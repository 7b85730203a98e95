"""Random multi-object synthetic scene generator (counterpart of
gdrnet_tpu/data/scene_renderer.py; reference SceneRenderer,
lib/meshrenderer/scenerenderer.py:16-144): samples N objects with random
rotations and frustum-bounded translations, renders them z-merged with
randomized Phong lighting (ops/rasterizer.render_scene, on the z-buffer
kernel B2 on `device`), composites a background where no object was hit,
and returns the image plus per-object {id, bb} records for detector
training.

The RNG is an explicit np.random.RandomState, drawn in the JAX package's
order, so one seed gives the same scenes. Backgrounds come from the port's
BackgroundReplacer: without `bg_root` its gradient fallback; a VOC folder of
JPEGs raises, since the port decodes no JPEG (ROADMAP.md A13).
"""

from __future__ import annotations

import math

import numpy as np

from gdrnet_tpu_torch.data.augment import BackgroundReplacer
from gdrnet_tpu_torch.ops.rasterizer import render_scene


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Uniform random rotation matrix (reference
    transform.random_rotation_matrix semantics: Shoemake uniform
    quaternion from three uniforms, lib/pysixd/transform.py)."""
    u1, u2, u3 = rng.random_sample(3)
    q = np.array([
        math.sqrt(1.0 - u1) * math.sin(2.0 * math.pi * u2),
        math.sqrt(1.0 - u1) * math.cos(2.0 * math.pi * u2),
        math.sqrt(u1) * math.sin(2.0 * math.pi * u3),
        math.sqrt(u1) * math.cos(2.0 * math.pi * u3),
    ])  # [x, y, z, w]
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class SceneRenderer:
    """Reference scenerenderer.SceneRenderer parity (scenerenderer.py:16-144).

    models: list of (verts, faces) or (verts, faces, colors) meshes, same
    units as `radius` (the reference uses mm, radius=650).
    obj_ids: dataset object id per mesh (reference `obj_ids`).
    bg_root: VOC-style background folder (reference `vocdevkit_path`);
    without it a synthetic gradient background is used.
    augmenters: optional callable(img_uint8, rng) -> img_uint8 applied to
    the composited image (reference applies imgaug `augmenters`).
    device: where the instances render (the card unless the caller passes
    another).
    """

    def __init__(self, models, obj_ids, width: int, height: int, K,
                 bg_root: str | None = None,
                 min_num_objects_per_scene: int = 3,
                 max_num_objects_per_scene: int = 6,
                 radius: float = 650.0,
                 augmenters=None,
                 rng: np.random.RandomState | None = None,
                 device="cuda"):
        self.models = models
        self.obj_ids = np.asarray(obj_ids)
        self.width, self.height = width, height
        self.K = np.asarray(K, np.float32)
        self.min_n = min_num_objects_per_scene
        self.max_n = max_num_objects_per_scene
        self.radius = float(radius)
        self.augmenters = augmenters
        self.rng = rng or np.random.RandomState()
        self.bg = BackgroundReplacer(bg_root or "")
        self.device = device

    def _sample_poses(self, n: int):
        """Random rotations + frustum-bounded translations with the
        reference's ray-separation rejection (scenerenderer.py:81-107:
        resample while the new center ray is within dot>0.99 of any
        previously placed object, so instances don't stack); accepted on
        the 100th attempt, where the reference would spin forever."""
        rng, K = self.rng, self.K
        Rs, ts, ts_norm = [], [], []
        for _ in range(n):
            for attempt in range(100):
                tz = rng.triangular(self.radius - self.radius / 3, self.radius,
                                    self.radius + self.radius / 3)
                tx = rng.uniform(-0.35 * tz * self.width / K[0, 0],
                                 0.35 * tz * self.width / K[0, 0])
                ty = rng.uniform(-0.35 * tz * self.height / K[1, 1],
                                 0.35 * tz * self.height / K[1, 1])
                t = np.array([tx, ty, tz], np.float32)
                t_norm = t / np.linalg.norm(t)
                if (attempt < 99 and ts_norm
                        and np.any(np.asarray(ts_norm) @ t_norm > 0.99)):
                    continue
                ts_norm.append(t_norm)
                ts.append(t)
                Rs.append(random_rotation(rng))
                break
        return np.stack(Rs), np.stack(ts)

    def render(self):
        """One random scene. Returns (bgr uint8 [H,W,3], obj_info, extras):
        obj_info = [{"id", "bb" xyxy}] (reference scenerenderer.py:129-137,
        amodal per-draw boxes); extras carries depth / inst_map /
        masks_visib / visible bboxes / poses for downstream GT."""
        rng = self.rng
        n = (self.min_n if self.min_n == self.max_n
             else rng.randint(self.min_n, self.max_n))
        obj_is = rng.choice(len(self.models), n)
        Rs, ts = self._sample_poses(n)
        scene = render_scene(self.models, obj_is, self.K, Rs, ts, self.height, self.width,
                             random_light=True, rng=rng, device=self.device)
        rgb = np.asarray(scene["rgb"], np.float32)
        bg = self.bg.get_bg(rng, self.height, self.width).astype(np.float32) / 255.0
        hit = scene["depth"] > 0
        out = np.where(hit[..., None], rgb, bg[..., ::-1])  # bg is BGR
        bgr = (np.clip(out[..., ::-1], 0, 1) * 255).astype(np.uint8)
        if self.augmenters is not None:
            bgr = self.augmenters(bgr, rng)
        obj_info = []
        for bb, oi in zip(scene["bboxes_amodal"], self.obj_ids[obj_is]):
            x1, y1, x2, y2 = (int(v) for v in bb)
            # exclusive max corner, reference convention (scenerenderer.py:
            # 129-137 builds [x, y, x+w, y+h] from calc_2d_bbox's w,h)
            obj_info.append({"id": int(oi), "bb": [x1, y1, x2 + 1, y2 + 1]})
        extras = {"depth": scene["depth"], "inst_map": scene["inst_map"],
                  "masks_visib": scene["masks_visib"],
                  "bboxes_visib": scene["bboxes"],
                  "obj_is": obj_is, "Rs": Rs, "ts": ts}
        return bgr, obj_info, extras
