"""Per-object 3D model asset store: sampled points, extents, 3D bboxes,
FPS keypoints, symmetry rotation sets. A copy of
gdrnet_tpu/data/model_store.py (which cannot be imported without JAX), so
that its RandomState draws give the same point samples.

The reference builds these lazily per dataset inside the mapper
(data_loader.py:189-302: _get_fps_points/_get_model_points/_get_extents/
_get_sym_infos); here they live in one host-side container that also emits
the padded device tensors the jitted loss needs (stacked [O, ...] arrays
indexed by roi_class).
"""

from __future__ import annotations

import numpy as np

from gdrnet_tpu_torch.data.ref_meta import DatasetMeta
from gdrnet_tpu_torch.data.ply import load_ply
from gdrnet_tpu_torch.ops.symmetry import get_symmetry_rotations, pad_symmetry_sets
from gdrnet_tpu_torch.ops.fps import farthest_point_sampling_np


class ObjectModels:
    def __init__(self, meta: DatasetMeta, objs: list[str] | None = None,
                 num_pm_points: int = 3000, num_fps: int = 8,
                 max_sym_disc_step: float = 0.01, seed: int = 2333):
        self.meta = meta
        self.objs = list(objs if objs is not None else meta.objects)
        self.num_pm_points = num_pm_points
        self.num_fps = num_fps
        rng = np.random.RandomState(seed)

        try:
            models_info = meta.models_info()
        except (FileNotFoundError, AssertionError):
            models_info = {}
        try:
            fps_pkl = meta.fps_points()
        except (FileNotFoundError, OSError):
            fps_pkl = None

        self.points: dict[str, np.ndarray] = {}
        self.full_points: dict[str, np.ndarray] = {}
        self.faces: dict[str, np.ndarray | None] = {}
        self.extents: dict[str, np.ndarray] = {}
        self.bbox3d: dict[str, np.ndarray] = {}
        self.fps_points: dict[str, np.ndarray] = {}
        self.diameters: dict[str, float] = {}
        self.sym_rots: dict[str, np.ndarray | None] = {}

        for name in self.objs:
            obj_id = meta.obj2id[name]
            ply = load_ply(meta.model_path(obj_id), vertex_scale=meta.vertex_scale)
            pts = ply["pts"]
            self.full_points[name] = pts
            # mesh faces for depth renders (vsd scoring, eval/vsd.py)
            f = ply.get("faces")
            self.faces[name] = None if f is None else np.asarray(f, np.int32)
            # sample to <= num_pm_points (reference data_loader.py:230-240)
            if pts.shape[0] > num_pm_points:
                sel = rng.choice(pts.shape[0], num_pm_points, replace=False)
                self.points[name] = pts[sel]
            else:
                self.points[name] = pts
            mins, maxs = pts.min(0), pts.max(0)
            self.extents[name] = (maxs - mins).astype(np.float32)
            self.bbox3d[name] = _bbox3d_and_center(mins, maxs)
            # prefer the precomputed fps_points.pkl artifact (the partition
            # the reference's region head was trained on, data_loader.py:
            # 189-212 loads fps{K}_and_center and drops the center); fall
            # back to on-the-fly sampling when absent (tiny/fixture sets)
            fps = None
            if fps_pkl is not None:
                entry = fps_pkl.get(str(obj_id), {})
                arr = entry.get(f"fps{num_fps}_and_center")
                if arr is not None:
                    fps = np.asarray(arr, np.float32)[:-1]
            if fps is None:
                fps = np.asarray(
                    farthest_point_sampling_np(pts, num_fps, init_center=True),
                    np.float32)
            self.fps_points[name] = fps
            info = models_info.get(str(obj_id), {})
            self.diameters[name] = float(info.get(
                "diameter", meta.diameters_by_name.get(name, 0.0) * 1000.0)) / 1000.0 \
                if "diameter" in info else meta.diameters_by_name.get(name, float(np.linalg.norm(maxs - mins)))
            self.sym_rots[name] = get_symmetry_rotations(info, max_sym_disc_step) \
                if info else (np.asarray([np.diag([-1.0, -1.0, 1.0])], np.float32)
                              if name in meta.sym_objects else None)

        # stacked per-class device tensors (indexed by label id 0..O-1)
        self.points_stack = _pad_stack([self.points[n] for n in self.objs])
        self.extents_stack = np.stack([self.extents[n] for n in self.objs])
        self.fps_stack = np.stack([self.fps_points[n] for n in self.objs])
        self.sym_rots_stack, self.sym_mask_stack = pad_symmetry_sets(
            [self.sym_rots[n] for n in self.objs])

    def label_of(self, name: str) -> int:
        return self.objs.index(name)


def _pad_stack(point_sets: list[np.ndarray]) -> np.ndarray:
    """Ragged [Ni,3] point sets -> [O, Nmax, 3], padding by repeating points
    (repetition keeps the PM-loss mean unbiased-ish vs zero-padding)."""
    n_max = max(p.shape[0] for p in point_sets)
    out = np.zeros((len(point_sets), n_max, 3), np.float32)
    for i, p in enumerate(point_sets):
        reps = int(np.ceil(n_max / p.shape[0]))
        out[i] = np.tile(p, (reps, 1))[:n_max]
    return out


def _bbox3d_and_center(mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    """8 corners + center, the reference's misc.get_bbox3d_and_center layout
    (lib/pysixd/misc.py:982)."""
    x0, y0, z0 = mins
    x1, y1, z1 = maxs
    corners = np.asarray([
        [x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0],
        [x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0],
        [(x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2],
    ], np.float32)
    return corners
