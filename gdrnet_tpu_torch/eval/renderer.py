"""BOP renderer-factory API over the port's z-buffer renders (counterpart of
gdrnet_tpu/eval/renderer.py; reference lib/pysixd/renderer.py:11-107, the
abstract Renderer + create_renderer factory that VSD/eval tooling drives
via add_object/render_object). Every renderer_type maps to
ops/rasterizer, whose renders go through the z-buffer kernel B2 on
`device`; outputs are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from gdrnet_tpu_torch.data.ply import load_ply
from gdrnet_tpu_torch.ops.rasterizer import (
    _phong_window,
    paste_window,
    render_xyz,
    render_xyz_roi,
    window_origin,
)


class Renderer:
    """BOP Renderer interface (renderer.py:11-75) rendering with the
    z-buffer kernel on `device` (the card unless the caller passes another).
    `mode` selects the returned images: "rgb", "depth" or "rgb+depth".
    Windowed renders keep per-object eval cheap."""

    def __init__(self, width: int, height: int, mode: str = "rgb+depth",
                 bg_color=(0.0, 0.0, 0.0, 0.0), device="cuda"):
        self.width = width
        self.height = height
        self.mode = mode
        self.bg_color = bg_color
        self.device = device
        self.light_cam_pos = (0, 0, 0)
        self.light_color = (1.0, 1.0, 1.0)
        self.light_ambient_weight = 0.5
        self.light_diffuse_weight = 1.0
        self.light_specular_weight = 0.0
        self.light_specular_shininess = 0.0
        self._models: dict = {}

    def set_light_cam_pos(self, light_cam_pos):
        self.light_cam_pos = light_cam_pos

    def set_light_ambient_weight(self, w):
        self.light_ambient_weight = w

    def add_object(self, obj_id, model_path: str | None = None, *,
                   verts=None, faces=None, colors=None, **kwargs):
        """Load a PLY (renderer.py:47-53) or take an in-memory mesh."""
        if model_path is not None:
            m = load_ply(model_path)
            verts, faces = m["pts"], m["faces"]
            colors = m.get("colors")
            if colors is not None and colors.max() > 1.0:
                colors = colors / 255.0
        self._models[obj_id] = (np.asarray(verts, np.float32),
                                np.asarray(faces, np.int32),
                                None if colors is None
                                else np.asarray(colors, np.float32))

    def remove_object(self, obj_id):
        del self._models[obj_id]

    def render_object(self, obj_id, R, t, fx, fy, cx, cy) -> dict:
        """Render one object pose -> {"rgb" uint8 [H,W,3], "depth" f32 [H,W]}
        per `mode` (renderer.py:61-75 contract)."""
        verts, faces, colors = self._models[obj_id]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        R = np.asarray(R, np.float32).reshape(3, 3)
        t = np.asarray(t, np.float32).reshape(3)
        out = {}
        if "rgb" in self.mode:
            d_win, rgb_win, org = _phong_window(
                verts, faces, K, R, t, self.height, self.width, device=self.device,
                colors=colors, light_pos=self.light_cam_pos,
                ambient=self.light_ambient_weight, diffuse=self.light_diffuse_weight,
                specular=self.light_specular_weight)
            rgb = paste_window(np.zeros((self.height, self.width, 3), np.float32),
                               rgb_win.cpu().numpy(), org)
            out["rgb"] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            if "depth" in self.mode:
                out["depth"] = paste_window(np.zeros((self.height, self.width), np.float32),
                                            d_win.cpu().numpy(), org)
            return out
        # depth-only: windowed XYZ render ladder, full-frame fallback
        for tile in (128, 256, 512):
            if tile >= max(self.height, self.width):
                break
            if window_origin(verts, K, R, t, self.height, self.width, tile) is None:
                continue
            d_win, _, org = render_xyz_roi(verts, faces, K, R, t, height=self.height,
                                           width=self.width, tile=tile, device=self.device)
            out["depth"] = paste_window(np.zeros((self.height, self.width), np.float32),
                                        d_win.cpu().numpy(), org)
            return out
        depth, _ = render_xyz(verts, faces, K, R, t, height=self.height, width=self.width,
                              device=self.device)
        out["depth"] = depth.cpu().numpy()
        return out


def create_renderer(width: int, height: int, renderer_type: str = "xla",
                    mode: str = "rgb+depth", shading: str = "phong",
                    bg_color=(0.0, 0.0, 0.0, 0.0), device="cuda") -> Renderer:
    """Factory (renderer.py:77-107). Every renderer_type the reference
    accepts (cpp/python/egl/aae) plus "xla" returns the Renderer on the
    z-buffer kernel: there is no GL dependency to dispatch over."""
    return Renderer(width, height, mode=mode, bg_color=bg_color, device=device)
