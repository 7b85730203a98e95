"""Farthest point sampling on the host (a copy of
gdrnet_tpu/ops/fps.py:farthest_point_sampling_np, which cannot be imported
without JAX; that module's C++ tool gdrnet_tpu/csrc/fps has the same
semantics).

Semantics (init_center=True, the variant used for fps_points.pkl):
  * seed min-dist with squared distance to the bbox center ((max+min)/2)
  * first sample = farthest point from that center
  * then repeat: update min-dist, pick argmax among unselected points.
"""

from __future__ import annotations

import numpy as np


def farthest_point_sampling_np(pts: np.ndarray, k: int, init_center: bool = True,
                               start_idx: int = 0) -> np.ndarray:
    """pts [N, 3] -> [k, 3] farthest-point samples."""
    pts = np.asarray(pts, dtype=np.float32)
    n = pts.shape[0]
    if init_center:
        center = (pts.max(0) + pts.min(0)) * 0.5
        min_d = np.square(pts - center).sum(-1)
        cur = int(np.argmax(min_d))
    else:
        min_d = np.full((n,), np.inf, dtype=np.float32)
        cur = start_idx
    idxs = np.empty((k,), dtype=np.int64)
    for i in range(k):
        idxs[i] = cur
        d = np.square(pts - pts[cur]).sum(-1)
        np.minimum(min_d, d, out=min_d)
        min_d[cur] = -np.inf
        cur = int(np.argmax(min_d))
    return pts[idxs]
