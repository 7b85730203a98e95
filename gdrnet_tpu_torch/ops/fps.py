"""Farthest point sampling (FPS): on a device in PyTorch, on the host in numpy
(a copy of gdrnet_tpu/ops/fps.py:farthest_point_sampling_np, which cannot be
imported without JAX) and in the port's own C++ (csrc/fps.cpp).

Semantics (init_center=True, the variant used for fps_points.pkl):
  * seed min-dist with squared distance to the bbox center ((max+min)/2)
  * first sample = farthest point from that center
  * then repeat: update min-dist, pick argmax among unselected points.
Without init_center the min-dists start at +inf and the first sample is
start_idx.

Every sampler here gives farthest_point_sampling_np's indices bit for bit,
on every cloud, ties between equal distances included: each squared
distance is (dx*dx + dy*dy) + dz*dz with each operation rounded once, as
numpy's three-term sum rounds it, and each pick is the first maximum, as
np.argmax's. That order is what the fps_points.pkl files and the loaders
(data/model_store.py) follow. Samplers that round otherwise break ties
otherwise: the JAX package's C++ tool (gdrnet_tpu/csrc/fps, built with
-march=native, where g++ contracts the sum into fused multiply-adds) and
its XLA device FPS (gdrnet_tpu/ops/fps.py:26-48) both pick other points
than numpy on lattices, cylinders and symmetric meshes, and the same
points on clouds without exact ties.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gdrnet_tpu_torch import csrc


def _device_points(pts, device) -> torch.Tensor:
    """pts as a float32 [N, 3] tensor: a tensor stays on its device unless
    `device` names another; anything else goes to `device`, the card by
    default."""
    if isinstance(pts, torch.Tensor):
        return pts.to(device=device if device is not None else pts.device,
                      dtype=torch.float32)
    return torch.as_tensor(np.asarray(pts, np.float32),
                           device=device if device is not None else "cuda")


def farthest_point_sampling_idx(pts, k: int, init_center: bool = True, start_idx: int = 0,
                                device=None) -> torch.Tensor:
    """pts [N, 3] -> int64 [k] indices of farthest-point samples, on pts's
    device (a numpy input goes to `device`, the card unless named).

    A step is eight launches (gather the current point, the difference, its
    square, two row sums, the minimum, the mask, the argmax); the current
    index stays a 0-d tensor on the device, so the loop never waits for
    the device."""
    pts = _device_points(pts, device)
    n = pts.shape[0]
    if not init_center and not 0 <= start_idx < n:
        raise ValueError(f"start_idx {start_idx} outside [0, {n})")
    coords = pts.T.contiguous()  # [3, N]: one contiguous row a coordinate

    def sq_dist(p: torch.Tensor) -> torch.Tensor:  # p [3, 1]
        sq = coords - p
        sq = sq * sq
        return (sq[0] + sq[1]) + sq[2]

    if init_center:
        min_d = sq_dist(((pts.amax(0) + pts.amin(0)) * 0.5)[:, None])
        cur = torch.argmax(min_d)
    else:
        min_d = torch.full_like(coords[0], float("inf"))
        cur = torch.full((), start_idx, dtype=torch.int64, device=pts.device)
    picks = []
    for _ in range(k):
        picks.append(cur)
        at = cur.view(1)
        torch.minimum(min_d, sq_dist(coords.index_select(1, at)), out=min_d)
        min_d.index_fill_(0, at, float("-inf"))
        cur = torch.argmax(min_d)
    return torch.stack(picks) if picks else torch.zeros(0, dtype=torch.int64,
                                                        device=pts.device)


def farthest_point_sampling(pts, k: int, init_center: bool = True,
                            device=None) -> torch.Tensor:
    """pts [N, 3] -> [k, 3] sampled points (ref fps_utils.py:6-21), on pts's
    device (a numpy input goes to `device`, the card unless named)."""
    pts = _device_points(pts, device)
    return pts[farthest_point_sampling_idx(pts, k, init_center=init_center)]


def get_fps_and_center(pts, num_fps: int = 8, init_center: bool = True,
                       device=None) -> torch.Tensor:
    """FPS points + mean center appended, [num_fps + 1, 3]: the layout of
    fps_points.pkl entries (ref core/utils/data_utils.py:201-210)."""
    pts = _device_points(pts, device)
    fps_pts = farthest_point_sampling(pts, num_fps, init_center=init_center)
    return torch.cat([fps_pts, pts.mean(0, keepdim=True)], 0)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib`, a library built from csrc/fps.cpp, with fps_sample's C
    signature declared."""
    lib.fps_sample.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
    lib.fps_sample.restype = ctypes.c_int
    return lib


@functools.cache
def _loaded() -> ctypes.CDLL:
    return declare(csrc.load("fps"))


def fps_sample(lib: ctypes.CDLL, pts: np.ndarray, k: int, init_center: bool,
               start_idx: int) -> np.ndarray:
    """pts [N, 3] -> int64 [k] indices through `lib`'s fps_sample (a
    library that `declare` has seen). Raises ValueError where it returns an
    error: n or k not positive, k > n, or start_idx outside [0, n) without
    init_center."""
    pts = np.ascontiguousarray(pts, np.float32)
    n = pts.shape[0]
    out = np.empty(k, np.int64)
    ret = lib.fps_sample(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k,
                         int(init_center), start_idx,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if ret != 0:
        raise ValueError(f"fps_sample failed: n={n}, k={k}, start_idx={start_idx}")
    return out


def farthest_point_sampling_cpp_idx(pts: np.ndarray, k: int, init_center: bool = True,
                                    start_idx: int = 0) -> np.ndarray:
    """pts [N, 3] -> int64 [k] indices, through csrc/fps.cpp on the host
    (built with g++ at first use; a failed build raises with its output);
    raises ValueError on the library's error code (see fps_sample)."""
    return fps_sample(_loaded(), pts, k, init_center, start_idx)


def farthest_point_sampling_cpp(pts: np.ndarray, k: int, init_center: bool = True,
                                start_idx: int = 0) -> np.ndarray:
    """pts [N, 3] -> [k, 3] float32 samples through csrc/fps.cpp."""
    pts = np.ascontiguousarray(pts, np.float32)
    return pts[farthest_point_sampling_cpp_idx(pts, k, init_center, start_idx)]


def farthest_point_sampling_np_idx(pts: np.ndarray, k: int, init_center: bool = True,
                                   start_idx: int = 0) -> np.ndarray:
    """pts [N, 3] -> int64 [k] indices of farthest-point samples."""
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
    return idxs


def farthest_point_sampling_np(pts: np.ndarray, k: int, init_center: bool = True,
                               start_idx: int = 0) -> np.ndarray:
    """pts [N, 3] -> [k, 3] farthest-point samples."""
    pts = np.asarray(pts, dtype=np.float32)
    return pts[farthest_point_sampling_np_idx(pts, k, init_center, start_idx)]
