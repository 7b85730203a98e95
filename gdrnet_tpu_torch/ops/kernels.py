"""Hand-written GPU kernels of the port, each beside its plain PyTorch version.

`nn_min_dist`: batched nearest-neighbour mean distance, the ADI / ADD-S core
(the counterpart of gdrnet_tpu/ops/pallas_kernels.py:nn_min_dist). On a CUDA
tensor it launches the CUDA kernel in csrc/nn_min_dist.cu; on a CPU tensor it
runs `nn_min_dist_ref`. `nn_min_dist.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gdrnet_tpu_torch import csrc

_REF_CHUNK_ELEMS = 1 << 24  # bounds the [B, chunk, NR, 3] difference tensor


def nn_min_dist_ref(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """query [B,NQ,3], ref [B,NR,3] f32 -> [B] mean_q min_r |q - r|.

    Plain version: direct differences in f32, queries taken in chunks."""
    B, NQ, _ = query.shape
    NR = ref.shape[1]
    chunk = max(1, _REF_CHUNK_ELEMS // (B * NR * 3))
    total = torch.zeros(B, dtype=torch.float32, device=query.device)
    for s in range(0, NQ, chunk):
        d2 = (query[:, s:s + chunk, None, :] - ref[:, None, :, :]).square().sum(-1)
        total += d2.amin(dim=-1).sqrt().sum(dim=-1)
    return total / NQ


@functools.cache
def _nn_lib() -> ctypes.CDLL:
    lib = csrc.load("nn_min_dist")
    lib.nn_min_dist_query_tile.argtypes = []
    lib.nn_min_dist_query_tile.restype = ctypes.c_int
    lib.nn_min_dist_partial_sums.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nn_min_dist_partial_sums.restype = ctypes.c_int
    lib.nn_min_dist_error_string.argtypes = [ctypes.c_int]
    lib.nn_min_dist_error_string.restype = ctypes.c_char_p
    return lib


def _check_point_sets(query: torch.Tensor, ref: torch.Tensor) -> None:
    for name, t in (("query", query), ("ref", ref)):
        if t.dtype != torch.float32:
            raise TypeError(f"nn_min_dist: {name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"nn_min_dist: {name} must be [B, N, 3], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nn_min_dist: {name} must be contiguous")
        if t.shape[1] < 1:
            raise ValueError(f"nn_min_dist: {name} holds no points")
    if query.shape[0] != ref.shape[0] or query.shape[0] < 1:
        raise ValueError("nn_min_dist: query and ref need the same batch size >= 1, "
                         f"got {query.shape[0]} and {ref.shape[0]}")
    if query.device != ref.device:
        raise ValueError(f"nn_min_dist: query on {query.device}, ref on {ref.device}")


def nn_min_dist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """query [B,NQ,3], ref [B,NR,3] f32 contiguous -> [B] mean_q min_r |q - r|.

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    `nn_min_dist_ref`."""
    _check_point_sets(query, ref)
    if query.device.type == "cpu":
        return nn_min_dist_ref(query, ref)
    if query.device.type != "cuda":
        raise ValueError(f"nn_min_dist: no kernel for device {query.device}")
    B, NQ, _ = query.shape
    if B > 65535:
        raise ValueError(f"nn_min_dist: batch {B} exceeds the kernel's grid limit 65535")
    lib = _nn_lib()
    tile = lib.nn_min_dist_query_tile()
    partial = torch.empty((B, -(-NQ // tile)), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nn_min_dist_partial_sums(query.data_ptr(), ref.data_ptr(),
                                          partial.data_ptr(), B, NQ, ref.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"nn_min_dist kernel launch failed: "
                           f"{lib.nn_min_dist_error_string(rc).decode()} ({rc})")
    nn_min_dist.launches += 1
    return partial.sum(dim=1) / NQ


nn_min_dist.launches = 0
