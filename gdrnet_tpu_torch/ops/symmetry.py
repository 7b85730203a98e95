"""Closest symmetric rotation over identity-padded symmetry sets
(counterpart of gdrnet_tpu/ops/symmetry.py)."""

from __future__ import annotations

import numpy as np
import torch


def identity_padded_sym_arrays(srots: np.ndarray | None, batch: int
                               ) -> tuple[np.ndarray, np.ndarray]:
    """[K,3,3] discrete symmetry rotations (or None) -> batched ([B,K+1,3,3],
    [B,K+1] bool mask) with the identity in slot 0.

    A copy of gdrnet_tpu.ops.symmetry.identity_padded_sym_arrays, which cannot
    be imported without JAX."""
    if srots is None:
        sym = np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1, 1))
        return sym, np.ones((batch, 1), bool)
    k = srots.shape[0] + 1
    sym = np.tile(np.eye(3, dtype=np.float32), (batch, k, 1, 1))
    sym[:, 1:] = srots[None]
    return sym, np.ones((batch, k), bool)


def get_closest_rot_batch(pred_rots: torch.Tensor, gt_rots: torch.Tensor,
                          sym_rots: torch.Tensor,
                          sym_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample closest symmetric GT rotation.

    pred_rots, gt_rots [B, 3, 3]; sym_rots [B, K, 3, 3] identity-padded;
    sym_mask [B, K] bool. The candidates are gt @ sym_k; the winner has the
    largest trace(pred @ cand^T), i.e. the smallest geodesic angle. Ties go to
    the lowest k."""
    # f32 products by broadcast, as in ops.rotation.mm3
    cands = (gt_rots[:, None, :, :, None] * sym_rots[:, :, None, :, :]).sum(-2)
    tr = (pred_rots[:, None] * cands).sum(dim=(-2, -1))  # [B, K]
    if sym_mask is not None:
        tr = tr.masked_fill(~sym_mask, float("-inf"))
    best = tr.argmax(dim=-1)
    return cands[torch.arange(cands.shape[0], device=cands.device), best]
