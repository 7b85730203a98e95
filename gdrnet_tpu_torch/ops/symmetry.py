"""Object symmetries (counterpart of gdrnet_tpu/ops/symmetry.py): symmetry
sets from BOP models_info entries and their identity-padded arrays (numpy
copies of the JAX module's host functions, which cannot be imported without
JAX), and the closest symmetric rotation on tensors.

Symmetry-set construction from BOP ``models_info.json`` follows
lib/pysixd/misc.py:206-262 (get_symmetry_transformations).
"""

from __future__ import annotations

import numpy as np
import torch


def _axangle_mat_np(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )


def get_symmetry_transformations(model_info: dict, max_sym_disc_step: float = 0.01) -> list[dict]:
    """BOP models_info entry -> list of {R: 3x3, t: 3x1} symmetry transforms.

    Mirrors lib/pysixd/misc.py:206-262: discrete syms from 4x4 matrices,
    continuous syms discretized to ceil(pi / max_sym_disc_step) steps, then the
    cartesian product of both sets.
    """
    trans_disc = [{"R": np.eye(3), "t": np.zeros((3, 1))}]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, dtype=np.float64), (4, 4))
        trans_disc.append({"R": m[:3, :3], "t": m[:3, 3].reshape(3, 1)})

    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], dtype=np.float64)
        offset = np.asarray(sym["offset"], dtype=np.float64).reshape(3, 1)
        n_steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / n_steps
        for i in range(1, n_steps):
            rot = _axangle_mat_np(axis, i * step)
            trans_cont.append({"R": rot, "t": -rot @ offset + offset})

    out = []
    for td in trans_disc:
        if trans_cont:
            for tc in trans_cont:
                out.append({"R": tc["R"] @ td["R"], "t": tc["R"] @ td["t"] + tc["t"]})
        else:
            out.append(dict(td))
    return out


def get_symmetry_rotations(model_info: dict, max_sym_disc_step: float = 0.01) -> np.ndarray | None:
    """Kx3x3 rotation-only symmetry set, or None if the object is asymmetric.

    Matches the reference evaluators' sym_info construction
    (gdrn_custom_evaluator.py get_sym_infos pattern): continuous syms are
    discretized much coarser for the PM loss (the reference's datasets use
    max_sym_disc_step=0.01 for eval; training sym_infos come from the same
    models_info).
    """
    if not model_info.get("symmetries_discrete") and not model_info.get("symmetries_continuous"):
        return None
    trans = get_symmetry_transformations(model_info, max_sym_disc_step)
    return np.stack([t["R"] for t in trans]).astype(np.float32)


def pad_symmetry_sets(sym_list: list[np.ndarray | None], max_k: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Ragged per-object [Ki x 3 x 3 | None] -> padded [O, K+1, 3, 3] + bool
    mask [O, K+1].

    Slot 0 is always the identity: the reference's get_closest_rot starts the
    search from the raw GT rotation (pose_utils.py:444-445), so GT itself must
    stay a candidate even when the stored sym set omits identity (BOP
    continuous syms are discretized as range(1, n), misc.py:238). Remaining
    slots hold the object's syms, identity-padded with mask=False."""
    ks = [0 if s is None else s.shape[0] for s in sym_list]
    K = (max_k if max_k is not None else max(ks)) + 1
    O = len(sym_list)
    rots = np.tile(np.eye(3, dtype=np.float32), (O, K, 1, 1))
    mask = np.zeros((O, K), dtype=bool)
    mask[:, 0] = True
    for i, s in enumerate(sym_list):
        if s is not None:
            k = min(s.shape[0], K - 1)
            rots[i, 1:1 + k] = s[:k]
            mask[i, 1:1 + k] = True
    return rots, mask



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
