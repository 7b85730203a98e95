"""BOP pose-error metrics on tensors, batched over [B] poses (counterpart of
gdrnet_tpu/eval/pose_errors.py).

Every function takes stacked [B, ...] tensors and returns [B] errors; `pts`
is one model-point set [N, 3] for the whole batch or [B, N, 3].
"""

from __future__ import annotations

import numpy as np
import torch

from gdrnet_tpu_torch.ops import kernels


def _tp(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[B?, N, 3] object points -> camera frame with [B, 3, 3], [B, 3] (f32
    broadcast products, no TF32)."""
    if pts.dim() == 2:
        pts = pts[None]
    return (R[:, None, :, :] * pts[:, :, None, :]).sum(-1) + t[:, None, :]


def add_batch(R_est, t_est, R_gt, t_gt, pts) -> torch.Tensor:
    """ADD: mean L2 between correspondingly transformed model points."""
    return (_tp(pts, R_est, t_est) - _tp(pts, R_gt, t_gt)).norm(dim=-1).mean(dim=-1)


def adi_batch(R_est, t_est, R_gt, t_gt, pts) -> torch.Tensor:
    """ADD-S / ADI: mean over the GT points of the distance to the nearest
    estimated point (queries = GT points, reference set = estimated points).
    Runs through ops.kernels.nn_min_dist."""
    pe = _tp(pts, R_est, t_est).contiguous()
    pg = _tp(pts, R_gt, t_gt).contiguous()
    return kernels.nn_min_dist(pg, pe)


def re_batch(R_est, R_gt) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    tr = (R_est * R_gt).sum(dim=(-2, -1))
    return torch.rad2deg(torch.arccos((0.5 * (tr - 1.0)).clamp(-1.0, 1.0)))


def te_batch(t_est, t_gt) -> torch.Tensor:
    """Translation error."""
    return (t_est - t_gt).norm(dim=-1)


def proj_batch(R_est, t_est, R_gt, t_gt, K, pts) -> torch.Tensor:
    """Mean 2D projection error in pixels."""
    def proj2d(p):
        uvw = (K[:, None, :, :] * p[:, :, None, :]).sum(-1)
        return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)

    return (proj2d(_tp(pts, R_est, t_est)) - proj2d(_tp(pts, R_gt, t_gt))
            ).norm(dim=-1).mean(dim=-1)


def _sym_gt_points(R_gt, t_gt, pts, sym_rots) -> torch.Tensor:
    """GT points under each symmetry: R_gt @ S_k applied to pts, plus t_gt
    -> [B, K, N, 3]."""
    Rk = (R_gt[:, None, :, :, None] * sym_rots[:, :, None, :, :]).sum(-2)  # [B, K, 3, 3]
    if pts.dim() == 2:
        pts = pts[None].expand(R_gt.shape[0], -1, -1)
    return (Rk[:, :, None, :, :] * pts[:, None, :, None, :]).sum(-1) + t_gt[:, None, None, :]


def _proj(K, p) -> torch.Tensor:
    """[B,3,3] intrinsics, [B, ..., N, 3] camera points -> [B, ..., N, 2] pixels."""
    Kb = K.reshape(K.shape[0], *([1] * (p.dim() - 2)), 3, 3)
    uvw = (Kb * p[..., None, :]).sum(-1)
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)


def mssd_batch(R_est, t_est, R_gt, t_gt, pts, sym_rots, sym_mask) -> torch.Tensor:
    """Maximum symmetry-aware surface distance (pose_error.mssd:131-154):
    min over symmetry transforms of the MAX point distance. sym_rots
    [B, K, 3, 3] identity-padded, sym_mask [B, K] bool."""
    pe = _tp(pts, R_est, t_est)                                   # [B, N, 3]
    pg = _sym_gt_points(R_gt, t_gt, pts, sym_rots)                # [B, K, N, 3]
    maxd = (pe[:, None] - pg).norm(dim=-1).amax(dim=-1)           # [B, K]
    return maxd.masked_fill(~sym_mask, float("inf")).amin(dim=-1)


def mspd_batch(R_est, t_est, R_gt, t_gt, K, pts, sym_rots, sym_mask) -> torch.Tensor:
    """Maximum symmetry-aware projection distance (pose_error.mspd:156-182)."""
    proj_e = _proj(K, _tp(pts, R_est, t_est))                     # [B, N, 2]
    proj_g = _proj(K, _sym_gt_points(R_gt, t_gt, pts, sym_rots))  # [B, K, N, 2]
    maxd = (proj_e[:, None] - proj_g).norm(dim=-1).amax(dim=-1)
    return maxd.masked_fill(~sym_mask, float("inf")).amin(dim=-1)


def vocap_auc(errors: np.ndarray, max_val: float = 0.1) -> float:
    """AUC of the error-recall curve up to max_val (YCB-Video VOCap)."""
    errors = np.sort(np.asarray(errors, np.float64))
    n = len(errors)
    if n == 0:
        return 0.0
    rec = np.arange(1, n + 1) / n
    valid = errors < max_val
    if not np.any(valid):
        return 0.0
    e = np.concatenate([[0.0], errors[valid], [max_val]])
    r = np.concatenate([[0.0], rec[valid], [rec[valid][-1]]])
    return float(np.trapezoid(r, e) / max_val)


def recall_at(errors: np.ndarray, threshold: float) -> float:
    errors = np.asarray(errors)
    if errors.size == 0:
        return 0.0
    return float(np.mean(errors < threshold))
