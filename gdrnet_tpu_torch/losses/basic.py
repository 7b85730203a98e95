"""Elementary losses on tensors (counterpart of gdrnet_tpu/losses/basic.py).

Semantics of the reference's losses: L2Loss is the per-sample L2 norm of the
difference, smooth_l1 is fvcore's, CrossEntropyHeatmapLoss is the CE over the
channel axis of a heatmap, here the LAST axis (channels-last), and the
rotation losses are rot_loss.py's.
"""

from __future__ import annotations

import torch

from gdrnet_tpu_torch.ops import rotation as R


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def l1_loss(pred, target, reduction: str = "mean"):
    return _reduce((pred - target).abs(), reduction)


def mse_loss(pred, target, reduction: str = "mean"):
    return _reduce((pred - target).square(), reduction)


def l2_loss(pred, target, reduction: str = "mean"):
    """Per-sample (batch-leading) L2 norm of the difference over every other
    axis, floored at 1e-6 (sqrt of 1e-12), then reduced."""
    d = (pred - target).reshape(pred.shape[0], -1)
    return _reduce(d.square().sum(-1).clamp_min(1e-12).sqrt(), reduction)


def smooth_l1_loss(pred, target, beta: float = 1.0, reduction: str = "mean"):
    """fvcore smooth_l1: 0.5 d^2 / beta where |d| < beta, else |d| - 0.5 beta."""
    d = (pred - target).abs()
    loss = d if beta < 1e-5 else torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _reduce(loss, reduction)


def cross_entropy_heatmap_loss(logits: torch.Tensor, target: torch.Tensor,
                               reduction: str = "sum") -> torch.Tensor:
    """CE over the LAST axis of [..., C] logits with integer targets [...]:
    log-softmax over that axis, then the target's negative log-probability."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, target.long()[..., None])[..., 0]
    return _reduce(nll, reduction)


def angular_distance_loss(pred, target, reduction: str = "mean"):
    """Rotation angular distance in [0, 1]: quaternions [B, 4] or matrices
    [B, 3, 3]."""
    if pred.shape[-1] == 4 and pred.dim() == 2:
        d = R.angular_distance_quat(pred, target)
    else:
        d = R.angular_distance_mat(pred, target)
    return _reduce(d, reduction)


def rot_l2_loss(pred_mat, gt_mat):
    """Mean squared Frobenius error."""
    return mse_loss(pred_mat, gt_mat, reduction="mean")


LOSS_FUNCS = {
    "L1": l1_loss,
    "MSE": mse_loss,
    "L2": l2_loss,
    "SMOOTH_L1": smooth_l1_loss,
}


def get_loss_func(name: str):
    key = name.upper()
    if key not in LOSS_FUNCS:
        raise ValueError(f"loss type {name} not supported")
    return LOSS_FUNCS[key]
