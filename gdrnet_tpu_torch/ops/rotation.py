"""Batched rotation math on tensors, in f32 (counterpart of gdrnet_tpu/ops/rotation.py).

The 3x3 products are written as broadcast multiply-and-sum, so they run in
full f32 whatever the TF32 switches say. Quaternions are scalar-first
(w, x, y, z).
"""

from __future__ import annotations

import torch

_EPS = 1e-8
# the largest f32 below 1: arccos has a finite gradient up to it
_ACOS_MAX = 1.0 - 2.0 ** -24


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] in full f32 (no TF32, no autocast)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def safe_norm(v: torch.Tensor, eps: float = _EPS, dim: int = -1) -> torch.Tensor:
    """L2 norm floored at eps, with a finite gradient at v == 0."""
    return v.square().sum(dim=dim, keepdim=True).clamp_min(eps * eps).sqrt()


def normalize_vector(v: torch.Tensor, eps: float = _EPS, dim: int = -1) -> torch.Tensor:
    """L2-normalize along `dim` (value- and gradient-safe at 0)."""
    return v / safe_norm(v, eps=eps, dim=dim)


def ortho6d_to_mat(poses: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt; the 6 numbers are R's first two columns."""
    x = normalize_vector(poses[..., 0:3])
    z = normalize_vector(torch.linalg.cross(x, poses[..., 3:6]))
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def quat_to_mat(quat: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """[..., 4] (w, x, y, z, possibly unnormalized) -> [..., 3, 3]."""
    q = quat / safe_norm(quat, eps=eps)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw),
        2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw),
        2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def allo_to_ego_mat(translation: torch.Tensor, rot_allo: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """Allocentric -> egocentric: rotate by the angle between the camera ray
    (0, 0, 1) and the object's ray. translation [..., 3], rot_allo [..., 3, 3].
    Norms are floored at eps, as in the JAX package. The ray's z is clamped
    to +-_ACOS_MAX, not +-1: a ray within about 3.5e-4 of the axis rounds to
    z = 1, where arccos's gradient is infinite and the translation's gradient
    not finite (ROADMAP.md section C); the angle there is 3.45e-4 rad, not 0,
    and every other ray's is unchanged."""
    obj_ray = translation / safe_norm(translation, eps=eps)
    angle = torch.arccos(obj_ray[..., 2:3].clamp(-_ACOS_MAX, _ACOS_MAX))
    cam_ray = torch.tensor([0.0, 0.0, 1.0], dtype=translation.dtype,
                           device=translation.device).expand_as(obj_ray)
    axis = torch.linalg.cross(cam_ray, obj_ray)
    axis = axis / safe_norm(axis, eps=eps)
    q = torch.cat([torch.cos(angle / 2.0), axis * torch.sin(angle / 2.0)], dim=-1)
    return mm3(quat_to_mat(q), rot_allo)


def angular_distance_mat(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """(3 - tr(R1 R2^T)) / 4, in [0, 1]."""
    return (3.0 - (r1 * r2).sum(dim=(-2, -1))) / 4.0


def angular_distance_quat(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """1 - <q1, q2>^2, in [0, 1]."""
    return 1.0 - (q1 * q2).sum(-1).square()


def rot_angle_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations, in degrees."""
    tr = (r1 * r2).sum(dim=(-2, -1))  # trace(r1 @ r2^T)
    cos = ((tr - 1.0) * 0.5).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))
