"""Batched rotation math on tensors, in f32 (counterpart of gdrnet_tpu/ops/rotation.py).

ortho6d, quaternions, axis-angle, so(3) exp / log, static sxyz euler angles
and the allocentric <-> egocentric corrections. The 3x3 products are written
as broadcast multiply-and-sum, so they run in full f32 whatever the TF32
switches say. Quaternions are scalar-first (w, x, y, z).

Where a function branches with torch.where (so3_exp, mat_to_euler), the
branch not taken is fed inputs at which its derivative is finite: a NaN or
inf there would poison the gradient through the zero that where sends it.
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


def mat_to_ortho6d(rots: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two columns."""
    return torch.cat([rots[..., :, 0], rots[..., :, 1]], dim=-1)


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


def mat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z) with w >= 0, by the branch-free
    "best of four": each of the four candidates divides by its own pivot,
    and the one with the largest pivot is kept (the first on a tie)."""
    m = rot.unbind(-2)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = (r.unbind(-1) for r in m)
    qw2 = (1 + m00 + m11 + m22).clamp_min(0.0)
    qx2 = (1 + m00 - m11 - m22).clamp_min(0.0)
    qy2 = (1 - m00 + m11 - m22).clamp_min(0.0)
    qz2 = (1 - m00 - m11 + m22).clamp_min(0.0)
    qw, qx, qy, qz = qw2.sqrt(), qx2.sqrt(), qy2.sqrt(), qz2.sqrt()

    def div(a, b):
        return a / b.clamp_min(_EPS)

    cands = torch.stack([
        torch.stack([qw, div(m21 - m12, qw), div(m02 - m20, qw), div(m10 - m01, qw)], -1),
        torch.stack([div(m21 - m12, qx), qx, div(m01 + m10, qx), div(m02 + m20, qx)], -1),
        torch.stack([div(m02 - m20, qy), div(m01 + m10, qy), qy, div(m12 + m21, qy)], -1),
        torch.stack([div(m10 - m01, qz), div(m02 + m20, qz), div(m12 + m21, qz), qz], -1),
    ], dim=-2)  # [..., 4 candidates, 4]
    best = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = normalize_vector(torch.gather(cands, -2, idx)[..., 0, :] * 0.5)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of [..., 4] quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_exp(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """exp of [..., 4] (s; v) or [..., 3] (pure v) -> [..., 4]:
    e^s (cos|v|, v sin|v| / |v|), the decode of the log_quat rot type. |v|
    is floored at eps, so the value and the gradient are finite at v = 0."""
    if q.shape[-1] == 4:
        s, v = q[..., :1], q[..., 1:]
    else:
        s, v = torch.zeros_like(q[..., :1]), q
    theta = safe_norm(v, eps=eps)
    return torch.exp(s) * torch.cat([torch.cos(theta), v * torch.sin(theta) / theta], dim=-1)


def qrot_points(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate [..., N, 3] points by [..., 4] unit quaternions: q p q*."""
    qv = q[..., None, 1:4].expand_as(pts)
    qw = q[..., None, 0:1]
    t = 2.0 * torch.linalg.cross(qv, pts)
    return pts + qw * t + torch.linalg.cross(qv, t)


def axangle_to_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis [..., 3] (any length), angle [...] -> [..., 3, 3]."""
    x, y, z = normalize_vector(axis).unbind(-1)
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1 - c
    m = torch.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c,
    ], dim=-1)
    return m.reshape(axis.shape[:-1] + (3, 3))


def axangle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = angle[..., None] / 2.0
    return torch.cat([torch.cos(half), normalize_vector(axis) * torch.sin(half)], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape[:-1] + (3, 3))


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """so(3) vector [..., 3] -> rotation [..., 3, 3], by Taylor terms below
    |omega|^2 = 1e-12. The angle is safe_norm's (floored at 1e-8) and the
    closed form's denominator is floored at 1e-16, so neither branch has a
    non-finite derivative at omega = 0."""
    theta_sq = omega.square().sum(-1)
    theta = safe_norm(omega)[..., 0]
    small = theta_sq < 1e-12
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1 - torch.cos(theta)) / theta_sq.clamp_min(_EPS * _EPS))
    K = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * mm3(K, K)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> so(3) vector [..., 3], through the quaternion."""
    q = mat_to_quat(rot)
    w = q[..., 0].clamp(-1.0, 1.0)
    v = q[..., 1:4]
    vn = torch.linalg.vector_norm(v, dim=-1)
    return v / vn.clamp_min(_EPS)[..., None] * (2.0 * torch.atan2(vn, w))[..., None]


def euler_to_mat(ai: torch.Tensor, aj: torch.Tensor, ak: torch.Tensor) -> torch.Tensor:
    """Static sxyz euler angles -> [..., 3, 3] (transforms3d's euler2mat)."""
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs, sc, ss = ci * ck, ci * sk, si * ck, si * sk
    m = torch.stack([
        cj * ck, sj * sc - cs, sj * cc + ss,
        cj * sk, sj * ss + cc, sj * cs - sc,
        -sj, cj * si, cj * ci,
    ], dim=-1)
    return m.reshape(ai.shape + (3, 3))


def mat_to_euler(rot: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., 3, 3] -> static sxyz euler angles, the JAX package's values;
    at the gimbal (cos of the middle angle at most 1e-6) z is 0. The square
    root is floored at 1e-30 and each atan2 of the branch not taken reads
    (0, 1), so the gradient is finite at the gimbal and away from it."""
    r = rot
    cy = (r[..., 0, 0].square() + r[..., 1, 0].square()).clamp_min(1e-30).sqrt()
    safe = cy > 1e-6

    def atan2_where(cond, y, x):
        return torch.atan2(torch.where(cond, y, 0.0), torch.where(cond, x, 1.0))

    ax = torch.where(safe, atan2_where(safe, r[..., 2, 1], r[..., 2, 2]),
                     atan2_where(~safe, -r[..., 1, 2], r[..., 1, 1]))
    ay = torch.atan2(-r[..., 2, 0], cy)
    az = torch.where(safe, atan2_where(safe, r[..., 1, 0], r[..., 0, 0]), torch.zeros_like(cy))
    return ax, ay, az


def _axis_rotation(translation: torch.Tensor, eps: float, sign: float) -> torch.Tensor:
    """The quaternion that turns the camera ray (0, 0, 1) onto the object's
    ray (sign 1) or back (sign -1). The ray's z is clamped to +-_ACOS_MAX
    (allo_to_ego_mat says why)."""
    obj_ray = translation / safe_norm(translation, eps=eps)
    angle = torch.arccos(obj_ray[..., 2:3].clamp(-_ACOS_MAX, _ACOS_MAX))
    cam_ray = torch.tensor([0.0, 0.0, 1.0], dtype=translation.dtype,
                           device=translation.device).expand_as(obj_ray)
    axis = torch.linalg.cross(cam_ray, obj_ray)
    axis = axis / safe_norm(axis, eps=eps)
    return torch.cat([torch.cos(sign * angle / 2.0), axis * torch.sin(sign * angle / 2.0)],
                     dim=-1)


def allo_to_ego_quat(translation: torch.Tensor, q_allo: torch.Tensor,
                     eps: float = 1e-4) -> torch.Tensor:
    """Allocentric -> egocentric on [..., 4] quaternions."""
    return quat_mul(_axis_rotation(translation, eps, 1.0), q_allo)


def ego_to_allo_mat(translation: torch.Tensor, rot_ego: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """Egocentric -> allocentric on matrices, the inverse of allo_to_ego_mat."""
    return mm3(quat_to_mat(_axis_rotation(translation, eps, -1.0)), rot_ego)


def allo_to_ego_mat(translation: torch.Tensor, rot_allo: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """Allocentric -> egocentric: rotate by the angle between the camera ray
    (0, 0, 1) and the object's ray. translation [..., 3], rot_allo [..., 3, 3].
    Norms are floored at eps, as in the JAX package. The ray's z is clamped
    to +-_ACOS_MAX, not +-1: a ray within about 3.5e-4 of the axis rounds to
    z = 1, where arccos's gradient is infinite and the translation's gradient
    not finite (ROADMAP.md section C); the angle there is 3.45e-4 rad, not 0,
    and every other ray's is unchanged."""
    return mm3(quat_to_mat(_axis_rotation(translation, eps, 1.0)), rot_allo)


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
