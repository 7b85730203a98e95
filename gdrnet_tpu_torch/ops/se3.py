"""SE(3) / homogeneous-transform utilities on torch tensors of any device
(counterpart of gdrnet_tpu/ops/se3.py).

Covers the reference's lib/pysixd/transform.py + RT_transform.py surface
that the framework actually uses: compose/invert rigid transforms, RT <->
4x4, pose interpolation, random rotations. Products run in full f32
(ops/rotation.mm3: no TF32, no autocast), as the JAX module's
precision="highest".
"""

from __future__ import annotations

import math

import torch

from gdrnet_tpu_torch.ops import rotation as R_ops


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] in full f32."""
    return (R * v[..., None, :]).sum(-1)


def rt_to_mat4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    m = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    m[..., :3, :3] = R
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def mat4_to_rt(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return m[..., :3, :3], m[..., :3, 3]


def se3_mul(R1, t1, R2, t2):
    """(R1, t1) ∘ (R2, t2): first apply 2 then 1 (reference se3_mul,
    lib/pysixd/RT_transform.py)."""
    return R_ops.mm3(R1, R2), _mv(R1, t2) + t1


def se3_inverse(R, t):
    """Inverse rigid transform: (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def relative_pose(R_src, t_src, R_tgt, t_tgt):
    """Delta pose taking src to tgt: tgt = delta ∘ src (reference
    calc_RT_delta, RT_transform.py)."""
    R_inv, t_inv = se3_inverse(R_src, t_src)
    return se3_mul(R_tgt, t_tgt, R_inv, t_inv)


def interpolate_poses(R1, t1, R2, t2, alpha):
    """Geodesic interpolation between two poses (quaternion slerp + linear
    translation), alpha in [0, 1]."""
    q1 = R_ops.mat_to_quat(R1)
    q2 = R_ops.mat_to_quat(R2)
    dot = (q1 * q2).sum(-1, keepdim=True)  # shortest arc
    q2 = torch.where(dot < 0, -q2, q2)
    dot = dot.abs()
    theta = torch.arccos(dot.clamp(-1.0, 1.0))
    sin_theta = torch.sin(theta).clamp_min(1e-7)
    w1 = torch.sin((1 - alpha) * theta) / sin_theta
    w2 = torch.sin(alpha * theta) / sin_theta
    small = theta[..., 0] < 1e-4  # lerp for tiny angles
    q = torch.where(small[..., None], (1 - alpha) * q1 + alpha * q2, w1 * q1 + w2 * q2)
    q = R_ops.normalize_vector(q)
    return R_ops.quat_to_mat(q), (1 - alpha) * t1 + alpha * t2


def rotations_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """Uniform [n, 3] draws in [0, 1) -> [n, 3, 3] rotations, uniform over
    SO(3) by quaternion sampling (reference transform.random_rotation_matrix
    semantics, batched)."""
    r1 = torch.sqrt(1 - u[:, 0])
    r2 = torch.sqrt(u[:, 0])
    t1 = 2 * math.pi * u[:, 1]
    t2 = 2 * math.pi * u[:, 2]
    q = torch.stack([r2 * torch.cos(t2), r1 * torch.sin(t1),
                     r1 * torch.cos(t1), r2 * torch.sin(t2)], dim=-1)
    return R_ops.quat_to_mat(q)


def random_rotations(generator: torch.Generator, n: int) -> torch.Tensor:
    """n uniform random rotations [n, 3, 3] from `generator`, on its device."""
    return rotations_from_uniforms(torch.rand((n, 3), generator=generator,
                                              device=generator.device))
