"""The rest of the geometry and the variants' modules of gdrnet_tpu_torch
against gdrnet_tpu on the CPU, from seeded numpy inputs, in f32.

- Every rotation and pose function the GDRN variants use, at rtol 1e-5 /
  atol 1e-6 (the same f32 formulas).
- Finite gradients where so3_exp, quat_exp and mat_to_euler branch (omega
  and v at 0 and 1e-8, rotations at the gimbal).
- The Bottleneck ResNet-50 with its 64/32/16 skips, the concat geometry
  head, TransHeadNet, PointPnPNet with every pooling (and region SoftPool)
  and SimplePointPnPNet with max and SoftPool, with the JAX module's
  weights carried by utils.jax_convert: rtol 1e-4 / atol 1e-5 of the
  output's scale, as tests/test_torch_model.py holds the other modules.
  SoftPool and top-k inputs are drawn without ties (torch.topk and
  jax.lax.top_k may order equal values differently).
- TEST.INT8 on the variants: the calibrated layers and their scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.models import heads as jheads
from gdrnet_tpu.models import point_pnp_net as jpoint
from gdrnet_tpu.models import resnet as jresnet
from gdrnet_tpu.ops import pose as jpose
from gdrnet_tpu.ops import rotation as jrot

from gdrnet_tpu_torch.models import heads, point_pnp_net, resnet
from gdrnet_tpu_torch.ops import pose, rotation

from gdrnet_tpu_torch.models import gdrn

from test_torch_variants_gdrn import VARIANTS, jax_variables, small_batch, variant_cfg
from torch_parity import init_shapes, load_port, nchw, randomize

T = torch.from_numpy
GEOM = dict(rtol=1e-5, atol=1e-6)
MODULE = dict(rtol=1e-4, atol=1e-5)


def _rotations(rng, n):
    Q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (Q * np.sign(np.linalg.det(Q))[:, None, None]).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or GEOM))


def _scaled_close(got, want):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-12)
    _close(np.asarray(got) / scale, np.asarray(want) / scale, **MODULE)


def _trans(rng, n):
    t = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    t[:, 2] = rng.uniform(0.5, 1.5, n)
    return t


# ---------------------------------------------------------------------------
# ops/rotation.py
# ---------------------------------------------------------------------------

def _quats(rng, n):
    return rng.randn(n, 4).astype(np.float32)


ROTATION_CASES = {
    "mat_to_ortho6d": lambda rng: [_rotations(rng, 16)],
    "mat_to_quat": lambda rng: [np.concatenate([_rotations(rng, 16), np.eye(3, dtype=np.float32)[
        None], np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None],
        np.diag([-1.0, 1.0, -1.0]).astype(np.float32)[None]])],
    "quat_mul": lambda rng: [_quats(rng, 16), _quats(rng, 16)],
    "quat_conjugate": lambda rng: [_quats(rng, 16)],
    "quat_exp": lambda rng: [np.concatenate([rng.randn(14, 4), np.zeros((2, 4))]).astype(
        np.float32)],
    "quat_exp_pure": lambda rng: [rng.randn(16, 3).astype(np.float32)],
    "qrot_points": lambda rng: [
        (lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True))(_quats(rng, 4)),
        rng.randn(4, 20, 3).astype(np.float32)],
    "axangle_to_mat": lambda rng: [rng.randn(16, 3).astype(np.float32),
                                   rng.uniform(-3, 3, 16).astype(np.float32)],
    "axangle_to_quat": lambda rng: [rng.randn(16, 3).astype(np.float32),
                                    rng.uniform(-3, 3, 16).astype(np.float32)],
    "so3_exp": lambda rng: [np.concatenate([rng.randn(13, 3), np.zeros((1, 3)),
                                            np.full((1, 3), 1e-8), np.full((1, 3), 1e-3)]
                                           ).astype(np.float32)],
    "so3_log": lambda rng: [_rotations(rng, 16)],
    "skew": lambda rng: [rng.randn(16, 3).astype(np.float32)],
    "euler_to_mat": lambda rng: [rng.uniform(-3, 3, 16).astype(np.float32) for _ in range(3)],
    "mat_to_euler": lambda rng: [np.concatenate([
        _rotations(rng, 14),
        np.asarray(jrot.euler_to_mat(jnp.asarray([0.3, -1.1]), jnp.asarray([np.pi / 2] * 2),
                                     jnp.asarray([0.0, 0.0])))]).astype(np.float32)],
    "allo_to_ego_quat": lambda rng: [_trans(rng, 16), (lambda q: q / np.linalg.norm(
        q, axis=-1, keepdims=True))(_quats(rng, 16))],
    "ego_to_allo_mat": lambda rng: [_trans(rng, 16), _rotations(rng, 16)],
}


@pytest.mark.parametrize("name", list(ROTATION_CASES))
def test_rotation_function_matches_jax(rng, name):
    args = ROTATION_CASES[name](rng)
    fn = name.replace("_pure", "")
    want = getattr(jrot, fn)(*map(jnp.asarray, args))
    got = getattr(rotation, fn)(*map(T, args))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    else:
        assert got.shape == want.shape
        _close(got.numpy(), want)


def test_mat_to_quat_round_trips(rng):
    R = _rotations(rng, 64)
    back = rotation.quat_to_mat(rotation.mat_to_quat(T(R)))
    _close(back.numpy(), R, rtol=0, atol=2e-6)
    so3 = rotation.so3_exp(rotation.so3_log(T(R)))
    _close(so3.numpy(), R, rtol=0, atol=1e-5)


def _grad_of(fn, x: np.ndarray) -> np.ndarray:
    t = torch.tensor(x, requires_grad=True)
    out = fn(t)
    out = torch.stack(out) if isinstance(out, tuple) else out
    (out.reshape(-1) * torch.linspace(0.5, 1.5, 18)[:out.numel()]).sum().backward()
    return t.grad.numpy()


@pytest.mark.parametrize("value", [0.0, 1e-8])
def test_exp_gradients_finite_at_zero(value):
    """Finite, and JAX's, at omega = 0 and 1e-8 (where the JAX package's
    guard keeps its own gradients finite too)."""
    omega = np.full((2, 3), value, np.float32)
    w = np.linspace(0.5, 1.5, 18, dtype=np.float32)
    cases = ((rotation.so3_exp, jrot.so3_exp, omega),
             (rotation.quat_exp, jrot.quat_exp, omega),
             (rotation.quat_exp, jrot.quat_exp,
              np.concatenate([np.ones((2, 1), np.float32), omega], 1)),
             (lambda v: rotation.quat_to_mat(rotation.quat_exp(v)),
              lambda v: jrot.quat_to_mat(jrot.quat_exp(v)), omega))
    for fn, jfn, x in cases:
        g = _grad_of(fn, x)
        assert np.all(np.isfinite(g)), (fn, value, g)
        want = jax.grad(lambda v: (jfn(v).reshape(-1) * w[:jfn(v).size]).sum())(jnp.asarray(x))
        _close(g, want, rtol=1e-5, atol=1e-6)


def test_mat_to_euler_gradient_finite_at_the_gimbal(rng):
    gimbal = rotation.euler_to_mat(torch.tensor([0.3, 0.0, -2.0]),
                                   torch.tensor([np.pi / 2, -np.pi / 2, np.pi / 2]),
                                   torch.tensor([0.0, 0.0, 0.0]))
    cases = [gimbal.numpy().astype(np.float32), _rotations(rng, 4),
             np.eye(3, dtype=np.float32)[None], np.diag([-1.0, -1.0, 1.0]).astype(np.float32)[
                 None]]
    for R in cases:
        g = _grad_of(lambda r: rotation.mat_to_euler(r), R)
        assert np.all(np.isfinite(g)), (R, g)
    # the values there are the JAX package's
    want = jrot.mat_to_euler(jnp.asarray(cases[0]))
    for g, w in zip(rotation.mat_to_euler(T(cases[0])), want):
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# ops/pose.py
# ---------------------------------------------------------------------------


def _cams(n):
    return np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
                   (n, 1, 1))


@pytest.mark.parametrize("is_allo", [True, False])
@pytest.mark.parametrize("rep", ["mat", "quat"])
def test_pose_decodes_match_jax(rng, is_allo, rep):
    B = 8
    rots = _rotations(rng, B) if rep == "mat" else _quats(rng, B)
    cams = _cams(B)
    cent = rng.randn(B, 2).astype(np.float32) * 0.1
    z = rng.uniform(0.5, 1.5, B).astype(np.float32)
    centers = rng.uniform(100, 400, (B, 2)).astype(np.float32)
    ratios = rng.uniform(0.2, 1.0, B).astype(np.float32)
    whs = rng.uniform(50, 150, (B, 2)).astype(np.float32)
    pix = rng.uniform(100, 500, (B, 2)).astype(np.float32)
    cases = {
        "pose_from_centroid_z": [rots, cent, z, cams, centers, ratios, whs],
        "pose_from_centroid_z_abs": [rots, pix, z, cams],
        "pose_from_pred": [rots, _trans(rng, B)],
    }
    for name, args in cases.items():
        want_r, want_t = getattr(jpose, name)(*map(jnp.asarray, args), is_allo=is_allo)
        got_r, got_t = getattr(pose, name)(*map(T, args), is_allo=is_allo)
        _close(got_r.numpy(), want_r)
        _close(got_t.numpy(), want_t)


def test_point_projections_match_jax(rng):
    B, N = 4, 30
    pts = rng.randn(B, N, 3).astype(np.float32) * 0.1
    R, t, K = _rotations(rng, B), _trans(rng, B), _cams(B)
    _close(pose.project_points(T(pts), T(K), T(R), T(t)).numpy(),
           jpose.project_points(*map(jnp.asarray, (pts, K, R, t))), rtol=1e-5, atol=1e-4)
    _close(pose.project_points(T(pts + [0, 0, 1]), T(K)).numpy(),
           jpose.project_points(jnp.asarray(pts + [0, 0, 1]), jnp.asarray(K)), rtol=1e-5,
           atol=1e-4)
    _close(pose.centroids_from_poses(T(t), T(K)).numpy(),
           jpose.centroids_from_poses(jnp.asarray(t), jnp.asarray(K)), rtol=1e-5, atol=1e-4)
    depth = rng.uniform(0.5, 1.5, (24, 32)).astype(np.float32)
    depth[rng.rand(24, 32) < 0.3] = 0.0
    args = (depth, R[0], t[0], K[0])
    _close(pose.backproject_depth_to_xyz(*map(T, args)).numpy(),
           jpose.backproject_depth_to_xyz(*map(jnp.asarray, args)), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rot_concat", [False, True])
def test_bottleneck_resnet50_matches_jax(rng, rot_concat):
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    jm = jresnet.ResNetBackbone(depth=50, rot_concat=rot_concat)
    params, stats = randomize(init_shapes(jm, jnp.asarray(x)), seed=1)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = load_port(resnet.ResNetBackbone(50, rot_concat=rot_concat), params, stats,
                     prefix="backbone")
    assert "layer1.0.conv3.weight" in port.state_dict()
    assert "layer1.0.downsample.1.running_var" in port.state_dict()
    with torch.no_grad():
        got = port(T(nchw(x)))
    got, want = (got, want) if rot_concat else ((got,), (want,))
    assert [g.shape[1] for g in got] == ([2048, 256, 512, 1024] if rot_concat else [2048])
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), nchw(w))


def test_concat_head_matches_jax(rng):
    """ROT_CONCAT: skips of 16, 32 and 64 px concatenated before each round,
    an upsample in every round, 128 px maps."""
    kw = dict(rot_output_dim=3, mask_output_dim=1, region_output_dim=9, num_filters=32,
              norm="BN", concat=True)
    x = rng.randn(2, 2, 2, 64).astype(np.float32)
    f16, f32, f64 = (rng.randn(2, s, s, c).astype(np.float32)
                     for s, c in ((4, 24), (8, 16), (16, 8)))
    jm = jheads.RotWithRegionHead(**kw)
    jx = [jnp.asarray(a) for a in (x, f64, f32, f16)]
    params, stats = randomize(init_shapes(jm, *jx), seed=2)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, *jx)
    kw.pop("concat")
    port = heads.RotWithRegionHead(64, concat_channels=(24, 16, 8), **kw)
    port = load_port(port, params, stats, prefix="rot_head")
    with torch.no_grad():
        got = port(T(nchw(x)), (T(nchw(f16)), T(nchw(f32)), T(nchw(f64))))
    assert got.shape[-1] == 32  # 2 -> 4 (deconv) -> 8 -> 16 -> 32
    _scaled_close(got.numpy(), nchw(want))


def test_trans_head_matches_jax(rng):
    """TransHeadNet, fc1 holding the (H, W, C) -> (C, H, W) flatten reorder."""
    x = rng.randn(3, 4, 4, 48).astype(np.float32)
    jm = jheads.TransHeadNet(num_filters=16)
    params, stats = randomize(init_shapes(jm, jnp.asarray(x)), seed=3)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = heads.TransHeadNet(48, num_filters=16, flat_hw=16)
    port = load_port(port, params, stats, prefix="trans_head")
    assert set(port.state_dict()) >= {"features.0.weight", "features.1.running_mean",
                                      "features.6.weight", "fc1.weight", "fc3.bias"}
    with torch.no_grad():
        got = port(T(nchw(x)))
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    _scaled_close(got.numpy(), want)


def _point_inputs(rng, b=2, hw=8, c=5, m=4):
    # distinct values everywhere: no ties for top-k or SoftPool's ranking
    coor = rng.permutation(b * hw * hw * c).reshape(b, hw, hw, c).astype(np.float32)
    coor = coor / coor.max()
    region = rng.rand(b, hw, hw, m).astype(np.float32)
    region = np.exp(4 * region) / np.exp(4 * region).sum(-1, keepdims=True)
    ext = rng.uniform(0.05, 0.15, (b, 3)).astype(np.float32)
    att = rng.rand(b, hw, hw, 1).astype(np.float32)
    return coor, region, ext, att


def _no_ties_in(x: np.ndarray, axis: int) -> bool:
    s = np.sort(x, axis=axis)
    return bool(np.all(np.diff(s, axis=axis) != 0))


@pytest.mark.parametrize("pool,topk,region_softpool", [
    ("max", 1, False), ("mean", 1, False), ("topk", 3, False), ("soft", 2, False),
    ("max", 1, True)])
def test_point_pnp_net_matches_jax(rng, pool, topk, region_softpool):
    coor, region, ext, att = _point_inputs(rng)
    kw = dict(rot_dim=4, num_regions=4, spatial_pooltype=pool, spatial_topk=topk,
              region_softpool=region_softpool, region_topk=3)
    jm = jpoint.PointPnPNet(**kw)
    jargs = [jnp.asarray(a) for a in (coor, region, ext, att)]
    params, _ = randomize(init_shapes(jm, *jargs), seed=4)
    want_r, want_t = jax.jit(jm.apply)({"params": params}, *jargs)
    port = load_port(point_pnp_net.PointPnPNet(5, **kw), params, {}, prefix="pnp_net")
    with torch.no_grad():
        got_r, got_t = port(*[T(nchw(a)) if a.ndim == 4 else T(a)
                              for a in (coor, region, ext, att)])
    _scaled_close(got_r.numpy(), want_r)
    _scaled_close(got_t.numpy(), want_t)


@pytest.mark.parametrize("softpool,mask_att", [(False, "none"), (False, "concat"),
                                               (True, "mul")])
def test_simple_point_pnp_net_matches_jax(rng, softpool, mask_att):
    coor, region, ext, att = _point_inputs(rng)
    kw = dict(rot_dim=6, use_softpool=softpool, softpool_topk=4, mask_attention_type=mask_att)
    jm = jpoint.SimplePointPnPNet(**kw)
    jargs = [jnp.asarray(a) for a in (coor, region, ext, att)]
    params, _ = randomize(init_shapes(jm, *jargs), seed=5)
    want_r, want_t = jax.jit(jm.apply)({"params": params}, *jargs)
    n_in = 5 + 4 + (1 if mask_att == "concat" else 0)
    port = load_port(point_pnp_net.SimplePointPnPNet(n_in, **kw), params, {},
                     prefix="pnp_net")
    with torch.no_grad():
        got_r, got_t = port(*[T(nchw(a)) if a.ndim == 4 else T(a)
                              for a in (coor, region, ext, att)])
    _scaled_close(got_r.numpy(), want_r)
    _scaled_close(got_t.numpy(), want_t)


def test_soft_pool_and_topk_pool_match_jax(rng):
    x = rng.permutation(2 * 40 * 6).reshape(2, 40, 6).astype(np.float32) / 480.0
    assert _no_ties_in(np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1)), axis=1)
    _close(point_pnp_net.soft_pool(T(x), 5).numpy(), jpoint.soft_pool(jnp.asarray(x), 5))
    y = rng.permutation(2 * 3 * 40 * 6).reshape(2, 3, 40, 6).astype(np.float32)
    _close(point_pnp_net.topk_pool(T(y), 4).numpy(), jpoint.topk_pool(jnp.asarray(y), 4))
    # gradients flow through the gather
    t = T(x).requires_grad_()
    point_pnp_net.soft_pool(t, 5).sum().backward()
    assert float(t.grad.abs().sum()) > 0


@pytest.mark.parametrize("variant", ["R50+R_ONLY", "PointPnPNet", "SimplePointPnPNet",
                                     "ROT_CONCAT"])
def test_int8_layers_and_scales_match_jax(variant):
    """TEST.INT8 on the variants: the layers the port calibrates are the JAX
    recipe's (its out_conv, fc_r / fc_t / fc_pose, TransHeadNet's fc_out and
    the point heads' MLP layers stay off), with the same activation scales
    at rtol 1e-4."""
    from gdrnet_tpu.models.quantize import calibrate_act_scales as jax_calibrate

    from gdrnet_tpu_torch.models.quantize import calibrate_act_scales
    from gdrnet_tpu_torch.utils.jax_convert import jax_scales_to_torch

    overrides = {"R50+R_ONLY": {**VARIANTS["R50"], **VARIANTS["R_ONLY"]}}.get(
        variant, VARIANTS.get(variant))
    cfg = variant_cfg(overrides)
    batch = small_batch(seed=16, n=2)
    jm, (params, stats) = jax_variables(cfg, batch, seed=17)
    want = jax_scales_to_torch(
        jax_calibrate(jm, {"params": params, "batch_stats": stats},
                      [{k: jnp.asarray(v) for k, v in batch.items()}]),
        rot_concat=cfg.MODEL.CDPN.ROT_HEAD.ROT_CONCAT)
    port = load_port(gdrn.build_model(cfg, device="cpu"), params, stats)
    got = calibrate_act_scales(port, [batch])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    if variant == "R50+R_ONLY":
        assert {"trans_head_net.fc1", "trans_head_net.fc2"} <= set(got)
        assert "trans_head_net.fc3" not in got and "backbone.layer1.0.conv3" in got
    if "Point" in variant:
        assert "pnp_net.fc1" in got and not any(k.startswith("pnp_net.conv") for k in got)
