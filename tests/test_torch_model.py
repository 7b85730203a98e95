"""gdrnet_tpu_torch modules against their gdrnet_tpu counterparts on the CPU:
the rotation / pose / symmetry ops, backbone, geometry head with
split_outputs, ConvPnPNet and the GDRN forward, with the same seeded numpy
inputs and the same weights (carried by utils.jax_convert), in f32.

Tolerances: 1e-5 relative on the geometry ops (same f32 formulas); conv
stacks differ by the two libraries' f32 conv algorithms, so module outputs
are held at rtol 1e-4 / atol 1e-5 of their O(1) scale unless a test says
otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.models import conv_pnp_net as jconv_pnp
from gdrnet_tpu.models import gdrn as jgdrn
from gdrnet_tpu.models import heads as jheads
from gdrnet_tpu.models import layers as jlayers
from gdrnet_tpu.models import resnet as jresnet
from gdrnet_tpu.ops import pose as jpose
from gdrnet_tpu.ops import rotation as jrot
from gdrnet_tpu.ops import symmetry as jsym
from gdrnet_tpu.utils.torch_convert import convert_torch_state_dict

from gdrnet_tpu_torch.models import conv_pnp_net, gdrn, heads, layers, resnet
from gdrnet_tpu_torch.ops import pose, rotation, symmetry
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch

from torch_parity import init_shapes, load_port, nchw, randomize, small_flagship_cfg

T = torch.from_numpy


def _rotations(rng, n):
    Q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (Q * np.sign(np.linalg.det(Q))[:, None, None]).astype(np.float32)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["normalize_vector", "ortho6d_to_mat", "quat_to_mat",
                                  "allo_to_ego_mat", "rot_angle_deg", "safe_norm"])
def test_rotation_op_matches_jax(rng, name):
    B = 16
    if name == "normalize_vector":
        args = [rng.randn(B, 3).astype(np.float32)]
        args[0][0] = 0.0  # the eps floor
    elif name == "safe_norm":
        args = [rng.randn(B, 5).astype(np.float32)]
    elif name == "ortho6d_to_mat":
        args = [rng.randn(B, 6).astype(np.float32)]
    elif name == "quat_to_mat":
        args = [rng.randn(B, 4).astype(np.float32)]
    elif name == "allo_to_ego_mat":
        t = (rng.randn(B, 3) * 0.1 + [0, 0, 0.8]).astype(np.float32)
        t[0] = [0.0, 0.0, 0.7]  # on the optical axis: the axis norm hits eps
        args = [t, _rotations(rng, B)]
    else:
        args = [_rotations(rng, B), _rotations(rng, B)]
    want = getattr(jrot, name)(*map(jnp.asarray, args))
    got = getattr(rotation, name)(*map(T, args))
    _close(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("offset", [0.0, 1e-4, 2e-4])
def test_allo_to_ego_gradient_is_finite_near_the_optical_axis(rng, offset):
    """A ray within about 3.5e-4 of the optical axis rounds to z = 1, where
    arccos has an infinite gradient: the JAX package's translation gradient
    is not finite there, so its train step skips such a batch; the port
    clamps z below 1 and its gradients stay finite (ROADMAP.md section C).
    Off the axis the port equals JAX (test_rotation_op_matches_jax)."""
    t = np.array([[offset, 0.0, 0.9]], np.float32)
    R = _rotations(rng, 1)
    w = rng.randn(1, 3, 3).astype(np.float32)
    jgrad = jax.grad(lambda tt: (jrot.allo_to_ego_mat(tt, jnp.asarray(R)) * w).sum())(
        jnp.asarray(t))
    tt = T(t).requires_grad_(True)
    (rotation.allo_to_ego_mat(tt, T(R)) * T(w)).sum().backward()
    assert torch.isfinite(tt.grad).all(), tt.grad
    assert not np.isfinite(np.asarray(jgrad)).all(), jgrad


@pytest.mark.parametrize("z_type", ["REL", "ABS"])
def test_translation_from_centroid_z_matches_jax(rng, z_type):
    B = 8
    args = [rng.randn(B, 2).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, (B, 1)).astype(np.float32),
            np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                             np.float32), (B, 1, 1)),
            rng.uniform(100, 400, (B, 2)).astype(np.float32),
            rng.uniform(0.2, 1.0, B).astype(np.float32),
            rng.uniform(50, 150, (B, 2)).astype(np.float32)]
    want = jpose.translation_from_centroid_z(*map(jnp.asarray, args), z_type=z_type)
    got = pose.translation_from_centroid_z(*map(T, args), z_type=z_type)
    _close(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("is_allo", [True, False])
def test_pose_from_centroid_z_matches_jax(rng, is_allo):
    B = 8
    args = [_rotations(rng, B), rng.randn(B, 2).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, B).astype(np.float32),
            np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                             np.float32), (B, 1, 1)),
            rng.uniform(100, 400, (B, 2)).astype(np.float32),
            rng.uniform(0.2, 1.0, B).astype(np.float32),
            rng.uniform(50, 150, (B, 2)).astype(np.float32)]
    want_r, want_t = jpose.pose_from_centroid_z(*map(jnp.asarray, args), is_allo=is_allo)
    got_r, got_t = pose.pose_from_centroid_z(*map(T, args), is_allo=is_allo)
    _close(got_r.numpy(), want_r, rtol=1e-5, atol=1e-6)
    _close(got_t.numpy(), want_t, rtol=1e-6, atol=1e-7)


def test_pose_from_centroid_z_quaternion_not_ported():
    with pytest.raises(NotImplementedError, match="A12"):
        pose.pose_from_centroid_z(torch.zeros(2, 4), *[torch.zeros(2, 2)] * 2,
                                  torch.zeros(2, 3, 3), torch.zeros(2, 2), torch.ones(2),
                                  torch.ones(2, 2))


@pytest.mark.parametrize("k", [None, 1, 5])
def test_identity_padded_sym_arrays_equal_jax(rng, k):
    srots = None if k is None else _rotations(rng, k)
    for got, want in zip(symmetry.identity_padded_sym_arrays(srots, 3),
                         jsym.identity_padded_sym_arrays(srots, 3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_get_closest_rot_batch_matches_jax(rng, masked):
    B, K = 12, 6
    pred, gt = _rotations(rng, B), _rotations(rng, B)
    sym = _rotations(rng, B * K).reshape(B, K, 3, 3)
    sym[:, 0] = np.eye(3)
    mask = rng.rand(B, K) < 0.6 if masked else np.ones((B, K), bool)
    mask[:, 0] = True
    want = jsym.get_closest_rot_batch(*map(jnp.asarray, (pred, gt, sym, mask)))
    got = symmetry.get_closest_rot_batch(*map(T, (pred, gt, sym, mask)))
    _close(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask_loss_type,ch", [("L1", 1), ("BCE", 1), ("CE", 2)])
def test_get_mask_prob_matches_jax(rng, mask_loss_type, ch):
    logits = rng.randn(3, 8, 8, ch).astype(np.float32)
    want = jgdrn.get_mask_prob(jnp.asarray(logits), mask_loss_type)
    got = gdrn.get_mask_prob(T(nchw(logits)), mask_loss_type)
    _close(nchw(want), got.numpy(), rtol=1e-6, atol=1e-6)


def test_decode_rot_other_types_not_ported():
    with pytest.raises(NotImplementedError, match="A12"):
        gdrn.decode_rot(torch.zeros(2, 4), "allo_quat")
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.PNP_NET.ROT_TYPE = "allo_quat"
    with pytest.raises(NotImplementedError, match="A12"):
        gdrn.build_model(cfg, device="cpu")
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.type = "PointPnPNet"
    with pytest.raises(NotImplementedError, match="A12"):
        gdrn.build_model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# layers and modules
# ---------------------------------------------------------------------------


def test_upsample_matches_jax(rng):
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    want = jlayers.upsample_bilinear_align_corners(jnp.asarray(x), 2)
    got = layers.UpsampleBilinear2x()(T(nchw(x)))
    _close(got.numpy(), nchw(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth,res", [(18, 64), (34, 32)])
def test_backbone_matches_jax(rng, depth, res):
    x = rng.rand(2, res, res, 3).astype(np.float32)
    jm = jresnet.ResNetBackbone(depth=depth)
    params, stats = randomize(init_shapes(jm, jnp.asarray(x)), seed=1)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = load_port(resnet.ResNetBackbone(depth), params, stats, prefix="backbone")
    with torch.no_grad():
        got = port(T(nchw(x)))
    scale = float(np.abs(want).max())
    _close(got.numpy() / scale, nchw(want) / scale)


@pytest.mark.parametrize("norm,class_aware", [("BN", False), ("GN", True)])
def test_rot_head_and_split_outputs_match_jax(rng, norm, class_aware):
    ncls = 3
    kw = dict(rot_output_dim=3, mask_output_dim=1, region_output_dim=9,
              num_filters=32, norm=norm, num_gn_groups=8, num_classes=ncls,
              rot_class_aware=class_aware, mask_class_aware=class_aware,
              region_class_aware=class_aware)
    x = rng.randn(2, 4, 4, 64).astype(np.float32)
    classes = rng.randint(0, ncls, 2).astype(np.int32)
    jm = jheads.RotWithRegionHead(**kw)
    params, stats = randomize(init_shapes(jm, jnp.asarray(x)), seed=2)
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    want_split = jm.apply(variables, want, jnp.asarray(classes), method="split_outputs")

    port = load_port(heads.RotWithRegionHead(64, **kw), params, stats, prefix="rot_head",
                     head_norm=norm)
    with torch.no_grad():
        got = port(T(nchw(x)))
    got_split = port.split_outputs(got, T(classes))
    scale = float(np.abs(want).max())
    _close(got.numpy() / scale, nchw(want) / scale)
    for g, w in zip(got_split, want_split):
        assert g.shape == nchw(w).shape
        _close(g.numpy() / scale, nchw(w) / scale)


@pytest.mark.parametrize("in_c,region,mask_att", [(5, True, "none"), (8, False, "mul"),
                                                  (3, True, "concat")])
def test_conv_pnp_net_matches_jax(rng, in_c, region, mask_att):
    B, hw, R = 2, 16, 8
    coor = rng.rand(B, hw, hw, in_c).astype(np.float32)
    reg = rng.rand(B, hw, hw, R).astype(np.float32) if region else None
    ext = rng.uniform(0.05, 0.15, (B, 3)).astype(np.float32)
    att = rng.rand(B, hw, hw, 1).astype(np.float32) if mask_att != "none" else None
    kw = dict(rot_dim=6, featdim=32, num_gn_groups=8, mask_attention_type=mask_att)
    jm = jconv_pnp.ConvPnPNet(**kw)
    jargs = [jnp.asarray(coor), None if reg is None else jnp.asarray(reg), jnp.asarray(ext),
             None if att is None else jnp.asarray(att)]
    params, _ = randomize(init_shapes(jm, *jargs), seed=3)
    want_r, want_t = jax.jit(jm.apply)({"params": params}, *jargs)

    n_in = in_c + (R if region else 0) + (1 if mask_att == "concat" else 0)
    port = load_port(conv_pnp_net.ConvPnPNet(n_in, flat_hw=(hw // 8) ** 2, **kw),
                     params, {}, prefix="pnp_net")
    with torch.no_grad():
        got_r, got_t = port(T(nchw(coor)), None if reg is None else T(nchw(reg)), T(ext),
                            None if att is None else T(nchw(att)))
    _close(got_r.numpy(), want_r)
    _close(got_t.numpy(), want_t)


def _small_models(seed):
    cfg = small_flagship_cfg()
    jm = jgdrn.build_model(cfg)
    from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch

    batch = synthetic_roi_batch(batch_size=3, input_res=64, out_res=16, num_classes=10,
                                seed=seed)
    keys = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
            "roi_extents", "resize_ratios")
    params, stats = randomize(init_shapes(jm, jnp.asarray(batch["roi_img"]),
                                          **{k: jnp.asarray(batch[k]) for k in keys}),
                              seed=seed)
    port = load_port(gdrn.build_model(cfg, device="cpu"), params, stats)
    return cfg, jm, {"params": params, "batch_stats": stats}, port, batch, keys


def test_gdrn_forward_matches_jax():
    _, jm, variables, port, batch, keys = _small_models(seed=4)
    want = jax.jit(jm.apply)(variables, jnp.asarray(batch["roi_img"]),
                             **{k: jnp.asarray(batch[k]) for k in keys})
    with torch.no_grad():
        got = port(T(batch["roi_img"]), **{k: T(batch[k]) for k in keys})
    for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
        assert got[k].shape == want[k].shape, k
        scale = float(np.abs(want[k]).max())
        _close(got[k].numpy() / scale, np.asarray(want[k]) / scale)
    for k in ("pred_rot_param", "pred_t_", "trans"):
        _close(got[k].numpy(), want[k])
    # R is a normalized cross product of the rot6d columns: its absolute error
    # is rot6d's relative error over the sine of the angle between them
    _close(got["rot"].numpy(), want["rot"], rtol=1e-4, atol=1e-4)


def test_jax_convert_round_trip_is_exact():
    cfg, _, variables, port, _, _ = _small_models(seed=5)
    sd = jax_to_torch(variables["params"], variables["batch_stats"])
    assert set(sd) == set(port.state_dict())
    params, stats = convert_torch_state_dict(sd, head_norm="BN", pnp_norm="GN")

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    for want, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        want, got = dict(flat(want)), dict(flat(got))
        assert set(want) == set(got)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg="/".join(path))
