"""The port's serving extras against the JAX package on the CPU: the BN fold
(utils/fold_bn.py), int8 post-training quantization (models/quantize.py),
do_test with TEST.FOLD_BN and TEST.INT8, and the predict CLI.

Model-level cases use the small flagship config (tests/torch_parity.py: R18
at 64x64, f32) with He-normal weights and BN statistics from a seed; the
do_test and CLI cases use tests/test_torch_tester.py's fixture split,
config and PRNGKey(0) weights as a reference-layout .pth.

Tolerances: the folded state_dict against JAX's fold_variables rtol 2e-6
on the kernels, 2e-5 / atol 1e-6 on the BN biases (tests/test_fold_bn.py's
bounds; the port folds in float64 like JAX's numpy fold, fold_variables in
f32); the folded f32 forward within 2e-4 of the unfolded one
(tests/test_fold_bn.py); int32 accumulators bitwise; calibration scales
1e-6 relative. The int8 forward against JAX's int8 forward on the same
weights and scales, f32, on tests/test_quantize.py's setup: rotations
within 1e-4 and translations within 1e-4 relative, as the f32 forwards
(measured 2.3e-7 and 2.1e-7). The two f32 activation streams differ in
their last bits, so a round(x / s) could land on the other side of a
half-way point; test_int8_forward_matches_jax counts those flips (0 of
1,404,928 layer inputs here) and allows at most 1e-4 of them, and
do_test / predict hold their CSVs to the same 1e-4. The int8 forward
against the port's own bf16 forward: rotation under 1 degree and
translation within 0.05 relative (tests/test_quantize.py:97-113).
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import linen as fnn
from jax import lax

from gdrnet_tpu.engine.steps import make_predict_step as jax_make_predict_step
from gdrnet_tpu.models.gdrn import build_model as jax_build_model
from gdrnet_tpu.models.quantize import calibrate_act_scales as jax_calibrate
from gdrnet_tpu.models.quantize import make_int8_interceptor
from gdrnet_tpu.utils.fold_bn import fold_variables

from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine import do_test
from gdrnet_tpu_torch.engine import tester as port_tester
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results
from gdrnet_tpu_torch.models import quantize as Q
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.ops.rotation import rot_angle_deg
from gdrnet_tpu_torch.tools import predict as port_predict
from gdrnet_tpu_torch.utils.fold_bn import BN_EPS, conv_bn_pairs, fold_batch_norms
from gdrnet_tpu_torch.utils.jax_convert import (
    jax_scales_to_torch,
    jax_to_torch,
    torch_scales_to_jax,
)

from test_torch_tester import _cfg, _jax_cfg, _port_model, fix, weights  # noqa: F401
from torch_parity import REPO, init_shapes, load_port, randomize, small_flagship_cfg

MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")
FOLD_KERNEL_RTOL, FOLD_BIAS_RTOL, FOLD_BIAS_ATOL, FOLD_POSE_ATOL = 2e-6, 2e-5, 1e-6, 2e-4
SCALE_RTOL = 1e-6
# int8 forward, port against JAX on the same weights and scales, f32
INT8_ROT_ATOL, INT8_TRANS_RTOL = 1e-4, 1e-4
INT8_VS_BF16_DEG, INT8_VS_BF16_TRANS_REL = 1.0, 0.05
CSV_POSE_ATOL, CSV_TRANS_RTOL = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    """The small flagship config, one batch, and the same seeded weights in
    the JAX model and the port's (tests/test_torch_slice.py's recipe)."""
    cfg = small_flagship_cfg()
    batch = synthetic_roi_batch(batch_size=12, input_res=64, out_res=16, num_classes=10,
                                seed=3)
    jm = jax_build_model(cfg)
    params, stats = randomize(init_shapes(jm, jnp.asarray(batch["roi_img"]),
                                          **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS}),
                              seed=11)
    port = load_port(build_model(cfg, device="cpu"), params, stats)
    return {"cfg": cfg, "batch": batch, "jm": jm,
            "variables": {"params": params, "batch_stats": stats}, "port": port,
            "jbatch": {k: jnp.asarray(v) for k, v in batch.items()},
            "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()}}


def _np(out: dict) -> dict:
    return {k: (v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# the BN fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["module", "state_dict"])
def test_fold_matches_jax_fold_variables(net, form):
    folded_j = jax.tree.map(np.asarray, fold_variables(jax.tree.map(jnp.asarray,
                                                                     net["variables"])))
    want = jax_to_torch(folded_j["params"], folded_j["batch_stats"])
    before = {k: v.clone() for k, v in net["port"].state_dict().items()}
    folded = fold_batch_norms(net["port"] if form == "module" else net["port"].state_dict())
    got = folded.state_dict() if form == "module" else folded
    assert all(torch.equal(v, net["port"].state_dict()[k]) for k, v in before.items())
    assert set(want) <= set(got)
    pairs = conv_bn_pairs(net["port"])
    assert len(pairs) == 1 + 8 * 2 + 3 + 1 + 6  # stem, blocks, downsamples, deconv, head
    convs = {c for c, *_ in pairs}
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith(".weight") and k[:-7] in convs:
            np.testing.assert_allclose(g, w.numpy(), rtol=FOLD_KERNEL_RTOL, err_msg=k)
        elif k.endswith(".bias"):
            np.testing.assert_allclose(g, w.numpy(), rtol=FOLD_BIAS_RTOL, atol=FOLD_BIAS_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w.numpy(), err_msg=k)
    assert not torch.equal(got["backbone.conv1.weight"], before["backbone.conv1.weight"])


def test_folded_forward_matches_unfolded(net):
    want = _np(make_predict_step(net["port"])(net["tbatch"]))
    got = _np(make_predict_step(fold_batch_norms(net["port"]))(net["tbatch"]))
    np.testing.assert_allclose(got["rot"], want["rot"], atol=FOLD_POSE_ATOL)
    np.testing.assert_allclose(got["trans"], want["trans"], atol=FOLD_POSE_ATOL)


def test_fold_of_a_transposed_conv_scales_its_output_channels():
    """ConvTranspose2d's weight is [in, out, kh, kw]: the fold scales dim 1.
    in == out, so scaling dim 0 would run but give another result."""
    g = torch.Generator().manual_seed(3)
    seq = nn.Sequential(nn.ConvTranspose2d(6, 6, 3, 2, 1, 1, bias=False),
                        nn.BatchNorm2d(6, eps=BN_EPS)).eval()
    with torch.no_grad():
        seq[0].weight.copy_(torch.randn(seq[0].weight.shape, generator=g))
        seq[1].running_mean.copy_(torch.randn(6, generator=g))
        seq[1].running_var.copy_(torch.rand(6, generator=g) + 0.5)
        seq[1].weight.copy_(torch.rand(6, generator=g) + 0.5)
        seq[1].bias.copy_(torch.randn(6, generator=g))
    x = torch.randn(2, 6, 5, 5, generator=g)
    folded = fold_batch_norms(seq)
    assert conv_bn_pairs(seq) == [("0", "1", True, BN_EPS)]
    with torch.no_grad():
        torch.testing.assert_close(folded(x), seq(x), rtol=1e-5, atol=1e-5)
        wrong = seq[0].weight * (seq[1].weight / torch.sqrt(seq[1].running_var + BN_EPS)
                                 ).reshape(-1, 1, 1, 1)
        assert not torch.allclose(folded[0].weight, wrong, atol=1e-3)


def test_every_bn_of_the_port_has_the_jax_eps(net):
    bns = [m for m in net["port"].modules() if isinstance(m, nn.BatchNorm2d)]
    assert bns and all(m.eps == BN_EPS == 1e-5 for m in bns)
    assert all(eps == BN_EPS for *_, eps in conv_bn_pairs(net["port"]))


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scales(net):
    want = jax_calibrate(net["jm"], net["variables"], [net["jbatch"]])
    got = Q.calibrate_act_scales(net["port"], [net["tbatch"]])
    return want, got


@pytest.fixture(scope="module")
def quant_net():
    """tests/test_quantize.py's setup: the base config at R18, 64x64, with
    2D coordinates and region attention, one batch of 4, and the JAX model's
    init at PRNGKey(0), in both packages; f32."""
    from gdrnet_tpu.engine.steps import _model_kwargs as jax_model_kwargs

    from gdrnet_tpu_torch.config import base_config

    cfg = base_config()
    net_cfg = cfg.MODEL.CDPN
    net_cfg.BACKBONE.NUM_LAYERS, net_cfg.BACKBONE.INPUT_RES = 18, 64
    net_cfg.BACKBONE.OUTPUT_RES = 16
    net_cfg.PNP_NET.WITH_2D_COORD = net_cfg.PNP_NET.REGION_ATTENTION = True
    cfg.PARALLEL.DTYPE = "float32"
    batch = synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_build_model(_jax_cfg(cfg))
    variables = jax.tree.map(np.asarray, dict(jm.init(
        {"params": jax.random.PRNGKey(0)}, jbatch["roi_img"], **jax_model_kwargs(jbatch),
        train=False)))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_to_torch(variables["params"], variables["batch_stats"]))
    return {"cfg": cfg, "jm": jm, "variables": variables, "port": port.eval(),
            "jbatch": jbatch, "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "scales": jax_calibrate(jm, variables, [jbatch])}


def test_calibration_covers_the_jax_layer_set(net, scales):
    want, got = scales
    conv = jax_scales_to_torch(want)
    assert set(got) == set(conv)
    assert torch_scales_to_jax(got).keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], conv[k], rtol=SCALE_RTOL, err_msg=k)
    head = net["port"].rot_head_net.features
    names = set(got)
    assert f"rot_head_net.features.{len(head) - 1}" not in names  # the f32 out conv
    assert "rot_head_net.features.0" not in names                  # the deconv
    assert not any(n.startswith("pnp_net.features") for n in names)
    assert {"pnp_net.fc1", "pnp_net.fc2"} <= names
    assert not names & {"pnp_net.fc_r", "pnp_net.fc_t"}
    assert sum(n.startswith("backbone") for n in names) == 1 + 8 * 2 + 3
    assert sum(n.startswith("rot_head_net") for n in names) == 6


@pytest.mark.parametrize("case", ["stem_k147_s2_p3", "3x3_s1_p1", "downsample_1x1_s2",
                                  "3x3_s2_p1", "linear"])
def test_int8_accumulators_equal_jax(case):
    """The plain int8 product (float64 conv of int8 values) against JAX's
    conv_general_dilated / dot_general with preferred_element_type=int32."""
    rng = np.random.RandomState(hash(case) % 2**31)
    if case == "linear":
        x = rng.randint(-127, 128, (5, 2048)).astype(np.int8)
        w = rng.randint(-127, 128, (96, 2048)).astype(np.int8)
        got = Q.int8_linear(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        want = lax.dot_general(jnp.asarray(x), jnp.asarray(w.T), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    else:
        c, o, k, s, p = {"stem_k147_s2_p3": (3, 64, 7, 2, 3), "3x3_s1_p1": (64, 48, 3, 1, 1),
                         "downsample_1x1_s2": (64, 128, 1, 2, 0),
                         "3x3_s2_p1": (32, 40, 3, 2, 1)}[case]
        x = rng.randint(-127, 128, (2, c, 19, 17)).astype(np.int8)
        w = rng.randint(-127, 128, (o, c, k, k)).astype(np.int8)
        got = Q.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), (s, s), (p, p)).numpy()
        want = lax.conv_general_dilated(
            jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
            (s, s), [(p, p), (p, p)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32).transpose(0, 3, 1, 2)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("c,o,k,s,p,d", [(3, 64, 7, 2, 3, 1), (16, 8, 3, 1, 1, 1),
                                         (8, 16, 1, 2, 0, 1), (4, 8, 3, 1, 2, 2)])
def test_nhwc_im2col_orders_columns_as_the_weights(c, o, k, s, p, d):
    """The CUDA path's layout on the CPU: im2col of a channels_last int8
    input in (kh, kw, C) order times the weight permuted alike (an int64
    product standing in for torch._int_mm) equals the plain conv."""
    g = torch.Generator().manual_seed(c * o + k)
    x = torch.randint(-127, 128, (2, c, 11, 13), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8)
    x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    assert x_nhwc.is_contiguous()
    cols = Q._im2col_nhwc(x_nhwc, k, k, (s, s), (p, p), (d, d))
    want = Q.int8_conv2d(x, w, (s, s), (p, p), (d, d))
    got = cols.long() @ w.permute(0, 2, 3, 1).reshape(o, -1).long().t()
    assert torch.equal(got.reshape(2, *want.shape[2:], o).permute(0, 3, 1, 2),
                       want.long())


def _jax_int8_inputs(net, scales_j: dict) -> dict:
    """Each quantized layer's input as JAX's int8 path rounds it: a recorder
    wrapped around the int8 interceptor (eager, so x / s is a division)."""
    rec = {}
    int8 = make_int8_interceptor(scales_j)

    def recorder(next_fun, args, kwargs, context):
        path = "/".join(context.module.path)
        if context.method_name == "__call__" and path in scales_j:
            rec[path] = np.asarray(jnp.clip(jnp.round(
                args[0].astype(jnp.float32) / jnp.float32(scales_j[path])), -127, 127))
        return int8(next_fun, args, kwargs, context)

    kw = {k: net["jbatch"][k] for k in MODEL_KEYS if k in net["jbatch"]}
    with fnn.intercept_methods(recorder):
        out = net["jm"].apply(net["variables"], net["jbatch"]["roi_img"], **kw, train=False)
    return rec, {k: np.asarray(out[k]) for k in ("rot", "trans")}


def test_int8_forward_matches_jax(quant_net):
    """Same weights, JAX's scales, f32: the port's int8 forward against
    JAX's. The rounding flips (an input that the two packages round to
    different int8 values) are counted: the f32 activations of the two
    libraries differ in their last bits, and a flip changes every layer
    after it."""
    net = quant_net
    scales_t = jax_scales_to_torch(net["scales"])
    rec_t = {}
    qmodel = Q.quantize_model(net["port"], scales_t)
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: rec_t.__setitem__(name, Q.quantize_input(
            args[0], mod.act_scale).numpy()))
        for name, m in qmodel.named_modules() if isinstance(m, (Q.Int8Conv2d, Q.Int8Linear))]
    got = _np(make_predict_step(qmodel)(net["tbatch"]))
    for h in hooks:
        h.remove()
    rec_j, want = _jax_int8_inputs(net, net["scales"])
    assert len(rec_t) == len(scales_t) == len(rec_j)
    flips = total = 0
    first = None
    for name_j, xj in rec_j.items():  # in call order
        if name_j == "pnp_net/fc1":  # flax flattens (H, W, C), the port (C, H, W)
            continue
        xt = rec_t[jax_scales_to_torch({name_j: 1.0}).popitem()[0]]
        xt = xt.transpose(0, 2, 3, 1) if xt.ndim == 4 else xt
        assert xt.shape == xj.shape, name_j
        n = int((xt != xj).sum())
        if n and first is None:  # the first flip is one step, at a half-way point
            first = (name_j, n, int(np.abs(xt.astype(np.int32) - xj).max()))
            assert first[2] == 1, first
        flips += n
        total += xt.size
    rel = np.linalg.norm(got["trans"] - want["trans"], axis=1) / np.linalg.norm(
        want["trans"], axis=1)
    print(f"int8 port vs JAX: {flips} of {total} layer inputs rounded differently, the "
          f"first at {first}; rot max abs {np.abs(got['rot'] - want['rot']).max():.3e}, "
          f"trans max rel {rel.max():.3e}")
    assert flips <= 1e-4 * total
    np.testing.assert_allclose(got["rot"], want["rot"], atol=INT8_ROT_ATOL)
    assert rel.max() < INT8_TRANS_RTOL, rel.max()


def test_int8_forward_tracks_bf16(quant_net):
    """tests/test_quantize.py:97-113's gates on the port: the int8 forward
    against its own bf16 forward, both on the quantized copy's source model,
    which stays as it was."""
    cfg = quant_net["cfg"]
    cfg.PARALLEL.DTYPE = "bfloat16"
    model = build_model(cfg, device="cpu")
    cfg.PARALLEL.DTYPE = "float32"
    model.load_state_dict(quant_net["port"].state_dict())
    batch = quant_net["tbatch"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = make_predict_step(model)(batch)
    q = make_predict_step(model, int8_scales=Q.calibrate_act_scales(model, [batch]))(batch)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert not any(isinstance(m, Q.Int8Conv2d) for m in model.modules())
    ang = rot_angle_deg(ref["rot"].float(), q["rot"].float())
    assert ang.max() < INT8_VS_BF16_DEG, ang
    t_ref, t_q = ref["trans"].double(), q["trans"].double()
    rel = (t_q - t_ref).abs() / t_ref.abs().clamp_min(1e-3)
    assert rel.max() < INT8_VS_BF16_TRANS_REL, rel.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_drift_on_seeded_weights_is_the_recipes(quant_net, seed):
    """tests/test_quantize.py's 1-degree gate holds on its PRNGKey(0) weights
    (test_int8_forward_tracks_bf16), not on the port's seeded init_weights:
    on the same such weights the int8 forward of either package moves the
    rotation from its own bf16 forward by more than 1 degree (measured: port
    2.109 and 1.733, JAX 1.816 and 2.130 degrees at most over 16 crops),
    the same recipe in both (ROADMAP.md section C)."""
    from gdrnet_tpu.models.quantize import calibrate_act_scales as jax_cal
    from gdrnet_tpu.ops.rotation import rot_angle_deg as jax_rot_angle_deg
    from gdrnet_tpu.utils.torch_convert import convert_torch_state_dict

    from gdrnet_tpu_torch.models.gdrn import init_weights

    cfg = quant_net["cfg"]
    cfg.PARALLEL.DTYPE = "bfloat16"
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    jm = jax_build_model(_jax_cfg(cfg))
    cfg.PARALLEL.DTYPE = "float32"
    batch = synthetic_roi_batch(batch_size=16, input_res=64, out_res=16, seed=seed)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = make_predict_step(model)(tb)
    q = make_predict_step(model, int8_scales=Q.calibrate_act_scales(model, [tb]))(tb)
    port = rot_angle_deg(ref["rot"].float(), q["rot"].float()).numpy()
    params, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    variables = {"params": params, "batch_stats": stats}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jref = jax_make_predict_step(jm)(variables, jb)
    jq = jax_make_predict_step(jm, int8_scales=jax_cal(jm, variables, [jb]))(variables, jb)
    jax_deg = np.asarray(jax_rot_angle_deg(jnp.asarray(jref["rot"], jnp.float32),
                                           jnp.asarray(jq["rot"], jnp.float32)))
    print(f"int8 vs bf16 rotation, seed {seed}: port max {port.max():.3f}, "
          f"JAX max {jax_deg.max():.3f} degrees")
    assert 1.0 < port.max() < 10.0 and 1.0 < jax_deg.max() < 10.0


def test_int8_layers_keep_the_bias_and_dtype():
    """A biased conv and a linear with inputs and weights on the int8 grid
    (per-channel max 127): the int8 path is exact."""
    rng = np.random.RandomState(1)
    conv = nn.Conv2d(4, 8, 3, 1, 1, bias=True)
    lin = nn.Linear(12, 8)
    with torch.no_grad():
        for layer in (conv, lin):
            w = torch.from_numpy(rng.randint(-127, 128, layer.weight.shape).astype(np.float32))
            w.reshape(w.shape[0], -1)[:, 0] = 127.0
            layer.weight.copy_(w)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 4, 6, 6)).astype(np.float32))
    xl = torch.from_numpy(rng.randint(-127, 128, (3, 12)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(Q.Int8Conv2d(conv, 1.0)(x), conv(x), rtol=0, atol=1e-3)
        torch.testing.assert_close(Q.Int8Linear(lin, 1.0)(xl), lin(xl), rtol=0, atol=1e-3)
        assert Q.Int8Conv2d(conv, 1.0)(x.double()).dtype == torch.float64


# ---------------------------------------------------------------------------
# do_test and the predict CLI, both packages on one .pth
# ---------------------------------------------------------------------------


def _csv_close(got_rows, want_rows, rot_atol=CSV_POSE_ATOL, trans_rtol=CSV_TRANS_RTOL):
    assert [(r["scene_id"], r["im_id"], r["obj_id"]) for r in got_rows] == \
        [(r["scene_id"], r["im_id"], r["obj_id"]) for r in want_rows]
    R_g, R_w = (np.stack([r["R"] for r in rows]) for rows in (got_rows, want_rows))
    t_g, t_w = (np.stack([r["t"] for r in rows]) for rows in (got_rows, want_rows))
    np.testing.assert_allclose(R_g, R_w, atol=rot_atol)
    np.testing.assert_allclose(t_g, t_w, rtol=trans_rtol, atol=1e-8)


@pytest.mark.parametrize("opts", [("FOLD_BN",), ("FOLD_BN", "INT8")])
def test_do_test_folded_and_int8_match_jax(fix, weights, tmp_path, opts):  # noqa: F811
    from gdrnet_tpu.engine import tester as jtester

    cfg = _cfg(fix)
    for o in opts:
        cfg.TEST[o] = True
    model, variables, path = weights
    want = jtester.do_test(_jax_cfg(cfg), model, variables, fix["jmodels"], fix["jrecs"],
                           output_dir=str(tmp_path / "jax"))
    port = _port_model(cfg, path)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = do_test(cfg, port, fix["pmodels"], fix["precs"], output_dir=str(tmp_path / "port"),
                  device="cpu")
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in before.items())
    tol = {} if "INT8" not in opts else {"rot_atol": INT8_ROT_ATOL,
                                          "trans_rtol": INT8_TRANS_RTOL}
    _csv_close(load_bop_results(got["_csv_path"]), load_bop_results(want["_csv_path"]), **tol)
    assert got["_bop"].keys() == want["_bop"].keys()


def _predict_cfg_file(tmp_path, opts: tuple) -> str:
    """tests/test_torch_tester.py's model and bucket as a config file."""
    test = ", ".join(["ROI_BATCH_SIZE=4", "LOCAL_DEVICES=1"] + [f"{o}=True" for o in opts])
    path = tmp_path / f"predict_{'_'.join(opts) or 'plain'}.py"
    path.write_text(
        "MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=32, OUTPUT_RES=8),\n"
        "                       ROT_HEAD=dict(NUM_CLASSES=2, NUM_REGIONS=4),\n"
        "                       PNP_NET=dict(NUM_PM_POINTS=64)))\n"
        "PARALLEL = dict(DTYPE='float32')\n"
        f"TEST = dict({test})\n")
    return str(path)


def _jax_predict_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_predict_tool", REPO / "tools/predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("opts", [(), ("FOLD_BN",), ("INT8", "FOLD_BN")])
def test_predict_cli_matches_jax(fix, weights, tmp_path, monkeypatch, opts):  # noqa: F811
    import gdrnet_tpu.data.ref_meta as jrm

    from gdrnet_tpu_torch.data import ref_meta

    meta = fix["jmodels"].meta
    monkeypatch.setattr(jrm, "get_meta", lambda name, data_root=None: meta)
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: fix["pmodels"].meta)
    cfg_path = _predict_cfg_file(tmp_path, opts)
    argv = ["--config-file", cfg_path, "--ckpt", weights[2], "--dataset", "fixture",
            "--dets", fix["det_path"], "--image-root", osp.join(meta.data_root, "test")]
    _jax_predict_tool().main(argv + ["--out", str(tmp_path / "jax.csv")])
    rows = port_predict.main(argv + ["--out", str(tmp_path / "port.csv")], device="cpu")
    want = load_bop_results(str(tmp_path / "jax.csv"))
    got = load_bop_results(str(tmp_path / "port.csv"))
    assert len(rows) == len(got) == len(want) == len(fix["dets"])
    tol = {} if "INT8" not in opts else {"rot_atol": INT8_ROT_ATOL,
                                          "trans_rtol": INT8_TRANS_RTOL}
    _csv_close(got, want, **tol)
    times = {}
    for r in rows:  # one time a bucket of ROI_BATCH_SIZE rows
        times.setdefault(r["time"], 0)
        times[r["time"]] += 1
    assert sorted(times.values(), reverse=True)[0] <= 4 and len(times) == -(-len(rows) // 4)


def test_predict_cli_reads_jpeg_frames_as_jax(fix, weights, tmp_path, monkeypatch):  # noqa: F811
    """The fixture's test split with its frames written as q95 JPEGs (and no
    PNG): both tools read the .jpg frames, the port through data/jpeg.py,
    and their CSVs agree as on the PNG frames."""
    import shutil

    import cv2
    import gdrnet_tpu.data.ref_meta as jrm

    from gdrnet_tpu_torch.data import jpeg, ref_meta

    meta = fix["jmodels"].meta
    monkeypatch.setattr(jrm, "get_meta", lambda name, data_root=None: meta)
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: fix["pmodels"].meta)
    split = tmp_path / "test"
    shutil.copytree(osp.join(meta.data_root, "test"), split)
    n_frames = 0
    for png in sorted(split.glob("*/rgb/*.png")):
        img = cv2.imread(str(png), cv2.IMREAD_COLOR)
        png.with_suffix(".jpg").write_bytes(
            cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes())
        png.unlink()
        n_frames += 1
    argv = ["--config-file", _predict_cfg_file(tmp_path, ()), "--ckpt", weights[2],
            "--dataset", "fixture", "--dets", fix["det_path"], "--image-root", str(split)]
    _jax_predict_tool().main(argv + ["--out", str(tmp_path / "jax.csv")])
    before = jpeg.calls["decode"]
    rows = port_predict.main(argv + ["--out", str(tmp_path / "port.csv")], device="cpu")
    assert jpeg.calls["decode"] - before >= n_frames > 0
    want = load_bop_results(str(tmp_path / "jax.csv"))
    got = load_bop_results(str(tmp_path / "port.csv"))
    assert len(rows) == len(got) == len(want) == len(fix["dets"])
    _csv_close(got, want)


def test_predict_cli_raises_for_what_waits(fix, weights, tmp_path, monkeypatch):  # noqa: F811
    """What waited for A10 runs now: TEST.LOCAL_DEVICES=2 over two replicas
    (local_devices patched to two CPU devices) splits each bucket of 4 in
    two, with the BN fold and int8 (calibrated once, on the whole first
    bucket, as JAX's tools/predict.py:79-86 does), and writes the rows of
    the one-device run (rotations within 1e-5, translations within 1e-5
    relative)."""
    from gdrnet_tpu_torch.data import ref_meta
    from gdrnet_tpu_torch.parallel import mesh

    meta = fix["pmodels"].meta
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: meta)
    argv = ["--config-file", _predict_cfg_file(tmp_path, ("INT8", "FOLD_BN")), "--ckpt",
            weights[2], "--dataset", "fixture", "--dets", fix["det_path"], "--image-root",
            osp.join(meta.data_root, "test")]
    port_predict.main(argv + ["--out", str(tmp_path / "one.csv")], device="cpu")
    monkeypatch.setattr(mesh, "local_devices", lambda device: [torch.device("cpu")] * 2)
    replicas = []
    setup = mesh.local_dp_setup

    def recorded(*args, **kwargs):
        out = setup(*args, **kwargs)
        replicas.append(len(out[1]))
        return out

    monkeypatch.setattr(port_tester, "local_dp_setup", recorded)
    port_predict.main(argv + ["--out", str(tmp_path / "two.csv"), "TEST.LOCAL_DEVICES=2"],
                      device="cpu")
    assert replicas == [2]
    _csv_close(load_bop_results(str(tmp_path / "two.csv")),
               load_bop_results(str(tmp_path / "one.csv")), rot_atol=1e-5, trans_rtol=1e-5)
    rgb = tmp_path / "000001" / "rgb"
    rgb.mkdir(parents=True)
    (rgb / "000000.jpg").write_bytes(b"")
    # a frame that is only a .jpg is read as the JAX tool reads it
    assert port_predict._rgb_path(str(tmp_path), 1, 0) == str(rgb / "000000.jpg")
