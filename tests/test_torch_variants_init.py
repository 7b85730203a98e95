"""The GDRN variants' state dicts and init, port against gdrnet_tpu on the
CPU (the small flagship of tests/test_torch_variants_gdrn.py):

- ResNet-101 and -152: the key set and shapes of jax_to_torch of the JAX
  init's shapes (jax.eval_shape, nothing compiled) against the port's
  build_model, and a forward of the port alone.
- init_weights' rules for the new layers against the JAX init's draws.
- TEST.FOLD_BN on ResNet-50 with TransHeadNet against JAX's fold.
- jax_to_torch then the JAX package's convert_torch_state_dict gives back
  the JAX variables bitwise, for ResNet-50 with TransHeadNet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.models import gdrn as jgdrn
from gdrnet_tpu.utils.torch_convert import convert_torch_state_dict

from gdrnet_tpu_torch.models import gdrn
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch

from test_torch_variants_gdrn import (MODEL_KEYS, VARIANTS, jax_variables, small_batch,
                                      variant_cfg)
from torch_parity import init_shapes

T = torch.from_numpy


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnet_keys_match_jax(depth):
    cfg = variant_cfg({"MODEL.CDPN.BACKBONE.NUM_LAYERS": depth})
    batch = small_batch(seed=9, n=1)
    shapes = init_shapes(jgdrn.build_model(cfg), jnp.asarray(batch["roi_img"]),
                         **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS})
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = jax_to_torch(zeros["params"], zeros["batch_stats"])
    port = gdrn.init_weights(gdrn.build_model(cfg, device="cpu"),
                             torch.Generator().manual_seed(0))
    got = port.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(v.shape) for k, v in want.items())
    assert f"backbone.layer3.{ {101: 22, 152: 35}[depth] }.conv3.weight" in got
    with torch.no_grad():
        out = port.eval()(T(batch["roi_img"]), **{k: T(batch[k]) for k in MODEL_KEYS})
    assert torch.isfinite(out["rot"]).all() and torch.isfinite(out["trans"]).all()


@pytest.mark.parametrize("variant", ["R50+R_ONLY+MTL", "PointPnPNet", "SimplePointPnPNet"])
def test_init_weights_rules_for_the_new_layers(variant):
    """As tests/test_torch_model.py holds the flagship's: per tensor of at
    least 4,096 values the std of the port's draw within 10 % of the JAX
    init's, the small ones' constants equal (zero biases and log-variances,
    identity norms)."""
    overrides = {
        "R50+R_ONLY+MTL": {**VARIANTS["R50"], **VARIANTS["R_ONLY"], **VARIANTS["USE_MTL"]},
        "PointPnPNet": VARIANTS["PointPnPNet"],
        "SimplePointPnPNet": VARIANTS["SimplePointPnPNet"],
    }[variant]
    cfg = variant_cfg(overrides)
    batch = {k: jnp.asarray(v) for k, v in small_batch(seed=10, n=2).items()}
    variables = jax.jit(jgdrn.build_model(cfg).init)({"params": jax.random.PRNGKey(0)},
                                                     batch["roi_img"],
                                                     **{k: batch[k] for k in MODEL_KEYS})
    variables = jax.tree.map(np.asarray, dict(variables))
    want = jax_to_torch(variables["params"], variables["batch_stats"])
    got = gdrn.init_weights(gdrn.build_model(cfg, device="cpu"),
                            torch.Generator().manual_seed(3)).state_dict()
    assert got.keys() == want.keys()
    new = ("backbone.layer", "trans_head_net.", "pnp_net.conv", "pnp_net.fc")
    compared = 0
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        if w.numel() == 1 or float(w.std()) == 0.0:
            assert torch.equal(g, w), k
        elif w.numel() >= 4096:
            assert abs(float(g.std() / w.std()) - 1.0) < 0.1, (k, float(g.std()), float(w.std()))
            compared += k.startswith(new)
    assert compared >= 4


def test_jax_convert_round_trip_is_exact():
    cfg = variant_cfg({**VARIANTS["R50"], **VARIANTS["R_ONLY"]})
    batch = small_batch(seed=14, n=1)
    _, (params, stats) = jax_variables(cfg, batch, seed=15)
    sd = jax_to_torch(params, stats)
    port = gdrn.build_model(cfg, device="cpu")
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    back_params, back_stats = convert_torch_state_dict(port.state_dict())

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    for want, got in ((params, back_params), (stats, back_stats)):
        want, got = dict(flat(want)), dict(flat(got))
        assert set(want) == set(got)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg="/".join(path))


def test_fold_bn_matches_jax():
    """TEST.FOLD_BN on ResNet-50 with TransHeadNet: the Bottleneck's and
    TransHeadNet's conv-BN pairs fold as JAX's fold_batch_norms folds them
    (rtol 1e-6)."""
    from gdrnet_tpu.utils.fold_bn import fold_batch_norms as jax_fold

    from gdrnet_tpu_torch.utils.fold_bn import conv_bn_pairs, fold_batch_norms

    cfg = variant_cfg({**VARIANTS["R50"], **VARIANTS["R_ONLY"]})
    _, (params, stats) = jax_variables(cfg, small_batch(seed=18, n=1), seed=19)
    want = jax_to_torch(*jax_fold(params, stats))
    model = gdrn.build_model(cfg, device="cpu")
    model.load_state_dict(jax_to_torch(params, stats))
    pairs = {bn for _, bn, _, _ in conv_bn_pairs(model)}
    assert {"backbone.layer1.0.bn3", "trans_head_net.features.7"} <= pairs
    for folded in (fold_batch_norms(model).state_dict(),
                   fold_batch_norms(jax_to_torch(params, stats))):
        for k, w in want.items():
            if w.is_floating_point():
                np.testing.assert_allclose(folded[k].numpy(), w.numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=k)


def test_mtl_checkpoint_loads_its_log_variances(tmp_path):
    """load_weights: an MTL model's log-variances come back from its
    checkpoint; a model without MTL skips them."""
    from gdrnet_tpu_torch.engine.checkpoint import load_weights

    cfg = variant_cfg(VARIANTS["USE_MTL"])
    model = gdrn.init_weights(gdrn.build_model(cfg, device="cpu"),
                              torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.log_var_mask.fill_(0.25)
    path = str(tmp_path / "mtl.pth")
    torch.save({"model": model.state_dict()}, path)
    again = load_weights(gdrn.build_model(cfg, device="cpu"), path)
    assert float(again.log_var_mask) == 0.25 and float(again.log_var_rot) == 0.0
    plain = load_weights(gdrn.build_model(variant_cfg({}), device="cpu"), path)
    assert not any(k.startswith("log_var") for k in plain.state_dict())
