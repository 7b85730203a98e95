"""The port's slice end to end against the JAX package on the CPU: one
synthetic batch through both predict steps (f32, same weights), then both
CustomEvaluators over those predictions with a symmetric object, so ADD-S
runs through ops.kernels.nn_min_dist (its plain version here).

Tolerances: rot atol 1e-4 and trans rtol 1e-4 (a conv stack in two
libraries, then the rot6d Gram-Schmidt); recalls must be equal; mean
errors and the AUC rtol 1e-4.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.data.synthetic import synthetic_roi_batch as jax_synthetic_roi_batch
from gdrnet_tpu.engine.steps import make_predict_step as jax_make_predict_step
from gdrnet_tpu.eval.custom_evaluator import CustomEvaluator as JaxCustomEvaluator
from gdrnet_tpu.models.gdrn import build_model as jax_build_model

from gdrnet_tpu_torch import merged_config
from gdrnet_tpu_torch.data.synthetic import (
    poses_near,
    synthetic_object_models,
    synthetic_roi_batch,
)
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator
from gdrnet_tpu_torch.models.gdrn import build_model

from torch_parity import FLAGSHIP, REPO, init_shapes, load_port, randomize, small_flagship_cfg

MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")


@pytest.mark.parametrize("kw", [dict(batch_size=3, input_res=64, out_res=16, seed=1),
                                dict(batch_size=2, num_classes=10, seed=7)])
def test_synthetic_roi_batch_equals_jax_package(kw):
    got, want = synthetic_roi_batch(**kw), jax_synthetic_roi_batch(**kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_merged_config_builds_flagship_gdrn_r34():
    cfg = merged_config(FLAGSHIP)
    assert cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES == 10
    assert cfg.TEST.ROI_BATCH_SIZE == 64 and cfg.PARALLEL.DTYPE == "bfloat16"
    model = build_model(cfg)
    assert model.compute_dtype == "bfloat16"
    assert len(model.backbone.layer3) == 6  # ResNet-34
    head = model.rot_head_net
    assert head.features[0].out_channels == 256 and head.out_channels == 1 + 3 + 65
    assert model.pnp_net.features[0].in_channels == 3 + 2 + 64
    assert model.pnp_net.fc1.in_features == 128 * 8 * 8
    assert model.pnp_net.features[1].num_groups == 32


@pytest.fixture(scope="module")
def predictions():
    """The same batch through the JAX and the port's predict steps, f32."""
    cfg = small_flagship_cfg()
    batch = synthetic_roi_batch(batch_size=12, input_res=64, out_res=16, num_classes=10,
                                seed=3)
    jm = jax_build_model(cfg)
    params, stats = randomize(init_shapes(jm, jnp.asarray(batch["roi_img"]),
                                          **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS}),
                              seed=11)
    want = jax_make_predict_step(jm, with_maps=True)(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_port(build_model(cfg), params, stats)
    got = make_predict_step(port, with_maps=True)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return batch, {k: np.asarray(v) for k, v in want.items()}, \
        {k: v.numpy() for k, v in got.items()}


def test_predict_step_matches_jax(predictions):
    _, want, got = predictions
    assert set(got) == set(want)
    np.testing.assert_allclose(got["rot"], want["rot"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["trans"], want["trans"], rtol=1e-4, atol=1e-6)
    for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("with_auc,missing", [(False, 0), (True, 2)])
def test_custom_evaluator_matches_jax(predictions, with_auc, missing):
    batch, want_pred, got_pred = predictions
    names = ["ape", "brick", "cat"]
    points, diameters, sym_rots = synthetic_object_models(names, ["brick"], num_points=500,
                                                          seed=5)
    obj = [names[c % 3] for c in batch["roi_classes"]]
    # GT scattered around the predictions, so every threshold has poses on both sides
    R_gt, t_gt = poses_near(want_pred["rot"], want_pred["trans"], seed=6)
    results = []
    for cls, pred in ((JaxCustomEvaluator, want_pred), (CustomEvaluator, got_pred)):
        ev = cls(names, points, diameters, sym_objs=["brick"], sym_rots=sym_rots,
                 with_auc=with_auc)
        ev.process_batch(obj, pred["rot"], pred["trans"], R_gt, t_gt, batch["roi_cams"])
        if missing:
            ev.record_missing("cat", missing)
            ev.record_missing("dog", 1)  # no model: ignored by both
        results.append(ev.evaluate())
    want, got = results
    assert set(got) == set(want) == set(names) | {"Avg"}
    for name in want:
        assert set(got[name]) == set(want[name])
        for k in RECALL_KEYS:
            assert got[name][k] == want[name][k], (name, k)
        # the AUC, like the means, is continuous in the errors
        for k in ("mean_re", "mean_te", "mean_ad", "mean_proj") + (
                ("auc_ad_10",) if with_auc else ()):
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=1e-4, err_msg=k)
        assert got[name]["count"] == want[name]["count"]
    assert 0.0 < want["Avg"]["ad_10"] < 1.0  # the thresholds do separate the poses


def test_port_imports_no_jax():
    """Nor cv2 or tabulate, which the card's machine lacks."""
    modules = ["gdrnet_tpu_torch", "gdrnet_tpu_torch.csrc", "gdrnet_tpu_torch.ops.kernels",
               "gdrnet_tpu_torch.ops.rotation", "gdrnet_tpu_torch.ops.pose",
               "gdrnet_tpu_torch.ops.symmetry", "gdrnet_tpu_torch.models.gdrn",
               "gdrnet_tpu_torch.utils.jax_convert", "gdrnet_tpu_torch.engine.steps",
               "gdrnet_tpu_torch.eval.pose_errors", "gdrnet_tpu_torch.eval.custom_evaluator",
               "gdrnet_tpu_torch.data.synthetic", "gdrnet_tpu_torch.data.io",
               "gdrnet_tpu_torch.data.ply", "gdrnet_tpu_torch.data.ref_meta",
               "gdrnet_tpu_torch.data.bop", "gdrnet_tpu_torch.data.model_store",
               "gdrnet_tpu_torch.ops.fps", "gdrnet_tpu_torch.ops.rasterizer",
               "gdrnet_tpu_torch.eval.bop_writer", "gdrnet_tpu_torch.eval.vsd",
               "gdrnet_tpu_torch.eval.bop_score"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from gdrnet_tpu_torch import merged_config\n"
        f"merged_config({FLAGSHIP!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cv2', 'tabulate'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
