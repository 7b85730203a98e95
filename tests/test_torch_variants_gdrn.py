"""Every GDRN variant that build_model takes, port against gdrnet_tpu on the
CPU at a small size (the small flagship: ResNet-18 unless the variant says,
64x64 crops, 16x16 maps, 32 head filters, 8 regions), with the JAX model's
seeded weights carried by utils.jax_convert, in f32.

- The forward of each variant of chip_smoke.py's [variants]: the maps at
  rtol 1e-4 / atol 1e-5 of their scale, the net's rotation parameters and
  translation outputs at rtol 1e-4 / atol 1e-5, the decoded poses at rtol
  1e-4 / atol 1e-4 (as tests/test_torch_model.py holds the flagship's).
- The MTL-weighted losses against JAX's gdrn_loss at rtol 1e-4.

tests/test_torch_variants_init.py holds the variants' keys, init and
conversion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.losses.gdrn_loss import gdrn_loss as jax_gdrn_loss
from gdrnet_tpu.models import gdrn as jgdrn

from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.losses.gdrn_loss import gdrn_loss
from gdrnet_tpu_torch.models import gdrn
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch

from torch_parity import init_shapes, load_port, randomize, small_flagship_cfg

T = torch.from_numpy
MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")
_DIRECT_T = {"MODEL.CDPN.PNP_NET.CENTROID_LW": 0.0, "MODEL.CDPN.PNP_NET.Z_LW": 0.0,
             "MODEL.CDPN.PNP_NET.TRANS_LW": 1.0}
# the [variants] of chip_smoke.py: one override of the flagship at a time
VARIANTS = {
    "ego_rot6d": {"MODEL.CDPN.PNP_NET.ROT_TYPE": "ego_rot6d"},
    "allo_quat": {"MODEL.CDPN.PNP_NET.ROT_TYPE": "allo_quat"},
    "ego_quat": {"MODEL.CDPN.PNP_NET.ROT_TYPE": "ego_quat"},
    "allo_log_quat": {"MODEL.CDPN.PNP_NET.ROT_TYPE": "allo_log_quat"},
    "allo_lie_vec": {"MODEL.CDPN.PNP_NET.ROT_TYPE": "allo_lie_vec"},
    "centroid_z_abs": {"MODEL.CDPN.PNP_NET.TRANS_TYPE": "centroid_z_abs", **_DIRECT_T},
    "trans": {"MODEL.CDPN.PNP_NET.TRANS_TYPE": "trans", **_DIRECT_T},
    "PointPnPNet": {"MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.type": "PointPnPNet"},
    "SimplePointPnPNet": {"MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.type": "SimplePointPnPNet"},
    "R_ONLY": {"MODEL.CDPN.PNP_NET.R_ONLY": True, "MODEL.CDPN.TRANS_HEAD.ENABLED": True,
               "MODEL.CDPN.TRANS_HEAD.FREEZE": False},
    "ROT_CONCAT": {"MODEL.CDPN.ROT_HEAD.ROT_CONCAT": True,
                   "MODEL.CDPN.PNP_NET.WITH_2D_COORD": False},
    "R50": {"MODEL.CDPN.BACKBONE.NUM_LAYERS": 50},
    "USE_MTL": {"MODEL.CDPN.USE_MTL": True},
    "BACKBONE.FREEZE": {"MODEL.CDPN.BACKBONE.FREEZE": True},
}


def variant_cfg(overrides: dict):
    cfg = small_flagship_cfg()
    for k, v in overrides.items():
        cfg.set_path(k, v)
    return cfg


def small_batch(seed: int, n: int = 3) -> dict:
    return synthetic_roi_batch(batch_size=n, input_res=64, out_res=16, num_classes=10,
                               num_points=64, num_regions=8, seed=seed)


def jax_variables(cfg, batch: dict, seed: int):
    jm = jgdrn.build_model(cfg)
    shapes = init_shapes(jm, jnp.asarray(batch["roi_img"]),
                         **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS})
    return jm, randomize(shapes, seed=seed)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gdrn_variant_matches_jax(variant):
    cfg = variant_cfg(VARIANTS[variant])
    batch = small_batch(seed=7)
    jm, (params, stats) = jax_variables(cfg, batch, seed=8)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                             jnp.asarray(batch["roi_img"]),
                             **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS})
    port = load_port(gdrn.build_model(cfg, device="cpu"), params, stats)
    with torch.no_grad():
        got = port(T(batch["roi_img"]), **{k: T(batch[k]) for k in MODEL_KEYS})
    for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
        assert got[k].shape == want[k].shape, k
        scale = float(np.abs(want[k]).max())
        _close(got[k].numpy() / scale, np.asarray(want[k]) / scale)
    for k in ("pred_rot_param", "pred_t_"):
        assert got[k].shape == want[k].shape, k
        _close(got[k].numpy(), want[k])
    _close(got["rot"].numpy(), want["rot"], atol=1e-4)
    _close(got["trans"].numpy(), want["trans"], atol=1e-4)
    assert ("log_vars" in got) == cfg.MODEL.CDPN.USE_MTL
    if variant == "ROT_CONCAT":
        assert got["coor_x"].shape[1] == 32  # twice the 16 px ground truth


def test_mtl_losses_match_jax():
    """USE_MTL: the model's log-variances (set away from 0 here) reweight
    each loss term, as JAX's gdrn_loss does, rtol 1e-4."""
    cfg = variant_cfg(VARIANTS["USE_MTL"])
    batch = small_batch(seed=11)
    jm, (params, stats) = jax_variables(cfg, batch, seed=12)
    rng = np.random.RandomState(13)
    params = {k: (rng.uniform(-1, 1, v.shape).astype(np.float32) if k.startswith("log_var_")
                  else v) for k, v in params.items()}
    jout = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(batch["roi_img"]),
                    **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS})
    want = jax_gdrn_loss(cfg, jout, {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_port(gdrn.build_model(cfg, device="cpu"), params, stats)
    with torch.no_grad():
        out = port(T(batch["roi_img"]), **{k: T(batch[k]) for k in MODEL_KEYS})
        got = gdrn_loss(cfg, out, {k: T(v) for k, v in batch.items()})
    assert set(got) == set(want) and len(got) >= 6
    for k in want:
        _close(float(got[k]), float(want[k]), atol=1e-6)
    cfg.MODEL.CDPN.USE_MTL = False
    with torch.no_grad():
        plain = gdrn_loss(cfg, out, {k: T(v) for k, v in batch.items()})
    assert all(float(plain[k]) != float(got[k]) for k in got)
