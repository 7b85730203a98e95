"""Helpers for the parity tests of gdrnet_tpu_torch against gdrnet_tpu:
seeded weights for a JAX module, carried into the port's module by
gdrnet_tpu_torch.utils.jax_convert, and the small flagship-shaped config."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from gdrnet_tpu_torch import merged_config
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = str(REPO / "configs/gdrn/synth/a6_cPnP_synth.py")


def gen_scale_dataset():
    """tools/gen_scale_dataset.py (mesh_zoo, _subdivide), loaded from its path."""
    spec = importlib.util.spec_from_file_location("gen_scale_dataset",
                                                  REPO / "tools/gen_scale_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_flagship_cfg():
    """The flagship config cut to CPU-test size: ResNet-18, 64x64 input,
    16x16 maps, head filters 32, 8 regions, pnp featdim 32, f32."""
    cfg = merged_config(FLAGSHIP)
    cfg.MODEL.CDPN.BACKBONE.NUM_LAYERS = 18
    cfg.MODEL.CDPN.BACKBONE.INPUT_RES = 64
    cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES = 16
    cfg.MODEL.CDPN.ROT_HEAD.NUM_FILTERS = 32
    cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 8
    cfg.MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.featdim = 32
    cfg.PARALLEL.DTYPE = "float32"
    return cfg


def init_shapes(module, *args, **kwargs) -> dict:
    """The shapes of a flax module's variables, without running its init."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))


def randomize(variables: dict, seed: int) -> tuple[dict, dict]:
    """Replace every leaf of a flax {"params", "batch_stats"} tree (arrays or
    shapes, as `init_shapes` gives) with seeded numpy values that keep
    activations O(1), rotation parameters included: He-normal kernels, small
    biases, norm scales near 1, running means near 0 and variances in
    [0.5, 1.5]. Returns (params, batch_stats) as nested dicts of numpy."""
    rng = np.random.RandomState(seed)

    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(dict(v), kind)
                continue
            shape = tuple(v.shape)
            if kind == "stats":
                a = rng.randn(*shape) * 0.1 if k == "mean" else rng.rand(*shape) + 0.5
            elif k == "kernel":
                a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
            elif k == "scale":
                a = 1.0 + 0.1 * rng.randn(*shape)
            else:
                a = 0.05 * rng.randn(*shape)
            out[k] = a.astype(np.float32)
        return out

    params = walk(dict(variables["params"]), "params")
    stats = walk(dict(variables.get("batch_stats", {})), "stats")
    return params, stats


def load_port(module: torch.nn.Module, params: dict, stats: dict, prefix: str = "",
              **convert_kwargs) -> torch.nn.Module:
    """Load JAX variables into a port module (strict). `prefix` is the
    top-level JAX scope the module sits under when it is not a whole GDRN
    (e.g. "backbone"); it is stripped from the state-dict keys."""
    if prefix:
        params, stats = {prefix: params}, {prefix: stats} if stats else {}
    sd = jax_to_torch(params, stats, **convert_kwargs)
    if prefix:
        port_prefix = {"rot_head": "rot_head_net", "trans_head": "trans_head_net"}.get(
            prefix, prefix) + "."
        sd = {k[len(port_prefix):]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(a: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(a), (0, 3, 1, 2))
