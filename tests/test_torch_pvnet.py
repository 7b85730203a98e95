"""The port's PVNet (models/pvnet.py) against gdrnet_tpu/models/pvnet.py on
the CPU, at tests/test_model.py:279-298's size (ResNet-18 trunk, 32x32
input, fcdim 32, s8/s4/s2/raw 16/16/8/8, 9 bins, batch 2), on the same
seeded weights (tests/torch_parity.randomize, carried over by
utils/jax_convert.pvnet_jax_to_torch with strict loading).

Tolerances: every output within tests/test_torch_model.py's rtol 1e-4 /
atol 1e-5 of its O(1) scale (one f32 forward in two libraries). In train
mode the BN running means move by flax's momentum 0.99 (torch momentum
0.01) within rtol 1e-4 / atol 1e-6 (on ResNet-34); the running variances
are not compared: flax updates them with the biased batch variance and
torch with the unbiased one (ROADMAP.md §C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.models.pvnet import PVNet as JaxPVNet

from gdrnet_tpu_torch.models import PVNet
from gdrnet_tpu_torch.utils.jax_convert import pvnet_jax_to_torch
from torch_parity import init_shapes, randomize

SMALL = dict(depth=18, num_bins=9, fcdim=32, s8dim=16, s4dim=16, s2dim=8, raw_dim=8)
RTOL, ATOL = 1e-4, 1e-5


def _models(conf_mode: str, coor_mode: str, depth: int = 18, seed: int = 0):
    kw = dict(SMALL, depth=depth, conf_mode=conf_mode, coor_mode=coor_mode)
    x = np.random.RandomState(seed).rand(2, 32, 32, 3).astype(np.float32)
    jnet = JaxPVNet(**kw)
    params, stats = randomize(init_shapes(jnet, jnp.asarray(x)), seed=seed + 1)
    port = PVNet(**kw)
    port.load_state_dict(pvnet_jax_to_torch(params, stats, depth=depth), strict=True)
    return jnet, {"params": params, "batch_stats": stats}, port, x


@pytest.mark.parametrize("conf_mode,coor_mode", [
    ("cls", "cls"), ("cls", "reg"), ("reg", "cls"), ("reg", "reg")])
def test_pvnet_matches_jax(conf_mode, coor_mode):
    jnet, variables, port, x = _models(conf_mode, coor_mode)
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    n_conf, n_coor = (2 if conf_mode == "cls" else 1), (9 if coor_mode == "cls" else 1)
    assert [tuple(g.shape) for g in got] == [(2, 32, 32, n_conf)] + [(2, 32, 32, n_coor)] * 3
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale, rtol=RTOL,
                                   atol=ATOL)


def test_pvnet_train_mode_bn_statistics_move_as_jax():
    jnet, variables, port, x = _models("cls", "cls", depth=34, seed=3)
    _, updated = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    port.train()(torch.from_numpy(x))
    sd = port.state_dict()
    want = pvnet_jax_to_torch(variables["params"], jax.tree.map(np.asarray,
                                                                 updated["batch_stats"]), depth=34)
    means = [k for k in want if k.endswith("running_mean")]
    # the stem, two a block, three downsamples, fc and the decoder's four
    assert len(means) == 1 + 2 * (3 + 4 + 6 + 3) + 3 + 1 + 4
    for k in means:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_pvnet_depth_beyond_basic_blocks_raises():
    """As the JAX module: the dilated trunk is built of basic blocks only."""
    with pytest.raises(ValueError, match="18/34"):
        JaxPVNet(depth=50).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="18/34"):
        PVNet(depth=50)
