"""Ranger on the small flagship's parameters against the JAX package's, on
the CPU in f32 (split from tests/test_torch_train.py, which holds Ranger on a
fixed tree and the train step):

- the JAX-state carry: 7 updates of the JAX `ranger()`, its state carried
  into the port by ranger_state_to_torch, then 6 more on both sides;
- build_optimizer with an LR multiplier and a clip, against JAX's;

both at rtol 1e-5 (atol 1e-6).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from gdrnet_tpu.solver import build_optimizer as jax_build_optimizer
from gdrnet_tpu.solver.optimizers import ranger as jax_ranger

from gdrnet_tpu_torch import build_optimizer
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.solver.optimizers import Ranger
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch, ranger_state_to_torch

from test_torch_train import small_model_variables
from torch_parity import load_port, small_flagship_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under xdist each worker shares the machine's
    cores with five others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["carry", "build_optimizer"])
def test_ranger_on_the_model_matches_jax(case):
    """The small flagship's parameters, seeded gradients, 13 updates.
    carry: 7 updates of the JAX `ranger()`, its state carried into the port
    by ranger_state_to_torch, then 6 more on both sides (through the
    Lookahead sync at 12). build_optimizer: both packages' build_optimizer
    with PNP_NET.LR_MULT 0.25 (param groups here, optax.multi_transform in
    JAX) and a GRAD_CLIP that half the updates reach. Parameters at rtol
    1e-5, atol 1e-6 (13 updates of about lr = 5e-3 each; the clip's global
    norm over 11.8 M values is summed in another order here)."""
    cfg = small_flagship_cfg()
    batch = synthetic_roi_batch(batch_size=2, input_res=64, out_res=16, num_classes=10, seed=1)
    _, (params, stats) = small_model_variables(cfg, batch, seed=21)
    if case == "carry":
        tx, carried = jax_ranger(5e-3, weight_decay=0.01), 7
    else:
        cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=5e-3, weight_decay=0.01)
        cfg.MODEL.CDPN.PNP_NET.LR_MULT = 0.25
        cfg.SOLVER.GRAD_CLIP = 0.1 * np.sqrt(sum(v.size for v in jax.tree.leaves(params)))
        tx, carried = jax_build_optimizer(cfg), 0
    state = tx.init(params)
    rng = np.random.RandomState(0)

    @jax.jit
    def apply(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    def jax_update(params, state, i):
        g = jax.tree.map(lambda v: (rng.randn(*v.shape) * (0.02, 0.2)[i % 2]).astype(np.float32),
                         params)
        return *apply(g, state, params), g

    for i in range(carried):
        params, state, _ = jax_update(params, state, i)
    model = load_port(build_model(cfg, device="cpu"), params, stats)
    if case == "carry":
        opt = Ranger(model.parameters(), lr=5e-3, weight_decay=0.01,
                     transposed=[model.rot_head_net.features[0].weight])
        opt.load_state_dict(ranger_state_to_torch(state, model, opt))
    else:
        opt = build_optimizer(cfg, model, jax_deconv_gc=True)
        assert sorted(g["lr_mult"] for g in opt.param_groups) == [0.25, 1.0]
    named = dict(model.named_parameters())
    for i in range(carried, 13):
        params, state, g = jax_update(params, state, i)
        for k, v in jax_to_torch(g).items():
            named[k].grad = v
        opt.step()
    assert int(opt.state["shared"]["count"]) == 13
    assert case != "carry" or int(state.count) == 13
    for k, v in jax_to_torch(params).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
