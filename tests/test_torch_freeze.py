"""FREEZE: both packages' train steps with each MODEL.CDPN.*.FREEZE flag, on
the CPU at the small flagship's size, from the same seeded weights.

BACKBONE.FREEZE, ROT_HEAD.FREEZE, PNP_NET.FREEZE and TRANS_HEAD.FREEZE (with
R_ONLY, whose translation comes from TransHeadNet): 2 steps of Ranger in each
package. A frozen module's BN statistics stay bitwise as they were in both,
in the port's own run and in JAX's; its parameters too where the weight
decay is 0, and where it is not (the backbone case) optax's decay still
moves them, and the port's with them, at rtol 1e-5 / atol 1e-6 (the
optimizer parity of tests/test_torch_train.py: their gradient is exactly 0).
Every other tensor's update is held as tests/test_torch_train.py holds it:
the port's step from the JAX state before each step (parameters, BN
statistics and Ranger's state carried over), its change within 0.15 of
JAX's in relative L2 and the median tensor's within 1e-2 (running_var with
torch's unbiased n / (n - 1) factor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.engine.steps import make_train_step as jax_make_train_step
from gdrnet_tpu.engine.train_state import GDRNTrainState
from gdrnet_tpu.models.gdrn import build_model as jax_build_model
from gdrnet_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from gdrnet_tpu.solver import build_optimizer as jax_build_optimizer

from gdrnet_tpu_torch import build_lr_schedule, build_optimizer, create_train_state
from gdrnet_tpu_torch import make_train_step
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch, ranger_state_to_torch

from torch_parity import init_shapes, load_port, randomize, small_flagship_cfg

MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")
STEPS = 2
# flag -> (overrides, the frozen module's prefix in the port, weight decay)
FLAGS = {
    "BACKBONE": ({"MODEL.CDPN.BACKBONE.FREEZE": True}, "backbone.", 0.01),
    "ROT_HEAD": ({"MODEL.CDPN.ROT_HEAD.FREEZE": True}, "rot_head_net.", 0.0),
    "PNP_NET": ({"MODEL.CDPN.PNP_NET.FREEZE": True}, "pnp_net.", 0.0),
    "TRANS_HEAD": ({"MODEL.CDPN.PNP_NET.R_ONLY": True, "MODEL.CDPN.TRANS_HEAD.FREEZE": True},
                   "trans_head_net.", 0.0),
}


def _cfg(flag: str):
    overrides, _, wd = FLAGS[flag]
    cfg = small_flagship_cfg()
    for k, v in overrides.items():
        cfg.set_path(k, v)
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-3, weight_decay=wd)
    cfg.SOLVER.WARMUP_ITERS = 0
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under xdist each worker shares the machine's
    cores with five others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    return [synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, num_classes=10,
                                num_points=64, num_regions=8, seed=60 + i)
            for i in range(STEPS)]


@pytest.mark.parametrize("flag", list(FLAGS))
def test_freeze_trains_like_jax(flag):
    cfg = _cfg(flag)
    _, prefix, wd = FLAGS[flag]
    batches = _batches()
    jm = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params, stats = randomize(init_shapes(jm, jb["roi_img"], **{k: jb[k] for k in MODEL_KEYS}),
                              seed=61)
    jopt = jax_build_optimizer(cfg, lr_schedule=jax_build_lr_schedule(cfg, 1e-3, 100))
    jstate = GDRNTrainState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=stats,
                            opt_state=jopt.init(params))
    jstep = jax_make_train_step(cfg, jm, jopt)
    spine = []  # JAX (params, batch_stats, opt_state) before each step, as numpy
    for i, batch in enumerate(batches):
        spine.append(jax.tree.map(np.array, (jstate.params, jstate.batch_stats,
                                             jstate.opt_state)))
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(i))
        assert np.isfinite(float(m["total_loss"]))
    spine.append(jax.tree.map(np.array, (jstate.params, jstate.batch_stats,
                                         jstate.opt_state)))
    before = jax_to_torch(params, stats)

    # the port's own run: the frozen module stays as it was (or decays)
    model = load_port(build_model(cfg, device="cpu"), params, stats)
    opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-3, 100), jax_deconv_gc=True)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, model, opt)
    for batch in batches:
        _, m = step(state, batch, None)
        assert float(m["nonfinite_skip"]) == 0.0
    # a frozen ConvPnPNet keeps the train mode, as in JAX (only its outputs are cut)
    assert model.training and getattr(model, prefix[:-1]).training == (flag == "PNP_NET")
    got = model.state_dict()
    want = jax_to_torch(*spine[-1][:2])
    frozen = [k for k in got if k.startswith(prefix) and got[k].is_floating_point()]
    n_params = len([k for k in frozen if not k.endswith(("running_mean", "running_var"))])
    assert frozen and n_params
    for k in frozen:
        if wd > 0 and not k.endswith(("running_mean", "running_var")):
            assert not np.array_equal(want[k].numpy(), before[k].numpy()), k
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(want[k].numpy(), before[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), before[k].numpy(), err_msg=k)

    # the port's step from the JAX state before each step
    n_per_bn = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda mod, args, name=name: n_per_bn.__setitem__(
                    name, args[0].shape[0] * args[0].shape[2] * args[0].shape[3]))
    errs = []
    for i, batch in enumerate(batches):
        p_i, s_i, o_i = spine[i]
        model.load_state_dict(jax_to_torch(p_i, s_i))
        opt.load_state_dict(ranger_state_to_torch(o_i, model, opt))
        b_i = {k: v.clone() for k, v in model.state_dict().items()}
        state = create_train_state(model, opt)
        state.step = i
        step(state, batch, None)
        got = model.state_dict()
        want = jax_to_torch(*spine[i + 1][:2])
        for k, w in want.items():
            b = b_i[k]
            if k in frozen and wd > 0 and not k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)  # decay alone
                continue
            if not w.is_floating_point() or k in frozen or torch.equal(w, b):
                assert not w.is_floating_point() or torch.equal(got[k], b), k
                continue
            if k.endswith("running_var"):  # torch's unbiased batch variance
                n = n_per_bn[k[: -len(".running_var")]]
                w = 0.9 * b + n / (n - 1) * (w - 0.9 * b)
            errs.append(float((got[k] - w).norm() / (w - b).norm()))
            assert errs[-1] < 0.15, (i, k, errs[-1])
    assert len(errs) > 10 and np.median(errs) < 1e-2, errs
