"""The port's train step and its parts against the JAX package on the CPU, in
f32, from numpy inputs made from seeds.

- Ranger against the JAX `ranger()` on a fixed tree of conv, linear,
  transposed-conv and vector parameters with fixed gradients, over 10 updates
  (the momentum branch up to update 5, the rectified branch from update 6, the
  Lookahead sync at 6), with weight decay on and off, a schedule, GRAD_CLIP
  and GRAD_ACCUM_STEPS=2: parameters after every call and the state at the
  end at rtol 1e-5 (atol 1e-7).
- The JAX-state carry and build_optimizer on the model's parameters are in
  tests/test_torch_train_ranger.py (a file of their own, so that xdist's
  --dist loadfile runs them beside this file's train steps).
- DropBlock's core given JAX's seed mask: rtol 1e-6; the port's draw by its
  dropped share only.
- make_train_step against the JAX step, 8 steps at lr 1e-2 with warmup
  off, then a NaN batch, then one more: from the JAX state before each step,
  every loss term, the gradients and the update of every parameter and BN
  buffer (running_var with torch's unbiased n/(n-1) factor), and the skip
  (bitwise unchanged); a free run of the port from the same weights follows
  JAX's total loss. Tolerances are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdrnet_tpu.engine.steps import make_train_step as jax_make_train_step
from gdrnet_tpu.engine.train_state import GDRNTrainState
from gdrnet_tpu.models.gdrn import build_model as jax_build_model
from gdrnet_tpu.models.layers import DropBlock2D as JaxDropBlock2D
from gdrnet_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from gdrnet_tpu.solver import build_optimizer as jax_build_optimizer
from gdrnet_tpu.solver.optimizers import ranger as jax_ranger
from gdrnet_tpu.solver.schedulers import flat_and_anneal_schedule as jax_flat_and_anneal

from gdrnet_tpu_torch import (
    build_lr_schedule,
    build_optimizer,
    create_train_state,
    make_train_step,
)
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.models.layers import DropBlock2D, dropblock
from gdrnet_tpu_torch.solver.optimizers import Ranger
from gdrnet_tpu_torch.solver.schedulers import flat_and_anneal_schedule
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch, ranger_state_to_torch

from torch_parity import init_shapes, load_port, randomize, small_flagship_cfg

OPT = dict(rtol=1e-5, atol=1e-7)
MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")

# ---------------------------------------------------------------------------
# Ranger on a fixed tree
# ---------------------------------------------------------------------------

# name: (JAX shape, JAX -> torch layout)
TREE = {
    "conv": ((3, 3, 4, 8), lambda a: a.transpose(3, 2, 0, 1)),
    "dense": ((12, 5), lambda a: a.T),
    "deconv": ((3, 3, 4, 6), lambda a: a.transpose(2, 3, 0, 1)),
    "bias": ((8,), lambda a: a),
    "scale": ((6,), lambda a: a),
}


def tree_values(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*shape) * scale).astype(np.float32) for k, (shape, _) in TREE.items()}


def to_torch_layout(tree: dict) -> dict:
    return {k: np.array(TREE[k][1](np.asarray(v)), np.float32) for k, v in tree.items()}


RANGER_CASES = {
    "plain": dict(),
    "weight_decay": dict(weight_decay=0.1),
    "schedule": dict(schedule=True),
    "grad_clip": dict(grad_clip=2.0),
    "accum2": dict(accum=2, weight_decay=0.05),
}


@pytest.mark.parametrize("case", list(RANGER_CASES))
def test_ranger_matches_jax(case):
    kw = RANGER_CASES[case]
    wd, clip, accum = kw.get("weight_decay", 0.0), kw.get("grad_clip", 0.0), kw.get("accum", 1)
    sched = dict(warmup_iters=3, warmup_factor=0.1, anneal_point=0.5)
    lr_jax = jax_flat_and_anneal(1e-2, 12, **sched) if kw.get("schedule") else 1e-2
    lr_port = flat_and_anneal_schedule(1e-2, 12, **sched) if kw.get("schedule") else 1e-2
    tx = jax_ranger(lr_jax, weight_decay=wd)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    params = {k: jnp.asarray(v) for k, v in tree_values(0).items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v))
               for k, v in to_torch_layout(params).items()}
    opt = Ranger(list(tparams.values()), lr=lr_port, weight_decay=wd, grad_clip=clip,
                 accum_steps=accum, transposed=[tparams["deconv"]])
    clipped = 0

    @jax.jit
    def jax_update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for call in range(10 * accum):
        # gradients on either side of the clip's threshold
        grads = {k: jnp.asarray(v)
                 for k, v in tree_values(100 + call, (0.05, 0.5, 1.0)[call % 3]).items()}
        clipped += float(optax.global_norm(grads)) > clip
        params, state = jax_update(grads, state, params)
        for k, g in to_torch_layout(grads).items():
            tparams[k].grad = torch.from_numpy(g)
        opt.step()
        for k, v in to_torch_layout(params).items():
            np.testing.assert_allclose(tparams[k].detach().numpy(), v, **OPT,
                                       err_msg=f"{k} after call {call}")
    if clip:
        assert 0 < clipped < 10  # both sides of the threshold were taken
    assert int(opt.state["shared"]["count"]) == 10
    look = state.inner_opt_state if accum > 1 else state
    look = look[-1] if clip else look
    radam = look.inner[1]
    assert int(look.count) == int(radam.count) == 10
    for name, tree in (("mu", radam.mu), ("nu", radam.nu), ("slow", look.slow)):
        for k, v in to_torch_layout(tree).items():
            np.testing.assert_allclose(opt.state[tparams[k]][name].numpy(), v, **OPT,
                                       err_msg=f"{name} {k}")


def test_ranger_skip_leaves_state_bitwise():
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v))
               for k, v in to_torch_layout(tree_values(0)).items()}
    opt = Ranger(list(tparams.values()), lr=1e-2, weight_decay=0.1, accum_steps=2)
    for call in range(14):
        grads = to_torch_layout(tree_values(200 + call))
        if call in (5, 6):
            grads["conv"][0, 0, 0, 0] = np.nan if call == 5 else np.inf
        for k, g in grads.items():
            tparams[k].grad = torch.from_numpy(g)
        before = ({k: p.detach().clone() for k, p in tparams.items()},
                  {(k, n): opt.state[p][n].clone() for k, p in tparams.items()
                   for n in ("mu", "nu", "slow")} if call else {},
                  {n: v.clone() for n, v in opt.state["shared"].items()} if call else {})
        ok = opt.step(finite=torch.tensor(call != 9))
        assert bool(ok) == (call not in (5, 6, 9))
        if not bool(ok):
            assert all(torch.equal(tparams[k], v) for k, v in before[0].items())
            assert all(torch.equal(opt.state[tparams[k]][n], v) for (k, n), v in before[1].items())
            assert all(torch.equal(opt.state["shared"][n], v) for n, v in before[2].items())
    assert int(opt.state["shared"]["count"]) == (14 - 3) // 2


def test_gc_rule_of_the_deconv_differs_from_the_original_ranger():
    """The original Ranger centralises every gradient over dims 1.., so the
    head's transposed conv (torch weight [in, out, kh, kw]) per INPUT
    channel; that is the port's default. The JAX package centralises a flax
    kernel [kh, kw, in, out] over every axis but `out`, per OUTPUT channel,
    over dims (0, 2, 3) of the torch weight; build_optimizer(...,
    jax_deconv_gc=True) keeps that rule for the parity tests. On a real
    gradient of rot_head_net.features.0.weight the two rules give first
    updates 0.18 apart in relative L2."""
    cfg = small_flagship_cfg()
    batch = synthetic_roi_batch(batch_size=2, input_res=64, out_res=16, num_classes=10, seed=3)
    updates = {}
    for jax_rule in (False, True):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu")
        opt = build_optimizer(cfg, model, lambda c: 1.0, jax_deconv_gc=jax_rule)
        state = create_train_state(model, opt)
        w = model.rot_head_net.features[0].weight
        before = w.detach().clone()
        make_train_step(cfg, model, opt)(state, batch, None)
        updates[jax_rule] = (before - w.detach(), w.grad)
    g = updates[False][1]
    assert torch.equal(g, updates[True][1])
    original = g - g.mean(dim=(1, 2, 3), keepdim=True)
    jax_rule = g - g.mean(dim=(0, 2, 3), keepdim=True)
    # update 1 is -lr * plain * mu = -lr * the centralised gradient (lr = 1 here)
    for got, want in ((updates[False][0], original), (updates[True][0], jax_rule)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6 * want.abs().max().item())
    rel = ((original - jax_rule).norm() / jax_rule.norm()).item()
    print(f"deconv GC: |original - JAX rule| / |JAX rule| of the first update = {rel:.4f}")
    assert rel > 1e-2


# ---------------------------------------------------------------------------
# the JAX-state carry
# ---------------------------------------------------------------------------


def small_model_variables(cfg, batch: dict, seed: int):
    jm = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jm, randomize(init_shapes(jm, jb["roi_img"], **{k: jb[k] for k in MODEL_KEYS}),
                         seed=seed)


# ---------------------------------------------------------------------------
# DropBlock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size,progress", [(5, 1.0), (3, 0.4), (4, 1.7), (2, 0.0)])
def test_dropblock_core_matches_jax(block_size, progress):
    x = np.random.RandomState(block_size).randn(3, 11, 9, 4).astype(np.float32)
    key = jax.random.PRNGKey(block_size)
    drop_prob = 0.6
    want = JaxDropBlock2D(drop_prob, block_size).apply({}, jnp.asarray(x), train=True,
                                                       progress=progress, rng=key)
    gamma = drop_prob * np.clip(progress, 0.0, 1.0) / block_size ** 2
    seeds = np.asarray(jax.random.bernoulli(key, gamma, (3, 11, 9, 1)), np.float32)
    got = dropblock(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(seeds).permute(0, 3, 1, 2), block_size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert progress == 0.0 or seeds.sum() > 0


def test_dropblock_draw_statistics():
    """The port's draw: the dropped share of a 64x64 map against the share a
    Bernoulli(gamma) seed grid gives with 5x5 blocks clipped at the edges."""
    torch.manual_seed(0)
    block, drop_prob, h = 5, 0.5, 64
    layer = DropBlock2D(drop_prob, block).train()
    out = layer(torch.ones(32, 1, h, h), progress=1.0,
                generator=torch.Generator().manual_seed(1))
    gamma = drop_prob / block ** 2
    cover = np.array([min(i + 2, h - 1) - max(i - 2, 0) + 1 for i in range(h)])
    want = 1.0 - np.mean((1.0 - gamma) ** (cover[:, None] * cover[None, :]))
    got = float((out == 0).float().mean())
    assert abs(got - want) < 0.02, (got, want)
    for sample in out:  # one rescale factor a sample
        kept = sample[sample > 0]
        assert torch.allclose(kept, kept[0])
    assert torch.equal(layer.eval()(torch.ones(2, 1, 8, 8)), torch.ones(2, 1, 8, 8))


def test_train_step_with_dropblock():
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.drop_prob = 0.3
    batch = synthetic_roi_batch(batch_size=2, input_res=64, out_res=16, num_classes=10, seed=4)
    losses = []
    for seed in (5, 5, 6):
        torch.manual_seed(0)  # the same default init each time
        model = build_model(cfg, device="cpu")
        assert model.pnp_net.dropblock.drop_prob == 0.3
        opt = build_optimizer(cfg, model)
        state = create_train_state(model, opt)
        state.step = 10  # DropBlock at half its rate (progress 10 / 20)
        step = make_train_step(cfg, model, opt, dropblock_nr_steps=20)
        _, metrics = step(state, batch, torch.Generator().manual_seed(seed))
        assert {v.device.type for v in metrics.values()} == {"cpu"}  # the model's device
        losses.append(float(metrics["loss_PM_R"]))
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------------------
# make_train_step against the JAX train step
# ---------------------------------------------------------------------------

STEPS = 8


def record_grads() -> optax.GradientTransformation:
    """Keeps the last gradients in its state and passes them on."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the rank tests run: under xdist each worker
    shares the machine's cores with five others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trajectories():
    """One JAX compile. The JAX train step runs STEPS steps, then one on a
    batch with a NaN in roi_img, then one more. The port's step runs twice
    over the same batches: once on its own from the same weights, and once
    from the JAX state before each step (params, BN stats and Ranger state
    carried by jax_to_torch and ranger_state_to_torch), so that each of its
    updates can be held against JAX's own."""
    cfg = small_flagship_cfg()
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-2, weight_decay=0)
    cfg.SOLVER.WARMUP_ITERS = 0
    batches = [synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, num_classes=10,
                                   num_points=64, num_regions=8, seed=30 + i)
               for i in range(STEPS + 2)]
    batches[STEPS] = dict(batches[STEPS], roi_img=batches[STEPS]["roi_img"].copy())
    batches[STEPS]["roi_img"][1, 5, 7, 0] = np.nan
    jm, (params, stats) = small_model_variables(cfg, batches[0], seed=11)

    jopt = optax.chain(record_grads(), jax_build_optimizer(
        cfg, lr_schedule=jax_build_lr_schedule(cfg, 1e-2, 100)))
    jstate = GDRNTrainState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=stats,
                            opt_state=jopt.init(params))
    jstep = jax_make_train_step(cfg, jm, jopt)
    spine = []  # JAX (params, batch_stats, opt_state) before each step, as numpy
    jax_metrics = []
    for i, batch in enumerate(batches):
        spine.append(jax.tree.map(np.array, (jstate.params, jstate.batch_stats,
                                             jstate.opt_state)))
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(i))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    spine.append(jax.tree.map(np.array, (jstate.params, jstate.batch_stats, jstate.opt_state)))

    def port(params, stats):
        model = load_port(build_model(cfg, device="cpu"), params, stats)
        opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-2, 100), jax_deconv_gc=True)
        return model, opt, make_train_step(cfg, model, opt)

    # the port on its own, from the same weights
    model, opt, step = port(params, stats)
    state = create_train_state(model, opt)
    free = [{k: float(v) for k, v in step(state, b, None)[1].items()} for b in batches]

    # the port from the JAX state before each step
    model, opt, step = port(params, stats)
    n_per_bn = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda mod, args, name=name: n_per_bn.__setitem__(
                    name, args[0].shape[0] * args[0].shape[2] * args[0].shape[3]))
    forced = []
    for i, batch in enumerate(batches):
        p_i, s_i, o_i = spine[i]
        model.load_state_dict(jax_to_torch(p_i, s_i))
        opt.load_state_dict(ranger_state_to_torch(o_i, model, opt))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        before_opt = {(p, n): t.clone() for p, st in opt.state.items()
                      if isinstance(p, torch.Tensor) for n, t in st.items()}
        state = create_train_state(model, opt)
        state.step = i
        _, m = step(state, batch, None)
        forced.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "before": before,
            "after": {k: v.clone() for k, v in model.state_dict().items()},
            "opt_unchanged": all(torch.equal(t, opt.state[p][n])
                                 for (p, n), t in before_opt.items()),
            "count": int(opt.state["shared"]["count"]),
        })
    return {"cfg": cfg, "spine": spine, "jax": jax_metrics, "free": free, "forced": forced,
            "n_per_bn": n_per_bn}


def test_train_step_losses_match_jax(trajectories):
    """Every loss term and metric at every step, from the JAX state before
    the step: rtol 1e-4 (the f32 forward of two libraries; measured 2e-5). The port's own run from the same weights: total_loss
    within 10 % at every step (f32 rounding flips a few ReLU / LeakyReLU units
    that sit near 0 between the two libraries, and lr 1e-2 amplifies that;
    measured: at most 5 %)."""
    for i, want in enumerate(trajectories["jax"]):
        got, free = trajectories["forced"][i]["metrics"], trajectories["free"][i]
        assert set(got) == set(want) == set(free)
        if i == STEPS:
            assert not np.isfinite(want["total_loss"])
            assert want["nonfinite_skip"] == got["nonfinite_skip"] == free["nonfinite_skip"] == 1
            continue
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} at step {i}")
        np.testing.assert_allclose(free["total_loss"], want["total_loss"], rtol=0.1)
        assert got["nonfinite_skip"] == free["nonfinite_skip"] == 0
    assert trajectories["jax"][STEPS - 1]["total_loss"] < 0.8 * trajectories["jax"][0]["total_loss"]


def test_train_step_gradients_match_jax(trajectories):
    """Each step's gradients against JAX's (through jax_to_torch), relative
    L2 error: at most 0.15 per tensor and 0.08 over all of them at every step
    (a unit flipped near 0, above), and at most 1e-2 at the median step
    (measured: 0.044, 0.028 and 2.8e-4)."""
    totals = []
    for i, forced in enumerate(trajectories["forced"]):
        if i == STEPS:
            continue
        want = jax_to_torch(trajectories["spine"][i + 1][2][0])
        assert set(want) == set(forced["grads"])
        for k, g in forced["grads"].items():
            assert rel_l2(g, want[k]) < 0.15, (i, k)
        totals.append(rel_l2(torch.cat([g.flatten() for g in forced["grads"].values()]),
                             torch.cat([want[k].flatten() for k in forced["grads"]])))
    assert max(totals) < 0.08 and np.median(totals) < 1e-2, totals


def test_train_step_updates_match_jax(trajectories):
    """Each step's change of every parameter and BN buffer (after - before)
    against JAX's, relative L2 error: at most 0.15 per tensor, and at most
    1e-2 for the worst tensor of the median step (measured: 0.044 and 1.6e-4).
    running_mean as JAX's; running_var as 0.9 r + n/(n-1) (JAX's - 0.9 r):
    torch updates it with the unbiased batch variance, flax with the biased
    one (n: the layer's B*H*W). The parameters after the last step within
    1e-6 of JAX's."""
    worst = []
    for i, forced in enumerate(trajectories["forced"]):
        if i == STEPS:
            continue
        p_next, s_next, _ = trajectories["spine"][i + 1]
        want = jax_to_torch(p_next, s_next)
        errs = []
        for k, w in want.items():
            if not w.is_floating_point():
                continue
            b, a = forced["before"][k], forced["after"][k]
            if k.endswith("running_var"):
                n = trajectories["n_per_bn"][k[: -len(".running_var")]]
                w = 0.9 * b + n / (n - 1) * (w - 0.9 * b)
            errs.append(rel_l2(a - b, w - b))
            assert errs[-1] < 0.15, (i, k, errs[-1])
        worst.append(max(errs))
    assert np.median(worst) < 1e-2, worst
    assert min(trajectories["n_per_bn"].values()) == 16  # ResNet-18's last stage: 4 x 2 x 2
    last = jax_to_torch(trajectories["spine"][-1][0])
    for k, w in last.items():
        np.testing.assert_allclose(trajectories["forced"][-1]["after"][k].numpy(), w.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_nonfinite_step_is_skipped_like_jax(trajectories):
    """The NaN step leaves JAX's state and the port's (parameters, BN buffers
    with their counts, Ranger's mu / nu / slow and update count) bitwise as
    they were."""
    spine, forced = trajectories["spine"], trajectories["forced"][STEPS]
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(spine[STEPS]),
                                                     jax.tree.leaves(spine[STEPS + 1])))
    assert all(torch.equal(forced["before"][k], v) for k, v in forced["after"].items())
    assert forced["opt_unchanged"] and forced["count"] == STEPS
