"""The optimizer zoo of gdrnet_tpu_torch against gdrnet_tpu's optax
registry on the CPU, on the same gradients.

A small model (a conv and a BN under `backbone`, a transposed conv under
`rot_head_net`, a linear under `pnp_net`) and its JAX tree in flax layout.
Each name of the JAX registry runs 12 updates of seeded gradients in both
packages' build_optimizer (past RAdam's switch to the rectified step at
update 6 and Lookahead's sync at 6 and 12): plainly, and with weight decay,
PNP_NET.LR_MULT 0.5 (param groups here, optax.multi_transform in JAX) and a
GRAD_CLIP that some updates reach. Parameters after every update at rtol
1e-5 / atol 1e-6. Then GRAD_ACCUM_STEPS=2 against optax.MultiSteps; a
non-finite gradient leaves every tensor of the state bitwise as it was; a
run resumed from a saved state_dict is bitwise the uninterrupted one; the
schedule reads the update count, which a skipped step does not advance.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from gdrnet_tpu.solver import build_optimizer as jax_build_optimizer
from gdrnet_tpu.solver.optimizers import _BUILDERS as JAX_REGISTRY

from gdrnet_tpu_torch.solver.optimizers import OPTIMIZER_NAMES, build_optimizer

from torch_parity import small_flagship_cfg

UPDATES = 12
TOL = dict(rtol=1e-5, atol=1e-6)


class Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Sequential(nn.Conv2d(4, 8, 3, bias=False), nn.BatchNorm2d(8))
        self.rot_head_net = nn.Sequential(nn.ConvTranspose2d(8, 6, 3, bias=False))
        self.pnp_net = nn.Sequential(nn.Linear(12, 5))


# port parameter name -> (JAX path, torch layout -> flax layout)
LAYOUT = {
    "backbone.0.weight": (("backbone", "conv", "kernel"), lambda a: a.transpose(2, 3, 1, 0)),
    "backbone.1.weight": (("backbone", "bn", "scale"), lambda a: a),
    "backbone.1.bias": (("backbone", "bn", "bias"), lambda a: a),
    "rot_head_net.0.weight": (("rot_head", "deconv", "kernel"),
                              lambda a: a.transpose(2, 3, 0, 1)),
    "pnp_net.0.weight": (("pnp_net", "fc", "kernel"), lambda a: a.T),
    "pnp_net.0.bias": (("pnp_net", "fc", "bias"), lambda a: a),
}
TO_TORCH = {"backbone.0.weight": lambda a: a.transpose(3, 2, 0, 1),
            "rot_head_net.0.weight": lambda a: a.transpose(2, 3, 0, 1),
            "pnp_net.0.weight": lambda a: a.T}


def to_jax(named: dict) -> dict:
    tree: dict = {}
    for k, v in named.items():
        path, f = LAYOUT[k]
        cur = tree
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = jnp.asarray(f(np.asarray(v)))
    return tree


def from_jax(tree: dict) -> dict:
    out = {}
    for k, (path, _) in LAYOUT.items():
        v = tree
        for p in path:
            v = v[p]
        out[k] = np.ascontiguousarray(TO_TORCH.get(k, lambda a: a)(np.asarray(v)))
    return out


def grads_for(model: nn.Module, i: int) -> dict:
    rng = np.random.RandomState(100 + i)
    scale = (0.05, 0.5, 2.0)[i % 3]  # either side of the clip's threshold
    return {k: (rng.randn(*p.shape) * scale).astype(np.float32)
            for k, p in model.named_parameters()}


def make(name: str, **solver):
    torch.manual_seed(0)
    model = Small()
    cfg = small_flagship_cfg()
    oc = dict(type=name, lr=1e-2)
    oc.update(solver.pop("oc", {}))
    cfg.SOLVER.OPTIMIZER_CFG = oc
    cfg.SOLVER.GRAD_CLIP = solver.pop("clip", 0.0)
    cfg.SOLVER.GRAD_ACCUM_STEPS = solver.pop("accum", 1)
    cfg.MODEL.CDPN.PNP_NET.LR_MULT = solver.pop("lr_mult", 1.0)
    assert not solver
    return cfg, model, build_optimizer(cfg, model, jax_deconv_gc=True)


def test_every_jax_name_is_built():
    assert set(OPTIMIZER_NAMES) == set(JAX_REGISTRY)
    assert len(OPTIMIZER_NAMES) == 17


CASES = {"plain": {},
         "decay_mult_clip": dict(oc=dict(weight_decay=0.05), lr_mult=0.5, clip=3.0)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_optimizer_matches_jax(name, case):
    cfg, model, opt = make(name, **{k: (dict(v) if isinstance(v, dict) else v)
                                   for k, v in CASES[case].items()})
    named = dict(model.named_parameters())
    params = to_jax({k: p.detach() for k, p in named.items()})
    tx = jax_build_optimizer(cfg)
    state = tx.init(params)
    clipped = 0
    for i in range(UPDATES):
        g = grads_for(model, i)
        clipped += float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))) \
            > cfg.SOLVER.GRAD_CLIP
        updates, state = tx.update(to_jax(g), state, params)
        params = optax.apply_updates(params, updates)
        for k, v in g.items():
            named[k].grad = torch.from_numpy(v)
        opt.step()
        for k, want in from_jax(params).items():
            np.testing.assert_allclose(named[k].detach().numpy(), want, **TOL,
                                       err_msg=f"{name} {case} {k} after update {i}")
    assert int(opt.state["shared"]["count"]) == UPDATES
    if cfg.SOLVER.GRAD_CLIP:
        assert 0 < clipped < UPDATES
    if case != "plain":
        assert sorted(g["lr_mult"] for g in opt.param_groups) == [0.5, 1.0]


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop", "adabelief", "ranger2020",
                                  "over9000"])
def test_accumulation_matches_multisteps(name):
    cfg, model, opt = make(name, accum=2, oc=dict(weight_decay=0.01))
    named = dict(model.named_parameters())
    params = to_jax({k: p.detach() for k, p in named.items()})
    tx = jax_build_optimizer(cfg)
    assert isinstance(tx, optax.MultiSteps)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for i in range(2 * 7):
        g = grads_for(model, i)
        updates, state = update(to_jax(g), state, params)
        params = optax.apply_updates(params, updates)
        for k, v in g.items():
            named[k].grad = torch.from_numpy(v)
        opt.step()
        for k, want in from_jax(params).items():
            np.testing.assert_allclose(named[k].detach().numpy(), want, **TOL,
                                       err_msg=f"{name} {k} after call {i}")
    assert int(opt.state["shared"]["count"]) == 7


def _state_tensors(model: nn.Module, opt) -> list[torch.Tensor]:
    return ([p.detach() for p in model.parameters()]
            + [t for p in opt._params for t in opt.state[p].values()]
            + list(opt.state["shared"].values()))


@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_nonfinite_step_leaves_the_state_bitwise(name):
    _, model, opt = make(name, accum=1, oc=dict(weight_decay=0.05), lr_mult=0.5)
    for i in range(9):
        g = grads_for(model, i)
        if i in (3, 7):
            g["backbone.0.weight"][0, 0, 0, 0] = np.nan if i == 3 else np.inf
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        before = [t.clone() for t in _state_tensors(model, opt)] if i else None
        ok = opt.step(finite=torch.tensor(i != 5))
        assert bool(ok) == (i not in (3, 5, 7))
        if not bool(ok):
            after = _state_tensors(model, opt)
            assert len(after) == len(before)
            assert all(torch.equal(a, b) for a, b in zip(after, before)), name
    assert int(opt.state["shared"]["count"]) == 6


@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_checkpoint_resume_is_bitwise(name):
    def run(n, model, opt, start=0):
        for i in range(start, start + n):
            for k, p in model.named_parameters():
                p.grad = torch.from_numpy(grads_for(model, i)[k])
            opt.step()

    _, model, opt = make(name, oc=dict(weight_decay=0.05))
    run(10, model, opt)
    _, model2, opt2 = make(name, oc=dict(weight_decay=0.05))
    run(5, model2, opt2)
    buf = io.BytesIO()
    torch.save({"model": model2.state_dict(), "optimizer": opt2.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    _, model3, opt3 = make(name, oc=dict(weight_decay=0.05))
    model3.load_state_dict(saved["model"])
    opt3.load_state_dict(saved["optimizer"])
    run(5, model3, opt3, start=5)
    for a, b in zip(_state_tensors(model, opt), _state_tensors(model3, opt3)):
        assert torch.equal(a, b), name


def test_schedule_reads_the_update_count():
    """Plain SGD without momentum: each update is -lr(count) g, and a skipped
    step leaves the count, so the next update takes the lr it would have."""
    _, model, opt = make("sgd", oc=dict(momentum=0.0))
    opt.lr = lambda c: 0.1 * (c + 1)
    p = model.pnp_net[0].bias
    seen = []
    for i in range(6):
        g = torch.full_like(p, 1.0)
        for q in model.parameters():
            q.grad = torch.zeros_like(q)
        p.grad = g
        before = p.detach().clone()
        opt.step(finite=torch.tensor(i != 2))
        seen.append(round(float((before - p.detach())[0]), 6))
    assert seen == [0.1, 0.2, 0.0, 0.3, 0.4, 0.5]
    assert int(opt.state["shared"]["count"]) == 5
