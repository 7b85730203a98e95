"""Ranger and build_optimizer (counterpart of gdrnet_tpu/solver/optimizers.py).

Ranger does the arithmetic of the JAX package's `ranger()`, in its order:
gradient centralisation, RAdam (rectified when the variance estimate is
tractable, bias-corrected momentum before), decoupled weight decay, -lr, all
inside Lookahead (every k updates: slow += alpha (fast - slow); fast = slow).
`build_optimizer` adds what the JAX one wraps around it: a global-norm clip
(SOLVER.GRAD_CLIP), gradient accumulation with optax.MultiSteps' semantics
(SOLVER.GRAD_ACCUM_STEPS) and per-module LR multipliers.

A step never waits for the device. The update count lives on the device,
because a step whose gradients are not finite must leave it (and every other
piece of state) unchanged. The per-update scalars (the learning rate from the
schedule, RAdam's rectification, Lookahead's sync) are therefore tabulated on
the host, in f64 from Python update counts as the reference computes them,
and the step reads its row at the device count. Every gradient-wide operation
works on one flat copy of the gradients; the rest is torch._foreach_* over
the parameter list.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
import torch.nn as nn

# the JAX package's optimizer zoo; only Ranger is ported so far
_NOT_PORTED = ("radam", "adabelief", "rangeradabelief", "adam", "adamw", "sgd", "sgd_gc",
               "sgd_gcc", "rmsprop", "rmsprop_tf", "adamp", "sgdp", "ralamb", "over9000",
               "rangerlars", "ranger2020")


def radam_step_scalars(t: int, b1: float, b2: float, sma_threshold: float
                       ) -> tuple[float, float, bool]:
    """RAdam's (rect, plain, use_rect) at update t >= 1, in f64."""
    one_m_b1t, one_m_b2t = 1.0 - b1 ** t, 1.0 - b2 ** t
    sma_max = 2.0 / (1 - b2) - 1.0
    sma = sma_max - 2.0 * t * (1.0 - one_m_b2t) / one_m_b2t
    rect = math.sqrt(max(one_m_b2t * (sma - 4) / (sma_max - 4) * (sma - 2) / max(sma, 1e-8)
                         * sma_max / (sma_max - 2), 0.0)) / one_m_b1t
    return rect, 1.0 / one_m_b1t, sma > sma_threshold


class Ranger(torch.optim.Optimizer):
    """Ranger over f32 parameters on one device.

    `lr` is a float or a schedule (update count -> lr; the first update uses
    lr(0)); a param group's "lr_mult" scales it. The other hyperparameters
    are fixed at construction. Gradient centralisation subtracts from each
    weight with more than 1 dim (3 with gc_conv_only) its mean over dims
    1.., the original Ranger's rule for every tensor: per output channel of
    a conv or linear weight, per input channel of a ConvTranspose2d weight
    ([in, out, kh, kw]). The weights listed in `transposed` are centralised
    over dims (0, 2, 3) instead, per output channel, as the JAX package
    centralises its flax kernels (gdrnet_tpu/solver/optimizers.py:49-52);
    the parity tests against the JAX package pass them.

    step(finite=flag) makes the update only where the device flag `flag` and
    every gradient are finite, and otherwise leaves the parameters and every
    piece of state exactly as they were; it returns that device flag. Without
    `finite`, every update is made. With accum_steps=k, k calls average their
    gradients and the k-th makes one update (optax.MultiSteps)."""

    TABLE_CHUNK = 1024

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 betas: tuple[float, float] = (0.95, 0.999), eps: float = 1e-5,
                 weight_decay: float = 0.0, alpha: float = 0.5, k: int = 6,
                 use_gc: bool = True, gc_conv_only: bool = False,
                 sma_threshold: float = 5.0, grad_clip: float = 0.0, accum_steps: int = 1,
                 transposed: Iterable[torch.Tensor] = ()):
        super().__init__(params, dict(lr_mult=1.0))
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.alpha, self.k = eps, weight_decay, alpha, k
        self.sma_threshold, self.grad_clip = sma_threshold, grad_clip
        self.accum_steps = max(int(accum_steps), 1)
        self._params = [p for g in self.param_groups for p in g["params"]]
        self._device = self._params[0].device
        if any(p.device != self._device or p.dtype != torch.float32 for p in self._params):
            raise ValueError("Ranger: every parameter must be f32 on one device")
        self._group_slices, start = [], 0
        for g in self.param_groups:
            self._group_slices.append(slice(start, start + len(g["params"])))
            start += len(g["params"])

        numels = [p.numel() for p in self._params]
        self._grad = torch.zeros(sum(numels), device=self._device)
        self._work = torch.zeros_like(self._grad) if self.accum_steps > 1 else self._grad
        self._grad_views = [v.view_as(p) for v, p in zip(self._grad.split(numels), self._params)]
        self._work_views = self._grad_views if self._work is self._grad else [
            v.view_as(p) for v, p in zip(self._work.split(numels), self._params)]
        transposed_ids = {id(p) for p in transposed}
        min_dim = 3 if gc_conv_only else 1
        self._gc = [] if not use_gc else [
            (v, (0, 2, 3) if id(p) in transposed_ids else tuple(range(1, p.dim())))
            for v, p in zip(self._work_views, self._params) if p.dim() > min_dim]
        # per-update scalars: decay1, decay2, use_rect, 1 - use_rect, step
        # coefficient, alpha * sync, sync, then -lr * lr_mult of each group;
        # the identity row leaves every piece of state as it is
        n_groups = len(self.param_groups)
        self._identity = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0] + [0.0] * n_groups,
                                      device=self._device)
        self._table = torch.empty(0, 7 + n_groups, device=self._device)
        self._calls = 0  # step() calls: an upper bound of the device update count

    def _row(self, count: int) -> list[float]:
        t = count + 1
        rect, plain, use = radam_step_scalars(t, self.b1, self.b2, self.sma_threshold)
        sync = t % self.k == 0
        lr = self.lr(count) if callable(self.lr) else self.lr
        return [self.b1, self.b2, float(use), 1.0 - use, rect if use else plain,
                self.alpha if sync else 0.0, float(sync)] + \
            [-lr * g["lr_mult"] for g in self.param_groups]

    def _extend_table(self) -> None:
        n = len(self._table)
        if n > self._calls:
            return
        rows = torch.tensor([self._row(c) for c in range(n, self._calls + self.TABLE_CHUNK)],
                            dtype=torch.float32)
        if self._device.type == "cuda":
            rows = rows.pin_memory()
        self._table = torch.cat([self._table, rows.to(self._device, non_blocking=True)])

    def _init_state(self) -> dict:
        for p in self._params:
            if p not in self.state:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                                 "slow": p.detach().clone()}
        if "shared" not in self.state:
            zero = torch.zeros((), dtype=torch.long, device=self._device)
            self.state["shared"] = {"count": zero, "mini_step": zero.clone()}
            if self.accum_steps > 1:
                self.state["shared"]["acc"] = torch.zeros_like(self._grad)
        return self.state["shared"]

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        shared = self.state.pop("shared", None)
        if shared:  # the counters and accumulator are not a parameter's state: move them here
            self.state["shared"] = {k: v.to(self._device) for k, v in shared.items()}
            self._calls = max(self._calls, int(shared["count"]))

    @torch.no_grad()
    def step(self, finite: torch.Tensor | None = None) -> torch.Tensor:
        shared = self._init_state()
        with_grad = [i for i, p in enumerate(self._params) if p.grad is not None]
        torch._foreach_copy_([self._grad_views[i] for i in with_grad],
                             [self._params[i].grad for i in with_grad])
        if len(with_grad) < len(self._params):
            skipped = set(with_grad)
            torch._foreach_zero_([v for i, v in enumerate(self._grad_views) if i not in skipped])

        if finite is None:
            ok = torch.ones((), dtype=torch.bool, device=self._device)
        else:
            ok = finite & torch.isfinite(torch.linalg.vector_norm(self._grad))
        if self.accum_steps > 1:  # optax.MultiSteps: a running mean of the k gradients
            n, acc = shared["mini_step"], shared["acc"]
            torch.sub(self._grad, acc, out=self._work).div_(n + 1).add_(acc)
            last = n == self.accum_steps - 1
            acc.copy_(torch.where(ok, torch.where(last, 0.0, self._work), acc))
            n.copy_(torch.where(ok, (n + 1) % self.accum_steps, n))
            commit = ok & last
        else:
            commit = ok
        work = self._work
        work.masked_fill_(~commit, 0.0)  # what follows is then finite, and a no-op

        if self.grad_clip > 0:  # optax.clip_by_global_norm
            norm = torch.linalg.vector_norm(work)
            work.mul_(torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        if self._gc:
            views = [v for v, _ in self._gc]
            torch._foreach_sub_(views, [v.mean(dims, keepdim=True) for v, dims in self._gc])

        self._extend_table()
        row = self._table.index_select(0, shared["count"].view(1))[0]
        s = torch.where(commit, row, self._identity)
        decay1, decay2, use, not_use, coef, alpha_sync, sync = s[:7]
        params, grads = self._params, self._work_views
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        slow = [self.state[p]["slow"] for p in params]

        torch._foreach_mul_(mu, decay1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, decay2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        # rectified: coef * mu / (sqrt(nu) + eps); momentum: coef * mu
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(denom, use)
        torch._foreach_add_(denom, not_use)
        update = torch._foreach_div(mu, denom)
        torch._foreach_mul_(update, coef)
        if self.weight_decay > 0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        for gi, sl in enumerate(self._group_slices):
            torch._foreach_mul_(update[sl], s[7 + gi])
        torch._foreach_add_(params, update)  # the fast weights
        # Lookahead: slow += alpha (fast - slow), then fast = slow, on a sync
        diff = torch._foreach_sub(params, slow)
        torch._foreach_mul_(diff, alpha_sync)
        torch._foreach_add_(slow, diff)
        diff = torch._foreach_sub(slow, params)
        torch._foreach_mul_(diff, sync)
        torch._foreach_add_(params, diff)

        shared["count"].add_(commit.long())
        self._calls += 1
        return ok


def build_optimizer(cfg, model: nn.Module,
                    lr_schedule: Callable[[int], float] | None = None, *,
                    jax_deconv_gc: bool = False) -> Ranger:
    """SOLVER.OPTIMIZER_CFG -> the optimizer of `model`'s parameters, one
    param group per LR multiplier (MODEL.CDPN.PNP_NET.LR_MULT for pnp_net,
    TRANS_HEAD.LR_MULT for trans_head, 1 elsewhere), with SOLVER.GRAD_CLIP and
    SOLVER.GRAD_ACCUM_STEPS. Gradient centralisation follows the original
    Ranger; jax_deconv_gc=True centralises the ConvTranspose2d weights per
    output channel, as the JAX package does (for the parity tests)."""
    oc = dict(cfg.SOLVER.OPTIMIZER_CFG)
    opt_type = oc.get("type", "Ranger").lower()
    if opt_type in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {oc['type']!r} is not ported yet (ROADMAP A5); only Ranger is")
    if opt_type != "ranger":
        raise ValueError(f"Unknown optimizer type: {oc.get('type')}")

    net_cfg = cfg.MODEL.CDPN
    mults = {"pnp_net": net_cfg.PNP_NET.get("LR_MULT", 1.0),
             "trans_head": net_cfg.TRANS_HEAD.get("LR_MULT", 1.0)}
    groups: dict[float, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(float(mults.get(name.split(".")[0], 1.0)), []).append(p)
    betas = oc.get("betas", (0.95, 0.999))
    return Ranger(
        [{"params": ps, "lr_mult": m} for m, ps in groups.items()],
        lr=lr_schedule if lr_schedule is not None else oc.get("lr", 1e-4),
        betas=(betas[0], betas[1]), weight_decay=oc.get("weight_decay", 0.0),
        use_gc=oc.get("use_gc", True), gc_conv_only=oc.get("gc_conv_only", False),
        grad_clip=cfg.SOLVER.get("GRAD_CLIP", 0.0),
        accum_steps=int(cfg.SOLVER.get("GRAD_ACCUM_STEPS", 1) or 1),
        transposed=[m.weight for m in model.modules()
                    if jax_deconv_gc and isinstance(m, nn.ConvTranspose2d)])
