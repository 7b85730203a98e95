"""The optimizer zoo and build_optimizer (counterpart of
gdrnet_tpu/solver/optimizers.py).

Each optimizer does the arithmetic of the JAX package's optax chain of the
same name, in its order and with its defaults (not torch.optim's):

  ranger       GC, RAdam (SMA threshold 5), decoupled weight decay, -lr, in
               Lookahead (every k updates: slow += alpha (fast - slow);
               fast = slow)
  radam        RAdam (b 0.9 / 0.999, eps 1e-8, SMA threshold 4), decay, -lr
  ralamb       RAdam (b 0.95 / 0.999, eps 1e-5), decay, the per-tensor trust
               ratio clip(|p|, 0, 10) / (|u| + 1e-8), -lr; over9000 /
               rangerlars is ralamb in Lookahead
  ranger2020   RAdam with the weight decay added before the rectified step
               size and GC on the gradient (gc_loc) or on the step, in
               Lookahead
  adam         Adam; with weight decay, coupled L2 added before the moments
  adamw        Adam, then decoupled decay (default 1e-4)
  adabelief    optax's scale_by_belief (eps 1e-16 outside the root, 1e-16
               inside), decay; rangeradabelief is the same
  adamp, sgdp  Adam / momentum, then the update projected off the parameter
               where it is scale-invariant (cos < delta / sqrt(dim)), decay
               scaled by wd_ratio there
  sgd          coupled decay, momentum (optax.trace), -lr; no GC
  sgd_gc(c)    GC (conv weights only for sgd_gcc), coupled decay, momentum
  rmsprop(_tf) eps inside the root (the TF semantics), -lr, then momentum
               on the scaled step

`TableOptimizer` holds what they share, built once: the gradients copied to
one flat buffer, SOLVER.GRAD_ACCUM_STEPS with optax.MultiSteps' semantics (a
running mean of k gradients, one update on the k-th), SOLVER.GRAD_CLIP
(a global-norm clip), gradient centralisation, one param group per LR
multiplier, Lookahead, and the update count that the LR schedule reads.

On a model axis (PARALLEL.MODEL_PARALLEL, parallel/tensor_parallel.py) a
rank holds the slices of the sharded weights and their state; every
reduction over a whole tensor or over all parameters (the global norm of the
clip and of the finite check, LAMB's trust ratio, AdamP / SGDP's norms, dot
product and size, a centralisation across the shard dim) sums a sharded
tensor's part over the model group and counts a whole one once, so that
each rank takes its slice of one process's step. full_state_dict gathers the
state whole; load_state_dict takes a whole or a sliced state.

A step never waits for the device. The update count lives on the device,
because a step whose gradients are not finite must leave it (and every other
piece of state) unchanged. The per-update scalars (the learning rate from the
schedule, bias corrections, RAdam's rectification, Lookahead's sync, the
moment decays) are therefore tabulated on the host in f64 from Python update
counts, and the step reads its row at the device count; on a skipped step it
reads the optimizer's identity row instead, whose decays are 1 and whose
increments, learning rates and syncs are 0, and the zeroed gradients then
leave the state as it was. The rest is torch._foreach_* over the parameter
list.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn as nn

from gdrnet_tpu_torch.parallel import tensor_parallel


def radam_step_scalars(t: int, b1: float, b2: float, sma_threshold: float
                       ) -> tuple[float, float, bool]:
    """RAdam's (rect, plain, use_rect) at update t >= 1, in f64."""
    one_m_b1t, one_m_b2t = 1.0 - b1 ** t, 1.0 - b2 ** t
    sma_max = 2.0 / (1 - b2) - 1.0
    sma = sma_max - 2.0 * t * (1.0 - one_m_b2t) / one_m_b2t
    rect = math.sqrt(max(one_m_b2t * (sma - 4) / (sma_max - 4) * (sma - 2) / max(sma, 1e-8)
                         * sma_max / (sma_max - 2), 0.0)) / one_m_b1t
    return rect, 1.0 / one_m_b1t, sma > sma_threshold


def bias_correction(b: float, t: int) -> float:
    """1 - b^t as optax computes it in f32 from an f32 b (its value differs
    from the f64 one by up to 1.3e-5 relative at t = 1 for b = 0.999)."""
    return float(np.float32(1.0) - np.float32(float(np.float32(b)) ** t))


class TableOptimizer(torch.optim.Optimizer):
    """The machinery the zoo shares, over f32 parameters on one device.

    `lr` is a float or a schedule (update count -> lr; the first update uses
    lr(0)); a param group's "lr_mult" scales it. A subclass names its
    per-parameter state (STATE: name -> initial value, "zeros" or
    "params"), its per-update scalars (_scalars(t) and IDENTITY, the same
    length) and its update (_update(s, grads, params) -> the step before
    -lr; it updates its state in place). `gc` centralises each gradient with
    more than 1 dim ("all") or 3 ("conv") over dims 1.., the original rule
    (per output channel of a conv or linear, per input channel of a
    ConvTranspose2d [in, out, kh, kw]); the tensors in `transposed` over
    dims (0, 2, 3), per output channel as the JAX package centralises flax
    kernels (the parity tests pass them). `lookahead` is (alpha, k) or None.
    `shards` is parallel/tensor_parallel.shards(model) on a model axis: (the
    ModelAxis, {parameter: its shard dim}) for the reductions over whole
    tensors; None elsewhere.

    step(finite=flag) makes the update only where the device flag `flag` and
    every gradient are finite, and otherwise leaves the parameters and every
    piece of state exactly as they were; it returns that device flag. Without
    `finite`, every update is made. With accum_steps=k, k calls average their
    gradients and the k-th makes one update (optax.MultiSteps); a skipped
    call does not count. micro_step() reads that count; step(reduce=fn)
    makes the mean accumulated so far global first (data parallelism, where
    the earlier micro-steps' gradients stayed on their rank)."""

    TABLE_CHUNK = 1024
    STATE: dict[str, str] = {}
    IDENTITY: list[float] = []

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3, *,
                 grad_clip: float = 0.0, accum_steps: int = 1, gc: str | None = None,
                 transposed: Iterable[torch.Tensor] = (),
                 lookahead: tuple[float, int] | None = None, shards: tuple | None = None):
        super().__init__(params, dict(lr_mult=1.0))
        self.lr = lr
        self.grad_clip = grad_clip
        self.accum_steps = max(int(accum_steps), 1)
        self.lookahead = lookahead
        self._params = [p for g in self.param_groups for p in g["params"]]
        self._device = self._params[0].device
        if any(p.device != self._device or p.dtype != torch.float32 for p in self._params):
            raise ValueError(f"{type(self).__name__}: every parameter must be f32 on one device")
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
        min_dim = {"all": 1, "conv": 3}.get(gc or "", None)
        # (index, dims) of each tensor that gradient centralisation touches
        self._gc_dims = [] if min_dim is None else [
            (i, (0, 2, 3) if id(p) in transposed_ids else tuple(range(1, p.dim())))
            for i, p in enumerate(self._params) if p.dim() > min_dim]
        # the model axis: (its ModelAxis, each parameter's shard dim or None)
        self._axis, dims = shards if shards is not None else (None, {})
        self._shard_dims = [dims.get(p) for p in self._params]
        self._sharded = [i for i, d in enumerate(self._shard_dims) if d is not None]
        self._numels = numels
        self._n_scalars = len(self.IDENTITY) + (2 if lookahead else 0)
        n_groups = len(self.param_groups)
        self._identity = torch.tensor(
            list(self.IDENTITY) + [0.0] * (self._n_scalars - len(self.IDENTITY) + n_groups),
            device=self._device)
        self._table = torch.empty(0, self._n_scalars + n_groups, device=self._device)
        self._calls = 0  # step() calls: an upper bound of the device update count

    # -- the subclass's part -------------------------------------------------

    def _scalars(self, t: int) -> list[float]:
        raise NotImplementedError

    def _update(self, s: torch.Tensor, grads: list, params: list) -> list:
        raise NotImplementedError

    def _after_lr(self, s: torch.Tensor, update: list) -> list:
        """The step after -lr (rmsprop's momentum); the identity here."""
        return update

    # -- shared --------------------------------------------------------------

    def _row(self, count: int) -> list[float]:
        t = count + 1
        row = self._scalars(t)
        if self.lookahead:
            alpha, k = self.lookahead
            sync = t % k == 0
            row += [alpha if sync else 0.0, float(sync)]
        lr = self.lr(count) if callable(self.lr) else self.lr
        return row + [-lr * g["lr_mult"] for g in self.param_groups]

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
        names = dict(self.STATE, **({"slow": "params"} if self.lookahead else {}))
        for p in self._params:
            if p not in self.state:
                self.state[p] = {n: p.detach().clone() if init == "params" else torch.zeros_like(p)
                                 for n, init in names.items()}
        if "shared" not in self.state:
            zero = torch.zeros((), dtype=torch.long, device=self._device)
            self.state["shared"] = {"count": zero, "mini_step": zero.clone()}
            if self.accum_steps > 1:
                self.state["shared"]["acc"] = torch.zeros_like(self._grad)
        return self.state["shared"]

    def micro_step(self) -> int:
        """The calls accumulated toward the next update (0 without
        accumulation): the device count, so one host sync. It stays on the
        device because a skipped call leaves it as it was, which the host
        does not know without this read."""
        if self.accum_steps == 1:
            return 0
        return int(self._init_state()["mini_step"])

    def _full_shape(self, i: int) -> tuple:
        shape = list(self._params[i].shape)
        if self._shard_dims[i] is not None:
            shape[self._shard_dims[i]] *= self._axis.size
        return tuple(shape)

    @torch.no_grad()
    def full_state_dict(self) -> dict:
        """state_dict() with each sharded parameter's state, and the
        accumulator's part of it, gathered whole over the model group: what
        one process holds (a collective: every model peer calls it)."""
        sd = self.state_dict()
        if self._axis is None:
            return sd
        state = sd["state"]
        for i in self._sharded:
            if i in state:
                shape = self._params[i].shape
                state[i] = {k: self._axis.gather(v, self._shard_dims[i])
                            if torch.is_tensor(v) and v.shape == shape else v
                            for k, v in state[i].items()}
        shared = state.get("shared", {})
        if "acc" in shared:
            parts = list(shared["acc"].split(self._numels))
            for i in self._sharded:
                parts[i] = self._axis.gather(parts[i].view_as(self._params[i]),
                                             self._shard_dims[i]).reshape(-1)
            state["shared"] = dict(shared, acc=torch.cat(parts))
        return sd

    def _slice_state(self, state_dict: dict) -> dict:
        """A whole state (full_state_dict's, or one process's) cut to this
        rank's slices; a sliced one as it is."""
        state = dict(state_dict["state"])
        for i in self._sharded:
            if i in state:
                full, dim = self._full_shape(i), self._shard_dims[i]
                state[i] = {k: self._axis.slice(v, dim) if torch.is_tensor(v)
                            and tuple(v.shape) == full else v for k, v in state[i].items()}
        shared = state.get("shared", {})
        full_numels = [math.prod(self._full_shape(i)) for i in range(len(self._params))]
        if "acc" in shared and shared["acc"].numel() == sum(full_numels) != len(self._grad):
            parts = list(shared["acc"].split(full_numels))
            for i in self._sharded:
                parts[i] = self._axis.slice(parts[i].view(self._full_shape(i)),
                                            self._shard_dims[i]).reshape(-1)
            state["shared"] = dict(shared, acc=torch.cat(parts))
        return dict(state_dict, state=state)

    def load_state_dict(self, state_dict: dict) -> None:
        if self._axis is not None:
            state_dict = self._slice_state(state_dict)
        super().load_state_dict(state_dict)
        shared = self.state.pop("shared", None)
        if shared:  # the counters and accumulator are not a parameter's state: move them here
            self.state["shared"] = {k: v.to(self._device) for k, v in shared.items()}
            self._calls = max(self._calls, int(shared["count"]))

    def _states(self, name: str) -> list[torch.Tensor]:
        return [self.state[p][name] for p in self._params]

    def _centralize(self, tensors: list[torch.Tensor]) -> None:
        """Gradient centralisation of `tensors` (one a parameter), in place;
        a mean across a shard dim over the model group."""
        if not self._gc_dims:
            return
        means = [tensors[i].mean(d, keepdim=True) for i, d in self._gc_dims]
        across = [j for j, (i, d) in enumerate(self._gc_dims) if self._shard_dims[i] in d]
        if across:  # the whole tensor's sum over those dims, over its count
            sums = torch.cat([means[j].reshape(-1) for j in across])
            self._axis.all_reduce(sums).div_(self._axis.size)
            for j, v in zip(across, sums.split([means[j].numel() for j in across])):
                means[j] = v.view_as(means[j])
        torch._foreach_sub_([tensors[i] for i, _ in self._gc_dims], means)

    def _norms(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The L2 norm of each whole tensor (tensors[i] shaped as parameter
        i), in f64: a sharded one's over the model group."""
        norms = _tensor_norms(tensors)
        if self._sharded:
            sq = torch.stack([norms[i] for i in self._sharded]).square()
            for i, v in zip(self._sharded, self._axis.all_reduce(sq).sqrt()):
                norms[i] = v
        return norms

    def _sums(self, values: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per-parameter scalars, a sharded parameter's summed over the model
        group."""
        if not self._sharded:
            return values
        values = list(values)
        summed = self._axis.all_reduce(torch.stack([values[i] for i in self._sharded]))
        for i, v in zip(self._sharded, summed):
            values[i] = v
        return values

    def _global_norm(self, flat: torch.Tensor, views: list[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of all the (whole) parameters' values in `flat`."""
        if self._axis is None:
            return torch.linalg.vector_norm(flat, dtype=torch.float64)
        return torch.stack(self._norms(views)).square().sum().sqrt()

    @torch.no_grad()
    def step(self, finite: torch.Tensor | None = None,
             reduce: Callable[[torch.Tensor], None] | None = None) -> torch.Tensor:
        """One call (see the class). `reduce`, with accumulation, is applied
        in place to the mean of the earlier calls' gradients before this
        call's joins it (the cross-rank mean, where those gradients stayed
        on their rank under DDP's no_sync)."""
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
            ok = finite & torch.isfinite(self._global_norm(self._grad, self._grad_views))
        if self.accum_steps > 1:  # optax.MultiSteps: a running mean of the k gradients
            n, acc = shared["mini_step"], shared["acc"]
            if reduce is not None:
                reduce(acc)
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
            norm = self._global_norm(work, self._work_views)
            work.mul_(torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        self._centralize_grads()

        self._extend_table()
        row = self._table.index_select(0, shared["count"].view(1))[0]
        s = torch.where(commit, row, self._identity)
        params = self._params
        update = self._update(s, self._work_views, params)
        lr_col = self._n_scalars
        for gi, sl in enumerate(self._group_slices):
            torch._foreach_mul_(update[sl], s[lr_col + gi])
        update = self._after_lr(s, update)
        torch._foreach_add_(params, update)  # the fast weights
        if self.lookahead:  # slow += alpha (fast - slow), then fast = slow, on a sync
            alpha_sync, sync = s[lr_col - 2], s[lr_col - 1]
            slow = self._states("slow")
            diff = torch._foreach_sub(params, slow)
            torch._foreach_mul_(diff, alpha_sync)
            torch._foreach_add_(slow, diff)
            diff = torch._foreach_sub(slow, params)
            torch._foreach_mul_(diff, sync)
            torch._foreach_add_(params, diff)

        shared["count"].add_(commit.long())
        self._calls += 1
        return ok

    def _centralize_grads(self) -> None:
        self._centralize(self._work_views)


def _tensor_norms(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor's L2 norm, summed in f64: an f32 sum over millions of
    values drifts by up to 1e-4 relative (PyTorch's CPU norm of 4M values),
    which would swamp the order in which a model axis sums a tensor's
    shards."""
    return list(torch._foreach_norm(tensors, 2, dtype=torch.float64))


def _trust_ratio(update: list, params: list, norms: Callable = _tensor_norms) -> list:
    """LAMB's per-tensor clip(|p|, 0, 10) / (|u| + 1e-8), 1 where either
    norm is 0, in place; returns the ratios. norms(tensors) gives each
    whole tensor's norm (the optimizer's _norms on a model axis)."""
    pn, un = norms(params), norms(update)
    ratios = []
    for u, a, b in zip(update, pn, un):
        a = a.clamp(0.0, 10.0)
        ratios.append(torch.where((a > 0) & (b > 0), a / (b + 1e-8), 1.0))
        u.mul_(ratios[-1])
    return ratios


def _project(update: list, params: list, delta: float, wd_ratio: float,
             weight_decay: float, opt: TableOptimizer) -> list:
    """AdamP / SGDP: where the update is nearly orthogonal to the parameter
    (|cos| < delta / sqrt(dim)), drop its radial part and scale the decay by
    wd_ratio. `opt` gives the whole tensors' norms, dot products and sizes
    (over the model group for a sharded one)."""
    pns = [p / (n + 1e-12) for p, n in zip(params, opt._norms(params))]
    dots = opt._sums([(pn * u).sum() for pn, u in zip(pns, update)])
    unorms = opt._norms(update)
    numels = [math.prod(opt._full_shape(i)) for i in range(len(params))]
    out = []
    for u, p, pn, dot, un, n in zip(update, params, pns, dots, unorms, numels):
        cos = dot.abs() / (un + 1e-12)
        small = cos < delta / math.sqrt(n)
        v = torch.where(small, u - dot * pn, u)
        if weight_decay > 0:
            v = v + weight_decay * torch.where(small, wd_ratio, 1.0) * p
        out.append(v)
    return out


class RAdam(TableOptimizer):
    """RAdam and the optimizers built on it (Ranger, ralamb, over9000,
    Ranger2020): rectified coef * mu / (sqrt(nu) + eps) when the variance
    estimate is tractable (SMA above the threshold), bias-corrected momentum
    coef * mu before. weight_decay adds wd * p after the step
    (decay_in_step: before the step size, Ranger2020's order);
    gc_on_update centralises that step instead of the gradient (Ranger2020's
    gc_loc=False); trust_ratio scales each tensor's step by LAMB's ratio."""

    STATE = {"mu": "zeros", "nu": "zeros"}
    IDENTITY = [1.0, 1.0, 1.0, 0.0, 0.0]  # decay1, decay2, use_rect, 1 - use_rect, coef

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, sma_threshold: float = 5.0,
                 decay_in_step: bool = False, gc_on_update: bool = False,
                 trust_ratio: bool = False, **shared):
        super().__init__(params, lr, **shared)
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.sma_threshold = eps, weight_decay, sma_threshold
        self.decay_in_step, self.gc_on_update = decay_in_step, gc_on_update
        self.trust_ratio = trust_ratio

    def _scalars(self, t: int) -> list[float]:
        rect, plain, use = radam_step_scalars(t, self.b1, self.b2, self.sma_threshold)
        return [self.b1, self.b2, float(use), 1.0 - use, rect if use else plain]

    def _centralize_grads(self) -> None:
        if not self.gc_on_update:
            super()._centralize_grads()

    def _update(self, s, grads, params):
        decay1, decay2, use, not_use, coef = s[:5]
        mu, nu = self._states("mu"), self._states("nu")
        torch._foreach_mul_(mu, decay1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, decay2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        # rectified: mu / (sqrt(nu) + eps); momentum: mu
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(denom, use)
        torch._foreach_add_(denom, not_use)
        update = torch._foreach_div(mu, denom)
        if self.decay_in_step:
            if self.weight_decay > 0:
                torch._foreach_add_(update, params, alpha=self.weight_decay)
            if self.gc_on_update:
                self._centralize(update)
            torch._foreach_mul_(update, coef)
        else:
            torch._foreach_mul_(update, coef)
            if self.weight_decay > 0:
                torch._foreach_add_(update, params, alpha=self.weight_decay)
        if self.trust_ratio:
            _trust_ratio(update, params, self._norms)
        return update


class Ranger(RAdam):
    """Ranger: GC, RAdam (b 0.95 / 0.999, eps 1e-5, SMA threshold 5),
    decoupled weight decay and -lr, in Lookahead (alpha 0.5, k 6)."""

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 betas: tuple[float, float] = (0.95, 0.999), eps: float = 1e-5,
                 weight_decay: float = 0.0, alpha: float = 0.5, k: int = 6,
                 use_gc: bool = True, gc_conv_only: bool = False,
                 sma_threshold: float = 5.0, grad_clip: float = 0.0, accum_steps: int = 1,
                 transposed: Iterable[torch.Tensor] = (), shards: tuple | None = None):
        super().__init__(params, lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         sma_threshold=sma_threshold, grad_clip=grad_clip,
                         accum_steps=accum_steps, transposed=transposed, shards=shards,
                         gc=("conv" if gc_conv_only else "all") if use_gc else None,
                         lookahead=(alpha, k))


class Adam(TableOptimizer):
    """optax's scale_by_adam: mu, nu, then (mu / bc1) / (sqrt(nu / bc2) +
    eps). decay: "coupled" adds wd * p to the gradient first (adam with
    weight decay), "decoupled" adds it to the step (adamw), "project" is
    AdamP's projection with its decay."""

    STATE = {"mu": "zeros", "nu": "zeros"}
    # decay1, 1 - decay1, decay2, 1 - decay2, 1 - b1^t, 1 - b2^t, coupled wd
    IDENTITY = [1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0]

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decay: str = "coupled", delta: float = 0.1,
                 wd_ratio: float = 0.1, **shared):
        super().__init__(params, lr, **shared)
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.decay = eps, weight_decay, decay
        self.delta, self.wd_ratio = delta, wd_ratio

    def _scalars(self, t: int) -> list[float]:
        coupled = self.weight_decay if self.decay == "coupled" else 0.0
        return [self.b1, 1 - self.b1, self.b2, 1 - self.b2, bias_correction(self.b1, t),
                bias_correction(self.b2, t), coupled]

    def _update(self, s, grads, params):
        d1, c1, d2, c2, bc1, bc2, coupled = s[:7]
        if self.decay == "coupled" and self.weight_decay > 0:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, coupled))
        mu, nu = self._states("mu"), self._states("nu")
        torch._foreach_mul_(mu, d1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, c1))
        torch._foreach_mul_(nu, d2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), c2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.decay == "project":
            return _project(update, params, self.delta, self.wd_ratio, self.weight_decay, self)
        if self.decay == "decoupled" and self.weight_decay > 0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        return update


class AdaBelief(TableOptimizer):
    """optax's scale_by_belief: mu; s = (1 - b2) (g - mu)^2 + b2 s + eps_root;
    (mu / bc1) / (sqrt(s / bc2) + eps); then decoupled decay."""

    STATE = {"mu": "zeros", "nu": "zeros"}
    # decay1, 1 - decay1, decay2, 1 - decay2, eps_root, 1 - b1^t, 1 - b2^t
    IDENTITY = [1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0]

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-16,
                 eps_root: float = 1e-16, weight_decay: float = 0.0, **shared):
        super().__init__(params, lr, **shared)
        self.b1, self.b2 = betas
        self.eps, self.eps_root, self.weight_decay = eps, eps_root, weight_decay

    def _scalars(self, t: int) -> list[float]:
        return [self.b1, 1 - self.b1, self.b2, 1 - self.b2, self.eps_root,
                bias_correction(self.b1, t), bias_correction(self.b2, t)]

    def _update(self, s, grads, params):
        d1, c1, d2, c2, eps_root, bc1, bc2 = s[:7]
        mu, nu = self._states("mu"), self._states("nu")
        torch._foreach_mul_(mu, d1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, c1))
        err = torch._foreach_sub(grads, mu)
        torch._foreach_mul_(nu, d2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(err, err), c2))
        torch._foreach_add_(nu, eps_root)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay > 0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        return update


class SGD(TableOptimizer):
    """SGD: coupled decay (g + wd p), momentum as optax.trace (t = g + m t;
    nesterov: g + m t), -lr; project=True is SGDP (momentum first, then
    the projection with its decay)."""

    IDENTITY = [0.0, 1.0]  # coupled wd, momentum

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 momentum: float = 0.9, nesterov: bool = False, weight_decay: float = 0.0,
                 project: bool = False, delta: float = 0.1, wd_ratio: float = 0.1,
                 **shared):
        self.STATE = {"trace": "zeros"} if momentum > 0 else {}
        super().__init__(params, lr, **shared)
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay
        self.project, self.delta, self.wd_ratio = project, delta, wd_ratio

    def _scalars(self, t: int) -> list[float]:
        return [0.0 if self.project else self.weight_decay, self.momentum]

    def _update(self, s, grads, params):
        coupled, momentum = s[:2]
        if self.weight_decay > 0 and not self.project:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, coupled))
        if self.momentum > 0:
            trace = self._states("trace")
            torch._foreach_mul_(trace, momentum)
            torch._foreach_add_(trace, grads)
            update = (torch._foreach_add(grads, torch._foreach_mul(trace, momentum))
                      if self.nesterov else [t.clone() for t in trace])
        else:
            update = [g.clone() for g in grads]
        if self.project:
            return _project(update, params, self.delta, self.wd_ratio, self.weight_decay, self)
        return update


class RMSprop(TableOptimizer):
    """optax.rmsprop: nu = (1 - a) g^2 + a nu; g / sqrt(nu + eps) (eps inside
    the root, the TF semantics); -lr; then momentum on the scaled step
    (optax.trace after the learning rate)."""

    STATE = {"nu": "zeros", "trace": "zeros"}
    IDENTITY = [1.0, 0.0, 1.0, 0.0]  # decay, 1 - decay, momentum, commit

    def __init__(self, params: Iterable, lr: float | Callable[[int], float] = 1e-3,
                 alpha: float = 0.99, momentum: float = 0.0, eps: float = 1e-8, **shared):
        super().__init__(params, lr, **shared)
        self.alpha, self.momentum, self.eps = alpha, momentum, eps

    def _scalars(self, t: int) -> list[float]:
        return [self.alpha, 1 - self.alpha, self.momentum, 1.0]

    def _update(self, s, grads, params):
        decay, c, _, _ = s[:4]
        nu = self._states("nu")
        torch._foreach_mul_(nu, decay)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), c))
        return torch._foreach_mul(grads, torch._foreach_rsqrt(torch._foreach_add(nu, self.eps)))

    def _after_lr(self, s, update):
        momentum, commit = s[2], s[3]
        trace = self._states("trace")
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, update)
        return torch._foreach_mul(trace, commit)


def _betas(oc: dict, default: tuple[float, float]) -> tuple[float, float]:
    b = oc.get("betas", default)
    return (b[0], b[1])


def _gc(oc: dict, conv_only: bool | None = None) -> str | None:
    if not oc.get("use_gc", True):
        return None
    conv = oc.get("gc_conv_only", False) if conv_only is None else conv_only
    return "conv" if conv else "all"


# name -> (SOLVER.OPTIMIZER_CFG, lr, shared kwargs) -> optimizer, each with the
# JAX registry's defaults and the keys its builder reads
_BUILDERS: dict[str, Callable] = {
    "ranger": lambda ps, oc, lr, kw: Ranger(
        ps, lr, betas=_betas(oc, (0.95, 0.999)), weight_decay=oc.get("weight_decay", 0.0),
        use_gc=oc.get("use_gc", True), gc_conv_only=oc.get("gc_conv_only", False), **kw),
    "radam": lambda ps, oc, lr, kw: RAdam(
        ps, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=oc.get("weight_decay", 0.0),
        sma_threshold=4.0, **kw),
    "adabelief": lambda ps, oc, lr, kw: AdaBelief(
        ps, lr, weight_decay=oc.get("weight_decay", 0.0), **kw),
    "adam": lambda ps, oc, lr, kw: Adam(
        ps, lr, weight_decay=oc.get("weight_decay", 0.0), decay="coupled", **kw),
    "adamw": lambda ps, oc, lr, kw: Adam(
        ps, lr, weight_decay=oc.get("weight_decay", 1e-4), decay="decoupled", **kw),
    "sgd": lambda ps, oc, lr, kw: SGD(
        ps, lr, momentum=oc.get("momentum", 0.9), nesterov=oc.get("nesterov", False),
        weight_decay=oc.get("weight_decay", 0.0), **kw),
    "sgd_gc": lambda ps, oc, lr, kw: SGD(
        ps, lr, momentum=oc.get("momentum", 0.9), nesterov=oc.get("nesterov", False),
        weight_decay=oc.get("weight_decay", 0.0),
        gc="conv" if oc.get("type", "SGD_GC").lower() == "sgd_gcc" else "all", **kw),
    "rmsprop": lambda ps, oc, lr, kw: RMSprop(
        ps, lr, alpha=oc.get("alpha", 0.99), momentum=oc.get("momentum", 0.0),
        eps=oc.get("eps", 1e-8), **kw),
    "adamp": lambda ps, oc, lr, kw: Adam(
        ps, lr, weight_decay=oc.get("weight_decay", 0.0), decay="project",
        delta=oc.get("delta", 0.1), wd_ratio=oc.get("wd_ratio", 0.1), **kw),
    "sgdp": lambda ps, oc, lr, kw: SGD(
        ps, lr, momentum=oc.get("momentum", 0.9), nesterov=oc.get("nesterov", False),
        weight_decay=oc.get("weight_decay", 0.0), project=True, **kw),
    "ralamb": lambda ps, oc, lr, kw: RAdam(
        ps, lr, betas=(0.95, 0.999), eps=1e-5, weight_decay=oc.get("weight_decay", 0.0),
        trust_ratio=True, **kw),
    "over9000": lambda ps, oc, lr, kw: RAdam(
        ps, lr, betas=(0.95, 0.999), eps=1e-5, weight_decay=oc.get("weight_decay", 0.0),
        trust_ratio=True, lookahead=(0.5, 6), **kw),
    "ranger2020": lambda ps, oc, lr, kw: RAdam(
        ps, lr, betas=(0.95, 0.999), eps=1e-5, weight_decay=oc.get("weight_decay", 0.0),
        decay_in_step=True, gc_on_update=not oc.get("gc_loc", True), gc=_gc(oc),
        lookahead=(0.5, 6), **kw),
}
_ALIASES = {"rangeradabelief": "adabelief", "sgd_gcc": "sgd_gc", "rmsprop_tf": "rmsprop",
            "rangerlars": "over9000"}
OPTIMIZER_NAMES = tuple(sorted(set(_BUILDERS) | set(_ALIASES)))


def build_optimizer(cfg, model: nn.Module,
                    lr_schedule: Callable[[int], float] | None = None, *,
                    jax_deconv_gc: bool = False) -> TableOptimizer:
    """SOLVER.OPTIMIZER_CFG (type: any of OPTIMIZER_NAMES, case-insensitive)
    -> the optimizer of `model`'s parameters, one param group per LR
    multiplier (MODEL.CDPN.PNP_NET.LR_MULT for pnp_net, TRANS_HEAD.LR_MULT
    for trans_head_net, 1 elsewhere, the MTL log-variances too), with
    SOLVER.GRAD_CLIP and SOLVER.GRAD_ACCUM_STEPS. Gradient centralisation
    follows the original rule; jax_deconv_gc=True centralises the
    ConvTranspose2d weights per output channel, as the JAX package does (for
    the parity tests)."""
    oc = dict(cfg.SOLVER.OPTIMIZER_CFG)
    opt_type = oc.get("type", "Ranger").lower()
    name = _ALIASES.get(opt_type, opt_type)
    if name not in _BUILDERS:
        raise ValueError(f"Unknown optimizer type: {oc.get('type')}; one of {OPTIMIZER_NAMES}")

    net_cfg = cfg.MODEL.CDPN
    mults = {"pnp_net": net_cfg.PNP_NET.get("LR_MULT", 1.0),
             "trans_head_net": net_cfg.TRANS_HEAD.get("LR_MULT", 1.0)}
    groups: dict[float, list] = {}
    for pname, p in model.named_parameters():
        groups.setdefault(float(mults.get(pname.split(".")[0], 1.0)), []).append(p)
    shared = dict(grad_clip=cfg.SOLVER.get("GRAD_CLIP", 0.0),
                  accum_steps=int(cfg.SOLVER.get("GRAD_ACCUM_STEPS", 1) or 1),
                  transposed=[m.weight for m in model.modules()
                              if jax_deconv_gc and isinstance(m, nn.ConvTranspose2d)],
                  shards=tensor_parallel.shards(model))
    lr = lr_schedule if lr_schedule is not None else oc.get("lr", 1e-4)
    return _BUILDERS[name]([{"params": ps, "lr_mult": m} for m, ps in groups.items()],
                           oc, lr, shared)
