"""The model axis: column-parallel layers over the model group (counterpart
of gdrnet_tpu/parallel/mesh.py:60-69's constrain_params and of the
activation all-gathers GSPMD inserts around the sharded kernels).

shard_model swaps each layer that parallel/mesh.param_partition picks (a
Conv2d, ConvTranspose2d or Linear weight of at least 2^16 values whose
output dimension the model axis divides) in place for its column-parallel
twin: the module keeps its name, hooks and state_dict keys, its weight
becomes the rank's 1/m slice of the output dimension (dim 0 of a Conv2d or
Linear weight, dim 1 of a ConvTranspose2d's [in, out, kh, kw]) and its bias
stays whole. Its forward runs the slice, gathers the full output over the
model group along the channel (feature) dimension and adds the bias there,
so every model peer holds the output one process computes and all that
follows (BatchNorm, the losses) runs replicated. The backward hands the
rank's slice of the output's gradient to the slice and sums the input's
gradient over the model group. Only all_gather (its list form) and
all_reduce are used: gloo, on which the tests and the card's gloo ranks
run, has no reduce_scatter.

sync_replicated_grads averages the replicated parameters' gradients over
the model group before the optimizer, so that model peers keep those
parameters equal on the card too, where a backward may add in no fixed
order. The gathered forms: full_state_dict and full_grads are what one process
holds (collectives: every model peer calls them); full_replica is an
unsharded copy of the model for testing; a sharded layer takes its slice of
a full weight in load_state_dict, so a checkpoint of one process loads
onto any grid. The optimizer reads `shards(model)` for its reductions over
whole tensors (solver/optimizers.py). Plain PyTorch: it ports no TPU kernel.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from gdrnet_tpu_torch.parallel import multihost as mh


class ModelAxis:
    """This rank's place on the model axis: its model group, the group's
    size and the rank's index in it. Shared, not copied, by deepcopy."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model peers, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The peers' slices of a tensor, concatenated along `dim` in rank
        order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of a full tensor along `dim`."""
        return t.chunk(self.size, dim)[self.rank]


class _GatherOutput(torch.autograd.Function):
    """Forward: the peers' output slices gathered along `dim`. Backward: the
    rank's slice of the output's gradient."""

    @staticmethod
    def forward(ctx, y, dim: int, axis: ModelAxis):
        ctx.dim, ctx.axis = dim, axis
        return axis.gather(y, dim)

    @staticmethod
    def backward(ctx, dy):
        return ctx.axis.slice(dy, ctx.dim).contiguous(), None, None


class _SumInputGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the input's gradient summed over the
    peers (each holds the part that flows through its slice)."""

    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return ctx.axis.all_reduce(dx.contiguous()), None


class _ColumnParallel:
    """What the three sharded layer types share: `axis`, `shard_dim` (of the
    weight), `out_dim` (of the output), `full_shape` (of the weight)."""

    axis: ModelAxis
    shard_dim: int
    out_dim: int
    full_shape: tuple

    def _parallel(self, x: torch.Tensor, local) -> torch.Tensor:
        y = local(_SumInputGrad.apply(x, self.axis))
        y = _GatherOutput.apply(y, self.out_dim, self.axis)
        if self.bias is None:
            return y
        shape = [1] * y.dim()
        shape[self.out_dim] = -1
        return y + self.bias.to(y.dtype).view(shape)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        if key in state_dict and tuple(state_dict[key].shape) == self.full_shape:
            state_dict[key] = self.axis.slice(state_dict[key], self.shard_dim)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ShardedConv2d(_ColumnParallel, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._parallel(x, lambda x: self._conv_forward(x, self.weight, None))


class ShardedConvTranspose2d(_ColumnParallel, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._parallel(x, lambda x: F.conv_transpose2d(
            x, self.weight, None, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation))


class ShardedLinear(_ColumnParallel, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._parallel(x, lambda x: F.linear(x, self.weight))


# layer type -> (its sharded twin, the weight's output dim, the output's channel dim)
SHARDED = {nn.Conv2d: (ShardedConv2d, 0, 1), nn.ConvTranspose2d: (ShardedConvTranspose2d, 1, 1),
           nn.Linear: (ShardedLinear, 0, -1)}


def sharded_modules(model: nn.Module) -> list[tuple[str, _ColumnParallel]]:
    return [(n, m) for n, m in model.named_modules() if isinstance(m, _ColumnParallel)]


def shard_model(model: nn.Module) -> nn.Module:
    """Swap the layers that param_partition picks for this rank's model axis
    (parallel/multihost.py) for their column-parallel twins, in place
    (module docstring), each keeping the rank's slice of its weight. Build
    the optimizer after: the sliced weights are new parameters. A no-op on a
    model axis of one rank. Returns `model`."""
    from gdrnet_tpu_torch.parallel.mesh import param_partition

    axis = ModelAxis(mh.model_group(), mh.model_size(), mh.model_rank())
    if axis.size == 1:
        return model
    modules = dict(model.named_modules())
    for name in param_partition(model, axis.size):
        layer = modules[name.rsplit(".", 1)[0]]
        twin, dim, out_dim = SHARDED[type(layer)]
        if getattr(layer, "groups", 1) != 1:
            raise NotImplementedError(f"{name}: a grouped convolution on the model axis")
        w = layer.weight
        layer.__class__ = twin
        layer.axis, layer.shard_dim, layer.out_dim = axis, dim, out_dim
        layer.full_shape = tuple(w.shape)
        layer.weight = nn.Parameter(axis.slice(w.detach(), dim).clone(),
                                    requires_grad=w.requires_grad)
    return model


@torch.no_grad()
def sync_replicated_grads(model: nn.Module) -> None:
    """Average the gradients of the replicated (not sharded) parameters over
    the model group, in place, so that every model peer takes the same
    update of them. Peers compute the same replicated values, but on the
    card a backward that adds in no fixed order (cuDNN's, atomics) may part
    them in the last bits; on the CPU the mean of equal values is each of
    them. A no-op without sharded layers."""
    layers = sharded_modules(model)
    if not layers:
        return
    axis, sharded = layers[0][1].axis, {id(m.weight) for _, m in layers}
    grads = [p.grad for p in model.parameters() if id(p) not in sharded and p.grad is not None]
    if grads:
        flat = axis.all_reduce(torch.cat([g.reshape(-1) for g in grads])).div_(axis.size)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


def shards(model: nn.Module) -> tuple[ModelAxis, dict] | None:
    """(the model axis, {sharded weight: its shard dim}) of a sharded model;
    None for a model with no sharded layer."""
    layers = sharded_modules(model)
    if not layers:
        return None
    return layers[0][1].axis, {m.weight: m.shard_dim for _, m in layers}


def full_shapes(model: nn.Module) -> dict:
    """state_dict key -> the shape one process holds."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    shapes.update({f"{n}.weight": m.full_shape for n, m in sharded_modules(model)})
    return shapes


@torch.no_grad()
def full_state_dict(model: nn.Module) -> dict:
    """The model's state_dict with every sharded weight gathered whole: one
    process's keys, order and shapes (a collective over the model group)."""
    sd = model.state_dict()
    for n, m in sharded_modules(model):
        sd[f"{n}.weight"] = m.axis.gather(m.weight.detach(), m.shard_dim)
    return sd


@torch.no_grad()
def full_grads(model: nn.Module) -> list[torch.Tensor]:
    """Each parameter's gradient in model.parameters() order (zeros where
    it got none), a sharded one's gathered whole (a collective over the
    model group)."""
    dims = {id(m.weight): (m.axis, m.shard_dim) for _, m in sharded_modules(model)}
    out = []
    for p in model.parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if id(p) in dims:
            axis, dim = dims[id(p)]
            g = axis.gather(g, dim)
        out.append(g)
    return out


def full_replica(model: nn.Module) -> nn.Module:
    """An unsharded copy of a sharded model (its weights gathered; a
    collective over the model group); the model itself when it has no
    sharded layer."""
    layers = sharded_modules(model)
    if not layers:
        return model
    full = full_state_dict(model)
    replica = copy.deepcopy(model)
    for n, m in sharded_modules(replica):
        base = next(t for t, (twin, _, _) in SHARDED.items() if isinstance(m, twin))
        m.__class__ = base
        for attr in ("axis", "shard_dim", "out_dim", "full_shape"):
            delattr(m, attr)
        m.weight = nn.Parameter(full[f"{n}.weight"].clone(),
                                requires_grad=m.weight.requires_grad)
    return replica
