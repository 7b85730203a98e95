"""The train and predict steps (counterpart of gdrnet_tpu/engine/steps.py).

Batches keep the JAX package's layout: `roi_img` [B, H, W, 3],
`roi_coord_2d` [B, h, w, 2], and the maps come back NHWC. A model whose
`compute_dtype` is "bfloat16" (PARALLEL.DTYPE) runs under bf16 autocast; the
head's out conv, the pose regressors and the decode stay f32, and so do the
parameters, the optimizer state and the losses.

Under a process group the train step takes the DDP-wrapped model (one
process a GPU, parallel/): each rank runs its row block of the global batch,
its BatchNorms normalise over the global batch (parallel/sync_bn.py), the
losses are its share of the global terms (losses/gdrn_loss.py), DDP
averages the gradients, and the logged metrics and the non-finite flag are
reduced over the ranks, so every rank takes or skips the same update and
logs the global values, as the JAX package's one program over the sharded
batch does. On a (data, model) grid (PARALLEL.MODEL_PARALLEL) the row blocks,
BatchNorms, loss normalisers and DDP are the data group's, the sharded
layers gather their outputs over the model group (parallel/
tensor_parallel.py), and the optimizer's whole-tensor reductions sum over it
(solver/optimizers.py): model peers compute the same replicated values, the
replicated parameters' gradients are averaged over the model group (equal
on the CPU; a card's backward may part them in the last bits), so those
parameters stay equal on the peers, and each holds its slice of the sharded
ones.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from gdrnet_tpu_torch.engine.train_state import TrainState
from gdrnet_tpu_torch.losses.gdrn_loss import gdrn_loss
from gdrnet_tpu_torch.ops.rotation import rot_angle_deg
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.parallel import tensor_parallel

_MODEL_KWARG_KEYS = (
    "roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
    "roi_extents", "resize_ratios",
)


def _model_kwargs(batch: dict) -> dict:
    return {k: batch[k] for k in _MODEL_KWARG_KEYS if k in batch}


def _autocast(model: torch.nn.Module, device: torch.device):
    return (torch.autocast(device.type, dtype=torch.bfloat16)
            if model.compute_dtype == "bfloat16" else contextlib.nullcontext())


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors]) if tensors else torch.empty(0)


def _restore_where_not(ok: torch.Tensor, tensors: list[torch.Tensor],
                       snapshot: torch.Tensor) -> None:
    """Put the snapshot (a _flat of `tensors`) back where the device flag
    `ok` is false, without a host sync."""
    if not tensors:
        return
    keep = torch.where(ok, _flat(tensors), snapshot)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(keep.split([t.numel() for t in tensors]), tensors)])


class _TieOutputs(torch.autograd.Function):
    """The loss in the forward; in the backward, its gradient, and a zero
    gradient into each of the model's other outputs. DDP's static graph
    (parallel/mesh.ddp_model) ties the outputs of its first step to the
    loss so, and records every parameter behind them as used: an output the
    loss leaves out (the translation where its losses are off) must then
    reach the backward at every later step too, or DDP waits for those
    parameters' gradients. Zeros change no update: the optimizer takes a
    missing gradient as zeros."""

    @staticmethod
    def forward(ctx, total, *outputs):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in outputs]
        return total.view_as(total)

    @staticmethod
    def backward(ctx, grad):
        return grad, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes)


def make_train_step(cfg, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    dropblock_nr_steps: int = 5000) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics), on the
    model's device: the forward in train mode, gdrn_loss in f32, backward,
    the optimizer, then state.step += 1. `model` is the model or, under a
    process group, its DistributedDataParallel wrapper. `batch` holds arrays
    or tensors (moved to the model's device); `generator` (on that device)
    feeds DropBlock, whose progress is state.step / dropblock_nr_steps.

    metrics are device tensors: every loss term, total_loss, vis/error_R
    (degrees), vis/error_t (cm) and, with SOLVER.SKIP_NONFINITE, nonfinite_skip:
    1.0 when the loss or a gradient was not finite (on any rank), and then the
    parameters, the optimizer state and the BN buffers are exactly as before
    the step. Under a process group they are the global batch's: the mean of
    the ranks' values. With SOLVER.GRAD_ACCUM_STEPS=k under a process group,
    the first k-1 micro-steps of an update run under DDP's no_sync and the
    optimizer's running mean of the gradients is averaged over the ranks once,
    at the k-th (TableOptimizer.step's `reduce`); which micro-step comes next
    is the optimizer's device count, read once a micro-step. The first call
    runs synced whichever micro-step it is: DDP records its static graph
    there (parallel/mesh.ddp_model), and a mean over the ranks taken early
    is the same mean."""
    module = model.module if isinstance(model, DistributedDataParallel) else model
    ddp = module is not model
    world, data_world = mh.get_world_size(), mh.data_size() if ddp else 1
    device = next(module.parameters()).device
    skip_nonfinite = bool(cfg.SOLVER.get("SKIP_NONFINITE", True))
    buffers = list(module.buffers())  # BN running stats; torch updates them in the forward
    groups = [[b for b in buffers if b.is_floating_point()],
              [b for b in buffers if not b.is_floating_point()]]
    accum = getattr(optimizer, "accum_steps", 1) if ddp else 1

    first = [True]

    def rank_mean(t: torch.Tensor) -> None:  # over the ranks that split the batch
        dist.all_reduce(t, group=mh.data_group())
        t.div_(data_world)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        model.train()
        snapshots = [_flat(g) for g in groups] if skip_nonfinite else None
        optimizer.zero_grad(set_to_none=True)
        # an update's micro-steps before its last keep their gradients local,
        # but for DDP's first step (its static graph is recorded on a synced one)
        local = accum > 1 and not first[0] and optimizer.micro_step() < accum - 1
        first[0] = False
        with model.no_sync() if local else contextlib.nullcontext():
            with _autocast(module, device):
                out = model(batch["roi_img"], **_model_kwargs(batch),
                            dropblock_progress=state.step / dropblock_nr_steps,
                            generator=generator)
            with torch.autocast(device.type, enabled=False):
                loss_dict = gdrn_loss(cfg, out, batch)
            total = sum(loss_dict[k] for k in sorted(loss_dict))  # the JAX package's leaf order
            if ddp:  # every output in the backward at every step, as at DDP's first
                total = _TieOutputs.apply(total, *[v for v in out.values() if v.requires_grad])
            total.backward()
        tensor_parallel.sync_replicated_grads(module)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["total_loss"] = total.detach()
        with torch.no_grad():  # train-time pose errors, as the reference logs them
            metrics["vis/error_R"] = rot_angle_deg(out["rot"], batch["gt_ego_rot"]).mean()
            metrics["vis/error_t"] = (out["trans"] - batch["gt_trans"]).norm(dim=-1).mean() * 100.0
        finite = torch.isfinite(metrics["total_loss"])
        if local:  # gradients DDP did not average: each rank's own count
            finite = finite & torch.isfinite(torch.linalg.vector_norm(
                _flat([p.grad for p in module.parameters() if p.grad is not None])))
        if world > 1:  # the global values, and one flag for every rank
            names = sorted(metrics)
            vec = torch.stack([metrics[k] for k in names] + [(~finite).float()])
            dist.all_reduce(vec)
            metrics = dict(zip(names, vec[:-1] / world))
            finite = vec[-1] == 0
        reduce = {"reduce": rank_mean} if accum > 1 and not local else {}
        if skip_nonfinite:
            ok = optimizer.step(finite=finite, **reduce)
            for g, snap in zip(groups, snapshots):
                _restore_where_not(ok, g, snap)
            metrics["nonfinite_skip"] = (~ok).float()
        else:
            optimizer.step(**reduce)
        state.step += 1
        return state, metrics

    return train_step


def make_predict_step(model: torch.nn.Module, with_maps: bool = False,
                      int8_scales: dict | None = None) -> Callable[[dict], dict]:
    """Returns predict(batch) -> {"rot", "trans"} (plus the mask / coor /
    region maps with `with_maps`), the test-time forward. With `int8_scales`
    (models.quantize.calibrate_act_scales) it runs a quantized copy of the
    model, made once here, whose calibrated layers take the int8 path
    (TEST.INT8); `model` itself is left as it was."""
    model.eval()
    if int8_scales:
        from gdrnet_tpu_torch.models.quantize import quantize_model

        model = quantize_model(model, int8_scales)

    def predict(batch: dict) -> dict:
        with torch.inference_mode(), _autocast(model, batch["roi_img"].device):
            out = model(batch["roi_img"], **_model_kwargs(batch))
        keep = {"rot": out["rot"], "trans": out["trans"]}
        if with_maps:
            for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
                keep[k] = out[k]
        return keep

    return predict
