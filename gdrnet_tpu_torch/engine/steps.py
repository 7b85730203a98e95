"""The train and predict steps (counterpart of gdrnet_tpu/engine/steps.py).

Batches keep the JAX package's layout: `roi_img` [B, H, W, 3],
`roi_coord_2d` [B, h, w, 2], and the maps come back NHWC. A model whose
`compute_dtype` is "bfloat16" (PARALLEL.DTYPE) runs under bf16 autocast; the
head's out conv, the pose regressors and the decode stay f32, and so do the
parameters, the optimizer state and the losses.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from gdrnet_tpu_torch.engine.train_state import TrainState
from gdrnet_tpu_torch.losses.gdrn_loss import gdrn_loss
from gdrnet_tpu_torch.ops.rotation import rot_angle_deg

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


def make_train_step(cfg, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    dropblock_nr_steps: int = 5000) -> Callable:
    """Returns train_step(state, batch, generator) -> (state, metrics), on the
    model's device: the forward in train mode, gdrn_loss in f32, backward,
    the optimizer, then state.step += 1. `batch` holds arrays or tensors
    (moved to the model's device); `generator` (on that device) feeds
    DropBlock, whose progress is state.step / dropblock_nr_steps.

    metrics are device tensors: every loss term, total_loss, vis/error_R
    (degrees), vis/error_t (cm) and, with SOLVER.SKIP_NONFINITE, nonfinite_skip:
    1.0 when the loss or a gradient was not finite, and then the parameters,
    the optimizer state and the BN buffers are exactly as before the step."""
    device = next(model.parameters()).device
    skip_nonfinite = bool(cfg.SOLVER.get("SKIP_NONFINITE", True))
    buffers = list(model.buffers())  # BN running stats; torch updates them in the forward
    groups = [[b for b in buffers if b.is_floating_point()],
              [b for b in buffers if not b.is_floating_point()]]

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        model.train()
        snapshots = [_flat(g) for g in groups] if skip_nonfinite else None
        optimizer.zero_grad(set_to_none=True)
        with _autocast(model, device):
            out = model(batch["roi_img"], **_model_kwargs(batch),
                        dropblock_progress=state.step / dropblock_nr_steps,
                        generator=generator)
        with torch.autocast(device.type, enabled=False):
            loss_dict = gdrn_loss(cfg, out, batch)
        total = sum(loss_dict[k] for k in sorted(loss_dict))  # the JAX package's leaf order
        total.backward()
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        if skip_nonfinite:
            ok = optimizer.step(finite=torch.isfinite(total.detach()))
            for g, snap in zip(groups, snapshots):
                _restore_where_not(ok, g, snap)
            metrics["nonfinite_skip"] = (~ok).float()
        else:
            optimizer.step()
        metrics["total_loss"] = total.detach()
        with torch.no_grad():  # train-time pose errors, as the reference logs them
            metrics["vis/error_R"] = rot_angle_deg(out["rot"], batch["gt_ego_rot"]).mean()
            metrics["vis/error_t"] = (out["trans"] - batch["gt_trans"]).norm(dim=-1).mean() * 100.0
        state.step += 1
        return state, metrics

    return train_step


def make_predict_step(model: torch.nn.Module, with_maps: bool = False
                      ) -> Callable[[dict], dict]:
    """Returns predict(batch) -> {"rot", "trans"} (plus the mask / coor /
    region maps with `with_maps`), the test-time forward."""
    model.eval()

    def predict(batch: dict) -> dict:
        with torch.inference_mode(), _autocast(model, batch["roi_img"].device):
            out = model(batch["roi_img"], **_model_kwargs(batch))
        keep = {"rot": out["rot"], "trans": out["trans"]}
        if with_maps:
            for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
                keep[k] = out[k]
        return keep

    return predict
