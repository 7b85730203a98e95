"""The predict step (counterpart of gdrnet_tpu/engine/steps.py:make_predict_step).

Batches keep the JAX package's layout: `roi_img` [B, H, W, 3],
`roi_coord_2d` [B, h, w, 2], and the maps come back NHWC.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

_MODEL_KWARG_KEYS = (
    "roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
    "roi_extents", "resize_ratios",
)


def _model_kwargs(batch: dict) -> dict:
    return {k: batch[k] for k in _MODEL_KWARG_KEYS if k in batch}


def make_predict_step(model: torch.nn.Module, with_maps: bool = False
                      ) -> Callable[[dict], dict]:
    """Returns predict(batch) -> {"rot", "trans"} (plus the mask / coor /
    region maps with `with_maps`), the test-time forward. A model whose
    `compute_dtype` is "bfloat16" (PARALLEL.DTYPE) runs under bf16 autocast;
    the head's out conv, the pose regressors and the decode stay f32."""
    bf16 = model.compute_dtype == "bfloat16"
    model.eval()

    def predict(batch: dict) -> dict:
        device_type = batch["roi_img"].device.type
        ctx = (torch.autocast(device_type, dtype=torch.bfloat16) if bf16
               else contextlib.nullcontext())
        with torch.inference_mode(), ctx:
            out = model(batch["roi_img"], **_model_kwargs(batch))
        keep = {"rot": out["rot"], "trans": out["trans"]}
        if with_maps:
            for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
                keep[k] = out[k]
        return keep

    return predict
