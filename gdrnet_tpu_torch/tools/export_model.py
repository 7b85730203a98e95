"""Export the GDRN serving forward as a torch.export artifact (counterpart of
the repository's tools/export_model.py).

The forward the serving step runs (engine/steps.make_predict_step: eval
mode, bf16 autocast when the config's PARALLEL.DTYPE is bfloat16) goes
through torch.export.export into an ExportedProgram saved with
torch.export.save: the model's graph and weights, and with `--int8` the
calibrated int8 layers (models/quantize.py, TEST.INT8 semantics) with their
scales, calibrated on the export batch. It loads WITHOUT this repository's
Python; `<out>.json` holds the metadata (arg_names, shapes, platforms,
bytes, int8, outputs).

An exported program is specialised to the device it was traced on (its
tensors and kernels are that device's, and the int8 product is the card's
im2col and torch._int_mm or the CPU's float64 convolution), so `--device`
(the card unless `--device cpu`) takes the place of the JAX tool's
`--platforms`; the batch size is fixed at `--batch`.

Usage:
  python -m gdrnet_tpu_torch.tools.export_model --out model.pt2 \\
      [--ckpt <ckpt dir | .pth>] [--config <cfg.py>] [--batch 64] [--fold-bn] [--int8] \\
      [--device cpu]

Load side (only torch needed):
  import torch
  fwd = torch.export.load("model.pt2").module()
  with torch.no_grad():  # the program's weights are parameters
      rot, trans = fwd(roi_img, roi_classes, roi_coord_2d, roi_cams, roi_centers,
                       roi_whs, roi_extents, resize_ratios)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn as nn

from gdrnet_tpu_torch.config import base_config, load_config
from gdrnet_tpu_torch.config.config import Config, merge_dict
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine.checkpoint import load_weights
from gdrnet_tpu_torch.engine.steps import _autocast
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.models.quantize import calibrate_act_scales, quantize_model
from gdrnet_tpu_torch.tools import entry_device
from gdrnet_tpu_torch.utils.fold_bn import fold_batch_norms

ARG_NAMES = ("roi_img", "roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
             "roi_extents", "resize_ratios")
OUTPUTS = ["rot [B,3,3]", "trans [B,3]"]


class ServingForward(nn.Module):
    """The eight serving inputs in ARG_NAMES order -> (rot, trans), as
    make_predict_step computes them."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model.eval()

    def forward(self, roi_img, roi_classes, roi_coord_2d, roi_cams, roi_centers, roi_whs,
                roi_extents, resize_ratios):
        with _autocast(self.model, roi_img.device):
            out = self.model(roi_img, roi_classes=roi_classes, roi_coord_2d=roi_coord_2d,
                             roi_cams=roi_cams, roi_centers=roi_centers, roi_whs=roi_whs,
                             roi_extents=roi_extents, resize_ratios=resize_ratios)
        return out["rot"], out["trans"]


def export_batch(cfg, batch_size: int, device) -> dict:
    """The synthetic batch the artifact is traced (and int8-calibrated) on."""
    net = cfg.MODEL.CDPN
    return {k: torch.from_numpy(v).to(device) for k, v in synthetic_roi_batch(
        batch_size=batch_size, input_res=net.BACKBONE.INPUT_RES,
        out_res=net.BACKBONE.OUTPUT_RES, num_classes=net.ROT_HEAD.NUM_CLASSES).items()}


def serving_forward(model: nn.Module, batch: dict, int8: bool = False) -> ServingForward:
    """The serving forward of `model`; with `int8`, of a quantized copy
    calibrated on `batch`."""
    if int8:
        model = quantize_model(model, calibrate_act_scales(model, [batch]))
    return ServingForward(model)


def build_exported(fwd: ServingForward, batch: dict):
    """The ExportedProgram of `fwd` traced on `batch`, in the ATen dialect:
    run_decompositions with an empty table retraces the pre-dispatch graph,
    whose autocast regions are higher-order ops run under autocast again at
    load time, with autocast applied, so that every bf16 cast is an explicit
    node and the artifact runs the dtypes it was traced with."""
    with torch.no_grad():
        return torch.export.export(fwd, tuple(batch[k] for k in ARG_NAMES)).run_decompositions({})


def export_config(cfg_path: str | None) -> Config:
    cfg = base_config()
    cfg.MODEL.CDPN.PNP_NET.WITH_2D_COORD = True
    cfg.MODEL.CDPN.PNP_NET.REGION_ATTENTION = True
    if cfg_path:
        cfg = Config(merge_dict(cfg.to_dict(), load_config(cfg_path).to_dict()))
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint directory of the port or a reference-layout .pth; "
                        "default: seeded random init (smoke artifacts)")
    p.add_argument("--config", default=None)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--fold-bn", action="store_true",
                   help="fold the BN statistics into the convs before export")
    p.add_argument("--int8", action="store_true",
                   help="bake the int8 serving path into the artifact (TEST.INT8 semantics; "
                        "calibrated on the export batch)")
    p.add_argument("--device", default=None,
                   help="the device the artifact is specialised to: cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Writes the artifact and its metadata, prints the metadata as one JSON
    line and returns it; `device` unless --device names one."""
    args = parse_args(argv)
    device = entry_device("export_model", args.device or device)
    cfg = export_config(args.config)
    model = build_model(cfg, device=device)
    if args.ckpt:
        load_weights(model, args.ckpt)
        print(f"exporting weights from {args.ckpt}", file=sys.stderr)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    if args.fold_bn:
        model = fold_batch_norms(model)
    batch = export_batch(cfg, args.batch, device)
    exported = build_exported(serving_forward(model, batch, int8=args.int8), batch)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(exported, args.out)
    meta = {"arg_names": list(ARG_NAMES), "shapes": {k: list(batch[k].shape) for k in ARG_NAMES},
            "platforms": [device.type], "bytes": os.path.getsize(args.out), "int8": args.int8,
            "outputs": OUTPUTS}
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps({"out": args.out, **meta}), flush=True)
    return meta


if __name__ == "__main__":
    main()
