#!/usr/bin/env python3
"""How far the int8 forward (models/quantize.py) moves the flagship's poses
from its bf16 forward, on seeded random weights and on a trained model.

One JSON line each:
- flagship: GDRN-R34 with `init_weights` at --seeds, one synthetic batch of
  --batch crops a seed: rotation degrees (min, median, max) of int8
  against bf16, of bf16 against f32 and of int8 with f32 activations
  against f32, and the translations' largest relative change;
- with --overfit: the learning check of gdrnet_tpu_torch/tools/
  validate_overfit.py (R18 trained TOTAL steps on its 12 mapped ROIs), then
  int8 and int8 on the folded model against its bf16 forward on those ROIs.

Run from the repository root (the card unless --device cpu):
    python3 scripts/probe_torch_int8_drift.py [--device cpu] [--seeds 0 1] [--overfit]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from gdrnet_tpu_torch.models import quantize as Q  # noqa: E402
from gdrnet_tpu_torch.tools import validate_overfit as overfit_tool  # noqa: E402
from gdrnet_tpu_torch.utils.fold_bn import fold_batch_norms  # noqa: E402


def drift(a: dict, b: dict) -> dict:
    cos = ((a["rot"].float() * b["rot"].float()).sum(dim=(1, 2)) - 1.0) / 2.0
    deg = torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0))).cpu()
    t = b["trans"].double()
    rel = ((a["trans"].double() - t).abs() / t.abs().clamp_min(1e-3)).max().item()
    return {"rot_deg_min": round(float(deg.min()), 4),
            "rot_deg_median": round(float(deg.median()), 4),
            "rot_deg_max": round(float(deg.max()), 4), "trans_rel_max": float(f"{rel:.3e}")}


def int8_of(model, batch) -> dict:
    return cs.make_predict_step(model, int8_scales=Q.calibrate_act_scales(model, [batch]))(batch)


def flagship(device: str, seeds: list[int], batch_size: int) -> None:
    cfg = cs.merged_config(cs.FLAGSHIP)
    cfg32 = cs.merged_config(cs.FLAGSHIP)
    cfg32.PARALLEL.DTYPE = "float32"
    res = cfg.MODEL.CDPN.BACKBONE.INPUT_RES, cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES
    for seed in seeds:
        sd = cs.init_weights(cs.build_model(cfg32, device="cpu"),
                             torch.Generator().manual_seed(seed)).state_dict()
        models = {}
        for name, c in (("bf16", cfg), ("f32", cfg32)):
            models[name] = cs.build_model(c, device=device)
            models[name].load_state_dict(sd)
        batch = cs.to_device(cs.synthetic_roi_batch(
            batch_size=batch_size, input_res=res[0], out_res=res[1],
            num_classes=cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES, seed=seed), device)
        out = {name: cs.make_predict_step(m)(batch) for name, m in models.items()}
        print(json.dumps({"case": "flagship_init_weights", "seed": seed, "crops": batch_size,
                          "device": device,
                          "int8_vs_bf16": drift(int8_of(models["bf16"], batch), out["bf16"]),
                          "bf16_vs_f32": drift(out["bf16"], out["f32"]),
                          "int8_f32_vs_f32": drift(int8_of(models["f32"], batch), out["f32"])}),
              flush=True)


def overfit(device: str, seed: int) -> None:
    c = overfit_tool.overfit_cfg()
    with tempfile.TemporaryDirectory() as root:
        meta = overfit_tool.overfit_split(str(Path(root) / "overfit"), device=device)
        split = overfit_tool.map_split(c, meta, device)
        run = overfit_tool.run_seed(c, split, seed, str(Path(root) / "out"), device,
                                    echo=lambda line: None)
    trained, batch = run["model"].eval(), run["batch"]
    ref = cs.make_predict_step(trained)(batch)
    print(json.dumps({"case": "overfit_trained_r18", "seed": seed, "crops": len(split[0]),
                      "device": device, "steps": overfit_tool.TOTAL,
                      "int8_vs_bf16": drift(int8_of(trained, batch), ref),
                      "int8_folded_vs_bf16": drift(int8_of(fold_batch_norms(trained), batch),
                                                   ref)}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--overfit", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_torch_int8_drift: no CUDA card; pass --device cpu")
    flagship(args.device, args.seeds, args.batch)
    if args.overfit:
        overfit(args.device, args.seeds[-1])


if __name__ == "__main__":
    main()
