#!/usr/bin/env python3
"""The learning check of chip_smoke.py ([overfit]) under two weight inits, on
one NVIDIA GPU: the port's init_weights (the JAX package's per-layer rules)
and plain He-normal convs with 1/sqrt(fan_in) linears everywhere.

For each dataset and init and seed: gdrnet_tpu_torch/tools/validate_overfit's
map_split and run_seed (every record mapped once by GDRNTrainMapper, TOTAL
train steps on that batch with its config, then engine/tester.do_test on the
same records with GT boxes). One
JSON line each: the first and last total loss, the region CE and the other
terms, the train seconds, and do_test's mean rotation error (degrees), mean
translation error (cm) and ad_10 per object.

Datasets: the tool's 2-object split (overfit_split), and
with --fixture DIR a tests/fixture_bop.py dataset (shaded objects on noise)
written beforehand where cv2 and JAX are installed, e.g.
    python -c "import sys; sys.path.insert(0, 'tests'); \\
        from fixture_bop import build_fixture_dataset; \\
        build_fixture_dataset('build/fixture42', n_images=6, seed=42)"

Run from the repository root:
    python3 scripts/probe_torch_overfit.py [--fixture build/fixture42] [--seeds 0 1 2]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from gdrnet_tpu_torch.data.ref_meta import DatasetMeta  # noqa: E402
from gdrnet_tpu_torch.tools import validate_overfit as overfit_tool  # noqa: E402


def he_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """He-normal convs and transposed convs, 1/sqrt(fan_in) linears, zero
    biases, identity norms."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel() if not isinstance(m, nn.ConvTranspose2d) \
                    else w.shape[0] * w[0, 0].numel()
                std = ((1.0 if isinstance(m, nn.Linear) else 2.0) / fan_in) ** 0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
    return model


def fixture_meta(root: Path) -> DatasetMeta:
    """tests/fixture_bop.py's DatasetMeta (it writes no meta.json)."""
    info = json.loads((root / "models" / "models_info.json").read_text())
    K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
    return DatasetMeta(name="fixture", objects=["cube", "brick"], id2obj={1: "cube", 2: "brick"},
                       diameters_by_name={"cube": info["1"]["diameter"] / 1000.0,
                                          "brick": info["2"]["diameter"] / 1000.0},
                       camera_matrix=K, width=320, height=240, data_root=str(root),
                       sym_objects=["brick"])


def run(label: str, meta, inits: dict, seeds, out: Path) -> None:
    c = overfit_tool.overfit_cfg()
    split = overfit_tool.map_split(c, meta, "cuda")
    for init_name, init in inits.items():
        for seed in seeds:
            r = overfit_tool.run_seed(c, split, seed, str(out / f"{label}_{init_name}_{seed}"),
                                      "cuda", echo=lambda line: None, init=init)
            total, region, res = r["history"]["total_loss"], r["history"]["loss_region"], r["results"]
            print("[probe_overfit] " + json.dumps({
                "data": label, "init": init_name, "seed": seed, "train_s": round(r["train_s"], 1),
                "total_first": round(float(total[0]), 4), "total_last": round(float(total[-1]), 4),
                "region_first": round(float(region[0]), 4), "region_last": round(float(region[-1]), 4),
                "others_first": round(float(total[0] - region[0]), 4),
                "others_last": round(float(total[-1] - region[-1]), 4),
                "do_test_re_deg_te_cm_ad10": {
                    n: [round(res[n]["mean_re"], 3), round(100 * res[n]["mean_te"], 3),
                        round(res[n]["ad_10"], 4)] for n in ("cube", "brick", "Avg")}}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fixture", default="", help="a tests/fixture_bop.py dataset directory")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_overfit: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cs.phase_build()
    inits = {"port": cs.init_weights, "he": he_init}
    with tempfile.TemporaryDirectory() as root:
        out = Path(root)
        run("smoke_split", overfit_tool.overfit_split(str(out / "split"), device="cuda"), inits,
            args.seeds, out)
        if args.fixture:
            run("fixture", fixture_meta(Path(args.fixture).resolve()), inits, args.seeds, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
