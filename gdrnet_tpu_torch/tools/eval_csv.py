"""Re-score a saved BOP result CSV without re-running the model (counterpart
of tools/eval_csv.py:23-72; the reference's VAL.EVAL_CACHED / SCORE_ONLY
path, core/gdrn_modeling/test_utils.py:78-135).

eval/bop_score.score_results scores the CSV's poses against the split's GT
on `--device`, the card unless `--device cpu`: ADD-S of the symmetric
objects through the nearest-neighbour kernel (B1), VSD's depth renders
through the z-buffer kernel (B2). It prints the per-object recall table as
tabulate's "plain" format prints it (eval/custom_evaluator.plain_table) and
the BOP19 average recall; --out writes the scores as JSON, --latex a LaTeX
report (eval/report.py).

Usage:
  python -m gdrnet_tpu_torch.tools.eval_csv --csv output/.../lm-test_gdrnet-tpu.csv \
      --dataset lm --split test --error-types ad,rete,re,te,proj [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

import numpy as np
import torch

from gdrnet_tpu_torch.data import ref_meta
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.eval.bop_score import bop19_average_recall, score_results
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import plain_table
from gdrnet_tpu_torch.eval.report import write_latex_report
from gdrnet_tpu_torch.tools import entry_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--csv", required=True)
    p.add_argument("--dataset", required=True,
                   help="a directory <data-root>/<name> with meta.json, or lm / lmo / ycbv")
    p.add_argument("--split", default="test")
    p.add_argument("--data-root", default="datasets/BOP_DATASETS")
    p.add_argument("--error-types", default="ad,rete,re,te,proj")
    p.add_argument("--n-top", type=int, default=1)
    p.add_argument("--out", default=None, help="write scores json here")
    p.add_argument("--latex", default=None, help="write a latex report here")
    p.add_argument("--device", default=None,
                   help="where the errors are computed: cuda (the default) or cpu")
    return p.parse_args(argv)


def score_table(scores: dict) -> str:
    """The per-object recall table (%) of score_results' output."""
    objs = sorted({o for s in scores.values() for o in s if o != "avg"})
    rows = []
    for etype, per_obj in scores.items():
        row = [etype]
        for o in objs + ["avg"]:
            v = per_obj.get(o, "-")
            row.append(f"{100 * np.mean(v):.2f}" if v != "-" else "-")
        rows.append(row)
    return plain_table(rows, ["error"] + objs + ["avg"])


def main(argv=None, device="cuda") -> dict:
    """Prints the table and returns the scores; `device` unless --device names one."""
    args = parse_args(argv)
    device = entry_device("eval_csv", args.device or device)
    meta = ref_meta.meta_by_name(args.dataset, args.data_root)
    gts = load_bop_scene_dicts(meta, args.split, with_masks=False, with_xyz=False)
    models = ObjectModels(meta)
    results = load_bop_results(args.csv)
    scores = score_results(results, gts, models, args.error_types, n_top=args.n_top,
                           image_width=meta.width, device=device)

    print(score_table(scores))
    print(f"bop-style average recall: {100 * bop19_average_recall(scores):.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: {o: (list(v) if isinstance(v, list) else v) for o, v in per.items()}
                       for k, per in scores.items()}, f, indent=2)
        print(f"saved {args.out}")
    if args.latex:
        write_latex_report(args.latex, scores, title=osp.basename(args.csv))
        print(f"saved {args.latex}")
    return scores


if __name__ == "__main__":
    main()
