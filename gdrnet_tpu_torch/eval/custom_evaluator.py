"""In-process pose evaluator (counterpart of gdrnet_tpu/eval/custom_evaluator.py).

Predictions accumulate on the host; each object's metrics are computed in a
few batched calls on `device`. Symmetric objects (DATASETS.SYM_OBJS) use the
closest symmetric GT rotation for re and proj, and ADI (through the
nearest-neighbour kernel) against the plain GT rotation for ad.
Undetected GTs registered with `record_missing` count as recall failures
unless `eval_precision`.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from gdrnet_tpu_torch.eval import pose_errors as PE
from gdrnet_tpu_torch.ops.symmetry import get_closest_rot_batch, identity_padded_sym_arrays

RECALL_KEYS = (
    "ad_2", "ad_5", "ad_10",
    "rete_2", "rete_5", "rete_10",
    "re_2", "re_5", "re_10",
    "te_2", "te_5", "te_10",
    "proj_2", "proj_5", "proj_10",
)


class CustomEvaluator:
    def __init__(self, obj_names: list[str], model_points: dict[str, np.ndarray],
                 diameters: dict[str, float], sym_objs: list[str] | None = None,
                 sym_rots: dict[str, np.ndarray] | None = None,
                 with_auc: bool = False, eval_precision: bool = False,
                 device: torch.device | str = "cuda"):
        """model_points: per-object [N,3] points (metres); diameters in
        metres; sym_rots: per-symmetric-object [K,3,3]; device: where the
        errors are computed."""
        self.obj_names = list(obj_names)
        self.model_points = {k: np.asarray(v, np.float32) for k, v in model_points.items()}
        self.diameters = dict(diameters)
        self.sym_objs = list(sym_objs or [])
        self.sym_rots = {k: np.asarray(v, np.float32) for k, v in (sym_rots or {}).items()}
        self.with_auc = with_auc
        self.eval_precision = eval_precision
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._preds = defaultdict(list)
        self._missing = defaultdict(int)

    def record_missing(self, obj_name: str, n: int = 1):
        """Register n GT instances of obj_name with no prediction."""
        self._missing[obj_name] += n

    def process(self, obj_name: str, R_pred, t_pred, R_gt, t_gt, K):
        """Register one prediction/GT pair (camera frame, metres)."""
        self._preds[obj_name].append(
            (np.asarray(R_pred, np.float32), np.asarray(t_pred, np.float32),
             np.asarray(R_gt, np.float32), np.asarray(t_gt, np.float32),
             np.asarray(K, np.float32)))

    def process_batch(self, obj_names, R_pred, t_pred, R_gt, t_gt, K):
        for i, name in enumerate(obj_names):
            self.process(name, R_pred[i], t_pred[i], R_gt[i], t_gt[i], K[i])

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def evaluate(self) -> dict:
        """{obj_name: {metric: value}} plus an 'Avg' entry. Recalls are
        fractions in [0, 1]; mean errors are over matched pairs."""
        results = {}
        for name, items in self._preds.items():
            if name not in self.model_points:
                continue
            R_p, t_p, R_g, t_g, K = (self._tensor(np.stack([it[i] for it in items]))
                                     for i in range(5))
            pts = self._tensor(self.model_points[name])
            B = R_p.shape[0]

            te_err = PE.te_batch(t_p, t_g).cpu().numpy()
            if name in self.sym_objs:
                sym, mask = identity_padded_sym_arrays(self.sym_rots.get(name), B)
                R_g_closest = get_closest_rot_batch(R_p, R_g, self._tensor(sym),
                                                    self._tensor(mask))
                re_err = PE.re_batch(R_p, R_g_closest).cpu().numpy()
                proj_err = PE.proj_batch(R_p, t_p, R_g_closest, t_g, K, pts).cpu().numpy()
                ad_err = PE.adi_batch(R_p, t_p, R_g, t_g, pts).cpu().numpy()
            else:
                re_err = PE.re_batch(R_p, R_g).cpu().numpy()
                proj_err = PE.proj_batch(R_p, t_p, R_g, t_g, K, pts).cpu().numpy()
                ad_err = PE.add_batch(R_p, t_p, R_g, t_g, pts).cpu().numpy()

            d = self.diameters[name]
            row = {
                "ad_2": PE.recall_at(ad_err, 0.02 * d),
                "ad_5": PE.recall_at(ad_err, 0.05 * d),
                "ad_10": PE.recall_at(ad_err, 0.10 * d),
                "rete_2": float(np.mean((re_err < 2) & (te_err < 0.02))),
                "rete_5": float(np.mean((re_err < 5) & (te_err < 0.05))),
                "rete_10": float(np.mean((re_err < 10) & (te_err < 0.1))),
                "re_2": PE.recall_at(re_err, 2), "re_5": PE.recall_at(re_err, 5),
                "re_10": PE.recall_at(re_err, 10),
                "te_2": PE.recall_at(te_err, 0.02), "te_5": PE.recall_at(te_err, 0.05),
                "te_10": PE.recall_at(te_err, 0.1),
                "proj_2": PE.recall_at(proj_err, 2), "proj_5": PE.recall_at(proj_err, 5),
                "proj_10": PE.recall_at(proj_err, 10),
                "mean_re": float(np.mean(re_err)),
                "mean_te": float(np.mean(te_err)),
                "mean_ad": float(np.mean(ad_err)),
                "mean_proj": float(np.mean(proj_err)),
                "count": int(B),
            }
            if self.with_auc:
                row["auc_ad_10"] = PE.vocap_auc(ad_err, max_val=0.1)
            miss = 0 if self.eval_precision else self._missing.get(name, 0)
            if miss:
                scale = B / (B + miss)
                for k in RECALL_KEYS:
                    row[k] *= scale
                if self.with_auc:
                    row["auc_ad_10"] *= scale
                row["count"] = B + miss
                row["n_missing"] = miss
            results[name] = row

        if not self.eval_precision:
            # objects whose every GT went undetected: all-zero recall rows
            for name, miss in self._missing.items():
                if name in results or name not in self.model_points:
                    continue
                row = {k: 0.0 for k in RECALL_KEYS}
                row.update(mean_re=np.nan, mean_te=np.nan, mean_ad=np.nan,
                           mean_proj=np.nan, count=miss, n_missing=miss)
                if self.with_auc:
                    row["auc_ad_10"] = 0.0
                results[name] = row

        if results:
            avg = {}
            keys = [k for k in next(iter(results.values()))
                    if k not in ("count", "n_missing")]
            for k in keys:
                avg[k] = float(np.nanmean([r[k] for r in results.values() if k in r]))
            avg["count"] = int(sum(r["count"] for r in results.values()))
            results["Avg"] = avg
        return results

    def summarize(self, results: dict | None = None) -> str:
        """Plain-text table of the recalls (%) and mean errors, one column an
        object and "Avg" last, as the JAX package prints it with tabulate's
        "plain" format (`plain_table`)."""
        if results is None:
            results = self.evaluate()
        names = [n for n in results if n != "Avg"] + (["Avg"] if "Avg" in results else [])
        keys = ["ad_2", "ad_5", "ad_10", "rete_2", "rete_5", "rete_10",
                "proj_2", "proj_5", "proj_10", "mean_re", "mean_te"]
        rows = [[k] + [f"{100 * results[n][k]:.2f}" if not k.startswith("mean")
                       else f"{results[n][k]:.4f}" for n in names] for k in keys]
        return plain_table(rows, ["objects"] + names)


def _number_kind(s: str):
    """int, float or None: how tabulate reads a cell's string."""
    for kind in (int, float):
        try:
            v = kind(s)
        except ValueError:
            continue
        if kind is float and (math.isinf(v) or math.isnan(v)) and s.lower() not in (
                "inf", "-inf", "nan"):
            return None
        return kind
    return None


def _after_point(s: str) -> int:
    """Digits after the decimal point (or the exponent) of a number, -1 for
    an int or a string: tabulate's _afterpoint."""
    kind = _number_kind(s)
    if kind is not float:
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1 if pos >= 0 else -1


def plain_table(rows: list[list], headers: list) -> str:
    """What tabulate(rows, headers, tablefmt="plain") prints, for string
    and number cells on one line each, without the package (the GPU
    machine has none): a column of numbers is reformatted with "g" (an int
    column as it is) and aligned at the decimal point, any other column is
    left-aligned; each column is at least its header's width plus 2, the
    headers take their column's alignment, cells are joined by two spaces
    and lines stripped on the right."""
    headers = [str(h) for h in headers]
    cols = [list(c) for c in zip(*rows)] if rows else [[] for _ in headers]
    out_cols, aligns = [], []
    for col in cols:
        cells = [str(v) for v in col]
        kinds = {_number_kind(c) for c in cells}
        if not cells:
            kind = str
        elif kinds <= {int}:
            kind = int
        elif None in kinds:
            kind = str
        else:
            kind = float
        if kind is float:
            cells = [format(float(c), "g") for c in cells]
        aligns.append("decimal" if kind in (int, float) else "left")
        out_cols.append(cells)
    widths = []
    for j, (cells, align) in enumerate(zip(out_cols, aligns)):
        minw = len(headers[j]) + 2
        if align == "decimal":
            dec = [_after_point(c) for c in cells]
            most = max(dec, default=-1)
            cells = [c + " " * (most - d) for c, d in zip(cells, dec)]
            width = max([len(c) for c in cells] + [minw])
            cells = [c.rjust(width) for c in cells]
        else:
            cells = [c.strip() for c in cells]
            width = max([len(c) for c in cells] + [minw])
            cells = [c.ljust(width) for c in cells]
        out_cols[j] = cells
        widths.append(width)
    head = [h.rjust(w) if a == "decimal" else h.ljust(w)
            for h, w, a in zip(headers, widths, aligns)]
    lines = ["  ".join(head).rstrip()]
    lines += ["  ".join(r).rstrip() for r in zip(*out_cols)]
    return "\n".join(lines)
