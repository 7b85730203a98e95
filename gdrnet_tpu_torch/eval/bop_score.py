"""BOP score computation over saved results (counterpart of
gdrnet_tpu/eval/bop_score.py; the pose errors run as tensors on `device`) —
in-process replacement for the reference's two-level subprocess fan-out
(lib/pysixd/scripts/eval_pose_results_more.py:200-310 dispatching
eval_calc_errors.py + eval_calc_scores.py per error type/threshold).

Supported error types (error matrix, eval_pose_results_more.py:41-94):
  ad / add / adi            recall at 0.02/0.05/0.10 x diameter
  AUCad / AUCadd / AUCadi   mean recall over thresholds 1..10 cm (:79-83)
  ABSad / ABSadd / ABSadi   recall at the absolute 2 cm threshold (:73-77)
  re / te / rete / proj     recall at (2,5,10) deg / cm / px (not sym-aware)
  reS / teS / reteS / projS sym-aware variants (min over the symmetry set)
  mssd / mspd               BOP19 recalls averaged over their threshold grids
  vsd                       BOP19 recall over the tau x threshold grid; needs
                            test depth (records with depth_path) + mesh faces
                            — renders est/gt depth via eval/vsd.py (on a
                            CUDA device through the z-buffer kernel)

`validate_error_types` rejects unknown names up front so a bad
VAL.ERROR_TYPES fails before inference, not after.

`score_results` matches estimates to GT by (scene_id, im_id, obj_id) with
n_top semantics (N_TOP=1: highest-score estimate per GT object); keys with
several instances of one object assign greedily by translation error in
estimate-score order (pose_matching.py protocol).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from gdrnet_tpu_torch.data.io import load_depth
from gdrnet_tpu_torch.eval import pose_errors as PE
from gdrnet_tpu_torch.eval.vsd import vsd_pairs
from gdrnet_tpu_torch.ops.symmetry import identity_padded_sym_arrays

BOP19_MSSD_THRESHOLDS = np.arange(0.05, 0.51, 0.05)  # x diameter
BOP19_MSPD_THRESHOLDS = np.arange(5, 51, 5)  # x r=w/640 px
BOP19_VSD_TAUS = np.arange(0.05, 0.51, 0.05)
BOP19_VSD_THRESHOLDS = np.arange(0.05, 0.51, 0.05)
# per-dataset visibility tolerance, mm (eval_pose_results_more.py vsd_deltas)
VSD_DELTAS_MM = {"itodd": 5.0}
VSD_DELTA_MM_DEFAULT = 15.0

SUPPORTED_ERROR_TYPES = frozenset(
    ["ad", "add", "adi", "AUCad", "AUCadd", "AUCadi", "ABSad", "ABSadd",
     "ABSadi", "re", "te", "rete", "proj", "reS", "teS", "reteS", "projS",
     "mssd", "mspd", "vsd"])


def validate_error_types(error_types: str) -> list:
    """Parse + validate an ERROR_TYPES string; raises before any compute so
    a typo'd VAL.ERROR_TYPES fails fast, not after a full inference run."""
    types = [t.strip() for t in error_types.split(",") if t.strip()]
    unknown = [t for t in types if t not in SUPPORTED_ERROR_TYPES]
    if unknown:
        raise ValueError(f"unsupported error types {unknown}; supported: "
                         f"{sorted(SUPPORTED_ERROR_TYPES)}")
    return types


def _vsd_errors_by_obj(pairs, models, delta_mm: float, taus,
                       batch: int = 64, device="cuda") -> dict:
    """Per-object lists of [T] vsd error arrays over the matched pairs
    (missing estimates -> all-ones, i.e. fail every threshold). Est + gt
    depths render through the BATCHED windowed rasterizer ladder and the
    error program runs over all pairs of a batch at once (eval/vsd.vsd_pairs)
    — the reference computes each pair sequentially through external C++/GL
    renderers (lib/pysixd/pose_error.py:22-129, eval_calc_errors.py)."""
    id2obj = models.meta.id2obj
    taus = np.asarray(taus, np.float32)
    # group estimate-bearing pairs per object, keeping slot order
    out = defaultdict(list)
    todo: dict = defaultdict(list)  # name -> [(slot, est, gt)]
    for est, gt in pairs:
        name = id2obj[gt["obj_id"]]
        slot = len(out[name])
        if est is None:
            out[name].append(np.ones(len(taus), np.float32))
            continue
        if gt.get("depth_path") is None:
            raise ValueError(
                "vsd requested but the GT record has no depth_path -- the "
                "test split has no depth/ images (vsd needs d_test)")
        if models.faces.get(name) is None:
            raise ValueError(f"vsd needs mesh faces for {name!r}; the model "
                             "PLY is a point cloud")
        out[name].append(None)
        todo[name].append((slot, est, gt))

    depth_cache: dict = {}  # FIFO-capped

    def d_test_of(gt):
        key = (gt["scene_id"], gt["im_id"])
        if key not in depth_cache:
            if len(depth_cache) >= 16:
                depth_cache.pop(next(iter(depth_cache)))
            depth_cache[key] = load_depth(gt["depth_path"],
                                          gt.get("depth_scale", 1.0))
        return depth_cache[key]

    for name, items in todo.items():
        verts = models.full_points[name]
        faces = models.faces[name]
        dia = models.diameters[name]
        for s in range(0, len(items), batch):
            chunk = items[s:s + batch]
            errs = vsd_pairs(
                np.stack([np.asarray(e["R"], np.float32)
                          for _, e, _ in chunk]),
                np.stack([np.asarray(e["t"], np.float32) / 1000.0
                          for _, e, _ in chunk]),
                np.stack([g["R"] for _, _, g in chunk]),
                np.stack([g["t"] for _, _, g in chunk]),
                np.stack([d_test_of(g) for _, _, g in chunk]),
                np.stack([g["K"] for _, _, g in chunk]),
                verts, faces, delta=delta_mm / 1000.0, taus=taus,
                diameter=dia, device=device)
            for (slot, _, _), e in zip(chunk, errs):
                out[name][slot] = np.asarray(e, np.float32)
    return out


def match_estimates_to_gt(results: list[dict], gts: list[dict],
                          n_top: int = 1, precision: bool = False
                          ) -> list[tuple[dict, dict]]:
    """results: BOP rows (R, t in mm); gts: records with R, t (m), K.

    recall mode (default): one pair per GT (missing estimate -> (None, gt)).
    precision mode (reference _eval_predictions_precision,
    gdrn_custom_evaluator.py:672): one pair per ESTIMATE — every prediction
    is judged against its image's GT of the same object; extra predictions
    without GT are dropped (they have no pose to compare against)."""
    gt_by_key = defaultdict(list)
    for g in gts:
        gt_by_key[(g["scene_id"], g["im_id"], g["obj_id"])].append(g)
    est_by_key = defaultdict(list)
    for r in results:
        est_by_key[(r["scene_id"], r["im_id"], r["obj_id"])].append(r)
    pairs = []
    if precision:
        for key, ests in est_by_key.items():
            gt_list = gt_by_key.get(key, [])
            if not gt_list:
                continue
            for est in sorted(ests, key=lambda e: -e.get("score", 1.0)):
                pairs.append((est, gt_list[0]))
        return pairs
    for key, gt_list in gt_by_key.items():
        ests = sorted(est_by_key.get(key, []), key=lambda e: -e.get("score", 1.0))
        take = len(gt_list) if n_top <= 0 else min(n_top, len(gt_list))
        targets = list(gt_list[:take])
        if len(targets) > 1:
            # multi-instance key: greedy assignment in estimate-score order,
            # each estimate claiming the unmatched GT with the lowest
            # translation error (the BOP toolkit matches greedily by the
            # error value, pose_matching.py:9-91; zip order would pair
            # instances arbitrarily)
            unmatched = list(range(len(targets)))
            for est in ests[:take]:
                if not unmatched:
                    break
                t_est = np.asarray(est["t"], np.float64) / 1000.0
                j = min(unmatched, key=lambda i: float(np.linalg.norm(
                    t_est - np.asarray(targets[i]["t"], np.float64))))
                unmatched.remove(j)
                pairs.append((est, targets[j]))
            for i in unmatched:
                pairs.append((None, targets[i]))
            continue
        for gt, est in zip(targets, ests[:take]):
            pairs.append((est, gt))
        # unmatched gts count as failures via the caller's recall denominators
        for gt in targets[len(ests):]:
            pairs.append((None, gt))
    return pairs


def _stack_pairs(pairs, id2obj):
    by_obj = defaultdict(lambda: {"Re": [], "te_": [], "Rg": [], "tg": [],
                                  "K": [], "miss": 0})
    for est, gt in pairs:
        name = id2obj[gt["obj_id"]]
        if est is None:
            by_obj[name]["miss"] += 1
            continue
        by_obj[name]["Re"].append(np.asarray(est["R"], np.float32))
        by_obj[name]["te_"].append(np.asarray(est["t"], np.float32) / 1000.0)
        by_obj[name]["Rg"].append(gt["R"])
        by_obj[name]["tg"].append(gt["t"])
        by_obj[name]["K"].append(gt["K"])
    return by_obj


def score_results(results: list[dict], gts: list[dict], models,
                  error_types: str = "ad,rete,re,te,proj",
                  sym_objs: list[str] | None = None, n_top: int = 1,
                  image_width: int = 640, precision: bool = False,
                  device="cuda") -> dict:
    """models: ObjectModels (points/diameters/sym_rots). Returns
    {error_type: {obj: recall(s)} + {"avg": ...}}. precision=True reproduces
    the reference's VAL.EVAL_PRECISION mode (per-estimate denominators).
    device: where the errors are computed (ADD-S and the VSD renders go
    through the CUDA kernels on a CUDA device).

    Error arrays are computed once per (object, base error kind) and shared
    across the requested types (e.g. ad/AUCad/ABSad reuse one ADD pass)."""
    id2obj = models.meta.id2obj
    sym_objs = sym_objs if sym_objs is not None else models.meta.sym_objects
    pairs = match_estimates_to_gt(results, gts, n_top, precision=precision)
    by_obj = _stack_pairs(pairs, id2obj)
    types = validate_error_types(error_types)
    out: dict = {t: {} for t in types}
    vsd_by_obj = None
    if "vsd" in types:
        delta_mm = VSD_DELTAS_MM.get(models.meta.name.split("_")[0],
                                     VSD_DELTA_MM_DEFAULT)
        vsd_by_obj = _vsd_errors_by_obj(pairs, models, delta_mm,
                                        BOP19_VSD_TAUS, device=device)

    for name, d in by_obj.items():
        n_total = len(d["Rg"]) + d["miss"]
        if len(d["Rg"]) == 0:
            for t in types:
                out[t][name] = 0.0
            continue
        Re = np.stack(d["Re"]); te_ = np.stack(d["te_"])
        Rg = np.stack(d["Rg"]); tg = np.stack(d["tg"])
        K = np.stack(d["K"])
        pts = models.points[name]
        dia = models.diameters[name]
        B = len(Re)
        is_sym = name in sym_objs
        cache: dict = {}

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def on_host(e: torch.Tensor) -> np.ndarray:
            return e.cpu().numpy()

        Re_d, te_d, Rg_d, tg_d, K_d, pts_d = (dev(a) for a in (Re, te_, Rg, tg, K, pts))

        def sym_rotated_gts(sym_aware: bool):
            """[S,B,3,3] gt rotations over the (identity-padded) sym set.
            Plain types are NOT sym-aware; the S variants take the min over
            the symmetry set per error independently (reference
            eval_calc_errors.py:408-450, pose_error.re_sym/te_sym/
            arp_2d_sym:184-234 — min over syms, not closest-by-angle). The
            model store keeps rotational syms only (sym t == 0 for the
            lm/lmo/ycbv discrete symmetries), so teS == te."""
            srots = models.sym_rots.get(name) if (sym_aware and is_sym) else None
            if srots is not None:
                sym_set = np.concatenate(
                    [np.eye(3, dtype=np.float32)[None], srots], axis=0)
            else:
                sym_set = np.eye(3, dtype=np.float32)[None]
            return np.einsum("bij,sjk->sbik", Rg, sym_set)

        def err_of(kind: str) -> np.ndarray:
            if kind in cache:
                return cache[kind]
            if kind == "add":
                e = on_host(PE.add_batch(Re_d, te_d, Rg_d, tg_d, pts_d))
            elif kind == "adi":
                e = on_host(PE.adi_batch(Re_d, te_d, Rg_d, tg_d, pts_d))
            elif kind == "ad":
                e = err_of("adi") if is_sym else err_of("add")
            elif kind in ("te", "teS"):
                e = on_host(PE.te_batch(te_d, tg_d))
            elif kind in ("re", "reS"):
                Rg_syms = sym_rotated_gts(kind == "reS")
                e = np.min(np.stack(
                    [on_host(PE.re_batch(Re_d, dev(Rg_syms[i])))
                     for i in range(len(Rg_syms))]), axis=0)
            elif kind in ("proj", "projS"):
                Rg_syms = sym_rotated_gts(kind == "projS")
                e = np.min(np.stack(
                    [on_host(PE.proj_batch(Re_d, te_d, dev(Rg_syms[i]), tg_d, K_d, pts_d))
                     for i in range(len(Rg_syms))]), axis=0)
            elif kind == "mssd":
                sym, mask = identity_padded_sym_arrays(
                    models.sym_rots.get(name), B)
                e = on_host(PE.mssd_batch(Re_d, te_d, Rg_d, tg_d, pts_d, dev(sym), dev(mask)))
            elif kind == "mspd":
                sym, mask = identity_padded_sym_arrays(
                    models.sym_rots.get(name), B)
                e = on_host(PE.mspd_batch(Re_d, te_d, Rg_d, tg_d, K_d, pts_d, dev(sym),
                                          dev(mask)))
            else:
                raise ValueError(kind)
            cache[kind] = e
            return e

        def recalls(err, thrs):
            return [float(np.sum(err < thr)) / n_total for thr in thrs]

        for etype in types:
            if etype.startswith("AUC"):
                # reference AUC = mean recall over 10 thresholds 1..10 cm
                # (eval_pose_results_more.py:79-83 linspace(1, 10, 10) cm)
                err = err_of(etype[3:])
                out[etype][name] = float(np.mean(
                    recalls(err, np.linspace(0.01, 0.10, 10))))
            elif etype.startswith("ABS"):
                # reference ABS = recall at one absolute 2 cm threshold
                # (eval_pose_results_more.py:73-77 correct_th [[2]] cm)
                out[etype][name] = recalls(err_of(etype[3:]), (0.02,))[0]
            elif etype in ("ad", "add", "adi"):
                out[etype][name] = recalls(
                    err_of(etype), (0.02 * dia, 0.05 * dia, 0.10 * dia))
            elif etype in ("re", "reS"):
                out[etype][name] = recalls(err_of(etype), (2, 5, 10))
            elif etype in ("te", "teS"):
                out[etype][name] = recalls(err_of(etype), (0.02, 0.05, 0.10))
            elif etype in ("proj", "projS"):
                out[etype][name] = recalls(err_of(etype), (2, 5, 10))
            elif etype in ("rete", "reteS"):
                # joint thresholds on independently (sym-)min'd errors
                S = "S" if etype.endswith("S") else ""
                r_err, t_err = err_of("re" + S), err_of("te" + S)
                out[etype][name] = [
                    float(np.sum((r_err < a) & (t_err < b))) / n_total
                    for a, b in ((2, 0.02), (5, 0.05), (10, 0.10))]
            elif etype == "mssd":
                out[etype][name] = float(np.mean(recalls(
                    err_of("mssd"), BOP19_MSSD_THRESHOLDS * dia)))
            elif etype == "mspd":
                r = image_width / 640.0
                out[etype][name] = float(np.mean(recalls(
                    err_of("mspd"), BOP19_MSPD_THRESHOLDS * r)))
            elif etype == "vsd":
                # AR_vsd = mean recall over the tau x threshold grid
                # (BOP19: taus 0.05..0.5, correct_th 0.05..0.5,
                # eval_pose_results_more.py:44-61). vsd errors include the
                # all-ones rows of missing estimates, so divide by rows.
                errs = np.stack(vsd_by_obj[name])  # [n_total, T]
                out[etype][name] = float(np.mean(
                    [np.mean(errs[:, i] < th)
                     for i in range(errs.shape[1])
                     for th in BOP19_VSD_THRESHOLDS]))

    for t in types:
        per_obj = out[t]
        vals = [np.mean(v) if isinstance(v, list) else v for v in per_obj.values()]
        per_obj["avg"] = float(np.mean(vals)) if vals else 0.0
    return out


def bop19_average_recall(scores: dict) -> float:
    """AR = mean(AR_vsd, AR_mssd, AR_mspd) when present, else mean of
    whatever recall averages exist (eval_pose_results_more.py:289-310)."""
    keys = [k for k in ("vsd", "mssd", "mspd") if k in scores]
    if not keys:
        keys = list(scores)
    return float(np.mean([scores[k]["avg"] for k in keys]))
