"""BOP estimate<->GT pose matching and 6D-localization scores (a copy of
gdrnet_tpu/eval/pose_matching.py:21-92, plain Python and numpy).

Parity target: lib/pysixd/pose_matching.py:9-91 (greedy score-ordered
matching with per-element error thresholds, unique GT assignment) and
lib/pysixd/score.py:49-150 (calc_recall / calc_localization_scores — recall
over targets per object/scene, Hodan et al. ECCV'18 BOP protocol).

`eval.bop_score.score_results` pairs an (image, object) key's best estimate
with its first GT instance, as the JAX package does (ROADMAP.md section C
weighs that pairing against this module's greedy matching).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def match_poses(errs: list[dict], error_ths, max_ests_count: int = 0,
                gt_valid_mask=None) -> list[dict]:
    """Greedy matching in decreasing estimate-score order
    (pose_matching.py:9-91). errs: [{est_id, score, errors: {gt_id: [e..]}}];
    error_ths: one threshold per error element. Each est matches at most one
    GT and vice versa; an est matches the GT with all error elements lowest
    and below threshold."""
    errs_sorted = sorted(errs, key=lambda e: e["score"], reverse=True)
    if max_ests_count > 0:
        errs_sorted = errs_sorted[:max_ests_count]
    ths = list(error_ths)
    n = len(ths)

    matches, gt_matched = [], set()
    for e in errs_sorted:
        best_gt, best_err = -1, list(ths)
        for gt_id, error in e["errors"].items():
            # `is None` — a numpy bool mask has ambiguous truthiness
            valid = gt_valid_mask is None or gt_valid_mask[gt_id]
            if valid and gt_id not in gt_matched:
                err = list(np.atleast_1d(error))
                if all(err[i] < best_err[i] for i in range(n)):
                    best_gt, best_err = gt_id, err
        if best_gt >= 0:
            gt_matched.add(best_gt)
            matches.append({
                "est_id": e["est_id"], "gt_id": best_gt, "score": e["score"],
                "error": best_err,
                "error_norm": [best_err[i] / float(ths[i]) for i in range(n)],
            })
    return matches


def calc_recall(tp_count: int, targets_count: int) -> float:
    """score.py:49-60."""
    return 0.0 if targets_count == 0 else tp_count / float(targets_count)


def calc_localization_scores(scene_ids, obj_ids, matches: list[dict],
                             n_top: int) -> dict:
    """6D localization recall (score.py:62-150). matches: one row per valid
    GT target with {scene_id, im_id, obj_id, valid, est_id (-1 = missed)}.
    Returns total/per-object/per-scene recalls."""
    insts = {i: {j: defaultdict(int) for j in scene_ids} for i in obj_ids}
    for m in matches:
        if m["valid"]:
            insts[m["obj_id"]][m["scene_id"]][m["im_id"]] += 1

    tars, obj_tars, scene_tars = 0, {i: 0 for i in obj_ids}, {j: 0 for j in scene_ids}
    for obj_id, obj_insts in insts.items():
        for scene_id, scene_insts in obj_insts.items():
            counts = list(scene_insts.values())
            count = int(sum(np.minimum(n_top, counts) if n_top > 0 else counts))
            tars += count
            obj_tars[obj_id] += count
            scene_tars[scene_id] += count

    tps, obj_tps, scene_tps = 0, {i: 0 for i in obj_ids}, {j: 0 for j in scene_ids}
    for m in matches:
        if m["valid"] and m["est_id"] != -1:
            tps += 1
            obj_tps[m["obj_id"]] += 1
            scene_tps[m["scene_id"]] += 1

    return {
        "recall": calc_recall(tps, tars),
        "obj_recalls": {i: calc_recall(obj_tps[i], obj_tars[i])
                        for i in obj_ids},
        "scene_recalls": {j: calc_recall(scene_tps[j], scene_tars[j])
                          for j in scene_ids},
        "gt_count": tars, "targets_count": tars, "tp_count": tps,
    }
