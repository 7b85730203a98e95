"""Test-time orchestration: inference over padded ROI buckets, then evaluation
(counterpart of gdrnet_tpu/engine/tester.py:25-339).

The reference's do_test / gdrn_inference_on_dataset
(core/gdrn_modeling/engine.py:121-142, gdrn_evaluator.py:516-631): every
(image, detection) pair of the test split goes into one flat stream that
fills each bucket of TEST.ROI_BATCH_SIZE rows, so that every forward runs at
one batch size; a producer thread maps bucket i+1 on the host
(data/mapper.GDRNTestMapper) while the card runs bucket i; the pose is
decoded on the device and comes back to the host, where estimates are
matched to GT per (image, object) and fed to the in-process CustomEvaluator,
a BOP19 CSV and, with VAL.USE_BOP, eval/bop_score. Timing is split compute
vs process with the first bucket left out (:545-624).

Where the port differs from the JAX package: the model is an nn.Module that
holds its weights (no separate `variables`). Under a process group each
rank tests a contiguous shard of the (image, object) groups on its own card
and the shards' predictions are gathered to every rank before scoring
(parallel/multihost.all_gather_objects, as gdrnet_tpu/engine/tester.py:
163-168,291-301); the CSV and BOP scoring run on the main process.
TEST.LOCAL_DEVICES splits each bucket over replicas of the model on this
process's cards (parallel/mesh.local_dp_setup; -1, the default, takes every
visible card of a single process, and a rank's own card under a process
group). A model sharded on a model axis (parallel/tensor_parallel.py, the
model do_train leaves with PARALLEL.MODEL_PARALLEL) tests as a gathered
replica on every rank, as JAX's do_test runs replicated parameters on a
1-D mesh (gdrnet_tpu/engine/tester.py:106-112). TEST.USE_PNP refines each bucket's net poses from
its decoded maps (engine/pnp_refine.py: TEST.PNP_TYPE's mode, on the device
with TEST.DEVICE_PNP, else the per-ROI host loop) inside the compute
window, as JAX does (gdrnet_tpu/engine/tester.py:229-236). TEST.FOLD_BN folds the BN
statistics into a copy of the model before the first bucket
(utils/fold_bn.py); TEST.INT8 calibrates on the first mapped bucket and
serves a quantized copy (models/quantize.py); the two compose, as in JAX
(gdrnet_tpu/engine/tester.py:95-102,113,219-225).
TEST.DEVICE_PREPROCESS maps each bucket with data/mapper.GDRNDeviceTestMapper,
as JAX's do_test does (gdrnet_tpu/engine/tester.py:90-93): the producer
thread decodes each image once and warps the crops on the card, where
`roi_img` stays for the forward.
"""

from __future__ import annotations

import os.path as osp
import queue
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from gdrnet_tpu_torch.data.bop import load_detections
from gdrnet_tpu_torch.data.mapper import GDRNDeviceTestMapper, GDRNTestMapper
from gdrnet_tpu_torch.engine.pnp_refine import refine_bucket_poses
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.eval.bop_score import (
    bop19_average_recall,
    score_results,
    validate_error_types,
)
from gdrnet_tpu_torch.eval.bop_writer import save_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import CustomEvaluator
from gdrnet_tpu_torch.models.quantize import calibrate_act_scales
from gdrnet_tpu_torch.parallel import local_dp_setup, split_predict
from gdrnet_tpu_torch.parallel.tensor_parallel import full_replica
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.utils.fold_bn import fold_batch_norms

# the batch keys the forward reads; the rest of a mapped bucket stays on the host
_DEVICE_KEYS = ("roi_img", "roi_classes", "roi_coord_2d", "roi_cams", "roi_centers",
                "roi_whs", "roi_extents", "resize_ratios")


def build_test_items(records: list[dict], detections: dict | None = None,
                     bbox_type: str = "gt") -> list:
    """Group per-instance records into per-image (rgb_path, K, rois, gts),
    in the order of the sorted (scene_id, im_id) keys.

    bbox_type "gt": ROI boxes from GT annotations (TEST.TEST_BBOX_TYPE=gt,
    bbox_visib as xyxy); "est": boxes from a detections dict
    (load_detections output, bbox_est or bbox as xywh)."""
    by_img: dict = defaultdict(list)
    for r in records:
        by_img[(r["scene_id"], r["im_id"])].append(r)
    items = []
    for key, recs in sorted(by_img.items()):
        r0 = recs[0]
        if bbox_type == "gt" or detections is None:
            rois = []
            for r in recs:
                x, y, w, h = r["bbox_visib"]
                rois.append({"obj_id": r["obj_id"],
                             "bbox": [x, y, x + w, y + h], "score": 1.0})
        else:
            rois = [dict(d, bbox=d.get("bbox_est", d.get("bbox")), bbox_mode="xywh")
                    for d in detections.get(key, [])]
        if rois:
            items.append((r0["rgb_path"], r0["K"], rois,
                          {"scene_id": key[0], "im_id": key[1], "gts": recs}))
    return items


def _to_device(batch: dict, device: torch.device) -> dict:
    """The forward's inputs of a mapped bucket on `device`, from pinned host
    memory without blocking the host on a CUDA device; a tensor the mapper
    made on the device (GDRNDeviceTestMapper's roi_img) stays as it is."""
    def put(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if device.type != "cuda":
            return torch.from_numpy(v).to(device)
        return torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
    return {k: put(batch[k]) for k in _DEVICE_KEYS}


def bucket_predictor(cfg, model: torch.nn.Module, bucket: int, with_maps: bool = False):
    """predict(dev_batch) for buckets of `bucket` rows, as do_test and
    predict serve them: TEST.FOLD_BN folds the BN statistics into a copy of
    the model first; TEST.LOCAL_DEVICES splits each bucket over replicas of
    it (parallel/mesh.py); TEST.INT8 calibrates the activation scales on the
    first bucket (on the whole bucket, with the first replica) and serves
    every replica quantized with them, as JAX does
    (gdrnet_tpu/engine/tester.py:95-112,219-225)."""
    if cfg.TEST.get("FOLD_BN"):  # inference only; a folded model quantizes too
        model = fold_batch_norms(model)
    devices, replicas = local_dp_setup(model, bucket, cfg.TEST.get("LOCAL_DEVICES", -1))
    int8 = bool(cfg.TEST.get("INT8"))
    predicts = [make_predict_step(r, with_maps=with_maps) for r in replicas]

    def predict(dev_batch: dict) -> dict:
        nonlocal predicts, int8
        if int8:
            scales = calibrate_act_scales(replicas[0], [dev_batch])
            predicts = [make_predict_step(r, with_maps=with_maps, int8_scales=scales)
                        for r in replicas]
            int8 = False
        return predicts[0](dev_batch) if devices is None else split_predict(
            predicts, devices)(dev_batch)

    return predict


def _check_device(model: torch.nn.Module, device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("do_test: device is cuda, but no CUDA card is available; "
                           "pass device='cpu' to test on the CPU")
    on = next(model.parameters()).device
    if on.type != device.type or (device.index is not None and on != device):
        raise ValueError(f"do_test: the model is on {on}, the test runs on {device}")


def do_test(cfg, model: torch.nn.Module, models, records: list[dict],
            output_dir: str | None = None, data_root: str = "datasets/BOP_DATASETS",
            save_csv: bool = True, shard: int | None = None, num_shards: int | None = None,
            device="cuda") -> dict:
    """Run inference over `records` (one test split) with `model` (on
    `device`, holding its weights), then the in-process evaluation. Returns
    the evaluator's results dict plus `_summary`, `_time` (after the first
    bucket), `_csv_path` (with output_dir and save_csv) and, with
    VAL.USE_BOP, `_bop` and `_bop_average_recall` (the last three on the main
    process). shard / num_shards (default: the rank and the world size)
    pick a contiguous shard of the (image, object) groups; the shards'
    predictions are gathered over the process group before scoring. Called
    in one process with num_shards > 1, it scores its shard alone, as JAX's
    does. data_root is accepted for the JAX package's signature; records
    already hold their paths. A sharded model is gathered first (a
    collective: every model peer calls do_test)."""
    del data_root
    model = full_replica(model)
    shard = mh.get_rank() if shard is None else shard
    num_shards = mh.get_world_size() if num_shards is None else num_shards
    device = torch.device(device)
    _check_device(model, device)
    detections = None
    # reference gating: detections load iff MODEL.LOAD_DETS_TEST (engine.py
    # evaluator setup + dataset_utils.load_detections_into_dataset); the
    # boxes are then used when TEST.TEST_BBOX_TYPE == "est"
    if (cfg.DATASETS.DET_FILES_TEST and cfg.TEST.TEST_BBOX_TYPE == "est"
            and cfg.MODEL.get("LOAD_DETS_TEST", False)):
        detections = load_detections(
            cfg.DATASETS.DET_FILES_TEST[0], score_thr=cfg.DATASETS.DET_THR,
            topk_per_obj=cfg.DATASETS.DET_TOPK_PER_OBJ)
    items = build_test_items(records, detections, cfg.TEST.TEST_BBOX_TYPE)

    if cfg.VAL.get("USE_BOP"):
        # fail fast on a bad VAL.ERROR_TYPES, not after full inference
        types = validate_error_types(cfg.VAL.ERROR_TYPES)
        if "vsd" in types and not any("depth_path" in r for r in records):
            raise ValueError(
                "VAL.ERROR_TYPES includes vsd but no test record has a "
                "depth_path — the split has no depth/ images (vsd needs "
                "d_test); failing before inference")

    bucket = cfg.TEST.ROI_BATCH_SIZE
    mapper = (GDRNDeviceTestMapper(cfg, models, roi_batch_size=bucket, device=device)
              if cfg.TEST.get("DEVICE_PREPROCESS")
              else GDRNTestMapper(cfg, models, roi_batch_size=bucket))
    use_pnp = bool(cfg.TEST.USE_PNP)
    predict = bucket_predictor(cfg, model, bucket, with_maps=use_pnp)
    evaluator = CustomEvaluator(
        models.objs, models.points, models.diameters,
        sym_objs=[o for o in cfg.DATASETS.SYM_OBJS if o in models.objs],
        sym_rots={k: v for k, v in models.sym_rots.items() if v is not None},
        eval_precision=cfg.VAL.get("EVAL_PRECISION", False), device=device)

    # GT instances with no detection are recall failures (reference
    # gdrn_custom_evaluator.py:552-556), counted on shard 0 alone so that
    # the gather sums to the total
    if detections is not None and shard == 0:
        gt_cnt_by_img: dict = defaultdict(Counter)
        for r in records:
            gt_cnt_by_img[(r["scene_id"], r["im_id"])][int(r["obj_id"])] += 1
        for key, gt_cnt in gt_cnt_by_img.items():
            det_cnt = Counter(int(d["obj_id"]) for d in detections.get(key, []))
            for oid, n_gt in gt_cnt.items():
                n_miss = max(0, n_gt - det_cnt.get(oid, 0))
                name = models.meta.id2obj.get(oid)
                if n_miss and name is not None and name in models.points:
                    evaluator.record_missing(name, n_miss)

    # flatten every (image, detection) into one stream and fill each bucket
    # completely (the reference batches per image, data_loader.py:389).
    # Estimates are matched to GT per (image, object) after inference, so
    # images with several instances of one object score every instance.
    groups: list[dict] = []
    flat: list[tuple] = []
    for rgb_path, K, rois, info in items:
        gts_by_obj: dict = defaultdict(list)
        for g in info["gts"]:
            gts_by_obj[int(g["obj_id"])].append(g)
        dets_by_obj: dict = defaultdict(list)
        for det in rois:
            dets_by_obj[int(det["obj_id"])].append(det)
        for oid, dets in dets_by_obj.items():
            grp = {"scene_id": info["scene_id"], "im_id": info["im_id"],
                   "obj_id": oid, "gts": gts_by_obj.get(oid, []), "ests": []}
            groups.append(grp)
            for det in dets:
                flat.append((rgb_path, K, det, grp))
    if num_shards > 1:
        # a contiguous shard of groups (not of detections), so that each
        # group's estimates are matched to its GT on one shard
        per = -(-len(groups) // num_shards)
        groups = groups[shard * per:(shard + 1) * per]
        kept = {id(g) for g in groups}
        flat = [f for f in flat if id(f[3]) in kept]

    bop_results = []
    total_compute, total_process, n_buckets = 0.0, 0.0, 0

    # one producer thread maps bucket i+1 (PNG decode and warps, the host's
    # share) while the device runs bucket i (the reference's per-image loop
    # serializes the two, gdrn_evaluator.py:545-560)
    buckets_q: queue.Queue = queue.Queue(maxsize=2)
    cancel = threading.Event()

    def _put(item) -> bool:
        while not cancel.is_set():
            try:
                buckets_q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _producer():
        try:
            for start_ in range(0, len(flat), bucket):
                if cancel.is_set():
                    return
                chunk_ = flat[start_:start_ + bucket]
                batch_ = mapper.map_flat([(p, K, d) for p, K, d, _ in chunk_])
                if not _put((start_, chunk_, batch_)):
                    return
            _put(None)
        except BaseException as e:  # raised again in the main loop below
            _put(e)

    producer = threading.Thread(target=_producer, name="do_test-mapper", daemon=True)
    producer.start()
    try:
        while True:
            item = buckets_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            start, chunk, batch = item
            t0 = time.perf_counter()
            dev_batch = _to_device(batch, device)
            out = predict(dev_batch)
            if use_pnp:  # pose computation, so it lands in the compute window
                rot, trans = refine_bucket_poses(cfg, models, batch, dev_batch, out, seed=start)
            else:
                rot = out["rot"].float().cpu().numpy()  # the host waits for the bucket here
                trans = out["trans"].float().cpu().numpy()
            if start > 0:  # warmup-excluded timing (gdrn_evaluator.py:545)
                total_compute += time.perf_counter() - t0
                n_buckets += 1

            t1 = time.perf_counter()
            for j, (_, _, _, meta_j) in enumerate(chunk):
                obj_id = int(batch["obj_ids"][j])
                bop_results.append({
                    "scene_id": meta_j["scene_id"], "im_id": meta_j["im_id"],
                    "obj_id": obj_id, "score": float(batch["scores"][j]),
                    "R": rot[j], "t": trans[j] * 1000.0,
                    "time": (time.perf_counter() - t0)})
                meta_j["ests"].append(
                    {"R": rot[j].copy(), "t": trans[j].copy(),
                     "score": float(batch["scores"][j])})
            if start > 0:
                total_process += time.perf_counter() - t1
    finally:
        # unblock and stop the producer on an exception mid-test, so that
        # later do_test calls in this process do not pile up wedged threads
        cancel.set()
        producer.join(timeout=10)

    # est<->gt matching per (image, object) group: best-score estimate first,
    # each takes the remaining GT instance nearest in translation (greedy,
    # BOP-protocol style with te as the matching cost). One scored pair per
    # GT instance; with EVAL_PRECISION every surplus estimate is also judged
    # against its nearest GT (reference _eval_predictions_precision).
    for grp in groups:
        gts = grp["gts"]
        if not gts:
            continue
        name = models.meta.id2obj[grp["obj_id"]]
        ests = sorted(grp["ests"], key=lambda e: -e["score"])
        remaining = list(range(len(gts)))
        matched: list[tuple] = []
        for est in ests:
            if remaining:
                k = min(remaining, key=lambda i: float(
                    np.linalg.norm(est["t"] - gts[i]["t"])))
                remaining.remove(k)
                matched.append((est, gts[k]))
            elif cfg.VAL.get("EVAL_PRECISION", False):
                k = min(range(len(gts)), key=lambda i: float(
                    np.linalg.norm(est["t"] - gts[i]["t"])))
                matched.append((est, gts[k]))
        for est, gt in matched:
            evaluator.process(name, est["R"], est["t"], gt["R"], gt["t"], gt["K"])

    if mh.get_world_size() > 1 and num_shards > 1:
        # every shard's rows and (pose, GT) pairs, scored together on every rank
        gathered = mh.all_gather_objects({"bop": bop_results, "preds": dict(evaluator._preds),
                                          "missing": dict(evaluator._missing)})
        bop_results = [r for g in gathered for r in g["bop"]]
        evaluator.reset()
        for g in gathered:
            for name, pairs in g["preds"].items():
                evaluator._preds[name].extend(pairs)
            for name, n in g["missing"].items():
                evaluator._missing[name] += n

    # BOP CSV requires one time value per image (the official toolkit
    # rejects rows of the same image with differing times); report the max
    # over the image's estimates
    t_by_img: dict = {}
    for r_ in bop_results:
        key = (r_["scene_id"], r_["im_id"])
        t_by_img[key] = max(t_by_img.get(key, 0.0), r_["time"])
    for r_ in bop_results:
        r_["time"] = t_by_img[(r_["scene_id"], r_["im_id"])]

    results = evaluator.evaluate()
    main = mh.is_main_process()
    if output_dir and save_csv and main:
        csv_path = osp.join(output_dir, f"{models.meta.name}-test_gdrnet-tpu.csv")
        save_bop_results(csv_path, bop_results)
        results["_csv_path"] = csv_path
    if cfg.VAL.get("USE_BOP") and main:
        # in-process BOP-toolkit-style scoring over VAL.ERROR_TYPES
        # (reference spawns eval_pose_results_more.py subprocesses,
        # test_utils.py:33-75; here eval/bop_score.py scores directly)
        results["_bop"] = score_results(
            bop_results, records, models,
            error_types=cfg.VAL.ERROR_TYPES, n_top=cfg.VAL.N_TOP,
            sym_objs=[o for o in cfg.DATASETS.SYM_OBJS if o in models.objs],
            image_width=models.meta.width,
            precision=cfg.VAL.get("EVAL_PRECISION", False), device=device)
        results["_bop_average_recall"] = bop19_average_recall(results["_bop"])
    if n_buckets:
        results["_time"] = {"compute_s_per_bucket": total_compute / n_buckets,
                            "process_s_per_bucket": total_process / n_buckets,
                            "rois_per_bucket": bucket}
    results["_summary"] = evaluator.summarize(
        {k: v for k, v in results.items() if not k.startswith("_")})
    return results
