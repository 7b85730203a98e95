#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gdrnet_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at the flagship's full width: GDRN-R34 from
configs/gdrn/synth/a6_cPnP_synth.py (256x256 crops, 256 head filters, 64
regions, 10 classes) with seeded random weights serves 4 requests of 64
crops under bf16 autocast, then CustomEvaluator scores the served poses,
ADD-S of the 4 symmetric objects going through the hand-written CUDA
nearest-neighbour kernel (gdrnet_tpu_torch/csrc/nn_min_dist.cu).

Phases, one line each: device, kernel build, kernel against its plain
PyTorch version and cKDTree, f32 forward on the GPU against the CPU, bf16
serving, scoring (kernel against the plain version), throughput. Any
failure raises; the exit code is then non-zero and the result line is not
printed. The last line is {"ok": true, "device": {...}}; the line before it
holds the kernels' launches, errors and times.

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and scipy.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gdrnet_tpu_torch import csrc, merged_config
from gdrnet_tpu_torch.data.synthetic import (
    poses_near,
    synthetic_object_models,
    synthetic_roi_batch,
)
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.ops import kernels

FLAGSHIP = str(Path(__file__).resolve().parent / "configs/gdrn/synth/a6_cPnP_synth.py")
# the synth dataset's objects (tools/gen_scale_dataset.py), in class order
OBJECTS = ["cube", "brick", "plate", "tower", "pyramid", "lblock", "wedge", "octa",
           "bar", "hexprism"]
NN_SHAPE = (64, 3000, 3000)  # a 64-instance object, NUM_PM_POINTS=3000
NN_RAGGED = [(3, 1, 3001), (3, 3001, 1), (2, 3001, 3001), (1, 1, 1), (5, 777, 1500)]
NN_RTOL, NN_ATOL = 1e-5, 1e-7  # vs the plain version: same f32 distances, other sum order
KDTREE_RTOL = 1e-4             # vs cKDTree: f64 search on the f32 points
# f32 GPU (TF32 off) vs CPU through ~40 conv layers of two conv libraries
FWD_ROT_ATOL, FWD_TRANS_RTOL, FWD_TRANS_ATOL = 1e-3, 1e-3, 1e-4
ORTHO_ATOL = 1e-4              # |R R^T - I| and |det R - 1| of the f32 decode
BENCH_BATCH = 1024             # bench.py's serving batch


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_times(fn, iters: int, warmup: int = 3) -> np.ndarray:
    """Device time of each of `iters` calls of fn() in ms, from CUDA events
    around each call, after `warmup` calls that are not timed."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return np.asarray([start.elapsed_time(end) for start, end in events])


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_kernel() -> dict:
    t0 = time.perf_counter()
    lib_path = csrc.build("nn_min_dist")
    build_s = time.perf_counter() - t0
    ptxas = [ln.split("ptxas info    :")[-1].strip()
             for ln in Path(f"{lib_path}.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", kernel="nn_min_dist", seconds=f"{build_s:.2f}", ptxas=" | ".join(ptxas))

    from scipy import spatial

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    worst = 0.0
    for b, nq, nr in [NN_SHAPE] + NN_RAGGED:
        q = (torch.randn(b, nq, 3, generator=g) * 0.1).to(dev)
        r = (torch.randn(b, nr, 3, generator=g) * 0.1).to(dev)
        got = kernels.nn_min_dist(q, r)
        again = kernels.nn_min_dist(q, r)
        want = kernels.nn_min_dist_ref(q, r)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=NN_RTOL, atol=NN_ATOL)
        if not torch.equal(got, again):
            raise AssertionError(f"nn_min_dist differs between runs at {(b, nq, nr)}")
        err = (got - want).abs().max().item()
        if (b, nq, nr) == NN_SHAPE:
            max_abs_err = err
            rows = 4
            kd = np.asarray([spatial.cKDTree(rr).query(qq, k=1)[0].mean() for qq, rr in
                             zip(q[:rows].cpu().numpy(), r[:rows].cpu().numpy())])
            np.testing.assert_allclose(got[:rows].cpu().numpy(), kd, rtol=KDTREE_RTOL)
            kd_err = float(np.max(np.abs(got[:rows].cpu().numpy() - kd) / kd))
        worst = max(worst, err)
        log("nn_min_dist", shape=f"{b}x{nq}x{nr}", max_abs_err=f"{err:.3e}")
    log("nn_min_dist", check="ok", rtol=NN_RTOL, atol=NN_ATOL, kdtree_rtol=KDTREE_RTOL,
        kdtree_max_rel=f"{kd_err:.3e}", worst_abs_err=f"{worst:.3e}")

    # time at the main path's shape, in turns: plain, kernel, kernel, plain
    b, nq, nr = NN_SHAPE
    q = (torch.randn(b, nq, 3, generator=g) * 0.1).to(dev)
    r = (torch.randn(b, nr, 3, generator=g) * 0.1).to(dev)
    plain = [cuda_times(lambda: kernels.nn_min_dist_ref(q, r), 10)]
    kern = [cuda_times(lambda: kernels.nn_min_dist(q, r), 50) for _ in range(2)]
    plain.append(cuda_times(lambda: kernels.nn_min_dist_ref(q, r), 10))
    kern, plain = np.concatenate(kern), np.concatenate(plain)
    log("nn_min_dist_time", shape=f"{b}x{nq}x{nr}", order="plain,kernel,kernel,plain",
        kernel_median_ms=f"{np.median(kern):.4f}", kernel_max_ms=f"{kern.max():.4f}",
        kernel_n=len(kern), plain_median_ms=f"{np.median(plain):.4f}",
        plain_max_ms=f"{plain.max():.4f}", plain_n=len(plain))
    return {"max_abs_err": max_abs_err, "ms": float(np.median(kern)),
            "plain_ms": float(np.median(plain))}


def phase_forward_f32(cfg32, state_dict: dict, batch: dict) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = []
    for device in ("cuda", "cpu"):
        model = build_model(cfg32, device=device)
        model.load_state_dict(state_dict)
        out = make_predict_step(model)(to_device(batch, device))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    gpu, cpu = outs
    rot_err = float(np.abs(gpu["rot"] - cpu["rot"]).max())
    trans_err = float(np.abs(gpu["trans"] - cpu["trans"]).max())
    np.testing.assert_allclose(gpu["rot"], cpu["rot"], atol=FWD_ROT_ATOL)
    np.testing.assert_allclose(gpu["trans"], cpu["trans"], rtol=FWD_TRANS_RTOL,
                               atol=FWD_TRANS_ATOL)
    log("forward_f32", crops=len(batch["roi_img"]), vs="cpu", rot_max_abs=f"{rot_err:.3e}",
        trans_max_abs=f"{trans_err:.3e}", rot_atol=FWD_ROT_ATOL,
        trans_rtol=FWD_TRANS_RTOL, trans_atol=FWD_TRANS_ATOL, check="ok")


def check_rotations(R: np.ndarray, where: str) -> None:
    if not np.all(np.isfinite(R)):
        raise AssertionError(f"{where}: non-finite rotations")
    ortho = np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max()
    det = np.abs(np.linalg.det(R.astype(np.float64)) - 1.0).max()
    if ortho > ORTHO_ATOL or det > ORTHO_ATOL:
        raise AssertionError(f"{where}: R not a rotation (|RR^T-I| {ortho}, |det-1| {det})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU",
              file=sys.stderr)
        return 2

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2-3. kernel build, correctness and time
    nn_stats = phase_kernel()

    # 4a. flagship forward in f32 on the GPU against the CPU
    cfg = merged_config(FLAGSHIP)
    cfg32 = merged_config(FLAGSHIP)
    cfg32.PARALLEL.DTYPE = "float32"
    ref_model = init_weights(build_model(cfg32), torch.Generator().manual_seed(0))
    state_dict = ref_model.state_dict()
    n_cls = cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES
    roi_bs = cfg.TEST.ROI_BATCH_SIZE
    res = cfg.MODEL.CDPN.BACKBONE.INPUT_RES, cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES
    small = synthetic_roi_batch(batch_size=4, input_res=res[0], out_res=res[1],
                                num_classes=n_cls, seed=100)
    phase_forward_f32(cfg32, state_dict, small)

    model = build_model(cfg, device="cuda")
    model.load_state_dict(state_dict)
    predict = make_predict_step(model)
    requests = [synthetic_roi_batch(batch_size=roi_bs, input_res=res[0], out_res=res[1],
                                    num_classes=n_cls, seed=i) for i in range(4)]
    points, diameters, sym_rots = synthetic_object_models(
        OBJECTS, list(cfg.DATASETS.SYM_OBJS), num_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
        seed=0)

    # 4b-5. the main path: serve 4 requests of 64 crops, then score them
    kernels.nn_min_dist.launches = 0
    served = []
    for req in requests:
        out = predict(to_device(req, "cuda"))
        served.append({k: v.float().cpu().numpy() for k, v in out.items()})
    R = np.concatenate([s["rot"] for s in served])
    t = np.concatenate([s["trans"] for s in served])
    K = np.concatenate([r["roi_cams"] for r in requests])
    objs = [OBJECTS[c] for r in requests for c in r["roi_classes"]]
    R_gt, t_gt = poses_near(R, t, seed=1)

    def evaluate(device):
        ev = CustomEvaluator(OBJECTS, points, diameters, sym_objs=list(cfg.DATASETS.SYM_OBJS),
                             sym_rots=sym_rots, device=device)
        ev.process_batch(objs, R, t, R_gt, t_gt, K)
        return ev.evaluate()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = evaluate("cuda")
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.nn_min_dist.launches

    if not np.all(np.isfinite(t)):
        raise AssertionError("serving: non-finite translations")
    check_rotations(R, "serving bf16")
    log("serve_bf16", requests=len(requests), crops=len(R), rot_shape=list(R.shape),
        trans_shape=list(t.shape), check="ok")
    # drift of the bf16 serving path against f32 on the card
    m32 = build_model(cfg32, device="cuda")
    m32.load_state_dict(state_dict)
    out32 = {k: v.cpu().numpy() for k, v in make_predict_step(m32)(
        to_device(requests[0], "cuda")).items()}
    cos = (np.sum(served[0]["rot"] * out32["rot"], axis=(1, 2)) - 1.0) / 2.0
    rot_deg = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    trans_rel = (np.linalg.norm(served[0]["trans"] - out32["trans"], axis=1)
                 / np.linalg.norm(out32["trans"], axis=1))
    log("bf16_drift", vs="f32 on the card", crops=roi_bs,
        rot_deg_median=f"{np.median(rot_deg):.3f}", rot_deg_max=f"{rot_deg.max():.3f}",
        trans_rel_median=f"{np.median(trans_rel):.3e}", trans_rel_max=f"{trans_rel.max():.3e}")

    n_sym = sum(1 for o in set(objs) if o in cfg.DATASETS.SYM_OBJS)
    if launches < 1 or launches != n_sym:
        raise AssertionError(f"nn_min_dist launched {launches} times, expected {n_sym} "
                             "(one per symmetric object)")
    plain = evaluate("cpu")  # the same scoring through nn_min_dist_ref
    for obj, row in results.items():
        for k in RECALL_KEYS:
            if row[k] != plain[obj][k]:
                raise AssertionError(f"scoring: {obj} {k} kernel {row[k]} vs plain "
                                     f"{plain[obj][k]}")
            np.testing.assert_allclose(row["mean_ad"], plain[obj]["mean_ad"], rtol=NN_RTOL)
    warm_ms = []
    for _ in range(5):  # the same scoring again, once PyTorch's kernels are loaded
        t0 = time.perf_counter()
        evaluate("cuda")
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    log("score", objects=len(results) - 1, sym_objects=n_sym, launches=launches,
        recalls="equal to plain", first_evaluate_ms=f"{score_ms:.1f}",
        warm_evaluate_ms_median=f"{np.median(warm_ms):.1f}", warm_n=len(warm_ms),
        avg_ad_10=results["Avg"]["ad_10"], avg_mean_ad=f"{results['Avg']['mean_ad']:.6f}")

    # 6. throughput, bf16 serving
    for bs in (roi_bs, BENCH_BATCH):
        torch.cuda.reset_peak_memory_stats()
        batch = to_device(synthetic_roi_batch(batch_size=bs, input_res=res[0], out_res=res[1],
                                              num_classes=n_cls, seed=7), "cuda")
        ms = cuda_times(lambda: predict(batch), iters=30 if bs <= 64 else 12)
        log("throughput_bf16", batch=bs, iters=len(ms), median_ms=f"{np.median(ms):.3f}",
            max_ms=f"{ms.max():.3f}", crops_per_s_median=f"{bs / np.median(ms) * 1e3:.1f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        del batch

    print(json.dumps({"kernels": [{
        "name": "nn_min_dist", "route": "cuda",
        "source": "gdrnet_tpu_torch/csrc/nn_min_dist.cu",
        "replaces": "gdrnet_tpu/ops/pallas_kernels.py:28",
        "launches": launches, **nn_stats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
