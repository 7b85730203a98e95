#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gdrnet_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at the flagship's full width: GDRN-R34 from
configs/gdrn/synth/a6_cPnP_synth.py (256x256 crops, 256 head filters, 64
regions, 10 classes) with seeded random weights serves 4 requests of 64
crops under bf16 autocast. CustomEvaluator scores the served poses, ADD-S of
the 4 symmetric objects going through the hand-written CUDA nearest-neighbour
kernel (gdrnet_tpu_torch/csrc/nn_min_dist.cu). Then the flagship's BOP
scoring runs as engine/tester.py:315-332 runs it: the served poses go to a
BOP19 CSV and back, and eval/bop_score.score_results scores them with the
config's VAL.ERROR_TYPES (ad,rete,re,te,proj,vsd,mssd,mspd) against a
BOP-layout test split of the dataset's ten meshes (tools/gen_scale_dataset.py
mesh_zoo) that this script writes; VSD's depth renders go through the
hand-written CUDA z-buffer kernels (gdrnet_tpu_torch/csrc/rasterize_xyz.cu:
the face setup on the device, then the z-buffer with per-tile face culling).

Phases, one line each (or one per case): device, kernel builds (both nvcc
runs at once), nn_min_dist against its plain PyTorch version and cKDTree,
timed beside its bound and torch.cdist; rasterize_xyz against its plain
version (20 cases), and its time beside its bounds and the share of
pixel-face pairs it culls; f32 forward on the GPU against the CPU, bf16
serving, CustomEvaluator scoring (kernel against the plain version),
throughput, the BOP split, BOP scoring on the card and against the plain
versions on the CPU; last, what torch.profiler measures (rasterize_xyz's
launches per call and its kernels' device time, the device time of a BOP
scoring call), so that no host-bound phase is timed after a profiler
session. Any failure raises; the exit code is then non-zero and the result
line is not printed. The last line is
{"ok": true, "device": {...}}; the line before it holds the kernels'
launches, errors, times and bounds.

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and scipy.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gdrnet_tpu_torch import csrc, merged_config
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.data.synthetic import (
    edge_on_poses,
    poses_near,
    sliver_mesh,
    synthetic_object_models,
    synthetic_roi_batch,
    write_bop_test_split,
)
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.eval import bop_score
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results, save_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent
DEV = "cuda"  # device of the rasterize_xyz and BOP phases
FLAGSHIP = str(REPO / "configs/gdrn/synth/a6_cPnP_synth.py")
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
# rasterize_xyz against its plain version on the card: both read one face
# table and round every operation alike, so hit masks must be equal and
# depth / xyz within this many metres (bitwise equality is expected)
RASTER_ATOL = 1e-6
RASTER_TILE_PIXELS = kernels.RASTER_TILE ** 2
# per-pair VSD errors, card (kernel) against CPU (plain versions): one pixel
# of a union of at least 1,000
VSD_ATOL = 1e-3
PER_IMAGE, IMAGES_PER_SCENE = 8, 8  # the BOP split: 8 instances an image, 4 scenes of 8 images
# bounds: the H100 SXM's published peaks (HBM 3.35 TB/s; FP32 outside the
# tensor cores 67 TFLOP/s with an FMA as two, so 3.35e13 instructions/s) and
# each kernel's f32 instructions per pair: B1's inner loop 3 sub, 1 mul, 2
# FMA, 1 min; B2's two edge functions, w2, the 1/z interpolation, the tests
HBM_BYTES_PER_S, FP32_INSTR_PER_S = 3.35e12, 3.35e13
NN_INSTR_PER_PAIR, RASTER_INSTR_PER_PAIR = 7, 25


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


def host_times(fn, iters: int, warmup: int = 3) -> np.ndarray:
    """Host-clock ms of each of `iters` calls of fn() that each end in
    torch.cuda.synchronize(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(out)


def profiled_device_ms(fn, iters: int, names=("",)) -> dict | None:
    """Device ms per call of fn() over `iters` calls, after one call that is
    not profiled, from torch.profiler: for each of `names`, the sum over the
    device activity (kernels, copies) whose name holds it ("" holds all);
    None where the profiler sees no device activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    return {k: sum(us for n, us in spans if k in n) / iters / 1e3 for k in names}


def bound(n_bytes: float, n_instr: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the f32 instructions over the issue rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_instr / FP32_INSTR_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes > by_ops else (by_ops, "operations")


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_build(names=("nn_min_dist", "rasterize_xyz")) -> None:
    """Build every kernel from the checkout's sources, one nvcc each, all
    started together."""
    def one(name):
        t0 = time.perf_counter()
        path = csrc.build(name)
        return name, path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(one, names))
    for name, lib_path, build_s in built:
        ptxas = [ln.split("ptxas info    :")[-1].strip()
                 for ln in Path(f"{lib_path}.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", kernel=name, seconds=f"{build_s:.2f}", ptxas=" | ".join(ptxas))


def phase_kernel() -> dict:
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
    # the one PyTorch call of the same function, a yardstick the port never calls
    library = cuda_times(lambda: torch.cdist(q, r).amin(-1).mean(-1), 10)
    lib_rel = float(((torch.cdist(q, r).amin(-1).mean(-1) - kernels.nn_min_dist(q, r)).abs()
                     / kernels.nn_min_dist_ref(q, r)).max())
    bound_ms, bound_by = bound(4.0 * (q.numel() + r.numel() + b), NN_INSTR_PER_PAIR * b * nq * nr)
    log("nn_min_dist_time", shape=f"{b}x{nq}x{nr}", order="plain,kernel,kernel,plain",
        kernel_median_ms=f"{np.median(kern):.4f}", kernel_max_ms=f"{kern.max():.4f}",
        kernel_n=len(kern), plain_median_ms=f"{np.median(plain):.4f}",
        plain_max_ms=f"{plain.max():.4f}", plain_n=len(plain),
        cdist_median_ms=f"{np.median(library):.4f}", cdist_n=len(library),
        cdist_max_rel_diff=f"{lib_rel:.3e}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / np.median(kern):.3f}")
    return {"max_abs_err": max_abs_err, "ms": float(np.median(kern)),
            "plain_ms": float(np.median(plain)), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": float(np.median(library))}


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


def mesh_tools():
    """tools/gen_scale_dataset.py (stdlib + numpy at import): mesh_zoo and
    _subdivide, loaded from its path."""
    spec = importlib.util.spec_from_file_location("gen_scale_dataset",
                                                  REPO / "tools/gen_scale_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def raster_args(verts, faces, K, R, t, origins) -> list:
    """rasterize_xyz's tensor arguments on the card, C-contiguous (a
    strided one would cost the wrapper a copy kernel)."""
    return [torch.as_tensor(np.ascontiguousarray(x, dtype), device=DEV)
            for x, dtype in ((verts, np.float32), (faces, np.int32), (K, np.float32),
                             (R, np.float32), (t, np.float32), (origins, np.float32))]


def raster_case(case: str, args: list, h: int, w: int) -> tuple[float, int]:
    """rasterize_xyz against rasterize_xyz_ref on the card at one shape;
    returns (max abs difference, hit pixels)."""
    d1, x1 = kernels.rasterize_xyz(*args, h, w)
    d2, x2 = kernels.rasterize_xyz(*args, h, w)
    dr, xr = kernels.rasterize_xyz_ref(*args, h, w)
    torch.cuda.synchronize()
    if not (torch.equal(d1, d2) and torch.equal(x1, x2)):
        raise AssertionError(f"rasterize_xyz differs between runs ({case})")
    unequal = int(((d1 > 0) != (dr > 0)).sum())
    dd = float((d1 - dr).abs().max())
    dx = float((x1 - xr).abs().max())
    bitwise = torch.equal(d1, dr) and torch.equal(x1, xr)
    hits = int((d1 > 0).sum())
    log("rasterize_xyz", case=case, shape=f"{args[2].shape[0]}x{h}x{w}",
        faces=args[1].shape[0], hit_px=hits, unequal_hit_px=unequal,
        max_depth_diff=f"{dd:.3e}", max_xyz_diff=f"{dx:.3e}", bitwise_equal=bitwise)
    if unequal or dd > RASTER_ATOL or dx > RASTER_ATOL:
        raise AssertionError(f"rasterize_xyz vs plain ({case}): {unequal} unequal hit "
                             f"pixels, depth {dd}, xyz {dx} (atol {RASTER_ATOL})")
    return max(dd, dx), hits


def centred_origins(K, t, tile: int) -> np.ndarray:
    """Window origins that centre a tile x tile window on each projected
    object centre (integer pixels, not clamped to the frame)."""
    c = np.einsum("ij,bj->bi", K, t)
    return np.stack([np.floor(c[:, 0] / c[:, 2]) - tile // 2,
                     np.floor(c[:, 1] / c[:, 2]) - tile // 2], axis=1).astype(np.float32)


def phase_raster(gsd) -> dict:
    zoo = gsd.mesh_zoo()
    poses = synthetic_roi_batch(batch_size=16, input_res=32, out_res=8, num_classes=10, seed=50)
    K, R, t = poses["roi_cams"][0], poses["gt_ego_rot"], poses["gt_trans"]
    Ks = np.broadcast_to(K, (16, 3, 3))
    sub2 = {name: gsd._subdivide(*gsd._subdivide(v, f)) for name, v, f, _ in zoo
            if name in ("cube", "tower")}
    worst, cases = 0.0, []
    for name, v, f, _ in zoo:  # each zoo mesh, 16 poses, 128^2 windows
        cases.append((f"zoo/{name}", raster_args(v, f, Ks, R, t, centred_origins(K, t, 128)),
                      128, 128))
    tower_v, tower_f = zoo[3][1], zoo[3][2]
    cases.append(("zoo256/tower", raster_args(tower_v, tower_f, Ks, R, t,
                                              centred_origins(K, t, 256)), 256, 256))
    for name, (v, f) in sub2.items():
        cases.append((f"subdiv2/{name}", raster_args(v, f, Ks, R, t,
                                                    centred_origins(K, t, 256)), 256, 256))
    cases.append(("full_frame/hexprism", raster_args(zoo[9][1], zoo[9][2], K[None], R[:1],
                                                     t[:1], np.zeros((1, 2))), 480, 640))
    tri = np.array([[-0.05, -0.04, 0.0], [0.06, -0.03, 0.01], [0.0, 0.05, -0.01]], np.float32)
    cases.append(("one_face", raster_args(tri, [[0, 1, 2]], Ks[:4], R[:4], t[:4],
                                          centred_origins(K, t[:4], 64)), 64, 64))
    cv, cf = sub2["cube"]
    cases.append(("ragged_faces_777", raster_args(cv, cf[:777], Ks[:3], R[:3], t[:3],
                                                  centred_origins(K, t[:3], 96)), 90, 100))
    # objects at the frame's corners, their windows hanging over its edges
    corners = np.array([[10.0, 470.0, 1.0], [630.0, 5.0, 1.0]], np.float32)
    t_edge = (0.6 * corners @ np.linalg.inv(K).T).astype(np.float32)
    cases.append(("off_frame", raster_args(tower_v, tower_f, Ks[:2], R[:2], t_edge,
                                           centred_origins(K, t_edge, 128)), 128, 128))
    behind = t[:2] * np.array([1.0, 1.0, -1.0], np.float32)
    cases.append(("behind_camera", raster_args(tower_v, tower_f, Ks[:2], R[:2], behind,
                                               centred_origins(K, t[:2], 128)), 128, 128))
    # face planes through the camera centre, then near-degenerate faces
    R_on, t_on = edge_on_poses(0.035)
    c_on = t_on @ K.T
    cases.append(("edge_on_cube", raster_args(zoo[0][1], zoo[0][2], Ks[:4], R_on, t_on,
                                              np.floor(c_on[:, :2] / c_on[:, 2:] - 64)),
                  128, 128))
    sv, sf = sliver_mesh(K, seed=1)
    cases.append(("slivers", raster_args(sv, sf, Ks[:2], np.stack([np.eye(3)] * 2),
                                         np.zeros((2, 3)), [[188.0, 146.0], [220.0, 130.0]]),
                  96, 128))
    for case, args, h, w in cases:
        err, hits = raster_case(case, args, h, w)
        worst = max(worst, err)
        if (case == "behind_camera") != (hits == 0):
            raise AssertionError(f"rasterize_xyz {case}: {hits} hit pixels")
    log("rasterize_xyz", check="ok", cases=len(cases), atol=RASTER_ATOL,
        worst_abs_err=f"{worst:.3e}")

    # time in turns, plain, kernel, kernel, plain: the main path's shape (a
    # 16-pose batch of 128^2 windows over a zoo mesh), then a heavy one
    timed = [("16x128x128/tower_448", cases[3][1], 128, 10),
             ("16x256x256/tower_subdiv2_7168", cases[12][1], 256, 3)]
    times = {}
    for label, args, hw, n_plain in timed:
        plain = [cuda_times(lambda: kernels.rasterize_xyz_ref(*args, hw, hw), n_plain, 1)]
        kern = [cuda_times(lambda: kernels.rasterize_xyz(*args, hw, hw), 20) for _ in range(2)]
        plain.append(cuda_times(lambda: kernels.rasterize_xyz_ref(*args, hw, hw), n_plain, 1))
        kern, plain = np.concatenate(kern), np.concatenate(plain)
        host = host_times(lambda: kernels.rasterize_xyz(*args, hw, hw), 20)
        # the plain version's PyTorch prologue alone (the face table), which
        # the CUDA path builds in its setup kernel instead
        geom, _ = kernels.raster_face_tables(args[0], args[0], *args[1:5])
        table = cuda_times(lambda: kernels.raster_face_tables(args[0], args[0], *args[1:5]), 20)
        B, V, F = args[2].shape[0], args[0].shape[0], args[1].shape[0]
        pairs = B * hw * hw * F
        # pairs the kernel tests after culling: kept faces x the tile's pixels
        # (every tile is full at these window sizes)
        kept = int(kernels.raster_tile_keep(geom, args[5], hw, hw).sum()) * RASTER_TILE_PIXELS
        n_bytes = 4.0 * (3 * V + 3 * F + 23 * B) + 16.0 * B * hw * hw
        all_ms, _ = bound(n_bytes, RASTER_INSTR_PER_PAIR * pairs)
        bound_ms, bound_by = bound(n_bytes, RASTER_INSTR_PER_PAIR * kept)
        med = float(np.median(kern))
        times[label] = {"ms": med, "plain_ms": float(np.median(plain)), "bound_ms": bound_ms,
                        "bound_by": bound_by}
        log("rasterize_xyz_time", shape=label, order="plain,kernel,kernel,plain",
            kernel_median_ms=f"{med:.4f}", kernel_max_ms=f"{kern.max():.4f}",
            kernel_n=len(kern), plain_median_ms=f"{np.median(plain):.4f}",
            plain_max_ms=f"{plain.max():.4f}", plain_n=len(plain),
            host_synced_call_median_ms=f"{np.median(host):.4f}", host_n=len(host),
            face_table_median_ms=f"{np.median(table):.4f}",
            all_pairs_bound_ms=f"{all_ms:.4f}", share_of_all_pairs_bound=f"{all_ms / med:.3f}",
            culled_pair_share=f"{1.0 - kept / pairs:.4f}",
            kept_pairs_bound_ms=f"{bound_ms:.4f}", share_of_kept_pairs_bound=f"{bound_ms / med:.3f}",
            pixel_face_pairs_per_s=f"{pairs / med * 1e3:.3e}")
    stats = {"max_abs_err": worst, **times["16x128x128/tower_448"], "library_ms": None}
    return stats, [(label, args, hw) for label, args, hw, _ in timed]


def check_raster_launches(args: list, hw: int) -> None:
    """One rasterize_xyz call on the card calls no raster_face_tables (the
    face table is built on the device) and, where the profiler sees the
    device, launches exactly the setup and the z-buffer kernel."""
    table_calls = []
    plain_table = kernels.raster_face_tables
    kernels.raster_face_tables = lambda *a, **k: table_calls.append(1) or plain_table(*a, **k)
    try:
        kernels.rasterize_xyz(*args, hw, hw)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            kernels.rasterize_xyz(*args, hw, hw)
            torch.cuda.synchronize()
    finally:
        kernels.raster_face_tables = plain_table
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = sorted("face_setup_kernel" if "face_setup_kernel" in n else
                   "zbuffer_kernel" if "zbuffer_kernel" in n else n for n in names)
    if table_calls or (names and kinds != ["face_setup_kernel", "zbuffer_kernel"]):
        raise AssertionError(f"rasterize_xyz on the card: {len(table_calls)} face-table calls, "
                             f"device activity {names}")
    log("rasterize_xyz_launches", face_table_calls=0,
        kernels_per_call=len(names) if names else "not measured (no device events)",
        kernels="|".join(kinds))


def bop_rows(keys, classes, R, t) -> list[dict]:
    """BOP19 result rows for poses R [N,3,3], t [N,3] (metres) of instance n
    in image keys[n] = (scene_id, im_id), object class classes[n]."""
    return [{"scene_id": int(k[0]), "im_id": int(k[1]), "obj_id": int(c) + 1, "score": 1.0,
             "R": R[i], "t": t[i] * 1000.0, "time": -1.0}
            for i, (k, c) in enumerate(zip(keys, classes))]


def score(cfg, results, records, models, device, error_types=None) -> dict:
    """bop_score.score_results as engine/tester.py:320-332 calls it (with
    cfg.VAL.ERROR_TYPES unless error_types names others)."""
    return bop_score.score_results(
        results, records, models, error_types=error_types or cfg.VAL.ERROR_TYPES,
        n_top=cfg.VAL.N_TOP,
        sym_objs=[o for o in cfg.DATASETS.SYM_OBJS if o in models.objs],
        image_width=models.meta.width, precision=cfg.VAL.get("EVAL_PRECISION", False),
        device=device)


def phase_bop_split(cfg, gsd, requests, root: str) -> dict:
    """The requests' own GT poses and classes as a BOP-layout test split."""
    classes = np.concatenate([r["roi_classes"] for r in requests])
    R_gt = np.concatenate([r["gt_ego_rot"] for r in requests])
    t_gt = np.concatenate([r["gt_trans"] for r in requests])
    zoo = gsd.mesh_zoo()
    t0 = time.perf_counter()
    meta, keys = write_bop_test_split(root, zoo, classes, R_gt, t_gt, requests[0]["roi_cams"][0],
                                      gsd.W_DEF, gsd.H_DEF, PER_IMAGE, IMAGES_PER_SCENE,
                                      device=DEV)
    write_s = time.perf_counter() - t0
    records = load_bop_scene_dicts(meta, "test")
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    log("bop_split", scenes=len(requests), images=len(classes) // PER_IMAGE,
        instances=len(classes), gt_records_visible=len(records),
        faces=",".join(str(len(z[2])) for z in zoo), write_s=f"{write_s:.2f}",
        load_s=f"{time.perf_counter() - t0 - write_s:.2f}")
    if not all("depth_path" in r for r in records) or len(records) < len(classes) // 2:
        raise AssertionError("bop_split: records without depth, or most instances hidden")
    return {"keys": keys, "classes": classes, "R_gt": R_gt, "t_gt": t_gt,
            "records": records, "models": models}


def compare_with_plain(cfg, results, split, label: str) -> None:
    """Scene 1's scoring on the card against the plain versions on the CPU:
    per-pair VSD errors within VSD_ATOL, every recall equal except where a
    pair's VSD error lies within VSD_ATOL of a threshold."""
    models = split["models"]
    records = [r for r in split["records"] if r["scene_id"] == 1]
    results = [r for r in results if r["scene_id"] == 1]
    t0 = time.perf_counter()
    plain = score(cfg, results, records, models, "cpu")
    plain_s = time.perf_counter() - t0
    card = score(cfg, results, records, models, DEV)
    pairs = bop_score.match_estimates_to_gt(results, records, cfg.VAL.N_TOP)
    delta = bop_score.VSD_DELTAS_MM.get(models.meta.name.split("_")[0],
                                        bop_score.VSD_DELTA_MM_DEFAULT)
    errs = [bop_score._vsd_errors_by_obj(pairs, models, delta, bop_score.BOP19_VSD_TAUS,
                                         device=device) for device in (DEV, "cpu")]
    worst, near, flips = 0.0, 0, 0
    ths = bop_score.BOP19_VSD_THRESHOLDS
    for name in errs[0]:
        e_card, e_plain = np.stack(errs[0][name]), np.stack(errs[1][name])
        worst = max(worst, float(np.abs(e_card - e_plain).max()))
        near += int(np.any(np.abs(e_card[..., None] - ths) <= VSD_ATOL, axis=(1, 2)).sum())
        flips += int(((e_card[..., None] < ths) != (e_plain[..., None] < ths)).sum())
    if worst > VSD_ATOL:
        raise AssertionError(f"bop_plain {label}: VSD errors card vs CPU differ by {worst}")
    differ = [(t, o) for t in card for o in card[t] if card[t][o] != plain[t][o]]
    if any(t != "vsd" for t, _ in differ) or (differ and not flips):
        raise AssertionError(f"bop_plain {label}: recalls differ at {differ} "
                             f"({flips} VSD threshold flips)")
    log("bop_plain", csv=label, scene=1, gt=len(records), estimates=len(results),
        vsd_pairs=sum(len(v) for v in errs[0].values()), vsd_max_abs_diff=f"{worst:.3e}",
        vsd_atol=VSD_ATOL, pairs_near_threshold=near, threshold_flips=flips,
        recalls="equal" if not differ else f"vsd differs at {len(differ)} (flips)",
        plain_cpu_s=f"{plain_s:.2f}")


def phase_bop_score(cfg, split, R, t, root: str) -> tuple[int, list]:
    """Score the served poses, then GT perturbed by poses_near, through
    BOP19 CSVs; returns the z-buffer kernel's launches in the served run and
    [(csv label, its results)]."""
    types = bop_score.validate_error_types(cfg.VAL.ERROR_TYPES)
    served_launches, scored = 0, []
    R_near, t_near = poses_near(split["R_gt"], split["t_gt"], seed=2)
    for label, (R_e, t_e) in (("served", (R, t)), ("gt_near", (R_near, t_near))):
        path = str(Path(root) / f"{label}.csv")
        kernels.nn_min_dist.launches = 0
        kernels.rasterize_xyz.launches = 0
        save_bop_results(path, bop_rows(split["keys"], split["classes"], R_e, t_e))
        results = load_bop_results(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = score(cfg, results, split["records"], split["models"], DEV)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.nn_min_dist.launches, kernels.rasterize_xyz.launches
        if label == "served":
            served_launches = launches[1]
        if min(launches) < 1:
            raise AssertionError(f"bop_score {label}: launches nn_min_dist {launches[0]}, "
                                 f"rasterize_xyz {launches[1]}; both must be > 0")
        ar = bop_score.bop19_average_recall(scores)
        if not all(np.isfinite(scores[k]["avg"]) for k in types) or not 0.0 <= ar <= 1.0:
            raise AssertionError(f"bop_score {label}: bad recalls {scores}")
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            score(cfg, results, split["records"], split["models"], DEV)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        log("bop_score", csv=label, error_types=cfg.VAL.ERROR_TYPES, n_top=cfg.VAL.N_TOP,
            estimates=len(results), gt=len(split["records"]), first_ms=f"{first_ms:.1f}",
            warm_ms_median=f"{np.median(warm):.1f}", warm_n=len(warm),
            launches_nn_min_dist=launches[0], launches_rasterize_xyz=launches[1],
            **{f"ar_{k}": f"{scores[k]['avg']:.4f}" for k in types}, ar_bop19=f"{ar:.4f}")
        by_type = {}
        for etype in types:  # each error type alone, warm
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                score(cfg, results, split["records"], split["models"], DEV, etype)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            by_type[etype] = f"{np.median(ms):.1f}"
        log("bop_score_by_type", csv=label, warm_ms_median=json.dumps(by_type).replace(" ", ""))
        compare_with_plain(cfg, results, split, label)
        scored.append((label, results))
    return served_launches, scored


def phase_profile(cfg, split, scored: list, timed: list) -> None:
    """The measurements that need torch.profiler, made last, so that no
    host-bound phase is timed after a profiler session (whether a session
    slows later launches is measured by scripts/probe_torch_zbuffer.py):
    rasterize_xyz's launches and its kernels' device ms per call at the
    timed shapes, then the device ms of one warm score_results call of each
    CSV, all of it and each kernel's share."""
    check_raster_launches(timed[0][1], timed[0][2])
    for label, args, hw in timed:
        device = profiled_device_ms(lambda: kernels.rasterize_xyz(*args, hw, hw), 20,
                                    ("", "face_setup_kernel", "zbuffer_kernel"))
        log("rasterize_xyz_device", shape=label, calls=20, **(
            {"device_ms_per_call": "not measured"} if device is None else {
                "device_ms_per_call": f"{device['']:.4f}",
                "setup_ms": f"{device['face_setup_kernel']:.4f}",
                "zbuffer_ms": f"{device['zbuffer_kernel']:.4f}"}))
    for label, results in scored:
        prof = profiled_device_ms(
            lambda: score(cfg, results, split["records"], split["models"], DEV), 1,
            ("", "face_setup_kernel", "zbuffer_kernel", "nn_min_dist_kernel", "Memcpy"))
        log("bop_score_device", csv=label, **(
            {"device_ms": "not measured"} if prof is None else {
                "device_ms": f"{prof['']:.3f}", "memcpy_ms": f"{prof['Memcpy']:.3f}",
                "rasterize_xyz_ms": f"{prof['face_setup_kernel'] + prof['zbuffer_kernel']:.3f}",
                "nn_min_dist_ms": f"{prof['nn_min_dist_kernel']:.3f}"}))


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

    # 2-3. kernel builds, correctness and time
    phase_build()
    nn_stats = phase_kernel()
    gsd = mesh_tools()
    raster_stats, raster_timed = phase_raster(gsd)

    # 4a. flagship forward in f32 on the GPU against the CPU
    cfg = merged_config(FLAGSHIP)
    cfg32 = merged_config(FLAGSHIP)
    cfg32.PARALLEL.DTYPE = "float32"
    ref_model = init_weights(build_model(cfg32, device="cpu"), torch.Generator().manual_seed(0))
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
    kernels.rasterize_xyz.launches = 0
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

    # 7. the flagship's BOP scoring of the served poses (engine/tester.py:315-332),
    # 8. then the profiled measurements
    with tempfile.TemporaryDirectory() as root:
        split = phase_bop_split(cfg, gsd, requests, root)
        raster_launches, scored = phase_bop_score(cfg, split, R, t, root)
        phase_profile(cfg, split, scored, raster_timed)

    print(json.dumps({"kernels": [
        {"name": "nn_min_dist", "route": "cuda",
         "source": "gdrnet_tpu_torch/csrc/nn_min_dist.cu",
         "replaces": "gdrnet_tpu/ops/pallas_kernels.py:28",
         "launches": launches, **nn_stats},
        {"name": "rasterize_xyz", "route": "cuda",
         "source": "gdrnet_tpu_torch/csrc/rasterize_xyz.cu",
         "replaces": "gdrnet_tpu/ops/pallas_kernels.py:140",
         "launches": raster_launches, **raster_stats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
