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
BOP-layout test split of the dataset's ten meshes (the mesh_zoo of
gdrnet_tpu_torch/tools/gen_scale_dataset.py) that this script writes; VSD's depth renders go through the
hand-written CUDA z-buffer kernels (gdrnet_tpu_torch/csrc/rasterize_xyz.cu:
the face setup on the device, then the z-buffer with per-tile face culling).
Then the flagship's train step (engine/steps.make_train_step: the GDR-Net
losses, Ranger with flat_and_anneal, bf16 autocast) runs at
SOLVER.IMS_PER_BATCH=128 on synthetic batches, and then the flagship trains
as a researcher runs it: engine/trainer.do_train from a BOP train split of
the ten meshes on disk, whose XYZ ground truth the loader threads render
with the z-buffer kernel on their own CUDA streams, with a checkpoint and a
resume. Last, the rendering slice: the z-buffer kernel with the 12 per-pose
attribute channels of the Phong + XYZ pass, the renders on the card against
the CPU, and the flagship's synth dataset written by the port's generator
(python -m gdrnet_tpu_torch.tools.gen_scale_dataset) as a user runs it.

Phases, one line each (or one per case): device, kernel builds (both nvcc
runs at once), nn_min_dist against its plain PyTorch version and cKDTree,
timed beside its bound and torch.cdist; rasterize_xyz against its plain
version (20 cases), and its time beside its bounds and the share of
pixel-face pairs it culls; f32 forward on the GPU against the CPU, bf16
serving, CustomEvaluator scoring (kernel against the plain version),
throughput, the BOP split, BOP scoring on the card and against the plain
versions on the CPU; the train step (one f32 step on the card against the
CPU, 30 bf16 steps, a skipped NaN step, its time per step and split); the
train loop (the mapper on the card against the CPU, the loader alone,
do_train to a checkpoint, the resumed state against it, do_train resumed,
with its step, data and loader times and B2's launches a step); the test
path ([do_test], [do_test_vs_cpu], [cli]) and the learning check
([overfit]); the rendering slice: [render_attr] (B2 at C = 12 against its
plain version, bitwise, over 15 cases, and its time at the generator's
shapes beside its bounds), [render_phong_xyz] (render_phong_xyz_roi_many,
Renderer and SceneRenderer on the card against the CPU), [gen_dataset]
(the generator's CLI on the card: wall s, images/s, its time by stage, B2's
launches a chunk; the split resolves, maps from its pickles without a
render, and agrees with the same scene written on the CPU); last, what
torch.profiler measures (rasterize_xyz's launches per call and its
kernels' device time, the device time of a BOP scoring call, the train
step's busy share, top device operations and Ranger's launches), so that no
host-bound phase is timed after a profiler session. Any failure raises; the exit code is then non-zero and the result
line is not printed. The last line is
{"ok": true, "device": {...}}; the line before it holds the kernels'
launches, errors, times and bounds.

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and scipy.
"""

from __future__ import annotations

import json
import pickle
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gdrnet_tpu_torch import (
    base_config,
    build_lr_schedule,
    build_optimizer,
    create_train_state,
    csrc,
    make_train_step,
    merged_config,
)
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts, load_detections
from gdrnet_tpu_torch.data.dataset_factory import resolve
from gdrnet_tpu_torch.data.io import read_png, write_png
from gdrnet_tpu_torch.data.mapper import GDRNTestMapper, GDRNTrainMapper, collate
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.data.ply import save_ply
from gdrnet_tpu_torch.data.scene_renderer import SceneRenderer
from gdrnet_tpu_torch.data.synthetic import (
    edge_on_poses,
    poses_near,
    sliver_mesh,
    synthetic_object_models,
    synthetic_roi_batch,
    write_bop_split,
)
from gdrnet_tpu_torch.engine import build_test_items, do_test, steps
from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager, load_weights
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.engine.trainer import build_input_pipeline, build_train_objects, do_train
from gdrnet_tpu_torch.eval import bop_score
from gdrnet_tpu_torch.eval import pose_errors as PE
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results, save_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator
from gdrnet_tpu_torch.eval.renderer import create_renderer
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.ops import kernels
from gdrnet_tpu_torch.ops.rasterizer import render_phong_xyz_roi_many, vertex_normals
from gdrnet_tpu_torch.ops.symmetry import get_closest_rot_batch, identity_padded_sym_arrays

REPO = Path(__file__).resolve().parent
DEV = "cuda"  # device of the rasterize_xyz, BOP and train phases
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
# the train step: the flagship's schedule over its run's length (160 epochs at
# IMS_PER_BATCH=128, 14,880 updates, SCALE_RUN.md:41); one f32 step on the
# card against the CPU at TRAIN_F32_BATCH; TRAIN_STEPS bf16 steps at
# SOLVER.IMS_PER_BATCH; TRAIN_TIMED steps timed after TRAIN_WARMUP
TRAIN_TOTAL_ITERS, TRAIN_F32_BATCH, TRAIN_STEPS = 14880, 8, 30
TRAIN_TIMED, TRAIN_WARMUP, TRAIN_BATCHES = 20, 3, (64, 128)
# f32, card (TF32 off) against CPU: loss terms and BN buffers; gradients by
# their relative L2 error per tensor and over all of them, since a ReLU unit
# within rounding of 0 routes its gradient differently in the two runs
# (tests/test_torch_train.py measures the same against the JAX package)
TRAIN_LOSS_RTOL, TRAIN_BN_RTOL, TRAIN_BN_ATOL = 1e-3, 1e-3, 1e-5
TRAIN_GRAD_TENSOR_REL, TRAIN_GRAD_ALL_REL = 0.15, 0.08
# the train loop: a BOP train split of the 10 zoo meshes, LOOP_SCENES x
# LOOP_IMAGES images x LOOP_PER_IMAGE instances at 640x480 without xyz_crop
# pickles; do_train to LOOP_SAVE iterations, then resumed to LOOP_ITERS;
# the loader alone over LOOP_LOADER_BATCHES batches; LOOP_MAPPED records
# mapped on the card against the CPU
LOOP_SCENES, LOOP_IMAGES, LOOP_PER_IMAGE = 4, 16, 8
LOOP_SAVE, LOOP_ITERS, LOOP_WORKERS = 12, 30, 4
LOOP_LOADER_BATCHES, LOOP_MAPPED = 8, 16
# the test path: est_dets.json from the BOP split's visible GT boxes jittered by
# up to DET_JITTER_PX, every DET_DROP_EVERY-th instance without a detection,
# every DET_SECOND_EVERY-th with a lower-scored second one; scene 1 in f32 on
# the card against the CPU: rotations within DO_TEST_ROT_ATOL, translations
# within DO_TEST_TRANS_RTOL of their norm (the forward's tolerance above)
DET_JITTER_PX, DET_DROP_EVERY, DET_SECOND_EVERY = 4, 16, 10
DO_TEST_ROT_ATOL, DO_TEST_TRANS_RTOL, CLI_TIMEOUT_S = 1e-3, 1e-3, 300
# the learning check (tools/validate_overfit.py): OVERFIT_STEPS updates on one
# batch of the 2-object split, then do_test; loose gates, the TPU tool's
# docstring expects about 2 degrees
OVERFIT_IMAGES, OVERFIT_STEPS, OVERFIT_SEEDS = 6, 800, (0, 1, 2)
OVERFIT_LOSS_RATIO, OVERFIT_MAX_RE_DEG = 0.2, 10.0
OVERFIT_K = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
# the rendering slice: B2 with the generator's 12 attribute channels, timed at
# its two shapes (label: (z range of the tower, window, plain-version calls));
# the renders on the card against the CPU, rgb within 1 grey level at no more
# than RENDER_FLIP_SHARE of the hit pixels; the generator's CLI at the synth
# dataset's width, GEN_TRAIN + GEN_TEST images of GEN_PER_SCENE a scene, its
# train mapper over GEN_MAPPED records, GEN_CPU_IMAGES compared with the CPU
RENDER_ATTR_CHANNELS = 12
RENDER_ATTR_TIMED = {"32x128x128x12/tower_448": ((0.5, 0.9), 128, 5),
                     "32x512x512x12/tower_448": ((0.15, 0.22), 512, 2)}
RENDER_FLIP_SHARE = 0.01
GEN_TRAIN, GEN_TEST, GEN_PER_SCENE, GEN_MAPPED, GEN_CPU_IMAGES = 64, 32, 32, 16, 4
GEN_TIMEOUT_S = 300
# device kernels of a train step by kind, from marks in their names
TRAIN_OP_KINDS = (
    ("conv_and_matmul", ("xmma", "gemm", "conv", "cudnn", "cutlass", "sm90_")),
    ("batch_norm", ("batch_norm",)),
    ("group_norm", ("group_norm", "GroupNorm")),
    ("foreach", ("multi_tensor_apply", "foreach")),
    ("copy_and_cast", ("copy",)),
    ("upsample", ("upsample",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


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
    """The port's synth dataset generator (gdrnet_tpu_torch/tools/
    gen_scale_dataset.py): mesh_zoo, _subdivide, K_DEF and the frame size."""
    from gdrnet_tpu_torch.tools import gen_scale_dataset

    return gen_scale_dataset


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
    meta, keys = write_bop_split(root, zoo, classes, R_gt, t_gt, requests[0]["roi_cams"][0],
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


def phase_profile(cfg, split, scored: list, timed: list, train: tuple) -> None:
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
    profile_train(*train)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def train_batch(cfg, batch_size: int, seed: int) -> dict:
    """A flagship-shaped batch: 256^2 crops, 64^2 maps, 64 regions, 10
    classes, NUM_PM_POINTS model points."""
    net = cfg.MODEL.CDPN
    return synthetic_roi_batch(batch_size=batch_size, input_res=net.BACKBONE.INPUT_RES,
                               out_res=net.BACKBONE.OUTPUT_RES,
                               num_classes=net.ROT_HEAD.NUM_CLASSES,
                               num_points=net.PNP_NET.NUM_PM_POINTS,
                               num_regions=net.ROT_HEAD.NUM_REGIONS, seed=seed)


def train_setup(cfg, state_dict: dict, device: str):
    """The flagship's model, Ranger with its schedule, train state and step."""
    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    opt = build_optimizer(cfg, model, build_lr_schedule(
        cfg, cfg.SOLVER.OPTIMIZER_CFG["lr"], TRAIN_TOTAL_ITERS))
    return create_train_state(model, opt), make_train_step(cfg, model, opt)


def phase_train_f32(cfg32, state_dict: dict) -> None:
    """(a) One f32 step on the card against one on the CPU, same weights and
    batch: every loss term, the gradients, the updated parameters and the BN
    buffers."""
    batch = train_batch(cfg32, TRAIN_F32_BATCH, seed=200)
    runs = {}
    for device in (DEV, "cpu"):
        state, step = train_setup(cfg32, state_dict, device)
        t0 = time.perf_counter()
        _, metrics = step(state, to_device(batch, device), None)
        runs[device] = ({k: float(v) for k, v in metrics.items()},
                        {k: p.grad.cpu() for k, p in state.model.named_parameters()},
                        {k: v.cpu() for k, v in state.model.state_dict().items()},
                        time.perf_counter() - t0)
    (m_gpu, g_gpu, sd_gpu, _), (m_cpu, g_cpu, sd_cpu, cpu_s) = runs[DEV], runs["cpu"]
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=TRAIN_LOSS_RTOL, atol=1e-6, err_msg=k)
    loss_rel = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu)
    grad_rel = {k: rel_l2(g_gpu[k], g_cpu[k]) for k in g_cpu}
    worst = max(grad_rel, key=grad_rel.get)
    grad_all = rel_l2(torch.cat([g.flatten() for g in g_gpu.values()]),
                      torch.cat([g_cpu[k].flatten() for k in g_gpu]))
    if grad_rel[worst] > TRAIN_GRAD_TENSOR_REL or grad_all > TRAIN_GRAD_ALL_REL:
        raise AssertionError(f"train_f32: gradients card vs CPU: {worst} {grad_rel[worst]}, "
                             f"all {grad_all}")
    param_diff = max(float((sd_gpu[k] - sd_cpu[k]).abs().max()) for k in g_cpu)
    bn_diff = 0.0
    for k in sd_cpu:
        if k not in g_cpu:
            torch.testing.assert_close(sd_gpu[k], sd_cpu[k], rtol=TRAIN_BN_RTOL,
                                       atol=TRAIN_BN_ATOL, msg=k)
            bn_diff = max(bn_diff, float((sd_gpu[k] - sd_cpu[k]).abs().max()))
    log("train_f32", batch=TRAIN_F32_BATCH, vs="cpu", loss_terms=len(m_cpu) - 4,
        loss_max_rel=f"{loss_rel:.3e}", grad_all_rel_l2=f"{grad_all:.3e}",
        grad_worst_tensor=worst, grad_worst_rel_l2=f"{grad_rel[worst]:.3e}",
        param_max_abs=f"{param_diff:.3e}", bn_buffer_max_abs=f"{bn_diff:.3e}",
        cpu_step_s=f"{cpu_s:.1f}", check="ok")


def state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a train state: the model's state dict, then Ranger's
    per-parameter state in parameter order, then its shared counters."""
    opt = state.optimizer
    return (list(state.model.state_dict().values())
            + [t for p in opt._params for t in opt.state[p].values()]
            + list(opt.state["shared"].values()))


def train_snapshot(state) -> list[torch.Tensor]:
    return [t.clone() for t in state_tensors(state)]


def phase_train(cfg, state_dict: dict, card: str) -> tuple:
    """(b) TRAIN_STEPS bf16 steps at IMS_PER_BATCH with the flagship's
    schedule: every metric finite, nothing skipped. (c) A NaN in roi_img:
    the step is skipped and the parameters, the optimizer state and the BN
    buffers are bitwise unchanged. (d) ms per step, ROIs/s, the split into
    forward, loss, backward and optimizer, and peak memory at each of
    TRAIN_BATCHES, each time with `card` (name, power limit) beside it.
    Returns what the profiled run needs."""
    bs = cfg.SOLVER.IMS_PER_BATCH
    state, step = train_setup(cfg, state_dict, DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    batch = to_device(train_batch(cfg, bs, seed=300), DEV)
    kernels.nn_min_dist.launches = 0
    kernels.rasterize_xyz.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = [step(state, batch, gen)[1] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    hist = {k: torch.stack([h[k] for h in history]).cpu().numpy() for k in history[0]}
    if not all(np.all(np.isfinite(v)) for v in hist.values()) or hist["nonfinite_skip"].any():
        raise AssertionError(f"train_bf16: non-finite metrics or skipped steps: {hist}")
    log("train_bf16", batch=bs, steps=TRAIN_STEPS, schedule="flat_and_anneal",
        total_iters=TRAIN_TOTAL_ITERS, lr_last=f"{state.optimizer.lr(TRAIN_STEPS - 1):.3e}",
        total_loss_first=f"{hist['total_loss'][0]:.4f}",
        total_loss_last=f"{hist['total_loss'][-1]:.4f}",
        loss_terms=",".join(k for k in hist if k.startswith("loss_")),
        skipped=int(hist["nonfinite_skip"].sum()), wall_s=f"{wall_s:.2f}",
        launches_nn_min_dist=kernels.nn_min_dist.launches,
        launches_rasterize_xyz=kernels.rasterize_xyz.launches, check="ok")

    bad = dict(batch, roi_img=batch["roi_img"].clone())
    bad["roi_img"][3, 10, 20, 1] = float("nan")
    before = train_snapshot(state)
    _, m_bad = step(state, bad, gen)
    unchanged = all(torch.equal(a, b) for a, b in zip(before, train_snapshot(state)))
    _, m_next = step(state, batch, gen)
    if not (float(m_bad["nonfinite_skip"]) == 1.0 and unchanged
            and float(m_next["nonfinite_skip"]) == 0.0 and np.isfinite(float(m_next["total_loss"]))):
        # the gradients of the clean step are still on the parameters
        bad_grads = [n for n, p in state.model.named_parameters()
                     if p.grad is not None and not torch.isfinite(p.grad).all()]
        raise AssertionError(f"train_skip: skip {float(m_bad['nonfinite_skip'])}, state "
                             f"unchanged {unchanged}, next {float(m_next['total_loss'])} with "
                             f"{len(bad_grads)} non-finite gradients {bad_grads[:6]}")
    log("train_skip", nan_in="roi_img", nonfinite_skip=1, state_tensors=len(before),
        bitwise_unchanged=True, next_step_total_loss=f"{float(m_next['total_loss']):.4f}",
        check="ok")

    for b in TRAIN_BATCHES:
        data = batch if b == bs else to_device(train_batch(cfg, b, seed=301), DEV)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_times(lambda: step(state, data, gen), TRAIN_TIMED, TRAIN_WARMUP)
        split = train_split(state, step, data, gen)
        log("train_time", card=repr(card), batch=b, steps=len(ms),
            median_ms=f"{np.median(ms):.3f}",
            max_ms=f"{ms.max():.3f}", rois_per_s=f"{b / np.median(ms) * 1e3:.1f}",
            **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()},
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return state, step, batch, gen, card


def train_split(state, step, batch, gen) -> dict:
    """Median device ms of each part of a train step, from CUDA events that
    hooks record at the model's forward, after gdrn_loss, and around the
    optimizer's step."""
    marks: dict[str, list] = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.setdefault(name, []).append(ev)

    plain_loss = steps.gdrn_loss

    def loss_then_mark(*args, **kwargs):
        out = plain_loss(*args, **kwargs)
        mark("loss")
        return out

    hooks = [state.model.register_forward_pre_hook(lambda *a: mark("forward")),
             state.model.register_forward_hook(lambda *a: mark("forward_end")),
             state.optimizer.register_step_pre_hook(lambda *a: mark("optimizer")),
             state.optimizer.register_step_post_hook(lambda *a: mark("optimizer_end"))]
    steps.gdrn_loss = loss_then_mark
    try:
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            mark("start")
            step(state, batch, gen)
            mark("end")
    finally:
        steps.gdrn_loss = plain_loss
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    parts = {"prologue": ("start", "forward"), "forward": ("forward", "forward_end"),
             "loss": ("forward_end", "loss"), "backward": ("loss", "optimizer"),
             "optimizer": ("optimizer", "optimizer_end"), "epilogue": ("optimizer_end", "end"),
             "step": ("start", "end")}
    return {name: float(np.median([a.elapsed_time(b) for a, b in
                                   zip(marks[s][TRAIN_WARMUP:], marks[e][TRAIN_WARMUP:])]))
            for name, (s, e) in parts.items()}


def device_spans(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of each device activity a profile saw, without
    the user annotations the profiler mirrors onto the device."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_train(state, step, batch, gen, card: str, n_steps: int = 5) -> None:
    """A profiled run of n_steps train steps: the device's busy share of the
    host-clock window (profiler on) and the top device operations; then one
    optimizer step alone, for Ranger's launches and device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    step(state, batch, gen)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(device_spans(prof), key=lambda s: s[1])
    if not spans:
        log("train_profile", device_busy="not measured (no device events)")
        return
    busy, end = 0.0, -1.0
    for _, a, b in spans:  # the union of the device's busy intervals
        busy += max(b, end) - max(a, end) if b > end else 0.0
        end = max(end, b)
    by_name: dict[str, float] = {}
    for name, a, b in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log("train_profile", card=repr(card), batch=len(batch["roi_img"]), steps=n_steps,
        window_ms_per_step=f"{window_ms / n_steps:.3f}",
        device_busy_ms_per_step=f"{busy / 1e3 / n_steps:.3f}",
        device_busy_share=f"{busy / 1e3 / window_ms:.3f}", device_ops=len(spans) // n_steps)
    print("[train_top_ops] " + json.dumps(
        [{"name": n[:80], "ms_per_step": round(us / 1e3 / n_steps, 4),
          "share": round(us / sum(by_name.values()), 4)} for n, us in top]), flush=True)
    by_kind: dict[str, float] = {}
    for name, us in by_name.items():  # the first kind whose marks the name holds
        kind = next((k for k, marks in TRAIN_OP_KINDS if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    print("[train_device_by_kind] " + json.dumps(
        {k: round(us / 1e3 / n_steps, 3) for k, us in sorted(by_kind.items(),
                                                            key=lambda kv: -kv[1])}), flush=True)
    with torch.profiler.profile(activities=acts) as prof:
        state.optimizer.step()
        torch.cuda.synchronize()
    ranger = device_spans(prof)
    log("train_ranger", card=repr(card), params=len(state.optimizer._params),
        launches_per_step=len(ranger) if ranger else "not measured",
        device_ms=f"{sum(b - a for _, a, b in ranger) / 1e3:.3f}" if ranger else "not measured")



def train_split_poses(n: int, K: np.ndarray, width: int, height: int, seed: int):
    """n instances for the train split: zoo classes, random rotations, and
    centres on a 4 x 2 grid of the frame per image (jittered), 0.5-0.9 m
    away, so that most of each object shows."""
    rng = np.random.RandomState(seed)
    p = synthetic_roi_batch(batch_size=n, input_res=8, out_res=4, num_classes=len(OBJECTS),
                            seed=seed)
    cell = np.arange(n) % LOOP_PER_IMAGE
    u = (cell % 4 + 0.5 + rng.uniform(-0.25, 0.25, n)) * width / 4
    v = (cell // 4 + 0.5 + rng.uniform(-0.25, 0.25, n)) * height / 2
    z = rng.uniform(0.5, 0.9, n)
    t = np.stack([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1], z], 1)
    return p["roi_classes"], p["gt_ego_rot"], t.astype(np.float32)


def loop_cfg(root: str, weights: str):
    """The flagship config as a researcher would train it on the split."""
    c = merged_config(FLAGSHIP)
    c.OUTPUT_DIR = str(Path(root) / "train_out")
    c.SEED = 0
    c.MODEL.WEIGHTS = weights
    c.DATASETS.TRAIN = ("loop_train",)
    c.DATALOADER.NUM_WORKERS = LOOP_WORKERS
    c.TRAIN.PRINT_FREQ = 1  # log every step's loss
    c.SOLVER.CHECKPOINT_PERIOD = LOOP_SAVE
    c.SOLVER.CHECKPOINT_BY_EPOCH = False
    return c


def check_card_mapper(cfg, root: str) -> None:
    """(b) LOOP_MAPPED records mapped with the kernel on the card equal the
    same records mapped with the plain rasterizer on the CPU, same seeds:
    every array bit for bit (so the hit masks too)."""
    _, records, _, models, mapper = build_train_objects(cfg, root, DEV)
    np.random.seed(0)  # GaussianBlur(1.2*np.random.rand()) draws when a mapper is built
    card = GDRNTrainMapper(cfg, models, bg_replacer=mapper.bg, device=DEV)
    np.random.seed(0)
    cpu = GDRNTrainMapper(cfg, models, bg_replacer=mapper.bg, device="cpu")
    for i, rec in enumerate(records[::max(1, len(records) // LOOP_MAPPED)][:LOOP_MAPPED]):
        got, want = card(dict(rec), np.random.RandomState(i)), cpu(dict(rec), np.random.RandomState(i))
        for k in want:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"train_loop: record {i} {k} card vs CPU differ by "
                                     f"{np.abs(got[k].astype(np.float64) - want[k]).max()}")
    log("train_loop_mapper", records=LOOP_MAPPED, vs="cpu", arrays=len(want), bitwise_equal=True,
        check="ok")


def time_loader(cfg, root: str) -> float:
    """Samples/s of the loader alone (NUM_WORKERS threads, renders on the
    card), over LOOP_LOADER_BATCHES batches after a first one."""
    _, records, records2, _, mapper = build_train_objects(cfg, root, DEV)
    loader, _ = build_input_pipeline(cfg, records, records2, mapper, seed=1, device=DEV)
    it = iter(loader)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(LOOP_LOADER_BATCHES):
            next(it)
        return LOOP_LOADER_BATCHES * cfg.SOLVER.IMS_PER_BATCH / (time.perf_counter() - t0)
    finally:
        it.close()


def phase_train_loop(cfg, state_dict: dict, gsd, root: str, card: str) -> int:
    """The flagship trained by engine/trainer.do_train from a BOP train split
    on disk: (a) every logged loss finite and no step skipped, (b) the
    mapper on the card against the CPU, (c) the state resumed from the
    checkpoint at LOOP_SAVE bitwise equal to the saved one, (d) B2 launched
    at least once per sample mapped. Returns B2's launches in the loop."""
    n = LOOP_SCENES * LOOP_IMAGES * LOOP_PER_IMAGE
    K = gsd.K_DEF.astype(np.float32)
    classes, R, t = train_split_poses(n, K, gsd.W_DEF, gsd.H_DEF, seed=400)
    t0 = time.perf_counter()
    write_bop_split(str(Path(root) / "loop"), gsd.mesh_zoo(), classes, R, t, K, gsd.W_DEF,
                    gsd.H_DEF, LOOP_PER_IMAGE, LOOP_IMAGES, device=DEV, split="train")
    weights = str(Path(root) / "flagship_seed0.pth")
    torch.save({"model": state_dict}, weights)
    c = loop_cfg(root, weights)
    log("train_loop_split", scenes=LOOP_SCENES, images=LOOP_SCENES * LOOP_IMAGES,
        instances=n, size=f"{gsd.W_DEF}x{gsd.H_DEF}", xyz_crop_pickles=0,
        write_s=f"{time.perf_counter() - t0:.2f}")
    check_card_mapper(c, root)
    loader_rate = time_loader(c, root)

    # the main path: do_train to LOOP_SAVE, then resumed to LOOP_ITERS
    kernels.nn_min_dist.launches = 0
    kernels.rasterize_xyz.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    saved, _, preempted = do_train(c, data_root=root, max_iters_override=LOOP_SAVE, device=DEV)
    run_a_s = time.perf_counter() - t0
    launches_a = kernels.rasterize_xyz.launches
    if preempted or saved.step != LOOP_SAVE:
        raise AssertionError(f"train_loop: first run ended at {saved.step}, preempted {preempted}")
    # (c) a fresh model and optimizer resumed from the checkpoint
    fresh = build_model(c, device=DEV)
    fresh_opt = build_optimizer(c, fresh, build_lr_schedule(c, c.SOLVER.OPTIMIZER_CFG["lr"], 30))
    resumed, start = CheckpointManager(str(Path(c.OUTPUT_DIR) / "ckpt")).resume_or_load(
        create_train_state(fresh, fresh_opt), resume=True)
    a, b = state_tensors(saved), state_tensors(resumed)
    if start != LOOP_SAVE or len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"train_loop: resumed at {start}, state not bitwise equal")
    del saved, resumed, fresh, fresh_opt, a, b
    t0 = time.perf_counter()
    state, _, preempted = do_train(c, resume=True, data_root=root, max_iters_override=LOOP_ITERS,
                                   device=DEV)
    torch.cuda.synchronize()
    run_b_s = time.perf_counter() - t0
    launches = kernels.rasterize_xyz.launches
    if preempted or state.step != LOOP_ITERS:
        raise AssertionError(f"train_loop: resumed run ended at {state.step}")

    with open(Path(c.OUTPUT_DIR) / "metrics.json") as f:
        rows = [json.loads(ln) for ln in f]
    losses = np.array([r["total_loss"] for r in rows])
    skips = np.array([r["nonfinite_skip"] for r in rows])
    if [r["iteration"] for r in rows] != list(range(LOOP_ITERS)) or not np.all(
            np.isfinite(losses)) or skips.any():
        raise AssertionError(f"train_loop: iterations {[r['iteration'] for r in rows]}, "
                             f"losses {losses.tolist()}, skips {skips.tolist()}")
    steady = rows[1:]  # the first step includes the warm-up of every PyTorch kernel
    step_ms = np.array([r["time/step"] for r in steady]) * 1e3
    data_ms = np.array([r["time/data"] for r in steady]) * 1e3
    samples = LOOP_ITERS * c.SOLVER.IMS_PER_BATCH
    if launches < samples or kernels.nn_min_dist.launches:
        raise AssertionError(f"train_loop: rasterize_xyz launched {launches} times for "
                             f"{samples} samples, nn_min_dist {kernels.nn_min_dist.launches}")
    log("train_loop", card=repr(card), batch=c.SOLVER.IMS_PER_BATCH, workers=LOOP_WORKERS,
        iterations=LOOP_ITERS, resumed_at=start, state_tensors=len(state_tensors(state)),
        resumed_bitwise_equal=True, losses_finite=True, skipped=int(skips.sum()),
        total_loss_first=f"{losses[0]:.4f}", total_loss_last=f"{losses[-1]:.4f}",
        step_ms_median=f"{np.median(step_ms):.1f}", data_ms_median=f"{np.median(data_ms):.1f}",
        data_share=f"{data_ms.sum() / step_ms.sum():.3f}",
        rois_per_s=f"{c.SOLVER.IMS_PER_BATCH / np.median(step_ms) * 1e3:.1f}",
        loader_samples_per_s=f"{loader_rate:.1f}",
        launches_rasterize_xyz=launches, launches_per_step=f"{launches / LOOP_ITERS:.1f}",
        launches_run1=launches_a, wall_s=f"{run_a_s:.1f}+{run_b_s:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", check="ok")
    return launches


def write_detections(split, path: str, seed: int = 5) -> dict:
    """est_dets.json for the BOP split, from each visible GT instance's
    bbox_visib: boxes jittered by up to DET_JITTER_PX, scores from a seed;
    every DET_DROP_EVERY-th instance gets no detection, every
    DET_SECOND_EVERY-th a second one, shifted and scored lower, that
    DET_TOPK_PER_OBJ=1 filters out. Returns what do_test must find: the
    detections kept, the GT instances left without one (dropped, or a
    duplicate of an object beyond the image's top-1) and the images."""
    rng = np.random.RandomState(seed)
    body: dict = {}
    dets_by_group: dict = defaultdict(int)
    gt_by_group: dict = defaultdict(int)
    dropped = 0
    for i, r in enumerate(split["records"]):
        group = (r["scene_id"], r["im_id"], r["obj_id"])
        gt_by_group[group] += 1
        if i % DET_DROP_EVERY == DET_DROP_EVERY - 1:
            dropped += 1
            continue
        box = np.asarray(r["bbox_visib"], np.float64) + rng.randint(
            -DET_JITTER_PX, DET_JITTER_PX + 1, 4)
        score = float(rng.uniform(0.5, 1.0))
        dets = body.setdefault(f"{r['scene_id']}/{r['im_id']}", [])
        dets.append({"obj_id": int(r["obj_id"]), "bbox_est": box.tolist(), "score": score,
                     "time": 0.0})
        dets_by_group[group] += 1
        if i % DET_SECOND_EVERY == 0:
            dets.append({"obj_id": int(r["obj_id"]), "bbox_est": (box + [12, -9, 6, 4]).tolist(),
                         "score": score - 0.45, "time": 0.0})
    with open(path, "w") as f:
        json.dump(body, f)
    kept = sum(min(1, n) for n in dets_by_group.values())
    missing = sum(n - min(1, dets_by_group[g]) for g, n in gt_by_group.items())
    return {"path": path, "kept": kept, "missing": missing, "dropped": dropped,
            "images": len({g[:2] for g in dets_by_group}),
            "written": sum(len(v) for v in body.values())}


def test_cfg(cfg, dets: dict):
    """The flagship's test settings (est detections with top-1 per object,
    VAL.USE_BOP over its ERROR_TYPES, ROI_BATCH_SIZE) on the smoke's files."""
    c = merged_config(FLAGSHIP)
    c.PARALLEL.DTYPE = cfg.PARALLEL.DTYPE
    c.DATASETS.DET_FILES_TEST = (dets["path"],)
    return c


def flat_entries(cfg, records) -> list:
    """do_test's flat (rgb_path, K, det) stream, in its order."""
    dets = load_detections(cfg.DATASETS.DET_FILES_TEST[0], score_thr=cfg.DATASETS.DET_THR,
                           topk_per_obj=cfg.DATASETS.DET_TOPK_PER_OBJ)
    flat = []
    for rgb_path, K, rois, _ in build_test_items(records, dets, cfg.TEST.TEST_BBOX_TYPE):
        by_obj: dict = defaultdict(list)
        for det in rois:
            by_obj[int(det["obj_id"])].append(det)
        flat += [(rgb_path, K, det) for ds in by_obj.values() for det in ds]
    return flat


def pose_errors_of(R, t, gts, models, name: str) -> dict:
    """Every per-pair error a recall threshold is applied to, for poses R,
    t (m) against GT records gts of object `name`, on the CPU."""
    B = len(gts)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    R, t = f32(R), f32(t)
    Rg, tg = f32(np.stack([g["R"] for g in gts])), f32(np.stack([g["t"] for g in gts]))
    K, pts = f32(np.stack([g["K"] for g in gts])), f32(models.points[name])
    sym, mask = identity_padded_sym_arrays(models.sym_rots.get(name), B)
    sym, mask = f32(sym), torch.from_numpy(mask)
    closest = get_closest_rot_batch(R, Rg, sym, mask)
    is_sym = models.sym_rots.get(name) is not None
    e = {"re": PE.re_batch(R, Rg), "re_sym": PE.re_batch(R, closest), "te": PE.te_batch(t, tg),
         "proj": PE.proj_batch(R, t, Rg, tg, K, pts),
         "proj_sym": PE.proj_batch(R, t, closest, tg, K, pts),
         "ad": (PE.adi_batch if is_sym else PE.add_batch)(R, t, Rg, tg, pts),
         "mssd": PE.mssd_batch(R, t, Rg, tg, pts, sym, mask),
         "mspd": PE.mspd_batch(R, t, Rg, tg, K, pts, sym, mask)}
    return {k: v.numpy() for k, v in e.items()}


def threshold_flips(cfg, rows_a: list, rows_b: list, records: list, models) -> dict:
    """Two pose sets of the same detections (BOP rows in one order, t in
    mm): by error kind, the (pair, threshold) cases where the pair's error
    lies on opposite sides of a recall threshold in the two sets, over the
    pairings of both scorers (the first GT of its (image, object) key, as
    bop_score with N_TOP=1; the GT nearest in translation, as do_test's
    matching). What may make two runs' recalls differ although every pose
    agrees within its tolerance."""
    gts: dict = defaultdict(list)
    for g in records:
        gts[(g["scene_id"], g["im_id"], g["obj_id"])].append(g)
    by_obj: dict = defaultdict(lambda: ([], [], []))
    for a, b in zip(rows_a, rows_b):
        if (a["scene_id"], a["im_id"], a["obj_id"]) != (b["scene_id"], b["im_id"], b["obj_id"]):
            raise AssertionError(f"threshold_flips: rows in other orders: {a} vs {b}")
        cands = gts.get((a["scene_id"], a["im_id"], a["obj_id"]), [])
        picked = {0} if cands else set()
        for row in (a, b):
            if cands:
                picked.add(int(np.argmin([np.linalg.norm(row["t"] / 1000.0 - g["t"])
                                          for g in cands])))
        lists = by_obj[models.meta.id2obj[a["obj_id"]]]
        for k in sorted(picked):
            lists[0].append(a)
            lists[1].append(b)
            lists[2].append(cands[k])
    flips: dict = defaultdict(int)
    ths = {"re": (2, 5, 10), "re_sym": (2, 5, 10), "te": (0.02, 0.05, 0.10), "proj": (2, 5, 10),
           "proj_sym": (2, 5, 10),
           "mspd": bop_score.BOP19_MSPD_THRESHOLDS * models.meta.width / 640.0}
    for name, (ra, rb, gs) in by_obj.items():
        dia = models.diameters[name]
        obj_ths = dict(ths, ad=(0.02 * dia, 0.05 * dia, 0.10 * dia),
                       mssd=bop_score.BOP19_MSSD_THRESHOLDS * dia)
        ea, eb = (pose_errors_of(np.stack([r["R"] for r in rows]),
                                 np.stack([r["t"] for r in rows]) / 1000.0, gs, models, name)
                  for rows in (ra, rb))
        for kind, th in obj_ths.items():
            th = np.asarray(th)
            flips[kind] += int(((ea[kind][:, None] < th) != (eb[kind][:, None] < th)).sum())
        delta = bop_score.VSD_DELTAS_MM.get(models.meta.name.split("_")[0],
                                            bop_score.VSD_DELTA_MM_DEFAULT)
        va, vb = (np.stack(bop_score._vsd_errors_by_obj(list(zip(rows, gs)), models, delta,
                                                        bop_score.BOP19_VSD_TAUS,
                                                        device=DEV)[name])
                  for rows in (ra, rb))
        ths_v = bop_score.BOP19_VSD_THRESHOLDS
        flips["vsd"] += int(((va[..., None] < ths_v) != (vb[..., None] < ths_v)).sum())
    return dict(flips)


# the error kinds behind each recall key of CustomEvaluator and each BOP error type
RECALL_KINDS = {"ad": ("ad",), "re": ("re", "re_sym"), "te": ("te",),
                "proj": ("proj", "proj_sym"), "rete": ("re", "re_sym", "te"),
                "mssd": ("mssd",), "mspd": ("mspd",), "vsd": ("vsd",)}


def recalls_differ(label: str, a: dict, b: dict, flips: dict | None) -> list:
    """The recall keys of CustomEvaluator and the `_bop` entries where two
    do_test results differ; raises unless each such difference has a
    threshold flip of its error kind (`flips`; None allows none)."""
    differ = [("eval", name, k) for name in a if not name.startswith("_")
              for k in RECALL_KEYS if a[name][k] != b[name][k]]
    differ += [("bop", etype, obj) for etype in a.get("_bop", {}) for obj in a["_bop"][etype]
               if a["_bop"][etype][obj] != b["_bop"][etype][obj]]
    for src, first, second in differ:
        kind = second.split("_")[0] if src == "eval" else first
        if not any((flips or {}).get(k, 0) for k in RECALL_KINDS[kind]):
            raise AssertionError(f"{label}: recalls differ at {(first, second)}: "
                                 f"{differ}, threshold flips {flips}")
    return differ


def csv_rows_check(rows: list, where: str) -> None:
    R = np.stack([r["R"] for r in rows])
    t = np.stack([r["t"] for r in rows])
    if not np.all(np.isfinite(t)):
        raise AssertionError(f"{where}: non-finite translations")
    check_rotations(R, where)


def phase_do_test(cfg, split, dets: dict, weights: str, root: str, card: str) -> tuple:
    """The flagship's test path on the card: engine/tester.do_test over the
    BOP split's estimated detections with the weights of [train_loop]'s
    checkpoint, bf16, ROI_BATCH_SIZE buckets, VAL.USE_BOP over the config's
    ERROR_TYPES. Gates: both kernels launched inside the call, every CSV row
    finite with a rotation, one row per kept detection, the missing count
    that of the GT instances left without a detection. Returns (its
    results, its CSV rows, B1 and B2 launches)."""
    c = test_cfg(cfg, dets)
    model = load_weights(build_model(c, device=DEV), weights)
    out = str(Path(root) / "test_out")
    torch.cuda.synchronize()
    kernels.nn_min_dist.launches = 0
    kernels.rasterize_xyz.launches = 0
    t0 = time.perf_counter()
    res = do_test(c, model, split["models"], split["records"], output_dir=out, device=DEV)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.nn_min_dist.launches, kernels.rasterize_xyz.launches
    if min(launches) < 1:
        raise AssertionError(f"do_test: launches nn_min_dist {launches[0]}, rasterize_xyz "
                             f"{launches[1]}; both must be > 0")
    rows = load_bop_results(res["_csv_path"])
    csv_rows_check(rows, "do_test")
    n_missing = sum(r.get("n_missing", 0) for n, r in res.items()
                    if not n.startswith("_") and n != "Avg")
    if len(rows) != dets["kept"] or n_missing != dets["missing"]:
        raise AssertionError(f"do_test: {len(rows)} CSV rows for {dets['kept']} kept detections, "
                             f"{n_missing} missing for {dets['missing']}")
    # the host mapping alone over the same buckets
    flat = flat_entries(c, split["records"])
    mapper = GDRNTestMapper(c, split["models"], roi_batch_size=c.TEST.ROI_BATCH_SIZE)
    bs = c.TEST.ROI_BATCH_SIZE
    t0 = time.perf_counter()
    for s in range(0, len(flat), bs):
        mapper.map_flat(flat[s:s + bs])
    map_s = time.perf_counter() - t0
    ar = res["_bop_average_recall"]
    if not (np.isfinite(ar) and all(np.isfinite(res["_bop"][k]["avg"]) for k in res["_bop"])):
        raise AssertionError(f"do_test: bad BOP recalls {res['_bop']}")
    tm = res["_time"]
    log("do_test", card=repr(card), images=dets["images"], detections_written=dets["written"],
        detections_kept=len(flat), buckets=-(-len(flat) // bs), rois=len(flat),
        roi_batch=bs, dtype=c.PARALLEL.DTYPE, missing=n_missing, dropped=dets["dropped"],
        beyond_top1=n_missing - dets["dropped"],
        compute_s_per_bucket=f"{tm['compute_s_per_bucket']:.4f}",
        process_s_per_bucket=f"{tm['process_s_per_bucket']:.4f}",
        wall_s=f"{wall_s:.2f}", host_mapping_s=f"{map_s:.2f}",
        launches_nn_min_dist=launches[0], launches_rasterize_xyz=launches[1],
        ar_bop19=f"{ar:.4f}", avg_ad_10=f"{res['Avg']['ad_10']:.4f}",
        avg_mean_re=f"{res['Avg']['mean_re']:.3f}", csv_rows=len(rows), check="ok")
    return res, rows, launches


def phase_do_test_vs_cpu(cfg32, split, dets: dict, weights: str, root: str) -> None:
    """Scene 1 through do_test in f32 (TF32 off) on the card and on the CPU
    (the plain versions): CSV rotations within DO_TEST_ROT_ATOL and
    translations within DO_TEST_TRANS_RTOL; the evaluator's recalls and the
    BOP recalls equal except where a threshold flip explains them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    c = test_cfg(cfg32, dets)
    records = [r for r in split["records"] if r["scene_id"] == 1]
    runs = {}
    for device in (DEV, "cpu"):
        model = load_weights(build_model(c, device=device), weights)
        t0 = time.perf_counter()
        res = do_test(c, model, split["models"], records,
                      output_dir=str(Path(root) / f"test_vs_cpu_{device}"), device=device)
        runs[device] = res, load_bop_results(res["_csv_path"]), time.perf_counter() - t0
    (card, rows_c, _), (cpu, rows_p, cpu_s) = runs[DEV], runs["cpu"]
    R_c, R_p = (np.stack([r["R"] for r in rows]) for rows in (rows_c, rows_p))
    t_c, t_p = (np.stack([r["t"] for r in rows]) for rows in (rows_c, rows_p))
    rot_err = float(np.abs(R_c - R_p).max())
    trans_rel = float((np.linalg.norm(t_c - t_p, axis=1) / np.linalg.norm(t_p, axis=1)).max())
    if len(rows_c) != len(rows_p) or rot_err > DO_TEST_ROT_ATOL or trans_rel > DO_TEST_TRANS_RTOL:
        raise AssertionError(f"do_test_vs_cpu: {len(rows_c)} vs {len(rows_p)} rows, rotations "
                             f"differ by {rot_err}, translations by {trans_rel} relative")
    flips = threshold_flips(c, rows_c, rows_p, records, split["models"])
    differ = recalls_differ("do_test_vs_cpu", card, cpu, flips)
    log("do_test_vs_cpu", scene=1, gt=len(records), rows=len(rows_c), dtype="float32",
        rot_max_abs=f"{rot_err:.3e}", trans_max_rel=f"{trans_rel:.3e}",
        rot_atol=DO_TEST_ROT_ATOL, trans_rtol=DO_TEST_TRANS_RTOL,
        threshold_flips=json.dumps(flips).replace(" ", ""),
        recalls="equal" if not differ else f"differ at {len(differ)} (flips)",
        cpu_s=f"{cpu_s:.1f}", check="ok")


def phase_cli(cfg, split, dets: dict, weights: str, root: str, in_process: tuple) -> None:
    """`python -m gdrnet_tpu_torch.engine.train --eval-only` on the card over
    the split as a dataset name (<dir>_test of a directory with meta.json),
    the detections and the checkpoint: exit code 0, results.json,
    config_dump.json and the CSV written, recalls equal to [do_test]'s."""
    split_dir = Path(split["models"].meta.data_root)
    out = Path(root) / "cli_out"
    cmd = [sys.executable, "-m", "gdrnet_tpu_torch.engine.train", "--config-file", FLAGSHIP,
           "--eval-only", "--data-root", str(split_dir.parent),
           f"DATASETS.TEST=({split_dir.name + '_test'!r},)",
           f"DATASETS.DET_FILES_TEST=({dets['path']!r},)", f"MODEL.WEIGHTS={weights!r}",
           f"OUTPUT_DIR={str(out)!r}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    with open(out / "results.json") as f:
        res = json.load(f)
    missing = [p for p in (out / "results.json", out / "config_dump.json",
                           Path(res["_csv_path"])) if not p.is_file()]
    if missing:
        raise AssertionError(f"cli: missing {missing}")
    want, want_rows, _ = in_process
    rows = load_bop_results(res["_csv_path"])
    flips = threshold_flips(cfg, rows, want_rows, split["records"], split["models"])
    differ = recalls_differ("cli", res, want, flips)
    log("cli", rc=proc.returncode, wall_s=f"{wall_s:.1f}", csv_rows=len(rows),
        files="results.json,config_dump.json,csv",
        ar_bop19=f"{res['_bop_average_recall']:.4f}",
        recalls_vs_do_test="equal" if not differ else f"differ at {len(differ)} (flips)",
        threshold_flips=json.dumps(flips).replace(" ", ""), check="ok")


def overfit_split(gsd, root: str):
    """The counterpart of tests/fixture_bop.py: the zoo's cube and brick
    (z-180 symmetric), OVERFIT_IMAGES images x 2 instances at 320x240 apart
    enough not to occlude each other, a test split with xyz_crop pickles,
    its frames painted as the fixture paints them (paint_like_fixture)."""
    rng = np.random.RandomState(42)
    n = 2 * OVERFIT_IMAGES
    p = synthetic_roi_batch(batch_size=n, input_res=8, out_res=4, num_classes=2, seed=42)
    t = np.stack([np.array([rng.uniform(-0.025, 0.025) + (-0.085 if i % 2 == 0 else 0.085),
                            rng.uniform(-0.03, 0.03), rng.uniform(0.45, 0.7)])
                  for i in range(n)]).astype(np.float32)
    meta, _ = write_bop_split(root, gsd.mesh_zoo()[:2], np.arange(n) % 2, p["gt_ego_rot"], t,
                              OVERFIT_K, width=320, height=240, per_image=2,
                              images_per_scene=OVERFIT_IMAGES, device=DEV, with_xyz_crop=True)
    paint_like_fixture(load_bop_scene_dicts(meta, "test"), 240, 320)
    return meta


def paint_like_fixture(records, height: int, width: int, seed: int = 0) -> None:
    """Repaint each frame as tests/fixture_bop.py paints its own: a noise
    background (60 + U[0, 40) a channel), each instance's visible pixels
    shaded by their object-frame z (100 + 120 z / max z, in the fixture's
    channel mix), so that a frame shows the object's orientation and not
    only its silhouette (write_bop_split paints one flat colour an object,
    and a flat box leaves flips beyond its declared symmetry unseen)."""
    rng = np.random.RandomState(seed)
    by_frame: dict = defaultdict(list)
    for r in records:
        by_frame[r["rgb_path"]].append(r)
    for path, recs in by_frame.items():
        bgr = (60 + rng.rand(height, width, 3) * 40).astype(np.uint8)
        for r in recs:
            with open(r["xyz_path"], "rb") as f:
                crop = pickle.load(f)
            x1, y1, x2, y2 = crop["xyxy"]
            z = np.zeros((height, width), np.float32)
            z[y1:y2 + 1, x1:x2 + 1] = np.asarray(crop["xyz_crop"], np.float32)[..., 2]
            shade = 100 + 120 * (z / max(float(z.max()), 1e-6))
            color = np.stack([shade * 0.6, shade, shade * (0.4 + 0.3 * r["obj_id"])], axis=-1)
            visible = read_png(r["mask_visib_path"]) > 0
            bgr = np.where(visible[..., None], color.clip(0, 255).astype(np.uint8), bgr)
        write_png(path, np.ascontiguousarray(bgr[..., ::-1]))


def overfit_cfg():
    """tools/validate_overfit.py:38-54's config on the port's defaults."""
    c = base_config()
    c.MODEL.CDPN.BACKBONE.NUM_LAYERS = 18
    c.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    c.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 8
    pnp = c.MODEL.CDPN.PNP_NET
    pnp.WITH_2D_COORD = pnp.REGION_ATTENTION = pnp.PM_LOSS_SYM = pnp.PM_NORM_BY_EXTENT = True
    pnp.CENTROID_LW = pnp.Z_LW = 1.0
    c.DATASETS.SYM_OBJS = ["brick"]
    c.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-3, weight_decay=0)
    c.SOLVER.ANNEAL_POINT = 0.72
    c.TEST.ROI_BATCH_SIZE = 4
    c.PARALLEL.DTYPE = "bfloat16"
    c.INPUT.DZI_TYPE = "none"  # train crops == test crops
    return c


def phase_overfit(gsd, root: str, card: str) -> None:
    """The learning check (tools/validate_overfit.py with the port alone):
    every record of a 2-object split mapped once by GDRNTrainMapper, then
    OVERFIT_STEPS train steps on that one batch on the card, then do_test on
    the same records with GT boxes, for each of OVERFIT_SEEDS. Gates: every
    loss finite; the sum of the loss terms other than the region CE below
    OVERFIT_LOSS_RATIO times its first value, and the region CE below its
    first (the reference's region CE keeps a floor of about ln(R+1) times
    the crop's pixels over its visible ones, losses/gdrn_loss.py:85-89, so
    the total cannot fall to OVERFIT_LOSS_RATIO of its first: the JAX
    package's own run stays near 0.24); Avg mean_re below
    OVERFIT_MAX_RE_DEG."""
    meta = overfit_split(gsd, str(Path(root) / "overfit"))
    records = load_bop_scene_dicts(meta, "test", img_type="real")
    c = overfit_cfg()
    models = ObjectModels(meta, num_pm_points=256, num_fps=8)
    mapper = GDRNTrainMapper(c, models, device=DEV)
    batch = to_device(collate([mapper(rec, np.random.RandomState(i))
                               for i, rec in enumerate(records)]), DEV)
    for seed in OVERFIT_SEEDS:
        model = init_weights(build_model(c, device=DEV), torch.Generator().manual_seed(seed))
        opt = build_optimizer(c, model, build_lr_schedule(c, 1e-3, OVERFIT_STEPS))
        state, step = create_train_state(model, opt), make_train_step(c, model, opt)
        gen = torch.Generator(device=DEV).manual_seed(seed + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = [step(state, batch, gen)[1] for _ in range(OVERFIT_STEPS)]
        hist = {k: torch.stack([h[k] for h in history]).cpu().numpy()
                for k in history[0] if k.startswith("loss") or k == "total_loss"}
        train_s = time.perf_counter() - t0
        total, region = hist["total_loss"], hist["loss_region"]
        others = total - region
        res = do_test(c, state.model, models, records,
                      output_dir=str(Path(root) / f"overfit_out_{seed}"), device=DEV)
        avg = res["Avg"]
        log("overfit", card=repr(card), seed=seed, records=len(records), steps=OVERFIT_STEPS,
            total_loss_first=f"{total[0]:.4f}", total_loss_last=f"{total[-1]:.4f}",
            total_ratio=f"{total[-1] / total[0]:.4f}", region_first=f"{region[0]:.4f}",
            region_last=f"{region[-1]:.4f}", others_ratio=f"{others[-1] / others[0]:.4f}",
            train_s=f"{train_s:.1f}", ad_10=f"{avg['ad_10']:.4f}",
            mean_re_deg=f"{avg['mean_re']:.3f}", mean_te_m=f"{avg['mean_te']:.4f}",
            per_object=json.dumps({n: [round(res[n]["mean_re"], 3), round(res[n]["mean_te"], 4)]
                                   for n in ("cube", "brick")}).replace(" ", ""))
        finite = all(np.all(np.isfinite(v)) for v in hist.values())
        if not (finite and others[-1] < OVERFIT_LOSS_RATIO * others[0] and region[-1] < region[0]
                and avg["mean_re"] < OVERFIT_MAX_RE_DEG):
            raise AssertionError(
                f"overfit seed {seed}: losses finite {finite}, loss without the region CE "
                f"{others[0]} -> {others[-1]}, region CE {region[0]} -> {region[-1]}, mean_re "
                f"{avg['mean_re']} (gates: {OVERFIT_LOSS_RATIO} x first, lower, "
                f"< {OVERFIT_MAX_RE_DEG})")
        del state, step, model, opt


def attr_case_args(gsd, v, f, R, t, origins, per_pose: bool = True) -> list:
    """rasterize_attr's tensor arguments on the card for mesh (v, f) under
    poses R, t through the generator's K: the 12 per-pose channels the
    generator renders (camera normal, camera position, a material, XYZ), or
    one random set of 12 shared by every pose."""
    B = len(R)
    if per_pose:
        attrs = np.concatenate([np.einsum("vk,bjk->bvj", vertex_normals(v, f), R),
                                np.einsum("vk,bjk->bvj", v, R) + t[:, None],
                                np.broadcast_to(np.float32([0.8, 0.6, 0.4]), (B, len(v), 3)),
                                np.broadcast_to(v, (B,) + v.shape)], -1)
    else:
        attrs = np.random.RandomState(len(v)).randn(1, len(v), RENDER_ATTR_CHANNELS)
    v_t, f_t, K, R_t, t_t, o = raster_args(v, f, np.broadcast_to(gsd.K_DEF, (B, 3, 3)), R, t,
                                           origins)
    return [v_t, torch.as_tensor(np.ascontiguousarray(attrs, np.float32), device=DEV), f_t, K,
            R_t, t_t, o]


def generator_poses(gsd, n: int, z: tuple, seed: int):
    """n random rotations with centres at random pixels of the generator's
    frame, z metres away."""
    g = np.random.RandomState(seed)
    q = np.linalg.qr(g.randn(n, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    c = np.stack([g.uniform(120, 520, n), g.uniform(100, 380, n), np.ones(n)], 1)
    t = (g.uniform(*z, (n, 1)) * c @ np.linalg.inv(gsd.K_DEF).T).astype(np.float32)
    return R, t


def phase_render_attr(gsd) -> None:
    """B2 with C = 12 attribute channels against rasterize_attr_ref on the
    card, bitwise (hit masks, depth, every channel): each zoo mesh at tile
    128 with per-pose channels, tiles 256 and 512, a ragged window over F =
    777, a shared set of 12, a pose whose faces reach behind z_near. Then
    its time at the generator's shapes, [32, 128^2] and [32, 512^2] over the
    tower (448 faces), beside its bounds, the plain version's time and the
    host time of a call."""
    zoo = gsd.mesh_zoo()
    tower_v, tower_f = zoo[3][1], zoo[3][2]

    def centred(t, tile):
        return centred_origins(gsd.K_DEF, t, tile)

    cases = []
    for i, (name, v, f, _) in enumerate(zoo):
        R, t = generator_poses(gsd, 8, (0.5, 0.9), seed=700 + i)
        cases.append((f"zoo128/{name}", attr_case_args(gsd, v, f, R, t, centred(t, 128)), 128))
    R, t = generator_poses(gsd, 8, (0.3, 0.4), seed=710)
    cases.append(("zoo256/tower", attr_case_args(gsd, tower_v, tower_f, R, t,
                                                 centred(t, 256)), 256))
    R, t = generator_poses(gsd, 4, (0.15, 0.2), seed=711)
    cases.append(("zoo512/hexprism", attr_case_args(gsd, zoo[9][1], zoo[9][2], R, t,
                                                    centred(t, 512)), 512))
    sv, sf = gsd._subdivide(tower_v, tower_f)
    R, t = generator_poses(gsd, 3, (0.5, 0.7), seed=712)
    args = attr_case_args(gsd, sv, sf[:777], R, t, centred(t, 96))
    cases.append(("ragged_90x100_faces_777", args, (90, 100)))
    cases.append(("shared_attrs", attr_case_args(gsd, tower_v, tower_f, R, t, centred(t, 128),
                                                 per_pose=False), 128))
    # the cube reaching from 5 mm behind the camera to 6.5 cm in front of it,
    # beside the optical axis: the faces that cross z_near are dropped
    R_near = np.stack([np.eye(3, dtype=np.float32)] * 2)
    t_near = np.float32([[0.04, 0.0, 0.03], [0.045, -0.01, 0.03]])
    cases.append(("behind_z_near", attr_case_args(gsd, zoo[0][1], zoo[0][2], R_near, t_near,
                                                  [[64.0, 0.0], [0.0, 0.0]]), 512))
    for case, args, hw in cases:
        h, w = hw if isinstance(hw, tuple) else (hw, hw)
        d1, a1 = kernels.rasterize_attr(*args, h, w)
        dr, ar = kernels.rasterize_attr_ref(*args, h, w)
        torch.cuda.synchronize()
        hits = int((d1 > 0).sum())
        bitwise = torch.equal(d1, dr) and torch.equal(a1, ar)
        log("render_attr", case=case, shape=f"{args[3].shape[0]}x{h}x{w}x{args[1].shape[2]}",
            attrs_per_pose=args[1].shape[0] > 1, faces=args[2].shape[0], hit_px=hits,
            unequal_hit_px=int(((d1 > 0) != (dr > 0)).sum()), bitwise_equal=bitwise)
        if not bitwise or hits == 0 or hits == d1.numel():
            raise AssertionError(f"render_attr {case}: kernel vs plain not bitwise equal "
                                 f"({hits} hit pixels, max depth diff "
                                 f"{float((d1 - dr).abs().max())}, attrs "
                                 f"{float((a1 - ar).abs().max())})")
    log("render_attr", check="ok", cases=len(cases), rule="bitwise")

    for label, (z, tile, n_plain) in RENDER_ATTR_TIMED.items():
        R, t = generator_poses(gsd, 32, z, seed=720 + tile)
        args = attr_case_args(gsd, tower_v, tower_f, R, t, centred(t, tile))
        plain = [cuda_times(lambda: kernels.rasterize_attr_ref(*args, tile, tile), n_plain, 1)]
        kern = [cuda_times(lambda: kernels.rasterize_attr(*args, tile, tile), 20)
                for _ in range(2)]
        plain.append(cuda_times(lambda: kernels.rasterize_attr_ref(*args, tile, tile), n_plain, 1))
        kern, plain = np.concatenate(kern), np.concatenate(plain)
        host = host_times(lambda: kernels.rasterize_attr(*args, tile, tile), 20)
        geom, _ = kernels.raster_face_tables(args[0], args[1], *args[2:6])
        B, V, F, C = 32, len(tower_v), len(tower_f), RENDER_ATTR_CHANNELS
        pairs = B * tile * tile * F
        kept = int(kernels.raster_tile_keep(geom, args[6], tile, tile).sum()) * RASTER_TILE_PIXELS
        n_bytes = 4.0 * (3 * V + B * V * C + 3 * F + 23 * B) + (4.0 + 4.0 * C) * B * tile * tile
        bound_ms, bound_by = bound(n_bytes, RASTER_INSTR_PER_PAIR * kept)
        all_ms, _ = bound(n_bytes, RASTER_INSTR_PER_PAIR * pairs)
        med = float(np.median(kern))
        log("render_attr_time", shape=label, order="plain,kernel,kernel,plain",
            kernel_median_ms=f"{med:.4f}", kernel_max_ms=f"{kern.max():.4f}",
            kernel_n=len(kern), plain_median_ms=f"{np.median(plain):.4f}", plain_n=len(plain),
            host_synced_call_median_ms=f"{np.median(host):.4f}", host_n=len(host),
            bytes_bound_ms=f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
            all_pairs_bound_ms=f"{all_ms:.4f}", culled_pair_share=f"{1.0 - kept / pairs:.4f}",
            kept_pairs_bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            share_of_bound=f"{bound_ms / med:.3f}", library_ms="none")


def count_flips(got: np.ndarray, want: np.ndarray, where: str) -> int:
    """Pixels where two uint8 images differ; raises where a value differs
    by more than 1."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if diff.size and diff.max() > 1:
        raise AssertionError(f"{where}: a value differs by {diff.max()}")
    return int((diff > 0).reshape(diff.shape[:2] + (-1,)).any(-1).sum())


def phase_render_phong_xyz(gsd) -> None:
    """The renders on the card against the CPU: render_phong_xyz_roi_many
    (the generator's pass) over every zoo mesh at tile 128, Renderer in
    rgb+depth and depth modes, and one SceneRenderer scene. The attribute
    maps are bitwise equal, so uint16 mm depth, f16 xyz, depth maps, masks
    and boxes must be equal; rgb within 1 grey level, at no more than
    RENDER_FLIP_SHARE of the hit pixels (the shading's norms and divisions
    are PyTorch ops on two devices)."""
    zoo, colors = gsd.mesh_zoo(), gsd._object_colors(10)
    hits = flips = fitted = 0
    for i, (name, v, f, _) in enumerate(zoo):
        R, t = generator_poses(gsd, 40, (0.5, 0.9), seed=730 + i)
        g = np.random.RandomState(i)
        kw = dict(colors=np.broadcast_to(colors[i], (len(v), 3)),
                  light_pos=g.uniform(-2, 2, (40, 3)), ambient=g.uniform(0.35, 0.55, 40),
                  diffuse=g.uniform(0.6, 1.0, 40), specular=g.uniform(0.1, 0.4, 40))
        Ks = np.broadcast_to(gsd.K_DEF, (40, 3, 3))
        (card, fit), (cpu, fit_cpu) = [
            render_phong_xyz_roi_many(v, f, Ks, R, t, gsd.H_DEF, gsd.W_DEF, tile=128,
                                      on_misfit="skip", device=dev, **kw) for dev in (DEV, "cpu")]
        if fit != fit_cpu or len(fit) < 20:
            raise AssertionError(f"render_phong_xyz {name}: fitted {fit} vs {fit_cpu}")
        fitted += len(fit)
        for (d, rgb, xyz, o), (dc, rgbc, xyzc, oc) in zip(card, cpu):
            if o != oc or not (np.array_equal(d, dc) and np.array_equal(xyz, xyzc)):
                raise AssertionError(f"render_phong_xyz {name}: depth_mm or xyz card vs CPU")
            hits += int((dc > 0).sum())
            flips += count_flips(rgb, rgbc, f"render_phong_xyz {name} rgb")
    if flips > RENDER_FLIP_SHARE * hits:
        raise AssertionError(f"render_phong_xyz: {flips} rgb flips of {hits} hit pixels")
    log("render_phong_xyz", meshes=len(zoo), poses=40 * len(zoo), fitted_128=fitted,
        depth_mm_and_xyz="equal", hit_px=hits, rgb_flips=flips,
        flip_share_max=RENDER_FLIP_SHARE, check="ok")

    with tempfile.TemporaryDirectory() as d:
        ply = str(Path(d) / "obj.ply")
        save_ply(ply, zoo[6][1], zoo[6][2],
                 colors=np.random.RandomState(1).randint(0, 255, (len(zoo[6][1]), 3)))
        R, _ = generator_poses(gsd, 1, (0.6, 0.6), seed=740)
        for mode in ("rgb+depth", "depth"):
            outs = []
            for dev in (DEV, "cpu"):
                ren = create_renderer(gsd.W_DEF, gsd.H_DEF, mode=mode, device=dev)
                ren.add_object(7, ply)
                outs.append([ren.render_object(7, R[0], t, *gsd.K_DEF[[0, 1, 0, 1], [0, 1, 2, 2]])
                             for t in ([0.02, 0.01, 0.6], [0.0, 0.0, 0.12])])
            n_flips = n_hits = 0
            for got, want in zip(*outs):
                if not np.array_equal(got["depth"], want["depth"]):
                    raise AssertionError(f"renderer {mode}: depth card vs CPU")
                n_hits += int((want["depth"] > 0).sum())
                if "rgb" in want:
                    n_flips += count_flips(got["rgb"], want["rgb"], f"renderer {mode}")
            if n_flips > RENDER_FLIP_SHARE * n_hits:
                raise AssertionError(f"renderer {mode}: {n_flips} rgb flips of {n_hits} hits")
            log("renderer", mode=mode, poses=2, depth="equal", hit_px=n_hits, rgb_flips=n_flips,
                check="ok")

    models = [(v * 1000.0, f, np.broadcast_to(colors[i], (len(v), 3)))
              for i, (_, v, f, _) in enumerate(zoo)]
    scenes = [SceneRenderer(models, range(1, 11), gsd.W_DEF, gsd.H_DEF, gsd.K_DEF,
                            rng=np.random.RandomState(5), device=dev).render()
              for dev in (DEV, "cpu")]
    (bgr, info, ex), (bgr_c, info_c, ex_c) = scenes
    same = info == info_c and all(np.array_equal(ex[k], ex_c[k]) for k in ex)
    n_flips = count_flips(bgr, bgr_c, "scene_renderer")
    if not same or n_flips > RENDER_FLIP_SHARE * (ex_c["depth"] > 0).sum():
        raise AssertionError(f"scene_renderer: obj_info / extras equal {same}, {n_flips} flips")
    log("scene_renderer", objects=len(info), depth_and_masks="equal",
        hit_px=int((ex_c["depth"] > 0).sum()), bgr_flips=n_flips, check="ok")


def gen_done_lines(stdout: str) -> dict:
    """The generator's "[split] done: ..." lines: {split: (images, stage
    seconds, B2 launches, chunks)}."""
    out = {}
    for m in re.finditer(r"\[(\w+)\] done: (\d+) images, \d+ scenes; host-clock s by stage "
                         r"(\{.*?\}); B2 launches (\d+) in (\d+) chunks", stdout):
        out[m[1]] = (int(m[2]), json.loads(m[3]), int(m[4]), int(m[5]))
    return out


def compare_generated(card_dir: Path, cpu_dir: Path, n_images: int) -> dict:
    """The first n_images of scene 1 written on the card and on the CPU:
    every file equal (B2 is bitwise equal to its plain version, so depth,
    masks, xyz crops and the JSON are), but rgb, whose values may differ by
    1 (the shading's PyTorch ops on two devices). Returns the counts."""
    with open(card_dir / "scene_gt.json") as f:
        gt = json.load(f)
    counts = {"images": 0, "instances": 0, "rgb_flips": 0, "px": 0}
    for name in ("scene_gt.json", "scene_gt_info.json", "scene_camera.json"):
        a, b = (json.load(open(d / name)) for d in (card_dir, cpu_dir))
        if {k: a[k] for k in list(a)[:n_images]} != {k: b[k] for k in list(b)[:n_images]}:
            raise AssertionError(f"gen_dataset card vs CPU: {name} differs")
    for im in list(gt)[:n_images]:
        stem = f"{int(im):06d}"
        files = [f"depth/{stem}.png"] + [f"{sub}/{stem}_{k:06d}.png" for k in range(len(gt[im]))
                                          for sub in ("mask", "mask_visib")]
        for rel in files:
            if not np.array_equal(read_png(str(card_dir / rel)), read_png(str(cpu_dir / rel))):
                raise AssertionError(f"gen_dataset card vs CPU: {rel} differs")
        for k in range(len(gt[im])):
            a, b = (pickle.load(open(d / f"xyz_crop/{stem}_{k:06d}.pkl", "rb"))
                    for d in (card_dir, cpu_dir))
            if a["xyxy"] != b["xyxy"] or not np.array_equal(a["xyz_crop"], b["xyz_crop"]):
                raise AssertionError(f"gen_dataset card vs CPU: xyz_crop {stem}_{k:06d}")
        rgb = [read_png(str(d / f"rgb/{stem}.png")) for d in (card_dir, cpu_dir)]
        counts["rgb_flips"] += count_flips(rgb[0], rgb[1], f"gen_dataset rgb {stem}")
        counts["px"] += rgb[0].shape[0] * rgb[0].shape[1]
        counts["images"] += 1
        counts["instances"] += len(gt[im])
    if counts["rgb_flips"] > RENDER_FLIP_SHARE * counts["px"]:
        raise AssertionError(f"gen_dataset card vs CPU: {counts}")
    return counts


def phase_gen_dataset(gsd, root: str, card: str) -> int:
    """The flagship's synth dataset as a user writes it: the generator's CLI
    in a subprocess on the card, at the dataset's width (640x480, the full
    10-mesh zoo, tiles 128/256/512, batch 32) cut to GEN_TRAIN + GEN_TEST
    images of GEN_PER_SCENE a scene. Gates: exit 0; both splits resolve
    by name and est_dets.json loads; the train mapper maps GEN_MAPPED
    records from the written xyz_crop pickles with no B2 launch; train scene
    1, written again on the CPU from the same seed, agrees file by file
    (compare_generated, its first GEN_CPU_IMAGES images). Returns B2's
    launches in the CLI's run."""
    data_root = Path(root) / "gen"
    cmd = [sys.executable, "-m", "gdrnet_tpu_torch.tools.gen_scale_dataset", "--root",
           str(data_root / "synth_smoke"), "--train-images", str(GEN_TRAIN), "--test-images",
           str(GEN_TEST), "--imgs-per-scene", str(GEN_PER_SCENE), "--seed", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=GEN_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"gen_dataset: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    done = gen_done_lines(proc.stdout)
    meta, train = resolve("synth_smoke_train", data_root=str(data_root))
    _, test = resolve("synth_smoke_test", data_root=str(data_root))
    dets = load_detections(str(data_root / "synth_smoke" / "test_bboxes" / "est_dets.json"))
    if (set(done) != {"train", "test"} or done["train"][0] != GEN_TRAIN
            or done["test"][0] != GEN_TEST or not train or not test or not dets
            or any(d[2] < d[3] for d in done.values())):
        raise AssertionError(f"gen_dataset: done lines {done}, {len(train)} train and "
                             f"{len(test)} test records, {len(dets)} detection images")
    launches = sum(d[2] for d in done.values())
    chunks = sum(d[3] for d in done.values())
    stages: dict = defaultdict(float)
    for d in done.values():
        for k, sec in d[1].items():
            stages[k] += sec
    n_img = GEN_TRAIN + GEN_TEST
    log("gen_dataset", card=repr(card), size=f"{gsd.W_DEF}x{gsd.H_DEF}", meshes=10,
        images=n_img, cut_from="2000+400 images, 200 a scene", per_scene=GEN_PER_SCENE,
        wall_s=f"{wall_s:.2f}", images_per_s=f"{n_img / wall_s:.2f}",
        stage_s=json.dumps({k: round(v, 3) for k, v in stages.items()}).replace(" ", ""),
        render_share_of_stages=f"{stages['render'] / sum(stages.values()):.3f}",
        b2_launches=launches, chunks=chunks, b2_launches_per_chunk=f"{launches / chunks:.1f}",
        train_records=len(train), test_records=len(test), detection_images=len(dets))

    cfg = merged_config(FLAGSHIP)
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    mapper = GDRNTrainMapper(cfg, models, device=DEV)
    before = kernels.rasterize_attr.launches
    mapped = [mapper(dict(rec), np.random.RandomState(i))
              for i, rec in enumerate(train[::max(1, len(train) // GEN_MAPPED)][:GEN_MAPPED])]
    if kernels.rasterize_attr.launches != before or not all(
            np.all(np.isfinite(m["gt_xyz"])) for m in mapped):
        raise AssertionError(f"gen_dataset mapper: {kernels.rasterize_attr.launches - before} "
                             "B2 launches, or non-finite XYZ")
    log("gen_dataset_mapper", records=len(mapped), xyz_from="pickles",
        b2_launches=0, check="ok")

    cpu_root = Path(root) / "gen_cpu"
    t0 = time.perf_counter()
    gsd.generate_split(str(cpu_root), "train", gsd.mesh_zoo(), gsd._object_colors(10),
                       gsd.K_DEF, gsd.W_DEF, gsd.H_DEF, GEN_PER_SCENE, seed=1,
                       images_per_scene=GEN_PER_SCENE, device="cpu")
    cpu_s = time.perf_counter() - t0
    counts = compare_generated(data_root / "synth_smoke" / "train" / "000001",
                               cpu_root / "train" / "000001", GEN_CPU_IMAGES)
    log("gen_dataset_vs_cpu", scene=1, **counts, cpu_scene_s=f"{cpu_s:.1f}",
        rule="equal but rgb within 1", flip_share_max=RENDER_FLIP_SHARE, check="ok")
    return launches


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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
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
    # 8. its train step, 9. its training run from a BOP split on disk, 10. its
    # test path over estimated detections with the trained checkpoint, in
    # process and through the CLI, 11. the learning check, 12. the rendering
    # slice: B2 with 12 channels, the renders on the card against the CPU and
    # the synth dataset's generator, 13. then the profiled measurements
    with tempfile.TemporaryDirectory() as root:
        split = phase_bop_split(cfg, gsd, requests, root)
        raster_launches, scored = phase_bop_score(cfg, split, R, t, root)
        del model, m32, predict
        phase_train_f32(cfg32, state_dict)
        train = phase_train(cfg, state_dict, card)
        loop_launches = phase_train_loop(cfg, state_dict, gsd, root, card)
        ckpt = str(Path(root) / "train_out" / "ckpt")
        dets = write_detections(split, str(Path(root) / "est_dets.json"))
        tested = phase_do_test(cfg, split, dets, ckpt, root, card)
        phase_do_test_vs_cpu(cfg32, split, dets, ckpt, root)
        phase_cli(cfg, split, dets, ckpt, root, tested)
        phase_overfit(gsd, root, card)
        phase_render_attr(gsd)
        phase_render_phong_xyz(gsd)
        gen_launches = phase_gen_dataset(gsd, root, card)
        phase_profile(cfg, split, scored, raster_timed, train)
    test_launches = tested[2]

    print(json.dumps({"kernels": [
        {"name": "nn_min_dist", "route": "cuda",
         "source": "gdrnet_tpu_torch/csrc/nn_min_dist.cu",
         "replaces": "gdrnet_tpu/ops/pallas_kernels.py:28",
         "launches": launches + test_launches[0], **nn_stats},
        {"name": "rasterize_xyz", "route": "cuda",
         "source": "gdrnet_tpu_torch/csrc/rasterize_xyz.cu",
         "replaces": "gdrnet_tpu/ops/pallas_kernels.py:140",
         "launches": raster_launches + loop_launches + test_launches[1] + gen_launches,
         **raster_stats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
