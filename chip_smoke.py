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
resume; then every COLOR_AUG_TYPE of the JAX package on that split
([color_aug]: ROI10D, SSD and the albumentations pipeline on data/cv_ops's
numpy HSV, L*a*b*, CLAHE and filter2D, the mapper on the card against the
CPU, the host cost of each, a short do_train with the default type, and
P3P and se3 on a machine without cv2). Last, the rendering slice: the
z-buffer kernel with the 12 per-pose attribute channels of the Phong + XYZ pass, the renders on the card against
the CPU, and the flagship's synth dataset written by the port's generator
(python -m gdrnet_tpu_torch.tools.gen_scale_dataset) as a user runs it,
then its region anchors written again by the compute_fps CLI ([fps]: the
device FPS of ops/fps.py on the card, the C++ twin csrc/fps.cpp on the
host).
Then serving from images as a user of a trained model runs it: BN folded
into the convs (utils/fold_bn.py) and int8 (models/quantize.py: im2col and
torch._int_mm), the predict CLI over the split's images and detections, the
eval_csv CLI re-scoring its CSV (ADD-S on the nearest-neighbour kernel, VSD
on the z-buffer kernel), and gen_xyz writing the train split's XYZ ground
truth with the z-buffer kernel, each CLI's main called in this process as
`python -m` calls it. Then the LM-O slice: the port's JPEG codec
(gdrnet_tpu_torch/csrc/jpeg_codec.cpp, host C++ built with g++) against
the digests cv2 gives, and the LM-O config
(configs/gdrn/lmo/a6_cPnP_AugAAETrunc_BG0.5_lmo_real_pbr0.1_40e.py) at full
width trained and tested through python -m gdrnet_tpu_torch.engine.train on
an LM-O tree this script writes: real LM frames, PBR frames as JPEGs whose
XYZ the z-buffer kernel renders, VOC_table JPEG backgrounds, and ADD-S of
eggbox and glue on the nearest-neighbour kernel in do_test. Then every
GDR-Net variant of MODEL.CDPN at the flagship's width ([variants]), every
optimizer of the JAX registry ([solvers]), and the LM config at ResNet-50
with Ranger2020 and precise BN trained and tested through the CLI on the
train loop's split ([train_variant], run before gen_xyz writes that split's
pickles, so that its XYZ renders on the z-buffer kernel), and the dataset
inspection CLI (python -m gdrnet_tpu_torch.data.visualize, [visualize]) over
that split, whose --mapped panels render their XYZ on the z-buffer kernel.
Then the PnP slice
([pnp]): the device PnP program (gdrnet_tpu_torch/ops/device_pnp.py,
batched torch) in each TEST.PNP_TYPE mode on the card against the CPU,
bench_pnp's ROIs/s of the host loop and of each mode, do_test with
TEST.USE_PNP on the device and on the host path (ADD-S on the
nearest-neighbour kernel, VSD on the z-buffer kernel), and training with
TRAIN.VIS_IMG. Then data parallelism ([ddp]): the engine.train CLI under
python -m torch.distributed.run as one NCCL rank (train, then --eval-only
on its checkpoint), and two gloo ranks on the one card (a DDP train step
of the flagship against one process, then the model axis: the flagship
tensor-sharded over the two ranks as a (1, 2) grid, its steps, gathered
gradients, checkpoint and resume against one process, then do_test sharded
over the ranks against [do_test]'s one process). Then the bench leg and the serving tools,
each tool's main called in this process as `python -m` calls it:
[bench_train] (tools/bench_train.py: the train step, the loader leg over
the train loop's split, whose XYZ renders on the z-buffer kernel, and the
FLOP audit with its share of the card's peaks), [bench] (tools/bench.py:
bf16, then int8 on the trained checkpoint), [export] (tools/export_model.py
on the card, the artifacts run in a child process that imports only
torch), [strip_ckpt] and [pvnet] (models/pvnet.py on the card against the
CPU).

Phases, one line each (or one per case): device, kernel builds (both nvcc
runs and the codec's g++ at once), nn_min_dist against its plain PyTorch version and cKDTree,
timed beside its bound and torch.cdist; rasterize_xyz against its plain
version (20 cases), and its time beside its bounds and the share of
pixel-face pairs it culls; f32 forward on the GPU against the CPU, bf16
serving, CustomEvaluator scoring (kernel against the plain version),
throughput, the BOP split, BOP scoring on the card and against the plain
versions on the CPU; the train step (one f32 step on the card against the
CPU, 30 bf16 steps, a skipped NaN step, its time per step and split); the
train loop (the mapper on the card against the CPU, the host loader
alone, do_train from the device-resident pool with its refresh, as the
flagship config says, to a checkpoint, the resumed state against it,
do_train resumed with its pool from the first run's cache; the pool's rows,
MiB, map, upload and cache-load seconds, rows refreshed, step and data
times and B2's launches); [pool_parity] (the pool's batch on the card
against the mapper's in the JAX package's envelope, against the CPU's
decode of the same rows, device_train_batch and every device_augment op on
the card against the CPU with the same draws, make_batch's ms); [color_aug]
(for ROI10D, SSD and ALBU at COLOR_AUG_PROB=1 the train loop's 16 mapped
records on the card against the CPU, bit for bit, every frame jittered, B2
at least once a sample; each augmentor's and cv_ops stand-in's host ms on
one thread beside the mapper's ms a sample; do_train at B=128 for 3
iterations with ROI10D at 0.8: losses finite, no step skipped, B2 at least
once a sample, ROIs/s and data-wait share beside the train loop's; P3P on
64 exact sets within 1e-9 rad and m, pnp_ransac(method="p3p") on 30 %
outliers within 1 degree and 1 cm, the se3 functions card against CPU
within 1e-6); the test
path ([do_test], and [do_test_device_preprocess]: the same with the crops
warped on the card, its recalls the host mapper's but for counted
threshold flips; [do_test_vs_cpu], [cli]) and the learning check
([overfit]: gdrnet_tpu_torch/tools/validate_overfit.py's split, config and
seed function for 3 seeds, with B1 in its do_test and B2 writing its split;
[scale_run]: the scale run's orchestrator in --dry-run, every stage
listed); the rendering slice: [render_attr] (B2 at C = 12 against its
plain version, bitwise, over 15 cases, and its time at the generator's
shapes beside its bounds), [render_phong_xyz] (render_phong_xyz_roi_many,
Renderer and SceneRenderer on the card against the CPU), [gen_dataset]
(the generator's CLI on the card: wall s, images/s, its time by stage, B2's
launches a chunk; the split resolves, maps from its pickles without a
render, and agrees with the same scene written on the CPU), [fps] (the
device FPS and the C++ twin index for index equal to numpy's FPS on the
generator's 10 meshes, a lattice, a cylinder and 100,000 random points, no
host sync in the device loop, the twin built with -march=native equal
too; the compute_fps CLI with --device cuda and cpu writing the
generator's fps_points.pkl bit for bit; the device FPS's ms at 100,000 x
256 beside the twin's and numpy's host ms, each CLI run's wall s); serving from
images: [fold_bn] (folded f32 forward against unfolded, bf16 crops/s
folded beside unfolded), [int8] (calibration, every layer's int32
accumulators against the plain version, int8 against bf16, crops/s of int8
and int8 + folded, _int_mm alone beside a bf16 matmul), [predict] (the CLI's
main, scene 1 in f32 on the card against the CPU, FOLD_BN + INT8
through its options), [eval_csv] (the CLI's main, its recalls against
score_results, B1 and B2 launches, cus / cou_bb_proj card against CPU),
[gen_xyz] (the CLI over the train split, scene 1 against the CPU, the
mapper from its pickles), [loader_pkl] (the loader alone with them); the
LM-O slice: [jpeg] (81 cases' stream and image digests against cv2's:
baseline, progressive, CMYK and YCCK; decode and encode ms of a 640x480
q95 frame, decode ms of its progressive and CMYK counterparts, decodes/s
on 4 threads),
[train_lmo_tree] and [train_lmo] (8 PBR samples mapped on the card against
the CPU, the loader alone, then the CLI in a subprocess: JPEG decodes of
PBR frames and backgrounds, losses finite with no step skipped, B2 at least
once a sample, one CSV row a kept detection, B1 in do_test; step and data
times, data-wait share, ROIs/s, loader samples/s, the share of samples
whose background was replaced); [variants] (each variant's f32 forward on
the card against the CPU, 5 bf16 steps at B=32, its step ms, crops/s and
peak memory), [solvers] (each optimizer's first f32 update against the
CPU's, 5 bf16 steps, its ms, a NaN step bitwise), [train_variant] (losses
finite, precise BN moving every BN statistic, one CSV row a kept
detection, B2 in training and B1 in do_test); [visualize] (VIS_N panel
files in each mode, B2 at least once a mapped record, the mapped panels on
the card bitwise the CPU's, the grid backend named); [pnp] (card against CPU with
the same minimal sets within 0.05 degrees and 5e-4 m, at least 95 % of 64
ROIs within 1 degree and 1 cm of the truth, in each mode), [pnp_bench]
(ROIs/s and peak memory), [do_test_pnp] (finite rows with rotations, one a
kept detection, finite recalls, B1 in each run), [vis_img] (finite losses;
with tensorboard, five panels an iteration); [ddp_nccl] (the NCCL group's
all_reduce, the host values' own gloo group's barrier and object gather,
losses finite, the rank's log, checkpoint keys without `module.`, B2 in
training and B1 in the test, one CSV row a kept detection), [ddp_gloo]
(loss terms of 2 ranks against one process at every step, the gradients
at the first, BN buffers equal on both ranks, ms a step and ROIs/s of each,
the all-reduce ms), [ddp_do_test] (rows and recalls against one process,
B1 on each rank, B2 on rank 0); [bench_train_step], [bench_train_loader]
(one line for each of the host, pool, device-prep and device-aug
pipelines; B2 at least once a sample the loop consumed or a record the pool
mapped), [bench_train_audit] (mfu
and hbm_frac in (0, 1], the FLOP counts beside [train_time]'s step),
[bench] (values finite and above 0, int8 drift finite), [export] (the
child's poses bit for bit the in-process forward's, bf16 and int8 at all 64
crops), [strip_ckpt] (smaller,
model and iteration only, the same poses bit for bit), [pvnet] (card
against CPU within 1e-3 of the scale, ms at B=64); last, what
torch.profiler measures (rasterize_xyz's launches per call and its
kernels' device time, the device time of a BOP scoring call, the train
step's busy share, top device operations and Ranger's launches, the
device FPS's launches and busy ms), so that no
host-bound phase is timed after a profiler session. Any failure raises; the exit code is then non-zero and the result
line is not printed. The last line is
{"ok": true, "device": {...}}; the line before it holds the kernels'
launches, errors, times and bounds.

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and scipy.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import io
import json
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gdrnet_tpu_torch import (
    build_lr_schedule,
    build_optimizer,
    create_train_state,
    csrc,
    make_train_step,
    merged_config,
)
from gdrnet_tpu_torch.config.config import apply_opts
from gdrnet_tpu_torch.data import augment as augment_mod
from gdrnet_tpu_torch.data import cv_ops, jpeg, jpeg_cases, ref_meta
from gdrnet_tpu_torch.data import visualize as visualize_tool
from gdrnet_tpu_torch.data.augment import build_color_augmentor
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts, load_detections
from gdrnet_tpu_torch.data.dataset_factory import resolve
from gdrnet_tpu_torch.data.io import read_image, read_png
from gdrnet_tpu_torch.data import device_augment as dev_aug
from gdrnet_tpu_torch.data import device_pool
from gdrnet_tpu_torch.data.device_pipeline import device_train_batch
from gdrnet_tpu_torch.data.mapper import (
    GDRNRawTrainMapper,
    GDRNTestMapper,
    GDRNTrainMapper,
    collate,
)
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.data.ply import load_ply, save_ply
from gdrnet_tpu_torch.data.scene_renderer import SceneRenderer
from gdrnet_tpu_torch.data.synthetic import (
    cylinder_cloud,
    edge_on_poses,
    lattice_cloud,
    poses_near,
    sliver_mesh,
    synthetic_decoded_maps,
    synthetic_object_models,
    synthetic_roi_batch,
    write_bop_split,
)
from gdrnet_tpu_torch.engine import build_test_items, do_test, steps
from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager, load_weights
from gdrnet_tpu_torch.engine import train as train_cli
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.engine import trainer as trainer_mod
from gdrnet_tpu_torch.engine.trainer import build_input_pipeline, build_train_objects, do_train
from gdrnet_tpu_torch.eval import bop_score, cv_pnp
from gdrnet_tpu_torch.eval import pnp as pnp_mod
from gdrnet_tpu_torch.eval import vsd as vsd_mod
from gdrnet_tpu_torch.eval import pose_errors as PE
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results, save_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator
from gdrnet_tpu_torch.eval.renderer import create_renderer
from gdrnet_tpu_torch.models import quantize as Q
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.models.pvnet import PVNet
from gdrnet_tpu_torch.solver.optimizers import OPTIMIZER_NAMES
from gdrnet_tpu_torch.ops import device_pnp, kernels, se3
from gdrnet_tpu_torch.ops import fps as fps_ops
from gdrnet_tpu_torch.ops.rasterizer import render_phong_xyz_roi_many, vertex_normals
from gdrnet_tpu_torch.ops.symmetry import get_closest_rot_batch, identity_padded_sym_arrays
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.tools import bench as bench_tool
from gdrnet_tpu_torch.tools import bench_pnp
from gdrnet_tpu_torch.tools import bench_train as bench_train_tool
from gdrnet_tpu_torch.tools import export_model as export_tool
from gdrnet_tpu_torch.tools import compute_fps as compute_fps_tool
from gdrnet_tpu_torch.tools.compute_fps import compute_fps_dict
from gdrnet_tpu_torch.tools import gen_xyz as gen_xyz_tool
from gdrnet_tpu_torch.tools import predict as predict_tool
from gdrnet_tpu_torch.tools import scale_run as scale_run_tool
from gdrnet_tpu_torch.tools import strip_ckpt as strip_tool
from gdrnet_tpu_torch.tools import validate_overfit as overfit_tool
from gdrnet_tpu_torch.tools.dryrun_multichip import launch, train_steps
from gdrnet_tpu_torch.utils import vis as vis_mod
from gdrnet_tpu_torch.utils.fold_bn import conv_bn_pairs, fold_batch_norms

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
INT8_OPS_PER_S, BF16_FLOPS_PER_S = 1.979e15, 9.89e14  # tensor cores, dense
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
LOOP_SAVE, LOOP_ITERS, LOOP_WORKERS = 6, 12, 4
LOOP_LOADER_BATCHES, LOOP_MAPPED = 2, 16
# [pool_parity]: POOL_PARITY_ROWS records of the loop split into a pool on the
# card (seed POOL_SEED) against the mapper, and its decode against the CPU's
# within POOL_CPU_ATOL; device_train_batch over POOL_RAW_RECORDS raw frames
# and each device_augment op over POOL_AUG_FRAMES of them, card against CPU
# with the same draws, within DEVICE_AUG_ATOL (0..255 for the ops, the
# normalized crop for device_train_batch) and labels equal at
# POOL_LABEL_SHARE; make_batch at B=128 timed POOL_TIMED times
POOL_PARITY_ROWS, POOL_SEED, POOL_RAW_RECORDS, POOL_AUG_FRAMES, POOL_TIMED = 64, 7, 32, 8, 20
POOL_CPU_ATOL, DEVICE_AUG_ATOL, POOL_LABEL_SHARE = 1e-6, 1e-4, 0.999
# the test path: est_dets.json from the BOP split's visible GT boxes jittered by
# up to DET_JITTER_PX, every DET_DROP_EVERY-th instance without a detection,
# every DET_SECOND_EVERY-th with a lower-scored second one; scene 1 in f32 on
# the card against the CPU: rotations within DO_TEST_ROT_ATOL, translations
# within DO_TEST_TRANS_RTOL of their norm (the forward's tolerance above)
DET_JITTER_PX, DET_DROP_EVERY, DET_SECOND_EVERY = 4, 16, 10
DO_TEST_ROT_ATOL, DO_TEST_TRANS_RTOL = 1e-3, 1e-3
# the learning check (gdrnet_tpu_torch/tools/validate_overfit.py, the port of
# tools/validate_overfit.py): its TOTAL updates on one batch of its IMAGES
# frames of the 2-object split, then do_test; loose gates (a mean rotation
# error, not a recall)
OVERFIT_SEEDS = (0, 1, 2)
OVERFIT_LOSS_RATIO, OVERFIT_MAX_RE_DEG = 0.2, 10.0
# the stages of gdrnet_tpu_torch/tools/scale_run.py, as tools/scale_run.py
# orders them
SCALE_RUN_STAGES = ["dataset", "insurance", "train", "eval_int8", "eval_dpnp", "bench", "audit",
                    "loader_bench"] + [f"sweep{i}" for i in range(5)]
# the rendering slice: B2 with the generator's 12 attribute channels, timed at
# its two shapes (label: (z range of the tower, window, plain-version calls));
# the renders on the card against the CPU, rgb within 1 grey level at no more
# than RENDER_FLIP_SHARE of the hit pixels; the generator's CLI at the synth
# dataset's width, GEN_TRAIN + GEN_TEST images of GEN_PER_SCENE a scene, its
# train mapper over GEN_MAPPED records, GEN_CPU_IMAGES compared with the CPU
RENDER_ATTR_CHANNELS = 12
RENDER_ATTR_TIMED = {"32x128x128x12/tower_448": ((0.5, 0.9), 128, 5),
                     "32x512x512x12/tower_448": ((0.15, 0.22), 512, 1)}
RENDER_FLIP_SHARE = 0.01
GEN_TRAIN, GEN_TEST, GEN_PER_SCENE, GEN_MAPPED, GEN_CPU_IMAGES = 32, 16, 16, 16, 4
GEN_TIMEOUT_S = 300
# farthest point sampling ([fps]): the device FPS and the C++ twin against
# numpy, index for index, on [gen_dataset]'s 10 meshes at every K of
# FPS_COUNTS up to n, on an FPS_LATTICE^3 lattice and an FPS_CYLINDER
# cylinder (exact ties) at FPS_TIE_K from each of FPS_STARTS
# ((init_center, start_idx)), and on FPS_BIG seeded random points at
# FPS_BIG_K; the device FPS there timed FPS_TIMED times after one warm-up,
# and profiled over FPS_PROFILED steps in the last phase
FPS_LATTICE, FPS_CYLINDER, FPS_TIE_K = 17, (96, 40), 256
FPS_STARTS = ((True, 0), (False, 0), (False, 7))
FPS_BIG, FPS_BIG_K, FPS_TIMED, FPS_PROFILED = 100_000, 256, 3, 32
# serving from images: the folded f32 forward against the unfolded one on the
# card within FOLD_POSE_ATOL (tests/test_fold_bn.py); the int8 forward against
# bf16 within INT8_VS_BF16_DEG and INT8_VS_BF16_TRANS_REL
# (tests/test_quantize.py:97-113), calibrated on one bucket; the int8
# accumulators card against CPU for INT8_CHECK_CROPS crops of that bucket;
# serving timed at SERVE_BATCHES, SERVE_ITERS calls each; the tools' mains in
# this process; cus / cou_bb_proj on SIL_PAIRS pairs
FOLD_POSE_ATOL, INT8_VS_BF16_DEG, INT8_VS_BF16_TRANS_REL = 2e-4, 1.0, 0.05
INT8_CHECK_CROPS, SERVE_ITERS, SIL_PAIRS = 2, {64: 20, 1024: 3}, 8
# every COLOR_AUG_TYPE on the card: [train_loop]'s LOOP_MAPPED records mapped
# with each of COLOR_TYPES at COLOR_AUG_PROB 1 on the card and on the CPU;
# each augmentor and new cv_ops stand-in timed on one host thread
# over COLOR_TIMED calls; do_train at the flagship's batch for COLOR_ITERS
# iterations with the default type at COLOR_TRAIN_PROB; P3P on COLOR_P3P
# exact sets of 4 within P3P_RAD / P3P_M, pnp_ransac(method="p3p") on 30 %
# outliers within P3P_RANSAC_DEG / P3P_RANSAC_M; se3 card vs CPU within
# SE3_ATOL. MAPPER_MS: the mapper's host ms a sample on the H100's host
# (scripts/probe_torch_loader.py, PERF.md section 5)
COLOR_TYPES, COLOR_TIMED = ("ROI10D", "SSD", "ALBU"), 5
COLOR_ITERS, COLOR_TRAIN_PROB, COLOR_P3P = 3, 0.8, 64
P3P_RAD, P3P_M, P3P_RANSAC_DEG, P3P_RANSAC_M, SE3_ATOL = 1e-9, 1e-9, 1.0, 0.01, 1e-6
MAPPER_MS = 66.24
# the JPEG codec: the case list of data/jpeg_cases.py against cv2's digests,
# then a 640x480 q95 4:2:0 frame (baseline, progressive, CMYK) timed
# JPEG_TIMED times on one thread, and the baseline one on JPEG_THREADS threads
JPEG_TIMED, JPEG_THREADS = 40, 4
# the LM-O config as a user trains it (configs/gdrn/lmo/a6_..._40e.py, full
# width, its INPUT and DATASETS blocks as they are) on an LM-O tree written
# here: the 8 LM-O objects on 8 zoo meshes (eggbox and glue on symmetric
# ones); lm/test/<obj id> with image_set/<obj>_all.txt of LMO_LM_IMAGES
# images of one instance each (lmo_train); lmo/train_pbr of LMO_PBR_SCENES x
# LMO_PBR_IMAGES frames of the 8 objects as q95 JPEGs, no xyz_crop pickles
# (lmo_pbr_train); lmo/test scene 2 of LMO_TEST_IMAGES images (lmo_test);
# LMO_VOC_IMAGES VOC_table backgrounds at VOC's sizes, LMO_VOC_NEGATIVE of
# them off the dining-table list. SOLVER.TOTAL_EPOCHS=LMO_EPOCHS gives
# LMO_EPOCHS * (8 * LMO_LM_IMAGES // 24) iterations; LMO_MAPPED PBR samples
# mapped on the card against the CPU
LMO_CONFIG = str(REPO / "configs/gdrn/lmo/a6_cPnP_AugAAETrunc_BG0.5_lmo_real_pbr0.1_40e.py")
LMO_MESHES = {1: "cube", 5: "plate", 6: "pyramid", 8: "lblock", 9: "wedge", 10: "brick",
              11: "hexprism", 12: "octa"}  # LM-O id -> zoo mesh; 10 eggbox, 11 glue
LMO_LM_IMAGES, LMO_PBR_SCENES, LMO_PBR_IMAGES, LMO_TEST_IMAGES = 12, 2, 8, 8
LMO_VOC_IMAGES, LMO_VOC_NEGATIVE, LMO_EPOCHS, LMO_MAPPED = 12, 2, 2, 8
LMO_VOC_SIZES = ((375, 500), (500, 375), (333, 500))  # (h, w)
LMO_CLI_TIMEOUT_S = 600
# device kernels of a train step by kind, from marks in their names
# the model variants and the solver zoo: [variants] takes the flagship with one
# override at a time (the JAX package's build_model switches; the direct and
# absolute translations train on TRANS_LW, as the centroid loss needs
# centroid_z; ROT_CONCAT without WITH_2D_COORD, whose 64 px coordinates its
# 128 px maps cannot take, as in JAX): an f32 forward of VARIANT_F32_CROPS on the
# card against the CPU (the [forward_f32] gate), VARIANT_STEPS bf16 train
# steps at VARIANT_BATCH, and crops/s at VARIANT_SERVE; [solvers] runs every
# optimizer name VARIANT_STEPS steps and holds its first f32 update on the
# card against the CPU's, from the same gradients, at SOLVER_UPDATE_RTOL of
# each tensor's largest step (plus the parameter's f32 ulp, as the update is
# read as after - before);
# [train_variant] trains the LM config (R50, Ranger2020, precise BN over
# TV_PRECISE_ITERS batches) through the CLI for TV_EPOCHS epoch of the
# [train_loop] split, then tests it on the BOP test split
_DIRECT_T = ["MODEL.CDPN.PNP_NET.CENTROID_LW=0.0", "MODEL.CDPN.PNP_NET.Z_LW=0.0",
             "MODEL.CDPN.PNP_NET.TRANS_LW=1.0"]
VARIANTS = {
    "ego_rot6d": ["MODEL.CDPN.PNP_NET.ROT_TYPE='ego_rot6d'"],
    "allo_quat": ["MODEL.CDPN.PNP_NET.ROT_TYPE='allo_quat'"],
    "ego_quat": ["MODEL.CDPN.PNP_NET.ROT_TYPE='ego_quat'"],
    "allo_log_quat": ["MODEL.CDPN.PNP_NET.ROT_TYPE='allo_log_quat'"],
    "allo_lie_vec": ["MODEL.CDPN.PNP_NET.ROT_TYPE='allo_lie_vec'"],
    "centroid_z_abs": ["MODEL.CDPN.PNP_NET.TRANS_TYPE='centroid_z_abs'", *_DIRECT_T],
    "trans": ["MODEL.CDPN.PNP_NET.TRANS_TYPE='trans'", *_DIRECT_T],
    "PointPnPNet": ["MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.type='PointPnPNet'"],
    "SimplePointPnPNet": ["MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.type='SimplePointPnPNet'"],
    "R_ONLY": ["MODEL.CDPN.PNP_NET.R_ONLY=True", "MODEL.CDPN.TRANS_HEAD.ENABLED=True",
               "MODEL.CDPN.TRANS_HEAD.FREEZE=False"],
    "ROT_CONCAT": ["MODEL.CDPN.ROT_HEAD.ROT_CONCAT=True", "MODEL.CDPN.PNP_NET.WITH_2D_COORD=False"],
    "R50": ["MODEL.CDPN.BACKBONE.NUM_LAYERS=50"],
    "R101": ["MODEL.CDPN.BACKBONE.NUM_LAYERS=101"],
    "R152": ["MODEL.CDPN.BACKBONE.NUM_LAYERS=152"],
    "USE_MTL": ["MODEL.CDPN.USE_MTL=True"],
    "BACKBONE.FREEZE": ["MODEL.CDPN.BACKBONE.FREEZE=True"],
}
VARIANT_F32_CROPS, VARIANT_BATCH, VARIANT_STEPS, VARIANT_SERVE = 4, 32, 5, (64, 1024)
VARIANT_TIMED = 2
# the variants that B=1024 does not fit: PointPnPNet's [B, 64, 4096, 128] region
# product (68.7 GB in bf16), and ROT_CONCAT's last upsample, [B, 320, 128, 128],
# over the INT_MAX elements that PyTorch's NHWC bilinear upsample takes
VARIANT_NO_1024 = {"PointPnPNet": "region_product_68.7GB",
                   "ROT_CONCAT": "upsample_over_INT_MAX_elements"}
SOLVER_UPDATE_RTOL, SOLVER_F32_BATCH = 1e-4, 4
LM_CONFIG = str(REPO / "configs/gdrn/lm/a6_cPnP_lm13.py")
TV_EPOCHS, TV_PRECISE_ITERS, TV_TIMEOUT_S = 1, 10, 600
# [visualize]: the CLI over the [train_loop] split's first VIS_N records,
# in each mode
VIS_N = 4
# [ddp]: (a) the CLI under torch.distributed.run, one NCCL rank, the flagship's
# B=128 over the [train_loop] split for DDP_CLI_ITERS iterations, then
# --eval-only; (b) two gloo ranks on the one card: DDP_STEPS f32 steps at a
# global DDP_BATCH against one process, then do_test sharded over the ranks
DDP_BATCH, DDP_STEPS, DDP_TIMEOUT_S, DDP_CLI_TIMEOUT_S, DDP_CLI_ITERS = 32, 3, 300, 300, 2
# (b)'s gradients at the first step, from one state on both sides: readings
# on the H100 4.7e-5 / 4.25e-4 overall, 1.51e-2 on the worst tensor (a BN
# weight: a sum over the batch with cancellation); from the second step the
# two runs are two states a rounding apart, held by the loss terms and the
# ranks' equal BN buffers
DDP_GRAD_ALL_REL, DDP_GRAD_TENSOR_REL = 5e-3, 0.05
# (b)'s model axis, in the same two ranks after their DDP steps: the flagship
# at PARALLEL.MODEL_PARALLEL=2 on a (1, 2) grid, MP_STEPS f32 steps at a global
# MP_BATCH against one process: the loss terms within TRAIN_LOSS_RTOL at each
# step, the first step's gathered gradients within the DDP_GRAD_* bounds, the
# replicated parameters bitwise equal on both ranks, pnp_net.fc1.weight held
# as [512, 8192], a rank's parameters and optimizer state at most MP_BYTES_SHARE
# of one process's (17,684,174 of 35,054,094 values: 0.5045), the gathered
# checkpoint one process's keys and shapes, and its resume the ranks' slices
MP_BATCH, MP_STEPS, MP_BYTES_SHARE = 8, 3, 0.51
MP_FC1_SHAPE = (512, 8192)

# the PnP slice: (a) ops/device_pnp.pnp_from_maps_batch on the card against the
# CPU with the same minimal sets, on synthetic_decoded_maps of PNP_B ROIs at
# PNP_HW x PNP_HW with 0.5 px noise (the default bucket), net poses
# PNP_NET_DEG and ~3 cm off: every ROI within PNP_DEG / PNP_METRE (the JAX
# package's clean-data floor, tests/test_device_pnp.py:51-52), and at least
# PNP_TRUTH_SHARE of them within PNP_TRUTH_DEG / PNP_TRUTH_M of the truth;
# (b) tools/bench_pnp at PNP_B, PNP_BENCH_ITERS chained rounds; (c) do_test
# with TEST.USE_PNP in PNP_TEST_RUNS (DEVICE_PNP, PNP_TYPE); (d) PNP_VIS_ITERS
# iterations with TRAIN.VIS_IMG at PNP_VIS_BATCH
PNP_B, PNP_HW, PNP_NET_DEG = 64, 64, 8.0
PNP_DEG, PNP_METRE = 0.05, 5e-4
PNP_TRUTH_DEG, PNP_TRUTH_M, PNP_TRUTH_SHARE = 1.0, 0.01, 0.95
PNP_BENCH_ITERS, PNP_VIS_ITERS, PNP_VIS_BATCH = 4, 3, 16
PNP_TEST_RUNS = ((True, "ransac_pnp"), (False, "net_iter_pnp"))

# the bench leg and the serving tools: [bench] at BENCH_BATCH for
# BENCH_ITERS calls; [bench_train] the step and the audit at BT_BATCH, the
# loader leg at BT_BATCH with BT_WORKERS threads for BT_LOADER_ITERS
# iterations over [train_loop]'s split (B2 at least once a sample mapped);
# [export] at EXPORT_BATCH, loaded in a child process with only torch;
# [pvnet] PVNet-34 at PVNET_RES^2 in f32, PVNET_CPU_CROPS crops on the card
# against the CPU within PVNET_REL of the outputs' scale, then its ms at
# PVNET_BATCH
BENCH_ITERS, BT_BATCH, BT_WORKERS, BT_LOADER_ITERS, BT_STEP_ITERS = 5, 128, 4, 2, 6
# the loader leg's pipelines; the pool's fill cut to BT_POOL_RECORDS records
BT_PIPELINES, BT_POOL_RECORDS = ("host", "pool", "device-prep", "device-aug"), 256
# [export]: both artifacts (bf16 and int8) bit for bit the eager forward's
# at all EXPORT_BATCH crops. The int8 one once parted at 1-5 crops: the
# exported upsample ran in bf16 where CUDA autocast runs the eager one in
# f32 (models/layers.UpsampleBilinear2x now casts it itself;
# scripts/probe_torch_export_int8.py compares every int8 layer's input).
EXPORT_BATCH, EXPORT_TIMEOUT_S = 64, 300
PVNET_RES, PVNET_CPU_CROPS, PVNET_BATCH, PVNET_REL, PVNET_TIMED = 256, 2, 64, 1e-3, 10

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


T_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One line `[phase] key=value ...`, ending in at_s, the seconds since the
    script started (the phases' share of the time limit)."""
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items())
          + f" at_s={time.perf_counter() - T_START:.1f}", flush=True)


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


def phase_build(names=("nn_min_dist", "rasterize_xyz", "jpeg_codec", "fps")) -> None:
    """Build every kernel from the checkout's sources, one nvcc each, and the
    host JPEG codec and FPS twin with g++, all started together."""
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
    for device in (DEV, "cpu"):
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
            "records": records, "models": models, "zoo": zoo}


def compare_with_plain(cfg, results, split, label: str) -> None:
    """Scene 1 scored on the card against the plain versions on the CPU:
    per-pair VSD errors (the ones each scoring computes, recorded as it runs)
    within VSD_ATOL, every recall equal except where a pair's VSD error lies
    within VSD_ATOL of a threshold."""
    models = split["models"]
    records = [r for r in split["records"] if r["scene_id"] == 1]
    results = [r for r in results if r["scene_id"] == 1]
    recorded = []  # the VSD errors of the CPU's scoring, then of the card's
    vsd_errors = bop_score._vsd_errors_by_obj

    def recording(*args, **kwargs):
        recorded.append(vsd_errors(*args, **kwargs))
        return recorded[-1]

    bop_score._vsd_errors_by_obj = recording
    try:
        t0 = time.perf_counter()
        plain = score(cfg, results, records, models, "cpu")
        plain_s = time.perf_counter() - t0
        card = score(cfg, results, records, models, DEV)
    finally:
        bop_score._vsd_errors_by_obj = vsd_errors
    if len(recorded) != 2:
        raise AssertionError(f"bop_plain {label}: {len(recorded)} VSD scorings, not 2")
    errs = recorded[::-1]  # card, CPU
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


def phase_profile(cfg, split, scored: list, timed: list, train: tuple, serving: dict,
                  fps_cloud: torch.Tensor) -> None:
    """The measurements that need torch.profiler, made last, so that no
    host-bound phase is timed after a profiler session (whether a session
    slows later launches is measured by scripts/probe_torch_zbuffer.py):
    rasterize_xyz's launches and its kernels' device ms per call at the
    timed shapes, then the device ms of one warm score_results call of each
    CSV, all of it and each kernel's share, the train step's profile, and
    each serving variant's (bf16, folded, int8, int8 + folded), and the
    device FPS's launches and busy time."""
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
    profile_serving(serving, cfg)
    profile_fps(fps_cloud)


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
    """Every tensor of a train state: the model's state dict, then the
    optimizer's per-parameter state in parameter order, then its shared
    counters."""
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
    Returns what the profiled run needs, and the median ms a step by batch
    size."""
    bs = cfg.SOLVER.IMS_PER_BATCH
    train_ms = {}
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
        train_ms[b] = float(np.median(ms))
        log("train_time", card=repr(card), batch=b, steps=len(ms),
            median_ms=f"{np.median(ms):.3f}",
            max_ms=f"{ms.max():.3f}", rois_per_s=f"{b / np.median(ms) * 1e3:.1f}",
            **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()},
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return (state, step, batch, gen, card), train_ms


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


def profiled_window(fn, n_calls: int) -> tuple[float, float, dict, int] | None:
    """n_calls of fn() under torch.profiler after one unprofiled call: the
    host-clock window ms, the device's busy ms (the union of its busy
    intervals), {device op name: us} and the number of device ops; None if
    the profiler saw no device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted(device_spans(prof), key=lambda s: s[1])
    if not spans:
        return None
    busy, end = 0.0, -1.0
    for _, a, b in spans:  # the union of the device's busy intervals
        busy += max(b, end) - max(a, end) if b > end else 0.0
        end = max(end, b)
    by_name: dict[str, float] = {}
    for name, a, b in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    return window_ms, busy / 1e3, by_name, len(spans)


def profile_train(state, step, batch, gen, card: str, n_steps: int = 5) -> None:
    """A profiled run of n_steps train steps: the device's busy share of the
    host-clock window (profiler on) and the top device operations; then one
    optimizer step alone, for Ranger's launches and device time."""
    got = profiled_window(lambda: step(state, batch, gen), n_steps)
    if got is None:
        log("train_profile", device_busy="not measured (no device events)")
        return
    window_ms, busy_ms, by_name, n_spans = got
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log("train_profile", card=repr(card), batch=len(batch["roi_img"]), steps=n_steps,
        window_ms_per_step=f"{window_ms / n_steps:.3f}",
        device_busy_ms_per_step=f"{busy_ms / n_steps:.3f}",
        device_busy_share=f"{busy_ms / window_ms:.3f}", device_ops=n_spans // n_steps)
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
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state.optimizer.step()
        torch.cuda.synchronize()
    ranger = device_spans(prof)
    log("train_ranger", card=repr(card), params=len(state.optimizer._params),
        launches_per_step=len(ranger) if ranger else "not measured",
        device_ms=f"{sum(b - a for _, a, b in ranger) / 1e3:.3f}" if ranger else "not measured")


def profile_serving(predicts: dict, cfg) -> None:
    """Each serving variant at each SERVE_ITERS batch under the profiler:
    the host-clock window and the device's busy ms a call, its device ops a
    call; for int8 also its top device operations, where its time goes."""
    for bs, batch in serve_batches(cfg).items():
        n = 5 if bs <= 64 else 1
        for name, predict in predicts.items():
            got = profiled_window(lambda: predict(batch), n)
            if got is None:
                log("serve_profile", variant=name, batch=bs, device_busy="not measured")
                continue
            window_ms, busy_ms, by_name, n_spans = got
            log("serve_profile", variant=name, batch=bs, calls=n,
                window_ms_per_call=f"{window_ms / n:.3f}",
                device_busy_ms_per_call=f"{busy_ms / n:.3f}",
                device_busy_share=f"{busy_ms / window_ms:.3f}", device_ops_per_call=n_spans // n)
            if name == "int8":
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
                print("[serve_int8_top_ops] " + json.dumps(
                    {"batch": bs, "ops": [{"name": k[:70], "ms_per_call": round(us / 1e3 / n, 4)}
                                          for k, us in top]}), flush=True)


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


def check_card_mapper(cfg, root: str) -> dict:
    """(b) LOOP_MAPPED records mapped with the kernel on the card equal the
    same records mapped with the plain rasterizer on the CPU, same seeds:
    every array bit for bit (so the hit masks too). Returns the records,
    the models, the background replacer and the CPU's renders, which
    [color_aug] maps again."""
    _, records, _, models, mapper = build_train_objects(cfg, root, DEV)
    np.random.seed(0)  # GaussianBlur(1.2*np.random.rand()) draws when a mapper is built
    card = GDRNTrainMapper(cfg, models, bg_replacer=mapper.bg, device=DEV)
    np.random.seed(0)
    cpu = GDRNTrainMapper(cfg, models, bg_replacer=mapper.bg, device="cpu")
    renders: dict = {}
    cpu._render_xyz = cached_renders(cpu._render_xyz, renders)
    recs = records[::max(1, len(records) // LOOP_MAPPED)][:LOOP_MAPPED]
    for i, rec in enumerate(recs):
        got, want = card(dict(rec), np.random.RandomState(i)), cpu(dict(rec), np.random.RandomState(i))
        for k in want:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"train_loop: record {i} {k} card vs CPU differ by "
                                     f"{np.abs(got[k].astype(np.float64) - want[k]).max()}")
    log("train_loop_mapper", records=LOOP_MAPPED, vs="cpu", arrays=len(want), bitwise_equal=True,
        check="ok")
    return {"records": recs, "models": models, "bg": mapper.bg, "renders": renders}


def time_loader(cfg, root: str) -> float:
    """Samples/s of the host loader alone (NUM_WORKERS threads, renders on
    the card; the pool off), over LOOP_LOADER_BATCHES batches after a first
    one."""
    pool_on = cfg.TRAIN.DEVICE_RESIDENT_POOL
    cfg.TRAIN.DEVICE_RESIDENT_POOL = False
    try:
        _, records, records2, _, mapper = build_train_objects(cfg, root, DEV)
        loader, _, _ = build_input_pipeline(cfg, records, records2, mapper, seed=1, device=DEV)
    finally:
        cfg.TRAIN.DEVICE_RESIDENT_POOL = pool_on
    it = iter(loader)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(LOOP_LOADER_BATCHES):
            next(it)
        return LOOP_LOADER_BATCHES * cfg.SOLVER.IMS_PER_BATCH / (time.perf_counter() - t0)
    finally:
        it.close()


class PoolWatch:
    """While active, records each DevicePool that engine/trainer builds (its
    stats and B2's launches during its fill and upload, before the refresher
    starts) and each refresher."""

    def __init__(self):
        self.pools, self.refreshers = [], []

    def __enter__(self):
        real_pool, real_pipe = trainer_mod.DevicePool, trainer_mod.build_input_pipeline

        def pool(*a, **k):
            before = kernels.rasterize_xyz.launches
            p = real_pool(*a, **k)
            self.pools.append((p, kernels.rasterize_xyz.launches - before))
            return p

        def pipeline(*a, **k):
            out = real_pipe(*a, **k)
            if out[2] is not None:
                self.refreshers.append(out[2])
            return out

        self._real = real_pool, real_pipe
        trainer_mod.DevicePool, trainer_mod.build_input_pipeline = pool, pipeline
        return self

    def __exit__(self, *exc):
        trainer_mod.DevicePool, trainer_mod.build_input_pipeline = self._real


def phase_train_loop(cfg, state_dict: dict, gsd, root: str, card: str) -> tuple[int, float]:
    """The flagship trained by engine/trainer.do_train from a BOP train split
    on disk, as its config says: from the pool on the card
    (TRAIN.DEVICE_RESIDENT_POOL) with its refresh. (a) every logged loss
    finite and no step skipped, (b) the mapper on the card against the CPU,
    (c) the state resumed from the checkpoint at LOOP_SAVE bitwise equal to
    the saved one, and the resumed run's pool loaded from the first run's
    cache with no B2 launch in its fill, (d) B2 launched at least once per
    record of the first fill; no refresh chunk torn. The host loader alone
    is timed beside it. Returns B2's launches in the loop, the host
    loader's samples/s alone and the split's objects for later phases."""
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
    mapped = check_card_mapper(c, root)
    loader_rate = time_loader(c, root)

    # the main path: do_train to LOOP_SAVE, then resumed to LOOP_ITERS, from
    # the pool with its refresh, as the flagship config says
    if not (c.TRAIN.DEVICE_RESIDENT_POOL and c.TRAIN.POOL_REFRESH):
        raise AssertionError("train_loop: the flagship config no longer trains from the pool")
    kernels.nn_min_dist.launches = 0
    kernels.rasterize_xyz.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with PoolWatch() as watch_a:
        saved, _, preempted = do_train(c, data_root=root, max_iters_override=LOOP_SAVE,
                                       device=DEV)
    run_a_s = time.perf_counter() - t0
    launches_a = kernels.rasterize_xyz.launches
    if preempted or saved.step != LOOP_SAVE:
        raise AssertionError(f"train_loop: first run ended at {saved.step}, preempted {preempted}")
    # (c) a fresh model and optimizer resumed from the checkpoint
    fresh = build_model(c, device=DEV)
    fresh_opt = build_optimizer(c, fresh,
                                build_lr_schedule(c, c.SOLVER.OPTIMIZER_CFG["lr"], LOOP_ITERS))
    resumed, start = CheckpointManager(str(Path(c.OUTPUT_DIR) / "ckpt")).resume_or_load(
        create_train_state(fresh, fresh_opt), resume=True)
    a, b = state_tensors(saved), state_tensors(resumed)
    if start != LOOP_SAVE or len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"train_loop: resumed at {start}, state not bitwise equal")
    del saved, resumed, fresh, fresh_opt, a, b
    t0 = time.perf_counter()
    with PoolWatch() as watch_b:
        state, _, preempted = do_train(c, resume=True, data_root=root,
                                       max_iters_override=LOOP_ITERS, device=DEV)
    torch.cuda.synchronize()
    run_b_s = time.perf_counter() - t0
    launches = kernels.rasterize_xyz.launches
    if preempted or state.step != LOOP_ITERS:
        raise AssertionError(f"train_loop: resumed run ended at {state.step}")
    # (c) the resumed run's pool comes from the first run's cache, no B2
    # launch in its fill; (d) the first fill launched B2 for each record
    if len(watch_a.pools) != 1 or len(watch_b.pools) != 1 or len(watch_a.refreshers) != 1:
        raise AssertionError(f"train_loop: pools built {len(watch_a.pools)}, "
                             f"{len(watch_b.pools)}; refreshers {len(watch_a.refreshers)}")
    (pool_a, fill_a), (pool_b, fill_b) = watch_a.pools[0], watch_b.pools[0]
    st_a, st_b = pool_a.stats, pool_b.stats
    if st_a["from_cache"] or not st_b["from_cache"] or fill_b or fill_a < st_a["rows"]:
        raise AssertionError(f"train_loop: first pool {st_a}, B2 {fill_a} in its fill; "
                             f"resumed pool {st_b}, B2 {fill_b} in its fill")
    refreshers = watch_a.refreshers + watch_b.refreshers
    refreshed = sum(r.refreshed for r in refreshers)
    torn = sum(r.torn_healed + r.torn_dropped for r in refreshers)
    if torn:
        raise AssertionError(f"train_loop: {torn} refresh chunks torn on the card")

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
    if kernels.nn_min_dist.launches:
        raise AssertionError(f"train_loop: nn_min_dist {kernels.nn_min_dist.launches}")
    log("train_loop_pool", card=repr(card), rows=st_a["rows"],
        mib_on_card=f"{st_a['nbytes'] / 2**20:.1f}",
        kib_per_row=f"{st_a['nbytes'] / st_a['rows'] / 1024:.1f}",
        map_s=f"{st_a['map_s']:.2f}", upload_s=f"{st_a['upload_s']:.3f}",
        cache_load_s=f"{st_b['cache_load_s']:.3f}", resumed_upload_s=f"{st_b['upload_s']:.3f}",
        fill_launches_rasterize_xyz=fill_a, resumed_fill_launches=fill_b,
        refreshed_rows=refreshed, torn_chunks=torn, check="ok")
    log("train_loop", card=repr(card), batch=c.SOLVER.IMS_PER_BATCH, workers=LOOP_WORKERS,
        input="pool+refresh", iterations=LOOP_ITERS, resumed_at=start,
        state_tensors=len(state_tensors(state)),
        resumed_bitwise_equal=True, losses_finite=True, skipped=int(skips.sum()),
        total_loss_first=f"{losses[0]:.4f}", total_loss_last=f"{losses[-1]:.4f}",
        step_ms_median=f"{np.median(step_ms):.1f}", data_ms_median=f"{np.median(data_ms):.1f}",
        data_share=f"{data_ms.sum() / step_ms.sum():.3f}",
        rois_per_s=f"{c.SOLVER.IMS_PER_BATCH / np.median(step_ms) * 1e3:.1f}",
        loader_samples_per_s=f"{loader_rate:.1f}",
        launches_rasterize_xyz=launches, launches_run1=launches_a,
        wall_s=f"{run_a_s:.1f}+{run_b_s:.1f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", check="ok")
    return launches, loader_rate, dict(
        mapped, weights=weights, data_share=data_ms.sum() / step_ms.sum(),
        rois_per_s=c.SOLVER.IMS_PER_BATCH / np.median(step_ms) * 1e3)


class CpuDraws(dev_aug.TorchKey):
    """A draw half's key whose numbers come from a CPU generator and are
    moved to `device`: the same draws on the card and on the CPU."""

    def __init__(self, seed: int, device):
        super().__init__(torch.Generator().manual_seed(seed))
        self.out = torch.device(device)

    def uniform(self, shape, lo=0.0, hi=1.0):
        return super().uniform(shape, lo, hi).to(self.out)

    def bernoulli(self, p, shape):
        return super().bernoulli(p, shape).to(self.out)

    def normal(self, shape):
        return super().normal(shape).to(self.out)

    def randint(self, shape, lo, hi):
        return super().randint(shape, lo, hi).to(self.out)


def prep_kwargs(c, color_op) -> dict:
    """device_train_batch's settings from config c, as engine/trainer builds
    them, with the colour jitter `color_op` at c's probability."""
    rh = c.MODEL.CDPN.ROT_HEAD
    return dict(input_res=c.MODEL.CDPN.BACKBONE.INPUT_RES,
                out_res=c.MODEL.CDPN.BACKBONE.OUTPUT_RES, xyz_bin=rh.XYZ_BIN,
                with_bins="CE" in rh.XYZ_LOSS_TYPE, dzi_type=c.INPUT.DZI_TYPE,
                pad_scale=c.INPUT.DZI_PAD_SCALE, scale_ratio=c.INPUT.DZI_SCALE_RATIO,
                shift_ratio=c.INPUT.DZI_SHIFT_RATIO, xyz_mask_gt=rh.XYZ_LOSS_MASK_GT,
                color_aug_type=c.INPUT.COLOR_AUG_TYPE, color_aug_prob=c.INPUT.COLOR_AUG_PROB,
                color_op=color_op)


def model_stacks(models, c, device) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        models.points_stack, models.extents_stack, models.fps_stack, models.sym_rots_stack,
        models.sym_mask_stack)] + [
        torch.tensor(c.MODEL.PIXEL_MEAN, dtype=torch.float32, device=device),
        torch.tensor(c.MODEL.PIXEL_STD, dtype=torch.float32, device=device)]


def max_diff(got: dict, want: dict) -> dict:
    return {k: float((got[k].double().cpu() - want[k].double().cpu()).abs().max())
            for k in want}


def phase_pool_parity(root: str, weights: str, card: str) -> int:
    """[pool_parity] on [train_loop]'s split with the flagship config:
    (a) the pool on the card (POOL_PARITY_ROWS records) against the card's
    mapper for the same slots and rng, inside the JAX package's envelope
    (image 0.5 LSB, xyz 5e-4, masks / region / classes / per-class
    constants exact, geometry 1e-5, bins equal at > 0.999); (b) the card's
    pool batch against the CPU's decode of the same rows within
    POOL_CPU_ATOL; (c) device_train_batch (INPUT.DEVICE_PREPROCESS with the
    flagship's colour jitter) over POOL_RAW_RECORDS raw frames on the card
    against the CPU, fed the same draws: roi_img within DEVICE_AUG_ATOL,
    masks and regions equal at POOL_LABEL_SHARE of the pixels or more; (d)
    every device_augment op on POOL_AUG_FRAMES frames, card against CPU,
    same draws, within DEVICE_AUG_ATOL. Times make_batch at B=128 and
    device_train_batch at POOL_RAW_RECORDS frames. Returns B2's launches."""
    c = loop_cfg(root, weights)
    kernels.rasterize_xyz.launches = 0
    _, records, _, models, mapper = build_train_objects(c, root, DEV)
    recs = [dict(r) for r in records[::max(1, len(records) // POOL_PARITY_ROWS)]
            ][:POOL_PARITY_ROWS]
    pool = device_pool.DevicePool(c, recs, mapper, models, device=DEV, seed=POOL_SEED,
                                  num_workers=LOOP_WORKERS)
    slots = np.arange(pool.per_shard)
    got = pool.make_batch(slots)
    samples = []
    for slot in slots:
        rec = pool.records[slot]
        smp = mapper(rec, np.random.RandomState((POOL_SEED * 1_000_003 + int(slot)) % 2 ** 31))
        smp["im_wh"] = np.asarray(rec["im_wh"], np.float32)
        samples.append(smp)
    want = {k: torch.from_numpy(v) for k, v in collate(samples).items()}
    g = {k: v.cpu() for k, v in got.items()}
    std = torch.tensor(c.MODEL.PIXEL_STD)
    mean = torch.tensor(c.MODEL.PIXEL_MEAN)
    img_lsb = float(((g["roi_img"] * std + mean) - (want["roi_img"] * std + mean)).abs().max())
    xyz = float((g["gt_xyz"] - want["gt_xyz"]).abs().max())
    exact = [k for k in ("gt_mask_trunc", "gt_mask_visib", "gt_mask_obj", "gt_region",
                         "roi_classes", "gt_points", "sym_rots", "sym_mask")
             if not torch.equal(g[k], want[k].to(g[k].dtype))]
    geom = max(max_diff(g, {k: want[k] for k in (
        "roi_cams", "roi_centers", "roi_whs", "roi_extents", "resize_ratios", "gt_ego_rot",
        "gt_trans", "gt_trans_ratio", "roi_coord_2d")}).values())
    bins_eq = float((g["gt_xyz_bin"] == want["gt_xyz_bin"]).double().mean())
    if img_lsb > 0.5 + 1e-3 or xyz >= 5e-4 or exact or geom > 1e-5 or bins_eq <= 0.999:
        raise AssertionError(f"pool_parity: pool vs mapper: image {img_lsb} LSB, xyz {xyz}, "
                             f"inexact {exact}, geometry {geom}, bins equal {bins_eq}")
    # (b) the same rows decoded on the CPU
    rows = {k: v.cpu() for k, v in pool.read_rows(slots).items()}
    cpu = device_pool._decode_rows(rows, *[t.cpu() for t in pool._stacks], pool._mean.cpu(),
                                   pool._std.cpu(), **pool._decode_static)
    card_cpu = max(max_diff(g, cpu).values())
    if card_cpu > POOL_CPU_ATOL:
        raise AssertionError(f"pool_parity: card vs CPU decode {max_diff(g, cpu)}")
    idx = np.random.RandomState(0).randint(0, pool.per_shard, 128)
    make_ms = cuda_times(lambda: pool.make_batch(idx), POOL_TIMED)

    # (c) device_train_batch, card against CPU, the same draws
    cr = loop_cfg(root, weights)
    cr.INPUT.DEVICE_PREPROCESS = cr.INPUT.DEVICE_COLOR_AUG = True
    cr.TRAIN.DEVICE_RESIDENT_POOL = False
    raw_mapper = GDRNRawTrainMapper(cr, models, bg_replacer=mapper.bg, device=DEV)
    raw = collate([raw_mapper(dict(r), np.random.RandomState(i))
                   for i, r in enumerate(records[:POOL_RAW_RECORDS])])
    order = "rgb" if cr.INPUT.get("FORMAT", "BGR").upper() == "RGB" else "bgr"
    op = dev_aug.color_aug_op(cr.INPUT.COLOR_AUG_TYPE, cr.INPUT.get("COLOR_AUG_CODE"), order)
    kw = prep_kwargs(cr, op)
    on = {dev: device_train_batch(CpuDraws(POOL_SEED, dev),
                                  {k: torch.from_numpy(v).to(dev) for k, v in raw.items()},
                                  *model_stacks(models, cr, dev), **kw)
          for dev in (DEV, "cpu")}
    d_img = float((on[DEV]["roi_img"].cpu() - on["cpu"]["roi_img"]).abs().max())
    labels = {k: (on[DEV][k].cpu() == on["cpu"][k]).double().mean().item()
              for k in ("gt_mask_trunc", "gt_mask_visib", "gt_mask_obj", "gt_region")}
    differ = {k: int((on[DEV][k].cpu() != on["cpu"][k]).sum()) for k in labels}
    if d_img > DEVICE_AUG_ATOL or min(labels.values()) < POOL_LABEL_SHARE:
        raise AssertionError(f"pool_parity: device_train_batch card vs CPU: roi_img {d_img}, "
                             f"label shares {labels}")
    raw_dev = {k: torch.from_numpy(v).to(DEV) for k, v in raw.items()}
    stacks_dev = model_stacks(models, cr, DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    dtb_ms = cuda_times(lambda: device_train_batch(dev_aug.TorchKey(gen), raw_dev, *stacks_dev,
                                                   **kw), 5)

    # (d) every op of device_augment, card against CPU, the same draws
    frames = raw["image"][:POOL_AUG_FRAMES].astype(np.float32)
    ops = {"add": dev_aug.add_op(), "multiply": dev_aug.multiply_op(),
           "linear_contrast": dev_aug.linear_contrast_op(), "invert": dev_aug.invert_op(),
           "additive_gaussian_noise": dev_aug.additive_gaussian_noise_op(),
           "dropout": dev_aug.dropout_op(per_channel=0.5), "grayscale": dev_aug.grayscale_op(),
           "coarse_dropout": dev_aug.coarse_dropout_op(), "saturation": dev_aug.saturation_op(),
           "gaussian_blur": dev_aug.gaussian_blur_op(), "aae": dev_aug.aae_aug_op(),
           "roi10d": dev_aug.roi10d_aug_op(), "flagship_code": op,
           "one_of": dev_aug.one_of([dev_aug.add_op(), dev_aug.grayscale_op()]),
           "sometimes": dev_aug.sometimes(0.5, dev_aug.multiply_op())}
    op_err = {}
    for i, (name, o) in enumerate(ops.items()):
        a = o(CpuDraws(i, DEV), torch.from_numpy(frames).to(DEV)).cpu()
        b = o(CpuDraws(i, "cpu"), torch.from_numpy(frames))
        op_err[name] = float((a - b).abs().max())
    if max(op_err.values()) > DEVICE_AUG_ATOL:
        raise AssertionError(f"pool_parity: device_augment card vs CPU {op_err}")
    launches = kernels.rasterize_xyz.launches
    if launches < len(recs):
        raise AssertionError(f"pool_parity: B2 launched {launches} times for {len(recs)} rows")
    log("pool_parity", card=repr(card), rows=pool.per_shard, vs="mapper on the card",
        img_max_lsb=f"{img_lsb:.4f}", xyz_max=f"{xyz:.3e}", geometry_max=f"{geom:.3e}",
        bins_equal=f"{bins_eq:.5f}", exact="masks,region,classes,constants",
        card_vs_cpu_decode_max=f"{card_cpu:.3e}", dtb_records=POOL_RAW_RECORDS,
        dtb_roi_img_max=f"{d_img:.3e}",
        dtb_label_share=json.dumps({k: round(v, 6) for k, v in labels.items()}),
        dtb_label_pixels_differ=json.dumps(differ),
        ops_max=json.dumps({k: float(f"{v:.3e}") for k, v in op_err.items()}),
        make_batch_b128_ms=f"{np.median(make_ms):.3f}",
        dtb_ms=f"{np.median(dtb_ms):.2f}", launches_rasterize_xyz=launches, check="ok")
    return launches


def cached_renders(render, cache: dict):
    """A mapper's _render_xyz that renders each instance once: the plain
    rasterizer's XYZ of one record is the same for every colour type."""
    def fn(rec, im_h, im_w):
        key = (rec["rgb_path"], rec["R"].tobytes(), rec["t"].tobytes())
        if key not in cache:
            cache[key] = render(rec, im_h, im_w)
        return cache[key].copy()
    return fn


def color_aug_mappers(root: str, loop: dict) -> None:
    """(a) of [color_aug]: for each of COLOR_TYPES at COLOR_AUG_PROB 1,
    [train_loop]'s LOOP_MAPPED records mapped on the card and on the CPU
    with the same seeds, LOOP_WORKERS records at a time (the CPU's renders
    are [train_loop]'s, which are the same for every type): every array bit
    for bit, every frame changed by the jitter (the frame it was given is
    what COLOR_AUG_PROB=0 would crop, on the same draws), B2 launched at
    least once a sample."""
    recs, models, bg = loop["records"], loop["models"], loop["bg"]
    for kind in COLOR_TYPES:
        ck = loop_cfg(root, loop["weights"])
        ck.INPUT.COLOR_AUG_TYPE, ck.INPUT.COLOR_AUG_PROB = kind, 1.0
        ck.INPUT.COLOR_AUG_SYN_ONLY = False
        np.random.seed(0)
        card = GDRNTrainMapper(ck, models, bg_replacer=bg, device=DEV)
        np.random.seed(0)
        cpu = GDRNTrainMapper(ck, models, bg_replacer=bg, device="cpu")
        cpu._render_xyz = cached_renders(cpu._render_xyz, loop["renders"])
        changed = []

        def recording(img, rng, aug=card.color_aug):
            out = aug(img, rng)
            changed.append(not np.array_equal(out, img))
            return out

        card.color_aug = recording

        def compare(i, rec, card=card, cpu=cpu, kind=kind):
            got = card(dict(rec), np.random.RandomState(i))
            want = cpu(dict(rec), np.random.RandomState(i))
            for k in want:
                if not np.array_equal(got[k], want[k]):
                    raise AssertionError(f"color_aug {kind}: record {i} {k} card vs CPU differ")
            return len(want)

        before = kernels.rasterize_xyz.launches
        t0 = time.perf_counter()
        with ThreadPoolExecutor(LOOP_WORKERS) as pool:  # as the loader's threads map
            arrays = list(pool.map(compare, range(len(recs)), recs))
        launches = kernels.rasterize_xyz.launches - before
        if len(changed) != len(recs) or not all(changed) or launches < len(recs):
            raise AssertionError(f"color_aug {kind}: {sum(changed)} of {len(changed)} frames "
                                 f"jittered for {len(recs)} records, B2 launched {launches}")
        log("color_aug_mapper", type=kind, records=len(recs), vs="cpu", arrays=arrays[0],
            bitwise_equal=True, frames_jittered=sum(changed), b2_launches=launches,
            wall_s=f"{time.perf_counter() - t0:.1f}", check="ok")


def color_aug_host_ms(frame: np.ndarray, code: str) -> None:
    """(b) of [color_aug]: the host ms a call (median of COLOR_TIMED, one
    thread) of each augmentor on a 640x480 frame (seeds 0.. so that the
    branches vary) and of each new cv_ops stand-in, beside the mapper's
    ms a sample."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        seeds = iter(range(10 ** 6))
        augs = {kind: build_color_augmentor(kind, code)
                for kind in ("ROI10D", "SSD", "ALBU", "AAE", "code")}
        aug_ms = {k: float(np.median(host_times(
            lambda a=a: a(frame, np.random.RandomState(next(seeds))), COLOR_TIMED, warmup=1)))
            for k, a in augs.items()}
        gray = cv_ops.bgr_to_lab(frame)[..., 0]
        mask = (gray > 128).astype(np.uint8)
        h, w = gray.shape
        poly = [np.array([[w // 8, h // 8], [w // 2, h // 16], [7 * w // 8, h // 3],
                          [3 * w // 4, 7 * h // 8], [w // 3, 3 * h // 4], [w // 16, h // 2]])]
        motion = np.zeros((5, 5), np.float32)
        motion[2] = 0.2
        crop = frame.astype(np.float32)
        M = np.array([[0.5, 0.0, -100.0], [0.0, 0.5, -60.0]])
        ops = {"bgr_to_hsv": lambda: cv_ops.bgr_to_hsv(frame),
               "hsv_to_bgr": lambda: cv_ops.hsv_to_bgr(frame),
               "bgr_to_lab": lambda: cv_ops.bgr_to_lab(frame),
               "lab_to_bgr": lambda: cv_ops.lab_to_bgr(frame),
               "clahe": lambda: cv_ops.clahe(gray, 2.0),
               "filter2d_u8_motion5": lambda: cv_ops.filter2d_u8(frame, motion),
               "filter2d_u8_sharpen": lambda: cv_ops.filter2d_u8(frame, augment_mod._SHARPEN),
               "box_blur3_u8": lambda: cv_ops.box_blur3_u8(frame),
               "warp_affine_f32_256": lambda: cv_ops.warp_affine(crop, M, 256),
               "fill_poly": lambda: cv_ops.fill_poly(np.zeros_like(mask), poly, 1),
               "dilate3": lambda: cv_ops.dilate(mask, 3), "erode3": lambda: cv_ops.erode(mask, 3)}
        op_ms = {k: float(np.median(host_times(f, COLOR_TIMED, warmup=1))) for k, f in ops.items()}
    finally:
        torch.set_num_threads(threads)
    fmt = lambda d: json.dumps({k: f"{v:.2f}" for k, v in d.items()}).replace(" ", "")  # noqa: E731
    log("color_aug_host", frame=f"{w}x{h}", threads=1, calls=COLOR_TIMED,
        augmentor_ms_median=fmt(aug_ms), cv_ops_ms_median=fmt(op_ms),
        mapper_ms_per_sample=MAPPER_MS,
        added_share_of_mapper=fmt({k: v / MAPPER_MS for k, v in aug_ms.items()}))


def color_aug_train(root: str, card: str, loop: dict) -> int:
    """(c) of [color_aug]: do_train at the flagship's batch for COLOR_ITERS
    iterations with the default COLOR_AUG_TYPE at COLOR_TRAIN_PROB: every
    loss finite, no step skipped, B2 at least once a sample; ROIs/s and the
    data-wait share beside [train_loop]'s. Returns B2's launches."""
    ct = loop_cfg(root, loop["weights"])
    ct.OUTPUT_DIR = str(Path(root) / "color_out")
    ct.INPUT.COLOR_AUG_TYPE, ct.INPUT.COLOR_AUG_PROB = "ROI10D", COLOR_TRAIN_PROB
    kernels.nn_min_dist.launches = 0
    kernels.rasterize_xyz.launches = 0
    t0 = time.perf_counter()
    state, _, preempted = do_train(ct, data_root=root, max_iters_override=COLOR_ITERS, device=DEV)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.rasterize_xyz.launches
    with open(Path(ct.OUTPUT_DIR) / "metrics.json") as f:
        rows = [json.loads(ln) for ln in f]
    losses = np.array([r["total_loss"] for r in rows])
    skips = np.array([r["nonfinite_skip"] for r in rows])
    samples = COLOR_ITERS * ct.SOLVER.IMS_PER_BATCH
    if preempted or state.step != COLOR_ITERS or [r["iteration"] for r in rows] != list(
            range(COLOR_ITERS)) or not np.all(np.isfinite(losses)) or skips.any() \
            or launches < samples:
        raise AssertionError(f"color_aug train: step {state.step}, losses {losses.tolist()}, "
                             f"skips {skips.tolist()}, B2 {launches} for {samples} samples")
    # the first iteration warms up; the last fetches no next batch, so its
    # time/step holds no data wait while its time/data is the previous one
    steady = rows[1:-1]
    step_ms = np.array([r["time/step"] for r in steady]) * 1e3
    data_ms = np.array([r["time/data"] for r in steady]) * 1e3
    log("color_aug_train", card=repr(card), type="ROI10D", prob=COLOR_TRAIN_PROB,
        batch=ct.SOLVER.IMS_PER_BATCH, iterations=COLOR_ITERS, losses_finite=True,
        skipped=int(skips.sum()), total_loss_last=f"{losses[-1]:.4f}",
        step_ms_median=f"{np.median(step_ms):.1f}", data_ms_median=f"{np.median(data_ms):.1f}",
        rois_per_s=f"{ct.SOLVER.IMS_PER_BATCH / np.median(step_ms) * 1e3:.1f}",
        data_share=f"{data_ms.sum() / step_ms.sum():.3f}",
        train_loop_rois_per_s=f"{loop['rois_per_s']:.1f}",
        train_loop_data_share=f"{loop['data_share']:.3f}",
        launches_rasterize_xyz=launches, wall_s=f"{wall_s:.1f}", check="ok")
    return launches


def p3p_scene(rng, K: np.ndarray, n: int, noise: float = 0.0, outliers: float = 0.0):
    """A pose 0.9 m away and n points of a 0.2 m cube, projected with K."""
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    R = Q * np.sign(np.linalg.det(Q))
    t = np.array([0.05, -0.03, 0.9]) + rng.randn(3) * 0.05
    p3 = (rng.rand(n, 3) - 0.5) * 0.2
    uv = (p3 @ R.T + t) @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + rng.randn(n, 2) * noise
    k = int(n * outliers)
    if k:
        uv[n - k:] = rng.rand(k, 2) * [640, 480]
    return R, t, p3, uv


def color_aug_p3p_se3(K: np.ndarray) -> None:
    """(d) of [color_aug], with no cv2: solve_pnp("p3p") on COLOR_P3P exact
    sets of 4 within P3P_RAD and P3P_M of the truth; pnp_ransac(method=
    "p3p") on 30 % outliers within P3P_RANSAC_DEG and P3P_RANSAC_M; the se3
    functions on CUDA tensors within SE3_ATOL of the CPU."""
    rng = np.random.RandomState(21)
    rad, m = [], []
    for _ in range(COLOR_P3P):
        R, t, p3, uv = p3p_scene(rng, K, 4)
        ok, rv, tv = cv_pnp.solve_pnp(p3, uv, K, flags="p3p")
        if not ok:
            raise AssertionError("p3p: no root for an exact set")
        rad.append(np.radians(rot_deg(cv_pnp.rodrigues(rv), R)))
        m.append(np.abs(tv.ravel() - t).max())
    deg, dm = [], []
    for _ in range(4):
        R, t, p3, uv = p3p_scene(rng, K, 300, noise=0.5, outliers=0.3)
        pose = pnp_mod.pnp_ransac(p3, uv, K, method="p3p")
        deg.append(rot_deg(pose[:, :3], R))
        dm.append(np.linalg.norm(pose[:, 3] - t))
    u = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32))
    t3 = torch.from_numpy(rng.randn(2, 64, 3).astype(np.float32))
    got = {}
    for device in ("cpu", DEV):
        R1, R2 = (se3.rotations_from_uniforms(x.to(device)) for x in u)
        t1, t2 = t3[0].to(device), t3[1].to(device)
        outs = [se3.rt_to_mat4(R1, t1), *se3.se3_mul(R1, t1, R2, t2), *se3.se3_inverse(R1, t1),
                *se3.relative_pose(R1, t1, R2, t2), *se3.interpolate_poses(R1, t1, R2, t2, 0.3)]
        got[device] = [o.cpu().numpy() for o in outs]
    se3_err = max(float(np.abs(a - b).max()) for a, b in zip(got["cpu"], got[DEV]))
    Rg = se3.random_rotations(torch.Generator(device=DEV).manual_seed(0), 64)
    ortho = float((Rg @ Rg.transpose(-1, -2) - torch.eye(3, device=Rg.device)).abs().max())
    if max(rad) > P3P_RAD or max(m) > P3P_M or max(deg) > P3P_RANSAC_DEG \
            or max(dm) > P3P_RANSAC_M or se3_err > SE3_ATOL or ortho > ORTHO_ATOL:
        raise AssertionError(f"p3p / se3: rad {max(rad)}, m {max(m)}, ransac deg {max(deg)} "
                             f"m {max(dm)}, se3 {se3_err}, ortho {ortho}")
    log("color_aug_p3p_se3", p3p_sets=COLOR_P3P, p3p_rad_max=f"{max(rad):.2e}",
        p3p_m_max=f"{max(m):.2e}", ransac_scenes=len(deg), ransac_outliers=0.3,
        ransac_deg_max=f"{max(deg):.3f}", ransac_m_max=f"{max(dm):.4f}",
        se3_card_vs_cpu_max_abs=f"{se3_err:.2e}", random_rotations_ortho=f"{ortho:.1e}",
        check="ok")


def phase_color_aug(root: str, card: str, loop: dict) -> int:
    """[color_aug]: every COLOR_AUG_TYPE of the host train path on the card
    over [train_loop]'s 640x480 split with the flagship (a) the mapper per
    type, card against CPU, (b) the host cost of each augmentor and
    stand-in, (c) a short training run with the default type, (d) P3P and
    se3 without cv2. Returns B2's launches in (c)."""
    t0 = time.perf_counter()
    color_aug_mappers(root, loop)
    rec = loop["records"][0]
    code = loop_cfg(root, loop["weights"]).INPUT.COLOR_AUG_CODE
    color_aug_host_ms(read_image(rec["rgb_path"]), code)
    launches = color_aug_train(root, card, loop)
    color_aug_p3p_se3(rec["K"].astype(np.float64))
    log("color_aug", types=",".join(COLOR_TYPES), phase_s=f"{time.perf_counter() - t0:.1f}",
        check="ok")
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
    that of the GT instances left without a detection. Then the same test
    with TEST.DEVICE_PREPROCESS (the crops warped on the card): B1 launched
    inside it, its recalls the host mapper's but where a threshold flip of
    the error kind is counted. Returns (the host run's results, its CSV
    rows, B1 and B2 launches of both runs)."""
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
    # the same test with TEST.DEVICE_PREPROCESS: the crops warped on the card
    cd = test_cfg(cfg, dets)
    cd.TEST.DEVICE_PREPROCESS = True
    kernels.nn_min_dist.launches = 0
    t0 = time.perf_counter()
    res_d = do_test(cd, model, split["models"], split["records"],
                    output_dir=str(Path(root) / "test_out_devprep"), device=DEV)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    b1_d = kernels.nn_min_dist.launches
    rows_d = load_bop_results(res_d["_csv_path"])
    csv_rows_check(rows_d, "do_test device preprocess")
    flips = threshold_flips(c, rows, rows_d, split["records"], split["models"])
    differ = recalls_differ("do_test device preprocess", res, res_d, flips)
    if len(rows_d) != len(rows) or b1_d < 1:
        raise AssertionError(f"do_test device preprocess: {len(rows_d)} rows for {len(rows)}, "
                             f"B1 {b1_d}")
    rot_d = np.array([rot_deg(a["R"][None], b["R"][None])[0] for a, b in zip(rows, rows_d)])
    log("do_test_device_preprocess", card=repr(card), rois=len(rows_d),
        launches_nn_min_dist=b1_d, recalls_differ=len(differ),
        threshold_flips=json.dumps(flips), rot_deg_max_vs_host=f"{rot_d.max():.4f}",
        rot_deg_median_vs_host=f"{np.median(rot_d):.4f}",
        compute_s_per_bucket=f"{res_d['_time']['compute_s_per_bucket']:.4f}",
        wall_s=f"{wall_d:.2f}", ar_bop19=f"{res_d['_bop_average_recall']:.4f}", check="ok")
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
    return res, rows, (launches[0] + b1_d, launches[1])


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
    """The engine.train CLI's main with --eval-only on the card (what
    `python -m gdrnet_tpu_torch.engine.train` calls; [train_variant],
    [train_lmo] and [ddp] run the CLI in processes of its own) over the
    split as a dataset name (<dir>_test of a directory with meta.json), the
    detections and the checkpoint: it returns, results.json,
    config_dump.json and the CSV are written, recalls equal to
    [do_test]'s."""
    split_dir = Path(split["models"].meta.data_root)
    out = Path(root) / "cli_out"
    argv = ["--config-file", FLAGSHIP, "--eval-only", "--data-root", str(split_dir.parent),
            f"DATASETS.TEST=({split_dir.name + '_test'!r},)",
            f"DATASETS.DET_FILES_TEST=({dets['path']!r},)", f"MODEL.WEIGHTS={weights!r}",
            f"OUTPUT_DIR={str(out)!r}"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(argv, device=DEV)
    wall_s = time.perf_counter() - t0
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
    log("cli", wall_s=f"{wall_s:.1f}", csv_rows=len(rows),
        files="results.json,config_dump.json,csv",
        ar_bop19=f"{res['_bop_average_recall']:.4f}",
        recalls_vs_do_test="equal" if not differ else f"differ at {len(differ)} (flips)",
        threshold_flips=json.dumps(flips).replace(" ", ""), check="ok")


def phase_overfit(root: str, card: str) -> tuple:
    """The learning check through gdrnet_tpu_torch/tools/validate_overfit.py
    (its split, its config, its seed function): every record of its
    2-object split mapped once, then the tool's TOTAL train steps on that one
    batch on the card and do_test on the same records with GT boxes, for
    each of OVERFIT_SEEDS. Gates: every loss finite; the sum of the loss
    terms other than the region CE below OVERFIT_LOSS_RATIO times its first
    value, and the region CE below its first (the reference's region CE
    keeps a floor of about ln(R+1) times the crop's pixels over its visible
    ones, losses/gdrn_loss.py:85-89, so the total cannot fall to
    OVERFIT_LOSS_RATIO of its first: the JAX package's own run stays near
    0.24); Avg mean_re below OVERFIT_MAX_RE_DEG. Returns (config, the last
    seed's trained model, the mapped batch) for [int8], and the launches of
    B1 (do_test's ADD-S of the brick) and B2 (the split's renders)."""
    b1, b2 = kernels.nn_min_dist.launches, kernels.rasterize_attr.launches
    meta = overfit_tool.overfit_split(str(Path(root) / "overfit"), overfit_tool.IMAGES,
                                      device=DEV)
    c = overfit_tool.overfit_cfg()
    split = overfit_tool.map_split(c, meta, DEV)
    for seed in OVERFIT_SEEDS:
        run = overfit_tool.run_seed(c, split, seed, str(Path(root) / f"overfit_out_{seed}"), DEV,
                                    echo=lambda line: None)
        hist, res, train_s = run["history"], run["results"], run["train_s"]
        total, region = hist["total_loss"], hist["loss_region"]
        others = total - region
        avg = res["Avg"]
        log("overfit", card=repr(card), seed=seed, records=len(split[0]),
            images=overfit_tool.IMAGES, steps=overfit_tool.TOTAL,
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
        trained, batch = run["model"], run["batch"]
        del run
    launches = (kernels.nn_min_dist.launches - b1, kernels.rasterize_attr.launches - b2)
    if launches[0] < len(OVERFIT_SEEDS) or launches[1] < 1:
        raise AssertionError(f"overfit: B1 launched {launches[0]} times over {len(OVERFIT_SEEDS)} "
                             f"do_test runs, B2 {launches[1]} times writing the split")
    log("overfit_launches", b1=launches[0], b2=launches[1], check="ok")
    return (c, trained, batch), launches


def phase_scale_run(root: str) -> None:
    """gdrnet_tpu_torch/tools/scale_run.py --dry-run in this process, its
    paths pointed at an empty layout under `root`: every stage listed, in
    order, none done, each running one of the port's CLIs, nothing run."""
    layout = Path(root) / "scale_run_layout"
    paths = {"REPO": layout, "SYNTH": layout / "datasets/BOP_DATASETS/synth",
             "OUT": layout / "output/gdrn/synth/a6_cPnP_synth",
             "LOGDIR": layout / "output/gdrn/synth/scale_run",
             "CKPT_DIR": layout / "checkpoints/bench_default"}
    saved = {k: getattr(scale_run_tool, k) for k in paths}
    out = io.StringIO()
    try:
        for k, v in paths.items():
            setattr(scale_run_tool, k, str(v))
        names = [st.name for st in scale_run_tool.build_stages()]
        with contextlib.redirect_stdout(out):
            scale_run_tool.main(["--dry-run"])
    finally:
        for k, v in saved.items():
            setattr(scale_run_tool, k, v)
    lines = out.getvalue().splitlines()
    heads = [ln.split(":")[0] for ln in lines if not ln.startswith("  ")]
    commands = [ln for ln in lines if ln.startswith("  ") and "retry: " not in ln]
    if (heads != names or names != SCALE_RUN_STAGES or len(commands) != len(names)
            or any("done=False" not in ln for ln in lines if not ln.startswith("  "))
            or not all("gdrnet_tpu_torch." in ln for ln in commands)
            or (paths["LOGDIR"] / "status.jsonl").exists()):
        raise AssertionError(f"scale_run --dry-run: stages {heads}, expected {SCALE_RUN_STAGES}:\n"
                             + out.getvalue())
    log("scale_run", stages=len(names), names=",".join(names), dry_run="every stage listed, "
        "none done, nothing run", check="ok")


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


def fps_native_builds(out_dir: Path) -> dict:
    """csrc/fps.cpp built with the JAX package's flags for its C++ FPS (g++
    -O3 -march=native; its -fopenmp is left out, the port's source has no
    OpenMP) for this host's CPU: "native" as the source stands,
    "contracted" with its fp-contract pragma taken out, so that g++ may fuse
    the distance's multiply-adds. {label: library}."""
    src = (REPO / "gdrnet_tpu_torch/csrc/fps.cpp").read_text()
    head, rest = src.split("#if defined(__clang__)", 1)
    sources = {"native": src, "contracted": head + rest.split("#endif", 1)[1]}
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(label):
        cpp, lib = out_dir / f"fps_{label}.cpp", out_dir / f"libfps_{label}.so"
        cpp.write_text(sources[label])
        proc = subprocess.run([csrc.find_gxx(), "-O3", "-march=native", "-shared", "-fPIC",
                               "-o", str(lib), str(cpp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise AssertionError(f"fps {label} build: {proc.stderr[-2000:]}")
        return label, fps_ops.declare(ctypes.CDLL(str(lib)))

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


def fps_pkl_differences(got: dict, want: dict) -> list:
    """The (object, key) pairs where two fps_points.pkl dicts differ in keys,
    dtype or bits."""
    if list(got) != list(want):
        return [("objects", sorted(set(got) ^ set(want)))]
    bad = []
    for obj, entry in want.items():
        if list(got[obj]) != list(entry):
            bad.append((obj, "keys"))
            continue
        bad += [(obj, key) for key, arr in entry.items()
                if got[obj][key].dtype != arr.dtype or not np.array_equal(got[obj][key], arr)]
    return bad


def phase_fps(root: str, card: str):
    """Farthest point sampling as a user runs it on [gen_dataset]'s models
    directory. Gates: the device FPS on the card (ops/fps.
    farthest_point_sampling_idx) and the C++ twin (csrc/fps.cpp) give
    farthest_point_sampling_np's indices on every cloud: the 10 meshes at
    every K of FPS_COUNTS up to n, the lattice and the cylinder (exact ties)
    from each of FPS_STARTS, FPS_BIG random points; the device FPS makes no
    host sync (torch.cuda sync debug mode "error"); the twin built for this
    host with -O3 -march=native equals numpy too (the picks of a
    build whose distance g++ may contract into FMAs are counted, not gated);
    the compute_fps CLI's main in this process, --device cuda and then
    --device cpu, writes fps_points.pkl bit for bit as the generator wrote
    it. Times: the device FPS at FPS_BIG x FPS_BIG_K (CUDA events and host
    clock, median of FPS_TIMED after one warm-up), the twin on the host
    (median of FPS_TIMED), numpy (the gate's one run), each CLI run's wall
    s. Returns the FPS_BIG cloud on the card, for [fps_device]'s profile in
    the last phase."""
    mdir = Path(root) / "gen" / "synth_smoke" / "models"
    with open(mdir / "models_info.json") as f:
        ids = sorted(int(k) for k in json.load(f))
    clouds = {f"obj_{i}": load_ply(str(mdir / f"obj_{i:06d}.ply"), vertex_scale=0.001)["pts"]
              for i in ids}
    cases = [(name, pts, k, True, 0) for name, pts in clouds.items()
             for k in compute_fps_tool.FPS_COUNTS if k <= len(pts)]
    ties = {"lattice": lattice_cloud(FPS_LATTICE), "cylinder": cylinder_cloud(*FPS_CYLINDER)}
    cases += [(name, pts, FPS_TIE_K, ic, s) for name, pts in ties.items() for ic, s in FPS_STARTS]
    big = np.random.RandomState(19).randn(FPS_BIG, 3).astype(np.float32)
    cases.append(("random", big, FPS_BIG_K, True, 0))
    native = fps_native_builds(Path(root) / "fps_native")
    contracted: dict = defaultdict(int)
    picks = 0
    for name, pts, k, ic, s in cases:
        t0 = time.perf_counter()
        want = fps_ops.farthest_point_sampling_np_idx(pts, k, ic, s)
        if name == "random":
            numpy_ms = (time.perf_counter() - t0) * 1e3
        got = {"card": fps_ops.farthest_point_sampling_idx(
                   torch.from_numpy(pts).to(DEV), k, ic, s).cpu().numpy(),
               "cpp": fps_ops.farthest_point_sampling_cpp_idx(pts, k, ic, s),
               "cpp_march_native": fps_ops.fps_sample(native["native"], pts, k, ic, s)}
        bad = {label: int((idx != want).sum()) for label, idx in got.items()
               if not np.array_equal(idx, want)}
        if bad:
            raise AssertionError(f"fps {name} k={k} init_center={ic} start_idx={s}: picks "
                                 f"differing from numpy {bad}")
        group = name if not name.startswith("obj_") else "meshes"
        contracted[group] += int((fps_ops.fps_sample(native["contracted"], pts, k, ic, s)
                                  != want).sum())
        picks += k
    sizes = [len(pts) for pts in clouds.values()]
    log("fps", card=repr(card), meshes=len(clouds), mesh_vertices=f"{min(sizes)}-{max(sizes)}",
        mesh_cases=sum(1 for c in cases if c[0].startswith("obj_")),
        tie_clouds=f"lattice {FPS_LATTICE}^3 and cylinder {FPS_CYLINDER[0]}x"
                   f"{FPS_CYLINDER[1]} at K={FPS_TIE_K} from {len(FPS_STARTS)} starts",
        big=f"{FPS_BIG}x{FPS_BIG_K}", picks=picks,
        card_cpp_native_vs_numpy="equal at every pick",
        contracted_build_picks_differing=json.dumps(dict(contracted)).replace(" ", ""),
        check="ok")

    on_card = torch.from_numpy(ties["lattice"]).to(DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fps_ops.farthest_point_sampling_idx(on_card, FPS_TIE_K)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    big_card = torch.from_numpy(big).to(DEV)

    def run():
        return fps_ops.farthest_point_sampling_idx(big_card, FPS_BIG_K)

    device_ms = cuda_times(run, FPS_TIMED, warmup=1)
    wall_ms = host_times(run, FPS_TIMED, warmup=0)
    cpp_ms = host_times(lambda: fps_ops.farthest_point_sampling_cpp_idx(big, FPS_BIG_K),
                        FPS_TIMED, warmup=1)
    # each step reads the cloud (12 B a point) and reads and writes min_d (8 B)
    bytes_ms = FPS_BIG_K * FPS_BIG * 20 / HBM_BYTES_PER_S * 1e3
    log("fps_time", card=repr(card), shape=f"{FPS_BIG}x{FPS_BIG_K}",
        device_ms_median=f"{np.median(device_ms):.3f}",
        device_ms=",".join(f"{m:.3f}" for m in device_ms),
        wall_ms_median=f"{np.median(wall_ms):.3f}", bytes_bound_ms=f"{bytes_ms:.4f}",
        cpp_host_ms_median=f"{np.median(cpp_ms):.3f}", numpy_host_ms=f"{numpy_ms:.3f}",
        cpp_vs_numpy=f"{numpy_ms / np.median(cpp_ms):.2f}x")

    want = pickle.loads((mdir / "fps_points.pkl").read_bytes())
    walls = {}
    for device in (DEV, "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = compute_fps_tool.main(["--models-dir", str(mdir), "--device", device])
        walls[device] = time.perf_counter() - t0
        bad = fps_pkl_differences(pickle.loads(Path(out).read_bytes()), want)
        lines = printed.getvalue().splitlines()
        if bad or len(lines) != len(ids) + 1 or lines[-1] != f"saved {out}":
            raise AssertionError(f"compute_fps --device {device}: differs from the "
                                 f"generator's file at {bad[:5]}; printed {lines[-2:]}")
    log("fps_cli", card=repr(card), objects=len(ids),
        keys=sum(len(e) for e in want.values()),
        **{f"wall_s_{d}": f"{w:.3f}" for d, w in walls.items()},
        vs="the generator's fps_points.pkl", rule="bit for bit", check="ok")
    return big_card


def profile_fps(big: torch.Tensor) -> None:
    """The device FPS's launches and device busy ms a step over FPS_PROFILED
    steps on the FPS_BIG cloud, beside the call's host-clock ms
    (torch.profiler; a profile of the timed call's 256 steps took 7-16 s
    to read back)."""
    def run():
        return fps_ops.farthest_point_sampling_idx(big, FPS_PROFILED)

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    if not spans:
        log("fps_device", device_ms="not measured")
        return
    busy = sum(end - start for _, start, end in spans) / 1e3
    log("fps_device", shape=f"{len(big)}x{FPS_PROFILED}", launches=len(spans),
        launches_per_step=f"{len(spans) / FPS_PROFILED:.2f}", busy_ms=f"{busy:.3f}",
        busy_ms_per_step=f"{busy / FPS_PROFILED:.4f}", wall_ms_profiled=f"{wall:.3f}",
        busy_share=f"{busy / wall:.3f}")


def serve_times(models: dict, batches: dict) -> dict:
    """{(name, batch size): crops/s} of each predict step in `models` over
    `batches`, by CUDA events, in turns (each once forward, then once
    backward, SERVE_ITERS[bs] calls a turn) so that a drift of the card's
    clock hits them alike; one warm-up call a turn); medians over both
    turns."""
    out = {}
    for bs, batch in batches.items():
        ms = defaultdict(list)
        for order in (list(models), list(models)[::-1]):
            for name in order:
                ms[name].append(cuda_times(lambda: models[name](batch), SERVE_ITERS[bs], 1))
        for name in models:
            out[name, bs] = bs / float(np.median(np.concatenate(ms[name]))) * 1e3
    return out


def serve_batches(cfg) -> dict:
    res = cfg.MODEL.CDPN.BACKBONE.INPUT_RES, cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES
    return {bs: to_device(synthetic_roi_batch(
        batch_size=bs, input_res=res[0], out_res=res[1],
        num_classes=cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES, seed=7), DEV) for bs in SERVE_ITERS}


def phase_fold_bn(cfg, cfg32, weights: str, request: dict) -> dict:
    """TEST.FOLD_BN on the flagship with [train_loop]'s checkpoint (its BN
    statistics trained): the folded f32 forward on the card (TF32 off)
    against the unfolded one within FOLD_POSE_ATOL, then bf16 serving
    crops/s, folded beside unfolded, at each SERVE_ITERS batch. Returns the
    crops/s."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = load_weights(build_model(cfg32, device=DEV), weights)
    batch = to_device(request, DEV)
    want = make_predict_step(m32)(batch)
    got = make_predict_step(fold_batch_norms(m32))(batch)
    rot_err = float((got["rot"] - want["rot"]).abs().max())
    trans_err = float((got["trans"] - want["trans"]).abs().max())
    if rot_err > FOLD_POSE_ATOL or trans_err > FOLD_POSE_ATOL:
        raise AssertionError(f"fold_bn: folded f32 forward differs by rot {rot_err}, "
                             f"trans {trans_err}")
    del m32
    model = load_weights(build_model(cfg, device=DEV), weights)
    rates = serve_times({"bf16": make_predict_step(model),
                         "bf16_folded": make_predict_step(fold_batch_norms(model))},
                        serve_batches(cfg))
    log("fold_bn", crops=len(request["roi_img"]), vs="unfolded f32 on the card",
        pairs=len(conv_bn_pairs(model)), rot_max_abs=f"{rot_err:.3e}",
        trans_max_abs=f"{trans_err:.3e}", atol=FOLD_POSE_ATOL,
        **{f"crops_per_s_{n}_b{bs}": f"{r:.1f}" for (n, bs), r in rates.items()}, check="ok")
    return rates


def int8_drift(model, batch: dict, scales: dict) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """(rotation degrees, translation relative) of the int8 forward against
    the model's own forward, per crop, and the int8 outputs."""
    ref = make_predict_step(model)(batch)
    q = make_predict_step(model, int8_scales=scales)(batch)
    cos = ((ref["rot"].float() * q["rot"].float()).sum(dim=(1, 2)) - 1.0) / 2.0
    t_ref = ref["trans"].double()
    return (torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0))),
            (q["trans"].double() - t_ref).abs() / t_ref.abs().clamp_min(1e-3), q)


def phase_int8(cfg, weights: str, request: dict, overfit: tuple) -> dict:
    """TEST.INT8 on the flagship (bf16) with [train_loop]'s checkpoint:
    calibration on one bucket; every quantized layer's int32 accumulators
    on the card (im2col and torch._int_mm) bitwise equal to the plain
    version's on the CPU for the same int8 inputs (the bucket's first
    INT8_CHECK_CROPS crops of each conv, every row of each linear); the
    int8 forward against bf16: translations within INT8_VS_BF16_TRANS_REL,
    and on [overfit]'s trained model and crops rotations under
    INT8_VS_BF16_DEG as well (tests/test_quantize.py:97-113's gates; the
    flagship's rotation drift is logged: on weights this little trained it
    is 1-3 degrees in both packages, ROADMAP.md section C); crops/s of int8
    and int8 + folded beside bf16; the time of _int_mm alone on the largest
    head conv's product beside torch.matmul in bf16 on the same M, N, K.
    Returns the four serving variants' predict steps, for the profile."""
    model = load_weights(build_model(cfg, device=DEV), weights)
    batch = to_device(request, DEV)
    t0 = time.perf_counter()
    scales = Q.calibrate_act_scales(model, [batch])
    calib_s = time.perf_counter() - t0
    folded = fold_batch_norms(model)
    predict_q = make_predict_step(model, int8_scales=scales)
    predict_qf = make_predict_step(folded, int8_scales=Q.calibrate_act_scales(folded, [batch]))

    seen = []
    plain_conv, plain_linear = Q.int8_conv2d, Q.int8_linear

    def conv_rec(x_i8, w_i8, *args):
        out = plain_conv(x_i8, w_i8, *args)
        k = INT8_CHECK_CROPS
        seen.append(("conv", x_i8[:k].cpu(), w_i8.cpu(), args, out[:k].cpu()))
        return out

    def linear_rec(x_i8, w_i8):
        out = plain_linear(x_i8, w_i8)
        seen.append(("linear", x_i8.cpu(), w_i8.cpu(), (), out.cpu()))
        return out

    Q.int8_conv2d, Q.int8_linear = conv_rec, linear_rec
    Q.int8_matmul.launches = 0
    try:
        q_out = predict_q(batch)
    finally:
        Q.int8_conv2d, Q.int8_linear = plain_conv, plain_linear
    gemms = Q.int8_matmul.launches
    if len(seen) != len(scales) or gemms < len(scales):
        raise AssertionError(f"int8: {len(seen)} int8 layers ran, {gemms} _int_mm calls, "
                             f"{len(scales)} calibrated")
    t0 = time.perf_counter()
    for kind, x_i8, w_i8, args, card in seen:
        want = (plain_conv(x_i8, w_i8, *args) if kind == "conv" else plain_linear(x_i8, w_i8))
        if not torch.equal(card, want):
            raise AssertionError(f"int8: a {kind} {tuple(w_i8.shape)}: card accumulators differ "
                                 f"from the plain version by {(card - want).abs().max()}")
    check_s = time.perf_counter() - t0
    rot_deg, trans_rel, _ = int8_drift(model, batch, scales)
    _, o_model, o_batch = overfit
    o_rot, o_trans, _ = int8_drift(o_model, o_batch, Q.calibrate_act_scales(o_model, [o_batch]))
    if (trans_rel.max() >= INT8_VS_BF16_TRANS_REL or o_rot.max() >= INT8_VS_BF16_DEG
            or o_trans.max() >= INT8_VS_BF16_TRANS_REL):
        raise AssertionError(f"int8 vs bf16: flagship translation {trans_rel.max():.4f} "
                             f"relative; trained R18 rotation {o_rot.max():.3f} deg, "
                             f"translation {o_trans.max():.4f}")
    log("int8", calibrated_on=len(request["roi_img"]), layers=len(scales),
        convs=sum(k == "conv" for k, *_ in seen), linears=sum(k == "linear" for k, *_ in seen),
        int_mm_calls=gemms, accumulators="bitwise equal to the plain version",
        checked_crops=INT8_CHECK_CROPS, calib_s=f"{calib_s:.2f}", plain_check_s=f"{check_s:.1f}",
        flagship_rot_deg_vs_bf16=f"{rot_deg.median():.3f}/{rot_deg.max():.3f}",
        flagship_trans_rel_max=f"{trans_rel.max():.3e}",
        trained_r18_crops=len(o_batch["roi_img"]),
        trained_r18_rot_deg_vs_bf16=f"{o_rot.median():.4f}/{o_rot.max():.4f}",
        trained_r18_trans_rel_max=f"{o_trans.max():.3e}",
        deg_gate=INT8_VS_BF16_DEG, trans_gate=INT8_VS_BF16_TRANS_REL, check="ok")
    del seen, q_out
    predicts = {"bf16": make_predict_step(model), "bf16_folded": make_predict_step(folded),
                "int8": predict_q, "int8_folded": predict_qf}
    rates = serve_times({k: predicts[k] for k in ("bf16", "int8", "int8_folded")},
                        serve_batches(cfg))
    log("int8_time", **{f"crops_per_s_{n}_b{bs}": f"{r:.1f}" for (n, bs), r in rates.items()})

    # the largest head conv's product at B=64: 64 x 64 x 64 rows, K = 256 x 9, N = 256
    bs = cfg.TEST.ROI_BATCH_SIZE
    head = cfg.MODEL.CDPN.ROT_HEAD.NUM_FILTERS
    hw = cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES
    m, k, n = bs * hw * hw, head * 9, head
    g = torch.Generator(device=DEV).manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, device=DEV, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=DEV, dtype=torch.int8)
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    int_ms = np.concatenate([cuda_times(lambda: torch._int_mm(a, b.t()), 20) for _ in range(2)])
    bf_ms = np.concatenate([cuda_times(lambda: torch.matmul(ab, bb.t()), 20) for _ in range(2)])
    ops, by = 2.0 * m * n * k, m * k + n * k
    log("int8_gemm", m=m, k=k, n=n, int_mm_ms=f"{np.median(int_ms):.4f}",
        bf16_matmul_ms=f"{np.median(bf_ms):.4f}",
        int_mm_tops=f"{ops / np.median(int_ms) / 1e9:.1f}",
        bf16_tflops=f"{ops / np.median(bf_ms) / 1e9:.1f}",
        int_mm_bound_ms=f"{max(by / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3:.4f}",
        bf16_bound_ms=f"{max(2 * by / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S) * 1e3:.4f}")
    return predicts


def scene_dets(dets: dict, path: str, scene_id: int) -> str:
    """est_dets.json restricted to one scene."""
    with open(dets["path"]) as f:
        body = {k: v for k, v in json.load(f).items() if int(k.split("/")[0]) == scene_id}
    with open(path, "w") as f:
        json.dump(body, f)
    return path


def run_tool(name: str, args: list) -> tuple[subprocess.CompletedProcess, float]:
    """gdrnet_tpu_torch.tools.<name>'s main(args), which `python -m` runs,
    on the card in this process (a process start costs about 8 s), its
    standard output captured; raises unless it returns."""
    module = importlib.import_module(f"gdrnet_tpu_torch.tools.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        module.main(list(args), device=DEV)
    wall_s = time.perf_counter() - t0
    return subprocess.CompletedProcess([name] + list(args), 0, out.getvalue(), ""), wall_s


def phase_predict(cfg, split, dets: dict, weights: str, root: str) -> str:
    """The predict CLI's main over the BOP split's images and est_dets.json
    with [train_loop]'s checkpoint, on the card (it returns, one CSV row a
    detection, finite rotations and translations); on scene 1 in f32 (TF32
    off), the card against the CPU within the gates of [do_test_vs_cpu];
    with TEST.FOLD_BN=True TEST.INT8=True: the same rows, finite. Returns
    the first run's CSV."""
    split_dir = Path(split["models"].meta.data_root)
    data = ["--config-file", FLAGSHIP, "--ckpt", weights, "--dataset", split_dir.name,
            "--data-root", str(split_dir.parent), "--image-root", str(split_dir / "test")]
    csv = str(Path(root) / "predict.csv")
    proc, wall_s = run_tool("predict", data + ["--dets", dets["path"], "--out", csv])
    rows = load_bop_results(csv)
    csv_rows_check(rows, "predict")
    if len(rows) != dets["written"]:
        raise AssertionError(f"predict: {len(rows)} CSV rows for {dets['written']} detections")
    bucket_s = np.array(sorted({r["time"] for r in rows}))
    log("predict", rc=proc.returncode, wall_s=f"{wall_s:.1f}", rows=len(rows),
        poses_per_s=f"{len(rows) / wall_s:.1f}", buckets=len(bucket_s),
        bucket_s_mean=f"{bucket_s.mean():.4f}", bucket_s_first=f"{bucket_s.max():.4f}",
        check="ok")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    one = data + ["--dets", scene_dets(dets, str(Path(root) / "dets_scene1.json"), 1)]
    runs = {}
    for device in (DEV, "cpu"):
        t0 = time.perf_counter()
        runs[device] = predict_tool.main(
            one + ["--out", str(Path(root) / f"predict_{device}.csv"), "PARALLEL.DTYPE=float32"],
            device=device), time.perf_counter() - t0
    (card, _), (cpu, cpu_s) = runs[DEV], runs["cpu"]
    R_c, R_p = (np.stack([r["R"] for r in rs]) for rs in (card, cpu))
    t_c, t_p = (np.stack([r["t"] for r in rs]) for rs in (card, cpu))
    rot_err = float(np.abs(R_c - R_p).max())
    trans_rel = float((np.linalg.norm(t_c - t_p, axis=1) / np.linalg.norm(t_p, axis=1)).max())
    if [(r["scene_id"], r["im_id"], r["obj_id"]) for r in card] != [
            (r["scene_id"], r["im_id"], r["obj_id"]) for r in cpu] \
            or rot_err > DO_TEST_ROT_ATOL or trans_rel > DO_TEST_TRANS_RTOL:
        raise AssertionError(f"predict_vs_cpu: rows {len(card)} vs {len(cpu)}, rotations "
                             f"differ by {rot_err}, translations by {trans_rel} relative")
    log("predict_vs_cpu", scene=1, rows=len(card), dtype="float32",
        rot_max_abs=f"{rot_err:.3e}", trans_max_rel=f"{trans_rel:.3e}",
        rot_atol=DO_TEST_ROT_ATOL, trans_rtol=DO_TEST_TRANS_RTOL, cpu_s=f"{cpu_s:.1f}",
        check="ok")

    t0 = time.perf_counter()
    q_rows = predict_tool.main(data + ["--dets", dets["path"], "--out",
                                       str(Path(root) / "predict_int8.csv"),
                                       "TEST.FOLD_BN=True", "TEST.INT8=True"], device=DEV)
    q_s = time.perf_counter() - t0
    csv_rows_check(q_rows, "predict int8+fold")
    if len(q_rows) != len(rows):
        raise AssertionError(f"predict int8+fold: {len(q_rows)} rows for {len(rows)}")
    log("predict_int8_fold", rows=len(q_rows), in_process_s=f"{q_s:.1f}",
        bucket_s_mean=f"{np.mean(sorted({r['time'] for r in q_rows})):.4f}", check="ok")
    return csv


def phase_eval_csv(cfg, split, csv: str, root: str) -> tuple[int, int]:
    """The eval_csv CLI's main over [predict]'s CSV with the flagship's
    VAL.ERROR_TYPES on the card, B1's and B2's launches counted: it returns,
    --out and --latex are written, and its recalls equal score_results on
    the CSV; then cus and cou_bb_proj on SIL_PAIRS pose pairs on the card
    equal to the CPU. Returns (B1, B2) launches of the run."""
    split_dir = Path(split["models"].meta.data_root)
    out = Path(root) / "eval_csv"
    args = ["--csv", csv, "--dataset", split_dir.name, "--data-root", str(split_dir.parent),
            "--error-types", cfg.VAL.ERROR_TYPES, "--out", str(out.with_suffix(".json")),
            "--latex", str(out.with_suffix(".tex"))]
    kernels.nn_min_dist.launches = 0
    kernels.rasterize_xyz.launches = 0
    proc, wall_s = run_tool("eval_csv", args)
    launches = kernels.nn_min_dist.launches, kernels.rasterize_xyz.launches
    with open(out.with_suffix(".json")) as f:
        from_cli = json.load(f)
    if not out.with_suffix(".tex").read_text().startswith("\\documentclass"):
        raise AssertionError("eval_csv: no latex report")
    meta = split["models"].meta
    want = bop_score.score_results(load_bop_results(csv), split["records"], ObjectModels(meta),
                                   cfg.VAL.ERROR_TYPES, image_width=meta.width, device=DEV)
    if json.loads(json.dumps(want)) != from_cli or min(launches) < 1:
        raise AssertionError(f"eval_csv: the CLI's and score_results' recalls differ, or "
                             f"launches {launches}")
    ar = bop_score.bop19_average_recall(want)
    log("eval_csv", rc=proc.returncode, wall_s=f"{wall_s:.1f}",
        error_types=cfg.VAL.ERROR_TYPES, ar_bop19=f"{ar:.4f}",
        recalls="equal to score_results", launches_nn_min_dist=launches[0],
        launches_rasterize_xyz=launches[1], latex=out.with_suffix(".tex").name,
        table_lines=len(proc.stdout.splitlines()), check="ok")

    recs = split["records"][:SIL_PAIRS]
    R_est, t_est = poses_near(np.stack([r["R"] for r in recs]), np.stack([r["t"] for r in recs]),
                              seed=9)
    vals = {}
    for device in (DEV, "cpu"):
        vals[device] = []
        for r, Re, te in zip(recs, R_est, t_est):
            _, v, f, _ = split["zoo"][r["obj_id"] - 1]
            kw = dict(height=split["models"].meta.height, width=split["models"].meta.width,
                      device=device)
            vals[device].append((vsd_mod.cus(Re, te, r["R"], r["t"], r["K"], v, f, **kw),
                                 vsd_mod.cou_bb_proj(Re, te, r["R"], r["t"], r["K"], v, f, **kw)))
    if vals[DEV] != vals["cpu"]:
        raise AssertionError(f"cus / cou_bb_proj card vs CPU: {vals[DEV]} vs {vals['cpu']}")
    log("silhouette_errors", pairs=len(recs), cus_mean=f"{np.mean([c for c, _ in vals[DEV]]):.4f}",
        cou_bb_proj_mean=f"{np.mean([b for _, b in vals[DEV]]):.4f}", vs="cpu", equal=True,
        check="ok")
    return launches


def phase_gen_xyz(cfg, root: str) -> int:
    """The gen_xyz CLI's main on the card over [train_loop]'s train split
    (written without pickles): one pickle an instance; scene 1 written
    again on the CPU, bitwise equal; then the train mapper maps GEN_MAPPED
    records from the pickles with no B2 launch. Returns the CLI's B2
    launches."""
    loop = Path(root) / "loop"
    proc, wall_s = run_tool("gen_xyz", ["--dataset", "loop", "--data-root", root,
                                        "--split", "train"])
    n = int(re.search(r"generated (\d+) xyz crops; B2 launches (\d+)", proc.stdout)[1])
    launches = int(re.search(r"B2 launches (\d+)", proc.stdout)[1])
    render_s = float(re.findall(r"renders with their copy ([\d.]+) s", proc.stdout)[-1])
    meta, records = resolve("loop_train", data_root=root)
    pickles = sorted((loop / "train").glob("*/xyz_crop/*.pkl"))
    n_inst = LOOP_SCENES * LOOP_IMAGES * LOOP_PER_IMAGE
    if n != n_inst or len(pickles) != n_inst or launches < 1:
        raise AssertionError(f"gen_xyz: {n} written, {len(pickles)} pickles for {n_inst} "
                             f"instances, {launches} B2 launches")
    scene1 = {p.name: p.read_bytes() for p in pickles if p.parent.parent.name == "000001"}
    t0 = time.perf_counter()
    gen_xyz_tool.gen_split_xyz(meta, "train", scenes=[1], overwrite=True, device="cpu")
    cpu_s = time.perf_counter() - t0
    again = {p.name: p.read_bytes() for p in sorted((loop / "train/000001/xyz_crop").glob("*"))}
    if again != scene1:
        raise AssertionError("gen_xyz: scene 1's pickles written on the CPU differ")
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    mapper = GDRNTrainMapper(cfg, models, device=DEV)
    before = kernels.rasterize_attr.launches
    mapped = [mapper(dict(rec), np.random.RandomState(i))
              for i, rec in enumerate(records[::max(1, len(records) // GEN_MAPPED)][:GEN_MAPPED])]
    if kernels.rasterize_attr.launches != before or not all(
            np.all(np.isfinite(m["gt_xyz"])) for m in mapped):
        raise AssertionError("gen_xyz mapper: B2 launched, or non-finite XYZ")
    log("gen_xyz", rc=proc.returncode, split="[train_loop]'s train split",
        size=f"{meta.width}x{meta.height}", crops=n, wall_s=f"{wall_s:.1f}",
        crops_per_s=f"{n / wall_s:.1f}", b2_launches=launches,
        render_and_copy_s=f"{render_s:.3f}", scene1_vs_cpu="bitwise equal",
        scene1_pickles=len(scene1), cpu_scene_s=f"{cpu_s:.1f}", mapped_from_pickles=len(mapped),
        mapper_b2_launches=0, check="ok")
    return launches


def phase_loader_pkl(root: str, loader_rate: float) -> None:
    """The train loader alone over [train_loop]'s split, now with gen_xyz's
    pickles, beside [train_loop]'s figure without them (every sample
    rendered by B2)."""
    c = loop_cfg(root, str(Path(root) / "flagship_seed0.pth"))
    before = kernels.rasterize_attr.launches
    rate = time_loader(c, root)
    log("loader_pkl", workers=LOOP_WORKERS, batch=c.SOLVER.IMS_PER_BATCH,
        batches=LOOP_LOADER_BATCHES, samples_per_s_pickles=f"{rate:.1f}",
        samples_per_s_renders=f"{loader_rate:.1f}", speedup=f"{rate / loader_rate:.2f}",
        b2_launches=kernels.rasterize_attr.launches - before)


def phase_jpeg() -> None:
    """The JPEG codec (csrc/jpeg_codec.cpp, built with g++ at first use) on
    the card's host: every case of data/jpeg_cases.py (baseline streams
    encoded by the port, progressive, CMYK and YCCK streams read from its
    files) decoded, the SHA-256 of each stream and each decoded image against
    the digests cv2 gives; then a 640x480 q95 4:2:0 frame decoded and encoded
    on one thread (host-clock ms), its progressive and CMYK counterparts
    decoded, and the baseline frame decoded on JPEG_THREADS threads
    (images/s)."""
    got = jpeg_cases.port_digests()
    bad = [k for k, v in jpeg_cases.DIGESTS.items() if got.get(k) != v]
    if bad or len(got) != len(jpeg_cases.DIGESTS):
        raise AssertionError(f"jpeg: digests differ from cv2's for {bad}")
    by_name = {c.name: c for c in jpeg_cases.CASES}
    frame = jpeg_cases.case_image(by_name["640x480_q95_420"])
    data = jpeg.encode_jpeg(frame, 95, "420")
    prog = jpeg_cases.case_stream(by_name["640x480_q95_420_prog"])
    cmyk = jpeg_cases.case_stream(by_name["640x480_q95_420_cmyk"])

    def host_ms(fn) -> np.ndarray:
        fn()
        out = []
        for _ in range(JPEG_TIMED):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(out)

    dec_ms, enc_ms = host_ms(lambda: jpeg.decode_jpeg(data)), host_ms(lambda: jpeg.encode_jpeg(frame))
    prog_ms = host_ms(lambda: jpeg.decode_jpeg(prog))
    cmyk_ms = host_ms(lambda: jpeg.decode_jpeg(cmyk))
    with ThreadPoolExecutor(JPEG_THREADS) as pool:
        list(pool.map(lambda _: jpeg.decode_jpeg(data), range(JPEG_THREADS)))
        t0 = time.perf_counter()
        list(pool.map(lambda _: jpeg.decode_jpeg(data), range(JPEG_THREADS * JPEG_TIMED)))
        rate = JPEG_THREADS * JPEG_TIMED / (time.perf_counter() - t0)
    processes = {p: sum(c.process == p for c in jpeg_cases.CASES) for p in jpeg_cases.PROCESSES}
    log("jpeg", cases=len(got), by_process=json.dumps(processes).replace(" ", ""),
        digests="equal to cv2", frame="640x480 q95 4:2:0", stream_bytes=len(data),
        decode_ms_median=f"{np.median(dec_ms):.3f}", encode_ms_median=f"{np.median(enc_ms):.3f}",
        progressive_bytes=len(prog), progressive_decode_ms_median=f"{np.median(prog_ms):.3f}",
        cmyk_bytes=len(cmyk), cmyk_decode_ms_median=f"{np.median(cmyk_ms):.3f}",
        timed=JPEG_TIMED, decode_images_per_s_1_thread=f"{1e3 / np.median(dec_ms):.1f}",
        decode_images_per_s_threads=f"{rate:.1f}", threads=JPEG_THREADS, check="ok")


def voc_image(rng, h: int, w: int) -> np.ndarray:
    """A background frame: blocky colour fields blurred by a box filter, with
    noise, as BGR uint8."""
    coarse = rng.randint(0, 256, (h // 25 + 2, w // 25 + 2, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((25, 25, 1), np.float32))[:h, :w]
    img = (img + np.roll(img, 12, 0) + np.roll(img, 12, 1) + np.roll(img, (12, 12), (0, 1))) / 4
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def write_lmo_tree(gsd, root: str) -> dict:
    """The LM-O layout the reference reads, written with the port's tools
    (write_bop_split, renders on DEV; compute_fps; encode_jpeg): returns the
    BOP root, the VOC root and counts."""
    bop_root = Path(root) / "lmo_data" / "BOP_DATASETS"
    zoo = {m[0]: m for m in gsd.mesh_zoo()}
    meshes = [zoo[LMO_MESHES.get(i, "tower")] for i in range(1, 13)]  # ids 2-4, 7 unused
    lmo_idx = np.array(sorted(LMO_MESHES)) - 1
    K = gsd.K_DEF.astype(np.float32)
    W, H = gsd.W_DEF, gsd.H_DEF
    scratch = Path(root) / "lmo_scratch"
    # lm/test/<obj id>: one instance an image, and image_set/<obj>_all.txt
    lm_sets = bop_root / "lm" / "image_set"
    lm_sets.mkdir(parents=True)
    for k, oid in enumerate(sorted(LMO_MESHES)):
        _, R, t = train_split_poses(LMO_LM_IMAGES, K, W, H, seed=500 + k)
        t[:, :2] *= 0.3  # near the centre of the frame
        write_bop_split(str(scratch / f"lm{oid}"), meshes, np.full(LMO_LM_IMAGES, oid - 1), R, t,
                        K, W, H, 1, LMO_LM_IMAGES, device=DEV, split="test")
        (bop_root / "lm" / "test").mkdir(parents=True, exist_ok=True)
        (scratch / f"lm{oid}" / "test" / "000001").rename(bop_root / "lm" / "test" / f"{oid:06d}")
        name = ref_meta.LMO_ID2OBJ[oid]
        (lm_sets / f"{name}_all.txt").write_text("".join(f"{i}\n" for i in range(LMO_LM_IMAGES)))
    # lmo/train_pbr (JPEG frames) and lmo/test scene 2, with the models
    lmo = bop_root / "lmo"
    n_pbr = LMO_PBR_SCENES * LMO_PBR_IMAGES * 8
    _, R, t = train_split_poses(n_pbr, K, W, H, seed=600)
    write_bop_split(str(lmo), meshes, np.tile(lmo_idx, n_pbr // 8), R, t, K, W, H, 8,
                    LMO_PBR_IMAGES, device=DEV, split="train_pbr")
    n_jpeg = 0
    for png in sorted(lmo.glob("train_pbr/*/rgb/*.png")):
        jpeg.write_jpeg(str(png.with_suffix(".jpg")), read_png(str(png))[..., ::-1], 95)
        png.unlink()
        n_jpeg += 1
    _, R, t = train_split_poses(LMO_TEST_IMAGES * 8, K, W, H, seed=700)
    write_bop_split(str(lmo), meshes, np.tile(lmo_idx, LMO_TEST_IMAGES), R, t, K, W, H, 8,
                    LMO_TEST_IMAGES, device=DEV, split="test")
    (lmo / "test" / "000001").rename(lmo / "test" / "000002")
    fps = compute_fps_dict(str(lmo / "models"), sorted(LMO_MESHES))
    with open(lmo / "models" / "fps_points.pkl", "wb") as f:
        pickle.dump(fps, f)
    # VOC_table backgrounds beside the BOP root
    voc = bop_root.parent / "VOCdevkit" / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.RandomState(8)
    lines = []
    for i in range(LMO_VOC_IMAGES):
        h, w = LMO_VOC_SIZES[i % len(LMO_VOC_SIZES)]
        name = f"2008_{i:06d}"
        jpeg.write_jpeg(str(voc / "JPEGImages" / f"{name}.jpg"), voc_image(rng, h, w), 90)
        lines.append(f"{name} {-1 if i < LMO_VOC_NEGATIVE else 1}\n")
    (voc / "ImageSets" / "Main" / "diningtable_trainval.txt").write_text("".join(lines))
    return {"bop": str(bop_root), "voc": str(voc), "pbr_jpegs": n_jpeg,
            "voc_jpegs": LMO_VOC_IMAGES, "voc_table": LMO_VOC_IMAGES - LMO_VOC_NEGATIVE}


def lmo_overrides(tree: dict, out: str, dets: str) -> list:
    """The KEY=value options a user gives the LM-O config on this tree: the
    BG root, OUTPUT_DIR, the run length, the workers, the detections, and
    no weights file (the data root is --data-root)."""
    return [f"INPUT.BG_IMGS_ROOT={tree['voc']!r}", f"OUTPUT_DIR={out!r}",
            f"SOLVER.TOTAL_EPOCHS={LMO_EPOCHS}", f"DATALOADER.NUM_WORKERS={LOOP_WORKERS}",
            f"DATASETS.DET_FILES_TEST=({dets!r},)", "MODEL.WEIGHTS=''",
            "MODEL.CDPN.BACKBONE.PRETRAINED=''"]


def train_cli_child(argv: list) -> None:
    """[train_lmo]'s subprocess: `python -m gdrnet_tpu_torch.engine.train
    <argv>` run as `python -m` runs it (runpy, as __main__), with counting
    wrappers around the JPEG decoder (by folder), the train mapper (by
    img_type), the background replacer, the train step (host clock at each
    call, its metrics) and the loader (host-clock wait for each batch).
    A leading `--max-iters N` is the child's own: do_train then stops after
    N iterations (max_iters_override); a `--then` splits the arguments into
    two CLI runs in this process, one after the other (each as `python -m`
    runs it; the second's launches are b1_test and b2_test). Under a process group it records the
    default group's backend and an all_reduce over it, and a barrier and an
    all_gather_object over multihost.host_group() (gloo beside NCCL). Its
    last line is TRAIN_CLI {json}."""
    import runpy
    import threading

    clock = {"entry": time.time()}  # epoch stamps: the parent sets them beside its own
    max_iters = None
    if argv[:1] == ["--max-iters"]:
        max_iters, argv = int(argv[1]), argv[2:]

    from gdrnet_tpu_torch.data import augment as aug_mod, io as io_mod, mapper as mapper_mod
    from gdrnet_tpu_torch.engine import trainer as trainer_mod

    lock = threading.Lock()
    counts: dict = defaultdict(int)

    def bump(key: str) -> None:
        with lock:
            counts[key] += 1

    decode = io_mod.decode_jpeg

    def counted_decode(data, flags="color", name="JPEG stream"):
        bump("decode_pbr" if "/train_pbr/" in name else
             "decode_bg" if "/JPEGImages/" in name else "decode_other")
        return decode(data, flags, name)

    call, replace = mapper_mod.GDRNTrainMapper.__call__, aug_mod.BackgroundReplacer.replace

    def counted_call(self, rec, rng):
        bump(f"samples_{rec.get('img_type', 'real')}")
        return call(self, rec, rng)

    def counted_replace(self, *args, **kwargs):
        bump("bg_replaced")
        return replace(self, *args, **kwargs)

    steps_log, waits = [], []
    make_step, build_pipeline, train = (trainer_mod.make_train_step,
                                        trainer_mod.build_input_pipeline, trainer_mod.do_train)

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(state, batch, gen):
            clock.setdefault("first_step", time.time())
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen)
            steps_log.append((t0, metrics))
            return state, metrics
        return timed

    class TimedLoader:
        def __init__(self, loader):
            self.loader = loader

        def __iter__(self):
            it = iter(self.loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = next(it)
                    waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()

    def timed_pipeline(*args, **kwargs):
        loader, to_dev, refresher = build_pipeline(*args, **kwargs)
        return TimedLoader(loader), to_dev, refresher

    precise: list = []
    update_bn_stats = trainer_mod.update_bn_stats

    def recorded_update_bn_stats(model, batches, num_iters, forward):
        stats = [k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))]
        before = {k: model.state_dict()[k].clone() for k in stats}
        n = update_bn_stats(model, batches, num_iters=num_iters, forward=forward)
        after = model.state_dict()
        unchanged = [k for k in stats if torch.equal(after[k], before[k])]
        precise.append({"batches": n, "moved": len(stats) - len(unchanged),
                        "unchanged": unchanged[:5]})
        return n

    train_out: dict = {}
    dist_info: dict = {}
    init_dist = mh.maybe_init_distributed

    def probed_init(*args, **kwargs):  # the process group the CLI joins, and its collectives
        up = init_dist(*args, **kwargs)
        clock.setdefault("group", time.time())
        if up and not dist_info:
            probe = torch.ones(1, device="cuda")
            torch.distributed.all_reduce(probe)
            host = mh.host_group()  # the host values' group (a new gloo group under NCCL)
            torch.distributed.barrier(group=host)
            gathered: list = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(gathered, {"rank": torch.distributed.get_rank()},
                                                group=host)
            dist_info.update(backend=torch.distributed.get_backend(),
                             world=torch.distributed.get_world_size(),
                             rank=torch.distributed.get_rank(), all_reduce=float(probe.item()),
                             host_backend=torch.distributed.get_backend(host),
                             host_is_world=host is torch.distributed.group.WORLD,
                             host_gathered=[g["rank"] for g in gathered])
        return up

    def counted_train(*args, **kwargs):
        if max_iters:
            kwargs["max_iters_override"] = max_iters
        clock["train_start"] = time.time()
        t0 = time.perf_counter()
        out = train(*args, **kwargs)
        torch.cuda.synchronize()
        clock["train_end"] = time.time()
        train_out.update(
            wall_s=time.perf_counter() - t0, b1=kernels.nn_min_dist.launches,
            b2=kernels.rasterize_xyz.launches, samples=dict(counts),
            losses=[float(m["total_loss"]) for _, m in steps_log],
            skips=[float(m.get("nonfinite_skip", 0.0)) for _, m in steps_log],
            step_starts=[t for t, _ in steps_log], waits=list(waits))
        return out

    io_mod.decode_jpeg = counted_decode
    mapper_mod.GDRNTrainMapper.__call__ = counted_call
    aug_mod.BackgroundReplacer.replace = counted_replace
    trainer_mod.make_train_step = timed_make_step
    trainer_mod.build_input_pipeline = timed_pipeline
    trainer_mod.do_train = counted_train
    trainer_mod.update_bn_stats = recorded_update_bn_stats
    mh.maybe_init_distributed = probed_init
    runs = [[]]
    for arg in argv:
        if arg == "--then":
            runs.append([])
        else:
            runs[-1].append(arg)
    for i, run_argv in enumerate(runs):
        sys.argv = ["gdrnet_tpu_torch.engine.train", *run_argv]
        runpy.run_module("gdrnet_tpu_torch.engine.train", run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        clock["cli_end" if i == 0 else f"cli{i}_end"] = time.time()
    print("TRAIN_CLI " + json.dumps({
        "train": train_out, "b1_test": kernels.nn_min_dist.launches - train_out.get("b1", 0),
        "b2_test": kernels.rasterize_xyz.launches - train_out.get("b2", 0),
        "counts": dict(counts), "precise_bn": precise, "dist": dist_info, "clock": clock}),
        flush=True)


def phase_train_lmo(gsd, root: str, card: str, flagship_loader_rate: float) -> tuple[int, int]:
    """The LM-O config at full width trained and tested as a user runs it:
    `python -m gdrnet_tpu_torch.engine.train --config-file <lmo cfg>
    --data-root <tree>` over an LM-O tree of the zoo meshes (lmo_train PNGs,
    lmo_pbr_train JPEGs at TRAIN2_RATIO 0.1, VOC_table JPEG backgrounds at
    CHANGE_BG_PROB 0.5, lmo_test with estimated detections). Gates: the JPEG
    decoder read PBR frames and backgrounds; every loss finite and no step
    skipped; B2 launched at least once per sample mapped (no sample has a
    pickle); LMO_MAPPED PBR samples mapped on the card bitwise equal to the
    CPU; one CSV row per kept detection with a rotation; B1 launched in
    do_test. Returns (B1, B2) launches of the CLI's run."""
    t0 = time.perf_counter()
    tree = write_lmo_tree(gsd, root)
    write_s = time.perf_counter() - t0
    _, test_recs = resolve("lmo_test", tree["bop"])
    dets = write_detections({"records": test_recs}, str(Path(root) / "lmo_dets.json"))
    out = str(Path(root) / "lmo_out")
    opts = lmo_overrides(tree, out, dets["path"])
    c = merged_config(LMO_CONFIG)
    apply_opts(c, opts)
    log("train_lmo_tree", lm_images=8 * LMO_LM_IMAGES, pbr_jpegs=tree["pbr_jpegs"],
        test_images=LMO_TEST_IMAGES, voc_jpegs=tree["voc_jpegs"], voc_table=tree["voc_table"],
        detections_kept=dets["kept"], write_s=f"{write_s:.2f}")

    # (a) LMO_MAPPED PBR samples: the card against the CPU, same seeds
    _, records, records2, models, mapper = build_train_objects(c, tree["bop"], DEV)
    if not records2 or not all(r["rgb_path"].endswith(".jpg") for r in records2):
        raise AssertionError(f"train_lmo: {len(records2)} PBR records, not all JPEG frames")
    np.random.seed(0)
    on_card = GDRNTrainMapper(c, models, bg_replacer=mapper.bg, device=DEV)
    np.random.seed(0)
    on_cpu = GDRNTrainMapper(c, models, bg_replacer=mapper.bg, device="cpu")
    step = max(1, len(records2) // LMO_MAPPED)
    for i, rec in enumerate(records2[::step][:LMO_MAPPED]):
        got, want = on_card(dict(rec), np.random.RandomState(i)), on_cpu(dict(rec),
                                                                         np.random.RandomState(i))
        for k in want:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"train_lmo: PBR record {i} {k} card vs CPU differ")
    loader_rate = time_loader(c, tree["bop"])

    # (b) the CLI: train, then do_test on lmo_test
    cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--train-cli-child", "--config-file",
           LMO_CONFIG, "--data-root", tree["bop"], *opts]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LMO_CLI_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN_CLI ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"train_lmo: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    run = json.loads(lines[-1][len("TRAIN_CLI "):])
    tr, counts = run["train"], run["counts"]
    samples = tr["samples"]
    n_samples = sum(v for k, v in samples.items() if k.startswith("samples_"))
    n_pbr = samples.get("samples_syn_pbr", 0)
    losses, skips = np.array(tr["losses"]), np.array(tr["skips"])
    iters = len(losses)
    if not (samples.get("decode_pbr", 0) >= n_pbr > 0 and samples.get("decode_bg", 0) > 0):
        raise AssertionError(f"train_lmo: JPEG decodes {samples} for {n_pbr} PBR samples")
    if iters != LMO_EPOCHS * (8 * LMO_LM_IMAGES // c.SOLVER.IMS_PER_BATCH) or not np.all(
            np.isfinite(losses)) or skips.any():
        raise AssertionError(f"train_lmo: {iters} steps, losses {losses.tolist()}, "
                             f"skips {skips.tolist()}")
    if tr["b2"] < n_samples or tr["b1"]:
        raise AssertionError(f"train_lmo: B2 launched {tr['b2']} times for {n_samples} samples, "
                             f"B1 {tr['b1']} in training")
    with open(Path(out) / "results.json") as f:
        res = json.load(f)
    rows = load_bop_results(res["_csv_path"])
    csv_rows_check(rows, "train_lmo")
    if len(rows) != dets["kept"] or run["b1_test"] < 1:
        raise AssertionError(f"train_lmo: {len(rows)} CSV rows for {dets['kept']} kept "
                             f"detections, B1 launched {run['b1_test']} times in do_test")
    # iteration wall times: from one step's call to the next's; the data
    # wait: the loader's batches after the first, each fetched in one step
    starts = np.array(tr["step_starts"])
    step_ms = np.diff(starts)[1:] * 1e3  # the first step warms every kernel up
    data_ms = np.array(tr["waits"][2:2 + len(step_ms)]) * 1e3
    log("train_lmo", card=repr(card), config=Path(LMO_CONFIG).name,
        batch=c.SOLVER.IMS_PER_BATCH, classes=c.MODEL.CDPN.ROT_HEAD.NUM_CLASSES,
        workers=LOOP_WORKERS, iterations=iters, losses_finite=True, skipped=int(skips.sum()),
        total_loss_first=f"{losses[0]:.4f}", total_loss_last=f"{losses[-1]:.4f}",
        step_ms_median=f"{np.median(step_ms):.1f}", data_ms_median=f"{np.median(data_ms):.1f}",
        data_share=f"{data_ms.sum() / step_ms.sum():.3f}",
        rois_per_s=f"{c.SOLVER.IMS_PER_BATCH / np.median(step_ms) * 1e3:.1f}",
        loader_samples_per_s=f"{loader_rate:.1f}",
        flagship_loader_samples_per_s=f"{flagship_loader_rate:.1f}",
        samples=n_samples, pbr_samples=n_pbr, pbr_share=f"{n_pbr / n_samples:.3f}",
        bg_replaced_share=f"{samples.get('bg_replaced', 0) / n_samples:.3f}",
        jpeg_decodes_pbr=samples.get("decode_pbr", 0), jpeg_decodes_bg=samples.get("decode_bg", 0),
        launches_rasterize_xyz_train=tr["b2"], launches_per_sample=f"{tr['b2'] / n_samples:.2f}",
        pbr_mapped_card_vs_cpu=f"{LMO_MAPPED} bitwise equal", csv_rows=len(rows),
        launches_nn_min_dist_test=run["b1_test"], launches_rasterize_xyz_test=run["b2_test"],
        ar_bop19=res.get("_bop_average_recall", "not scored"), train_s=f"{tr['wall_s']:.1f}",
        cli_wall_s=f"{wall_s:.1f}", check="ok")
    return run["b1_test"], tr["b2"] + run["b2_test"]


def variant_cfg(overrides: list, dtype: str | None = None):
    c = merged_config(FLAGSHIP)
    apply_opts(c, overrides)
    if dtype:
        c.PARALLEL.DTYPE = dtype
    return c


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30 if DEV == "cuda" else 0.0


def reset_peak() -> None:
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase_variants(card: str) -> None:
    """[variants]: each of VARIANTS from one seeded init_weights state dict:
    the f32 forward of VARIANT_F32_CROPS crops on the card against the CPU
    (phase_forward_f32's gate), VARIANT_STEPS bf16 train steps at
    VARIANT_BATCH on a device-resident batch (every loss finite, nothing
    skipped, a frozen backbone bitwise as it was; ROT_CONCAT's step raises,
    as the JAX step fails on its 128 px maps against the 64 px ground
    truth), the median step ms, bf16 crops/s at VARIANT_SERVE and the peak
    memory of each."""
    res = merged_config(FLAGSHIP).MODEL.CDPN.BACKBONE
    n_cls = merged_config(FLAGSHIP).MODEL.CDPN.ROT_HEAD.NUM_CLASSES
    small = synthetic_roi_batch(batch_size=VARIANT_F32_CROPS, input_res=res.INPUT_RES,
                                out_res=res.OUTPUT_RES, num_classes=n_cls, seed=500)
    serve = {bs: to_device(synthetic_roi_batch(batch_size=bs, input_res=res.INPUT_RES,
                                               out_res=res.OUTPUT_RES, num_classes=n_cls,
                                               seed=501), DEV) for bs in VARIANT_SERVE}
    for name, overrides in VARIANTS.items():
        t0 = time.perf_counter()
        c32 = variant_cfg(overrides, "float32")
        sd = init_weights(build_model(c32, device="cpu"),
                          torch.Generator().manual_seed(0)).state_dict()
        phase_forward_f32(c32, sd, small)
        f32_s = time.perf_counter() - t0

        c = variant_cfg(overrides)
        c.SOLVER.IMS_PER_BATCH = VARIANT_BATCH
        reset_peak()
        state, step = train_setup(c, sd, DEV)
        batch = to_device(train_batch(c, VARIANT_BATCH, seed=502), DEV)
        gen = torch.Generator(device=DEV).manual_seed(0)
        frozen = ({k: v.clone() for k, v in state.model.backbone.state_dict().items()}
                  if c.MODEL.CDPN.BACKBONE.FREEZE else None)
        train = {}
        try:
            hist = [step(state, batch, gen)[1] for _ in range(VARIANT_STEPS)]
        except ValueError as e:
            if not c.MODEL.CDPN.ROT_HEAD.ROT_CONCAT or "ROT_CONCAT" not in str(e):
                raise
            train = {"train": "raises_as_the_JAX_step_fails"}
        if not train:
            total = torch.stack([h["total_loss"] for h in hist]).float().cpu().numpy()
            skips = torch.stack([h["nonfinite_skip"] for h in hist]).cpu().numpy()
            if not np.all(np.isfinite(total)) or skips.any():
                raise AssertionError(f"variants {name}: losses {total}, skips {skips}")
            if frozen is not None and not all(
                    torch.equal(v, state.model.backbone.state_dict()[k])
                    for k, v in frozen.items()):
                raise AssertionError(f"variants {name}: the frozen backbone moved")
            ms = cuda_times(lambda: step(state, batch, gen), VARIANT_TIMED, 1)
            train = {"loss_first": f"{total[0]:.4f}", "loss_last": f"{total[-1]:.4f}",
                     "step_ms_b32": f"{np.median(ms):.3f}",
                     "train_peak_gib": f"{peak_gib():.2f}",
                     "frozen_backbone_bitwise": frozen is not None or "n/a"}
        del state, step, batch
        model = build_model(c, device=DEV)
        model.load_state_dict(sd)
        predict = make_predict_step(model)
        served = {}
        for bs, data in serve.items():
            if bs > VARIANT_SERVE[0] and name in VARIANT_NO_1024:
                served[f"crops_per_s_b{bs}"] = f"not_run_{VARIANT_NO_1024[name]}"
                continue
            reset_peak()
            ms = cuda_times(lambda: predict(data), VARIANT_TIMED, 1)
            served[f"crops_per_s_b{bs}"] = f"{bs / np.median(ms) * 1e3:.1f}"
            served[f"serve_peak_gib_b{bs}"] = f"{peak_gib():.2f}"
        R = predict(serve[VARIANT_SERVE[0]])["rot"].float().cpu().numpy()
        if not np.all(np.isfinite(R)):
            raise AssertionError(f"variants {name}: non-finite served rotations")
        # a quaternion below the decode's 1e-4 floor (untrained, seeded heads)
        # is not normalised, in the JAX package as here
        served["served_ortho_err"] = f"{np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max():.1e}"
        del model, predict
        log("variants", card=repr(card), variant=name, forward_f32="ok", **train, **served,
            wall_s=f"{time.perf_counter() - t0:.1f}", f32_check_s=f"{f32_s:.1f}")
    del serve
    reset_peak()


def solver_cfg(name: str, dtype: str | None = None):
    c = merged_config(FLAGSHIP)
    c.SOLVER.OPTIMIZER_CFG = dict(type=name, lr=c.SOLVER.OPTIMIZER_CFG["lr"])
    c.SOLVER.IMS_PER_BATCH = VARIANT_BATCH
    if dtype:
        c.PARALLEL.DTYPE = dtype
    return c


def phase_solvers(state_dict: dict, card: str) -> None:
    """[solvers]: every optimizer name of the JAX registry on the flagship:
    its first f32 update on the card against the CPU's from the same
    gradients (one f32 step's, made on the card), VARIANT_STEPS bf16 steps at
    VARIANT_BATCH (losses finite, nothing skipped), the step ms and the
    optimizer's ms alone, and a step with a NaN in roi_img that leaves the
    state bitwise as it was."""
    c32 = solver_cfg("Ranger", "float32")
    card32, host32 = build_model(c32, device=DEV), build_model(c32, device="cpu")
    card32.load_state_dict(state_dict)
    small = to_device(train_batch(c32, SOLVER_F32_BATCH, seed=510), DEV)
    state, step = train_setup(c32, state_dict, DEV)
    step(state, small, None)
    grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
    del state, step
    batch = to_device(train_batch(solver_cfg("Ranger"), VARIANT_BATCH, seed=511), DEV)
    bad = dict(batch, roi_img=batch["roi_img"].clone())
    bad["roi_img"][2, 11, 7, 0] = float("nan")
    for name in OPTIMIZER_NAMES:
        t0 = time.perf_counter()
        updates = []
        for model in (card32, host32):
            model.load_state_dict(state_dict)
            before = {k: p.detach().clone() for k, p in model.named_parameters()}
            opt = build_optimizer(solver_cfg(name, "float32"), model)
            for k, p in model.named_parameters():
                p.grad = grads[k].to(p.device)
            opt.step()
            updates.append({k: (p.detach() - before[k]).cpu()
                            for k, p in model.named_parameters()})
        worst = 0.0
        for k, want in updates[1].items():
            got = updates[0][k]
            scale = float(want.abs().max())
            # the update is read as after - before: one f32 ulp of the parameter
            ulp = 2.0 ** -23 * float(state_dict[k].abs().max())
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SOLVER_UPDATE_RTOL,
                                       atol=SOLVER_UPDATE_RTOL * scale + ulp,
                                       err_msg=f"{name} {k}")
            worst = max(worst, float((got - want).abs().max()) / max(scale, 1e-30))

        c = solver_cfg(name)
        state, step = train_setup(c, state_dict, DEV)
        gen = torch.Generator(device=DEV).manual_seed(0)
        hist = [step(state, batch, gen)[1] for _ in range(VARIANT_STEPS)]
        total = torch.stack([h["total_loss"] for h in hist]).float().cpu().numpy()
        skips = torch.stack([h["nonfinite_skip"] for h in hist]).cpu().numpy()
        if not np.all(np.isfinite(total)) or skips.any():
            raise AssertionError(f"solvers {name}: losses {total}, skips {skips}")
        step_ms = cuda_times(lambda: step(state, batch, gen), VARIANT_TIMED, 1)
        opt_ms = cuda_times(lambda: state.optimizer.step(), 10, 2)
        before = train_snapshot(state)
        _, m_bad = step(state, bad, gen)
        if float(m_bad["nonfinite_skip"]) != 1.0 or not all(
                torch.equal(a, b) for a, b in zip(before, train_snapshot(state))):
            raise AssertionError(f"solvers {name}: the NaN step changed the state")
        log("solvers", card=repr(card), optimizer=name, first_update_f32_vs_cpu="ok",
            worst_rel_diff=f"{worst:.2e}", loss_first=f"{total[0]:.4f}",
            loss_last=f"{total[-1]:.4f}", step_ms_b32=f"{np.median(step_ms):.3f}",
            optimizer_ms=f"{np.median(opt_ms):.3f}", state_tensors=len(before),
            nan_step_bitwise_unchanged=True, wall_s=f"{time.perf_counter() - t0:.1f}")
        del state, step, before
    del card32, host32, batch, bad, grads
    reset_peak()


def tv_overrides(root: str, dets: str, out: str) -> list:
    """The LM config as a researcher retargets it to the smoke's splits: the
    [train_loop] split to train on (no VOC backgrounds: CHANGE_BG_PROB 0, as
    the flagship on it), the BOP test split (a link `bop` to it under the
    data root) with its detections, the zoo's 10 classes and symmetric
    objects; ResNet-50, Ranger2020 and precise BN."""
    c = merged_config(FLAGSHIP)
    return [f"OUTPUT_DIR={out!r}", "DATASETS.TRAIN=('loop_train',)",
            "DATASETS.TEST=('bop_test',)", f"DATASETS.DET_FILES_TEST=({dets!r},)",
            f"DATASETS.SYM_OBJS={list(c.DATASETS.SYM_OBJS)!r}",
            f"MODEL.CDPN.ROT_HEAD.NUM_CLASSES={c.MODEL.CDPN.ROT_HEAD.NUM_CLASSES}",
            "INPUT.CHANGE_BG_PROB=0.0", f"SOLVER.TOTAL_EPOCHS={TV_EPOCHS}",
            f"DATALOADER.NUM_WORKERS={LOOP_WORKERS}", "MODEL.WEIGHTS=''",
            "MODEL.CDPN.BACKBONE.PRETRAINED=''", "MODEL.CDPN.BACKBONE.NUM_LAYERS=50",
            "SOLVER.OPTIMIZER_CFG.type='Ranger2020'",
            "TEST.PRECISE_BN.ENABLED=True", f"TEST.PRECISE_BN.NUM_ITER={TV_PRECISE_ITERS}"]


def phase_train_variant(root: str, dets: dict, card: str) -> tuple[int, int]:
    """[train_variant]: `python -m gdrnet_tpu_torch.engine.train` with the LM
    config (tv_overrides) in a subprocess: every loss finite, nothing
    skipped, precise BN over TV_PRECISE_ITERS batches moving every BN
    statistic, one CSV row per kept detection, B2 launched in training (the
    split has no pickles) and B1 in do_test. Returns (B1, B2) launches."""
    link = Path(root) / "bop"
    if not link.exists():
        link.symlink_to(Path(root), target_is_directory=True)
    out = str(Path(root) / "tv_out")
    opts = tv_overrides(root, dets["path"], out)
    cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--train-cli-child", "--config-file",
           LM_CONFIG, "--data-root", root, *opts]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=TV_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN_CLI ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"train_variant: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    run = json.loads(lines[-1][len("TRAIN_CLI "):])
    tr, pbn = run["train"], run["precise_bn"]
    losses, skips = np.array(tr["losses"]), np.array(tr["skips"])
    if not len(losses) or not np.all(np.isfinite(losses)) or skips.any():
        raise AssertionError(f"train_variant: losses {losses.tolist()}, skips {skips.tolist()}")
    if len(pbn) != 1 or pbn[0]["batches"] != TV_PRECISE_ITERS or pbn[0]["unchanged"]:
        raise AssertionError(f"train_variant: precise BN {pbn}")
    with open(Path(out) / "results.json") as f:
        res = json.load(f)
    rows = load_bop_results(res["_csv_path"])
    csv_rows_check(rows, "train_variant")
    if len(rows) != dets["kept"] or run["b1_test"] < 1 or tr["b2"] < 1 or tr["b1"]:
        raise AssertionError(f"train_variant: {len(rows)} CSV rows for {dets['kept']} kept, "
                             f"B1 {run['b1_test']} in do_test, B2 {tr['b2']} in training")
    starts = np.array(tr["step_starts"])
    step_ms = np.diff(starts)[1:] * 1e3  # as [train_lmo]: call to call, the first left out
    data_ms = np.array(tr["waits"][2:2 + len(step_ms)]) * 1e3
    bs = merged_config(LM_CONFIG).SOLVER.IMS_PER_BATCH
    log("train_variant", card=repr(card), config=Path(LM_CONFIG).name, backbone="R50", batch=bs,
        optimizer="Ranger2020", iterations=len(losses), losses_finite=True, skipped=0,
        total_loss_first=f"{losses[0]:.4f}", total_loss_last=f"{losses[-1]:.4f}",
        step_ms_median=f"{np.median(step_ms):.1f}", data_ms_median=f"{np.median(data_ms):.1f}",
        data_share=f"{data_ms.sum() / step_ms.sum():.3f}",
        rois_per_s=f"{bs / np.median(step_ms) * 1e3:.1f}", precise_bn_batches=pbn[0]["batches"],
        precise_bn_stats_moved=pbn[0]["moved"], csv_rows=len(rows),
        launches_rasterize_xyz_train=tr["b2"], launches_nn_min_dist_test=run["b1_test"],
        launches_rasterize_xyz_test=run["b2_test"],
        ar_bop19=res.get("_bop_average_recall", "not scored"), train_s=f"{tr['wall_s']:.1f}",
        cli_wall_s=f"{wall_s:.1f}", check="ok")
    return run["b1_test"], tr["b2"] + run["b2_test"]


def phase_visualize(root: str, card: str) -> int:
    """[visualize]: python -m gdrnet_tpu_torch.data.visualize's main in this
    process over the [train_loop] split (no XYZ pickles yet), --n VIS_N:
    the records' panels on the card, the mapper's (--mapped) on the card,
    then the mapper's on the CPU. Gates: VIS_N panel files in each mode, B2
    launched at least once a mapped record on the card and never on the
    CPU, every panel handed to grid_show on the card bitwise the CPU's, the
    grid backend the CLI prints the one utils/vis picks, and each written
    PNG the image grid_show returned where that is the mosaic. Returns the
    card's mapped B2 launches."""
    out = Path(root) / "vis"
    plain = vis_mod.grid_show
    panels: dict = defaultdict(list)
    wall_s, launches, saved, printed = {}, {}, {}, {}

    def capture(mode):
        def grid_show(images, titles=None, **kw):
            grid = plain(images, titles, **kw)
            panels[mode].append(([np.array(im, copy=True) for im in images], kw["save_path"],
                                 grid))
            return grid
        return grid_show

    try:
        for mode, device, extra in (("records", DEV, []), ("mapped", DEV, ["--mapped"]),
                                    ("mapped_cpu", "cpu", ["--mapped"])):
            vis_mod.grid_show = capture(mode)
            kernels.rasterize_xyz.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                saved[mode] = visualize_tool.main(
                    ["loop_train", "--data-root", root, "--n", str(VIS_N), "--save-dir",
                     str(out / mode), "--device", device] + extra)
            torch.cuda.synchronize()
            wall_s[mode] = time.perf_counter() - t0
            launches[mode] = kernels.rasterize_xyz.launches
            printed[mode] = buf.getvalue().strip().splitlines()[-1]
    finally:
        vis_mod.grid_show = plain
    backend = vis_mod.grid_backend()
    for mode, paths in saved.items():
        if len(paths) != VIS_N or not all(Path(p).is_file() for p in paths):
            raise AssertionError(f"visualize {mode}: {len(paths)} panel files for {VIS_N}")
        if not printed[mode].endswith(f"(grid: {backend})"):
            raise AssertionError(f"visualize {mode}: printed {printed[mode]!r}, the grid is "
                                 f"{backend}")
        for _, path, grid in panels[mode]:
            if backend == "mosaic" and not np.array_equal(read_png(path), grid):
                raise AssertionError(f"visualize {mode}: {path} is not the mosaic")
    if launches["mapped"] < VIS_N or launches["mapped_cpu"] or launches["records"]:
        raise AssertionError(f"visualize: B2 launches {launches} (at least {VIS_N} mapped on "
                             "the card, none otherwise)")
    for i, ((card_p, _, _), (cpu_p, _, _)) in enumerate(zip(panels["mapped"],
                                                           panels["mapped_cpu"])):
        for j, (a, b) in enumerate(zip(card_p, cpu_p)):
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"visualize: mapped record {i} panel {j} card vs CPU "
                                     "differ")
    log("visualize", card=repr(card), split="loop_train", panels_records=len(saved["records"]),
        panels_mapped=len(saved["mapped"]), grid=backend,
        launches_rasterize_xyz_mapped=launches["mapped"], mapped_vs_cpu="bitwise_equal",
        records_s=f"{wall_s['records']:.2f}", mapped_s=f"{wall_s['mapped']:.2f}",
        s_per_mapped_panel=f"{wall_s['mapped'] / VIS_N:.3f}",
        mapped_cpu_s=f"{wall_s['mapped_cpu']:.2f}", wall_s=f"{sum(wall_s.values()):.1f}",
        check="ok")
    return launches["mapped"]


def ddp_cli(args: list, label: str) -> tuple[dict, float]:
    """`python -m torch.distributed.run --standalone --nproc_per_node=1
    chip_smoke.py --train-cli-child <args>`: the engine.train CLI as one
    NCCL rank, with the counting wrappers. Gates the process group: NCCL
    answers an all_reduce, and host_group() is a gloo group of its own that
    answers a barrier and an all_gather_object. Returns (its TRAIN_CLI
    record, its "clock" holding the parent's launch and end stamps beside
    the child's, and wall s)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           str(REPO / "chip_smoke.py"), "--train-cli-child", *args]
    t0, launched = time.perf_counter(), time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=DDP_CLI_TIMEOUT_S)
    wall_s, ended = time.perf_counter() - t0, time.time()
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN_CLI ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"ddp {label}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    run = json.loads(lines[-1][len("TRAIN_CLI "):])
    run["clock"].update(launched=launched, ended=ended)
    info = run["dist"]
    if (info.get("backend"), info.get("world"), info.get("all_reduce"), info.get("host_backend"),
            info.get("host_is_world"), info.get("host_gathered")) != (
            "nccl", 1, 1.0, "gloo", False, [0]):
        raise AssertionError(f"ddp {label}: process group {info}")
    return run, wall_s


def clock_parts(clock: dict, marks: tuple) -> str:
    """s between consecutive stamps of a CLI child's clock, by the later
    stamp's name (entry: the launcher and the child's imports; group: the
    process group; ended: the child's and the launcher's exit)."""
    return ",".join(f"{b}:{clock[b] - clock[a]:.1f}" for a, b in zip(marks, marks[1:]))


def ddp_rank_child(argv: list) -> None:
    """[ddp] (b)'s rank process (started by dryrun_multichip.launch):
    joins the gloo group on the one card, loads the weights and batches and
    builds the model, the optimizer and DDP, then waits for the parent's
    `go` file (written once the card is free of leg (a) and of the
    one-process run; "abort" ends it). Then it takes DDP_STEPS f32 train
    steps on its rows of the global batches, times a
    gradient-sized all_reduce, runs the model-axis leg (model_axis_rank) and
    do_test sharded over the ranks; pickles what it measured beside the
    job."""
    import argparse
    import hashlib

    p = argparse.ArgumentParser()
    p.add_argument("job")
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--init-method")
    args = p.parse_args(argv)
    if DEV == "cuda":  # both ranks on the one card: NCCL refuses that, gloo does not
        torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False  # f32 as the one process runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    mh.maybe_init_distributed(backend="gloo", init_method=args.init_method,
                              world_size=args.world, rank=args.rank)
    with open(args.job, "rb") as f:
        job = pickle.load(f)
    cfg32 = merged_config(FLAGSHIP)
    cfg32.PARALLEL.DTYPE = "float32"
    state_dict = torch.load(job["init_path"], weights_only=True)
    batches = [train_batch(cfg32, DDP_BATCH, seed=s) for s in job["seeds"]]
    went = []

    def wait_for_go() -> None:  # the model, optimizer and DDP built; the card may be busy
        go, deadline = Path(job["go"]), time.monotonic() + DDP_TIMEOUT_S
        while not go.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"ddp rank {args.rank}: no go from the parent")
            time.sleep(0.05)
        if go.read_text() != "go":
            raise SystemExit(f"ddp rank {args.rank}: the parent aborted")
        went.append(time.perf_counter())

    out = {"rank": args.rank}
    res = train_steps(cfg32, state_dict, batches, device=DEV, keep_steps=args.rank == 0,
                      before_steps=wait_for_go)
    t_go = went[0]
    out.update(metrics=res["metrics"], step_ms=res["step_ms"],
               parts_s={"steps": time.perf_counter() - t_go})
    out["buffers_sha"] = hashlib.sha256(b"".join(
        v.numpy().tobytes() for v in res["buffers"].values())).hexdigest()
    if args.rank == 0:  # the first step's gradients against one process's
        ref = torch.load(job["ref_path"], weights_only=True)
        sizes = [(k, v.numel()) for k, v in state_dict.items()  # the parameters' order
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
        out["grads"] = []
        for got, want in zip(res["grads"], ref):
            parts = dict(zip([k for k, _ in sizes], got.split([n for _, n in sizes])))
            wants = dict(zip([k for k, _ in sizes], want.split([n for _, n in sizes])))
            per = {k: rel_l2(parts[k], wants[k]) for k in parts}
            worst = max(per, key=per.get)
            out["grads"].append({"all": rel_l2(got, want), "worst": worst,
                                 "worst_rel": per[worst]})
    flat = torch.zeros(sum(p.numel() for p in state_dict.values() if p.is_floating_point()),
                       device=DEV)
    ms = []
    for _ in range(4):  # a gradient-sized all_reduce over gloo, the first left out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(flat)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = float(np.median(ms[1:]))
    out["allreduce_mb"] = flat.numel() * 4 / 2 ** 20
    del res
    out["model_axis"] = model_axis_rank(job, cfg32, state_dict, args.rank)
    out["parts_s"]["to_test"] = time.perf_counter() - t_go
    # the sharded test
    c = merged_config(FLAGSHIP)
    apply_opts(c, job["test_opts"])
    models = ObjectModels(job["meta"], num_pm_points=c.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=c.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    model = load_weights(build_model(c, device=DEV), job["weights"])
    kernels.nn_min_dist.launches = kernels.rasterize_xyz.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = do_test(c, model, models, job["records"], output_dir=job["out"], device=DEV)
    torch.cuda.synchronize()
    out.update(test_wall_s=time.perf_counter() - t0, results=results,
               b1=kernels.nn_min_dist.launches, b2=kernels.rasterize_xyz.launches)
    out["parts_s"]["done"] = time.perf_counter() - t_go
    torch.distributed.destroy_process_group()
    with open(f"{args.job}.rank{args.rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def state_bytes(model: torch.nn.Module, optimizer) -> int:
    """Bytes of the model's parameters and of its optimizer's state (every
    per-parameter tensor and the shared counters), as this process holds
    them."""
    tensors = list(model.parameters()) + [
        v for st in optimizer.state.values() for v in st.values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)


def model_axis_rank(job: dict, cfg32, state_dict: dict, rank: int) -> dict:
    """[ddp] (b)'s model-axis leg on one of the two gloo ranks: MP_STEPS f32
    steps of the flagship on a (1, 2) grid (tools/dryrun_multichip.
    train_steps: the model sharded, the optimizer over its slices), the
    gathered checkpoint written and resumed onto the grid. Returns the
    rank's terms, step ms, slices' shapes, replicated parameters' digest,
    bytes, the first step's gradients against one process's (rank 0) and
    whether the resume gave its slices back bit for bit."""
    import hashlib

    from gdrnet_tpu_torch.engine.train_state import create_train_state
    from gdrnet_tpu_torch.parallel import tensor_parallel
    from gdrnet_tpu_torch.solver.optimizers import build_optimizer

    t0 = time.perf_counter()
    cfg = merged_config(FLAGSHIP)
    cfg.PARALLEL.DTYPE, cfg.PARALLEL.MODEL_PARALLEL = "float32", 2
    batches = [train_batch(cfg, MP_BATCH, seed=s) for s in job["mp_seeds"]]
    res = train_steps(cfg, state_dict, batches, device=DEV, keep_steps=True)
    model, opt = res["model"], res["optimizer"]
    sharded = {f"{n}.weight" for n, _ in tensor_parallel.sharded_modules(model)}
    replicated = [p for k, p in model.named_parameters() if k not in sharded]
    out = {"metrics": res["metrics"], "step_ms": res["step_ms"],
           "fc1": tuple(model.pnp_net.fc1.weight.shape), "sharded": len(sharded),
           "bytes": state_bytes(model, opt), "grid": (mh.data_size(), mh.model_size()),
           "replicated": hashlib.sha256(b"".join(
               p.detach().cpu().numpy().tobytes() for p in replicated)).hexdigest()}
    if rank == 0:
        ref = torch.load(job["mp_ref_path"], weights_only=True)
        names = [k for k, _ in model.named_parameters()]
        sizes = [res["state"][k].numel() for k in names]  # the parameters' whole sizes
        got = dict(zip(names, res["grads"][0].split(sizes)))
        want = dict(zip(names, ref.split(sizes)))
        per = {k: rel_l2(got[k], want[k]) for k in names}
        worst = max(per, key=per.get)
        out["grads"] = {"all": rel_l2(res["grads"][0], ref), "worst": worst,
                        "worst_rel": per[worst]}
    t_ckpt = time.perf_counter()
    state = create_train_state(model, opt)
    CheckpointManager(job["mp_ckpt"]).save(state, MP_STEPS)
    fresh = tensor_parallel.shard_model(build_model(cfg, device=DEV))
    fresh_opt = build_optimizer(cfg, fresh)
    CheckpointManager(job["mp_ckpt"]).resume_or_load(create_train_state(fresh, fresh_opt))
    local, back = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    out["resume_bitwise"] = all(
        torch.equal(v, fresh.state_dict()[k]) for k, v in model.state_dict().items()) and \
        local.keys() == back.keys() and all(
            torch.equal(v, back[i][n]) for i, st in local.items() for n, v in st.items())
    out.update(ckpt_s=time.perf_counter() - t_ckpt, leg_s=time.perf_counter() - t0)
    mh.set_model_parallel(1)  # the sharded test that follows runs on the plain world
    return out


def phase_ddp(cfg, split, dets: dict, weights: str, tested: tuple, root: str,
              card: str) -> tuple[int, int]:
    """[ddp]: data-parallel training and sharded testing, (a) one NCCL rank
    through the CLI (ddp_nccl), (b) two gloo ranks on the one card
    (ddp_gloo; after their DDP steps the model axis, model_axis_rank). (b)'s
    rank processes start with (a) and build their model, then wait for the
    card before their timed work. Returns their (B1, B2) launches."""
    t0 = time.perf_counter()
    job: dict = {}
    try:
        job.update(start_gloo_ranks(cfg, split, dets, weights, root))
        a = ddp_nccl(dets, root, card)
        b = ddp_gloo(cfg, split, dets, tested, job, card)
    finally:
        if job:  # ranks still waiting (a failure above) end; none outlives the phase
            go = job["dir"] / "go"
            if not go.exists():
                (job["dir"] / "go.tmp").write_text("abort")
                (job["dir"] / "go.tmp").rename(go)
            job["thread"].join()
    log("ddp", phase_s=f"{time.perf_counter() - t0:.1f}", check="ok")
    return a[0] + b[0], a[1] + b[1]


def ddp_nccl(dets: dict, root: str, card: str) -> tuple[int, int]:
    """[ddp] (a): the engine.train CLI under torch.distributed.run as one
    NCCL rank: the flagship at full width over the [train_loop] split for
    DDP_CLI_ITERS iterations, then --eval-only on its checkpoint over the
    BOP split's detections, both CLI runs in the one launcher process (a
    process start saved). Gates: the process group (ddp_cli); losses
    finite, no step skipped; the rank's log; a checkpoint whose keys have no
    `module.`; B2 launched in training (the split has no pickles yet), B1 in
    the test, one CSV row a kept detection. Returns (B1, B2) launches."""
    link = Path(root) / "bop"
    if not link.exists():
        link.symlink_to(Path(root), target_is_directory=True)
    out_a, out_e = Path(root) / "ddp_out", Path(root) / "ddp_eval"
    run, cli_s = ddp_cli([
        "--max-iters", str(DDP_CLI_ITERS), "--config-file", FLAGSHIP, "--data-root", root,
        f"OUTPUT_DIR={str(out_a)!r}",
        "DATASETS.TRAIN=('loop_train',)", "DATASETS.TEST=()", "INPUT.CHANGE_BG_PROB=0.0",
        "SOLVER.TOTAL_EPOCHS=1", f"DATALOADER.NUM_WORKERS={LOOP_WORKERS}", "MODEL.WEIGHTS=''",
        "MODEL.CDPN.BACKBONE.PRETRAINED=''", "TRAIN.PRINT_FREQ=1",
        "--then", "--config-file", FLAGSHIP, "--eval-only", "--data-root", root,
        f"OUTPUT_DIR={str(out_e)!r}", f"MODEL.WEIGHTS={str(out_a / 'ckpt')!r}",
        "DATASETS.TEST=('bop_test',)", f"DATASETS.DET_FILES_TEST=({dets['path']!r},)"],
        "train, eval")
    tr = run["train"]
    losses, skips = np.array(tr["losses"]), np.array(tr["skips"])
    if len(losses) != DDP_CLI_ITERS or not np.all(np.isfinite(losses)) or skips.any() or \
            tr["b2"] < 1:
        raise AssertionError(f"ddp train: losses {losses.tolist()}, skips {skips.tolist()}, "
                             f"B2 {tr['b2']}")
    ckpts = sorted((out_a / "ckpt").glob("model_*.pth"))
    keys = list(torch.load(ckpts[-1], map_location="cpu", weights_only=True, mmap=True)["model"])
    with open(out_a / "log.txt") as f:
        rank_log = "rank 0 of 1" in f.read()
    if not ckpts or any(k.startswith("module.") for k in keys) or not rank_log:
        raise AssertionError(f"ddp train: checkpoints {ckpts}, keys {keys[:3]}, "
                             f"rank log {rank_log}")
    with open(out_e / "results.json") as f:
        res_a = json.load(f)
    rows_a = load_bop_results(res_a["_csv_path"])
    csv_rows_check(rows_a, "ddp eval")
    if len(rows_a) != dets["kept"] or run["b1_test"] < 1:
        raise AssertionError(f"ddp eval: {len(rows_a)} CSV rows for {dets['kept']} kept, "
                             f"B1 {run['b1_test']}")
    step_ms_a = np.diff(np.array(tr["step_starts"])) * 1e3  # the first step, warm-up included
    log("ddp_nccl", card=repr(card), launcher="torch.distributed.run --standalone "
        "--nproc_per_node=1", backend=run["dist"]["backend"], world=1,
        batch=merged_config(FLAGSHIP).SOLVER.IMS_PER_BATCH, iterations=len(losses),
        losses_finite=True, skipped=0, total_loss_first=f"{losses[0]:.4f}",
        total_loss_last=f"{losses[-1]:.4f}",
        first_step_ms=",".join(f"{m:.1f}" for m in step_ms_a),
        checkpoint=ckpts[-1].name, module_prefix=False, rank_log="log.txt",
        launches_rasterize_xyz_train=tr["b2"], launches_nn_min_dist_test=run["b1_test"],
        launches_rasterize_xyz_test=run["b2_test"], csv_rows=len(rows_a),
        ar_bop19=res_a.get("_bop_average_recall", "not scored"), cli_wall_s=f"{cli_s:.1f}",
        cli_parts_s=clock_parts(run["clock"], ("launched", "entry", "group", "train_start",
                                               "first_step", "train_end", "cli_end",
                                               "cli1_end", "ended")), check="ok")
    return run["b1_test"], tr["b2"] + run["b2_test"]


def start_gloo_ranks(cfg, split, dets: dict, weights: str, root: str) -> dict:
    """[ddp] (b)'s two rank processes (ddp_rank_child), started in a thread
    with their job: the flagship's seeded f32 weights, the batches' seeds,
    the sharded test's split, detections and weights. Returns the job."""
    job_dir = Path(root) / "ddp_job"
    job_dir.mkdir()
    job = {"seeds": [300 + i for i in range(DDP_STEPS)], "init_path": str(job_dir / "init.pt"),
           "ref_path": str(job_dir / "ref_grads.pt"), "go": str(job_dir / "go"),
           "mp_seeds": [350 + i for i in range(MP_STEPS)],
           "mp_ref_path": str(job_dir / "mp_ref_grads.pt"), "mp_ckpt": str(job_dir / "mp_ckpt"),
           "test_opts": [f"PARALLEL.DTYPE={cfg.PARALLEL.DTYPE!r}",
                         f"DATASETS.DET_FILES_TEST=({dets['path']!r},)"],
           "meta": split["models"].meta, "records": split["records"], "weights": weights,
           "out": str(job_dir / "test_out")}
    with open(job_dir / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    errors: list = []
    weights0: dict = {}
    ready = threading.Event()

    def run() -> None:
        try:  # the weights first (on the host, beside the eval-only CLI), then the ranks
            cfg32 = merged_config(FLAGSHIP)
            cfg32.PARALLEL.DTYPE = "float32"
            weights0.update(init_weights(build_model(cfg32, device="cpu"),
                                         torch.Generator().manual_seed(0)).state_dict())
            torch.save(weights0, job_dir / "init.pt")
            ready.set()
            launch([sys.executable, str(REPO / "chip_smoke.py"), "--ddp-rank-child",
                    str(job_dir / "job.pkl")], 2, timeout_s=DDP_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 (raised in the phase's thread)
            errors.append(e)
            ready.set()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return dict(job, dir=job_dir, state_dict=weights0, ready=ready, thread=thread,
                errors=errors)


def ddp_gloo(cfg, split, dets: dict, tested: tuple, job: dict, card: str) -> tuple[int, int]:
    """[ddp] (b): two gloo ranks on the one card (NCCL refuses two ranks on
    one card), named explicitly, started by start_gloo_ranks. DDP_STEPS f32
    steps of the flagship at a global DDP_BATCH against one process at
    DDP_BATCH from the same weights and batches: every loss term of every
    step within TRAIN_LOSS_RTOL, the first step's gradients within
    DDP_GRAD_ALL_REL overall and DDP_GRAD_TENSOR_REL a tensor, every BN
    buffer equal on both ranks. Then the model axis's gates
    (model_axis_gates) against one process's MP_STEPS at MP_BATCH, run here
    before the go. Then do_test sharded over the ranks against [do_test]'s
    one process: the same rows and keys, recalls equal but for counted
    threshold flips, B1 on each rank, B2 on rank 0. The ranks share one
    card: their step times are no scaling figure. Returns (B1, B2)
    launches."""
    torch.backends.cudnn.allow_tf32 = False  # f32 as the ranks run it
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = merged_config(FLAGSHIP)
    cfg32.PARALLEL.DTYPE = "float32"
    job["ready"].wait(DDP_TIMEOUT_S)
    if job["errors"] or not job["state_dict"]:
        raise AssertionError(f"ddp gloo: the ranks' job failed: {job['errors']}")
    one = train_steps(cfg32, job["state_dict"],
                      [train_batch(cfg32, DDP_BATCH, seed=s) for s in job["seeds"]],
                      device=DEV, keep_steps=True)
    torch.save(one["grads"][:1], job["ref_path"])  # the first step's
    del one["grads"], one["states"], one["model"], one["optimizer"]
    one_mp = train_steps(cfg32, job["state_dict"],  # the model axis's one process
                         [train_batch(cfg32, MP_BATCH, seed=s) for s in job["mp_seeds"]],
                         device=DEV, keep_steps=True)
    torch.save(one_mp["grads"][0], job["mp_ref_path"])
    one_mp.update(bytes=state_bytes(one_mp["model"], one_mp["optimizer"]),
                  opt_shapes={i: {n: tuple(v.shape) for n, v in st.items()} for i, st in
                              one_mp["optimizer"].state_dict()["state"].items()})
    for k in ("grads", "states", "model", "optimizer"):
        del one_mp[k]
    torch.cuda.empty_cache()
    c = test_cfg(cfg, dets)
    t0 = time.perf_counter()
    (job["dir"] / "go.tmp").write_text("go")
    (job["dir"] / "go.tmp").rename(job["go"])
    job["thread"].join()
    ranks_s = time.perf_counter() - t0
    if job["errors"]:
        raise job["errors"][0]
    ranks = []
    for r in range(2):
        with open(job["dir"] / f"job.pkl.rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    r0, r1 = ranks
    if r0["metrics"] != r1["metrics"] or r0["buffers_sha"] != r1["buffers_sha"]:
        raise AssertionError("ddp gloo: the ranks' logged terms or BN buffers differ")
    loss_rel = 0.0
    for i, (g, w) in enumerate(zip(r0["metrics"], one["metrics"])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_LOSS_RTOL, atol=1e-6,
                                       err_msg=f"ddp step {i} {k}")
            loss_rel = max(loss_rel, abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
    g = r0["grads"][0]
    if len(r0["grads"]) != 1 or g["all"] > DDP_GRAD_ALL_REL or \
            g["worst_rel"] > DDP_GRAD_TENSOR_REL:
        raise AssertionError(f"ddp gloo: the first step's gradients against one process {g}")
    # the sharded test against [do_test]'s one process (the same config, weights, split)
    want, want_rows, _ = tested
    res_b = r0["results"]
    rows_b = load_bop_results(res_b["_csv_path"])
    csv_rows_check(rows_b, "ddp do_test")
    if [(r["scene_id"], r["im_id"], r["obj_id"]) for r in rows_b] != [
            (r["scene_id"], r["im_id"], r["obj_id"]) for r in want_rows] or set(
            k for k in res_b if not k.startswith("_")) != set(
            k for k in want if not k.startswith("_")):
        raise AssertionError("ddp do_test: rows or result keys differ from one process's")
    if "_csv_path" in r1["results"] or "_bop" in r1["results"] or r0["b1"] < 1 or \
            r1["b1"] < 1 or r0["b2"] < 1:
        raise AssertionError(f"ddp do_test: rank 1 wrote a CSV or scored BOP, or launches "
                             f"B1 {r0['b1']}, {r1['b1']}, B2 {r0['b2']}, {r1['b2']}")
    model_axis_gates(ranks, one_mp, job, card)
    flips = threshold_flips(c, rows_b, want_rows, split["records"], split["models"])
    differ = recalls_differ("ddp do_test", res_b, want, flips)
    one_ms = np.median(one["step_ms"][1:])
    rank_ms = [np.median(r["step_ms"][1:]) for r in ranks]
    half = DDP_BATCH // 2
    log("ddp_gloo", card=repr(card), backend="gloo", ranks="2 on one card", dtype="float32",
        global_batch=DDP_BATCH, steps=DDP_STEPS, loss_max_rel=f"{loss_rel:.3e}",
        step1_grad_all_rel_l2=f"{g['all']:.3e}", step1_grad_worst_rel_l2=f"{g['worst_rel']:.3e}",
        step1_grad_worst_tensor=g["worst"], bn_buffers="equal on both ranks",
        one_process_step_ms=f"{one_ms:.1f}",
        one_process_rois_per_s=f"{DDP_BATCH / one_ms * 1e3:.1f}",
        rank_step_ms=",".join(f"{m:.1f}" for m in rank_ms),
        rank_rois_per_s=",".join(f"{half / m * 1e3:.1f}" for m in rank_ms),
        allreduce_ms=",".join(f"{r['allreduce_ms']:.1f}" for r in ranks),
        allreduce_mib=f"{r0['allreduce_mb']:.1f}",
        scaling="none: both ranks share one card", check="ok")
    log("ddp_do_test", card=repr(card), ranks=2, csv_rows=len(rows_b),
        rows_vs_one_process="same keys and order",
        recalls_vs_one_process="equal" if not differ else f"differ at {len(differ)} (flips)",
        threshold_flips=json.dumps(flips).replace(" ", ""),
        ar_bop19=f"{res_b['_bop_average_recall']:.4f}",
        ar_bop19_one_process=f"{want['_bop_average_recall']:.4f}",
        wall_s=",".join(f"{r['test_wall_s']:.2f}" for r in ranks),
        launches_nn_min_dist=f"{r0['b1']},{r1['b1']}",
        launches_rasterize_xyz=f"{r0['b2']},{r1['b2']}", ranks_after_go_s=f"{ranks_s:.1f}",
        rank0_s_after_go="steps {steps:.1f}, test start {to_test:.1f}, done {done:.1f}".format(
            **r0["parts_s"]),
        check="ok")
    return r0["b1"] + r1["b1"], r0["b2"] + r1["b2"]


def model_axis_gates(ranks: list, one: dict, job: dict, card: str) -> None:
    """[ddp] (b)'s model-axis leg against one process (MP_* above); logs
    `ddp_model_axis`."""
    mp = [r["model_axis"] for r in ranks]
    if [m["grid"] for m in mp] != [(1, 2)] * 2 or mp[0]["metrics"] != mp[1]["metrics"]:
        raise AssertionError(f"ddp model axis: grids {[m['grid'] for m in mp]}, or the ranks' "
                             "logged terms differ")
    loss_rel = 0.0
    for i, (g, w) in enumerate(zip(mp[0]["metrics"], one["metrics"])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_LOSS_RTOL, atol=1e-6,
                                       err_msg=f"ddp model axis step {i} {k}")
            loss_rel = max(loss_rel, abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
    g = mp[0]["grads"]
    if g["all"] > DDP_GRAD_ALL_REL or g["worst_rel"] > DDP_GRAD_TENSOR_REL:
        raise AssertionError(f"ddp model axis: the first step's gradients {g}")
    share = [m["bytes"] / one["bytes"] for m in mp]
    if mp[0]["replicated"] != mp[1]["replicated"] or any(
            m["fc1"] != MP_FC1_SHAPE for m in mp) or max(share) > MP_BYTES_SHARE:
        raise AssertionError(f"ddp model axis: replicated parameters equal "
                             f"{mp[0]['replicated'] == mp[1]['replicated']}, fc1 "
                             f"{[m['fc1'] for m in mp]}, bytes share {share}")
    step = max(CheckpointManager(job["mp_ckpt"]).steps())
    saved = torch.load(CheckpointManager(job["mp_ckpt"]).path(step), map_location="cpu",
                       weights_only=True, mmap=True)
    shapes = [(k, tuple(v.shape)) for k, v in saved["model"].items()]
    opt_shapes = {i: {n: tuple(v.shape) for n, v in st.items()}
                  for i, st in saved["optimizer"]["state"].items()}
    if shapes != [(k, tuple(v.shape)) for k, v in one["state"].items()] or \
            opt_shapes != one["opt_shapes"] or not all(m["resume_bitwise"] for m in mp):
        raise AssertionError(f"ddp model axis: the checkpoint's keys or shapes differ from one "
                             f"process's, or its resume {[m['resume_bitwise'] for m in mp]}")
    log("ddp_model_axis", card=repr(card), backend="gloo", ranks="2 on one card", grid="1x2",
        dtype="float32", global_batch=MP_BATCH, steps=MP_STEPS,
        sharded_weights=mp[0]["sharded"], fc1_local=",".join(map(str, mp[0]["fc1"])),
        loss_max_rel=f"{loss_rel:.3e}", step1_grad_all_rel_l2=f"{g['all']:.3e}",
        step1_grad_worst_rel_l2=f"{g['worst_rel']:.3e}", step1_grad_worst_tensor=g["worst"],
        replicated="bitwise equal on both ranks",
        state_bytes_share=",".join(f"{x:.4f}" for x in share),
        state_mib=",".join(f"{m['bytes'] / 2 ** 20:.1f}" for m in mp),
        one_process_state_mib=f"{one['bytes'] / 2 ** 20:.1f}",
        checkpoint="one process's keys and shapes", resume="bitwise",
        rank_step_ms=",".join(f"{np.median(m['step_ms'][1:]):.1f}" for m in mp),
        one_process_step_ms=f"{np.median(one['step_ms'][1:]):.1f}",
        ckpt_s=",".join(f"{m['ckpt_s']:.1f}" for m in mp),
        leg_s=",".join(f"{m['leg_s']:.1f}" for m in mp),
        scaling="none: both ranks share one card, over gloo", check="ok")


def rot_deg(Ra, Rb) -> np.ndarray:
    """Angle in degrees of Ra^T Rb ([..., 3, 3] each), by atan2 of its skew
    part, which resolves angles below arccos's f32 floor."""
    M = np.swapaxes(np.asarray(Ra, np.float64), -1, -2) @ np.asarray(Rb, np.float64)
    v = np.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                  M[..., 1, 0] - M[..., 0, 1]], -1) / 2
    return np.degrees(np.arctan2(np.linalg.norm(v, axis=-1),
                                 (np.trace(M, axis1=-2, axis2=-1) - 1) / 2))


def pnp_card_vs_cpu() -> None:
    """(a) pnp_from_maps_batch in each mode on the card and on the CPU with
    the same minimal sets (drawn once on the CPU)."""
    rng = np.random.RandomState(0)
    mask, xyzn, c2d, R, t, K, ext, (W, H) = synthetic_decoded_maps(
        rng, PNP_B, h=PNP_HW, w=PNP_HW, noise_px=0.5, t_jitter=0.02)
    axes = rng.randn(PNP_B, 3)
    axes *= np.radians(PNP_NET_DEG) / np.linalg.norm(axes, axis=1, keepdims=True)
    R_net = np.stack([cv_pnp.rodrigues(a) @ r for a, r in zip(axes, R)]).astype(np.float32)
    t_net = (t + [0.02, -0.01, 0.02]).astype(np.float32)
    host = {"mask_prob": mask, "xyz_norm": xyzn, "coord2d": c2d,
            "im_wh": np.tile([[W, H]], (PNP_B, 1)).astype(np.float32),
            "extents": np.tile(ext, (PNP_B, 1)), "Ks": np.tile(K, (PNP_B, 1, 1)),
            "rot_net": R_net, "trans_net": t_net, "roi_valid": np.ones(PNP_B, bool)}
    on = {d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(d) for k, v in host.items()}
          for d in (DEV, "cpu")}
    w = device_pnp.correspondence_weights(*(on["cpu"][k] for k in (
        "mask_prob", "xyz_norm", "coord2d", "im_wh", "extents")))[2]
    idx = device_pnp.draw_samples(w, 128, 6, torch.Generator().manual_seed(0))
    for mode in device_pnp.MODES:
        got = {}
        for d in (DEV, "cpu"):
            if d == DEV:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            Rd, td = device_pnp.pnp_from_maps_batch(**on[d], mode=mode, sample_idx=idx)
            got[d] = (Rd.cpu().numpy(), td.cpu().numpy(), time.perf_counter() - t0)
        (Rc, tc, card_s), (Rp, tp, cpu_s) = got[DEV], got["cpu"]
        vs_deg, vs_m = float(rot_deg(Rc, Rp).max()), float(np.abs(tc - tp).max())
        near = (rot_deg(Rc, R) < PNP_TRUTH_DEG) & (np.linalg.norm(tc - t, axis=1) < PNP_TRUTH_M)
        if vs_deg > PNP_DEG or vs_m > PNP_METRE or near.mean() < PNP_TRUTH_SHARE:
            raise AssertionError(f"pnp {mode}: card vs CPU {vs_deg} deg, {vs_m} m; "
                                 f"{near.mean()} of the ROIs near the truth")
        log("pnp", mode=mode, rois=PNP_B, maps=f"{PNP_HW}x{PNP_HW}", points_median=int(
            w.sum(-1).median()), hypotheses=idx.shape[1], vs="cpu, same minimal sets",
            max_deg=f"{vs_deg:.3e}", max_m=f"{vs_m:.3e}", deg_tol=PNP_DEG, m_tol=PNP_METRE,
            near_truth=f"{near.mean():.3f}", truth_deg_median=f"{np.median(rot_deg(Rc, R)):.4f}",
            first_call_card_s=f"{card_s:.3f}", cpu_s=f"{cpu_s:.3f}", check="ok")


def phase_pnp(cfg, split, dets: dict, weights: str, root: str, card: str) -> tuple[int, int]:
    """The PnP slice on the card: (a) the device program against the CPU,
    (b) bench_pnp's ROIs/s and peak memory, (c) do_test with TEST.USE_PNP on
    [train_loop]'s checkpoint (finite CSV rows with rotations, one a kept
    detection, finite recalls, B1 launched inside each run), (d) do_train
    with TRAIN.VIS_IMG (finite losses; with tensorboard, the five panels at
    every iteration). Returns the B1 and B2 launches of (c) and (d)."""
    t_phase = time.perf_counter()
    pnp_card_vs_cpu()
    for row in bench_pnp.run(PNP_B, PNP_BENCH_ITERS, device=DEV):
        log("pnp_bench", card=repr(card), **{k: (f"{v:.2f}" if isinstance(v, float) else v)
                                               for k, v in row.items() if k != "device"})
    nn_total = raster_total = 0
    for device_pnp_on, pnp_type in PNP_TEST_RUNS:
        c = test_cfg(cfg, dets)
        c.TEST.USE_PNP, c.TEST.DEVICE_PNP, c.TEST.PNP_TYPE = True, device_pnp_on, pnp_type
        model = load_weights(build_model(c, device=DEV), weights)
        torch.cuda.synchronize()
        kernels.nn_min_dist.launches = 0
        kernels.rasterize_xyz.launches = 0
        t0 = time.perf_counter()
        res = do_test(c, model, split["models"], split["records"],
                      output_dir=str(Path(root) / f"test_pnp_{pnp_type}"), device=DEV)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.nn_min_dist.launches, kernels.rasterize_xyz.launches
        rows = load_bop_results(res["_csv_path"])
        csv_rows_check(rows, f"do_test_pnp {pnp_type}")
        recalls = [res["Avg"][k] for k in RECALL_KEYS] + [res["_bop_average_recall"]]
        if launches[0] < 1 or len(rows) != dets["kept"] or not np.all(np.isfinite(recalls)):
            raise AssertionError(f"do_test_pnp {pnp_type}: launches {launches}, {len(rows)} rows "
                                 f"for {dets['kept']}, recalls {recalls}")
        nn_total, raster_total = nn_total + launches[0], raster_total + launches[1]
        tm = res["_time"]
        log("do_test_pnp", device_pnp=device_pnp_on, pnp_type=pnp_type, rois=len(rows),
            compute_s_per_bucket=f"{tm['compute_s_per_bucket']:.4f}",
            process_s_per_bucket=f"{tm['process_s_per_bucket']:.4f}", wall_s=f"{wall_s:.2f}",
            launches_nn_min_dist=launches[0], launches_rasterize_xyz=launches[1],
            ar_bop19=f"{res['_bop_average_recall']:.4f}",
            avg_mean_re=f"{res['Avg']['mean_re']:.3f}", check="ok")
        del model

    c = loop_cfg(root, str(Path(root) / "flagship_seed0.pth"))
    c.OUTPUT_DIR = str(Path(root) / "vis_out")
    c.SOLVER.IMS_PER_BATCH = PNP_VIS_BATCH
    c.TRAIN.VIS_IMG = True
    # [train_loop]'s mapped pool (the same split and INPUT): the fill is its phase's to test
    shutil.copytree(Path(root) / "train_out" / "pool_cache", Path(c.OUTPUT_DIR) / "pool_cache")
    kernels.rasterize_xyz.launches = 0
    t0 = time.perf_counter()
    state, _, preempted = do_train(c, data_root=root, max_iters_override=PNP_VIS_ITERS, device=DEV)
    vis_s = time.perf_counter() - t0
    raster_total += kernels.rasterize_xyz.launches
    with open(Path(c.OUTPUT_DIR) / "metrics.json") as f:
        losses = [json.loads(ln)["total_loss"] for ln in f]
    if preempted or state.step != PNP_VIS_ITERS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"vis_img: step {state.step}, losses {losses}")
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:
        EventAccumulator = None
    panels = {}
    if EventAccumulator is not None:
        acc = EventAccumulator(str(Path(c.OUTPUT_DIR) / "tb"), size_guidance={"images": 0})
        acc.Reload()
        panels = {tag: len(acc.Images(tag)) for tag in acc.Tags()["images"]}
        if len(panels) != 5 or set(panels.values()) != {PNP_VIS_ITERS}:
            raise AssertionError(f"vis_img: tensorboard holds the panels {panels}")
    log("vis_img", iterations=PNP_VIS_ITERS, batch=PNP_VIS_BATCH,
        tensorboard="present" if EventAccumulator is not None else "absent",
        panels_written=sum(panels.values()), tags=len(panels), losses_finite=True,
        wall_s=f"{vis_s:.1f}", phase_s=f"{time.perf_counter() - t_phase:.1f}", check="ok")
    return nn_total, raster_total


def phase_bench(weights: str, card: str) -> None:
    """[bench]: python -m gdrnet_tpu_torch.tools.bench's main in this
    process, as a user runs it: --bf16 on the random-init flagship input
    assembly at BENCH_BATCH, then the default int8 path on [train_loop]'s
    checkpoint with the flagship's config. Each line's value finite and
    above 0, the int8 drift fields finite."""
    runs = {"bf16": ["--bf16"], "int8_ckpt": ["--ckpt", weights, "--config", FLAGSHIP]}
    for label, extra in runs.items():
        t0 = time.perf_counter()
        rec = bench_tool.main(["--batch", str(BENCH_BATCH), "--iters", str(BENCH_ITERS)] + extra)
        wall_s = time.perf_counter() - t0
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"bench {label}: value {rec['value']}")
        drift = {k: rec[k] for k in ("int8_rot_drift_deg_mean", "int8_trans_rel_drift_max")
                 if k in rec}
        if label != "bf16" and (len(drift) != 2 or not all(np.isfinite(list(drift.values())))):
            raise AssertionError(f"bench {label}: drift fields {drift}")
        log("bench", card=repr(card), path=label, batch=BENCH_BATCH, iters=BENCH_ITERS,
            crops_per_s=rec["value"], vs_baseline=rec["vs_baseline"], ckpt=rec["ckpt"],
            wall_s=f"{wall_s:.1f}", **drift, check="ok")


def bench_train_loader(root: str, card: str) -> int:
    """[bench_train]'s loader leg, one line for each of BT_PIPELINES;
    returns B2's launches."""
    launches = 0
    for pipeline in BT_PIPELINES:
        kernels.nn_min_dist.launches = 0
        kernels.rasterize_xyz.launches = 0
        args = ["--with-loader", "--config-file", FLAGSHIP, "--data-root", root,
                "--batch-sizes", str(BT_BATCH), "--workers", str(BT_WORKERS),
                "--iters", str(BT_LOADER_ITERS), "--pipeline", pipeline,
                "DATASETS.TRAIN=('loop_train',)"]
        if pipeline == "pool":
            args[1:1] = ["--max-records", str(BT_POOL_RECORDS)]
        (row,) = bench_train_tool.main(args)
        b2 = kernels.rasterize_xyz.launches
        launches += b2
        # the first batch, the warm-up's next and the loop's; the pool maps
        # each of its records once
        need = row.get("pool_rows") or (BT_LOADER_ITERS + 2) * BT_BATCH
        if b2 < need or not (row["value"] > 0 and np.isfinite(row["loss"])):
            raise AssertionError(f"bench_train loader {pipeline}: B2 launched {b2} times for "
                                 f"{need} samples; {row}")
        pool = ({k: row[k] for k in ("pool_rows", "pool_mib", "pool_map_s", "pool_upload_s",
                                     "refreshed")} if pipeline == "pool" else {})
        log("bench_train_loader", card=repr(card), pipeline=pipeline, batch=BT_BATCH,
            workers=BT_WORKERS, iterations=BT_LOADER_ITERS, rois_per_s=row["value"],
            ms_per_step=row["ms_per_step"], data_ms_per_step=row["data_ms_per_step"],
            records=row["records"], build_s=row["build_s"], **pool,
            launches_rasterize_xyz=b2, launches_per_sample=f"{b2 / need:.2f}", check="ok")

    return launches


def phase_bench_train(root: str, card: str, train_ms: dict) -> int:
    """[bench_train]: tools/bench_train's three legs in this process: the
    step at BT_BATCH; --with-loader at BT_BATCH with BT_WORKERS threads for
    BT_LOADER_ITERS iterations over [train_loop]'s split, once for each of
    BT_PIPELINES (the pool's fill cut to BT_POOL_RECORDS records), before
    [gen_xyz] writes its pickles, so that every sample's XYZ renders on B2
    (at least once a sample the loop consumed, a record the pool mapped);
    --audit at BT_BATCH, its mfu and hbm_frac in (0, 1], its FLOP counts
    logged beside [train_time]'s step. Returns B2's launches in the loader
    leg."""
    (step,) = bench_train_tool.main(["--batch-sizes", str(BT_BATCH), "--iters",
                                     str(BT_STEP_ITERS)])
    if not (step["value"] > 0 and np.isfinite(step["loss"])):
        raise AssertionError(f"bench_train step: {step}")
    log("bench_train_step", card=repr(card), batch=BT_BATCH, rois_per_s=step["value"],
        ms_per_step=step["ms_per_step"], train_time_ms=f"{train_ms.get(BT_BATCH, 0):.3f}",
        loss=step["loss"], check="ok")

    launches = bench_train_loader(root, card)
    (audit,) = bench_train_tool.main(["--audit", "--batch-sizes", str(BT_BATCH), "--iters",
                                      str(BT_STEP_ITERS)])
    if not (0 < audit["mfu"] <= 1 and 0 < audit["hbm_frac"] <= 1):
        raise AssertionError(f"bench_train audit: mfu {audit['mfu']}, hbm_frac "
                             f"{audit['hbm_frac']}")
    log("bench_train_audit", card=repr(card), batch=BT_BATCH,
        step_gflops=audit["step_gflops"], fwd_gflops=audit["fwd_gflops"],
        fwd_gflops_on_input=audit["fwd_gflops_on_input"],
        step_fwd_flop_ratio=audit["step_fwd_flop_ratio"], step_eager_gb=audit["step_eager_gb"],
        step_aten_ops=audit["step_aten_ops"], ms_per_step=audit["ms_per_step"],
        train_time_ms=f"{train_ms.get(BT_BATCH, 0):.3f}",
        achieved_tflops=audit["achieved_tflops"], mfu=audit["mfu"],
        achieved_hbm_gbs=audit["achieved_hbm_gbs"], hbm_frac=audit["hbm_frac"],
        peak_bf16_tflops=audit["peak_bf16_tflops"],
        peak_hbm_gbs=audit["peak_hbm_gbs"], check="ok")
    return launches


EXPORT_CHILD = """
import sys, time, numpy as np, torch
t0 = time.perf_counter()
# the parent's TF32 settings: an exported program records no process flag
torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
    flag == "1" for flag in sys.argv[2])
args = np.load(sys.argv[1])
for name in sys.argv[3:]:
    fwd = torch.export.load(name + ".pt2").module()
    with torch.no_grad():
        r, t = fwd(*[torch.from_numpy(args[f"arr_{i}"]).cuda() for i in range(8)])
    np.savez(name + ".out.npz", r=r.float().cpu().numpy(), t=t.float().cpu().numpy())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("gdrnet_tpu_torch", "gdrnet_tpu"))
assert not bad, bad
print(f"EXPORT_CHILD loaded={len(sys.argv) - 3} s={time.perf_counter() - t0:.1f}")
"""


def phase_export(weights: str, root: str, card: str) -> None:
    """[export]: tools/export_model on the card at EXPORT_BATCH over
    [train_loop]'s checkpoint, bf16 (the flagship's PARALLEL.DTYPE) and
    --int8; both artifacts loaded and run in one child process that
    imports only torch (gdrnet_tpu_torch must not be in its sys.modules)
    under this process's TF32 settings, while this process runs the serving
    forwards; the bf16 artifact's poses equal the in-process forward's bit
    for bit, and so do the int8 one's."""
    out = Path(root) / "export"
    t0 = time.perf_counter()
    metas = {}
    for label, extra in (("bf16", []), ("int8", ["--int8"])):
        metas[label] = export_tool.main(["--out", str(out / f"{label}.pt2"), "--ckpt", weights,
                                         "--config", FLAGSHIP, "--batch", str(EXPORT_BATCH)]
                                        + extra)
    export_s = time.perf_counter() - t0
    cfg = export_tool.export_config(FLAGSHIP)
    batch = export_tool.export_batch(cfg, EXPORT_BATCH, DEV)
    np.savez(out / "args.npz", *[batch[k].cpu().numpy() for k in export_tool.ARG_NAMES])
    t0 = time.perf_counter()
    tf32 = "".join(str(int(flag)) for flag in (torch.backends.cudnn.allow_tf32,
                                                torch.backends.cuda.matmul.allow_tf32))
    proc = subprocess.Popen([sys.executable, "-c", EXPORT_CHILD, str(out / "args.npz"), tf32]
                            + [str(out / label) for label in metas], cwd=out,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        model = load_weights(build_model(cfg, device=DEV), weights)
        want = {}
        for label in metas:
            with torch.no_grad():
                rot, trans = export_tool.serving_forward(model, batch, int8=label == "int8")(
                    *[batch[k] for k in export_tool.ARG_NAMES])
            want[label] = (rot.float().cpu().numpy(), trans.float().cpu().numpy())
        stdout, stderr = proc.communicate(timeout=EXPORT_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export: the torch-only child exited {proc.returncode}\n"
                             f"{stderr[-3000:]}")
    for label, meta in metas.items():
        got = np.load(out / f"{label}.out.npz")
        r_want, t_want = want[label]
        deg = rot_deg(got["r"], r_want)
        t_rel = np.abs(got["t"] - t_want).max(1) / np.maximum(np.abs(t_want).max(1), 1e-3)
        differ = (got["r"] != r_want).any((1, 2)) | (got["t"] != t_want).any(1)
        n = int(differ.sum())
        if n:
            raise AssertionError(f"export {label}: the loaded program's poses differ from the "
                                 f"in-process forward at {n} of {len(deg)} crops, by up to "
                                 f"{deg.max()} degrees, translations {t_rel.max()} relative")
        log("export", card=repr(card), variant=label, batch=EXPORT_BATCH, int8=meta["int8"],
            mb=f"{meta['bytes'] / 2**20:.1f}", platforms=",".join(meta["platforms"]),
            bitwise_equal=not n, crops_differing=n, rot_deg_max=f"{deg.max():.4f}",
            trans_rel_max=f"{t_rel.max():.3e}", export_s=f"{export_s:.1f}",
            child_s=f"{child_s:.1f}", child=stdout.strip().splitlines()[-1], check="ok")


def phase_strip_ckpt(weights: str, root: str, request: dict) -> None:
    """[strip_ckpt]: tools/strip_ckpt over [train_loop]'s checkpoint
    directory; the slim file is smaller, holds only the model and the
    iteration, and its weights serve the same poses bit for bit."""
    slim_dir = Path(root) / "ckpt_slim"
    path = strip_tool.main(["--ckpt-dir", weights, "--out", str(slim_dir)])
    src = CheckpointManager(weights)
    src_path = src.path(src.latest_step())
    slim = torch.load(path, weights_only=True)
    if set(slim) != {"model", "iteration"} or Path(path).stat().st_size >= Path(
            src_path).stat().st_size:
        raise AssertionError(f"strip_ckpt: keys {sorted(slim)}, {Path(path).stat().st_size} "
                             f"bytes against {Path(src_path).stat().st_size}")
    cfg = merged_config(FLAGSHIP)
    batch = to_device(request, DEV)
    poses = [make_predict_step(load_weights(build_model(cfg, device=DEV), w))(batch)
             for w in (weights, str(slim_dir))]
    if not all(torch.equal(poses[0][k], poses[1][k]) for k in ("rot", "trans")):
        raise AssertionError("strip_ckpt: the slim checkpoint serves other poses")
    log("strip_ckpt", iteration=slim["iteration"], mb=f"{Path(path).stat().st_size / 2**20:.1f}",
        source_mb=f"{Path(src_path).stat().st_size / 2**20:.1f}", crops=len(request["roi_img"]),
        poses_bitwise_equal=True, check="ok")


def phase_pvnet(card: str) -> None:
    """[pvnet]: PVNet-34 (models/pvnet.py, 65 bins, the reference's widths)
    at PVNET_RES^2 in f32 with TF32 off, seeded: PVNET_CPU_CROPS crops on
    the card against the CPU within PVNET_REL of each output's scale; then
    its ms a call at PVNET_BATCH (CUDA events)."""
    torch.manual_seed(0)
    net = PVNet(depth=34).eval()
    x = torch.rand(PVNET_CPU_CROPS, PVNET_RES, PVNET_RES, 3,
                   generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = net(x)
            net = net.to(DEV)
            got = net(x.to(DEV))
            worst = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-12))
                        for g, w in zip(got, want))
            if worst > PVNET_REL or not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"pvnet: card against CPU {worst} of the scale")
            xb = torch.rand(PVNET_BATCH, PVNET_RES, PVNET_RES, 3, device=DEV)
            reset_peak()
            ms = cuda_times(lambda: net(xb), PVNET_TIMED)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log("pvnet", card=repr(card), depth=34, res=PVNET_RES, dtype="float32", vs="cpu",
        crops=PVNET_CPU_CROPS, max_rel=f"{worst:.3e}", batch=PVNET_BATCH,
        ms_median=f"{np.median(ms):.3f}", crops_per_s=f"{PVNET_BATCH / np.median(ms) * 1e3:.1f}",
        peak_mem_gib=f"{peak_gib():.2f}", check="ok")


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
    # the synth dataset's generator, 13. serving from images and the offline
    # tools: folded BN, int8, predict, eval_csv, gen_xyz, 14. then the
    # profiled measurements
    with tempfile.TemporaryDirectory() as root:
        split = phase_bop_split(cfg, gsd, requests, root)
        raster_launches, scored = phase_bop_score(cfg, split, R, t, root)
        del model, m32, predict
        phase_train_f32(cfg32, state_dict)
        train, train_ms = phase_train(cfg, state_dict, card)
        loop_launches, loader_rate, loop = phase_train_loop(cfg, state_dict, gsd, root, card)
        parity_launches = phase_pool_parity(root, loop["weights"], card)
        color_launches = phase_color_aug(root, card, loop)
        ckpt = str(Path(root) / "train_out" / "ckpt")
        dets = write_detections(split, str(Path(root) / "est_dets.json"))
        tested = phase_do_test(cfg, split, dets, ckpt, root, card)
        phase_do_test_vs_cpu(cfg32, split, dets, ckpt, root)
        phase_cli(cfg, split, dets, ckpt, root, tested)
        pnp_launches = phase_pnp(cfg, split, dets, ckpt, root, card)
        # before [gen_xyz] writes the train split's pickles: its XYZ renders on B2
        tv_launches = phase_train_variant(root, dets, card)
        vis_launches = phase_visualize(root, card)
        bt_launches = phase_bench_train(root, card, train_ms)
        ddp_launches = phase_ddp(cfg, split, dets, ckpt, tested, root, card)
        overfit, overfit_launches = phase_overfit(root, card)
        phase_scale_run(root)
        phase_render_attr(gsd)
        phase_render_phong_xyz(gsd)
        gen_launches = phase_gen_dataset(gsd, root, card)
        fps_cloud = phase_fps(root, card)
        phase_fold_bn(cfg, cfg32, ckpt, requests[0])
        serving = phase_int8(cfg, ckpt, requests[0], overfit)
        predicted = phase_predict(cfg, split, dets, ckpt, root)
        csv_launches = phase_eval_csv(cfg, split, predicted, root)
        xyz_launches = phase_gen_xyz(cfg, root)
        phase_loader_pkl(root, loader_rate)
        phase_jpeg()
        lmo_launches = phase_train_lmo(gsd, root, card, loader_rate)
        phase_variants(card)
        phase_solvers(state_dict, card)
        phase_bench(ckpt, card)
        phase_export(ckpt, root, card)
        phase_strip_ckpt(ckpt, root, requests[0])
        phase_pvnet(card)
        phase_profile(cfg, split, scored, raster_timed, train, serving, fps_cloud)
    test_launches = tested[2]

    print(json.dumps({"kernels": [
        {"name": "nn_min_dist", "route": "cuda",
         "source": "gdrnet_tpu_torch/csrc/nn_min_dist.cu",
         "replaces": "gdrnet_tpu/ops/pallas_kernels.py:28",
         "launches": launches + test_launches[0] + csv_launches[0] + lmo_launches[0]
         + tv_launches[0] + pnp_launches[0] + ddp_launches[0] + overfit_launches[0],
         **nn_stats},
        {"name": "rasterize_xyz", "route": "cuda",
         "source": "gdrnet_tpu_torch/csrc/rasterize_xyz.cu",
         "replaces": "gdrnet_tpu/ops/pallas_kernels.py:140",
         "launches": raster_launches + loop_launches + test_launches[1] + gen_launches
         + csv_launches[1] + xyz_launches + lmo_launches[1] + tv_launches[1] + pnp_launches[1]
         + ddp_launches[1] + bt_launches + color_launches + overfit_launches[1]
         + vis_launches + parity_launches,
         **raster_stats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-cli-child"]:
        train_cli_child(sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--ddp-rank-child"]:
        ddp_rank_child(sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
