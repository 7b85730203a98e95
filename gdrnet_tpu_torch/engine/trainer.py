"""Training orchestration: config -> data / model / optimizer -> the train loop
(counterpart of gdrnet_tpu/engine/trainer.py:36-69,107-207,210-463).

The reference's GDRN_Lite.do_train (core/gdrn_modeling/engine.py:144-333)
on one device: the host TrainLoader's worker threads map BOP records (the
XYZ ground truth of a record without an xyz_crop pickle rendered by the
z-buffer kernel on the card), each batch goes to the device from pinned host
memory while the previous step runs, engine/steps.make_train_step takes the
step, and the loop checkpoints, writes console / metrics.json lines, calls
eval_fn every TEST.EVAL_PERIOD epochs, checkpoints and returns on
SIGTERM / SIGINT, and stops on a persistent non-finite loss (engine.py:271).
With TEST.PRECISE_BN it recomputes the BN statistics over NUM_ITER train
batches (engine/precise_bn.py) before each periodic eval, as the JAX package
does, and once after the last iteration, so that the final checkpoint and
the test that follows read them (detectron2's PreciseBN hook runs at the
final iteration too; the JAX package's do_train leaves the final statistics
as their running average). With TRAIN.VIS_IMG it writes five tensorboard
panels of the current batch's first ROI at each log boundary (the input
crop, the predicted and GT xyz, the predicted and GT mask), as JAX does
(gdrnet_tpu/engine/trainer.py:405-427); without tensorboard it writes none.

Data parallelism (ROADMAP.md A10): under a launcher (`torchrun`, one process
a GPU) or a process group the caller made, every rank trains on its row
block of each global batch of SOLVER.IMS_PER_BATCH (data/loader.py) with the
model wrapped in DistributedDataParallel, its BatchNorms over the global
batch (parallel/sync_bn.py) and the loss terms and logged metrics global
(losses/gdrn_loss.py, engine/steps.py), so N ranks take the step one
process takes at the same global batch. parallel/mesh.resolve_world checks
the world against PARALLEL.MESH_SHAPE and the batch. Rank 0 broadcasts the
seed, writes the checkpoints, the console and metrics.json lines and
tensorboard; every rank logs to its own file and stops at the same
iteration on SIGTERM; eval_fn tests sharded (engine/tester.py).

The model axis (PARALLEL.MODEL_PARALLEL = m > 1): the world is a (d, m)
grid (parallel/multihost.py), the batch is split over d, and the model is
sharded (parallel/tensor_parallel.shard_model) before the optimizer is
built, so that each rank holds and updates its 1/m of every large weight and
of its optimizer state (gdrnet_tpu/engine/trainer.py:267-299). Checkpoints
hold the gathered weights and state, one process's file (engine/
checkpoint.py); the test after training runs on a gathered replica.

The device-side input (gdrnet_tpu/engine/trainer.py:63-68,107-207), as the
flagship config trains: TRAIN.DEVICE_RESIDENT_POOL maps the train set once
into a pool of compact rows on the card (data/device_pool.py); the loader
then yields sampler indices and to_device gathers and decodes the batch on
the card, and with TRAIN.POOL_REFRESH a host thread re-maps slots that the
loop writes in after each step (one chunk a step). INPUT.DEVICE_PREPROCESS
maps with GDRNRawTrainMapper and makes the crops and targets on the card
(data/device_pipeline.py), with INPUT.DEVICE_COLOR_AUG jittering there too;
its draws come from a generator seeded by the run's seed, the iteration and
the data rank, so a resumed run draws as the original. The pool with
DEVICE_PREPROCESS raises JAX's NotImplementedError; the device jitter
refuses ssd, albu and code_albu with JAX's ValueError.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import os.path as osp
import signal
import time

import numpy as np
import torch

from gdrnet_tpu_torch.data.augment import BackgroundReplacer
from gdrnet_tpu_torch.data.dataset_factory import resolve
from gdrnet_tpu_torch.data.loader import TrainLoader
from gdrnet_tpu_torch.data.device_augment import TorchKey, color_aug_op
from gdrnet_tpu_torch.data.device_pipeline import device_train_batch
from gdrnet_tpu_torch.data.device_pool import DevicePool, PoolRefresher, pool_index_sampler
from gdrnet_tpu_torch.data.mapper import GDRNRawTrainMapper, GDRNTrainMapper
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager, init_model_weights
from gdrnet_tpu_torch.engine.decode import get_out_coor, get_out_mask
from gdrnet_tpu_torch.engine import profiling
from gdrnet_tpu_torch.engine.precise_bn import update_bn_stats
from gdrnet_tpu_torch.engine.steps import (
    _autocast,
    _model_kwargs,
    make_predict_step,
    make_train_step,
)
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.engine.writers import (
    ConsoleWriter,
    EventLog,
    JsonWriter,
    TensorboardWriter,
    setup_logger,
)
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.parallel import ddp_model, resolve_world, shard_model
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule

def check_supported(cfg) -> None:
    """Raise where the JAX package refuses the input settings: the pool maps
    on the host, so it does not take DEVICE_PREPROCESS
    (gdrnet_tpu/engine/trainer.py:128-130), and the device jitter takes aae,
    code and roi10d only (gdrnet_tpu/data/device_augment.py:337-344)."""
    inp = cfg.INPUT
    if cfg.TRAIN.get("DEVICE_RESIDENT_POOL") and inp.get("DEVICE_PREPROCESS"):
        raise NotImplementedError("DEVICE_RESIDENT_POOL maps on host; disable DEVICE_PREPROCESS")
    aug_type = inp.COLOR_AUG_TYPE
    if (inp.get("DEVICE_PREPROCESS") and inp.get("DEVICE_COLOR_AUG") and aug_type
            and inp.COLOR_AUG_PROB > 0 and aug_type.lower() not in ("aae", "code", "roi10d")):
        raise ValueError(
            f"device color aug supports aae/code/roi10d, got {aug_type!r} "
            "(keep INPUT.DEVICE_COLOR_AUG=False for ssd/albu)")


def build_train_objects(cfg, data_root: str = "datasets/BOP_DATASETS", device="cuda"):
    """Resolve datasets + models + mapper from cfg; the mapper renders
    missing XYZ ground truth on `device`."""
    names = list(cfg.DATASETS.TRAIN)
    assert names, "DATASETS.TRAIN is empty"
    thr = cfg.DATALOADER.FILTER_VISIB_THR
    meta, records = resolve(names[0], data_root, visib_thr=thr)
    for extra in names[1:]:
        records = records + resolve(extra, data_root, visib_thr=thr)[1]
    records2 = []
    if cfg.DATASETS.TRAIN2 and cfg.DATASETS.TRAIN2_RATIO > 0:
        for extra in cfg.DATASETS.TRAIN2:
            records2 += resolve(extra, data_root, visib_thr=thr)[1]

    models = ObjectModels(
        meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
        num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    bg = None
    if cfg.INPUT.CHANGE_BG_PROB > 0 or any(
            r.get("img_type", "real") != "real" for r in records):
        bg = BackgroundReplacer(
            cfg.INPUT.BG_IMGS_ROOT, cfg.INPUT.NUM_BG_IMGS,
            keep_aspect=cfg.INPUT.BG_KEEP_ASPECT_RATIO,
            bg_type=cfg.INPUT.BG_TYPE)
    mapper_cls = GDRNRawTrainMapper if cfg.INPUT.DEVICE_PREPROCESS else GDRNTrainMapper
    mapper = mapper_cls(cfg, models, bg_replacer=bg, device=device)
    return meta, records, records2, models, mapper


def vis_panels(cfg, model: torch.nn.Module, batch: dict) -> dict:
    """TRAIN.VIS_IMG's tensorboard panels of the batch's first ROI, as the
    JAX trainer draws them (gdrnet_tpu/engine/trainer.py:412-427): tag ->
    (numpy image, dataformats). The maps come from the eval-mode forward
    (the next train step puts the model back in train mode)."""
    out = make_predict_step(model, with_maps=True)(batch)
    rh = cfg.MODEL.CDPN.ROT_HEAD
    xyz_pred = get_out_coor(out["coor_x"], out["coor_y"], out["coor_z"], rh.XYZ_BIN)[0]
    mask_pred = get_out_mask(out["mask"], rh.MASK_LOSS_TYPE)[0]
    img0 = batch["roi_img"][0].float().cpu().numpy()
    img0 = (img0 - img0.min()) / max(img0.max() - img0.min(), 1e-6)
    return {
        "vis/roi_img": (img0, "HWC"),
        "vis/xyz_pred": (np.clip(xyz_pred.cpu().numpy(), 0, 1), "HWC"),
        "vis/xyz_gt": (np.clip(batch["gt_xyz"][0].float().cpu().numpy(), 0, 1), "HWC"),
        "vis/mask_pred": (np.clip(mask_pred.cpu().numpy(), 0, 1)[None], "CHW"),
        "vis/mask_gt": (batch["gt_mask_visib"][0].float().cpu().numpy()[None], "CHW"),
    }


def build_input_pipeline(cfg, records, records2, mapper, seed: int, device="cuda",
                         logger=None, abort_check=None):
    """The training input path: (loader, to_device, refresher), as JAX's
    (gdrnet_tpu/engine/trainer.py:107-207). to_device(batch, it) puts the
    loader's item for iteration `it` on `device`:
    - the host loader (the default): the rank's rows of each global batch,
      mapped on the loader's threads, through pinned host memory and a copy
      that does not block the host;
    - TRAIN.DEVICE_RESIDENT_POOL: the loader yields the global batch's pool
      indices, to_device takes the rank's block and gathers and decodes it
      from the pool on the card; with TRAIN.POOL_REFRESH the refresher
      re-maps slots (drain it between steps, stop it at the end);
    - INPUT.DEVICE_PREPROCESS: the loader yields raw frames and to_device
      makes the batch on the card with device_train_batch (and the colour
      jitter with INPUT.DEVICE_COLOR_AUG), its draws from a generator
      seeded by (seed + 101, it, the data rank).
    The pool is built here, on `device`; a preemption during its fill
    (abort_check() true) raises InterruptedError."""
    check_supported(cfg)
    device = torch.device(device)
    models = mapper.models
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    refresher = None
    if cfg.TRAIN.get("DEVICE_RESIDENT_POOL"):
        pool_out = cfg.OUTPUT_DIR if cfg.OUTPUT_DIR != "auto" else osp.join(
            cfg.OUTPUT_ROOT, cfg.EXP_NAME or "gdrn")
        cache_dir = (osp.join(pool_out, "pool_cache") if cfg.TRAIN.get("POOL_CACHE", True)
                     else None)
        pool = DevicePool(cfg, records, mapper, models, device=device, seed=seed, logger=logger,
                          abort_check=abort_check, cache_dir=cache_dir, records2=records2,
                          num_workers=cfg.DATALOADER.NUM_WORKERS)
        loader = pool_index_sampler(
            pool, batch_size, seed, sampler_name=cfg.DATALOADER.SAMPLER_TRAIN,
            repeat_thresh=cfg.DATALOADER.REPEAT_THRESHOLD,
            ratio2=cfg.DATASETS.TRAIN2_RATIO if records2 else 0.0)
        if cfg.TRAIN.get("POOL_REFRESH", True):
            # each rank re-augments its own rows with a stream of its own
            refresher = PoolRefresher(
                pool, chunk=int(cfg.TRAIN.get("POOL_REFRESH_CHUNK", 64) or 64),
                seed=seed + 1 + 1009 * mh.data_rank(), logger=logger)
        b = batch_size // pool.n_shards
        lo = pool.shard * b

        def to_device(idx, it):  # noqa: ARG001 — the pool's rows hold their draws
            return pool.make_batch(idx[lo:lo + b])

        to_device.pool = pool
        return loader, to_device, refresher

    loader = TrainLoader(
        records, mapper, batch_size,
        sampler_name=cfg.DATALOADER.SAMPLER_TRAIN,
        repeat_thresh=cfg.DATALOADER.REPEAT_THRESHOLD,
        num_workers=cfg.DATALOADER.NUM_WORKERS, seed=seed,
        records2=records2, ratio2=cfg.DATASETS.TRAIN2_RATIO,
        rank=mh.data_rank(), world_size=mh.data_size())

    def put(batch: dict) -> dict:
        if device.type != "cuda":
            return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
        return {k: torch.from_numpy(np.asarray(v)).pin_memory().to(device, non_blocking=True)
                for k, v in batch.items()}

    if not cfg.INPUT.DEVICE_PREPROCESS:
        return loader, lambda batch, it: put(batch), None

    rh = cfg.MODEL.CDPN.ROT_HEAD
    stacks = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        models.points_stack, models.extents_stack, models.fps_stack, models.sym_rots_stack,
        models.sym_mask_stack)] + [
        torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=device),
        torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32, device=device)]
    prep_static = dict(
        input_res=cfg.MODEL.CDPN.BACKBONE.INPUT_RES, out_res=cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES,
        xyz_bin=rh.XYZ_BIN, with_bins="CE" in rh.XYZ_LOSS_TYPE, dzi_type=cfg.INPUT.DZI_TYPE,
        pad_scale=cfg.INPUT.DZI_PAD_SCALE, scale_ratio=cfg.INPUT.DZI_SCALE_RATIO,
        shift_ratio=cfg.INPUT.DZI_SHIFT_RATIO, xyz_mask_gt=rh.XYZ_LOSS_MASK_GT)
    if cfg.INPUT.get("DEVICE_COLOR_AUG") and cfg.INPUT.COLOR_AUG_PROB > 0:
        order = "rgb" if cfg.INPUT.get("FORMAT", "BGR").upper() == "RGB" else "bgr"
        prep_static.update(
            color_aug_type=cfg.INPUT.COLOR_AUG_TYPE, color_aug_prob=cfg.INPUT.COLOR_AUG_PROB,
            color_op=color_aug_op(cfg.INPUT.COLOR_AUG_TYPE,
                                  cfg.INPUT.get("COLOR_AUG_CODE") or None, order))
    generator = torch.Generator(device=device)
    rank = mh.data_rank()

    def to_device(batch, it):
        generator.manual_seed(prep_seed(seed, it, rank))
        return device_train_batch(TorchKey(generator), put(batch), *stacks, **prep_static)

    return loader, to_device, None


def prep_seed(seed: int, it: int, rank: int = 0) -> int:
    """The device preprocessing's generator seed at iteration `it` on data
    rank `rank`."""
    return ((seed + 101) * 1_000_003 + it * 65_537 + rank) % (2 ** 63)


def precise_bn(cfg, model, loader_iter, to_device, seed: int, logger) -> int:
    """TEST.PRECISE_BN: the BN statistics averaged over NUM_ITER batches of
    the train input (DropBlock draws from a generator of its own; the
    batches are iterations 2^30 + k of to_device, apart from the train
    loop's, as JAX's)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(dropblock_seed(seed, 2 ** 30))

    def forward(model, batch):
        with _autocast(model, device):
            model(batch["roi_img"], **_model_kwargs(batch), generator=generator)

    batches = (to_device(next(loader_iter), 2 ** 30 + k) for k in itertools.count(1))
    n = update_bn_stats(model, batches, num_iters=cfg.TEST.PRECISE_BN.NUM_ITER, forward=forward)
    logger.info(f"precise BN: statistics averaged over {n} batches")
    return n


def dropblock_seed(seed: int, it: int) -> int:
    """The DropBlock generator's seed at iteration `it`: a function of the run
    seed and the iteration, so a resumed run draws as an uninterrupted one."""
    return (seed * 1_000_003 + it) % (2 ** 63)


class _Preemption:
    """While active, SIGTERM / SIGINT set `flag` instead of ending the
    process, so the loop can checkpoint at the next iteration boundary and
    return; the previous handlers come back on exit. In a thread other
    than the main one, signals cannot be caught and nothing is installed."""

    def __init__(self, logger):
        self.flag = False
        self._logger = logger
        self._prev = {}

    def _on_signal(self, signum, frame):  # noqa: ARG002
        self.flag = True
        self._logger.warning(f"signal {signum}: checkpointing at next boundary")

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread
                break
        return self

    def __exit__(self, *exc):
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)


def do_train(cfg, resume: bool = False, data_root: str = "datasets/BOP_DATASETS",
             max_iters_override: int | None = None, eval_fn=None, device="cuda"):
    """Returns (state, models, preempted). eval_fn(cfg, state, models) is
    called every TEST.EVAL_PERIOD epochs if provided (engine.py:285-292),
    on every rank. preempted=True means a SIGTERM/SIGINT ended the run at an
    iteration boundary (state checkpointed; resume with resume=True). Under a
    launcher it joins the process group first (NCCL for a CUDA `device`,
    gloo for the CPU; a group the caller made is kept); `device` "cuda" is
    then the rank's card. state.model is the unwrapped model."""
    device = torch.device(device)
    mh.maybe_init_distributed(backend="nccl" if device.type == "cuda" else "gloo")
    out_dir = cfg.OUTPUT_DIR if cfg.OUTPUT_DIR != "auto" else osp.join(
        cfg.OUTPUT_ROOT, cfg.EXP_NAME or "gdrn")
    logger = setup_logger(out_dir, rank=mh.get_rank())
    check_supported(cfg)

    # preemption-safe exit: on SIGTERM/SIGINT finish the current iteration,
    # checkpoint, and return, so resume=True restores the exact step.
    # Installed at entry so that signals during the data warm-up count too.
    with _Preemption(logger) as preempted:
        return _train(cfg, resume, data_root, max_iters_override, eval_fn, device, out_dir,
                      logger, preempted)


def _train(cfg, resume, data_root, max_iters_override, eval_fn, device, out_dir, logger,
           preempted: _Preemption):
    ims_per_batch = cfg.SOLVER.IMS_PER_BATCH
    d, m = resolve_world(cfg, ims_per_batch, mh.get_world_size(), logger)
    mh.set_model_parallel(m)
    meta, records, records2, models, mapper = build_train_objects(cfg, data_root, device)
    iters_per_epoch = max(len(records) // ims_per_batch, 1)
    total_iters = max_iters_override or iters_per_epoch * cfg.SOLVER.TOTAL_EPOCHS
    logger.info(f"{len(records)} records, {iters_per_epoch} iters/epoch, "
                f"{total_iters} total iters, on {device}, rank {mh.get_rank()} of {d * m} "
                f"(data {mh.data_rank()} of {d}, model {mh.model_rank()} of {m})")

    # SEED < 0 means fully randomize (reference common_base.py SEED=-1),
    # masked to 31 bits; every rank takes rank 0's (the same loader stream
    # and init, as gdrnet_tpu/engine/trainer.py:256-263)
    seed = cfg.SEED if cfg.SEED >= 0 else int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF
    seed = mh.broadcast_int(seed)
    try:
        loader, to_device, refresher = build_input_pipeline(
            cfg, records, records2, mapper, seed, device, logger=logger,
            abort_check=lambda: preempted.flag)
    except InterruptedError:
        logger.warning("preempted during pool build; nothing saved")
        return None, models, True
    try:
        return _loop(cfg, resume, eval_fn, device, out_dir, logger, preempted, models, seed, m,
                     iters_per_epoch, total_iters, loader, to_device, refresher)
    finally:  # at the end, on SIGTERM and on an error alike
        if refresher is not None:
            refresher.stop()
            logger.info(f"pool refresh: {refresher.refreshed} samples re-augmented during "
                        f"training ({refresher.torn_healed} torn and written again, "
                        f"{refresher.torn_dropped} chunks dropped)")


def _loop(cfg, resume, eval_fn, device, out_dir, logger, preempted, models, seed, m,
          iters_per_epoch, total_iters, loader, to_device, refresher):
    model = init_weights(build_model(cfg, device=device), torch.Generator().manual_seed(seed))
    shard_model(model)  # before the optimizer: its state is then the rank's slice
    base_lr = dict(cfg.SOLVER.OPTIMIZER_CFG).get("lr", 1e-4)
    # with gradient accumulation the schedule advances once per k train
    # iterations — built over optimizer UPDATES so warmup/anneal land where
    # configured
    accum = int(cfg.SOLVER.get("GRAD_ACCUM_STEPS", 1) or 1)
    schedule = build_lr_schedule(cfg, base_lr, total_iters, steps_per_update=accum)
    optimizer = build_optimizer(cfg, model, schedule)
    state = create_train_state(model, optimizer)

    ckpt = CheckpointManager(osp.join(out_dir, "ckpt"), max_to_keep=cfg.SOLVER.MAX_TO_KEEP)
    state, start_iter = ckpt.resume_or_load(state, resume=resume)
    if start_iter == 0:
        # fresh run: MODEL.WEIGHTS, else BACKBONE.PRETRAINED, else the
        # random-init warning (reference engine.py:198-204 + GDRN.py:713-721)
        init_model_weights(cfg, state, logger=logger)
    train_step = make_train_step(cfg, ddp_model(model), optimizer)

    loader_iter = iter(loader)
    t0 = time.perf_counter()
    batch = to_device(next(loader_iter), start_iter)
    data_time = time.perf_counter() - t0

    ev = EventLog()
    # console / metrics.json / tensorboard on the main process only (reference
    # setup_for_distributed, my_setup.py:6-20): the metrics are global
    main = mh.is_main_process()
    writers = ([ConsoleWriter(total_iters, device),
                JsonWriter(osp.join(out_dir, "metrics.json"))] if main else [])
    tb = None  # tensorboard's writer, where tensorboard is installed
    if (cfg.TRAIN.VIS_IMG or cfg.VIS_PERIOD) and main:
        tb = TensorboardWriter(osp.join(out_dir, "tb"))
        if tb.tb is None:
            tb = None
        else:
            writers.append(tb)
    ckpt_every = (cfg.SOLVER.CHECKPOINT_PERIOD * iters_per_epoch
                  if cfg.SOLVER.CHECKPOINT_BY_EPOCH else cfg.SOLVER.CHECKPOINT_PERIOD)
    eval_every = cfg.TEST.EVAL_PERIOD * iters_per_epoch if cfg.TEST.EVAL_PERIOD else 0
    print_every = cfg.TRAIN.PRINT_FREQ
    generator = torch.Generator(device=device)

    prof_dir, prof = cfg.TRAIN.PROFILE_DIR, None
    skip_guard = bool(cfg.SOLVER.get("SKIP_NONFINITE", True))
    skip_patience = int(cfg.SOLVER.get("SKIP_NONFINITE_PATIENCE", 5))
    skipped_boundaries = 0  # consecutive print boundaries with a skip

    def stop_profiler():
        prof.close()  # engine/profiling.trace writes the trace as it exits
        logger.info(f"profiler trace written to {osp.join(prof_dir, trace_name)}")

    try:
        for it in range(start_iter, total_iters):
            # profiler window: trace a few steady-state iters (TRAIN.PROFILE_*)
            if prof_dir and it == cfg.TRAIN.PROFILE_START and prof is None:
                rank = mh.get_rank()
                trace_name = f"trace.rank{rank}.json" if rank else "trace.json"
                prof = contextlib.ExitStack()
                prof.enter_context(profiling.trace(prof_dir, device, trace_name))
            if prof is not None and it == cfg.TRAIN.PROFILE_STOP:
                stop_profiler()
                prof, prof_dir = None, ""
            if mh.any_rank(preempted.flag):  # every rank stops at the same iteration
                if prof is not None:
                    stop_profiler()
                ckpt.save(state, it)
                logger.warning(f"preempted: saved step {it}; resume with resume=True")
                return state, models, True
            generator.manual_seed(dropblock_seed(seed, it))
            t_step = time.perf_counter()
            state, metrics = train_step(state, batch, generator)
            # overlap: fetch the next batch while the device runs the step
            if it + 1 < total_iters:
                t0 = time.perf_counter()
                batch = to_device(next(loader_iter), it + 1)
                data_time = time.perf_counter() - t0
            if refresher is not None:  # one refresh chunk while the card runs the step
                refresher.drain(max_chunks=1)
            # sync with the device only at print boundaries (the NaN
            # tripwire fires at PRINT_FREQ granularity; steps pipeline between)
            ev.iter = it
            if it % print_every == 0 or it == total_iters - 1:
                total = float(metrics["total_loss"])  # waits for the step
                step_time = time.perf_counter() - t_step
                if not np.isfinite(total):  # NaN tripwire (engine.py:271)
                    if not skip_guard:
                        raise FloatingPointError(f"non-finite loss at iter {it}: {total}")
                    # SKIP_NONFINITE reverted this step's update (steps.py); a
                    # lone poisoned batch costs one step — only a persistent
                    # streak (model or data wedged) should kill the run
                    skipped_boundaries += 1
                    logger.warning(f"non-finite loss at iter {it} — update skipped "
                                   f"({skipped_boundaries}/{skip_patience} boundaries)")
                    if skipped_boundaries >= skip_patience:
                        raise FloatingPointError(
                            f"non-finite loss at {skip_patience} consecutive print "
                            f"boundaries (iter {it}) — wedged, aborting")
                else:
                    skipped_boundaries = 0
                ev.put(total_loss=total, lr=float(schedule(it // accum)),
                       **{k: float(v) for k, v in metrics.items() if k != "total_loss"})
                ev.put(**{"time/step": step_time, "time/data": data_time})
                for w in writers:
                    w.write(ev)
                # on a model axis every rank runs the forward: its layers gather
                if cfg.TRAIN.VIS_IMG and (tb is not None or m > 1):
                    for tag, (img, fmt) in vis_panels(cfg, model, batch).items():
                        if tb is not None:
                            tb.tb.add_image(tag, img, it, dataformats=fmt)
            if ckpt_every and (it + 1) % ckpt_every == 0:
                ckpt.save(state, it + 1)
            if eval_every and (it + 1) % eval_every == 0 and eval_fn is not None:
                if cfg.TEST.PRECISE_BN.ENABLED:
                    precise_bn(cfg, model, loader_iter, to_device, seed, logger)
                eval_fn(cfg, state, models)
        if prof is not None:  # the window ran past the end of training
            stop_profiler()
        if cfg.TEST.PRECISE_BN.ENABLED:
            precise_bn(cfg, model, loader_iter, to_device, seed, logger)
        ckpt.save(state, total_iters)
        return state, models, False
    finally:
        loader_iter.close()
        if tb is not None:
            tb.close()
