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

The JAX package's device-resident pool and device preprocessing
(TRAIN.DEVICE_RESIDENT_POOL, POOL_REFRESH, INPUT.DEVICE_PREPROCESS) are TPU
placement choices the port does not need (ROADMAP.md "Do not port"): with
them set it trains from the host loader, the reference's sampling, and
warns once.
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import time

import numpy as np
import torch

from gdrnet_tpu_torch.data.augment import BackgroundReplacer
from gdrnet_tpu_torch.data.dataset_factory import resolve
from gdrnet_tpu_torch.data.loader import TrainLoader
from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager, init_model_weights
from gdrnet_tpu_torch.engine.steps import make_train_step
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.engine.writers import ConsoleWriter, EventLog, JsonWriter, setup_logger
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule

# TPU placement settings of the JAX package: the port trains from the host loader
_TPU_PLACEMENT = (("TRAIN", "DEVICE_RESIDENT_POOL"), ("TRAIN", "POOL_REFRESH"),
                  ("INPUT", "DEVICE_PREPROCESS"))


def check_supported(cfg, logger=None) -> None:
    """Raise for what the port's trainer does not do yet; warn once for the
    TPU placement settings, which it does not need."""
    if cfg.TEST.PRECISE_BN.ENABLED:
        raise NotImplementedError("TEST.PRECISE_BN is not ported yet (ROADMAP.md A12)")
    if cfg.TRAIN.VIS_IMG:
        raise NotImplementedError("TRAIN.VIS_IMG is not ported yet (ROADMAP.md A7)")
    mesh = tuple(cfg.PARALLEL.get("MESH_SHAPE", (-1,)))
    if mesh not in ((-1,), (1,)) or int(cfg.PARALLEL.get("MODEL_PARALLEL", 1) or 1) > 1:
        raise NotImplementedError(
            f"PARALLEL.MESH_SHAPE={mesh}: the port trains on one device; more than one is "
            "not ported yet (ROADMAP.md A10)")
    on = [f"{a}.{b}" for a, b in _TPU_PLACEMENT if getattr(cfg, a).get(b)]
    if not cfg.TRAIN.get("DEVICE_RESIDENT_POOL"):  # the refresh is part of the pool
        on = [name for name in on if name != "TRAIN.POOL_REFRESH"]
    if on and logger is not None:
        logger.warning(f"{', '.join(on)}: TPU placement settings of the JAX package; the "
                       "port trains from the host TrainLoader (ROADMAP.md \"Do not port\")")


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
    mapper = GDRNTrainMapper(cfg, models, bg_replacer=bg, device=device)
    return meta, records, records2, models, mapper


def build_input_pipeline(cfg, records, records2, mapper, seed: int, device="cuda"):
    """The training input path: (loader, to_device). The loader yields host
    batches; to_device(batch) moves one to `device`, through pinned host
    memory and a copy that does not block the host on a CUDA device."""
    loader = TrainLoader(
        records, mapper, cfg.SOLVER.IMS_PER_BATCH,
        sampler_name=cfg.DATALOADER.SAMPLER_TRAIN,
        repeat_thresh=cfg.DATALOADER.REPEAT_THRESHOLD,
        num_workers=cfg.DATALOADER.NUM_WORKERS, seed=seed,
        records2=records2, ratio2=cfg.DATASETS.TRAIN2_RATIO)
    device = torch.device(device)

    def to_device(batch: dict) -> dict:
        if device.type != "cuda":
            return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                for k, v in batch.items()}

    return loader, to_device


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
    called every TEST.EVAL_PERIOD epochs if provided (engine.py:285-292).
    preempted=True means a SIGTERM/SIGINT ended the run at an iteration
    boundary (state checkpointed; resume with resume=True)."""
    device = torch.device(device)
    out_dir = cfg.OUTPUT_DIR if cfg.OUTPUT_DIR != "auto" else osp.join(
        cfg.OUTPUT_ROOT, cfg.EXP_NAME or "gdrn")
    logger = setup_logger(out_dir)
    check_supported(cfg, logger)

    # preemption-safe exit: on SIGTERM/SIGINT finish the current iteration,
    # checkpoint, and return, so resume=True restores the exact step.
    # Installed at entry so that signals during the data warm-up count too.
    with _Preemption(logger) as preempted:
        return _train(cfg, resume, data_root, max_iters_override, eval_fn, device, out_dir,
                      logger, preempted)


def _train(cfg, resume, data_root, max_iters_override, eval_fn, device, out_dir, logger,
           preempted: _Preemption):
    meta, records, records2, models, mapper = build_train_objects(cfg, data_root, device)
    ims_per_batch = cfg.SOLVER.IMS_PER_BATCH
    iters_per_epoch = max(len(records) // ims_per_batch, 1)
    total_iters = max_iters_override or iters_per_epoch * cfg.SOLVER.TOTAL_EPOCHS
    logger.info(f"{len(records)} records, {iters_per_epoch} iters/epoch, "
                f"{total_iters} total iters, on {device}")

    # SEED < 0 means fully randomize (reference common_base.py SEED=-1),
    # masked to 31 bits
    seed = cfg.SEED if cfg.SEED >= 0 else int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF
    loader, to_device = build_input_pipeline(cfg, records, records2, mapper, seed, device)
    model = init_weights(build_model(cfg, device=device), torch.Generator().manual_seed(seed))
    base_lr = dict(cfg.SOLVER.OPTIMIZER_CFG).get("lr", 1e-4)
    # with gradient accumulation the schedule advances once per k train
    # iterations — built over optimizer UPDATES so warmup/anneal land where
    # configured
    accum = int(cfg.SOLVER.get("GRAD_ACCUM_STEPS", 1) or 1)
    schedule = build_lr_schedule(cfg, base_lr, total_iters, steps_per_update=accum)
    optimizer = build_optimizer(cfg, model, schedule)
    state = create_train_state(model, optimizer)
    train_step = make_train_step(cfg, model, optimizer)

    ckpt = CheckpointManager(osp.join(out_dir, "ckpt"), max_to_keep=cfg.SOLVER.MAX_TO_KEEP)
    state, start_iter = ckpt.resume_or_load(state, resume=resume)
    if start_iter == 0:
        # fresh run: MODEL.WEIGHTS, else BACKBONE.PRETRAINED, else the
        # random-init warning (reference engine.py:198-204 + GDRN.py:713-721)
        init_model_weights(cfg, state, logger=logger)

    loader_iter = iter(loader)
    t0 = time.perf_counter()
    batch = to_device(next(loader_iter))
    data_time = time.perf_counter() - t0

    ev = EventLog()
    writers = [ConsoleWriter(total_iters, device), JsonWriter(osp.join(out_dir, "metrics.json"))]
    if cfg.VIS_PERIOD:
        from gdrnet_tpu_torch.engine.writers import TensorboardWriter

        tb = TensorboardWriter(osp.join(out_dir, "tb"))
        if tb.tb is not None:
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
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(prof_dir, exist_ok=True)
        path = osp.join(prof_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")

    try:
        for it in range(start_iter, total_iters):
            # profiler window: trace a few steady-state iters (TRAIN.PROFILE_*)
            if prof_dir and it == cfg.TRAIN.PROFILE_START and prof is None:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if prof is not None and it == cfg.TRAIN.PROFILE_STOP:
                stop_profiler()
                prof, prof_dir = None, ""
            if preempted.flag:
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
                batch = to_device(next(loader_iter))
                data_time = time.perf_counter() - t0
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
            if ckpt_every and (it + 1) % ckpt_every == 0:
                ckpt.save(state, it + 1)
            if eval_every and (it + 1) % eval_every == 0 and eval_fn is not None:
                eval_fn(cfg, state, models)
        if prof is not None:  # the window ran past the end of training
            stop_profiler()
        ckpt.save(state, total_iters)
        return state, models, False
    finally:
        loader_iter.close()
