"""Data-parallel layout: the training world from the config, the per-rank
batch, and local data parallelism for testing and serving (counterpart of
the data-parallel part of gdrnet_tpu/parallel/mesh.py and of
gdrnet_tpu/engine/trainer.py:72-104's resolve_mesh_spec).

The JAX package lays a 1-D `data` mesh over every chip and lets GSPMD split
the batch. Here training runs one process a GPU (torch.distributed, DDP),
so the world size is the launcher's; resolve_world checks it against
PARALLEL.MESH_SHAPE and the batch. Testing and serving in one process over
several local cards (TEST.LOCAL_DEVICES) put one replica of the model on
each card and split every bucket between them, the counterpart of
shard_batch plus GSPMD.

Not here: the model axis (PARALLEL.MODEL_PARALLEL > 1, JAX's 2-D mesh with
tensor-sharded kernels, gdrnet_tpu/parallel/mesh.py:28-69), ROADMAP.md
queue A item 10 (A10's model axis).
"""

from __future__ import annotations

import copy
import logging
from typing import Callable

import torch
from torch.nn.parallel import DistributedDataParallel

from gdrnet_tpu_torch.models.layers import DropBlock2D
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.parallel.sync_bn import convert_sync_bn


def resolve_world(cfg, ims_per_batch: int, world_size: int,
                  logger: logging.Logger | None = None) -> int:
    """The number of data-parallel ranks for training: the launcher's world
    size, checked as JAX's resolve_mesh_spec checks its mesh. PARALLEL.
    MESH_SHAPE (-1,) takes every rank; (n,) asks for n, clamped with a
    warning to the ranks there are; the count then shrinks to the largest
    divisor of the batch (the reference asserts divisibility,
    dataset_utils.py:196-198). Where JAX would then use fewer devices than it
    has, the port raises: a launcher's rank cannot sit out."""
    mesh_shape = tuple(cfg.PARALLEL.get("MESH_SHAPE", (-1,)))
    if len(mesh_shape) != 1:
        raise ValueError(f"only 1-D data meshes are supported (DP, like the reference; "
                         f"PARALLEL.MODEL_PARALLEL names a model axis): "
                         f"PARALLEL.MESH_SHAPE={mesh_shape}")
    if mesh_shape[0] != -1 and mesh_shape[0] < 1:
        raise ValueError(f"PARALLEL.MESH_SHAPE={mesh_shape} must be (-1,) or a positive "
                         "device count")
    mp = int(cfg.PARALLEL.get("MODEL_PARALLEL", 1) or 1)
    if mp > 1:
        raise NotImplementedError(
            f"PARALLEL.MODEL_PARALLEL={mp}: the model axis (tensor-sharded kernels) is not "
            "ported yet (ROADMAP.md queue A item 10, A10's model axis)")
    budget = world_size
    if mesh_shape[0] != -1:
        if mesh_shape[0] > world_size and logger is not None:
            logger.warning(f"PARALLEL.MESH_SHAPE={mesh_shape} asks for more devices than the "
                           f"{world_size} rank(s) there are; training on {world_size}")
        budget = min(world_size, mesh_shape[0])
    n = max(d for d in range(1, budget + 1) if ims_per_batch % d == 0)
    if n != world_size:
        raise ValueError(
            f"{world_size} ranks were started, but PARALLEL.MESH_SHAPE={mesh_shape} and "
            f"SOLVER.IMS_PER_BATCH={ims_per_batch} allow {n}: start {n} processes")
    return n


def ddp_model(model: torch.nn.Module) -> torch.nn.Module:
    """The model as the train step takes it: the model itself in one process;
    under a process group of more than one rank, its BatchNorm2d layers
    swapped for SyncBatchNorm2d and each DropBlock2D given the rank's share
    of the batch (in place), and the model wrapped in
    DistributedDataParallel, without the per-step buffer broadcast (the
    synced buffers are equal on every rank) and with static_graph: some
    configurations leave parameters out of the loss (R_ONLY's translation
    head, USE_MTL's unused log-variances, BACKBONE.FREEZE's backbone), the
    same ones at every step, which DDP then finds once, at the first step,
    rather than by a walk of the graph at every step."""
    world = mh.get_world_size()
    if world == 1:
        return model
    for m in model.modules():
        if isinstance(m, DropBlock2D):
            m.shard = (mh.get_rank(), world)
    return DistributedDataParallel(convert_sync_bn(model), broadcast_buffers=False,
                                   static_graph=True)


def local_batch_size(global_batch: int, world_size: int) -> int:
    """Rows of the global batch a rank takes."""
    if global_batch % world_size != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {world_size} ranks "
            f"(reference asserts the same, core/utils/dataset_utils.py:196-198)")
    return global_batch // world_size


def local_devices(device: torch.device) -> list[torch.device]:
    """The devices this process may drive, `device` first: every visible
    CUDA card in one process; under a process group only the rank's own
    (each rank drives its card, as JAX's local devices are a process's own);
    the CPU is one device."""
    device = torch.device(device)
    if device.type != "cuda" or mh.get_world_size() > 1:
        return [device]
    first = device.index if device.index is not None else torch.cuda.current_device()
    n = torch.cuda.device_count()
    return [torch.device("cuda", (first + i) % n) for i in range(n)]


def local_dp_setup(model: torch.nn.Module, bucket: int, n_want: int = -1,
                   devices: list | None = None) -> tuple[list | None, list]:
    """Local data-parallel testing and serving (TEST.LOCAL_DEVICES, -1 for
    all), as gdrnet_tpu/parallel/mesh.py:87-108 picks it: the largest divisor
    of `bucket` no greater than the devices asked for (and there), and one
    replica of `model` on each. `devices` defaults to local_devices of the
    model's device. Returns (devices, replicas), `model` the first replica;
    devices is None when one device is used (callers then run unsplit)."""
    n_want = int(n_want if n_want is not None else -1) or -1
    avail = list(devices) if devices is not None else local_devices(
        next(model.parameters()).device)
    n = len(avail) if n_want < 0 else max(1, min(n_want, len(avail)))
    n_loc = max(d for d in range(1, n + 1) if bucket % d == 0)
    if n_loc <= 1:
        return None, [model]
    replicas = [model] + [copy.deepcopy(model).to(d) for d in avail[1:n_loc]]
    return [torch.device(d) for d in avail[:n_loc]], replicas


def split_predict(predicts: list[Callable[[dict], dict]], devices: list) -> Callable:
    """predict(batch) over the replicas: every tensor of `batch` split into
    len(devices) equal row blocks, block i run by predicts[i] on devices[i]
    (the launches queue on each card without waiting for the others), and
    the outputs concatenated on devices[0]."""
    n = len(predicts)

    def predict(batch: dict) -> dict:
        blocks = [{} for _ in range(n)]
        for k, v in batch.items():
            for i, part in enumerate(v.tensor_split(n)):
                blocks[i][k] = part.to(devices[i], non_blocking=True)
        outs = [fn(b) for fn, b in zip(predicts, blocks)]
        return {k: torch.cat([o[k].to(devices[0]) for o in outs]) for k in outs[0]}

    return predict
