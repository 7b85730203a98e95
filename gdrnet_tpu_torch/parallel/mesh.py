"""The training layout: the world and its (data, model) grid from the config,
the model axis's partition rule, the per-rank batch, and local data
parallelism for testing and serving (counterpart of
gdrnet_tpu/parallel/mesh.py and of gdrnet_tpu/engine/trainer.py:72-104's
resolve_mesh_spec).

The JAX package lays a `data` mesh over every chip, or with
PARALLEL.MODEL_PARALLEL = m a 2-D (data, model) mesh, and lets GSPMD split
the batch and the large kernels. Here training runs one process a GPU
(torch.distributed): resolve_world checks the launcher's world against
PARALLEL.MESH_SHAPE, the model axis and the batch; parallel/multihost.py
lays the grid; param_partition picks the weights the model axis shards
(parallel/tensor_parallel.py shards them); ddp_model wraps the model in DDP
over the data group. Testing and serving in one process over several local
cards (TEST.LOCAL_DEVICES) put one replica of the model on each card and
split every bucket between them, the counterpart of shard_batch plus GSPMD.
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
from gdrnet_tpu_torch.parallel.tensor_parallel import SHARDED


def resolve_world(cfg, ims_per_batch: int, world_size: int,
                  logger: logging.Logger | None = None) -> tuple[int, int]:
    """The training grid (data ranks d, model ranks m) for the launcher's
    world, as JAX's resolve_mesh_spec picks its mesh. PARALLEL.MESH_SHAPE
    (-1,) takes every rank; (n,) asks for n, clamped with a warning to the
    ranks there are. m is PARALLEL.MODEL_PARALLEL; d is the largest divisor
    of the batch no greater than the budget over m (the reference asserts
    divisibility, dataset_utils.py:196-198), and a budget below m raises
    JAX's ValueError. Where JAX would then use fewer devices than it has,
    the port raises and names the count to start: a launcher's rank cannot
    sit out."""
    mesh_shape = tuple(cfg.PARALLEL.get("MESH_SHAPE", (-1,)))
    if len(mesh_shape) != 1:
        raise ValueError(f"only 1-D data meshes are supported (DP, like the reference; "
                         f"PARALLEL.MODEL_PARALLEL names a model axis): "
                         f"PARALLEL.MESH_SHAPE={mesh_shape}")
    if mesh_shape[0] != -1 and mesh_shape[0] < 1:
        raise ValueError(f"PARALLEL.MESH_SHAPE={mesh_shape} must be (-1,) or a positive "
                         "device count")
    mp = int(cfg.PARALLEL.get("MODEL_PARALLEL", 1) or 1)
    budget = world_size
    if mesh_shape[0] != -1:
        if mesh_shape[0] > world_size and logger is not None:
            logger.warning(f"PARALLEL.MESH_SHAPE={mesh_shape} asks for more devices than the "
                           f"{world_size} rank(s) there are; training on {world_size}")
        budget = min(world_size, mesh_shape[0])
    if budget // mp < 1:
        raise ValueError(f"MODEL_PARALLEL={mp} exceeds {budget} devices")
    d = max(n for n in range(1, budget // mp + 1) if ims_per_batch % n == 0)
    if d * mp != world_size:
        raise ValueError(
            f"{world_size} ranks were started, but PARALLEL.MESH_SHAPE={mesh_shape}, "
            f"PARALLEL.MODEL_PARALLEL={mp} and SOLVER.IMS_PER_BATCH={ims_per_batch} allow "
            f"{d * mp}: start {d * mp} processes")
    return d, mp


def param_partition(model: torch.nn.Module, m: int, min_size: int = 1 << 16) -> dict:
    """The weights a model axis of m ranks shards, JAX's param_partition_spec
    (gdrnet_tpu/parallel/mesh.py:45-57) read in torch's layout: name -> the
    dim it is split on, for each Conv2d, ConvTranspose2d and Linear weight of
    at least 2 dims and `min_size` values whose output dim (0; 1 for a
    ConvTranspose2d's [in, out, kh, kw], where flax puts it last in all
    three) m divides. Every other parameter (biases, norms, the MTL
    log-variances) stays whole; {} for m = 1."""
    if m <= 1:
        return {}
    out = {}
    for name, layer in model.named_modules():
        if type(layer) not in SHARDED:
            continue
        w, dim = layer.weight, SHARDED[type(layer)][1]
        if w.dim() >= 2 and w.numel() >= min_size and w.shape[dim] % m == 0:
            out[f"{name}.weight"] = dim
    return out


def ddp_model(model: torch.nn.Module) -> torch.nn.Module:
    """The model as the train step takes it: the model itself where the data
    axis has one rank; else its BatchNorm2d layers swapped for
    SyncBatchNorm2d (statistics over the data group) and each DropBlock2D
    given the rank's share of the batch, in place, and the model wrapped in
    DistributedDataParallel over the data group, so that a sharded weight's
    gradient is averaged with its data peers' slices only, never across the
    model axis. Without the per-step buffer broadcast (the synced buffers are
    equal on every rank) and with static_graph: some configurations leave
    parameters out of the loss (R_ONLY's translation head, USE_MTL's unused
    log-variances, BACKBONE.FREEZE's backbone), the same ones at every step,
    which DDP then finds once, at the first step, rather than by a walk of
    the graph at every step."""
    if mh.data_size() == 1:
        return model
    for m in model.modules():
        if isinstance(m, DropBlock2D):
            m.shard = (mh.data_rank(), mh.data_size())
    return DistributedDataParallel(convert_sync_bn(model), broadcast_buffers=False,
                                   static_graph=True, process_group=mh.data_group())


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
