"""Multi-process helpers over torch.distributed: initialisation, rank queries,
barriers, object gathers and reductions (counterpart of
gdrnet_tpu/parallel/multihost.py; the reference's comm layer,
core/utils/my_comm.py:8-49 over NCCL).

A launcher (`torchrun`, `python -m torch.distributed.run`) starts one process
a GPU and sets WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
maybe_init_distributed joins them into the default process group. Without a
process group every function here is the identity, so the same engine code
runs on one card and on several (gdrnet_tpu/parallel/multihost.py:1-6).

Device tensors (gradients, BN statistics, loss normalisers, logged metrics)
go over the default group: NCCL on CUDA unless the caller names another
backend. Host values (pickled objects, barriers, the SIGTERM flag, host
scalars) go over `host_group()`, a gloo group of the same ranks: gloo carries
CPU tensors, NCCL does not. Nothing here picks a backend on its own beyond
maybe_init_distributed's default.

PARALLEL.MODEL_PARALLEL = m lays the ranks out as the JAX package's 2-D
(data, model) mesh (gdrnet_tpu/parallel/mesh.py:28-43), the model axis
fastest: rank r sits at data index r // m and model index r % m.
set_model_parallel makes the two kinds of group once a process group: the
data group of r holds the ranks with its model index (they split the batch;
DDP, the BatchNorm statistics and the loss normalisers reduce over it), the
model group the m ranks [i m, (i + 1) m) of its data index (they hold the
slices of the sharded weights, parallel/tensor_parallel.py, and see the
same rows). Without it the data group is the whole world and the model
group one rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_HOST_GROUP: list = [None, None]  # (the default group, its gloo twin for host values)
# the (data, model) grid of set_model_parallel: the default group it was laid
# over, the model axis's size, this rank's data group and model group
_GRID: dict = {"world": None, "m": 1, "data": None, "model": None}


def maybe_init_distributed(backend: str | None = None, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None) -> bool:
    """Join the default process group when a launcher started this process
    (WORLD_SIZE and RANK in the environment) or when `init_method` is given
    (with world_size and rank: the counterpart of JAX_COORDINATOR_ADDRESS,
    gdrnet_tpu/parallel/multihost.py:22-27). The backend defaults to NCCL
    where CUDA is available and gloo elsewhere; with CUDA, LOCAL_RANK's card
    becomes the current device first. Returns whether a process group is up
    (an existing one is kept)."""
    if dist.is_initialized():
        return True
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if init_method is None and not launched:
        return False
    if torch.cuda.is_available() and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method,
                      world_size=int(world_size if world_size is not None
                                     else os.environ["WORLD_SIZE"]),
                      rank=int(rank if rank is not None else os.environ["RANK"]))
    dist.init_process_group(backend=backend, **kwargs)
    return True


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _active() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _active() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def set_model_parallel(m: int) -> None:
    """Lay the world out as a (world / m, m) grid (module docstring): every
    data group and every model group made with dist.new_group, in the same
    order on every rank, once for this default group and m. m = 1 (or no
    process group) is the plain data world."""
    m = int(m or 1)
    if m == 1 or not _active():
        if m > 1:
            raise ValueError(f"a model axis of {m} needs a process group of {m} or more ranks")
        _GRID.update(world=None, m=1, data=None, model=None)
        return
    world, rank = get_world_size(), get_rank()
    if world % m:
        raise ValueError(f"{world} ranks do not divide into a model axis of {m}")
    if _grid() is not None and _GRID["m"] == m:
        return
    data = model = None
    for j in range(m):
        group = dist.new_group(list(range(j, world, m)))
        data = group if rank % m == j else data
    for i in range(world // m):
        group = dist.new_group(list(range(i * m, (i + 1) * m)))
        model = group if rank // m == i else model
    _GRID.update(world=dist.group.WORLD, m=m, data=data, model=model)


def _grid() -> dict | None:
    """The grid laid over the current default group, if any."""
    return _GRID if _active() and _GRID["world"] is dist.group.WORLD else None


def model_size() -> int:
    """Ranks on the model axis (1 without one)."""
    grid = _grid()
    return grid["m"] if grid else 1


def model_rank() -> int:
    return get_rank() % model_size()


def data_size() -> int:
    """Ranks on the data axis: the ranks that split each global batch."""
    return get_world_size() // model_size()


def data_rank() -> int:
    return get_rank() // model_size()


def data_group():
    """The process group of the rank's data axis (None, the default group,
    without a model axis)."""
    grid = _grid()
    return grid["data"] if grid else None


def model_group():
    """The process group of the rank's model peers (None without a model
    axis)."""
    grid = _grid()
    return grid["model"] if grid else None


def host_group():
    """The gloo group over every rank that carries host values: the default
    group itself when that is gloo, else one made at the first call for
    this default group (every rank reaches that call at the same point, as
    for any collective; a process group made again after
    destroy_process_group gets a twin of its own)."""
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _HOST_GROUP[0] is not world:
        _HOST_GROUP[:] = [world, dist.new_group(backend="gloo")]
    return _HOST_GROUP[1]


def synchronize() -> None:
    """Barrier over every rank (reference comm.synchronize, engine.py:292)."""
    if get_world_size() > 1:
        dist.barrier(group=host_group())


def all_gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order (reference comm.all_gather,
    used for the evaluator's predictions, gdrn_evaluator.py:439-444)."""
    if get_world_size() == 1:
        return [obj]
    out: list = [None] * get_world_size()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def reduce_dict_mean(metrics: dict) -> dict:
    """Mean over ranks of host scalars (reference comm.reduce_dict,
    my_comm.py:8)."""
    if get_world_size() == 1:
        return metrics
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(vals, group=host_group())
    return {k: float(v) / get_world_size() for k, v in zip(keys, vals)}


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (the SIGTERM flag)."""
    if get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def broadcast_int(value: int) -> int:
    """Rank 0's integer on every rank (the run seed)."""
    if get_world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, src=0, group=host_group())
    return int(t.item())


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of `group` (default: every rank) of a device
    tensor, as a new detached tensor (no host sync)."""
    t = t.detach().clone()
    if _active() and dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t
