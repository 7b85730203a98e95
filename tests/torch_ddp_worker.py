"""One rank of the port's data- and model-parallel tests: joins a gloo process
group on the CPU and runs the scenarios of a pickled job, then pickles what
each returned next to the job, as `<job>.rank<r>.pkl`.

Run by gdrnet_tpu_torch.tools.dryrun_multichip.launch:
  python tests/torch_ddp_worker.py <job.pkl> --rank R --world N --init-method file://...

The ranks meet at a rendezvous file beside the job (no free port to race
for when several test files launch ranks at once). It imports neither JAX
nor the JAX package. A job is {"scenarios": [(name, kwargs), ...]}; the
names are the functions below. After `regrid` the ranks it leaves out
return None for the scenarios that follow.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import os.path as osp
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from gdrnet_tpu_torch.parallel import multihost as mh

WORKER = osp.abspath(__file__)


def run_ranks(job_dir, scenarios: list, world: int = 2, timeout_s: float = 300.0) -> list:
    """Run `scenarios` in `world` rank processes of this script (gloo, CPU);
    returns each rank's list of results, in rank order."""
    from gdrnet_tpu_torch.tools.dryrun_multichip import launch

    job = osp.join(str(job_dir), "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"scenarios": scenarios}, f)
    launch([sys.executable, WORKER, job], world, timeout_s=timeout_s,
           init_method=f"file://{osp.join(str(job_dir), 'rendezvous')}")
    out = []
    for r in range(world):
        with open(f"{job}.rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def start_ranks(job_dir, scenarios: list, world: int = 2,
                timeout_s: float = 300.0) -> concurrent.futures.Future:
    """run_ranks in a thread of its own: the caller works on while the ranks
    run and takes their results with .result()."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_ranks, job_dir, scenarios, world, timeout_s)
    pool.shutdown(wait=False)
    return future


def helpers() -> dict:
    """Every multihost helper once; payloads of different sizes per rank."""
    rank = mh.get_rank()
    gathered = mh.all_gather_objects({"rank": rank, "data": list(range(1000 * rank + 1))})
    mh.synchronize()
    return {"rank": rank, "world": mh.get_world_size(), "main": mh.is_main_process(),
            "gathered": gathered,
            "mean": mh.reduce_dict_mean({"a": float(rank), "b": 2.0}),
            "any_none": mh.any_rank(False), "any_one": mh.any_rank(rank == 1),
            "seed": mh.broadcast_int(1234 + rank),
            "sum": mh.all_reduce_sum(torch.tensor([1.0 + rank])).tolist()}


def sync_bn(x: np.ndarray, dy: np.ndarray, state: dict, momentum, passes: int,
            train: bool = True, device: str = "cpu") -> dict:
    """SyncBatchNorm2d on the rank's row block of x [B, C, H, W] on `device`
    (every rank on the first card for "cuda"): `passes` forward / backward
    passes of sum(y * dy); per pass the outputs, the input's gradient, the
    affine gradients summed over the ranks, and the buffers."""
    from gdrnet_tpu_torch.parallel.sync_bn import SyncBatchNorm2d

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    rank, world = mh.get_rank(), mh.get_world_size()
    b = len(x) // world
    rows = slice(rank * b, (rank + 1) * b)
    bn = SyncBatchNorm2d(x.shape[1], eps=1e-5, momentum=momentum).to(device)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    bn.train(train)
    out = []
    for _ in range(passes):
        xr = torch.from_numpy(x[rows]).to(device).requires_grad_(True)
        bn.zero_grad()
        y = bn(xr)
        (y * torch.from_numpy(dy[rows]).to(device)).sum().backward()
        grads = torch.cat([bn.weight.grad, bn.bias.grad])
        dist.all_reduce(grads)
        out.append({"y": y.detach().cpu().numpy(), "dx": xr.grad.cpu().numpy(),
                    "dw": grads[:x.shape[1]].cpu().numpy(),
                    "db": grads[x.shape[1]:].cpu().numpy(),
                    "buffers": {k: v.clone().cpu().numpy() for k, v in bn.state_dict().items()}})
    return {"rows": (rows.start, rows.stop), "passes": out}


def train(cfg: dict, state_dict: dict, batches: list, **kwargs) -> dict:
    """dryrun_multichip.train_steps as this rank; "no_sync" counts the
    micro-steps DDP ran under no_sync."""
    from torch.nn.parallel import DistributedDataParallel

    from gdrnet_tpu_torch.config.config import Config
    from gdrnet_tpu_torch.tools.dryrun_multichip import train_steps

    no_sync, calls = DistributedDataParallel.no_sync, []

    def counted(self):
        calls.append(1)
        return no_sync(self)

    DistributedDataParallel.no_sync = counted
    try:
        res = train_steps(Config(cfg), state_dict, batches, **dict(dict(device="cpu"), **kwargs))
    finally:
        DistributedDataParallel.no_sync = no_sync
    res["no_sync"] = len(calls)
    res.pop("model"), res.pop("optimizer")
    if not mh.is_main_process():  # the parameters and gradients are every rank's
        for k in ("state", "grads", "states"):
            res.pop(k)
    return res


def do_train(cfg: dict, dataset: str, meta, records: list, iters: int) -> dict:
    """engine/trainer.do_train on the CPU over `records` registered as
    `dataset`, seeded as the single-process run is."""
    from gdrnet_tpu_torch.config.config import Config
    from gdrnet_tpu_torch.data import dataset_factory
    from gdrnet_tpu_torch.engine import trainer

    dataset_factory.register(dataset, lambda: (meta, records))
    np.random.seed(5)  # the mapper draws its blur when it is built
    state, _, preempted = trainer.do_train(Config(cfg), max_iters_override=iters, device="cpu")
    return {"step": state.step, "preempted": preempted}


def pool_block(cfg: dict, meta, records: list, seed: int) -> dict:
    """data/device_pool.DevicePool on the CPU as this rank builds it: its
    slot range, its records' frames, its rows' images, the sampler's first
    global index batch of 4 and the rows of this rank's block of it."""
    from gdrnet_tpu_torch.config.config import Config
    from gdrnet_tpu_torch.data import ObjectModels
    from gdrnet_tpu_torch.data.device_pool import DevicePool, pool_index_sampler
    from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper

    cfg = Config(cfg)
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    np.random.seed(2)  # the mapper draws its blur when it is built
    pool = DevicePool(cfg, [dict(r) for r in records], GDRNTrainMapper(cfg, models, device="cpu"),
                      models, device="cpu", seed=seed)
    idx = next(pool_index_sampler(pool, 4, seed))
    r = mh.data_rank()
    batch = pool.make_batch(idx[2 * r:2 * r + 2])
    return {"start": pool.start, "stop": pool.stop,
            "paths": [pool.records[i]["rgb_path"] for i in range(pool.start, pool.stop)],
            "img_u8": pool.pool["img_u8"].numpy(), "idx_all": idx.tolist(),
            "idx_block": idx[2 * r:2 * r + 2].tolist(), "batch_rows": batch["roi_img"].shape[0]}


def do_test(cfg: dict, meta, records: list, weights: str, output_dir: str,
            num_pm_points: int, num_fps: int) -> dict:
    """engine/tester.do_test on the CPU, sharded over the ranks."""
    from gdrnet_tpu_torch.config.config import Config
    from gdrnet_tpu_torch.data import ObjectModels
    from gdrnet_tpu_torch.engine import checkpoint, tester
    from gdrnet_tpu_torch.models.gdrn import build_model

    cfg = Config(cfg)
    models = ObjectModels(meta, num_pm_points=num_pm_points, num_fps=num_fps)
    model = checkpoint.load_weights(build_model(cfg, device="cpu"), weights)
    res = tester.do_test(cfg, model, models, records, output_dir=output_dir, device="cpu")
    return {k: v for k, v in res.items() if k != "_time"}


def regrid(world: int, init_method: str) -> dict:
    """Leave the process group; the ranks below `world` join a new one of
    `world` ranks at `init_method`, the others sit out what follows."""
    rank = mh.get_rank()
    dist.destroy_process_group()
    if rank < world:
        mh.maybe_init_distributed(backend="gloo", init_method=init_method, world_size=world,
                                  rank=rank)
    return {"rank": rank, "joined": rank < world}


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def model_axis(cfg: dict, state_dict: dict, batches: list, trust_ratio: bool = False,
               returns: tuple = ("grads",), **kwargs) -> dict:
    """dryrun_multichip.train_steps on the grid of cfg's
    PARALLEL.MODEL_PARALLEL: rank 0 returns what `returns` names of the
    first step's gathered gradients ("grads") and the gathered state at
    the end ("state"). Every rank returns its metrics, its
    place on the grid, its slices' shapes and a digest of its replicated
    parameters. trust_ratio: the optimizer's per-tensor ratios at its
    first step beside the ratios one process's _trust_ratio gives on the
    same whole tensors (gathered)."""
    from gdrnet_tpu_torch.config.config import Config
    from gdrnet_tpu_torch.parallel import tensor_parallel as tp
    from gdrnet_tpu_torch.solver import optimizers
    from gdrnet_tpu_torch.tools.dryrun_multichip import train_steps

    trust, plain = [], optimizers._trust_ratio

    def captured(update, params, norms=torch._foreach_norm):
        ratios = plain(update, params, norms) if trust else None
        if ratios is None:  # the first call: the whole tensors before the ratios scale them
            opt = norms.__self__  # the optimizer's _norms
            whole = [[opt._axis.gather(t, d) if d is not None else t.clone()
                      for t, d in zip(ts, opt._shard_dims)] for ts in (update, params)]
            ratios = plain(update, params, norms)
            trust.append([float(r) for r in ratios])
            trust.append([float(r) for r in plain(*whole)])
        return ratios

    optimizers._trust_ratio = captured if trust_ratio else plain
    try:
        res = train_steps(Config(cfg), state_dict, batches, keep_steps=True,
                          **dict(dict(device="cpu"), **kwargs))
    finally:
        optimizers._trust_ratio = plain
    res.update(rank=mh.get_rank(), data=(mh.data_rank(), mh.data_size()),
               model_axis=(mh.model_rank(), mh.model_size()), trust=trust,
               grads=res["grads"][:1])  # the first step's: the tests compare no other
    res.pop("states")
    model, _ = res.pop("model"), res.pop("optimizer")
    if "local" in res:  # a model axis
        local = res.pop("local")
        sharded = {f"{n}.weight" for n, _ in tp.sharded_modules(model)}
        replicated = [v for k, v in model.named_parameters() if k not in sharded]
        res.update(local_shapes={k: tuple(local[k].shape) for k in sorted(sharded)},
                   replicated=(len(replicated), hashlib.sha256(b"".join(
                       v.detach().numpy().tobytes() for v in replicated)).hexdigest()))
    for k in ("state", "grads"):
        if not mh.is_main_process() or k not in returns:
            res.pop(k)
    return res


def model_axis_checkpoint(cfg: dict, one_ckpt: str, round_trip: str, stepped: str,
                          batch: dict) -> dict:
    """The checkpoint on a grid. Resume one process's checkpoint `one_ckpt`
    onto it (the digests of the rank's model and optimizer slices, and of a
    sharded model that load_weights filled from it, MODEL.WEIGHTS's way), save
    that state again to `round_trip`, take a train step on `batch` and save
    to `stepped` (the digests of the rank's slices before the save)."""
    from gdrnet_tpu_torch.config.config import Config
    from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager, load_weights
    from gdrnet_tpu_torch.engine.steps import make_train_step
    from gdrnet_tpu_torch.engine.train_state import create_train_state
    from gdrnet_tpu_torch.models.gdrn import build_model
    from gdrnet_tpu_torch.parallel import ddp_model, local_batch_size
    from gdrnet_tpu_torch.parallel import tensor_parallel as tp
    from gdrnet_tpu_torch.solver.optimizers import build_optimizer

    cfg = Config(cfg)
    mh.set_model_parallel(cfg.PARALLEL.MODEL_PARALLEL)
    model = tp.shard_model(build_model(cfg, device="cpu"))
    opt = build_optimizer(cfg, model)
    state = create_train_state(model, opt)

    def digests() -> dict:
        sd = opt.state_dict()["state"]
        return {"model": {k: sha(v) for k, v in model.state_dict().items()},
                "optimizer": {f"{i}.{n}": sha(v) for i, st in sd.items() if i != "shared"
                              for n, v in st.items()}}

    state, it = CheckpointManager(one_ckpt).resume_or_load(state)
    resumed = digests()
    weights = tp.shard_model(build_model(cfg, device="cpu"))  # MODEL.WEIGHTS's way in
    load_weights(weights, one_ckpt)
    resumed["weights"] = {k: sha(v) for k, v in weights.state_dict().items()}
    CheckpointManager(round_trip).save(state, it)
    b = local_batch_size(len(batch["roi_img"]), mh.data_size())
    rows = {k: v[mh.data_rank() * b:(mh.data_rank() + 1) * b] for k, v in batch.items()}
    state, metrics = make_train_step(cfg, ddp_model(model), opt)(state, rows, None)
    stepped_digests = digests()
    CheckpointManager(stepped).save(state, it + 1)
    return {"rank": mh.get_rank(), "model_axis": (mh.model_rank(), mh.model_size()),
            "iteration": it, "resumed": resumed, "stepped": stepped_digests,
            "shard_dims": {f"{n}.weight": m.shard_dim for n, m in tp.sharded_modules(model)},
            "opt_shard_dims": {i: d for i, d in enumerate(opt._shard_dims) if d is not None},
            "total_loss": float(metrics["total_loss"])}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("job")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init-method", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    with open(args.job, "rb") as f:
        job = pickle.load(f)
    mh.maybe_init_distributed(backend="gloo", init_method=args.init_method,
                              world_size=args.world, rank=args.rank)
    out = []
    try:
        for name, kwargs in job["scenarios"]:
            out.append(getattr(sys.modules[__name__], name)(**kwargs)
                       if dist.is_initialized() else None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{args.job}.rank{args.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
