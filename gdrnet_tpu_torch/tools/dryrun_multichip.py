"""Multi-process dry run on the CPU: N gloo processes take a train step of a
tiny GDR-Net, and their loss terms must equal one process's at the same
global batch (counterpart of the first leg of __graft_entry__.py:87-188,
dryrun_multichip: one train step of R18 at 64x64 crops, global batch 2N,
Ranger, over an N-device mesh). With N >= 4 and even, the ranks then take
one step on an (N/2, 2) grid with PARALLEL.MODEL_PARALLEL=2 (its third leg,
__graft_entry__.py:171-186): the loss must be finite and pnp_net.fc1 sharded
on every rank.

Usage:
  python -m gdrnet_tpu_torch.tools.dryrun_multichip [--nproc 2] [--steps 1] [--seed 0]
      [--device cuda|cpu]

The ranks join a gloo process group (named here: gloo carries CPU tensors
and also runs several ranks on one card, which NCCL refuses). With
--device cuda (the default) rank r runs on card r modulo the cards there
are, the one-process run on the first card, both in f32 with TF32 off;
--device cpu needs no card. It prints one line, `dryrun_multichip {json}`
(with `model_parallel_loss`, NaN where the leg does not run), and exits
non-zero when a loss is not finite, a term of the ranks differs from one
process's by more than rtol 1e-4 (atol 1e-6), or the model axis's leg fails.

The pieces are shared: `launch` starts N processes of a command that meet
at a rendezvous file (the tests' and chip_smoke.py's rank processes), and
`train_steps` runs the steps as one process or as one rank (DDP over the
data axis's row block of each global batch; on a model axis the model
sharded first).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gdrnet_tpu_torch.config import base_config
from gdrnet_tpu_torch.config.config import Config
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine.steps import make_train_step
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.parallel import ddp_model, local_batch_size
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.parallel import tensor_parallel as tp
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule

RTOL, ATOL = 1e-4, 1e-6
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def tiny_cfg() -> Config:
    """The JAX dry run's config: the defaults at ResNet-18, 64x64 crops and
    16x16 maps, 2-D coordinates, region attention, the symmetric PM loss,
    the centroid and z losses, Ranger at 1e-4, f32."""
    cfg = base_config()
    bb = cfg.MODEL.CDPN.BACKBONE
    bb.NUM_LAYERS, bb.INPUT_RES, bb.OUTPUT_RES = 18, 64, 16
    pnp = cfg.MODEL.CDPN.PNP_NET
    pnp.WITH_2D_COORD = pnp.REGION_ATTENTION = pnp.PM_LOSS_SYM = True
    pnp.CENTROID_LW = pnp.Z_LW = 1.0
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-4, weight_decay=0)
    cfg.PARALLEL.DTYPE = "float32"
    return cfg


def launch(argv: list[str], world: int, timeout_s: float = 600.0,
           env: dict | None = None, init_method: str | None = None) -> list[str]:
    """Run `world` processes of `argv` + ["--rank", r, "--world", world,
    "--init-method", init_method] together, with this package importable;
    returns their stdouts in rank order. init_method defaults to a
    rendezvous file of its own (file://, in a new temporary directory: no
    port to race for when several launches start at once). Raises with the
    failing ranks' stderr when any exits non-zero or outlives `timeout_s`;
    every process is ended before it returns."""
    if init_method is None:
        with tempfile.TemporaryDirectory() as tmp:
            return launch(argv, world, timeout_s, env, f"file://{tmp}/rendezvous")
    init = init_method
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([*argv, "--rank", str(r), "--world", str(world),
                               "--init-method", init],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for r in range(world)]
    outs, failed = [], []
    deadline = time.monotonic() + timeout_s
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failed.append(f"rank {r}: timed out after {timeout_s} s\n{err[-3000:]}")
                continue
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"rank {r}: exit {p.returncode}\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("rank processes failed:\n" + "\n".join(failed))
    return outs


def train_steps(cfg, state_dict: dict, batches: list[dict], device="cuda",
                keep_steps: bool = False, lr_schedule: tuple | None = None,
                jax_deconv_gc: bool = False, before_steps=None) -> dict:
    """The train step over `batches` (global batches of numpy arrays) from
    `state_dict`, as one process or, under a process group, as its rank on
    its data axis's row block of each (the model's BNs then over the global
    batch, wrapped in DDP over the data group; with
    PARALLEL.MODEL_PARALLEL > 1 the world laid out as the grid and the
    model sharded). lr_schedule (base_lr, total_iters) builds the schedule
    build_lr_schedule gives; jax_deconv_gc as build_optimizer takes it;
    before_steps, if given, is called once everything is built, before the
    first step.
    Returns {"metrics": [{name: float}] a step, "step_ms": [host ms a step,
    synchronized], "buffers": {BN buffer: tensor} at the end, "state": the
    model's state_dict at the end, gathered whole, and with keep_steps
    "grads": [flat gradients, gathered whole] and "states": [gathered
    state_dict] after each step}, tensors on the CPU, and "model",
    "optimizer" (the model, sharded on a model axis, and its optimizer); on a
    model axis also "local": the rank's own state_dict at the end. On a
    model axis every rank must pass the same keep_steps (the gathers are
    collectives)."""
    device = torch.device(device)
    mh.set_model_parallel(int(cfg.PARALLEL.get("MODEL_PARALLEL", 1) or 1))
    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    tp.shard_model(model)
    schedule = build_lr_schedule(cfg, *lr_schedule) if lr_schedule else None
    optimizer = build_optimizer(cfg, model, schedule, jax_deconv_gc=jax_deconv_gc)
    state = create_train_state(model, optimizer)
    step = make_train_step(cfg, ddp_model(model), optimizer)
    rank, world = mh.data_rank(), mh.data_size()
    b = local_batch_size(len(batches[0]["roi_img"]), world)
    out: dict = {"metrics": [], "step_ms": [], "grads": [], "states": []}
    if before_steps is not None:
        before_steps()
    for batch in batches:
        rows = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, rows, None)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append(metrics)
        if keep_steps:
            out["grads"].append(torch.cat([g.detach().reshape(-1).cpu()
                                           for g in tp.full_grads(model)]))
            out["states"].append({k: v.detach().cpu().clone()
                                  for k, v in tp.full_state_dict(model).items()})
    out["state"] = {k: v.detach().cpu().clone() for k, v in tp.full_state_dict(model).items()}
    out.update(model=model, optimizer=optimizer)
    if mh.model_size() > 1:
        out["local"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    out["buffers"] = {k: v for k, v in out["state"].items()
                      if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    return out


def seeded_job(nproc: int, steps: int, seed: int) -> tuple:
    """(cfg, state_dict, batches): the tiny config's weights from `seed`
    and `steps` global batches of 2 * nproc ROIs."""
    cfg = tiny_cfg()
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    batches = [synthetic_roi_batch(batch_size=2 * nproc, input_res=64, out_res=16,
                                   num_points=64, seed=seed + 1 + i) for i in range(steps)]
    return cfg, model.state_dict(), batches


def worst_rel(got: list[dict], want: list[dict]) -> float:
    """The largest |got - want| / (atol + rtol |want|) over every term and
    step: at most 1 within the tolerance."""
    return max(abs(g[k] - w[k]) / (ATOL + RTOL * abs(w[k]))
               for g, w in zip(got, want) for k in w)


def use_device(device: str, rank: int = 0) -> str:
    """The device a process of the dry run takes: on CUDA, card rank modulo
    the cards there are, made current, with TF32 off (f32 as the tests'
    tolerance assumes)."""
    if torch.device(device).type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here (pass --device cpu)")
    card = rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return f"cuda:{card}"


def model_axis_leg(cfg, state_dict: dict, batches: list[dict], device) -> dict:
    """The third leg, on every rank of an even world of 4 or more: one step
    on a (world / 2, 2) grid. Returns the rank's total loss and
    pnp_net.fc1.weight's shape on it against the whole one."""
    cfg = Config(cfg.to_dict())
    cfg.PARALLEL.MODEL_PARALLEL = 2
    res = train_steps(cfg, state_dict, batches[:1], device=device)
    fc1 = res["local"]["pnp_net.fc1.weight"]
    return {"loss": res["metrics"][0]["total_loss"], "fc1_local": list(fc1.shape),
            "fc1_full": list(state_dict["pnp_net.fc1.weight"].shape)}


def _worker(args) -> None:
    torch.set_num_threads(1)
    device = use_device(args.device, args.rank)
    mh.maybe_init_distributed(backend="gloo", init_method=args.init_method,
                              world_size=args.world, rank=args.rank)
    mp = None
    try:
        cfg, state_dict, batches = seeded_job(args.world, args.steps, args.seed)
        res = train_steps(cfg, state_dict, batches, device=device)
        if args.world >= 4 and args.world % 2 == 0:
            mp = model_axis_leg(cfg, state_dict, batches, device)
    finally:
        torch.distributed.destroy_process_group()
    print("RANK " + json.dumps({"rank": args.rank, "metrics": res["metrics"],
                                "model_parallel": mp}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the ranks and the one-process run compute (default: cuda)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:  # one of the rank processes
        _worker(args)
        return 0

    t0 = time.perf_counter()
    cfg, state_dict, batches = seeded_job(args.nproc, args.steps, args.seed)
    torch.set_num_threads(1)  # as each rank
    one = train_steps(cfg, state_dict, batches, device=use_device(args.device))["metrics"]
    outs = launch([sys.executable, "-m", "gdrnet_tpu_torch.tools.dryrun_multichip",
                   "--steps", str(args.steps), "--seed", str(args.seed),
                   "--device", args.device], args.nproc)
    ranks = [json.loads(next(ln for ln in o.splitlines() if ln.startswith("RANK "))[5:])
             for o in outs]
    finite = all(np.isfinite(v) for r in ranks for m in r["metrics"] for v in m.values())
    worst = max(worst_rel(r["metrics"], one) for r in ranks)
    equal = all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    ok = finite and worst <= 1.0 and equal
    mp = [r["model_parallel"] for r in ranks]
    mp_loss, fc1_sharded = float("nan"), None
    if mp[0] is not None:  # the model axis's leg ran
        mp_loss = mp[0]["loss"]
        fc1_sharded = all(m["fc1_local"] == [m["fc1_full"][0] // 2, *m["fc1_full"][1:]]
                          for m in mp)
        ok = ok and fc1_sharded and all(np.isfinite(m["loss"]) and m["loss"] == mp_loss
                                        for m in mp)
    print("dryrun_multichip " + json.dumps({
        "nproc": args.nproc, "device": args.device, "global_batch": 2 * args.nproc,
        "steps": args.steps,
        "total_loss": [m["total_loss"] for m in ranks[0]["metrics"]],
        "total_loss_one_process": [m["total_loss"] for m in one],
        "model_parallel_loss": mp_loss, "model_parallel_grid": (
            [args.nproc // 2, 2] if mp[0] is not None else None),
        "fc1_sharded_on_every_rank": fc1_sharded,
        "worst_over_tolerance": worst, "ranks_equal": equal, "finite": finite,
        "tolerance": {"rtol": RTOL, "atol": ATOL},
        "wall_s": round(time.perf_counter() - t0, 3), "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
