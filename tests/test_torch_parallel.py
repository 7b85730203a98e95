"""The port's data parallelism on the CPU (gdrnet_tpu_torch/parallel, the
rank-sliced loader, DDP in the train step and do_train, the dry run), and
do_train on a model axis (PARALLEL.MODEL_PARALLEL; the rest of the model
axis is tests/test_torch_parallel_model.py's).

Rank processes run tests/torch_ddp_worker.py under a gloo process group
that meets at a rendezvous file: one launch of two ranks serves every case
of the file (the helpers, the BatchNorm cases, the accumulated steps,
R_ONLY, an output the loss leaves out, do_train as 2 data ranks and as a
(1, 2) grid), started with the file's first test and run beside the
one-process tests, whose results the rank tests at the end compare with.
Tolerances:
- SyncBatchNorm2d in 2 ranks against nn.BatchNorm2d in one process on the
  concatenated batch: outputs, the input's and the affine gradients and
  the running buffers within 1e-6 (f32; the statistics are summed in
  another order).
- A DDP update with SOLVER.GRAD_ACCUM_STEPS=3 (the first micro-step synced,
  as DDP's first step always is, then one under no_sync, then a synced
  one) in 2 ranks against one process at the same global
  batch: every logged term at rtol 1e-4 (the train-step tests' forward
  tolerance); the update of all parameters together within 1e-3 relative
  L2 and of each tensor within 0.15, tests/test_torch_train.py's
  tolerance. The convolutions at half the batch round differently, and
  this net's BatchNorms over 16 values a channel (ResNet-18's last stage)
  amplify that to about 2e-5 in the head's maps and 0.5 % in single
  gradients (a ReLU unit near 0 flips). Only the first update is compared:
  from there the two runs are two states a rounding apart.
- R_ONLY (a parameter left out of the loss) in 2 ranks: the first step's
  terms at rtol 1e-4 against one process, the second step finite; the
  same for the translation's losses off (fc_t runs, no loss reads it), 3
  steps.
- do_train in 2 ranks against one process, 3 iterations of the small
  flagship on tests/fixture_bop.py: total_loss at rtol 1e-4 at each; the
  same on a (1, 2) grid, whose checkpoint is one process's.
- The loader's ranks: bitwise.
"""

import json
import logging
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from gdrnet_tpu.parallel.mesh import local_dp_setup as jax_local_dp_setup

from gdrnet_tpu_torch.data import dataset_factory
from gdrnet_tpu_torch.data.loader import TrainLoader
from gdrnet_tpu_torch.data.mapper import collate
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine import checkpoint, trainer
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.parallel import (
    SyncBatchNorm2d,
    convert_sync_bn,
    ddp_model,
    local_dp_setup,
    resolve_world,
    split_predict,
)
from gdrnet_tpu_torch.parallel import multihost as mh
from gdrnet_tpu_torch.tools import dryrun_multichip
from gdrnet_tpu_torch.tools.dryrun_multichip import train_steps
from test_torch_trainer import _losses, _train_cfg, fixture_records  # noqa: F401
from torch_ddp_worker import start_ranks
from test_torch_parallel_model import tiny_cfg
from torch_parity import small_flagship_cfg

BN_CASES = {"momentum": dict(momentum=0.1, passes=2), "cumulative": dict(momentum=None, passes=3),
            "eval": dict(momentum=0.1, passes=1, train=False)}
ACCUM_STEPS = 3  # micro-steps: one update at GRAD_ACCUM_STEPS=3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bn_inputs(seed: int = 0, b: int = 4, c: int = 3) -> tuple:
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, c, 5, 6) * 2.0 + 0.5).astype(np.float32)
    dy = rng.randn(b, c, 5, 6).astype(np.float32)
    state = {"weight": (1.0 + 0.1 * rng.randn(c)).astype(np.float32),
             "bias": (0.1 * rng.randn(c)).astype(np.float32),
             "running_mean": (0.1 * rng.randn(c)).astype(np.float32),
             "running_var": (rng.rand(c) + 0.5).astype(np.float32),
             "num_batches_tracked": np.array(3, np.int64)}
    return x, dy, state


def accum_job():
    cfg = small_flagship_cfg()
    cfg.SOLVER.GRAD_ACCUM_STEPS = ACCUM_STEPS
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-3, weight_decay=0)
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(2))
    batches = [synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, num_classes=10,
                                   num_points=64, seed=50 + i) for i in range(ACCUM_STEPS)]
    return cfg, model.state_dict(), batches


def r_only_job():
    """R_ONLY leaves the translation head's fc_t out of the loss: DDP must
    take parameters that get no gradient (parallel/mesh.ddp_model)."""
    cfg = small_flagship_cfg()
    for k, v in {"MODEL.CDPN.PNP_NET.R_ONLY": True, "MODEL.CDPN.TRANS_HEAD.ENABLED": True,
                 "MODEL.CDPN.TRANS_HEAD.FREEZE": False}.items():
        cfg.set_path(k, v)
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-3, weight_decay=0)
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(3))
    batches = [synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, num_classes=10,
                                   num_points=64, seed=60 + i) for i in range(2)]
    return cfg, model.state_dict(), batches


def unused_output_job():
    """JAX's _tiny_setup config (tests/test_torch_parallel_model.py), whose
    losses leave the translation out: fc_t runs in the forward and feeds no
    loss term, so DDP must take the parameters behind an output the loss
    leaves out at every step (engine/steps._TieOutputs)."""
    cfg = tiny_cfg()
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(6))
    batches = [synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, num_points=64,
                                   num_regions=4, seed=65 + i) for i in range(3)]
    return cfg, model.state_dict(), batches


def do_train_cfgs(root) -> tuple:
    """(the ranks' config, the one-process config, the (1, 2) grid's
    config): ITERS iterations of tests/test_torch_trainer.py's train config,
    checkpoints every 2."""
    cfgs = []
    for name, mesh_shape in (("ranks", (-1,)), ("one", (1,)), ("grid", (-1,))):
        cfg = _train_cfg(str(root / name), "")
        cfg.SOLVER.CHECKPOINT_PERIOD = 2
        cfg.PARALLEL.MESH_SHAPE = mesh_shape
        cfg.PARALLEL.MODEL_PARALLEL = 2 if name == "grid" else 1
        cfgs.append(cfg)
    return tuple(cfgs)


ITERS = 3
SCENARIOS = ["helpers", *(f"sync_bn_{c}" for c in BN_CASES), "accum", "r_only",
             "unused_output", "do_train", "do_train_grid"]


@pytest.fixture(scope="module", autouse=True)
def ranks_job(fixture_records, tmp_path_factory):  # noqa: F811
    """One launch of 2 ranks for the whole file, started when the file's
    first test starts and run beside the one-process tests: the helpers,
    every BN case, the accumulated train steps, R_ONLY's steps and
    do_train (SCENARIOS, in order). A test takes its results with
    results() once its own reference is computed."""
    root = tmp_path_factory.mktemp("ranks")
    scenarios = [("helpers", {})]
    for case in BN_CASES.values():
        x, dy, state = bn_inputs()
        scenarios.append(("sync_bn", dict(x=x, dy=dy, state=state, **case)))
    for job in (accum_job, r_only_job, unused_output_job):
        cfg, sd, batches = job()
        scenarios.append(("train", dict(cfg=cfg.to_dict(), state_dict=sd, batches=batches)))
    meta, records = dataset_factory.resolve("trajfix_train")
    for cfg in do_train_cfgs(root)[::2]:
        scenarios.append(("do_train", dict(cfg=cfg.to_dict(), dataset="trajfix_train",
                                           meta=meta, records=records, iters=ITERS)))
    return {"root": root, "future": start_ranks(root, scenarios)}


def results(ranks_job, name: str) -> list:
    """Each rank's result of scenario `name`, in rank order."""
    return [r[SCENARIOS.index(name)] for r in ranks_job["future"].result()]


# ---------------------------------------------------------------------------
# parallel/multihost.py
# ---------------------------------------------------------------------------


def test_multihost_helpers_identity_in_one_process():
    assert not torch.distributed.is_initialized()
    assert (mh.get_rank(), mh.get_world_size(), mh.is_main_process()) == (0, 1, True)
    obj = {"a": [1, 2]}
    assert mh.all_gather_objects(obj) == [obj]
    mh.synchronize()
    metrics = {"loss": 2.5}
    assert mh.reduce_dict_mean(metrics) is metrics
    assert mh.any_rank(True) and not mh.any_rank(False)
    assert mh.broadcast_int(7) == 7
    assert mh.maybe_init_distributed() is False  # no launcher, no init method


def test_host_group_is_a_gloo_twin_made_once_a_process_group(monkeypatch, tmp_path):
    """Under a default group that is not gloo (NCCL on the card; here a
    1-rank gloo group that says it is NCCL), host_group makes one gloo
    group and reuses it, and a process group made again after
    destroy_process_group gets a new one."""
    backend = torch.distributed.get_backend
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group=None: "nccl" if group is None else backend(group))
    twins = []
    try:
        for i in range(2):
            torch.distributed.init_process_group(
                "gloo", init_method=f"file://{tmp_path / f'rendezvous{i}'}", world_size=1, rank=0)
            first = mh.host_group()
            assert first is not torch.distributed.group.WORLD and mh.host_group() is first
            assert backend(first) == "gloo"
            twins.append(first)
            torch.distributed.destroy_process_group()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert twins[0] is not twins[1]


# ---------------------------------------------------------------------------
# parallel/sync_bn.py
# ---------------------------------------------------------------------------


def test_sync_bn_in_one_process_is_the_plain_bn():
    """Without a process group the swapped layer is nn.BatchNorm2d bit for
    bit; convert_sync_bn keeps the parameter objects, the state_dict keys
    and each layer's mode (R_ONLY's TransHeadNet stays in eval)."""
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.PNP_NET.R_ONLY = True
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    keys = list(model.state_dict())
    plain = [n for n, m in model.named_modules() if type(m) is torch.nn.BatchNorm2d]
    model.train()
    modes = {n: m.training for n, m in model.named_modules()}
    convert_sync_bn(model)
    assert list(model.state_dict()) == keys
    assert all(p is params[n] for n, p in model.named_parameters())
    mods = dict(model.named_modules())
    assert plain and all(type(mods[n]) is SyncBatchNorm2d for n in plain)
    assert {n: m.training for n, m in model.named_modules()} == modes
    assert not all(modes[n] for n in plain)  # the trans head's BNs read running stats
    x = torch.randn(3, 4, 5, 5)
    ref = torch.nn.BatchNorm2d(4)
    sync = convert_sync_bn(torch.nn.Sequential(torch.nn.BatchNorm2d(4)))[0]
    assert torch.equal(sync(x), ref(x))
    assert torch.equal(sync.running_var, ref.running_var)
    assert ddp_model(model) is model  # one process: no wrapper


# ---------------------------------------------------------------------------
# data/loader.py
# ---------------------------------------------------------------------------


def _stub_mapper(rec, rng):
    return {"id": np.array([rec["id"]]), "draw": rng.randint(0, 2 ** 31 - 1, size=2)}


@pytest.mark.parametrize("ratio2", [0.0, 0.3])
def test_loader_ranks_union_is_one_process_batch(ratio2):
    """Every rank walks the one-process stream: rows [r b, (r+1) b) of each
    global batch of 8, bitwise, with and without TRAIN2 mixing."""
    recs = [{"id": i, "label": i % 3} for i in range(11)]
    recs2 = [{"id": 100 + i, "label": 0} for i in range(5)]

    def batches(rank, world, n=5):
        loader = TrainLoader(recs, _stub_mapper, 8, seed=3, num_workers=1, records2=recs2,
                             ratio2=ratio2, rank=rank, world_size=world)
        it = iter(loader)
        try:
            return [next(it) for _ in range(n)]
        finally:
            it.close()

    one = batches(0, 1)
    for world in (2, 4):
        ranks = [batches(r, world) for r in range(world)]
        for i, want in enumerate(one):
            got = collate([{k: v[j] for k, v in b[i].items()}
                           for b in ranks for j in range(len(b[i]["id"]))])
            assert all(np.array_equal(got[k], want[k]) for k in want)
    assert (ratio2 > 0) == any((b["id"] >= 100).any() for b in one)
    with pytest.raises(ValueError, match="divisible"):
        TrainLoader(recs, _stub_mapper, 6, world_size=4)


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------


def test_local_dp_setup_rule_matches_jax(monkeypatch):
    """The replica count over device counts, requests and buckets is JAX's
    mesh size (its devices: the conftest's virtual CPU devices)."""
    layer = torch.nn.Linear(2, 2)
    devices = jax.local_devices()
    for n_dev in (1, 2, 3, 4, 8):
        monkeypatch.setattr(jax, "local_devices", lambda n=n_dev: devices[:n])
        for n_want in (-1, 0, 1, 2, 3, 4, 6, 8, 16):
            for bucket in (1, 2, 3, 4, 6, 8, 12, 64):
                mesh, _ = jax_local_dp_setup({"w": np.zeros(2)}, bucket, n_want)
                got, replicas = local_dp_setup(layer, bucket, n_want, devices=["cpu"] * n_dev)
                want = 1 if mesh is None else mesh.shape["data"]
                assert len(replicas) == want and (got is None) == (want == 1), \
                    (n_dev, n_want, bucket)
                assert replicas[0] is layer and all(r is not layer for r in replicas[1:])


def test_split_predict_gives_unsplit_poses():
    cfg = small_flagship_cfg()
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(4))
    batch = {k: torch.from_numpy(v) for k, v in synthetic_roi_batch(
        batch_size=6, input_res=64, out_res=16, num_classes=10, seed=9).items()}
    want = make_predict_step(model, with_maps=True)(batch)
    devices, replicas = local_dp_setup(model, 6, 4, devices=["cpu", "cpu", "cpu", "cpu"])
    assert len(devices) == 3  # 6 rows: the largest divisor no greater than 4
    got = split_predict([make_predict_step(r, with_maps=True) for r in replicas],
                        devices)(batch)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


RESOLVE_CASES = {  # (MESH_SHAPE, MODEL_PARALLEL, batch, world): (data, model) ranks, or the error
    "all": ((-1,), 1, 8, 2, (2, 1)),
    "one_of_one": ((1,), 1, 8, 1, (1, 1)),
    "four_on_one_warns": ((4,), 1, 8, 1, (1, 1)),
    "fewer_than_started": ((1,), 1, 8, 2, ValueError),
    "batch_not_divisible": ((-1,), 1, 3, 2, ValueError),
    "two_d": ((2, 2), 1, 8, 2, ValueError),
    "zero": ((0,), 1, 8, 1, ValueError),
    "model_axis": ((-1,), 2, 8, 2, (1, 2)),
}


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve_world(case, caplog):
    mesh, mp, batch, world, want = RESOLVE_CASES[case]
    cfg = small_flagship_cfg()
    cfg.PARALLEL.MESH_SHAPE, cfg.PARALLEL.MODEL_PARALLEL = mesh, mp
    logger = logging.getLogger("gdrnet_tpu_torch.test")
    if isinstance(want, type):
        with pytest.raises(want):
            resolve_world(cfg, batch, world, logger)
        return
    with caplog.at_level(logging.WARNING, logger=logger.name):
        assert resolve_world(cfg, batch, world, logger) == want
    assert ("asks for more devices" in caplog.text) == (case == "four_on_one_warns")


# ---------------------------------------------------------------------------
# engine/trainer.do_train: MESH_SHAPE on one device
# ---------------------------------------------------------------------------


def test_mesh_shape_4_on_one_device_warns_and_trains(fixture_records, tmp_path):  # noqa: F811
    cfg = _train_cfg(str(tmp_path), "")
    cfg.PARALLEL.MESH_SHAPE = (4,)
    np.random.seed(5)
    state, _, preempted = trainer.do_train(cfg, max_iters_override=1, device="cpu")
    assert state.step == 1 and not preempted
    with open(osp.join(cfg.OUTPUT_DIR, "log.txt")) as f:
        assert "asks for more devices than the 1 rank(s)" in f.read()


# ---------------------------------------------------------------------------
# tools/dryrun_multichip.py
# ---------------------------------------------------------------------------


def test_dryrun_multichip_cli_two_processes(capsys):
    """The CLI's main with --device cpu: the one-process step here, the
    ranks as `python -m gdrnet_tpu_torch.tools.dryrun_multichip` processes."""
    assert dryrun_multichip.main(["--nproc", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("dryrun_multichip ")
    res = json.loads(lines[0].split(" ", 1)[1])
    assert res["ok"] and res["finite"] and res["ranks_equal"] and res["global_batch"] == 4
    assert res["worst_over_tolerance"] <= 1.0


# ---------------------------------------------------------------------------
# the tests that read the ranks' results (last: the launch runs beside the
# tests above)
# ---------------------------------------------------------------------------


def test_multihost_helpers_in_two_processes(ranks_job):
    payloads = [{"rank": r, "data": list(range(1000 * r + 1))} for r in range(2)]
    for r, got in enumerate(results(ranks_job, "helpers")):
        assert (got["rank"], got["world"], got["main"]) == (r, 2, r == 0)
        assert got["gathered"] == payloads  # rank order, payloads of two sizes
        assert got["mean"] == {"a": 0.5, "b": 2.0}
        assert not got["any_none"] and got["any_one"]
        assert got["seed"] == 1234 and got["sum"] == [3.0]


@pytest.mark.parametrize("case", list(BN_CASES))
def test_sync_bn_two_ranks_match_one_process(ranks_job, case):
    kw = BN_CASES[case]
    x, dy, state = bn_inputs()
    bn = torch.nn.BatchNorm2d(x.shape[1], eps=1e-5, momentum=kw["momentum"])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    bn.train(kw.get("train", True))
    want = []
    for _ in range(kw["passes"]):
        xt = torch.from_numpy(x).requires_grad_(True)
        bn.zero_grad()
        y = bn(xt)
        (y * torch.from_numpy(dy)).sum().backward()
        want.append({"y": y.detach().numpy(), "dx": xt.grad.numpy(),
                     "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                     "buffers": {k: v.clone().numpy() for k, v in bn.state_dict().items()}})
    ranks = results(ranks_job, f"sync_bn_{case}")
    for got in ranks:
        lo, hi = got["rows"]
        for g, w in zip(got["passes"], want):
            np.testing.assert_allclose(g["y"], w["y"][lo:hi], rtol=0, atol=1e-6)
            np.testing.assert_allclose(g["dx"], w["dx"][lo:hi], rtol=0, atol=1e-6)
            for k in ("dw", "db"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6, err_msg=k)
            for k, v in w["buffers"].items():
                np.testing.assert_allclose(g["buffers"][k], v, rtol=0, atol=1e-6, err_msg=k)
    a, b = (r["passes"][-1]["buffers"] for r in ranks)
    assert all(np.array_equal(a[k], b[k]) for k in a)  # every rank holds the same buffers


# ---------------------------------------------------------------------------
# engine/steps.py under DDP: SOLVER.GRAD_ACCUM_STEPS with no_sync
# ---------------------------------------------------------------------------


def test_grad_accum_ranks_match_one_process(ranks_job):
    cfg, sd, batches = accum_job()
    one = train_steps(cfg, sd, batches, device="cpu")
    got, other = results(ranks_job, "accum")
    assert other["metrics"] == got["metrics"]  # the logged values are global
    assert got["no_sync"] == other["no_sync"] == 1  # the middle micro-step
    for g, w in zip(got["metrics"], one["metrics"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=k)
    errs = {}
    for k, w in one["state"].items():
        if not w.is_floating_point():
            assert torch.equal(got["state"][k], w), k
            continue
        update = w - sd[k]
        errs[k] = float((got["state"][k] - w).norm() / update.norm().clamp_min(1e-30))
    total = float(torch.cat([(got["state"][k] - w).reshape(-1) for k, w in one["state"].items()
                             if k in errs]).norm() / torch.cat(
        [(w - sd[k]).reshape(-1) for k, w in one["state"].items() if k in errs]).norm())
    print(f"update error: all {total:.3e}, worst tensor {max(errs.values()):.3e} at "
          f"{max(errs, key=errs.get)}")
    assert total < 1e-3 and max(errs.values()) < 0.15


def test_ddp_takes_parameters_left_out_of_the_loss(ranks_job):
    """R_ONLY in 2 ranks: both steps run (DDP would stop at the second if
    it waited for fc_t's gradient), the logged terms are the ranks' same
    global values, at the first step those of one process (rtol 1e-4)."""
    cfg, sd, batches = r_only_job()
    one = train_steps(cfg, sd, batches[:1], device="cpu")
    got, other = results(ranks_job, "r_only")
    assert other["metrics"] == got["metrics"] and len(got["metrics"]) == 2
    assert all(np.isfinite(v) for m in got["metrics"] for v in m.values())
    assert got["state"]["pnp_net.fc_t.weight"].equal(sd["pnp_net.fc_t.weight"])
    for k, w in one["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], w, rtol=1e-4, atol=1e-6, err_msg=k)


def test_ddp_takes_outputs_left_out_of_the_loss(ranks_job):
    """The translation's losses off (JAX's _tiny_setup config): the three
    steps run in 2 ranks (DDP's static graph used to stop at the second:
    its first step reaches fc_t through the output, the later ones did not),
    the ranks log the same global terms, at the first step those of one
    process (rtol 1e-4), and fc_t, which no loss reaches, stays as it was."""
    cfg, sd, batches = unused_output_job()
    one = train_steps(cfg, sd, batches[:1], device="cpu")
    got, other = results(ranks_job, "unused_output")
    assert other["metrics"] == got["metrics"] and len(got["metrics"]) == 3
    assert all(np.isfinite(v) for m in got["metrics"] for v in m.values())
    assert got["state"]["pnp_net.fc_t.weight"].equal(sd["pnp_net.fc_t.weight"])
    for k, w in one["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], w, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def one_do_train(ranks_job):
    """do_train in this process on the ranks' data: the state it returns."""
    np.random.seed(5)
    state, _, _ = trainer.do_train(do_train_cfgs(ranks_job["root"])[1],
                                   max_iters_override=ITERS, device="cpu")
    return state


def test_do_train_on_a_model_axis_matches_one_process(ranks_job, one_do_train):
    """do_train at PARALLEL.MODEL_PARALLEL=2 in the 2 ranks, a (1, 2) grid:
    the losses are the one-process run's (rtol 1e-4, as the data-parallel
    ranks'), and rank 0 writes one process's checkpoint: its keys and whole
    shapes, loadable by load_weights into one process's model."""
    _, one, cfg = do_train_cfgs(ranks_job["root"])
    assert results(ranks_job, "do_train_grid") == [{"step": ITERS, "preempted": False}] * 2
    np.testing.assert_allclose(_losses(cfg.OUTPUT_DIR), _losses(one.OUTPUT_DIR), rtol=1e-4)
    with open(osp.join(cfg.OUTPUT_DIR, "log.rank1.txt")) as f:
        assert "model 1 of 2" in f.read()
    got, want = (torch.load(osp.join(c.OUTPUT_DIR, "ckpt", "model_0000003.pth"),
                            weights_only=True) for c in (cfg, one))
    assert [(k, v.shape) for k, v in got["model"].items()] == [
        (k, v.shape) for k, v in want["model"].items()]
    assert got["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    checkpoint.load_weights(build_model(cfg, device="cpu"), osp.join(cfg.OUTPUT_DIR, "ckpt"))


def test_do_train_two_ranks_match_one_process(ranks_job, one_do_train):
    """Rank 0 writes metrics.json and the checkpoints (state_dict keys
    without DDP's `module.`, loadable by load_weights), every rank its log;
    the losses are the one-process run's at the same global batch of 4."""
    cfg, one, _ = do_train_cfgs(ranks_job["root"])
    state = one_do_train
    assert results(ranks_job, "do_train") == [{"step": ITERS, "preempted": False}] * 2
    got, want = _losses(cfg.OUTPUT_DIR), _losses(one.OUTPUT_DIR)
    assert len(got) == len(want) == ITERS
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert sorted(os.listdir(osp.join(cfg.OUTPUT_DIR, "ckpt"))) == sorted(
        os.listdir(osp.join(one.OUTPUT_DIR, "ckpt")))
    saved = torch.load(osp.join(cfg.OUTPUT_DIR, "ckpt", "model_0000003.pth"), weights_only=True)
    assert list(saved["model"]) == list(state.model.state_dict())
    checkpoint.load_weights(build_model(cfg, device="cpu"),
                            osp.join(cfg.OUTPUT_DIR, "ckpt"))
    for name in ("log.txt", "log.rank1.txt"):
        with open(osp.join(cfg.OUTPUT_DIR, name)) as f:
            assert "rank" in f.read(), name
