"""The port's checkpoints and do_train against the JAX package, on the CPU, in
f32, with the small flagship config (tests/torch_parity.py).

- Checkpoints: a save / resume round trip is bitwise (model, BN buffers,
  Ranger's mu / nu / slow and update counts, the accumulator with
  GRAD_ACCUM_STEPS=2), and 3 steps from the resumed state equal 3 steps
  from the live one, bit for bit (the CPU is deterministic); MAX_TO_KEEP;
  MODEL.WEIGHTS and BACKBONE.PRETRAINED give the port exactly the weights
  that the JAX package's init_model_weights gives through
  utils/torch_convert.
- A 6-iteration trajectory of the JAX package's do_train and the port's
  do_train(device="cpu") on tests/fixture_bop.py from one MODEL.WEIGHTS
  file: total_loss at iteration 0 within 1e-4 relative (one f32 forward of
  two libraries), then within 2e-2 (five Ranger updates at lr 1e-4 through
  ReLU networks whose units near 0 can flip between the two, ROADMAP.md §C;
  measured at most 6.9e-3).
- The trainer's behaviour: SIGTERM checkpoints and a resume continues; the
  TPU placement settings warn and train; what waits raises.
"""

import dataclasses
import json
import os
import os.path as osp
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data import dataset_factory as jfactory
from gdrnet_tpu.engine import checkpoint as jcheckpoint
from gdrnet_tpu.engine import trainer as jtrainer
from gdrnet_tpu.engine.train_state import GDRNTrainState
from gdrnet_tpu.models.gdrn import build_model as jax_build_model
from gdrnet_tpu.solver.optimizers import LookaheadState

from gdrnet_tpu_torch import build_lr_schedule, build_optimizer, create_train_state
from gdrnet_tpu_torch import make_train_step
from gdrnet_tpu_torch.data import bop, dataset_factory, ref_meta
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine import checkpoint, trainer
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch
from fixture_bop import build_fixture_dataset
from torch_parity import init_shapes, randomize, small_flagship_cfg

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests gain nothing from intra-op threads, and under pytest-xdist
    each worker's threads would compete for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


def _batch(seed: int, bs: int = 2) -> dict:
    return synthetic_roi_batch(batch_size=bs, input_res=64, out_res=16, num_classes=10,
                               num_points=64, num_regions=8, seed=seed)


def _port_state(cfg, seed: int = 0):
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-2, 100))
    return create_train_state(model, opt), make_train_step(cfg, model, opt)


def _tensors(state) -> list[torch.Tensor]:
    """Every tensor of the state: the model's state dict, then Ranger's."""
    opt = state.optimizer
    return ([v for v in state.model.state_dict().values()]
            + [t for p in opt._params for t in opt.state[p].values()]
            + list(opt.state["shared"].values()))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_checkpoint_round_trip_and_continuation_are_bitwise(tmp_path, accum):
    cfg = small_flagship_cfg()
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.GRAD_ACCUM_STEPS = accum
    live, step = _port_state(cfg)
    for i in range(3):  # with accum=2 the accumulator holds a gradient now
        step(live, _batch(i), None)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    path = mgr.save(live, 3)
    assert osp.basename(path) == "model_0000003.pth" and mgr.latest_step() == 3
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"model", "optimizer", "iteration"} and saved["iteration"] == 3

    resumed, step2 = _port_state(cfg, seed=1)  # other weights, no optimizer state yet
    resumed, start = mgr.resume_or_load(resumed, resume=True)
    assert start == 3 and resumed.step == 3
    a, b = _tensors(live), _tensors(resumed)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(resumed.optimizer.state["shared"]["count"]) == 3 // accum

    for i in range(3, 6):
        _, m_live = step(live, _batch(i), None)
        _, m_res = step2(resumed, _batch(i), None)
        assert float(m_live["total_loss"]) == float(m_res["total_loss"])
    assert all(torch.equal(x, y) for x, y in zip(_tensors(live), _tensors(resumed)))
    assert mgr.resume_or_load(resumed, resume=False)[1] == 0


def test_checkpoint_keeps_max_to_keep_and_loads_model_only(tmp_path):
    state, _ = _port_state(small_flagship_cfg())
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    for it in (4, 8, 12):
        mgr.save(state, it)
    assert mgr.steps() == [8, 12] and mgr.latest_step() == 12
    with open(tmp_path / "last_checkpoint") as f:
        assert f.read() == "model_0000012.pth"
    sd = checkpoint.load_model_weights(str(tmp_path))
    assert sd.keys() == state.model.state_dict().keys()
    assert all(torch.equal(v, sd[k]) for k, v in state.model.state_dict().items())


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """One reference-layout .pth of seeded weights for the 2-class fixture
    model, {"model": state_dict}, and its flax variables."""
    cfg = _fixture_cfg()
    b = {k: jax.numpy.asarray(v) for k, v in _batch(0).items()}
    b["roi_classes"] = b["roi_classes"] % 2
    params, stats = randomize(init_shapes(jax_build_model(cfg), b["roi_img"],
                                          **{k: b[k] for k in MODEL_KEYS}), seed=17)
    path = str(tmp_path_factory.mktemp("weights") / "ref_model.pth")
    torch.save({"model": jax_to_torch(params, stats)}, path)
    return path, params, stats


def _fixture_cfg():
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    cfg.DATASETS.SYM_OBJS = ["brick"]
    return cfg


def _jax_init(cfg, params, stats):
    """The JAX package's init_model_weights over a state of other weights."""
    other = jax.tree.map(lambda a: a + 1.0, (params, stats))
    jstate = GDRNTrainState(step=np.zeros([], np.int32), params=other[0], batch_stats=other[1],
                            opt_state=None)
    out = jcheckpoint.init_model_weights(cfg, jstate)
    sd = jax_to_torch(jax.tree.map(np.asarray, out.params),
                      jax.tree.map(np.asarray, out.batch_stats))
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def test_model_weights_equal_jax_init(reference_pth):
    path, params, stats = reference_pth
    cfg = _fixture_cfg()
    cfg.MODEL.WEIGHTS = path
    state, _ = _port_state(cfg, seed=5)
    checkpoint.init_model_weights(cfg, state)
    want = _jax_init(cfg, params, stats)
    got = state.model.state_dict()
    assert set(want) == {k for k in got if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _torchvision_resnet(state_dict: dict) -> dict:
    """The port backbone's keys are torchvision's; add the classifier that a
    torchvision .pth carries."""
    sd = {k[len("backbone."):]: v.clone() for k, v in state_dict.items()
          if k.startswith("backbone.") and not k.endswith("num_batches_tracked")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    return sd


def test_backbone_pretrained_equals_jax_init(reference_pth, tmp_path, monkeypatch):
    path, params, stats = reference_pth
    resnet = _torchvision_resnet(torch.load(path, weights_only=True)["model"])
    hub = tmp_path / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    torch.save(resnet, hub / "resnet18-f37072fd.pth")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    cfg = _fixture_cfg()
    cfg.MODEL.CDPN.BACKBONE.PRETRAINED = "torchvision://resnet18"
    state, _ = _port_state(cfg, seed=5)
    head_before = state.model.pnp_net.fc_r.weight.clone()
    checkpoint.init_model_weights(cfg, state)
    got = state.model.state_dict()
    want = _jax_init(cfg, jax.tree.map(lambda a: a + 1.0, params), stats)
    for k, v in resnet.items():
        if not k.startswith("fc."):
            assert torch.equal(got["backbone." + k], v) and torch.equal(want["backbone." + k], v), k
    assert torch.equal(state.model.pnp_net.fc_r.weight, head_before)  # only the backbone
    cfg.MODEL.CDPN.BACKBONE.NUM_LAYERS = 34  # resnet18 weights cannot cover a resnet34
    deeper, _ = _port_state(cfg)
    with pytest.raises(KeyError, match="missing"):
        checkpoint.init_model_weights(cfg, deeper)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="offline"):
        checkpoint.init_model_weights(cfg, deeper)


# ---------------------------------------------------------------------------
# do_train: a trajectory against the JAX package
# ---------------------------------------------------------------------------

ITERS = 6


def _train_cfg(out_dir: str, weights: str):
    cfg = _fixture_cfg()
    cfg.OUTPUT_DIR = out_dir
    cfg.SEED = 3
    cfg.MODEL.WEIGHTS = weights
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-4, weight_decay=0)
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.CHECKPOINT_PERIOD = 1000
    cfg.SOLVER.CHECKPOINT_BY_EPOCH = False
    cfg.DATALOADER.NUM_WORKERS = 1  # a fixed batch order
    cfg.DATASETS.TRAIN = ("trajfix_train",)
    cfg.TRAIN.PRINT_FREQ = 1
    cfg.TRAIN.DEVICE_RESIDENT_POOL = False
    cfg.INPUT.DZI_TYPE = "uniform"
    cfg.INPUT.COLOR_AUG_PROB = 0.5
    cfg.PARALLEL.MESH_SHAPE = (1,)
    return cfg


def _losses(out_dir: str) -> list[float]:
    with open(osp.join(out_dir, "metrics.json")) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["iteration"] for r in rows] == list(range(len(rows)))
    return [r["total_loss"] for r in rows]


@pytest.fixture(scope="module")
def fixture_records(tmp_path_factory):
    jmeta = build_fixture_dataset(str(tmp_path_factory.mktemp("traj")), n_images=6, seed=8)
    pmeta = _port_meta(jmeta)
    jrecs = jbop.load_bop_scene_dicts(jmeta, "test", img_type="real")
    precs = bop.load_bop_scene_dicts(pmeta, "test", img_type="real")
    jfactory.register("trajfix_train", lambda: (jmeta, jrecs))
    dataset_factory.register("trajfix_train", lambda: (pmeta, precs))
    return jrecs, precs


@pytest.fixture(scope="module")
def trajectories(fixture_records, reference_pth, tmp_path_factory):
    out = tmp_path_factory.mktemp("traj_out")
    runs = {}
    for name, do_train, kw in (("jax", jtrainer.do_train, {}),
                               ("port", trainer.do_train, {"device": "cpu"})):
        cfg = _train_cfg(str(out / name), reference_pth[0])
        np.random.seed(5)  # GaussianBlur(1.2*np.random.rand()) draws when the mapper is built
        state, _, preempted = do_train(cfg, max_iters_override=ITERS, **kw)
        assert not preempted
        runs[name] = (state, _losses(cfg.OUTPUT_DIR))
    return runs


def test_do_train_trajectory_matches_jax(trajectories):
    (_, want), (state, got) = trajectories["jax"], trajectories["port"]
    assert len(got) == len(want) == ITERS and state.step == ITERS
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"total_loss JAX {np.round(want, 5).tolist()}, port {np.round(got, 5).tolist()}, "
          f"relative {np.array(rel).round(7).tolist()}")
    assert rel[0] <= 1e-4 and max(rel) <= 2e-2


def test_lookahead_slow_weights_start_from_model_weights(trajectories, reference_pth):
    """Ranger's slow weights start from the loaded MODEL.WEIGHTS in the port
    (as the reference's Ranger takes them at its first step), so the
    Lookahead sync at update 6 pulls the weights toward MODEL.WEIGHTS. The
    JAX package's do_train builds the optimizer state from its random init
    and loads MODEL.WEIGHTS after it (gdrnet_tpu/engine/trainer.py:296-311),
    so its sync pulls them halfway back to that random init (ROADMAP.md
    §C)."""
    _, params, stats = reference_pth
    w0 = jax_to_torch(params, stats)
    jstate = trajectories["jax"][0]
    pstate = trajectories["port"][0]
    names = [k for k, _ in pstate.model.named_parameters()]
    slow = {k: pstate.optimizer.state[p]["slow"] for k, p in pstate.model.named_parameters()}
    look = next(s for s in jax.tree.leaves(jstate.opt_state, is_leaf=lambda x: isinstance(
        x, LookaheadState)) if isinstance(s, LookaheadState))
    jslow = jax_to_torch(jax.tree.map(np.asarray, look.slow))
    jparams = jax_to_torch(jax.tree.map(np.asarray, jstate.params))

    def rel(tree):
        num = sum(float((tree[k].detach() - w0[k]).square().sum()) for k in names)
        return (num / sum(float(w0[k].square().sum()) for k in names)) ** 0.5

    moved = {"port slow": rel(slow), "JAX slow": rel(jslow), "JAX params": rel(jparams),
             "port params": rel(dict(pstate.model.named_parameters()))}
    print("relative L2 distance from MODEL.WEIGHTS after 6 updates: "
          + ", ".join(f"{k} {v:.4f}" for k, v in moved.items()))
    assert moved["port slow"] < 0.05 and moved["port params"] < 0.05
    assert moved["JAX params"] > 0.2


# ---------------------------------------------------------------------------
# the trainer's behaviour
# ---------------------------------------------------------------------------


def test_sigterm_checkpoints_and_resume_continues(fixture_records, reference_pth, tmp_path):
    cfg = _train_cfg(str(tmp_path / "preempt"), reference_pth[0])
    metrics = osp.join(cfg.OUTPUT_DIR, "metrics.json")
    stop = threading.Event()

    def fire_after_first_iteration():
        while not stop.is_set():
            if osp.exists(metrics) and os.path.getsize(metrics) > 0:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.05)

    t = threading.Thread(target=fire_after_first_iteration, daemon=True)
    t.start()
    try:
        state, _, preempted = trainer.do_train(cfg, max_iters_override=500, device="cpu")
    finally:
        stop.set()
        t.join(timeout=10)
    assert preempted and 0 < state.step < 500
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # handlers restored
    mgr = checkpoint.CheckpointManager(osp.join(cfg.OUTPUT_DIR, "ckpt"))
    assert mgr.latest_step() == state.step
    saved = state.step
    state, _, preempted = trainer.do_train(cfg, resume=True, max_iters_override=saved + 2,
                                           device="cpu")
    assert not preempted and state.step == saved + 2
    assert mgr.latest_step() == saved + 2 and len(_losses(cfg.OUTPUT_DIR)) == saved + 2


def test_pool_settings_warn_and_train(fixture_records, reference_pth, tmp_path, caplog):
    cfg = _train_cfg(str(tmp_path / "pool"), reference_pth[0])
    cfg.TRAIN.DEVICE_RESIDENT_POOL = True
    cfg.INPUT.DEVICE_PREPROCESS = True
    state, _, _ = trainer.do_train(cfg, max_iters_override=2, device="cpu")
    assert state.step == 2 and np.all(np.isfinite(_losses(cfg.OUTPUT_DIR)))
    warned = [r.message for r in caplog.records if "TPU placement" in r.message]
    assert len(warned) == 1
    for name in ("TRAIN.DEVICE_RESIDENT_POOL", "TRAIN.POOL_REFRESH", "INPUT.DEVICE_PREPROCESS"):
        assert name in warned[0]


@pytest.mark.parametrize("setting,item", [("TEST.PRECISE_BN.ENABLED", "A12"),
                                          ("TRAIN.VIS_IMG", "A7"),
                                          ("PARALLEL.MESH_SHAPE", "A10")])
def test_what_waits_raises(setting, item, tmp_path):
    cfg = _train_cfg(str(tmp_path), "")
    cfg.set_path(setting, (8,) if setting == "PARALLEL.MESH_SHAPE" else True)
    with pytest.raises(NotImplementedError, match=item):
        trainer.do_train(cfg, max_iters_override=1, device="cpu")
