"""The port's bench leg against the JAX package on the CPU: tools/bench.py
against the repository's bench.py, tools/bench_train.py's three legs, and
engine/profiling.py against gdrnet_tpu/engine/profiling.py.

Sizes: bench.py's own test size (tests/test_tools.py:251-323: ResNet-18,
32x32 crops, 8x8 maps, 4 regions, batch 8, 2 iterations); the step and
the audit on tests/torch_parity.small_flagship_cfg (ResNet-18 at 64x64,
f32) with 64 model points; the loader leg on tests/fixture_bop.py's split.

Tolerances: the two benches' int8 drift fields are each a bf16 forward
against an int8 one of the same weights, in two libraries whose bf16
rounding differs (XLA rounds where it fuses, PyTorch after every op), so
they agree only as far as that: the mean rotation drift within
DRIFT_ROT_REL relative (measured 0.093 relative: 1.1088 degrees in the port
against 1.0148 in JAX) and the largest relative translation drift within
DRIFT_TRANS_ATOL, one and a half steps of the 5-decimal rounding both
benches print it with (measured 3e-5 against 2e-5, one step apart; a path
that left the translations as bf16's would print 0). The audit's forward count equals the
analytic count of its convolutions and linears exactly; XLA's count of the
same forward (cost_analysis) is the analytic count of the taps that fall on
the input plus XLA's elementwise ops, within XLA_ELEMENTWISE_REL of it
(measured 0.65 %: 0.4823 GFLOP against 0.4791; every tap counts 0.6230).
"""

import json
import os
import os.path as osp
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.engine import profiling as jprofiling
from gdrnet_tpu.engine.steps import _model_kwargs as jax_model_kwargs
from gdrnet_tpu.models.gdrn import build_model as jax_build_model

from gdrnet_tpu_torch.data import dataset_factory
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine import profiling, trainer
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.tools import bench, bench_train, export_model
from fixture_bop import build_fixture_dataset
from test_torch_trainer import _port_meta
from torch_parity import FLAGSHIP, REPO, init_shapes, load_port, randomize, small_flagship_cfg

BENCH_CFG = ("MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=32, OUTPUT_RES=8), "
             "ROT_HEAD=dict(NUM_REGIONS=4)))\n")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ckpt"}
INT8_KEYS = {"int8_rot_drift_deg_mean", "int8_trans_rel_drift_max"}
DRIFT_ROT_REL, DRIFT_TRANS_ATOL = 0.15, 1.5e-5
XLA_ELEMENTWISE_REL = 0.02
MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tools/bench.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_weights(tmp_path_factory):
    """bench.py's test config and the port's seeded weights as a
    reference-layout .pth, which the JAX bench converts (torch_convert)."""
    root = tmp_path_factory.mktemp("bench")
    cfg_path = str(root / "bench_cfg.py")
    with open(cfg_path, "w") as f:
        f.write(BENCH_CFG)
    model = init_weights(build_model(bench.bench_config(cfg_path), device="cpu"),
                         torch.Generator().manual_seed(0))
    pth = str(root / "bench.pth")
    torch.save({"model": model.state_dict()}, pth)
    return cfg_path, pth


def _jax_bench(argv, monkeypatch, capsys) -> dict:
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    jax_bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_bench_line_matches_jax_bench(bench_weights, path, monkeypatch, capsys):
    cfg_path, pth = bench_weights
    argv = ["--ckpt", pth, "--config", cfg_path, "--batch", "8", "--iters", "2"]
    argv += ["--bf16"] if path == "bf16" else []
    want = _jax_bench(argv, monkeypatch, capsys)
    got = bench.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want) == BENCH_KEYS | (INT8_KEYS if path == "int8" else set())
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["ckpt"] == want["ckpt"] == pth
    assert all(np.isfinite(got[k]) for k in got if k not in ("metric", "unit", "ckpt"))
    assert got["value"] > 0
    if path == "int8":
        np.testing.assert_allclose(got["int8_rot_drift_deg_mean"],
                                   want["int8_rot_drift_deg_mean"], rtol=DRIFT_ROT_REL)
        print(f"int8 drift, port against JAX: rotation {got['int8_rot_drift_deg_mean']} "
              f"against {want['int8_rot_drift_deg_mean']} degrees, translation "
              f"{got['int8_trans_rel_drift_max']} against {want['int8_trans_rel_drift_max']}")
        assert abs(got["int8_trans_rel_drift_max"]
                   - want["int8_trans_rel_drift_max"]) <= DRIFT_TRANS_ATOL


def test_bench_random_init_warns(bench_weights, capsys):
    cfg_path, _ = bench_weights
    got = bench.main(["--config", cfg_path, "--batch", "4", "--iters", "1", "--bf16",
                      "--fold-bn", "--device", "cpu"])
    assert got["ckpt"] is None and got["value"] > 0
    assert "RANDOM INIT" in capsys.readouterr().err


def test_bench_auto_detects_a_port_checkpoint(bench_weights, tmp_path, monkeypatch, capsys):
    """DEFAULT_CKPTS: a checkpoint directory counts only with last_checkpoint."""
    cfg_path, pth = bench_weights
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    monkeypatch.setattr(bench, "DEFAULT_CKPTS", ((str(ckpt), cfg_path),))
    assert not bench.is_checkpoint(str(ckpt))
    os.symlink(pth, ckpt / "model_0000003.pth")
    (ckpt / "last_checkpoint").write_text("model_0000003.pth")
    got = bench.main(["--batch", "4", "--iters", "1", "--bf16", "--device", "cpu"])
    assert got["ckpt"] == str(ckpt)
    assert "auto-detected trained weights" in capsys.readouterr().err


@pytest.mark.parametrize("tool", [bench, bench_train, export_model])
def test_entry_points_without_cuda_name_device_cpu(tool, tmp_path, monkeypatch):
    """Without a card and without --device cpu each entry point exits
    non-zero, and its message names --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path / "m.pt2")] if tool is export_model else []
    with pytest.raises(SystemExit) as exc:
        tool.main(argv)
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)


# ---------------------------------------------------------------------------
# tools/bench_train.py
# ---------------------------------------------------------------------------


def _small_step_config():
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS = 64
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 13
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-4, weight_decay=0)
    return cfg


def test_step_config_is_the_jax_tools():
    """The step leg's settings are tools/bench_train.py:263-274's."""
    cfg = bench_train.step_config()
    pnp = cfg.MODEL.CDPN.PNP_NET
    assert pnp.WITH_2D_COORD and pnp.REGION_ATTENTION and pnp.PM_NORM_BY_EXTENT
    assert pnp.CENTROID_LW == pnp.Z_LW == 1.0 and pnp.NUM_PM_POINTS == 3000
    assert cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS == 64 and cfg.PARALLEL.DTYPE == "bfloat16"
    assert dict(cfg.SOLVER.OPTIMIZER_CFG) == {"type": "Ranger", "lr": 1e-4, "weight_decay": 0}


def test_bench_train_step_leg_prints_the_jax_metric(monkeypatch):
    monkeypatch.setattr(bench_train, "step_config", _small_step_config)
    rows = bench_train.main(["--batch-sizes", "2,3", "--iters", "1", "--device", "cpu"])
    assert [r["batch"] for r in rows] == [2, 3]
    for r in rows:
        assert set(r) == {"metric", "batch", "value", "unit", "ms_per_step", "loss"}
        assert r["metric"] == "train_rois_per_sec_per_chip" and r["unit"] == "ROIs/s"
        assert r["value"] > 0 and np.isfinite(r["loss"])


@pytest.fixture(scope="module")
def audit(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_train, "step_config", _small_step_config)
        (row,) = bench_train.main(["--audit", "--batch-sizes", "2", "--device", "cpu"])
    return row


def test_audit_counts_equal_the_analytic_count(audit):
    """The forward's count is exactly the analytic count of every kernel
    tap; a step (forward, backward, optimizer) counts more than twice it."""
    assert set(audit) == {"metric", "batch", "step_gflops", "fwd_gflops", "fwd_gflops_on_input",
                          "step_fwd_flop_ratio", "step_eager_gb", "step_aten_ops",
                          "backend"}
    cfg = _small_step_config()
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    batch = bench_train.step_batch(cfg, 2, "cpu")
    run = lambda: make_predict_step(model)(batch)  # noqa: E731
    assert audit["fwd_gflops"] == round(bench_train.analytic_flops(model, run) / 1e9, 3)
    assert audit["fwd_gflops_on_input"] == round(
        bench_train.analytic_flops(model, run, in_bounds=True) / 1e9, 3)
    assert audit["step_gflops"] > 2 * audit["fwd_gflops"]
    assert audit["step_eager_gb"] > 0 and audit["step_aten_ops"] > 100
    assert audit["metric"] == "train_step_mfu_audit" and audit["backend"] == "cpu"


def test_xla_counts_only_the_taps_on_the_input():
    """Why the two counters disagree: on the same small forward, XLA's
    cost_analysis (which adds the elementwise ops) sits near the analytic
    count of the taps that fall on the input, and FlopCounterMode on the
    count of every tap (zero padding and a transposed conv's cropped border
    included)."""
    cfg = small_flagship_cfg()
    batch = synthetic_roi_batch(batch_size=2, input_res=64, out_res=16, num_classes=10)
    jm = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = randomize(init_shapes(jm, jb["roi_img"], **{k: jb[k] for k in MODEL_KEYS}),
                              seed=1)
    variables = {"params": params, "batch_stats": stats}
    fwd = jax.jit(lambda v, b: jm.apply(v, b["roi_img"], **jax_model_kwargs(b), train=False))
    cost = fwd.lower(variables, jb).compile().cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])
    port = load_port(build_model(cfg, device="cpu"), params, stats)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    run = lambda: make_predict_step(port)(tb)  # noqa: E731
    every_tap = bench_train.analytic_flops(port, run)
    on_input = bench_train.analytic_flops(port, run, in_bounds=True)
    assert on_input < 0.8 * every_tap
    assert on_input <= xla <= on_input * (1 + XLA_ELEMENTWISE_REL)


@pytest.fixture(scope="module")
def loader_split(tmp_path_factory):
    """tests/fixture_bop.py's split as the train dataset benchfix_train, and
    a config file: the flagship at the small size, 2 classes."""
    root = tmp_path_factory.mktemp("bench_loader")
    meta = _port_meta(build_fixture_dataset(str(root / "data"), n_images=3, seed=8))
    records = load_bop_scene_dicts(meta, "test")
    dataset_factory.register("benchfix_train", lambda: (meta, records))
    cfg_path = root / "loader_cfg.py"
    cfg_path.write_text(
        f"_base_ = [{FLAGSHIP!r}]\n"
        "MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=64, OUTPUT_RES=16), "
        "ROT_HEAD=dict(NUM_FILTERS=32, NUM_REGIONS=8, NUM_CLASSES=2), "
        "PNP_NET=dict(NUM_PM_POINTS=64, PNP_HEAD_CFG=dict(featdim=32))))\n"
        "PARALLEL = dict(DTYPE='float32')\n"
        "DATASETS = dict(TRAIN=('benchfix_train',), SYM_OBJS=['brick'])\n"
        "TRAIN = dict(DEVICE_RESIDENT_POOL=False, POOL_REFRESH=False)\n")
    return str(cfg_path), len(records)


def test_bench_train_with_loader_runs_the_host_pipeline(loader_split):
    cfg_path, n_records = loader_split
    (row,) = bench_train.main(["--with-loader", "--config-file", cfg_path, "--batch-sizes", "4",
                               "--workers", "2", "--iters", "2", "--device", "cpu"])
    assert set(row) == {"metric", "pipeline", "batch", "workers", "value", "unit", "ms_per_step",
                        "data_ms_per_step", "records", "build_s", "loss"}
    assert row["metric"] == "sustained_train_rois_per_sec" and row["pipeline"] == "host"
    assert row["records"] == n_records and row["batch"] == 4 and row["workers"] == 2
    assert row["value"] > 0 and np.isfinite(row["loss"]) and row["data_ms_per_step"] >= 0


@pytest.mark.parametrize("pipeline", ["device-prep", "device-aug", "pool"])
def test_bench_train_device_pipelines_exit_with_their_reason(loader_split, pipeline, capsys):
    """Each device pipeline runs at the tiny size and prints its JSON line:
    the host pipeline's keys, and the pool's own for the pool."""
    cfg_path, n_records = loader_split
    (row,) = bench_train.main(["--with-loader", "--config-file", cfg_path, "--batch-sizes", "4",
                               "--workers", "2", "--iters", "2", "--pipeline", pipeline,
                               "--device", "cpu"])
    keys = {"metric", "pipeline", "batch", "workers", "value", "unit", "ms_per_step",
            "data_ms_per_step", "records", "build_s", "loss"}
    if pipeline == "pool":
        keys |= {"pool_rows", "pool_mib", "pool_map_s", "pool_upload_s", "refreshed"}
        assert row["pool_rows"] == n_records and row["pool_mib"] > 0
    assert set(row) == keys
    assert row["metric"] == "sustained_train_rois_per_sec" and row["pipeline"] == pipeline
    assert row["value"] > 0 and np.isfinite(row["loss"]) and row["records"] == n_records
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
    with pytest.raises(SystemExit, match="one of host, device-prep, device-aug, pool"):
        bench_train.main(["--with-loader", "--config-file", cfg_path, "--pipeline",
                          "tunnel", "--device", "cpu"])


# ---------------------------------------------------------------------------
# engine/profiling.py
# ---------------------------------------------------------------------------


def _timer_calls(timer):
    for step in range(4):
        timer.start("compute")
        timer.stop()
        timer.start("process")
        timer.stop()
        if step % 2:
            timer.start("compute")
            timer.stop()
        timer.step_done()
    return timer.report()


@pytest.mark.parametrize("warmup", [0, 1, 3, 5])
def test_step_timer_reports_as_jax(warmup, monkeypatch):
    """Both timers under one clock that advances 1, 2, 3, ... seconds a read."""
    reports = []
    for mod in (jprofiling, profiling):
        ticks = iter(range(1000))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(ticks)) ** 1.5)
        reports.append(_timer_calls(mod.StepTimer(warmup=warmup)))
    assert reports[0] == reports[1]
    assert set(reports[1]) == ({"compute_s_per_step", "process_s_per_step"} if warmup < 4
                               else set())


def test_trace_of_no_dir_is_a_no_op(tmp_path):
    with profiling.trace(None) as prof, profiling.annotate("region"):
        torch.ones(3).sum()
    assert prof is None
    with profiling.trace("", device="cpu") as prof:
        pass
    assert prof is None and not os.listdir(tmp_path)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), device="cpu"):
        with profiling.annotate("the_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "the_region" in names and any("mm" in str(n) for n in names)


def test_do_train_profile_window_writes_through_trace(loader_split, tmp_path, monkeypatch):
    """do_train's TRAIN.PROFILE_* window opens engine/profiling.trace at
    PROFILE_START and closes it at PROFILE_STOP: one trace.json."""
    from gdrnet_tpu_torch import merged_config

    opened = []
    real = profiling.trace

    def spy(logdir, device=None, filename="trace.json"):
        opened.append((logdir, str(device), filename, time.perf_counter()))
        return real(logdir, device, filename)

    monkeypatch.setattr(profiling, "trace", spy)
    cfg = merged_config(loader_split[0])
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.TRAIN.PROFILE_DIR = str(tmp_path / "prof")
    cfg.TRAIN.PROFILE_START, cfg.TRAIN.PROFILE_STOP = 1, 2
    state, _, preempted = trainer.do_train(cfg, max_iters_override=3, device="cpu")
    assert not preempted and state.step == 3
    assert [o[:3] for o in opened] == [(cfg.TRAIN.PROFILE_DIR, "cpu", "trace.json")]
    assert osp.isfile(osp.join(cfg.TRAIN.PROFILE_DIR, "trace.json"))
