"""The port's scale-run orchestrator (gdrnet_tpu_torch/tools/scale_run.py)
against the root tools/scale_run.py, loaded from its path (it imports no JAX
at module level), on the CPU.

Both modules' paths are pointed at one temporary tree. The stages' names,
order, timeouts and flags are the JAX tool's, each stage running the port's
CLI of the JAX tool's script (the loader bench with the host pipeline only);
their done-predicates turn true on the same files; --dry-run, --only and an
unknown stage behave alike; run_stage over stub commands retries, takes
resume_argv after the first attempt, calls on_rc0, and writes the same
status.jsonl lines as the JAX tool's run_stage (its TPU wait stubbed out);
a partial dataset is wiped before the dataset stage runs again.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest

from gdrnet_tpu_torch.tools import scale_run
from torch_parity import REPO

STATUS_KEYS = {"stage", "attempt", "rc", "ok", "secs", "ts"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_scale_run", REPO / "tools/scale_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tools(tmp_path, monkeypatch):
    """(the JAX tool, the port's tool), both with their paths under tmp_path
    and the JAX tool's chip wait stubbed out."""
    jax_tool = _jax_tool()
    paths = {"REPO": tmp_path, "SYNTH": tmp_path / "datasets/BOP_DATASETS/synth",
             "OUT": tmp_path / "output/gdrn/synth/a6_cPnP_synth",
             "CFG": tmp_path / "configs/gdrn/synth/a6_cPnP_synth.py",
             "LOGDIR": tmp_path / "output/gdrn/synth/scale_run"}
    for mod in (jax_tool, scale_run):
        for name, path in paths.items():
            monkeypatch.setattr(mod, name, str(path))
    monkeypatch.setattr(scale_run, "CKPT_DIR", str(tmp_path / "checkpoints/bench_default"))
    monkeypatch.setattr(jax_tool, "_wait_for_chip", lambda *a, **k: True)
    os.makedirs(paths["LOGDIR"])
    return jax_tool, scale_run


def _program(argv: list) -> tuple[str, list]:
    """(the tool a stage runs, its flags): tools/<x>.py and bench.py of the
    repository, python -m gdrnet_tpu[_torch].<x>."""
    if argv[0] == "bash":  # the bench stage: two commands
        cmds = [c.split() for c in argv[2].split(" && ")]
        return "bash", [_program(c) for c in cmds]
    if argv[1] == "-m":
        return argv[2].split(".", 1)[1], argv[3:]
    return "tools." + os.path.basename(argv[1])[:-3], argv[2:]


def test_stages_equal_the_jax_tool(tools):
    jax_tool, port = tools
    want, got = jax_tool.build_stages(), port.build_stages()
    assert [s.name for s in got] == [s.name for s in want] == [
        "dataset", "insurance", "train", "eval_int8", "eval_dpnp", "bench", "audit",
        "loader_bench", "sweep0", "sweep1", "sweep2", "sweep3", "sweep4"]
    for g, w in zip(got, want):
        assert g.timeout_s == w.timeout_s, g.name
        assert (g.pre is None) == (w.pre is None) and (g.on_rc0 is None) == (w.on_rc0 is None)
        assert (g.resume_argv is None) == (w.resume_argv is None), g.name
        assert g.argv[0] in (sys.executable, "bash")
        g_prog, w_prog = _program(g.argv), _program(w.argv)
        if g.name == "loader_bench":  # the host pipeline is the port's only one
            i = w_prog[1].index("--pipeline")
            assert w_prog[1][i + 1] == "host,device-prep,device-aug,pool"
            w_prog[1][i + 1] = "host"
        assert g_prog == w_prog, g.name
        if g.resume_argv:
            assert _program(g.resume_argv) == _program(w.resume_argv)
    assert got[2].resume_argv[-1] == "--resume"


def _done_files(tmp_path) -> list:
    """Every file (and, as (path, "dir"), directory) a done-predicate reads,
    in the stages' order."""
    out = tmp_path / "output/gdrn/synth/a6_cPnP_synth"
    log = tmp_path / "output/gdrn/synth/scale_run"
    csv = scale_run.CSV
    return ([tmp_path / "datasets/BOP_DATASETS/synth/meta.json",
             tmp_path / "datasets/BOP_DATASETS/synth/test_bboxes/est_dets.json",
             (tmp_path / "checkpoints/bench_default/ckpt", "dir"),
             tmp_path / "checkpoints/bench_default/config.py", log / "train.done",
             out / "eval_int8" / csv, out / "eval_dpnp" / csv, log / "bench.done",
             log / "audit.done", log / "loader_bench.done"]
            + [log / f"sweep{i}.done" for i in range(5)])


def test_done_predicates_read_the_jax_tool_files(tools, tmp_path):
    jax_tool, port = tools
    want, got = jax_tool.build_stages(), port.build_stages()
    assert [s.done() for s in got] == [s.done() for s in want] == [False] * 13
    for path in _done_files(tmp_path):
        if isinstance(path, tuple):
            path = path[0]
            path.mkdir(parents=True)
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text("x\n")
        assert [s.done() for s in got] == [s.done() for s in want], path
    assert all(s.done() for s in got)
    # the train marker is written only once the held-out CSV exists
    (tmp_path / "output/gdrn/synth/scale_run/train.done").unlink()
    got[2].on_rc0()
    assert not got[2].done()
    (tmp_path / "output/gdrn/synth/a6_cPnP_synth" / port.CSV).write_text("x\n")
    got[2].on_rc0()
    assert got[2].done()


def _main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    return out.getvalue()


def test_dry_run_and_only(tools, tmp_path):
    jax_tool, port = tools
    got, want = _main(port, ["--dry-run"]), _main(jax_tool, ["--dry-run"])
    heads = [ln for ln in got.splitlines() if not ln.startswith("  ")]
    assert heads == [ln for ln in want.splitlines() if not ln.startswith("  ")]
    assert len(heads) == 13 and heads[0] == "dataset: done=False timeout=7200s"
    assert "gdrnet_tpu_torch.engine.train" in got and "retry: " in got
    only = _main(port, ["--dry-run", "--only", "train,sweep3"])
    assert [ln.split(":")[0] for ln in only.splitlines() if not ln.startswith("  ")] == [
        "train", "sweep3"]
    assert not (tmp_path / "output/gdrn/synth/scale_run/status.jsonl").exists()
    for mod in (port, jax_tool):
        with pytest.raises(SystemExit, match="unknown stages: \\['nope'\\]"):
            _main(mod, ["--only", "train,nope"])


def _stub_stage(mod, tmp_path, name: str):
    """A stage whose first attempt exits 1 and whose resume command exits 0,
    done once on_rc0 has written its marker."""
    marker = tmp_path / f"{name}.marker"
    calls = []
    return mod.Stage(
        name, [sys.executable, "-c", "import sys; sys.exit(1)"], marker.exists, timeout_s=60,
        pre=lambda: calls.append("pre"),
        resume_argv=[sys.executable, "-c", "print('resumed')"],
        on_rc0=lambda: (calls.append("rc0"), marker.write_text("x"))), calls


def test_run_stage_retries_resumes_and_logs_as_the_jax_tool(tools, tmp_path):
    statuses = {}
    for mod in tools:
        st, calls = _stub_stage(mod, tmp_path, f"stub_{mod.__name__.split('.')[-1]}")
        status = tmp_path / f"{st.name}.jsonl"
        with open(status, "w") as fp, contextlib.redirect_stdout(io.StringIO()):
            assert mod.run_stage(st, 3, fp)
            assert mod.run_stage(st, 3, fp)  # already done: no attempt
        lines = [json.loads(ln) for ln in status.read_text().splitlines()]
        assert all(set(ln) == STATUS_KEYS for ln in lines)
        statuses[mod] = [(ln["attempt"], ln["rc"], ln["ok"]) for ln in lines]
        assert calls == ["pre", "pre", "rc0"]
        log = (tmp_path / "output/gdrn/synth/scale_run" / f"{st.name}.log").read_text()
        assert log.count("===== attempt") == 2 and "resumed" in log
    assert statuses[scale_run] == statuses[tools[0]] == [(1, 1, False), (2, 0, True)]
    # a stage that never gets done fails after max_tries; one past its time is killed
    st = scale_run.Stage("slow", [sys.executable, "-c", "import time; time.sleep(30)"],
                         lambda: False, timeout_s=1)
    with open(tmp_path / "slow.jsonl", "w") as fp, contextlib.redirect_stdout(io.StringIO()):
        assert not scale_run.run_stage(st, 2, fp)
    assert [json.loads(ln)["rc"] for ln in (tmp_path / "slow.jsonl").read_text().splitlines()] == [
        -9, -9]


def test_partial_dataset_is_wiped(tools, tmp_path):
    synth = tmp_path / "datasets/BOP_DATASETS/synth"
    (synth / "train").mkdir(parents=True)
    (synth / "meta.json").write_text("{}")
    dataset = scale_run.build_stages()[0]
    with contextlib.redirect_stdout(io.StringIO()):
        dataset.pre()
    assert not synth.exists()
    (synth / "test_bboxes").mkdir(parents=True)
    (synth / "meta.json").write_text("{}")
    (synth / "test_bboxes/est_dets.json").write_text("{}")
    dataset.pre()
    assert synth.is_dir() and dataset.done()
