"""The scale run's orchestrator on the card (the counterpart of
tools/scale_run.py): the port's CLIs as a sequence of resumable stages, each
in a fresh subprocess, so that a crash costs one stage attempt, not the run.

  dataset       gdrnet_tpu_torch.tools.gen_scale_dataset -> datasets/BOP_DATASETS/synth
                (2,000 train + 400 test images)
  insurance     gdrnet_tpu_torch.tools.validate_overfit --save-ckpt checkpoints/bench_default
  train         gdrnet_tpu_torch.engine.train on configs/gdrn/synth/a6_cPnP_synth.py,
                retried with --resume; its held-out do_test writes the BOP19 CSV
  eval_int8     --eval-only with TEST.INT8=True
  eval_dpnp     --eval-only with TEST.USE_PNP=True TEST.DEVICE_PNP=True
  bench         gdrnet_tpu_torch.tools.bench (int8), then --bf16, on the trained weights
  audit         gdrnet_tpu_torch.tools.bench_train --audit --batch-sizes 128,256
  loader_bench  gdrnet_tpu_torch.tools.bench_train --with-loader --pipeline host
  sweep0..4     gdrnet_tpu_torch.tools.validate_scale --seed 0..4

Every stage has a done-predicate, checked before it runs, so running the
orchestrator again after a crash or a preemption goes on where it stopped.
A stage's output goes to <LOGDIR>/<stage>.log and one JSON line a attempt to
<LOGDIR>/status.jsonl ({"stage", "attempt", "rc", "ok", "secs", "ts"}). The
stages run on the card; without one, a stage's CLI exits with its own code
and the stage fails. The paths are the module's constants (REPO, SYNTH, OUT,
CFG, LOGDIR, CKPT_DIR).

Usage:
  python -m gdrnet_tpu_torch.tools.scale_run [--only STAGE[,STAGE..]] [--max-tries N]
      [--dry-run]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time
from typing import Callable

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
SYNTH = osp.join(REPO, "datasets", "BOP_DATASETS", "synth")
OUT = osp.join(REPO, "output", "gdrn", "synth", "a6_cPnP_synth")
CFG = osp.join(REPO, "configs", "gdrn", "synth", "a6_cPnP_synth.py")
LOGDIR = osp.join(REPO, "output", "gdrn", "synth", "scale_run")
CKPT_DIR = osp.join(REPO, "checkpoints", "bench_default")
# the CSV that engine/tester.do_test writes: <meta.name>-test_gdrnet-tpu.csv
CSV = "synth-test_gdrnet-tpu.csv"
PY = sys.executable


class Stage:
    def __init__(self, name: str, argv: list[str], done: Callable[[], bool], timeout_s: int,
                 pre: Callable[[], None] | None = None, resume_argv: list[str] | None = None,
                 on_rc0: Callable[[], None] | None = None):
        self.name = name
        self.argv = argv
        self.done = done
        self.timeout_s = timeout_s
        self.pre = pre                  # run before each attempt
        self.resume_argv = resume_argv  # the argv of the attempts after the first
        self.on_rc0 = on_rc0            # run after an attempt that exits 0


def _module(name: str) -> list[str]:
    return [PY, "-m", f"gdrnet_tpu_torch.{name}"]


def _dataset_done() -> bool:
    return (osp.isfile(osp.join(SYNTH, "meta.json"))
            and osp.isfile(osp.join(SYNTH, "test_bboxes", "est_dets.json")))


def _wipe_partial_dataset() -> None:
    # a generator run cut short leaves a tree that resolves as a malformed
    # dataset; the stage writes it anew
    if osp.isdir(SYNTH) and not _dataset_done():
        print(f"[scale_run] wiping partial dataset at {SYNTH}", flush=True)
        shutil.rmtree(SYNTH)


def _insurance_done() -> bool:
    return (osp.isdir(osp.join(CKPT_DIR, "ckpt"))
            and osp.isfile(osp.join(CKPT_DIR, "config.py")))


def _train_done() -> bool:
    return osp.isfile(osp.join(LOGDIR, "train.done"))


def _mark_train_if_complete() -> None:
    # exit 0 covers both "trained and tested" and "preempted, resume later";
    # only the first writes the held-out CSV
    if osp.isfile(osp.join(OUT, CSV)):
        with open(osp.join(LOGDIR, "train.done"), "w") as fp:
            fp.write(time.ctime() + "\n")


def _eval_done(tag: str) -> bool:
    return osp.isfile(osp.join(OUT, f"eval_{tag}", CSV))


def _marker(tag: str) -> tuple[Callable[[], bool], Callable[[], None]]:
    def path() -> str:
        return osp.join(LOGDIR, f"{tag}.done")

    def done() -> bool:
        return osp.isfile(path())

    def touch() -> None:
        with open(path(), "w") as fp:
            fp.write(time.ctime() + "\n")

    return done, touch


def build_stages() -> list[Stage]:
    train_argv = _module("engine.train") + ["--config-file", CFG]
    eval_base = train_argv + ["--eval-only", f"MODEL.WEIGHTS={osp.join(OUT, 'ckpt')}"]
    bench_done, bench_touch = _marker("bench")
    audit_done, audit_touch = _marker("audit")
    loader_done, loader_touch = _marker("loader_bench")
    sweeps = []
    for seed in range(5):
        s_done, s_touch = _marker(f"sweep{seed}")
        sweeps.append(Stage(f"sweep{seed}",
                            _module("tools.validate_scale") + ["--seed", str(seed)],
                            s_done, timeout_s=2400, on_rc0=s_touch))
    bench = " ".join(_module("tools.bench"))
    return [
        Stage("dataset",
              _module("tools.gen_scale_dataset") + ["--root", SYNTH, "--train-images", "2000",
                                                    "--test-images", "400"],
              _dataset_done, timeout_s=7200, pre=_wipe_partial_dataset),
        Stage("insurance", _module("tools.validate_overfit") + ["--save-ckpt", CKPT_DIR],
              _insurance_done, timeout_s=1500),
        Stage("train", train_argv, _train_done, timeout_s=7200,
              resume_argv=train_argv + ["--resume"], on_rc0=_mark_train_if_complete),
        Stage("eval_int8",
              eval_base + ["TEST.INT8=True", f"OUTPUT_DIR={osp.join(OUT, 'eval_int8')}"],
              lambda: _eval_done("int8"), timeout_s=3600),
        Stage("eval_dpnp",
              eval_base + ["TEST.USE_PNP=True", "TEST.DEVICE_PNP=True",
                           f"OUTPUT_DIR={osp.join(OUT, 'eval_dpnp')}"],
              lambda: _eval_done("dpnp"), timeout_s=3600),
        # int8 then bf16 serving on the trained weights (tools/bench finds
        # OUT/ckpt, the run's cwd being REPO); the JSON lines go to the log
        Stage("bench", ["bash", "-c", f"{bench} && {bench} --bf16"],
              bench_done, timeout_s=2400, on_rc0=bench_touch),
        # the train step's FLOP and byte audit on the card
        Stage("audit", _module("tools.bench_train") + ["--audit", "--batch-sizes", "128,256"],
              audit_done, timeout_s=1800, on_rc0=audit_touch),
        # the host input pipeline on the real data path
        Stage("loader_bench",
              _module("tools.bench_train") + [
                  "--with-loader", "--config-file", CFG, "--batch-sizes", "128", "--iters", "30",
                  "--pipeline", "host", "--workers", "1,2", "--max-records", "1024"],
              loader_done, timeout_s=5400, on_rc0=loader_touch),
    ] + sweeps


def run_stage(st: Stage, max_tries: int, status_fp) -> bool:
    for attempt in range(1, max_tries + 1):
        if st.done():
            print(f"[scale_run] {st.name}: already done", flush=True)
            return True
        if st.pre:
            st.pre()
        argv = st.argv if attempt == 1 or not st.resume_argv else st.resume_argv
        log = osp.join(LOGDIR, f"{st.name}.log")
        print(f"[scale_run] {st.name}: attempt {attempt}/{max_tries} -> {log}", flush=True)
        t0 = time.time()
        with open(log, "a") as lf:
            lf.write(f"\n===== attempt {attempt} {time.ctime()} =====\n")
            lf.write(" ".join(argv) + "\n")
            lf.flush()
            try:
                rc = subprocess.run(argv, stdout=lf, stderr=subprocess.STDOUT,
                                    timeout=st.timeout_s, cwd=REPO).returncode
            except subprocess.TimeoutExpired:
                rc = -9
                lf.write(f"\n[scale_run] KILLED after {st.timeout_s}s\n")
        if rc == 0 and st.on_rc0:
            st.on_rc0()
        ok = st.done()
        status_fp.write(json.dumps({"stage": st.name, "attempt": attempt, "rc": rc, "ok": ok,
                                    "secs": round(time.time() - t0, 1),
                                    "ts": time.time()}) + "\n")
        status_fp.flush()
        print(f"[scale_run] {st.name}: rc={rc} done={ok} ({time.time() - t0:.0f}s)", flush=True)
        if ok:
            return True
    return st.done()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", default=None, help="comma-separated stage subset")
    p.add_argument("--max-tries", type=int, default=3)
    p.add_argument("--dry-run", action="store_true",
                   help="print each stage's argv and done state, run nothing")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    os.makedirs(LOGDIR, exist_ok=True)
    stages = build_stages()
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - {s.name for s in stages}
        if unknown:
            raise SystemExit(f"unknown stages: {sorted(unknown)}")
        stages = [s for s in stages if s.name in keep]
    if args.dry_run:
        for st in stages:
            print(f"{st.name}: done={st.done()} timeout={st.timeout_s}s")
            print("  " + " ".join(st.argv))
            if st.resume_argv:
                print("  retry: " + " ".join(st.resume_argv))
        return
    with open(osp.join(LOGDIR, "status.jsonl"), "a") as status_fp:
        for st in stages:
            if not run_stage(st, args.max_tries, status_fp):
                raise SystemExit(f"[scale_run] stage {st.name} FAILED")
    print("[scale_run] ALL STAGES DONE", flush=True)


if __name__ == "__main__":
    main()
