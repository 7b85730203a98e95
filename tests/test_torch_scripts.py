"""The port's shell entry points (scripts/train_gdrn_torch.sh and
scripts/test_gdrn_torch.sh, the counterparts of scripts/train_gdrn.sh and
scripts/test_gdrn.sh): each execs the port's engine.train CLI with the
JAX scripts' arguments."""

import os
import subprocess
import sys

import pytest

from torch_parity import REPO

FLAGSHIP = "configs/gdrn/synth/a6_cPnP_synth.py"
# a `python` that prints its arguments, one a line
ECHO_PYTHON = '#!/usr/bin/env bash\nprintf "%s\\n" "$@"\n'


def _run(script: str, args: list, path: str) -> subprocess.CompletedProcess:
    return subprocess.run(["bash", f"scripts/{script}", *args], capture_output=True, text=True,
                          timeout=120, cwd=REPO,
                          env=dict(os.environ, PATH=path + os.pathsep + os.environ["PATH"]))


def test_train_script_shows_the_ports_cli_help():
    proc = _run("train_gdrn_torch.sh", [FLAGSHIP, "--help"], os.path.dirname(sys.executable))
    assert proc.returncode == 0, proc.stderr
    assert "GDR-Net (PyTorch port)" in proc.stdout and "--config-file" in proc.stdout


@pytest.mark.parametrize("script,args,want", [
    ("train_gdrn_torch.sh", [FLAGSHIP, "SOLVER.MAX_ITER=2"],
     ["--config-file", FLAGSHIP, "SOLVER.MAX_ITER=2"]),
    ("test_gdrn_torch.sh", [FLAGSHIP, "output/ckpt", "TEST.USE_PNP=True"],
     ["--config-file", FLAGSHIP, "--eval-only", "MODEL.WEIGHTS=output/ckpt",
      "TEST.USE_PNP=True"]),
])
def test_script_passes_its_arguments_to_the_ports_cli(tmp_path, script, args, want):
    fake = tmp_path / "python"
    fake.write_text(ECHO_PYTHON)
    fake.chmod(0o755)
    proc = _run(script, args, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["-m", "gdrnet_tpu_torch.engine.train", *want]
