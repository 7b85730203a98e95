"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each `<name>.cu` in this directory has a plain C interface. At first use it
is compiled with nvcc for Hopper (sm_90a) into a shared library under
`<checkout>/build/gdrnet_tpu_torch/`, named by a hash of the source and the
flags, so an edited source builds anew and an unchanged one loads at once.
Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[1] / "build" / "gdrnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda; raises if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in "
        f"{cuda_home}/bin): the CUDA kernels of gdrnet_tpu_torch need the "
        "CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where `<name>.cu` builds to for the current source and flags."""
    src = _SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `<name>.cu` unless its library exists; returns the library.

    nvcc's output (ptxas register and spill counts included) is kept beside
    the library as `<library>.log`. A failed build raises with that output.
    """
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                           f"{' '.join(cmd)}\n{log}")
    Path(f"{out}.log").write_text(log)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build `<name>.cu` if needed and load its library."""
    return ctypes.CDLL(str(build(name)))
