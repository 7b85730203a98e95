"""Builds the hand-written CUDA kernels and the host code (the JPEG codec,
farthest point sampling), and loads them with ctypes.

Each `<name>.cu` or `<name>.cpp` in this directory has a plain C interface.
At first use a `.cu` is compiled with nvcc for Hopper (sm_90a), a `.cpp`
with g++ for the host, into a shared library under
`<checkout>/build/gdrnet_tpu_torch/`, named by a hash of the source and the
flags, so an edited source builds anew and an unchanged one loads at once.
The host flags hold no -ffast-math and no -march=native, so that the host
code gives the same bytes on every x86-64 machine. Nothing is built when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[1] / "build" / "gdrnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


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


def find_gxx() -> str:
    """g++ on PATH (or $CXX); raises if none."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: the host code of gdrnet_tpu_torch "
                       "(csrc/*.cpp) needs a C++17 compiler to build")


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of `name` and its flags: `<name>.cu` for nvcc, else
    `<name>.cpp` for g++."""
    cu = _SRC_DIR / f"{name}.cu"
    return (cu, NVCC_FLAGS) if cu.is_file() else (_SRC_DIR / f"{name}.cpp", GXX_FLAGS)


def library_path(name: str) -> Path:
    """Where `<name>.cu` / `<name>.cpp` builds to for the current source and flags."""
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `<name>.cu` or `<name>.cpp` unless its library exists; returns
    the library.

    The compiler's output (for nvcc, ptxas register and spill counts
    included) is kept beside the library as `<library>.log`. A failed build
    raises with that output.
    """
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src, flags = _source(name)
    compiler = find_nvcc() if src.suffix == ".cu" else find_gxx()
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed ({proc.returncode}) building "
                           f"{src.name}:\n{' '.join(cmd)}\n{log}")
    Path(f"{out}.log").write_text(log)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build `<name>.cu` / `<name>.cpp` if needed and load its library."""
    return ctypes.CDLL(str(build(name)))
