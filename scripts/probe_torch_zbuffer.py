#!/usr/bin/env python3
"""Probe of the port's z-buffer kernel (gdrnet_tpu_torch/csrc/rasterize_xyz.cu)
on one NVIDIA GPU: where its device time goes, and what a torch.profiler
session costs the launches after it.

1. Builds variants of the kernel source, each with one part switched off by
   a text substitution, and times the device time per rasterize_xyz call of
   each (torch.profiler, 20 calls) at chip_smoke.py's two timed shapes,
   [16 poses, 128^2, tower 448 faces] and [16, 256^2, tower subdivided
   twice, 7168 faces]:
     design           the source as it is
     strided_copy     each thread copies its own face's three 16-byte
                      pieces (48-byte stride) instead of the block copying
                      the chunk's records contiguously
     no_culling       every valid face is tested at every pixel of a tile
     no_raster        copies and culling tests only, no pixel tests
     copy_only        copies and barriers only
   Each variant that computes the render is checked bitwise against the
   plain version.
2. Times bf16 serving of the flagship at B=64 (CUDA events, 30 calls, three
   times) before and after one short torch.profiler session in the same
   process.

Run from the repository root:  python3 scripts/probe_torch_zbuffer.py
It needs one CUDA card and nvcc; the variants build into build/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from gdrnet_tpu_torch import csrc, merged_config  # noqa: E402
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch  # noqa: E402
from gdrnet_tpu_torch.engine.steps import make_predict_step  # noqa: E402
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights  # noqa: E402
from gdrnet_tpu_torch.ops import kernels  # noqa: E402

OUT = REPO / "build" / "probe_torch_zbuffer"
SRC = (Path(csrc.__file__).parent / "rasterize_xyz.cu").read_text()
CONTIGUOUS_COPY = """    const int base = chunk * kChunk;
    const int n = 3 * min(kChunk, nf - base);
    for (int k = tid; k < n; k += kThreads) {
      cp_async16(&stage[chunk & 1][k], gb + 3 * static_cast<size_t>(base) + k);
    }"""
STRIDED_COPY = """    const int f = chunk * kChunk + tid;
    if (f < nf) {
      for (int k = 0; k < 3; ++k) {
        cp_async16(&stage[chunk & 1][3 * tid + k], gb + 3 * static_cast<size_t>(f) + k);
      }
    }"""
CULL = "keep = may_cover(p, q, rx, ry);"
RASTER = "for (int k = 0; k < n_live; ++k) {"
VARIANTS = {
    "design": [],
    "strided_copy": [(CONTIGUOUS_COPY, STRIDED_COPY)],
    "no_culling": [(CULL, "keep = q.w > 0.f;")],
    "no_raster": [(RASTER, "for (int k = 0; k < 0 * n_live; ++k) {")],
    "copy_only": [(CULL, "keep = false;")],
}


def build(name: str, subs: list) -> ctypes.CDLL:
    src = SRC
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([csrc.find_nvcc(), *csrc.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.rasterize_xyz_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.rasterize_xyz_launch.restype = ctypes.c_int
    lib.rasterize_xyz_error_string.argtypes = [ctypes.c_int]
    lib.rasterize_xyz_error_string.restype = ctypes.c_char_p
    return lib


def timed_shapes() -> dict:
    """chip_smoke.py's two timed shapes, with its poses and windows."""
    gsd = cs.mesh_tools()
    _, tower_v, tower_f, _ = gsd.mesh_zoo()[3]
    poses = synthetic_roi_batch(batch_size=16, input_res=32, out_res=8, num_classes=10, seed=50)
    K, R, t = poses["roi_cams"][0], poses["gt_ego_rot"], poses["gt_trans"]
    Ks = np.broadcast_to(K, (16, 3, 3))
    sub_v, sub_f = gsd._subdivide(*gsd._subdivide(tower_v, tower_f))
    return {"16x128x128/tower_448": (cs.raster_args(tower_v, tower_f, Ks, R, t,
                                                    cs.centred_origins(K, t, 128)), 128),
            "16x256x256/tower_subdiv2_7168": (cs.raster_args(sub_v, sub_f, Ks, R, t,
                                                             cs.centred_origins(K, t, 256)), 256)}


def serving_crops_per_s() -> list[float]:
    cfg = merged_config(cs.FLAGSHIP)
    model = init_weights(build_model(cfg, device="cuda"), torch.Generator().manual_seed(0))
    predict = make_predict_step(model)
    res = cfg.MODEL.CDPN.BACKBONE.INPUT_RES, cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES
    batch = cs.to_device(synthetic_roi_batch(batch_size=64, input_res=res[0], out_res=res[1],
                                             num_classes=10, seed=7), "cuda")
    return [64 / float(np.median(cs.cuda_times(lambda: predict(batch), iters=30))) * 1e3
            for _ in range(3)]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_zbuffer: this probe needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # 2 first: the variants' timing opens profiler sessions
    before = serving_crops_per_s()
    x = torch.ones(1024, device="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(10):
            x = x * 2
        torch.cuda.synchronize()
    after = serving_crops_per_s()
    cs.log("serving_around_profiler", batch=64, before_crops_per_s=[round(v, 1) for v in before],
           after_crops_per_s=[round(v, 1) for v in after])

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    results = {}
    for name, lib in libs.items():
        kernels._raster_lib = lambda lib=lib: lib
        for shape, (args, hw) in timed_shapes().items():
            ms = cs.profiled_device_ms(lambda: kernels.rasterize_xyz(*args, hw, hw), 20,
                                       ("", "face_setup_kernel", "zbuffer_kernel"))
            row = {"device_ms_per_call": ms[""], "setup_ms": ms["face_setup_kernel"],
                   "zbuffer_ms": ms["zbuffer_kernel"]}
            if name not in ("no_raster", "copy_only"):
                got, want = kernels.rasterize_xyz(*args, hw, hw), kernels.rasterize_xyz_ref(
                    *args, hw, hw)
                row["bitwise_equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
            results[f"{name}/{shape}"] = row
            cs.log("zbuffer_variant", variant=name, shape=shape,
                   **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in row.items()})
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
