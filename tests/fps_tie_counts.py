"""Counts, for each farthest point sampler of the two packages, the picks
that differ from the numpy FPS (gdrnet_tpu/ops/fps.py:farthest_point_sampling_np)
on clouds whose distances tie exactly and on a random one, on this host's CPU:

  port_device  gdrnet_tpu_torch/ops/fps.farthest_point_sampling_idx (torch, CPU)
  port_cpp     gdrnet_tpu_torch/csrc/fps.cpp (the port's g++ flags)
  jax_device   gdrnet_tpu/ops/fps.farthest_point_sampling_idx (XLA)
  jax_cpp      gdrnet_tpu/csrc/fps/fps.cpp, as gdrnet_tpu/csrc builds it
               (g++ -O3 -march=native -fopenmp)

A pick differs where the index at that step differs; after the first
difference the two samplers follow other paths, so the count says how far
the samples part, not how many ties there were.

    JAX_PLATFORMS=cpu python tests/fps_tie_counts.py [--ks 64 128 256]

prints one JSON line a (cloud, K, init_center, start_idx). chip_smoke.py's
[fps] phase holds the port's samplers to numpy on the card's machine.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def clouds() -> dict:
    from gdrnet_tpu_torch.data.synthetic import cylinder_cloud, lattice_cloud

    return {"lattice_9": lattice_cloud(9), "lattice_17": lattice_cloud(17),
            "cylinder_96x40": cylinder_cloud(96, 40),
            "random_2000": np.random.RandomState(0).rand(2000, 3).astype(np.float32),
            "gaussian_2000": np.random.RandomState(1).randn(2000, 3).astype(np.float32)}


def samplers() -> dict:
    import jax.numpy as jnp
    from gdrnet_tpu.csrc import fps_native_available
    from gdrnet_tpu.ops import fps as jfps

    from gdrnet_tpu_torch.ops import fps

    out = {
        "port_device": lambda p, k, ic, s: fps.farthest_point_sampling_idx(
            p, k, ic, s, device="cpu").numpy(),
        "port_cpp": fps.farthest_point_sampling_cpp_idx,
        "jax_device": lambda p, k, ic, s: np.asarray(
            jfps.farthest_point_sampling_idx(jnp.asarray(p), k, init_center=ic, start_idx=s)),
    }
    if fps_native_available():
        def jax_cpp(p, k, ic, s):
            # its wrapper returns points: map them back to their indices (the
            # clouds' points are distinct)
            got = jfps.farthest_point_sampling_cpp(p, k, init_center=ic, start_idx=s)
            return np.array([np.flatnonzero((p == q).all(1))[0] for q in got])

        out["jax_cpp"] = jax_cpp
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", type=int, nargs="*", default=[64, 128, 256])
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from gdrnet_tpu_torch.ops.fps import farthest_point_sampling_np_idx

    run = samplers()
    for name, pts in clouds().items():
        for k in args.ks:
            for ic, start in ((True, 0), (False, 0), (False, 7)):
                want = farthest_point_sampling_np_idx(pts, k, ic, start)
                row = {"cloud": name, "n": len(pts), "k": k, "init_center": ic,
                       "start_idx": start}
                for s, fn in run.items():
                    row[s] = int((np.asarray(fn(pts, k, ic, start)) != want).sum())
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
