#!/usr/bin/env python3
"""Probe of the port's host train data path (gdrnet_tpu_torch/data): how long
the mapper takes a sample, where that time goes, and how many samples a
second the threaded TrainLoader gives.

Writes chip_smoke.py's train split (the ten zoo meshes of
tools/gen_scale_dataset.py at 640x480, 8 instances an image) at a smaller
scale into a temporary directory, with xyz_crop pickles (--xyz pickles) or
without them (--xyz render: every sample renders its XYZ ground truth on
--device), then with the flagship config
(configs/gdrn/synth/a6_cPnP_synth.py):
  1. the mapper alone on one thread: ms a sample over --samples samples;
  2. the same under cProfile: the functions with the most own time;
  3. TrainLoader at each --workers count: samples/s over 3 batches of
     --batch after a first one;
  4. data/io.read_png on one frame of the split re-encoded with each PNG
     filter on every row: None (what data/io.write_png writes), Sub (what
     OpenCV 5 writes) and Paeth (what libpng's and PIL's writers choose,
     hence most BOP datasets' files): ms a decode, median of 5.
Times are host-clock times of the machine it runs on.

Run from the repository root:
  python3 scripts/probe_torch_loader.py --device cpu --xyz pickles
  python3 scripts/probe_torch_loader.py --device cuda --xyz render
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import struct
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the split's poses and the train config)
from gdrnet_tpu_torch.data.io import read_png  # noqa: E402
from gdrnet_tpu_torch.data.loader import TrainLoader  # noqa: E402
from gdrnet_tpu_torch.data.synthetic import write_bop_split  # noqa: E402
from gdrnet_tpu_torch.engine.trainer import build_train_objects  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--xyz", choices=("pickles", "render"), default="render")
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--samples", type=int, default=40)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4])
    args = ap.parse_args()

    gsd = chip_smoke.mesh_tools()
    K = gsd.K_DEF.astype(np.float32)
    n = args.images * chip_smoke.LOOP_PER_IMAGE
    classes, R, t = chip_smoke.train_split_poses(n, K, gsd.W_DEF, gsd.H_DEF, seed=400)
    with tempfile.TemporaryDirectory() as root:
        write_bop_split(str(Path(root) / "loop"), gsd.mesh_zoo(), classes, R, t, K, gsd.W_DEF,
                        gsd.H_DEF, chip_smoke.LOOP_PER_IMAGE, args.images, device=args.device,
                        split="train", with_xyz_crop=args.xyz == "pickles")
        cfg = chip_smoke.loop_cfg(root, "")
        _, records, _, _, mapper = build_train_objects(cfg, root, args.device)
        print(f"[split] records={len(records)} size={gsd.W_DEF}x{gsd.H_DEF} xyz={args.xyz} "
              f"device={args.device}", flush=True)

        def map_all():
            for i in range(args.samples):
                mapper(dict(records[i % len(records)]), np.random.RandomState(i))

        map_all()  # warm-up: mesh cache, CUDA context and kernel build
        t0 = time.perf_counter()
        map_all()
        per_ms = (time.perf_counter() - t0) / args.samples * 1e3
        print(f"[mapper] threads=1 samples={args.samples} ms_per_sample={per_ms:.2f}",
              flush=True)
        prof = cProfile.Profile()
        prof.runcall(map_all)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
        print("[mapper_profile]\n" + out.getvalue().split("\n\n", 2)[-1].rstrip(), flush=True)

        for workers in args.workers:
            it = iter(TrainLoader(records, mapper, args.batch, num_workers=workers, seed=1))
            try:
                next(it)
                t0 = time.perf_counter()
                for _ in range(3):
                    next(it)
                rate = 3 * args.batch / (time.perf_counter() - t0)
            finally:
                it.close()
            print(f"[loader] workers={workers} batch={args.batch} samples_per_s={rate:.1f}",
                  flush=True)

        frame = read_png(records[0]["rgb_path"])
        ms = {}
        for name, ftype in (("none", 0), ("sub", 1), ("paeth", 4)):
            path = str(Path(root) / f"frame_{name}.png")
            with open(path, "wb") as f:
                f.write(png_filtered(frame, ftype))
            if not np.array_equal(read_png(path), frame):
                raise AssertionError(f"read_png: the {name}-filtered frame reads back wrong")
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                read_png(path)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = f"{np.median(times):.2f}"
        print(f"[png] size={frame.shape[1]}x{frame.shape[0]} channels={frame.shape[2]} "
              + " ".join(f"{k}_ms={v}" for k, v in ms.items()), flush=True)
    return 0


def png_filtered(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit RGB PNG of img [H, W, 3] whose every row uses PNG filter
    ftype: 0 None, 1 Sub, 4 Paeth."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    left = np.pad(x, ((0, 0), (3, 0)))[:, :-3]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (3, 0)))[:, :-3]
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    else:
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.concatenate([np.full((h, 1), ftype, np.uint8), ((x - pred) % 256).astype(np.uint8)],
                          axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


if __name__ == "__main__":
    sys.exit(main())
