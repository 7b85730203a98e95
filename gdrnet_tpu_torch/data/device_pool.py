"""The device-resident training pool (counterpart of
gdrnet_tpu/data/device_pool.py), TRAIN.DEVICE_RESIDENT_POOL: the train set is
mapped once, kept on the card as compact rows, and each step's batch is an
index-select and a decode there.

Why: a mapped GDR-Net ROI is small in compact form (about 224 KiB at 256 / 64
px: uint8 image, f16 xyz, packed mask bits, uint8 regions, ~180 B of
scalars), while the host mapper's cost a visit sets the pace of training
(the reference streams CPU-worker batches every iteration,
core/gdrn_modeling/engine.py:229-239). A set of LM-13's scale (~15k ROIs,
~3.5 GB) fits the card many times over; uploaded once, batches are gathered
on the card, and a background thread re-maps random slots (fresh DZI and
colour draws) and writes them in between steps (PoolRefresher).

Layout under data parallelism (engine/trainer.py): the records are arranged
as JAX arranges them over its mesh's data axis, data rank d owns slots
[d * per, (d + 1) * per), maps, uploads, checks and refreshes only those, and
samples only its own block (pool_index_sampler's block d). On a model axis
with more than one process the pool raises, as JAX's multi-process pool
takes pure data meshes only.

Residuals against the mapper's batch (the envelope of tests/
test_device_pool.py): roi_img through uint8 (at most 0.5 LSB of the
de-normalized image), gt_xyz through f16 (at most 5e-4), gt_xyz_bin
recomputed from the f16 xyz (flips at exact bin boundaries only).
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gdrnet_tpu_torch.data.mapper import read_color_image
from gdrnet_tpu_torch.data.samplers import repeat_factor_training_sampler, training_sampler
from gdrnet_tpu_torch.ops.warp import affine_params_batch
from gdrnet_tpu_torch.parallel import multihost as mh

# checksums are f64 on both sides, so that a torn row of a large pool shows
SUM_RTOL = 1e-7


def _np_abs_sum(v: np.ndarray) -> float:
    """Host-side |sum| checksum in f64."""
    if v.dtype.kind == "u":
        return float(np.sum(v, dtype=np.float64))
    return float(np.sum(np.abs(v.astype(np.float32)), dtype=np.float64))


def _device_abs_sum(t: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """The same checksum of a device tensor, f64, a block of rows at a time
    (bounded scratch memory); a 0-dim tensor on t's device."""
    total = torch.zeros((), dtype=torch.float64, device=t.device)
    for a in range(0, max(t.shape[0], 1), rows):
        part = t[a:a + rows]
        if part.dtype == torch.uint8:
            total += part.sum(dtype=torch.float64)
        else:
            total += part.float().abs().sum(dtype=torch.float64)
    return total


def _sums_match(got: dict, want: dict, rtol: float = SUM_RTOL) -> list:
    return [k for k in want if abs(float(got[k]) - want[k]) > rtol * max(abs(want[k]), 1.0)]


# ---------------------------------------------------------------- encode


def encode_sample(s: dict, pixel_mean, pixel_std) -> dict:
    """Mapper sample -> compact pool row (host numpy). Inverse of _decode_rows."""
    img = np.clip(np.round(s["roi_img"] * pixel_std + pixel_mean), 0, 255)
    masks = (s["gt_mask_trunc"] > 0.5).astype(np.uint8) \
        | ((s["gt_mask_visib"] > 0.5).astype(np.uint8) << 1) \
        | ((s["gt_mask_obj"] > 0.5).astype(np.uint8) << 2)
    return {
        "img_u8": img.astype(np.uint8),
        "xyz_f16": s["gt_xyz"].astype(np.float16),
        "masks_u8": masks,
        "region_u8": s["gt_region"].astype(np.uint8),
        "cls": np.int32(s["roi_classes"]),
        "cams": s["roi_cams"].astype(np.float32),
        "centers": s["roi_centers"].astype(np.float32),
        "whs": s["roi_whs"].astype(np.float32),
        "resize_ratios": np.float32(s["resize_ratios"]),
        "rot": s["gt_ego_rot"].astype(np.float32),
        "trans": s["gt_trans"].astype(np.float32),
        "trans_ratio": s["gt_trans_ratio"].astype(np.float32),
        "im_wh": s["im_wh"].astype(np.float32),
    }


def _decode_rows(rows: dict, points_stack, extents_stack, fps_stack, sym_rots_stack,
                 sym_mask_stack, pixel_mean, pixel_std, *, out_res: int, xyz_bin: int,
                 with_bins: bool, xyz_mask_gt: str) -> dict:
    """Pool rows [B, ...] (tensors) -> the train batch on their device,
    the mapper's tail (data/mapper.GDRNTrainMapper.__call__) from the
    compact row. fps_stack is unused: the regions are stored."""
    del fps_stack
    cls = rows["cls"].long()
    img = (rows["img_u8"].float() - pixel_mean) / pixel_std
    masks = rows["masks_u8"]
    m_trunc = (masks & 1).float()
    m_visib = ((masks >> 1) & 1).float()
    m_obj = ((masks >> 2) & 1).float()
    xyz_norm = rows["xyz_f16"].float()

    # coord_2d recomputed (mapper.roi_coord_2d's closed form)
    centers = rows["centers"]
    scales = out_res / rows["resize_ratios"]
    M_out = affine_params_batch(centers, scales, out_res, inv=True)
    dev = img.device
    dy = torch.arange(out_res, device=dev, dtype=torch.float32)[:, None]
    dx = torch.arange(out_res, device=dev, dtype=torch.float32)[None, :]
    m = M_out[:, :, :, None, None]
    sx = m[:, 0, 0] * dx + m[:, 0, 1] * dy + m[:, 0, 2]
    sy = m[:, 1, 0] * dx + m[:, 1, 1] * dy + m[:, 1, 2]
    w1 = torch.clamp(rows["im_wh"][:, 0] - 1.0, min=1.0)[:, None, None]
    h1 = torch.clamp(rows["im_wh"][:, 1] - 1.0, min=1.0)[:, None, None]
    coord2d = torch.stack([sx / w1, sy / h1], dim=-1)

    if with_bins:
        bins = (torch.clamp(xyz_norm, 0, 0.999999) * xyz_bin).to(torch.int32)
        mk = {"trunc": m_trunc, "visib": m_visib, "obj": m_obj}[xyz_mask_gt]
        bins = torch.where(mk[..., None] == 0,
                           torch.full((), xyz_bin, dtype=torch.int32, device=dev), bins)
    else:
        bins = torch.zeros(xyz_norm.shape[:3] + (3,), dtype=torch.int32, device=dev)

    return {
        "roi_img": img,
        "roi_classes": rows["cls"],
        "roi_coord_2d": coord2d,
        "roi_cams": rows["cams"],
        "roi_centers": centers,
        "roi_whs": rows["whs"],
        "roi_extents": extents_stack[cls],
        "resize_ratios": rows["resize_ratios"],
        "gt_xyz": xyz_norm,
        "gt_xyz_bin": bins,
        "gt_mask_trunc": m_trunc,
        "gt_mask_visib": m_visib,
        "gt_mask_obj": m_obj,
        "gt_region": rows["region_u8"].to(torch.int32),
        "gt_ego_rot": rows["rot"],
        "gt_trans": rows["trans"],
        "gt_trans_ratio": rows["trans_ratio"],
        "gt_points": points_stack[cls],
        "sym_rots": sym_rots_stack[cls],
        "sym_mask": sym_mask_stack[cls],
    }


# ----------------------------------------------------------------- pool


class DevicePool:
    """Maps `records` once, uploads this data rank's compact rows to
    `device`, and serves batches from them.

    make_batch(local_idx): [b] indices into this rank's block (what
    pool_index_sampler yields for block `shard`). Returns the train batch
    on `device`. `stats` holds the build's rows, bytes and seconds."""

    _CHUNK_BYTES = 64 * 2 ** 20
    _UPLOAD_RETRIES = 3

    def __init__(self, cfg, records, mapper, models, device="cuda", seed: int = 0, logger=None,
                 abort_check=None, cache_dir: str | None = None, records2=None,
                 n_shards: int | None = None, shard: int | None = None,
                 num_workers: int = 1):
        if mh.get_world_size() > 1 and mh.model_size() > 1:
            raise NotImplementedError(
                "multi-process DEVICE_RESIDENT_POOL supports pure data meshes only "
                f"(axis model={mh.model_size()})")
        self.device = torch.device(device)
        n_shards = mh.data_size() if n_shards is None else n_shards
        shard = mh.data_rank() if shard is None else shard
        self.n_shards, self.shard = n_shards, shard
        per1 = len(records) // n_shards
        per2 = (len(records2) // n_shards) if records2 else 0
        if records2 and per2 == 0 and logger is not None:
            logger.warning(f"pool: TRAIN2 has only {len(records2)} records "
                           f"for {n_shards} shards; ignoring TRAIN2")
        dropped = (len(records) - per1 * n_shards
                   + (len(records2) - per2 * n_shards if records2 else 0))
        if dropped and logger is not None:
            logger.info(f"pool: dropping {dropped} records to shard evenly over {n_shards}")
        # per-shard layout: [per1 TRAIN slots | per2 TRAIN2 slots], so that the
        # TRAIN2_RATIO mix (reference engine.py:157-165,232-235) stays a
        # decision within a shard
        arranged = []
        for d in range(n_shards):
            arranged += records[d * per1:(d + 1) * per1]
            if per2:
                arranged += records2[d * per2:(d + 1) * per2]
        n_use = len(arranged)
        self.per_shard = per1 + per2
        self.per_shard_ds1 = per1
        self.records = arranged
        self.mapper = mapper
        rh = cfg.MODEL.CDPN.ROT_HEAD
        self._decode_static = dict(
            out_res=cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES, xyz_bin=rh.XYZ_BIN,
            with_bins="CE" in rh.XYZ_LOSS_TYPE, xyz_mask_gt=rh.XYZ_LOSS_MASK_GT)
        self.pixel_mean = np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32)
        self.pixel_std = np.asarray(cfg.MODEL.PIXEL_STD, np.float32)
        self.labels = [models.label_of(r["label"]) for r in self.records]
        self.start = shard * self.per_shard
        self.stop = self.start + self.per_shard
        self._local_ranges = [(self.start, self.stop)]
        dev = self.device
        self._stacks = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            models.points_stack, models.extents_stack, models.fps_stack,
            models.sym_rots_stack, models.sym_mask_stack))
        self._mean = torch.from_numpy(self.pixel_mean).to(dev)
        self._std = torch.from_numpy(self.pixel_std).to(dev)
        self.stats = {"rows": self.per_shard, "from_cache": False, "map_s": 0.0,
                      "cache_load_s": 0.0, "upload_s": 0.0, "nbytes": 0}

        # The mapped rows are cached on disk, keyed by what changes map_row's
        # output: the dataset's identity and contents, the INPUT config, the
        # model's input / output sizes and pixel statistics, and this rank's
        # rows. Not the seed: a resumed run's cached rows are still a valid
        # augmentation draw, and the refresher keeps re-drawing them.
        host, cache_path = None, None
        if cache_dir:
            inp = cfg.INPUT.to_dict() if hasattr(cfg.INPUT, "to_dict") else dict(cfg.INPUT)
            rec_fp = hashlib.sha1("\n".join(
                f"{r.get('rgb_path', '')}|{r.get('xyz_path', '')}|"
                f"{r.get('label', '')}|{r.get('inst_id', '')}|"
                f"{r.get('img_type', 'real')}"  # drives the bg-replace branch
                for r in self.records).encode()).hexdigest()
            key = json.dumps(
                [sorted(cfg.DATASETS.TRAIN), n_use, self._decode_static, inp,
                 int(cfg.MODEL.CDPN.BACKBONE.INPUT_RES), rec_fp, self.pixel_mean.tolist(),
                 self.pixel_std.tolist()], sort_keys=True, default=str)
            key += json.dumps(self._local_ranges)  # this rank's rows
            digest = hashlib.sha1(key.encode()).hexdigest()[:16]
            self._rank = mh.get_rank()
            cache_path = osp.join(cache_dir, f"pool_r{self._rank}_{digest}.npz")
            if osp.isfile(cache_path):
                host = self._load_cache(cache_path, logger)
        self.cache_path = cache_path
        if host is None:
            host = self._fill(seed, logger, abort_check, num_workers)
            if cache_path is not None:
                self._write_cache(host, cache_dir, cache_path, logger)
        self._upload(host, logger)

    # ------------------------------------------------------------ the fill

    def _load_cache(self, path: str, logger) -> dict | None:
        t0 = time.perf_counter()
        if logger is not None:
            logger.info(f"pool: loading mapped cache {path}")
        try:
            with np.load(path) as z:
                host = {k: z[k] for k in z.files}
            if any(v.shape[0] != self.per_shard for v in host.values()):
                raise ValueError(f"rows {[v.shape[0] for v in host.values()]}, "
                                 f"expected {self.per_shard}")
        except Exception as e:  # noqa: BLE001 — a torn or stale cache is remapped
            if logger is not None:
                logger.warning(f"pool: cache load failed ({e}); remapping")
            return None
        self.stats.update(from_cache=True, cache_load_s=time.perf_counter() - t0)
        return host

    def _write_cache(self, host: dict, cache_dir: str, path: str, logger) -> None:
        os.makedirs(cache_dir, exist_ok=True)
        # this rank's stale pools go first (a changed key would leave orphans)
        for old in os.listdir(cache_dir):
            if (old.startswith(f"pool_r{self._rank}_") and old.endswith(".npz")
                    and old != osp.basename(path)):
                os.remove(osp.join(cache_dir, old))
        tmp = path + ".tmp"
        with open(tmp, "wb") as fp:
            np.savez(fp, **host)
        os.replace(tmp, path)
        if logger is not None:
            logger.info(f"pool: cached mapped pool at {path}")

    def _fill(self, seed: int, logger, abort_check, num_workers: int) -> dict:
        """Maps this rank's rows in rgb_path order with the mapper's frame
        cache on (the ROIs of one frame decode it once), on num_workers
        threads, each a contiguous run of that order. A row depends only on
        (seed, slot), not on the visit order or the thread."""
        order = sorted(range(self.start, self.stop), key=lambda i: self.records[i]["rgb_path"])
        if logger is not None:
            logger.info(f"pool: mapping {len(order)} of {len(self.records)} records once "
                        f"on {num_workers} threads ...")
        t0 = time.perf_counter()
        first = self.map_row(order[0], seed)
        host = {k: np.zeros((self.per_shard,) + np.shape(v), np.asarray(v).dtype)
                for k, v in first.items()}
        for k, v in first.items():
            host[k][order[0] - self.start] = v
        done = [1]
        lock = threading.Lock()

        def run(part):
            try:
                for j, i in enumerate(part):
                    if abort_check is not None and j % 64 == 0 and abort_check():
                        raise InterruptedError("pool build aborted (preemption)")
                    row = self.map_row(i, seed)
                    for k, v in row.items():
                        host[k][i - self.start] = v
                    with lock:
                        done[0] += 1
                        if logger is not None and done[0] % 1024 == 0:
                            logger.info(f"pool: mapped {done[0]}/{len(order)}")
            finally:
                self.mapper.clear_frame_cache()

        rest = order[1:]
        n = max(1, min(num_workers, len(rest)))
        parts = [rest[len(rest) * w // n:len(rest) * (w + 1) // n] for w in range(n)]
        self.mapper.frame_cache_max = 4
        try:
            with ThreadPoolExecutor(max_workers=n) as ex:
                for f in [ex.submit(run, p) for p in parts]:
                    f.result()
        finally:
            self.mapper.frame_cache_max = 0
        self.stats["map_s"] = time.perf_counter() - t0
        if logger is not None:
            logger.info(f"pool: mapped {len(order)} rows in {self.stats['map_s']:.1f}s "
                        f"({len(order) / max(self.stats['map_s'], 1e-6):.0f} rows/s)")
        return host

    def map_row(self, slot: int, seed: int) -> dict:
        """Map and encode one record; the rng is keyed by (seed, slot), so a
        refresh with another seed draws fresh augmentations."""
        rec = self.records[slot]
        rng = np.random.RandomState((seed * 1_000_003 + int(slot)) % (2 ** 31))
        s = self.mapper(rec, rng)
        s["im_wh"] = np.asarray(self._im_wh(rec), np.float32)
        return encode_sample(s, self.pixel_mean, self.pixel_std)

    @staticmethod
    def _im_wh(rec) -> tuple:
        # the mapper notes the frame's size on the record as it reads it
        if "im_wh" not in rec:
            img = read_color_image(rec["rgb_path"])
            rec["im_wh"] = (img.shape[1], img.shape[0])
        return rec["im_wh"]

    # ---------------------------------------------------------- the upload

    def _upload_key(self, v: np.ndarray) -> torch.Tensor:
        """One key's rows into a buffer on the device, _CHUNK_BYTES at a
        time: the peak is the final buffer plus one chunk."""
        buf = torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=self.device)
        rows = max(1, self._CHUNK_BYTES // max(v[0].nbytes if len(v) else 1, 1))
        for a in range(0, v.shape[0], rows):
            buf[a:a + rows].copy_(torch.from_numpy(np.ascontiguousarray(v[a:a + rows])))
        return buf

    def _upload(self, host: dict, logger) -> None:
        """Uploads every key, then holds the resident bytes against the
        host's checksums: a mismatched key is uploaded again, up to
        _UPLOAD_RETRIES times, then the pool raises. A pool larger than
        the card's free memory raises before the upload."""
        nbytes = sum(v.nbytes for v in host.values())
        self.stats["nbytes"] = nbytes
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes > free:
                raise MemoryError(f"pool: {nbytes / 2**20:.0f} MiB of rows do not fit in the "
                                  f"{free / 2**20:.0f} MiB free on {self.device}")
        if logger is not None:
            logger.info(f"pool: uploading {nbytes / 2**20:.1f} MiB ({self.per_shard} rows x "
                        f"{nbytes // max(self.per_shard, 1) / 1024:.1f} KiB)")
        want = {k: _np_abs_sum(v) for k, v in host.items()}
        t0 = time.perf_counter()
        self.pool = {k: self._upload_key(v) for k, v in host.items()}
        def check():
            return _sums_match({k: float(_device_abs_sum(self.pool[k])) for k in want}, want)

        bad = check()
        for attempt in range(self._UPLOAD_RETRIES):
            if not bad:
                break
            if logger is not None:
                logger.warning(f"pool: upload checksum mismatch on {bad}, uploading them "
                               f"again (retry {attempt + 1})")
            for k in bad:
                self.pool[k] = self._upload_key(host[k])
            bad = check()
        if bad:
            raise RuntimeError(f"pool upload torn on keys {bad} after "
                               f"{self._UPLOAD_RETRIES} retries; refusing to train")
        self.stats["upload_s"] = time.perf_counter() - t0
        if logger is not None:
            logger.info(f"pool: uploaded and checked in {self.stats['upload_s']:.2f}s")

    # ------------------------------------------------------------ batches

    def make_batch(self, local_idx) -> dict:
        idx = torch.as_tensor(np.asarray(local_idx, np.int64)).to(self.device)
        rows = {k: v.index_select(0, idx) for k, v in self.pool.items()}
        return _decode_rows(rows, *self._stacks, self._mean, self._std, **self._decode_static)

    # ------------------------------------------------------------ refresh

    @property
    def n_refresh_shards(self) -> int:
        """Row ranges this process refreshes: its own block."""
        return len(self._local_ranges)

    def refresh_range(self, shard: int) -> tuple:
        """(global_row_start, global_row_stop) of local refresh shard."""
        return self._local_ranges[shard]

    def read_rows(self, local_idx: np.ndarray) -> dict:
        """A copy of the rows at `local_idx` on the device."""
        idx = torch.as_tensor(np.asarray(local_idx, np.int64)).to(self.device)
        return {k: v.index_select(0, idx) for k, v in self.pool.items()}

    def write_rows(self, local_idx: np.ndarray, rows: dict) -> None:
        """Writes device rows (read_rows' form) back into the slots."""
        idx = torch.as_tensor(np.asarray(local_idx, np.int64)).to(self.device)
        for k, v in self.pool.items():
            v.index_copy_(0, idx, rows[k])

    def _scatter_local(self, idx: torch.Tensor, rows: dict) -> dict:
        """Writes `rows` (device tensors) into slots `idx` and returns the
        read-back |sum| of the slots just written, f64 device scalars (what
        landed, compared with the host's sums on a later drain)."""
        sums = {}
        for k, v in self.pool.items():
            v.index_copy_(0, idx, rows[k])
            sums[k] = _device_abs_sum(v.index_select(0, idx))
        return sums

    def apply_refresh(self, shard: int, local_idx: np.ndarray, rows: dict) -> dict:
        """Replaces slots `local_idx` of local refresh shard `shard` with
        freshly mapped host rows. Returns the read-back checksums (not
        fetched here: the caller compares them with expected_sums(rows) once
        they are ready)."""
        del shard  # one local range
        idx = torch.as_tensor(np.asarray(local_idx, np.int64)).to(self.device)
        dev_rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                    for k, v in rows.items()}
        return self._scatter_local(idx, dev_rows)

    @staticmethod
    def expected_sums(rows: dict) -> dict:
        return {k: _np_abs_sum(v) for k, v in rows.items()}


def pool_index_sampler(pool: DevicePool, batch_size: int, seed: int,
                       sampler_name: str = "TrainingSampler", repeat_thresh: float = 0.0,
                       ratio2: float = 0.0):
    """Infinite [B] int32 streams of shard-local indices, one contiguous
    block of B / n per shard (JAX's streams: the samplers of shard d are
    seeded seed + 7919 d). ratio2 > 0 mixes the TRAIN2 tail of each shard
    ([per_shard_ds1, per_shard)) at that per-element probability; the
    RepeatFactor sampler governs the TRAIN slots only (reference
    data_loader.py:692-708)."""
    n, per = pool.n_shards, pool.per_shard
    per1 = pool.per_shard_ds1
    per2 = per - per1
    if per2 == 0:
        ratio2 = 0.0
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by {n} shards")
    b_local = batch_size // n
    streams, streams2 = [], []
    for d in range(n):
        if sampler_name == "RepeatFactorTrainingSampler":
            labels_d = pool.labels[d * per:d * per + per1]
            streams.append(repeat_factor_training_sampler(
                labels_d, repeat_thresh, seed=seed + d * 7919))
        else:
            streams.append(training_sampler(per1, seed=seed + d * 7919))
        streams2.append(training_sampler(per2, seed=seed + d * 7919 + 13) if per2 else None)
    mix_rng = np.random.RandomState(seed + 424242)
    while True:
        idx = np.empty(batch_size, np.int32)
        for d in range(n):
            for j in range(b_local):
                if ratio2 > 0 and mix_rng.rand() < ratio2:
                    idx[d * b_local + j] = per1 + next(streams2[d])
                else:
                    idx[d * b_local + j] = next(streams[d])
        yield idx


class PoolRefresher:
    """Background re-augmentation: a host thread re-maps random slots of
    this rank's block with fresh seeds, `chunk` rows at a time; the train
    loop's drain() writes ready chunks between steps. Each written chunk's
    slots are read back and held against the host's checksums on a later
    drain: a torn chunk is written again, and a chunk torn twice is dropped,
    its slots restored to their rows from before."""

    def __init__(self, pool: DevicePool, chunk: int = 64, max_queue: int = 4, seed: int = 1,
                 logger=None):
        self.pool = pool
        self.chunk = chunk
        self.q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._seed = seed
        self.refreshed = 0
        self.torn_healed = 0
        self.torn_dropped = 0
        self._logger = logger
        # chunks written, not yet verified:
        # (sums, ready event, expected, shard, local, rows, old rows, attempt)
        self._pending: list = []
        self._thread = threading.Thread(target=self._produce, name="pool-refresh", daemon=True)
        self._thread.start()

    def _produce(self):
        rng = np.random.RandomState(self._seed ^ 0x5EED)
        epoch = 1
        while not self._stop.is_set():
            shard = int(rng.randint(self.pool.n_refresh_shards))
            start, stop = self.pool.refresh_range(shard)
            local = rng.choice(stop - start, size=min(self.chunk, stop - start),
                               replace=False).astype(np.int32)
            rows = []
            for i in local:
                if self._stop.is_set():
                    return
                rows.append(self.pool.map_row(start + int(i), seed=self._seed + epoch))
            stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            epoch += 1
            while not self._stop.is_set():
                try:
                    self.q.put((shard, local, stacked), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def drain(self, max_chunks: int = 1):
        """Writes up to max_chunks ready chunks (call between steps) and
        settles the checksums of earlier ones that are ready."""
        self._settle_pending()
        for _ in range(max_chunks):
            try:
                shard, local, rows = self.q.get_nowait()
            except queue.Empty:
                return
            self._apply(shard, local, rows, attempt=0, old=self.pool.read_rows(local))

    def _apply(self, shard, local, rows, attempt: int, old: dict):
        sums = self.pool.apply_refresh(shard, local, rows)
        ready = None
        if self.pool.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.pool.device))
        self._pending.append((sums, ready, self.pool.expected_sums(rows), shard, local, rows,
                              old, attempt))

    def _settle_pending(self, force: bool = False):
        pending, self._pending = self._pending, []
        still = []
        for item in pending:
            sums, ready, want, shard, local, rows, old, attempt = item
            if not force and ready is not None and not ready.query():
                still.append(item)
                continue
            bad = _sums_match({k: float(s) for k, s in sums.items()}, want)
            if not bad:
                self.refreshed += len(local)
                continue
            if attempt >= 1:
                self.torn_dropped += 1
                self.pool.write_rows(local, old)
                if self._logger is not None:
                    self._logger.warning(f"pool refresh: chunk torn twice on {bad}, dropped")
                continue
            self.torn_healed += 1
            if self._logger is not None:
                self._logger.warning(f"pool refresh: upload torn on {bad}, writing it again")
            self._apply(shard, local, rows, attempt + 1, old)
        self._pending.extend(still)

    def stop(self):
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)
