"""The port's host train data path against the JAX package, on the CPU, from
numpy-seeded inputs: samplers, dataset resolution, the cv2 stand-ins
(data/cv_ops.py) against cv2 itself, the colour augmentation DSL,
GDRNTrainMapper and the TrainLoader stream, over tests/fixture_bop.py and a
BOP split that the port writes.

Tolerances: everything is bit for bit (cv_ops.resize_linear against
cv2.resize included), except
- the mapper with on-the-fly XYZ renders: the plain rasterizer against the
  JAX package's, hit masks equal and xyz within 1e-5 m (the bound of
  tests/test_torch_raster.py); the region and bin labels that differ are
  counted and printed.
"""

import dataclasses
import os.path as osp
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from gdrnet_tpu.data import augment as jaug
from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data import dataset_factory as jfactory
from gdrnet_tpu.data import loader as jloader
from gdrnet_tpu.data import mapper as jmapper
from gdrnet_tpu.data import model_store as jmodel_store
from gdrnet_tpu.data import samplers as jsamplers

from gdrnet_tpu_torch.data import augment, bop, cv_ops, dataset_factory, loader, mapper
from gdrnet_tpu_torch.data import model_store, ref_meta, samplers
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch, write_bop_split
from gdrnet_tpu_torch.ops import kernels
from gdrnet_tpu_torch.ops.warp import affine_params
from fixture_bop import build_fixture_dataset
from torch_parity import gen_scale_dataset, small_flagship_cfg

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests gain nothing from intra-op threads, and under pytest-xdist
    each worker's threads would compete for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLAGSHIP_CODE = small_flagship_cfg().INPUT.COLOR_AUG_CODE


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == np.asarray(want).dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


# ---------------------------------------------------------------------------
# samplers and dataset resolution
# ---------------------------------------------------------------------------

SAMPLER_CASES = {
    "training": lambda m: m.training_sampler(37, seed=5),
    "training_shard": lambda m: m.training_sampler(37, shard=1, num_shards=3, seed=5),
    "training_noshuffle": lambda m: m.training_sampler(11, shuffle=False),
    "repeat_factor": lambda m: m.repeat_factor_training_sampler(
        ["a"] * 20 + ["b"] * 3 + ["c"] * 7, 0.3, seed=9),
    "repeat_factor_shard": lambda m: m.repeat_factor_training_sampler(
        ["a"] * 20 + ["b"] * 3, 0.5, shard=1, num_shards=2, seed=2),
    "inference": lambda m: m.inference_sampler(23, shard=2, num_shards=4),
    "batched": lambda m: m.batched(m.training_sampler(13, seed=1), 4),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_samplers_equal_jax(case):
    port, jax_ = SAMPLER_CASES[case](samplers), SAMPLER_CASES[case](jsamplers)
    for _ in range(150):
        try:
            want = next(jax_)
        except StopIteration:
            with pytest.raises(StopIteration):
                next(port)
            return
        assert next(port) == want


@pytest.fixture(scope="module")
def fixture_ds(tmp_path_factory):
    """tests/fixture_bop.py's dataset (xyz_crop pickles, masks) as both
    packages' (meta, records, ObjectModels)."""
    jmeta = build_fixture_dataset(str(tmp_path_factory.mktemp("data_port")), n_images=3, seed=4)
    pmeta = _port_meta(jmeta)
    jrecs = jbop.load_bop_scene_dicts(jmeta, "test", img_type="real")
    precs = bop.load_bop_scene_dicts(pmeta, "test", img_type="real")
    return {"jax": (jmeta, jrecs, jmodel_store.ObjectModels(jmeta, num_pm_points=64,
                                                           num_fps=8)),
            "port": (pmeta, precs, model_store.ObjectModels(pmeta, num_pm_points=64,
                                                           num_fps=8))}


def test_resolve_registered_fixture_equals_jax(fixture_ds):
    (jmeta, jrecs, _), (pmeta, precs, _) = fixture_ds["jax"], fixture_ds["port"]
    jfactory.register("portfix_train", lambda: (jmeta, jrecs))
    dataset_factory.register("portfix_train", lambda: (pmeta, precs))
    (_, want), (_, got) = jfactory.resolve("portfix_train"), dataset_factory.resolve("portfix_train")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.fixture(scope="module")
def zoo_split(tmp_path_factory):
    """A self-describing BOP split written by the port: 2 scenes x 2 images x
    3 instances of the zoo meshes at 160x120, train and test."""
    root = tmp_path_factory.mktemp("zoo_data")
    zoo = gen_scale_dataset().mesh_zoo()
    p = synthetic_roi_batch(batch_size=12, input_res=8, out_res=4, num_classes=10, seed=2)
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32)
    t = p["gt_trans"].copy()
    t[:, :2] = np.random.RandomState(1).uniform(-0.08, 0.08, (12, 2))
    t[:, 2] += 0.6
    for split in ("train", "test"):
        write_bop_split(str(root / "zoo"), zoo, p["roi_classes"], p["gt_ego_rot"], t, K,
                        width=160, height=120, per_image=3, images_per_scene=2, device="cpu",
                        split=split, with_xyz_crop=split == "test")
    return str(root)


@pytest.mark.parametrize("name", ["zoo_train", "zoo_test"])
def test_resolve_self_describing_split_equals_jax(zoo_split, name):
    (jmeta, want), (pmeta, got) = (jfactory.resolve(name, zoo_split, visib_thr=0.1),
                                   dataset_factory.resolve(name, zoo_split, visib_thr=0.1))
    assert pmeta.objects == jmeta.objects and len(got) == len(want) > 6
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert all(osp.exists(r["mask_visib_path"]) for r in got)
    assert all(osp.exists(r["xyz_path"]) == (name == "zoo_test") for r in got)


def test_resolve_render_folders_wait_for_jpeg():
    """The blender / imgn render folders no longer wait for a JPEG decoder:
    they resolve as the JAX package resolves them (tests/test_torch_jpeg.py
    holds them to JAX on a fixture of render folders)."""
    for name in ("lm_blender_13_train", "lm_imgn_13_train_1k_per_obj", "lmo_blender_train"):
        (jmeta, want), (pmeta, got) = (jfactory.resolve(name, "/nonexistent/BOP_DATASETS"),
                                       dataset_factory.resolve(name, "/nonexistent/BOP_DATASETS"))
        assert pmeta.name == jmeta.name and got == want == []


# ---------------------------------------------------------------------------
# cv_ops against cv2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    img = np.ascontiguousarray(np.concatenate([img, cv2.GaussianBlur(img, (9, 9), 3)], 0))
    xyz = rng.randn(240, 160, 3).astype(np.float32)
    mask = (rng.rand(240, 160) > 0.5).astype(np.float32)
    return img, xyz, mask


def test_warp_affine_equals_cv2_on_dzi_crops(frames):
    """Bilinear uint8 and nearest f32 crops of random DZI boxes, a quarter
    of them past the frame's edge, at 64 and 256."""
    img, xyz, mask = frames
    h, w = img.shape[:2]
    rng = np.random.RandomState(1)
    past_edge = 0
    for i in range(40):
        x1, y1 = rng.uniform(-30, w - 5), rng.uniform(-30, h - 5)
        box = [x1, y1, x1 + rng.uniform(4, 120), y1 + rng.uniform(4, 120)]
        center, scale = mapper.dzi_aug_bbox(box, h, w, rng)
        past_edge += (center[0] - scale / 2 < 0) or (center[1] + scale / 2 > h)
        size = (64, 256)[i % 2]
        M = affine_params(center, scale, 0.0, size)
        np.testing.assert_array_equal(cv_ops.warp_affine(img, M, size),
                                      cv2.warpAffine(img, M, (size, size), flags=cv2.INTER_LINEAR))
        for a in (xyz, mask):
            np.testing.assert_array_equal(
                cv_ops.warp_affine(a, M, size, cv_ops.INTER_NEAREST),
                cv2.warpAffine(a, M, (size, size), flags=cv2.INTER_NEAREST))
    assert past_edge >= 5


@pytest.mark.parametrize("sigma", [0.05, 0.3, 0.62, 0.8025, 0.95, 1.0, 1.2])
def test_gaussian_blur_within_one_grey_level_of_cv2(frames, sigma):
    img = frames[0]
    k = augment._blur_size(sigma)
    got = cv_ops.gaussian_blur_u8(img, k, sigma).astype(int)
    want = cv2.GaussianBlur(img, (k, k), sigma).astype(int)
    equal = float((got == want).mean())
    print(f"GaussianBlur sigma {sigma} k {k}: share of equal values {equal:.6f}")
    assert np.abs(got - want).max() <= 1


def test_resizes_median_laplacian_gray_against_cv2(frames):
    img, xyz, mask = frames
    rng = np.random.RandomState(2)
    for _ in range(6):
        grid = rng.randint(0, 2, (rng.randint(2, 13), rng.randint(2, 17))).astype(np.uint8)
        w, h = rng.randint(20, 400), rng.randint(20, 300)
        np.testing.assert_array_equal(cv_ops.resize_nearest(grid, w, h),
                                      cv2.resize(grid, (w, h), interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(cv_ops.resize_linear(img, w, h), cv2.resize(img, (w, h)))
    np.testing.assert_array_equal(cv_ops.median_blur3(xyz), cv2.medianBlur(xyz, 3))
    np.testing.assert_array_equal(cv_ops.laplacian(mask), cv2.Laplacian(mask, cv2.CV_32F))
    np.testing.assert_array_equal(cv_ops.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


# ---------------------------------------------------------------------------
# colour augmentation
# ---------------------------------------------------------------------------

DSL_CASES = [
    "CoarseDropout(p=0.2, size_percent=0.05)",
    "CoarseDropout(p=(0.05, 0.3), size_percent=(0.02, 0.1), per_channel=True)",
    "GaussianBlur(0.8025)",
    "GaussianBlur((0.0, 1.2))",
    "Add((-25, 25), per_channel=0.3)",
    "Multiply((0.6, 1.4), per_channel=0.5)",
    "LinearContrast((0.5, 2.2), per_channel=0.3)",
    "ContrastNormalization((0.5, 1.5))",
    "Invert(0.2, per_channel=True)",
    "Invert(0.5, per_channel=0.4)",
    "AdditiveGaussianNoise(loc=2, scale=(0, 10))",
    "Dropout(p=(0.0, 0.1), per_channel=0.5)",
    "Grayscale(alpha=(0.0, 1.0))",
    "Noop()",
    "OneOf([Add(10), Multiply(1.2), Invert(1.0)])",
    "Sequential([Add(-5), Multiply((0.9, 1.1)), GaussianBlur(0.5)], random_order=True)",
    "Sometimes(0.5, Add((-30, 30)))",
    "AAE",
    "FLAGSHIP",
]


def _dsl(pkg, code: str):
    np.random.seed(7)  # the trap: np.random in a code string draws when it is built
    if code == "AAE":
        return pkg.build_color_augmentor("aae")
    return pkg.build_color_augmentor("code", FLAGSHIP_CODE if code == "FLAGSHIP" else code)


@pytest.mark.parametrize("code", DSL_CASES)
def test_color_aug_dsl_equals_jax(frames, code):
    img = frames[0]
    port, jax_ = _dsl(augment, code), _dsl(jaug, code)
    for seed in range(8):
        _assert_same(port(img, np.random.RandomState(seed)), jax_(img, np.random.RandomState(seed)),
                     f"{code} seed {seed}")


ELEMENTARY = ["aug_brightness_add", "aug_multiply", "aug_contrast", "aug_gaussian_blur",
              "aug_gaussian_noise", "aug_invert_channel", "aug_coarse_dropout"]


@pytest.mark.parametrize("name", ELEMENTARY)
def test_elementary_ops_equal_jax(frames, name):
    for seed in range(5):
        _assert_same(getattr(augment, name)(frames[0], np.random.RandomState(seed)),
                     getattr(jaug, name)(frames[0], np.random.RandomState(seed)), f"{name} {seed}")


def test_what_waits_raises(frames):
    """The ROI10D, SSD and albumentations augmentors no longer wait: equal to
    JAX's (tests/test_torch_color_aug.py holds them on 640x480 frames); the
    geometric DSL ops still raise in both packages."""
    for kind in ("ROI10D", "ssd", "albu"):
        port, jax_ = augment.build_color_augmentor(kind), jaug.build_color_augmentor(kind)
        for seed in range(3):
            _assert_same(port(frames[0], np.random.RandomState(seed)),
                         jax_(frames[0], np.random.RandomState(seed)), f"{kind} {seed}")
    for pkg in (augment, jaug):  # geometric ops would desync the targets
        with pytest.raises(NotImplementedError):
            pkg.parse_aug_code("Affine(rotate=10)")


def test_background_replacer_equals_jax(tmp_path, frames):
    """The gradient fallback, PNG and JPEG backgrounds (aspect-keeping
    resize and TRUNCATE_FG), bit for bit; an unreadable file is cv2's None."""
    img, _, mask = frames
    for i in range(3):
        bg = np.random.RandomState(i).randint(0, 256, (90 + 40 * i, 130, 3)).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"bg{i}.png"), bg)
    cv2.imwrite(str(tmp_path / "bg3.jpg"), img)
    for root in ("/nonexistent", str(tmp_path)):
        port, jax_ = augment.BackgroundReplacer(root), jaug.BackgroundReplacer(root)
        assert port.paths == jax_.paths
        for seed in range(6):
            (pi, pm), (ji, jm) = (r.replace(img, mask, np.random.RandomState(seed), truncate_fg=True)
                                  for r in (port, jax_))
            np.testing.assert_array_equal(pm, jm)
            np.testing.assert_array_equal(pi, ji)
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    assert augment.BackgroundReplacer(str(tmp_path))._read(str(tmp_path / "bad.jpg")) is None


# ---------------------------------------------------------------------------
# the mapper and the loader
# ---------------------------------------------------------------------------


def _mapper_cfg(color_aug_prob=0.7, smooth=False):
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    cfg.DATASETS.SYM_OBJS = ["brick"]
    cfg.INPUT.DZI_TYPE = "uniform"
    cfg.INPUT.COLOR_AUG_PROB = color_aug_prob
    cfg.INPUT.SMOOTH_XYZ = smooth
    return cfg


def _mappers(fixture_ds, cfg):
    np.random.seed(3)
    jm = jmapper.GDRNTrainMapper(cfg, fixture_ds["jax"][2])
    np.random.seed(3)
    pm = mapper.GDRNTrainMapper(cfg, fixture_ds["port"][2], device="cpu")
    return jm, pm


@pytest.mark.parametrize("smooth", [False, True])
def test_mapper_with_xyz_crops_equals_jax(fixture_ds, smooth):
    jm, pm = _mappers(fixture_ds, _mapper_cfg(smooth=smooth))
    jrecs, precs = fixture_ds["jax"][1], fixture_ds["port"][1]
    for i, (jr, pr) in enumerate(zip(jrecs, precs)):
        for seed in (i, 100 + i):
            _assert_same(pm(dict(pr), np.random.RandomState(seed)),
                         jm(dict(jr), np.random.RandomState(seed)), f"record {i} seed {seed}")


def test_mapper_with_renders_against_jax(fixture_ds):
    """No xyz_crop pickle: the port renders with its plain rasterizer on the
    CPU, the JAX package with its own; the rest of the sample follows."""
    jm, pm = _mappers(fixture_ds, _mapper_cfg())
    (pmeta, precs, pmodels) = fixture_ds["port"]
    jrecs = fixture_ds["jax"][1]
    differ = {"gt_region": 0, "gt_xyz_bin": 0}
    before = kernels.rasterize_xyz.launches
    for i, (jr, pr) in enumerate(zip(jrecs, precs)):
        jr, pr = dict(jr, xyz_path=None), dict(pr, xyz_path=None)
        got, want = pm(pr, np.random.RandomState(i)), jm(jr, np.random.RandomState(i))
        extent = pmodels.extents[pr["label"]]
        assert np.abs((got["gt_xyz"] - want["gt_xyz"]) * extent).max() <= 1e-5
        for k in differ:
            differ[k] += int((got[k] != want[k]).sum())
        for k in want:
            if k not in ("gt_xyz", "gt_region", "gt_xyz_bin"):
                _assert_same(got[k], want[k], f"record {i} {k}")
    assert kernels.rasterize_xyz.launches == before  # the CPU takes the plain version
    print(f"labels that differ over {len(precs)} samples: {differ}")
    assert differ["gt_region"] <= 4 and differ["gt_xyz_bin"] <= 12


def test_mapper_jpeg_frame_waits(fixture_ds, tmp_path):
    """A JPEG frame no longer waits: the fixture's first frame written as a
    q90 JPEG maps bit for bit as the JAX mapper maps it."""
    jm, pm = _mappers(fixture_ds, _mapper_cfg())
    jr, pr = fixture_ds["jax"][1][0], fixture_ds["port"][1][0]
    frame = str(tmp_path / "000001.jpg")
    cv2.imwrite(frame, cv2.imread(pr["rgb_path"]), [cv2.IMWRITE_JPEG_QUALITY, 90])
    for seed in (0, 1):
        _assert_same(pm(dict(pr, rgb_path=frame), np.random.RandomState(seed)),
                     jm(dict(jr, rgb_path=frame), np.random.RandomState(seed)), f"seed {seed}")


def test_train_loader_stream_equals_jax(fixture_ds):
    """num_workers=1: the first 3 batches of 4, bit for bit."""
    jm, pm = _mappers(fixture_ds, _mapper_cfg())
    jl = jloader.TrainLoader(fixture_ds["jax"][1], jm, 4, seed=11, num_workers=1)
    pl = loader.TrainLoader(fixture_ds["port"][1], pm, 4, seed=11, num_workers=1)
    jit, pit = iter(jl), iter(pl)
    try:
        for b in range(3):
            _assert_same(next(pit), next(jit), f"batch {b}")
    finally:
        jit.close()
        pit.close()


def test_train_loader_surfaces_mapper_errors(fixture_ds):
    def broken(rec, rng):
        raise ValueError("empty object mask")

    it = iter(loader.TrainLoader(fixture_ds["port"][1], broken, 2, num_workers=2))
    with pytest.raises(ValueError, match="empty object mask"):
        next(it)
    it.close()


def test_train_loader_close_joins_its_threads(fixture_ds):
    """Closing the iterator ends every worker (each after the sample it is
    mapping), so no thread is left inside a mapper at the process's exit."""
    def slow(rec, rng):
        time.sleep(0.05)
        return {"x": np.zeros(1, np.float32)}

    before = set(threading.enumerate())
    it = iter(loader.TrainLoader(fixture_ds["port"][1], slow, 2, num_workers=3))
    next(it)
    workers = {t for t in set(threading.enumerate()) - before if t.name.endswith("(worker)")}
    assert len(workers) == 3
    it.close()
    assert not any(t.is_alive() for t in workers)


def test_launch_count_is_exact_across_threads(monkeypatch):
    """Loader threads bump rasterize_xyz.launches concurrently: the count
    loses no update (a short switch interval forces interleaving). The
    count is restored afterwards, so that tests of the same process that
    read it from 0 are not moved."""
    monkeypatch.setattr(kernels.rasterize_xyz, "launches", kernels.rasterize_xyz.launches)
    start, n = kernels.rasterize_xyz.launches, 20000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels._count_launch(kernels.rasterize_xyz)
                                                    for _ in range(n)]) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.rasterize_xyz.launches == start + 2 * n
