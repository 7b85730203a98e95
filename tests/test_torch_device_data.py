"""The port's device-side training and test input against the JAX package, on
the CPU, from numpy-seeded inputs: the batched warps (ops/warp.py), the
colour jitter (data/device_augment.py), the device pipeline
(data/device_pipeline.py), the raw train mapper and the device test mapper,
synthetic_raw_batch, the device pool, its sampler and refresher
(data/device_pool.py), and do_train with the pool and with device
preprocessing.

JAX's random streams cannot be drawn by torch, so the draw halves of the
port's ops take JaxKey below: a key with JAX's split / fold_in that draws
with jax.random, so that the port's apply halves see JAX's own draws.

Tolerances (JAX's own where it states one: tests/test_device_pool.py:58-91,
tests/test_device_pipeline.py:54-101,190-216):
- warps and pipeline: f32 within 1e-5 of JAX's jitted functions (the form
  JAX runs them in; XLA fuses a * b + c into one rounding there, and the
  port rounds those sums once too), nearest and region results equal. The
  general (gather) warp is held against JAX op by op: jitted, XLA fuses its
  source coordinates m00 x + m01 y + m02 into multiply-adds grouped
  differently from one vector lane to the next, which no fixed order
  reproduces (one rounding of the coordinate, 1.3e-5 of a unit-range noise
  image at most);
- colour ops: within 1e-4 in 0..255. The composite pipelines with a
  GaussianBlur (aae, the DSL codes) within COMPOSITE_ATOL: XLA's
  convolution sums its taps in an order the port does not reproduce (the
  blur alone within 1e-4), and the Multiply and LinearContrast after it
  scale that difference by up to 1.4 * 1.4 * 2.2;
- the pool batch against the port's mapper: JAX's envelope (image 0.5 LSB,
  xyz 5e-4, masks / region / classes exact, geometry 1e-5, bins > 0.999).
"""

import dataclasses
import json
import os
import os.path as osp
import time
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data import device_augment as jaug
from gdrnet_tpu.data import device_pipeline as jpipe
from gdrnet_tpu.data import device_pool as jpool
from gdrnet_tpu.data import mapper as jmapper
from gdrnet_tpu.data import model_store as jmodel_store
from gdrnet_tpu.data.synthetic import synthetic_raw_batch as jax_raw_batch
from gdrnet_tpu.ops import warp as jwarp

from gdrnet_tpu_torch.data import bop, dataset_factory, device_augment as aug
from gdrnet_tpu_torch.data import device_pipeline as pipe, device_pool, mapper
from gdrnet_tpu_torch.data import model_store, ref_meta
from gdrnet_tpu_torch.data.synthetic import synthetic_raw_batch
from gdrnet_tpu_torch.engine import trainer
from gdrnet_tpu_torch.ops import warp
from fixture_bop import build_fixture_dataset
from torch_parity import small_flagship_cfg

COMPOSITE_ATOL = 1e-4 * 1.4 * 1.4 * 2.2
STACK_KEYS = ("points_stack", "extents_stack", "fps_stack", "sym_rots_stack", "sym_mask_stack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxKey:
    """A draw half's key that draws JAX's numbers: jax.random's split,
    fold_in and distributions on a JAX key, as torch tensors."""

    def __init__(self, key):
        self.key = key

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def uniform(self, shape, lo=0.0, hi=1.0):
        return _t(jax.random.uniform(self.key, shape, minval=lo, maxval=hi))

    def bernoulli(self, p, shape):
        return _t(jax.random.bernoulli(self.key, p, shape))

    def normal(self, shape):
        return _t(jax.random.normal(self.key, shape))

    def randint(self, shape, lo, hi):
        return _t(jax.random.randint(self.key, shape, lo, hi)).long()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _n(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


# ---------------------------------------------------------------------------
# ops/warp.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    """5 frames of 96x128: f32 in [0, 1) and uint8; square ROIs whose
    centres reach 10 px past the frame, with rotations for the gather path."""
    rng = np.random.RandomState(0)
    B, H, W = 5, 96, 128
    return {"f32": rng.rand(B, H, W, 3).astype(np.float32),
            "u8": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
            "centers": np.stack([rng.uniform(-10, W + 10, B),
                                 rng.uniform(-10, H + 10, B)], 1).astype(np.float32),
            "scales": rng.uniform(10, 150, B).astype(np.float32),
            "rot": rng.uniform(-60, 60, B).astype(np.float32)}


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("rotated", [False, True])
def test_affine_params_batch_and_apply_equal_jax(frames, inv, rotated):
    rot = frames["rot"] if rotated else None
    want = np.asarray(jax.jit(partial(jwarp.affine_params_batch, output_size=64, inv=inv))(
        frames["centers"], frames["scales"], rot_deg=rot))
    got = warp.affine_params_batch(_t(frames["centers"]), _t(frames["scales"]), 64,
                                   None if rot is None else _t(rot), inv=inv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    pts = np.random.RandomState(1).uniform(-20, 150, (5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(warp.affine_apply(_t(pts), _t(want)).numpy(),
                               np.asarray(jax.jit(jwarp.affine_apply)(pts, want)),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("path", ["rotated", "gather", "axis_aligned"])
def test_warp_affine_batch_equals_jax(frames, dtype, interp, path):
    rot = frames["rot"] if path == "rotated" else None
    M = np.asarray(jax.jit(partial(jwarp.affine_params_batch, output_size=64, inv=True))(
        frames["centers"], frames["scales"], rot_deg=rot))
    aa = path == "axis_aligned"
    fn = partial(jwarp.warp_affine_batch, out_hw=(64, 48), interp=interp, axis_aligned=aa)
    want = np.asarray((jax.jit(fn) if aa else fn)(frames[dtype], M))
    got = warp.warp_affine_batch(_t(frames[dtype]), _t(M), (64, 48), interp, aa).numpy()
    assert got.dtype == want.dtype
    if interp == "nearest":
        np.testing.assert_array_equal(got, want)
    else:  # 1e-5 of the value range
        scale = 255.0 if dtype == "u8" else 1.0
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)
    assert (want == 0).any()  # some taps fall outside the frame


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_crop_resize_equals_jax(frames, interp):
    c, s, img = frames["centers"], frames["scales"], frames["f32"]
    want = np.asarray(jax.jit(partial(jwarp.crop_resize_batch, out_size=32, interp=interp))(
        img, c, s))
    got = warp.crop_resize_batch(_t(img), _t(c), _t(s), 32, interp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want = np.asarray(jax.jit(partial(jwarp.crop_resize_from_single_image, out_size=32,
                                      interp=interp))(img[0], c, s))
    got = warp.crop_resize_from_single_image(_t(img[0]), _t(c), _t(s), 32, interp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_coord_maps_regions_and_masks_equal_jax():
    for fmt in ("HWC", "CHW"):
        np.testing.assert_allclose(warp.get_2d_coord(13, 7, fmt=fmt).numpy(),
                                   np.asarray(jwarp.get_2d_coord(13, 7, fmt=fmt)), atol=1e-6)
    rng = np.random.RandomState(2)
    xyz = ((rng.rand(4, 16, 16, 3) - 0.5) * 0.1).astype(np.float32)
    xyz[:, :5] = 0
    fps = ((rng.rand(4, 8, 3) - 0.5) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(warp.xyz_to_region(_t(xyz), _t(fps)).numpy(),
                                  np.asarray(jax.jit(jwarp.xyz_to_region)(xyz, fps)))
    np.testing.assert_array_equal(warp.mask_from_xyz(_t(xyz)).numpy(),
                                  np.asarray(jwarp.mask_from_xyz(xyz)))


# ---------------------------------------------------------------------------
# data/device_augment.py
# ---------------------------------------------------------------------------

OPS = {
    "add": (jaug.add_batch, aug.add_batch, {}),
    "multiply": (jaug.multiply_batch, aug.multiply_batch, {}),
    "linear_contrast": (jaug.linear_contrast_batch, aug.linear_contrast_batch, {}),
    "invert": (jaug.invert_batch, aug.invert_batch, {"p": 0.5, "per_channel": 0.5}),
    "additive_gaussian_noise": (jaug.additive_gaussian_noise_batch,
                                aug.additive_gaussian_noise_batch, {"loc": (-3, 3)}),
    "dropout": (jaug.dropout_batch, aug.dropout_batch, {"p": (0.05, 0.3), "per_channel": 0.5}),
    "grayscale": (jaug.grayscale_batch, aug.grayscale_batch, {"alpha": (0.2, 1.0)}),
    "coarse_dropout": (jaug.coarse_dropout_batch, aug.coarse_dropout_batch,
                       {"p": (0.1, 0.4), "size_percent": 0.2}),
    "saturation": (jaug.saturation_batch, aug.saturation_batch, {}),
    "gaussian_blur": (jaug.gaussian_blur_batch, aug.gaussian_blur_batch,
                      {"sigma_lo": 0.3, "sigma_hi": 2.5}),
    "roi10d": (jaug.roi10d_aug_batch, aug.roi10d_aug_batch, {}),
}


@pytest.fixture(scope="module")
def aug_imgs():
    return np.random.RandomState(3).randint(0, 256, (6, 24, 20, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(OPS))
def test_color_op_apply_half_equals_jax(aug_imgs, name):
    jf, pf, kw = OPS[name]
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jf(key, jnp.asarray(aug_imgs), **kw))
        got = pf(JaxKey(key), _t(aug_imgs), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=f"{name} {seed}")


def _flagship_code() -> str:
    return small_flagship_cfg().INPUT.COLOR_AUG_CODE


@pytest.mark.parametrize("which", ["aae", "sometimes", "flagship_code", "dsl_ops"])
def test_composite_jitter_equals_jax(aug_imgs, which):
    """aae_aug_batch, _sometimes and the DSL: the same draws give JAX's
    images, so the parse builds JAX's op list (order, keys, parameters)."""
    dsl = ("Sequential([OneOf([Add((-9, 9)), Grayscale((0.1, 0.6)), Noop()]), "
           "Sometimes(0.6, Dropout((0.02, 0.2), per_channel=0.5)), "
           "AdditiveGaussianNoise(scale=(0, 6)), Invert(0.3), "
           "ContrastNormalization((0.7, 1.3), per_channel=0.4), CoarseDropout(0.2, 0.1)])")
    for seed in range(3):
        key = jax.random.PRNGKey(10 + seed)
        imgs = jnp.asarray(aug_imgs)
        if which == "aae":
            want, got = jaug.aae_aug_batch(key, imgs), aug.aae_aug_batch(JaxKey(key), _t(aug_imgs))
        elif which == "sometimes":
            want = jaug._sometimes(key, 0.5, imgs, partial(jaug.add_batch, lo=-40.0, hi=40.0))
            got = aug._sometimes(JaxKey(key), 0.5, _t(aug_imgs), aug.add_op(-40.0, 40.0))
        else:
            code = _flagship_code() if which == "flagship_code" else dsl
            np.random.seed(seed)  # the code's np.random expressions are drawn at parse
            jop = jaug.parse_device_aug_code(code, "bgr")
            np.random.seed(seed)
            pop = aug.parse_device_aug_code(code, "bgr")
            want, got = jop(key, imgs), pop(JaxKey(key), _t(aug_imgs))
        np.testing.assert_allclose(_n(got), np.asarray(want), rtol=0, atol=COMPOSITE_ATOL,
                                   err_msg=f"{which} {seed}")


def test_dsl_refusals_equal_jax():
    for code in ("Sequential([Affine(rotate=10)])", "Fliplr(0.5)",
                 "Sequential([Add(3)], random_order=True)"):
        with pytest.raises(NotImplementedError) as want:
            jaug.parse_device_aug_code(code)
        with pytest.raises(NotImplementedError) as got:
            aug.parse_device_aug_code(code)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("aug_type", ["aae", "code", "roi10d"])
def test_color_aug_gate_equals_jax(aug_imgs, aug_type):
    """apply_color_aug_batch: prob and aug_ok gate each image as in JAX;
    gated-off images come out untouched."""
    ok = np.array([1, 1, 0, 1, 0, 1], np.uint8)
    code = _flagship_code() if aug_type == "code" else None
    key = jax.random.PRNGKey(4)
    np.random.seed(0)
    want = np.asarray(jaug.apply_color_aug_batch(key, jnp.asarray(aug_imgs), jnp.asarray(ok),
                                                 aug_type=aug_type, prob=0.8, aug_code=code))
    np.random.seed(0)
    got = aug.apply_color_aug_batch(JaxKey(key), _t(aug_imgs), _t(ok), aug_type=aug_type,
                                    prob=0.8, aug_code=code).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=COMPOSITE_ATOL)
    np.testing.assert_array_equal(got[ok == 0], aug_imgs[ok == 0])
    assert aug.apply_color_aug_batch(None, _t(aug_imgs), _t(ok), prob=0.0) is not None
    with pytest.raises(ValueError) as err:
        aug.apply_color_aug_batch(JaxKey(key), _t(aug_imgs), _t(ok), aug_type="ssd", prob=0.5)
    assert "aae/code/roi10d" in str(err.value)


def _within(count: float, n: int, p: float) -> bool:
    return abs(count - n * p) <= 3 * np.sqrt(n * p * (1 - p)) + 1e-9


def test_torch_draws_fall_in_jax_ranges():
    """Over 2,048 images from the port's own generator: every per-image
    parameter lies in its JAX range; the shares of applied Sometimes and of
    per-channel draws are within 3 sigma of their probability."""
    n, shape = 2048, (2048, 4, 4, 3)
    key = aug.TorchKey(torch.Generator().manual_seed(0))
    d = aug.add_op(-25.0, 25.0, 0.3).draw(key, shape)["v"]
    assert d.min() >= -25.0 and d.max() < 25.0
    per_channel = (d[:, 0] != d[:, 1]).sum().item()
    assert _within(per_channel, n, 0.3), per_channel
    for op, name, lo, hi in ((aug.multiply_op(0.6, 1.4, 0.5), "v", 0.6, 1.4),
                             (aug.linear_contrast_op(0.5, 2.2, 0.3), "a", 0.5, 2.2),
                             (aug.saturation_op(0.6, 1.4), "f", 0.6, 1.4),
                             (aug.gaussian_blur_op(1.2, 0.0), "sigma", 0.0, 1.2),
                             (aug.grayscale_op((0.2, 0.9)), "a", 0.2, 0.9)):
        v = op.draw(key, shape)[name]
        assert v.min() >= lo and v.max() < hi, name
    r = aug.roi10d_aug_op().draw(key, shape)
    assert r["v"].abs().max() < 18.0 and ((r["a"] >= 0.6) & (r["a"] < 1.4)).all()
    s = aug.sometimes(0.3, aug.add_op()).draw(key, shape)
    assert _within(s["apply"].sum().item(), n, 0.3)
    flip = aug.invert_op(0.2, per_channel=True).draw(key, shape)["flip"]
    assert _within(flip.sum().item(), 3 * n, 0.2)
    gate = key.bernoulli(0.5, (n,))
    assert _within(gate.sum().item(), n, 0.5)
    sel = aug.one_of([aug.add_op(), aug.invert_op(), aug.saturation_op()]).draw(key, shape)["sel"]
    for i in range(3):
        assert _within((sel == i).sum().item(), n, 1 / 3)


# ---------------------------------------------------------------------------
# data/device_pipeline.py and synthetic_raw_batch
# ---------------------------------------------------------------------------


def _raw(seed=3, b=6):
    raw, stacks = synthetic_raw_batch(b, seed=seed)
    jr, js = jax_raw_batch(b, seed=seed)
    for k in jr:
        np.testing.assert_array_equal(raw[k], jr[k], err_msg=k)
        assert raw[k].dtype == jr[k].dtype
    for k in js:
        np.testing.assert_array_equal(stacks[k], js[k], err_msg=k)
    return raw, stacks


def _compare_batches(got: dict, want: dict, f32_atol: float = 1e-5):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), _n(got[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if w.dtype.kind in "iub" or k.startswith("gt_mask"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=f32_atol, err_msg=k)


@pytest.mark.parametrize("dzi", ["none", "uniform", "roi10d"])
def test_device_roi_pipeline_equals_jax(dzi):
    raw, stacks = _raw()
    cls = raw["roi_classes"]
    args = [raw["image"], raw["xyz"].astype(np.float32), raw["mask_visib"], raw["bbox"],
            raw["gt_ego_rot"], raw["gt_trans"], raw["roi_cams"],
            stacks["extents_stack"][cls], stacks["fps_stack"][cls],
            np.zeros(3, np.float32), np.full(3, 255.0, np.float32)]
    for bins in (False, True):
        kw = dict(input_res=64, out_res=16, xyz_bin=16, with_bins=bins, dzi_type=dzi)
        key = jax.random.PRNGKey(7)
        want = jpipe.device_roi_pipeline(key, *map(jnp.asarray, args), **kw)
        got = pipe.device_roi_pipeline(JaxKey(key), *map(_t, args), **kw)
        _compare_batches(got, want)
    with pytest.raises(NotImplementedError):
        pipe.dzi_draw(JaxKey(key), 2, "truncnorm")


def test_device_train_batch_with_code_jitter_equals_jax():
    raw, stacks = _raw(seed=5, b=8)
    mean, std = np.zeros(3, np.float32), np.full(3, 255.0, np.float32)
    kw = dict(input_res=64, out_res=16, xyz_bin=16, with_bins=True, dzi_type="uniform",
              color_aug_type="code", color_aug_prob=0.9, color_aug_code=_flagship_code())
    key = jax.random.PRNGKey(11)
    raw["aug_ok"] = np.array([1, 0, 1, 1, 1, 1, 0, 1], np.uint8)
    np.random.seed(0)
    want = jpipe.device_train_batch(key, {k: jnp.asarray(v) for k, v in raw.items()},
                                    *[jnp.asarray(stacks[k]) for k in STACK_KEYS],
                                    jnp.asarray(mean), jnp.asarray(std), **kw)
    np.random.seed(0)
    got = pipe.device_train_batch(JaxKey(key), {k: _t(v) for k, v in raw.items()},
                                  *[_t(stacks[k]) for k in STACK_KEYS], _t(mean), _t(std), **kw)
    np.testing.assert_allclose(got["roi_img"].numpy(), np.asarray(want["roi_img"]), rtol=0,
                               atol=1e-4)
    _compare_batches({k: v for k, v in got.items() if k != "roi_img"},
                     {k: v for k, v in want.items() if k != "roi_img"})


# ---------------------------------------------------------------------------
# data/mapper.py: GDRNRawTrainMapper, GDRNDeviceTestMapper
# ---------------------------------------------------------------------------


def _data_cfg(**settings):
    """The small flagship config at 2 classes, 4 regions, 64 PM points."""
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 4
    cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS = 64
    cfg.DATASETS.SYM_OBJS = ["brick"]
    for k, v in settings.items():
        cfg.set_path(k, v)
    return cfg


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    """tests/fixture_bop.py (4 images, 8 instances) as both packages'
    records and ObjectModels."""
    jmeta = build_fixture_dataset(str(tmp_path_factory.mktemp("devdata")), n_images=4, seed=31)
    pmeta = _port_meta(jmeta)
    return {"jmeta": jmeta, "pmeta": pmeta,
            "jrecs": jbop.load_bop_scene_dicts(jmeta, "test", img_type="real"),
            "precs": bop.load_bop_scene_dicts(pmeta, "test", img_type="real"),
            "jmodels": jmodel_store.ObjectModels(jmeta, num_pm_points=64, num_fps=4),
            "pmodels": model_store.ObjectModels(pmeta, num_pm_points=64, num_fps=4)}


@pytest.mark.parametrize("device_color_aug", [False, True])
def test_raw_train_mapper_equals_jax(fix, device_color_aug):
    cfg = _data_cfg(**{"INPUT.DEVICE_COLOR_AUG": device_color_aug,
                       "INPUT.COLOR_AUG_PROB": 0.8})
    np.random.seed(1)
    jm = jmapper.GDRNRawTrainMapper(cfg, fix["jmodels"])
    np.random.seed(1)
    pm = mapper.GDRNRawTrainMapper(cfg, fix["pmodels"], device="cpu")
    for i, (jr, pr) in enumerate(zip(fix["jrecs"], fix["precs"])):
        want = jm(dict(jr), np.random.RandomState(i))
        got = pm(dict(pr), np.random.RandomState(i))
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")


def test_device_test_mapper_equals_jax(fix):
    cfg = _data_cfg()
    entries = [[(r["rgb_path"], r["K"], {"obj_id": r["obj_id"], "bbox": r["bbox_visib"],
                                         "score": 0.9}) for r in recs[:5]]
               for recs in (fix["jrecs"], fix["precs"])]
    want = jmapper.GDRNDeviceTestMapper(cfg, fix["jmodels"], roi_batch_size=6).map_flat(
        entries[0])
    got = mapper.GDRNDeviceTestMapper(cfg, fix["pmodels"], roi_batch_size=6,
                                      device="cpu").map_flat(entries[1])
    assert set(got) == set(want)
    for k in want:
        atol = 1e-5 if np.asarray(want[k]).dtype.kind == "f" else 0
        np.testing.assert_allclose(_n(got[k]), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)
    host = mapper.GDRNTestMapper(cfg, fix["pmodels"], roi_batch_size=6).map_flat(entries[1])
    for k in host:
        if k != "roi_img":
            np.testing.assert_array_equal(_n(got[k]), host[k], err_msg=k)


# ---------------------------------------------------------------------------
# data/device_pool.py
# ---------------------------------------------------------------------------

SEED = 7


def _mapper(fix):
    np.random.seed(2)  # GaussianBlur(1.2*np.random.rand()) draws when the mapper is built
    return mapper.GDRNTrainMapper(_data_cfg(), fix["pmodels"], device="cpu")


@pytest.fixture(scope="module")
def pool(fix, tmp_path_factory):
    p = device_pool.DevicePool(_data_cfg(), [dict(r) for r in fix["precs"]], _mapper(fix),
                               fix["pmodels"], device="cpu", seed=SEED, num_workers=2,
                               cache_dir=str(tmp_path_factory.mktemp("pool_cache")))
    return p


def _mapped(pool, slots, seed=SEED):
    """The slots mapped as DevicePool.map_row maps them, with im_wh."""
    out = []
    for s in slots:
        rec = pool.records[s]
        smp = pool.mapper(rec, np.random.RandomState((seed * 1_000_003 + int(s)) % (2 ** 31)))
        smp["im_wh"] = np.asarray(rec["im_wh"], np.float32)
        out.append(smp)
    return out


def test_encode_and_decode_equal_jax(fix, pool):
    samples = _mapped(pool, range(4))
    mean, std = pool.pixel_mean, pool.pixel_std
    rows, jrows = [], []
    for s in samples:
        got, want = device_pool.encode_sample(s, mean, std), jpool.encode_sample(s, mean, std)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        rows.append(got)
    stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    m = fix["pmodels"]
    stacks = [getattr(m, k) for k in STACK_KEYS]
    want = jpool._decode_rows({k: jnp.asarray(v) for k, v in stacked.items()},
                              *map(jnp.asarray, stacks), jnp.asarray(mean), jnp.asarray(std),
                              **pool._decode_static)
    got = device_pool._decode_rows({k: _t(v) for k, v in stacked.items()},
                                   *map(_t, stacks), _t(mean), _t(std), **pool._decode_static)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_pool_batch_within_jax_envelope(pool):
    slots = np.arange(pool.per_shard)
    got = {k: v.numpy() for k, v in pool.make_batch(slots).items()}
    want = mapper.collate(_mapped(pool, slots))
    std, mean = pool.pixel_std, pool.pixel_mean
    d_img = np.abs((got["roi_img"] * std + mean) - (want["roi_img"] * std + mean))
    assert d_img.max() <= 0.5 + 1e-3, d_img.max()
    assert np.abs(got["gt_xyz"] - want["gt_xyz"]).max() < 5e-4
    for k in ("gt_mask_trunc", "gt_mask_visib", "gt_mask_obj", "gt_region", "roi_classes",
              "gt_points", "sym_rots", "sym_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("roi_cams", "roi_centers", "roi_whs", "roi_extents", "resize_ratios",
              "gt_ego_rot", "gt_trans", "gt_trans_ratio", "roi_coord_2d"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert (got["gt_xyz_bin"] == want["gt_xyz_bin"]).mean() > 0.999
    assert pool.stats["rows"] == 8 and pool.stats["nbytes"] > 0


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("ratio2", [0.0, 0.3])
@pytest.mark.parametrize("sampler", ["TrainingSampler", "RepeatFactorTrainingSampler"])
def test_pool_index_sampler_equals_jax(n_shards, ratio2, sampler):
    labels = list(np.random.RandomState(0).choice(3, 24, p=[0.7, 0.2, 0.1]))
    per1 = 9 if ratio2 else 12
    fake = types.SimpleNamespace(n_shards=n_shards, per_shard=12 if n_shards == 2 else 24,
                                 per_shard_ds1=per1 if n_shards == 2 else 2 * per1,
                                 labels=labels)
    kw = dict(sampler_name=sampler, repeat_thresh=0.5, ratio2=ratio2)
    want = jpool.pool_index_sampler(fake, 8, 5, **kw)
    got = device_pool.pool_index_sampler(fake, 8, 5, **kw)
    for _ in range(20):
        np.testing.assert_array_equal(next(got), next(want))


def test_refresh_writes_and_heals_torn_uploads(pool):
    before = {k: v.clone() for k, v in pool.pool.items()}
    slots = np.asarray([1, 3], np.int32)
    rows = [pool.map_row(s, seed=SEED + 5) for s in slots]
    stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    assert not np.array_equal(stacked["img_u8"], before["img_u8"][slots].numpy())
    ref = device_pool.PoolRefresher(pool, chunk=2, seed=3)
    ref.stop()  # drive the apply / settle machinery directly, no thread
    real = pool._scatter_local
    tears = {"n": 0}

    def torn(idx, dev_rows):
        if tears["n"] > 0:
            tears["n"] -= 1
            dev_rows = dict(dev_rows, xyz_f16=torch.zeros_like(dev_rows["xyz_f16"]))
        return real(idx, dev_rows)

    pool._scatter_local = torn
    try:
        # torn once: detected, written again, verified
        tears["n"] = 1
        ref._apply(0, slots, stacked, attempt=0, old=pool.read_rows(slots))
        ref._settle_pending(force=True)
        ref._settle_pending(force=True)
        assert (ref.torn_healed, ref.torn_dropped, ref.refreshed) == (1, 0, 2)
        for k, v in pool.pool.items():
            np.testing.assert_array_equal(v[slots].numpy(), stacked[k], err_msg=k)
            keep = [i for i in range(pool.per_shard) if i not in slots]
            assert torch.equal(v[keep], before[k][keep]), k
        # torn twice: dropped, the slots keep the rows they had before
        written = {k: v.clone() for k, v in pool.pool.items()}
        rows2 = [pool.map_row(s, seed=SEED + 9) for s in slots]
        stacked2 = {k: np.stack([r[k] for r in rows2]) for k in rows2[0]}
        tears["n"] = 2
        ref._apply(0, slots, stacked2, attempt=0, old=pool.read_rows(slots))
        ref._settle_pending(force=True)
        ref._settle_pending(force=True)
        assert (ref.torn_healed, ref.torn_dropped, ref.refreshed) == (2, 1, 2)
        for k, v in pool.pool.items():
            assert torch.equal(v, written[k]), k
    finally:
        pool._scatter_local = real
        for k, v in pool.pool.items():
            v.copy_(before[k])
    # the thread end to end
    ref = device_pool.PoolRefresher(pool, chunk=2, seed=4)
    try:
        for _ in range(200):
            ref.drain()
            if ref.refreshed >= 2:
                break
            time.sleep(0.05)
    finally:
        ref.stop()
        for k, v in pool.pool.items():
            v.copy_(before[k])
    assert ref.refreshed >= 2


def test_pool_cache_round_trips_and_a_torn_cache_is_remapped(fix, pool, monkeypatch):
    path = pool.cache_path
    cache_dir = osp.dirname(path)
    calls = []
    m = _mapper(fix)
    plain = mapper.GDRNTrainMapper.__call__
    monkeypatch.setattr(mapper.GDRNTrainMapper, "__call__",
                        lambda self, *a: calls.append(1) or plain(self, *a))
    again = device_pool.DevicePool(_data_cfg(), [dict(r) for r in fix["precs"]], m,
                                   fix["pmodels"], device="cpu", seed=SEED + 1,
                                   cache_dir=cache_dir)
    assert not calls and again.stats["from_cache"]
    for k, v in again.pool.items():
        assert torch.equal(v, pool.pool[k]), k
    with open(path, "r+b") as f:  # tear it
        f.truncate(os.path.getsize(path) // 2)
    again = device_pool.DevicePool(_data_cfg(), [dict(r) for r in fix["precs"]], m,
                                   fix["pmodels"], device="cpu", seed=SEED,
                                   cache_dir=cache_dir)
    assert len(calls) == 8 and not again.stats["from_cache"]
    for k, v in again.pool.items():
        assert torch.equal(v, pool.pool[k]), k
    assert os.listdir(cache_dir) == [osp.basename(path)]


def test_pool_upload_raises_after_torn_retries(fix, monkeypatch):
    calls = []
    real = device_pool.DevicePool._upload_key

    def torn(self, v):
        buf = real(self, v)
        if v.dtype == np.float16:
            calls.append(1)
            if len(calls) < 4:
                buf[0] = 0.5
        return buf

    monkeypatch.setattr(device_pool.DevicePool, "_upload_key", torn)
    p = device_pool.DevicePool(_data_cfg(), [dict(r) for r in fix["precs"][:2]], _mapper(fix),
                               fix["pmodels"], device="cpu", seed=SEED)
    assert len(calls) == 4 and p.per_shard == 2  # three bad uploads, then a good one

    def always(self, v):
        buf = real(self, v)
        if v.dtype == np.float16:
            buf[0] = 0.5
        return buf

    monkeypatch.setattr(device_pool.DevicePool, "_upload_key", always)
    with pytest.raises(RuntimeError, match="torn on keys"):
        device_pool.DevicePool(_data_cfg(), [dict(r) for r in fix["precs"][:2]], _mapper(fix),
                               fix["pmodels"], device="cpu", seed=SEED)


def test_two_rank_pool_gives_each_rank_its_block(fix, tmp_path):
    from torch_ddp_worker import run_ranks

    cfg = _data_cfg()
    out = run_ranks(tmp_path, [("pool_block", dict(
        cfg=cfg.to_dict(), meta=fix["pmeta"], records=fix["precs"], seed=SEED))], world=2)
    blocks = [o[0] for o in out]
    assert [(b["start"], b["stop"]) for b in blocks] == [(0, 4), (4, 8)]
    m = _mapper(fix)
    single = device_pool.DevicePool(cfg, [dict(r) for r in fix["precs"]], m, fix["pmodels"],
                                    device="cpu", seed=SEED, n_shards=2, shard=0)
    for r, b in enumerate(blocks):
        assert b["paths"] == [single.records[i]["rgb_path"] for i in range(4 * r, 4 * r + 4)]
        rows = [single.map_row(i, SEED) for i in range(4 * r, 4 * r + 4)]
        np.testing.assert_array_equal(b["img_u8"], np.stack([x["img_u8"] for x in rows]))
        assert b["batch_rows"] == 2 and b["idx_block"] == list(b["idx_all"][2 * r:2 * r + 2])


# ---------------------------------------------------------------------------
# engine/trainer.do_train
# ---------------------------------------------------------------------------


def _train_cfg(out_dir: str, **settings):
    cfg = _data_cfg(**{"TRAIN.DEVICE_RESIDENT_POOL": False, **settings})
    cfg.OUTPUT_DIR = out_dir
    cfg.SEED = 3
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    cfg.SOLVER.CHECKPOINT_BY_EPOCH = False
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.DATASETS.TRAIN = ("devdata_train",)
    cfg.TRAIN.PRINT_FREQ = 1
    cfg.INPUT.COLOR_AUG_PROB = 0.8
    return cfg


def _losses(out_dir: str) -> list:
    with open(osp.join(out_dir, "metrics.json")) as f:
        return [json.loads(ln)["total_loss"] for ln in f]


@pytest.mark.parametrize("mode", ["pool", "device_preprocess", "device_color_aug"])
def test_do_train_runs_each_device_input(fix, tmp_path, mode, monkeypatch):
    dataset_factory.register("devdata_train", lambda: (fix["pmeta"], fix["precs"]))
    settings = {
        "pool": {"TRAIN.DEVICE_RESIDENT_POOL": True, "TRAIN.POOL_REFRESH": True,
                 "TRAIN.POOL_REFRESH_CHUNK": 2},
        "device_preprocess": {"INPUT.DEVICE_PREPROCESS": True},
        "device_color_aug": {"INPUT.DEVICE_PREPROCESS": True, "INPUT.DEVICE_COLOR_AUG": True},
    }[mode]
    cfg = _train_cfg(str(tmp_path / mode), **settings)
    built = []
    real = trainer.build_input_pipeline

    def spy(*a, **k):
        out = real(*a, **k)
        built.append(out)
        return out

    monkeypatch.setattr(trainer, "build_input_pipeline", spy)
    calls = []
    monkeypatch.setattr(mapper.GDRNTrainMapper, "_render_xyz",
                        lambda self, *a: calls.append(1) or pytest.fail("no render expected"))
    state, _, preempted = trainer.do_train(cfg, max_iters_override=2, device="cpu")
    assert not preempted and state.step == 2
    losses = _losses(cfg.OUTPUT_DIR)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    loader, to_device, refresher = built[0]
    if mode == "pool":
        assert refresher is not None and not to_device.pool.stats["from_cache"]
        assert to_device.pool.stats["map_s"] > 0
        state, _, _ = trainer.do_train(cfg, resume=True, max_iters_override=3, device="cpu")
        assert state.step == 3 and built[1][1].pool.stats["from_cache"]
        assert len(_losses(cfg.OUTPUT_DIR)) == 3
    else:
        assert refresher is None and isinstance(
            trainer.build_train_objects(cfg, device="cpu")[4], mapper.GDRNRawTrainMapper)
