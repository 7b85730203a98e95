"""Every COLOR_AUG_TYPE of the port's host train path against the JAX package
and cv2, on the CPU, from numpy-seeded inputs: data/cv_ops's HSV, L*a*b*,
CLAHE, filter2D and box-blur stand-ins against cv2 5.0 itself, the ROI10D,
SSD and albumentations pipelines and build_color_augmentor against
gdrnet_tpu.data.augment, and GDRNTrainMapper with each type against the JAX
mapper on a 640x480 split.

Tolerances: everything is bit for bit. The colour conversions are checked
over every input (all 2^24 colours, every H, S, V and every L, a, b byte,
so LAB2BGR of every value BGR2LAB gives), at a row width that OpenCV
converts in vector blocks and at one that leaves a scalar tail.
"""

import cv2
import numpy as np
import pytest
import torch

from gdrnet_tpu.data import augment as jaug
from gdrnet_tpu.data import dataset_factory as jfactory
from gdrnet_tpu.data import mapper as jmapper
from gdrnet_tpu.data import model_store as jmodel_store

from gdrnet_tpu_torch.data import augment, cv_ops, dataset_factory, mapper, model_store
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch, write_bop_split
from gdrnet_tpu_torch.ops.warp import affine_params
from torch_parity import gen_scale_dataset, small_flagship_cfg

TYPES = ["roi10d", "aae", "code", "albu", "code_albu", "ssd"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def every_byte_triple() -> np.ndarray:
    """All 2^24 byte triples as one 4096 x 4096 x 3 image."""
    x = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([x >> 16, (x >> 8) & 255, x & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-like BGR frame: smooth colour fields, edges and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / (23 + 7 * c) + c) * np.cos(yy / (31 - 5 * c))
                    for c in range(3)], -1)
    img[h // 3: h // 2, w // 4: w // 2] = rng.randint(0, 256, 3)
    img += rng.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


FRAMES = {"640x480": (480, 640), "odd": (237, 331)}


@pytest.fixture(scope="module")
def frames():
    return {k: _frame(h, w, i) for i, (k, (h, w)) in enumerate(FRAMES.items())}


# ---------------------------------------------------------------------------
# cv_ops against cv2
# ---------------------------------------------------------------------------

CONVERSIONS = {
    "bgr_to_hsv": cv2.COLOR_BGR2HSV, "hsv_to_bgr": cv2.COLOR_HSV2BGR,
    "bgr_to_lab": cv2.COLOR_BGR2LAB, "lab_to_bgr": cv2.COLOR_LAB2BGR,
}


@pytest.mark.parametrize("name", list(CONVERSIONS))
def test_colour_conversion_equals_cv2_on_every_input(every_byte_triple, name):
    """Every byte triple (H >= 180 included for HSV2BGR) in rows of 4096,
    which OpenCV converts in vector blocks, then every 97th triple in rows of
    33, which leave a scalar tail."""
    fn, code = getattr(cv_ops, name), CONVERSIONS[name]
    every = every_byte_triple
    for slab in np.split(every, 4):
        np.testing.assert_array_equal(fn(slab), cv2.cvtColor(slab, code), err_msg=name)
    tail = np.ascontiguousarray(every.reshape(-1, 3)[::97][: 33 * 5000].reshape(-1, 33, 3))
    np.testing.assert_array_equal(fn(tail), cv2.cvtColor(tail, code), err_msg=f"{name} width 33")


CLAHE_SIZES = [(480, 640), (481, 643), (480, 643), (483, 640), (37, 29), (8, 8)]


@pytest.mark.parametrize("hw", CLAHE_SIZES, ids=[f"{h}x{w}" for h, w in CLAHE_SIZES])
def test_clahe_equals_cv2(frames, hw):
    """Seeded frames of 640x480 and of sizes that 8 does not divide (the
    histograms then come from the reflect-101 padded image), an L channel and
    noise."""
    h, w = hw
    rng = np.random.RandomState(h * w)
    lum = cv2.cvtColor(_frame(h, w, 7), cv2.COLOR_BGR2LAB)[..., 0]
    noise = rng.randint(0, 256, (h, w)).astype(np.uint8)
    for img in (lum, noise, (lum // 64 * 64).astype(np.uint8)):
        np.testing.assert_array_equal(cv_ops.clahe(img, 2.0),
                                      cv2.createCLAHE(clipLimit=2.0).apply(img))


def _kernels():
    rng = np.random.RandomState(0)
    out = {"sharpen": augment._SHARPEN, "emboss": augment._EMBOSS,
           "rand3": rng.randn(3, 3).astype(np.float32),
           "rand5": (rng.randn(5, 5) / 5).astype(np.float32)}
    for k in (3, 5):
        for axis in (0, 1):
            kern = np.zeros((k, k), np.float32)
            if axis:
                kern[:, k // 2] = 1.0
            else:
                kern[k // 2, :] = 1.0
            out[f"motion{k}_{axis}"] = kern / kern.sum()
    return out


@pytest.mark.parametrize("frame", list(FRAMES))
def test_filter2d_box_and_median_blur_equal_cv2(frames, frame):
    img = frames[frame]
    for name, kern in _kernels().items():
        np.testing.assert_array_equal(cv_ops.filter2d_u8(img, kern), cv2.filter2D(img, -1, kern),
                                      err_msg=name)
    np.testing.assert_array_equal(cv_ops.box_blur3_u8(img), cv2.blur(img, (3, 3)))
    np.testing.assert_array_equal(cv_ops.box_blur3_u8(img[..., 0]), cv2.blur(img[..., 0], (3, 3)))
    np.testing.assert_array_equal(cv_ops.median_blur3(img), cv2.medianBlur(img, 3))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_affine_float_equals_cv2(frames, dtype):
    """The bilinear crop of an f32 or f64 frame, as the mapper takes it after
    the albumentations pipeline (its RandomBrightness scales by a numpy
    scalar and so returns f64), crops inside and across the border."""
    img = frames["640x480"].astype(dtype) * dtype(0.93)
    rng = np.random.RandomState(4)
    for _ in range(6):
        M = affine_params(rng.uniform(-20, 660, 2), rng.uniform(30, 400), 0.0, 64)
        np.testing.assert_array_equal(cv_ops.warp_affine(img, M, 64),
                                      cv2.warpAffine(img, M, (64, 64), flags=cv2.INTER_LINEAR))


# ---------------------------------------------------------------------------
# the augmentors against the JAX package
# ---------------------------------------------------------------------------


def _assert_same(got, want, where):
    assert np.asarray(got).dtype == np.asarray(want).dtype, where
    np.testing.assert_array_equal(got, want, err_msg=where)


OPS = ["aug_saturation", "aug_hue", "aug_roi10d", "aug_ssd", "aug_albu"]


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("name", OPS)
def test_color_ops_equal_jax(frames, name, frame):
    img = frames[frame]
    for seed in range(8):
        _assert_same(getattr(augment, name)(img, np.random.RandomState(seed)),
                     getattr(jaug, name)(img, np.random.RandomState(seed)), f"{name} seed {seed}")


def test_albu_every_branch_equals_jax(frames):
    """200 seeds on a 64x48 crop, so that every branch of the albumentations
    pipeline runs (CLAHE fires in 7.5 % of samples)."""
    img = np.ascontiguousarray(frames["odd"][:48, :64])
    for seed in range(200):
        _assert_same(augment.aug_albu(img, np.random.RandomState(seed)),
                     jaug.aug_albu(img, np.random.RandomState(seed)), f"seed {seed}")


OP_OF_TYPE = {"roi10d": "aug_roi10d", "ssd": "aug_ssd", "albu": "aug_albu", "code_albu": "aug_albu"}


@pytest.mark.parametrize("kind", TYPES)
def test_build_color_augmentor_equals_jax(frames, kind):
    """Each type's augmentor against JAX's; the types that return one of the
    ops above return the same op in both packages (held over 8 seeds there),
    so their images are compared here over 2 seeds, the DSL's over 8."""
    code = small_flagship_cfg().INPUT.COLOR_AUG_CODE
    np.random.seed(5)
    port = augment.build_color_augmentor(kind.upper() if kind == "roi10d" else kind, code)
    np.random.seed(5)
    jax_ = jaug.build_color_augmentor(kind.upper() if kind == "roi10d" else kind, code)
    if kind in OP_OF_TYPE:
        assert port is getattr(augment, OP_OF_TYPE[kind])
        assert jax_ is getattr(jaug, OP_OF_TYPE[kind])
    for frame, img in frames.items():
        for seed in range(2 if kind in OP_OF_TYPE else 8):
            _assert_same(port(img, np.random.RandomState(seed)),
                         jax_(img, np.random.RandomState(seed)), f"{kind} {frame} seed {seed}")
    for pkg in (augment, jaug):
        with pytest.raises(ValueError, match="Unknown color aug type"):
            pkg.build_color_augmentor("hsv_only")


# ---------------------------------------------------------------------------
# the mapper with each type
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split640(tmp_path_factory):
    """A train split written by the port: one 640x480 image of 3 zoo meshes
    with xyz_crop pickles, and a folder of PNG backgrounds."""
    root = tmp_path_factory.mktemp("aug_split")
    zoo = gen_scale_dataset().mesh_zoo()
    p = synthetic_roi_batch(batch_size=3, input_res=8, out_res=4, num_classes=10, seed=3)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    t = p["gt_trans"].copy()
    t[:, :2] = np.random.RandomState(2).uniform(-0.1, 0.1, (3, 2))
    t[:, 2] += 0.5
    write_bop_split(str(root / "augzoo"), zoo, p["roi_classes"], p["gt_ego_rot"], t, K,
                    per_image=3, images_per_scene=1, device="cpu", split="train",
                    with_xyz_crop=True)
    bg_dir = root / "bg"
    bg_dir.mkdir()
    for i in range(2):
        cv2.imwrite(str(bg_dir / f"bg{i}.png"), _frame(300 + 60 * i, 420, 10 + i))
    (jmeta, jrecs), (pmeta, precs) = (jfactory.resolve("augzoo_train", str(root)),
                                      dataset_factory.resolve("augzoo_train", str(root)))
    return {"jax": (jrecs, jmodel_store.ObjectModels(jmeta, num_pm_points=64, num_fps=8)),
            "port": (precs, model_store.ObjectModels(pmeta, num_pm_points=64, num_fps=8)),
            "bg": str(bg_dir)}


@pytest.mark.parametrize("kind", TYPES)
def test_mapper_with_each_type_equals_jax(split640, kind):
    """COLOR_AUG_PROB 1, CHANGE_BG_PROB 0.5 over PNG backgrounds before the
    jitter, COLOR_AUG_SYN_ONLY with records of each img_type: every array
    bitwise. The albumentations types map each record with 3 seeds, so that
    the frames they crop are uint8, f32 and f64 (RandomBrightness)."""
    cfg = small_flagship_cfg()
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 10
    cfg.INPUT.COLOR_AUG_TYPE = kind
    cfg.INPUT.COLOR_AUG_PROB = 1.0
    cfg.INPUT.CHANGE_BG_PROB = 0.5
    cfg.INPUT.COLOR_AUG_SYN_ONLY = True
    np.random.seed(3)
    jm = jmapper.GDRNTrainMapper(cfg, split640["jax"][1],
                                 bg_replacer=jaug.BackgroundReplacer(split640["bg"]))
    np.random.seed(3)
    pm = mapper.GDRNTrainMapper(cfg, split640["port"][1], device="cpu",
                                bg_replacer=augment.BackgroundReplacer(split640["bg"]))
    dtypes = set()

    def recording(img, rng, aug=pm.color_aug):
        out = aug(img, rng)
        dtypes.add(np.asarray(out).dtype)
        return out

    pm.color_aug = recording
    seeds = (0, 100, 200) if "albu" in kind else (0,)
    jrecs, precs = split640["jax"][0], split640["port"][0]
    for i, (jr, pr) in enumerate(zip(jrecs, precs)):
        img_type = ("syn", "real", "pbr")[i % 3]
        for seed in seeds:
            got = pm(dict(pr, img_type=img_type), np.random.RandomState(seed + i))
            want = jm(dict(jr, img_type=img_type), np.random.RandomState(seed + i))
            assert got.keys() == want.keys()
            for k in want:
                _assert_same(got[k], want[k], f"{kind} record {i} seed {seed + i} {k}")
    if "albu" in kind:
        assert np.dtype(np.float64) in dtypes, dtypes
