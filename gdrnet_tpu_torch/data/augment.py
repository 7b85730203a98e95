"""Host-side colour augmentation and background replacement in numpy
(counterpart of gdrnet_tpu/data/augment.py, whose cv2 calls go through
data/cv_ops here; the same ops draw the same numbers from the same
RandomState, so a seeded mapper gives the JAX package's images).

Covers the reference's augmentation surface (core/base_data_loader.py:154-259
_get_color_augmentor/_color_aug and :320-419 replace_bg/get_bg_image):

  * ROI10D AugmentRGB-style brightness/contrast/saturation jitter
    (core/utils/augment.py:7), the SSD photometric distortion and the
    numpy form of the `code_albu` albumentations pipeline, on data/cv_ops's
    HSV, LAB, CLAHE, filter2D and blur stand-ins
  * the imgaug code-string DSL ("code", and the built-in "aae" string) that
    every shipped config uses, evaluated against numpy ops in a restricted
    namespace
  * background replacement with aspect-keeping resize and optional
    foreground truncation (TRUNCATE_FG), from PNG or JPEG backgrounds
    (data/jpeg.py) or the gradient fallback

Every op takes (img uint8 HWC BGR, rng: np.random.RandomState).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable

import numpy as np

from gdrnet_tpu_torch.data import cv_ops
from gdrnet_tpu_torch.data.io import load_im

# ---------------------------------------------------------------------------
# elementary color ops
# ---------------------------------------------------------------------------


def aug_brightness_add(img, rng, lo=-30, hi=30):
    return np.clip(img.astype(np.float32) + rng.uniform(lo, hi), 0, 255).astype(np.uint8)


def aug_multiply(img, rng, lo=0.8, hi=1.2, per_channel_p=0.5):
    if rng.rand() < per_channel_p:
        m = rng.uniform(lo, hi, size=(1, 1, img.shape[2]))
    else:
        m = rng.uniform(lo, hi)
    return np.clip(img.astype(np.float32) * m, 0, 255).astype(np.uint8)


def aug_contrast(img, rng, lo=0.5, hi=2.2):
    """LinearContrast: (x - 127) * alpha + 127."""
    alpha = rng.uniform(lo, hi)
    return np.clip((img.astype(np.float32) - 127.0) * alpha + 127.0, 0, 255).astype(np.uint8)


def _blur_size(sigma: float) -> int:
    return max(3, int(2 * round(2 * sigma) + 1))


def aug_gaussian_blur(img, rng, sigma_lo=0.0, sigma_hi=1.2):
    sigma = rng.uniform(sigma_lo, sigma_hi)
    if sigma < 1e-3:
        return img
    return cv_ops.gaussian_blur_u8(img, _blur_size(sigma), sigma)


def aug_gaussian_noise(img, rng, scale=10.0):
    noise = rng.randn(*img.shape) * scale
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def aug_invert_channel(img, rng, p_channel=0.3):
    out = img.copy()
    for c in range(img.shape[2]):
        if rng.rand() < p_channel:
            out[..., c] = 255 - out[..., c]
    return out


def aug_saturation(img, rng, lo=0.5, hi=1.5):
    hsv = cv_ops.bgr_to_hsv(img).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(lo, hi), 0, 255)
    return cv_ops.hsv_to_bgr(hsv.astype(np.uint8))


def aug_hue(img, rng, delta=18):
    hsv = cv_ops.bgr_to_hsv(img).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + rng.randint(-delta, delta + 1)) % 180
    return cv_ops.hsv_to_bgr(hsv.astype(np.uint8))


def aug_coarse_dropout(img, rng, p_px=0.05, size_frac=0.05, fill=0):
    """Drop random coarse blocks (imgaug CoarseDropout analogue)."""
    h, w = img.shape[:2]
    gh = max(2, int(h * size_frac))
    gw = max(2, int(w * size_frac))
    grid = rng.rand(gh, gw) < p_px
    mask = cv_ops.resize_nearest(grid.astype(np.uint8), w, h)
    out = img.copy()
    out[mask.astype(bool)] = fill
    return out


def aug_roi10d(img, rng, brightness=18.0, contrast=0.4, saturation=0.4):
    """AugmentRGB-style jitter (reference core/utils/augment.py:7-60)."""
    img = aug_brightness_add(img, rng, -brightness, brightness)
    img = aug_contrast(img, rng, 1 - contrast, 1 + contrast)
    img = aug_saturation(img, rng, 1 - saturation, 1 + saturation)
    return img


def aug_ssd(img, rng):
    """SSD-style photometric distortion (reference ColorAugSSDTransform,
    core/utils/ssd_color_transform.py:10): random brightness, contrast,
    saturation, hue in randomized order."""
    if rng.rand() < 0.5:
        img = aug_brightness_add(img, rng, -32, 32)
    if rng.rand() < 0.5:  # contrast-first or contrast-last ordering
        if rng.rand() < 0.5:
            img = aug_contrast(img, rng, 0.5, 1.5)
        img = aug_saturation(img, rng, 0.5, 1.5)
        img = aug_hue(img, rng, 18)
    else:
        img = aug_saturation(img, rng, 0.5, 1.5)
        img = aug_hue(img, rng, 18)
        if rng.rand() < 0.5:
            img = aug_contrast(img, rng, 0.5, 1.5)
    return img


_SHARPEN = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)
_EMBOSS = np.array([[-1, -1, 0], [-1, 1, 1], [0, 1, 1]], np.float32)


def aug_albu(img, rng):
    """numpy form of the reference's `code_albu` albumentations pipeline
    (base_data_loader.py:208-243), as the JAX package composes it: coarse
    dropout, noise, a blur family, CLAHE/sharpen/emboss/brightness-contrast,
    invert, RGB shift, contrast, gamma, brightness. Returns floats in
    [0, 255]: f32, or f64 where RandomBrightness's numpy-scalar factor
    promotes the frame, as in the JAX package."""
    img = img.astype(np.float32)
    if rng.rand() < 0.4:  # CoarseDropout(max 5% holes of 5% size, p=0.4)
        img = aug_coarse_dropout(img, rng, p_px=0.03, size_frac=0.05)
    if rng.rand() < 0.2:  # OneOf additive noise
        img = aug_gaussian_noise(img, rng, scale=10.0)
    if rng.rand() < 0.2:  # OneOf[MotionBlur | MedianBlur(3) | Blur(3)]
        u = rng.rand()
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        if u < 0.5:  # motion blur: a horizontal or vertical line kernel
            k = 2 * rng.randint(1, 3) + 1
            kern = np.zeros((k, k), np.float32)
            if rng.rand() < 0.5:
                kern[k // 2, :] = 1.0
            else:
                kern[:, k // 2] = 1.0
            img = cv_ops.filter2d_u8(u8, kern / kern.sum()).astype(np.float32)
        elif u < 0.75:
            img = cv_ops.median_blur3(u8).astype(np.float32)
        else:
            img = cv_ops.box_blur3_u8(u8).astype(np.float32)
    if rng.rand() < 0.3:  # OneOf[CLAHE | Sharpen | Emboss | Bright+Contrast]
        u = rng.rand()
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        if u < 0.25:
            lab = cv_ops.bgr_to_lab(u8)
            lab[..., 0] = cv_ops.clahe(lab[..., 0], 2.0)
            img = cv_ops.lab_to_bgr(lab).astype(np.float32)
        elif u < 0.5:
            img = cv_ops.filter2d_u8(u8, _SHARPEN).astype(np.float32)
        elif u < 0.75:  # emboss blended with identity
            emb = cv_ops.filter2d_u8(u8, _EMBOSS).astype(np.float32)
            a = rng.uniform(0.2, 0.5)
            img = (1 - a) * img + a * emb
        else:
            img = aug_contrast(aug_brightness_add(img, rng), rng,
                               lo=0.8, hi=1.2)
    if rng.rand() < 0.2:  # InvertImg
        img = 255.0 - img
    if rng.rand() < 0.5:  # RGBShift(105/45/40) — img is BGR
        shift = np.array([rng.uniform(-40, 40), rng.uniform(-45, 45),
                          rng.uniform(-105, 105)], np.float32)
        img = img + shift[None, None]
    if rng.rand() < 0.5:  # RandomContrast(0.9)
        img = aug_contrast(img, rng, lo=0.1, hi=1.9)
    if rng.rand() < 0.5:  # RandomGamma(80..120)
        gamma = rng.uniform(0.8, 1.2)
        img = 255.0 * (np.clip(img, 0, 255) / 255.0) ** gamma
    if rng.rand() < 0.5:  # RandomBrightness(1.2)
        img = img * (1.0 + rng.uniform(-0.5, 0.5))
    return np.clip(img, 0, 255)


# ---------------------------------------------------------------------------
# imgaug code-string interpreter (reference base_data_loader.py:196-208:
# aug_type "code" evals cfg.INPUT.COLOR_AUG_CODE with imgaug constructors in
# scope; "aae" evals a fixed built-in string, :168-186), as the JAX package
# evaluates it.
# ---------------------------------------------------------------------------


def _rand_param(v, rng):
    """imgaug stochastic parameter: scalar -> itself, (lo, hi) -> uniform."""
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return rng.uniform(v[0], v[1])
    return float(v)


def _per_channel_param(v, rng, per_channel, nch):
    """Sample a value per channel w.p. per_channel (imgaug semantics:
    True -> always, float p -> with probability p), else one value."""
    pc = 1.0 if per_channel is True else float(per_channel or 0.0)
    if rng.rand() < pc:
        return np.array([_rand_param(v, rng) for _ in range(nch)],
                        np.float32).reshape(1, 1, nch)
    return _rand_param(v, rng)


def _iaa_sequential(children, random_order=False):
    def op(img, rng):
        order = rng.permutation(len(children)) if random_order else range(len(children))
        for i in order:
            img = children[i](img, rng)
        return img
    return op


def _iaa_sometimes(p, child):
    def op(img, rng):
        return child(img, rng) if rng.rand() < p else img
    return op


def _iaa_oneof(children):
    def op(img, rng):
        return children[rng.randint(len(children))](img, rng)
    return op


def _iaa_coarse_dropout(p=0.1, size_percent=0.05, per_channel=0.0):
    def op(img, rng):
        pc = 1.0 if per_channel is True else float(per_channel or 0.0)
        if rng.rand() < pc:  # independent block pattern per channel
            out = img.copy()
            for c in range(img.shape[2]):
                out[..., c] = aug_coarse_dropout(
                    img[..., c:c + 1], rng, p_px=_rand_param(p, rng),
                    size_frac=_rand_param(size_percent, rng))[..., 0]
            return out
        return aug_coarse_dropout(img, rng, p_px=_rand_param(p, rng),
                                  size_frac=_rand_param(size_percent, rng))
    return op


def _iaa_gaussian_blur(sigma=1.0):
    def op(img, rng):
        s = _rand_param(sigma, rng)
        if s < 1e-3:
            return img
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        return cv_ops.gaussian_blur_u8(u8, _blur_size(s), s)
    return op


def _iaa_add(value=(-20, 20), per_channel=0.0):
    def op(img, rng):
        v = _per_channel_param(value, rng, per_channel, img.shape[2])
        return np.clip(img.astype(np.float32) + v, 0, 255).astype(np.uint8)
    return op


def _iaa_multiply(mul=(0.8, 1.2), per_channel=0.0):
    def op(img, rng):
        m = _per_channel_param(mul, rng, per_channel, img.shape[2])
        return np.clip(img.astype(np.float32) * m, 0, 255).astype(np.uint8)
    return op


def _iaa_linear_contrast(alpha=(0.6, 1.4), per_channel=0.0):
    def op(img, rng):
        a = _per_channel_param(alpha, rng, per_channel, img.shape[2])
        return np.clip((img.astype(np.float32) - 127.0) * a + 127.0,
                       0, 255).astype(np.uint8)
    return op


def _iaa_invert(p=0.5, per_channel=False):
    def op(img, rng):
        out = img.copy()
        if per_channel:
            pc = 1.0 if per_channel is True else float(per_channel)
            if rng.rand() < pc:
                for c in range(img.shape[2]):
                    if rng.rand() < p:
                        out[..., c] = 255 - out[..., c]
                return out
        if rng.rand() < p:
            out = 255 - out
        return out
    return op


def _iaa_additive_gaussian_noise(loc=0, scale=(0, 10), per_channel=0.0):
    def op(img, rng):
        s = _rand_param(scale, rng)
        noise = rng.randn(*img.shape) * s + _rand_param(loc, rng)
        return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return op


def _iaa_dropout(p=0.05, per_channel=0.0):
    def op(img, rng):
        pc = 1.0 if per_channel is True else float(per_channel or 0.0)
        if rng.rand() < pc:
            keep = rng.rand(*img.shape) >= _rand_param(p, rng)
            return (img * keep).astype(img.dtype)
        keep = rng.rand(*img.shape[:2]) >= _rand_param(p, rng)
        return (img * keep[..., None]).astype(img.dtype)
    return op


def _iaa_grayscale(alpha=1.0):
    def op(img, rng):
        a = _rand_param(alpha, rng)
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        g = cv_ops.bgr_to_gray(u8)[..., None].astype(np.float32)
        return np.clip((1 - a) * u8 + a * g, 0, 255).astype(np.uint8)
    return op


def _geometric_stub(name):
    def ctor(*a, **k):
        raise NotImplementedError(
            f"{name}: geometric color-aug ops would desync bbox/xyz/mask "
            "targets (the reference keeps them commented out in every "
            "shipped COLOR_AUG_CODE)")
    return ctor


def _iaa_noop(*a, **k):
    return lambda img, rng: img


_AUG_NAMESPACE = {
    "Sequential": _iaa_sequential,
    "Sometimes": _iaa_sometimes,
    "OneOf": _iaa_oneof,
    "CoarseDropout": _iaa_coarse_dropout,
    "GaussianBlur": _iaa_gaussian_blur,
    "Add": _iaa_add,
    "Multiply": _iaa_multiply,
    "LinearContrast": _iaa_linear_contrast,
    "ContrastNormalization": _iaa_linear_contrast,  # imgaug alias
    "Invert": _iaa_invert,
    "AdditiveGaussianNoise": _iaa_additive_gaussian_noise,
    "Dropout": _iaa_dropout,
    "Grayscale": _iaa_grayscale,
    "Noop": _iaa_noop,
    "np": np,  # configs use e.g. GaussianBlur(1.2*np.random.rand())
}
for _name in ("PerspectiveTransform", "CropAndPad", "Affine", "PiecewiseAffine",
              "ElasticTransformation", "Fliplr", "Flipud", "Crop", "Pad",
              "Scale", "Superpixels"):
    _AUG_NAMESPACE[_name] = _geometric_stub(_name)

# the reference's built-in AAE pipeline string (base_data_loader.py:173-183)
AAE_AUG_CODE = (
    "Sequential(["
    "Sometimes(0.5, CoarseDropout( p=0.2, size_percent=0.05) ),"
    "Sometimes(0.5, GaussianBlur(1.2*np.random.rand())),"
    "Sometimes(0.5, Add((-25, 25), per_channel=0.3)),"
    "Sometimes(0.3, Invert(0.2, per_channel=True)),"
    "Sometimes(0.5, Multiply((0.6, 1.4), per_channel=0.5)),"
    "Sometimes(0.5, Multiply((0.6, 1.4))),"
    "Sometimes(0.5, LinearContrast((0.5, 2.2), per_channel=0.3))"
    "], random_order=False)")


def parse_aug_code(code: str) -> Callable:
    """COLOR_AUG_CODE string -> (img, rng) -> img. Evaluated once, like the
    reference's eval at augmentor construction: an np.random expression in
    the string draws from numpy's global generator here and fixes its value
    for the run."""
    return eval(code, {"__builtins__": {}}, dict(_AUG_NAMESPACE))


def build_color_augmentor(aug_type: str = "ROI10D",
                          aug_code: str | None = None) -> Callable:
    key = aug_type.lower()
    if key == "roi10d":
        return aug_roi10d
    if key == "aae":  # fixed built-in pipeline (base_data_loader.py:168-186)
        return parse_aug_code(AAE_AUG_CODE)
    if key == "code":  # cfg.INPUT.COLOR_AUG_CODE DSL (:196-208)
        return parse_aug_code(aug_code) if aug_code else parse_aug_code(AAE_AUG_CODE)
    if key in ("albu", "code_albu"):
        return aug_albu
    if key == "ssd":
        return aug_ssd
    raise ValueError(f"Unknown color aug type: {aug_type}")


# ---------------------------------------------------------------------------
# background replacement (base_data_loader.py:320-419)
# ---------------------------------------------------------------------------


class BackgroundReplacer:
    def __init__(self, bg_root: str, num_bg_imgs: int = 10000,
                 keep_aspect: bool = True, bg_type: str = "VOC_table",
                 exts=(".jpg", ".jpeg", ".png")):
        self.keep_aspect = keep_aspect
        self.paths: list[str] = []
        if bg_root and osp.isdir(bg_root):
            # bg_type selects the path list (reference _bg_img_paths,
            # base_data_loader.py:282-309): "VOC_table" filters VOC to the
            # DeepIM dining-table subset, "VOC"/"SUN2012" use JPEGImages/,
            # "coco" (and any flat folder) scans bg_root directly.
            candidates: list[str] = []
            table_list = osp.join(bg_root, "ImageSets", "Main",
                                  "diningtable_trainval.txt")
            img_dir = osp.join(bg_root, "JPEGImages")
            if bg_type == "VOC_table" and osp.exists(table_list):
                with open(table_list) as f:
                    for ln in f:
                        parts = ln.split()
                        if len(parts) == 2 and parts[1] == "1":
                            candidates.append(
                                osp.join(img_dir, f"{parts[0]}.jpg"))
            elif osp.isdir(img_dir):
                candidates = [osp.join(img_dir, fn)
                              for fn in sorted(os.listdir(img_dir))]
            else:
                candidates = [osp.join(bg_root, fn)
                              for fn in sorted(os.listdir(bg_root))]
            self.paths = [p for p in candidates
                          if p.lower().endswith(exts)][: num_bg_imgs]
        self._grad_cache: dict = {}

    def _gradient_bg(self, rng, h: int, w: int) -> np.ndarray:
        """Smooth random-gradient fallback; the per-size ramps are cached
        (read-only across threads) — only the random mix is per-call. The
        convex combination of values in [0, 255] stays in range, so no clip."""
        ramps = self._grad_cache.get((h, w))
        if ramps is None:
            gy = np.linspace(0, 255, h, dtype=np.float32)[:, None, None]
            gx = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
            ramps = self._grad_cache[(h, w)] = (gy, gx)
        gy, gx = ramps
        c = rng.rand(1, 1, 3).astype(np.float32)
        return (gy * c + gx * (1 - c)).astype(np.uint8)

    @staticmethod
    def _read(path: str) -> np.ndarray | None:
        """The background as cv2.imread reads it, None where cv2 gives None
        (a missing, unreadable or corrupt file). A JPEG that the port refuses
        (arithmetic-coded, 12-bit, lossless, hierarchical, or progressive
        with a low coefficient left unrefined) raises NotImplementedError,
        since cv2 would have read the file."""
        try:
            return load_im(path)
        except (OSError, ValueError):
            return None

    def get_bg(self, rng, h: int, w: int) -> np.ndarray:
        """Aspect-keeping random crop/resize of a random bg image
        (get_bg_image, base_data_loader.py:366-419)."""
        if not self.paths:
            return self._gradient_bg(rng, h, w)
        # bounded retry over random picks; no mutation (the replacer is
        # shared across loader threads) — persistent failures fall through
        # to the gradient fallback
        bg = None
        for _ in range(5):
            bg = self._read(self.paths[rng.randint(len(self.paths))])
            if bg is not None:
                break
        if bg is None:
            return self._gradient_bg(rng, h, w)
        if self.keep_aspect:
            bh, bw = bg.shape[:2]
            scale = max(h / bh, w / bw)
            bg = cv_ops.resize_linear(bg, int(np.ceil(bw * scale)), int(np.ceil(bh * scale)))
            y0 = rng.randint(0, bg.shape[0] - h + 1)
            x0 = rng.randint(0, bg.shape[1] - w + 1)
            return bg[y0:y0 + h, x0:x0 + w]
        return cv_ops.resize_linear(bg, w, h)

    def replace(self, img: np.ndarray, fg_mask: np.ndarray, rng,
                truncate_fg: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Replace everything outside fg_mask with a random background;
        optionally truncate a random side of the fg first (replace_bg +
        TRUNCATE_FG, base_data_loader.py:320-364). Returns (img, mask)."""
        h, w = img.shape[:2]
        mask = fg_mask.astype(bool)  # astype copies; safe to truncate in place
        # reference truncates w.p. 0.8 (one of 4 sides), no-op otherwise
        # (base_data_loader.py:342-356 rnd<0.2/0.4/0.6/0.8/else-pass)
        if truncate_fg and mask.any() and rng.rand() < 0.8:
            ys, xs = np.nonzero(mask)
            x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
            side = rng.randint(4)
            if x2 > x1 and y2 > y1:
                if side == 0:
                    mask[:, : rng.randint(x1, (x1 + x2) // 2 + 1)] = False
                elif side == 1:
                    mask[:, rng.randint((x1 + x2) // 2, x2 + 1):] = False
                elif side == 2:
                    mask[: rng.randint(y1, (y1 + y2) // 2 + 1), :] = False
                else:
                    mask[rng.randint((y1 + y2) // 2, y2 + 1):, :] = False
        bg = self.get_bg(rng, h, w)
        out = np.where(mask[..., None], img, bg)
        return out, mask.astype(np.float32)
