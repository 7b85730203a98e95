"""Batched colour jitter on the device (counterpart of
gdrnet_tpu/data/device_augment.py): with INPUT.DEVICE_PREPROCESS and
INPUT.DEVICE_COLOR_AUG the host stops after decode and background
replacement, and the jitter runs on the card beside the crops and targets
(data/device_pipeline.py).

Twins of the host augmentors (data/augment.py): the AAE imgaug code
(base_data_loader.py:168-186) and ROI10D's AugmentRGB
(core/utils/augment.py:7-60), with JAX's two departures from the host's
evaluation of the imgaug DSL: GaussianBlur's sigma is drawn per image in
[lo, hi), and saturation scales chroma in closed form (x' = max - f (max - x),
HSV S *= f at fixed V).

Every op is split into a draw half and an apply half (Op.draw, Op.apply).
The draw half takes a key with JAX's key discipline (split, fold_in) and
its distributions (uniform, bernoulli, normal, randint); TorchKey draws
them from one torch.Generator on the images' device, in which split and
fold_in hand on the same stream. The apply half is arithmetic on the images
[B, H, W, 3] f32 in 0..255 (BGR or RGB: every op but Grayscale is blind to
the channel order) and the draws, so the same draws give JAX's images.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


class TorchKey:
    """The draw halves' random source on `generator`'s device. split and
    fold_in return the key itself: one stream, consumed in the draw
    halves' fixed order, so a generator seeded alike draws alike."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def split(self, n: int = 2) -> list["TorchKey"]:
        return [self] * n

    def fold_in(self, i: int) -> "TorchKey":  # noqa: ARG002
        return self

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (hi - lo) + lo

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device) < p

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=self.generator, device=self.device)


@dataclass(frozen=True)
class Op:
    """draw(key, shape) -> draws (a dict or list of tensors); apply(imgs,
    draws) -> imgs. Calling it draws and applies."""
    draw: Callable
    apply: Callable

    def __call__(self, key, imgs: torch.Tensor) -> torch.Tensor:
        return self.apply(imgs, self.draw(key, tuple(imgs.shape)))


def _clip(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 255.0)


def _rng_pair(v) -> tuple[float, float]:
    """imgaug stochastic parameter: scalar -> (v, v); (lo, hi) -> range."""
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return float(v[0]), float(v[1])
    return float(v), float(v)


def _pc_prob(per_channel) -> float:
    return 1.0 if per_channel is True else float(per_channel or 0.0)


def _per_channel_draw(key, lo: float, hi: float, b: int, per_channel_p: float) -> torch.Tensor:
    """imgaug per_channel: w.p. per_channel_p one value per channel, else one
    shared value per image -> [b, 3]."""
    k_pc, k_ch, k_sh = key.split(3)
    pc = k_pc.bernoulli(per_channel_p, (b, 1))
    v_ch = k_ch.uniform((b, 3), lo, hi)
    v_sh = k_sh.uniform((b, 1), lo, hi)
    return torch.where(pc, v_ch, v_sh.expand(b, 3))


# ---------------------------------------------------------------- the ops


def add_op(lo: float = -25.0, hi: float = 25.0, per_channel=0.3) -> Op:
    return Op(lambda key, s: {"v": _per_channel_draw(key, lo, hi, s[0], _pc_prob(per_channel))},
              lambda x, d: _clip(x + d["v"][:, None, None, :]))


def multiply_op(lo: float = 0.8, hi: float = 1.2, per_channel=0.5) -> Op:
    return Op(lambda key, s: {"v": _per_channel_draw(key, lo, hi, s[0], _pc_prob(per_channel))},
              lambda x, d: _clip(x * d["v"][:, None, None, :]))


def linear_contrast_op(lo: float = 0.5, hi: float = 2.2, per_channel=0.3) -> Op:
    """(x - 127) * alpha + 127 (augment.aug_contrast)."""
    return Op(lambda key, s: {"a": _per_channel_draw(key, lo, hi, s[0], _pc_prob(per_channel))},
              lambda x, d: _clip((x - 127.0) * d["a"][:, None, None, :] + 127.0))


def invert_op(p: float = 0.2, per_channel=True) -> Op:
    """imgaug Invert: per image, w.p. per_channel the channels flip
    independently w.p. p, else the whole image flips w.p. p."""
    def draw(key, s):
        b = s[0]
        k_pc, k_ch, k_im = key.split(3)
        pc = k_pc.bernoulli(_pc_prob(per_channel), (b, 1))
        flip_ch = k_ch.bernoulli(p, (b, 3))
        flip_im = k_im.bernoulli(p, (b, 1)).expand(b, 3)
        return {"flip": torch.where(pc, flip_ch, flip_im)}
    return Op(draw, lambda x, d: torch.where(d["flip"][:, None, None, :], 255.0 - x, x))


def additive_gaussian_noise_op(loc=0.0, scale=(0.0, 10.0)) -> Op:
    """imgaug AdditiveGaussianNoise: full-shape noise, per-image scale and
    mean drawn from their ranges."""
    s_lo, s_hi = _rng_pair(scale)
    l_lo, l_hi = _rng_pair(loc)

    def draw(key, s):
        b = s[0]
        k_s, k_l, k_n = key.split(3)
        return {"s": k_s.uniform((b, 1, 1, 1), s_lo, s_hi),
                "mu": k_l.uniform((b, 1, 1, 1), l_lo, l_hi), "n": k_n.normal(s)}
    return Op(draw, lambda x, d: _clip(x + d["n"] * d["s"] + d["mu"]))


def dropout_op(p=0.05, per_channel=0.0) -> Op:
    """imgaug Dropout: per-pixel zeros, shared by the channels unless the
    per-image per_channel draw fires."""
    lo, hi = _rng_pair(p)

    def draw(key, s):
        b = s[0]
        k_pc, k_px, k_ch, k_p = key.split(4)
        return {"pv": k_p.uniform((b, 1, 1, 1), lo, hi),
                "pc": k_pc.bernoulli(_pc_prob(per_channel), (b, 1, 1, 1)),
                "u_px": k_px.uniform(s[:3]), "u_ch": k_ch.uniform(s)}

    def apply(x, d):
        keep_px = d["u_px"][..., None] >= d["pv"]
        keep_ch = d["u_ch"] >= d["pv"]
        return x * torch.where(d["pc"], keep_ch, keep_px)
    return Op(draw, apply)


def grayscale_op(alpha=1.0, channel_order: str = "bgr") -> Op:
    """imgaug Grayscale: blend toward the luma (cv2 BGR2GRAY weights)."""
    lo, hi = _rng_pair(alpha)
    w = [0.114, 0.587, 0.299] if channel_order == "bgr" else [0.299, 0.587, 0.114]

    def apply(x, d):
        g = (x * torch.tensor(w, dtype=x.dtype, device=x.device)).sum(dim=-1, keepdim=True)
        return _clip((1.0 - d["a"]) * x + d["a"] * g)
    return Op(lambda key, s: {"a": key.uniform((s[0], 1, 1, 1), lo, hi)}, apply)


def _resize_nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image.resize's "nearest" source index of each output position."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def coarse_dropout_op(p=0.2, size_percent=0.05, fill: float = 0.0) -> Op:
    """Coarse blocks: a bernoulli grid at size_percent of the image (its
    upper bound when a range), nearest-upsampled; p drawn per image."""
    sp = _rng_pair(size_percent)[1]
    lo, hi = _rng_pair(p)

    def draw(key, s):
        b, h, w = s[0], s[1], s[2]
        gh, gw = max(2, int(h * sp)), max(2, int(w * sp))
        k_p, k_g = key.split(2)
        pv = k_p.uniform((b, 1, 1), lo, hi)
        return {"grid": k_g.uniform((b, gh, gw)) < pv}

    def apply(x, d):
        grid = d["grid"]
        iy = _resize_nearest_index(grid.shape[1], x.shape[1], x.device)
        ix = _resize_nearest_index(grid.shape[2], x.shape[2], x.device)
        mask = grid[:, iy][:, :, ix]
        return torch.where(mask[..., None], torch.full((), fill, dtype=x.dtype, device=x.device),
                           x)
    return Op(draw, apply)


def saturation_op(lo: float = 0.6, hi: float = 1.4) -> Op:
    """HSV S *= f at fixed V, closed form: x' = max - f (max - x)."""
    def apply(x, d):
        mx = x.amax(dim=-1, keepdim=True)
        return _clip(mx - d["f"] * (mx - x))
    return Op(lambda key, s: {"f": key.uniform((s[0], 1, 1, 1), lo, hi)}, apply)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """numpy's "reflect" padding of r on both sides of an axis of n."""
    i = torch.arange(-r, n + r, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur_op(sigma_hi: float = 1.2, sigma_lo: float = 0.0, radius: int = 4) -> Op:
    """Separable Gaussian blur with a per-image sigma in [sigma_lo,
    sigma_hi) over a reflect-padded image (cv2's BORDER_DEFAULT), first
    along H, then along W, as JAX's two depthwise convolutions. A sigma under
    ~0.35 is the identity through the normalized kernel itself."""
    def apply(x, d):
        b, h, w, _ = x.shape
        # the kernel and both passes in f64, rounded to f32 once at the end:
        # the same image on every device (exp's last bit differs between
        # libraries in f32), within an f32 rounding of JAX's convolution,
        # whatever order it sums its taps in
        taps = torch.arange(-radius, radius + 1, dtype=torch.float64, device=x.device)
        s = torch.clamp(d["sigma"].double(), min=1e-3)[:, None]
        k = torch.exp(-0.5 * (taps[None, :] / s) ** 2)
        k = k / k.sum(dim=1, keepdim=True)  # [B, K]
        pad = x[:, _reflect_index(h, radius, x.device)][:, :, _reflect_index(w, radius, x.device)]
        kk = k[:, :, None, None, None]
        pad = pad.double()
        y = sum(kk[:, j] * pad[:, j:j + h] for j in range(2 * radius + 1))
        return sum(kk[:, j] * y[:, :, j:j + w] for j in range(2 * radius + 1)).float()
    return Op(lambda key, s: {"sigma": key.uniform((s[0],), sigma_lo, sigma_hi)}, apply)


_IDENTITY = Op(lambda key, s: {}, lambda x, d: x)


# ---------------------------------------------------------- composition


def sometimes(p: float, child: Op) -> Op:
    """imgaug Sometimes: the child applies to each image independently w.p. p."""
    def draw(key, s):
        k_apply, k_op = key.split(2)
        return {"apply": k_apply.bernoulli(float(p), (s[0],)), "child": child.draw(k_op, s)}

    def apply(x, d):
        return torch.where(d["apply"][:, None, None, None], child.apply(x, d["child"]), x)
    return Op(draw, apply)


def _sometimes(key, p: float, imgs: torch.Tensor, child: Op) -> torch.Tensor:
    """JAX's _sometimes(key, p, imgs, fn) with the child as an Op."""
    return sometimes(p, child)(key, imgs)


def sequential(children: list[Op], keys: str = "fold_in") -> Op:
    """The children in order; child i draws from key.fold_in(i) (the DSL's
    Sequential) or from the i-th of key.split(n) (the fixed AAE pipeline)."""
    def draw(key, s):
        ks = key.split(len(children)) if keys == "split" else [
            key.fold_in(i) for i in range(len(children))]
        return [c.draw(k, s) for c, k in zip(children, ks)]

    def apply(x, ds):
        for c, d in zip(children, ds):
            x = c.apply(x, d)
        return x
    return Op(draw, apply)


def one_of(children: list[Op]) -> Op:
    """imgaug OneOf: each image takes one child's output, chosen uniformly;
    every child runs on the whole batch (child i draws from fold_in(i) of
    the second split key)."""
    def draw(key, s):
        k_sel, k_op = key.split(2)
        return {"sel": k_sel.randint((s[0],), 0, len(children)),
                "children": [c.draw(k_op.fold_in(i), s) for i, c in enumerate(children)]}

    def apply(x, d):
        out = x
        for i, c in enumerate(children):
            out = torch.where((d["sel"] == i)[:, None, None, None], c.apply(x, d["children"][i]),
                              out)
        return out
    return Op(draw, apply)


def aae_aug_op() -> Op:
    """The AAE pipeline (augment.AAE_AUG_CODE, base_data_loader.py:168-186),
    fixed order: Sometimes(0.5 CoarseDropout(0.2, 5%)), Sometimes(0.5
    GaussianBlur), Sometimes(0.5 Add(+-25, pc 0.3)), Sometimes(0.3
    Invert(0.2, pc)), Sometimes(0.5 Multiply(0.6-1.4, pc 0.5)), Sometimes(0.5
    Multiply(0.6-1.4)), Sometimes(0.5 LinearContrast(0.5-2.2, pc 0.3))."""
    return sequential([
        sometimes(0.5, coarse_dropout_op(p=0.2, size_percent=0.05)),
        sometimes(0.5, gaussian_blur_op()),
        sometimes(0.5, add_op(lo=-25.0, hi=25.0, per_channel=0.3)),
        sometimes(0.3, invert_op(p=0.2, per_channel=True)),
        sometimes(0.5, multiply_op(lo=0.6, hi=1.4, per_channel=0.5)),
        sometimes(0.5, multiply_op(lo=0.6, hi=1.4, per_channel=0.0)),
        sometimes(0.5, linear_contrast_op(lo=0.5, hi=2.2, per_channel=0.3)),
    ], keys="split")


def roi10d_aug_op(brightness: float = 18.0, contrast: float = 0.4,
                  saturation: float = 0.4) -> Op:
    """AugmentRGB (augment.aug_roi10d): brightness add, linear contrast,
    saturation, each drawn per image."""
    sat = saturation_op(lo=1 - saturation, hi=1 + saturation)

    def draw(key, s):
        k1, k2, k3 = key.split(3)
        b = s[0]
        return {"v": k1.uniform((b, 1, 1, 1), -brightness, brightness),
                "a": k2.uniform((b, 1, 1, 1), 1 - contrast, 1 + contrast),
                "sat": sat.draw(k3, s)}

    def apply(x, d):
        x = _clip(x + d["v"])
        x = _clip((x - 127.0) * d["a"] + 127.0)
        return sat.apply(x, d["sat"])
    return Op(draw, apply)


# the batched functions of the JAX module: (key, imgs, params) -> imgs
def add_batch(key, imgs, lo=-25.0, hi=25.0, per_channel=0.3):
    return add_op(lo, hi, per_channel)(key, imgs)


def multiply_batch(key, imgs, lo=0.8, hi=1.2, per_channel=0.5):
    return multiply_op(lo, hi, per_channel)(key, imgs)


def linear_contrast_batch(key, imgs, lo=0.5, hi=2.2, per_channel=0.3):
    return linear_contrast_op(lo, hi, per_channel)(key, imgs)


def invert_batch(key, imgs, p=0.2, per_channel=True):
    return invert_op(p, per_channel)(key, imgs)


def additive_gaussian_noise_batch(key, imgs, loc=0.0, scale=(0.0, 10.0)):
    return additive_gaussian_noise_op(loc, scale)(key, imgs)


def dropout_batch(key, imgs, p=0.05, per_channel=0.0):
    return dropout_op(p, per_channel)(key, imgs)


def grayscale_batch(key, imgs, alpha=1.0, channel_order: str = "bgr"):
    return grayscale_op(alpha, channel_order)(key, imgs)


def coarse_dropout_batch(key, imgs, p=0.2, size_percent=0.05, fill=0.0):
    return coarse_dropout_op(p, size_percent, fill)(key, imgs)


def saturation_batch(key, imgs, lo=0.6, hi=1.4):
    return saturation_op(lo, hi)(key, imgs)


def gaussian_blur_batch(key, imgs, sigma_hi=1.2, sigma_lo=0.0, radius: int = 4):
    return gaussian_blur_op(sigma_hi, sigma_lo, radius)(key, imgs)


def aae_aug_batch(key, imgs):
    return aae_aug_op()(key, imgs)


def roi10d_aug_batch(key, imgs, brightness=18.0, contrast=0.4, saturation=0.4):
    return roi10d_aug_op(brightness, contrast, saturation)(key, imgs)


# ------------------------------------------------------------------ DSL


def _geometric_stub(name):
    def ctor(*a, **k):
        raise NotImplementedError(
            f"{name}: geometric color-aug ops would desync bbox/xyz/mask "
            "targets (the reference keeps them commented out in every "
            "shipped COLOR_AUG_CODE)")
    return ctor


def parse_device_aug_code(code: str, channel_order: str = "bgr") -> Op:
    """INPUT.COLOR_AUG_CODE (the imgaug DSL) -> one Op, as JAX's parser
    builds it: ranges are drawn per image; the np.random expressions of the
    code (GaussianBlur(1.2*np.random.rand())) are evaluated once, here."""
    def Sequential(children, random_order=False):
        if random_order:
            raise NotImplementedError(
                "random_order=True has no fixed-program equivalent "
                "(no shipped COLOR_AUG_CODE uses it)")
        return sequential(list(children))

    def Sometimes(p, child):
        return sometimes(float(p), child)

    def OneOf(children):
        return one_of(list(children))

    def CoarseDropout(p=0.1, size_percent=0.05, per_channel=0.0):  # noqa: ARG001
        # per-channel block patterns collapse to shared blocks, as in JAX
        return coarse_dropout_op(p=p, size_percent=size_percent)

    def GaussianBlur(sigma=1.0):
        lo, hi = _rng_pair(sigma)
        return gaussian_blur_op(sigma_lo=lo, sigma_hi=max(hi, lo + 1e-6))

    def Add(value=(-20, 20), per_channel=0.0):
        lo, hi = _rng_pair(value)
        return add_op(lo, hi, _pc_prob(per_channel))

    def Multiply(mul=(0.8, 1.2), per_channel=0.0):
        lo, hi = _rng_pair(mul)
        return multiply_op(lo, hi, _pc_prob(per_channel))

    def LinearContrast(alpha=(0.6, 1.4), per_channel=0.0):
        lo, hi = _rng_pair(alpha)
        return linear_contrast_op(lo, hi, _pc_prob(per_channel))

    def Invert(p=0.5, per_channel=False):
        return invert_op(float(p), per_channel)

    def AdditiveGaussianNoise(loc=0, scale=(0, 10), per_channel=0.0):  # noqa: ARG001
        return additive_gaussian_noise_op(loc, scale)

    def Dropout(p=0.05, per_channel=0.0):
        return dropout_op(p, per_channel)

    def Grayscale(alpha=1.0):
        return grayscale_op(alpha, channel_order)

    ns = {
        "Sequential": Sequential, "Sometimes": Sometimes, "OneOf": OneOf,
        "CoarseDropout": CoarseDropout, "GaussianBlur": GaussianBlur,
        "Add": Add, "Multiply": Multiply, "LinearContrast": LinearContrast,
        "ContrastNormalization": LinearContrast, "Invert": Invert,
        "AdditiveGaussianNoise": AdditiveGaussianNoise, "Dropout": Dropout,
        "Grayscale": Grayscale, "Noop": lambda *a, **k: _IDENTITY, "np": np,
    }
    for name in ("PerspectiveTransform", "CropAndPad", "Affine", "PiecewiseAffine",
                 "ElasticTransformation", "Fliplr", "Flipud", "Crop", "Pad", "Scale",
                 "Superpixels"):
        ns[name] = _geometric_stub(name)
    return eval(code, {"__builtins__": {}}, ns)  # noqa: S307 restricted ns


def color_aug_op(aug_type: str = "aae", aug_code: str | None = None,
                 channel_order: str = "bgr") -> Op:
    """The jitter of COLOR_AUG_TYPE: "code" parses COLOR_AUG_CODE (the AAE
    pipeline without one), "aae" and "roi10d" are built in; the host-only
    types raise JAX's ValueError."""
    t = aug_type.lower()
    if t == "code" and aug_code:
        return parse_device_aug_code(aug_code, channel_order)
    if t in ("aae", "code"):
        return aae_aug_op()
    if t == "roi10d":
        return roi10d_aug_op()
    raise ValueError(
        f"device color aug supports aae/code/roi10d, got {aug_type!r} "
        "(keep INPUT.DEVICE_COLOR_AUG=False for ssd/albu)")


def apply_color_aug_batch(key, imgs: torch.Tensor, aug_ok: torch.Tensor,
                          aug_type: str = "aae", prob: float = 0.0,
                          aug_code: str | None = None, channel_order: str = "bgr",
                          op: Op | None = None) -> torch.Tensor:
    """The top-level gate: each image is jittered w.p. `prob` where its
    host-computed `aug_ok` flag (the COLOR_AUG_SYN_ONLY rule) is set.
    imgs [B, H, W, 3] f32 in 0..255. `op` is color_aug_op's result, when the
    caller built it once."""
    if prob <= 0.0:
        return imgs
    fn = op or color_aug_op(aug_type, aug_code, channel_order)
    k_p, k_op = key.split(2)
    do = k_p.bernoulli(prob, (imgs.shape[0],)) & aug_ok.bool()
    out = fn(k_op, imgs)
    return torch.where(do[:, None, None, None], out, imgs)
