"""numpy stand-ins for the OpenCV calls of the host train path (the port needs
no cv2, as data/io.py needs none for PNG).

Each function gives what the JAX package's cv2 call gives, as OpenCV 5.0
computes it:
  warp_affine       cv2.warpAffine(img, M, (size, size), flags, borderValue=0)
                    (data/mapper.py:crop_resize): bilinear on uint8, nearest
                    on any dtype; bit for bit.
  gaussian_blur_u8  cv2.GaussianBlur(u8, (k, k), sigma) (augment.py:58,257):
                    the bit-exact 8.8 fixed-point kernel and rounding; bit
                    for bit.
  resize_nearest    cv2.resize(..., INTER_NEAREST) (augment.py:92); bit for bit.
  resize_linear     cv2.resize(u8, (w, h)) (augment.py:467,471): 11-bit
                    fixed-point coefficients, the vertical weights unclamped
                    at the border rows; bit for bit.
  median_blur3      cv2.medianBlur(f32, 3), BORDER_REPLICATE (mapper.py:88).
  laplacian         cv2.Laplacian(f32, CV_32F) with ksize=1, BORDER_REFLECT_101
                    (mapper.py:90).
  bgr_to_gray       cv2.cvtColor(u8, COLOR_BGR2GRAY) (augment.py:322).
"""

from __future__ import annotations

import math

import numpy as np

INTER_LINEAR, INTER_NEAREST = "linear", "nearest"


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add a * b + c, rounded once: the f64 product of two
    f32 values is exact, and so is its sum with an f32 at the magnitudes
    here, so one rounding to f32 remains."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _invert_affine(M) -> np.ndarray:
    """cv2.warpAffine's inverse of a forward 2x3 map, in f64, then cast to
    f32 as its kernels use it."""
    m = np.asarray(M, np.float32).astype(np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m.astype(np.float32)


def _gather(img: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """img[ys, xs] with 0 where (ys, xs) lies outside the image."""
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = img.reshape(h * w, *img.shape[2:])
    out = flat[np.where(ok, ys * w + xs, 0)]
    out[~ok] = 0
    return out


def warp_affine(img: np.ndarray, M, size: int, interp: str = INTER_LINEAR) -> np.ndarray:
    """img [H,W] or [H,W,C] sampled at the inverse of the forward map M
    [2,3] over a size x size output, 0 outside the image.

    Source point of output pixel (x, y): sx = fma(x, m0, y*m1 + m2) in f32
    (the row base rounded twice, then one fused step), the same for sy.
    Nearest takes the pixel at (rint(sx), rint(sy)), ties to even. Bilinear
    (uint8 only) interpolates in f32 with fused steps, v0 = fma(a, p01 - p00,
    p00), v1 likewise, v = fma(b, v1 - v0, v0), and rounds to the nearest
    integer, ties to even."""
    m = _invert_affine(M)
    ys = np.arange(size, dtype=np.float32)[:, None]
    xs = np.arange(size, dtype=np.float64)[None, :]
    sx = _fma32(xs, m[0], ys * m[1] + m[2])                      # [size, size]
    sy = _fma32(xs, m[3], ys * m[4] + m[5])
    if interp == INTER_NEAREST:
        return _gather(img, np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    if interp != INTER_LINEAR or img.dtype != np.uint8:
        raise ValueError(f"warp_affine: bilinear takes uint8, got {img.dtype} ({interp})")
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = sx - fx, sy - fy                                      # exact in f32
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = _gather(img, iy, ix).astype(np.float32), _gather(img, iy, ix + 1).astype(np.float32)
    p10, p11 = _gather(img, iy + 1, ix).astype(np.float32), _gather(img, iy + 1, ix + 1).astype(np.float32)
    v0 = _fma32(a, p01 - p00, p00)
    v1 = _fma32(a, p11 - p10, p10)
    v = _fma32(b, v1 - v0, v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 indices (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def gaussian_kernel_u8(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's bit-exact Gaussian kernel for uint8 images: ksize int
    weights summing to 256 (8.8 fixed point). The side taps are the steps of
    the rounded running sum of the normalised f64 weights; the centre takes
    what is left."""
    n2 = (ksize - 1) // 2
    scale2 = -0.125 / (sigma * sigma)
    vals = [math.exp(float((1 - ksize + 2 * i) ** 2) * scale2) for i in range(n2)]
    total = 2.0 * sum(vals) + 1.0 + (1.0 if ksize % 2 == 0 else 0.0)
    cum = np.rint(np.cumsum([v / total * 256.0 for v in vals])).astype(np.int64)
    side = np.diff(cum, prepend=0)
    return np.concatenate([side, [256 - 2 * int(side.sum())], side[::-1]]).astype(np.int32)


def gaussian_blur_u8(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) of a uint8 [H,W(,C)]
    image, odd ksize, BORDER_REFLECT_101: a horizontal pass of 8.8 weights
    kept exact in 16 bits, a vertical pass into 16.16, rounded half up."""
    if img.dtype != np.uint8 or ksize % 2 == 0:
        raise ValueError(f"gaussian_blur_u8: uint8 and an odd size, got {img.dtype}, {ksize}")
    k = gaussian_kernel_u8(ksize, sigma)
    r = ksize // 2
    h, w = img.shape[:2]
    src = img.astype(np.int32)
    cols = src[:, _reflect101(np.arange(-r, w + r), w)]
    horiz = sum(int(k[j]) * cols[:, j:j + w] for j in range(ksize))
    rows = horiz[_reflect101(np.arange(-r, h + r), h)]
    vert = sum(int(k[j]) * rows[j:j + h] for j in range(ksize))
    return np.clip((vert + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_NEAREST): source
    index floor(d * (1 / (dst / src))), clamped to the last."""
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    return img[ys][:, xs]


def _linear_taps(dst: int, src: int, clamp: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Source index and 11-bit weights (sum 2048) of each destination index
    of a linear resize, with OpenCV's half-pixel centres. `clamp` is
    OpenCV's horizontal rule: a tap before the first or past the last source
    index takes that index whole. Vertically OpenCV keeps the fraction and
    clamps only the two rows it reads, so a border row of an upscale is
    row * w0 + row * w1, which rounds apart from row * 2048."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, src - 1)
    return s, np.rint((np.float32(1) - f) * 2048).astype(np.int64), np.rint(f * 2048).astype(np.int64)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height)) of a uint8 [H,W,C] image (bilinear,
    11-bit fixed point, the vertical rounding of OpenCV's vector path)."""
    h, w = img.shape[:2]
    sx, ax0, ax1 = _linear_taps(width, w, clamp=True)
    sy, by0, by1 = _linear_taps(height, h, clamp=False)
    src = img.astype(np.int64)
    rows = (src[:, sx] * ax0[None, :, None] + src[:, np.minimum(sx + 1, w - 1)]
            * ax1[None, :, None])
    r0, r1 = rows[np.clip(sy, 0, h - 1)] >> 4, rows[np.clip(sy + 1, 0, h - 1)] >> 4
    v = (((r0 * by0[:, None, None]) >> 16) + ((r1 * by1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def median_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.medianBlur(img, 3) per channel, BORDER_REPLICATE."""
    h, w = img.shape[:2]
    pad = img[np.clip(np.arange(-1, h + 1), 0, h - 1)][:, np.clip(np.arange(-1, w + 1), 0, w - 1)]
    win = np.stack([pad[i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return np.partition(win, 4, axis=0)[4]


def laplacian(img: np.ndarray) -> np.ndarray:
    """cv2.Laplacian(img, CV_32F) with ksize=1 of a [H,W] f32 image: the
    4-neighbour sum minus 4x the pixel, BORDER_REFLECT_101."""
    h, w = img.shape
    p = img.astype(np.float32)[_reflect101(np.arange(-1, h + 1), h)][:, _reflect101(
        np.arange(-1, w + 1), w)]
    return (p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] + p[2:, 1:-1]) - 4.0 * p[1:-1, 1:-1]


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of uint8 BGR: 15-bit weights
    (B 3735, G 19235, R 9798), rounded half up."""
    b, g, r = (img[..., c].astype(np.int32) for c in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)
