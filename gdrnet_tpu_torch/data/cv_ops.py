"""numpy stand-ins for the OpenCV calls of the host train path (the port needs
no cv2, as data/io.py needs none for PNG).

Each function gives what the JAX package's cv2 call gives, as OpenCV 5.0
computes it:
  warp_affine       cv2.warpAffine(img, M, (size, size), flags, borderValue=0)
                    (data/mapper.py:crop_resize): bilinear on uint8, f32 and
                    f64 (the albumentations pipeline's frames), nearest on
                    any dtype; bit for bit.
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
  bgr_to_hsv        cv2.cvtColor(u8, COLOR_BGR2HSV) (augment.py:85,89): H in
                    [0, 180), the integer tables with a 12-bit shift; bit for
                    bit over all 2^24 colours.
  hsv_to_bgr        cv2.cvtColor(u8, COLOR_HSV2BGR): f32 with fused steps;
                    bit for bit over every input, H >= 180 too.
  bgr_to_lab        cv2.cvtColor(u8, COLOR_BGR2LAB) (augment.py:149): the
                    fixed-point gamma and cube-root tables; bit for bit over
                    all 2^24 colours.
  lab_to_bgr        cv2.cvtColor(u8, COLOR_LAB2BGR) (augment.py:151): the
                    integer L, a, b tables; bit for bit over every input.
  clahe             cv2.createCLAHE(clipLimit, (8, 8)).apply(u8)
                    (augment.py:150); bit for bit.
  filter2d_u8       cv2.filter2D(u8, -1, f32 kernel) (augment.py:138,156,
                    160): f32 fused sums in kernel order; bit for bit.
  box_blur3_u8      cv2.blur(u8, (3, 3)) (augment.py:144); bit for bit.
  fill_poly         cv2.fillPoly(mask, polys, value) with integer vertices
                    inside the image (utils/mask_utils.py:119-129); bit for
                    bit.
  dilate, erode     cv2.dilate / cv2.erode with a rectangle of ones
                    (utils/mask_utils.py:144-160); bit for bit.
  line, rectangle   cv2.line / cv2.rectangle with LINE_8, any thickness, end
                    points anywhere (utils/vis.py); bit for bit, and
  clip_line         cv2.clipLine's, which they clip with.
  put_text          cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
                    from the glyph table of data/font_simplex.py, and
  get_text_size     cv2.getTextSize's width at that size; bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from gdrnet_tpu_torch.data.font_simplex import GLYPHS

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
    (uint8 or f32) interpolates in f32 with fused steps, v0 = fma(a, p01 -
    p00, p00), v1 likewise, v = fma(b, v1 - v0, v0); uint8 rounds that to
    the nearest integer, ties to even. An f64 image takes OpenCV's older
    remap path (_warp_affine_remap64)."""
    if img.dtype == np.float64 and interp == INTER_LINEAR:
        return _warp_affine_remap64(img, M, size)
    m = _invert_affine(M)
    ys = np.arange(size, dtype=np.float32)[:, None]
    xs = np.arange(size, dtype=np.float64)[None, :]
    sx = _fma32(xs, m[0], ys * m[1] + m[2])                      # [size, size]
    sy = _fma32(xs, m[3], ys * m[4] + m[5])
    if interp == INTER_NEAREST:
        return _gather(img, np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    if interp != INTER_LINEAR or img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"warp_affine: bilinear takes uint8 or f32, got {img.dtype} ({interp})")
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
    if img.dtype == np.float32:
        return v
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _warp_affine_remap64(img: np.ndarray, M, size: int) -> np.ndarray:
    """Bilinear cv2.warpAffine of an f64 [H,W(,C)] image: the inverse map in
    f64 scaled to 10-bit fixed point per row and column, source points on a
    1/32 pixel grid, the four taps weighted by f32 table weights and summed
    in f64, 0 outside the image."""
    m = np.asarray(M, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1, b2 = -a11 * m[0, 2] - a12 * m[1, 2], -a21 * m[0, 2] - a22 * m[1, 2]
    ab, half = 1 << 10, 1 << 4
    x = np.arange(size)
    y = np.arange(size)[:, None]
    X = (np.rint((a12 * y + b1) * ab).astype(np.int64) + half
         + np.rint(a11 * x * ab).astype(np.int64)) >> 5
    Y = (np.rint((a22 * y + b2) * ab).astype(np.int64) + half
         + np.rint(a21 * x * ab).astype(np.int64)) >> 5
    fx, fy = (X & 31) / 32.0, (Y & 31) / 32.0
    ix, iy = X >> 5, Y >> 5
    taps = ((iy, ix, (1 - fy) * (1 - fx)), (iy, ix + 1, (1 - fy) * fx),
            (iy + 1, ix, fy * (1 - fx)), (iy + 1, ix + 1, fy * fx))
    out = 0.0
    for ty, tx, wgt in taps:
        wgt = wgt.astype(np.float32).astype(np.float64)
        out = out + _gather(img, ty, tx) * (wgt[..., None] if img.ndim == 3 else wgt)
    return out


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


def _descale(x, n: int):
    """CV_DESCALE: x / 2^n rounded half up."""
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# HSV (OpenCV's RGB2HSV_b and HSV2RGB_b, H in [0, 180))
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
# the output columns that take v, v(1-s), v(1-s f) and v(1-s(1-f)), per sector
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
                        np.int8)
# HSV2RGB_b converts blocks of 32 pixels in vector code that truncates, and
# the rest of a row in scalar code that rounds half to even
_HSV_VECTOR_BLOCK = 32


@functools.lru_cache(maxsize=None)
def _hsv_div_tables() -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int32)
    hdiv = np.zeros(256, np.int32)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) of uint8 BGR [..., 3]."""
    sdiv, hdiv = _hsv_div_tables()
    b, g, r = (img[..., c].astype(np.int32) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) of uint8 HSV [H, W, 3]: h = H * 6/180,
    s and v scaled by 1/255, the sector's products in f32 with the inner
    1 - s*x fused, times 255."""
    f32 = np.float32
    sat = img[..., 1]
    s = sat.astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    pre = np.floor(h)
    f = h - pre
    sector = pre.astype(np.int8) % 6
    s64 = s.astype(np.float64)
    tab = (v, v * (f32(1) - s), v * (1.0 - s64 * f).astype(f32),
           v * (1.0 - s64 * (f32(1) - f)).astype(f32))
    gray = sat == 0
    out = np.stack([np.where(gray, v, np.choose(_HSV_SECTORS[sector, c], tab)) for c in range(3)],
                   -1) * f32(255)
    nv = img.shape[-2] // _HSV_VECTOR_BLOCK * _HSV_VECTOR_BLOCK
    out[..., nv:, :] = np.rint(out[..., nv:, :])
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# CIE L*a*b* (OpenCV's RGB2Lab_b and Lab2RGBinteger, sRGB, D65)
# ---------------------------------------------------------------------------

_LAB_SHIFT, _LAB_SHIFT2, _GAMMA_SHIFT = 12, 15, 3
_LAB_BASE = 1 << 14
_MIN_AB = -8145
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_XYZ_TO_SRGB = np.array([[3.240479, -1.53715, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])
_D65 = np.array([0.950456, 1.0, 1.088754])


@functools.lru_cache(maxsize=None)
def _lab_forward_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sRGB gamma of each byte at scale 255 * 2^3, the cube root (linear
    below (6/29)^3) of each gamma-space index at scale 2^15, and the XYZ rows
    over the white point at scale 2^12 (columns R, G, B)."""
    f32 = np.float32
    x = (np.arange(256, dtype=f32) / f32(255)).astype(np.float64)
    g = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4).astype(f32)
    gamma = np.rint(f32(255 << _GAMMA_SHIFT) * g).astype(np.int32)
    xs = np.arange(3 * 256 // 2 << _GAMMA_SHIFT) / float(255 << _GAMMA_SHIFT)
    lin = (xs.astype(f32).astype(np.float64) * (f32(841) / f32(108))
           + (f32(16) / f32(116))).astype(f32)
    cbrt = np.where(xs.astype(f32) < f32(216) / f32(24389), lin, np.cbrt(xs).astype(f32))
    cbrt = np.rint(np.float64(1 << _LAB_SHIFT2) * cbrt).astype(np.int32)
    coeffs = np.rint((1 << _LAB_SHIFT) * _SRGB_TO_XYZ / _D65[:, None]).astype(np.int32)
    return gamma, cbrt, coeffs


def bgr_to_lab(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2LAB) of uint8 BGR [..., 3]."""
    gamma, cbrt, c = _lab_forward_tables()
    b, g, r = (gamma[img[..., k]] for k in range(3))
    fx, fy, fz = (cbrt[_descale(r * c[k, 0] + g * c[k, 1] + b * c[k, 2], _LAB_SHIFT)]
                  for k in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    ab_bias = 128 << _LAB_SHIFT2
    lab = np.stack([_descale(l_scale * fy + l_shift, _LAB_SHIFT2),
                    _descale(500 * (fx - fy) + ab_bias, _LAB_SHIFT2),
                    _descale(200 * (fy - fz) + ab_bias, _LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _lab_inverse_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Y and f(Y) of each 8-bit L at scale 2^14, X or Z of each f value from
    _MIN_AB on, the RGB rows times the white point at scale 2^12, and the
    inverse sRGB gamma of 4096 steps at scale 255."""
    base = _LAB_BASE
    y = np.zeros(256, np.int64)
    fy = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:  # L = i * 100 / 255 <= 8: the linear segment
            yy = i * 100 / 255 / 903.3
            y[i] = round(yy * base)
            fy[i] = round(base * (7.787 * yy + 16 / 116))
        else:
            f = (i * 100 * base / 255 + 16 * base) / 116
            fy[i] = round(f)
            y[i] = round(f * f * f / (base * base))
    v = np.arange(_MIN_AB, base * 9 // 4 + _MIN_AB, dtype=np.int64)
    lin = np.trunc(v * 108 / 841).astype(np.int64) - base * 16 // 116 * 108 // 841
    xz = np.where(v <= 3390, lin, v * v // base * v // base)
    coeffs = np.rint((1 << _LAB_SHIFT) * _XYZ_TO_SRGB * _D65[None, :]).astype(np.int64)
    f32 = np.float32
    x = (f32(1) / f32(4096) * np.arange(4096, dtype=f32)).astype(np.float64)
    g = np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055).astype(f32)
    inv_gamma = np.rint(f32(255) * g).astype(np.uint8)
    return y, fy, xz, coeffs, inv_gamma


def lab_to_bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_LAB2BGR) of uint8 L*a*b* [..., 3]."""
    y_tab, fy_tab, xz, c, inv_gamma = _lab_inverse_tables()
    L, a, b = (img[..., k].astype(np.int64) for k in range(3))
    y, fy = y_tab[L], fy_tab[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    x, z = xz[fy + adiv - _MIN_AB], xz[fy - bdiv - _MIN_AB]
    rgb = [inv_gamma[np.clip(_descale(c[k, 0] * x + c[k, 1] * y + c[k, 2] * z, 14), 0, 4095)]
           for k in range(3)]
    return np.stack(rgb[::-1], -1)


# ---------------------------------------------------------------------------
# CLAHE, filter2D, box blur
# ---------------------------------------------------------------------------


def clahe(img: np.ndarray, clip_limit: float = 2.0, tiles: tuple[int, int] = (8, 8)) -> np.ndarray:
    """cv2.createCLAHE(clip_limit, tiles).apply(img) of a uint8 [H, W] image.

    Histograms are taken per tile on the image padded by reflect-101 to a
    multiple of the grid (OpenCV pads a whole tile where a side already
    divides); each is clipped at max(int(clip * area / 256), 1), the excess
    spread over all bins and its residual over every (256 // residual)-th
    bin; the LUT is the cumulative sum times 255 / area in f32, rounded.
    Each pixel interpolates its four tiles' LUTs bilinearly in f32."""
    tx, ty = tiles
    h, w = img.shape
    src = img
    if h % ty or w % tx:
        src = img[_reflect101(np.arange(h + ty - h % ty), h)][
            :, _reflect101(np.arange(w + tx - w % tx), w)]
    th, tw = src.shape[0] // ty, src.shape[1] // tx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1)
    cells = src.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(ty * tx, area)
    bins = (np.arange(ty * tx) * 256)[:, None] + cells
    hist = np.bincount(bins.reshape(-1), minlength=ty * tx * 256).reshape(ty * tx, 256)
    excess = np.maximum(hist - limit, 0).sum(1)
    hist = np.minimum(hist, limit) + (excess // 256)[:, None]
    for t, residual in enumerate(excess % 256):
        if residual:
            hist[t, 0:256:max(256 // int(residual), 1)][:residual] += 1
    lut = np.rint(np.cumsum(hist, 1).astype(np.float32) * (np.float32(255) / np.float32(area)))
    lut = np.clip(lut, 0, 255).astype(np.float32).reshape(ty, tx, 256)

    def taps(n: int, size: int, count: int):
        t = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(size)) - np.float32(0.5)
        t1 = np.floor(t).astype(np.int64)
        frac = t - t1.astype(np.float32)
        return np.maximum(t1, 0), np.minimum(t1 + 1, count - 1), frac, np.float32(1) - frac

    x1, x2, xa, xa1 = taps(w, tw, tx)
    y1, y2, ya, ya1 = taps(h, th, ty)
    v = img.astype(np.int64)
    top = lut[y1[:, None], x1, v] * xa1 + lut[y1[:, None], x2, v] * xa
    bottom = lut[y2[:, None], x1, v] * xa1 + lut[y2[:, None], x2, v] * xa
    res = top * ya1[:, None] + bottom * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def _pad_reflect101(img: np.ndarray, ry: int, rx: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[_reflect101(np.arange(-ry, h + ry), h)][:, _reflect101(np.arange(-rx, w + rx), w)]


def filter2d_u8(img: np.ndarray, kernel) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) of a uint8 [H, W(, C)] image with an
    f32 kernel of odd sides, centred anchor, BORDER_REFLECT_101: the nonzero
    taps in row-major order, each a fused f32 multiply-add, rounded half to
    even."""
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    h, w = img.shape[:2]
    if (k == np.round(k)).all() and np.abs(k).sum() * 255 < 1 << 24:
        # integer taps: every f32 partial sum is an exact integer
        pad = _pad_reflect101(img, kh // 2, kw // 2).astype(np.int32)
        acc = sum(int(k[i, j]) * pad[i:i + h, j:j + w]
                  for i in range(kh) for j in range(kw) if k[i, j] != 0)
        return np.clip(acc, 0, 255).astype(np.uint8)
    pad = _pad_reflect101(img, kh // 2, kw // 2).astype(np.float64)
    acc = np.zeros(img.shape, np.float32)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0:
                acc = (pad[i:i + h, j:j + w] * float(k[i, j]) + acc).astype(np.float32)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def box_blur3_u8(img: np.ndarray) -> np.ndarray:
    """cv2.blur(img, (3, 3)) of a uint8 [H, W(, C)] image, BORDER_REFLECT_101:
    the 3x3 sum over 9, rounded to nearest (a sum of integers over 9 never
    ties)."""
    h, w = img.shape[:2]
    pad = _pad_reflect101(img, 1, 1).astype(np.int32)
    rows = pad[:, 0:w] + pad[:, 1:w + 1] + pad[:, 2:w + 2]
    s = rows[0:h] + rows[1:h + 1] + rows[2:h + 2]
    return ((2 * s + 9) // 18).astype(np.uint8)


# ---------------------------------------------------------------------------
# fillPoly, dilate, erode (drawing.cpp, morph.dispatch.cpp)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16


def _line8(img: np.ndarray, p1, p2, value) -> None:
    """cv::line with LINE_8 and no shift, drawn left to right (the outline
    fillPoly draws) between two points inside the image: LineIterator's
    Bresenham walk."""
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1)
    steps = np.empty(major + 1, np.int64)
    err, step = major - 2 * minor, 0
    for i in range(major + 1):
        steps[i] = step
        if err < 0:
            step, err = step + 1, err + 2 * major
        err -= 2 * minor
    if vert:
        img[p1[1] + sy * k, p1[0] + steps] = value
    else:
        img[p1[1] + sy * steps, p1[0] + k] = value


def _raw_color(img: np.ndarray, color) -> np.ndarray:
    """cv::scalarToRawData: the first C entries of the colour (a number or a
    sequence, missing entries 0) rounded half to even and saturated to the
    image's dtype; C the image's channels."""
    c = np.zeros(img.shape[2] if img.ndim == 3 else 1, np.float64)
    v = np.atleast_1d(np.asarray(color, np.float64))[:len(c)]
    c[:len(v)] = v
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        c = np.clip(np.rint(c), info.min, info.max)
    c = c.astype(img.dtype)
    return c if img.ndim == 3 else c[0]


def clip_line(size, p1, p2):
    """cv2.clipLine over the image (w, h) = size: the segment p1-p2 cut to
    the pixels [0, w) x [0, h), or None where none of it lies inside; each
    end moved along the line to the border it crosses first (rows, then
    columns), the second end from the first's moved position, truncated
    toward zero."""
    right, bottom = size[0] - 1, size[1] - 1
    if size[0] <= 0 or size[1] <= 0:
        return None
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else ((x1, y1), (x2, y2))


_XY_ONE = 1 << _XY_SHIFT


def _c_div(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """cv::Line2: a LINE_8 line between 16.16 fixed-point points, clipped to
    the image in fixed point, one pixel a step along the major axis (the
    outline cv::FillConvexPoly draws)."""
    h, w = img.shape[:2]
    clipped = clip_line((w << _XY_SHIFT, h << _XY_SHIFT), p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy, half = x2 - x1, y2 - y1, _XY_ONE // 2
    if abs(dx) > abs(dy):
        if dx < 0:
            (x1, y1), (x2, y2), dy = (x2, y2), (x1, y1), -dy
        step = _c_div(dy << _XY_SHIFT, abs(dx) | 1)
        x, y = (x1 + half) >> _XY_SHIFT, y1 + half
        pts = [(x + k, (y + k * step) >> _XY_SHIFT) for k in range(((x2 - x1) >> _XY_SHIFT) + 1)]
    else:
        if dy < 0:
            (x1, y1), (x2, y2), dx = (x2, y2), (x1, y1), -dx
        step = _c_div(dx << _XY_SHIFT, abs(dy) | 1)
        x, y = x1 + half, (y1 + half) >> _XY_SHIFT
        pts = [((x + k * step) >> _XY_SHIFT, y + k) for k in range(((y2 - y1) >> _XY_SHIFT) + 1)]
    pts.append(((x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT))
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _fill_convex_poly(img: np.ndarray, v, color) -> None:
    """cv::FillConvexPoly of 16.16 fixed-point vertices with LINE_8: the
    outline by _line2, then one span a row between the two edges that walk
    down from the top vertex, each span from (x_left + 1/2) to (x_right +
    1/2), floored, clipped to the image."""
    h, w = img.shape[:2]
    n, half = len(v), _XY_ONE // 2
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(p[0] for p in v) + half) >> _XY_SHIFT, (max(p[0] for p in v) + half) >> _XY_SHIFT
    ymin, ymax = (min(ys) + half) >> _XY_SHIFT, (max(ys) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "ye": ymin, "x": -_XY_ONE, "dx": 0},
            {"idx": imin, "di": n - 1, "ye": ymin, "x": -_XY_ONE, "dx": 0}]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + half) >> _XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=xs, idx=idx,
                             dx=_c_div((xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
            else:
                edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]["x"] > edge[1]["x"] else (edge[0], edge[1])
            x1, x2 = (left["x"] + half) >> _XY_SHIFT, (right["x"] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _circle_filled(img: np.ndarray, center, radius: int, color) -> None:
    """cv::Circle with fill: the midpoint circle's horizontal spans, clipped."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                img[yy, max(xa, 0):min(xb, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int) -> None:
    """cv::ThickLine with LINE_8 and no shift; flags bit 0 / bit 1 draw the
    round cap at p0 / p1 (a filled circle) of a line thicker than 1."""
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        clipped = clip_line((img.shape[1], img.shape[0]), p0, p1)
        if clipped is not None:
            _line8(img, *clipped, color)
        return
    q0 = (p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT)
    q1 = (p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT)
    dx, dy = (q0[0] - q1[0]) / _XY_ONE, (q1[1] - q0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (th + odd * _XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(q0[0] + ddx, q0[1] + ddy), (q0[0] - ddx, q0[1] - ddy),
                                (q1[0] - ddx, q1[1] - ddy), (q1[0] + ddx, q1[1] + ddy)], color)
    for i, q in enumerate((q0, q1)):
        if flags & (i + 1):
            _circle_filled(img, ((q[0] + _XY_ONE // 2) >> _XY_SHIFT,
                                 (q[1] + _XY_ONE // 2) >> _XY_SHIFT),
                           (th + _XY_ONE // 2) >> _XY_SHIFT, color)


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p1, p2, color, thickness) with LINE_8 and no shift, in
    place on a [H, W] or [H, W, C] image: integer end points anywhere
    (clipped as cv2.clipLine clips them), drawn left to right; a thicker
    line is first clipped to the image grown by its thickness, then drawn
    as a filled quad with round caps. Returns img."""
    if not 0 < thickness <= 32767:
        raise ValueError(f"line: thickness {thickness} outside (0, 32767]")
    if thickness > 1:
        h, w = img.shape[:2]
        t = thickness
        clipped = clip_line((w + 2 * t, h + 2 * t), (p1[0] + t, p1[1] + t),
                            (p2[0] + t, p2[1] + t))
        if clipped is None:
            return img
        (x1, y1), (x2, y2) = clipped
        p1, p2 = (x1 - t, y1 - t), (x2 - t, y2 - t)
    _thick_line(img, p1, p2, _raw_color(img, color), thickness, 3)
    return img


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness) with LINE_8 and a
    thickness of at least 0, in place: the closed outline p1, (p2.x, p1.y),
    p2, (p1.x, p2.y), each side a line with the round cap at its end (no
    clipping beforehand, unlike `line`). Returns img."""
    if not 0 <= thickness <= 32767:
        raise ValueError(f"rectangle: thickness {thickness} outside [0, 32767] (no fill)")
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    c = _raw_color(img, color)
    p0 = pts[-1]
    for p in pts:
        _thick_line(img, p0, p, c, thickness, 2)
        p0 = p
    return img


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1) on a
    uint8 [H, W] or [H, W, C] image, in place, as OpenCV 5.0 draws it: each
    character's antialiased coverage mask a (data/font_simplex.py) blended
    in turn at its integer pen position, round(bg * (1 - a) + color * a)
    per channel, clipped to the image; org is the text's bottom-left.
    Only that size (the table's SCALE and THICKNESS); a character outside
    the table raises ValueError. Returns img."""
    if img.dtype != np.uint8:
        raise ValueError(f"put_text: uint8 images only, got {img.dtype}")
    for ch in text:
        if ch not in GLYPHS:
            raise ValueError(f"put_text: no glyph for {ch!r} (printable ASCII only)")
    h, w = img.shape[:2]
    c = _raw_color(img, color).astype(np.int32)
    x, y = int(org[0]), int(org[1])
    for ch in text:
        adv, dx, dy, gw, gh, cov = GLYPHS[ch]
        x0, y0 = x + dx, y + dy
        xa, xb, ya, yb = max(x0, 0), min(x0 + gw, w), max(y0, 0), min(y0 + gh, h)
        if gw and xa < xb and ya < yb:
            a = np.frombuffer(bytes.fromhex(cov), np.uint8).reshape(gh, gw)
            a = a[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)
            if img.ndim == 3:
                a = a[..., None]
            bg = img[ya:yb, xa:xb].astype(np.int32)
            img[ya:yb, xa:xb] = ((bg * (255 - a) + c * a + 127) // 255).astype(np.uint8)
        x += adv
    return img


def get_text_size(text: str) -> int:
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, 0.5, 1)'s width: the sum
    of the characters' advances plus 1 (0 for no text)."""
    return sum(GLYPHS[ch][0] for ch in text) + 1 if text else 0


def fill_poly(img: np.ndarray, polys, value) -> np.ndarray:
    """cv2.fillPoly(img, polys, value) in place, LINE_8, integer vertices
    inside the image: every polygon's outline drawn by Bresenham, then one
    scanline fill of all their edges (even-odd), each edge walked in 16.16
    fixed point from its upper vertex's pixel centre, a span running from
    floor(x_left) to floor(x_right - 1/2). Returns img.

    A vertex outside the image raises NotImplementedError: OpenCV then
    clips the edges in a way this stand-in does not reproduce."""
    h, w = img.shape[:2]
    half = 1 << (_XY_SHIFT - 1)
    edges = []
    for poly in polys:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        if ((pts < 0) | (pts >= (w, h))).any():
            raise NotImplementedError(f"fill_poly: a vertex outside the {w}x{h} image "
                                      "(cv2's edge clipping is not ported)")
        for i in range(len(pts)):
            (x0, y0), (x1, y1) = pts[i - 1].tolist(), pts[i].tolist()
            _line8(img, (x0, y0), (x1, y1), value)
            if y0 == y1:
                continue
            if y0 > y1:
                (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
            num = (x1 - x0) << _XY_SHIFT
            dx = abs(num) // (y1 - y0) * (1 if num >= 0 else -1)  # C division
            edges.append((y0, y1, (x0 << _XY_SHIFT) + half, dx))
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    for y in range(int(e[:, 0].min()), int(e[:, 1].max())):
        act = e[(e[:, 0] <= y) & (y < e[:, 1])]
        xs = np.sort(act[:, 2] + (y - act[:, 0]) * act[:, 3])
        for xa, xb in zip(xs[0::2], xs[1::2]):
            img[y, int(xa >> _XY_SHIFT):int((xb - half) >> _XY_SHIFT) + 1] = value
    return img


def _ksize(ksize) -> tuple[int, int]:
    return (ksize, ksize) if np.isscalar(ksize) else tuple(ksize)


def _morph(img: np.ndarray, ksize, pick, fill) -> np.ndarray:
    kw, kh = _ksize(ksize)
    h, w = img.shape[:2]
    ax, ay = kw // 2, kh // 2
    pad = np.full((h + kh - 1, w + kw - 1) + img.shape[2:], fill, img.dtype)
    pad[ay:ay + h, ax:ax + w] = img
    rows = functools.reduce(pick, (pad[:, j:j + w] for j in range(kw)))
    return functools.reduce(pick, (rows[i:i + h] for i in range(kh)))


def dilate(img: np.ndarray, ksize) -> np.ndarray:
    """cv2.dilate(img, np.ones((kh, kw), np.uint8)) of a uint8 image (ksize
    an int or (kw, kh)): the maximum over the window at anchor (kw // 2,
    kh // 2); outside the image counts as 0."""
    return _morph(img, ksize, np.maximum, 0)


def erode(img: np.ndarray, ksize) -> np.ndarray:
    """cv2.erode(img, np.ones((kh, kw), np.uint8)) of a uint8 image: the
    minimum over the window; outside the image counts as 255."""
    return _morph(img, ksize, np.minimum, 255)
