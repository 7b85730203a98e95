"""Image / depth / json IO (counterpart of gdrnet_tpu/data/io.py).

The JAX module reads and writes images through OpenCV. This one carries its
own small PNG codec (zlib + struct + numpy), so the port needs no cv2:
8- and 16-bit, gray and RGB, non-interlaced; every filter type on read,
filter 0 on write; JPEGs go through data/jpeg.py. `load_im`, `load_depth`
and `save_depth` give what the JAX module's cv2 calls give on such files:
`load_im` picks the codec by the file's signature, as cv2.imread does, and
returns BGR like cv2.IMREAD_COLOR (gray replicated to three channels, 16-bit
cut to its high byte), `load_depth` takes channel 0 of the BGR image when
the file has three channels.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from gdrnet_tpu_torch.data.cv_ops import bgr_to_gray
from gdrnet_tpu_torch.data.jpeg import JPEG_SIGNATURE, decode_jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # PNG colour type -> channels: gray, RGB


def _unfilter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filters None, Sub and Up in whole-image vector operations, all
    modulo 256: a Sub row is a running sum along the row; a run of Up rows
    is a running sum down the columns from the row before the run."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    ftype = rows[:, 0]
    own = rows[:, 1:].copy()  # each row decoded without the rows above it
    sub = ftype == 1
    own[sub] = np.cumsum(own[sub].reshape(-1, stride // bpp, bpp), axis=1,
                         dtype=np.uint8).reshape(-1, stride)
    if not (ftype == 2).any():
        return own
    total = np.cumsum(own, axis=0, dtype=np.uint8)
    # the last row that does not add the row above it (Up on the first row
    # adds zeros); everything before it drops out of the running sum
    start = np.maximum.accumulate(np.where((ftype != 2) | (np.arange(height) == 0),
                                           np.arange(height), 0))
    before = np.where((start > 0)[:, None], total[np.maximum(start - 1, 0)], 0)
    return (total - before).astype(np.uint8)


def _unfilter_diagonals(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five filters. Average and Paeth predict a pixel
    from its left, upper and upper-left neighbours, so the pixels of one
    anti-diagonal (y + x = d) depend only on the two diagonals before it:
    the image is skewed so that each diagonal is one row of `sk`, and each
    diagonal is one vector step over the image's rows."""
    height, width = rows.shape[0], (rows.shape[1] - 1) // bpp
    ftype = rows[:, 0].astype(np.int16)[:, None]
    px = rows[:, 1:].reshape(height, width, bpp)
    n_diag = height + width - 1
    ys = np.arange(height)
    # raw[d, y] = px[y, d - y]; sk[d + 2, y + 1] = decoded px[y, d - y], with
    # zeros for the diagonals before the first, the row above the first and
    # every position off the image
    xs = np.arange(n_diag)[:, None] - ys[None, :]
    raw = px[ys[None, :], np.clip(xs, 0, width - 1)].astype(np.int16)
    sk = np.zeros((n_diag + 2, height + 1, bpp), np.int16)
    # Paeth on every row, the usual choice of libpng's and PIL's writers (on
    # the first row, with nothing above it, Paeth is Sub)
    only_paeth = bool((ftype[1:] == 4).all()) and int(ftype[0, 0]) in (1, 4)
    for d in range(n_diag):
        y0, y1 = max(0, d - width + 1), min(height, d + 1)
        a = sk[d + 1, y0 + 1:y1 + 1]  # left
        b = sk[d + 1, y0:y1]          # up
        c = sk[d, y0:y1]              # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        if not only_paeth:
            f = ftype[y0:y1]
            pred = np.where(f == 4, pred, np.where(f == 3, (a + b) >> 1,
                                                   np.where(f == 2, b, np.where(f == 1, a, 0))))
        sk[d + 2, y0 + 1:y1 + 1] = (raw[d, y0:y1] + pred) & 0xFF
    x = np.arange(width)[None, :]
    return sk[ys[:, None] + x + 2, ys[:, None] + 1].astype(np.uint8).reshape(height, -1)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw holds height rows of 1 + stride
    bytes, the first byte of each row naming its filter."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    bad = np.flatnonzero(rows[:, 0] > 4)
    if len(bad):
        raise ValueError(f"PNG: unknown filter type {rows[bad[0], 0]} in row {bad[0]}")
    if rows[:, 0].max(initial=0) <= 2:
        return _unfilter_rows(rows, bpp)
    return _unfilter_diagonals(rows, bpp)


def read_png(path: str) -> np.ndarray:
    """PNG -> [H, W] (gray) or [H, W, 3] (RGB, file order) uint8 or uint16."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG stream") -> np.ndarray:
    """read_png of the file's bytes; `path` labels the errors."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {path}")
    width, height, depth, ctype, _, _, interlace = header
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG {path}: bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; this codec reads 8/16-bit gray or RGB, not interlaced")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    return pix.reshape(height, width, ch)[..., 0] if ch == 1 else pix.reshape(height, width, ch)


def write_png(path: str, img: np.ndarray) -> None:
    """[H, W] or [H, W, 3] (RGB, file order) uint8 / uint16 -> PNG, filter 0."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: dtype {img.dtype}; uint8 or uint16 expected")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"write_png: shape {img.shape}; [H, W] or [H, W, 3] expected")
    height, width, ch = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(height, width * ch * img.dtype.itemsize)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, 0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


def read_image(path: str, flags: str = "color") -> np.ndarray:
    """A PNG or JPEG file, told apart by its signature as cv2.imread tells
    them apart: [H, W, 3] BGR uint8 as cv2.IMREAD_COLOR (flags "color") or
    [H, W] uint8 as cv2.IMREAD_GRAYSCALE (flags "gray"). A JPEG may be
    baseline, extended or progressive, gray, colour, CMYK or YCCK; an
    arithmetic-coded, 12-bit, lossless or hierarchical one raises
    NotImplementedError (data/jpeg.py), and a corrupt or truncated file
    ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, flags, name=path)
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    img = decode_png(data, path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if flags == "gray":
        return bgr_to_gray(img[..., ::-1]) if img.ndim == 3 else img
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., ::-1]


def load_im(path: str, fmt: str = "BGR") -> np.ndarray:
    """8-bit 3-channel image, BGR (or RGB with fmt="RGB"), as cv2.IMREAD_COLOR."""
    img = read_image(path)
    return img[..., ::-1] if fmt == "RGB" else img


def load_depth(path: str, depth_scale: float = 1.0) -> np.ndarray:
    """16-bit BOP depth png -> metres: raw * depth_scale / 1000
    (inout.load_depth semantics)."""
    d = read_png(path)
    if d.ndim == 3:
        d = d[..., 2]  # channel 0 of the BGR image
    return d.astype(np.float32) * depth_scale / 1000.0


def save_depth(path: str, depth_m: np.ndarray, depth_scale: float = 1.0) -> None:
    """Metres -> 16-bit png with the given depth_scale."""
    raw = np.round(depth_m * 1000.0 / depth_scale).astype(np.uint16)
    if not path.endswith(".png"):
        raise ValueError(f"save_depth writes PNG, got {path}")
    write_png(path, raw)


def load_json(path: str, keys_to_int: bool = False) -> dict:
    with open(path) as f:
        d = json.load(f)
    if keys_to_int:
        return {int(k): v for k, v in d.items()}
    return d


def save_json(path: str, obj) -> None:
    def _default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(obj, f, default=_default)


def load_cam_params(path: str) -> dict:
    """Camera json -> {im_size, K, depth_scale?} (reference
    lib/pysixd/inout.py:204-223)."""
    c = load_json(path)
    cam = {
        "im_size": (c["width"], c["height"]),
        "K": np.array([[c["fx"], 0.0, c["cx"]],
                       [0.0, c["fy"], c["cy"]],
                       [0.0, 0.0, 1.0]]),
    }
    if "depth_scale" in c:
        cam["depth_scale"] = float(c["depth_scale"])
    return cam
