"""Image / depth / json IO (counterpart of gdrnet_tpu/data/io.py).

The JAX module reads and writes PNGs through OpenCV. This one carries its
own small PNG codec (zlib + struct + numpy), so the port needs no cv2:
8- and 16-bit, gray and RGB, non-interlaced; every filter type on read,
filter 0 on write. `load_im`, `load_depth` and `save_depth` give what the
JAX module's cv2 calls give on such files: `load_im` returns BGR like
cv2.IMREAD_COLOR (gray replicated to three channels, 16-bit cut to its high
byte), `load_depth` takes channel 0 of the BGR image when the file has
three channels.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # PNG colour type -> channels: gray, RGB


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw holds height rows of 1 + stride
    bytes, the first byte of each row naming its filter."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per byte lane, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """PNG -> [H, W] (gray) or [H, W, 3] (RGB, file order) uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
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


def load_im(path: str, fmt: str = "BGR") -> np.ndarray:
    """8-bit 3-channel image, BGR (or RGB with fmt="RGB"), as cv2.IMREAD_COLOR."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    rgb = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img
    return rgb if fmt == "RGB" else rgb[..., ::-1]


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
