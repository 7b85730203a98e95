"""Baseline JPEG read and write without cv2 (the JAX package reads JPEGs with
cv2.imread, gdrnet_tpu/data/io.py:13-18, gdrnet_tpu/data/mapper.py:109-116,
gdrnet_tpu/data/augment.py:459, tools/predict.py:115-118).

The codec is host C++ (csrc/jpeg_codec.cpp), built with g++ at first use and
called through ctypes, which releases the GIL, so loader threads decode at
once. It computes what libjpeg-turbo 3.1 computes, as OpenCV calls it:
  decode_jpeg(data, "color")  cv2.imdecode(buf, cv2.IMREAD_COLOR): BGR, a gray
                              JPEG replicated to three channels, a CMYK or
                              YCCK JPEG through OpenCV's CMYK -> BGR;
  decode_jpeg(data, "gray")   cv2.IMREAD_GRAYSCALE;
  encode_jpeg(img, q, s)      cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q,
                              IMWRITE_JPEG_SAMPLING_FACTOR, s]), byte for byte;
both decodes read baseline, extended sequential and progressive Huffman
JPEGs of 1, 3 or 4 components and apply the EXIF orientation tag as OpenCV
does. A corrupt or truncated stream raises ValueError (where cv2.imread
would return None or an image padded after a warning). Arithmetic-coded,
12-bit, lossless and hierarchical JPEGs raise NotImplementedError, and so
does a progressive JPEG whose scans leave a low coefficient unrefined (one
that libjpeg outputs through its block smoothing); the encoder writes
baseline only, as cv2.imencode does by default.

`calls` counts the codec's calls by kind ("decode", "encode"), exact under
concurrent callers, so that a run can show which path decoded JPEGs.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

from gdrnet_tpu_torch import csrc

JPEG_SIGNATURE = b"\xff\xd8\xff"
# luma (h, v) sampling factors by the name of the chroma subsampling
SAMPLING = {"420": (2, 2), "422": (2, 1), "444": (1, 1), "440": (1, 2), "411": (4, 1)}

calls = {"decode": 0, "encode": 0}
_CALLS_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()
_ERR_LEN = 256


def _count(kind: str) -> None:
    with _CALLS_LOCK:
        calls[kind] += 1


@functools.cache
def _loaded() -> ctypes.CDLL:
    lib = csrc.load("jpeg_codec")
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    lib.gdr_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, u8pp,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
    lib.gdr_jpeg_decode.restype = ctypes.c_int
    lib.gdr_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8pp,
                                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
    lib.gdr_jpeg_encode.restype = ctypes.c_int
    lib.gdr_jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.gdr_jpeg_free.restype = None
    return lib


def _lib() -> ctypes.CDLL:
    with _BUILD_LOCK:  # one build when several loader threads start at once
        return _loaded()


def _raise(code: int, err: ctypes.Array, what: str) -> None:
    msg = err.value.decode(errors="replace")
    if code == 2:
        raise NotImplementedError(f"{what}: {msg}; the port decodes baseline, extended "
                                  "sequential and progressive Huffman JPEGs of 8-bit samples; "
                                  "arithmetic-coded, 12-bit, lossless and hierarchical ones "
                                  "are refused")
    raise ValueError(f"{what}: {msg}")


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: flips and a transpose by the EXIF tag."""
    if orientation >= 5:
        img = np.swapaxes(img, 0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, flags: str = "color", name: str = "JPEG stream") -> np.ndarray:
    """JPEG bytes -> [H, W, 3] BGR uint8 (flags "color") or [H, W] (flags
    "gray"), oriented by the EXIF tag. `name` labels the errors."""
    if flags not in ("color", "gray"):
        raise ValueError(f"decode_jpeg: flags {flags!r}; 'color' or 'gray' expected")
    data = bytes(data)
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    info = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _count("decode")
    code = lib.gdr_jpeg_decode(data, len(data), int(flags == "gray"), ctypes.byref(out), info,
                               err, _ERR_LEN)
    if code:
        _raise(code, err, name)
    try:
        h, w, c = info[0], info[1], info[2]
        img = np.ctypeslib.as_array(out, shape=(h * w * c,)).copy()
    finally:
        lib.gdr_jpeg_free(out)
    img = img.reshape((h, w, c) if c == 3 else (h, w))
    return _orient(img, info[3])


def read_jpeg(path: str, flags: str = "color") -> np.ndarray:
    """decode_jpeg of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), flags, name=path)


def encode_jpeg(img: np.ndarray, quality: int = 95, sampling: str = "420",
                restart_interval: int = 0) -> bytes:
    """[H, W] gray or [H, W, 3] BGR uint8 -> baseline JFIF bytes, as
    cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality,
    IMWRITE_JPEG_SAMPLING_FACTOR, <sampling>, IMWRITE_JPEG_RST_INTERVAL,
    restart_interval]) writes them. `sampling` is a key of SAMPLING; a gray
    image ignores it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"encode_jpeg: {img.dtype} {img.shape}; uint8 [H, W] or [H, W, 3] expected")
    if sampling not in SAMPLING:
        raise ValueError(f"encode_jpeg: sampling {sampling!r}; one of {sorted(SAMPLING)}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _count("encode")
    code = lib.gdr_jpeg_encode(img.ctypes.data, w, h, ch, int(quality), *SAMPLING[sampling],
                               int(restart_interval), ctypes.byref(out), ctypes.byref(size),
                               err, _ERR_LEN)
    if code:
        raise ValueError(f"encode_jpeg: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.gdr_jpeg_free(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95, sampling: str = "420",
               restart_interval: int = 0) -> None:
    """encode_jpeg into a file."""
    data = encode_jpeg(img, quality, sampling, restart_interval)
    with open(path, "wb") as f:
        f.write(data)
