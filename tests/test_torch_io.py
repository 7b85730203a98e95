"""The port's PNG codec and image / depth IO (gdrnet_tpu_torch/data/io.py)
against OpenCV and the JAX package's cv2-based gdrnet_tpu/data/io.py.

Files cv2 writes (libpng's adaptive filters), files written here with each
PNG filter type forced on every row (and mixed per row), and files the port
writes must all read back exactly equal: the codec is lossless, so every
comparison is exact.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from gdrnet_tpu.data import io as jio

from gdrnet_tpu_torch.data import io


def _image(rng, kind: str) -> np.ndarray:
    """Smooth gradients plus noise plus flat patches, so that libpng's
    heuristic picks several filter types."""
    h, w = 37, 53
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 3 + yy * 5) % 256
    if kind == "depth16":
        d = 400 + 3 * xx + 7 * yy + rng.randint(0, 3, (h, w))
        d[5:15, 10:30] = 0
        d[20:, :8] = 65535
        return d.astype(np.uint16)
    if kind == "gray8":
        return np.clip(smooth + rng.randint(0, 9, (h, w)), 0, 255).astype(np.uint8)
    rgb = np.stack([smooth, (smooth * 2) % 256, rng.randint(0, 256, (h, w))], -1)
    rgb[10:20, 10:20] = 77
    return rgb.astype(np.uint8)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """A PNG of img ([H,W] or [H,W,3], file channel order) whose row y uses
    filter type filters[y % len(filters)]."""
    img = img[..., None] if img.ndim == 2 else img
    h, w, ch = img.shape
    raw = img.astype(img.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = ch * img.dtype.itemsize
    out = []
    for y in range(h):
        x = raw[y]
        up = raw[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        ftype = filters[y % len(filters)]
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def _bgr(img):
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("kind", ["depth16", "gray8", "rgb8"])
def test_read_png_equals_cv2_on_cv2_files(rng, tmp_path, kind):
    img = _image(rng, kind)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, _bgr(img))
    np.testing.assert_array_equal(io.read_png(path), img)
    np.testing.assert_array_equal(_bgr(io.read_png(path)), cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["depth16", "gray8", "rgb8"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0),
                                     # PIL's choice: Sub on the first row, Paeth on the rest
                                     (1,) + (4,) * 36, (3,) + (4,) * 36])
def test_read_png_undoes_every_filter_type(rng, tmp_path, kind, filters):
    img = _image(rng, kind)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, filters))
    np.testing.assert_array_equal(io.read_png(str(path)), img)
    np.testing.assert_array_equal(_bgr(io.read_png(str(path))),
                                  cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["depth16", "gray8", "rgb8"])
def test_write_png_reads_back_through_cv2(rng, tmp_path, kind):
    img = _image(rng, kind)
    path = str(tmp_path / "w.png")
    io.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), _bgr(img))
    np.testing.assert_array_equal(io.read_png(path), img)


@pytest.mark.parametrize("kind", ["depth16", "gray8", "rgb8"])
@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
def test_load_im_equals_jax_package(rng, tmp_path, kind, fmt):
    img = _image(rng, kind)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, _bgr(img))
    np.testing.assert_array_equal(io.load_im(path, fmt), jio.load_im(path, fmt))


@pytest.mark.parametrize("kind", ["depth16", "rgb8"])
def test_depth_io_equals_jax_package(rng, tmp_path, kind):
    img = _image(rng, kind)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, _bgr(img))
    np.testing.assert_array_equal(io.load_depth(path, 0.1), jio.load_depth(path, 0.1))
    depth_m = rng.uniform(0.3, 1.5, (20, 30)).astype(np.float32)
    depth_m[3:6] = 0
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    io.save_depth(ours, depth_m, 0.25)
    jio.save_depth(theirs, depth_m, 0.25)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(io.load_depth(ours, 0.25), jio.load_depth(theirs, 0.25))


def test_json_equals_jax_package(tmp_path):
    obj = {"3": [1.5, 2], "7": np.arange(3), "9": np.float32(0.5)}
    io.save_json(str(tmp_path / "p.json"), obj)
    jio.save_json(str(tmp_path / "j.json"), obj)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    for keys_to_int in (False, True):
        assert (io.load_json(str(tmp_path / "p.json"), keys_to_int)
                == jio.load_json(str(tmp_path / "p.json"), keys_to_int))


def test_read_png_rejects_what_it_cannot_read(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        io.read_png(str(bad))
    rgba = np.zeros((4, 4, 4), np.uint8)
    cv2.imwrite(str(tmp_path / "rgba.png"), rgba)
    with pytest.raises(ValueError, match="colour type 6"):
        io.read_png(str(tmp_path / "rgba.png"))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        io.write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.float32))
