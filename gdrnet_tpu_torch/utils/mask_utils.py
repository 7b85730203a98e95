"""Binary-mask utilities: COCO RLE codec (pure numpy — no pycocotools in the
image), bbox extraction, edges, dilation. The port's copy of
gdrnet_tpu/utils/mask_utils.py, with data/cv_ops's stand-ins for
cv2.fillPoly, cv2.dilate and cv2.erode.

Parity target: lib/utils/mask_utils.py in the reference
(binary_mask_to_rle:54, rle2mask:93, segmToRLE:103, cocosegm2mask:122,
mask2bbox_xyxy:39, get_edge:22, mask_dilate:128). The compressed RLE string
codec follows the COCO maskApi byte format (rleToString/rleFrString):
column-major counts, 5-bit groups with a continuation bit, delta-coded
against counts[i-2] from the third run on.
"""

from __future__ import annotations

import numpy as np

from gdrnet_tpu_torch.data import cv_ops


# -- COCO RLE codec ---------------------------------------------------------


def _counts_from_mask(mask: np.ndarray) -> list[int]:
    """Fortran-order run lengths, first run counts zeros (COCO convention)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # run-length encode
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return [int(r) for r in runs]


def _mask_from_counts(counts: list[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def rle_encode_string(counts: list[int]) -> str:
    """COCO maskApi rleToString: 5-bit groups + continuation, delta vs
    counts[i-2] for i >= 2."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            g = x & 0x1F
            x >>= 5
            more = (x != -1) if (g & 0x10) else (x != 0)
            if more:
                g |= 0x20
            out.append(chr(g + 48))
    return "".join(out)


def rle_decode_string(s: str | bytes) -> list[int]:
    """Inverse of rle_encode_string."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: list[int] = []
    i = 0
    while i < len(s):
        x, k = 0, 0
        more = True
        while more:
            g = ord(s[i]) - 48
            x |= (g & 0x1F) << (5 * k)
            more = bool(g & 0x20)
            i += 1
            if not more and (g & 0x10):
                x |= -1 << (5 * (k + 1))  # sign-extend
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


def binary_mask_to_rle(mask: np.ndarray, compressed: bool = True) -> dict:
    """mask [H,W] -> COCO rle dict (reference mask_utils.py:54-66)."""
    h, w = mask.shape
    counts = _counts_from_mask(mask)
    if compressed:
        return {"counts": rle_encode_string(counts), "size": [h, w]}
    return {"counts": counts, "size": [h, w]}


def rle2mask(rle: dict, height: int | None = None,
             width: int | None = None) -> np.ndarray:
    """COCO rle dict (compressed string or plain counts) -> mask [H,W]."""
    h, w = rle.get("size", (height, width))
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_decode_string(counts)
    return _mask_from_counts(list(counts), int(h), int(w))


def segm_to_rle(segm, h: int, w: int) -> dict:
    """Polygon list / uncompressed rle / rle -> compressed rle
    (reference segmToRLE, mask_utils.py:103-119)."""
    if isinstance(segm, list):
        return binary_mask_to_rle(_polygons_to_mask(segm, h, w))
    if isinstance(segm["counts"], list):
        return {"counts": rle_encode_string(segm["counts"]),
                "size": segm["size"]}
    return segm


def cocosegm2mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation form -> binary mask (mask_utils.py:122-125)."""
    return rle2mask(segm_to_rle(segm, h, w))


def _polygons_to_mask(polys: list, h: int, w: int) -> np.ndarray:
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys]
    return cv_ops.fill_poly(np.zeros((h, w), np.uint8), pts, 1)


# -- mask geometry ------------------------------------------------------------


def mask2bbox_xyxy(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def mask2bbox_xywh(mask: np.ndarray) -> np.ndarray:
    x1, y1, x2, y2 = mask2bbox_xyxy(mask)
    return np.asarray([x1, y1, x2 - x1 + 1, y2 - y1 + 1], np.float32)


def get_edge(mask: np.ndarray, bw: int = 1, out_channel: int = 3) -> np.ndarray:
    """Mask boundary band of width bw (reference get_edge, mask_utils.py:22)."""
    m = np.asarray(mask, np.uint8)
    edge = cv_ops.dilate(m, 2 * bw + 1) - cv_ops.erode(m, 2 * bw + 1)
    if out_channel == 3:
        edge = np.repeat(edge[..., None], 3, axis=-1)
    return edge


def mask_dilate(mask: np.ndarray, thickness: int = 10) -> np.ndarray:
    return cv_ops.dilate(np.asarray(mask, np.uint8), thickness)
