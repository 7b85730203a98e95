"""Box format helpers (the port's copy of gdrnet_tpu/utils/bbox_utils.py) —
reference lib/utils/bbox_utils.py:26-130 semantics
(xyxy boxes are inclusive of the far pixel: width = x2 - x1 + 1), batched
over [..., 4] numpy arrays.
"""

from __future__ import annotations

import numpy as np


def clip_xyxy_to_im(xyxy: np.ndarray, height: int, width: int) -> np.ndarray:
    """Clip boxes to image bounds (bbox_utils.py:26-57)."""
    b = np.asarray(xyxy, np.float64).copy()
    b[..., 0] = np.clip(b[..., 0], 0, width - 1)
    b[..., 2] = np.clip(b[..., 2], 0, width - 1)
    b[..., 1] = np.clip(b[..., 1], 0, height - 1)
    b[..., 3] = np.clip(b[..., 3], 0, height - 1)
    return b


def xyxy_to_xywh(xyxy: np.ndarray) -> np.ndarray:
    """[x1, y1, x2, y2] -> [x1, y1, w, h] with w = x2 - x1 + 1
    (bbox_utils.py:60-76)."""
    b = np.asarray(xyxy, np.float64)
    return np.concatenate(
        [b[..., :2], b[..., 2:4] - b[..., :2] + 1.0], axis=-1)


def xywh_to_xyxy(xywh: np.ndarray) -> np.ndarray:
    """[x1, y1, w, h] -> [x1, y1, x2, y2] with x2 = x1 + w - 1
    (bbox_utils.py:79-95)."""
    b = np.asarray(xywh, np.float64)
    return np.concatenate(
        [b[..., :2], b[..., :2] + np.maximum(b[..., 2:4] - 1.0, 0.0)],
        axis=-1)


def boxes_area(boxes: np.ndarray):
    """Inclusive-pixel area of xyxy boxes -> (areas, negative_area_indices)
    (bbox_utils.py:98-109 return shape)."""
    b = np.asarray(boxes, np.float64)
    w = b[..., 2] - b[..., 0] + 1.0
    h = b[..., 3] - b[..., 1] + 1.0
    areas = w * h
    return areas, np.where(areas.reshape(-1) < 0)[0]


def bbox_center(bbox: np.ndarray, fmt: str = "xyxy") -> np.ndarray:
    """Box center [cx, cy] (bbox_utils.py:112-130)."""
    b = np.asarray(bbox, np.float64)
    if fmt == "xyxy":
        return (b[..., :2] + b[..., 2:4]) / 2.0
    if fmt == "xywh":
        return b[..., :2] + (b[..., 2:4] - 1.0) / 2.0
    raise ValueError(f"unknown bbox fmt {fmt!r}")


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [N, 4] x [M, 4] xyxy boxes -> [N, M] (inclusive
    pixel convention, matching boxes_area)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    union = boxes_area(a)[0][:, None] + boxes_area(b)[0][None] - inter
    return inter / np.maximum(union, 1e-12)
