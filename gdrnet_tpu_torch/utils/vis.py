"""Visualization helpers, host-side numpy (counterpart of
gdrnet_tpu/utils/vis.py: the reference's lib/vis_utils/image.py grid_show,
vis_image_mask_bbox_cv2, vis_image_bboxes_cv2 and colormap.py).

The drawings are the JAX package's, with data/cv_ops's stand-ins in place
of cv2.rectangle, cv2.line and cv2.putText (bit for bit with OpenCV 5.0).
grid_show draws the JAX package's matplotlib figure where matplotlib
imports; where it does not (the card's machine has no matplotlib), it
writes the same row x col grid as one uint8 RGB mosaic with the titles
drawn by cv_ops.put_text, and returns that.
"""

from __future__ import annotations

import numpy as np

from gdrnet_tpu_torch.data import cv_ops
from gdrnet_tpu_torch.data.io import write_png

_COLORS = np.array([
    [0.000, 0.447, 0.741], [0.850, 0.325, 0.098], [0.929, 0.694, 0.125],
    [0.494, 0.184, 0.556], [0.466, 0.674, 0.188], [0.301, 0.745, 0.933],
    [0.635, 0.078, 0.184], [0.300, 0.300, 0.300], [0.600, 0.600, 0.600],
    [1.000, 0.000, 0.000], [1.000, 0.500, 0.000], [0.749, 0.749, 0.000],
    [0.000, 1.000, 0.000], [0.000, 0.000, 1.000], [0.667, 0.000, 1.000],
])
# the mosaic: PAD px around and between cells, a TITLE_H px title strip
# above each panel (the title's baseline TITLE_BASELINE px down), white
# ground and black titles
PAD, TITLE_H, TITLE_BASELINE = 4, 18, 13


def colormap(idx: int, bgr: bool = True, uint8: bool = True):
    c = _COLORS[idx % len(_COLORS)]
    if bgr:
        c = c[::-1]
    return (c * 255).astype(np.uint8).tolist() if uint8 else c


def grid_backend() -> str:
    """"matplotlib" where matplotlib imports, else "mosaic": what grid_show
    draws with."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return "mosaic"
    return "matplotlib"


def _panel_rgb(img) -> np.ndarray:
    """A panel as imshow takes it, as uint8 RGB [H, W, 3]: 3-channel uint8
    flipped from BGR, floats clipped to [0, 1] and scaled to 0-255, a 2-D
    panel as grey."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8:
        img = img[..., ::-1]
    if img.dtype != np.uint8:
        img = (np.clip(img.astype(np.float64), 0.0, 1.0) * 255).round().astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img)


def mosaic_cells(images, titles, row: int, col: int) -> tuple[tuple[int, int], list]:
    """The mosaic's (height, width) and each panel's top-left (y, x) in it:
    cells as large as the largest panel (and as wide as the widest title),
    row-major; as in the figure, panels past row * col are left out."""
    cell_h = max(np.asarray(im).shape[0] for im in images) if images else 0
    cell_w = max([np.asarray(im).shape[1] for im in images]
                 + [cv_ops.get_text_size(str(t)) for t in (titles or [])] + [0])
    step_y, step_x = TITLE_H + cell_h + PAD, cell_w + PAD
    origins = [(PAD + (i // col) * step_y + TITLE_H, PAD + (i % col) * step_x)
               for i in range(min(len(images), row * col))]
    return (PAD + row * step_y, PAD + col * step_x), origins


def _mosaic(images, titles, row: int, col: int) -> np.ndarray:
    (h, w), origins = mosaic_cells(images, titles, row, col)
    out = np.full((h, w, 3), 255, np.uint8)
    for i, (y, x) in enumerate(origins):
        panel = _panel_rgb(images[i])
        out[y:y + panel.shape[0], x:x + panel.shape[1]] = panel
        if titles and i < len(titles):
            cv_ops.put_text(out, str(titles[i]), (x, y - TITLE_H + TITLE_BASELINE), (0, 0, 0))
    return out


def grid_show(images, titles=None, row: int = 1, col: int | None = None,
              save_path: str | None = None, show: bool = False):
    """The images in a row x col grid (reference grid_show, lib/vis_utils/
    image.py:31). With matplotlib: its figure, saved at save_path when given
    (as the JAX package draws it). Without: the uint8 RGB mosaic of
    mosaic_cells, written as a PNG at save_path when given; `show` needs
    matplotlib."""
    n = len(images)
    col = col or -(-n // row)
    if grid_backend() == "mosaic":
        if show:
            raise ValueError("grid_show: show=True needs matplotlib, which does not import")
        out = _mosaic(images, titles, row, col)
        if save_path:
            write_png(save_path, out)
        return out
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(row, col, squeeze=False, figsize=(3 * col, 3 * row))
    for i in range(row * col):
        ax = axes[i // col][i % col]
        ax.axis("off")
        if i < n:
            img = np.asarray(images[i])
            if img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8:
                img = img[..., ::-1]  # BGR -> RGB for display
            ax.imshow(img)
            if titles and i < len(titles):
                ax.set_title(titles[i], fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
    if show:
        plt.show()
    return fig


def vis_image_bboxes_cv2(img: np.ndarray, bboxes, labels=None,
                         thickness: int = 2) -> np.ndarray:
    """Draw xyxy boxes + labels (reference vis_image_bboxes_cv2, :146)."""
    out = np.ascontiguousarray(img.copy())
    for i, box in enumerate(bboxes):
        x1, y1, x2, y2 = [int(v) for v in box]
        color = colormap(i)
        cv_ops.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        if labels is not None and i < len(labels):
            cv_ops.put_text(out, str(labels[i]), (x1, max(y1 - 4, 10)), color)
    return out


def vis_image_mask_cv2(img: np.ndarray, mask: np.ndarray,
                       color_idx: int = 0, alpha: float = 0.5) -> np.ndarray:
    """Blend a binary mask over the image (vis_image_mask_bbox_cv2, :113)."""
    out = img.astype(np.float32).copy()
    color = np.asarray(colormap(color_idx), np.float32)
    m = mask.astype(bool)
    out[m] = out[m] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def draw_projected_box3d(img: np.ndarray, corners_2d: np.ndarray,
                         color=None, thickness: int = 1) -> np.ndarray:
    """Draw a projected 3D box from its 8 projected corners (reference
    misc.draw_projected_box3d usage in dataset test_vis)."""
    out = np.ascontiguousarray(img.copy())
    color = color or colormap(3)
    c = corners_2d.astype(int)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        cv_ops.line(out, tuple(c[a]), tuple(c[b]), color, thickness)
    return out


def vis_xyz_map(xyz: np.ndarray) -> np.ndarray:
    """Normalized XYZ map [H,W,3] in [0,1] -> uint8 RGB for panels."""
    return np.clip(np.asarray(xyz) * 255, 0, 255).astype(np.uint8)
