"""Per-instance ROI train mapper: BOP record -> fixed-shape ROI training sample
(counterpart of gdrnet_tpu/data/mapper.py:26-310,470-473).

The reference's GDRN_DatasetFromList.read_data (core/gdrn_modeling/
data_loader.py:304-633) as the JAX package restates it: DZI bbox aug, warp
crops with bilinear img / nearest mask+xyz, xyz normalised by extent + 0.5,
CE binning, SITE trans ratios; channels-last numpy arrays. The mapper stays
host numpy driven by an explicit np.random.RandomState, with data/cv_ops in
place of cv2, so that the same record and seed give the JAX mapper's sample.

The one device step is the on-the-fly XYZ ground truth of a record without
an xyz_crop pickle: a full-frame ops/rasterizer.render_xyz on the mapper's
`device`, which on a CUDA device launches the z-buffer kernel
(csrc/rasterize_xyz.cu). Loader threads call the mapper concurrently while
the train step runs on the default stream, so each thread renders on a CUDA
stream of its own and waits for that stream alone before the copy back.

GDRNRawTrainMapper and GDRNDeviceTestMapper feed the JAX package's device
pipeline, which the port does not need (ROADMAP.md "Do not port");
GDRNTestMapper comes with do_test (ROADMAP.md A7).
"""

from __future__ import annotations

import os.path as osp
import pickle
import threading

import numpy as np
import torch

from gdrnet_tpu_torch.data import cv_ops
from gdrnet_tpu_torch.data.augment import BackgroundReplacer, build_color_augmentor
from gdrnet_tpu_torch.data.io import load_im, read_png
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.data.ply import load_ply
from gdrnet_tpu_torch.ops.rasterizer import render_xyz
from gdrnet_tpu_torch.ops.warp import affine_params


def crop_resize(img: np.ndarray, center, scale, out_size: int,
                interp: str = cv_ops.INTER_LINEAR) -> np.ndarray:
    """The warp crop of the reference's crop_resize_by_warp_affine
    (core/utils/data_utils.py:80-93) with the closed-form affine."""
    M = affine_params(center, scale, 0.0, out_size)
    return cv_ops.warp_affine(img, M, out_size, interp)


def dzi_aug_bbox(bbox_xyxy, im_h, im_w, rng, dzi_type="uniform",
                 pad_scale=1.5, scale_ratio=0.25, shift_ratio=0.25):
    """DZI bbox augmentation (reference base_data_loader.aug_bbox:120-152)."""
    x1, y1, x2, y2 = [float(v) for v in bbox_xyxy]
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    t = dzi_type.lower()
    if t == "uniform":
        s = 1 + scale_ratio * (2 * rng.random_sample() - 1)
        sh = shift_ratio * (2 * rng.random_sample(2) - 1)
        center = np.array([cx + bw * sh[0], cy + bh * sh[1]])
        scale = max(bh, bw) * s * pad_scale
    elif t == "roi10d":
        a, b = -0.15, 0.15
        x1 += bw * (rng.rand() * (b - a) + a)
        x2 += bw * (rng.rand() * (b - a) + a)
        y1 += bh * (rng.rand() * (b - a) + a)
        y2 += bh * (rng.rand() * (b - a) + a)
        x1, x2 = np.clip([x1, x2], 0, im_w)
        y1, y2 = np.clip([y1, y2], 0, im_h)
        center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
        scale = max(y2 - y1, x2 - x1) * pad_scale
    else:  # none
        center = np.array([cx, cy])
        scale = max(bh, bw) * pad_scale
    scale = min(scale, max(im_h, im_w)) * 1.0
    return center.astype(np.float32), float(scale)


def get_2d_coord_np(w: int, h: int) -> np.ndarray:
    """[H,W,2] normalized pixel coords (data_utils.get_2d_coord_np:222)."""
    x = np.linspace(0, 1, w, dtype=np.float32)
    y = np.linspace(0, 1, h, dtype=np.float32)
    xm, ym = np.meshgrid(x, y)
    return np.stack([xm, ym], axis=-1)


def roi_coord_2d(im_w: int, im_h: int, center, scale, out_res: int) -> np.ndarray:
    """Full-image normalized coord map cropped to the ROI — encodes WHERE the
    ROI sits in the image (reference crops get_2d_coord_np(im_W, im_H) with
    the same affine, data_loader.py:501-504). Computed in closed form instead
    of warping the full map."""
    M = affine_params(center, scale, 0.0, out_res, inv=True)
    dy, dx = np.mgrid[0:out_res, 0:out_res].astype(np.float32)
    sx = M[0, 0] * dx + M[0, 1] * dy + M[0, 2]
    sy = M[1, 0] * dx + M[1, 1] * dy + M[1, 2]
    return np.stack([sx / max(im_w - 1, 1), sy / max(im_h - 1, 1)], axis=-1)


def smooth_xyz(xyz: np.ndarray) -> np.ndarray:
    """Median-filter the XYZ map's edge pixels to suppress render noise
    (reference smooth_xyz, data_loader.py:635-641: replace Laplacian-edge
    pixels with the 3x3 median)."""
    xyz = np.asarray(xyz, np.float32)
    blurred = cv_ops.median_blur3(xyz)
    gray = np.any(xyz != 0, axis=-1).astype(np.uint8)
    edges = cv_ops.laplacian(gray.astype(np.float32))
    out = xyz.copy()
    out[edges != 0] = blurred[edges != 0]
    return out


def xyz_to_region_np(xyz: np.ndarray, fps_points: np.ndarray) -> np.ndarray:
    """Nearest-FPS region labels, 0 = bg (data_utils.xyz_to_region:213).

    argmin of |x-f|^2 = |x|^2 - 2 x.f + |f|^2 via one [HW,3]x[3,F] matmul
    (|x|^2 constant over f — dropped)."""
    h, w, _ = xyz.shape
    mask = np.any(xyz != 0, axis=-1)
    flat = xyz.reshape(-1, 3)
    scores = flat @ fps_points.T * (-2.0) + np.sum(fps_points ** 2, axis=1)[None]
    region = (np.argmin(scores, axis=-1).astype(np.int32) + 1).reshape(h, w)
    return np.where(mask, region, 0).astype(np.int32)


def read_color_image(path: str) -> np.ndarray:
    """8-bit BGR image, as cv2.IMREAD_COLOR reads a PNG (reference
    read_image_cv2, core/utils/data_utils.py:6)."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"{path}: the port decodes PNG only; JPEG decoding is not ported yet "
            "(ROADMAP.md A13)")
    return np.ascontiguousarray(load_im(path))


def read_gray_image(path: str) -> np.ndarray:
    """8-bit gray image, as cv2.IMREAD_GRAYSCALE reads a PNG."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return cv_ops.bgr_to_gray(img[..., ::-1]) if img.ndim == 3 else img


class GDRNTrainMapper:
    """record, RandomState -> training sample, as the JAX package's mapper.
    `device` is where a missing XYZ ground truth is rendered."""

    def __init__(self, cfg, models: ObjectModels,
                 bg_replacer: BackgroundReplacer | None = None, device="cuda"):
        self.cfg = cfg
        self.models = models
        inp = cfg.INPUT
        self.input_res = cfg.MODEL.CDPN.BACKBONE.INPUT_RES
        self.out_res = cfg.MODEL.CDPN.BACKBONE.OUTPUT_RES
        self.dzi_type = inp.DZI_TYPE
        self.dzi_pad = inp.DZI_PAD_SCALE
        self.dzi_scale = inp.DZI_SCALE_RATIO
        self.dzi_shift = inp.DZI_SHIFT_RATIO
        self.color_aug_prob = inp.COLOR_AUG_PROB
        self.color_aug_syn_only = inp.COLOR_AUG_SYN_ONLY
        self.color_aug = (build_color_augmentor(inp.COLOR_AUG_TYPE,
                                                inp.get("COLOR_AUG_CODE"))
                          if inp.COLOR_AUG_PROB > 0 else None)
        self.change_bg_prob = inp.CHANGE_BG_PROB
        self.truncate_fg = inp.TRUNCATE_FG
        self.bg = bg_replacer
        self.xyz_bin = cfg.MODEL.CDPN.ROT_HEAD.XYZ_BIN
        self.with_bins = "CE" in cfg.MODEL.CDPN.ROT_HEAD.XYZ_LOSS_TYPE
        self.xyz_mask_gt = cfg.MODEL.CDPN.ROT_HEAD.XYZ_LOSS_MASK_GT
        self.pixel_mean = np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32)
        self.pixel_std = np.asarray(cfg.MODEL.PIXEL_STD, np.float32)
        self.device = torch.device(device)
        self._mesh_cache: dict = {}
        self._local = threading.local()  # each thread's CUDA stream

    # -- xyz GT --------------------------------------------------------
    def _stream(self) -> torch.cuda.Stream:
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        return stream

    def _render_xyz(self, rec, im_h, im_w) -> np.ndarray:
        """Full-frame XYZ of rec's object on the mapper's device, as a host
        array (tools/gen_xyz.py makes the offline artifacts; this path keeps
        small datasets self-serve)."""
        name = rec["label"]
        if name not in self._mesh_cache:
            ply = load_ply(self.models.meta.model_path(rec["obj_id"]),
                           vertex_scale=self.models.meta.vertex_scale)
            self._mesh_cache[name] = (ply["pts"], ply.get("faces"))
        verts, faces = self._mesh_cache[name]
        if self.device.type != "cuda":
            return render_xyz(verts, faces, rec["K"], rec["R"], rec["t"], im_h, im_w,
                              device=self.device)[1].numpy()
        stream = self._stream()
        with torch.cuda.stream(stream):
            _, xyz = render_xyz(verts, faces, rec["K"], rec["R"], rec["t"], im_h, im_w,
                                device=self.device)
            stream.synchronize()  # this thread's renders only, not the train step
            return xyz.cpu().numpy()

    def _load_xyz(self, rec, im_h, im_w) -> np.ndarray:
        path = rec.get("xyz_path")
        if path and osp.exists(path):
            with open(path, "rb") as f:
                info = pickle.load(f)
            x1, y1, x2, y2 = info["xyxy"]
            xyz = np.zeros((im_h, im_w, 3), np.float32)
            xyz[y1:y2 + 1, x1:x2 + 1] = np.asarray(info["xyz_crop"], np.float32)
            return xyz
        return self._render_xyz(rec, im_h, im_w)

    # -- main ----------------------------------------------------------
    def __call__(self, rec: dict, rng: np.random.RandomState) -> dict:
        img = read_color_image(rec["rgb_path"])
        im_h, im_w = img.shape[:2]

        xyz = self._load_xyz(rec, im_h, im_w)
        if self.cfg.INPUT.SMOOTH_XYZ:
            xyz = smooth_xyz(xyz)
        mask_obj = np.any(xyz != 0, axis=-1).astype(np.float32)

        mask_visib = None
        if rec.get("mask_visib_path") and osp.exists(rec["mask_visib_path"]):
            mask_visib = (read_gray_image(rec["mask_visib_path"]) > 0).astype(np.float32)
        if mask_visib is None:
            mask_visib = mask_obj.copy()
        mask_visib = mask_visib * mask_obj  # (reference data_loader.py:507)
        mask_trunc = mask_visib.copy()

        # bg replacement: mandatory only for bg-less "syn" renders (imgn
        # OpenGL); "syn_pbr"/"syn_blender" already have backgrounds and use
        # the CHANGE_BG_PROB branch like real (data_loader.py:321-346)
        is_syn = rec.get("img_type", "real") == "syn"
        if self.bg is not None and (is_syn or rng.rand() < self.change_bg_prob):
            img, mask_trunc_new = self.bg.replace(
                img, mask_trunc, rng, truncate_fg=self.truncate_fg)
            mask_trunc = mask_trunc * mask_trunc_new

        # color aug; COLOR_AUG_SYN_ONLY means any synthetic img_type, as in
        # the JAX package (the reference's branch at data_loader.py:340-343
        # augments both arms)
        if self.color_aug is not None and rng.rand() < self.color_aug_prob:
            if not (self.color_aug_syn_only
                    and rec.get("img_type", "real") == "real"):
                img = self.color_aug(img, rng)
        # convert AFTER bg/color aug — those ops are BGR-defined (INPUT.FORMAT)
        if self.cfg.INPUT.get("FORMAT", "BGR").upper() == "RGB":
            img = np.ascontiguousarray(img[..., ::-1])

        # DZI bbox aug on the xyz-derived bbox (reference overrides bbox
        # with xyz xyxy, data_loader.py:477-479)
        ys, xs = np.nonzero(mask_obj)
        if len(xs) == 0:
            raise ValueError("empty object mask")
        bbox = [xs.min(), ys.min(), xs.max(), ys.max()]
        center, scale = dzi_aug_bbox(
            bbox, im_h, im_w, rng, self.dzi_type, self.dzi_pad,
            self.dzi_scale, self.dzi_shift)
        bw = max(bbox[2] - bbox[0], 1)
        bh = max(bbox[3] - bbox[1], 1)

        roi_img = crop_resize(img, center, scale, self.input_res, cv_ops.INTER_LINEAR)
        roi_img = (roi_img.astype(np.float32) - self.pixel_mean) / self.pixel_std

        near = cv_ops.INTER_NEAREST
        roi_mask_trunc = crop_resize(mask_trunc, center, scale, self.out_res, near)
        roi_mask_visib = crop_resize(mask_visib, center, scale, self.out_res, near)
        roi_mask_obj = crop_resize(mask_obj, center, scale, self.out_res, near)
        roi_xyz = crop_resize(xyz, center, scale, self.out_res, near)

        name = rec["label"]
        cls = self.models.label_of(name)
        extent = self.models.extents[name]
        region = xyz_to_region_np(roi_xyz, self.models.fps_points[name])

        roi_xyz_norm = roi_xyz / extent[None, None] + 0.5
        sample = {
            "roi_img": roi_img.astype(np.float32),
            "roi_classes": np.int32(cls),
            "roi_coord_2d": roi_coord_2d(im_w, im_h, center, scale, self.out_res),
            "roi_cams": rec["K"].astype(np.float32),
            "roi_centers": center.astype(np.float32),
            "roi_whs": np.asarray([bw, bh], np.float32),
            "roi_extents": extent.astype(np.float32),
            "resize_ratios": np.float32(self.out_res / scale),
            "gt_xyz": roi_xyz_norm.astype(np.float32),
            "gt_mask_trunc": roi_mask_trunc.astype(np.float32),
            "gt_mask_visib": roi_mask_visib.astype(np.float32),
            "gt_mask_obj": roi_mask_obj.astype(np.float32),
            "gt_region": region,
            "gt_ego_rot": rec["R"].astype(np.float32),
            "gt_trans": rec["t"].astype(np.float32),
            "gt_points": self.models.points_stack[cls],
            "sym_rots": self.models.sym_rots_stack[cls],
            "sym_mask": self.models.sym_mask_stack[cls],
        }

        if self.with_bins:
            norm = np.clip(roi_xyz_norm, 0, 0.999999)
            bins = (norm * self.xyz_bin).astype(np.int32)
            roi_masks = {"trunc": roi_mask_trunc, "visib": roi_mask_visib,
                         "obj": roi_mask_obj}
            m = roi_masks[self.xyz_mask_gt]
            bins[m == 0] = self.xyz_bin  # last bin = bg
            sample["gt_xyz_bin"] = bins
        else:
            sample["gt_xyz_bin"] = np.zeros(
                (self.out_res, self.out_res, 3), np.int32)

        # SITE ratios (data_loader.py:628-632)
        uvw = rec["K"] @ rec["t"]
        centroid = uvw[:2] / max(uvw[2], 1e-12)
        dc = centroid - center
        resize_ratio = self.out_res / scale
        sample["gt_trans_ratio"] = np.asarray(
            [dc[0] / bw, dc[1] / bh, rec["t"][2] / resize_ratio], np.float32)
        return sample


def collate(samples: list[dict]) -> dict:
    """Stack per-sample dicts into one batch dict of numpy arrays."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
