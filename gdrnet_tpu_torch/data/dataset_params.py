"""BOP dataset parameters for the full BOP family (LM, LM-O, T-LESS,
TUD-L, TYO-L, RU-APC, IC-MI, IC-BIN, ITODD, HB/HBS, YCB-V); the port's copy
of gdrnet_tpu/data/dataset_params.py, over data/io.py's camera reader.
Reference lib/pysixd/dataset_params.py:15-391 semantics: the same dict keys and
path templates over the standard BOP directory layout, so tooling
written against the reference's `dp_split`/`dp_model` dicts ports
unchanged.

Layout notes mirrored from the reference:
- `hbs` (BOP'19/20 subset) and `hb` share the `hb/` directory; `ycbv`
  and `ycbvposecnn` share `ycbv/`.
- T-LESS defaults: `cad` models, `primesense` sensor; HB/T-LESS/YCB-V
  camera files are per-sensor (`camera_<type>.json`).
- ITODD is gray+depth with `.tif` images; PBR RGB is `.jpg`.
"""

from __future__ import annotations

import glob
import math
import os
from os.path import join

from gdrnet_tpu_torch.data.io import load_cam_params

HALF_PI = 0.5 * math.pi
TWO_PI = 2 * math.pi

# Directory aliases: datasets that live inside another dataset's folder.
_DIR_ALIAS = {"hbs": "hb", "ycbvposecnn": "ycbv"}

# Per-sensor camera files and the default sensor (reference :28-52).
_CAM_SENSOR_DEFAULT = {
    "tless": "primesense",
    "hb": "primesense",
    "hbs": "primesense",
    "ycbv": "uw",
    "ycbvposecnn": "uw",
}

OBJ_IDS = {
    "lm": list(range(1, 16)),
    "lmo": [1, 5, 6, 8, 9, 10, 11, 12],
    "tless": list(range(1, 31)),
    "tudl": list(range(1, 4)),
    "tyol": list(range(1, 22)),
    "ruapc": list(range(1, 15)),
    "icmi": list(range(1, 7)),
    "icbin": list(range(1, 3)),
    "itodd": list(range(1, 29)),
    "hbs": [1, 3, 4, 8, 9, 10, 12, 15, 17, 18, 19, 22, 23, 29, 32, 33],
    "hb": list(range(1, 34)),
    "ycbv": list(range(1, 22)),
    "ycbvposecnn": list(range(1, 22)),
}

# Objects scored with ADI instead of ADD (ambiguous views), per dataset
# (reference :97-112).
SYMMETRIC_OBJ_IDS = {
    "lm": [3, 7, 10, 11],
    "lmo": [10, 11],
    "tless": list(range(1, 31)),
    "tudl": [],
    "tyol": [3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 16, 17, 18, 19, 21],
    "ruapc": [8, 9, 12, 13],
    "icmi": [1, 2, 6],
    "icbin": [1],
    "itodd": [2, 3, 4, 5, 7, 8, 9, 11, 12, 14, 17, 18, 19, 23, 24, 25,
              27, 28],
    "hbs": [10, 12, 18, 29],
    "hb": [6, 10, 11, 12, 13, 14, 18, 24, 29],
    "ycbv": [1, 13, 14, 16, 18, 19, 20, 21],
    "ycbvposecnn": [13, 16, 19, 20, 21],
}

_SUPPORTED = tuple(OBJ_IDS)

# Test-split capture ranges: depth (mm), azimuth, elevation (reference
# :190-345; per-dataset comments there).
_TEST_RANGES = {
    "lm": ((600.90, 1102.35), (0, TWO_PI), (0, HALF_PI)),
    "lmo": ((346.31, 1499.84), (0, TWO_PI), (0, HALF_PI)),
    "tless": ((649.89, 940.04), (0, TWO_PI), (-HALF_PI, HALF_PI)),
    "tudl": ((851.29, 2016.14), (0, TWO_PI), (-0.4363, HALF_PI)),
    "tyol": ((499.57, 1246.07), (0, TWO_PI), (-HALF_PI, HALF_PI)),
    "ruapc": ((594.41, 739.12), (0, TWO_PI), (-HALF_PI, HALF_PI)),
    "icmi": ((509.12, 1120.41), (0, TWO_PI), (0, HALF_PI)),
    "icbin": ((454.56, 1076.29), (0, TWO_PI), (-1.0297, HALF_PI)),
    "itodd": ((638.38, 775.97), (0, TWO_PI), (-HALF_PI, HALF_PI)),
    "hb": ((438.24, 1416.97), (0, TWO_PI), (-HALF_PI, HALF_PI)),
    "hbs": ((438.24, 1416.97), (0, TWO_PI), (-HALF_PI, HALF_PI)),
    "ycbv": ((612.92, 1243.59), (0, TWO_PI), (-1.2788, 1.1291)),
    "ycbvposecnn": ((612.92, 1243.59), (0, TWO_PI), (-1.2788, 1.1291)),
}


def _check(dataset_name: str) -> None:
    if dataset_name not in _SUPPORTED:
        raise ValueError(f"unknown BOP dataset {dataset_name!r}; "
                         f"supported: {_SUPPORTED}")


def get_camera_params(datasets_path: str, dataset_name: str,
                      cam_type: str | None = None) -> dict:
    """Sensor-level camera parameters (dataset_params.py:15-67): K,
    im_size, depth_scale from the dataset's camera json."""
    _check(dataset_name)
    sensor = cam_type or _CAM_SENSOR_DEFAULT.get(dataset_name)
    cam_filename = f"camera_{sensor}.json" if sensor else "camera.json"
    dir_name = _DIR_ALIAS.get(dataset_name, dataset_name)
    path = join(datasets_path, dir_name, cam_filename)
    p = {"cam_params_path": path}
    p.update(load_cam_params(path))
    return p


def get_model_params(datasets_path: str, dataset_name: str,
                     model_type: str | None = None) -> dict:
    """Object-model parameters (dataset_params.py:69-146): obj_ids,
    symmetric_obj_ids, model/models_info path templates."""
    _check(dataset_name)
    # T-LESS ships CAD and reconstructed model sets; CAD is the default.
    if dataset_name == "tless" and model_type is None:
        model_type = "cad"
    dir_name = _DIR_ALIAS.get(dataset_name, dataset_name)
    models_folder = "models" if model_type is None else f"models_{model_type}"
    models_path = join(datasets_path, dir_name, models_folder)
    return {
        "obj_ids": OBJ_IDS[dataset_name],
        "symmetric_obj_ids": SYMMETRIC_OBJ_IDS[dataset_name],
        "model_tpath": join(models_path, "obj_{obj_id:06d}.ply"),
        "models_info_path": join(models_path, "models_info.json"),
    }


def _scene_ids(dataset_name: str, split: str, split_type: str | None):
    """Scene ids per split (reference :186-344). None → enumerate what is
    on disk via get_present_scene_ids().

    For every `pbr` split we return None (the reference does this for ycbv
    pbr, :333; its per-dataset lists predate the BOP train_pbr releases and
    would resolve itodd/hb pbr to [] and lm pbr to 1..15 when the disk
    layout is 000000-000049 — disk enumeration is correct for all of them).
    """
    if split_type == "pbr":
        return None
    if dataset_name == "lm":
        return list(range(1, 16))
    if dataset_name == "lmo":
        return {"train": [1, 5, 6, 8, 9, 10, 11, 12], "test": [2]}[split]
    if dataset_name == "tless":
        if split == "train":
            return [1] if split_type == "synthetless" else list(range(1, 31))
        return list(range(1, 21))
    if dataset_name == "tudl":
        return list(range(1, 4))
    if dataset_name == "tyol":
        return list(range(1, 22))
    if dataset_name == "ruapc":
        return list(range(1, 15))
    if dataset_name == "icmi":
        return list(range(1, 7))
    if dataset_name == "icbin":
        return {"train": list(range(1, 3)), "test": list(range(1, 4))}[split]
    if dataset_name == "itodd":
        return {"train": [], "val": [1], "test": [1]}[split]
    if dataset_name == "hbs":
        return {"train": [], "val": [3, 5, 13], "test": [3, 5, 13]}[split]
    if dataset_name == "hb":
        return {"train": [], "val": list(range(1, 14)),
                "test": list(range(1, 14))}[split]
    # ycbv / ycbvposecnn
    if split == "train":
        return {"real": list(range(48)) + list(range(60, 92)),
                "pbr": None,  # use get_present_scene_ids()
                "synt": list(range(80))}[split_type]
    return list(range(48, 60))


def _im_size(dataset_name: str, split: str, split_type: str | None):
    """Image size per split/sensor (reference :191-341)."""
    if dataset_name == "tless":
        return {
            "train": {"primesense": (400, 400), "kinect": (400, 400),
                      "canon": (1900, 1900), "render_reconst": (1280, 1024),
                      "pbr": (720, 540), "synthetless": (400, 400)},
            "test": {"primesense": (720, 540), "kinect": (720, 540),
                     "canon": (2560, 1920)},
        }[split][split_type]
    if dataset_name == "itodd":
        return (1280, 960)
    if dataset_name in ("hb", "hbs"):
        return {"pbr": (640, 480), "primesense": (640, 480),
                "kinect": (1920, 1080)}[split_type]
    return (640, 480)


def get_split_params(datasets_path: str, dataset_name: str, split: str,
                     split_type: str | None = None) -> dict:
    """Split-level parameters and path templates (dataset_params.py:148-380)."""
    _check(dataset_name)
    # Per-dataset default split types (reference :213-214,236-237,306-307,
    # 327-329).
    if split_type is None:
        if dataset_name == "tless":
            split_type = "primesense"
        elif dataset_name == "tudl" and split == "train":
            split_type = "render"
        elif dataset_name in ("hb", "hbs"):
            split_type = "primesense"
        elif dataset_name in ("ycbv", "ycbvposecnn") and split == "train":
            split_type = "real"

    p = {
        # The requested name, even for aliased datasets (reference keeps
        # "hbs"/"ycbvposecnn" in p["name"]; only the paths resolve to the
        # shared directory).
        "name": dataset_name,
        "split": split,
        "split_type": split_type,
        "depth_range": None,
        "azimuth_range": None,
        "elev_range": None,
        "im_modalities": (["gray", "depth"] if dataset_name == "itodd"
                          else ["rgb", "depth"]),
        "scene_ids": _scene_ids(dataset_name, split, split_type),
        "im_size": _im_size(dataset_name, split, split_type),
    }
    if split == "test":
        (p["depth_range"], p["azimuth_range"],
         p["elev_range"]) = _TEST_RANGES[dataset_name]

    # Reference :171-178 ('elif'): pbr wins over itodd — itodd's pbr split
    # uses .jpg rgb and .png gray/depth like every other pbr split.
    rgb_ext = gray_ext = depth_ext = ".png"
    if split_type == "pbr":
        rgb_ext = ".jpg"
    elif dataset_name == "itodd":
        gray_ext = depth_ext = ".tif"

    base_path = join(datasets_path, _DIR_ALIAS.get(dataset_name, dataset_name))
    split_path = join(base_path, split)
    if split_type is not None and split_type != "bb8":
        split_path += "_" + split_type
    p.update({
        "base_path": base_path,
        "split_path": split_path,
        "scene_camera_tpath": join(split_path, "{scene_id:06d}",
                                   "scene_camera.json"),
        "scene_gt_tpath": join(split_path, "{scene_id:06d}",
                               "scene_gt.json"),
        "scene_gt_info_tpath": join(split_path, "{scene_id:06d}",
                                    "scene_gt_info.json"),
        "gray_tpath": join(split_path, "{scene_id:06d}", "gray",
                           "{im_id:06d}" + gray_ext),
        "rgb_tpath": join(split_path, "{scene_id:06d}", "rgb",
                          "{im_id:06d}" + rgb_ext),
        "depth_tpath": join(split_path, "{scene_id:06d}", "depth",
                            "{im_id:06d}" + depth_ext),
        "mask_tpath": join(split_path, "{scene_id:06d}", "mask",
                           "{im_id:06d}_{gt_id:06d}.png"),
        "mask_visib_tpath": join(split_path, "{scene_id:06d}", "mask_visib",
                                 "{im_id:06d}_{gt_id:06d}.png"),
    })
    return p


def get_present_scene_ids(dp_split: dict) -> list[int]:
    """Scene ids actually present on disk (dataset_params.py:381-390)."""
    scene_dirs = [d for d in glob.glob(join(dp_split["split_path"], "*"))
                  if os.path.isdir(d)]
    return sorted(int(os.path.basename(d)) for d in scene_dirs)
