"""Dataset metadata registry (a copy of gdrnet_tpu/data/ref_meta.py, which
cannot be imported without JAX) — the framework's `ref` package
(reference ref/lm_full.py, ref/lmo_full.py, ref/ycbv.py). The numeric
constants (object ids/names, diameters, camera intrinsics) are BOP dataset
facts, identical by necessity.

Each dataset is a `DatasetMeta`; `get_meta(name)` resolves "lm", "lmo",
"ycbv". Model-derived artifacts (models_info.json, fps_points.pkl, sampled
points) load lazily from `data_root` with per-process caching.
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

LM_OBJECTS = [
    "ape", "benchvise", "bowl", "camera", "can", "cat", "cup", "driller",
    "duck", "eggbox", "glue", "holepuncher", "iron", "lamp", "phone",
]
LM_ID2OBJ = {i + 1: n for i, n in enumerate(LM_OBJECTS)}
LM_DIAMETERS = np.array(
    [102.099, 247.506, 167.355, 172.492, 201.404, 154.546, 124.264, 261.472,
     108.999, 164.628, 175.889, 145.543, 278.078, 282.601, 212.358]) / 1000.0
LM_CAMERA = np.array(
    [[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]])
LM_13_OBJECTS = [n for n in LM_OBJECTS if n not in ("bowl", "cup")]

LMO_OBJECTS = ["ape", "can", "cat", "driller", "duck", "eggbox", "glue", "holepuncher"]
LMO_ID2OBJ = {1: "ape", 5: "can", 6: "cat", 8: "driller", 9: "duck",
              10: "eggbox", 11: "glue", 12: "holepuncher"}
LMO_DIAMETERS = np.array(
    [102.099, 201.404, 154.546, 261.472, 108.999, 164.628, 175.889, 145.543]) / 1000.0

YCBV_ID2OBJ = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
    17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
    20: "052_extra_large_clamp", 21: "061_foam_brick",
}
YCBV_DIAMETERS = np.array(
    [172.063, 269.573, 198.377, 120.543, 196.463, 89.797, 142.543, 114.053,
     129.540, 197.796, 259.534, 259.566, 161.922, 124.990, 226.170, 237.299,
     203.973, 121.365, 174.746, 217.094, 102.903]) / 1000.0
YCBV_CAMERA_UW = np.array(
    [[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0.0, 0.0, 1.0]])
YCBV_CAMERA_CMU = np.array(
    [[1077.836, 0.0, 323.7872], [0.0, 1078.189, 279.6921], [0.0, 0.0, 1.0]])

SYM_OBJECTS = {
    "lm": ["bowl", "cup", "eggbox", "glue"],
    "lmo": ["eggbox", "glue"],
    "ycbv": ["024_bowl", "036_wood_block", "051_large_clamp",
             "052_extra_large_clamp", "061_foam_brick"],
}


@dataclass
class DatasetMeta:
    name: str
    objects: list
    id2obj: dict
    diameters_by_name: dict
    camera_matrix: np.ndarray
    width: int = 640
    height: int = 480
    vertex_scale: float = 0.001  # BOP PLYs are in mm
    data_root: str = ""
    sym_objects: list = field(default_factory=list)
    depth_factor: float = 1000.0

    @property
    def obj2id(self) -> dict:
        return {n: i for i, n in self.id2obj.items()}

    @property
    def model_dir(self) -> str:
        return osp.join(self.data_root, "models")

    def model_path(self, obj_id: int) -> str:
        return osp.join(self.model_dir, f"obj_{obj_id:06d}.ply")

    def models_info(self) -> dict:
        """BOP models_info.json keyed by str(obj_id) (ref lm_full.py:109)."""
        return _load_json(osp.join(self.model_dir, "models_info.json"))

    def fps_points(self) -> dict:
        """fps_points.pkl keyed by str(obj_id) (ref lm_full.py:117);
        regenerate with python -m gdrnet_tpu_torch.tools.compute_fps."""
        with open(osp.join(self.model_dir, "fps_points.pkl"), "rb") as f:
            return pickle.load(f)


@lru_cache(maxsize=64)
def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def meta_from_json(root_dir: str) -> DatasetMeta:
    """DatasetMeta from a self-describing dataset dir: <root>/meta.json as
    written by tools/gen_scale_dataset.py (keys: name, objects, id2obj,
    diameters [m], cam_K, width, height, sym_objects). The analogue of a
    hand-written ref/<ds>.py module for generated datasets."""
    m = _load_json(osp.join(root_dir, "meta.json"))
    return DatasetMeta(
        name=m.get("name", osp.basename(root_dir.rstrip("/"))),
        objects=list(m["objects"]),
        id2obj={int(k): v for k, v in m["id2obj"].items()},
        diameters_by_name={k: float(v) for k, v in m["diameters"].items()},
        camera_matrix=np.asarray(m["cam_K"], np.float64).reshape(3, 3),
        width=int(m.get("width", 640)), height=int(m.get("height", 480)),
        data_root=root_dir, sym_objects=list(m.get("sym_objects", [])))


def get_meta(name: str, data_root: str = "datasets/BOP_DATASETS") -> DatasetMeta:
    key = name.lower()
    if key in ("lm", "lm_full", "lm13"):
        objects = LM_13_OBJECTS if key == "lm13" else LM_OBJECTS
        return DatasetMeta(
            name="lm", objects=objects, id2obj=LM_ID2OBJ,
            diameters_by_name={n: float(d) for n, d in zip(LM_OBJECTS, LM_DIAMETERS)},
            camera_matrix=LM_CAMERA, data_root=osp.join(data_root, "lm"),
            sym_objects=SYM_OBJECTS["lm"])
    if key in ("lmo", "lmo_full"):
        return DatasetMeta(
            name="lmo", objects=LMO_OBJECTS, id2obj=LMO_ID2OBJ,
            diameters_by_name={n: float(d) for n, d in zip(LMO_OBJECTS, LMO_DIAMETERS)},
            camera_matrix=LM_CAMERA, data_root=osp.join(data_root, "lmo"),
            sym_objects=SYM_OBJECTS["lmo"])
    if key == "ycbv":
        names = [YCBV_ID2OBJ[i] for i in sorted(YCBV_ID2OBJ)]
        return DatasetMeta(
            name="ycbv", objects=sorted(names), id2obj=YCBV_ID2OBJ,
            diameters_by_name={n: float(d) for n, d in zip(names, YCBV_DIAMETERS)},
            camera_matrix=YCBV_CAMERA_UW, data_root=osp.join(data_root, "ycbv"),
            sym_objects=SYM_OBJECTS["ycbv"], depth_factor=10000.0)
    raise KeyError(f"Unknown dataset: {name}")


def meta_by_name(name: str, data_root: str = "datasets/BOP_DATASETS") -> DatasetMeta:
    """A dataset directory <data_root>/<name> that holds a meta.json (as the
    port's generator and data/synthetic.write_bop_split write it), else one
    of get_meta's names: how the port's tools read --dataset."""
    root = osp.join(data_root, name)
    if osp.isfile(osp.join(root, "meta.json")):
        return meta_from_json(root)
    return get_meta(name, data_root)
