"""Dataset-name registry: string names in configs -> record lists (counterpart
of gdrnet_tpu/data/dataset_factory.py:30-195).

The reference registers named splits into detectron2's DatasetCatalog
(core/gdrn_modeling/dataset_factory.py:19-76 + SPLITS_* dicts in each
dataset module, e.g. lm_dataset_d2.py:303). Here a name resolves through
(a) explicit `register()` entries, then (b) a pattern parser covering the
reference's naming scheme:

  lm_13_train, lm_13_test, lm_real_<obj>_{train,test,all}, lm_pbr_13_train,
  lmo_train, lmo_test, lmo_pbr[_<obj>]_train, lmo_blender[_<obj>]_train,
  ycbv[_<obj>]_train_real, ycbv[_<obj>]_train_pbr, ycbv[_<obj>]_train_synt,
  ycbv_test, ycbv_bop_test, fixture_test (unit tests)

LM real splits resolve through `image_set/<obj>_<split>.txt` idx files over
the test/ scene of the object when that dir exists (the reference's real-LM
layout, lm_dataset_d2.py:310-392; "all" = train+test union used to train
LM-O, :364-371); fixtures without image_set fall back to plain split dirs.
The blender / imgn render folders (lm_blender_*, lm_imgn_*, lmo_blender_*)
live beside the BOP root (data/render_dataset.py).
"""

from __future__ import annotations

from typing import Callable

import os.path as _osp

from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.ref_meta import DatasetMeta, get_meta, meta_from_json
from gdrnet_tpu_torch.data.render_dataset import load_render_folder_dicts


def osp_join_root(data_root: str, sub: str) -> str:
    """Renders live beside (not inside) BOP_DATASETS (reference layout:
    datasets/lm_renders_blender vs datasets/BOP_DATASETS/lm)."""
    parent = _osp.dirname(data_root.rstrip("/")) or "."
    return _osp.join(parent, sub)


_REGISTRY: dict[str, Callable[[], tuple[DatasetMeta, list[dict]]]] = {}


def register(name: str, fn: Callable[[], tuple[DatasetMeta, list[dict]]]) -> None:
    _REGISTRY[name] = fn


def _load_lm_real_image_set(lm_meta: DatasetMeta, objs: list[str],
                            split: str, visib_thr: float) -> list[dict]:
    """LM real data via idx files: scene == obj id under <lm>/test, im ids
    from image_set/<obj>_<split>.txt (lm_dataset_d2.py:103-107, 310-392).
    Returns per-instance records restricted to the idx'd images."""
    recs: list[dict] = []
    for obj in objs:
        oid = lm_meta.obj2id[obj]
        idx_path = _osp.join(lm_meta.data_root, "image_set", f"{obj}_{split}.txt")
        with open(idx_path) as f:
            ids = {int(ln.strip()) for ln in f if ln.strip()}
        recs += load_bop_scene_dicts(
            lm_meta, "test", scenes=[oid], objs=[obj],
            im_ids={oid: ids}, visib_thr=visib_thr, img_type="real")
    return recs


def resolve(name: str, data_root: str = "datasets/BOP_DATASETS",
            visib_thr: float = 0.0) -> tuple[DatasetMeta, list[dict]]:
    """name -> (meta, records)."""
    if name in _REGISTRY:
        return _REGISTRY[name]()

    parts = name.split("_")
    ds = parts[0]
    if ds == "lm" and ("blender" in parts or "imgn" in parts):
        # lm_blender_13_train | lm_imgn_13_train_1k_per_obj
        # (reference lm_blender.py:304 / lm_syn_imgn.py)
        meta = get_meta("lm13" if "13" in parts else "lm", data_root)
        n_per_obj = -1
        for p in parts:
            if p.endswith("k") and p[:-1].isdigit():
                n_per_obj = int(p[:-1]) * 1000
        kind = "blender" if "blender" in parts else "imgn"
        sub = ("lm_renders_blender/renders" if kind == "blender"
               else "lm_imgn/imgn")
        renders_root = osp_join_root(data_root, sub)
        recs = load_render_folder_dicts(
            meta, renders_root, objs=meta.objects, n_per_obj=n_per_obj,
            img_type="syn_blender" if kind == "blender" else "syn",
            visib_thr=visib_thr)
        return meta, recs
    if ds == "lm":
        meta = get_meta("lm13" if "13" in parts else "lm", data_root)
        objs = None
        # per-object SO splits: lm_real_ape_train (lm_dataset_d2.py:303+)
        for p in parts[1:]:
            if p in meta.objects:
                objs = [p]
        if "pbr" in parts:
            recs = load_bop_scene_dicts(meta, "train_pbr", objs=objs,
                                        visib_thr=visib_thr, img_type="syn_pbr")
            return meta, recs
        split = ("all" if "all" in parts else
                 "test" if "test" in parts else "train")
        if _osp.isdir(_osp.join(meta.data_root, "image_set")):
            return meta, _load_lm_real_image_set(meta, objs or meta.objects,
                                                 split, visib_thr)
        # fixture fallback: plain split dirs, "all" = train if present else test
        split_dir = split if split != "all" else (
            "train" if _osp.isdir(_osp.join(meta.data_root, "train")) else "test")
        recs = load_bop_scene_dicts(meta, split_dir, objs=objs,
                                    visib_thr=visib_thr, img_type="real")
        return meta, recs
    if ds == "lmo":
        meta = get_meta("lmo", data_root)
        objs = None
        for p in parts[1:]:
            if p in meta.objects:
                objs = [p]
        if "blender" in parts:
            # lmo_blender[_<obj>]_train: LM blender renders of the LMO
            # objects (reference lm_blender.py:327 SPLITS)
            renders_root = osp_join_root(data_root, "lm_renders_blender/renders")
            recs = load_render_folder_dicts(
                meta, renders_root, objs=objs or meta.objects,
                img_type="syn_blender", visib_thr=visib_thr)
            return meta, recs
        if "pbr" in parts:
            split, img_type = "train_pbr", "syn_pbr"
        elif "test" in parts or "bop" in parts:
            split, img_type = "test", "real"
        else:
            # lmo_train = LM real "all" idx split of the 8 LMO objects
            # (lm_dataset_d2.py:364-371) when the lm image_set exists;
            # fixture fallback: lmo/train.
            lm_meta = get_meta("lm", data_root)
            if _osp.isdir(_osp.join(lm_meta.data_root, "image_set")):
                return meta, _load_lm_real_image_set(
                    lm_meta, objs or meta.objects, "all", visib_thr)
            split, img_type = "train", "real"
        recs = load_bop_scene_dicts(meta, split, objs=objs, visib_thr=visib_thr,
                                    img_type=img_type)
        return meta, recs
    if ds == "ycbv":
        meta = get_meta("ycbv", data_root)
        # per-object SO splits: ycbv_024_bowl_train_real (ycbv_d2.py SO
        # SPLITS); object names contain underscores, so match by stripping
        # the split suffix from the full name.
        rest = name[len("ycbv"):].lstrip("_")
        objs = None
        for suf in ("train_real", "train_pbr", "train_synt", "bop_test", "test"):
            if rest.endswith(suf):
                mid = rest[: -len(suf)].rstrip("_")
                if mid in meta.objects:
                    objs = [mid]
                break
        if "pbr" in parts:
            split, img_type = "train_pbr", "syn_pbr"
        elif "real" in parts:
            split, img_type = "train_real", "real"
        elif "synt" in parts:
            split, img_type = "train_synt", "syn"
        elif "test" in parts or "bop" in parts:
            split, img_type = "test", "real"
        else:
            split, img_type = "train_pbr", "syn_pbr"
        recs = load_bop_scene_dicts(meta, split, objs=objs, visib_thr=visib_thr,
                                    img_type=img_type)
        if split == "test" and "bop" not in parts:
            # YCB-V keyframe test protocol (reference ycbv_d2.py keyframe
            # split: image_sets/keyframe.txt lines "scene/im_id")
            kf = _osp.join(meta.data_root, "image_sets", "keyframe.txt")
            if _osp.exists(kf):
                with open(kf) as f:
                    keep = {tuple(int(x) for x in ln.strip().split("/"))
                            for ln in f if ln.strip()}
                recs = [r for r in recs if (r["scene_id"], r["im_id"]) in keep]
        return meta, recs
    # Self-describing datasets: "<dir>_train"/"<dir>_test" where
    # <data_root>/<dir>/meta.json exists (tools/gen_scale_dataset.py layout).
    # Train images are synthetic FULL-SCENE renders WITH backgrounds ->
    # img_type "syn_pbr" (the CHANGE_BG_PROB branch, like BOP PBR;
    # COLOR_AUG_SYN_ONLY still applies). "syn" would force bg replacement
    # on every sample (reference semantics for bg-less OpenGL renders,
    # data_loader.py:330-346), which collapses held-out scores (gradient-bg
    # training domain vs rendered-bg test domain). Test follows the
    # real-image protocol.
    for suffix, img_type in (("_train", "syn_pbr"), ("_test", "real")):
        if name.endswith(suffix):
            root_dir = _osp.join(data_root, name[: -len(suffix)])
            if _osp.isfile(_osp.join(root_dir, "meta.json")):
                meta = meta_from_json(root_dir)
                recs = load_bop_scene_dicts(meta, suffix[1:], visib_thr=visib_thr,
                                            img_type=img_type)
                return meta, recs
    raise KeyError(f"Cannot resolve dataset name: {name}")
