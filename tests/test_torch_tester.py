"""The port's test path against the JAX package on the CPU: load_detections,
build_test_items, GDRNTestMapper, do_test and the engine.train CLI, on
tests/fixture_bop.py (2 objects, one symmetric, 6 images x 2 instances at
320x240, with depth) at tests/run_tiny_dotest.py's size: ResNet-18, 32x32
crops, 8x8 maps, 4 regions, buckets of 4 ROIs, f32. Both packages get the
same weights: the JAX model's init at PRNGKey(0), carried into the port by
utils/jax_convert.jax_to_torch.

The detections file jitters each GT box by a few pixels, drops one GT
instance (a miss that record_missing counts) and adds lower-scored second
detections that DET_TOPK_PER_OBJ=1 filters out.

Tolerances: the mapper bitwise; CSV rotations within 1e-4 and translations
within 1e-4 relative (one f32 forward in two libraries; the PRNGKey(0)
weights put t near 0, so also within the CSV's 1e-8 mm resolution);
per-object mean errors rtol 1e-4; recalls, BOP recalls and missing counts
equal. With random weights every recall is 0, so a stub predictor shared by
both packages returns each ROI's GT pose perturbed from a seed, and there
the recalls lie strictly between 0 and 1 and must be equal too (their mean
rotation errors, f32 arccos near 0 in two libraries, agree to 2e-4
relative only, and are not compared).
"""

import dataclasses
import json
import os.path as osp
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.config.config import Config as JaxConfig
from gdrnet_tpu.data import GDRNTestMapper as JaxTestMapper
from gdrnet_tpu.data import ObjectModels as JaxObjectModels
from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data import dataset_factory as jfactory
from gdrnet_tpu.data.synthetic import synthetic_roi_batch as jax_synthetic_roi_batch
from gdrnet_tpu.engine import tester as jtester
from gdrnet_tpu.engine import train as jtrain
from gdrnet_tpu.models.gdrn import build_model as jax_build_model

from gdrnet_tpu_torch.config import base_config
from gdrnet_tpu_torch.data import GDRNTestMapper, ObjectModels, bop, dataset_factory, ref_meta
from gdrnet_tpu_torch.engine import build_test_items, checkpoint, do_test, tester, train
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch
from fixture_bop import H as FIX_H
from fixture_bop import W as FIX_W
from fixture_bop import build_fixture_dataset

POSE_ATOL, TRANS_RTOL, MEAN_RTOL = 1e-4, 1e-4, 1e-4
CSV_MM = 1e-8  # the CSV writes t in mm with 8 decimals
ERROR_TYPES = "ad,rete,proj,vsd,mssd,mspd"
DROPPED = 3      # the GT record that gets no detection
SECONDS = (0, 5)  # records that get a lower-scored second detection
MEAN_KEYS = ("mean_re", "mean_te", "mean_ad", "mean_proj")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


def _box_center_wh(box):
    """The mapper's ROI centre and size of an xywh box."""
    x, y, w, h = (float(v) for v in box)
    return np.array([x + w / 2, y + h / 2, max(w, 1.0), max(h, 1.0)])


def _detections(records, seed: int = 4):
    """One jittered, scored detection per GT record except DROPPED, plus a
    lower-scored, further-shifted second one for each of SECONDS; each det
    keeps the index of its record."""
    rng = np.random.RandomState(seed)
    dets = []
    for i, r in enumerate(records):
        if i == DROPPED:
            continue
        box = np.asarray(r["bbox_visib"], np.float64) + rng.randint(-3, 4, 4)
        score = float(rng.uniform(0.5, 1.0))
        dets.append({"scene_id": int(r["scene_id"]), "im_id": int(r["im_id"]),
                     "obj_id": int(r["obj_id"]), "bbox_est": box.tolist(), "score": score,
                     "time": 0.01, "rec": i})
        if i in SECONDS:
            dets.append(dict(dets[-1], bbox_est=(box + [9, -7, 4, 2]).tolist(),
                             score=score - 0.4))
    return dets


def _write_dets(path, dets, form: str):
    if form == "list":
        body = [{k: v for k, v in d.items() if k != "rec"} for d in dets]
    else:
        body = {}
        for d in dets:
            body.setdefault(f"{d['scene_id']}/{d['im_id']}", []).append(
                {k: v for k, v in d.items() if k not in ("rec", "scene_id", "im_id")})
    with open(path, "w") as f:
        json.dump(body, f)
    return str(path)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    root = tmp_path_factory.mktemp("tester")
    jmeta = build_fixture_dataset(str(root / "data"), n_images=6, seed=42)
    pmeta = _port_meta(jmeta)
    jrecs = jbop.load_bop_scene_dicts(jmeta, "test")
    precs = bop.load_bop_scene_dicts(pmeta, "test")
    dets = _detections(precs)
    jfactory.register("testerfix_test", lambda: (jmeta, jrecs))
    dataset_factory.register("testerfix_test", lambda: (pmeta, precs))
    dataset_factory.register("testerfix_train", lambda: (pmeta, precs))
    return {"root": root, "jrecs": jrecs, "precs": precs, "dets": dets,
            "det_path": _write_dets(root / "est_dets.json", dets, "dict"),
            "jmodels": JaxObjectModels(jmeta, num_pm_points=64, num_fps=4),
            "pmodels": ObjectModels(pmeta, num_pm_points=64, num_fps=4)}


def _cfg(fix, bbox_type: str = "est"):
    """run_tiny_dotest's model and bucket, f32, on one device, with the
    flagship's test settings (est detections, BOP scoring)."""
    cfg = base_config()
    net = cfg.MODEL.CDPN
    net.BACKBONE.NUM_LAYERS, net.BACKBONE.INPUT_RES, net.BACKBONE.OUTPUT_RES = 18, 32, 8
    net.ROT_HEAD.NUM_CLASSES, net.ROT_HEAD.NUM_REGIONS = 2, 4
    net.PNP_NET.NUM_PM_POINTS = 64
    cfg.PARALLEL.DTYPE = "float32"
    cfg.TEST.ROI_BATCH_SIZE = 4
    cfg.TEST.LOCAL_DEVICES = 1
    cfg.TEST.TEST_BBOX_TYPE = bbox_type
    cfg.MODEL.LOAD_DETS_TEST = True
    cfg.DATASETS.DET_FILES_TEST = (fix["det_path"],)
    cfg.DATASETS.SYM_OBJS = ["brick"]
    cfg.VAL.USE_BOP = True
    cfg.VAL.ERROR_TYPES = ERROR_TYPES
    return cfg


def _jax_cfg(cfg):
    return JaxConfig(json.loads(json.dumps(cfg.to_dict())))


@pytest.fixture(scope="module")
def weights(fix):
    """PRNGKey(0) init of the JAX model (tests/run_tiny_dotest.py:54-62),
    and the same weights as a reference-layout .pth."""
    model = jax_build_model(_jax_cfg(_cfg(fix)))
    sample = {k: jnp.asarray(v) for k, v in jax_synthetic_roi_batch(
        batch_size=2, input_res=32, out_res=8, num_classes=2).items()}
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, sample["roi_img"],
        roi_classes=sample["roi_classes"], roi_coord_2d=sample["roi_coord_2d"],
        roi_cams=sample["roi_cams"], roi_centers=sample["roi_centers"],
        roi_whs=sample["roi_whs"], roi_extents=sample["roi_extents"],
        resize_ratios=sample["resize_ratios"], train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    path = str(fix["root"] / "tiny.pth")
    torch.save({"model": jax_to_torch(variables["params"], variables["batch_stats"])}, path)
    return model, variables, path


def _port_model(cfg, path):
    return checkpoint.load_weights(build_model(cfg, device="cpu"), path)


def _run_both(fix, weights, cfg, out):
    model, variables, path = weights
    want = jtester.do_test(_jax_cfg(cfg), model, variables, fix["jmodels"], fix["jrecs"],
                           output_dir=str(out / "jax"))
    got = do_test(cfg, _port_model(cfg, path), fix["pmodels"], fix["precs"],
                  output_dir=str(out / "port"), device="cpu")
    return want, got


@pytest.fixture(scope="module")
def runs(fix, weights, tmp_path_factory):
    """(d) do_test of both packages with the seeded weights."""
    return _run_both(fix, weights, _cfg(fix), tmp_path_factory.mktemp("runs"))


# ---------------------------------------------------------------------------
# (a)-(c): detections, test items, the mapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["dict", "list"])
@pytest.mark.parametrize("score_thr,topk", [(0.0, 1), (0.6, 1), (0.0, 2)])
def test_load_detections_equals_jax(fix, tmp_path, form, score_thr, topk):
    path = _write_dets(tmp_path / f"dets_{form}.json", fix["dets"], form)
    got = bop.load_detections(path, score_thr=score_thr, topk_per_obj=topk)
    want = jbop.load_detections(path, score_thr=score_thr, topk_per_obj=topk)
    assert got == want
    per_group: dict = {}
    for d in fix["dets"]:
        if d["score"] >= score_thr:
            key = (d["scene_id"], d["im_id"], d["obj_id"])
            per_group[key] = per_group.get(key, 0) + 1
    assert sum(len(v) for v in got.values()) == sum(min(topk, n) for n in per_group.values())
    for lst in got.values():  # the best-scored det of each object first
        for a, b in zip(lst, lst[1:]):
            assert a["obj_id"] != b["obj_id"] or a["score"] >= b["score"]


@pytest.mark.parametrize("bbox_type", ["gt", "est"])
def test_build_test_items_equals_jax(fix, bbox_type):
    dets = bop.load_detections(fix["det_path"])
    got = build_test_items(fix["precs"], dets, bbox_type)
    want = jtester.build_test_items(fix["jrecs"], jbop.load_detections(fix["det_path"]),
                                    bbox_type)
    assert len(got) == len(want) == 6
    assert [(i[3]["scene_id"], i[3]["im_id"]) for i in got] == sorted(
        (i[3]["scene_id"], i[3]["im_id"]) for i in want)
    for (gp, gK, grois, ginfo), (wp, wK, wrois, winfo) in zip(got, want):
        assert gp == wp and np.array_equal(gK, wK)
        assert len(ginfo["gts"]) == len(winfo["gts"])
        assert len(grois) == len(wrois)
        for g, w in zip(grois, wrois):
            assert g["obj_id"] == w["obj_id"] and g["score"] == w["score"]
            np.testing.assert_array_equal(np.asarray(g["bbox"], np.float64),
                                          np.asarray(w["bbox"], np.float64))
            assert g.get("bbox_mode", "xyxy") == w.get("bbox_mode", "xyxy") == (
                "xywh" if bbox_type == "est" else "xyxy")


@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
def test_test_mapper_equals_jax_bitwise(fix, fmt):
    """One bucket with ROIs from 2 images: two est boxes (xywh), one GT box
    (xyxy) and one box that runs off the frame's left and bottom edges."""
    cfg = _cfg(fix)
    cfg.INPUT.FORMAT = fmt
    recs = fix["precs"]
    r0, r1 = recs[0], recs[2]
    assert (r0["scene_id"], r0["im_id"]) != (r1["scene_id"], r1["im_id"])
    entries = [
        (r0["rgb_path"], r0["K"], {"obj_id": 1, "bbox_est": [100.0, 80.0, 40.0, 30.0],
                                   "bbox_mode": "xywh", "score": 0.9}),
        (r0["rgb_path"], r0["K"], {"label": "brick", "bbox": [150.0, 60.0, 230.0, 120.0],
                                   "score": 0.7}),
        (r1["rgb_path"], r1["K"], {"obj_id": 2, "bbox": [-30.0, 200.0, 70.0, 70.0],
                                   "bbox_mode": "xywh", "score": 0.4}),
        (r1["rgb_path"], r1["K"], {"obj_id": 1, "bbox": [0.0, 0.0, 400.0, 300.0]}),
    ]
    got = GDRNTestMapper(cfg, fix["pmodels"], roi_batch_size=5).map_flat(entries)
    want = JaxTestMapper(_jax_cfg(cfg), fix["jmodels"], roi_batch_size=5).map_flat(entries)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["valid"].tolist() == [True] * 4 + [False]
    assert got["resize_ratios"][3] == 8 / 320  # the scale clamps to the larger side
    single = GDRNTestMapper(cfg, fix["pmodels"], roi_batch_size=5)(
        r0["rgb_path"], r0["K"], [e[2] for e in entries[:2]])
    assert single["im_hw"].tolist() == [240, 320]


def test_test_mapper_rejects_an_unknown_format(fix):
    cfg = _cfg(fix)
    cfg.INPUT.FORMAT = "L"
    r = fix["precs"][0]
    with pytest.raises(NotImplementedError, match="FORMAT"):
        GDRNTestMapper(cfg, fix["pmodels"], roi_batch_size=2).map_flat(
            [(r["rgb_path"], r["K"], {"obj_id": 1, "bbox": [0, 0, 10, 10]})])


# ---------------------------------------------------------------------------
# (d): do_test of both packages, same weights
# ---------------------------------------------------------------------------


def test_do_test_csv_poses_match_jax(runs, fix):
    want, got = runs
    w_rows, g_rows = load_bop_results(want["_csv_path"]), load_bop_results(got["_csv_path"])
    assert osp.basename(got["_csv_path"]) == osp.basename(want["_csv_path"])
    kept = len(fix["dets"]) - len(SECONDS)  # DET_TOPK_PER_OBJ=1 drops the second dets
    assert len(g_rows) == len(w_rows) == kept
    for g, w in zip(g_rows, w_rows):
        assert (g["scene_id"], g["im_id"], g["obj_id"], g["score"]) == (
            w["scene_id"], w["im_id"], w["obj_id"], w["score"])
        np.testing.assert_allclose(g["R"], w["R"], atol=POSE_ATOL)
        np.testing.assert_allclose(g["t"], w["t"], rtol=TRANS_RTOL, atol=CSV_MM)
    rot = np.stack([g["R"] for g in g_rows])
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    assert set(got["_time"]) == set(want["_time"]) and got["_time"]["rois_per_bucket"] == 4


def test_do_test_recalls_means_and_missing_match_jax(runs):
    want, got = runs
    names = {k for k in want if not k.startswith("_")}
    assert {k for k in got if not k.startswith("_")} == names == {"cube", "brick", "Avg"}
    for name in names:
        for k in RECALL_KEYS:
            assert got[name][k] == want[name][k], (name, k)
        for k in MEAN_KEYS:
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=MEAN_RTOL,
                                       err_msg=f"{name} {k}")
        assert got[name]["count"] == want[name]["count"]
        assert got[name].get("n_missing") == want[name].get("n_missing")
    assert sum(got[n].get("n_missing", 0) for n in names - {"Avg"}) == 1
    assert "cube" in got["_summary"] and "Avg" in got["_summary"]


def test_do_test_bop_scores_match_jax(runs):
    want, got = runs
    assert got["_bop"].keys() == want["_bop"].keys() == set(ERROR_TYPES.split(","))
    for etype, per_obj in want["_bop"].items():
        assert got["_bop"][etype].keys() == per_obj.keys()
        for name, v in per_obj.items():
            np.testing.assert_array_equal(np.asarray(got["_bop"][etype][name]), np.asarray(v),
                                          err_msg=f"{etype} {name}")
    assert got["_bop_average_recall"] == want["_bop_average_recall"]


# ---------------------------------------------------------------------------
# (e): a stub predictor shared by both packages: GT poses perturbed
# ---------------------------------------------------------------------------


def _rotvec_to_mat(v: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(v)
    k = v / max(theta, 1e-12)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


class StubPoses:
    """Each ROI's GT pose, perturbed from a seed by up to 12 degrees and
    3 cm: the ROI is found by its class, centre and size among the boxes of
    the detections (or of the GT records)."""

    def __init__(self, fix, models, bbox_type: str):
        recs = fix["precs"]
        src = ([(d["bbox_est"], d["rec"]) for d in fix["dets"]] if bbox_type == "est"
               else [(r["bbox_visib"], i) for i, r in enumerate(recs)])
        self.keys = np.stack([np.concatenate([[models.label_of(recs[i]["label"])],
                                              _box_center_wh(box)]) for box, i in src])
        rng = np.random.RandomState(11)
        self.poses = []
        for _, i in src:
            axis = rng.randn(3)
            dR = _rotvec_to_mat(axis / np.linalg.norm(axis) * np.radians(rng.uniform(0, 12)))
            dt = rng.randn(3)
            dt *= rng.uniform(0, 0.03) / np.linalg.norm(dt)
            self.poses.append(((dR @ recs[i]["R"]).astype(np.float32),
                               (recs[i]["t"] + dt).astype(np.float32)))

    def __call__(self, batch: dict) -> tuple[np.ndarray, np.ndarray]:
        q = np.concatenate([np.asarray(batch["roi_classes"], np.float64)[:, None],
                            np.asarray(batch["roi_centers"], np.float64),
                            np.asarray(batch["roi_whs"], np.float64)], axis=1)
        d = np.abs(q[:, None] - self.keys[None]).sum(-1)
        rot = np.tile(np.eye(3, dtype=np.float32), (len(q), 1, 1))
        trans = np.tile(np.array([0, 0, 1], np.float32), (len(q), 1))
        for j, k in enumerate(d.argmin(1)):
            if d[j, k] < 1e-3:
                rot[j], trans[j] = self.poses[k]
        return rot, trans


def _patch_predictors(monkeypatch, stub: StubPoses):
    def jax_make(*args, **kwargs):
        return lambda variables, batch: dict(zip(("rot", "trans"), stub(batch)))

    def port_make(*args, **kwargs):
        return lambda batch: {k: torch.from_numpy(v)
                              for k, v in zip(("rot", "trans"), stub(batch))}

    monkeypatch.setattr(jtester, "make_predict_step", jax_make)
    monkeypatch.setattr(tester, "make_predict_step", port_make)


@pytest.mark.parametrize("bbox_type", ["est", "gt"])
def test_do_test_with_stub_poses_equals_jax(fix, weights, tmp_path, monkeypatch, bbox_type):
    _patch_predictors(monkeypatch, StubPoses(fix, fix["pmodels"], bbox_type))
    want, got = _run_both(fix, weights, _cfg(fix, bbox_type), tmp_path)
    assert 0.0 < got["Avg"]["re_5"] < 1.0 and 0.0 < got["Avg"]["ad_10"] < 1.0
    assert 0.0 < got["_bop"]["mssd"]["avg"] < 1.0 and 0.0 < got["_bop"]["vsd"]["avg"] < 1.0
    for name in ("cube", "brick", "Avg"):
        for k in RECALL_KEYS:
            assert got[name][k] == want[name][k], (name, k)
        assert got[name].get("n_missing") == want[name].get("n_missing")
    assert got["_bop"] == want["_bop"]
    missing = sum(got[n].get("n_missing", 0) for n in ("cube", "brick"))
    assert missing == (1 if bbox_type == "est" else 0)


# ---------------------------------------------------------------------------
# (e2): TEST.USE_PNP, with geometry maps whose correspondences are exact
# ---------------------------------------------------------------------------


class StubMaps(StubPoses):
    """StubPoses' perturbed GT poses as the net's, and L1-head geometry maps
    whose correspondences are exact: each ROI pixel's image point (its 2D
    coordinate map times the frame size) is lifted along its camera ray to
    the depth where the ray passes nearest the GT object centre, moved by up
    to 0.3 of the smallest extent (a draw seeded by the ROI), and the pixels
    whose object point lies inside the object's box form the mask. PnP
    recovers the GT pose from them, so that the coordinate conventions of
    the whole path (maps, 2D coordinates, frame size, extents, K) are held."""

    def __init__(self, fix, models, bbox_type: str):
        super().__init__(fix, models, bbox_type)
        recs = fix["precs"]
        src = ([d["rec"] for d in fix["dets"]] if bbox_type == "est" else range(len(recs)))
        self.gts = [(np.asarray(recs[i]["R"], np.float64), np.asarray(recs[i]["t"], np.float64),
                     np.asarray(models.extents[models.meta.id2obj[int(recs[i]["obj_id"])]],
                                np.float64)) for i in src]

    def outputs(self, batch: dict) -> dict:
        rot, trans = self(batch)
        q = np.concatenate([np.asarray(batch["roi_classes"], np.float64)[:, None],
                            np.asarray(batch["roi_centers"], np.float64),
                            np.asarray(batch["roi_whs"], np.float64)], axis=1)
        d = np.abs(q[:, None] - self.keys[None]).sum(-1)
        c2d = np.asarray(batch["roi_coord_2d"], np.float64)
        B, h, w, _ = c2d.shape
        mask = np.zeros((B, h, w, 1), np.float32)
        xyz = np.zeros((B, h, w, 3), np.float32)
        for j, k in enumerate(d.argmin(1)):
            if d[j, k] >= 1e-3:
                continue
            R, t, ext = self.gts[k]
            uv1 = np.concatenate([c2d[j] * [FIX_W, FIX_H], np.ones((h, w, 1))], -1)
            rays = uv1 @ np.linalg.inv(np.asarray(batch["roi_cams"][j], np.float64)).T
            z = (rays @ t) / (rays * rays).sum(-1)
            z = z + np.random.RandomState(100 + k).uniform(-0.3, 0.3, (h, w)) * ext.min()
            obj = (z[..., None] * rays - t) @ R
            inside = (np.abs(obj) < 0.45 * ext).all(-1)
            mask[j, inside, 0] = 1.0
            xyz[j][inside] = obj[inside] / ext + 0.5
        return {"rot": rot, "trans": trans, "mask": mask, "coor_x": xyz[..., :1],
                "coor_y": xyz[..., 1:2], "coor_z": xyz[..., 2:]}


def _patch_map_predictors(monkeypatch, stub: StubMaps, jax_too: bool = False):
    def port_make(*args, **kwargs):
        return lambda batch: {k: torch.from_numpy(v) for k, v in stub.outputs(batch).items()}

    monkeypatch.setattr(tester, "make_predict_step", port_make)
    if jax_too:
        monkeypatch.setattr(jtester, "make_predict_step",
                            lambda *args, **kwargs: lambda variables, batch: stub.outputs(batch))


def _rot_deg(Ra, Rb) -> float:
    """Angle of Ra^T Rb in degrees, by atan2 of its skew part (no arccos floor)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    v = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(v), (np.trace(M) - 1) / 2)))


def _pnp_cfg(fix, pnp_type: str, device_pnp: bool):
    cfg = _cfg(fix)
    cfg.VAL.USE_BOP = False
    cfg.TEST.USE_PNP = True
    cfg.TEST.PNP_TYPE = pnp_type
    cfg.TEST.DEVICE_PNP = device_pnp
    return cfg


@pytest.mark.parametrize("device_pnp", [False, True])
@pytest.mark.parametrize("pnp_type", ["ransac_pnp", "net_iter_pnp", "net_ransac_pnp"])
def test_do_test_use_pnp_recovers_the_gt_poses(fix, weights, tmp_path, monkeypatch, pnp_type,
                                               device_pnp):
    """Every mode on both paths: the CSV rows hold the GT poses within the
    device PnP's clean-data floor (0.05 degrees, 0.5 mm), where the net's
    were up to 12 degrees and 3 cm off."""
    cfg = _pnp_cfg(fix, pnp_type, device_pnp)
    _patch_map_predictors(monkeypatch, StubMaps(fix, fix["pmodels"], "est"))
    got = do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"],
                  output_dir=str(tmp_path), device="cpu")
    gts = {(r["scene_id"], r["im_id"], r["obj_id"]): r for r in fix["precs"]}
    rows = load_bop_results(got["_csv_path"])
    assert len(rows) == len(fix["dets"]) - len(SECONDS)
    for row in rows:
        gt = gts[(row["scene_id"], row["im_id"], row["obj_id"])]
        assert _rot_deg(gt["R"], row["R"]) < 0.05
        assert np.abs(row["t"] / 1000.0 - gt["t"]).max() < 5e-4
    for name in ("cube", "brick"):  # every GT instance but the dropped one
        n, miss = got[name]["count"], got[name].get("n_missing", 0)
        assert got[name]["re_2"] == got[name]["te_2"] == (n - miss) / n


def test_do_test_use_pnp_on_the_host_equals_jax(fix, weights, tmp_path, monkeypatch):
    """net_iter_pnp on the host: the port's stand-in LM and the JAX
    package's cv2.solvePnP ITERATIVE on the same maps, rows within 1e-3
    degrees and 1e-3 mm, recalls equal."""
    cfg = _pnp_cfg(fix, "net_iter_pnp", False)
    _patch_map_predictors(monkeypatch, StubMaps(fix, fix["pmodels"], "est"), jax_too=True)
    want, got = _run_both(fix, weights, cfg, tmp_path)
    w_rows, g_rows = load_bop_results(want["_csv_path"]), load_bop_results(got["_csv_path"])
    assert len(g_rows) == len(w_rows) > 0
    for g, w in zip(g_rows, w_rows):
        assert _rot_deg(w["R"], g["R"]) < 1e-3
        np.testing.assert_allclose(g["t"], w["t"], rtol=0, atol=1e-3)
    for k in RECALL_KEYS:
        assert got["Avg"][k] == want["Avg"][k], k


def test_do_test_use_pnp_with_the_model(fix, weights, tmp_path):
    """The model's own maps (random weights) through the device path with
    TEST.INT8: one finite row a kept detection."""
    cfg = _pnp_cfg(fix, "net_ransac_pnp", True)
    cfg.TEST.INT8 = True
    got = do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"],
                  output_dir=str(tmp_path), device="cpu")
    rows = load_bop_results(got["_csv_path"])
    assert len(rows) == len(fix["dets"]) - len(SECONDS)
    assert all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all() for r in rows)


# ---------------------------------------------------------------------------
# (f): what the port does not run yet, and the producer thread
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setting,value,item", [("TEST.LOCAL_DEVICES", 2, "A10")])
def test_what_waits_raises_before_mapping(fix, weights, runs, setting, value, item):
    """What waited for its ROADMAP.md item runs now (A10: data parallelism):
    TEST.LOCAL_DEVICES=2 in this one-device process tests unsplit, as JAX
    does on one chip, and gives the default run's results (the split itself
    is tests/test_torch_parallel_test.py's)."""
    assert item == "A10"
    cfg = _cfg(fix)
    cfg.set_path(setting, value)
    got = do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"], device="cpu")
    want = runs[1]
    for name in (k for k in want if not k.startswith("_")):
        for k in RECALL_KEYS + MEAN_KEYS:
            assert got[name][k] == want[name][k], (name, k)


def test_device_preprocess_warns_and_scores(fix, weights, monkeypatch):
    """TEST.DEVICE_PREPROCESS maps every bucket with GDRNDeviceTestMapper
    (the crops warped on the device) and scores as the host mapper's run:
    equal recalls under the stub predictor, and crops within JAX's own
    bound of the host's (tests/test_device_pipeline.py:212-216)."""
    from gdrnet_tpu_torch.data.mapper import GDRNDeviceTestMapper

    stub = StubPoses(fix, fix["pmodels"], "est")
    crops = {True: [], False: []}
    mode = {"device": False}

    def port_make(*args, **kwargs):
        def predict(batch):
            crops[mode["device"]].append(batch["roi_img"].numpy().copy())
            return {k: torch.from_numpy(v) for k, v in zip(("rot", "trans"), stub(batch))}
        return predict

    monkeypatch.setattr(tester, "make_predict_step", port_make)
    mapped = []
    plain = GDRNDeviceTestMapper.map_flat
    monkeypatch.setattr(GDRNDeviceTestMapper, "map_flat",
                        lambda self, entries: mapped.append(len(entries)) or plain(self, entries))
    runs = {}
    for device_prep in (False, True):
        cfg = _cfg(fix)
        cfg.TEST.DEVICE_PREPROCESS = device_prep
        mode["device"] = device_prep
        runs[device_prep] = do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"],
                                    fix["precs"], device="cpu")
    assert len(mapped) == len(crops[True]) == len(crops[False]) > 0  # every bucket
    for name, row in runs[False].items():
        if not name.startswith("_"):
            for k in RECALL_KEYS:
                assert runs[True][name][k] == row[k], (name, k)
    assert 0.0 < runs[True]["Avg"]["re_5"] < 1.0
    diff = np.concatenate([np.abs(a[:n] - b[:n])  # the rows that hold a detection
                           for a, b, n in zip(crops[True], crops[False], mapped)])
    assert np.quantile(diff, 0.99) < 2e-2 and diff.mean() < 5e-3


def test_a_mapper_error_is_raised_and_the_thread_stops(fix, weights, monkeypatch):
    """A mapper error on the second bucket comes out of do_test, and the
    producer thread is gone after it; a second do_test then runs."""
    cfg = _cfg(fix)
    calls = []
    plain = GDRNTestMapper.map_flat

    def second_fails(self, entries):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("unreadable frame")
        return plain(self, entries)

    model = _port_model(cfg, weights[2])
    cfg.VAL.USE_BOP = False
    monkeypatch.setattr(GDRNTestMapper, "map_flat", second_fails)
    with pytest.raises(OSError, match="unreadable"):
        do_test(cfg, model, fix["pmodels"], fix["precs"], device="cpu")
    assert not [t for t in threading.enumerate() if t.name == "do_test-mapper"]
    monkeypatch.setattr(GDRNTestMapper, "map_flat", plain)
    assert do_test(cfg, model, fix["pmodels"], fix["precs"], device="cpu")["Avg"]["count"] == 12


def test_do_test_refuses_a_model_on_another_device(fix, weights):
    cfg = _cfg(fix)
    with pytest.raises((ValueError, RuntimeError)):
        do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"],
                device="meta")


# ---------------------------------------------------------------------------
# (g)-(h): the engine.train CLI
# ---------------------------------------------------------------------------

CONFIG = """
SEED = 0
INPUT = dict(CHANGE_BG_PROB=0.0)
MODEL = dict(LOAD_DETS_TEST=True, CDPN=dict(
    BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=32, OUTPUT_RES=8),
    ROT_HEAD=dict(NUM_CLASSES=2, NUM_REGIONS=4),
    PNP_NET=dict(NUM_PM_POINTS=64)))
PARALLEL = dict(DTYPE="float32")
DATASETS = dict(TRAIN=("testerfix_train",), TEST=("testerfix_test",), SYM_OBJS=["brick"])
SOLVER = dict(IMS_PER_BATCH=4, TOTAL_EPOCHS=1, CHECKPOINT_PERIOD=1000,
              OPTIMIZER_CFG=dict(_delete_=True, type="Ranger", lr=1e-4, weight_decay=0))
DATALOADER = dict(NUM_WORKERS=1)
TEST = dict(ROI_BATCH_SIZE=4, LOCAL_DEVICES=1, TEST_BBOX_TYPE="est")
VAL = dict(USE_BOP=True, ERROR_TYPES="{types}")
"""


def _cli_args(fix, tmp_path, out: str, weights: str = "") -> list[str]:
    path = tmp_path / "tiny_cfg.py"
    path.write_text(CONFIG.format(types=ERROR_TYPES))
    return ["--config-file", str(path), "--eval-only", f"OUTPUT_DIR={out!r}",
            f"MODEL.WEIGHTS={weights!r}", f"DATASETS.DET_FILES_TEST=({fix['det_path']!r},)"]


def _recalls(path: str) -> dict:
    with open(path) as f:
        res = json.load(f)
    return {"objects": {n: {k: res[n][k] for k in RECALL_KEYS} for n in ("cube", "brick", "Avg")},
            "bop": res["_bop"], "missing": [res[n].get("n_missing") for n in ("cube", "brick")]}


def test_cli_eval_only_equals_jax(fix, weights, tmp_path):
    """(g) `main --eval-only` of both packages on one reference-layout .pth
    (the JAX CLI converts it through load_variables_any)."""
    path = weights[2]
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jtrain.main(_cli_args(fix, tmp_path, outs["jax"], path))
    got = train.main(_cli_args(fix, tmp_path, outs["port"], path), device="cpu")
    for out in outs.values():
        for name in ("results.json", "config_dump.json", "fixture-test_gdrnet-tpu.csv"):
            assert osp.isfile(osp.join(out, name)), (out, name)
    want = _recalls(osp.join(outs["jax"], "results.json"))
    assert _recalls(osp.join(outs["port"], "results.json")) == want
    assert want["missing"] == [None, 1] or want["missing"] == [1, None]
    assert got["Avg"]["count"] == 12


def test_cli_trains_then_tests(fix, weights, tmp_path):
    """(h) Without --eval-only: do_train for an epoch (3 iterations from
    MODEL.WEIGHTS), a checkpoint, then do_test on DATASETS.TEST[0]."""
    out = str(tmp_path / "run")
    args = [a for a in _cli_args(fix, tmp_path, out, weights[2]) if a != "--eval-only"]
    results = train.main(args, device="cpu")
    mgr = checkpoint.CheckpointManager(osp.join(out, "ckpt"))
    assert mgr.latest_step() == 3
    for name in ("results.json", "config_dump.json", "metrics.json"):
        assert osp.isfile(osp.join(out, name)), name
    with open(osp.join(out, "config_dump.json")) as f:
        assert json.load(f)["OUTPUT_DIR"] == out
    assert results["Avg"]["count"] == 12 and np.isfinite(results["Avg"]["mean_re"])
    # --eval-only without MODEL.WEIGHTS reads the run's newest checkpoint
    again = train.main(_cli_args(fix, tmp_path, out), device="cpu")
    assert again["Avg"]["mean_re"] == pytest.approx(results["Avg"]["mean_re"], rel=1e-6)


def test_cli_auto_output_dir_and_no_card(tmp_path, monkeypatch):
    """OUTPUT_DIR "auto" follows the config path under OUTPUT_ROOT; without a
    card, main on its default device raises after the config dump."""
    cfg_dir = tmp_path / "configs" / "gdrn" / "toy"
    cfg_dir.mkdir(parents=True)
    (cfg_dir / "a_toy.py").write_text("DEBUG = True\n")
    monkeypatch.chdir(tmp_path)
    args = train.parse_args(["--config-file", str(cfg_dir / "a_toy.py"),
                             f"OUTPUT_ROOT={str(tmp_path / 'out')!r}"])
    cfg = train.setup(args)
    assert cfg.OUTPUT_DIR == str(tmp_path / "out" / "gdrn" / "toy" / "a_toy")
    assert cfg.DATALOADER.NUM_WORKERS == 0 and cfg.TRAIN.PRINT_FREQ == 1
    assert osp.isfile(osp.join(cfg.OUTPUT_DIR, "config_dump.json"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--config-file", str(cfg_dir / "a_toy.py"), "--eval-only"])
