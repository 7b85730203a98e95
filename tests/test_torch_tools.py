"""The port's offline tool chain against the JAX package on the CPU, over the
tests/fixture_bop.py dataset (two objects, one z-180 symmetric): gen_xyz
(the xyz_crop pickles), eval_csv (the printed table, the average recall,
the --out JSON and the --latex report), and the eval helpers they stand on:
pose matching, the CoU errors (cou_mask, cou_bb, cus, cou_bb_proj), the
LaTeX report and the tabulate-like table. The root tools/*.py run as the
JAX package's tests run them, loaded from their path, with the dataset's
meta given through get_meta (tests/test_tools.py:128-250). Then the predict
CLI with TEST.USE_PNP on exact correspondences (its poses against the GT),
and bench_pnp's lines on the CPU.

Tolerances: xyz_crop within 1e-3 (f16 of the two packages' plain
rasterizers, which tests/test_torch_raster.py holds within 1e-5 m), xyxy
and counts equal; every other comparison is equality (strings and files
byte for byte, matches and CoU values exactly).
"""

import dataclasses
import importlib.util
import json
import os
import os.path as osp
import pickle
import shutil

import numpy as np
import pytest
import torch
from tabulate import tabulate

from gdrnet_tpu.data import ref_meta as jref_meta
from gdrnet_tpu.data.bop import load_bop_scene_dicts as jax_load_bop_scene_dicts
from gdrnet_tpu.data.ply import load_ply
from gdrnet_tpu.eval import pose_errors as jpe
from gdrnet_tpu.eval import pose_matching as jpm
from gdrnet_tpu.eval import report as jreport
from gdrnet_tpu.eval import vsd as jvsd
from gdrnet_tpu.eval.bop_writer import save_bop_results

from gdrnet_tpu_torch.data import ref_meta
from gdrnet_tpu_torch.eval import pose_errors, pose_matching, report, vsd
from gdrnet_tpu_torch.eval.custom_evaluator import plain_table
from gdrnet_tpu_torch.tools import eval_csv, gen_xyz
from fixture_bop import build_fixture_dataset
from test_torch_tester import StubMaps, _rot_deg, fix, weights  # noqa: F401
from torch_parity import REPO

XYZ_ATOL = 1e-3
ERROR_TYPES = "ad,rete,re,te,proj,vsd,mssd,mspd"  # the flagship's VAL.ERROR_TYPES


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / f"tools/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    meta = build_fixture_dataset(str(tmp_path_factory.mktemp("tools")), n_images=3, seed=21)
    return meta, _port_meta(meta), jax_load_bop_scene_dicts(meta, "test")


@pytest.fixture
def both_metas(dataset, monkeypatch):
    """get_meta of both packages gives the fixture's meta, whatever the name."""
    monkeypatch.setattr(jref_meta, "get_meta", lambda name, data_root=None: dataset[0])
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: dataset[1])


# ---------------------------------------------------------------------------
# gen_xyz
# ---------------------------------------------------------------------------


def _read_crops(scene_dir: str) -> dict:
    out = {}
    for name in sorted(os.listdir(osp.join(scene_dir, "xyz_crop"))):
        with open(osp.join(scene_dir, "xyz_crop", name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_gen_xyz_matches_jax(tmp_path):
    """Both packages regenerate the fixture's wiped xyz_crop pickles
    (tests/test_tools.py:52-72); the JAX tool at its chunk of 64."""
    roots = {}
    for pkg in ("jax", "port"):
        meta = build_fixture_dataset(str(tmp_path / pkg), n_images=2, seed=6)
        shutil.rmtree(osp.join(meta.data_root, "test", "000001", "xyz_crop"))
        roots[pkg] = meta
    n_jax = _root_tool("gen_xyz").gen_split_xyz(roots["jax"], "test", chunk=64)
    n_port = gen_xyz.gen_split_xyz(_port_meta(roots["port"]), "test", chunk=64, device="cpu")
    assert n_port == n_jax == 4
    want, got = (_read_crops(osp.join(roots[p].data_root, "test", "000001"))
                 for p in ("jax", "port"))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name]["xyxy"] == want[name]["xyxy"], name
        assert got[name]["xyz_crop"].dtype == np.float16
        np.testing.assert_allclose(got[name]["xyz_crop"].astype(np.float32),
                                   want[name]["xyz_crop"].astype(np.float32), atol=XYZ_ATOL)
    # a second run writes nothing
    assert gen_xyz.gen_split_xyz(_port_meta(roots["port"]), "test", device="cpu") == 0


def test_gen_xyz_cli_writes_what_is_missing(tmp_path, monkeypatch, capsys):
    """The CLI, --device naming the device and main's device= alike: the
    fixture's own pickles are kept, --overwrite writes them all again."""
    pmeta = _port_meta(build_fixture_dataset(str(tmp_path / "cli"), n_images=2, seed=6))
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: pmeta)
    assert gen_xyz.main(["--dataset", "fixture", "--device", "cpu"]) == 0
    assert gen_xyz.main(["--dataset", "fixture", "--overwrite", "--chunk", "9"],
                        device="cpu") == 4
    assert "generated 4 xyz crops; B2 launches 0" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# eval_csv
# ---------------------------------------------------------------------------


def _perturbed_csv(records, path: str) -> str:
    """One estimate a GT instance, rotated by up to 8 degrees and moved by up
    to 3 cm from a seed, so that every threshold has poses on both sides."""
    rng = np.random.RandomState(7)
    rows = []
    for g in records:
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rng.uniform(0, 8))
        Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        dR = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx
        rows.append({"scene_id": g["scene_id"], "im_id": g["im_id"], "obj_id": g["obj_id"],
                     "score": float(rng.uniform(0.5, 1)), "R": dR @ g["R"],
                     "t": (g["t"] + rng.uniform(-0.03, 0.03, 3)) * 1000.0, "time": 0.5})
    save_bop_results(path, rows)
    return path


def test_eval_csv_matches_jax(dataset, both_metas, tmp_path, capsys):
    csv = _perturbed_csv(dataset[2], str(tmp_path / "est.csv"))
    outs = {}
    for pkg, run in (("jax", _root_tool("eval_csv").main),
                     ("port", lambda argv: eval_csv.main(argv, device="cpu"))):
        argv = ["--csv", csv, "--dataset", "fixture", "--error-types", ERROR_TYPES,
                "--out", str(tmp_path / f"{pkg}.json"), "--latex", str(tmp_path / f"{pkg}.tex")]
        run(argv)
        printed = capsys.readouterr().out
        lines = printed.splitlines()
        table_end = next(i for i, ln in enumerate(lines) if ln.startswith("bop-style"))
        outs[pkg] = (lines[:table_end + 1], (tmp_path / f"{pkg}.json").read_text(),
                     (tmp_path / f"{pkg}.tex").read_text())
    assert outs["port"] == outs["jax"]
    table = outs["port"][0]
    assert table[0].split()[0] == "error" and len(table) == 2 + len(ERROR_TYPES.split(","))
    ar = float(table[-1].split()[-1])
    assert 0.0 < ar < 100.0, table


# ---------------------------------------------------------------------------
# the eval helpers
# ---------------------------------------------------------------------------


MATCH_ERRS = [
    {"est_id": 0, "score": 0.9, "errors": {0: [0.05], 1: [0.01]}},
    {"est_id": 1, "score": 0.8, "errors": {0: [0.02], 1: [0.20]}},
    {"est_id": 2, "score": 0.7, "errors": {0: [0.01], 1: [0.01]}},
]


@pytest.mark.parametrize("case", [
    (MATCH_ERRS, [0.1], {}),
    (MATCH_ERRS, [0.1], {"gt_valid_mask": {0: True, 1: False}}),
    (MATCH_ERRS, [0.1], {"max_ests_count": 1}),
    ([{"est_id": 0, "score": 1.0, "errors": {0: [4.0, 0.06]}}], [5.0, 0.05], {}),
    ([{"est_id": 0, "score": 1.0, "errors": {0: [4.0, 0.06]}}], [5.0, 0.07], {}),
])
def test_match_poses_equals_jax(case):
    """tests/test_bop_score.py:246-276's cases."""
    errs, ths, kw = case
    assert pose_matching.match_poses(errs, ths, **kw) == jpm.match_poses(errs, ths, **kw)


@pytest.mark.parametrize("n_top", [1, 0, 2])
def test_localization_scores_equal_jax(n_top):
    """tests/test_bop_score.py:279-291's matches, and a third instance."""
    matches = [
        {"scene_id": 1, "im_id": 0, "obj_id": 5, "valid": True, "est_id": 0},
        {"scene_id": 1, "im_id": 1, "obj_id": 5, "valid": True, "est_id": -1},
        {"scene_id": 2, "im_id": 0, "obj_id": 7, "valid": True, "est_id": 3},
        {"scene_id": 2, "im_id": 0, "obj_id": 7, "valid": False, "est_id": -1},
        {"scene_id": 2, "im_id": 0, "obj_id": 7, "valid": True, "est_id": 4},
    ]
    got = pose_matching.calc_localization_scores([1, 2], [5, 7], matches, n_top)
    assert got == jpm.calc_localization_scores([1, 2], [5, 7], matches, n_top)
    assert pose_matching.calc_recall(0, 0) == jpm.calc_recall(0, 0) == 0.0


def test_cou_mask_and_bb_equal_jax():
    """tests/test_bop_score.py:209-226's cases, an empty union scoring 1."""
    a = np.zeros((8, 8), bool)
    a[2:6, 2:6] = True
    b = np.zeros((8, 8), bool)
    b[4:8, 4:8] = True
    z = np.zeros_like(a)
    me, mg = np.stack([a, a, a, z]), np.stack([a, b, z, z])
    got = pose_errors.cou_mask_batch(torch.from_numpy(me), torch.from_numpy(mg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpe.cou_mask_batch(me, mg)))
    assert got.tolist() == pytest.approx([0.0, 1 - 4 / 28, 1.0, 1.0], abs=1e-6)
    bb = np.array([[0, 0, 4, 4], [0, 0, 4, 4], [0, 0, 4, 4], [1, 1, 0, 0]], np.float32)
    bb2 = np.array([[0, 0, 4, 4], [2, 2, 4, 4], [10, 10, 4, 4], [1, 1, 0, 0]], np.float32)
    got = pose_errors.cou_bb_batch(torch.from_numpy(bb), torch.from_numpy(bb2)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpe.cou_bb_batch(bb, bb2)))


def test_adi_sym_batch_equals_jax():
    from gdrnet_tpu.ops.symmetry import identity_padded_sym_arrays

    rng = np.random.RandomState(2)
    Q = np.linalg.qr(rng.randn(4, 3, 3))[0].astype(np.float32)
    Rz = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    sym, mask = identity_padded_sym_arrays(np.stack([np.eye(3, dtype=np.float32), Rz]), 4)
    R_gt = Q @ Rz
    got = pose_errors.adi_sym_batch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        Q, np.zeros((4, 3), np.float32), R_gt, np.zeros((4, 3), np.float32),
        np.zeros((5, 3), np.float32), sym, mask))).numpy()
    want = np.asarray(jpe.adi_sym_batch(Q, np.zeros((4, 3)), R_gt, np.zeros((4, 3)),
                                        np.zeros((5, 3)), sym, mask))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, Q, atol=1e-6)


@pytest.mark.parametrize("shift", [0.0, 0.01, 0.15])
@pytest.mark.parametrize("fn", ["cus", "cou_bb_proj"])
def test_cus_and_cou_bb_proj_equal_jax(dataset, fn, shift):
    """tests/test_bop_score.py:229-243's case, the estimate moved along x."""
    meta, pmeta, records = dataset
    rec = records[0]
    ply = load_ply(meta.model_path(rec["obj_id"]), vertex_scale=0.001)
    t_est = rec["t"] + np.array([shift, 0.0, 0.0], np.float32)
    args = (rec["R"], t_est, rec["R"], rec["t"], rec["K"], ply["pts"], ply["faces"])
    kw = dict(height=meta.height, width=meta.width)
    got = getattr(vsd, fn)(*args, **kw, device="cpu")
    assert got == getattr(jvsd, fn)(*args, **kw)
    assert (got == 0.0) == (shift == 0.0)


def test_report_equals_jax(tmp_path):
    scores = {"ad": {"cube": [1.0, 0.0, 1.0], "brick": 0.25, "avg": 0.5},
              "re_2": {"cube": 0.5, "avg": 0.5}, "vsd": {"cube": 0.125, "brick": 0.0}}
    assert report.scores_to_latex(scores, "x_y%") == jreport.scores_to_latex(scores, "x_y%")
    got = report.write_latex_report(str(tmp_path / "p" / "r.tex"), scores, title="t_1",
                                    extra_tables=[("more", scores)], figures=["f.png"])
    assert got == jreport.write_latex_report(str(tmp_path / "j" / "r.tex"), scores,
                                             title="t_1", extra_tables=[("more", scores)],
                                             figures=["f.png"])
    assert (tmp_path / "p" / "r.tex").read_text() == got


def test_report_plots_write_pngs(tmp_path):
    """matplotlib is imported when a plot is drawn, not with the module."""
    rng = np.random.RandomState(0)
    report.plot_t_err_recall(rng.randn(20, 3) * 0.01, str(tmp_path / "t.png"))
    report.plot_err_hist(rng.rand(30), str(tmp_path / "h.png"), max_val=1.0, xlabel="re")
    for name in ("t.png", "h.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("seed", range(6))
def test_plain_table_prints_as_tabulate(seed):
    rng = np.random.RandomState(seed)
    cells = ["-", "100.00", "0.00", "45.20", "5", "12.3456", "0.0000", "ad", "1e-05", "3.5e+02"]
    n_cols = rng.randint(1, 6)
    headers = [str(rng.choice(["error", "objects", "a", "hexprism", "Avg"]))
               for _ in range(n_cols)]
    rows = [[str(rng.choice(["ad", "re_2", "mean_te"]))]
            + [str(rng.choice(cells)) for _ in range(n_cols - 1)]
            for _ in range(rng.randint(0, 5))]
    assert plain_table(rows, headers) == tabulate(rows, headers=headers, tablefmt="plain")


def test_summarize_equals_jax():
    from gdrnet_tpu.eval.custom_evaluator import CustomEvaluator as JaxCustomEvaluator

    from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator

    rng = np.random.RandomState(3)
    results = {}
    for name in ("cube", "brick", "Avg"):
        row = {k: float(rng.choice([0.0, 1.0, rng.rand()])) for k in RECALL_KEYS}
        row.update(mean_re=float(rng.rand() * 90), mean_te=float(rng.rand()))
        results[name] = row
    args = (["cube"], {"cube": np.zeros((3, 3), np.float32)}, {"cube": 0.1})
    assert CustomEvaluator(*args, device="cpu").summarize(results) == \
        JaxCustomEvaluator(*args).summarize(results)


# ---------------------------------------------------------------------------
# predict with TEST.USE_PNP, and bench_pnp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pnp_type,device_pnp", [("ransac_pnp", True), ("net_iter_pnp", False)])
def test_predict_cli_with_use_pnp_recovers_the_gt_poses(fix, weights, tmp_path, monkeypatch,
                                                        pnp_type, device_pnp):
    """The serving CLI with TEST.USE_PNP over tests/test_torch_tester.py's
    fixture, its net replaced by StubMaps (exact correspondences, net poses
    up to 12 degrees and 3 cm off): every detection's row, the lower-scored
    shifted second ones too, holds its GT pose within the device PnP's
    clean-data floor (0.05 degrees, 0.5 mm)."""
    from gdrnet_tpu_torch.engine import tester as port_tester
    from gdrnet_tpu_torch.eval.bop_writer import load_bop_results
    from gdrnet_tpu_torch.tools import predict as port_predict

    stub = StubMaps(fix, fix["pmodels"], "est")
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: fix["pmodels"].meta)
    # predict's forward is engine/tester.bucket_predictor's make_predict_step
    monkeypatch.setattr(port_tester, "make_predict_step", lambda *args, **kwargs: (
        lambda batch: {k: torch.from_numpy(v) for k, v in stub.outputs(batch).items()}))
    cfg = tmp_path / "predict_pnp.py"
    cfg.write_text(
        "MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=32, OUTPUT_RES=8),\n"
        "                       ROT_HEAD=dict(NUM_CLASSES=2, NUM_REGIONS=4),\n"
        "                       PNP_NET=dict(NUM_PM_POINTS=64)))\n"
        "PARALLEL = dict(DTYPE='float32')\n"
        "TEST = dict(ROI_BATCH_SIZE=4, LOCAL_DEVICES=1)\n")
    out = str(tmp_path / "poses.csv")
    rows = port_predict.main(
        ["--config-file", str(cfg), "--ckpt", weights[2], "--dataset", "fixture", "--dets",
         fix["det_path"], "--image-root", osp.join(fix["pmodels"].meta.data_root, "test"),
         "--out", out, "TEST.USE_PNP=True", f"TEST.PNP_TYPE={pnp_type}",
         f"TEST.DEVICE_PNP={device_pnp}"], device="cpu")
    assert len(rows) == len(load_bop_results(out)) == len(fix["dets"])
    gts = {(r["scene_id"], r["im_id"], r["obj_id"]): r for r in fix["precs"]}
    for row in load_bop_results(out):
        gt = gts[(row["scene_id"], row["im_id"], row["obj_id"])]
        assert _rot_deg(gt["R"], row["R"]) < 0.05
        assert np.abs(row["t"] / 1000.0 - gt["t"]).max() < 5e-4


def test_bench_pnp_prints_a_line_a_path(capsys):
    from gdrnet_tpu_torch.tools import bench_pnp

    rows = bench_pnp.main(["--device", "cpu", "--batch", "3", "--iters", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == rows
    assert [r["metric"] for r in rows] == ["pnp_host_numpy", "pnp_device_ransac_pnp",
                                           "pnp_device_net_iter_pnp",
                                           "pnp_device_net_ransac_pnp"]
    assert all(r["value"] > 0 and r["unit"] == "rois/s" and r["batch"] == 3 for r in rows)
    assert all(r["device"] == "cpu" and r["peak_mem_mib"] is None for r in rows[1:])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            bench_pnp.main(["--batch", "3"])
