"""The port's BOP scoring chain and its host data copies against the JAX
package, on the CPU, over the tests/fixture_bop.py dataset (two objects,
one z-180 symmetric, the first object twice in every image).

The chain: load_bop_scene_dicts -> ObjectModels -> score_results ->
bop19_average_recall, with error types ad, add, adi, rete, re, te, proj,
reS, projS, mssd, mspd, vsd, AUCad and ABSad; estimates perfect, perturbed
and partly missing, in recall and in precision mode. Every recall and the
AR must be equal: the errors agree to ~1e-6 relative (VSD's to a pixel), far
from any threshold on this data.

The numpy copies (PLY, BOP records, ObjectModels, symmetry sets, FPS, the
BOP CSV) must give exactly what the JAX package's modules give, and the
BOP split that the port writes must load through the JAX package alike.
"""

import dataclasses

import numpy as np
import pytest

from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data import io as jio
from gdrnet_tpu.data import model_store as jmodel_store
from gdrnet_tpu.data import ply as jply
from gdrnet_tpu.data import ref_meta as jref_meta
from gdrnet_tpu.eval import bop_score as jbop_score
from gdrnet_tpu.eval import bop_writer as jbop_writer
from gdrnet_tpu.eval.pose_matching import match_poses
from gdrnet_tpu.ops import fps as jfps
from gdrnet_tpu.ops import symmetry as jsym

from gdrnet_tpu_torch.data import bop, io, model_store, ply, ref_meta
from gdrnet_tpu_torch.data.synthetic import write_bop_split
from gdrnet_tpu_torch.eval import bop_score, bop_writer
from gdrnet_tpu_torch.ops import fps, symmetry
from fixture_bop import build_fixture_dataset
from torch_parity import gen_scale_dataset

ERROR_TYPES = "ad,add,adi,rete,re,te,proj,reS,projS,mssd,mspd,vsd,AUCad,ABSad"


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    meta = build_fixture_dataset(str(tmp_path_factory.mktemp("bop_port")), n_images=3,
                                 seed=21, duplicate_first_obj=True)
    return meta, _port_meta(meta)


@pytest.fixture(scope="module")
def chains(dataset):
    """(records, models) of the JAX package and of the port."""
    jmeta, pmeta = dataset
    return ((jbop.load_bop_scene_dicts(jmeta, "test"),
             jmodel_store.ObjectModels(jmeta, num_pm_points=128)),
            (bop.load_bop_scene_dicts(pmeta, "test"),
             model_store.ObjectModels(pmeta, num_pm_points=128)))


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)) and not (want and isinstance(want[0], (int, float))):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert np.asarray(got).dtype == np.asarray(want).dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def test_load_bop_scene_dicts_equals_jax(dataset, chains):
    (want, _), (got, _) = chains
    assert len(want) == 9 and all("depth_path" in r for r in want)
    _assert_same(got, want, "records")
    jmeta, pmeta = dataset
    kw = dict(objs=["brick"], im_ids={1: {0, 2}}, with_masks=False, with_xyz=False)
    _assert_same(bop.load_bop_scene_dicts(pmeta, "test", **kw),
                 jbop.load_bop_scene_dicts(jmeta, "test", **kw), "filtered")


@pytest.mark.parametrize("num_pm_points,num_fps", [(128, 8), (5, 4)])
def test_object_models_equal_jax(dataset, num_pm_points, num_fps):
    """num_pm_points=5 makes both draw a point sample from their RandomState."""
    jmeta, pmeta = dataset
    want = jmodel_store.ObjectModels(jmeta, num_pm_points=num_pm_points, num_fps=num_fps)
    got = model_store.ObjectModels(pmeta, num_pm_points=num_pm_points, num_fps=num_fps)
    for attr in ("points", "full_points", "faces", "extents", "bbox3d", "fps_points",
                 "diameters", "sym_rots", "points_stack", "extents_stack", "fps_stack",
                 "sym_rots_stack", "sym_mask_stack"):
        _assert_same(getattr(got, attr), getattr(want, attr), attr)
    assert got.label_of("brick") == want.label_of("brick")


def test_meta_registry_equals_jax(tmp_path):
    for name in ("lm", "lm13", "lmo", "ycbv"):
        _assert_same(dataclasses.asdict(ref_meta.get_meta(name)),
                     dataclasses.asdict(jref_meta.get_meta(name)), name)
    jio.save_json(str(tmp_path / "meta.json"), {
        "name": "synth", "objects": ["a", "b"], "id2obj": {"1": "a", "2": "b"},
        "diameters": {"a": 0.1, "b": 0.2}, "cam_K": [500, 0, 320, 0, 500, 240, 0, 0, 1],
        "sym_objects": ["b"]})
    _assert_same(dataclasses.asdict(ref_meta.meta_from_json(str(tmp_path))),
                 dataclasses.asdict(jref_meta.meta_from_json(str(tmp_path))), "from_json")


def test_symmetry_sets_equal_jax():
    disc = [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]
    infos = [{}, {"symmetries_discrete": disc},
             {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]},
             {"symmetries_discrete": disc,
              "symmetries_continuous": [{"axis": [0, 1, 1], "offset": [1, 2, 3]}]}]
    for info in infos:
        _assert_same(symmetry.get_symmetry_transformations(info, 0.3),
                     jsym.get_symmetry_transformations(info, 0.3), str(info))
        _assert_same(symmetry.get_symmetry_rotations(info, 0.3),
                     jsym.get_symmetry_rotations(info, 0.3), str(info))
    sets = [None, jsym.get_symmetry_rotations(infos[1]), jsym.get_symmetry_rotations(infos[3],
                                                                                      0.5)]
    for max_k in (None, 2):
        _assert_same(symmetry.pad_symmetry_sets(sets, max_k), jsym.pad_symmetry_sets(sets, max_k))


@pytest.mark.parametrize("init_center,start_idx", [(True, 0), (False, 17)])
def test_farthest_point_sampling_np_equals_jax(rng, init_center, start_idx):
    pts = rng.randn(300, 3).astype(np.float32)
    _assert_same(fps.farthest_point_sampling_np(pts, 12, init_center, start_idx),
                 jfps.farthest_point_sampling_np(pts, 12, init_center, start_idx))


def test_ply_equals_jax(rng, tmp_path):
    pts = rng.randn(7, 3).astype(np.float32)
    faces = rng.randint(0, 7, (5, 3)).astype(np.int32)
    colors = rng.randint(0, 256, (7, 3))
    ply.save_ply(str(tmp_path / "p.ply"), pts, faces, colors)
    jply.save_ply(str(tmp_path / "j.ply"), pts, faces, colors)
    assert (tmp_path / "p.ply").read_text() == (tmp_path / "j.ply").read_text()
    _assert_same(ply.load_ply(str(tmp_path / "p.ply"), 0.001),
                 jply.load_ply(str(tmp_path / "p.ply"), 0.001), "ascii")
    for fmt, end in (("binary_little_endian", "<"), ("binary_big_endian", ">")):
        header = (f"ply\nformat {fmt} 1.0\ncomment made here\nelement vertex 7\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "property float nx\nproperty float ny\nproperty float nz\n"
                  "element face 5\nproperty list uchar int vertex_indices\nend_header\n")
        body = np.concatenate([pts, pts[::-1]], 1).astype(end + "f4").tobytes()
        for fc in faces:
            body += bytes([3]) + fc.astype(end + "i4").tobytes()
        path = tmp_path / f"{fmt}.ply"
        path.write_bytes(header.encode() + body)
        _assert_same(ply.load_ply(str(path)), jply.load_ply(str(path)), fmt)


def test_bop_csv_round_trip_equals_jax(rng, tmp_path):
    rows = [{"scene_id": 1, "im_id": i, "obj_id": 2, "score": 0.5 + 0.1 * i,
             "R": rng.randn(3, 3), "t": rng.randn(3) * 100, "time": 0.25} for i in range(3)]
    bop_writer.save_bop_results(str(tmp_path / "p.csv"), rows)
    jbop_writer.save_bop_results(str(tmp_path / "j.csv"), rows)
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    _assert_same(bop_writer.load_bop_results(str(tmp_path / "p.csv")),
                 jbop_writer.load_bop_results(str(tmp_path / "p.csv")))


def _estimates(records, rng, case: str) -> list[dict]:
    out = []
    for g in records:
        R, t = g["R"].astype(np.float64), g["t"].astype(np.float64)
        if case != "perfect":
            ax = rng.randn(3)
            ax /= np.linalg.norm(ax)
            a = np.radians(rng.uniform(0, 12))
            Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
            R = (np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx) @ R
            t = t + rng.randn(3) * 0.008
        out.append({"scene_id": g["scene_id"], "im_id": g["im_id"], "obj_id": g["obj_id"],
                    "score": float(rng.rand()), "R": R, "t": t * 1000.0, "time": 0.1})
    if case == "missing":
        out = out[::2]
    return out


@pytest.mark.parametrize("case,precision", [("perfect", False), ("perturbed", False),
                                            ("missing", False), ("perturbed", True)])
def test_score_results_matches_jax(chains, rng, tmp_path, case, precision):
    (jrec, jmodels), (precs, pmodels) = chains
    results = _estimates(jrec, rng, case)
    # through a BOP19 CSV, as the tester writes and the scorer reads it
    bop_writer.save_bop_results(str(tmp_path / "est.csv"), results)
    results = bop_writer.load_bop_results(str(tmp_path / "est.csv"))
    kw = dict(error_types=ERROR_TYPES, sym_objs=["brick"], image_width=320,
              precision=precision)
    want = jbop_score.score_results(results, jrec, jmodels, **kw)
    got = bop_score.score_results(results, precs, pmodels, **kw, device="cpu")
    _assert_same(got, want, case)
    assert bop_score.bop19_average_recall(got) == jbop_score.bop19_average_recall(want)
    if case == "perturbed":
        assert 0.0 < want["vsd"]["avg"] < 1.0 and 0.0 < want["ad"]["avg"] < 1.0


def test_match_and_validate_equal_jax(chains, rng):
    (jrec, _), _ = chains
    results = _estimates(jrec, rng, "perturbed")
    results += [dict(results[0], score=0.0)]  # a second, weaker estimate of one GT
    for n_top in (1, 0):
        for precision in (False, True):
            want = jbop_score.match_estimates_to_gt(results, jrec, n_top, precision)
            got = bop_score.match_estimates_to_gt(results, jrec, n_top, precision)
            assert [(id(e), id(g)) for e, g in got] == [(id(e), id(g)) for e, g in want]
    assert bop_score.validate_error_types("vsd, mssd,mspd") == ["vsd", "mssd", "mspd"]
    with pytest.raises(ValueError, match="unsupported"):
        bop_score.validate_error_types("ad,cus")
    assert bop_score.bop19_average_recall({"ad": {"avg": 0.5}, "re": {"avg": 0.25}}) == 0.375


def test_duplicate_gt_pairing_against_the_toolkits_matching(chains):
    """With N_TOP=1 and two GT instances of one (image, object) key, the
    port (as the JAX package, bop_score.match_estimates_to_gt) pairs the key's
    best estimate with its first-listed GT instance; the BOP toolkit's
    greedy matching (gdrnet_tpu/eval/pose_matching.match_poses) lets it
    match any GT instance it fits below the threshold. On the fixture, whose
    first object shows twice in every image, one perfect estimate a key of
    the SECOND instance: the toolkit's translation recall is 1 at every
    threshold, the port's 0 for the duplicated object; the objects shown
    once agree (ROADMAP.md §C)."""
    _, (records, models) = chains
    by_key: dict = {}
    for g in records:
        by_key.setdefault((g["scene_id"], g["im_id"], g["obj_id"]), []).append(g)
    results = [{"scene_id": k[0], "im_id": k[1], "obj_id": k[2], "score": 1.0,
                "R": gts[-1]["R"].astype(np.float64), "t": gts[-1]["t"] * 1000.0, "time": 0.1}
               for k, gts in by_key.items()]
    port = bop_score.score_results(results, records, models, error_types="te", n_top=1,
                                   device="cpu")["te"]
    ths = (0.02, 0.05, 0.10)
    tps, targets = {}, {}
    for est, (key, gts) in zip(results, by_key.items()):
        name = models.meta.id2obj[key[2]]
        targets[name] = targets.get(name, 0) + min(1, len(gts))  # calc_localization_scores
        errs = [{"est_id": 0, "score": est["score"], "errors": {
            j: [float(np.linalg.norm(est["t"] / 1000.0 - g["t"]))] for j, g in enumerate(gts)}}]
        hits = [len(match_poses(errs, [th])) for th in ths]
        tps[name] = [a + b for a, b in zip(tps.get(name, [0, 0, 0]), hits)]
    toolkit = {n: [tp / targets[n] for tp in tps[n]] for n in tps}
    dup = {models.meta.id2obj[k[2]] for k, gts in by_key.items() if len(gts) > 1}
    print("te recalls at 2/5/10 cm, port pairing:", {n: port[n] for n in toolkit},
          "toolkit matching:", toolkit)
    assert len(dup) == 1 and len(toolkit) == 2
    for name in toolkit:
        assert toolkit[name] == [1.0, 1.0, 1.0]
        assert port[name] == ([0.0, 0.0, 0.0] if name in dup else [1.0, 1.0, 1.0])


def test_written_bop_split_loads_through_jax(tmp_path):
    """The port's BOP split writer (rendering on the CPU here): the JAX
    package reads the same records, models and depth images from it."""
    zoo = gen_scale_dataset().mesh_zoo()[:3]
    rng = np.random.RandomState(3)
    q = np.linalg.qr(rng.randn(6, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t = np.concatenate([rng.uniform(-0.04, 0.04, (6, 2)), rng.uniform(0.5, 0.7, (6, 1))], 1)
    K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]], np.float32)
    pmeta, keys = write_bop_split(str(tmp_path), zoo, np.array([0, 1, 2, 2, 1, 0]), R, t,
                                       K, width=160, height=120, per_image=3,
                                       images_per_scene=1, device="cpu")
    assert keys.tolist() == [[1, 0]] * 3 + [[2, 0]] * 3
    jmeta = jref_meta.meta_from_json(str(tmp_path))
    _assert_same(dataclasses.asdict(pmeta), dataclasses.asdict(jmeta), "meta")
    want = jbop.load_bop_scene_dicts(jmeta, "test")
    _assert_same(bop.load_bop_scene_dicts(pmeta, "test"), want, "records")
    assert len(want) >= 4 and all(0 < r["visib_fract"] <= 1 for r in want)
    for r in want:
        depth = jio.load_depth(r["depth_path"], r["depth_scale"])
        np.testing.assert_array_equal(io.load_depth(r["depth_path"], r["depth_scale"]), depth)
        assert (depth > 0).sum() >= r["bbox_visib"][2] * r["bbox_visib"][3] * 0.2
    jm = jmodel_store.ObjectModels(jmeta, num_pm_points=50, num_fps=8)
    pm = model_store.ObjectModels(pmeta, num_pm_points=50, num_fps=8)
    _assert_same(pm.sym_rots, jm.sym_rots, "sym_rots")
    _assert_same(pm.diameters, jm.diameters, "diameters")
    np.testing.assert_allclose(pm.full_points["cube"], zoo[0][1], rtol=0, atol=1e-6)
