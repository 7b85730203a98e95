"""The port's synth dataset generator (gdrnet_tpu_torch/tools/
gen_scale_dataset.py) against the JAX package's tool (tools/
gen_scale_dataset.py, loaded from its path), on the CPU, from one seed.

Both tools draw the same numpy RNG streams, so they write the same scenes.
The port renders on B2's plain version, the JAX tool on XLA's z-buffer; the
JAX tool pads every mesh to the zoo's largest vertex count for its compile
cache, the port does not, and the test renders the JAX tool with batch 2
and face chunks of 512 (its default pads every render to 32 poses x 1,024
faces, a 2 GB XLA intermediate on the CPU); none of these changes a value,
ties going to the lowest face index in either chunking.

What may differ, and by how much: screen coordinates differ in the last
bits (tests/test_torch_render.py), so a uint16 mm depth or a uint8 grey
level may be 1 apart where its f32 value lies near a rounding boundary
(ROUNDING_FLIP_SHARE of the pixels at most), and a pixel of mask_visib may
change hands where two instances' depths lie within 1 mm, the composite
comparing uint16 mm (VISIB_FLIP_SHARE of the visible pixels at most, each
such pixel checked to lie on both instances within 1 mm), so an
instance's visible pixel count may differ by VISIB_COUNT_ATOL (its visible
box is then not compared); xyz_crop within 1e-3 m (f16). Everything else
is equal.
"""

import json
import os
import os.path as osp
import pickle

import cv2
import numpy as np
import pytest
import torch

from gdrnet_tpu.ops import fps as jfps
from gdrnet_tpu.ops import rasterizer as jrast

from gdrnet_tpu_torch.data.bop import load_detections
from gdrnet_tpu_torch.data.dataset_factory import resolve
from gdrnet_tpu_torch.data.io import read_png
from gdrnet_tpu_torch.tools import gen_scale_dataset as gen
from torch_parity import REPO, gen_scale_dataset

ROUNDING_FLIP_SHARE = 0.01
VISIB_FLIP_SHARE = 0.01
VISIB_COUNT_ATOL = 5
SUBZOO = (0, 3, 8)  # cube, tower (4-fold symmetric), bar


@pytest.fixture(scope="module")
def tool():
    """The JAX tool with tools/ importable (its write_models imports
    compute_fps from there), its renders at batch 2, chunk 512, and its FPS
    on the numpy sampler that the port copies: where g++ is present the
    tool samples with gdrnet_tpu/csrc/fps, which breaks ties between equal
    distances otherwise (the tower's fps128 differs in 4 of 129 points)."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(REPO / "tools"))
    import compute_fps

    mp.setattr(compute_fps, "_sampler", lambda: jfps.farthest_point_sampling_np)
    gsd = gen_scale_dataset()
    mp.setattr(gsd, "_render_retry", lambda *a, **k: jrast.render_phong_xyz_roi_many(
        *a, **{**k, "batch": 2, "chunk": 512}))
    yield gsd
    mp.undo()


def test_mesh_zoo_equals_the_tool(tool):
    want, got = tool.mesh_zoo(), gen.mesh_zoo()
    assert [z[0] for z in got] == [z[0] for z in want] and len(got) == 10
    for (_, v, f, s), (_, vj, fj, sj) in zip(got, want):
        assert v.dtype == vj.dtype and f.dtype == fj.dtype
        np.testing.assert_array_equal(v, vj)
        np.testing.assert_array_equal(f, fj)
        assert len(s) == len(sj) and all(np.array_equal(a, b) for a, b in zip(s, sj))
    np.testing.assert_array_equal(gen._object_colors(10), tool._object_colors(10))
    v, f = want[5][1], want[5][2]
    for a, b in zip(gen._subdivide(v, f), tool._subdivide(v, f)):
        np.testing.assert_array_equal(a, b)


def test_write_models_equals_the_tool(tool, tmp_path):
    zoo = gen.mesh_zoo()
    got = gen.write_models(str(tmp_path / "port"), zoo)
    want = tool.write_models(str(tmp_path / "jax"), tool.mesh_zoo())
    assert got == want
    for name in sorted(os.listdir(tmp_path / "jax" / "models")):
        a, b = tmp_path / "port" / "models" / name, tmp_path / "jax" / "models" / name
        if name.endswith(".pkl"):
            pa, pb = (pickle.load(open(p, "rb")) for p in (a, b))
            assert pa.keys() == pb.keys() and len(pa) == 10
            for k in pb:
                assert pa[k].keys() == pb[k].keys()
                for key in pb[k]:
                    np.testing.assert_array_equal(pa[k][key], pb[k][key], err_msg=f"{k} {key}")
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_sample_scene_equals_the_tool(tool):
    zoo = gen.mesh_zoo()
    K = gen.K_DEF
    for seed in range(4):
        got = gen.sample_scene(np.random.RandomState(seed), zoo, K, 640, 480)
        want = tool.sample_scene(np.random.RandomState(seed), zoo, K, 640, 480)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3].keys() == want[3].keys()
        for k in want[3]:
            np.testing.assert_array_equal(got[3][k], want[3][k])


def _read(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def _visib_depths(sdir, im_id, k, ys, xs, gt):
    """Camera z (mm) of instance k at pixels (ys, xs), from its xyz_crop
    pickle and its pose; nan where the instance does not cover a pixel."""
    with open(osp.join(sdir, "xyz_crop", f"{im_id:06d}_{k:06d}.pkl"), "rb") as f:
        crop = pickle.load(f)
    x1, y1, x2, y2 = crop["xyxy"]
    xyz = np.asarray(crop["xyz_crop"], np.float64)
    inside = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
    z = np.full(len(ys), np.nan)
    p = xyz[ys[inside] - y1, xs[inside] - x1]
    R = np.asarray(gt["cam_R_m2c"]).reshape(3, 3)
    zz = (p @ R[2] + gt["cam_t_m2c"][2] / 1000.0) * 1000.0
    z[inside] = np.where(np.abs(p).sum(-1) > 0, zz, np.nan)
    return z


def _compare_split(port_dir, jax_dir) -> dict:
    """Every file of a split written by both tools, by the rules of the
    module docstring; returns the counts of differing values."""
    counts = dict(depth_px=0, rgb_px=0, visib_px=0, visib_total=0, hit_px=0)
    for scene in sorted(os.listdir(jax_dir)):
        sp, sj = osp.join(port_dir, scene), osp.join(jax_dir, scene)
        assert sorted(os.listdir(sp)) == sorted(os.listdir(sj))
        for name in ("scene_gt.json", "scene_camera.json"):
            assert json.load(open(osp.join(sp, name))) == json.load(open(osp.join(sj, name)))
        scene_gt = json.load(open(osp.join(sj, "scene_gt.json")))
        info_p = json.load(open(osp.join(sp, "scene_gt_info.json")))
        info_j = json.load(open(osp.join(sj, "scene_gt_info.json")))
        for sub in ("rgb", "depth", "mask", "mask_visib", "xyz_crop"):
            assert sorted(os.listdir(osp.join(sp, sub))) == sorted(os.listdir(osp.join(sj, sub)))
        for im in scene_gt:
            im_id = int(im)
            name = f"{im_id:06d}.png"
            dp, dj = read_png(osp.join(sp, "depth", name)), _read(osp.join(sj, "depth", name))
            assert dp.dtype == dj.dtype == np.uint16
            np.testing.assert_array_equal(dp > 0, dj > 0)
            assert np.abs(dp.astype(int) - dj).max() <= 1
            counts["depth_px"] += int((dp != dj).sum())
            counts["hit_px"] += int((dj > 0).sum())
            rp = read_png(osp.join(sp, "rgb", name))
            rj = _read(osp.join(sj, "rgb", name))[..., ::-1]
            assert np.abs(rp.astype(int) - rj).max() <= 1
            counts["rgb_px"] += int((rp != rj).any(-1).sum())
            for k, (ip, ij) in enumerate(zip(info_p[im], info_j[im])):
                stem = f"{im_id:06d}_{k:06d}"
                np.testing.assert_array_equal(read_png(osp.join(sp, "mask", stem + ".png")),
                                              _read(osp.join(sj, "mask", stem + ".png")))
                vp = read_png(osp.join(sp, "mask_visib", stem + ".png"))
                vj = _read(osp.join(sj, "mask_visib", stem + ".png"))
                ys, xs = np.nonzero(vp != vj)
                counts["visib_px"] += len(ys)
                counts["visib_total"] += int((vj > 0).sum())
                if len(ys):  # each such pixel: some other instance within 1 mm of this one
                    z_k = _visib_depths(sj, im_id, k, ys, xs, scene_gt[im][k])
                    near = np.zeros(len(ys), bool)
                    for m in range(len(scene_gt[im])):
                        if m != k:
                            z_m = _visib_depths(sj, im_id, m, ys, xs, scene_gt[im][m])
                            near |= np.abs(z_m - z_k) <= 1.1
                    assert near.all(), (scene, im, k, ys[~near], xs[~near])
                assert ip["bbox_obj"] == ij["bbox_obj"] and ip["px_count_all"] == ij["px_count_all"]
                assert abs(ip["px_count_visib"] - ij["px_count_visib"]) <= VISIB_COUNT_ATOL
                if ip["px_count_visib"] == ij["px_count_visib"]:
                    assert ip["bbox_visib"] == ij["bbox_visib"]
                with open(osp.join(sp, "xyz_crop", stem + ".pkl"), "rb") as f:
                    cp = pickle.load(f)
                with open(osp.join(sj, "xyz_crop", stem + ".pkl"), "rb") as f:
                    cj = pickle.load(f)
                assert cp["xyxy"] == cj["xyxy"] and cp["xyz_crop"].dtype == np.float16
                np.testing.assert_allclose(cp["xyz_crop"].astype(np.float32),
                                           cj["xyz_crop"].astype(np.float32), rtol=0, atol=1e-3)
    return counts


@pytest.mark.parametrize("split,n_images", [("train", 3), ("test", 2)])
def test_generate_split_equals_the_tool(tool, tmp_path, split, n_images):
    """A 3-object sub-zoo at 320x240 (K scaled), one scene; the test split
    also writes est_dets.json from a seed."""
    zoo = [gen.mesh_zoo()[i] for i in SUBZOO]
    colors = gen._object_colors(len(zoo))
    K = gen.K_DEF.copy()
    K[:2] *= 0.5
    v_max = max(len(z[1]) for z in zoo)  # the JAX tool's compile-reuse padding (:610-616)
    zoo_padded = [(n, np.concatenate([v, np.repeat(v[-1:], v_max - len(v), 0)]), f, s)
                  for n, v, f, s in zoo]
    first = 1 if split == "train" else 101
    stats = gen.generate_split(str(tmp_path / "port"), split, zoo, colors, K, 320, 240,
                               n_images, seed=3, first_scene=first, device="cpu")
    tool.generate_split(str(tmp_path / "jax"), split, zoo_padded, colors, K, 320, 240,
                        n_images, seed=3, first_scene=first)
    assert stats["chunks"] == 1 and stats["b2_launches"] == 0  # the CPU takes the plain version
    counts = _compare_split(str(tmp_path / "port" / split), str(tmp_path / "jax" / split))
    print(split, counts)
    assert counts["hit_px"] > 2000
    assert counts["depth_px"] <= ROUNDING_FLIP_SHARE * counts["hit_px"]
    assert counts["rgb_px"] <= ROUNDING_FLIP_SHARE * 320 * 240 * n_images
    assert counts["visib_px"] <= VISIB_FLIP_SHARE * counts["visib_total"]
    if split == "test":
        got = gen.write_detections(str(tmp_path / "port"), split, seed=3)
        want = tool.write_detections(str(tmp_path / "jax"), split, seed=3)
        assert json.load(open(got)) == json.load(open(want))


def test_main_writes_a_dataset_that_resolves(tmp_path):
    """The CLI on the CPU at a tiny size: models, meta.json, both splits and
    est_dets.json; the splits resolve by name, the detections load; a second
    run skips the complete scenes."""
    root = str(tmp_path / "synth_tiny")
    argv = ["--root", root, "--train-images", "3", "--test-images", "2", "--imgs-per-scene",
            "2", "--width", "240", "--height", "180", "--seed", "5", "--device", "cpu"]
    gen.main(argv)
    meta, train = resolve("synth_tiny_train", data_root=str(tmp_path))
    _, test = resolve("synth_tiny_test", data_root=str(tmp_path))
    assert meta.objects == [z[0] for z in gen.mesh_zoo()] and meta.width == 240
    assert {r["scene_id"] for r in train} == {1, 2} and {r["scene_id"] for r in test} == {101}
    assert all(osp.isfile(r["xyz_path"]) and osp.isfile(r["mask_visib_path"]) for r in train)
    dets = load_detections(osp.join(root, "test_bboxes", "est_dets.json"))
    assert set(dets) <= {(r["scene_id"], r["im_id"]) for r in test} and dets
    before = {p: os.path.getmtime(osp.join(root, "train", "000001", "rgb", p))
              for p in os.listdir(osp.join(root, "train", "000001", "rgb"))}
    gen.main(argv)  # resumes: every scene is complete
    assert before == {p: os.path.getmtime(osp.join(root, "train", "000001", "rgb", p))
                      for p in before}
    if not torch.cuda.is_available():  # the CLI runs on the card by default
        with pytest.raises(RuntimeError, match="no CUDA card"):
            gen.main(argv[:-2])
