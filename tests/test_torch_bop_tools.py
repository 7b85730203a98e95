"""The port's two BOP tools against the repository's, on tests/fixture_bop.py
(2 objects, 3 images of 320x240, PNG frames and masks), with get_meta of
both packages giving the fixture's meta:
- gen_test_targets: the json byte for byte the JAX tool's, over every
  image and over a keyframe list;
- gen_det_fuse: annotations.json and every JPEG byte for byte the JAX
  tool's (cv2.imread, cv2.resize and cv2.imwrite there; data/io,
  data/cv_ops and data/jpeg.py here), with the gradient backgrounds of
  BackgroundReplacer("") and with a folder of JPEG and PNG backgrounds.
"""

import dataclasses
import importlib.util
import os

import cv2
import numpy as np
import pytest

from gdrnet_tpu.data import ref_meta as jref_meta

from gdrnet_tpu_torch.data import ref_meta
from gdrnet_tpu_torch.data.augment import BackgroundReplacer
from gdrnet_tpu_torch.tools import gen_det_fuse, gen_test_targets
from fixture_bop import build_fixture_dataset
from torch_parity import REPO


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / f"tools/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop_tools")
    meta = build_fixture_dataset(str(root / "data"), n_images=3, seed=17)
    pmeta = ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                    for f in dataclasses.fields(meta)})
    bg = root / "backgrounds"
    bg.mkdir()
    rng = np.random.RandomState(2)
    for i, (h, w) in enumerate(((200, 300), (480, 360), (150, 500))):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        img = cv2.GaussianBlur(img, (9, 9), 3)  # natural-image-like spectra for the codec
        cv2.imwrite(str(bg / f"bg{i}.{'png' if i == 1 else 'jpg'}"), img)
    return root, meta, pmeta, str(bg)


@pytest.fixture
def both_metas(dataset, monkeypatch):
    monkeypatch.setattr(jref_meta, "get_meta", lambda name, data_root=None: dataset[1])
    monkeypatch.setattr(ref_meta, "get_meta", lambda name, data_root=None: dataset[2])


@pytest.mark.parametrize("keyframe", [False, True])
def test_gen_test_targets_json_equals_jax(dataset, both_metas, tmp_path, keyframe):
    extra = []
    if keyframe:
        (tmp_path / "keyframe.txt").write_text("0001/000000\n0001/000002\n\n")
        extra = ["--keyframe", str(tmp_path / "keyframe.txt")]
    argv = ["--dataset", "fixture", "--data-root", str(tmp_path)] + extra
    _root_tool("gen_test_targets").main(argv + ["--out", str(tmp_path / "jax.json")])
    rows = gen_test_targets.main(argv + ["--out", str(tmp_path / "port.json")])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert len(rows) == (4 if keyframe else 6) and {r["scene_id"] for r in rows} == {1}


@pytest.mark.parametrize("backgrounds", ["gradient", "folder"])
def test_gen_det_fuse_files_equal_jax(dataset, both_metas, tmp_path, backgrounds):
    bg_root = dataset[3] if backgrounds == "folder" else ""
    assert len(BackgroundReplacer(bg_root).paths) == (3 if bg_root else 0)
    argv = ["--dataset", "fixture", "--num-images", "4", "--bg-root", bg_root, "--seed", "3"]
    _root_tool("gen_det_fuse").main(argv + ["--out", str(tmp_path / "jax")])
    coco = gen_det_fuse.main(argv + ["--out", str(tmp_path / "port")])
    assert (tmp_path / "port" / "annotations.json").read_bytes() == (
        tmp_path / "jax" / "annotations.json").read_bytes()
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images")) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / "images" / name).read_bytes() == (
            tmp_path / "jax" / "images" / name).read_bytes(), name
    assert len(coco["annotations"]) >= 8 and {c["id"] for c in coco["categories"]} == {1, 2}
