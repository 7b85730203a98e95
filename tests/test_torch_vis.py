"""The port's visualization slice on the CPU: data/cv_ops's line, rectangle
and put_text against cv2 5.0 itself, the glyph table against a fresh one,
utils/vis against gdrnet_tpu/utils/vis.py, and data/visualize's
vis_records and main against gdrnet_tpu/data/visualize.py on
tests/fixture_bop.build_fixture_dataset (as tests/test_utils_aux.py:60-77
builds it).

Tolerances: line, rectangle and put_text bit for bit with cv2, the text's
box included (so put_text's tolerance inside getTextSize's box, grown by
1 px, is zero: OpenCV 5.0 blends each glyph's antialiased mask in turn at
an integer pen position, and the table holds those masks). The drawings
and the panels handed to grid_show bit for bit with the JAX package's;
the projected box corners within 1e-4 px of JAX's (one f32 projection in
two libraries), and a record whose corner lies within 1e-3 px of an
integer, where astype(int) may truncate the two the other way, is counted
and not compared.
"""

import importlib.util
import re
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from gdrnet_tpu.config import base_config as jax_base_config
from gdrnet_tpu.data import dataset_factory as jax_factory
from gdrnet_tpu.data import visualize as jax_visualize
from gdrnet_tpu.data.bop import load_bop_scene_dicts as jax_load_dicts
from gdrnet_tpu.data.model_store import ObjectModels as JaxObjectModels
from gdrnet_tpu.utils import vis as jvis

from gdrnet_tpu_torch.config import base_config
from gdrnet_tpu_torch.data import cv_ops, dataset_factory, font_simplex, visualize
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.io import read_png
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.tools import NoCardError
from gdrnet_tpu_torch.utils import vis
from torch_parity import REPO

FONT = cv2.FONT_HERSHEY_SIMPLEX
CORNER_ATOL, FLIP_BAND = 1e-4, 1e-3
FIXTURE = "vis_fixture_test"


def _draw_cases(seed: int, n: int) -> list:
    """n seeded (h, w, channels, p1, p2) cases, end points up to 3 image
    sizes outside, a sixth each horizontal, vertical or single-point; then
    fixed edge cases: both directions of one segment, points far outside,
    a segment that misses the image, one along an edge."""
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(n):
        h, w = (int(v) for v in rng.randint(1, 48, 2))
        p1 = (int(rng.randint(-3 * w, 4 * w)), int(rng.randint(-3 * h, 4 * h)))
        p2 = (int(rng.randint(-3 * w, 4 * w)), int(rng.randint(-3 * h, 4 * h)))
        kind = rng.randint(6)
        p2 = {0: (p2[0], p1[1]), 1: (p1[0], p2[1]), 2: p1}.get(kind, p2)
        cases.append((h, w, int(rng.choice([1, 3])), p1, p2))
    return cases + [(20, 30, 3, (2, 3), (25, 17)), (20, 30, 3, (25, 17), (2, 3)),
                    (20, 30, 1, (-500, -7), (900, 40)), (20, 30, 3, (-5, -5), (-1, 40)),
                    (20, 30, 1, (0, 0), (29, 0)), (20, 30, 3, (29, 19), (29, 19)),
                    (480, 640, 3, (-4000, 2500), (3000, -1200))]


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("fn", ["line", "rectangle"])
def test_line_and_rectangle_equal_cv2(fn, thickness):
    """cv_ops.line / rectangle bit for bit with cv2.line / cv2.rectangle
    (LINE_8) over 300 seeded cases and the edge cases, 1- and 3-channel;
    for lines, cv2.clipLine's answer too."""
    rng = np.random.RandomState(7)
    for h, w, ch, p1, p2 in _draw_cases(thickness, 300):
        img = rng.randint(0, 256, (h, w, ch) if ch == 3 else (h, w)).astype(np.uint8)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want = getattr(cv2, fn)(img.copy(), p1, p2, color, thickness)
        got = getattr(cv_ops, fn)(img.copy(), p1, p2, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{fn} {(h, w, ch, p1, p2)}")
        if fn == "line":
            ok, q1, q2 = cv2.clipLine((0, 0, w, h), p1, p2)
            clipped = cv_ops.clip_line((w, h), p1, p2)
            assert clipped == (((tuple(q1), tuple(q2))) if ok else None), (h, w, p1, p2)


# the fixture's labels and panel titles, digits, and every glyph of the table
@pytest.mark.parametrize("text", ["cube", "brick", "cube s1 i0", "brick s1 i1", "roi_img",
                                  "mask_visib", "region", "0123456789", "1", "42",
                                                    "".join(map(chr, range(32, 80))),
                                                    "".join(map(chr, range(80, 127)))])
def test_put_text_equals_cv2(text):
    """put_text bit for bit with cv2.putText(FONT_HERSHEY_SIMPLEX, 0.5, 1)
    on random backgrounds, 1- and 3-channel, at origins inside and partly
    outside the image; the ink inside getTextSize's box grown by 1 px, and
    nothing outside it; the width equal to getTextSize's."""
    rng = np.random.RandomState(len(text))
    (tw, th), base = cv2.getTextSize(text, FONT, 0.5, 1)
    assert cv_ops.get_text_size(text) == tw
    for org in [(5, 20), (-7, 9), (tw // 2 + 30, 45), (int(rng.randint(-40, 60)), 50)]:
        for ch in (1, 3):
            img = rng.randint(0, 256, (48, tw + 40) + ((3,) if ch == 3 else ())).astype(np.uint8)
            color = tuple(int(v) for v in rng.randint(0, 256, 3))
            want = cv2.putText(img.copy(), text, org, FONT, 0.5, color, 1)
            got = cv_ops.put_text(img.copy(), text, org, color)
            np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")
            outside = np.ones(img.shape[:2], bool)
            outside[max(org[1] - th - 1, 0):org[1] + base + 2,
                    max(org[0] - 1, 0):org[0] + tw + 1] = False
            assert np.array_equal(got[outside], img[outside])


def test_put_text_raises_outside_its_table():
    img = np.zeros((20, 40, 3), np.uint8)
    for text in ("café", "a\nb", "\t"):
        bad = next(c for c in text if not 32 <= ord(c) < 127)
        with pytest.raises(ValueError, match=re.escape(repr(bad))):
            cv_ops.put_text(img, text, (2, 15), (255, 255, 255))


def test_glyph_table_equals_a_fresh_one():
    """scripts/gen_font_simplex.py run against this cv2 gives the committed
    table and the committed file, byte for byte."""
    spec = importlib.util.spec_from_file_location("gen_font_simplex",
                                                  REPO / "scripts" / "gen_font_simplex.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    table = gen.glyph_table()
    assert table == font_simplex.GLYPHS
    assert gen.module_source(table) == gen.OUT.read_text()
    assert (font_simplex.SCALE, font_simplex.THICKNESS) == (0.5, 1)


def test_colormap_equals_jax():
    for idx in range(31):
        for bgr in (True, False):
            assert vis.colormap(idx, bgr) == jvis.colormap(idx, bgr)
            np.testing.assert_array_equal(vis.colormap(idx, bgr, uint8=False),
                                          jvis.colormap(idx, bgr, uint8=False))


@pytest.mark.parametrize("fn", ["vis_image_bboxes_cv2", "vis_image_mask_cv2",
                                "draw_projected_box3d", "vis_xyz_map"])
def test_drawings_equal_jax(fn):
    """Each drawing on the same seeded inputs as the JAX package's: boxes
    in and partly out of the image with labels (thickness 2 and 1), masks
    at several colours and alphas, 3D boxes whose corners leave the image
    (thickness 1 and 2), XYZ maps out of [0, 1]; bit for bit."""
    rng = np.random.RandomState(11)
    for k in range(12):
        img = rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)
        if fn == "vis_image_bboxes_cv2":
            boxes = rng.uniform(-20, 100, (3, 4))
            args, kw = (img, boxes, ["ape", 3, "cube s1 i0"][:1 + k % 3]), {
                "thickness": 2 if k % 2 else 1}
        elif fn == "vis_image_mask_cv2":
            args, kw = (img, rng.rand(60, 80) > 0.6, k), {"alpha": [0.5, 0.3, 0.9][k % 3]}
        elif fn == "draw_projected_box3d":
            args, kw = (img, rng.uniform(-40, 120, (8, 2))), {"thickness": 1 + k % 2}
        else:
            args, kw = (rng.uniform(-0.2, 1.2, (16, 16, 3)),), {}
        np.testing.assert_array_equal(getattr(vis, fn)(*args, **kw),
                                      getattr(jvis, fn)(*args, **kw), err_msg=f"{fn} {k}")


def _panels():
    rng = np.random.RandomState(5)
    return ([rng.randint(0, 256, (40, 50, 3)).astype(np.uint8),
             rng.rand(30, 30).astype(np.float32), rng.rand(20, 36) > 0.5,
             rng.uniform(-0.5, 1.5, (24, 24, 3))],
            ["img", "mask", "bool", "xyz"])


def test_grid_show_with_matplotlib_equals_jax(tmp_path):
    """With matplotlib, grid_show's saved figure decodes to the JAX
    package's pixels for the same panels."""
    import matplotlib.pyplot as plt

    images, titles = _panels()
    assert vis.grid_backend() == "matplotlib"
    for mod, name in ((vis, "port"), (jvis, "jax")):
        fig = mod.grid_show(images, titles, row=2, save_path=str(tmp_path / f"{name}.png"))
        plt.close(fig)
    port, jax = (cv2.imread(str(tmp_path / f"{n}.png"), cv2.IMREAD_UNCHANGED)
                 for n in ("port", "jax"))  # RGBA, which the port's PNG reader leaves out
    assert port.shape == jax.shape and port.shape[2] == 4
    np.testing.assert_array_equal(port, jax)


def test_grid_show_without_matplotlib_writes_the_mosaic(tmp_path, monkeypatch):
    """With matplotlib blocked, grid_show returns the mosaic and writes it:
    each panel bitwise in its cell (uint8 BGR flipped, floats and bools
    scaled to 0-255 from [0, 1], 2-D as grey), each title as put_text draws
    it above its panel, the rest white."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert vis.grid_backend() == "mosaic"
    images, titles = _panels()
    out = vis.grid_show(images, titles, row=2, save_path=str(tmp_path / "grid.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "grid.png")), out)
    (h, w), origins = vis.mosaic_cells(images, titles, 2, 2)
    assert out.shape == (h, w, 3) and len(origins) == 4
    blank = np.full_like(out, 255)
    for img, title, (y, x) in zip(images, titles, origins):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            want = img[..., ::-1]
        else:
            want = np.round(np.clip(img.astype(np.float64), 0, 1) * 255).astype(np.uint8)
        want = np.repeat(want[..., None], 3, -1) if want.ndim == 2 else want
        np.testing.assert_array_equal(out[y:y + want.shape[0], x:x + want.shape[1]], want)
        blank[y:y + want.shape[0], x:x + want.shape[1]] = want
        cv2.putText(blank, title, (x, y - vis.TITLE_H + vis.TITLE_BASELINE), FONT, 0.5,
                    (0, 0, 0), 1)
    np.testing.assert_array_equal(out, blank)
    with pytest.raises(ValueError, match="matplotlib"):
        vis.grid_show(images, titles, show=True)


@pytest.fixture(scope="module")
def fixture_split(tmp_path_factory):
    from fixture_bop import build_fixture_dataset

    root = tmp_path_factory.mktemp("vis")
    meta = build_fixture_dataset(str(root / "ds"), n_images=2, seed=13)
    return {"root": root, "meta": meta}


def _capture(monkeypatch, mod) -> dict:
    """The panels and titles each grid_show call of `mod` is handed, and
    the corners each draw_projected_box3d call is."""
    seen = {"panels": [], "corners": []}
    grid_show, draw = mod.grid_show, mod.draw_projected_box3d

    def grid(images, titles=None, **kw):
        seen["panels"].append(([np.array(im, copy=True) for im in images], list(titles)))
        return grid_show(images, titles, **kw)

    def box(img, corners_2d, *a, **kw):
        seen["corners"].append(np.array(corners_2d, np.float64))
        return draw(img, corners_2d, *a, **kw)

    monkeypatch.setattr(mod, "grid_show", grid)
    monkeypatch.setattr(mod, "draw_projected_box3d", box)
    return seen


def _assert_panels_equal(port: dict, jax: dict) -> int:
    """The port's captured panels against JAX's; returns the records not
    compared for a possible truncation flip of a corner."""
    assert len(port["panels"]) == len(jax["panels"]) > 0
    assert len(port["corners"]) == len(jax["corners"])
    flips = set()
    for i, (a, b) in enumerate(zip(port["corners"], jax["corners"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=CORNER_ATOL)
        if (np.abs(b - np.round(b)) < FLIP_BAND).any():
            flips.add(i)
    for i, ((pa, ta), (pb, tb)) in enumerate(zip(port["panels"], jax["panels"])):
        assert ta == tb
        if i in flips:
            continue
        for x, y in zip(pa, pb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    return len(flips)


@pytest.mark.parametrize("mapped", [False, True])
def test_vis_records_equals_jax(fixture_split, monkeypatch, tmp_path, mapped):
    """vis_records on device="cpu" hands grid_show JAX's panels, over the
    fixture's records, both modes (the mapped mode renders its XYZ on B2's
    plain version)."""
    meta = fixture_split["meta"]
    port, jax = _capture(monkeypatch, vis), _capture(monkeypatch, jvis)
    cfg, jcfg = base_config(), jax_base_config()
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = jcfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    saved = visualize.vis_records(meta, load_bop_scene_dicts(meta, "test"),
                                  ObjectModels(meta, num_pm_points=64), n=3,
                                  save_dir=str(tmp_path / "port"), mapped=mapped, cfg=cfg,
                                  device="cpu")
    want = jax_visualize.vis_records(meta, jax_load_dicts(meta, "test"),
                                     JaxObjectModels(meta, num_pm_points=64), n=3,
                                     save_dir=str(tmp_path / "jax"), mapped=mapped, cfg=jcfg)
    assert [p.replace("port", "jax") for p in saved] == want and len(saved) == 3
    _assert_panels_equal(port, jax)


@pytest.mark.parametrize("mapped", [False, True])
def test_main_equals_jax(fixture_split, monkeypatch, tmp_path, capsys, mapped):
    """main([split, --device cpu]) over the fixture registered under one
    name in both packages' factories: JAX's panels, files in both modes,
    and the grid backend printed; without a card the default device
    raises."""
    meta = fixture_split["meta"]
    for factory, load in ((dataset_factory, load_bop_scene_dicts),
                          (jax_factory, jax_load_dicts)):
        monkeypatch.setitem(factory._REGISTRY, FIXTURE,
                            lambda load=load: (meta, load(meta, "test")))
    port, jax = _capture(monkeypatch, vis), _capture(monkeypatch, jvis)
    args = [FIXTURE, "--n", "2"] + (["--mapped"] if mapped else [])
    saved = visualize.main(args + ["--save-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith(f"(grid: {vis.grid_backend()})")
    jax_visualize.main(args + ["--save-dir", str(tmp_path / "jax")])
    assert len(saved) == 2 and all(Path(p).is_file() for p in saved)
    _assert_panels_equal(port, jax)
    if not torch.cuda.is_available():
        with pytest.raises(NoCardError, match="--device cpu"):
            visualize.main(args + ["--save-dir", str(tmp_path / "card")])
