"""The port's renders on the z-buffer kernel B2 (gdrnet_tpu_torch/ops/
rasterizer.py, eval/renderer.py, data/scene_renderer.py) against the JAX
package's, on the CPU, from the same numpy inputs. The JAX renders other
than XYZ run on XLA's rasterize_attr (no Pallas kernel), so no interpret
mode is needed; the port's run on B2's plain version, `rasterize_attr_ref`.

Tolerances: hit masks (depth > 0) exactly equal; depth and attribute maps
within ATOL = 1e-5 (the projection sums in another order than JAX's
matmul, so screen coordinates, and so the barycentrics, differ in the last
bits, as in tests/test_torch_raster.py); interpolated camera normals, and
the rgb shaded from them, within ATOL_NORMALS = 1e-4, since a unit vertex
normal changes by up to about 1 across a face at a box's edges (the
positions' channels, which change by millimetres there, stay within 3e-7
m). Where a value is rounded to an integer (uint16
mm depth, uint8 rgb) a difference of 1e-5 can cross a rounding boundary:
those may differ by 1 at a counted share of the hit pixels, stated in each
test; f16 xyz within 1e-3 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.data import scene_renderer as jscene
from gdrnet_tpu.data.ply import save_ply
from gdrnet_tpu.eval import renderer as jrenderer
from gdrnet_tpu.ops import rasterizer as jrast

from gdrnet_tpu_torch.data import scene_renderer
from gdrnet_tpu_torch.eval import renderer
from gdrnet_tpu_torch.ops import kernels, rasterizer
from test_rasterizer import K as CUBE_K
from test_rasterizer import make_cube
from torch_parity import gen_scale_dataset

ATOL = 1e-5
ATOL_NORMALS = 1e-4
# a uint8 / uint16 value that differs by 1: at most this share of hit pixels
ROUNDING_FLIP_SHARE = 0.01
K_VGA = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)
ZOO = {name: (v, f) for name, v, f, _ in gen_scale_dataset().mesh_zoo()}


def _poses(rs, n, z=(0.5, 0.9)):
    """n random rotations, object centres at random pixels of the VGA
    frame's middle, z metres away."""
    q = np.linalg.qr(rs.randn(n, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    c = np.stack([rs.uniform(200, 440, n), rs.uniform(140, 340, n), np.ones(n)], 1)
    t = (rs.uniform(*z, (n, 1)) * c @ np.linalg.inv(K_VGA).T).astype(np.float32)
    return R, t


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _phong_attrs(v, f, R, t, colors=None):
    """(n_cam, p_cam, material, xyz) [V, 12] as the JAX module builds them."""
    n_cam = jrast.vertex_normals(v, f) @ R.T
    mat = np.broadcast_to(jrast._CAD_MATERIAL, (len(v), 3)) if colors is None else colors
    return np.concatenate([n_cam, v @ R.T + t, mat, v], -1).astype(np.float32)


@pytest.mark.parametrize("per_pose", [True, False])
def test_rasterize_attr_per_pose_channels_match_jax(per_pose):
    """B2's plain version over 3 poses with 12 attribute channels a pose
    (the generator's pass), or one set of 5 shared by all, against JAX's
    rasterize_attr pose by pose; one window hangs over the frame's edge."""
    rs = np.random.RandomState(3)
    v, f = ZOO["tower"]
    R, t = _poses(rs, 3)
    t[2] = 0.6 * np.linalg.inv(K_VGA) @ np.array([630.0, 470.0, 1.0])
    c = t @ K_VGA.T
    origins = np.floor(c[:, :2] / c[:, 2:] - 64).astype(np.float32)
    if per_pose:
        attrs = np.stack([_phong_attrs(v, f, R[b], t[b]) for b in range(3)])
    else:
        attrs = (v @ rs.randn(3, 5) + 0.05 * rs.randn(5)).astype(np.float32)[None]
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (v, attrs, f, np.broadcast_to(K_VGA, (3, 3, 3)), R, t, origins)]
    depth, amap = kernels.rasterize_attr(*args, 128, 128)
    assert amap.shape == (3, 128, 128, attrs.shape[-1]) and kernels.rasterize_attr.launches == 0
    for b in range(3):
        dj, aj = jrast.rasterize_attr(
            jnp.asarray(v), jnp.asarray(attrs[b if per_pose else 0]),
            jnp.asarray(jrast._pad_faces(f, 512)), jnp.asarray(K_VGA), jnp.asarray(R[b]),
            jnp.asarray(t[b]), height=128, width=128, chunk=512,
            origin=(jnp.float32(origins[b, 0]), jnp.float32(origins[b, 1])))
        np.testing.assert_array_equal(depth[b].numpy() > 0, np.asarray(dj) > 0)
        assert (np.asarray(dj) > 0).sum() > 100
        _close(depth[b], dj)
        if per_pose:
            _close(amap[b, ..., :3], np.asarray(aj)[..., :3], atol=ATOL_NORMALS)
            _close(amap[b, ..., 3:], np.asarray(aj)[..., 3:])
        else:
            _close(amap[b], aj)


def test_render_normals_matches_jax():
    v, f = make_cube(0.05)
    R, t = _poses(np.random.RandomState(4), 1)
    t = np.array([0.01, -0.02, 0.5], np.float32)
    want = jrast.render_normals(v, f, CUBE_K, R[0], t, height=96, width=128)
    got = rasterizer.render_normals(v, f, CUBE_K, R[0], t, 96, 128, device="cpu")
    np.testing.assert_array_equal(got[0].numpy() > 0, np.asarray(want[0]) > 0)
    _close(got[0], want[0])
    _close(got[1], want[1], atol=ATOL_NORMALS)


@pytest.mark.parametrize("window", [False, True])
def test_render_phong_matches_jax(window):
    """Full frame, and a 128^2 window at an origin; per-vertex colours in
    the windowed case, the CAD material in the other."""
    rs = np.random.RandomState(5)
    v, f = ZOO["hexprism"]
    R, t = _poses(rs, 1, (0.6, 0.6))
    kw = dict(light_pos=(100.0, -200.0, 50.0), ambient=0.45, diffuse=0.7, specular=0.25)
    if window:
        org = rasterizer.window_origin(v, K_VGA, R[0], t[0], 480, 640, 128)
        colors = rs.rand(len(v), 3).astype(np.float32)
        want = jrast.render_phong(v, f, K_VGA, R[0], t[0], 128, 128, colors=colors, origin=org,
                                  **kw)
        got = rasterizer.render_phong(v, f, K_VGA, R[0], t[0], 128, 128, colors=colors,
                                      origin=org, device="cpu", **kw)
    else:
        want = jrast.render_phong(v, f, K_VGA, R[0], t[0], 480, 640, **kw)
        got = rasterizer.render_phong(v, f, K_VGA, R[0], t[0], 480, 640, device="cpu", **kw)
    np.testing.assert_array_equal(got[0].numpy() > 0, np.asarray(want[0]) > 0)
    assert (got[0] > 0).sum() > 500
    _close(got[0], want[0])
    _close(got[1], want[1], atol=ATOL_NORMALS)


def test_render_phong_many_matches_jax():
    """random_light draws each pose's light from one RandomState seed."""
    v, f = make_cube(0.05)
    rs = np.random.RandomState(6)
    q = np.linalg.qr(rs.randn(3, 3, 3))[0]
    Rs = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    ts = np.array([[0.0, 0.0, 0.5], [0.02, 0.01, 0.6], [-0.02, 0.0, 0.45]], np.float32)
    dj, cj = jrast.render_phong_many(v, f, CUBE_K, Rs, ts, 96, 128, random_light=True,
                                     rng=np.random.RandomState(9))
    dp, cp = rasterizer.render_phong_many(v, f, CUBE_K, Rs, ts, 96, 128, random_light=True,
                                          rng=np.random.RandomState(9), device="cpu")
    assert dp.shape == dj.shape == (3, 96, 128) and cp.shape == cj.shape == (3, 96, 128, 3)
    np.testing.assert_array_equal(dp > 0, dj > 0)
    _close(dp, dj)
    _close(cp, cj, atol=ATOL_NORMALS)


def _rounding_flips(got, want) -> int:
    """Pixels where two integer images ([H, W] or [H, W, 3])
    differ; raises where a value differs by more than 1."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, diff.max()
    return int((diff > 0).reshape(diff.shape[:2] + (-1,)).any(-1).sum())


@pytest.mark.parametrize("tile,on_misfit", [(64, "skip"), (128, "raise"), (128, "skip")])
def test_render_phong_xyz_roi_many_matches_jax(tile, on_misfit):
    """The generator's 12-channel pass, 5 poses with per-pose lights (at tile
    64 the two nearer ones do not fit and are skipped), against JAX's with
    batch 2 (its default pads to 32 poses x 1,024 faces, a 2 GB XLA
    intermediate on the CPU; the batch changes no output). Windows'
    origins and hit masks equal; uint16 mm depth and uint8 rgb equal but
    for values 1 apart at no more than ROUNDING_FLIP_SHARE of the hit
    pixels; f16 xyz within 1e-3 m."""
    rs = np.random.RandomState(64)
    v, f = ZOO["cube"]
    R, t = _poses(rs, 5, (1.2, 1.5))
    t[:2] *= 0.6  # near: beyond a 64^2 window
    colors = np.broadcast_to(rs.rand(3).astype(np.float32), (len(v), 3))
    kw = dict(colors=colors, light_pos=rs.uniform(-2, 2, (5, 3)).astype(np.float32),
              ambient=rs.uniform(0.35, 0.55, 5), diffuse=rs.uniform(0.6, 1.0, 5),
              specular=rs.uniform(0.1, 0.4, 5), on_misfit=on_misfit)
    Ks = np.broadcast_to(K_VGA, (5, 3, 3))
    if on_misfit == "raise" and tile == 64:
        return
    want = jrast.render_phong_xyz_roi_many(v, f, Ks, R, t, 480, 640, tile=tile, batch=2,
                                           chunk=512, **kw)
    got = rasterizer.render_phong_xyz_roi_many(v, f, Ks, R, t, 480, 640, tile=tile, batch=2,
                                               device="cpu", **kw)
    if on_misfit == "skip":
        (want, fit_j), (got, fit_p) = want, got
        assert fit_p == fit_j == ([2, 3, 4] if tile == 64 else [0, 1, 2, 3, 4])
    else:
        got_all = rasterizer.render_phong_xyz_roi_many(v, f, Ks, R, t, 480, 640, tile=tile,
                                                       batch=5, device="cpu", **kw)
        for a, b in zip(got, got_all):  # the batch changes nothing
            assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) and a[3] == b[3]
    assert len(got) == len(want) == (3 if tile == 64 else 5)
    hits = flips_d = flips_c = 0
    for (d, c, x, o), (dj, cj, xj, oj) in zip(got, want):
        assert o == oj and d.dtype == np.uint16 and c.dtype == np.uint8
        assert x.dtype == np.float16
        hit = dj > 0
        np.testing.assert_array_equal(d > 0, hit)
        hits += int(hit.sum())
        flips_d += _rounding_flips(d, dj)
        flips_c += _rounding_flips(c, cj)
        _close(x.astype(np.float32), xj.astype(np.float32), atol=1e-3)
    print(f"tile {tile}: {hits} hit px, depth flips {flips_d}, rgb flips {flips_c}")
    assert hits > 1000
    assert flips_d <= ROUNDING_FLIP_SHARE * hits and flips_c <= ROUNDING_FLIP_SHARE * hits
    if on_misfit == "raise":
        with pytest.raises(ValueError, match="exceed tile"):
            rasterizer.render_phong_xyz_roi_many(v, f, Ks, R, t, 480, 640, tile=64,
                                                 device="cpu")


@pytest.mark.parametrize("case", ["in_front", "near_plane"])
def test_render_box3d_matches_jax(case):
    """A box in front of the camera, and one whose 4 z-parallel edges cross
    the near plane (clipped to their visible part)."""
    lo = np.array([-0.05, -0.035, -0.03] if case == "in_front" else [-0.02, -0.02, -0.2],
                  np.float32)
    hi = -lo
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.01, 0, 0.5] if case == "in_front" else [0, 0, 0.1], np.float32)
    want = np.asarray(jrast.render_box3d(lo, hi, CUBE_K, R, t, height=96, width=128))
    got = rasterizer.render_box3d(lo, hi, CUBE_K, R, t, 96, 128, device="cpu").numpy()
    assert (want[..., 1] > 0).sum() > 50
    np.testing.assert_array_equal(got, want)


def test_render_scene_matches_jax():
    """Five zoo instances, two of them the same mesh and overlapping, one
    random light: rgb, depth, the instance map, both box sets and masks."""
    rs = np.random.RandomState(8)
    models = [ZOO["cube"], ZOO["tower"], (*ZOO["octa"], rs.rand(len(ZOO["octa"][0]), 3))]
    obj_is = [0, 1, 2, 1, 0]
    R, t = _poses(rs, 5, (0.5, 0.9))
    t[3] = t[1] + np.array([0.04, 0.03, 0.05], np.float32)  # beside instance 1, overlapping
    want = jrast.render_scene(models, obj_is, K_VGA, R, t, 480, 640, random_light=True,
                              rng=np.random.RandomState(2))
    got = rasterizer.render_scene(models, obj_is, K_VGA, R, t, 480, 640, random_light=True,
                                  rng=np.random.RandomState(2), device="cpu")
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["inst_map"], want["inst_map"])
    assert (want["inst_map"] == 3).sum() > 0 and (want["inst_map"] == 1).sum() > 0
    for k in ("bboxes", "bboxes_amodal", "masks_visib"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _close(got["depth"], want["depth"])
    _close(got["rgb"], want["rgb"], atol=ATOL_NORMALS)


@pytest.mark.parametrize("mode", ["rgb+depth", "depth"])
def test_renderer_matches_jax(tmp_path, mode):
    """create_renderer / add_object from a coloured PLY / render_object, at
    a window pose and at a pose too near for any window (the full-frame
    path); uint8 rgb within 1 at no more than ROUNDING_FLIP_SHARE of the hit
    pixels (the JAX renderer truncates the f32 rgb)."""
    v, f = ZOO["wedge"]
    ply = str(tmp_path / "obj.ply")
    save_ply(ply, v, faces=f, colors=np.random.RandomState(1).randint(0, 255, (len(v), 3)))
    got_r = renderer.create_renderer(320, 240, renderer_type="egl", mode=mode, device="cpu")
    want_r = jrenderer.create_renderer(320, 240, renderer_type="egl", mode=mode)
    for r in (got_r, want_r):
        r.add_object(3, ply)
        r.set_light_cam_pos((50.0, 50.0, -100.0))
    R, _ = _poses(np.random.RandomState(2), 1)
    for t in ([0.02, 0.01, 0.6], [0.0, 0.0, 0.12]):
        got = got_r.render_object(3, R[0], t, 300.0, 300.0, 160.0, 120.0)
        want = want_r.render_object(3, R[0], t, 300.0, 300.0, 160.0, 120.0)
        assert got.keys() == want.keys()
        if "depth" in want:
            hit = want["depth"] > 0
            np.testing.assert_array_equal(got["depth"] > 0, hit)
            assert hit.sum() > 500
            _close(got["depth"], want["depth"])
        if "rgb" in want:
            flips = _rounding_flips(got["rgb"], want["rgb"])
            assert flips <= ROUNDING_FLIP_SHARE * hit.sum()


def test_scene_renderer_matches_jax():
    """One seed: the same draws, so the same bgr image, obj_info and extras
    (gradient background; the uint8 image within 1 at no more than
    ROUNDING_FLIP_SHARE of the hit pixels, the JAX renderer truncating)."""
    models = [(ZOO[n][0] * 1000.0, ZOO[n][1]) for n in ("cube", "bar", "pyramid")]
    kw = dict(obj_ids=[1, 9, 5], width=320, height=240,
              K=np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1]], np.float32),
              min_num_objects_per_scene=3, max_num_objects_per_scene=5)
    got = scene_renderer.SceneRenderer(models, rng=np.random.RandomState(4), device="cpu", **kw)
    want = jscene.SceneRenderer(models, rng=np.random.RandomState(4), **kw)
    for _ in range(2):
        bgr, info, extras = got.render()
        bgr_j, info_j, extras_j = want.render()
        assert info == info_j and extras.keys() == extras_j.keys()
        for k in ("inst_map", "masks_visib", "bboxes_visib", "obj_is", "Rs", "ts"):
            np.testing.assert_array_equal(extras[k], extras_j[k], err_msg=k)
        _close(extras["depth"], extras_j["depth"], atol=ATOL * 1000.0)  # mm
        hit = extras_j["depth"] > 0
        assert _rounding_flips(bgr, bgr_j) <= ROUNDING_FLIP_SHARE * hit.sum()
    np.testing.assert_array_equal(scene_renderer.random_rotation(np.random.RandomState(1)),
                                  jscene.random_rotation(np.random.RandomState(1)))


def test_vertex_normals_equal_jax():
    v, f = ZOO["lblock"]
    np.testing.assert_array_equal(rasterizer.vertex_normals(v, f), jrast.vertex_normals(v, f))


def test_rasterize_attr_checks_its_inputs():
    v, f = make_cube(0.05)
    ok = dict(verts=torch.from_numpy(v), attrs=torch.from_numpy(v)[None],
              faces=torch.from_numpy(f), K=torch.from_numpy(CUBE_K)[None].repeat(2, 1, 1),
              R=torch.eye(3).repeat(2, 1, 1), t=torch.tensor([[0.0, 0.0, 0.5]] * 2),
              origins=torch.zeros(2, 2))

    def call(**kw):
        return kernels.rasterize_attr(**{**ok, **kw}, height=8, width=8)

    assert call()[1].shape == (2, 8, 8, 3) and kernels.rasterize_attr.launches == 0
    assert call(attrs=torch.zeros(2, len(v), 16))[1].shape == (2, 8, 8, 16)
    with pytest.raises(ValueError, match="attribute channels"):
        call(attrs=torch.zeros(1, len(v), 0))
    with pytest.raises(ValueError, match="attribute channels"):
        call(attrs=torch.zeros(1, len(v), 17))
    with pytest.raises(ValueError, match=r"\[1 or B, V, C\]"):
        call(attrs=torch.zeros(3, len(v), 3))
    with pytest.raises(ValueError, match=r"\[1 or B, V, C\]"):
        call(attrs=torch.zeros(1, len(v) + 1, 3))
    with pytest.raises(ValueError, match=r"\[1 or B, V, C\]"):
        call(attrs=torch.from_numpy(v))
    with pytest.raises(TypeError, match="float32"):
        call(attrs=ok["attrs"].double())
    with pytest.raises(ValueError, match="attrs on meta"):
        call(attrs=ok["attrs"].to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.rasterize_attr(*(x.to("meta") for x in ok.values()), 8, 8)
