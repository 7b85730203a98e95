"""The port's z-buffer rasterizer (gdrnet_tpu_torch/ops/rasterizer.py and the
plain version of kernel B2 in ops/kernels.py) against the JAX package's
rasterizer and its Pallas kernel in interpret mode, on the CPU.

Meshes: the cube of tests/test_rasterizer.py and three zoo meshes of
tools/gen_scale_dataset.py (256-448 faces); windows at the origin and off
it, one pose behind the camera, one window hanging off the frame.

Tolerances: hit masks (depth > 0) exactly equal; depth and xyz (or any
attribute) within 1e-5 m. Both sides interpolate alike in f32, but the
projection sums in another order (broadcast products here, a matmul in
JAX), so screen coordinates differ in the last bits. window_origin is a
numpy copy and must be exactly equal. The CUDA kernel itself is held
against the plain version by tests/test_torch_cuda.py on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gdrnet_tpu.ops import rasterizer as jrast
from gdrnet_tpu.ops.pallas_kernels import rasterize_xyz_pallas

from gdrnet_tpu_torch.data.synthetic import edge_on_poses, sliver_mesh
from gdrnet_tpu_torch.ops import kernels, rasterizer
from test_rasterizer import K as CUBE_K
from test_rasterizer import make_cube
from torch_parity import gen_scale_dataset

ATOL = 1e-5
K_VGA = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)


ZOO = {name: (v, f) for name, v, f, _ in gen_scale_dataset().mesh_zoo()}
MESHES = {"cube": make_cube(0.05), "brick": ZOO["brick"], "tower": ZOO["tower"],
          "hexprism": ZOO["hexprism"]}


def _pose(rng, z=0.6, xy=(0.0, 0.0)):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    R = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    return R, np.array([xy[0], xy[1], z], np.float32)


def _assert_render_close(got_depth, got_map, want_depth, want_map):
    got_depth, got_map = np.asarray(got_depth), np.asarray(got_map)
    want_depth, want_map = np.asarray(want_depth), np.asarray(want_map)
    np.testing.assert_array_equal(got_depth > 0, want_depth > 0)
    np.testing.assert_allclose(got_depth, want_depth, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_map, want_map, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("origin", [None, (280, 200), (560, 400)])
def test_rasterize_attr_matches_jax(rng, mesh, origin):
    """Any attribute channels; origin (560, 400) puts the 128^2 window over
    the frame's bottom-right corner, where the object sits."""
    v, f = MESHES[mesh]
    # the object's centre projects to the window's centre, or for the
    # window off the frame to the frame's corner pixel (639, 479)
    centre = {None: (64, 64), (280, 200): (344, 264), (560, 400): (639, 479)}[origin]
    R, _ = _pose(rng)
    t = (0.55 * np.linalg.inv(K_VGA) @ np.array([*centre, 1.0])).astype(np.float32)
    # 5 channels, a random affine map of the object coordinates: z-fighting
    # faces (a landmark flush with a box face) then carry the same value
    # where they meet, as for xyz, and the tolerance means what it means there
    attrs = (v @ rng.randn(3, 5) + 0.05 * rng.randn(5)).astype(np.float32)
    kw = dict(height=128, width=128)
    want = jrast.rasterize_attr(
        jnp.asarray(v), jnp.asarray(attrs), jnp.asarray(jrast._pad_faces(f, 512)),
        jnp.asarray(K_VGA), jnp.asarray(R), jnp.asarray(t), chunk=512,
        origin=None if origin is None else (jnp.float32(origin[0]), jnp.float32(origin[1])),
        **kw)
    got = rasterizer.rasterize_attr(v, attrs, f, K_VGA, R, t, origin=origin, **kw)
    assert (np.asarray(want[0]) > 0).sum() > 100
    _assert_render_close(*got, *want)


@pytest.mark.parametrize("z", [0.5, -0.5])
def test_render_xyz_matches_jax(z):
    """Full frame; z = -0.5 puts the cube behind the camera: no hit."""
    v, f = MESHES["cube"]
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.02, -0.01, z], np.float32)
    want = jrast.render_xyz(v, f, CUBE_K, R, t, height=96, width=128)
    got = rasterizer.render_xyz(v, f, CUBE_K, R, t, height=96, width=128, device="cpu")
    _assert_render_close(*got, *want)
    assert (np.asarray(got[0]) > 0).any() == (z > 0)
    np.testing.assert_allclose(rasterizer.render_depth(v, f, CUBE_K, R, t, 96, 128, "cpu"),
                               got[0], rtol=0, atol=0)


@pytest.mark.parametrize("mesh", ["brick", "tower"])
def test_render_xyz_roi_matches_jax(rng, mesh):
    v, f = MESHES[mesh]
    R, t = _pose(rng, 0.8, (0.05, -0.04))
    dj, xj, oj = jrast.render_xyz_roi(v, f, K_VGA, R, t, 480, 640, tile=128)
    dp, xp, op = rasterizer.render_xyz_roi(v, f, K_VGA, R, t, 480, 640, tile=128, device="cpu")
    assert op == oj
    _assert_render_close(dp, xp, dj, xj)
    # the window equals the same pixels of the full-frame render
    full, _ = rasterizer.render_xyz(v, f, K_VGA, R, t, 480, 640, device="cpu")
    np.testing.assert_array_equal(dp.numpy(), full[oj[1]:oj[1] + 128, oj[0]:oj[0] + 128].numpy())
    with pytest.raises(ValueError, match="exceeds tile"):
        rasterizer.render_xyz_roi(v, f, K_VGA, R, t * np.float32([1, 1, 0.2]), 480, 640,
                                  tile=128, device="cpu")


def test_render_xyz_roi_many_matches_jax(rng):
    """Poses that fit a 128 tile, and one too near to fit (skipped)."""
    v, f = MESHES["tower"]
    poses = [_pose(rng, z, (x, 0.03)) for z, x in ((0.6, 0.0), (0.9, -0.1), (0.15, 0.0),
                                                    (1.1, 0.12))]
    Rs = np.stack([p[0] for p in poses])
    ts = np.stack([p[1] for p in poses])
    Ks = np.stack([K_VGA] * len(poses))
    want, want_fit = jrast.render_xyz_roi_many(v, f, Ks, Rs, ts, 480, 640, tile=128,
                                               on_misfit="skip")
    got, got_fit = rasterizer.render_xyz_roi_many(v, f, Ks, Rs, ts, 480, 640, tile=128,
                                                  on_misfit="skip", device="cpu")
    assert got_fit == want_fit == [0, 1, 3]
    for (dp, xp, op), (dj, xj, oj) in zip(got, want):
        assert op == oj
        _assert_render_close(dp, xp, dj, xj)
    with pytest.raises(ValueError, match="exceed tile"):
        rasterizer.render_xyz_roi_many(v, f, Ks, Rs, ts, 480, 640, tile=128, device="cpu")


def test_window_origin_equals_jax(rng):
    v, _ = MESHES["hexprism"]
    for z, xy, tile in ((0.5, (0, 0), 128), (0.7, (0.25, 0.18), 128), (0.3, (0, 0), 128),
                        (0.9, (-0.3, -0.2), 256), (0.2, (0.0, 0.0), 512)):
        R, t = _pose(rng, z, xy)
        assert (rasterizer.window_origin(v, K_VGA, R, t, 480, 640, tile)
                == jrast.window_origin(v, K_VGA, R, t, 480, 640, tile))


def test_paste_window_and_xyz_crop_equal_jax(rng):
    v, f = MESHES["brick"]
    R, t = _pose(rng, 0.8)
    dp, xp, org = rasterizer.render_xyz_roi(v, f, K_VGA, R, t, 480, 640, tile=128,
                                            device="cpu")
    got = rasterizer.paste_window(torch.zeros(480, 640), dp, (600, 450)).numpy()
    want = jrast.paste_window(np.zeros((480, 640), np.float32), dp.numpy(), (600, 450))
    np.testing.assert_array_equal(got, want)
    crop_p = rasterizer.xyz_crop_from_render(dp, xp)
    crop_j = jrast.xyz_crop_from_render(dp.numpy(), xp.numpy())
    assert crop_p["xyxy"] == crop_j["xyxy"]
    np.testing.assert_array_equal(crop_p["xyz_crop"], crop_j["xyz_crop"])


def test_rasterize_xyz_matches_pallas_interpret():
    """The plain version of B2 against the TPU kernel itself (interpret
    mode), full frame and a window off the origin."""
    v, f = MESHES["cube"]
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.02, -0.01, 0.5], np.float32)
    fp = jrast._pad_faces(f, 128)
    for (h, w, org) in ((96, 128, (0.0, 0.0)), (64, 64, (40.0, 20.0))):
        with pltpu.force_tpu_interpret_mode():
            dj, xj = rasterize_xyz_pallas(v, fp, CUBE_K, R, t, height=h, width=w,
                                          origin=(jnp.float32(org[0]), jnp.float32(org[1])),
                                          tile_p=256, chunk_f=128)
        dp, xp = kernels.rasterize_xyz(
            torch.from_numpy(v), torch.from_numpy(f), torch.from_numpy(CUBE_K)[None],
            torch.from_numpy(R)[None], torch.from_numpy(t)[None], torch.tensor([org]), h, w)
        _assert_render_close(dp[0], xp[0], dj, xj)


def test_ties_go_to_the_lowest_face_across_chunks():
    """Two coincident triangles with different attributes: the lower face
    index wins, also when 600 degenerate faces put them in different face
    chunks (the plain version's chunks hold 512); JAX agrees."""
    tri = np.array([[-0.05, -0.05, 0.0], [0.05, -0.05, 0.0], [0.0, 0.05, 0.0]], np.float32)
    v = np.concatenate([tri, tri])
    attrs = np.concatenate([np.ones((3, 1)), 2 * np.ones((3, 1))]).astype(np.float32)
    f = np.concatenate([[[0, 1, 2]], np.zeros((600, 3), np.int32), [[3, 4, 5]]]).astype(np.int32)
    R, t = np.eye(3, dtype=np.float32), np.array([0, 0, 0.5], np.float32)
    d, a = rasterizer.rasterize_attr(v, attrs, f, CUBE_K, R, t, height=96, width=128)
    hit = d.numpy() > 0
    assert hit.sum() > 100
    np.testing.assert_array_equal(a.numpy()[hit], 1.0)
    dj, aj = jrast.rasterize_attr(jnp.asarray(v), jnp.asarray(attrs),
                                  jnp.asarray(jrast._pad_faces(f, 512)), jnp.asarray(CUBE_K),
                                  jnp.asarray(R), jnp.asarray(t), height=96, width=128,
                                  chunk=512)
    _assert_render_close(d, a, dj, aj)


def test_zbuffer_ref_chunking_changes_nothing(rng, monkeypatch):
    """The plain version's pose, pixel and face chunks are bookkeeping:
    tiny chunks give bitwise the same render."""
    v, f = MESHES["tower"]
    poses = [_pose(rng, 0.5 + 0.1 * i) for i in range(3)]
    args = (torch.from_numpy(v), torch.from_numpy(f),
            torch.from_numpy(np.stack([K_VGA] * 3)),
            torch.from_numpy(np.stack([p[0] for p in poses])),
            torch.from_numpy(np.stack([p[1] for p in poses])),
            torch.tensor([[260.0, 180.0], [270.0, 190.0], [280.0, 200.0]]))
    want = kernels.rasterize_xyz_ref(*args, 100, 90)
    monkeypatch.setattr(kernels, "_RASTER_ELEMS", 1 << 10)
    monkeypatch.setattr(kernels, "_RASTER_FACE_CHUNK", 37)
    got = kernels.rasterize_xyz_ref(*args, 100, 90)
    assert (want[0] > 0).sum() > 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tile_by_tile_zbuffer(geom, attr, origins, height, width):
    """zbuffer_ref run on each RASTER_TILE block of the window over only the
    faces raster_tile_keep keeps for it (in face order)."""
    keep = kernels.raster_tile_keep(geom, origins, height, width)
    T = kernels.RASTER_TILE
    B, _, _ = geom.shape
    depth = torch.zeros(B, height, width)
    out = torch.zeros(B, height, width, attr.shape[-1] // 3)
    for b in range(B):
        for ty in range(keep.shape[1]):
            for tx in range(keep.shape[2]):
                idx = keep[b, ty, tx].nonzero()[:, 0]
                i0, j0 = ty * T, tx * T
                th, tw = min(T, height - i0), min(T, width - j0)
                if len(idx):  # else no face can cover the tile: it stays 0
                    org = origins[b:b + 1] + torch.tensor([[float(j0), float(i0)]])
                    d, a = kernels.zbuffer_ref(geom[b:b + 1, idx], attr[b:b + 1, idx], org,
                                               th, tw)
                    depth[b, i0:i0 + th, j0:j0 + tw] = d[0]
                    out[b, i0:i0 + th, j0:j0 + tw] = a[0]
    return depth, out, keep


def _random_poses(rs, n, z=(0.5, 1.0)):
    """n random rotations and translations that put the object's centre at
    a random pixel of the VGA frame's middle; returns R, t and that pixel."""
    q = np.linalg.qr(rs.randn(n, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    c = np.stack([rs.uniform(200, 440, n), rs.uniform(140, 340, n), np.ones(n)], 1)
    t = (rs.uniform(*z, (n, 1)) * c @ np.linalg.inv(K_VGA).T).astype(np.float32)
    return R, t, c[:, :2]


CULL_CASES = ["zoo/tower", "zoo/brick", "zoo/octa", "zoo/hexprism", "subdiv2/tower", "off_frame",
              "edge_on_cube", "slivers"]


def _cull_case(case):
    """(verts, faces, K [B,3,3], R, t, origins [B,2], height, width)."""
    rs = np.random.RandomState(sum(map(ord, case)))
    h = w = 96
    if case == "edge_on_cube":  # the zoo cube, faces seen exactly edge-on
        v, f = ZOO["cube"]
        R, t = edge_on_poses(0.035)
        c = t @ K_VGA.T
        centres = c[:, :2] / c[:, 2:]
    elif case == "slivers":
        v, f = sliver_mesh(K_VGA, seed=1)
        R = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3))
        t = np.zeros((2, 3), np.float32)
        centres = np.array([[236.0, 186.0], [250.0, 170.0]])
        h, w = 80, 112
    else:
        v, f = ZOO[case.split("/")[1] if "/" in case else "tower"]
        if case.startswith("subdiv2"):
            gsd = gen_scale_dataset()
            v, f = gsd._subdivide(*gsd._subdivide(v, f))
        R, t, centres = _random_poses(rs, 1 if case.startswith("subdiv2") else 3)
        if case == "off_frame":  # objects at the frame's corners, windows over its edges
            centres = np.array([[5.0, 475.0], [636.0, 3.0], [2.0, 2.0]])
            t = (0.6 * np.concatenate([centres, np.ones((3, 1))], 1)
                 @ np.linalg.inv(K_VGA).T).astype(np.float32)
    B = len(R)
    origins = np.floor(centres - [w // 2, h // 2]).astype(np.float32)
    return v, f, np.broadcast_to(K_VGA, (B, 3, 3)), R, t, origins, h, w


@pytest.mark.parametrize("case", CULL_CASES)
def test_tile_culling_changes_no_bit(case):
    """The CUDA kernel's per-tile culling rule (raster_tile_keep, its plain
    version): the z-buffer over only the kept faces of each tile equals the
    unculled plain z-buffer bit for bit, near-degenerate faces included."""
    v, f, K, R, t, origins, h, w = _cull_case(case)
    v32 = torch.from_numpy(np.asarray(v, np.float32))
    geom, attr = kernels.raster_face_tables(
        v32, v32, torch.from_numpy(np.asarray(f, np.int32)),
        *(torch.from_numpy(np.array(x, np.float32)) for x in (K, R, t)))
    org = torch.from_numpy(origins)
    want = kernels.zbuffer_ref(geom, attr, org, h, w)
    depth, xyz, keep = _tile_by_tile_zbuffer(geom, attr, org, h, w)
    assert torch.equal(depth, want[0]) and torch.equal(xyz, want[1])
    assert (want[0] > 0).sum() > 20
    assert keep.shape == (len(R), -(-h // 16), -(-w // 16), len(f))
    assert keep.float().mean() < 0.5
    inv_area = geom[..., 6].abs()[geom[..., 7] > 0]
    if case == "subdiv2/tower":  # the rule is not vacuous: most faces leave most tiles
        assert keep.float().mean() < 0.2
    if case == "edge_on_cube":  # faces seen edge-on: valid, with a thin sliver of area
        assert (inv_area > 100).any()
    if case == "slivers":  # near-degenerate faces, their bounds huge, are kept where needed
        assert (inv_area > 1e5).any() and (geom[..., 7] == 0).any()


def test_rasterize_xyz_checks_its_inputs():
    v, f = MESHES["cube"]
    ok = dict(verts=torch.from_numpy(v), faces=torch.from_numpy(f),
              K=torch.from_numpy(CUBE_K)[None], R=torch.eye(3)[None],
              t=torch.tensor([[0.0, 0.0, 0.5]]), origins=torch.zeros(1, 2))

    def call(**kw):
        return kernels.rasterize_xyz(**{**ok, **kw}, height=8, width=8)

    assert call()[0].shape == (1, 8, 8) and kernels.rasterize_xyz.launches == 0
    with pytest.raises(TypeError, match="float32"):
        call(verts=ok["verts"].double())
    with pytest.raises(TypeError, match="int32 or int64"):
        call(faces=ok["faces"].float())
    with pytest.raises(ValueError, match="F >= 1"):
        call(faces=ok["faces"][:0])
    with pytest.raises(ValueError, match="one batch size"):
        call(t=torch.zeros(2, 3))
    with pytest.raises(ValueError, match=r"\[B, 3, 3\]"):
        call(K=ok["K"][0])
    with pytest.raises(ValueError, match="contiguous"):
        call(origins=torch.zeros(2, 2)[:1, ::2].expand(1, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.rasterize_xyz(*(x.to("meta") for x in ok.values()), 8, 8)
