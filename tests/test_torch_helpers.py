"""The port's small helper modules against their JAX-package modules on the
CPU, from numpy-seeded inputs: ops/se3.py, ops/view_sampler.py,
utils/bbox_utils.py, utils/mask_utils.py (the RLE codec, and data/cv_ops's
fillPoly, dilate and erode against cv2 5.0) and data/dataset_params.py.

Tolerances: se3 within 1e-6 of the JAX functions (f32, both at full
precision); everything else bit for bit.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.data import dataset_params as jdp
from gdrnet_tpu.ops import se3 as jse3
from gdrnet_tpu.ops import view_sampler as jvs
from gdrnet_tpu.utils import bbox_utils as jbbox
from gdrnet_tpu.utils import mask_utils as jmask

from gdrnet_tpu_torch.data import cv_ops, dataset_params
from gdrnet_tpu_torch.data.io import load_cam_params
from gdrnet_tpu_torch.ops import se3, view_sampler
from gdrnet_tpu_torch.utils import bbox_utils, mask_utils


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_se3_equals_jax():
    rng = np.random.RandomState(0)
    R1, R2 = _rotations(rng, 6), _rotations(rng, 6)
    t1, t2 = (rng.randn(6, 3).astype(np.float32) for _ in range(2))
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    _close(se3.rt_to_mat4(T(R1), T(t1)), jse3.rt_to_mat4(jnp.asarray(R1), jnp.asarray(t1)))
    for got, want in zip(se3.mat4_to_rt(se3.rt_to_mat4(T(R1), T(t1))), (R1, t1)):
        _close(got, want, 0)
    for name in ("se3_mul", "relative_pose"):
        got = getattr(se3, name)(T(R1), T(t1), T(R2), T(t2))
        want = getattr(jse3, name)(*map(jnp.asarray, (R1, t1, R2, t2)))
        for g, w in zip(got, want):
            _close(g, w)
    inverses = se3.se3_inverse(T(R1), T(t1)), jse3.se3_inverse(jnp.asarray(R1), jnp.asarray(t1))
    for g, w in zip(*inverses):
        _close(g, w)
    near = (R1[0] @ cv2.Rodrigues(np.array([1e-5, 0, 0]))[0]).astype(np.float32)[None]
    for Rb, alpha in ((R2, 0.3), (near, 0.5)):  # slerp, and lerp below 1e-4 rad
        Rb = np.broadcast_to(Rb, R1.shape).copy()
        got = se3.interpolate_poses(T(R1), T(t1), T(Rb), T(t2), alpha)
        want = jse3.interpolate_poses(*map(jnp.asarray, (R1, t1, Rb, t2)), alpha)
        for g, w in zip(got, want):
            _close(g, w)


def test_random_rotations_equal_jax_on_the_same_draws():
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (64, 3)))
    got = se3.rotations_from_uniforms(torch.from_numpy(u.copy()))
    _close(got, jse3.random_rotations(key, 64))
    R = se3.random_rotations(torch.Generator().manual_seed(0), 32)
    _close(R @ R.transpose(-1, -2), np.broadcast_to(np.eye(3), (32, 3, 3)))
    _close(torch.linalg.det(R), np.ones(32))


def test_view_sampler_equals_jax():
    for n in (1, 12, 42, 300):
        np.testing.assert_array_equal(view_sampler.icosphere_views(n, 2.0),
                                      jvs.icosphere_views(n, 2.0))
        np.testing.assert_array_equal(view_sampler.fibonacci_sphere_views(n),
                                      jvs.fibonacci_sphere_views(n))
    for mode in ("icosphere", "fibonacci"):
        for g, w in zip(view_sampler.sample_views(50, 0.7, mode), jvs.sample_views(50, 0.7, mode)):
            np.testing.assert_array_equal(g["R"], w["R"])
            np.testing.assert_array_equal(g["t"], w["t"])
    for pt in ([0, 0, 3.0], [0, 0, -2.0], [1.0, 2.0, 0.5]):  # up parallel to the view too
        for g, w in zip(view_sampler.view_to_pose(pt), jvs.view_to_pose(pt)):
            np.testing.assert_array_equal(g, w)


def test_bbox_utils_equal_jax():
    rng = np.random.RandomState(1)
    a = rng.uniform(-20, 700, (7, 4))
    b = rng.uniform(-20, 700, (5, 4))
    for name, args in (("clip_xyxy_to_im", (a, 480, 640)), ("xyxy_to_xywh", (a,)),
                       ("xywh_to_xyxy", (a,)), ("iou_xyxy", (a, b)),
                       ("bbox_center", (a,)), ("bbox_center", (a, "xywh"))):
        np.testing.assert_array_equal(getattr(bbox_utils, name)(*args), getattr(jbbox, name)(*args))
    for g, w in zip(bbox_utils.boxes_area(a), jbbox.boxes_area(a)):
        np.testing.assert_array_equal(g, w)
    for pkg in (bbox_utils, jbbox):
        with pytest.raises(ValueError, match="unknown bbox fmt"):
            pkg.bbox_center(a, "cxcywh")


def _masks(rng):
    h, w = 37, 53
    m = np.zeros((h, w), np.uint8)
    m[5:20, 8:30] = 1
    m[25:, 40:] = 1
    yield m
    yield (rng.rand(h, w) > 0.6).astype(np.uint8)
    yield np.ones((h, w), np.uint8)
    yield np.zeros((h, w), np.uint8)


def test_mask_rle_and_geometry_equal_jax():
    rng = np.random.RandomState(2)
    for m in _masks(rng):
        for compressed in (True, False):
            got = mask_utils.binary_mask_to_rle(m, compressed)
            want = jmask.binary_mask_to_rle(m, compressed)
            assert got == want
            np.testing.assert_array_equal(mask_utils.rle2mask(got), m)
            np.testing.assert_array_equal(mask_utils.cocosegm2mask(got, *m.shape),
                                          jmask.cocosegm2mask(want, *m.shape))
        string = jmask.binary_mask_to_rle(m)["counts"]
        assert mask_utils.rle_encode_string(mask_utils._counts_from_mask(m)) == string
        for form in (string, string.encode()):
            assert mask_utils.rle_decode_string(form) == jmask.rle_decode_string(form)
        for name in ("mask2bbox_xyxy", "mask2bbox_xywh"):
            np.testing.assert_array_equal(getattr(mask_utils, name)(m), getattr(jmask, name)(m))
        for bw, ch in ((1, 3), (2, 1)):
            np.testing.assert_array_equal(mask_utils.get_edge(m, bw, ch), jmask.get_edge(m, bw, ch))
        for th in (3, 10):
            np.testing.assert_array_equal(mask_utils.mask_dilate(m, th), jmask.mask_dilate(m, th))


def _polygons(rng, h, w):
    """1-3 random integer polygons of 1-11 vertices inside an h x w image,
    as float COCO coordinates (rounded by the polygon path)."""
    return [list((np.stack([rng.randint(0, w, n), rng.randint(0, h, n)], 1)
                  + rng.uniform(-0.4, 0.4, (n, 2))).clip(0, [w - 1, h - 1]).ravel())
            for n in rng.randint(1, 12, rng.randint(1, 4))]


def test_fill_poly_equals_cv2():
    """Random polygons (self-intersecting, several in one call, degenerate
    ones of 1 or 2 vertices), a self-touching bow tie, a polygon with a
    collinear run and a spike, every vertex inside the image."""
    rng = np.random.RandomState(3)
    for _ in range(300):
        h, w = rng.randint(2, 70, 2)
        polys = _polygons(rng, h, w)
        want = jmask._polygons_to_mask(polys, h, w)
        np.testing.assert_array_equal(mask_utils._polygons_to_mask(polys, h, w), want)
        rle = mask_utils.segm_to_rle(polys, h, w)
        assert rle == jmask.segm_to_rle(polys, h, w)
    fixed = [[[2, 2], [20, 20], [20, 2], [2, 20]],             # bow tie
             [[3, 3], [10, 3], [17, 3], [17, 12], [10, 20], [10, 12], [3, 12]],  # run, spike
             [[0, 0], [29, 0], [29, 24], [0, 24]],             # the whole image
             [[5, 5], [15, 5], [10, 15]], [[10, 15], [20, 15], [15, 5]]]  # sharing a vertex
    for polys in (fixed[:1], fixed[1:2], fixed[2:3], fixed[3:]):
        pts = [np.asarray(p, np.int32) for p in polys]
        want = cv2.fillPoly(np.zeros((25, 30), np.uint8), pts, 7)
        np.testing.assert_array_equal(cv_ops.fill_poly(np.zeros((25, 30), np.uint8), pts, 7), want)
    with pytest.raises(NotImplementedError, match="outside"):
        cv_ops.fill_poly(np.zeros((25, 30), np.uint8), [np.array([[0, 0], [30, 5], [3, 9]])], 1)


@pytest.mark.parametrize("ksize", [1, 3, 4, 10, (5, 2)])
def test_dilate_erode_equal_cv2(ksize):
    rng = np.random.RandomState(4)
    kw, kh = (ksize, ksize) if np.isscalar(ksize) else ksize
    kernel = np.ones((kh, kw), np.uint8)
    for img in (rng.randint(0, 256, (31, 45)).astype(np.uint8), next(_masks(rng)),
                rng.randint(0, 256, (20, 17, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(cv_ops.dilate(img, ksize), cv2.dilate(img, kernel))
        np.testing.assert_array_equal(cv_ops.erode(img, ksize), cv2.erode(img, kernel))


def test_dataset_params_equal_jax(tmp_path):
    root = str(tmp_path)
    for name in jdp._SUPPORTED:
        d = os.path.join(root, jdp._DIR_ALIAS.get(name, name))
        os.makedirs(d, exist_ok=True)
        sensor = jdp._CAM_SENSOR_DEFAULT.get(name)
        cam = {"width": 640, "height": 480, "fx": 572.4, "fy": 573.6, "cx": 325.3, "cy": 242.0}
        if name != "lm":
            cam["depth_scale"] = 0.1
        with open(os.path.join(d, f"camera_{sensor}.json" if sensor else "camera.json"), "w") as f:
            json.dump(cam, f)
    os.makedirs(os.path.join(root, "lm", "test", "000002"))
    os.makedirs(os.path.join(root, "lm", "test", "000007"))
    for name in jdp._SUPPORTED:
        got, want = dataset_params.get_camera_params(root, name), jdp.get_camera_params(root, name)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert dataset_params.get_model_params(root, name) == jdp.get_model_params(root, name)
        for split in ("train", "val", "test"):
            for split_type in (None, "pbr"):
                try:
                    want = jdp.get_split_params(root, name, split, split_type)
                except (KeyError, ValueError) as e:
                    with pytest.raises(type(e)):
                        dataset_params.get_split_params(root, name, split, split_type)
                    continue
                assert dataset_params.get_split_params(root, name, split, split_type) == want
    dp = dataset_params.get_split_params(root, "lm", "test")
    assert dataset_params.get_present_scene_ids(dp) == jdp.get_present_scene_ids(dp) == [2, 7]
    for pkg in (dataset_params, jdp):
        with pytest.raises(ValueError, match="unknown BOP dataset"):
            pkg.get_camera_params(root, "coco")
    assert load_cam_params(os.path.join(root, "lm", "camera.json")).keys() == {"im_size", "K"}
