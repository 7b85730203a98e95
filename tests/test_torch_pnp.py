"""The port's decode and device PnP against the JAX package on the CPU.

- engine/decode.py against gdrnet_tpu/engine/decode.py for every mask loss
  type, both CE_DECODE_TYPEs and both xyz modes: the CE argmax and the CE
  mask exactly, the BCE mask within two ulps (XLA's f32 exp is not
  torch's), the L1 min-max mask within 1e-6.
- ops/device_pnp.py's functions against gdrnet_tpu/ops/device_pnp.py's
  (vmapped over the batch): reprojection errors within 1e-3 px, Kabsch
  within 1e-5, the beta approximations and Gauss-Newton within 1e-4
  relative, EPnP on clean data, LM and RANSAC (with JAX's own minimal sets)
  within 0.05 degrees and 5e-4 m: the JAX package's clean-data floor
  (tests/test_device_pnp.py:51-52). On 1 px noise the three beta cases of
  EPnP nearly tie and f32 rounding picks among them, so there the port's
  rotation error is held to JAX's by tests/test_device_pnp.py:56-74's rule
  (at most 1.5x + 0.05 degrees).
- pnp_from_maps_batch in each mode against JAX's, with JAX's minimal sets,
  at clean 16x16 maps, n_hyp=16, B=4 (one compile a mode, module-scoped): the
  refined rows within 0.05 degrees and 5e-4 m; the rows that keep the net
  pose (padding, fewer than 4 points, the 1 m net fallback) equal to it
  within 1e-6, in both packages.
- engine/pnp_refine.refine_bucket_poses on the device path against JAX's on
  one bucket (the two draw different hypotheses, so each is held to the
  truth and to the other within the floor).

Rotation differences are measured as the angle of Ra^T Rb through atan2 of
its skew part, which resolves angles far below arccos's f32 floor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.data.synthetic import synthetic_decoded_maps as jax_synthetic_decoded_maps
from gdrnet_tpu.engine import decode as jdecode
from gdrnet_tpu.engine import pnp_refine as jpnp_refine
from gdrnet_tpu.ops import device_pnp as J

from gdrnet_tpu_torch.config import base_config
from gdrnet_tpu_torch.data.synthetic import synthetic_decoded_maps
from gdrnet_tpu_torch.engine import decode, pnp_refine
from gdrnet_tpu_torch.ops import device_pnp as P

DEG, METRE = 0.05, 5e-4  # the clean-data floor of tests/test_device_pnp.py:51-52
KEEP_ATOL = 1e-6
K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]], np.float32)


def rot_deg(Ra, Rb) -> np.ndarray:
    """Angle in degrees of Ra^T Rb, [..., 3, 3] each."""
    M = np.swapaxes(np.asarray(Ra, np.float64), -1, -2) @ np.asarray(Rb, np.float64)
    v = np.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                  M[..., 1, 0] - M[..., 0, 1]], -1) / 2
    return np.degrees(np.arctan2(np.linalg.norm(v, axis=-1),
                                 (np.trace(M, axis1=-2, axis2=-1) - 1) / 2))


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def axis_angle(rng, deg: float) -> np.ndarray:
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    th = np.radians(deg)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def scenes(rng, B: int, n: int = 300, noise: float = 0.0, outlier_frac: float = 0.0):
    """B point sets seen by K: (R [B,3,3], t [B,3], p3 [B,n,3], uv [B,n,2]),
    the last outlier_frac of each set's pixels replaced by uniform ones."""
    Rs, ts, p3s, uvs = [], [], [], []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.randn(3, 3))
        R = Q * np.sign(np.linalg.det(Q))
        t = np.array([0.05, -0.03, 0.9]) + rng.randn(3) * 0.05
        p3 = (rng.rand(n, 3) - 0.5) * 0.2
        uv = (p3 @ R.T + t) @ K.T.astype(np.float64)
        uv = uv[:, :2] / uv[:, 2:3] + rng.randn(n, 2) * noise
        k = int(n * outlier_frac)
        if k:
            uv[n - k:] = rng.rand(k, 2) * [640, 480]
        Rs.append(R)
        ts.append(t)
        p3s.append(p3)
        uvs.append(uv)
    f32 = lambda xs: np.stack(xs).astype(np.float32)  # noqa: E731
    return f32(Rs), f32(ts), f32(p3s), f32(uvs)


def jax_minimal_sets(key, w: np.ndarray, n_hyp: int, S: int = 6) -> np.ndarray:
    """The minimal sets JAX's pnp_from_maps_batch draws for weights w [B, N]
    (gdrnet_tpu/ops/device_pnp.py:245-246, 304)."""
    keys = jax.random.split(key, len(w))
    return np.stack([np.asarray(jax.lax.top_k(
        jax.random.gumbel(keys[i], (n_hyp, w.shape[1])) + jnp.log(jnp.asarray(w[i]) + 1e-30),
        S)[1]) for i in range(len(w))])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_type", ["L1", "BCE", "CE"])
@pytest.mark.parametrize("xyz_mode", ["L1", "CE-center", "CE-reference"])
def test_decode_equals_jax(mask_type, xyz_mode):
    rng = np.random.RandomState(7)
    B, H, W, nbin = 3, 8, 8, 16
    ch = 1 if xyz_mode == "L1" else nbin + 1
    coors = [rng.randn(B, H, W, ch).astype(np.float32) for _ in range(3)]
    if ch > 1:  # a background argmax at some pixels
        coors[0][:, :2, :, -1] += 10.0
    mask = rng.randn(B, H, W, 2 if mask_type == "CE" else 1).astype(np.float32)
    dtype = "reference" if xyz_mode == "CE-reference" else "center"
    got = decode.get_out_coor(*map(T, coors), nbin, decode_type=dtype).numpy()
    want = np.asarray(jdecode.get_out_coor(*map(jnp.asarray, coors), nbin, decode_type=dtype))
    assert got.shape == want.shape == (B, H, W, 3)
    np.testing.assert_array_equal(got, want)
    got_m = decode.get_out_mask(T(mask), mask_type).numpy()
    want_m = np.asarray(jdecode.get_out_mask(jnp.asarray(mask), mask_type))
    if mask_type == "L1":
        np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-6)
    elif mask_type == "BCE":  # XLA's f32 exp is not torch's: 0.4 % of sigmoids differ
        np.testing.assert_array_max_ulp(got_m, want_m, maxulp=2)
    else:
        np.testing.assert_array_equal(got_m, want_m)
    with pytest.raises(ValueError, match="decode type"):
        decode.get_out_coor(*map(T, coors), nbin, decode_type="bilinear")


def test_synthetic_decoded_maps_equal_jax_package():
    got = synthetic_decoded_maps(np.random.RandomState(3), 2, h=8, w=8, noise_px=0.5,
                                 t_jitter=0.02)
    want = jax_synthetic_decoded_maps(np.random.RandomState(3), 2, h=8, w=8, noise_px=0.5,
                                      t_jitter=0.02)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------


def test_reprojection_errors_and_kabsch_equal_jax():
    rng = np.random.RandomState(0)
    R, t, p3, uv = scenes(rng, 3, n=50, noise=2.0)
    t[2] = -t[2]  # the third set lies behind the camera
    got = P.reprojection_errors(T(R), T(t), T(p3), T(uv), T(np.stack([K] * 3))).numpy()
    want = np.asarray(jax.vmap(J.reprojection_errors, (0, 0, 0, 0, None))(R, t, p3, uv, K))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert got[2].min() >= 1e6 and got[:2].max() < 20
    w = (rng.rand(3, 50) > 0.3).astype(np.float32)
    dst = p3 @ np.swapaxes(R, 1, 2) + t[:, None]
    Rk, tk = P._kabsch(T(p3), T(dst), T(w))
    Rj, tj = jax.vmap(J._kabsch)(p3, dst, w)
    np.testing.assert_allclose(Rk.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(Rk.numpy(), R, atol=1e-5)


def test_betas_and_gauss_newton_equal_jax():
    rng = np.random.RandomState(1)
    LL = rng.randn(4, 6, 10).astype(np.float32)
    rho = rng.rand(4, 6).astype(np.float32) + 0.1
    got = P._betas_approx(T(LL), T(rho)).numpy()
    want = np.asarray(jax.vmap(J._betas_approx)(LL, rho))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    dv = rng.randn(4, 4, 6, 3).astype(np.float32)
    b0 = rng.randn(4, 4).astype(np.float32)
    rho2 = ((np.einsum("bk,bkpi->bpi", rng.randn(4, 4), dv) ** 2).sum(-1)).astype(np.float32)
    got = P._gauss_newton_betas(T(b0), T(dv), T(rho2)).numpy()
    want = np.asarray(jax.vmap(J._gauss_newton_betas)(b0, dv, rho2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_weighted_epnp_equals_jax(noise):
    rng = np.random.RandomState(2)
    R, t, p3, uv = scenes(rng, 4, noise=noise)
    w = np.ones(p3.shape[:2], np.float32)
    Rp, tp, err = P.weighted_epnp(T(p3), T(uv), T(K), T(w))
    Rj, tj, errj = jax.jit(jax.vmap(J.weighted_epnp, (0, 0, None, 0)))(p3, uv, K, w)
    if noise == 0.0:
        np.testing.assert_allclose(err.numpy(), np.asarray(errj), rtol=0, atol=1e-3)
        assert rot_deg(Rp.numpy(), np.asarray(Rj)).max() < DEG
        assert np.abs(tp.numpy() - np.asarray(tj)).max() < METRE
        assert rot_deg(Rp.numpy(), R).max() < DEG and float(err.max()) < 0.05
    else:
        assert (rot_deg(Rp.numpy(), R) <= 1.5 * rot_deg(np.asarray(Rj), R) + DEG).all()
        assert (np.linalg.norm(tp.numpy() - t, axis=1) < 0.01).all()


def test_weighted_epnp_padding_invariance():
    """Zero-weight rows do not change the solution: the fixed-shape
    contract of the bucket (tests/test_device_pnp.py::test_padding_invariance)."""
    rng = np.random.RandomState(3)
    R, t, p3, uv = scenes(rng, 1, n=200, noise=0.5)
    w = np.ones((1, 200), np.float32)
    Rd, td, _ = P.weighted_epnp(T(p3), T(uv), T(K), T(w))
    pad3 = np.concatenate([p3, rng.rand(1, 100, 3).astype(np.float32) * 9], 1)
    pad2 = np.concatenate([uv, rng.rand(1, 100, 2).astype(np.float32) * 9], 1)
    wp = np.concatenate([w, np.zeros((1, 100), np.float32)], 1)
    Rp, tp, _ = P.weighted_epnp(T(pad3), T(pad2), T(K), T(wp))
    np.testing.assert_allclose(Rp.numpy(), Rd.numpy(), atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), td.numpy(), atol=2e-5)


def test_refine_pose_lm_equals_jax():
    rng = np.random.RandomState(4)
    R, t, p3, uv = scenes(rng, 3, noise=0.5)
    R0 = np.stack([axis_angle(rng, 8.0) @ r for r in R]).astype(np.float32)
    t0 = (t + [0.03, -0.02, 0.05]).astype(np.float32)
    w = np.ones(p3.shape[:2], np.float32)
    Rp, tp = P.refine_pose_lm(T(R0), T(t0), T(p3), T(uv), T(K), T(w))
    Rj, tj = jax.vmap(J.refine_pose_lm, (0, 0, 0, 0, None, 0))(R0, t0, p3, uv, K, w)
    assert rot_deg(Rp.numpy(), np.asarray(Rj)).max() < DEG
    assert np.abs(tp.numpy() - np.asarray(tj)).max() < METRE
    assert (rot_deg(Rp.numpy(), R) < rot_deg(R0, R) / 10).all()


def test_ransac_epnp_with_jax_minimal_sets_equals_jax():
    """30 % gross outliers: with JAX's own minimal sets the port picks the
    same consensus and lands within the floor of JAX's pose."""
    rng = np.random.RandomState(5)
    R, t, p3, uv = scenes(rng, 3, noise=0.5, outlier_frac=0.3)
    w = np.ones(p3.shape[:2], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jax_ransac = jax.jit(J.ransac_epnp, static_argnames=("n_hyp",))
    idx = np.stack([np.asarray(jax.lax.top_k(
        jax.random.gumbel(keys[i], (32, 300)) + jnp.log(jnp.asarray(w[i]) + 1e-30), 6)[1])
        for i in range(3)])
    Rp, tp, ok, w_in = P.ransac_epnp(T(p3), T(uv), T(np.stack([K] * 3)), T(w),
                                     sample_idx=T(idx))
    for i in range(3):
        Rj, tj, okj, w_inj = jax_ransac(keys[i], p3[i], uv[i], K, w[i], n_hyp=32)
        assert bool(ok[i]) and bool(okj)
        assert rot_deg(Rp[i].numpy(), np.asarray(Rj)) < DEG
        assert np.abs(tp[i].numpy() - np.asarray(tj)).max() < METRE
        assert rot_deg(Rp[i].numpy(), R[i]) < 1.0
        np.testing.assert_array_equal(w_in[i].numpy() > 0, np.asarray(w_inj) > 0)
        assert int((w_in[i, -90:] > 0).sum()) < 5  # the outliers are left out


def test_draw_samples_and_chunks(monkeypatch):
    """Minimal sets hold distinct valid points while enough exist; a seeded
    generator repeats its draws; row chunks give the unchunked result."""
    w = torch.zeros(3, 40)
    w[0, :30] = 1
    w[1, :5] = 1
    w[2] = 1
    idx = P.draw_samples(w, 16, 6, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 16, 6)
    assert torch.equal(idx, P.draw_samples(w, 16, 6, torch.Generator().manual_seed(0)))
    for h in idx[0]:
        assert len(set(h.tolist())) == 6 and max(h.tolist()) < 30
    assert all(set(range(5)) <= set(h.tolist()) for h in idx[1])  # every valid point
    rng = np.random.RandomState(6)
    _, _, p3, uv = scenes(rng, 3, n=40, noise=0.5)
    Ks = T(np.stack([K] * 3))
    whole = P.ransac_epnp(T(p3), T(uv), Ks, w, sample_idx=idx)
    monkeypatch.setattr(P, "_RANSAC_CHUNK", 16 * 40)  # one row a chunk
    chunked = P.ransac_epnp(T(p3), T(uv), Ks, w, sample_idx=idx)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# pnp_from_maps_batch: every mode against JAX's, with JAX's minimal sets
# ---------------------------------------------------------------------------

MAPS_B, MAPS_HW, MAPS_HYP = 4, 16, 16


@pytest.fixture(scope="module")
def maps_case():
    """Row 0 a plain ROI with its net pose ~8 degrees and 3 cm off; row 1 an
    empty mask (fewer than 4 points); row 2 a net translation 2 m away (the
    1 m fallback of the net modes); row 3 padding (not valid)."""
    rng = np.random.RandomState(9)
    mask, xyzn, c2d, R, t, K_, ext, (W, H) = synthetic_decoded_maps(
        rng, MAPS_B, h=MAPS_HW, w=MAPS_HW, t_jitter=0.02)
    mask[1] = 0.0
    Rn = np.stack([axis_angle(rng, 8.0) @ r for r in R]).astype(np.float32)
    tn = (t + [0.02, -0.01, 0.02]).astype(np.float32)
    tn[2] = t[2] + [0.0, 0.0, 2.0]
    inputs = dict(mask_prob=mask, xyz_norm=xyzn, coord2d=c2d,
                  im_wh=np.tile([[W, H]], (MAPS_B, 1)).astype(np.float32),
                  extents=np.tile(ext, (MAPS_B, 1)), Ks=np.tile(K_, (MAPS_B, 1, 1)),
                  rot_net=Rn, trans_net=tn, roi_valid=np.array([True, True, True, False]))
    xyz = (xyzn - 0.5) * ext
    w = ((mask > 0.5) & np.all(np.abs(xyz) > 1e-4 * ext, -1)).reshape(MAPS_B, -1)
    key = jax.random.PRNGKey(1)
    idx = jax_minimal_sets(key, w.astype(np.float32), MAPS_HYP)
    runs = {}
    for mode in P.MODES:
        Rj, tj = J.pnp_from_maps_batch(key, **inputs, mode=mode, n_hyp=MAPS_HYP)
        Rp, tp = P.pnp_from_maps_batch(**{k: T(v) for k, v in inputs.items()}, mode=mode,
                                       n_hyp=MAPS_HYP, sample_idx=T(idx))
        runs[mode] = (np.asarray(Rj), np.asarray(tj), Rp.numpy(), tp.numpy())
    return inputs, R, t, runs


@pytest.mark.parametrize("mode", P.MODES)
def test_pnp_from_maps_batch_equals_jax(maps_case, mode):
    inputs, R, t, runs = maps_case
    Rj, tj, Rp, tp = runs[mode]
    Rn, tn = inputs["rot_net"], inputs["trans_net"]
    refined = [0] if mode != "ransac_pnp" else [0, 2]
    for j in refined:
        assert rot_deg(Rp[j], Rj[j]) < DEG and np.abs(tp[j] - tj[j]).max() < METRE
        assert rot_deg(Rp[j], R[j]) < 1.0 and np.linalg.norm(tp[j] - t[j]) < 0.01
    for j in (1, 3):  # fewer than 4 points, padding: the net pose
        for got in ((Rp[j], Rn[j]), (Rj[j], Rn[j]), (tp[j], tn[j]), (tj[j], tn[j])):
            np.testing.assert_allclose(*got, rtol=0, atol=KEEP_ATOL)
        np.testing.assert_array_equal(Rp[j], Rn[j])
        np.testing.assert_array_equal(tp[j], tn[j])
    if mode != "ransac_pnp":  # the 1 m fallback keeps the net translation, refines R
        np.testing.assert_array_equal(tp[2], tn[2])
        np.testing.assert_allclose(tj[2], tn[2], rtol=0, atol=KEEP_ATOL)
        assert rot_deg(Rp[2], Rj[2]) < DEG


def test_pnp_from_maps_batch_rejects_an_unknown_mode(maps_case):
    inputs = {k: T(v) for k, v in maps_case[0].items()}
    with pytest.raises(ValueError, match="mode"):
        P.pnp_from_maps_batch(**inputs, mode="p3p")


# ---------------------------------------------------------------------------
# refine_bucket_poses, the device path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Meta:
    id2obj: dict


@dataclasses.dataclass
class BucketModels:
    """What refine_bucket_poses reads of ObjectModels."""
    meta: _Meta
    extents: dict


def bucket(seed: int, B: int = 4, hw: int = 16, valid=(True, True, True, False)):
    """One mapped bucket of decoded-map outputs in the L1 heads' form:
    (cfg, models, batch, numpy out, truth R, t)."""
    rng = np.random.RandomState(seed)
    mask, xyzn, c2d, R, t, K_, ext, (W, H) = synthetic_decoded_maps(
        rng, B, h=hw, w=hw, noise_px=0.5, t_jitter=0.02)
    cfg = base_config()
    cfg.TEST.USE_PNP = True
    batch = {"roi_coord_2d": c2d, "roi_cams": np.tile(K_, (B, 1, 1)),
             "roi_extents": np.tile(ext, (B, 1)), "valid": np.asarray(valid),
             "obj_ids": np.ones(B, np.int32), "im_hws": np.tile([[H, W]], (B, 1)).astype(np.int32)}
    out = {"mask": mask[..., None] * 4.0 - 2.0, "coor_x": xyzn[..., :1], "coor_y": xyzn[..., 1:2],
           "coor_z": xyzn[..., 2:], "rot": np.stack([axis_angle(rng, 8.0) @ r for r in R])
           .astype(np.float32), "trans": (t + [0.02, -0.01, 0.02]).astype(np.float32)}
    return cfg, BucketModels(_Meta({1: "obj"}), {"obj": ext}), batch, out, R, t


def refine_both(cfg, models, batch, out, seed: int = 0):
    """refine_bucket_poses of both packages on the same bucket."""
    dev = {k: T(batch[k]) for k in ("roi_coord_2d", "roi_cams", "roi_extents")}
    got = pnp_refine.refine_bucket_poses(cfg, models, batch, dev,
                                         {k: T(v) for k, v in out.items()}, seed=seed)
    jdev = {k: jnp.asarray(batch[k]) for k in ("roi_coord_2d", "roi_cams", "roi_extents")}
    want = jpnp_refine.refine_bucket_poses(cfg, models, batch, jdev,
                                           {k: jnp.asarray(v) for k, v in out.items()},
                                           seed=seed)
    return got, want


def test_refine_bucket_poses_device_equals_jax():
    cfg, models, batch, out, R, t = bucket(11)
    cfg.TEST.DEVICE_PNP = True
    cfg.TEST.PNP_TYPE = "ransac_pnp"
    (Rp, tp), (Rj, tj) = refine_both(cfg, models, batch, out, seed=64)
    assert Rp.dtype == np.float32 and Rp.shape == (4, 3, 3) and tp.shape == (4, 3)
    for j in range(3):
        assert rot_deg(Rp[j], Rj[j]) < DEG and np.abs(tp[j] - tj[j]).max() < METRE
        assert rot_deg(Rp[j], R[j]) < 1.0 and np.linalg.norm(tp[j] - t[j]) < 0.01
    np.testing.assert_array_equal(Rp[3], out["rot"][3])
    np.testing.assert_array_equal(tp[3], out["trans"][3])
    again = pnp_refine.refine_bucket_poses(
        cfg, models, batch, {k: T(batch[k]) for k in ("roi_coord_2d", "roi_cams", "roi_extents")},
        {k: T(v) for k, v in out.items()}, seed=64)
    np.testing.assert_array_equal(again[0], Rp)  # the bucket's seed fixes its draws


def test_degenerate_rows_keep_the_net_pose():
    """Rows of 1-3 valid points (degenerate minimal sets) and a row whose
    maps hold NaN and inf (which torch's eigh would raise on) run and keep
    the net pose bitwise; a normal row beside them is refined."""
    rng = np.random.RandomState(13)
    mask, xyzn, c2d, R, t, K_, ext, (W, H) = synthetic_decoded_maps(rng, 5, h=8, w=8)
    for j, n in ((1, 1), (2, 2), (3, 3)):
        mask[j] = 0.0
        mask[j].flat[:n] = 1.0
    xyzn[4, :4] = np.nan
    xyzn[4, 4:] = np.inf
    Rn = np.stack([axis_angle(rng, 5.0) @ r for r in R]).astype(np.float32)
    tn = (t + 0.01).astype(np.float32)
    for mode in P.MODES:
        Ro, to = P.pnp_from_maps_batch(
            T(mask), T(xyzn), T(c2d), T(np.tile([[W, H]], (5, 1)).astype(np.float32)),
            T(np.tile(ext, (5, 1))), T(np.tile(K_, (5, 1, 1))), T(Rn), T(tn),
            torch.ones(5, dtype=torch.bool), mode=mode, n_hyp=8,
            generator=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(Ro[1:].numpy(), Rn[1:])
        np.testing.assert_array_equal(to[1:].numpy(), tn[1:])
        assert rot_deg(Ro[0].numpy(), R[0]) < 0.05
