"""Batched EPnP + RANSAC + Levenberg-Marquardt pose refinement on the device
(counterpart of gdrnet_tpu/ops/device_pnp.py).

The reference's PnP post-processing runs cv2.solvePnP / solvePnPRansac once
per ROI on the host (core/gdrn_modeling/gdrn_evaluator.py:187-435,
lib/pysixd/misc.py pnp_v2 :145-196). Here a whole ROI bucket solves in one
batch of tensor operations on the bucket's device, batched over ROIs and
RANSAC hypotheses by broadcasting (no per-ROI loop):

  * weighted EPnP (Lepetit et al.): PCA control points, barycentric lift,
    the null space of the 12x12 normal matrix by eigh, betas from the three
    cv2-style approximations + Gauss-Newton on the control-point distance
    residuals, absolute orientation by weighted Kabsch;
  * fixed-iteration RANSAC with Gumbel-top-k minimal sets (fixed shapes:
    the correspondence set is all H*W pixels with a weight each, so masked
    pixels never enter a hypothesis or an inlier count);
  * Levenberg-Marquardt on the reprojection error (the cv2 ITERATIVE
    equivalent) for the net-initialised modes.

Every product is a broadcast multiply-and-sum in f32, so it runs in full
f32 whatever the TF32 switches say (the port's form of JAX's
precision="highest"). Where the port differs from the JAX program:

  * RANSAC draws its Gumbel noise from a torch.Generator on the tensors'
    device, not from jax.random; `sample_idx` [B, n_hyp, S] takes a given
    set of minimal sets instead (the parity tests pass JAX's own);
  * least squares is an SVD pseudo-inverse solve with jnp.linalg.lstsq's
    cut-off (torch.linalg.lstsq on CUDA assumes full rank);
  * the barycentric coordinates are V^T (p - c0) / sqrt(lambda) and the
    normal matrix is built from four 4x4 moment sums (its Kronecker form):
    the same arithmetic as the JAX program's solve and [N, 12] products, in
    another order;
  * non-finite map values never become correspondences and are zeroed
    (torch's eigh raises on a NaN where the JAX program returns NaN poses);
  * RANSAC runs over row chunks of the bucket so that its [rows, n_hyp, N]
    error tensors stay below _RANSAC_CHUNK elements.
"""

from __future__ import annotations

import torch

from gdrnet_tpu_torch.ops.rotation import mm3, so3_exp

MODES = ("ransac_pnp", "net_iter_pnp", "net_ransac_pnp")
# the 6 unordered control-point pairs (i < j) of the 4 EPnP control points
_PAIRS_I = (0, 0, 0, 1, 1, 2)
_PAIRS_J = (1, 2, 3, 2, 3, 3)
# quadratic terms of ||sum_k beta_k dv_k||^2 in cv2's column order
# [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]
_KK = (0, 0, 1, 0, 1, 2, 0, 1, 2, 3)
_LL = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3)
_RANSAC_CHUNK = 1 << 24  # elements of one [rows, n_hyp, N] tensor


def _outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_n a[..., n, i] b[..., n, j] -> [..., I, J] in full f32."""
    return (a[..., :, :, None] * b[..., :, None, :]).sum(-3)


def _cam_points(R: torch.Tensor, t: torch.Tensor, p3: torch.Tensor) -> list[torch.Tensor]:
    """R [..., 3, 3], t [..., 3], p3 [..., N, 3] -> the camera-frame x, y, z,
    each [..., N] (batch dims broadcast)."""
    x, y, z = p3.unbind(-1)
    return [R[..., i, 0, None] * x + R[..., i, 1, None] * y + R[..., i, 2, None] * z
            + t[..., i, None] for i in range(3)]


def _project(R, t, p3, K):
    """-> pixel u, v and depth, each [..., N]."""
    xc, yc, zc = _cam_points(R, t, p3)
    z = zc.abs().clamp_min(1e-9) * torch.where(zc == 0, torch.ones_like(zc), zc).sign()
    u = K[..., 0, 0, None] * xc / z + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * yc / z + K[..., 1, 2, None]
    return u, v, zc


def reprojection_errors(R, t, p3, p2, K) -> torch.Tensor:
    """Per-point pixel reprojection error [..., N]; points behind the camera
    get 1e6, so that they never count as inliers."""
    u, v, z = _project(R, t, p3, K)
    du, dv = u - p2[..., 0], v - p2[..., 1]
    err = (du * du + dv * dv).sqrt()
    return torch.where(z > 1e-6, err, torch.full_like(err, 1e6))


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _kabsch(src, dst, w):
    """Weighted absolute orientation: R [..., 3, 3], t [..., 3] with
    dst ~= R @ src + t, for src, dst [..., N, 3] and w [..., N]."""
    sw = w.sum(-1).clamp_min(1e-9)[..., None]
    mu_s = (w[..., None] * src).sum(-2) / sw
    mu_d = (w[..., None] * dst).sum(-2) / sw
    H = _outer_sum((src - mu_s[..., None, :]) * w[..., None], dst - mu_d[..., None, :])
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = _det3(mm3(V, Ut)).sign()
    S = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = mm3(V * S[..., None, :], Ut)
    return R, mu_d - (R * mu_s[..., None, :]).sum(-1)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares of A [..., m, n] x = b [..., m] through
    the SVD, with jnp.linalg.lstsq's cut-off eps * max(m, n) * s_max."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    keep = (S > 0) & (S >= rcond * S[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    c = s_inv * (U * b[..., :, None]).sum(-2)
    return (Vh * c[..., :, None]).sum(-2)


def _betas_approx(LL: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """The three cv2 beta initializations (epnp.cpp find_betas_approx_{1,2,3}).

    LL [..., 6, 10] are the quadratic terms b_kl = v_k . v_l of the pairwise
    control-point differences for the 4 null-space vectors, in cv2's column
    order; rho [..., 6] the squared world distances. Returns [..., 3, 4]."""
    one = torch.ones_like(rho[..., 0])
    zero = torch.zeros_like(one)
    # case 1: unknowns [b11, b12, b13, b14]
    x1 = _lstsq(LL[..., [0, 1, 3, 6]], rho)
    bc = x1[..., 0].abs().sqrt() * torch.where(x1[..., 0] < 0, -one, one)
    den = torch.where(bc == 0, one, bc)
    betas1 = torch.stack([bc] + [torch.where(x1[..., 0] != 0, x1[..., k] / den, zero)
                                 for k in (1, 2, 3)], -1)
    # case 2: unknowns [b11, b12, b22]
    x2 = _lstsq(LL[..., [0, 1, 2]], rho)
    s2 = torch.where((x2[..., 0] < 0) & (x2[..., 2] < 0), -one, one)
    b21 = (x2[..., 0] * s2).clamp_min(0.0).sqrt()
    b22 = (x2[..., 2] * s2).clamp_min(0.0).sqrt() * torch.where(x2[..., 1] < 0, -one, one)
    betas2 = torch.stack([b21, b22, zero, zero], -1)
    # case 3: unknowns [b11, b12, b22, b13, b23]
    x3 = _lstsq(LL[..., [0, 1, 2, 3, 4]], rho)
    s3 = torch.where((x3[..., 0] < 0) & (x3[..., 2] < 0), -one, one)
    b31 = (x3[..., 0] * s3).clamp_min(0.0).sqrt()
    b32 = (x3[..., 2] * s3).clamp_min(0.0).sqrt() * torch.where(x3[..., 1] < 0, -one, one)
    b33 = torch.where(b31 > 1e-12, x3[..., 3] / b31.clamp_min(1e-12), zero)
    betas3 = torch.stack([b31, b32, b33, zero], -1)
    return torch.stack([betas1, betas2, betas3], -2)


def _gauss_newton_betas(betas, dv, rho, iters: int = 8):
    """Refine betas [..., 4] so that || sum_k beta_k dv[k, pair] ||^2
    matches rho [..., 6]; dv [..., 4, 6, 3] are the null-space
    control-point pair differences."""
    eye = torch.eye(4, dtype=betas.dtype, device=betas.device)
    for _ in range(iters):
        x = (betas[..., :, None, None] * dv).sum(-3)                   # [..., 6, 3]
        e = rho - (x * x).sum(-1)                                       # [..., 6]
        J = 2.0 * (x[..., None, :, :] * dv).sum(-1).transpose(-1, -2)  # [..., 6, 4]
        JtJ = _outer_sum(J, J) + 1e-9 * eye
        step = torch.linalg.solve_ex(JtJ, (J * e[..., :, None]).sum(-2)[..., None])[0]
        betas = betas + step[..., 0]
    return betas


def weighted_epnp(p3, p2, K, w):
    """Weighted EPnP: [..., N, 3] object points, [..., N, 2] pixels,
    [..., 3, 3] K, [..., N] weights (0 = padded / ignored) -> (R [..., 3, 3],
    t [..., 3], the weighted mean reprojection error [...]). Needs >= 4
    effective points and non-degenerate (non-collinear) geometry; callers
    guard by the weight sum and the returned error."""
    p3, p2, w, K = p3.float(), p2.float(), w.float(), K.float()
    sw = w.sum(-1).clamp_min(1e-9)
    mu = (w[..., None] * p3).sum(-2) / sw[..., None]
    A = p3 - mu[..., None, :]
    cov = _outer_sum(A * w[..., None], A) / sw[..., None, None]
    lam, V = torch.linalg.eigh(cov)                                # ascending
    lam = torch.maximum(lam, (lam[..., 2:3] * 1e-8).clamp_min(1e-12))
    s = lam.sqrt()
    ctrl = torch.cat([mu[..., None, :], mu[..., None, :] + (V * s[..., None, :]).transpose(-1, -2)],
                     -2)                                            # [..., 4, 3]
    a123 = (A[..., :, :, None] * V[..., None, :, :]).sum(-2) / s[..., None, :]
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)  # [..., N, 4]

    # normal matrix: sum_n w (alpha alpha^T) kron (au au^T + av av^T), with
    # au = [fu, 0, uc - u], av = [0, fv, vc - v]
    fu, fv = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    du = K[..., 0, 2, None] - p2[..., 0]
    dvv = K[..., 1, 2, None] - p2[..., 1]
    P = (alphas * w[..., None])[..., :, :, None] * alphas[..., :, None, :]  # [..., N, 4, 4]
    S0 = P.sum(-3)
    Su = (P * du[..., None, None]).sum(-3)
    Sv = (P * dvv[..., None, None]).sum(-3)
    Sr = (P * (du * du + dvv * dvv)[..., None, None]).sum(-3)
    zero = torch.zeros_like(S0)
    blocks = torch.stack([fu * fu * S0, zero, fu * Su,
                          zero, fv * fv * S0, fv * Sv,
                          fu * Su, fv * Sv, Sr], -1).unflatten(-1, (3, 3))  # [..., c, d, i, j]
    MtM = blocks.transpose(-3, -2).flatten(-4, -3).flatten(-2, -1)       # [..., 12, 12]
    _, evec = torch.linalg.eigh(MtM)
    Vn = evec[..., :, :4].transpose(-1, -2).unflatten(-1, (4, 3))  # [..., k, ctrl, xyz]

    dv = Vn[..., _PAIRS_I, :] - Vn[..., _PAIRS_J, :]                  # [..., 4, 6, 3]
    dw = ctrl[..., _PAIRS_I, :] - ctrl[..., _PAIRS_J, :]
    rho = (dw * dw).sum(-1)                                           # [..., 6]
    dots = (dv[..., :, None, :, :] * dv[..., None, :, :, :]).sum(-1)  # [..., k, l, 6]
    scale = torch.tensor([1.0 if k == l else 2.0 for k, l in zip(_KK, _LL)],
                         dtype=dots.dtype, device=dots.device)
    LL = dots[..., _KK, _LL, :].transpose(-1, -2) * scale             # [..., 6, 10]

    # the three beta cases side by side on a new axis -3
    b = _gauss_newton_betas(_betas_approx(LL, rho), dv[..., None, :, :, :], rho[..., None, :])
    x_ctrl = (b[..., :, :, None, None] * Vn[..., None, :, :, :]).sum(-3)  # [..., 3, 4, 3]
    pc = (alphas[..., None, :, :, None] * x_ctrl[..., :, None, :, :]).sum(-2)  # [..., 3, N, 3]
    flip = torch.where((w[..., None, :] * pc[..., 2]).sum(-1) < 0, -1.0, 1.0)
    R, t = _kabsch(p3[..., None, :, :], pc * flip[..., None, None], w[..., None, :])
    err = (w[..., None, :] * reprojection_errors(
        R, t, p3[..., None, :, :], p2[..., None, :, :], K[..., None, :, :])).sum(-1) / sw[..., None]
    best = err.argmin(-1, keepdim=True)
    R = torch.take_along_dim(R, best[..., None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(t, best[..., None], dim=-2)[..., 0, :]
    return R, t, torch.take_along_dim(err, best, dim=-1)[..., 0]


def refine_pose_lm(R0, t0, p3, p2, K, w, iters: int = 10):
    """Levenberg-Marquardt on the weighted reprojection error from
    (R0 [..., 3, 3], t0 [..., 3]): the cv2.solvePnP ITERATIVE /
    useExtrinsicGuess equivalent, with the left increment
    R <- exp(skew(dw)) @ R. Returns (R, t)."""
    p3, p2, w, K = p3.float(), p2.float(), w.float(), K.float()
    R, t = R0.float(), t0.float()
    sw = w.sum(-1).clamp_min(1e-9)
    sqw = w.sqrt()
    fu, fv = K[..., 0, 0, None], K[..., 1, 1, None]
    eye = torch.eye(6, dtype=R.dtype, device=R.device)

    def cost(R, t):
        u, v, _ = _project(R, t, p3, K)
        ru, rv = (u - p2[..., 0]) * sqw, (v - p2[..., 1]) * sqw
        return (ru * ru + rv * rv).sum(-1) / sw, u, v

    lam = torch.full(w.shape[:-1], 1e-3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        c0, u, v = cost(R, t)
        xc, yc, zc = _cam_points(R, t, p3)
        zs = zc.abs().clamp_min(1e-9)
        # d(u, v)/d(camera point), then through the left increment:
        # d(pc)/d(dw) = -skew(R p) = -skew(pc - t), d(pc)/d(dt) = I
        ju = [fu / zs, torch.zeros_like(zs), -fu * xc / (zs * zs)]
        jv = [torch.zeros_like(zs), fv / zs, -fv * yc / (zs * zs)]
        x, y, z = xc - t[..., 0, None], yc - t[..., 1, None], zc - t[..., 2, None]
        Ju = torch.stack([ju[1] * -z + ju[2] * y, ju[0] * z + ju[2] * -x,
                          ju[0] * -y + ju[1] * x] + ju, -1)            # [..., N, 6]
        Jv = torch.stack([jv[1] * -z + jv[2] * y, jv[0] * z + jv[2] * -x,
                          jv[0] * -y + jv[1] * x] + jv, -1)
        ru, rv = u - p2[..., 0], v - p2[..., 1]
        JtJ = _outer_sum(Ju * w[..., None], Ju) + _outer_sum(Jv * w[..., None], Jv)
        Jtr = (w[..., None] * (Ju * ru[..., None] + Jv * rv[..., None])).sum(-2)
        dx = torch.linalg.solve_ex(JtJ + lam[..., None, None] * eye, -Jtr[..., None])[0][..., 0]
        R_new = mm3(so3_exp(dx[..., :3]), R)
        t_new = t + dx[..., 3:]
        c1, _, _ = cost(R_new, t_new)
        ok = c1 < c0
        R = torch.where(ok[..., None, None], R_new, R)
        t = torch.where(ok[..., None], t_new, t)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return R, t


def draw_samples(w: torch.Tensor, n_hyp: int, sample_size: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Gumbel-top-k minimal sets [B, n_hyp, sample_size] drawn without
    replacement from the weights w [B, N] (on w's device, from `generator`
    there): zero-weight points rank below every valid one, so they are only
    drawn when fewer than sample_size valid points exist."""
    u = torch.rand((w.shape[0], n_hyp, w.shape[1]), generator=generator, device=w.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (g + torch.log(w.float() + 1e-30)[:, None, :]).topk(sample_size, dim=-1).indices


def _ransac_rows(p3, p2, K, w, idx, reproj_thr: float, refine: bool):
    rows = torch.arange(w.shape[0], device=w.device)
    valid = w > 0
    b = rows[:, None, None]
    # the hypothesis weights zero out drawn padding, so a 4-5 point ROI still
    # solves from exactly its valid points (host parity)
    Rh, th, _ = weighted_epnp(p3[b, idx], p2[b, idx], K[:, None], (w[b, idx] > 0).float())
    err = reprojection_errors(Rh, th, p3[:, None], p2[:, None], K[:, None])  # [rows, n_hyp, N]
    inl = (err < reproj_thr) & valid[:, None]
    scores = inl.sum(-1)
    best = scores.argmax(-1)
    R_b, t_b, inl_b, score_b = Rh[rows, best], th[rows, best], inl[rows, best], scores[rows, best]
    w_in = torch.where(inl_b, w, torch.zeros_like(w))
    if refine:
        R_r, t_r, _ = weighted_epnp(p3, p2, K, w_in)
        # keep the refit only if it does not lose inliers (cv2 refines on the
        # consensus set; a degenerate refit must not poison the result)
        n_new = ((reprojection_errors(R_r, t_r, p3, p2, K) < reproj_thr) & valid).sum(-1)
        take = ((w_in > 0).sum(-1) >= 4) & (n_new >= score_b)
        R_b = torch.where(take[:, None, None], R_r, R_b)
        t_b = torch.where(take[:, None], t_r, t_b)
    return R_b, t_b, valid.sum(-1) >= 4, w_in


def ransac_epnp(p3, p2, K, w, n_hyp: int = 128, sample_size: int = 6,
                reproj_thr: float = 3.0, refine: bool = True,
                generator: torch.Generator | None = None,
                sample_idx: torch.Tensor | None = None):
    """Fixed-iteration RANSAC-EPnP over a batch: p3 [B, N, 3], p2 [B, N, 2],
    K [B, 3, 3], w [B, N] (cv2.solvePnPRansac flags=EPNP semantics,
    reprojectionError 3 px). n_hyp Gumbel-top-k minimal sets a row (or
    `sample_idx` [B, n_hyp, sample_size]), inliers counted over all points,
    the best hypothesis refit on its inliers. Returns (R, t, ok, inlier
    weights); ok is False below 4 valid points, the host path's guard
    (callers then keep the net pose, reference gdrn_evaluator.py:253-257)."""
    p3, p2, w, K = p3.float(), p2.float(), w.float(), K.float()
    if sample_idx is not None:
        n_hyp = sample_idx.shape[1]
    step = max(1, _RANSAC_CHUNK // max(1, n_hyp * w.shape[1]))
    outs = []
    for s in range(0, w.shape[0], step):
        sl = slice(s, s + step)
        idx = (draw_samples(w[sl], n_hyp, sample_size, generator) if sample_idx is None
               else sample_idx[sl].to(w.device))
        outs.append(_ransac_rows(p3[sl], p2[sl], K[sl], w[sl], idx, reproj_thr, refine))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def correspondence_weights(mask_prob, xyz_norm, coord2d, im_wh, extents, mask_thr: float = 0.5):
    """The bucket's correspondences as fixed-shape arrays: p3 [B, H*W, 3]
    (object metres), p2 [B, H*W, 2] (image pixels) and weights w [B, H*W],
    1 where the mask prob > mask_thr and |xyz| > 1e-4 * extent on every axis
    (get_img_model_points_with_coords2d, gdrn_evaluator.py:89-126) and the
    values are finite; the points of weight 0 are zeroed."""
    B, H, W, _ = xyz_norm.shape
    ext = extents.float()[:, None, None, :]
    xyz = (xyz_norm.float() - 0.5) * ext
    p2 = coord2d.float() * im_wh.float()[:, None, None, :]
    sel = ((mask_prob.float() > mask_thr) & (xyz.abs() > 1e-4 * ext).all(-1)
           & xyz.isfinite().all(-1) & p2.isfinite().all(-1))
    p3 = torch.where(sel[..., None], xyz, torch.zeros_like(xyz)).reshape(B, H * W, 3)
    p2 = torch.where(sel[..., None], p2, torch.zeros_like(p2)).reshape(B, H * W, 2)
    return p3, p2, sel.reshape(B, H * W).float()


def pnp_from_maps_batch(mask_prob, xyz_norm, coord2d, im_wh, extents, Ks, rot_net, trans_net,
                        roi_valid, mode: str = "ransac_pnp", mask_thr: float = 0.5,
                        reproj_thr: float = 3.0, n_hyp: int = 128, sample_size: int = 6,
                        refine_iters: int = 10, generator: torch.Generator | None = None,
                        sample_idx: torch.Tensor | None = None):
    """Decoded maps -> refined poses for a whole ROI bucket, on the maps'
    device.

    mask_prob [B,H,W], xyz_norm [B,H,W,3] in [0,1], coord2d [B,H,W,2] as
    full-image fractions (the test mapper's roi_coord_2d), im_wh [B,2],
    extents [B,3], Ks [B,3,3], net poses [B,3,3] / [B,3], roi_valid [B]:
    the correspondences of correspondence_weights, as weights over all H*W
    pixels (no subsampling).

    Modes (gdrn_evaluator.py): "ransac_pnp" = pure RANSAC-EPnP (:316-435);
    "net_iter_pnp" = LM refinement warm-started at the net pose (:255-296);
    "net_ransac_pnp" = RANSAC then LM polish. The |dt| > 1 m
    net-translation fallback (:293-296) applies to the net_* modes. Rows
    that are not valid or have fewer than 4 points keep the net pose as it
    was given. RANSAC draws from `generator` (on the maps' device), or takes
    `sample_idx` [B, n_hyp, sample_size]. Returns (R [B,3,3], t [B,3]) f32."""
    if mode not in MODES:
        raise ValueError(f"unknown device PnP mode: {mode}")
    p3, p2, w = correspondence_weights(mask_prob, xyz_norm, coord2d, im_wh, extents, mask_thr)
    K = Ks.float()
    R_n, t_n = rot_net.float(), trans_net.float()
    kw = dict(n_hyp=n_hyp, sample_size=sample_size, reproj_thr=reproj_thr,
              generator=generator, sample_idx=sample_idx)
    if mode == "ransac_pnp":
        R, t, ok, _ = ransac_epnp(p3, p2, K, w, **kw)
    elif mode == "net_iter_pnp":
        R, t = refine_pose_lm(R_n, t_n, p3, p2, K, w, iters=refine_iters)
        ok = (w > 0).sum(-1) >= 4
    else:
        R, t, ok, w_in = ransac_epnp(p3, p2, K, w, **kw)
        R, t = refine_pose_lm(R, t, p3, p2, K, w_in, iters=refine_iters)
    if mode != "ransac_pnp":  # net-translation fallback (te > 1 m)
        t = torch.where((torch.linalg.vector_norm(t - t_n, dim=-1) > 1.0)[:, None], t_n, t)
    use = ok & roi_valid.to(device=ok.device, dtype=torch.bool)
    return torch.where(use[:, None, None], R, R_n), torch.where(use[:, None], t, t_n)
