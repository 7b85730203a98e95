"""The port's losses and learning-rate schedules against the JAX package on
the CPU, in f32, from numpy inputs made from seeds.

Every losses/basic function, every point_matching_loss branch (symmetric with
K > 1 rotations included) and every gdrn_loss branch the model's outputs can
feed: values at rtol 1e-5 (atol 1e-6), and the gradients with respect to the
inputs / model outputs against jax.grad at rtol 1e-4 (atol 1e-6). The
schedules: every anneal method over a grid of steps crossing warmup, the flat
part and the anneal, at rtol 1e-5 with atol 1e-6 of the base LR (the JAX
package evaluates them in f32, the port in f64, and near the end of a cosine
f32's cos leaves about 1e-8 of the base LR).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.losses import basic as jbasic
from gdrnet_tpu.losses.gdrn_loss import gdrn_loss as jax_gdrn_loss
from gdrnet_tpu.losses.pm_loss import point_matching_loss as jax_pm_loss
from gdrnet_tpu.ops import pose as jpose
from gdrnet_tpu.ops import rotation as jrot
from gdrnet_tpu.solver import schedulers as jsched

from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.losses import basic
from gdrnet_tpu_torch.losses.gdrn_loss import gdrn_loss
from gdrnet_tpu_torch.losses.pm_loss import point_matching_loss
from gdrnet_tpu_torch.ops import pose
from gdrnet_tpu_torch.ops import rotation as rot
from gdrnet_tpu_torch.solver import schedulers

from torch_parity import small_flagship_cfg

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def rotations(rng: np.random.RandomState, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    return q.astype(np.float32)


def value_and_grads(jax_fn, torch_fn, inputs: dict, wrt: tuple):
    """Both functions on the same numpy inputs; each returns a dict or an
    array. Returns (jax values, torch values, jax grads, torch grads), the
    grads of the sum of every output times fixed weights with respect to the
    inputs named in `wrt`."""
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.tensor(v, requires_grad=k in wrt) for k, v in inputs.items()}
    jv, tv = jax_fn(**jin), torch_fn(**tin)
    as_dict = (lambda v: v) if isinstance(jv, dict) else (lambda v: {"out": v})
    jv, tv = as_dict(jv), as_dict(tv)
    w = {k: np.asarray(np.random.RandomState(5).rand(*np.shape(v)) + 0.5, np.float32)
         for k, v in jv.items()}

    def jtotal(diff):
        out = as_dict(jax_fn(**{**jin, **diff}))
        return sum(jnp.sum(out[k] * w[k]) for k in sorted(out))

    jg = jax.grad(jtotal)({k: jin[k] for k in wrt})
    sum(torch.sum(tv[k] * torch.from_numpy(w[k])) for k in sorted(tv)).backward()
    # an input the output does not depend on: no grad in torch, zeros in JAX
    tg = {k: torch.zeros_like(tin[k]) if tin[k].grad is None else tin[k].grad for k in wrt}
    return ({k: np.asarray(v) for k, v in jv.items()}, {k: v.detach().numpy() for k, v in tv.items()},
            {k: np.asarray(v) for k, v in jg.items()}, {k: v.numpy() for k, v in tg.items()})


def assert_match(jv, tv, jg, tg):
    assert set(jv) == set(tv)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], **VAL, err_msg=k)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **GRAD, err_msg=f"grad {k}")


# ---------------------------------------------------------------------------
# losses/basic.py and the rotation / point ops under it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name,kw", [("l1_loss", {}), ("mse_loss", {}), ("l2_loss", {}),
                                     ("smooth_l1_loss", {"beta": 1.0}),
                                     ("smooth_l1_loss", {"beta": 0.05}),
                                     ("smooth_l1_loss", {"beta": 0.0})])
def test_basic_losses_match_jax(name, kw, reduction):
    rng = np.random.RandomState(0)
    inputs = {"pred": rng.randn(4, 10, 3).astype(np.float32) * 0.5,
              "target": rng.randn(4, 10, 3).astype(np.float32) * 0.5}
    jfn, tfn = getattr(jbasic, name), getattr(basic, name)
    assert_match(*value_and_grads(lambda **a: jfn(**a, **kw, reduction=reduction),
                                  lambda **a: tfn(**a, **kw, reduction=reduction),
                                  inputs, ("pred", "target")))


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_cross_entropy_heatmap_loss_matches_jax(reduction):
    rng = np.random.RandomState(1)
    inputs = {"logits": rng.randn(2, 5, 6, 7).astype(np.float32) * 2,
              "target": rng.randint(0, 7, (2, 5, 6)).astype(np.int32)}
    assert_match(*value_and_grads(
        lambda **a: jbasic.cross_entropy_heatmap_loss(**a, reduction=reduction),
        lambda **a: basic.cross_entropy_heatmap_loss(**a, reduction=reduction),
        inputs, ("logits",)))


@pytest.mark.parametrize("kind", ["mat", "quat", "rot_l2"])
def test_rotation_losses_match_jax(kind):
    rng = np.random.RandomState(2)
    if kind == "quat":
        q = rng.randn(2, 6, 4).astype(np.float32)
        a, b = q / np.linalg.norm(q, axis=-1, keepdims=True)
    else:
        a, b = rotations(rng, 6), rotations(rng, 6)
    inputs = {"pred": a, "target": b}
    if kind == "rot_l2":
        jfn = lambda pred, target: jbasic.rot_l2_loss(pred, target)  # noqa: E731
        tfn = lambda pred, target: basic.rot_l2_loss(pred, target)  # noqa: E731
    else:
        jfn, tfn = jbasic.angular_distance_loss, basic.angular_distance_loss
    assert_match(*value_and_grads(jfn, tfn, inputs, ("pred",)))


def test_get_loss_func():
    for name in ("L1", "mse", "L2", "smooth_l1"):
        assert basic.get_loss_func(name).__name__ == jbasic.get_loss_func(name).__name__
    with pytest.raises(ValueError):
        basic.get_loss_func("huber")


def test_rotation_distances_and_transform_pts_match_jax():
    rng = np.random.RandomState(3)
    r1, r2 = rotations(rng, 5), rotations(rng, 5)
    q = rng.randn(2, 5, 4).astype(np.float32)
    pts, t = rng.randn(5, 9, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(rot.angular_distance_mat(T(r1), T(r2)).numpy(),
                               np.asarray(jrot.angular_distance_mat(r1, r2)), **VAL)
    np.testing.assert_allclose(rot.angular_distance_quat(T(q[0]), T(q[1])).numpy(),
                               np.asarray(jrot.angular_distance_quat(q[0], q[1])), **VAL)
    for tt in (None, t):
        got = pose.transform_pts(T(pts), T(r1), None if tt is None else T(tt)).numpy()
        np.testing.assert_allclose(got, np.asarray(jpose.transform_pts(pts, r1, tt)), **VAL)


# ---------------------------------------------------------------------------
# losses/pm_loss.py
# ---------------------------------------------------------------------------


def sym_sets(rng: np.random.RandomState, b: int) -> tuple[np.ndarray, np.ndarray]:
    """[b, 4, 3, 3] identity-padded symmetry sets: half the batch with three
    rotations about z (90, 180, 270 degrees), the rest identity-only."""
    sym = np.tile(np.eye(3, dtype=np.float32), (b, 4, 1, 1))
    mask = np.zeros((b, 4), bool)
    mask[:, 0] = True
    for k, ang in enumerate((np.pi / 2, np.pi, 3 * np.pi / 2), start=1):
        c, s = np.cos(ang), np.sin(ang)
        sym[: b // 2, k] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        mask[: b // 2, k] = True
    return sym, mask


PM_BRANCHES = [
    dict(r_only=True),
    dict(r_only=True, norm_by_extent=True, symmetric=True),  # the flagship's
    dict(r_only=True, loss_type="L2", symmetric=True),
    dict(r_only=True, loss_type="MSE"),
    dict(r_only=True, loss_type="SMOOTH_L1", beta=0.05, norm_by_extent=True),
    dict(disentangle_t=True),
    dict(disentangle_t=True, t_loss_use_points=True, symmetric=True),
    dict(disentangle_z=True),
    dict(disentangle_z=True, t_loss_use_points=True, norm_by_extent=True),
    dict(),  # fully entangled
    dict(loss_weight=2.5, symmetric=True, quat_gt=True),
]


@pytest.mark.parametrize("kw", PM_BRANCHES, ids=[str(i) for i in range(len(PM_BRANCHES))])
def test_point_matching_loss_matches_jax(kw):
    kw = dict(kw)
    rng = np.random.RandomState(4)
    b = 6
    gt = rotations(rng, b)
    if kw.pop("quat_gt", False):
        q = rng.randn(b, 4).astype(np.float32)
        gt = q / np.linalg.norm(q, axis=1, keepdims=True)
    sym, mask = sym_sets(rng, b)
    inputs = {"pred_rots": rotations(rng, b), "gt_rots": gt,
              "points": (rng.rand(b, 50, 3).astype(np.float32) - 0.5) * 0.1,
              "pred_transes": rng.randn(b, 3).astype(np.float32) * 0.1 + [0, 0, 1],
              "gt_transes": rng.randn(b, 3).astype(np.float32) * 0.1 + [0, 0, 1],
              "extents": rng.uniform(0.05, 0.15, (b, 3)).astype(np.float32),
              "sym_rots": sym, "sym_mask": mask}
    inputs = {k: np.asarray(v, np.float32) if k != "sym_mask" else v for k, v in inputs.items()}
    got = value_and_grads(lambda **a: jax_pm_loss(**a, **kw),
                          lambda **a: point_matching_loss(**a, **kw),
                          inputs, ("pred_rots", "pred_transes"))
    assert_match(*got)
    if kw.get("symmetric"):  # the closest symmetric GT is found and differs from the raw GT
        plain = jax_pm_loss(**{k: jnp.asarray(v) for k, v in inputs.items()},
                            **{**kw, "symmetric": False})
        assert float(plain["loss_PM_R" if "loss_PM_R" in plain else "loss_PM_RT"]) > \
            float(got[0]["loss_PM_R" if "loss_PM_R" in got[0] else "loss_PM_RT"])


# ---------------------------------------------------------------------------
# losses/gdrn_loss.py
# ---------------------------------------------------------------------------


def loss_case(changes: dict):
    cfg = small_flagship_cfg()
    for path, value in changes.items():
        cfg.set_path(path, value)
    return cfg


GDRN_BRANCHES = {
    "flagship": {},
    "xyz_ce_coor": {"MODEL.CDPN.ROT_HEAD.XYZ_LOSS_TYPE": "CE_coor"},
    "mask_bce": {"MODEL.CDPN.ROT_HEAD.MASK_LOSS_TYPE": "BCE"},
    "mask_ce_gt_obj": {"MODEL.CDPN.ROT_HEAD.MASK_LOSS_TYPE": "CE",
                       "MODEL.CDPN.ROT_HEAD.MASK_LOSS_GT": "gt",
                       "MODEL.CDPN.ROT_HEAD.XYZ_LOSS_MASK_GT": "obj"},
    "rot_angular": {"MODEL.CDPN.PNP_NET.ROT_LW": 1.0},
    "rot_l2": {"MODEL.CDPN.PNP_NET.ROT_LW": 0.5, "MODEL.CDPN.PNP_NET.ROT_LOSS_TYPE": "L2"},
    "trans_disentangled": {"MODEL.CDPN.PNP_NET.TRANS_LW": 1.0},
    "trans_lpnp_l2": {"MODEL.CDPN.PNP_NET.TRANS_LW": 2.0,
                      "MODEL.CDPN.PNP_NET.TRANS_LOSS_DISENTANGLE": False,
                      "MODEL.CDPN.PNP_NET.TRANS_LOSS_TYPE": "L2"},
    "bind": {"MODEL.CDPN.PNP_NET.BIND_LW": 1.0},
    "z_abs_mse": {"MODEL.CDPN.PNP_NET.Z_TYPE": "ABS", "MODEL.CDPN.PNP_NET.Z_LOSS_TYPE": "MSE",
                  "MODEL.CDPN.PNP_NET.CENTROID_LOSS_TYPE": "L2"},
    "pm_entangled_z": {"MODEL.CDPN.PNP_NET.PM_R_ONLY": False,
                       "MODEL.CDPN.PNP_NET.PM_DISENTANGLE_Z": True},
    "head_frozen": {"MODEL.CDPN.ROT_HEAD.FREEZE": True, "MODEL.CDPN.PNP_NET.PM_LW": 0.0},
}


def random_outputs(cfg, batch: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    rh = cfg.MODEL.CDPN.ROT_HEAD
    b, h, w = batch["gt_mask_visib"].shape
    nbin = rh.XYZ_BIN + 1 if rh.XYZ_LOSS_TYPE == "CE_coor" else 1
    out = {"mask": rng.randn(b, h, w, 2 if rh.MASK_LOSS_TYPE == "CE" else 1),
           "region": rng.randn(b, h, w, rh.NUM_REGIONS + 1) * 2,
           "rot": rotations(rng, b), "trans": batch["gt_trans"] + rng.randn(b, 3) * 0.05,
           "pred_t_": batch["gt_trans_ratio"] + rng.randn(b, 3) * 0.1}
    for c in ("coor_x", "coor_y", "coor_z"):
        out[c] = rng.rand(b, h, w, nbin) if nbin == 1 else rng.randn(b, h, w, nbin)
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def roi_batch():
    batch = synthetic_roi_batch(batch_size=4, input_res=32, out_res=16, num_classes=10,
                                num_points=64, num_regions=8, seed=9)
    batch["sym_rots"], batch["sym_mask"] = sym_sets(np.random.RandomState(8), 4)
    return batch


@pytest.mark.parametrize("case", list(GDRN_BRANCHES))
def test_gdrn_loss_matches_jax(case, roi_batch):
    cfg = loss_case(GDRN_BRANCHES[case])
    out = random_outputs(cfg, roi_batch, seed=10)
    jb = {k: jnp.asarray(v) for k, v in roi_batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in roi_batch.items()}
    got = value_and_grads(lambda **o: jax_gdrn_loss(cfg, o, jb), lambda **o: gdrn_loss(cfg, o, tb),
                          out, tuple(out))
    assert_match(*got)
    names = set(got[0])
    assert ("loss_coor_x" in names) != cfg.MODEL.CDPN.ROT_HEAD.FREEZE
    if case == "flagship":
        assert names == {"loss_coor_x", "loss_coor_y", "loss_coor_z", "loss_mask", "loss_region",
                         "loss_PM_R", "loss_centroid", "loss_z"}


# ---------------------------------------------------------------------------
# solver/schedulers.py
# ---------------------------------------------------------------------------

SCHED = dict(rtol=1e-5, atol=2e-10)  # atol 1e-6 of the 2e-4 / 1e-3 base LRs below, at most
STEPS = [0, 1, 37, 99, 100, 101, 300, 719, 720, 721, 800, 888, 889, 950, 999, 1000, 1100]


@pytest.mark.parametrize("method", ["cosine", "linear", "poly", "exp", "step", "none"])
@pytest.mark.parametrize("warmup", [(100, "linear"), (100, "constant"), (0, "linear")])
def test_flat_and_anneal_matches_jax(method, warmup):
    kw = dict(warmup_iters=warmup[0], warmup_method=warmup[1], warmup_factor=0.01,
              anneal_point=0.72, anneal_method=method, target_lr_factor=0.05, poly_power=0.9,
              step_gamma=0.3, steps=(0.5, 0.8))
    got = schedulers.flat_and_anneal_schedule(2e-4, 1000, **kw)
    want = jsched.flat_and_anneal_schedule(2e-4, 1000, **kw)
    for s in STEPS:
        assert isinstance(got(s), float)
        np.testing.assert_allclose(got(s), float(want(s)), **SCHED, err_msg=str(s))


def test_warmup_multistep_and_cosine_match_jax():
    pairs = [(schedulers.warmup_multistep_schedule(1e-3, [500, 800], gamma=0.2, warmup_iters=100),
              jsched.warmup_multistep_schedule(1e-3, [500, 800], gamma=0.2, warmup_iters=100)),
             (schedulers.warmup_cosine_schedule(1e-3, 1000, warmup_iters=100),
              jsched.warmup_cosine_schedule(1e-3, 1000, warmup_iters=100))]
    for got, want in pairs:
        for s in STEPS:
            np.testing.assert_allclose(got(s), float(want(s)), **SCHED, err_msg=str(s))


@pytest.mark.parametrize("name,accum,extra", [
    ("flat_and_anneal", 1, {}),
    ("flat_and_anneal", 4, {"TARTGET_LR_FACTOR": 0.1}),  # the reference's spelling
    ("flat_and_anneal", 1, {"WARMUP_ITERS": 0, "ANNEAL_METHOD": "step"}),
    ("WarmupMultiStepLR", 2, {}),
    ("WarmupCosineLR", 3, {"WARMUP_ITERS": 0}),
])
def test_build_lr_schedule_matches_jax(name, accum, extra):
    cfg = small_flagship_cfg()  # the JAX function reads the same config
    cfg.SOLVER.LR_SCHEDULER_NAME = name
    for k, v in extra.items():
        cfg.SOLVER[k] = v
    got = schedulers.build_lr_schedule(cfg, 2e-4, 1000, steps_per_update=accum)
    want = jsched.build_lr_schedule(cfg, 2e-4, 1000, steps_per_update=accum)
    for s in STEPS:
        np.testing.assert_allclose(got(s), float(want(s)), **SCHED, err_msg=str(s))
    cfg.SOLVER.LR_SCHEDULER_NAME = "poly"
    with pytest.raises(ValueError):
        schedulers.build_lr_schedule(cfg, 2e-4, 1000)
