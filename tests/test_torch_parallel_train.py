"""The port's data-parallel train step against the JAX package's on a
2-device mesh (the conftest's virtual CPU devices) and against the port in
one process: the small flagship (tests/torch_parity.py), Ranger at lr 1e-2
without warmup, 2 steps at a global batch of 4 from one set of seeded
weights (carried into the port by utils/jax_convert). The port's ranks are
2 gloo processes on the CPU (tests/torch_ddp_worker.py), each on its 2 rows
of every batch, its BatchNorms over the global batch.

It also settles what the JAX program computes for BatchNorm on a sharded
batch: its loss terms, gradients and running statistics at the first step
equal the port's global BN (one process, and 2 ranks with SyncBatchNorm2d),
running_var with n the global batch's B*H*W.

Tolerances, tests/test_torch_train.py's: at the first step every loss term
at rtol 1e-4 (atol 1e-6); the gradients and the update of every parameter
and BN buffer within 0.15 relative L2 a tensor and the gradients within
0.08 over all of them; at the second step, from states a rounding apart,
total_loss within 10 %. The ranks against the port in one process: every
term at rtol 1e-4 at the first step, the BN buffers equal on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gdrnet_tpu.engine.steps import make_train_step as jax_make_train_step
from gdrnet_tpu.engine.train_state import GDRNTrainState
from gdrnet_tpu.parallel.mesh import make_mesh, replicated_sharding
from gdrnet_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from gdrnet_tpu.solver import build_optimizer as jax_build_optimizer

from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine.steps import _model_kwargs
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.tools.dryrun_multichip import train_steps
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch
from test_torch_train import record_grads, rel_l2, small_model_variables
from torch_ddp_worker import start_ranks
from torch_parity import small_flagship_cfg

STEPS, GLOBAL_B = 2, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = small_flagship_cfg()
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-2, weight_decay=0)
    cfg.SOLVER.WARMUP_ITERS = 0
    batches = [synthetic_roi_batch(batch_size=GLOBAL_B, input_res=64, out_res=16,
                                   num_classes=10, num_points=64, num_regions=8, seed=70 + i)
               for i in range(STEPS)]
    jm, (params, stats) = small_model_variables(cfg, batches[0], seed=13)
    sd = jax_to_torch(params, stats)
    kw = dict(keep_steps=True, lr_schedule=(1e-2, 100), jax_deconv_gc=True, device="cpu")
    ranks = start_ranks(tmp_path_factory.mktemp("ddp_train"), [  # beside the JAX step
        ("train", dict(cfg=cfg.to_dict(), state_dict=sd, batches=batches, **kw))])

    # the JAX package's step over a 2-device data mesh
    mesh = make_mesh(2)
    jopt = optax.chain(record_grads(), jax_build_optimizer(
        cfg, lr_schedule=jax_build_lr_schedule(cfg, 1e-2, 100)))
    jstate = jax.device_put(
        GDRNTrainState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=stats,
                       opt_state=jopt.init(params)), replicated_sharding(mesh))
    jstep = jax_make_train_step(cfg, jm, jopt, mesh=mesh)
    data = NamedSharding(mesh, P("data"))
    spine, jax_metrics = [jax.tree.map(np.array, (params, stats))], []
    for i, batch in enumerate(batches):
        jstate, m = jstep(jstate, {k: jax.device_put(v, data) for k, v in batch.items()},
                          jax.random.PRNGKey(i))
        jax_metrics.append({k: float(v) for k, v in m.items()})
        spine.append(jax.tree.map(np.array, (jstate.params, jstate.batch_stats,
                                             jstate.opt_state[0])))

    one = train_steps(cfg, sd, batches, **kw)
    n_per_bn = {}  # the global batch's B*H*W at each BN
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(lambda mod, args, name=name: n_per_bn.__setitem__(
                name, args[0].shape[0] * args[0].shape[2] * args[0].shape[3]))
    b0 = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        model.train()(b0["roi_img"], **_model_kwargs(b0))
    return {"cfg": cfg, "sd": sd, "spine": spine, "jax": jax_metrics, "one": one,
            "batch0": batches[0],
            "ranks": [r[0] for r in ranks.result()], "n_per_bn": n_per_bn}


def test_ddp_losses_match_jax_mesh_and_one_process(runs):
    want, one, ranks = runs["jax"], runs["one"]["metrics"], runs["ranks"]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]  # every rank logs the global terms
    got = ranks[0]["metrics"]
    assert set(got[0]) == set(want[0]) == set(one[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[0][k], one[0][k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got[1]["total_loss"], want[1]["total_loss"], rtol=0.1)
    assert all(m["nonfinite_skip"] == 0 for m in got)


def test_jax_mesh_bn_is_not_per_replica(runs):
    """The counter-check: BN over each device's 2 rows alone (the port in
    one process on each half) gives another loss_mask (a plain mean over
    the pixels, so the halves' mean is what per-replica BN would log) than
    the JAX mesh step, which the global BN matches at 1e-4 above."""
    halves = [train_steps(runs["cfg"], runs["sd"], [{k: v[i:i + 2] for k, v in
                                                     runs["batch0"].items()}],
                          device="cpu")
              for i in (0, 2)]
    per_replica = np.mean([h["metrics"][0]["loss_mask"] for h in halves])
    want = runs["jax"][0]["loss_mask"]
    print(f"loss_mask: JAX mesh {want:.6f}, per-replica BN {per_replica:.6f}")
    assert abs(per_replica - want) > 1e-2 * abs(want)


def test_ddp_gradients_match_jax_mesh(runs):
    want = jax_to_torch(runs["spine"][1][2])  # record_grads' state: the step's gradients
    names = list(want)
    flat = runs["ranks"][0]["grads"][0]
    got, start = {}, 0
    for k, p in build_model(runs["cfg"], device="cpu").named_parameters():  # train_steps' order
        got[k] = flat[start:start + p.numel()].view_as(p)
        start += p.numel()
    assert start == flat.numel() and set(got) == set(names)
    for k in names:
        assert rel_l2(got[k], want[k]) < 0.15, k
    total = rel_l2(torch.cat([got[k].flatten() for k in names]),
                   torch.cat([want[k].flatten() for k in names]))
    print(f"DDP gradients against the JAX mesh's: {total:.3e} relative L2 over all")
    assert total < 0.08


def test_ddp_update_and_global_bn_stats_match_jax_mesh(runs):
    """The first step's change of every parameter and BN buffer against the
    JAX mesh step's; running_var as 0.9 r + n/(n-1) (JAX's - 0.9 r) with n
    the global batch's B*H*W: the JAX program's BN statistics are the
    global batch's, and so are the ranks'."""
    p1, s1, _ = runs["spine"][1]
    want = jax_to_torch(p1, s1)
    before, after = runs["sd"], runs["ranks"][0]["states"][0]
    errs = {}
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        b = before[k]
        if k.endswith("running_var"):
            n = runs["n_per_bn"][k[: -len(".running_var")]]
            w = 0.9 * b + n / (n - 1) * (w - 0.9 * b)
        errs[k] = rel_l2(after[k] - b, w - b)
    print(f"update against the JAX mesh's: worst {max(errs.values()):.3e} at "
          f"{max(errs, key=errs.get)}")
    assert max(errs.values()) < 0.15
    stats = [k for k in errs if k.endswith(("running_mean", "running_var"))]
    assert stats and max(errs[k] for k in stats) < 1e-3  # the forward's statistics, no flip
    a, b = (r["buffers"] for r in runs["ranks"])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
