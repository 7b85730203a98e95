"""The port's model axis (PARALLEL.MODEL_PARALLEL) on the CPU: the partition
rule and the grid against the JAX package's, and the train step on (data,
model) grids of gloo ranks against JAX's step and against the port in one
process.

The config is JAX's own model-parallel test's (_tiny_setup of
tests/test_model_parallel.py: R18, 64x64 crops, 16x16 maps, 4 regions, 2-D
coordinates, region attention, Adam at 1e-3) in f32, from seeded weights
carried into the port by utils/jax_convert, 3 steps at a global batch of 8.
One launch of 4 ranks (tests/torch_ddp_worker.py) serves every grid case:
first a (2, 2) grid, then the ranks regroup and 2 of them run a (1, 2)
grid; it starts with the file's first test and runs beside the JAX step
and the one-process references, which the rank tests compare with at the
end.

Tolerances. This config's one process is itself sensitive to the order of
its reductions: run on the CPU at 4 threads instead of 1, its first
step's loss_PM_R moves by 1.8e-5, its gradients by 6.6e-3 relative L2
overall (BN weights over 16-32 values a channel, ReLU units near 0), and
Adam (lr 1e-3) turns that into 3.8e-4 of total_loss at the second step and
1.3e-3 at the third (up to 1.2e-2 in a single term). Hence:
- the first step against JAX's one-device step on the same weights and
  batch: every loss term at rtol 1e-4 (atol 1e-6), the gathered gradients
  within 0.15 relative L2 a tensor and 0.08 over all of them,
  tests/test_torch_train.py's bounds (JAX's own (4, 2) mesh gives its
  one-device losses: tests/test_model_parallel.py);
- the model axis alone, the (1, 2) grid against one process: every term at
  rtol 1e-5 at the first step, its gradients within 5e-3 overall and 0.05
  a tensor (the data-parallel bounds of chip_smoke.py's [ddp]); the (2, 2)
  grid, which also splits the batch, against 2 data-parallel ranks at the
  same split likewise, and against one process at the data-parallel bounds
  of tests/test_torch_parallel*.py (rtol 1e-4; the gradients at
  tests/test_torch_train.py's);
- the later Adam steps: total_loss within 1e-2 of one process's (the
  free-run family of tests/test_torch_train.py);
- one SGDP step, whose update is linear in the gradient, with a GRAD_CLIP
  that binds: each updated parameter within 1e-5 relative L2 of one
  process's;
- the replicated parameters bitwise equal on model peers; LAMB's trust
  ratios within rtol 1e-6 of one process's _trust_ratio on the same whole
  tensors;
- checkpoints bitwise: the file a grid writes is one process's (keys,
  gathered tensors), and resume works in both directions.
"""

import hashlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdrnet_tpu.config import base_config as jax_base_config
from gdrnet_tpu.engine.steps import make_train_step as jax_make_train_step
from gdrnet_tpu.engine.train_state import GDRNTrainState
from gdrnet_tpu.engine.trainer import resolve_mesh_spec
from gdrnet_tpu.parallel.mesh import make_mesh, param_partition_spec
from gdrnet_tpu.solver import build_optimizer as jax_build_optimizer
from gdrnet_tpu.utils.torch_convert import convert_torch_state_dict

from gdrnet_tpu_torch import merged_config
from gdrnet_tpu_torch.config import base_config
from gdrnet_tpu_torch.config.config import Config
from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine.checkpoint import CheckpointManager
from gdrnet_tpu_torch.engine.steps import make_train_step
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.parallel import param_partition, resolve_world
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.tools.dryrun_multichip import train_steps
from gdrnet_tpu_torch.utils.jax_convert import jax_to_torch
from test_torch_train import record_grads, rel_l2, small_model_variables
from torch_ddp_worker import start_ranks
from torch_parity import FLAGSHIP

STEPS, GLOBAL_B = 3, 8
GRIDS = {"2x2": 0, "1x2": 3}  # grid -> its scenario in the launch
SGDP, LAMB, DATA_2 = 4, 5, 6  # the (1, 2) grid's SGDP and Ralamb, 2 data-parallel ranks
CLIP = 0.1  # SGDP's GRAD_CLIP, below the first gradient's global norm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank
    yield
    torch.set_num_threads(n)


def tiny_cfg(model_parallel: int = 1, **optimizer) -> Config:
    """JAX's _tiny_setup config in f32; `optimizer` replaces Adam's."""
    cfg = base_config()
    bb = cfg.MODEL.CDPN.BACKBONE
    bb.NUM_LAYERS, bb.INPUT_RES, bb.OUTPUT_RES = 18, 64, 16
    cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 4
    cfg.MODEL.CDPN.PNP_NET.WITH_2D_COORD = cfg.MODEL.CDPN.PNP_NET.REGION_ATTENTION = True
    cfg.SOLVER.OPTIMIZER_CFG = optimizer or {"type": "Adam", "lr": 1e-3, "weight_decay": 0}
    cfg.PARALLEL.DTYPE = "float32"
    cfg.PARALLEL.MODEL_PARALLEL = model_parallel
    return cfg


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# the partition rule and the grid
# ---------------------------------------------------------------------------

PARTITION_CASES = {"small_m2": ("small", 2), "small_m4": ("small", 4),
                   "flagship_m2": ("flagship", 2)}


@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_param_partition_equals_jax(case):
    """The port's sharded weights, marked by their index along the shard dim
    and carried into JAX's layout by convert_torch_state_dict, are exactly
    the leaves param_partition_spec shards on an (8 / m, m) mesh of the
    conftest's devices, each on its last (output) dim. The flagship at m = 2:
    39 of its 148 leaves, 34,739,840 values."""
    which, m = PARTITION_CASES[case]
    cfg = tiny_cfg() if which == "small" else merged_config(FLAGSHIP)
    model = build_model(cfg, device="meta")  # shapes only
    part = param_partition(model, m)
    sd = {}
    for k, v in model.state_dict().items():
        if k in part:
            shape = [1] * v.dim()
            shape[part[k]] = -1
            marks = np.arange(1, v.shape[part[k]] + 1, dtype=np.float32).reshape(shape)
            sd[k] = np.broadcast_to(marks, tuple(v.shape))
        else:
            sd[k] = np.zeros(tuple(v.shape), np.float32)
    params, _ = convert_torch_state_dict(
        sd, head_norm=cfg.MODEL.CDPN.ROT_HEAD.NORM,
        pnp_norm=cfg.MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.get("norm", "GN"))
    mesh = make_mesh(8, model_parallel=m)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    sharded = 0
    for path, leaf in leaves:
        spec = tuple(param_partition_spec(leaf, mesh))
        assert ("model" in spec) == bool(np.any(leaf != 0)), jax.tree_util.keystr(path)
        if "model" in spec:
            assert spec[-1] == "model"
            want = np.arange(1, leaf.shape[-1] + 1, dtype=np.float32)
            assert np.array_equal(leaf, np.broadcast_to(want, leaf.shape)), \
                jax.tree_util.keystr(path)
            sharded += 1
    assert sharded == len(part) and len(leaves) == len(dict(model.named_parameters()))
    if which == "flagship":
        params = dict(model.named_parameters())
        assert (len(part), len(params)) == (39, 148)
        assert sum(params[k].numel() for k in part) == 34_739_840
        assert part["pnp_net.fc1.weight"] == 0 and part["rot_head_net.features.0.weight"] == 1
        # a rank's slices at m = 2: fc1 [512, 8192], the deconv [512, 128, 3, 3]
        assert tuple(params["pnp_net.fc1.weight"].shape) == (1024, 8192)
        assert tuple(params["rot_head_net.features.0.weight"].shape) == (512, 256, 3, 3)


RESOLVE_CASES = {  # (MESH_SHAPE, MODEL_PARALLEL, batch, ranks started)
    "cap_2x2": ((4,), 2, 8, 4),
    "cap_8_started": ((4,), 2, 8, 8),
    "grid_4x2": ((-1,), 2, 8, 8),
    "grid_1x2": ((-1,), 2, 8, 2),
    "grid_batch_3": ((-1,), 2, 3, 8),
    "mp_exceeds_world": ((-1,), 2, 8, 1),
    "mp_exceeds_cap": ((2,), 4, 8, 8),
    "dp_6": ((-1,), 1, 6, 6),
    "dp_cap_3": ((4,), 1, 6, 3),
    "zero": ((0,), 1, 8, 8),
}


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve_world_equals_jax_resolve_mesh_spec(case):
    """resolve_world gives JAX's resolve_mesh_spec counts with as many
    devices as ranks: (data, model) where they use every rank, a ValueError
    naming the count to start where they do not, and JAX's ValueError
    where JAX raises (tests/test_model_parallel.py's cases among them)."""
    mesh, mp, batch, world = RESOLVE_CASES[case]
    cfgs = [tiny_cfg(mp), jax_base_config()]
    for cfg in cfgs:
        cfg.PARALLEL.MESH_SHAPE, cfg.PARALLEL.MODEL_PARALLEL = mesh, mp
    try:
        n_total, jax_mp, _ = resolve_mesh_spec(cfgs[1], ims_per_batch=batch, n_avail=world)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            resolve_world(cfgs[0], batch, world)
        return
    if n_total == world:
        assert resolve_world(cfgs[0], batch, world) == (n_total // jax_mp, jax_mp)
    else:
        with pytest.raises(ValueError, match=f"start {n_total} processes"):
            resolve_world(cfgs[0], batch, world)


# ---------------------------------------------------------------------------
# the train step on the grids
# ---------------------------------------------------------------------------


def one_process_checkpoint(cfg, sd: dict, batch: dict, root) -> str:
    """One process's Ranger checkpoint after one step, for the grid to resume."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    opt = build_optimizer(cfg, model)
    state = create_train_state(model, opt)
    state, _ = make_train_step(cfg, model, opt)(state, batch, None)
    CheckpointManager(str(root / "one")).save(state, 1)
    return str(root / "one")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_axis")
    cfg = tiny_cfg()
    batches = [synthetic_roi_batch(batch_size=GLOBAL_B, input_res=64, out_res=16,
                                   num_points=64, num_regions=4, seed=80 + i)
               for i in range(STEPS)]
    jm, (params, stats) = small_model_variables(cfg, batches[0], seed=17)
    sd = jax_to_torch(params, stats)
    sgdp = tiny_cfg(type="SGDP", lr=0.1, momentum=0.9, weight_decay=1e-4)
    sgdp.SOLVER.GRAD_CLIP = CLIP
    lamb = tiny_cfg(type="Ralamb", lr=1e-3, weight_decay=1e-4)
    ranger = tiny_cfg(type="Ranger", lr=1e-3, weight_decay=1e-4)
    one_ckpt = one_process_checkpoint(ranger, sd, batches[0], root)

    def mp(c, m=2):
        c = Config(c.to_dict())
        c.PARALLEL.MODEL_PARALLEL = m
        return c.to_dict()

    scenarios = [
        ("model_axis", dict(cfg=mp(cfg), state_dict=sd, batches=batches)),  # (2, 2)
        ("model_axis_checkpoint", dict(cfg=mp(ranger), one_ckpt=one_ckpt,
                                       round_trip=str(root / "round_trip"),
                                       stepped=str(root / "stepped"), batch=batches[1])),
        ("regrid", dict(world=2, init_method=f"file://{root / 'rendezvous_1x2'}")),
        ("model_axis", dict(cfg=mp(cfg), state_dict=sd, batches=batches)),  # (1, 2)
        ("model_axis", dict(cfg=mp(sgdp), state_dict=sd, batches=batches[:1],
                            returns=("state",))),
        ("model_axis", dict(cfg=mp(lamb), state_dict=sd, batches=batches[:1],
                            trust_ratio=True, returns=())),
        ("model_axis", dict(cfg=mp(cfg, 1), state_dict=sd, batches=batches[:1])),
    ]
    future = start_ranks(root, scenarios, world=4)

    # beside the ranks: the port in one process, and JAX's step on one device
    one = train_steps(cfg, sd, batches, keep_steps=True, device="cpu")
    one_sgdp = train_steps(sgdp, sd, batches[:1], device="cpu")
    jopt = optax.chain(record_grads(), jax_build_optimizer(cfg))
    jstate = GDRNTrainState(step=jnp.zeros([], jnp.int32), params=params, batch_stats=stats,
                            opt_state=jopt.init(params))
    jstate, m = jax_make_train_step(cfg, jm, jopt)(
        jstate, {k: jnp.asarray(v) for k, v in batches[0].items()}, jax.random.PRNGKey(0))
    jax_metrics = {k: float(v) for k, v in m.items()}
    jax_grads = jax_to_torch(jax.tree.map(np.array, jstate.opt_state[0]))
    ranks = future.result()
    return {"cfg": cfg, "sd": sd, "batches": batches, "one": one, "jax": jax_metrics,
            "jax_grads": jax_grads, "one_sgdp": one_sgdp, "ranger": ranger,
            "one_ckpt": one_ckpt, "root": root, "ranks": ranks}


def grid_ranks(runs, grid: str) -> list:
    """The ranks' results of the grid's scenario (the ranks that ran it)."""
    return [r[GRIDS[grid]] for r in runs["ranks"] if r[GRIDS[grid]] is not None]


def named_grads(cfg, flat: torch.Tensor) -> dict:
    """A flat gradient (model.parameters() order) by parameter name."""
    out, start = {}, 0
    for k, p in build_model(cfg, device="meta").named_parameters():
        out[k] = flat[start:start + p.numel()].view(p.shape)
        start += p.numel()
    assert start == flat.numel()
    return out


def assert_terms(got: dict, want: dict, rtol: float, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=f"{k}, {what}")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_model_axis_losses_match_jax_and_one_process(runs, grid):
    ranks = grid_ranks(runs, grid)
    d, m = {"2x2": (2, 2), "1x2": (1, 2)}[grid]
    assert len(ranks) == d * m
    assert [r["model_axis"] for r in ranks] == [(i % m, m) for i in range(d * m)]
    assert [r["data"] for r in ranks] == [(i // m, d) for i in range(d * m)]
    got = ranks[0]["metrics"]
    assert all(r["metrics"] == got for r in ranks)  # every rank logs the global terms
    one = runs["one"]["metrics"]
    assert len(got) == STEPS and all(s["nonfinite_skip"] == 0 for s in got)
    for k in runs["jax"]:
        np.testing.assert_allclose(got[0][k], runs["jax"][k], rtol=1e-4, atol=1e-6, err_msg=k)
    if grid == "1x2":
        assert_terms(got[0], one[0], 1e-5, "step 0 against one process")
    else:
        assert_terms(got[0], one[0], 1e-4, "step 0 against one process")
        data = runs["ranks"][0][DATA_2]
        assert data["model_axis"] == (0, 1) and data["data"] == (0, 2)
        assert_terms(got[0], data["metrics"][0], 1e-5, "step 0 against 2 data ranks")
    for i in range(1, STEPS):
        np.testing.assert_allclose(got[i]["total_loss"], one[i]["total_loss"], rtol=1e-2)
        print(f"{grid} step {i}: total_loss {abs(got[i]['total_loss'] / one[i]['total_loss'] - 1):.3e} "
              "from one process's")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_model_axis_gradients_match_jax_and_one_process(runs, grid):
    """The first step's gradients, gathered whole on rank 0."""
    got = named_grads(runs["cfg"], grid_ranks(runs, grid)[0]["grads"][0])
    one = named_grads(runs["cfg"], runs["one"]["grads"][0])
    refs = [("JAX", runs["jax_grads"], 0.15, 0.08)]
    if grid == "1x2":
        refs.append(("one process", one, 0.05, 5e-3))
    else:
        refs += [("one process", one, 0.15, 0.08), ("2 data ranks", named_grads(
            runs["cfg"], runs["ranks"][0][DATA_2]["grads"][0]), 0.05, 5e-3)]
    names = sorted(got)

    def flat(d):
        return torch.cat([d[k].flatten() for k in names])

    for what, ref, per_tensor, overall in refs:
        assert set(ref) == set(got), what
        worst = max(names, key=lambda k: rel_l2(got[k], ref[k]))
        print(f"{grid} against {what}: {rel_l2(flat(got), flat(ref)):.3e} overall, worst "
              f"{rel_l2(got[worst], ref[worst]):.3e} at {worst}")
        assert rel_l2(got[worst], ref[worst]) < per_tensor, what
        assert rel_l2(flat(got), flat(ref)) < overall, what


@pytest.mark.parametrize("grid", list(GRIDS))
def test_replicated_parameters_equal_on_model_peers(runs, grid):
    """After the last step every model peer holds the same replicated
    parameters, bit for bit, and its slice of each sharded weight: 1/m of
    the output dim (dim 1 of the ConvTranspose2d)."""
    ranks = grid_ranks(runs, grid)
    m = ranks[0]["model_axis"][1]
    for i in range(0, len(ranks), m):
        peers = ranks[i:i + m]
        assert len({r["replicated"] for r in peers}) == 1, [r["replicated"] for r in peers]
    full = {k: tuple(v.shape) for k, v in runs["sd"].items()}
    part = param_partition(build_model(runs["cfg"], device="meta"), m)
    for r in ranks:
        assert set(r["local_shapes"]) == set(part)
        for k, dim in part.items():
            want = list(full[k])
            want[dim] //= m
            assert r["local_shapes"][k] == tuple(want), k
    assert ranks[0]["local_shapes"]["pnp_net.fc1.weight"][0] * m == full["pnp_net.fc1.weight"][0]
    assert part["rot_head_net.features.0.weight"] == 1
    assert ranks[0]["replicated"][0] == len(runs["sd"]) - len(part) - sum(
        k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in runs["sd"])


def test_sgdp_with_a_binding_clip_matches_one_process(runs):
    """One SGDP step (momentum, weight decay, the projection) under a
    GRAD_CLIP below the gradient's global norm on the (1, 2) grid: the
    global clip norm and _project's norms, dot product and sizes run over
    whole tensors, so each updated parameter is one process's within 1e-5
    relative L2 (SGDP's update is linear in the gradient: no noise is
    amplified)."""
    assert float(runs["one"]["grads"][0].norm()) > 2 * CLIP  # the clip binds
    got, want = runs["ranks"][0][SGDP]["state"], runs["one_sgdp"]["state"]
    assert_terms(runs["ranks"][0][SGDP]["metrics"][0], runs["one_sgdp"]["metrics"][0], 1e-5,
                 "SGDP's step")
    assert set(got) == set(want)
    moved = 0
    for k, w in want.items():
        if w.is_floating_point():
            assert rel_l2(got[k], w) < 1e-5, k
            moved += not torch.equal(w, runs["sd"][k])
    assert moved > 0


def test_lamb_trust_ratios_match_one_process(runs):
    """Ralamb's per-tensor trust ratios on the (1, 2) grid (its norms of a
    sharded tensor summed over the model group) against one process's
    _trust_ratio on the same whole tensors, on both ranks."""
    for r in runs["ranks"][:2]:
        got, want = r[LAMB]["trust"]
        assert len(got) == len(want) == len(runs["sd"]) - sum(
            k.endswith(("running_mean", "running_var", "num_batches_tracked"))
            for k in runs["sd"])
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert len(set(got)) > 1


def _load(path: str) -> dict:
    step = CheckpointManager(path).latest_step()
    return torch.load(CheckpointManager(path).path(step), weights_only=True)


def _slices_match(ckpt: dict, digests: dict, rank: dict) -> None:
    """Each of a rank's digests is that of its slice of the checkpoint's
    whole tensor (the whole tensor where it is replicated)."""
    r, m = rank["model_axis"]
    opt_dims = {f"{i}.": d for i, d in rank["opt_shard_dims"].items()}
    for k, h in digests["model"].items():
        t, dim = ckpt["model"][k], rank["shard_dims"].get(k)
        assert digest(t if dim is None else t.chunk(m, dim)[r]) == h, k
    for key, h in digests["optimizer"].items():
        i, name = key.split(".", 1)
        t, dim = ckpt["optimizer"]["state"][int(i)][name], opt_dims.get(f"{i}.")
        assert digest(t if dim is None or t.dim() == 0 else t.chunk(m, dim)[r]) == h, key


def test_grid_resumes_one_process_checkpoint_and_writes_it_back(runs):
    """One process's checkpoint resumed onto the (2, 2) grid: every rank's
    model and optimizer slices are those of the file, bit for bit, and so
    are a sharded model's that load_weights (MODEL.WEIGHTS) fills; saved
    again from the grid, the file is the one process wrote (the same keys,
    order and tensors)."""
    one, back = _load(runs["one_ckpt"]), _load(str(runs["root"] / "round_trip"))
    ranks = [r[1] for r in runs["ranks"]]
    assert all(r["iteration"] == 1 for r in ranks)
    for r in ranks:
        _slices_match(one, r["resumed"], r)
        assert r["resumed"]["weights"] == r["resumed"]["model"]  # MODEL.WEIGHTS's slices
    assert list(back["model"]) == list(one["model"]) and back["iteration"] == one["iteration"]
    assert all(torch.equal(back["model"][k], v) for k, v in one["model"].items())
    so, sb = one["optimizer"], back["optimizer"]
    assert so["param_groups"] == sb["param_groups"] and so["state"].keys() == sb["state"].keys()
    for i, st in so["state"].items():
        assert st.keys() == sb["state"][i].keys()
        assert all(torch.equal(v, sb["state"][i][n]) for n, v in st.items()), i


def test_grid_checkpoint_loads_in_one_process(runs):
    """After a step on the (2, 2) grid, the checkpoint rank 0 writes holds
    every rank's slices gathered (bit for bit), with one process's keys and
    shapes, and resumes in one process to exactly its tensors."""
    stepped = _load(str(runs["root"] / "stepped"))
    one = _load(runs["one_ckpt"])
    for r in [r[1] for r in runs["ranks"]]:
        _slices_match(stepped, r["stepped"], r)
    assert [(k, v.shape) for k, v in stepped["model"].items()] == [
        (k, v.shape) for k, v in one["model"].items()]
    model = build_model(runs["ranger"], device="cpu")
    opt = build_optimizer(runs["ranger"], model)
    state, it = CheckpointManager(str(runs["root"] / "stepped")).resume_or_load(
        create_train_state(model, opt))
    assert it == 2
    assert all(torch.equal(v, stepped["model"][k]) for k, v in model.state_dict().items())
    got = opt.state_dict()["state"]
    for i, st in stepped["optimizer"]["state"].items():
        assert all(torch.equal(got[i][n], v) for n, v in st.items()), i
    assert np.isfinite(runs["ranks"][0][1]["total_loss"])


def test_dryrun_multichip_four_processes_takes_a_model_axis_step(capsys):
    """The dry run's CLI at 4 ranks: the data-parallel step against one
    process, then its third leg, one step on a (2, 2) grid: a finite
    model_parallel_loss with pnp_net.fc1 sharded on every rank."""
    from gdrnet_tpu_torch.tools import dryrun_multichip

    assert dryrun_multichip.main(["--nproc", "4", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1].split(" ", 1)[1])
    assert res["ok"] and res["model_parallel_grid"] == [2, 2]
    assert res["fc1_sharded_on_every_rank"] and np.isfinite(res["model_parallel_loss"])
    np.testing.assert_allclose(res["model_parallel_loss"], res["total_loss"][0], rtol=1e-4)
