"""The port's export_model and strip_ckpt on the CPU, against the
repository's tools/export_model.py and its checkpoints.

export_model at tests/test_tools.py:326-392's size (ResNet-18, 32x32 crops,
8x8 maps, 4 regions, batch 4) with 32 head filters and a PnP featdim of 32
(smaller artifacts), in f32, over seeded weights that keep the activations
O(1) (tests/torch_parity.randomize) and that both tools read from one
reference-layout .pth (the JAX tool through torch_convert):
- the exported program (f32, BN folded, int8) run through
  torch.export.load(path).module() equals the in-process forward it was
  traced from, bit for bit (the same aten ops in the same order on the
  CPU), and in a child process that imports only torch;
- that forward matches the JAX tool's deserialized artifact within
  tests/test_torch_model.py's tolerances (one f32 forward in two libraries):
  translations rtol 1e-4 / atol 1e-5, rotations rtol 1e-4 / atol 1e-4, the
  file's bound for R (measured 7.1e-5 on a rotation entry); the metadata
  json has the JAX tool's keys.
strip_ckpt: the slim file holds exactly model and iteration, its
state_dict is bitwise the source's, and load_weights (which predict and
engine.train --eval-only call) reads the slim directory and the slim file.
"""

import importlib.util
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jex

from gdrnet_tpu.models.gdrn import build_model as jax_build_model

from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.engine import checkpoint
from gdrnet_tpu_torch.engine.steps import make_train_step
from gdrnet_tpu_torch.engine.train_state import create_train_state
from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
from gdrnet_tpu_torch.solver.optimizers import build_optimizer
from gdrnet_tpu_torch.solver.schedulers import build_lr_schedule
from gdrnet_tpu_torch.tools import export_model, strip_ckpt
from gdrnet_tpu_torch.utils.fold_bn import fold_batch_norms
from torch_parity import REPO, init_shapes, load_port, randomize

EXPORT_CFG = ("MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=32, OUTPUT_RES=8), "
              "ROT_HEAD=dict(NUM_REGIONS=4, NUM_FILTERS=32), "
              "PNP_NET=dict(PNP_HEAD_CFG=dict(featdim=32))))\nPARALLEL = dict(DTYPE='float32')\n")
# tests/test_torch_model.py: outputs rtol 1e-4 / atol 1e-5 of their O(1) scale, and R
# (a normalized cross product of the rot6d columns) atol 1e-4
RTOL, ATOL, ROT_ATOL = 1e-4, 1e-5, 1e-4
BATCH = 4
VARIANTS = {"f32": [], "folded": ["--fold-bn"], "int8": ["--int8"]}
# the load side, in a process that imports nothing but torch and numpy
CHILD = """
import sys, numpy as np, torch
torch.set_num_threads(1)  # as this file's tests run: the CPU's reductions split by thread
fwd = torch.export.load(sys.argv[1]).module()
args = np.load(sys.argv[2])
with torch.no_grad():
    rot, trans = fwd(*[torch.from_numpy(args[f"a{i}"]) for i in range(8)])
assert "gdrnet_tpu_torch" not in sys.modules and "gdrnet_tpu" not in sys.modules
np.savez(sys.argv[3], rot=rot.numpy(), trans=trans.numpy())
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    cfg_path = str(root / "export_cfg.py")
    with open(cfg_path, "w") as f:
        f.write(EXPORT_CFG)
    cfg = export_model.export_config(cfg_path)
    batch = export_model.export_batch(cfg, BATCH, "cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params, stats = randomize(init_shapes(jax_build_model(cfg), jb["roi_img"],
                                          **{k: jb[k] for k in export_model.ARG_NAMES[1:]}),
                              seed=3)
    model = load_port(build_model(cfg, device="cpu"), params, stats)
    pth = str(root / "weights.pth")
    torch.save({"model": model.state_dict()}, pth)
    return {"root": root, "cfg_path": cfg_path, "cfg": cfg, "model": model, "pth": pth,
            "batch": batch, "args": tuple(batch[k] for k in export_model.ARG_NAMES)}


@pytest.fixture(scope="module")
def exported(setup):
    """Each variant exported by the tool's CLI, and its in-process forward."""
    out = {}
    for name, extra in VARIANTS.items():
        path = str(setup["root"] / f"{name}.pt2")
        meta = export_model.main(["--out", path, "--ckpt", setup["pth"], "--config",
                                  setup["cfg_path"], "--batch", str(BATCH), "--device", "cpu"]
                                 + extra)
        model = fold_batch_norms(setup["model"]) if name == "folded" else setup["model"]
        fwd = export_model.serving_forward(model, setup["batch"], int8=name == "int8")
        with torch.no_grad():
            want = fwd(*setup["args"])
        out[name] = (path, meta, want)
    return out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_exported_forward_equals_the_in_process_forward(exported, setup, name):
    path, meta, (rot, trans) = exported[name]
    with torch.no_grad():
        got_rot, got_trans = torch.export.load(path).module()(*setup["args"])
    assert torch.equal(got_rot, rot) and torch.equal(got_trans, trans)
    assert got_rot.shape == (BATCH, 3, 3) and got_trans.shape == (BATCH, 3)
    assert torch.isfinite(got_rot).all() and torch.isfinite(got_trans).all()
    assert meta["int8"] == (name == "int8") and meta["platforms"] == ["cpu"]
    assert meta["shapes"]["roi_img"] == [BATCH, 32, 32, 3]


def test_artifacts_load_with_torch_only(exported, setup, tmp_path):
    """All three artifacts run in one child process that imports only torch;
    its outputs equal the in-process forwards bit for bit."""
    args = str(tmp_path / "args.npz")
    np.savez(args, **{f"a{i}": a.numpy() for i, a in enumerate(setup["args"])})
    script = "\n".join(f"sys.argv = ['', {exported[n][0]!r}, {args!r}, "
                       f"{str(tmp_path / (n + '.npz'))!r}]\n{CHILD}" for n in VARIANTS)
    proc = subprocess.run([sys.executable, "-c", "import sys\n" + script],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    for name in VARIANTS:
        got = np.load(tmp_path / f"{name}.npz")
        rot, trans = exported[name][2]
        assert np.array_equal(got["rot"], rot.numpy()) and np.array_equal(
            got["trans"], trans.numpy())


def test_export_matches_the_jax_tools_artifact(exported, setup, tmp_path):
    spec = importlib.util.spec_from_file_location("jax_export_model",
                                                  REPO / "tools/export_model.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    out = str(tmp_path / "model.jaxexp")
    jax_tool.main(["--out", out, "--ckpt", setup["pth"], "--config", setup["cfg_path"],
                   "--batch", str(BATCH), "--platforms", "cpu"])
    jmeta = json.load(open(out + ".json"))
    path, meta, (rot, trans) = exported["f32"]
    assert set(meta) == set(jmeta)
    assert meta["arg_names"] == jmeta["arg_names"] and meta["shapes"] == jmeta["shapes"]
    assert meta["outputs"] == jmeta["outputs"] and meta["int8"] == jmeta["int8"]
    exp = jex.deserialize(open(out, "rb").read())
    want_rot, want_trans = exp.call(*[jnp.asarray(a.numpy()) for a in setup["args"]])
    np.testing.assert_allclose(rot.numpy(), np.asarray(want_rot), rtol=RTOL, atol=ROT_ATOL)
    np.testing.assert_allclose(trans.numpy(), np.asarray(want_trans), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# strip_ckpt
# ---------------------------------------------------------------------------


def test_strip_ckpt_keeps_the_model_and_the_iteration(setup, tmp_path, capsys):
    cfg = setup["cfg"]
    model = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(4))
    opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-4, 100))
    state = create_train_state(model, opt)
    batch = synthetic_roi_batch(batch_size=2, input_res=32, out_res=8, num_regions=4)
    make_train_step(cfg, model, opt)(state, batch, None)  # an optimizer state to drop
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    for it in (3, 7):
        src = mgr.save(state, it)
    slim_dir = tmp_path / "slim"
    path = strip_ckpt.main(["--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(slim_dir)])
    assert "model_0000007.pth" in capsys.readouterr().out
    slim = torch.load(path, weights_only=True)
    full = torch.load(src, weights_only=True)
    assert set(full) == {"model", "optimizer", "iteration"}
    assert set(slim) == {"model", "iteration"} and slim["iteration"] == 7
    assert slim["model"].keys() == full["model"].keys()
    assert all(torch.equal(v, full["model"][k]) for k, v in slim["model"].items())
    assert (slim_dir / "last_checkpoint").read_text() == "model_0000007.pth"
    assert (slim_dir / "model_0000007.pth").stat().st_size < (tmp_path / "ckpt" /
                                                              "model_0000007.pth").stat().st_size
    for where in (str(slim_dir), path):  # load_weights: predict's --ckpt, --eval-only's weights
        loaded = checkpoint.load_weights(build_model(cfg, device="cpu"), where)
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in loaded.state_dict().items())
    again = strip_ckpt.main(["--ckpt-dir", src, "--out", str(tmp_path / "slim2")])
    assert torch.load(again, weights_only=True)["iteration"] == 7
