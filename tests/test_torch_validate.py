"""The port's learning checks (gdrnet_tpu_torch/tools/validate_overfit.py and
validate_scale.py) against the JAX package's tools (tools/validate_overfit.py
and tools/validate_scale.py), on the CPU at a small size.

The JAX tools run their work at import (the TPU probe, the fixture, the
training), so the JAX side is built here as they build it: the overfit
config from tools/validate_overfit.py:38-54, and validate_scale's record
slices and config from tools/validate_scale.py:48-79, with the JAX
package's own modules. The port's CLIs run for real: validate_overfit at
--images 1 with TOTAL cut to 2 steps (with --save-ckpt, read back through
tools.bench's auto-detection, and --int8), validate_scale for one epoch at
batch 2 on a generator tree written on the CPU, its flagship config cut to
the small model of tests/test_torch_bench.py.
"""

import contextlib
import io
import json
import os.path as osp

import numpy as np
import pytest
import torch

from gdrnet_tpu.config import base_config as jax_base_config
from gdrnet_tpu.config import load_config as jax_load_config
from gdrnet_tpu.config.config import Config as JaxConfig
from gdrnet_tpu.config.config import merge_dict as jax_merge_dict
from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data.ref_meta import meta_from_json as jax_meta_from_json

from gdrnet_tpu_torch.engine.checkpoint import load_weights
from gdrnet_tpu_torch.models.gdrn import build_model
from gdrnet_tpu_torch.tools import bench, gen_scale_dataset, validate_overfit, validate_scale
from torch_parity import FLAGSHIP

OVERFIT_SWEEP_KEYS = {"seed", "images", "device_preprocess", "ad_10", "mean_re", "mean_te"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests gain nothing from intra-op threads, and under pytest-xdist
    each worker's threads would compete for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SCALE_SWEEP_KEYS = {"seed", "train_images", "test_images", "epochs", "train_secs", "ad_10",
                    "mean_re", "mean_te"}


def _sweep(stdout: str) -> dict:
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("SWEEP ")]
    return json.loads(line[len("SWEEP "):])


def jax_overfit_cfg():
    """tools/validate_overfit.py:38-54 on the JAX package's base_config."""
    cfg = jax_base_config()
    bb = cfg.MODEL.CDPN.BACKBONE
    bb.NUM_LAYERS = 18
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS = 8
    pnp = cfg.MODEL.CDPN.PNP_NET
    pnp.WITH_2D_COORD = True
    pnp.REGION_ATTENTION = True
    pnp.PM_LOSS_SYM = True
    pnp.PM_NORM_BY_EXTENT = True
    pnp.CENTROID_LW = 1.0
    pnp.Z_LW = 1.0
    cfg.DATASETS.SYM_OBJS = ["brick"]
    cfg.SOLVER.OPTIMIZER_CFG = dict(type="Ranger", lr=1e-3, weight_decay=0)
    cfg.SOLVER.ANNEAL_POINT = 0.72
    cfg.TEST.ROI_BATCH_SIZE = 4
    cfg.PARALLEL.DTYPE = "bfloat16"
    cfg.INPUT.DZI_TYPE = "none"
    return cfg


def test_overfit_cfg_equals_jax_tool():
    got, want = validate_overfit.overfit_cfg().to_dict(), jax_overfit_cfg().to_dict()
    assert got == want
    assert validate_overfit.TOTAL == 800 and validate_overfit.IMAGES == 6


@pytest.fixture(scope="module")
def overfit_run(tmp_path_factory):
    """The CLI at --images 1 and TOTAL 2 on the CPU, with --int8 and
    --save-ckpt checkpoints/bench_default in a fresh working directory."""
    work = tmp_path_factory.mktemp("overfit")
    mp = pytest.MonkeyPatch()
    mp.setattr(validate_overfit, "TOTAL", 2)
    mp.chdir(work)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            sweep = validate_overfit.main(["--images", "1", "--int8", "--save-ckpt",
                                           "checkpoints/bench_default"], device="cpu")
    finally:
        mp.undo()
    return {"work": work, "sweep": sweep, "stdout": out.getvalue()}


def test_overfit_cli_prints_the_jax_sweep_line(overfit_run):
    stdout = overfit_run["stdout"]
    sweep = _sweep(stdout)
    assert set(sweep) == OVERFIT_SWEEP_KEYS and sweep == overfit_run["sweep"]
    assert sweep["seed"] == 0 and sweep["images"] == 1 and sweep["device_preprocess"] is False
    assert all(isinstance(sweep[k], float) and sweep[k] == sweep[k]
               for k in ("ad_10", "mean_re", "mean_te"))
    lines = stdout.splitlines()
    # a line at step 0 and at the last step, the train time, both summaries
    assert [ln.split(":")[0] for ln in lines if ln.startswith("it ")] == ["it 0", "it 1"]
    assert any(ln.startswith("train time: ") for ln in lines)
    assert any(ln.startswith("ad_10 avg: ") for ln in lines)
    assert any(ln.startswith("int8 ad_10 avg: ") for ln in lines)


def test_save_ckpt_round_trips_through_bench_auto_detection(overfit_run, monkeypatch, capsys):
    work = overfit_run["work"]
    ckpt = work / "checkpoints" / "bench_default" / "ckpt"
    assert (ckpt / "last_checkpoint").is_file() and (ckpt.parent / "config.py").is_file()
    monkeypatch.chdir(work)
    row = bench.main(["--bf16", "--batch", "2", "--iters", "1"], device="cpu")
    assert row["ckpt"] == "checkpoints/bench_default/ckpt" and row["value"] > 0
    assert "auto-detected trained weights" in capsys.readouterr().err
    # the model of config.py's dims holds the saved weights, every tensor
    model = build_model(bench.bench_config(str(ckpt.parent / "config.py")), device="cpu")
    load_weights(model, str(ckpt))
    saved = torch.load(str(ckpt / "model_0000002.pth"), weights_only=True)["model"]
    assert saved.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0, msg=k)


def test_device_preprocess_exits_naming_it(tmp_path, monkeypatch):
    """--device-preprocess: the raw frames mapped by GDRNRawTrainMapper and
    the batch made by device_train_batch (DZI "none"), one image, 2 steps;
    the SWEEP line says device_preprocess true."""
    monkeypatch.setattr(validate_overfit, "TOTAL", 2)
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sweep = validate_overfit.main(["--images", "1", "--device-preprocess"], device="cpu")
    stdout = out.getvalue()
    assert "training through the device preprocessing pipeline" in stdout
    assert _sweep(stdout) == sweep and sweep["device_preprocess"] is True
    assert all(np.isfinite(sweep[k]) for k in ("ad_10", "mean_re", "mean_te"))


# ---------------------------------------------------------------------------
# validate_scale
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_tree(tmp_path_factory):
    """The generator's tree on the CPU: 6 train and 3 test images at
    240x180, 3 a scene."""
    root = tmp_path_factory.mktemp("scale") / "synth"
    with contextlib.redirect_stdout(io.StringIO()):
        gen_scale_dataset.main(["--root", str(root), "--train-images", "6", "--test-images", "3",
                                "--width", "240", "--height", "180", "--imgs-per-scene", "3",
                                "--device", "cpu"])
    return str(root)


def _keys(records) -> list:
    return [(r["scene_id"], r["im_id"], r["inst_i"], r["obj_id"]) for r in records]


def test_validate_scale_selects_the_jax_records(synth_tree):
    jmeta = jax_meta_from_json(synth_tree)
    jtrain = jbop.load_bop_scene_dicts(jmeta, "train", visib_thr=0.1, img_type="syn_pbr")
    jtrain.sort(key=lambda r: (r["scene_id"], r["im_id"]))
    jtest = jbop.load_bop_scene_dicts(jmeta, "test", visib_thr=0.1, img_type="real")
    jtest.sort(key=lambda r: (r["scene_id"], r["im_id"]))
    assert len(jtrain) > 8 and len(jtest) > 4
    meta = validate_scale.meta_from_json(synth_tree)
    for n_train, n_test in ((len(jtrain) - 3, len(jtest) - 2), (5, 2), (10_000, 10_000)):
        train, test = validate_scale.select_records(meta, n_train, n_test)
        assert _keys(train) == _keys(jtrain[:n_train])
        assert _keys(test) == _keys(jtest[:n_test])
        assert [r["rgb_path"] for r in train] == [r["rgb_path"] for r in jtrain[:n_train]]


def test_validate_scale_config_equals_jax_tool(tmp_path):
    args = validate_scale.parse_args(["--seed", "3", "--batch", "16", "--epochs", "7",
                                      "--out", str(tmp_path / "vs")])
    want = JaxConfig(jax_merge_dict(jax_base_config().to_dict(),
                                    jax_load_config(FLAGSHIP).to_dict()))
    want.SEED = 3
    want.OUTPUT_DIR = f"{tmp_path / 'vs'}_seed3"
    want.DATASETS.TRAIN = ("synthgate_train",)
    want.DATASETS.TEST = ("synthgate_test",)
    want.SOLVER.IMS_PER_BATCH = 16
    want.SOLVER.TOTAL_EPOCHS = 7
    want.SOLVER.CHECKPOINT_PERIOD = 10_000_000
    want.TRAIN.PRINT_FREQ = 100
    want.TEST.TEST_BBOX_TYPE = "gt"
    want.MODEL.LOAD_DETS_TEST = False
    want.VAL.ERROR_TYPES = "ad,rete,re,te,proj"
    assert osp.samefile(validate_scale.CONFIG, FLAGSHIP)
    assert validate_scale.build_config(args).to_dict() == want.to_dict()
    defaults = validate_scale.parse_args([])
    assert (defaults.seed, defaults.train_images, defaults.test_images, defaults.epochs,
            defaults.batch, defaults.root) == (0, 200, 50, 160, 128, "datasets/BOP_DATASETS/synth")


def test_validate_scale_one_epoch_prints_its_sweep_line(synth_tree, tmp_path, monkeypatch):
    small = tmp_path / "small_flagship.py"
    small.write_text(
        f"_base_ = [{FLAGSHIP!r}]\n"
        "MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=64, OUTPUT_RES=16), "
        "ROT_HEAD=dict(NUM_FILTERS=32, NUM_REGIONS=8), "
        "PNP_NET=dict(NUM_PM_POINTS=64, PNP_HEAD_CFG=dict(featdim=32))))\n"
        "PARALLEL = dict(DTYPE='float32')\n"
        "DATALOADER = dict(NUM_WORKERS=2)\n")
    monkeypatch.setattr(validate_scale, "CONFIG", str(small))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sweep = validate_scale.main(["--root", synth_tree, "--train-images", "6",
                                     "--test-images", "3", "--epochs", "1", "--batch", "2",
                                     "--out", str(tmp_path / "vs"), "--seed", "1"], device="cpu")
    assert _sweep(out.getvalue()) == sweep and set(sweep) == SCALE_SWEEP_KEYS
    assert (sweep["seed"], sweep["train_images"], sweep["test_images"], sweep["epochs"]) == (
        1, 6, 3, 1)
    assert all(sweep[k] == sweep[k] for k in ("ad_10", "mean_re", "mean_te"))
    assert osp.isfile(tmp_path / "vs_seed1" / "synth-test_gdrnet-tpu.csv")


def test_validate_scale_without_dataset_exits(tmp_path):
    with pytest.raises(SystemExit, match="scale dataset not found.*gen_scale_dataset"):
        validate_scale.main(["--root", str(tmp_path / "none")], device="cpu")
