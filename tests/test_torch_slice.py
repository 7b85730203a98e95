"""The port's slice end to end against the JAX package on the CPU: one
synthetic batch through both predict steps (f32, same weights), then both
CustomEvaluators over those predictions with a symmetric object, so ADD-S
runs through ops.kernels.nn_min_dist (its plain version here).

Tolerances: rot atol 1e-4 and trans rtol 1e-4 (a conv stack in two
libraries, then the rot6d Gram-Schmidt); recalls must be equal; mean
errors and the AUC rtol 1e-4.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnet_tpu.data.synthetic import synthetic_roi_batch as jax_synthetic_roi_batch
from gdrnet_tpu.engine.steps import make_predict_step as jax_make_predict_step
from gdrnet_tpu.eval.custom_evaluator import CustomEvaluator as JaxCustomEvaluator
from gdrnet_tpu.models.gdrn import build_model as jax_build_model

from gdrnet_tpu_torch import merged_config
from gdrnet_tpu_torch.data.synthetic import (
    poses_near,
    synthetic_object_models,
    synthetic_roi_batch,
)
from gdrnet_tpu_torch.engine.steps import make_predict_step
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS, CustomEvaluator
from gdrnet_tpu_torch.models.gdrn import build_model

from torch_parity import (
    FLAGSHIP,
    REPO,
    gen_scale_dataset,
    init_shapes,
    load_port,
    randomize,
    small_flagship_cfg,
)

MODEL_KEYS = ("roi_classes", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
              "roi_extents", "resize_ratios")


@pytest.mark.parametrize("kw", [dict(batch_size=3, input_res=64, out_res=16, seed=1),
                                dict(batch_size=2, num_classes=10, seed=7)])
def test_synthetic_roi_batch_equals_jax_package(kw):
    got, want = synthetic_roi_batch(**kw), jax_synthetic_roi_batch(**kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_merged_config_builds_flagship_gdrn_r34():
    cfg = merged_config(FLAGSHIP)
    assert cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES == 10
    assert cfg.TEST.ROI_BATCH_SIZE == 64 and cfg.PARALLEL.DTYPE == "bfloat16"
    model = build_model(cfg, device="cpu")
    assert model.compute_dtype == "bfloat16"
    assert len(model.backbone.layer3) == 6  # ResNet-34
    head = model.rot_head_net
    assert head.features[0].out_channels == 256 and head.out_channels == 1 + 3 + 65
    assert model.pnp_net.features[0].in_channels == 3 + 2 + 64
    assert model.pnp_net.fc1.in_features == 128 * 8 * 8
    assert model.pnp_net.features[1].num_groups == 32


@pytest.fixture(scope="module")
def predictions():
    """The same batch through the JAX and the port's predict steps, f32."""
    cfg = small_flagship_cfg()
    batch = synthetic_roi_batch(batch_size=12, input_res=64, out_res=16, num_classes=10,
                                seed=3)
    jm = jax_build_model(cfg)
    params, stats = randomize(init_shapes(jm, jnp.asarray(batch["roi_img"]),
                                          **{k: jnp.asarray(batch[k]) for k in MODEL_KEYS}),
                              seed=11)
    want = jax_make_predict_step(jm, with_maps=True)(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_port(build_model(cfg, device="cpu"), params, stats)
    got = make_predict_step(port, with_maps=True)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return batch, {k: np.asarray(v) for k, v in want.items()}, \
        {k: v.numpy() for k, v in got.items()}


def test_predict_step_matches_jax(predictions):
    _, want, got = predictions
    assert set(got) == set(want)
    np.testing.assert_allclose(got["rot"], want["rot"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["trans"], want["trans"], rtol=1e-4, atol=1e-6)
    for k in ("mask", "coor_x", "coor_y", "coor_z", "region"):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("with_auc,missing", [(False, 0), (True, 2)])
def test_custom_evaluator_matches_jax(predictions, with_auc, missing):
    batch, want_pred, got_pred = predictions
    names = ["ape", "brick", "cat"]
    points, diameters, sym_rots = synthetic_object_models(names, ["brick"], num_points=500,
                                                          seed=5)
    obj = [names[c % 3] for c in batch["roi_classes"]]
    # GT scattered around the predictions, so every threshold has poses on both sides
    R_gt, t_gt = poses_near(want_pred["rot"], want_pred["trans"], seed=6)
    results = []
    port_evaluator = functools.partial(CustomEvaluator, device="cpu")
    for cls, pred in ((JaxCustomEvaluator, want_pred), (port_evaluator, got_pred)):
        ev = cls(names, points, diameters, sym_objs=["brick"], sym_rots=sym_rots,
                 with_auc=with_auc)
        ev.process_batch(obj, pred["rot"], pred["trans"], R_gt, t_gt, batch["roi_cams"])
        if missing:
            ev.record_missing("cat", missing)
            ev.record_missing("dog", 1)  # no model: ignored by both
        results.append(ev.evaluate())
    want, got = results
    assert set(got) == set(want) == set(names) | {"Avg"}
    for name in want:
        assert set(got[name]) == set(want[name])
        for k in RECALL_KEYS:
            assert got[name][k] == want[name][k], (name, k)
        # the AUC, like the means, is continuous in the errors
        for k in ("mean_re", "mean_te", "mean_ad", "mean_proj") + (
                ("auc_ad_10",) if with_auc else ()):
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=1e-4, err_msg=k)
        assert got[name]["count"] == want[name]["count"]
    assert 0.0 < want["Avg"]["ad_10"] < 1.0  # the thresholds do separate the poses


CONFIG_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.py"))


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_merged_config_equals_jax_package(path):
    """The port's copy of the config system merges every config file of the
    repo over its defaults exactly as the JAX package's does."""
    from gdrnet_tpu.config import base_config as jax_base_config
    from gdrnet_tpu.config import load_config as jax_load_config
    from gdrnet_tpu.config.config import Config as JaxConfig
    from gdrnet_tpu.config.config import merge_dict as jax_merge_dict

    full = str(REPO / path)
    want = JaxConfig(jax_merge_dict(jax_base_config().to_dict(), jax_load_config(full).to_dict()))
    got = merged_config(full)
    assert type(got).__module__ == "gdrnet_tpu_torch.config.config"
    assert got.to_dict() == want.to_dict()


@pytest.fixture(scope="module")
def tiny_split(tmp_path_factory):
    """A BOP test split of three zoo meshes at 160x120, written on the CPU,
    and one GT-equal estimate per visible instance."""
    from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
    from gdrnet_tpu_torch.data.model_store import ObjectModels
    from gdrnet_tpu_torch.data.synthetic import write_bop_split

    root = str(tmp_path_factory.mktemp("tiny_split"))
    zoo = gen_scale_dataset().mesh_zoo()[:3]
    R = np.stack([np.eye(3, dtype=np.float32)] * 3)
    t = np.array([[-0.05, 0.0, 0.6], [0.0, 0.0, 0.6], [0.05, 0.0, 0.6]], np.float32)
    K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]], np.float32)
    meta, _ = write_bop_split(root, zoo, np.arange(3), R, t, K, width=160, height=120,
                              per_image=3, images_per_scene=1, device="cpu")
    records = load_bop_scene_dicts(meta, "test")
    models = ObjectModels(meta, num_pm_points=50, num_fps=8)
    results = [{"scene_id": r["scene_id"], "im_id": r["im_id"], "obj_id": r["obj_id"],
                "score": 1.0, "R": r["R"], "t": r["t"] * 1000.0, "time": -1.0}
               for r in records]
    return {"zoo": zoo, "records": records, "models": models, "results": results, "K": K,
            "root": root}


def _entry_point_call(entry: str, split: dict, tmp_path):
    """A call of one entry point that names no device."""
    from gdrnet_tpu_torch.data.synthetic import write_bop_split
    from gdrnet_tpu_torch.eval import bop_score, vsd
    from gdrnet_tpu_torch.ops import rasterizer

    _, v, f, _ = split["zoo"][0]
    K, R, t = split["K"], np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 0.6], np.float32)
    depth = np.zeros((120, 160), np.float32)
    if entry == "build_model":
        return build_model(small_flagship_cfg())
    if entry == "CustomEvaluator":
        points, diameters, sym_rots = synthetic_object_models(["brick"], ["brick"],
                                                              num_points=50, seed=0)
        ev = CustomEvaluator(["brick"], points, diameters, sym_objs=["brick"], sym_rots=sym_rots)
        ev.process_batch(["brick"], R[None], t[None], R[None], t[None], K[None])
        return ev.evaluate()
    if entry == "_vsd_errors_by_obj":
        pairs = bop_score.match_estimates_to_gt(split["results"], split["records"])
        return bop_score._vsd_errors_by_obj(pairs, split["models"], 15.0,
                                            bop_score.BOP19_VSD_TAUS)
    if entry == "score_results":
        return bop_score.score_results(split["results"], split["records"], split["models"],
                                       error_types="ad,vsd")
    if entry == "render_depths_many":
        return vsd.render_depths_many(v, f, K[None], R[None], t[None], 120, 160)
    if entry == "vsd_pairs":
        return vsd.vsd_pairs(R[None], t[None], R[None], t[None], depth[None], K[None], v, f)
    if entry == "vsd":
        return vsd.vsd(R, t, R, t, depth, K, v, f)
    if entry == "render_xyz_windows":
        return rasterizer.render_xyz_windows(v, f, K[None], R[None], t[None],
                                             np.zeros((1, 2), np.float32), 32, 32)
    if entry == "render_xyz":
        return rasterizer.render_xyz(v, f, K, R, t, 120, 160)
    if entry == "render_depth":
        return rasterizer.render_depth(v, f, K, R, t, 120, 160)
    if entry == "render_xyz_roi":
        return rasterizer.render_xyz_roi(v, f, K, R, t, 120, 160, tile=64)
    if entry == "render_xyz_roi_many":
        return rasterizer.render_xyz_roi_many(v, f, K[None], R[None], t[None], 120, 160, tile=64)
    if entry == "GDRNTrainMapper":  # a record without xyz_crop renders its XYZ
        from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper

        return GDRNTrainMapper(small_flagship_cfg(), split["models"])(
            dict(split["records"][0]), np.random.RandomState(0))
    if entry == "do_train":
        from gdrnet_tpu_torch.data.dataset_factory import register
        from gdrnet_tpu_torch.engine.trainer import do_train

        cfg = small_flagship_cfg()
        cfg.OUTPUT_DIR, cfg.DATASETS.TRAIN = str(tmp_path), ("tinysplit_train",)
        register("tinysplit_train", lambda: (split["models"].meta, split["records"]))
        return do_train(cfg, max_iters_override=1)
    if entry == "do_test":
        from gdrnet_tpu_torch.engine.tester import do_test

        cfg = small_flagship_cfg()
        return do_test(cfg, build_model(cfg, device="cpu"), split["models"], split["records"])
    if entry == "train.main":
        from gdrnet_tpu_torch.engine import train

        return train.main(["--config-file", FLAGSHIP, "--eval-only",
                           f"OUTPUT_DIR={str(tmp_path)!r}"])
    if entry == "vis_records":
        from gdrnet_tpu_torch.data.visualize import vis_records

        return vis_records(split["models"].meta, split["records"], split["models"], n=1,
                           mapped=True, cfg=small_flagship_cfg())
    if entry == "visualize.main":
        from gdrnet_tpu_torch.data.dataset_factory import register
        from gdrnet_tpu_torch.data.visualize import main

        register("tinysplit_vis", lambda: (split["models"].meta, split["records"]))
        return main(["tinysplit_vis", "--mapped", "--save-dir", str(tmp_path)])
    if entry in ("cus", "cou_bb_proj"):
        return getattr(vsd, entry)(R, t, R, t, K, v, f, 120, 160)
    if entry == "compute_fps.main":
        from gdrnet_tpu_torch.tools import compute_fps

        return compute_fps.main(["--models-dir", split["models"].meta.model_dir])
    if entry == "farthest_point_sampling_idx":
        from gdrnet_tpu_torch.ops.fps import farthest_point_sampling_idx

        return farthest_point_sampling_idx(v, 8)
    data = ["--dataset", split["models"].meta.name,
            "--data-root", str(Path(split["root"]).parent)]
    if entry == "predict.main":
        from gdrnet_tpu_torch.tools import predict

        return predict.main(["--config-file", FLAGSHIP, "--ckpt", str(tmp_path), "--dets",
                             str(tmp_path / "d.json"), "--image-root", str(tmp_path),
                             "--out", str(tmp_path / "p.csv")] + data)
    if entry == "eval_csv.main":
        from gdrnet_tpu_torch.tools import eval_csv

        return eval_csv.main(["--csv", str(tmp_path / "p.csv")] + data)
    if entry == "gen_xyz.main":
        from gdrnet_tpu_torch.tools import gen_xyz

        return gen_xyz.main(data + ["--overwrite"])
    assert entry == "write_bop_split"
    return write_bop_split(str(tmp_path), split["zoo"][:1], np.zeros(1, int), R[None],
                           t[None], K, width=160, height=120, per_image=1,
                           images_per_scene=1)


ENTRY_POINTS = ["build_model", "CustomEvaluator", "_vsd_errors_by_obj", "score_results",
                "render_depths_many", "vsd_pairs", "vsd", "render_xyz_windows", "render_xyz",
                "render_depth", "render_xyz_roi", "render_xyz_roi_many", "write_bop_split",
                "GDRNTrainMapper", "do_train", "do_test", "train.main", "cus", "cou_bb_proj",
                "predict.main", "eval_csv.main", "gen_xyz.main", "vis_records",
                "visualize.main", "compute_fps.main", "farthest_point_sampling_idx"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(entry, tiny_split, tmp_path):
    """Called without `device`, each entry point runs on the CUDA card: with
    no card it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises((AssertionError, RuntimeError), match=r"(?i)cuda|nvidia"):
        _entry_point_call(entry, tiny_split, tmp_path)


def test_port_imports_no_jax():
    """Every module of the port (found by walking the package, so new ones
    are covered), then merged_config on the flagship: no JAX, nor the JAX
    package or its tools/ scripts, cv2, tabulate or matplotlib, which the
    card's machine lacks, nor PIL, torchvision or tensorboard, which no
    required path needs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gdrnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(gdrnet_tpu_torch.__path__,\n"
        "                                               'gdrnet_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'gdrnet_tpu_torch.ops.kernels' in names and len(names) > 25, names\n"
        "assert 'gdrnet_tpu_torch.tools.gen_scale_dataset' in names, names\n"
        "for tool in ('predict', 'eval_csv', 'gen_xyz'):\n"
        "    assert 'gdrnet_tpu_torch.tools.' + tool in names, names\n"
        "for mod in ('utils.fold_bn', 'models.quantize', 'eval.pose_matching', 'eval.report',\n"
        "            'data.jpeg', 'data.jpeg_cases', 'data.render_dataset',\n"
        "            'models.point_pnp_net', 'engine.precise_bn', 'parallel.multihost',\n"
        "            'parallel.mesh', 'parallel.sync_bn', 'tools.dryrun_multichip',\n"
        "            'engine.profiling', 'tools.bench', 'tools.bench_train', 'tools.export_model',\n"
        "            'tools.strip_ckpt', 'tools.gen_test_targets', 'tools.gen_det_fuse',\n"
        "            'models.pvnet', 'ops.se3', 'ops.view_sampler', 'utils.bbox_utils',\n"
        "            'utils.mask_utils', 'data.dataset_params', 'tools.validate_overfit',\n"
        "            'tools.validate_scale', 'tools.scale_run', 'utils.vis', 'data.visualize',\n"
        "            'data.font_simplex', 'data.device_augment', 'data.device_pipeline',\n"
        "            'data.device_pool', 'ops.fps', 'tools.compute_fps'):\n"
        "    assert 'gdrnet_tpu_torch.' + mod in names, names\n"
        "from gdrnet_tpu_torch import merged_config\n"
        f"merged_config({FLAGSHIP!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gdrnet_tpu', 'cv2',\n"
        "              'tabulate', 'matplotlib', 'PIL', 'torchvision', 'tensorboard', 'tools',\n"
        "              'compute_fps', 'gen_scale_dataset'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
