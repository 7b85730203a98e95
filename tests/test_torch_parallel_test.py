"""Sharded testing on the CPU: the port's do_test in 2 gloo ranks against one
process, and the port's shards against the JAX package's
do_test(..., shard=i, num_shards=2), on tests/fixture_bop.py with
tests/test_torch_tester.py's detections, config (R18 at 32x32 crops, buckets
of 4, est boxes, BOP scoring over ad,rete,proj,vsd,mssd,mspd) and weights
(the JAX model's PRNGKey(0) init as a .pth). Also TEST.LOCAL_DEVICES.

Tolerances: recalls, counts, missing counts and BOP recalls equal; mean
errors at rtol 1e-5 between the port's runs (a shard's buckets start at
other rows, so a ROI may share its convolution with other ROIs) and at
test_torch_tester.py's 1e-4 against JAX; CSV rows in the same order with
rotations within 1e-5 (1e-4 against JAX) and translations within 1e-5
relative (1e-4 against JAX).
"""

import os.path as osp

import numpy as np
import pytest
import torch

from gdrnet_tpu.engine import tester as jtester

from gdrnet_tpu_torch.engine import do_test, tester
from gdrnet_tpu_torch.eval.bop_writer import load_bop_results
from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS
from gdrnet_tpu_torch.parallel import mesh
from test_torch_tester import (  # noqa: F401
    CSV_MM,
    MEAN_KEYS,
    POSE_ATOL,
    TRANS_RTOL,
    _cfg,
    _jax_cfg,
    _port_model,
    fix,
    weights,
)
from torch_ddp_worker import start_ranks

PORT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_results_equal(got: dict, want: dict, mean_rtol: float) -> None:
    names = {k for k in want if not k.startswith("_")}
    assert {k for k in got if not k.startswith("_")} == names
    for name in names:
        for k in RECALL_KEYS:
            assert got[name][k] == want[name][k], (name, k)
        for k in MEAN_KEYS:
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=mean_rtol,
                                       err_msg=f"{name} {k}")
        assert got[name]["count"] == want[name]["count"], name
        assert got[name].get("n_missing") == want[name].get("n_missing"), name


def assert_rows_close(got: list, want: list, r_atol: float, t_rtol: float) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["scene_id"], g["im_id"], g["obj_id"], g["score"]) == (
            w["scene_id"], w["im_id"], w["obj_id"], w["score"])
        np.testing.assert_allclose(g["R"], w["R"], atol=r_atol)
        np.testing.assert_allclose(g["t"], w["t"], rtol=t_rtol, atol=CSV_MM)


@pytest.fixture(scope="module", autouse=True)
def sharded(fix, weights, tmp_path_factory):
    """do_test in 2 ranks, started with the file's first test and run
    beside the one-process runs; {"root": their output_dir, "future"}."""
    root = tmp_path_factory.mktemp("sharded")
    cfg = _cfg(fix)
    return {"root": root, "future": start_ranks(root, [("do_test", dict(
        cfg=cfg.to_dict(), meta=fix["pmodels"].meta, records=fix["precs"], weights=weights[2],
        output_dir=str(root), num_pm_points=64, num_fps=4))])}


@pytest.fixture(scope="module")
def one(fix, weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    cfg = _cfg(fix)
    return do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"],
                   output_dir=str(out), device="cpu")


def test_sharded_do_test_two_ranks_equals_one_process(one, sharded):
    """Each rank tests half the (image, object) groups; after the gather
    every rank scores all of them, and rank 0 alone writes the CSV and runs
    BOP scoring: the results and the CSV of one process."""
    ranks = [r[0] for r in sharded["future"].result()]
    for got in ranks:
        assert_results_equal(got, one, PORT_RTOL)
    assert "_csv_path" not in ranks[1] and "_bop" not in ranks[1]
    assert ranks[0]["_bop"].keys() == one["_bop"].keys()
    for etype, per_obj in one["_bop"].items():
        for name, v in per_obj.items():
            np.testing.assert_array_equal(np.asarray(ranks[0]["_bop"][etype][name]),
                                          np.asarray(v), err_msg=f"{etype} {name}")
    assert ranks[0]["_bop_average_recall"] == one["_bop_average_recall"]
    assert osp.dirname(ranks[0]["_csv_path"]) == str(sharded["root"])
    assert_rows_close(load_bop_results(ranks[0]["_csv_path"]),
                      load_bop_results(one["_csv_path"]), 1e-5, PORT_RTOL)
    assert sum(one[n].get("n_missing", 0) for n in one if not n.startswith("_")) == 1


def test_shards_equal_jax_shards(fix, weights, one, tmp_path):
    """do_test(shard=i, num_shards=2) in one process scores shard i alone,
    in both packages (the missing detection counted on shard 0); the two
    shards' CSV rows together are the one-process CSV."""
    cfg = _cfg(fix)
    model, variables, path = weights
    rows = []
    for shard in (0, 1):
        want = jtester.do_test(_jax_cfg(cfg), model, variables, fix["jmodels"], fix["jrecs"],
                               output_dir=str(tmp_path / f"jax{shard}"), shard=shard,
                               num_shards=2)
        got = do_test(cfg, _port_model(cfg, path), fix["pmodels"], fix["precs"],
                      output_dir=str(tmp_path / f"port{shard}"), shard=shard, num_shards=2,
                      device="cpu")
        assert_results_equal(got, want, 1e-4)
        assert_rows_close(load_bop_results(got["_csv_path"]),
                          load_bop_results(want["_csv_path"]), POSE_ATOL, TRANS_RTOL)
        assert bool(sum(got[n].get("n_missing", 0) for n in got if not n.startswith("_"))) == (
            shard == 0)
        rows += load_bop_results(got["_csv_path"])
    assert_rows_close(rows, load_bop_results(one["_csv_path"]), 1e-5, PORT_RTOL)


def test_local_devices_split_equals_one_device(fix, weights, one, tmp_path, monkeypatch):
    """TEST.LOCAL_DEVICES=2: on this one-device process do_test runs
    unsplit, as JAX does on one chip; with two CPU replicas (local_devices
    patched) every bucket of 4 is split in two, and the results and the
    CSV are the one-device run's."""
    cfg = _cfg(fix)
    cfg.TEST.LOCAL_DEVICES = 2
    calls = []
    split = mesh.split_predict

    def counted(predicts, devices):
        calls.append(len(devices))
        return split(predicts, devices)

    monkeypatch.setattr(tester, "split_predict", counted)
    got = do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"],
                  output_dir=str(tmp_path / "unsplit"), device="cpu")
    assert not calls
    assert_results_equal(got, one, PORT_RTOL)
    monkeypatch.setattr(mesh, "local_devices", lambda device: [torch.device("cpu")] * 2)
    got = do_test(cfg, _port_model(cfg, weights[2]), fix["pmodels"], fix["precs"],
                  output_dir=str(tmp_path / "split"), device="cpu")
    assert calls and set(calls) == {2}
    assert_results_equal(got, one, PORT_RTOL)
    assert_rows_close(load_bop_results(got["_csv_path"]), load_bop_results(one["_csv_path"]),
                      1e-5, PORT_RTOL)
