"""The CUDA kernels of gdrnet_tpu_torch against their plain PyTorch versions:
nn_min_dist (B1) and rasterize_xyz (B2, with XYZ and with 12 per-pose
attribute channels), B2 under the train mapper (renders on the card equal
to the CPU's, from loader-like threads on their own streams beside train
steps) and under the dataset generator's phong+XYZ pass; and the device PnP
program (ops/device_pnp.py, batched torch, no kernel of its own) on the
card against the CPU; and parallel/sync_bn.SyncBatchNorm2d in two gloo
ranks on the one card against nn.BatchNorm2d in one process (plain
PyTorch, no kernel of its own), and the multichip dry run's ranks on the
card; and the device FPS (ops/fps.py, plain PyTorch) on the card against
numpy's FPS on clouds with exact ties.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. This file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py does import JAX, so on such a machine run it as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import os.path as osp
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gdrnet_tpu_torch.data.synthetic import (
    cylinder_cloud,
    edge_on_poses,
    lattice_cloud,
    sliver_mesh,
    synthetic_decoded_maps,
)
from gdrnet_tpu_torch.ops import device_pnp, fps, kernels
from gdrnet_tpu_torch.ops.kernels import (
    nn_min_dist,
    nn_min_dist_ref,
    rasterize_attr,
    rasterize_attr_ref,
    rasterize_xyz,
    rasterize_xyz_ref,
)
from gdrnet_tpu_torch.ops.rasterizer import render_phong_xyz_roi_many, vertex_normals
from gdrnet_tpu_torch.tools import gen_scale_dataset as gsd

# ragged sizes: one query, one reference point, sizes off any tile
SHAPES = [(3, 700, 500), (2, 1, 300), (2, 300, 1), (1, 1, 1), (2, 1001, 257),
          (64, 3000, 3000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nr", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, nq, nr):
    g = torch.Generator().manual_seed(b * 7919 + nq * 31 + nr)
    q = (torch.randn(b, nq, 3, generator=g) * 0.1).to(cuda_device)
    r = (torch.randn(b, nr, 3, generator=g) * 0.1).to(cuda_device)
    before = kernels.nn_min_dist.launches
    got = nn_min_dist(q, r)
    torch.cuda.synchronize()
    assert kernels.nn_min_dist.launches == before + 1
    # same f32 distances, another summation order
    torch.testing.assert_close(got, nn_min_dist_ref(q, r), rtol=1e-5, atol=1e-7)
    # runs give identical results: fixed-order reduction, no atomics
    assert torch.equal(got, nn_min_dist(q, r))


K_VGA = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]], np.float32)


def _zoo_mesh(index: int = 3, rounds: int = 0):
    """Mesh `index` of the synth dataset's mesh_zoo (3: the tower, 448
    faces; 0: the cube), after `rounds` rounds of its _subdivide (x4 faces
    each)."""
    _, v, f, _ = gsd.mesh_zoo()[index]
    for _ in range(rounds):
        v, f = gsd._subdivide(v, f)
    return v, f


def _tensors(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _raster_inputs(case: str, device):
    """(args of rasterize_xyz, height, width) of one test case."""
    g = np.random.RandomState(sum(map(ord, case)))
    K = K_VGA
    if case == "edge_on_cube":  # face planes through the camera centre
        v, f = _zoo_mesh(0)
        R, t = edge_on_poses(0.035)
        c = t @ K.T
        origins = np.floor(c[:, :2] / c[:, 2:] - 64).astype(np.float32)
        return _tensors(device, v, f, np.broadcast_to(K, (4, 3, 3)), R, t, origins), 128, 128
    if case == "slivers":  # near-degenerate faces with huge 1 / area
        v, f = sliver_mesh(K, seed=1)
        origins = np.array([[188.0, 146.0], [220.0, 130.0]], np.float32)
        return _tensors(device, v, f, np.broadcast_to(K, (2, 3, 3)),
                        np.stack([np.eye(3, dtype=np.float32)] * 2),
                        np.zeros((2, 3), np.float32), origins), 96, 128
    v, f = _zoo_mesh()
    B, h, w = 16, 128, 128
    centres = np.stack([g.uniform(200, 440, B), g.uniform(140, 340, B), np.ones(B)], 1)
    if case == "one_face":
        v = np.array([[-0.05, -0.04, 0.0], [0.06, -0.03, 0.01], [0.0, 0.05, -0.01]], np.float32)
        f = np.array([[0, 1, 2]], np.int32)
    elif case == "ragged_faces":  # F on no chunk boundary, window off any tile
        v, f = _zoo_mesh(rounds=1)
        f, h, w = f[:777], 90, 100
    elif case == "off_frame":  # objects at the frame's corners, windows over its edges
        centres[:2] = [[5.0, 475.0, 1.0], [636.0, 3.0, 1.0]]
    elif case == "subdivided":
        v, f = _zoo_mesh(rounds=2)
        h = w = 256
    q = np.linalg.qr(g.randn(B, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t = (g.uniform(0.5, 1.2, (B, 1)) * centres @ np.linalg.inv(K).T).astype(np.float32)
    if case == "behind_camera":
        t[:, 2] *= -1
    c = centres[:, :2] - [w // 2, h // 2]
    origins = np.floor(c).astype(np.float32)
    return _tensors(device, v, f, np.broadcast_to(K, (B, 3, 3)), R, t, origins), h, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["batch16", "one_face", "ragged_faces", "off_frame",
                                  "behind_camera", "subdivided", "edge_on_cube", "slivers"])
def test_rasterize_xyz_kernel_matches_plain_version(cuda_device, case):
    args, h, w = _raster_inputs(case, cuda_device)
    before = kernels.rasterize_xyz.launches
    depth, xyz = rasterize_xyz(*args, h, w)
    torch.cuda.synchronize()
    assert kernels.rasterize_xyz.launches == before + 1
    want_depth, want_xyz = rasterize_xyz_ref(*args, h, w)
    # one face table, every operation rounded alike: equal hit masks and,
    # in f32, depth / xyz within 1e-6 m (bitwise equal is expected)
    assert torch.equal(depth > 0, want_depth > 0)
    torch.testing.assert_close(depth, want_depth, rtol=0, atol=1e-6)
    torch.testing.assert_close(xyz, want_xyz, rtol=0, atol=1e-6)
    assert ((depth > 0).sum() == 0) == (case == "behind_camera")
    again = rasterize_xyz(*args, h, w)
    assert torch.equal(depth, again[0]) and torch.equal(xyz, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("per_pose", [True, False])
def test_rasterize_attr_12_channels_matches_plain_version(cuda_device, per_pose):
    """B2 with 12 attribute channels a pose (camera normal, camera position,
    material, XYZ, as the dataset generator renders them) or one set of 12
    shared by the 16 poses: bitwise equal to rasterize_attr_ref, and one
    launch counted."""
    args, h, w = _raster_inputs("batch16", cuda_device)
    v, f, K, R, t, origins = (a.cpu().numpy() for a in args)
    g = np.random.RandomState(12)
    if per_pose:
        n = vertex_normals(v, f)
        attrs = np.concatenate([np.einsum("vk,bjk->bvj", n, R),
                                np.einsum("vk,bjk->bvj", v, R) + t[:, None],
                                np.broadcast_to(g.rand(3), (16, len(v), 3)),
                                np.broadcast_to(v, (16,) + v.shape)], -1)
    else:
        attrs = g.randn(1, len(v), 12)
    a = torch.from_numpy(np.ascontiguousarray(attrs, np.float32)).to(cuda_device)
    call = [args[0], a, *args[1:]]
    before = kernels.rasterize_attr.launches
    depth, out = rasterize_attr(*call, h, w)
    torch.cuda.synchronize()
    assert kernels.rasterize_attr.launches == before + 1 and out.shape == (16, h, w, 12)
    want_depth, want_out = rasterize_attr_ref(*call, h, w)
    assert (depth > 0).sum() > 1000
    assert torch.equal(depth, want_depth) and torch.equal(out, want_out)


@pytest.mark.cuda
def test_render_phong_xyz_roi_many_on_the_card_equals_the_cpu(cuda_device):
    """The generator's pass over 40 poses of the zoo's hexprism (two B2
    launches at batch 32) at tile 128: uint16 mm depth and f16 XYZ equal
    (the attribute maps are bitwise equal); uint8 rgb within 1 grey level,
    at no more than 1 % of the hit pixels (the shading's norms and
    divisions are PyTorch ops on two devices)."""
    _, v, f, _ = gsd.mesh_zoo()[9]
    g = np.random.RandomState(40)
    q = np.linalg.qr(g.randn(40, 3, 3))[0]
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    c = np.stack([g.uniform(100, 540, 40), g.uniform(100, 380, 40), np.ones(40)], 1)
    t = (g.uniform(0.5, 0.9, (40, 1)) * c @ np.linalg.inv(gsd.K_DEF).T).astype(np.float32)
    kw = dict(colors=np.broadcast_to(g.rand(3), (len(v), 3)),
              light_pos=g.uniform(-2, 2, (40, 3)), ambient=g.uniform(0.35, 0.55, 40),
              diffuse=g.uniform(0.6, 1.0, 40), specular=g.uniform(0.1, 0.4, 40))
    Ks = np.broadcast_to(gsd.K_DEF, (40, 3, 3))
    before = kernels.rasterize_attr.launches
    card = render_phong_xyz_roi_many(v, f, Ks, R, t, 480, 640, tile=128, device="cuda", **kw)
    assert kernels.rasterize_attr.launches == before + 2
    cpu = render_phong_xyz_roi_many(v, f, Ks, R, t, 480, 640, tile=128, device="cpu", **kw)
    hits = flips = 0
    for (d, rgb, xyz, o), (dc, rgbc, xyzc, oc) in zip(card, cpu):
        assert o == oc
        np.testing.assert_array_equal(d, dc)
        np.testing.assert_array_equal(xyz, xyzc)
        diff = np.abs(rgb.astype(int) - rgbc)
        assert diff.max() <= 1
        hits += int((dc > 0).sum())
        flips += int((diff > 0).any(-1).sum())
    assert hits > 40 * 1000 and flips <= 0.01 * hits


@pytest.mark.cuda
def test_rasterize_xyz_takes_int64_faces(cuda_device):
    args, h, w = _raster_inputs("batch16", cuda_device)
    got = rasterize_xyz(*args, h, w)
    args[1] = args[1].long()
    again = rasterize_xyz(*args, h, w)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_rasterize_xyz_launches_two_kernels_and_no_face_table(cuda_device, monkeypatch):
    """The CUDA path builds the face table on the device: raster_face_tables
    (the plain version's prologue) is not called, and one call launches the
    setup and the z-buffer kernel, nothing else."""
    args, h, w = _raster_inputs("batch16", cuda_device)
    rasterize_xyz(*args, h, w)  # build and load the kernels first
    torch.cuda.synchronize()

    def no_table(*a, **k):
        raise AssertionError("raster_face_tables called on the CUDA path")

    monkeypatch.setattr(kernels, "raster_face_tables", no_table)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        rasterize_xyz(*args, h, w)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        pytest.skip("the profiler saw no device activity on this machine")
    assert len(names) == 2
    assert sum("face_setup_kernel" in n for n in names) == sum("zbuffer_kernel" in n
                                                                for n in names) == 1


@pytest.mark.cuda
def test_rasterize_xyz_stops_on_a_bad_face_index(cuda_device):
    """A face index outside [0, V) stops the setup kernel before it reads
    (a device-side fault, in a process of its own)."""
    code = (
        "import torch\n"
        "from gdrnet_tpu_torch.ops.kernels import rasterize_xyz\n"
        "v = torch.rand(4, 3, device='cuda') + torch.tensor([0.0, 0.0, 1.0], device='cuda')\n"
        "f = torch.tensor([[0, 1, 2], [1, 2, 4]], dtype=torch.int32, device='cuda')\n"
        "K = torch.tensor([[[500.0, 0, 32], [0, 500.0, 32], [0, 0, 1]]], device='cuda')\n"
        "d, _ = rasterize_xyz(v, f, K, torch.eye(3, device='cuda')[None],\n"
        "                     torch.zeros(1, 3, device='cuda'), torch.zeros(1, 2, device='cuda'),\n"
        "                     64, 64)\n"
        "torch.cuda.synchronize()\n"
        "print('finished', float(d.sum()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0 and "finished" not in proc.stdout, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the train mapper's XYZ renders on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo_train_split(tmp_path_factory):
    """A BOP train split of the zoo meshes without xyz_crop pickles (2 scenes
    x 2 images x 4 instances at 320x240) and the flagship config: (records,
    models, cfg)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from gdrnet_tpu_torch import merged_config
    from gdrnet_tpu_torch.data.dataset_factory import resolve
    from gdrnet_tpu_torch.data.model_store import ObjectModels
    from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch, write_bop_split

    root = tmp_path_factory.mktemp("zoo_cuda")
    p = synthetic_roi_batch(batch_size=16, input_res=8, out_res=4, num_classes=10, seed=4)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    t = p["gt_trans"].copy()
    t[:, :2] = np.random.RandomState(2).uniform(-0.1, 0.1, (16, 2))
    t[:, 2] += 0.4
    write_bop_split(str(root / "zoo"), gsd.mesh_zoo(), p["roi_classes"], p["gt_ego_rot"], t, K,
                    width=320, height=240, per_image=4, images_per_scene=2, device="cuda",
                    split="train")
    cfg = merged_config(str(Path(__file__).resolve().parents[1]
                            / "configs/gdrn/synth/a6_cPnP_synth.py"))
    meta, records = resolve("zoo_train", str(root), visib_thr=0.1)
    models = ObjectModels(meta, num_pm_points=cfg.MODEL.CDPN.PNP_NET.NUM_PM_POINTS,
                          num_fps=cfg.MODEL.CDPN.ROT_HEAD.NUM_REGIONS)
    assert len(records) >= 8 and not any(osp.exists(r["xyz_path"]) for r in records)
    return records, models, cfg


@pytest.mark.cuda
def test_mapper_renders_on_the_card_equal_the_cpu(zoo_train_split):
    """Every record's sample mapped with the kernel on the card equals the
    one mapped with the plain rasterizer on the CPU, same seeds, bit for bit
    (the kernel equals its plain version bitwise)."""
    from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper

    records, models, cfg = zoo_train_split
    np.random.seed(0)
    card = GDRNTrainMapper(cfg, models, device="cuda")
    np.random.seed(0)
    cpu = GDRNTrainMapper(cfg, models, device="cpu")
    before = kernels.rasterize_xyz.launches
    for i, rec in enumerate(records[:8]):
        got, want = card(dict(rec), np.random.RandomState(i)), cpu(dict(rec), np.random.RandomState(i))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"record {i} {k}")
    assert kernels.rasterize_xyz.launches == before + 8


@pytest.mark.cuda
def test_renders_on_thread_streams_beside_a_train_step(zoo_train_split):
    """Two threads render with the mapper, each on a CUDA stream of its own,
    while train steps run on the default stream: each render equals the
    plain version's, the streams are distinct and not the default one."""
    from gdrnet_tpu_torch import build_lr_schedule, build_optimizer, create_train_state
    from gdrnet_tpu_torch import make_train_step
    from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper
    from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
    from gdrnet_tpu_torch.models.gdrn import build_model

    records, models, cfg = zoo_train_split
    mapper = GDRNTrainMapper(cfg, models, device="cuda")
    want = {}
    for i, rec in enumerate(records[:6]):
        want[i] = GDRNTrainMapper(cfg, models, device="cpu")._render_xyz(rec, 240, 320)
    model = build_model(cfg, device="cuda")
    opt = build_optimizer(cfg, model, build_lr_schedule(cfg, 1e-4, 100))
    state, step = create_train_state(model, opt), make_train_step(cfg, model, opt)
    net = cfg.MODEL.CDPN
    batch = synthetic_roi_batch(batch_size=16, input_res=net.BACKBONE.INPUT_RES,
                                out_res=net.BACKBONE.OUTPUT_RES,
                                num_classes=net.ROT_HEAD.NUM_CLASSES,
                                num_points=net.PNP_NET.NUM_PM_POINTS,
                                num_regions=net.ROT_HEAD.NUM_REGIONS, seed=1)
    got, streams, errors = {}, {}, []

    def render(worker):
        try:
            for i in range(worker, 6, 2):
                got[i] = mapper._render_xyz(records[i], 240, 320)
            streams[worker] = mapper._local.stream
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=render, args=(w,)) for w in range(2)]
    for _ in range(2):
        step(state, batch, None)  # queued on the default stream
    for t in threads:
        t.start()
    for _ in range(2):
        step(state, batch, None)
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads), errors
    default = torch.cuda.default_stream()
    assert streams[0] != streams[1] and default not in streams.values()
    for i in range(6):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"record {i}")


# the test path: do_test on the card against do_test on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_do_test_on_the_card_equals_the_cpu(tmp_path):
    """A small f32 model (TF32 off) tests a BOP split of zoo meshes that
    write_bop_split renders on the card: the poses of do_test on the card
    within 1e-3 of those on the CPU (the plain versions), the recalls and
    BOP recalls equal, and both kernels launched inside the card's call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from gdrnet_tpu_torch import merged_config
    from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
    from gdrnet_tpu_torch.data.model_store import ObjectModels
    from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch, write_bop_split
    from gdrnet_tpu_torch.engine.tester import do_test
    from gdrnet_tpu_torch.models.gdrn import build_model, init_weights

    repo = Path(__file__).resolve().parents[1]
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    p = synthetic_roi_batch(batch_size=8, input_res=8, out_res=4, num_classes=10, seed=6)
    t = p["gt_trans"].copy()
    t[:, :2] = np.random.RandomState(3).uniform(-0.08, 0.08, (8, 2))
    t[:, 2] += 0.4
    classes = np.array([0, 1, 3, 8, 1, 2, 3, 9])  # brick, tower, bar, hexprism are symmetric
    meta, _ = write_bop_split(str(tmp_path / "split"), gsd.mesh_zoo(), classes, p["gt_ego_rot"],
                              t, K, width=320, height=240, per_image=4, images_per_scene=2,
                              device="cuda")
    records = load_bop_scene_dicts(meta, "test")
    models = ObjectModels(meta, num_pm_points=300, num_fps=8)

    cfg = merged_config(str(repo / "configs/gdrn/synth/a6_cPnP_synth.py"))
    net = cfg.MODEL.CDPN
    net.BACKBONE.NUM_LAYERS, net.BACKBONE.INPUT_RES, net.BACKBONE.OUTPUT_RES = 18, 64, 16
    net.ROT_HEAD.NUM_FILTERS, net.ROT_HEAD.NUM_REGIONS = 32, 8
    net.PNP_NET.PNP_HEAD_CFG.featdim, net.PNP_NET.NUM_PM_POINTS = 32, 300
    cfg.PARALLEL.DTYPE = "float32"
    cfg.TEST.TEST_BBOX_TYPE = "gt"
    cfg.TEST.ROI_BATCH_SIZE = 4
    cfg.VAL.ERROR_TYPES = "ad,rete,proj,vsd,mssd,mspd"
    state_dict = init_weights(build_model(cfg, device="cpu"),
                              torch.Generator().manual_seed(0)).state_dict()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for device in ("cuda", "cpu"):
            model = build_model(cfg, device=device)
            model.load_state_dict(state_dict)
            kernels.nn_min_dist.launches = kernels.rasterize_xyz.launches = 0
            res = do_test(cfg, model, models, records, output_dir=str(tmp_path / device),
                          device=device)
            runs[device] = res, (kernels.nn_min_dist.launches, kernels.rasterize_xyz.launches)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (card, launches), (cpu, cpu_launches) = runs["cuda"], runs["cpu"]
    assert min(launches) >= 1 and cpu_launches == (0, 0), (launches, cpu_launches)
    from gdrnet_tpu_torch.eval.bop_writer import load_bop_results

    rows = [load_bop_results(r["_csv_path"]) for r in (card, cpu)]
    assert len(rows[0]) == len(rows[1]) == len(records)
    for a, b in zip(*rows):
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-3)
        np.testing.assert_allclose(a["t"], b["t"], rtol=1e-3, atol=1e-3)
    from gdrnet_tpu_torch.eval.custom_evaluator import RECALL_KEYS

    for name in cpu:
        if not name.startswith("_"):
            assert {k: card[name][k] for k in RECALL_KEYS} == {k: cpu[name][k] for k in RECALL_KEYS}
    assert card["_bop"] == cpu["_bop"]


# ---------------------------------------------------------------------------
# serving from images: the int8 product, gen_xyz and predict on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stem_k147_s2_p3", "head_3x3_256", "downsample_1x1_s2",
                                  "linear_8192", "linear_rows_5"])
def test_int8_product_on_the_card_equals_the_plain_version(cuda_device, case):
    """im2col and torch._int_mm on the card against the float64 product on
    the CPU, for the same int8 inputs: bitwise (both are exact)."""
    from gdrnet_tpu_torch.models import quantize as Q

    g = torch.Generator().manual_seed(len(case))
    if case.startswith("linear"):
        rows, k, n = (5, 1024, 256) if case == "linear_rows_5" else (64, 8192, 1024)
        x = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        got = Q.int8_linear(x.to(cuda_device), w.to(cuda_device))
        want = Q.int8_linear(x, w)
    else:
        c, o, k, s, p, hw = {"stem_k147_s2_p3": (3, 64, 7, 2, 3, 64),
                             "head_3x3_256": (256, 256, 3, 1, 1, 32),
                             "downsample_1x1_s2": (64, 128, 1, 2, 0, 31)}[case]
        x = torch.randint(-127, 128, (3, c, hw, hw), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8)
        got = Q.int8_conv2d(x.to(cuda_device), w.to(cuda_device), (s, s), (p, p))
        want = Q.int8_conv2d(x, w, (s, s), (p, p))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gen_xyz_on_the_card_equals_the_cpu(zoo_train_split):
    """The zoo split's xyz_crop pickles written on the card and on the CPU:
    bitwise equal (B2 is bitwise equal to its plain version)."""
    import shutil

    from gdrnet_tpu_torch.tools.gen_xyz import gen_split_xyz

    records, models, _ = zoo_train_split
    meta = models.meta
    split = Path(meta.data_root) / "train"
    written = {}
    for device in ("cuda", "cpu"):
        before = kernels.rasterize_attr.launches
        n = gen_split_xyz(meta, "train", overwrite=True, device=device)
        launches = kernels.rasterize_attr.launches - before
        assert (launches > 0) == (device == "cuda")
        written[device] = {p.relative_to(split): p.read_bytes()
                           for p in sorted(split.glob("*/xyz_crop/*.pkl"))}
    for scene in split.glob("*/xyz_crop"):  # leave the split without pickles
        shutil.rmtree(scene)
    assert n == len(written["cpu"]) >= len(records)
    assert written["cuda"] == written["cpu"]


@pytest.mark.cuda
def test_predict_on_the_card_equals_the_cpu(tmp_path):
    """The predict CLI over a zoo test split in f32 (TF32 off), on the card
    and on the CPU, from one .pth: rows equal in order, poses within 1e-3."""
    import json

    from gdrnet_tpu_torch import merged_config
    from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
    from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch, write_bop_split
    from gdrnet_tpu_torch.eval.bop_writer import load_bop_results
    from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
    from gdrnet_tpu_torch.tools import predict

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    repo = Path(__file__).resolve().parents[1]
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    p = synthetic_roi_batch(batch_size=8, input_res=8, out_res=4, num_classes=10, seed=6)
    t = p["gt_trans"].copy()
    t[:, :2] = np.random.RandomState(3).uniform(-0.08, 0.08, (8, 2))
    t[:, 2] += 0.4
    meta, _ = write_bop_split(str(tmp_path / "zoo"), gsd.mesh_zoo(), np.arange(8) % 10,
                              p["gt_ego_rot"], t, K, width=320, height=240, per_image=4,
                              images_per_scene=2, device="cuda")
    dets = {}
    for r in load_bop_scene_dicts(meta, "test"):
        dets.setdefault(f"{r['scene_id']}/{r['im_id']}", []).append(
            {"obj_id": int(r["obj_id"]), "bbox_est": [float(v) for v in r["bbox_visib"]],
             "score": 0.9})
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(
        f"_base_ = [{str(repo / 'configs/gdrn/synth/a6_cPnP_synth.py')!r}]\n"
        "MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=64, OUTPUT_RES=16),\n"
        "    ROT_HEAD=dict(NUM_FILTERS=32, NUM_REGIONS=8),\n"
        "    PNP_NET=dict(PNP_HEAD_CFG=dict(featdim=32), NUM_PM_POINTS=300)))\n"
        "PARALLEL = dict(DTYPE='float32')\nTEST = dict(ROI_BATCH_SIZE=4)\n")
    cfg = merged_config(str(cfg_path))
    torch.save({"model": init_weights(build_model(cfg, device="cpu"),
                                      torch.Generator().manual_seed(0)).state_dict()},
               tmp_path / "w.pth")
    argv = ["--config-file", str(cfg_path), "--ckpt", str(tmp_path / "w.pth"), "--dataset",
            "zoo", "--data-root", str(tmp_path), "--dets", str(tmp_path / "dets.json"),
            "--image-root", str(tmp_path / "zoo" / "test")]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            predict.main(argv + ["--out", str(tmp_path / f"{device}.csv")], device=device)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    card, cpu = (load_bop_results(str(tmp_path / f"{d}.csv")) for d in ("cuda", "cpu"))
    assert len(card) == len(cpu) == sum(len(v) for v in dets.values())
    assert [(r["scene_id"], r["im_id"], r["obj_id"]) for r in card] == \
        [(r["scene_id"], r["im_id"], r["obj_id"]) for r in cpu]
    np.testing.assert_allclose(np.stack([r["R"] for r in card]),
                               np.stack([r["R"] for r in cpu]), atol=1e-3)
    t_card, t_cpu = (np.stack([r["t"] for r in rows]) for rows in (card, cpu))
    assert (np.linalg.norm(t_card - t_cpu, axis=1) / np.linalg.norm(t_cpu, axis=1)).max() < 1e-3


def _small_variant_cfg(*overrides: str):
    from gdrnet_tpu_torch import merged_config
    from gdrnet_tpu_torch.config.config import apply_opts

    cfg = merged_config(str(Path(__file__).resolve().parents[1]
                            / "configs/gdrn/synth/a6_cPnP_synth.py"))
    apply_opts(cfg, ["MODEL.CDPN.BACKBONE.INPUT_RES=64", "MODEL.CDPN.BACKBONE.OUTPUT_RES=16",
                     "MODEL.CDPN.ROT_HEAD.NUM_FILTERS=32", "MODEL.CDPN.ROT_HEAD.NUM_REGIONS=8",
                     "PARALLEL.DTYPE='float32'", *overrides])
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [
    ("MODEL.CDPN.BACKBONE.NUM_LAYERS=50", "MODEL.CDPN.PNP_NET.R_ONLY=True",
     "MODEL.CDPN.PNP_NET.ROT_TYPE='allo_lie_vec'"),
    ("MODEL.CDPN.PNP_NET.PNP_HEAD_CFG.type='PointPnPNet'",
     "MODEL.CDPN.PNP_NET.ROT_TYPE='ego_quat'")])
def test_variant_forward_on_the_card_equals_the_cpu(cuda_device, overrides):
    """A variant's f32 forward (TF32 off) on the card against the CPU, from
    one seeded init: the [forward_f32] gate of chip_smoke.py."""
    from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
    from gdrnet_tpu_torch.engine.steps import make_predict_step
    from gdrnet_tpu_torch.models.gdrn import build_model, init_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_variant_cfg(*overrides)
    sd = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_roi_batch(batch_size=4, input_res=64, out_res=16, num_classes=10, seed=3)
    outs = []
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(sd)
        out = make_predict_step(model)({k: torch.from_numpy(v).to(device)
                                        for k, v in batch.items()})
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    np.testing.assert_allclose(outs[0]["rot"], outs[1]["rot"], atol=1e-3)
    np.testing.assert_allclose(outs[0]["trans"], outs[1]["trans"], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AdamP", "Ranger2020", "RMSprop"])
def test_zoo_update_on_the_card_equals_the_cpu(cuda_device, name):
    """One update of a zoo optimizer from the same gradients on the card and
    on the CPU, rtol 1e-4 of each tensor's largest step (plus one f32 ulp of
    the parameter)."""
    from gdrnet_tpu_torch.models.gdrn import build_model, init_weights
    from gdrnet_tpu_torch.solver.optimizers import build_optimizer

    cfg = _small_variant_cfg()
    cfg.SOLVER.OPTIMIZER_CFG = dict(type=name, lr=1e-3, weight_decay=0.01)
    sd = init_weights(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0)).state_dict()
    g = torch.Generator().manual_seed(1)
    updates = []
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(sd)
        g.manual_seed(1)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g).to(device)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        build_optimizer(cfg, model).step()
        updates.append({k: (p.detach() - before[k]).cpu() for k, p in model.named_parameters()})
    for k, want in updates[1].items():
        scale = float(want.abs().max())
        ulp = 2.0 ** -23 * float(sd[k].abs().max())  # the update is read as after - before
        np.testing.assert_allclose(updates[0][k].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale + ulp, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", device_pnp.MODES)
def test_device_pnp_on_the_card_equals_the_cpu(cuda_device, mode):
    """pnp_from_maps_batch on the card against the CPU with the same minimal
    sets (16 ROIs of 64x64 maps, 0.5 px noise, net poses ~3 cm off): every
    refined pose within 0.05 degrees and 5e-4 m (the JAX package's
    clean-data floor), the padding row's net pose kept bitwise."""
    rng = np.random.RandomState(4)
    mask, xyzn, c2d, R, t, K, ext, (W, H) = synthetic_decoded_maps(rng, 16, noise_px=0.5,
                                                                   t_jitter=0.02)
    valid = np.ones(16, bool)
    valid[-1] = False
    host = {"mask_prob": mask, "xyz_norm": xyzn, "coord2d": c2d,
            "im_wh": np.tile([[W, H]], (16, 1)).astype(np.float32),
            "extents": np.tile(ext, (16, 1)), "Ks": np.tile(K, (16, 1, 1)), "rot_net": R,
            "trans_net": (t + [0.02, -0.01, 0.02]).astype(np.float32), "roi_valid": valid}
    w = device_pnp.correspondence_weights(*(torch.from_numpy(host[k]) for k in (
        "mask_prob", "xyz_norm", "coord2d", "im_wh", "extents")))[2]
    idx = device_pnp.draw_samples(w, 64, 6, torch.Generator().manual_seed(1))
    got = {}
    for d in (cuda_device, torch.device("cpu")):
        Rd, td = device_pnp.pnp_from_maps_batch(
            **{k: torch.from_numpy(np.ascontiguousarray(v)).to(d) for k, v in host.items()},
            mode=mode, sample_idx=idx)
        assert Rd.device.type == d.type
        got[d.type] = (Rd.cpu().numpy().astype(np.float64), td.cpu().numpy())
    (Rc, tc), (Rp, tp) = got["cuda"], got["cpu"]
    M = np.swapaxes(Rc, 1, 2) @ Rp
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    deg = np.degrees(np.arctan2(np.linalg.norm(v / 2, axis=-1),
                                (np.trace(M, axis1=1, axis2=2) - 1) / 2))
    assert deg.max() < 0.05 and np.abs(tc - tp).max() < 5e-4
    np.testing.assert_array_equal(Rc[-1], R[-1])
    np.testing.assert_array_equal(tc[-1], host["trans_net"][-1])


# ---------------------------------------------------------------------------
# parallel/sync_bn.py: two gloo ranks on the one card
# ---------------------------------------------------------------------------

SYNC_BN_CASES = {"momentum": dict(momentum=0.1, passes=2), "cumulative": dict(momentum=None,
                                                                             passes=3)}


@pytest.mark.cuda
def test_sync_bn_two_ranks_on_the_card_match_one_process(cuda_device, tmp_path):
    """SyncBatchNorm2d over [8, 64, 16, 16] in two gloo ranks on the card
    (4 rows each) against nn.BatchNorm2d (cuDNN) on the 8 rows, with torch's
    momentum and with the cumulative average (precise BN): outputs, the
    input's and the affine gradients and the running buffers within 1e-5
    (the two sum in other orders: cuDNN's Welford against two passes), the
    buffers equal on both ranks."""
    from torch_ddp_worker import run_ranks

    rng = np.random.RandomState(0)
    c = 64
    x = (rng.randn(8, c, 16, 16) * 2.0 + 0.5).astype(np.float32)
    dy = rng.randn(8, c, 16, 16).astype(np.float32)
    state = {"weight": (1.0 + 0.1 * rng.randn(c)).astype(np.float32),
             "bias": (0.1 * rng.randn(c)).astype(np.float32),
             "running_mean": (0.1 * rng.randn(c)).astype(np.float32),
             "running_var": (rng.rand(c) + 0.5).astype(np.float32),
             "num_batches_tracked": np.array(3, np.int64)}
    ranks = run_ranks(tmp_path, [("sync_bn", dict(x=x, dy=dy, state=state, device="cuda", **kw))
                                 for kw in SYNC_BN_CASES.values()])
    for i, kw in enumerate(SYNC_BN_CASES.values()):
        bn = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=kw["momentum"]).to(cuda_device)
        bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        bn.train()
        for p in range(kw["passes"]):
            xt = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
            bn.zero_grad()
            y = bn(xt)
            (y * torch.from_numpy(dy).to(cuda_device)).sum().backward()
            want = {"y": y.detach().cpu().numpy(), "dx": xt.grad.cpu().numpy(),
                    "dw": bn.weight.grad.cpu().numpy(), "db": bn.bias.grad.cpu().numpy()}
            for results in ranks:
                got = results[i]
                lo, hi = got["rows"]
                g = got["passes"][p]
                for k in ("y", "dx"):
                    np.testing.assert_allclose(g[k], want[k][lo:hi], rtol=0, atol=1e-5, err_msg=k)
                for k in ("dw", "db"):
                    np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)
                for k, v in bn.state_dict().items():
                    np.testing.assert_allclose(g["buffers"][k], v.cpu().numpy(), rtol=0,
                                               atol=1e-5, err_msg=k)
        a, b = (r[i]["passes"][-1]["buffers"] for r in ranks)
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(cuda_device):
    """The dry run's default device: two gloo ranks on the card (card r
    modulo the cards there are) against one process on the first, f32 with
    TF32 off, loss terms within the dry run's rtol 1e-4."""
    import json

    from gdrnet_tpu_torch.tools import dryrun_multichip

    proc = subprocess.run([sys.executable, "-m", "gdrnet_tpu_torch.tools.dryrun_multichip",
                           "--nproc", "2"], capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=dryrun_multichip.PACKAGE_ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    assert res["ok"] and res["device"] == "cuda" and res["ranks_equal"]


# ---------------------------------------------------------------------------
# the bench leg and the serving tools on the card (plain PyTorch, no kernel
# of their own)
# ---------------------------------------------------------------------------

SMALL_TOOL_CFG = (
    "MODEL = dict(CDPN=dict(BACKBONE=dict(NUM_LAYERS=18, INPUT_RES=64, OUTPUT_RES=16),\n"
    "    ROT_HEAD=dict(NUM_FILTERS=32, NUM_REGIONS=8),\n"
    "    PNP_NET=dict(PNP_HEAD_CFG=dict(featdim=32), NUM_PM_POINTS=300)))\n")


@pytest.mark.cuda
@pytest.mark.parametrize("path", [["--bf16"], []])
def test_bench_on_the_card_prints_its_line(cuda_device, tmp_path, path):
    from gdrnet_tpu_torch.tools import bench

    (tmp_path / "cfg.py").write_text(SMALL_TOOL_CFG)
    rec = bench.main(["--config", str(tmp_path / "cfg.py"), "--batch", "64", "--iters", "3"]
                     + path)
    assert rec["metric"] == "roi_pose_crops_per_sec_per_chip" and rec["value"] > 0
    if not path:
        assert np.isfinite(rec["int8_rot_drift_deg_mean"])
        assert np.isfinite(rec["int8_trans_rel_drift_max"])


@pytest.mark.cuda
def test_bench_train_audit_on_the_card_gives_shares_of_the_peaks(cuda_device, monkeypatch):
    """The audit's mfu and hbm_frac on the card lie in (0, 1], beside the
    card's name and power limit."""
    from gdrnet_tpu_torch.tools import bench_train

    plain = bench_train.step_config

    def small():
        cfg = plain()
        net = cfg.MODEL.CDPN
        net.BACKBONE.NUM_LAYERS, net.BACKBONE.INPUT_RES, net.BACKBONE.OUTPUT_RES = 18, 64, 16
        net.ROT_HEAD.NUM_FILTERS, net.PNP_NET.PNP_HEAD_CFG.featdim = 32, 32
        net.PNP_NET.NUM_PM_POINTS = 300
        return cfg

    monkeypatch.setattr(bench_train, "step_config", small)
    (row,) = bench_train.main(["--audit", "--batch-sizes", "32", "--iters", "3"])
    assert 0 < row["mfu"] <= 1 and 0 < row["hbm_frac"] <= 1 and row["backend"] == "cuda"
    assert row["card"] == torch.cuda.get_device_name(0) and row["power_limit"]
    (step,) = bench_train.main(["--batch-sizes", "32", "--iters", "3"])
    assert step["value"] > 0 and np.isfinite(step["loss"])


class UpsampleDtypes(TorchDispatchMode):
    """The input dtype of every upsample_bilinear2d op run under it."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "upsample_bilinear2d" in str(func):
            self.dtypes.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_export_on_the_card_loads_in_a_torch_only_process(cuda_device, tmp_path, int8):
    """The artifact exported on the card (bf16 autocast, or int8 on
    torch._int_mm) runs in a child process that imports only torch, and
    gives the in-process forward's poses bit for bit, under the same TF32
    settings; loaded here, every upsample_bilinear2d in it takes the dtype
    the eager forward's takes. CUDA autocast casts the eager upsample's
    input to f32, while torch.export retraces the op as
    upsample_bilinear2d.vec, which autocast leaves in bf16: without the
    head's own cast (models/layers.UpsampleBilinear2x) the exported
    upsample is a bf16 op one ulp off the eager one, and an int8 layer
    after it rounds some inputs the other way (chip_smoke.py's [export]
    holds both artifacts to the eager forward at the flagship's width)."""
    from gdrnet_tpu_torch.tools import export_model

    (tmp_path / "cfg.py").write_text(SMALL_TOOL_CFG + "PARALLEL = dict(DTYPE='bfloat16')\n")
    out = str(tmp_path / "m.pt2")
    export_model.main(["--out", out, "--config", str(tmp_path / "cfg.py"), "--batch", "32"]
                      + (["--int8"] if int8 else []))
    cfg = export_model.export_config(str(tmp_path / "cfg.py"))
    from gdrnet_tpu_torch.models.gdrn import build_model, init_weights

    model = init_weights(build_model(cfg, device="cuda"), torch.Generator().manual_seed(0))
    batch = export_model.export_batch(cfg, 32, "cuda")
    args = [batch[k] for k in export_model.ARG_NAMES]
    eager, exported = UpsampleDtypes(), UpsampleDtypes()
    with torch.no_grad():
        fwd = export_model.serving_forward(model, batch, int8=int8)  # int8: calibrates here
        with eager:
            rot, trans = fwd(*args)
        with exported:
            torch.export.load(out).module()(*args)
    assert eager.dtypes and exported.dtypes == eager.dtypes
    np.savez(tmp_path / "args.npz", *[batch[k].cpu().numpy() for k in export_model.ARG_NAMES])
    child = (  # under this process's TF32 settings: an exported program records none
        "import sys, numpy as np, torch\n"
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}\n"
        f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}\n"
        f"fwd = torch.export.load({out!r}).module()\n"
        f"a = np.load({str(tmp_path / 'args.npz')!r})\n"
        "with torch.no_grad():\n"
        "    r, t = fwd(*[torch.from_numpy(a[f'arr_{i}']).cuda() for i in range(8)])\n"
        "assert 'gdrnet_tpu_torch' not in sys.modules\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, r=r.float().cpu().numpy(), "
        "t=t.float().cpu().numpy())\n")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    assert np.array_equal(got["r"], rot.float().cpu().numpy())
    assert np.array_equal(got["t"], trans.float().cpu().numpy())


@pytest.mark.cuda
def test_pvnet_on_the_card_equals_the_cpu(cuda_device):
    """PVNet-34 at 64x64 in f32 with TF32 off: every output within 1e-3 of
    the CPU's."""
    from gdrnet_tpu_torch.models import PVNet

    net = PVNet(depth=34)
    for p in net.parameters():
        p.data.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(p.numel()))
    net.eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = net(x)
            got = net.to(cuda_device)(x.to(cuda_device))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["lattice_17", "cylinder_96x40"])
def test_device_fps_on_the_card_equals_numpy(cuda_device, cloud):
    """Index for index at K=256 from each start, with no host sync in the
    loop (sync debug mode "error" raises on one)."""
    pts = lattice_cloud(17) if cloud == "lattice_17" else cylinder_cloud(96, 40)
    on_card = torch.from_numpy(pts).to(cuda_device)
    for init_center, start_idx in ((True, 0), (False, 0), (False, 7)):
        want = fps.farthest_point_sampling_np_idx(pts, 256, init_center, start_idx)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fps.farthest_point_sampling_idx(on_card, 256, init_center, start_idx)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert got.device.type == "cuda" and got.dtype == torch.int64
        np.testing.assert_array_equal(got.cpu().numpy(), want)
