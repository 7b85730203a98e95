"""The CUDA kernels of gdrnet_tpu_torch against their plain PyTorch versions:
nn_min_dist (B1) and rasterize_xyz (B2, with XYZ and with 12 per-pose
attribute channels), B2 under the train mapper (renders on the card equal
to the CPU's, from loader-like threads on their own streams beside train
steps) and under the dataset generator's phong+XYZ pass.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. This file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py does import JAX, so on such a machine run it as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os.path as osp
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from gdrnet_tpu_torch.data.synthetic import edge_on_poses, sliver_mesh
from gdrnet_tpu_torch.ops import kernels
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
