"""The port's JPEG codec (csrc/jpeg_codec.cpp through data/jpeg.py) against
OpenCV 5.0's cv2 (libjpeg-turbo 3.1.2), and the paths that read JPEGs
against the JAX package, on the CPU.

Everything is bit for bit: decodes equal cv2.imdecode / cv2.imread with
IMREAD_COLOR and IMREAD_GRAYSCALE (EXIF orientations, progressive streams,
CMYK and YCCK included), encodes are byte-equal to cv2.imencode, the case
digests of data/jpeg_cases.py and its committed streams equal what cv2 and
PIL write and decode, and the train mapper over a PBR split of JPEG frames
with JPEG VOC backgrounds, the render-folder datasets and the BOP PBR names
equal the JAX package's. The processes the codec refuses raise
NotImplementedError naming them; corrupt and truncated streams ValueError.
"""

import dataclasses
import io
import json
import os
import os.path as osp
import pickle
import shutil
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from gdrnet_tpu.data import augment as jaug
from gdrnet_tpu.data import bop as jbop
from gdrnet_tpu.data import dataset_factory as jfactory
from gdrnet_tpu.data import io as jio
from gdrnet_tpu.data import mapper as jmapper
from gdrnet_tpu.data import model_store as jmodel_store
from gdrnet_tpu.data import render_dataset as jrender

from gdrnet_tpu_torch import csrc
from gdrnet_tpu_torch.config.config import load_config
from gdrnet_tpu_torch.data import augment, bop, dataset_factory, io as pio, jpeg, jpeg_cases
from gdrnet_tpu_torch.data import mapper, model_store, ref_meta, render_dataset
from fixture_bop import build_fixture_dataset
from torch_parity import REPO, small_flagship_cfg

LMO_CONFIG = REPO / "configs/gdrn/lmo/a6_cPnP_AugAAETrunc_BG0.5_lmo_real_pbr0.1_40e.py"
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (7, 9), (33, 17), (16, 16), (47, 61), (3, 4)]
QUALITIES = [50, 75, 95, 100]


def _image(rng, h, w, gray):
    """Smooth content with noise, as a camera frame compresses."""
    base = rng.randint(0, 256, (h // 6 + 2, w // 6 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img.astype(int) + rng.randint(-25, 26, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0].copy() if gray else img


def _cv2_encode(img, quality, sampling="420", restart=0, **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for k, v in extra.items():
        params += [getattr(cv2, k), v]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def _assert_decodes_as_cv2(data, label):
    for flags, cv_flags in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv_flags)
        got = jpeg.decode_jpeg(data, flags)
        assert got.dtype == np.uint8 and got.shape == want.shape, (label, flags)
        np.testing.assert_array_equal(got, want, err_msg=f"{label} {flags}")


@pytest.mark.parametrize("sampling", ["420", "422", "444", "440", "411", "gray"])
def test_decode_equals_cv2(sampling, tmp_path):
    rng = np.random.RandomState(sum(map(ord, sampling)))
    for h, w in SIZES:
        for q in QUALITIES:
            img = _image(rng, h, w, sampling == "gray")
            _assert_decodes_as_cv2(_cv2_encode(img, q, sampling), f"{w}x{h} q{q}")
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, _image(rng, 75, 101, sampling == "gray"), [cv2.IMWRITE_JPEG_QUALITY, 90])
    for fmt in ("BGR", "RGB"):
        np.testing.assert_array_equal(pio.load_im(path, fmt), jio.load_im(path, fmt))
    np.testing.assert_array_equal(mapper.read_gray_image(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("sampling", ["420", "422", "444", "440", "411", "gray"])
def test_encode_equals_cv2(sampling):
    rng = np.random.RandomState(7 + sum(map(ord, sampling)))
    for h, w in SIZES:
        for q in QUALITIES:
            for restart in (0, 2):
                img = _image(rng, h, w, sampling == "gray")
                got = jpeg.encode_jpeg(img, q, "420" if sampling == "gray" else sampling, restart)
                assert got == _cv2_encode(img, q, sampling, restart), (w, h, q, restart)


def _pil(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img[..., ::-1] if img.ndim == 3 else img).save(bio, "JPEG", **kw)
    return bio.getvalue()


def _cmyk(img, **kw):
    """PIL's CMYK JPEG (Adobe's inverted CMYK, APP14 transform 0) of a BGR
    image with a K channel made from its flipped blue channel."""
    cmyk = np.ascontiguousarray(np.concatenate([img, img[::-1, :, :1]], axis=-1))
    bio = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(bio, "JPEG", **kw)
    return bio.getvalue()


def _exif(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


VARIANTS = {
    "restart_1": lambda img: _cv2_encode(img, 90, restart=1),
    "restart_7_444": lambda img: _cv2_encode(img, 80, "444", restart=7),
    "optimize": lambda img: _cv2_encode(img, 85, IMWRITE_JPEG_OPTIMIZE=1),
    "optimize_gray": lambda img: _cv2_encode(img[..., 1].copy(), 60, IMWRITE_JPEG_OPTIMIZE=1),
    "pil_444": lambda img: _pil(img, quality=90, subsampling=0),
    "pil_422": lambda img: _pil(img, quality=35, subsampling=1),
    "pil_420_optimize_dpi": lambda img: _pil(img, quality=80, optimize=True, dpi=(300, 300)),
    "pil_gray": lambda img: _pil(img[..., 2].copy(), quality=70),
    "exif_3": lambda img: _pil(img, quality=85, exif=_exif(3)),
    "exif_6": lambda img: _pil(img, quality=85, exif=_exif(6)),
    "exif_8": lambda img: _pil(img, quality=85, exif=_exif(8)),
    "exif_6_gray": lambda img: _pil(img[..., 0].copy(), quality=85, exif=_exif(6)),
    "progressive": lambda img: _cv2_encode(img, 90, IMWRITE_JPEG_PROGRESSIVE=1),
    "progressive_444_restart_3": lambda img: _cv2_encode(img, 80, "444", restart=3,
                                                         IMWRITE_JPEG_PROGRESSIVE=1),
    "progressive_gray_optimize": lambda img: _cv2_encode(img[..., 1].copy(), 65,
                                                         IMWRITE_JPEG_PROGRESSIVE=1,
                                                         IMWRITE_JPEG_OPTIMIZE=1),
    "pil_progressive_422_exif_8": lambda img: _pil(img, quality=60, subsampling=1,
                                                   progressive=True, exif=_exif(8)),
    "pil_cmyk": lambda img: _cmyk(img, quality=90),
    "pil_cmyk_progressive_420": lambda img: _cmyk(img, quality=70, subsampling=2,
                                                  progressive=True),
    "ycck": lambda img: jpeg_cases.to_ycck(_cmyk(img, quality=85)),
    "cmyk_exif_6": lambda img: _cmyk(img, quality=85, exif=_exif(6)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_variants_equal_cv2(variant, tmp_path):
    """Restart intervals, optimized Huffman tables, PIL's writer (its own
    header and tables), EXIF orientations, progressive streams, CMYK and
    YCCK, through imdecode and through a file read by both packages."""
    img = _image(np.random.RandomState(len(variant)), 77, 123, gray=False)
    data = VARIANTS[variant](img)
    _assert_decodes_as_cv2(data, variant)
    path = tmp_path / "frame.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(pio.load_im(str(path)), jio.load_im(str(path)))


# SOF markers of the processes the codec refuses, by the name its error gives
REFUSED_SOF = {b"\xc3": "lossless", b"\xc5": "hierarchical", b"\xc6": "hierarchical",
               b"\xc7": "hierarchical", b"\xc9": "arithmetic-coded",
               b"\xca": "arithmetic-coded", b"\xcb": "arithmetic-coded",
               b"\xcd": "hierarchical arithmetic-coded", b"\xce": "hierarchical arithmetic-coded",
               b"\xcf": "hierarchical arithmetic-coded"}


def _scans_cut(data, keep):
    """A progressive stream cut before its scan number `keep` (and the DHT
    before it), with an EOI: a scan script that leaves coefficients
    unrefined."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data.rfind(b"\xff\xc4", sos[keep - 1], sos[keep])
    return data[:cut if cut > 0 else sos[keep]] + b"\xff\xd9"


def test_unsupported_and_corrupt_streams(tmp_path):
    """The processes still refused raise NotImplementedError naming them,
    from every reader, and the background reader does not take them as a
    corrupt file; a corrupt or truncated stream, baseline or progressive,
    raises ValueError, which the background reader takes as cv2's None."""
    img = _image(np.random.RandomState(3), 40, 56, gray=False)
    data = _cv2_encode(img, 90)
    sof = data.index(b"\xff\xc0")
    refused = {f"sof_{m.hex()}": (data[:sof + 1] + m + data[sof + 2:], name)
               for m, name in REFUSED_SOF.items()}
    # SOF1 (extended sequential) with 12-bit samples
    refused["12_bit"] = (data[:sof + 1] + b"\xc1" + data[sof + 2:sof + 4] + b"\x0c"
                         + data[sof + 5:], "12-bit JPEG")
    prog = _cv2_encode(img, 90, IMWRITE_JPEG_PROGRESSIVE=1)
    for keep in (1, 5, 9):  # libjpeg outputs these through its block smoothing
        refused[f"scans_{keep}"] = (_scans_cut(prog, keep), "block smoothing")
        assert cv2.imdecode(np.frombuffer(_scans_cut(prog, keep), np.uint8),
                            cv2.IMREAD_COLOR) is not None
    for label, (stream, name) in refused.items():
        path = tmp_path / f"{label}.jpg"
        path.write_bytes(stream)
        for read in (jpeg.read_jpeg, pio.load_im, augment.BackgroundReplacer._read):
            with pytest.raises(NotImplementedError, match=f"{name}.*arithmetic-coded, 12-bit"):
                read(str(path))
        with pytest.raises(NotImplementedError, match=str(path)):
            pio.read_image(str(path), "gray")
    for stream in (data, prog):
        for cut in (len(stream) // 2, len(stream) - 2, 40):
            bad = tmp_path / f"cut{cut}.jpg"
            bad.write_bytes(stream[:cut])
            # cv2.imdecode gives None on a cut baseline stream; cv2.imread
            # pads a truncated file with grey after a warning; the port
            # raises ValueError, which the background reader takes as None
            if stream is data:
                assert cv2.imdecode(np.frombuffer(stream[:cut], np.uint8), cv2.IMREAD_COLOR) is None
            with pytest.raises(ValueError):
                jpeg.read_jpeg(str(bad))
            assert augment.BackgroundReplacer._read(str(bad)) is None
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        (tmp_path / "x.jpg").write_bytes(b"GIF89a")
        pio.load_im(str(tmp_path / "x.jpg"))


def test_readers_take_progressive_and_cmyk_files(tmp_path):
    """data/io.read_image in both modes and the background reader read a
    progressive and a CMYK file as cv2.imread does, and the background
    replacer draws from them what the JAX package's draws."""
    img = _image(np.random.RandomState(9), 75, 101, gray=False)
    files = {"progressive": _cv2_encode(img, 88, "422", IMWRITE_JPEG_PROGRESSIVE=1),
             "cmyk": _cmyk(img, quality=80, progressive=True)}
    for label, stream in files.items():
        path = str(tmp_path / f"{label}.jpg")
        with open(path, "wb") as f:
            f.write(stream)
        for flags, cv_flags in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            np.testing.assert_array_equal(pio.read_image(path, flags), cv2.imread(path, cv_flags),
                                          err_msg=f"{label} {flags}")
        np.testing.assert_array_equal(augment.BackgroundReplacer._read(path),
                                      cv2.imread(path, cv2.IMREAD_COLOR), err_msg=label)
        jbg, pbg = jaug.BackgroundReplacer(str(tmp_path)), augment.BackgroundReplacer(str(tmp_path))
        jbg.paths, pbg.paths = [path], [path]
        np.testing.assert_array_equal(pbg.get_bg(np.random.RandomState(1), 60, 80),
                                      jbg.get_bg(np.random.RandomState(1), 60, 80), err_msg=label)


def writer_stream(case) -> bytes:
    """The case's stream as cv2 or PIL writes it (data/jpeg_cases.py's
    processes)."""
    if case.process.startswith("ycck"):
        cmyk = next(c for c in jpeg_cases.CASES if c.name == case.name.replace("ycck", "cmyk"))
        return jpeg_cases.to_ycck(writer_stream(cmyk))
    img = jpeg_cases.case_image(case)
    if case.process.startswith("cmyk"):
        bio = io.BytesIO()
        Image.fromarray(img, "CMYK").save(bio, "JPEG", quality=case.quality,
                                          subsampling={"444": 0, "420": 2}[case.sampling],
                                          progressive=case.process == "cmyk_progressive")
        return bio.getvalue()
    extra = {}
    if case.process.startswith("progressive"):
        extra["IMWRITE_JPEG_PROGRESSIVE"] = 1
    if case.process == "progressive_optimize":
        extra["IMWRITE_JPEG_OPTIMIZE"] = 1
    return _cv2_encode(img, case.quality, "420" if case.sampling == "gray" else case.sampling,
                       case.restart, **extra)


def _cv2_decode(data, flags):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR if flags == "color" else cv2.IMREAD_GRAYSCALE)


def write_streams() -> None:
    """Writes jpeg_cases.STREAM_DIR's files, the streams that the port's
    encoder does not write, from cv2 and PIL: run
    `python -c "import sys; sys.path.insert(0, 'tests'); import test_torch_jpeg as t;
    t.write_streams()"` from the repository's root."""
    jpeg_cases.STREAM_DIR.mkdir(exist_ok=True)
    for case in jpeg_cases.CASES:
        if case.process not in ("baseline", "ycck", "ycck_progressive"):
            (jpeg_cases.STREAM_DIR / f"{case.name}.jpg").write_bytes(writer_stream(case))


def test_case_digests_equal_cv2():
    """data/jpeg_cases.py's digests, regenerated from cv2 (streams written by
    cv2 and PIL, decoded by cv2), and the port's; the committed streams are
    the writers' bytes."""
    want = jpeg_cases.digests(writer_stream, _cv2_decode)
    assert len(jpeg_cases.CASES) == 81
    assert {c.process for c in jpeg_cases.CASES} == set(jpeg_cases.PROCESSES)
    assert want == jpeg_cases.DIGESTS
    assert jpeg_cases.port_digests() == jpeg_cases.DIGESTS
    files = sorted(p.name for p in jpeg_cases.STREAM_DIR.iterdir())
    assert files == sorted(f"{c.name}.jpg" for c in jpeg_cases.CASES
                           if c.process not in ("baseline", "ycck", "ycck_progressive"))


@pytest.mark.parametrize("process", [p for p in jpeg_cases.PROCESSES if p != "baseline"])
def test_stream_cases_decode_as_cv2(process):
    """Each progressive, CMYK and YCCK case: the committed stream is the
    writer's, and both decodes equal cv2.imdecode's."""
    cases = [c for c in jpeg_cases.CASES if c.process == process]
    assert cases
    for case in cases:
        data = jpeg_cases.case_stream(case)
        assert data == writer_stream(case), case.name
        _assert_decodes_as_cv2(data, case.name)


def test_load_im_goes_by_signature(tmp_path):
    """cv2.imread sniffs the content: a JPEG named .png and a PNG named .jpg."""
    img = _image(np.random.RandomState(5), 30, 41, gray=False)
    (tmp_path / "a.png").write_bytes(_cv2_encode(img, 92))
    cv2.imwrite(str(tmp_path / "b.jpg.tmp.png"), img)
    os.replace(tmp_path / "b.jpg.tmp.png", tmp_path / "b.jpg")
    for name in ("a.png", "b.jpg"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(pio.load_im(path), jio.load_im(path))
        np.testing.assert_array_equal(mapper.read_color_image(path, "RGB"),
                                      jmapper.read_color_image(path, "RGB"))


def test_codec_is_exact_across_threads():
    """Four threads decode and encode at once: the same bytes as one thread,
    and the call counts exact."""
    imgs = [_image(np.random.RandomState(i), 120, 160, gray=False) for i in range(4)]
    datas = [jpeg.encode_jpeg(im, 90) for im in imgs]
    want = [jpeg.decode_jpeg(d) for d in datas]
    before = dict(jpeg.calls)
    errors = []

    def work(i):
        try:
            for _ in range(10):
                assert jpeg.encode_jpeg(imgs[i], 90) == datas[i]
                np.testing.assert_array_equal(jpeg.decode_jpeg(datas[i]), want[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert jpeg.calls["decode"] - before["decode"] == 40
    assert jpeg.calls["encode"] - before["encode"] == 40


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    monkeypatch.setattr(csrc, "_SRC_DIR", tmp_path)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        csrc.build("broken")
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# JPEG datasets: BOP PBR splits, render folders, VOC backgrounds
# ---------------------------------------------------------------------------


def _port_meta(meta):
    return ref_meta.DatasetMeta(**{f.name: getattr(meta, f.name)
                                   for f in dataclasses.fields(meta)})


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == np.asarray(want).dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _to_jpeg(png: str, quality: int = 95) -> None:
    """A frame written as BOP PBR writes it: rgb/<im>.jpg, no PNG."""
    img = cv2.imread(png, cv2.IMREAD_COLOR)
    with open(png[:-4] + ".jpg", "wb") as f:
        f.write(_cv2_encode(img, quality))
    os.remove(png)


@pytest.fixture(scope="module")
def pbr(tmp_path_factory):
    """tests/fixture_bop.py's dataset written as a train_pbr split of JPEG
    frames (with its xyz_crop pickles), a VOC_table folder of JPEG
    backgrounds at VOC's sizes, and the same split under lmo/ and ycbv/."""
    root = tmp_path_factory.mktemp("jpeg_pbr")
    jmeta = build_fixture_dataset(str(root / "fix"), n_images=4, seed=11, split="train_pbr")
    for dirpath, _, files in os.walk(root / "fix" / "train_pbr"):
        for fn in files:
            if osp.basename(dirpath) == "rgb" and fn.endswith(".png"):
                _to_jpeg(osp.join(dirpath, fn))
    voc = root / "VOCdevkit" / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.RandomState(2)
    lines = []
    for i, (h, w) in enumerate([(375, 500), (500, 375), (333, 500), (375, 500)]):
        name = f"2008_{i:06d}"
        (voc / "JPEGImages" / f"{name}.jpg").write_bytes(_cv2_encode(_image(rng, h, w, False), 90))
        lines.append(f"{name}  {1 if i != 3 else -1}")
    (voc / "ImageSets" / "Main" / "diningtable_trainval.txt").write_text("\n".join(lines) + "\n")
    for ds in ("lmo", "ycbv"):
        shutil.copytree(root / "fix" / "train_pbr", root / "bop" / ds / "train_pbr")
    return {"root": root, "jmeta": jmeta, "pmeta": _port_meta(jmeta), "voc": str(voc),
            "bop": str(root / "bop")}


@pytest.mark.parametrize("name", ["lmo_pbr_train", "ycbv_train_pbr"])
def test_pbr_jpeg_splits_resolve_as_jax(pbr, name):
    (jmeta, want), (pmeta, got) = (jfactory.resolve(name, pbr["bop"]),
                                   dataset_factory.resolve(name, pbr["bop"]))
    assert pmeta.objects == jmeta.objects and len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g["rgb_path"].endswith(".jpg") and g["img_type"] == "syn_pbr"


def _lmo_mapper_cfg():
    cfg = small_flagship_cfg()
    lmo = load_config(str(LMO_CONFIG))
    cfg.MODEL.CDPN.ROT_HEAD.NUM_CLASSES = 2
    cfg.DATASETS.SYM_OBJS = ["brick"]
    for key in ("TRUNCATE_FG", "COLOR_AUG_PROB", "COLOR_AUG_TYPE", "COLOR_AUG_CODE",
                "DZI_PAD_SCALE"):
        cfg.INPUT[key] = lmo.INPUT[key]
    cfg.INPUT.CHANGE_BG_PROB = 1.0
    return cfg


def _mappers(cfg, jmodels, pmodels, bg_root):
    np.random.seed(3)  # the code string draws np.random.rand() once
    jm = jmapper.GDRNTrainMapper(cfg, jmodels, bg_replacer=jaug.BackgroundReplacer(bg_root))
    np.random.seed(3)
    pm = mapper.GDRNTrainMapper(cfg, pmodels, bg_replacer=augment.BackgroundReplacer(bg_root),
                                device="cpu")
    return jm, pm


def test_mapper_on_jpeg_pbr_split_with_voc_backgrounds_equals_jax(pbr):
    """The LM-O config's INPUT block at CHANGE_BG_PROB=1: every sample's
    frame and background are JPEGs decoded by the codec, bit for bit."""
    cfg = _lmo_mapper_cfg()
    jmodels = jmodel_store.ObjectModels(pbr["jmeta"], num_pm_points=64, num_fps=8)
    pmodels = model_store.ObjectModels(pbr["pmeta"], num_pm_points=64, num_fps=8)
    jm, pm = _mappers(cfg, jmodels, pmodels, pbr["voc"])
    assert len(pm.bg.paths) == 3 and pm.bg.paths == jm.bg.paths
    jrecs = jbop.load_bop_scene_dicts(pbr["jmeta"], "train_pbr", img_type="syn_pbr")
    precs = bop.load_bop_scene_dicts(pbr["pmeta"], "train_pbr", img_type="syn_pbr")
    assert len(precs) == len(jrecs) >= 6
    before = jpeg.calls["decode"]
    for i, (jr, pr) in enumerate(zip(jrecs, precs)):
        assert pr["rgb_path"].endswith(".jpg")
        _assert_same(pm(dict(pr), np.random.RandomState(i)),
                     jm(dict(jr), np.random.RandomState(i)), f"record {i}")
    # a frame and a background a sample
    assert jpeg.calls["decode"] - before == 2 * len(precs)


def _write_render_folders(root, objects, n, seed):
    """tests/test_render_dataset.py's layout with box-shaped objects: per
    object renders/<obj>/{i}.jpg, {i}_mask_opengl.png, {i}_xyz_bop.pkl and
    renders/<obj>_gt.json."""
    rng = np.random.RandomState(seed)
    for obj in objects:
        obj_dir = osp.join(root, obj)
        os.makedirs(obj_dir, exist_ok=True)
        gt = {}
        for i in range(n):
            x1, y1 = rng.randint(10, 60), rng.randint(10, 40)
            w, h = rng.randint(20, 50), rng.randint(20, 40)
            img = _image(rng, 120, 160, gray=False)
            mask = np.zeros((120, 160), np.uint8)
            mask[y1:y1 + h, x1:x1 + w] = 255
            cv2.imwrite(osp.join(obj_dir, f"{i}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
            cv2.imwrite(osp.join(obj_dir, f"{i}_mask_opengl.png"), mask)
            xyz = rng.uniform(-0.03, 0.03, (h, w, 3)).astype(np.float16)
            with open(osp.join(obj_dir, f"{i}_xyz_bop.pkl"), "wb") as f:
                pickle.dump({"xyz_crop": xyz, "xyxy": (x1, y1, x1 + w - 1, y1 + h - 1)}, f)
            gt[str(i)] = [{"cam_R_m2c": np.eye(3).reshape(-1).tolist(),
                           "cam_t_m2c": [0.0, 0.0, float(rng.uniform(400, 700))],
                           "bbox_visib": [x1, y1, w, h], "visib_fract": 0.9}]
        with open(osp.join(root, f"{obj}_gt.json"), "w") as f:
            json.dump(gt, f)


@pytest.fixture(scope="module")
def render_folders(tmp_path_factory):
    """lm_renders_blender/renders and lm_imgn/imgn beside BOP_DATASETS, for
    ape, cat and eggbox (LM and LM-O objects)."""
    root = tmp_path_factory.mktemp("render_folders")
    _write_render_folders(str(root / "lm_renders_blender" / "renders"), ["ape", "cat", "eggbox"],
                          4, seed=0)
    _write_render_folders(str(root / "lm_imgn" / "imgn"), ["ape", "cat"], 3, seed=1)
    return str(root / "BOP_DATASETS")


@pytest.mark.parametrize("name", ["lm_blender_13_train", "lm_imgn_13_train_1k_per_obj",
                                  "lmo_blender_train", "lmo_blender_ape_train"])
def test_render_folders_resolve_as_jax(render_folders, name):
    (jmeta, want), (pmeta, got) = (jfactory.resolve(name, render_folders),
                                   dataset_factory.resolve(name, render_folders))
    assert pmeta.objects == jmeta.objects and len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g["rgb_path"].endswith(".jpg")


def test_render_dataset_equals_jax_on_its_fixture_layout(pbr, tmp_path):
    """load_render_folder_dicts with n_per_obj and visib_thr, then the
    mapper over its syn_blender records (JPEG frames, JPEG backgrounds)."""
    renders = str(tmp_path / "renders")
    _write_render_folders(renders, ["cube", "brick"], 5, seed=4)
    jmeta, pmeta = pbr["jmeta"], pbr["pmeta"]
    for kw in ({}, {"n_per_obj": 2}, {"visib_thr": 0.95}, {"objs": ["brick"]}):
        want = jrender.load_render_folder_dicts(jmeta, renders, **kw)
        got = render_dataset.load_render_folder_dicts(pmeta, renders, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    cfg = _lmo_mapper_cfg()
    cfg.INPUT.CHANGE_BG_PROB = 0.5
    jmodels = jmodel_store.ObjectModels(jmeta, num_pm_points=64, num_fps=8)
    pmodels = model_store.ObjectModels(pmeta, num_pm_points=64, num_fps=8)
    jm, pm = _mappers(cfg, jmodels, pmodels, pbr["voc"])
    jrecs = jrender.load_render_folder_dicts(jmeta, renders)
    precs = render_dataset.load_render_folder_dicts(pmeta, renders)
    for i, (jr, pr) in enumerate(zip(jrecs, precs)):
        _assert_same(pm(dict(pr), np.random.RandomState(i)),
                     jm(dict(jr), np.random.RandomState(i)), f"record {i}")
