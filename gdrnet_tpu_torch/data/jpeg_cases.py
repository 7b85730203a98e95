"""A seeded case list for the JPEG codec (data/jpeg.py) and the SHA-256
digests that OpenCV 5.0 with libjpeg-turbo 3.1.2 gives on it.

Each case is an image made from its own seed with numpy alone (smooth ramps
and waves, plus noise), written as a JPEG stream by its process:
  baseline              cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q,
                        IMWRITE_JPEG_SAMPLING_FACTOR, s, IMWRITE_JPEG_RST_INTERVAL,
                        r]), which the port's encoder writes byte for byte;
  progressive           the same with IMWRITE_JPEG_PROGRESSIVE=1;
  progressive_optimize  and IMWRITE_JPEG_OPTIMIZE=1;
  cmyk                  PIL 12.1's writer of a CMYK image (inverted CMYK with an
                        Adobe APP14 segment of transform 0), quality q,
                        subsampling 0 for "444" and 2 for "420";
  cmyk_progressive      the same with progressive=True;
  ycck, ycck_progressive  the stream of the cmyk case of the same name with its
                        APP14 transform byte set to 2, which libjpeg reads as
                        YCCK;
then decoded as cv2.imdecode with IMREAD_COLOR and with IMREAD_GRAYSCALE.
DIGESTS holds the SHA-256 of the stream and of both decoded images. The
port's encoder writes baseline only, so the streams of the progressive and
CMYK cases are files of STREAM_DIR, written by cv2 and PIL
(tests/test_torch_jpeg.py's write_streams); they are test fixtures of the
repository, left out of the installed package. Machines without cv2 hold the
port's codec to the digests; the tests regenerate them, and the files, from
cv2 and PIL so that they cannot go stale.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

from gdrnet_tpu_torch.data import jpeg

STREAM_DIR = Path(__file__).resolve().parent / "jpeg_streams"
PROCESSES = ("baseline", "progressive", "progressive_optimize", "cmyk", "cmyk_progressive",
             "ycck", "ycck_progressive")


class Case(NamedTuple):
    name: str
    height: int
    width: int
    quality: int
    sampling: str   # "420", "422", "444", or "gray" for a one-channel image
    restart: int    # restart interval in MCUs, 0 for none
    process: str = "baseline"  # one of PROCESSES


def _cases() -> list[Case]:
    out = []
    for h, w in ((1, 1), (7, 9), (33, 17), (375, 500), (480, 640)):
        for q in (75, 95):
            for s in ("420", "422", "444", "gray"):
                out.append(Case(f"{w}x{h}_q{q}_{s}", h, w, q, s, 0))
    out.append(Case("640x480_q95_420_rst5", 480, 640, 95, "420", 5))
    for h, w in ((1, 1), (7, 9), (33, 17), (480, 640)):
        for q in (75, 95):
            for s in ("420", "422", "444", "gray"):
                out.append(Case(f"{w}x{h}_q{q}_{s}_prog", h, w, q, s, 0, "progressive"))
    out.append(Case("500x375_q75_420_prog_opt", 375, 500, 75, "420", 0, "progressive_optimize"))
    out.append(Case("500x375_q75_420_prog_rst5", 375, 500, 75, "420", 5, "progressive"))
    for h, w, q, s, process in ((33, 17, 75, "444", "cmyk"), (480, 640, 95, "420", "cmyk"),
                                (33, 17, 95, "420", "cmyk_progressive")):
        for p in (process, process.replace("cmyk", "ycck")):
            out.append(Case(f"{w}x{h}_q{q}_{s}_{p}", h, w, q, s, 0, p))
    return out


CASES = _cases()


def case_image(case: Case) -> np.ndarray:
    """The case's uint8 image: [H, W] for "gray", [H, W, 4] CMYK for a CMYK
    or YCCK case, else [H, W, 3] BGR."""
    rng = np.random.RandomState(CASES.index(case) + 1)
    ch = 1 if case.sampling == "gray" else 4 if case.process[:4] in ("cmyk", "ycck") else 3
    y = np.arange(case.height, dtype=np.float64)[:, None, None]
    x = np.arange(case.width, dtype=np.float64)[None, :, None]
    freq = rng.uniform(0.01, 0.15, (2, 1, 1, ch))
    phase = rng.uniform(0, 2 * np.pi, (1, 1, ch))
    base = (128 + 60 * np.sin(freq[0] * x + phase) * np.cos(freq[1] * y)
            + 40 * (x / max(case.width, 1) - y / max(case.height, 1)))
    img = np.clip(np.rint(base + rng.normal(0, 12, base.shape)), 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def to_ycck(data: bytes) -> bytes:
    """A JPEG stream with the transform byte of its Adobe APP14 segment (the
    12th byte after "Adobe") set to 2, YCCK."""
    at = data.find(b"\xff\xee")
    if at < 0 or data[at + 4:at + 9] != b"Adobe":
        raise ValueError("to_ycck: no Adobe APP14 segment")
    at += 4 + 11
    return data[:at] + b"\x02" + data[at + 1:]


def case_stream(case: Case) -> bytes:
    """The port's stream of the case: its encoder's for a baseline case,
    STREAM_DIR's file for a progressive or CMYK one, and for a YCCK case its
    CMYK case's file through to_ycck."""
    if case.process == "baseline":
        return jpeg.encode_jpeg(case_image(case), case.quality,
                                "420" if case.sampling == "gray" else case.sampling, case.restart)
    if case.process.startswith("ycck"):
        return to_ycck((STREAM_DIR / f"{case.name.replace('ycck', 'cmyk')}.jpg").read_bytes())
    return (STREAM_DIR / f"{case.name}.jpg").read_bytes()


def digests(stream: Callable[[Case], bytes],
            decode: Callable[[bytes, str], np.ndarray]) -> dict[str, tuple[str, str, str]]:
    """{case name: (sha256 of the stream, of the colour decode, of the gray
    decode)} for a codec given as stream(case) and decode(data, flags),
    flags "color" or "gray"."""
    out = {}
    for case in CASES:
        data = stream(case)
        color, gray = decode(data, "color"), decode(data, "gray")
        out[case.name] = tuple(hashlib.sha256(b).hexdigest()
                               for b in (data, np.ascontiguousarray(color).tobytes(),
                                         np.ascontiguousarray(gray).tobytes()))
    return out


def port_digests() -> dict[str, tuple[str, str, str]]:
    """digests() of the port's codec."""
    return digests(case_stream, jpeg.decode_jpeg)


DIGESTS: dict[str, tuple[str, str, str]] = {
    "1x1_q75_420": (
        "c1da9471caac649f9baa2c567a069397cb3d928955552a111ef17ac03764be8c",
        "d1c03a50dfd4e6d497522796d11e33bee6160e844ce61f161cb86649786ec8b7",
        "5a6e7a4754af8e7f47fc9493040d853e7b01e39d537cb1dd353c93b7ae58eb3d"),
    "1x1_q75_422": (
        "1a18d8571a8408bcbe728017e9e5bfb2e8e0c98f043bb19120f16802a46c42e0",
        "fc09b3218039b7877878077a648f83a37e64af2fab4c12cf5965db9329982fef",
        "043a718774c572bd8a25adbeb1bfcd5c0256ae11cecf9f9c3f925d0e52beaf89"),
    "1x1_q75_444": (
        "6faadab92c0254c2f1b6624db1447e319a15380a022f39263876bc5539967225",
        "546a68ceae0f375a1fd94a57503c8bc5db06d0214ddc3ec904c7464d31bfb0db",
        "65f15821061635e6807f06701bf0a12d8e89dcff88df5968bd0822c9dbb52f1c"),
    "1x1_q75_gray": (
        "bdf231a56c776b6c515c6e9ba28de3f2627f53d9802525f829963593713c4d07",
        "6ae7044ad519e317abe56abdb05070a4e873037f0846419ac699341e166c7509",
        "a5ab782c805e8bfbe34cb65742a0471cf5a53a97f0a1160ab6cccbb64c9131ce"),
    "1x1_q95_420": (
        "29202aedaba9313340a1caf1241acbf6586eb3ad65c613ea51144d9f88ad0017",
        "802e3799c9ff436038f7b2441be35a9e9a4ac6280a29129c6af571cbb796e973",
        "5e37305c587caf07e99a08e1efd0749fd3bbbb855752e4d568ac2dbfc2025464"),
    "1x1_q95_422": (
        "7eddee9bc977f9109279d6233d459c38cc0211d69ed5104e6290226ab8063604",
        "00f75153c4e7a221a514b8b4b4b9064e37b9c761d5d6dab665081870f7fcee7f",
        "22adaf058a2cb668b15cb4c1f30e7cc720bbe38c146544169db35fbf630389c4"),
    "1x1_q95_444": (
        "3b4b1a2c67f901a4c8d7fe9b0402f387d6f925e1b4bbf8c86cd85fec420dee43",
        "c082902fee7208c5275e151aa3df98c51624953db4d5d348610ae43da6f79183",
        "0a43b22d89fa2499be5c7704c9bf273260b0ca9588e4cd1897cd80f9c96cd97a"),
    "1x1_q95_gray": (
        "1bf480cf798a3a396726b1bc9926cf60a7e8b18e09dfa0445991dd148a260061",
        "cb1ad2119d8fafb69566510ee712661f9f14b83385006ef92aec47f523a38358",
        "559aead08264d5795d3909718cdd05abd49572e84fe55590eef31a88a08fdffd"),
    "9x7_q75_420": (
        "e332ee911b6fb7f8e4f594d781133eb59555ddb17757f3bc24382a1673937db9",
        "be9a033c77163aecdb95d9b58db30b8f11c26fd15c03b37f5871ee8b5a7f82b6",
        "ae4579620ec28148b59c692919ec974d60481ac2b86c3664d892d51b87b20652"),
    "9x7_q75_422": (
        "d8a83741f64b8e26068a375d6e6a885be4465c8fbc4b2033287227a192476186",
        "d077ac9988b6898fdceecd5f2f89b6ab901ffe7700d9da001500d6ee167c04bf",
        "024d53a00b3edac10096b5a0c8e94b4b558d1b5eca7b027d345435cec4ce757f"),
    "9x7_q75_444": (
        "258b242ba50580cf1b0364d907657dce9c9710a657cfb63e47b133417d91837c",
        "342d5556665e7f712f70d08e80abc5c7baec0a59c536a017266a734bd6341ddd",
        "36ef35516497ac8d0340d82c0a9a3ef51d3dbf393f389cacfe387f56dddc4d9e"),
    "9x7_q75_gray": (
        "c8b41ed8bc3eaaf15b0401cc969322ab066bfa11910467bf744f7a552f5d3364",
        "46f24bc0ff918f74d62f2e04c5a033e3a1b8c3dbe1bb6a1a7b4c9d6d01950687",
        "23ba7726200bf28c3c9350fd40050b29b7816a796ceed7b0b256ab23fed6e478"),
    "9x7_q95_420": (
        "cd3d3067df8fe28fe6d083a041a0853c3c17f462fbb7f06e2bd1df74db54751e",
        "38ec6735d6dc642075e9690951cf50b0eb6f281a58dd499e578fc62b38242de5",
        "9df54f1937086f101302f23f935beacba8de497bea0d2ac275aea65d6aad4db7"),
    "9x7_q95_422": (
        "ce0fc12ec5fea406cf52fbf0f4e4b97eb3b5ebb72170ca1fb746e5e7ad371193",
        "39f807af61b597b3b00e9042caa98c5921674cfcdad47b7fe7ed021022dab1a3",
        "eaa4a8677f83a90d6eb51f86f00710d02c1681989a53bdd83d472192faa293e8"),
    "9x7_q95_444": (
        "40a979d5906bd6128f0bb851ca7cd1f25237de2357cd64332cd0c425a64223bf",
        "9feee862b45b4d267d5bdf4287b36985798cf515cff797d0592ee78e7086b1b9",
        "9184350027417632ee9978b9ee99629859c5b5cdec6e8e986e6157eb2c540243"),
    "9x7_q95_gray": (
        "7707d2c18c789d6283d8aff40fb65ce315c73f544779064e0912c20a89164ed0",
        "4c25e007b62d2ac396293d16640a3e64ae2e0042935d7faf607fbef626d7a9eb",
        "70d02d0a48232b3efa20afaaa5aad45dd9a544c35f983c14c7f54fc3310242d9"),
    "17x33_q75_420": (
        "3bf0785e33ee75366995c310d9da86b07cb6b6cc1517803fc088ff7a3e489362",
        "59eacc5b3a0da1bffe903e8f38d42abfbffc0666be79a07d620a2601064162e4",
        "aca38663c3a065b34b59998503247388f01a7fa4d1b4e9db35be9a8ba5fc1b5c"),
    "17x33_q75_422": (
        "2f5751a35fa73a8d34a584f9eec96fb5a991742c2ee1c44a5fb80c18f7c3fad0",
        "92e2ddecd24f9dce14897826261ed91430a6e0c86fa77c554f4e91826e639935",
        "0b53f6d72124b06329fdf824df4ae877e8ad109f398b9901a3e247467afe55d4"),
    "17x33_q75_444": (
        "8eae665c06e4596388c3c856c34acc042b19029d7984445acc5798aed66669fe",
        "759eefca94bc62d69d391d738c11e64da5a9affa22f4db3e7687cdb1ecb776b1",
        "e5108f739ded1521095941ba0a15ee2b823687fa2eb91d719b5f33556d181e4a"),
    "17x33_q75_gray": (
        "776996942d22998695c885e3252051ce82eb9ea34edeb189fce1ef3549ebe035",
        "bba7edfbe9950f0d6a7ae3c00241e7a9496ed7747986967f89a8c82c8c016aea",
        "6f27d0dc8c207793417d3b25bf9c75c01bb4319e0dc893f08668fb05e563517a"),
    "17x33_q95_420": (
        "3fcc274839f04bf9f689731fb86d37f12d9a14bbca078283a339a559c64a73aa",
        "10926276e0dc20bc1303691122eb831e6ad7c28959e30a5faf8b2cf1213b7fd5",
        "c09cf9afeb58695781555dde3700a097a16511bae2df657b5b982027310953fd"),
    "17x33_q95_422": (
        "925d008022175ce5f9b2a31acd11022d5f8a1ede244c860d0ff4a2b13cc9eb14",
        "fe5cd64cd36423ed99900dd46bfe27add21004d0df06dcb09e8aac35ce37efa9",
        "6da27af3f4df4a6f540b2bb2cce26cd2923f7bf80f5c63b7c6b211e4c0bd16df"),
    "17x33_q95_444": (
        "593f8e94124fe4e3846e3a97ea3c255a04648a29455571cbaba44ca7bddb7f12",
        "1fa39402b83b4661951e16f238e602e37878c23511cd9fe042d38f38ea403558",
        "f26545a9d16566be4221f7b9bbd6085048d52e71547e93ce7e52f825272d93dd"),
    "17x33_q95_gray": (
        "dee6d608f00096ee46f306fb4e81bc3df6951fe222f152847192feb66a7c913e",
        "cc3d38d867cd2f9f143dd062cd9bffed495587052a5abd0d4ca99f8c274646d0",
        "27be2642e8c5c97eca2c84b4e9889c82d5fdd7b72eb78e38689f43c0d31171fa"),
    "500x375_q75_420": (
        "44e61de5aedde7e26d5d8cecd87823e82ce9209bd6d6039c4807bca7a798d386",
        "79c076c24a5845a673a9f2b73e46b68552af401744dd48ea37702130361c798b",
        "db5a9c96444b9e7ecb3c023e40213032b2745757a30c4a46ea4020944c4c455a"),
    "500x375_q75_422": (
        "ac0dbff0e7e4b66163be6cdcc8304653a9cd3bb06c06af93b09731c169bc845b",
        "d26a4691bf978c2946cef349291ac7d46b88f8464c1e8d4069f9bb628dac1964",
        "5144534ccabc673e235db4f50118dbdd478fd2cd2b726f063d4348ebc61cdb23"),
    "500x375_q75_444": (
        "e93cac5485badd358bb88fda8178c11cc0f945e3b2b90945533ac5d8eb3a38bb",
        "8de4e09c35b90fa56e661eeea619adae9e4f2e4e788310b915720ec5c9a3ef90",
        "93ec8fa207fd929e4ab975629282d1008622ea4a390ccbb284e90bc62ffd5cec"),
    "500x375_q75_gray": (
        "281f42facfc6ae2d89396b1d6a8ed09069f87ca9f3dd4fa3404dd18518445d9d",
        "907e31502ffc92113f7e2c345794dd06f71f2404445f3754056b6ed6a4e093d3",
        "6cb2ecd688386c88f791af3ee39d858de6d62e331951e1f516b9d215094b95d8"),
    "500x375_q95_420": (
        "f419aaabfa50d2c7d9bbf02114db8e983e82bc414a3d6ab3abf56daa02d77d57",
        "fb4330143d3fc282dfcadce174586e317d8e317ce96cf1e83d6ede16f31a82d3",
        "433cf6a2d0179c32424c847829013ed1a46a5df55cf633a965308ac689d69523"),
    "500x375_q95_422": (
        "f42c482ef5e4aaee06d01b5df19f0aebea1083ace9faf7dd7f0365acb1d2624b",
        "93254f2c4bd4e292165e4c6f1a94120b8cf8f369f6866fdb4d65040be112ec23",
        "d2c83f5f0e483e598ea7323ff29d78e61d7bd05f8a23fe81f3f890eb6c94863a"),
    "500x375_q95_444": (
        "0a7c172fd096a6f75c2b083e7dcf02ab18ec71d0461badbd488d8944b6c4ce5b",
        "b768f138625d2e0183a270fbdd6042b84320d6c273384b887bed3153c86accbb",
        "55a84fcfa5006d6641a258773b525508527eb69378d52ad6b47f593bf6110750"),
    "500x375_q95_gray": (
        "9e2de5957ed8913a06804fb07ca51e44aca519d998f1d8d1fa13b93a967ef1f3",
        "33c19daaf6181ffcb01b0fcc139a2916a39948de6708247ca2b0f1c832c6171b",
        "501ac958e5f856856e0022063756e0f7e432cdf14a570d3b41db4546234cdf83"),
    "640x480_q75_420": (
        "d784350987fcc0622c6582ae01d1f919ee6831ada77a3fc89c4d0d70504c0e5f",
        "50d1d32c5c50b9d9531ab25ed5e205d36ea138778ef2b1181a5a82f6de7ff419",
        "4632a1a71abec9a20971be5a04b1b2a8824bb0c2f3b720ad4d5c082a22d3d10f"),
    "640x480_q75_422": (
        "d7f6d06f9478a30d2fe3f9684a49f9eed37f77e9902191e0dec96eefcb71ba6d",
        "d181d7b5de3bc9cb8cc7c5bfe26c02710451d869183e311a621faa03aa6b5419",
        "9f4724c71ffefc9c0cceeda8780af1524534db62fb373ae236dc460709c626cd"),
    "640x480_q75_444": (
        "bb2d7e9beb25ccef52529e2ace1f248443ef1742c59f698b4fca3bcfdc46037a",
        "00a9835b38c59ea04b627e13217fb905f8e6843252cde497f2dcd8f960e09a88",
        "a50fd2235e51358fc1e1caf589ae1e892ecf176561492360e2f63e3e561447c2"),
    "640x480_q75_gray": (
        "9694d002006bf246604a95f208ceb72ad719f6e74879b1b232cf28d3fb7abd88",
        "01fc8b9228782e7d2fb0f8eb0ec0f89a6de2f4ab26853e63f2cb776fc6ac9ce0",
        "be2abccf6dfcc968a5880bb1186989079c451bb43c7f8323fa780945025bfb50"),
    "640x480_q95_420": (
        "a95e7aa0512ce8d870b2a79ba3c657d26d3ac9bbb84e5ef90292dc07cfba9fff",
        "a08ae4c945251684f30edaccfb14435fd47c22c4e662866aee683d9852a2a7d2",
        "b07f4c502313f49f3d100255d312ae3d0d2ac04713b99f222158f21bb125b7f6"),
    "640x480_q95_422": (
        "787f0807e6055e0b57926b931aaae38cd601d96b58d4f91b1a7e3f95a57ba2ef",
        "5d0818b5d6600129d94a7099fcd4ddaf770c2818e8c8b76e950b36b38b57d910",
        "e0fe462be722ff8094178923c1e81f352d9e961db453da39c1be2df108dc945c"),
    "640x480_q95_444": (
        "f440da7cbd250132314b3f428a945f8ec692bffa450772f3fe2560f98ce620cd",
        "14ad303fa91efeaaefb76759450d38fdcc2a9d8b5f28d76a21aec3711f6a4d87",
        "7d654240070a62cf0a42bcf8f45e31abe4ab4131dcbc384e4baddb73c21a9db2"),
    "640x480_q95_gray": (
        "cf4fe68efa2beb0cfb4d273c317993775c671e418ca68ce2dce7da67aefe3483",
        "1657bff1d38a5804e395192f392280b06a48bc6584f2a59ff2b9bbb18e4df45f",
        "d0a3a8b4d30b6ab40d5d521ce42c928f0a4c6726b7827186c06c6bde520a19af"),
    "640x480_q95_420_rst5": (
        "dacf863f1d0366d795c1528dabd52bc5054e29d63ef8daef9cdd9c8d6240fe26",
        "e45b50e488440c7a8303aad3369a50c8bc4825c0d162c2146af8e97139d92517",
        "c4a5f450c6345c7127e98fe0145b36aaf4de5628c1e4a06cd27cb7abbb078f60"),
    "1x1_q75_420_prog": (
        "08ff1c5781dd1f1d91ef751772339f85da04853ac5ee031a2070301fbfe05b7c",
        "3bc43a0b78df8621ed34e03ecb8d9df51bbb3058088f1b0b63465088ddd3a95b",
        "fcb5f40df9be6bae66c1d77a6c15968866a9e6cbd7314ca432b019d17392f6f4"),
    "1x1_q75_422_prog": (
        "84c026d2ac181202f17e0f1a274b24b5a5fd08b2488b843f9230728abf8cad62",
        "9c5f230352df6eab3bb2ffcbce554562d734be2f0fc38e08c629b15d19462e48",
        "cbe5cfdf7c2118a9c3d78ef1d684f3afa089201352886449a06a6511cfef74a7"),
    "1x1_q75_444_prog": (
        "2ccc442474f29a6799503bfab8b53e969264c83fe2c63dd84e1b09ec7e4d0fbb",
        "8052bab35bf796f69bd49e87729dde77cd7367f24cbf3600c035c43bb3e176d9",
        "4f362f9093bb8e7012f466224ff1237c0746d8c8f660b16699f5036ccba9c64a"),
    "1x1_q75_gray_prog": (
        "fc5a941af4b0b1101d5bd047cc1175b9950478cbee1f3895ac3c8b444ecc5f9d",
        "c4d4798b9b21d1daca37589f0a74c82c82b7196088f3cfd8bf4e593de5dfeeac",
        "281c93990bac2c69cf372c9a3b66c406c86cca826d6407b68e644da22eef8186"),
    "1x1_q95_420_prog": (
        "9447b6fc49202e63fc2486d2e8fe81683304ec41b1a76a6ff8ea46a41f516606",
        "1f2ad222c0ebd6b5fb1b3d05deb2e8cc40e4c53597d84529e8cfc09f3c338710",
        "148de9c5a7a44d19e56cd9ae1a554bf67847afb0c58f6e12fa29ac7ddfca9940"),
    "1x1_q95_422_prog": (
        "458200715cd775a4b0d46c62fcc28d46d0f68cd7a7aa12d79517d36dd37d3ed9",
        "04192a90caec29cf8e349e66a104d295cf82d512dbce5f78a2ca978cbc0a8d44",
        "50e721e49c013f00c62cf59f2163542a9d8df02464efeb615d31051b0fddc326"),
    "1x1_q95_444_prog": (
        "7e9dff3fa10d96329b60a225846a05876c9b48aa47f532575dacf58c94e05134",
        "fb93c1b842e3449e66b22379ee01f3e3fbeb3ddb992d7ebe7efdde92537ebbe2",
        "d10b36aa74a59bcf4a88185837f658afaf3646eff2bb16c3928d0e9335e945d2"),
    "1x1_q95_gray_prog": (
        "77f1549867e099ece9739ccbc31ecb2a58bdd839cd9c5968dc40b5510a43b18e",
        "f5557d4fcf727a981a3c315aca733eefa2996f7c7cdae1fa7e0de28522820bb0",
        "de7d1b721a1e0632b7cf04edf5032c8ecffa9f9a08492152b926f1a5a7e765d7"),
    "9x7_q75_420_prog": (
        "84bc50cf75d3b17322369106312e8c2e58426f685443cb1b7fece832b2da7bc2",
        "1073242b6d5830a7a320f811b7a9cd8c27c082eb43c9cb5f90f76897f7c94de2",
        "4a040ff4cd08cd75a12caf1e912b221b187bad117bcb7cc09ced539e9f1af049"),
    "9x7_q75_422_prog": (
        "f1b6469615dd8d2c0fe690a7cd0c5cca18f41c4008bff6783c8001c58059e5a7",
        "fe79dd5b42faa27e5c2105b2ed4a4bc541268394586e272c48999e0d07fd882f",
        "d51ad9927a0a751825f53831c067ebe14a6a5c4b74df22e91b5e6c606b30d0dc"),
    "9x7_q75_444_prog": (
        "c11a6145cbc5bf66e12dcf791d10503fdc42bcd93ac2ed0866afa4ab3659eb95",
        "c6ab3380cc06179b445f23d13561671b38ef58d1227d335421546128eb796660",
        "27a974b81e541f4b5662df8a9105083be258638116e1dfe6b7c1b2da912e63a6"),
    "9x7_q75_gray_prog": (
        "0ac08001191bafe1b365443ce20dc0cf9594d92110a67a6ef9d33c98b4b93166",
        "58d3d48f0209dcce4c730c139ac8b345154269fd69e37f62bf8f767a195897ad",
        "759d43c4ae69831a78385837b4367b6c7c8b24b792f668b55c093ff44ad65785"),
    "9x7_q95_420_prog": (
        "acfcee46f8fb748e94b419d54b9d4693c0db3ac128138782d754c4d88be091d9",
        "ec46347723d344612f91bfb15d9b0b29f2c42c9caecd5aee78b4a5bbdabd4ffb",
        "9486d1cd997bdb2055a19d188aa3ab82c1cf36d6a8bc55cb51fe35185660dbe1"),
    "9x7_q95_422_prog": (
        "8bcdefbf8ea46ef9237b03d07010ee7595957af2ed0d4da91b2c04f07cc52abb",
        "a98c1fa4b0765b3a0843b9f131859e3c5b015220df43312ac70fd4d77667a9dd",
        "78b6a8da86dbea6ebb747de967e9fac48382f4a0571da06878ef67bd3d866108"),
    "9x7_q95_444_prog": (
        "73c019b564e88ccff460fe996916cba5ced142d36924c7248264d606e535dccd",
        "9feb4a20d560ef0d8dde40379ea2d76db4e381e9805119d4ac1908f14e917bec",
        "8c2cc43aba246558d040690ad18b0701c694636e5f425084dc199dedc0868398"),
    "9x7_q95_gray_prog": (
        "2493a0f39641004043a096596b0e12a9fd18ddba95d10007becd895bea432dc8",
        "86b43ad7db4ceca037ba53c5fadc8feec0f2adcf9aff7983e420b896f50d75f7",
        "e3b0d3470273f24e9e427c7dce7c650343c503567855afd8b513369e40588edf"),
    "17x33_q75_420_prog": (
        "1038c1c12f2f41b299e09cf4e060bc8438b7b3a26b52d6d2575754a21edb3ac9",
        "bffa4565d96184ddfb4d8d2c10fad17feb6dc22325bc3c43ce57f8a394e2caeb",
        "e8352312f58069b2010a287d56e5cfcb3b2e9e7e8d74b908363b88579361a517"),
    "17x33_q75_422_prog": (
        "1466b9ebe176e2ef41c5ff640ec7a92593cdf1c5ed20c8953726ef2ba758dafa",
        "856200188f2d8efc4ac78dcd4edad1f772b9ef0c76cd38c22f96a1a0a36615d7",
        "37c1dddda666d24c0a87d8fb8fe8498e93e1bb7be99018efde685d5985789289"),
    "17x33_q75_444_prog": (
        "43285f83cf08e8368d06aebb5bd341e0f53b792eaafc32d7e6ee8bd7948497d2",
        "aca5ea7703089593578969feb95c24f0b11fe16c84f09980d881e2747ccb437f",
        "77feb1af1906aad1e3c04f99c5a8943f551ffed8e71e9aed4e1c5000dec2fcea"),
    "17x33_q75_gray_prog": (
        "05a77fd0a72c9fa229ed7adbb3188660b434782f3d779048547c9b81e948c558",
        "5f42dd7a9e28bda39aafa416fdc13709edc4e4c405d47e819667373e1139365a",
        "d720a6bade985e1e68fce013e8ce71b3439134cb6ea7ed201c84955ee9cad4a1"),
    "17x33_q95_420_prog": (
        "a0fa7324d8a54366a3efd23ac48fb07a34ab72ce469988188164cc046db5afb6",
        "0550fb0f90cba3addb35ffe95f18193249eecabd3bd9bc7a6a4a343394c437d6",
        "3fd5782d589dcf9d45398c4ed047c07279a0566e36997f7332a952bbfb1aa1ae"),
    "17x33_q95_422_prog": (
        "a6501b6ed8be143281cca50e7bb7cae5d8db08a7e8600d88a5bd51dfee7153b2",
        "3dc31b756f3269d1e0c651536be4ff7ea548d02ede09e64136151b5f6a3b7033",
        "099394780a4a894fb0114a25a30d71f471f2ec7811282897f7a8f5cb34daafa4"),
    "17x33_q95_444_prog": (
        "ad44a719f0f00078a4f16e06e97a269f15b48b2d1196a63383e59476b4b705ec",
        "280afc29c85f67fbd8c5acc0e120db8c7fb93532501df196700d94f08ac095cd",
        "95d09469666b470624b4474fc726fad4ab6c68be79a128a486cb7db2cf5c846b"),
    "17x33_q95_gray_prog": (
        "a60b5fe870acf4dcc45ac30ca4959c16acbeaba231dfa3df4c794ac8ff18f5db",
        "1417a836c217700d268f90d5c0e7dd076fe862114aa56cc5c1f5521d66bd9c44",
        "9e474f3fa3f735fa0fe553e8093f9bd9a7c4c7ce093dd1fca5fbda2d76be8d94"),
    "640x480_q75_420_prog": (
        "dfee339f4d81af690ef12a3fd94fa29ba6142d51fbe04705fb5337b09307e473",
        "c085e3eb961a32adc6d170b18e21910925ee7be30f47ae224641074ee224e586",
        "89d73124fe4bdc5cc927dcd524f515e18e30f827e8f11a47c29835f3dd17d008"),
    "640x480_q75_422_prog": (
        "d4c9a265c0edd5b72607cbffe185fea66ab8e8e5493e3bf7d5a1b91c2b6eb7a7",
        "5b61ec012c498772253a0d033e595ffeec13fe789d141770c65df659990051c4",
        "940437b7a51715a001c684b171e988769d72934700dea125045e07e6cb24f3e7"),
    "640x480_q75_444_prog": (
        "a244869d66ba4a540bf7a43ef24945de4f2a1173056f1d3c4b81bd6e8f86db79",
        "b76662882f47161193c3c068c2f8b164f746870bcc43259f25968336668e3fd2",
        "df3d30062143a3295ad5d2a39f6e138b3dca8a96ebd1999d9989e927983037ba"),
    "640x480_q75_gray_prog": (
        "2138cb60978e08c6d392fed49504643084e0e1795a1eba8299e3a8352814c098",
        "8adb5a0a5eaa257b4eff95281b895a2483fee4bd013a9bbc926ecb3c19782d0b",
        "53e5f7e8f0c58c58f463cc8bb5fde4dfe81b4a72b2c13eaad929d785965ce7bc"),
    "640x480_q95_420_prog": (
        "9a6ac42549975624144b70422d3e466c2a4b27f7d430ce79a2456a3c294b9080",
        "09d29497bddad376b935b8c1281306af88cff45287d5f3f469dfd73ac6d0ad7c",
        "689f9ab0f79659fa58555249d74ec46b9a1f6dc6ad01180c36473e58de3f84ad"),
    "640x480_q95_422_prog": (
        "8d031cd360cf17ea64b96be7f7f3493cd96711cfbdb199ea559058de024dba1e",
        "ade26f3c44bc7798bf090be3802ca8283591b5423a64b28edd1e445622bbdf8b",
        "2d5a7c5b7f6398e5b07c4d987575281162b7a16059c31f6aff5ebd07a0b5f6ca"),
    "640x480_q95_444_prog": (
        "71d535403268b962b93aab22fa7a8f7a9f45ddf9d709da64aa1ad554086105e7",
        "7de079eed34f595d5adb95b8708f5a2dd3f3c041a583367d943290df71940ed7",
        "cf6c6c667f641dfe2eae4231506ee1a74de271cd61be59cb7f6390d9d73265ff"),
    "640x480_q95_gray_prog": (
        "94d3cae09ad184884969d08cc9e5360053c5a9c487b1f404bf942a62d44dc1d4",
        "46533e6507cec36da410028e35e264ae7c296d374a7b583ef695f91b4f20202c",
        "b669dc22f7b50601c5f96c19392d3cbf2a0cffef681f8754a2a6681ca16d33b1"),
    "500x375_q75_420_prog_opt": (
        "44d8bdaa774365c122e5c1547896067b7a248565d19477163b23af69e4e68adf",
        "9a8453691a88eccb795d7f812e2ad15ef5d3a6448ae23dddc3c644f7fc4826ba",
        "953f6cb5bcf578516e4681623effd5465eeb0237bdb068fe5139e86b463748b4"),
    "500x375_q75_420_prog_rst5": (
        "ea839c1ae4063cf8d058a114238a6368c833f5bc9584043b5f684d48dd7ad1fc",
        "0b1862ca4b1774edbc16e5e5ce41dbd9f9f4f3c1d5bd552a4a1aee46a3ce413b",
        "40c7157816540924b41d4a9f66c86ad6710be93f83827713c2e933383c91080e"),
    "17x33_q75_444_cmyk": (
        "5d477d8e7e7365853bc084cd9963e59a709e0ea40f9ac17acc3356d298193ab6",
        "39e2c0a60cd6428ca38378f987cdeb0e5474b731c666debcd1c8d7c1438c9922",
        "56893d7394a4c201075ec5574eddcb0d126ae10f7a549e95473845dd00fb49a7"),
    "17x33_q75_444_ycck": (
        "3a19c972e70bf2788478c37cf2681e8eeb904db59a9a782c783d5d0316fa9c51",
        "6314686cdf3605bd3cf71221643b6edbe1c627c4384291a107921b38e73360f9",
        "0f9b8e68862ecc35819276903548aa5460f2eb3fcb96b4cca94a64b4b437cb57"),
    "640x480_q95_420_cmyk": (
        "11a5a0bcfe90e5b73b2d56e09b12342173b6e7a688f4e949c564fda70fad47da",
        "929c0bfe27cdb9326ff82ad2722379f393bb5bb2ce0bcc0751a8677ae38acacb",
        "033175958bb2a63ff413b8fa17c55da19b5004a740a2e0dbd4d3f2710c58855e"),
    "640x480_q95_420_ycck": (
        "73dc83e6aa2f5bdbcf6f4a42842aaff4a4a2faff92b9eb6da5845a1636c962ca",
        "36866dabaab8dcaa80065dc273274e445305ec1777a082f295cb84ead2c1d2c5",
        "6a4f3ce49d42254f6e9e183f2a8a21b2f6b8a9c3d66004ec0dbf59b6cd04fdc0"),
    "17x33_q95_420_cmyk_progressive": (
        "01de215cc078bd5681a2568781bef73d5b6d96b58bcf091f7b00d2cc7ac5e6d3",
        "56c2bd7be2ac60e199ab1c658bf5c25d853c12396bc0592d303cf99ee022272e",
        "b2e2d05b220e8306b3a0baa96c67876a4b0c18ca863f16573cb1c08805724068"),
    "17x33_q95_420_ycck_progressive": (
        "0003e1f40c4fb5888f1dc7c0de49da1573d645c1916166626d8a0e6d0b3db57b",
        "33b17ebcabdf09ca17b22cadeb6e375a704c4cc0886d18507230f2cf71d3b648",
        "eb57433db8734b806bf28636092011a181dd14e2895f86ddeb85d98ff1b787b9"),
}
