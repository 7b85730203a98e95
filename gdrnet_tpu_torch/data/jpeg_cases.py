"""A seeded case list for the JPEG codec (data/jpeg.py) and the SHA-256
digests that OpenCV 5.0 with libjpeg-turbo 3.1.2 gives on it.

Each case is an image made from its own seed with numpy alone (smooth ramps
and waves, plus noise), encoded as cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q, IMWRITE_JPEG_SAMPLING_FACTOR, s,
IMWRITE_JPEG_RST_INTERVAL, r]) encodes it, then decoded as cv2.imdecode
with IMREAD_COLOR and with IMREAD_GRAYSCALE. DIGESTS holds the SHA-256 of
the stream and of both decoded images. Machines without cv2 hold the port's
codec to them; the tests regenerate them from cv2 so that they cannot go
stale.
"""

from __future__ import annotations

import hashlib
from typing import Callable, NamedTuple

import numpy as np

from gdrnet_tpu_torch.data import jpeg


class Case(NamedTuple):
    name: str
    height: int
    width: int
    quality: int
    sampling: str   # "420", "422", "444", or "gray" for a one-channel image
    restart: int    # restart interval in MCUs, 0 for none


def _cases() -> list[Case]:
    out = []
    for h, w in ((1, 1), (7, 9), (33, 17), (375, 500), (480, 640)):
        for q in (75, 95):
            for s in ("420", "422", "444", "gray"):
                out.append(Case(f"{w}x{h}_q{q}_{s}", h, w, q, s, 0))
    out.append(Case("640x480_q95_420_rst5", 480, 640, 95, "420", 5))
    return out


CASES = _cases()


def case_image(case: Case) -> np.ndarray:
    """The case's uint8 image: [H, W] for "gray", else [H, W, 3] BGR."""
    rng = np.random.RandomState(CASES.index(case) + 1)
    ch = 1 if case.sampling == "gray" else 3
    y = np.arange(case.height, dtype=np.float64)[:, None, None]
    x = np.arange(case.width, dtype=np.float64)[None, :, None]
    freq = rng.uniform(0.01, 0.15, (2, 1, 1, ch))
    phase = rng.uniform(0, 2 * np.pi, (1, 1, ch))
    base = (128 + 60 * np.sin(freq[0] * x + phase) * np.cos(freq[1] * y)
            + 40 * (x / max(case.width, 1) - y / max(case.height, 1)))
    img = np.clip(np.rint(base + rng.normal(0, 12, base.shape)), 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def digests(encode: Callable[[np.ndarray, Case], bytes],
            decode: Callable[[bytes, str], np.ndarray]) -> dict[str, tuple[str, str, str]]:
    """{case name: (sha256 of the stream, of the colour decode, of the gray
    decode)} for a codec given as encode(img, case) and decode(data, flags),
    flags "color" or "gray"."""
    out = {}
    for case in CASES:
        data = encode(case_image(case), case)
        color, gray = decode(data, "color"), decode(data, "gray")
        out[case.name] = tuple(hashlib.sha256(b).hexdigest()
                               for b in (data, np.ascontiguousarray(color).tobytes(),
                                         np.ascontiguousarray(gray).tobytes()))
    return out


def port_digests() -> dict[str, tuple[str, str, str]]:
    """digests() of the port's codec."""
    return digests(
        lambda img, c: jpeg.encode_jpeg(img, c.quality, "420" if c.sampling == "gray" else c.sampling,
                                        c.restart),
        jpeg.decode_jpeg)


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
}
