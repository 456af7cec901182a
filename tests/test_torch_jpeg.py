"""The port's JPEG decoder (``utils/jpeg.py`` over the host library
``csrc/host/jpeg_decode.cpp``) against libjpeg-turbo, bit for bit, on
the CPU: against the JAX package's ``read_image`` (``cv2.imread``, EXIF
orientation applied; colour and gray) for files, and against PIL's
``convert("RGB")`` (the JAX package's HTTP decode, orientation not
applied) for request bodies. Files are written by cv2 and by PIL from
seeded numpy images. Every comparison is exact: no tolerance.

Also: the refusals (each a ``ValueError`` naming its feature), seeded
corruptions, the host library's build errors, ``extract_features.main``
of both packages on a folder of JPEG views (``test_torch_port_batch.py``'s
tolerances: keypoints 1e-3 px, descriptors and scores 2e-3) and
``reconstruction.import_images`` of both packages on an orientation-6
JPEG.
"""

import base64
import copy
import io
import struct
from pathlib import Path

import cv2
import h5py
import numpy as np
import PIL.Image
import PIL.ImageOps
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.spatial import cKDTree

import chip_smoke
from imcui_tpu import api as japi
from imcui_tpu.pipeline import extract_features as jextract
from imcui_tpu.pipeline import reconstruction as jrecon
from imcui_tpu.utils.image import read_image as jax_read_image
from imcui_tpu_torch import api as tapi
from imcui_tpu_torch.ops import _build
from imcui_tpu_torch.pipeline import extract_features as textract
from imcui_tpu_torch.pipeline import reconstruction as trecon
from imcui_tpu_torch.utils import h5lite, jpeg
from imcui_tpu_torch.utils.image import (decode_image_bytes, image_size,
                                         read_image)

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
KINDS = list(SAMPLING) + ["gray"]
SIZES = [(1, 1), (2, 3), (7, 13), (17, 33), (37, 53), (255, 193)]
PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
KPT_PX = 1e-3
F16 = 2e-3


def _photo(seed, h, w):
    """A seeded RGB uint8 (h, w) image: colour gradients and waves under
    noise, so that every channel and frequency carries signal."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([x * 255 / max(w, 2) + 40 * np.sin(y / 3.0),
                     128 + 90 * np.sin(x / 5.0 + y / 7.0),
                     220 - y * 180 / max(h, 2)], -1)
    return np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _cv2_jpeg(rgb, kind="420", quality=95, flags=()):
    """cv2's JPEG of ``rgb`` (``kind`` a sampling or "gray": a
    one-component file of the image's first channel)."""
    if kind == "gray":
        src, params = rgb[..., 0], []
    else:
        src, params = rgb[..., ::-1], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       SAMPLING[kind]]
    ok, enc = cv2.imencode(".jpg", src, [cv2.IMWRITE_JPEG_QUALITY, quality]
                           + params + list(flags))
    assert ok
    return enc.tobytes()


def _pil_jpeg(rgb, kind="420", quality=95, **kw):
    buf = io.BytesIO()
    if kind == "gray":
        PIL.Image.fromarray(rgb[..., 0]).save(buf, format="JPEG",
                                              quality=quality, **kw)
    else:
        PIL.Image.fromarray(rgb).save(buf, format="JPEG", quality=quality,
                                      subsampling=PIL_SUBSAMPLING[kind], **kw)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


def _same_as_cv2(tmp_path, data, name="x.jpg"):
    """read_image of the file in colour and gray equals the JAX package's
    (cv2's) bit for bit, and decode_jpeg equals it on the bytes."""
    path = tmp_path / name
    path.write_bytes(data)
    for gray in (False, True):
        want = jax_read_image(path, gray)
        got = read_image(path, gray)
        assert got.dtype == want.dtype and got.shape == want.shape, gray
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, gray), want)


# --------------------------------------------------------------------------
# files, against cv2 through the JAX package's read_image
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_sampling_and_quality_equal_cv2(tmp_path, kind, quality):
    _same_as_cv2(tmp_path, _cv2_jpeg(_photo(1, 61, 83), kind, quality))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("kind", KINDS)
def test_sizes_equal_cv2(tmp_path, kind, size):
    """Sizes that are not MCU multiples, down to components of width ≤ 2
    (plain replication in place of the triangle filters)."""
    _same_as_cv2(tmp_path, _cv2_jpeg(_photo(2, *size), kind, 90))


OPTIONS = {
    "optimize": lambda img, k: _cv2_jpeg(img, k, 85,
                                         (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
    "progressive_cv2": lambda img, k: _cv2_jpeg(
        img, k, 85, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
    "progressive_pil": lambda img, k: _pil_jpeg(img, k, 95,
                                                progressive=True),
    "restart_1": lambda img, k: _cv2_jpeg(
        img, k, 85, (cv2.IMWRITE_JPEG_RST_INTERVAL, 1)),
    "restart_7": lambda img, k: _cv2_jpeg(
        img, k, 85, (cv2.IMWRITE_JPEG_RST_INTERVAL, 7)),
}


@pytest.mark.parametrize("size", [(7, 13), (93, 141)],
                         ids=["7x13", "93x141"])
@pytest.mark.parametrize("kind", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_encoder_options_equal_cv2(tmp_path, option, kind, size):
    """Optimised tables, progressive files (cv2's and PIL's scan
    scripts: spectral selection, successive approximation, EOB runs) and
    restart intervals."""
    _same_as_cv2(tmp_path, OPTIONS[option](_photo(3, *size), kind))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       quality=st.integers(30, 100), kind=st.sampled_from(KINDS),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_property_equal_cv2(h, w, quality, kind, progressive, seed):
    data = _cv2_jpeg(_photo(seed, h, w), kind, quality,
                     (cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)))
    buf = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(data), cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, True),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


# --------------------------------------------------------------------------
# request bodies, against PIL through the JAX package's decode
# --------------------------------------------------------------------------

BODIES = {
    "pil_420": lambda img: _pil_jpeg(img, "420"),
    "pil_422": lambda img: _pil_jpeg(img, "422", 80),
    "pil_444": lambda img: _pil_jpeg(img, "444", 100),
    "pil_progressive": lambda img: _pil_jpeg(img, "420", progressive=True),
    "pil_gray": lambda img: _pil_jpeg(img, "gray", 90),
    "cv2_411": lambda img: _cv2_jpeg(img, "411", 75),
    "cv2_440_restart": lambda img: _cv2_jpeg(
        img, "440", 75, (cv2.IMWRITE_JPEG_RST_INTERVAL, 3)),
}


@pytest.mark.parametrize("body", list(BODIES))
def test_http_routes_equal_pil(body):
    """decode_image_bytes as the server calls it and decode_base64_to_image
    equal PIL's convert("RGB") and the JAX package's decode."""
    data = BODIES[body](_photo(4, 75, 99))
    want = _pil_rgb(data)
    got = decode_image_bytes(data, orientation=False)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    b64 = base64.b64encode(data).decode()
    np.testing.assert_array_equal(tapi.decode_base64_to_image(b64),
                                  japi.decode_base64_to_image(b64))


def _exif(order, tag):
    """An APP1 Exif payload whose IFD0 holds one orientation entry, in
    TIFF byte order ``order`` ("II" little-endian, "MM" big-endian),
    after another entry (ImageWidth) so the tag is not the first."""
    e = "<" if order == "II" else ">"
    ifd = (struct.pack(e + "HHIHH", 0x0100, 3, 1, 48, 0)
           + struct.pack(e + "HHIHH", 0x0112, 3, 1, tag, 0))
    return (b"Exif\x00\x00" + order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2) + ifd + struct.pack(e + "I", 0))


@pytest.mark.parametrize("tag", range(1, 9))
@pytest.mark.parametrize("order", ["MM", "II"])
def test_exif_orientation(tmp_path, order, tag):
    """read_image turns the image as cv2.imread does (colour and gray);
    the HTTP routes keep the stored pixels as PIL's convert("RGB") does;
    image_size and jpeg_size read the turned size from the header. PIL
    writes its own EXIF block in MM order; the II block here is the same
    entries little-endian."""
    img = _photo(5, 48, 80)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                  exif=_exif(order, tag))
    data = buf.getvalue()
    assert data.find(b"Exif\x00\x00" + order.encode()) > 0
    _same_as_cv2(tmp_path, data)
    pil = PIL.Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(
        read_image(tmp_path / "x.jpg"),
        np.asarray(PIL.ImageOps.exif_transpose(pil).convert("RGB")))
    np.testing.assert_array_equal(decode_image_bytes(data, orientation=False),
                                  _pil_rgb(data))
    h, w = jax_read_image(tmp_path / "x.jpg").shape[:2]
    assert image_size(tmp_path / "x.jpg") == jpeg.jpeg_size(data) == (w, h)
    assert (w, h) == ((48, 80) if tag >= 5 else (80, 48))


def test_pil_exif_block_orientation_6(tmp_path):
    """PIL's own EXIF writer (MM order, its IFD layout): tag 6 reads as
    cv2.imread reads it."""
    pim = PIL.Image.fromarray(_photo(6, 48, 80))
    exif = pim.getexif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    pim.save(buf, format="JPEG", exif=exif.tobytes(), quality=90)
    _same_as_cv2(tmp_path, buf.getvalue())
    assert read_image(tmp_path / "x.jpg").shape == (80, 48, 3)


# --------------------------------------------------------------------------
# what raises
# --------------------------------------------------------------------------

def _patched(data, marker, offset, value):
    """``data`` with the byte ``offset`` past ``marker`` set to ``value``."""
    out = bytearray(data)
    out[data.find(marker) + offset] = value
    return bytes(out)


def _refusals():
    base = _cv2_jpeg(_photo(7, 40, 56), "444", 90)
    prog = _cv2_jpeg(_photo(7, 40, 56), "420", 90,
                     (cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    cmyk, rgb = io.BytesIO(), io.BytesIO()
    PIL.Image.fromarray(_photo(7, 40, 56)).convert("CMYK").save(
        cmyk, format="JPEG")
    PIL.Image.fromarray(_photo(7, 40, 56)).save(rgb, format="JPEG",
                                                keep_rgb=True)
    sof = b"\xff\xc0"
    # 4:4:4 components patched to 3x1 and 2x1: ratio 3/2
    fractional = _patched(_patched(_patched(base, sof, 11, 0x31), sof, 14,
                                   0x21), sof, 17, 0x21)
    sos = base.find(b"\xff\xda")
    return {
        "arithmetic coding (SOF9)": _patched(base, sof, 1, 0xC9),
        "lossless (SOF3)": _patched(base, sof, 1, 0xC3),
        "hierarchical (SOF5)": _patched(base, sof, 1, 0xC5),
        "12-bit precision": _patched(base, sof, 4, 12),
        "4 components (CMYK/YCCK)": cmyk.getvalue(),
        "RGB components (Adobe transform 0)": rgb.getvalue(),
        "fractional sampling ratios": fractional,
        "more than 2^30 pixels": _patched(_patched(_patched(_patched(
            base, sof, 5, 0xFF), sof, 6, 0xFF), sof, 7, 0xFF), sof, 8, 0xFF),
        "truncated or corrupt": base[:sos + (len(base) - sos) // 2],
        "coefficient bits unrefined": prog[:prog.rfind(b"\xff\xda")]
        + b"\xff\xd9",
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("feature", list(REFUSALS))
def test_refusals_name_the_feature(tmp_path, feature):
    """Each kind the decoder does not read raises ValueError naming it,
    and read_image names the file as well. cv2 reads every one of them
    but the 12-bit patch (libjpeg pads the truncated file and smooths
    the unrefined one), so the port's refusal is a deviation."""
    data = REFUSALS[feature]
    with pytest.raises(ValueError, match="JPEG") as err:
        jpeg.decode_jpeg(data)
    assert feature in str(err.value)
    (tmp_path / "r.jpg").write_bytes(data)
    with pytest.raises(ValueError, match=r"r\.jpg") as err:
        read_image(tmp_path / "r.jpg")
    assert feature in str(err.value)
    with pytest.raises(ValueError, match="JPEG"):
        decode_image_bytes(data, orientation=False)


@pytest.mark.parametrize("kind", ["420", "gray", "progressive", "restart"])
def test_corrupt_streams_raise_or_decode(kind):
    """Seeded corruptions (bytes overwritten, bits flipped, runs deleted)
    of a small file: each decode returns an image or raises ValueError;
    nothing else escapes and the process survives, as a server taking
    any request body needs."""
    flags = {"progressive": (cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
             "restart": (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)}.get(kind, ())
    base = _cv2_jpeg(_photo(9, 37, 53), "gray" if kind == "gray" else "420",
                     80, flags)
    rng = np.random.default_rng(len(kind))
    decoded = 0
    for _ in range(150):
        d = bytearray(base)
        for _ in range(rng.integers(1, 6)):
            i = int(rng.integers(2, len(d)))
            how = rng.integers(0, 3)
            if how == 0:
                d[i] = int(rng.integers(0, 256))
            elif how == 1:
                d[i] ^= 1 << int(rng.integers(0, 8))
            else:
                del d[i:i + int(rng.integers(1, 20))]
        for gray in (False, True):
            try:
                out = jpeg.decode_jpeg(bytes(d), gray)
            except ValueError:
                continue
            assert out.dtype == np.uint8 and out.ndim == (2 if gray else 3)
            decoded += 1
    assert 0 < decoded < 300


def test_host_library_build_errors(tmp_path, monkeypatch):
    """A failed build and a missing compiler raise RuntimeError with what
    the compiler said; nothing is left at the output path."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        _build.compile_host(tmp_path / "lib.so", [bad])
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        _build.compile_host(tmp_path / "lib.so", [bad])
    assert not (tmp_path / "lib.so").exists()
    assert _build.host_library_path().name.startswith("libimcui_host_")


# --------------------------------------------------------------------------
# the pipelines against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_extract_features_on_jpeg_equals_jax(tmp_path, _one_thread,
                                             monkeypatch):
    """extract_features.main of both packages on a folder of three JPEG
    views (planted pairs of chip_smoke, PIL at q95 4:2:0, one
    progressive), the trained SuperPoint tree in float32 at resize_max
    200: the same names, keypoints paired within 1e-3 px, scores and
    descriptors within 2e-3."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    d = tmp_path / "jpg"
    d.mkdir()
    a, b, _ = chip_smoke.synthetic_pair(100, 256, 192)
    c = chip_smoke.synthetic_pair(101, 256, 192)[0]
    tint = np.array([1.0, 0.8, 0.6])
    for name, img, kw in (("a.jpg", a, {}), ("b.jpg", b * tint, {}),
                          ("c.jpg", c, {"progressive": True})):
        (d / name).write_bytes(_pil_jpeg(img.astype(np.uint8), **kw))
    conf = copy.deepcopy(textract.confs["superpoint_aachen"])
    conf["model"].update(precision="fp32",
                         checkpoint_npz=str(WEIGHTS / "superpoint_adapted.npz"))
    conf["preprocessing"].update(resize_max=200, force_resize=False)
    jpath = jextract.main(conf, d, tmp_path / "jax")
    tpath = textract.main(conf, d, tmp_path / "port", device="cpu")
    with h5py.File(jpath, "r") as fj, h5lite.File(tpath) as ft:
        assert set(ft.keys()) == set(fj.keys()) == {"a.jpg", "b.jpg",
                                                    "c.jpg"}
        for name in fj:
            kj = fj[name]["keypoints"][()]
            kt = np.asarray(ft[name]["keypoints"])
            assert len(kt) == len(kj) > 20
            dist, idx = cKDTree(kj).query(kt)
            assert (dist <= KPT_PX).all() and len(set(idx.tolist())) == len(kt)
            np.testing.assert_allclose(np.asarray(ft[name]["scores"]),
                                       fj[name]["scores"][()][idx], atol=F16)
            np.testing.assert_allclose(np.asarray(ft[name]["descriptors"]),
                                       fj[name]["descriptors"][()][:, idx],
                                       atol=F16)


def test_import_images_reads_the_jpeg_header(tmp_path):
    """Both packages' import_images on a folder of an orientation-6 JPEG
    and a plain one: the same camera and image rows (the port's sizes
    from the frame header, swapped for the tag; the JAX package's from
    cv2.imread)."""
    d = tmp_path / "imgs"
    d.mkdir()
    pim = PIL.Image.fromarray(_photo(8, 48, 80))
    pim.save(d / "a.jpg", quality=90, exif=_exif("MM", 6))
    pim.save(d / "b.jpg", quality=90)
    rows = {}
    for tag, mod in (("jax", jrecon), ("port", trecon)):
        db = tmp_path / f"{tag}.db"
        mod.create_empty_db(db)
        mod.import_images(d, db)
        rows[tag] = (chip_smoke.sqlite_rows(db, "cameras"),
                     chip_smoke.sqlite_rows(db, "images"))
    assert rows["port"] == rows["jax"]
    cams = rows["port"][0]
    assert [c[2:4] for c in cams] == [(48, 80), (80, 48)]
