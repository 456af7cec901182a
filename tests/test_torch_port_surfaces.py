"""The port's building blocks of the user surfaces on the CPU against the
JAX package and the libraries it reads with: the config files as PyYAML
reads them, the PNG codec against PIL and OpenCV, read_image against the JAX
package's OpenCV reader, ops/matching.py and the NearestNeighbor and
DualSoftMax BaseModels against their JAX counterparts, the model cache,
the matcher zoo and run_matching / run_ransac. Inputs come from seeded
numpy generators; tolerances are stated per test."""

import copy
import io
import struct
import zlib
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
import yaml

import chip_smoke
from imcui_tpu.models.matchers.dual_softmax import DualSoftMax as JaxDS
from imcui_tpu.models.matchers.nearest_neighbor import \
    NearestNeighbor as JaxNN
from imcui_tpu.ops import matching as jm
from imcui_tpu.ops import ransac as jransac
from imcui_tpu.ui import modelcache as jcache
from imcui_tpu.ui import utils as jui
from imcui_tpu.utils.image import read_image as jax_read_image
from imcui_tpu_torch.models.matchers.dual_softmax import DualSoftMax
from imcui_tpu_torch.models.matchers.nearest_neighbor import NearestNeighbor
from imcui_tpu_torch.ops import matching as tm
from imcui_tpu_torch.ui import modelcache as tcache
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import png
from imcui_tpu_torch.utils.image import read_image
from imcui_tpu_torch.utils.io import read_yaml

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights"
CONFIGS = ["imcui_tpu/config/api.yaml", "imcui_tpu/config/app.yaml",
           "config/app.yaml", "imcui_tpu_torch/config/api.yaml",
           "imcui_tpu_torch/config/app.yaml"]


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The JAX models look for checkpoints on the hub unless told not to."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


# --------------------------------------------------------------------------
# utils/io.py::read_yaml
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_read_yaml_equals_pyyaml_on_the_config_files(path):
    with open(ROOT / path) as f:
        assert read_yaml(ROOT / path) == yaml.safe_load(f)


def test_packaged_configs_are_byte_copies():
    for name in ("api.yaml", "app.yaml"):
        assert (ROOT / "imcui_tpu_torch/config" / name).read_bytes() == \
            (ROOT / "imcui_tpu/config" / name).read_bytes()


# --------------------------------------------------------------------------
# utils/png.py
# --------------------------------------------------------------------------

def _rgb(seed, h=37, w=53, c=3):
    """Noise over a smooth ramp, so that every filter has work to do."""
    rng = np.random.default_rng(seed)
    ramp = np.cumsum(rng.integers(0, 4, (h, w, c)), 1)
    return ((ramp + rng.integers(0, 8, (h, w, c))) % 256).astype(np.uint8)


def _pil_png(image, mode=None, palette=False, **kw):
    im = PIL.Image.fromarray(image, mode)
    if palette:
        im.putpalette(np.random.default_rng(7).integers(
            0, 256, 768).astype(np.uint8).tolist())
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    return np.array(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


PNG_CASES = {
    "pil gray": lambda: _pil_png(_rgb(0)[..., 0]),
    "pil rgb": lambda: _pil_png(_rgb(1)),
    "pil rgba": lambda: _pil_png(_rgb(2, c=4)),
    "pil gray+alpha": lambda: _pil_png(_rgb(3, c=2), "LA"),
    "pil palette 8": lambda: _pil_png(_rgb(4)[..., 0], "P", palette=True),
    "pil palette 4": lambda: _pil_png(_rgb(5)[..., 0] % 16, "P",
                                      palette=True, bits=4),
    "pil palette 2": lambda: _pil_png(_rgb(6)[..., 0] % 4, "P",
                                      palette=True, bits=2),
    "pil palette 1": lambda: _pil_png(_rgb(7)[..., 0] % 2, "P",
                                      palette=True, bits=1),
    "pil palette short PLTE": lambda: _pil_png(_rgb(8)[..., 0] % 16, "P"),
    "pil palette tRNS": lambda: _pil_png(_rgb(9)[..., 0], "P", palette=True,
                                         transparency=3),
    "cv2 gray": lambda: cv2.imencode(".png", _rgb(10)[..., 0])[1].tobytes(),
    "cv2 bgr": lambda: cv2.imencode(".png", _rgb(11))[1].tobytes(),
    "cv2 bgra": lambda: cv2.imencode(".png", _rgb(12, c=4))[1].tobytes(),
    "cv2 bgr level 9": lambda: cv2.imencode(
        ".png", _rgb(13), [cv2.IMWRITE_PNG_COMPRESSION, 9])[1].tobytes(),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_decode_png_equals_pil(case):
    """Exact: the decoded RGB equals PIL's convert("RGB")."""
    data = PNG_CASES[case]()
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape[2] == 3
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("filter_type", ["none", "sub", "up", "average",
                                         "paeth", "per row"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_encode_png_each_filter_round_trips_and_pil_agrees(filter_type,
                                                           channels):
    image = _rgb(20 + channels, c=channels)
    if channels == 1:
        image = image[..., 0]
    f = np.random.default_rng(3).integers(0, 5, image.shape[0]) \
        if filter_type == "per row" else \
        ["none", "sub", "up", "average", "paeth"].index(filter_type)
    data = png.encode_png(image, f)
    rows = np.frombuffer(zlib.decompress(b"".join(
        p for k, p in png._chunks(data) if k == b"IDAT")), np.uint8)
    np.testing.assert_array_equal(  # the filters asked for were written
        rows.reshape(image.shape[0], -1)[:, 0],
        np.broadcast_to(f, image.shape[:1]))
    np.testing.assert_array_equal(np.array(PIL.Image.open(io.BytesIO(data))),
                                  image)
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))


def _with_header(data, **fields):
    """``data`` with IHDR fields replaced (CRC recomputed)."""
    names = ("w", "h", "depth", "color", "compression", "filter",
             "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    payload = struct.pack(">IIBBBBB", *(values[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + payload))
    return data[:16] + payload + crc + data[33:]


@pytest.mark.parametrize("make,what", [
    (lambda: cv2.imencode(".png", _rgb(30).astype(np.uint16) * 257)[1]
     .tobytes(), "16-bit"),
    (lambda: _with_header(png.encode_png(_rgb(31)), interlace=1),
     "interlace"),
    (lambda: _with_header(png.encode_png(_rgb(32)[..., 0]), depth=4),
     "bit depth 4"),
    (lambda: cv2.imencode(".jpg", _rgb(33))[1].tobytes(), "signature"),
    (lambda: png.encode_png(_rgb(34))[:-20] + b"\0" * 20, "CRC|truncated"),
])
def test_decode_png_refuses_what_it_does_not_read(make, what):
    with pytest.raises(ValueError, match=what):
        png.decode_png(make())


# --------------------------------------------------------------------------
# utils/image.py::read_image
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rgb, rgba = _rgb(40, 48, 70), _rgb(41, 48, 70, 4)
    cv2.imwrite(str(d / "rgb.png"), rgb)
    cv2.imwrite(str(d / "rgba.png"), rgba)
    cv2.imwrite(str(d / "gray.png"), rgb[..., 0])
    cv2.imwrite(str(d / "rgb.ppm"), rgb)
    cv2.imwrite(str(d / "gray.pgm"), rgb[..., 0])
    (d / "palette.png").write_bytes(_pil_png(rgb[..., 0], "P", palette=True))
    (d / "pil_rgb.png").write_bytes(_pil_png(rgb))
    cv2.imwrite(str(d / "rgb.jpg"), rgb)
    return d


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("name", ["rgb.png", "rgba.png", "gray.png",
                                  "rgb.ppm", "gray.pgm", "palette.png",
                                  "pil_rgb.png"])
def test_read_image_equals_jax_read_image(image_files, name, grayscale):
    """Exact, colour and gray (libpng's and OpenCV's fixed-point gray)."""
    want = jax_read_image(image_files / name, grayscale)
    got = read_image(image_files / name, grayscale)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_image_refuses_jpeg_naming_it(image_files, tmp_path):
    """cv2's JPEG reads as the JAX package reads it (the port's decoder);
    the same file cut short raises naming JPEG."""
    for grayscale in (False, True):
        np.testing.assert_array_equal(
            read_image(image_files / "rgb.jpg", grayscale),
            jax_read_image(image_files / "rgb.jpg", grayscale))
    data = (image_files / "rgb.jpg").read_bytes()
    (tmp_path / "cut.jpg").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="JPEG"):
        read_image(tmp_path / "cut.jpg")


# --------------------------------------------------------------------------
# ops/matching.py and the two matchers
# --------------------------------------------------------------------------

def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def descriptors():
    """B = 1 pair, D = 256, N0 = 512, N1 = 384, the last slots padded; 200
    of image 1's descriptors are noisy copies of image 0's."""
    rng = np.random.default_rng(0)
    d0, d1 = _unit(rng, 512, 256), _unit(rng, 384, 256)
    d1[:200] = d0[rng.permutation(512)[:200]] + 0.05 * _unit(rng, 200, 256)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0, m1 = np.arange(512) < 450, np.arange(384) < 350
    return d0, d1, m0, m1


NN_KW = [{}, {"ratio_thresh": 0.8}, {"distance_thresh": 0.7},
         {"do_mutual_check": False},
         {"ratio_thresh": 0.9, "distance_thresh": 0.9,
          "do_mutual_check": False}]


def _both(fn_j, fn_t, arrays, **kw):
    a = fn_j(*(jnp.asarray(x) for x in arrays), **kw)
    b = fn_t(*(torch.from_numpy(np.asarray(x)) for x in arrays), **kw)
    return a, b


def test_masked_similarity_equals_jax(descriptors):
    """Within 1e-6 (float32 products; on this CPU bit-equal)."""
    a, b = _both(jm.masked_similarity, tm.masked_similarity, descriptors)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"ratio_thresh": 0.8},
                                {"distance_thresh": 0.7},
                                {"ratio_thresh": 0.9, "distance_thresh": 0.9}])
def test_find_nn_and_mutual_check_equal_jax(descriptors, kw):
    """Matches exact, scores within 1e-6."""
    sim = np.asarray(jm.masked_similarity(*(jnp.asarray(x)
                                            for x in descriptors)))
    (m0j, s0j), (m0t, s0t) = _both(jm.find_nn, tm.find_nn, [sim], **kw)
    (m1j, _), (m1t, _) = _both(jm.find_nn, tm.find_nn, [sim.T], **kw)
    np.testing.assert_array_equal(m0t.numpy(), np.asarray(m0j))
    np.testing.assert_allclose(s0t.numpy(), np.asarray(s0j), atol=1e-6)
    np.testing.assert_array_equal(
        tm.mutual_check(m0t, m1t).numpy(),
        np.asarray(jm.mutual_check(m0j, m1j)))


@pytest.mark.parametrize("kw", NN_KW)
def test_mutual_nn_match_equals_jax(descriptors, kw):
    """Matches exact, scores within 1e-6."""
    a, b = _both(jm.mutual_nn_match, tm.mutual_nn_match, descriptors, **kw)
    np.testing.assert_array_equal(b["matches0"].numpy(),
                                  np.asarray(a["matches0"]))
    np.testing.assert_allclose(b["matching_scores0"].numpy(),
                               np.asarray(a["matching_scores0"]), atol=1e-6)
    assert (b["matches0"] > -1).sum() > 100


@pytest.mark.parametrize("kw", [{}, {"inv_temperature": 5.0,
                                     "match_threshold": 0.01}])
def test_dual_softmax_match_equals_jax(descriptors, kw):
    """Matches exact; scores and the assignment within 1e-6."""
    a, b = _both(jm.dual_softmax_match, tm.dual_softmax_match, descriptors,
                 **kw)
    np.testing.assert_array_equal(b["matches0"].numpy(),
                                  np.asarray(a["matches0"]))
    for key in ("matching_scores0", "similarity"):
        np.testing.assert_allclose(b[key].numpy(), np.asarray(a[key]),
                                   atol=1e-6)
    assert (b["matches0"] > -1).sum() > 100


def test_ties_take_the_lowest_index_as_jax():
    """Planted equal similarities: every row of image 0 ties over columns 1,
    3 and 4 of image 1 (exactly representable values), so the first and
    second neighbours are columns 1 and 3, as lax.top_k gives them."""
    d0 = np.zeros((4, 8), np.float32)
    d0[:, 0] = 1.0
    d1 = np.zeros((6, 8), np.float32)
    d1[[1, 3, 4], 0] = 1.0
    d1[[0, 2, 5], 1] = 1.0
    sim = d0 @ d1.T
    for kw in ({}, {"ratio_thresh": 0.8}):
        (mj, sj), (mt, st) = _both(jm.find_nn, tm.find_nn, [sim], **kw)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (tm.find_nn(torch.from_numpy(sim))[0] == 1).all()
    _, idx = tm._top2(torch.from_numpy(sim))
    assert idx[0].tolist() == [1, 3]
    for fn in ("mutual_nn_match", "dual_softmax_match"):
        a, b = _both(getattr(jm, fn), getattr(tm, fn), [d0, d1])
        np.testing.assert_array_equal(b["matches0"].numpy(),
                                      np.asarray(a["matches0"]))


@pytest.mark.parametrize("cls,jcls,conf", [
    (NearestNeighbor, JaxNN, {}),
    (NearestNeighbor, JaxNN, {"ratio_threshold": 0.8,
                              "do_mutual_check": False}),
    (NearestNeighbor, JaxNN, {"distance_threshold": 0.7}),
    (DualSoftMax, JaxDS, {}),
    (DualSoftMax, JaxDS, {"inv_temperature": 10, "match_threshold": 0.05}),
])
@pytest.mark.parametrize("masked", [True, False])
def test_matcher_basemodels_equal_jax(descriptors, cls, jcls, conf, masked):
    """(B, D, N) descriptors, masks given or defaulted to all valid:
    matches exact, scores within 1e-6; the same conf, inputs and meta."""
    d0, d1, m0, m1 = descriptors
    data = {"descriptors0": d0.T[None], "descriptors1": d1.T[None]}
    if masked:
        data.update(mask0=m0[None], mask1=m1[None])
    model, jmodel = cls(conf, device="cpu"), jcls(conf)
    assert model.conf == jmodel.conf and model.meta == jmodel.meta
    assert cls.required_inputs == jcls.required_inputs
    got, want = model(data), jmodel(data)
    assert set(got) == set(want)
    assert got["matches0"].dtype == torch.int32
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               atol=1e-6)


# --------------------------------------------------------------------------
# ui/modelcache.py
# --------------------------------------------------------------------------

class _Sized:
    def __init__(self, nbytes):
        self.params = {"w": np.zeros(nbytes, np.uint8)}


def _state(cache):
    return ([list(d) for d in (cache.t1, cache.t2, cache.b1, cache.b2)],
            cache.p)


# (key, model bytes): repeats, a ghost hit in B1, sizes past the budget
SCRIPT = [("a", 10), ("b", 20), ("a", 10), ("c", 30), ("d", 40),
          ("b", 20), ("e", 50), ("a", 10), ("f", 5), ("c", 30), ("g", 60),
          ("d", 40), ("d", 40), ("h", 15), ("e", 50), ("b", 20)]


def _load(cache, key, nbytes):
    conf = {"name": key, "nested": {"size": nbytes, "l": [1, 2]}}
    return cache.load_model(key, lambda c: _Sized(c["nested"]["size"]), conf)


@pytest.mark.parametrize("kind,kw,steps", [
    ("ARCSizeAwareModelCache", {"max_models": 3, "max_bytes": 100},
     len(SCRIPT)),
    # the JAX cache never returns from step 11 of this one (next test)
    ("ARCSizeAwareModelCache", {"max_models": 4, "max_bytes": 90}, 11),
])
def test_caches_evict_as_jax(kind, kw, steps):
    """The same script gives the same lists after every load (and the same
    models handed out)."""
    port, jax_ = getattr(tcache, kind)(**kw), getattr(jcache, kind)(**kw)
    for key, nbytes in SCRIPT[:steps]:
        a, b = _load(port, key, nbytes), _load(jax_, key, nbytes)
        assert _state(port) == _state(jax_)
        assert a.params["w"].nbytes == b.params["w"].nbytes
    port.clear()
    assert _state(port)[0] == [[], [], [], []]


def test_arc_evicts_where_the_jax_cache_loops_forever():
    """Finding in the JAX package: with T1 no longer than its target p and
    T2 empty, ``_replace`` evicts nothing, so ``load_model``'s loop over an
    overfull cache never ends (step 11 of SCRIPT at 4 models, 90 bytes).
    The port evicts T1's oldest entry there, and runs the whole script."""
    port, jax_ = (m.ARCSizeAwareModelCache(max_models=4, max_bytes=90)
                  for m in (tcache, jcache))
    for cache in (port, jax_):
        cache.t1.update({"x": (None, 50), "y": (None, 50)})
        cache.p = 2
    jax_._replace(False)  # the one call of the JAX fit loop, repeated
    assert list(jax_.t1) == ["x", "y"] and not jax_.b1  # no progress
    port._replace(False)  # outside the fit loop: as the JAX package
    assert list(port.t1) == ["x", "y"] and not port.b1
    port._replace(False, fit=True)
    assert list(port.t1) == ["y"] and list(port.b1) == ["x"]
    port.clear()
    for key, nbytes in SCRIPT:
        _load(port, key, nbytes)
        assert port._total_bytes() <= 90 and port._total_models() <= 4


def test_conf_key_and_tree_nbytes():
    conf = {"b": {"x": [1, {"y": 2.5}], "z": None}, "a": (3, "s")}
    assert tcache._conf_key(conf) == jcache._conf_key(conf)
    assert tcache._conf_key(conf) == tcache._conf_key(copy.deepcopy(conf))
    tree = {"w": torch.zeros(3, 4), "l": [torch.zeros(2, dtype=torch.bfloat16),
                                          (np.zeros(5, np.int64),)]}
    assert tcache.tree_nbytes(tree) == 48 + 4 + 40
    assert tcache.model_nbytes(NearestNeighbor({}, device="cpu")) == 0
    assert tcache.model_nbytes(torch.nn.Linear(3, 2)) == (6 + 2) * 4
    assert tcache.get_global_cache() is tcache.get_global_cache()


# --------------------------------------------------------------------------
# ui/utils.py: the zoo, run_matching, run_ransac
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["config/app.yaml",
                                  "imcui_tpu_torch/config/app.yaml"])
def test_matcher_zoo_equals_jax(path):
    want = jui.get_matcher_zoo(jui.load_config(ROOT / path)["matcher_zoo"])
    got = tui.get_matcher_zoo(tui.load_config(ROOT / path)["matcher_zoo"])
    assert got == want
    assert tui.load_config(ROOT / path) == jui.load_config(ROOT / path)


def test_zoo_entry_of_an_unported_model_raises_naming_it():
    """Both zoos are served whole, so the entry here is the root
    config/app.yaml's ``omniglue`` with a matcher no package has: it
    raises naming the model."""
    zoo = tui.get_matcher_zoo(tui.load_config(
        ROOT / "config/app.yaml")["matcher_zoo"])
    zoo["omniglue"]["matcher"]["model"]["name"] = "no_such_matcher"
    pair = chip_smoke.synthetic_pair(100, 80, 64)
    with pytest.raises(NotImplementedError, match="'no_such_matcher'"):
        tui.run_matching(pair[0], pair[1], key="omniglue",
                         matcher_zoo=zoo, device="cpu")


@pytest.fixture(scope="module")
def zoo_runs():
    """run_matching of both packages on one planted pair forced to 320 x
    240, on the packaged zoo, with both reading the trained trees and
    SuperPoint in fp32, where the two packages find the same keypoints (in
    bf16 they round in other places by design, ROADMAP.md section C: on
    this pair's ~120 keypoints that moves 10-20 % of the raw matches)."""
    img0, img1, _ = chip_smoke.synthetic_pair(100, 400, 300)
    out = {}
    for key in ("superpoint+NN", "superpoint+lightglue"):
        runs = []
        for ui in (jui, tui):
            zoo = ui.get_matcher_zoo(ui.load_config(
                ROOT / "imcui_tpu/config/app.yaml")["matcher_zoo"])
            zoo[key]["feature"]["model"].update(
                checkpoint_npz=str(WEIGHTS / "superpoint_adapted.npz"),
                precision="fp32")
            if key.endswith("lightglue"):
                zoo[key]["matcher"]["model"]["checkpoint_npz"] = str(
                    WEIGHTS / "lightglue_selftrained.npz")
            kw = {"device": "cpu"} if ui is tui else {}
            runs.append((ui.run_matching(
                img0, img1, key=key, matcher_zoo=zoo, force_resize=True,
                image_width=320, image_height=240, **kw), zoo))
        out[key] = runs
    return out


@pytest.mark.parametrize("key", ["superpoint+NN", "superpoint+lightglue"])
def test_run_matching_equals_jax(zoo_runs, key):
    """The zoo entry's conf takes the UI values in place in both packages;
    the pred keys are the JAX package's; the raw matches agree at IoU >=
    0.9 within 0.5 px (measured 1.0)."""
    (want, jzoo), (got, tzoo) = zoo_runs[key]
    assert tzoo[key] == jzoo[key]
    assert tzoo[key]["matcher"]["model"]["max_keypoints"] == \
        tui.DEFAULT_SETTING_MAX_FEATURES
    assert set(got) == set(want)
    assert len(got["mkeypoints0_orig"]) > 50
    iou = chip_smoke.raw_match_iou(got, want)
    assert iou >= 0.9, iou


def test_run_ransac_equals_filter_matches_on_the_cached_state(zoo_runs,
                                                             tmp_path):
    """Exact: the same RANSAC (seeded hypotheses) on a copy of the state;
    the pickle holds the same."""
    state = zoo_runs["superpoint+NN"][1][0]
    args = ("Homography", "TPU_LORANSAC", 8, 0.9999, 10000)
    want = tui.filter_matches(copy.deepcopy(state), *args[1:],
                              device="cpu")
    got = tui.run_ransac(copy.deepcopy(state), *args, output_dir=tmp_path,
                         device="cpu")
    for k in ("mmkeypoints0_orig", "mmkeypoints1_orig", "mmconf", "H"):
        np.testing.assert_array_equal(got[k], want[k])
    import pickle

    with open(tmp_path / "output.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["H"], want["H"])
    assert tui.run_ransac({}, *args, device="cpu") is None


def _jax_indices(mask, num_hypotheses, k, generator):
    """The hypothesis index set the JAX package's estimator draws."""
    idx = jransac._sample_indices(jax.random.PRNGKey(0),
                                  jnp.asarray(mask[0].numpy()),
                                  num_hypotheses, k)
    return torch.from_numpy(np.array(idx))[None].long()


def test_run_ransac_equals_jax_on_the_cached_state(zoo_runs, tmp_path):
    """run_ransac of both packages on copies of one cached state, the port
    drawing the JAX package's hypothesis index set: the same inlier set,
    confidences within 5e-4, H to 1e-3 relative, and the same in each
    pickle; no state gives None in both."""
    import pickle

    state = zoo_runs["superpoint+NN"][1][0]
    args = ("Homography", "TPU_LORANSAC", 8, 0.9999, 10000)
    want = jui.run_ransac(copy.deepcopy(state), *args,
                          output_dir=tmp_path / "jax")
    got = tui.run_ransac(copy.deepcopy(state), *args,
                         output_dir=tmp_path / "port", device="cpu",
                         sample=_jax_indices)
    assert len(want["mmkeypoints0_orig"]) > 50
    with open(tmp_path / "jax" / "output.pkl", "rb") as f:
        pickled_want = pickle.load(f)
    with open(tmp_path / "port" / "output.pkl", "rb") as f:
        pickled_got = pickle.load(f)
    for a, b in ((got, want), (pickled_got, pickled_want)):
        assert set(a) == set(b)
        for k in ("mmkeypoints0_orig", "mmkeypoints1_orig"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), k)
        np.testing.assert_allclose(a["mmconf"], np.asarray(b["mmconf"]),
                                   atol=5e-4)
        h = np.asarray(b["H"])
        np.testing.assert_allclose(a["H"], h, rtol=1e-3,
                                   atol=1e-3 * np.abs(h).max())
    assert jui.run_ransac({}, *args) is None
    assert tui.run_ransac({}, *args, device="cpu") is None
