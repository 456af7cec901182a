"""The dense (standalone) branch of the port against the JAX package on
the CPU: RGB preprocessing, the ``Roma`` wrapper, ``pipeline/match_dense``
and ``ImageMatchingAPI`` with ``{"matcher": "roma", "dense": True}`` at
the JAX tests' tiny configuration (DINOv2 "test", coarse_res 112²), in
float32 and bfloat16. Weights are the JAX init tree with seeded biases,
BN statistics and LayerScale gammas; images are ``chip_smoke``'s planted
pairs and numpy-seeded noise.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models import layers as jl
from imcui_tpu.models.matchers import roma as jr
from imcui_tpu.pipeline import match_dense as jdense
from imcui_tpu.ui import utils as jui
from imcui_tpu.utils import image as jimage
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models import layers as tl
from imcui_tpu_torch.pipeline import match_dense as tdense
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import image as timage
from imcui_tpu_torch.utils import weights
from imcui_tpu_torch.utils.png import encode_png

TINY = {"dinov2_variant": "test", "gp_dim": 512, "coarse_res": (112, 112),
        "max_keypoints": 64, "sample_recall_target": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The JAX package's RoMa looks for its checkpoint on the model hub
    first; offline it goes straight to its random init."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: RoMa's many small CPU ops wait at every
    parallel region's barrier under the suite's six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_tree(seed=0):
    """The JAX init tree (numpy) with its zero biases, unit BN statistics
    and 1e-5 LayerScale gammas replaced by seeded values."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        np.asarray, jr.init_params(jax.random.PRNGKey(0), TINY))

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name in ("gamma", "var"):
            return rng.uniform(0.5, 1.5, size=node.shape).astype(np.float32)
        if name in ("b", "bias", "mean"):
            return (rng.normal(size=node.shape) * 0.05).astype(np.float32)
        return node

    return walk(tree)


def _conf(mod):
    conf = mod.parse_match_config({"matcher": "roma", "dense": True})
    conf["matcher"]["model"].update(TINY)
    return conf


class Pair:
    """Both packages' APIs on the same weights; ``set_precision`` recasts
    the one tree for both (one model construction per package)."""

    def __init__(self):
        tree = tiny_tree()
        self.jp = jax.tree_util.tree_map(jnp.asarray, tree)
        self.tp = weights.params_from_jax(tree)
        self.japi = JaxAPI(_conf(jui))
        self.tapi = TorchAPI(_conf(tui), device="cpu")
        self.init_meta = dict(self.tapi.matcher.meta)
        weights.assert_tree_matches(self.tapi.matcher.params, self.tp, "roma")
        self.set_precision(None)

    def set_precision(self, precision):
        for api in (self.japi, self.tapi):
            api.matcher.conf["precision"] = precision
        self.japi.matcher.params = jl.apply_precision(self.jp, precision)
        self.tapi.matcher.params = tl.apply_precision(self.tp, precision)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(100, 601, 451)


def _rows(k0, k1):
    r = np.concatenate([np.asarray(k0), np.asarray(k1)], 1)
    return r[np.lexsort(r.T[::-1])]


# --------------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(451, 601), (1203, 901), (240, 320)])
def test_preprocess_rgb_force_resize_matches_jax(hw):
    """The roma entry's preprocessing: RGB, forced to 320 × 240, dfactor 8.
    atol 1e-5 on [0, 1] values, as the grayscale path."""
    rng = np.random.default_rng(hw[0])
    img = rng.uniform(0, 255, hw + (3,)).astype(np.uint8)
    conf = tdense.confs["roma"]["preprocessing"]
    assert conf == jdense.confs["roma"]["preprocessing"]
    want = jimage.preprocess(img, **conf)
    got = timage.preprocess(img, **conf)
    assert got["image"].shape == want["image"].shape == (1, 3, 256, 320)
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-5)
    for k in ("size", "original_size", "scale"):
        np.testing.assert_array_equal(got[k], want[k], k)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bf16"])
def test_roma_wrapper_matches_jax(pair, precision):
    """The BaseModel wrappers on a (1, 3, 96, 128) pair and a gray pair:
    same keys, shapes and mask. f32: the 64 correspondences agree as sets
    to 0.05 px (of a 128-px image) and the scores to 1e-3. bf16: which 64
    cells are drawn depends on certainties that saturate near 1, so only
    shapes, finiteness and range are held."""
    pair.set_precision(precision)
    jm, tm = pair.japi.matcher, pair.tapi.matcher
    assert pair.init_meta["pretrained"] is False
    assert "random init" in pair.init_meta["source"]
    want_dtype = torch.bfloat16 if precision else torch.float32
    assert all(v.dtype == want_dtype
               for v in weights.flatten_tree(tm.params).values())
    rng = np.random.default_rng(5)
    img0 = rng.uniform(size=(1, 3, 96, 128)).astype(np.float32)
    img1 = rng.uniform(size=(1, 3, 96, 128)).astype(np.float32)
    want = {k: np.asarray(v) for k, v in
            jm({"image0": img0, "image1": img1}).items()}
    got = {k: v.numpy() for k, v in
           tm({"image0": img0, "image1": img1}).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert got["keypoints0"].shape == (1, 64, 2)
    assert got["mask"].dtype == np.bool_
    assert np.isfinite(got["keypoints1"]).all()
    assert (got["keypoints0"][0, :, 0] <= 127.0 + 1e-3).all()
    assert (got["keypoints0"][0, :, 1] <= 95.0 + 1e-3).all()
    assert ((got["mconf"] >= 0) & (got["mconf"] <= 1)).all()
    if precision is None:
        np.testing.assert_allclose(
            _rows(got["keypoints0"][0], got["keypoints1"][0]),
            _rows(want["keypoints0"][0], want["keypoints1"][0]), atol=0.05)
        np.testing.assert_allclose(np.sort(got["mconf"][0]),
                                   np.sort(want["mconf"][0]), atol=1e-3)
    gray = tm({"image0": img0[:, :1], "image1": img1[:, :1]})
    assert gray["keypoints0"].shape == (1, 64, 2)
    with pytest.raises(KeyError):
        tm({"image0": img0})


# --------------------------------------------------------------------------
# match_dense and the API
# --------------------------------------------------------------------------

def test_match_images_matches_jax(pair, planted):
    """match_dense.match_images on a planted 601 × 451 pair, f32: the same
    keys, and the correspondences as sets to 0.05 px at the model's
    resolution and 0.1 px at the original one."""
    pair.set_precision(None)
    pconf = pair.tapi.match_conf["preprocessing"]
    want = jdense.match_images(pair.japi.matcher, planted[0], planted[1],
                               pconf)
    got = tdense.match_images(pair.tapi.matcher, planted[0], planted[1],
                              pconf)
    assert set(got) == set(want)
    assert got["image0_orig"] is planted[0]
    assert len(got["mkeypoints0"]) == len(want["mkeypoints0"]) == 64
    np.testing.assert_allclose(
        _rows(got["mkeypoints0"], got["mkeypoints1"]),
        _rows(want["mkeypoints0"], want["mkeypoints1"]), atol=0.05)
    np.testing.assert_allclose(
        _rows(got["mkeypoints0_orig"], got["mkeypoints1_orig"]),
        _rows(want["mkeypoints0_orig"], want["mkeypoints1_orig"]), atol=0.1)
    np.testing.assert_allclose(np.sort(got["mconf"]), np.sort(want["mconf"]),
                               atol=1e-3)
    np.testing.assert_array_equal(got["keypoints0"], got["mkeypoints0"])


def test_match_images_pads_two_aspect_ratios_to_one_canvas(pair):
    """A landscape and a portrait image land on the (256, 320) and
    (320, 256) canvases; both are padded to (320, 320) before the model."""
    pair.set_precision(None)
    rng = np.random.default_rng(8)
    img0 = rng.uniform(0, 255, (200, 300, 3)).astype(np.uint8)
    img1 = rng.uniform(0, 255, (300, 200, 3)).astype(np.uint8)
    pconf = {"grayscale": False, "resize_max": 320, "dfactor": 8}
    seen = []
    model = pair.tapi.matcher
    hook = model.register_forward_pre_hook(
        lambda mod, args: seen.append({k: np.asarray(v).shape
                                       for k, v in args[0].items()}))
    got = tdense.match_images(model, img0, img1, pconf)
    hook.remove()
    assert seen[0]["image0"] == seen[0]["image1"] == (1, 3, 320, 320)
    want = jdense.match_images(pair.japi.matcher, img0, img1, pconf)
    assert set(got) == set(want)
    np.testing.assert_allclose(
        _rows(got["mkeypoints0_orig"], got["mkeypoints1_orig"]),
        _rows(want["mkeypoints0_orig"], want["mkeypoints1_orig"]), atol=0.1)


def test_match_images_copies_line_outputs_and_handles_no_mask():
    """A model that returns lines and unmasked points: the keys of the JAX
    function, with the ``*_orig`` copies rescaled."""
    def model(data):
        n = 5
        k = torch.arange(n * 2, dtype=torch.float32).reshape(1, n, 2)
        lines = np.ones((3, 2, 2), np.float32)
        return {"keypoints0": k, "keypoints1": k + 1,
                "lines0": lines, "lines1": lines * 2,
                "line_keypoints0": lines[:, 0], "line_keypoints1": lines[:, 1]}

    img = np.zeros((96, 128, 3), np.uint8)
    pconf = {"grayscale": False, "resize_max": 64, "dfactor": 8}
    got = tdense.match_images(model, img, img, pconf)
    want = jdense.match_images(
        lambda d: {k: np.asarray(v) for k, v in model(d).items()}, img, img,
        pconf)
    assert set(got) == set(want)
    for k in want:
        if k.startswith("image"):
            continue
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert got["mconf"].shape == (5,)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_api_standalone_forward_matches_jax(pair, planted, precision):
    """ImageMatchingAPI(standalone).forward end to end. f32: the raw
    correspondences agree with the JAX package's as sets to 0.1 px at the
    original resolution. bf16: the certainties saturate and the drawn
    cells differ, so the image-0 grid points are held to the grid (they
    are cell centres in both) and the rest to shape and finiteness."""
    pair.set_precision(precision)
    want = pair.japi.forward(planted[0], planted[1])
    got = pair.tapi.forward(planted[0], planted[1])
    assert pair.tapi.standalone and pair.tapi.extractor is None
    assert pair.tapi.match_conf["model"]["match_threshold"] == 0.2
    assert set(want) - set(got) <= {"H1", "H2"}     # cv2's rectification
    assert set(got) <= set(want)
    for k in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf"):
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
    if precision is None:
        np.testing.assert_allclose(
            _rows(got["mkeypoints0_orig"], got["mkeypoints1_orig"]),
            _rows(want["mkeypoints0_orig"], want["mkeypoints1_orig"]),
            atol=0.1)
    else:
        cells = np.unique(np.round(np.concatenate(
            [got["mkeypoints0"], want["mkeypoints0"]]) % (320 / 112), 3))
        assert len(cells) < 2 * 112          # offsets on the 112-cell grid
    assert "geom_info" in got and "mmkeypoints0_orig" in got


def test_api_standalone_refuses_extract_and_cuda(pair, planted, tmp_path):
    with pytest.raises(RuntimeError, match="standalone"):
        pair.tapi.extract(np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(TypeError):
        pair.tapi.forward([1], [2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchAPI(_conf(tui))               # device defaults to "cuda"
    assert tdense.confs.keys() == jdense.confs.keys()
    assert tui.parse_match_config({"matcher": "roma", "dense": True})[
        "matcher"] == jui.parse_match_config(
            {"matcher": "roma", "dense": True})["matcher"]
    # the batch export writes its files (utils/h5lite) where it raised
    conf = _conf(tui)["matcher"]
    for name, image in zip(("a.png", "b.png"), planted[:2]):
        (tmp_path / name).write_bytes(encode_png(image))
    (tmp_path / "pairs.txt").write_text("a.png b.png\n")
    feats, matches = tdense.main(conf, tmp_path / "pairs.txt", tmp_path,
                                 tmp_path, max_kps=32, device="cpu")
    with h5py.File(feats, "r") as f:
        assert sorted(f.keys()) == ["a.png", "b.png"]
        assert 0 < len(f["a.png/keypoints"]) <= 32
    with h5py.File(matches, "r") as f:
        assert f["a.png/b.png/matches0"].dtype == np.int16
        assert (f["a.png/b.png/matches0"][()] >= 0).any()


def test_to_cpts_and_assign_keypoints_match_jax():
    rng = np.random.default_rng(9)
    kpts = rng.uniform(0, 50, (40, 2))
    assert tdense.to_cpts(kpts, 4) == jdense.to_cpts(kpts, 4)
    assert tdense.to_cpts(kpts, 0) == jdense.to_cpts(kpts, 0)
    cpts = jdense.to_cpts(kpts[:25], 4)
    np.testing.assert_array_equal(
        tdense.assign_keypoints(kpts, cpts, max_error=2),
        jdense.assign_keypoints(kpts, cpts, max_error=2))
    scores = rng.uniform(size=40)
    out = []
    for mod in (tdense, jdense):
        other, bins = [list(c) for c in cpts], [{} for _ in cpts]
        ids = mod.assign_keypoints(kpts, other, 2, update=True,
                                   ref_bins=bins, scores=scores, cell_size=4)
        out.append((ids, other, bins))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] and out[0][2] == out[1][2]
