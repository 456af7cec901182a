"""The port's general matching path on the CPU against the JAX package:
the registry, the BaseModel protocol, preprocessing options, both
BaseModel wrappers dict-in/dict-out, extract / match_images, the RANSAC
filter on JAX's hypothesis index set, and ImageMatchingAPI.forward whole.
Models run in fp32 with the trained weights, read by both packages from
the same npz trees; tolerances are stated per test."""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.configs import confs_dict as jconfs
from imcui_tpu.models.extractors.superpoint import SuperPoint as JaxSuperPoint
from imcui_tpu.models.matchers.lightglue import LightGlue as JaxLightGlue
from imcui_tpu.ops import ransac as jransac
from imcui_tpu.pipeline import extract_features as jextract
from imcui_tpu.pipeline import match_features as jmatch
from imcui_tpu.ui import utils as jui
from imcui_tpu.utils import image as jimage
from imcui_tpu_torch import models as tmodels
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.configs import confs_dict as tconfs
from imcui_tpu_torch.models import extractors as textractors
from imcui_tpu_torch.models import matchers as tmatchers
from imcui_tpu_torch.models.extractors.superpoint import SuperPoint
from imcui_tpu_torch.models.matchers.lightglue import LightGlue
from imcui_tpu_torch.pipeline import extract_features as textract
from imcui_tpu_torch.pipeline import match_features as tmatch
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import base_model as tbase
from imcui_tpu_torch.utils import image as timage

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
SP_NPZ = str(WEIGHTS / "superpoint_adapted.npz")
LG_NPZ = str(WEIGHTS / "lightglue_selftrained.npz")
ATOL = 5e-4  # the goldens' precedent (tests/test_goldens.py)


# --------------------------------------------------------------------------
# registry, protocol
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["extractors", "matchers"])
def test_registry_equals_jax(kind):
    assert tconfs[kind] == jconfs[kind]
    assert tconfs[kind] is not jconfs[kind]


def test_constants_and_zoo_keys_equal_jax():
    for name in ("DEFAULT_SETTING_THRESHOLD", "DEFAULT_SETTING_MAX_FEATURES",
                 "DEFAULT_DEFAULT_KEYPOINT_THRESHOLD", "DEFAULT_ENABLE_RANSAC",
                 "DEFAULT_RANSAC_METHOD", "DEFAULT_RANSAC_REPROJ_THRESHOLD",
                 "DEFAULT_RANSAC_CONFIDENCE", "DEFAULT_RANSAC_MAX_ITER",
                 "DEFAULT_MIN_NUM_MATCHES", "DEFAULT_MATCHING_THRESHOLD",
                 "DEFAULT_SETTING_GEOMETRY"):
        assert getattr(tui, name) == getattr(jui, name), name
    assert set(tui.ransac_zoo) == set(jui.ransac_zoo)
    assert TorchAPI.default_conf == JaxAPI.default_conf


def test_parse_match_config_equals_jax():
    zoo = {"feature": "superpoint_inloc", "matcher": "superpoint-lightglue",
           "dense": False, "info": {"name": "x"}}
    got = tui.parse_match_config(zoo)
    assert got == jui.parse_match_config(zoo)
    got["feature"]["model"]["max_keypoints"] = 7  # a copy, not the registry
    assert tconfs["extractors"]["superpoint_inloc"]["model"][
        "max_keypoints"] == 4096


def test_merge_confs_and_dynamic_load():
    merged = tbase.merge_confs({"a": {"b": 1, "c": 2}, "d": 3},
                               {"a": {"b": 5}, "e": 6})
    assert merged == {"a": {"b": 5, "c": 2}, "d": 3, "e": 6}
    assert tbase.dynamic_load(textractors, "superpoint") is SuperPoint
    assert tbase.dynamic_load(tmatchers, "lightglue") is LightGlue
    with pytest.raises(NotImplementedError, match="not ported"):
        tbase.dynamic_load(tmatchers, "no_such_matcher")
    assert tbase.dynamic_load(tmatchers, "omniglue").__name__ == "OmniGlue"
    assert tbase.dynamic_load(tmatchers, "gluestick").__name__ == "GlueStick"
    assert tmodels.__name__ == "imcui_tpu_torch.models"


def test_base_model_checks_required_inputs_and_device():
    sp = SuperPoint({"checkpoint_npz": SP_NPZ}, device="cpu")
    assert sp.meta["pretrained"] and isinstance(sp, torch.nn.Module)
    with pytest.raises(KeyError, match="image"):
        sp({})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SuperPoint({"checkpoint_npz": SP_NPZ})


def test_random_init_is_recorded_in_meta(tmp_path):
    sp = SuperPoint({"checkpoint_npz": str(tmp_path / "absent.npz")},
                    device="cpu")
    assert sp.meta["pretrained"] is False
    lg = LightGlue({"features": "disk", "n_layers": 2}, device="cpu")
    assert lg.meta["pretrained"] is False
    assert lg.params["input_proj"]["w"].shape == (256, 128)
    assert len(lg.params["token_confidence"]) == 1


# --------------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(200, 150), (64, 150), (50, 40)])
def test_resize_linear_matches_cv2(size):
    """atol 1e-3 on a 0–255 scale, as the area resize."""
    img = np.random.default_rng(0).uniform(0, 255, (97, 133)).astype(
        np.float32)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(timage.resize_linear(img, size), want,
                               atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(force_resize=True, width=640, height=480, resize_max=1600),
    dict(force_resize=True, width=160, height=120,
         interpolation="cv2_linear"),
    dict(resize_max=200, dfactor=16),
    dict(grayscale=False, resize_max=256),
])
def test_preprocess_options_match_jax(kw):
    """atol 1e-5 on [0, 1] images, as the serving preprocess."""
    rgb = np.random.default_rng(1).integers(0, 255, (301, 401, 3)).astype(
        np.uint8)
    got, want = timage.preprocess(rgb, **kw), jimage.preprocess(rgb, **kw)
    assert got["image"].shape == want["image"].shape
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-5)
    for k in ("size", "original_size", "scale"):
        np.testing.assert_array_equal(got[k], want[k])


def test_load_conf_and_unported_interpolations():
    conf = {"resize_max": 1600, "grayscale": True}
    assert vars(timage.load_conf(conf)) == vars(jimage.load_conf(conf))
    assert vars(timage.load_conf(None)) == vars(jimage.load_conf(None))
    img = np.zeros((20, 30), np.float32)
    with pytest.raises(NotImplementedError, match="cv2"):
        timage.resize_image(img, (10, 10), "cv2_cubic")
    with pytest.raises(NotImplementedError, match="PIL"):
        timage.resize_image(img, (10, 10), "pil_linear")


# --------------------------------------------------------------------------
# the two wrappers, dict in / dict out
# --------------------------------------------------------------------------

def _images():
    imgs = np.stack([chip_smoke.textured_image(np.random.default_rng(s),
                                               160, 224) for s in (5, 6)])
    return imgs[:, None].astype(np.float32) / 255


@pytest.mark.parametrize("conf", [
    {"max_keypoints": 256, "keypoint_threshold": 0.0005},
    {"max_keypoints": 128, "nms_radius": 3, "subpixel": True},
    {"max_keypoints": -1},
])
def test_superpoint_wrapper_matches_jax(conf):
    """fp32: keypoints (subpixel ones to 1e-4 px), masks equal; scores and
    descriptors within 5e-4."""
    conf = {**conf, "precision": "fp32", "checkpoint_npz": SP_NPZ}
    jm, tm = JaxSuperPoint(conf), SuperPoint(conf, device="cpu")
    data = {"image": _images()}
    if conf["max_keypoints"] == 128:
        data["valid_wh"] = np.array([[224, 160], [200, 150]], np.int32)
    want, got = jm(data), tm(data)
    if conf["max_keypoints"] == -1:
        assert tm.conf["max_keypoints"] == 4096
        assert got["keypoints"].shape == (2, 4096, 2)
    assert set(got) == set(want)
    mask = np.asarray(want["mask"])
    assert mask.sum() > 100
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_allclose(got["keypoints"].numpy(),
                               np.asarray(want["keypoints"]), atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=ATOL)
    m = np.broadcast_to(mask[:, None], got["descriptors"].shape)
    np.testing.assert_allclose(got["descriptors"].numpy()[m],
                               np.asarray(want["descriptors"])[m], atol=ATOL)


def _features(rng, b, n0, n1):
    kpts0 = rng.uniform(0, 200, (b, n0, 2)).astype(np.float32)
    desc0 = rng.normal(size=(b, n0, 256)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    perm = rng.permutation(n0)[:n1]
    kpts1 = kpts0[:, perm] + rng.normal(size=(b, n1, 2)).astype(np.float32)
    desc1 = desc0[:, perm] + 0.05 * rng.normal(size=(b, n1, 256)).astype(
        np.float32)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    return kpts0, kpts1, desc0, desc1


@pytest.mark.parametrize("sizes", ["size", "image", "extent"])
def test_lightglue_wrapper_matches_jax(sizes):
    """The registry's adaptive conf, trained weights, (B, D, N) descriptors
    in: stop_layer and matches0 equal, scores within 5e-4."""
    conf = {**tconfs["matchers"]["superpoint-lightglue"]["model"],
            "checkpoint_npz": LG_NPZ}
    jm, tm = JaxLightGlue(conf), LightGlue(conf, device="cpu")
    rng = np.random.default_rng(3)
    kpts0, kpts1, desc0, desc1 = _features(rng, 2, 96, 80)
    data = {"keypoints0": kpts0, "keypoints1": kpts1,
            "descriptors0": desc0.transpose(0, 2, 1),
            "descriptors1": desc1.transpose(0, 2, 1)}
    if sizes == "size":
        data["size0"] = data["size1"] = np.array([[224, 160]] * 2, np.float32)
        mask1 = np.ones((2, 80), bool)
        mask1[1, 50:] = False
        data["mask1"] = mask1
    elif sizes == "image":
        data["image0"] = data["image1"] = np.zeros((2, 1, 208, 240),
                                                   np.float32)
    want, got = jm(data), tm(data)
    assert set(got) == set(want) == {"matches0", "matching_scores0",
                                     "stop_layer"}
    np.testing.assert_array_equal(got["stop_layer"].numpy(),
                                  np.asarray(want["stop_layer"]))
    assert (np.asarray(want["matches0"]) > -1).sum() > 40
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               atol=ATOL)


def test_lightglue_wrapper_static_depth_and_scale_ori():
    """depth_confidence 0 takes the static path (no stop_layer); SIFT mode
    appends scale and orientation to the positional encoding. Random init
    on both sides, the JAX tree converted; matches equal, scores 5e-4."""
    from imcui_tpu_torch.utils import weights as tweights

    conf = {"features": "sift", "n_layers": 2, "depth_confidence": 0,
            "add_scale_ori": True, "match_threshold": 0.0}
    jm, tm = JaxLightGlue(conf), LightGlue(conf, device="cpu")
    assert not jm.meta["pretrained"]
    tm.params = tweights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params))
    rng = np.random.default_rng(4)
    kpts0, kpts1, _, _ = _features(rng, 1, 40, 40)
    data = {"keypoints0": kpts0, "keypoints1": kpts1,
            "descriptors0": rng.normal(size=(1, 128, 40)).astype(np.float32),
            "descriptors1": rng.normal(size=(1, 128, 40)).astype(np.float32),
            "size0": np.array([[224, 160]], np.float32),
            "size1": np.array([[224, 160]], np.float32)}
    for k in ("scales0", "scales1", "oris0", "oris1"):
        data[k] = rng.uniform(0.5, 2.0, (1, 40)).astype(np.float32)
    want, got = jm(data), tm(data)
    assert set(got) == set(want) == {"matches0", "matching_scores0"}
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               atol=ATOL)


# --------------------------------------------------------------------------
# pipeline helpers and the RANSAC filter
# --------------------------------------------------------------------------

def test_feature_helpers_match_jax():
    for n in (1, 256, 257, 4096, 5000, 9000):
        assert tmatch.kpt_bucket(n) == jmatch.kpt_bucket(n)
    rng = np.random.default_rng(5)
    kpts = rng.uniform(0, 50, (7, 2)).astype(np.float32)
    sc, desc = rng.uniform(size=7), rng.normal(size=(16, 7))
    got = tmatch.pad_features(kpts, sc, desc, 12, scales=sc, oris=sc)
    want = jmatch.pad_features(kpts, sc, desc, 12, scales=sc, oris=sc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        tmatch.pad_features(kpts, sc, desc, 5)
    for scale in ([1.0, 1.0], [1.5, 0.75]):
        np.testing.assert_array_equal(tmatch.scale_keypoints(kpts, scale),
                                      jmatch.scale_keypoints(kpts, scale))
    assert tmatch.confs == jmatch.confs and textract.confs == jextract.confs


def _api_conf(mod, resize_max):
    conf = mod.parse_match_config({"feature": "superpoint_inloc",
                                   "matcher": "superpoint-lightglue",
                                   "dense": False})
    conf["feature"]["model"].update(precision="fp32", checkpoint_npz=SP_NPZ)
    conf["feature"]["preprocessing"]["resize_max"] = resize_max
    conf["matcher"]["model"]["checkpoint_npz"] = LG_NPZ
    return conf


@pytest.fixture(scope="module")
def apis():
    kw = dict(max_keypoints=512, detect_threshold=0.005)
    return (JaxAPI(_api_conf(jui, 448), **kw),
            TorchAPI(_api_conf(tui, 448), device="cpu", **kw))


@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(100, 601, 451)


def test_extract_and_trim_valid_match_jax(apis, planted):
    japi, tapi = apis
    pconf = tapi.extract_conf["preprocessing"]
    want = jextract.extract(japi.extractor, planted[0], pconf)
    got = textract.extract(tapi.extractor, planted[0], pconf)
    assert set(got) == set(want)
    for k in ("keypoints", "mask", "size", "original_size", "image_size"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    # the area resize is restated in numpy: 1e-5 on [0, 1], as preprocess
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-5)
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               atol=ATOL)
    tw, tg = jextract.trim_valid(want), textract.trim_valid(got)
    assert set(tg) == set(tw) and len(tg["keypoints"]) > 200
    np.testing.assert_array_equal(tg["keypoints"], tw["keypoints"])
    np.testing.assert_allclose(tg["descriptors"], tw["descriptors"],
                               atol=ATOL)


def test_api_extract_matches_jax(apis, planted):
    japi, tapi = apis
    kw = dict(max_keypoints=128, keypoint_threshold=0.001, binarize=True)
    want, got = japi.extract(planted[1], **kw), tapi.extract(planted[1], **kw)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["keypoints"], want["keypoints"])
    np.testing.assert_allclose(got["keypoints_orig"], want["keypoints_orig"],
                               atol=1e-4)
    assert got["descriptors"].shape == want["descriptors"].shape
    # a sign bit may flip where a descriptor entry is within 5e-4 of zero
    assert (got["descriptors"] != want["descriptors"]).mean() < 1e-3


def _jax_indices(mask, num_hypotheses, k, generator):
    """The hypothesis index set the JAX package's estimator draws."""
    idx = jransac._sample_indices(jax.random.PRNGKey(0),
                                  jnp.asarray(mask[0].numpy()),
                                  num_hypotheses, k)
    return torch.from_numpy(np.array(idx))[None].long()


def test_api_forward_matches_jax(apis, planted):
    """The slice whole, fp32, on a planted pair at a 448-px canvas: the
    same keypoints and raw matches, confidences within 5e-4, adaptive depth
    stopping at the same layer; with JAX's hypothesis index set injected
    into the RANSAC filter the same inlier set and H to 1e-3 relative; with
    the port's own draws both pass the inlier gate."""
    japi, tapi = apis
    img0, img1, hm = planted
    stops = []
    hook = tapi.matcher.register_forward_hook(
        lambda mod, args, out: stops.append(out["stop_layer"].tolist()))
    want = japi(img0, img1)
    got = tapi(img0, img1)
    hook.remove()
    assert set(got) == set(want)
    for k in ("keypoints0", "keypoints1", "mkeypoints0", "mkeypoints1"):
        np.testing.assert_array_equal(got[k], want[k], k)
    for k in ("keypoints0_orig", "keypoints1_orig", "mkeypoints0_orig",
              "mkeypoints1_orig"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["mconf"], want["mconf"], atol=ATOL)
    assert len(want["mkeypoints0"]) > 100

    feats = [jextract.extract(japi.extractor, im,
                              japi.extract_conf["preprocessing"])
             for im in (img0, img1)]
    data = {f"{k}{i}": np.asarray(f[k]) for i, f in enumerate(feats)
            for k in ("keypoints", "descriptors", "mask", "image")}
    assert stops == [[int(japi.matcher(data)["stop_layer"][0])]]
    assert stops[0][0] < 9  # the trained confidence heads do exit early

    for pred in (want, got):
        err = chip_smoke.transfer_errors(hm, pred["mmkeypoints0_orig"],
                                         pred["mmkeypoints1_orig"])
        assert len(err) >= chip_smoke.GATE_MIN_INLIERS
        assert np.median(err) <= chip_smoke.GATE_MEDIAN_PX

    raw = {k: got[k] for k in ("mkeypoints0_orig", "mkeypoints1_orig",
                               "mconf")}
    injected = tui.filter_matches(
        dict(raw), ransac_reproj_threshold=3, ransac_max_iter=10000,
        device="cpu", sample=_jax_indices)
    np.testing.assert_array_equal(injected["mmkeypoints0_orig"],
                                  want["mmkeypoints0_orig"])
    np.testing.assert_allclose(injected["mmconf"], want["mmconf"], atol=ATOL)
    np.testing.assert_allclose(injected["H"], want["H"], rtol=1e-3,
                               atol=1e-3 * np.abs(want["H"]).max())
    assert set(injected["geom_info"]) == {"Fundamental", "Homography"}


def test_filter_matches_edge_cases_and_cv2_methods():
    few = {"mkeypoints0_orig": np.zeros((3, 2)),
           "mkeypoints1_orig": np.zeros((3, 2)), "mconf": np.zeros(3)}
    out = tui.filter_matches(dict(few), device="cpu")
    assert out["H"] is None and out["geom_info"] == {}
    assert len(out["mmkeypoints0_orig"]) == 0
    assert tui.filter_matches({}, device="cpu")["H"] is None
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 100, (30, 2))
    with pytest.raises(NotImplementedError, match="cv2"):
        tui.filter_matches({"mkeypoints0_orig": pts, "mkeypoints1_orig": pts,
                            "mconf": np.ones(30)},
                           ransac_method="CV2_USAC_MAGSAC", device="cpu")


def test_api_standalone_and_visualize_are_not_ported(apis):
    # the standalone branch is open; a dense matcher without a model in the
    # port still raises, naming the model (every matcher of the JAX
    # package is ported, so the name is one no package has)
    with pytest.raises(NotImplementedError,
                       match="'no_such_matcher' is not ported"):
        TorchAPI({"standalone": True,
                  "matcher": {"model": {"name": "no_such_matcher"}}},
                 device="cpu")
    with pytest.raises(NotImplementedError, match="cv2"):
        apis[1].visualize()
    with pytest.raises(TypeError):
        apis[1]("a.png", "b.png")
