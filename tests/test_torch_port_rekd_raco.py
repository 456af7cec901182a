"""REKD and RaCo: the port against the JAX package on the CPU. Each
extractor alone on one image whose valid part is smaller than the canvas,
REKD's rotation equivariance and its unused threshold, and the two ways
users reach them end to end through both ``ImageMatchingAPI``s: the
registry's ``rekd`` with ``NN-mutual``, and the root ``config/app.yaml``'s
``raco+lightglue`` (RaCo's keypoints, ALIKED's descriptors, LightGlue
with ``features="raco-aliked"``).

Every model runs on the port's seed-0 tree, carried to the JAX package's
layout by ``params_to_jax`` and checked against the layout of the JAX init
(``jax.eval_shape``); the JAX random init is never drawn.

Tolerances, float32 on both sides: the same valid keypoint set (slots
compared as sets within 1e-3 px: the JAX package's top-k and torch's
order equal scores differently), scores within 1e-4 of the largest,
descriptors within 1e-5 of the largest entry, covariances within 1e-5;
REKD's score map on a 90°-rotated image equal to the rotated score map
within 1e-5 of its largest value (the convolutions sum in another
order); end to end, the same keypoints and the same raw match set
(points within 1e-3 px), LightGlue at ``match_threshold`` 1e-6 on its
random tree.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import aliked as jaliked
from imcui_tpu.models.extractors import raco as jraco
from imcui_tpu.models.extractors import rekd as jrekd
from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.extractors import raco as traco
from imcui_tpu_torch.models.extractors import rekd as trekd
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

ROOT_YAML = Path(__file__).resolve().parents[1] / "config" / "app.yaml"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The JAX models look for checkpoints on the hub unless told not to."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the tier-1 run puts six test workers on eight
    cores, where many small CPU ops would each wait at a parallel region's
    barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _carried(init, ttree):
    """The port's tree in the JAX layout, checked against the layout of
    the JAX ``init`` (a thunk, only traced)."""
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(init)
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree


def _image(size, channels, seed=100):
    img = chip_smoke.synthetic_pair(seed, *size)[0]
    x = img.transpose(2, 0, 1)[None] / 255.0
    if channels == 1:
        x = x.mean(1, keepdims=True)
    return x.astype(np.float32)


def _same_set(got, want, n_least, extra=()):
    """One view's outputs of both packages: the same valid keypoint set
    within 1e-3 px, scores within 1e-4 and descriptors within 1e-5 of the
    largest, each key of ``extra`` (B, N, C) within 1e-5."""
    jm, tm = np.asarray(want["mask"][0]), got["mask"][0].numpy()
    assert tm.sum() == jm.sum() >= n_least, (tm.sum(), jm.sum())
    jk = np.asarray(want["keypoints"][0])[jm]
    tk = got["keypoints"][0].numpy()[tm]
    iou, it, ij = chip_smoke.common_points(tk, jk, 1e-3)
    assert iou == 1.0, iou
    js = np.asarray(want["scores"][0])[jm]
    assert np.abs(got["scores"][0].numpy()[tm][it] - js[ij]).max() \
        <= 1e-4 * max(1.0, np.abs(js).max())
    jd = np.asarray(want["descriptors"][0])[:, jm][:, ij]
    td = got["descriptors"][0].numpy()[:, tm][:, it]
    assert np.abs(td - jd).max() <= 1e-5 * max(1.0, np.abs(jd).max())
    for k in extra:
        je = np.asarray(want[k][0])[jm][ij]
        te = got[k][0].numpy()[tm][it]
        assert np.abs(te - je).max() <= 1e-5 * max(1.0, np.abs(je).max()), k
    return int(tm.sum())


# --------------------------------------------------------------------------
# REKD
# --------------------------------------------------------------------------

def _rekd_trees():
    ttree = trekd.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jrekd.init_params(KEY), ttree)
    return jtree, weights.params_from_jax(jtree)


def test_rekd_matches_jax():
    """``apply`` on a 128 x 96 canvas whose valid part is 123 x 93."""
    jtree, ttree = _rekd_trees()
    x = _image((128, 96), 1)
    vwh = np.array([[123, 93]], np.int32)
    want = jrekd.apply(jtree, jnp.asarray(x), jnp.asarray(vwh),
                       max_keypoints=96)
    got = trekd.apply(ttree, _t(x), torch.from_numpy(vwh), max_keypoints=96)
    _same_set(got, want, 50)
    tk = got["keypoints"][0].numpy()[got["mask"][0].numpy()]
    assert (tk[:, 0] <= 2 * (62 - 2)).all()
    assert (tk[:, 1] <= 2 * (47 - 2)).all()


def test_rekd_group_weights_match_jax_rotations():
    """The stacked kernels equal the JAX package's rot90 + roll, leaf for
    leaf: the lifting layer's and the first group layer's."""
    jtree, ttree = _rekd_trees()
    lift = np.concatenate([np.asarray(jrekd._rot_kernel(
        jtree["lift"]["w"], g)) for g in range(4)], -1)
    np.testing.assert_array_equal(
        weights.params_to_jax({"w": trekd.lift_weight(ttree["lift"]["w"])})
        ["w"], lift)
    w = jtree["gconv"][0]["w"]
    cin, cout = w.shape[2] // 4, w.shape[3]
    stacked = []
    for g in range(4):
        wg = np.asarray(jrekd._rot_kernel(w, g)).reshape(3, 3, 4, cin, cout)
        stacked.append(np.roll(wg, g, axis=2).reshape(3, 3, 4 * cin, cout))
    np.testing.assert_array_equal(
        weights.params_to_jax(
            {"w": trekd.group_weight(ttree["gconv"][0]["w"])})["w"],
        np.concatenate(stacked, -1))


def test_rekd_score_is_rotation_equivariant():
    """C4 equivariance by construction: the score map of the image turned
    by 90° is the turned score map, in both packages."""
    jtree, ttree = _rekd_trees()
    x = _t(_image((96, 64), 1))
    xr = torch.rot90(x, 1, dims=(2, 3))
    with torch.no_grad():
        s, _ = trekd.backbone(ttree, x)
        sr, _ = trekd.backbone(ttree, xr)
    want = torch.rot90(s, 1, dims=(1, 2))
    tol = 1e-5 * s.abs().max().item()
    assert (sr - want).abs().max().item() <= tol
    js, _ = jrekd.backbone(jtree, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    jsr, _ = jrekd.backbone(jtree, jnp.asarray(
        xr.numpy().transpose(0, 2, 3, 1)))
    assert np.abs(np.asarray(jsr) - np.rot90(np.asarray(js), 1, (1, 2))
                  ).max() <= tol
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=tol)


def test_rekd_ignores_its_threshold_as_jax():
    """``apply`` takes ``threshold`` and selects at 0.0 whatever it says
    (``rekd.py:99-110`` of the JAX package), and the wrapper passes the
    conf's ``keypoint_threshold`` on: 0.0 and 0.9 give the same output in
    both packages."""
    jtree, ttree = _rekd_trees()
    x = _image((64, 48), 1)
    vwh = np.array([[64, 48]], np.int32)
    outs = {}
    for th in (0.0, 0.9):
        outs["jax", th] = jrekd.apply(jtree, jnp.asarray(x), jnp.asarray(vwh),
                                      max_keypoints=32, threshold=th)
        outs["port", th] = trekd.apply(ttree, _t(x), torch.from_numpy(vwh),
                                       max_keypoints=32, threshold=th)
    for k in ("keypoints", "scores", "mask"):
        np.testing.assert_array_equal(np.asarray(outs["jax", 0.0][k]),
                                      np.asarray(outs["jax", 0.9][k]))
        np.testing.assert_array_equal(outs["port", 0.0][k].numpy(),
                                      outs["port", 0.9][k].numpy())
    # keypoints scoring below 0.9 are kept at 0.9
    for pkg in ("jax", "port"):
        mask = np.asarray(outs[pkg, 0.9]["mask"])
        assert mask.any()
        assert (np.asarray(outs[pkg, 0.9]["scores"])[mask] < 0.9).all()
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trekd, "apply",
                   lambda *a, threshold, **kw: seen.append(threshold) or {})
        trekd.REKD({"keypoint_threshold": 0.9}, device="cpu")(
            {"image": x})
    assert seen == [0.9]


# --------------------------------------------------------------------------
# RaCo
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sort_by_ranker,subpixel", [(False, True),
                                                     (True, False)])
def test_raco_detect_matches_jax(sort_by_ranker, subpixel):
    """``detect`` (keypoints, scores, covariance) on a 128 x 96 canvas
    whose valid part is 121 x 90; the descriptor is ALIKED's
    ``describe``, held in the end-to-end test."""
    ttree = traco.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jraco.init_params(KEY), ttree)
    x = _image((128, 96), 3)
    vwh = np.array([[121, 90]], np.int32)
    kw = dict(max_keypoints=64, nms_radius=3, subpixel=subpixel,
              subpixel_temp=0.5, sort_by_ranker=sort_by_ranker)
    jk, js, jc, jm = jraco.detect(jtree, jnp.asarray(x), jnp.asarray(vwh),
                                  **kw)
    tk, ts, tc, tm = traco.detect(weights.params_from_jax(jtree), _t(x),
                                  torch.from_numpy(vwh), **kw)
    want = {"keypoints": jk, "scores": js, "covariance": jc, "mask": jm,
            "descriptors": np.zeros((1, 1, jk.shape[1]), np.float32)}
    got = {"keypoints": tk, "scores": ts, "covariance": tc, "mask": tm,
           "descriptors": torch.zeros(1, 1, tk.shape[1])}
    _same_set(got, want, 30, extra=("covariance",))


# --------------------------------------------------------------------------
# end to end through both ImageMatchingAPIs
# --------------------------------------------------------------------------

def _jax_api(conf, mods, **kw):
    """The JAX package's ImageMatchingAPI without drawing its random
    trees: each of ``mods``' ``load_params`` returns no tree, and the
    caller sets one."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in mods:
            mp.setattr(mod, "load_params",
                       lambda *a, **k: (None, {"pretrained": False}))
        return JaxAPI(conf, **kw)


def _confs(get, feature_overrides, matcher_overrides):
    confs = []
    for ui in (jui, tui):
        conf = get(ui)
        conf["feature"]["model"].update(feature_overrides)
        conf["matcher"]["model"].update(matcher_overrides)
        conf["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(conf)
    return confs


def _compare(japi, tapi, size, n_least):
    planted = chip_smoke.synthetic_pair(101, *size)
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    assert set(got) == set(want)
    for k in ("keypoints0_orig", "keypoints1_orig"):
        assert len(got[k]) == len(want[k]) >= n_least, k
        assert chip_smoke.common_points(got[k], want[k], 1e-3)[0] == 1.0, k
    assert len(got["mkeypoints0_orig"]) >= 5
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0
    return got


def test_rekd_with_mutual_nn_end_to_end_matches_jax():
    """The registry's ``rekd`` extractor with ``NN-mutual`` (no app.yaml
    lists it) on a planted 256 x 192 pair at 128 keypoints."""
    confs = _confs(lambda ui: ui.parse_match_config(
        {"feature": "rekd", "matcher": "NN-mutual", "dense": False}), {}, {})
    japi = _jax_api(confs[0], (jrekd,), max_keypoints=128)
    tapi = TorchAPI(confs[1], device="cpu", max_keypoints=128)
    japi.extractor.params = _carried(lambda: jrekd.init_params(KEY),
                                     tapi.extractor.params)
    _compare(japi, tapi, (256, 192), 100)


def test_raco_lightglue_end_to_end_matches_jax():
    """The root app.yaml's ``raco+lightglue`` on a planted 128 x 96 pair:
    RaCo at 128 slots (it reads ``max_num_keypoints``, not the API's
    ``max_keypoints``), ALIKED-n16 describing, LightGlue cut to two
    layers at ``match_threshold`` 1e-6, all three on the port's trees."""
    confs = _confs(
        lambda ui: ui.get_matcher_zoo(ui.load_config(ROOT_YAML)[
            "matcher_zoo"])["raco+lightglue"],
        {"max_num_keypoints": 128}, {"n_layers": 2, "match_threshold": 1e-6})
    japi = _jax_api(confs[0], (jraco, jaliked, jlg), max_keypoints=128,
                    match_threshold=1e-6)
    tapi = TorchAPI(confs[1], device="cpu", max_keypoints=128,
                    match_threshold=1e-6)
    assert tapi.matcher.conf["features"] == "raco-aliked"
    assert tapi.matcher.conf["input_dim"] == 128
    japi.extractor.params = _carried(lambda: jraco.init_params(KEY),
                                     tapi.extractor.params)
    japi.extractor.describer.params = _carried(
        lambda: jaliked.init_params(KEY, **jaliked.SIZES["aliked-n16"]),
        tapi.extractor.describer.params)
    japi.matcher.params = _carried(
        lambda: jlg.init_params(KEY, japi.matcher.conf),
        tapi.matcher.params)
    _compare(japi, tapi, (128, 96), 50)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["rekd", "raco"])
def test_extractor_on_cuda_without_a_card_raises(name):
    from imcui_tpu_torch.models import extractors
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(extractors, name)({})
