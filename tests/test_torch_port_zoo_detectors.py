"""The sparse zoo's detectors on parts already ported, the port against
the JAX package on the CPU: D2-Net (and RoRD, the same module) with its
zero-padded ``avg_pool_s1`` and soft detection, DeDoDe with its coverage
re-weighting, ResNet's basic block and SFD2, and the standalone
``xfeat(dense)`` and ``xfeat+lightglue``; then the zoo entries end to end
through both ``ImageMatchingAPI``s: the packaged ``xfeat(dense)``,
``dedode`` and ``rord`` and the root ``config/app.yaml``'s
``xfeat+lightglue``, ``d2net`` and ``sfd2+mnn``.

Every model runs on the port's seed-0 tree, carried to the JAX package's
layout by ``params_to_jax`` and checked against the layout of the JAX init
(``jax.eval_shape``: the JAX init runs op by op, seconds a model).

Tolerances, float32 on both sides:
- the ops and the basic block: 1e-5 relative to the largest value;
- each extractor on one preprocessed image (alone, and inside its zoo
  entry's test as the API preprocesses it): the same keypoint set (slots
  compared as sets, within 1e-3 px), scores within 1e-4 of the largest,
  descriptors within 1e-4 (unit vectors);
- end to end on a planted 128 × 96 or 256 × 192 pair: the same valid
  keypoints and the same raw match set (points within 1e-3 px); for
  D2-Net and RoRD an IoU of at least 0.98 (see ENTRIES: their score map
  is flat to float32's last bits).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.backbones import resnet as jresnet
from imcui_tpu.models.extractors import d2net as jd2net
from imcui_tpu.models.extractors import dedode as jdedode
from imcui_tpu.models.extractors import sfd2 as jsfd2
from imcui_tpu.models.extractors import xfeat as jxfeat
from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.backbones import resnet as tresnet
from imcui_tpu_torch.models.extractors import d2net as td2net
from imcui_tpu_torch.models.extractors import dedode as tdedode
from imcui_tpu_torch.models.extractors import sfd2 as tsfd2
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

ROOT = Path(__file__).resolve().parents[1]
PACKAGED_YAML = ROOT / "imcui_tpu_torch" / "config" / "app.yaml"
ROOT_YAML = ROOT / "config" / "app.yaml"
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
    cores, where this file's many small CPU ops would each wait at a
    parallel region's barrier (several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1.0, np.abs(np.asarray(want)).max()))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# ops and blocks
# --------------------------------------------------------------------------

def test_avg_pool_s1_pads_the_last_row_and_column_with_zeros():
    """The JAX function's reduce_window starts from 0 over a (0, 1)
    padding, so the last row and column average two real taps and two
    zeros (its docstring says replicate-pad; the code is the reference)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    want = np.asarray(jd2net.avg_pool_s1(jnp.asarray(x)))
    got = td2net.avg_pool_s1(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) < 1e-6
    np.testing.assert_allclose(got[:, -1, :-1],
                               (x[:, -1, :-1] + x[:, -1, 1:]) / 4, atol=1e-6)
    np.testing.assert_allclose(got[:, :-1, -1],
                               (x[:, :-1, -1] + x[:, 1:, -1]) / 4, atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1] / 4, atol=1e-6)


def test_d2_scores_match_jax():
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 11, 13, 16)).astype(np.float32)
    feats[1] *= 5.0
    want = np.asarray(jd2net.d2_scores(jnp.asarray(feats)))
    got = td2net.d2_scores(_nchw(feats)).numpy()
    assert got.shape == (2, 11, 13)
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(got.sum((1, 2)), 1.0, atol=1e-5)


@pytest.mark.parametrize("cin,cout,stride", [(8, 8, 1), (8, 16, 2),
                                             (16, 16, 2)])
def test_basic_block_matches_jax(cin, cout, stride):
    """ResNet's basic block, with the downsample where the stride or the
    width changes, on BatchNorm statistics that are not the init's."""
    rng = np.random.default_rng(2)
    jtree = weights.params_to_jax(tresnet.init_basic_block(
        torch.Generator().manual_seed(3), cin, cout, stride))
    shapes = jax.eval_shape(
        lambda: jresnet.init_basic_block(KEY, cin, cout, stride))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    for path, leaf in weights.flatten_tree(jtree).items():
        if path.endswith(("mean", "bias")):
            leaf[...] = rng.normal(size=leaf.shape)
        elif path.endswith(("var", "scale")):
            leaf[...] = rng.uniform(0.5, 2.0, leaf.shape)
    x = rng.normal(size=(2, 10, 14, cin)).astype(np.float32)
    want = np.asarray(jresnet.basic_block(jtree, jnp.asarray(x), stride))
    got = tresnet.basic_block(weights.params_from_jax(jtree), _nchw(x),
                              stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_coverage_reweight_matches_jax():
    """DeDoDe's 51-tap re-weighting on a map narrower than its kernel in
    one axis (the zero padding reaches across it)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (2, 40, 70)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum((1, 2), keepdims=True)
    want = np.stack([np.asarray(jdedode.coverage_reweight(jnp.asarray(q)))
                     for q in p])
    got = tdedode.coverage_reweight(_t(p)).numpy()
    assert _rel(got / want.max(), want / want.max()) < 1e-5


def test_dedode_random_tree_spreads_its_detections():
    """The seed-0 tree's residual branches start at RESIDUAL_INIT of He's
    scale: with full-scale branches the detector's logits reach ~1e7 and
    its softmax leaves every slot but one at 0."""
    model = tdedode.DeDoDe({"max_keypoints": 64}, device="cpu")
    img = chip_smoke.synthetic_pair(103, 96, 64)[0]
    out = model({"image": _t(img.transpose(2, 0, 1)[None] / 255.0)})
    scores = out["scores"][0]
    assert bool(out["mask"].all()) and float(scores.min()) > 0.0
    assert len(torch.unique(scores)) == 64
    assert not model.meta["pretrained"]


# --------------------------------------------------------------------------
# the extractors, both packages, on one preprocessed image
# --------------------------------------------------------------------------

EXTRACTORS = {"d2net": (jd2net, td2net), "sfd2": (jsfd2, tsfd2)}


def _carried(jmod, ttree, init=None):
    """The port's tree in the JAX layout, checked against the JAX init's."""
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(init or (lambda: jmod.init_params(KEY)))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree


@pytest.mark.parametrize("name", list(EXTRACTORS))
def test_extractor_matches_jax(name):
    """D2-Net and SFD2 alone on a 200 × 144 image, where tens of cells of
    their 1/4-resolution maps survive the NMS, with a valid part smaller
    than the canvas. (DeDoDe's JAX program takes seconds to compile: it is
    held to the same bounds inside its zoo entry's test below.)"""
    jmod, tmod = EXTRACTORS[name]
    jtree = _carried(jmod, tmod.init_params(torch.Generator().manual_seed(0)))
    w, h = 200, 144
    img = chip_smoke.synthetic_pair(100, w, h)[0]
    x = (img.transpose(2, 0, 1)[None] / 255.0).astype(np.float32)
    vwh = np.array([[w - 3, h - 5]], np.int32)  # a padded canvas's valid part
    want = {k: np.asarray(v) for k, v in jmod.apply(
        jtree, jnp.asarray(x), jnp.asarray(vwh), max_keypoints=128).items()}
    got = tmod.apply(weights.params_from_jax(jtree), _t(x),
                     torch.from_numpy(vwh), max_keypoints=128)
    jm, tm = want["mask"][0], got["mask"][0].numpy()
    assert tm.sum() == jm.sum() >= 20, (tm.sum(), jm.sum())
    jk, tk = want["keypoints"][0][jm], got["keypoints"][0].numpy()[tm]
    d = np.abs(tk[:, None] - jk[None]).max(-1)
    j = d.argmin(1)
    assert d[np.arange(len(tk)), j].max() <= 1e-3 and len(set(j)) == len(tk)
    assert (tk[:, 0] < w - 3).all() and (tk[:, 1] < h - 5).all()
    assert _rel(got["scores"][0].numpy()[tm] / want["scores"].max(),
                want["scores"][0][jm][j] / want["scores"].max()) <= 1e-4
    td = got["descriptors"][0].numpy()[:, tm]
    assert np.abs(td - want["descriptors"][0][:, jm][:, j]).max() <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(td, axis=0), 1.0, atol=1e-5)


# --------------------------------------------------------------------------
# the zoo entries end to end through both ImageMatchingAPIs
# --------------------------------------------------------------------------

# (yaml, key) → (matcher overrides, planted pair size, least IoU of the
# keypoint and raw-match sets): the standalone XFeat pipelines at 1024
# slots (a 128 × 96 pair holds a few hundred keypoints), LightGlue cut to
# two layers; the
# Dual-Softmax at 1e-6, since on DeDoDe's random tree no assignment reaches
# its 0.2; the entries whose maps are at 1/4 on a 256 × 192 pair, where
# tens of cells survive their NMS on the random trees. D2-Net's score is
# nearly flat (every cell ≈ α at its arg-max channel, whose β is 1), so
# neighbours and the top-k cut lie within float32's last bits of each
# other: the two packages' 1e-6 differences move one or two of 129 cells
# (IoU 0.984 on this pair), hence 0.98 for D2-Net and RoRD, 1.0 elsewhere
ENTRIES = {
    ("packaged", "xfeat(dense)"): ({"max_keypoints": 1024}, (128, 96), 1.0),
    ("packaged", "dedode"): ({"match_threshold": 1e-6}, (128, 96), 1.0),
    ("packaged", "rord"): ({}, (256, 192), 0.98),
    ("root", "xfeat+lightglue"): ({"n_layers": 2, "max_keypoints": 1024},
                                  (128, 96), 1.0),
    ("root", "d2net"): ({}, (256, 192), 0.98),
    ("root", "sfd2+mnn"): ({}, (256, 192), 1.0),
}
YAMLS = {"packaged": PACKAGED_YAML, "root": ROOT_YAML}
# the JAX init of each model, for its layout, by module
JAX_INIT = {jd2net: lambda c: jd2net.init_params(KEY),
            jdedode: lambda c: jdedode.init_params(KEY),
            jsfd2: lambda c: jsfd2.init_params(KEY),
            jxfeat: lambda c: jxfeat.init_params(KEY),
            jlg: lambda c: jlg.init_params(KEY, c)}


def _jax_api(conf, **kw):
    """The JAX package's ImageMatchingAPI on ``conf`` without drawing its
    random trees: each model's ``load_params`` returns no tree, and the
    caller sets one."""
    mp = pytest.MonkeyPatch()
    for mod in JAX_INIT:
        mp.setattr(mod, "load_params", lambda c: (None, {"pretrained": False}))
    try:
        return JaxAPI(conf, **kw)
    finally:
        mp.undo()


def _share(tmodel, jmodel):
    """The port model's seed-0 tree to the JAX model (layout checked),
    and back through ``params_from_jax``."""
    jmod = next(m for m in JAX_INIT
                if type(jmodel).__module__ == m.__name__)
    jtree = _carried(jmod, tmodel.params,
                     lambda: JAX_INIT[jmod](jmodel.conf))
    jmodel.params = jtree
    tmodel.params = weights.params_from_jax(jtree)


def _apis(yaml, key):
    """Both packages' API on the entry, at 256 keypoints, the raw matches
    compared (no RANSAC), standalone matchers at threshold 1e-6 (their
    random trees clear no other)."""
    confs = []
    for ui in (jui, tui):
        conf = ui.get_matcher_zoo(ui.load_config(YAMLS[yaml])[
            "matcher_zoo"])[key]
        conf["matcher"]["model"].update(ENTRIES[yaml, key][0])
        conf["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(conf)
    kw = {"max_keypoints": 256, "match_threshold": 1e-6}
    japi = _jax_api(confs[0], **kw)
    tapi = TorchAPI(confs[1], device="cpu", **kw)
    if tapi.extractor is not None:
        _share(tapi.extractor, japi.extractor)
    for part in ("extractor", "matcher"):  # the standalone XFeat pipelines
        tsub = getattr(tapi.matcher, part, None)
        if isinstance(tsub, torch.nn.Module):
            _share(tsub, getattr(japi.matcher, part))
    return japi, tapi


def _same_features(jfeat, tfeat, least):
    """One view's extraction in both packages: the keypoint sets (IoU at
    least ``least`` within 1e-3 px), and at the common keypoints the
    scores within 1e-4 of the largest and the unit descriptors within
    1e-4."""
    jm, tm = np.asarray(jfeat["mask"][0]), tfeat["mask"][0]
    jk = np.asarray(jfeat["keypoints"][0])[jm]
    iou, it, ij = chip_smoke.common_points(tfeat["keypoints"][0][tm], jk,
                                           1e-3)
    assert iou >= least and len(it) > 10, (iou, len(it))
    js = np.asarray(jfeat["scores"][0])[jm]
    assert _rel(tfeat["scores"][0][tm][it] / js.max(),
                js[ij] / js.max()) <= 1e-4
    td = tfeat["descriptors"][0][:, tm][:, it]
    assert np.abs(td - np.asarray(jfeat["descriptors"][0])[:, jm][:, ij]
                  ).max() <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(td, axis=0), 1.0, atol=1e-5)


def _recording(mod):
    """A stand-in for ``mod.extract`` that keeps each call's result."""
    real, seen = mod.extract, []

    def extract(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    return extract, seen


@pytest.mark.parametrize("yaml,key", list(ENTRIES))
def test_zoo_entry_end_to_end_matches_jax(yaml, key):
    """The pair through each API; view 0's extraction inside it (as the API
    preprocesses it) held to the extractor bounds."""
    from imcui_tpu.pipeline import extract_features as jext
    from imcui_tpu_torch.pipeline import extract_features as text

    _, size, least = ENTRIES[yaml, key]
    planted = chip_smoke.synthetic_pair(101, *size)
    japi, tapi = _apis(yaml, key)
    feats = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, api in ((jext, japi), (text, tapi)):
            extract, seen = _recording(mod)
            mp.setattr(mod, "extract", extract)
            feats.append(seen)
        want = japi(planted[0], planted[1])
        got = tapi(planted[0], planted[1])
    if tapi.extractor is not None:
        _same_features(feats[0][0], feats[1][0], least)
    assert set(got) == set(want)
    for k in ("keypoints0_orig", "keypoints1_orig"):
        assert len(got[k]) == len(want[k]) > 10, (key, k)
        iou = chip_smoke.common_points(got[k], want[k], 1e-3)[0]
        assert iou >= least, (key, k, iou)
    assert len(got["mkeypoints0_orig"]) >= 10, key
    iou = chip_smoke.raw_match_iou(got, want, tol=1e-3)
    assert iou >= least, (key, iou)


def test_xfeat_lightglue_serves_4096_slots_and_reports_both_trees():
    """The standalone pipeline keeps its own budget (the API writes only
    the threshold) and names the random trees of both models."""
    zoo = tui.get_matcher_zoo(tui.load_config(ROOT_YAML)["matcher_zoo"])
    api = TorchAPI(zoo["xfeat+lightglue"], device="cpu")
    model = api.matcher
    assert model.extractor.conf["max_keypoints"] == 4096
    assert model.matcher.conf["input_dim"] == 64
    assert model.matcher.conf["n_layers"] == 6
    assert model.conf["match_threshold"] == 0.2  # the API's
    assert not model.meta["pretrained"]
    assert "random init" in model.meta["matcher"]["source"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["d2net", "dedode", "sfd2"])
def test_extractor_on_cuda_without_a_card_raises(name):
    from imcui_tpu_torch.models import extractors
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(extractors, name)({})


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["xfeat_dense", "xfeat_lightglue"])
def test_standalone_on_cuda_without_a_card_raises(name):
    from imcui_tpu_torch.models import matchers
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(matchers, name)({})
