"""R2D2, DarkFeat, LANet, LiftFeat and RIPE: the port against the JAX
package on the CPU, each extractor alone on one image and each zoo entry
of the root ``config/app.yaml`` end to end through both
``ImageMatchingAPI``s (``r2d2``, ``darkfeat``, ``lanet``,
``liftfeat(sparse)``, ``ripe(+mnn)``, all with mutual nearest neighbour).

Every model runs on the port's seed-0 tree, carried to the JAX package's
layout by ``params_to_jax`` and checked against the layout of the JAX init
(``jax.eval_shape``). On that random tree R2D2's 0.7 thresholds keep
nothing: its cases run at thresholds of 1e-6, on both sides.

Tolerances, float32 on both sides: the same valid keypoint set (slots
compared as sets within 1e-3 px), scores within 1e-4 of the largest,
descriptors within 1e-5 of the largest entry; end to end, the same
keypoints and the same raw match set (points within 1e-3 px).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import darkfeat as jdarkfeat
from imcui_tpu.models.extractors import lanet as jlanet
from imcui_tpu.models.extractors import liftfeat as jliftfeat
from imcui_tpu.models.extractors import r2d2 as jr2d2
from imcui_tpu.models.extractors import ripe as jripe
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.extractors import darkfeat as tdarkfeat
from imcui_tpu_torch.models.extractors import lanet as tlanet
from imcui_tpu_torch.models.extractors import liftfeat as tliftfeat
from imcui_tpu_torch.models.extractors import r2d2 as tr2d2
from imcui_tpu_torch.models.extractors import ripe as tripe
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

ROOT_YAML = Path(__file__).resolve().parents[1] / "config" / "app.yaml"
KEY = jax.random.PRNGKey(0)
LOW = 1e-6  # R2D2's thresholds on the random tree
# name → (JAX module, port module, image (w, h), apply keywords, channels)
EXTRACTORS = {
    "r2d2": (jr2d2, tr2d2, (96, 72), {"reliability_threshold": LOW,
                                      "repeatability_threshold": LOW}, 3),
    "darkfeat": (jdarkfeat, tdarkfeat, (128, 96), {"threshold": 0.0}, 3),
    "lanet": (jlanet, tlanet, (256, 192), {"threshold": 0.1}, 1),
    "liftfeat": (jliftfeat, tliftfeat, (128, 96), {"threshold": 0.0}, 1),
    "ripe": (jripe, tripe, (128, 96), {"threshold": 0.0}, 3),
}


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


def _carried(jmod, ttree):
    """The port's tree in the JAX layout, checked against the JAX init's."""
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(lambda: jmod.init_params(KEY))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree


def _image(size, channels, seed=100):
    img = chip_smoke.synthetic_pair(seed, *size)[0]
    x = img.transpose(2, 0, 1)[None] / 255.0
    if channels == 1:
        x = x.mean(1, keepdims=True)
    return x.astype(np.float32)


def _same_set(got, want, n_least):
    """Both packages' outputs of one view: the same valid keypoint set
    within 1e-3 px, scores within 1e-4 and descriptors within 1e-5 of the
    largest. Returns the number of valid keypoints."""
    jm, tm = np.asarray(want["mask"][0]), got["mask"][0].numpy()
    assert tm.sum() == jm.sum() >= n_least, (tm.sum(), jm.sum())
    jk, tk = np.asarray(want["keypoints"][0])[jm], got["keypoints"][0].numpy()[tm]
    iou, it, ij = chip_smoke.common_points(tk, jk, 1e-3)
    assert iou == 1.0, iou
    js = np.asarray(want["scores"][0])[jm]
    assert np.abs(got["scores"][0].numpy()[tm][it] - js[ij]).max() \
        <= 1e-4 * max(1.0, np.abs(js).max())
    jd = np.asarray(want["descriptors"][0])[:, jm][:, ij]
    td = got["descriptors"][0].numpy()[:, tm][:, it]
    assert np.abs(td - jd).max() <= 1e-5 * max(1.0, np.abs(jd).max())
    return int(tm.sum())


@pytest.mark.parametrize("name", list(EXTRACTORS))
def test_extractor_matches_jax(name):
    """Each extractor's ``apply`` on one image whose valid part is smaller
    than the canvas, on the port's tree given to both."""
    jmod, tmod, (w, h), kw, ch = EXTRACTORS[name]
    jtree = _carried(jmod, tmod.init_params(torch.Generator().manual_seed(0)))
    x = _image((w, h), ch)
    vwh = np.array([[w - 5, h - 3]], np.int32)
    want = jmod.apply(jtree, jnp.asarray(x), jnp.asarray(vwh),
                      max_keypoints=64, **kw)
    got = tmod.apply(weights.params_from_jax(jtree), _t(x),
                     torch.from_numpy(vwh), max_keypoints=64, **kw)
    _same_set(got, want, 10)
    tk = got["keypoints"][0].numpy()[got["mask"][0].numpy()]
    assert (tk[:, 0] < w - 3).all() and (tk[:, 1] < h - 1).all()


def test_lanet_takes_the_lower_index_first_among_equal_scores():
    """``lax.top_k`` puts the lower index first among ties: with the score
    head's bias at 40 every cell scores sigmoid(40) = 1.0 exactly, and both
    packages return the cells in raster order, slot for slot."""
    ttree = tlanet.init_params(torch.Generator().manual_seed(0))
    ttree["score"][1]["b"] = torch.full((1,), 40.0)
    jtree = _carried(jlanet, ttree)
    x = _image((128, 96), 1)
    vwh = np.array([[128, 96]], np.int32)
    want = jlanet.apply(jtree, jnp.asarray(x), jnp.asarray(vwh),
                        max_keypoints=100, threshold=0.1)
    got = tlanet.apply(weights.params_from_jax(jtree), _t(x),
                       torch.from_numpy(vwh), max_keypoints=100,
                       threshold=0.1)
    assert (np.asarray(want["scores"][0]) == 1.0).all()
    np.testing.assert_array_equal(got["scores"][0].numpy(), 1.0)
    np.testing.assert_allclose(got["keypoints"][0].numpy(),
                               np.asarray(want["keypoints"][0]), atol=1e-4)
    vals, idx = tlanet.top_k_low_index_first(
        torch.tensor([[0.5, 1.0, 0.5, 1.0, 0.2, 1.0]]), 4)
    assert idx.tolist() == [[1, 3, 5, 0]] and vals[0, 3] == 0.5


def test_liftfeat_threshold_rule_and_darkfeat_gate():
    """LiftFeat detects at min(keypoint_threshold, 0.05 if the tree is
    trained else 0.0); DarkFeat reads its detection_threshold and gates at
    0.0 whatever it says, as the JAX modules."""
    seen = []

    def spy(params, image, valid_wh, max_keypoints, threshold, **kw):
        seen.append(threshold)
        return {}

    x = {"image": _image((64, 48), 1)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tliftfeat, "apply", spy)
        mp.setattr(tdarkfeat, "apply", spy)
        model = tliftfeat.Liftfeat({"keypoint_threshold": 0.3},
                                   device="cpu")
        model(x)
        model.meta["pretrained"] = True
        model(x)
        tdarkfeat.DarkFeat({"detection_threshold": 0.9}, device="cpu")(x)
    assert seen == [0.0, 0.05, 0.0]


# --------------------------------------------------------------------------
# the root zoo's entries end to end through both ImageMatchingAPIs
# --------------------------------------------------------------------------

# key → (extractor conf overrides, planted pair size, preprocessing
# overrides): R2D2's conf resizes every image to 640 x 480, here to the
# pair's 128 x 96 on both sides
ENTRIES = {
    "r2d2": ({"reliability_threshold": LOW, "repetability_threshold": LOW},
             (128, 96), {"width": 128, "height": 96}),
    "darkfeat": ({}, (128, 96), {}),
    "lanet": ({}, (256, 192), {}),
    "liftfeat(sparse)": ({}, (128, 96), {}),
    "ripe(+mnn)": ({}, (128, 96), {}),
}
JAX_MODULES = (jr2d2, jdarkfeat, jlanet, jliftfeat, jripe)


def _jax_api(conf, **kw):
    """The JAX package's ImageMatchingAPI without drawing its random
    trees: each model's ``load_params`` returns no tree, and the caller
    sets one."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in JAX_MODULES:
            mp.setattr(mod, "load_params",
                       lambda c: (None, {"pretrained": False}))
        return JaxAPI(conf, **kw)


def _apis(key):
    confs = []
    for ui in (jui, tui):
        conf = ui.get_matcher_zoo(ui.load_config(ROOT_YAML)["matcher_zoo"])[
            key]
        conf["feature"]["model"].update(ENTRIES[key][0])
        conf["feature"]["preprocessing"].update(ENTRIES[key][2])
        conf["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(conf)
    kw = {"max_keypoints": 128}
    japi = _jax_api(confs[0], **kw)
    tapi = TorchAPI(confs[1], device="cpu", **kw)
    jmod = next(m for m in JAX_MODULES
                if type(japi.extractor).__module__ == m.__name__)
    japi.extractor.params = _carried(jmod, tapi.extractor.params)
    tapi.extractor.params = weights.params_from_jax(japi.extractor.params)
    return japi, tapi


@pytest.mark.parametrize("key", list(ENTRIES))
def test_zoo_entry_end_to_end_matches_jax(key):
    """The planted pair through each API: view 0's extraction inside it
    (as the API preprocesses it) held to the extractor bounds, then the
    keypoints of both views and the raw matches."""
    from imcui_tpu.pipeline import extract_features as jext
    from imcui_tpu_torch.pipeline import extract_features as text

    planted = chip_smoke.synthetic_pair(101, *ENTRIES[key][1])
    japi, tapi = _apis(key)
    feats = []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jext, text):
            real, seen = mod.extract, []

            def extract(*a, _real=real, _seen=seen, **kw):
                _seen.append(_real(*a, **kw))
                return _seen[-1]

            mp.setattr(mod, "extract", extract)
            feats.append(seen)
        want = japi(planted[0], planted[1])
        got = tapi(planted[0], planted[1])
    jf = feats[0][0]
    tf = {k: torch.as_tensor(np.asarray(v)) for k, v in feats[1][0].items()
          if k in ("mask", "keypoints", "scores", "descriptors")}
    _same_set(tf, jf, 10)
    assert set(got) == set(want)
    for k in ("keypoints0_orig", "keypoints1_orig"):
        assert len(got[k]) == len(want[k]) > 10, (key, k)
        assert chip_smoke.common_points(got[k], want[k], 1e-3)[0] == 1.0
    assert len(got["mkeypoints0_orig"]) >= 5, key
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0, key


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["r2d2", "darkfeat", "lanet", "liftfeat",
                                  "ripe"])
def test_extractor_on_cuda_without_a_card_raises(name):
    from imcui_tpu_torch.models import extractors
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(extractors, name)({})
