"""The head of the sparse zoo in the port against the JAX package on the
CPU: ``ops/deform.py``, ``ops/nms.py::sample_bilinear``,
``ops/resize.py::torch_interpolate`` in every mode, the bicubic and nearest modes of
``ops/sampling.py::grid_sample`` and ``xfeat_grid``, and the DISK,
ALIKED, ALIKE and XFeat extractors; then the zoo entries ``disk``,
``alike``, ``aliked+lightglue`` and ``xfeat(sparse)`` end to end through
both ``ImageMatchingAPI``s, the keys each extractor reads from the API's
conf, and which zoo entries the port builds.

Tolerances, float32 on both sides:
- the ops: 1e-5 relative to the largest value (measured <= 1e-6);
- each extractor on the same preprocessed image, on one random tree (the
  port's seed-0 tree in the JAX package's layout, checked against the
  layout of the JAX init, carried back by ``params_from_jax``): the same keypoint set
  (slots compared as sets: top-k fills tied slots in any order), the
  refined keypoints within 1e-3 px, scores within 1e-4 of the largest
  and descriptors within 1e-4 (unit vectors);
- end to end on a planted 160 × 120 pair: the same raw match set (points
  within 1e-3 px).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import alike as jalike
from imcui_tpu.models.extractors import aliked as jaliked
from imcui_tpu.models.extractors import disk as jdisk
from imcui_tpu.models.extractors import xfeat as jxfeat
from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.ops import deform as jdeform
from imcui_tpu.ops import nms as jnms
from imcui_tpu.ops import resize as jresize
from imcui_tpu.ops import sampling as jsampling
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models import extractors as textractors
from imcui_tpu_torch.models import matchers as tmatchers
from imcui_tpu_torch.models.extractors import aliked as taliked
from imcui_tpu_torch.ops import deform as tdeform
from imcui_tpu_torch.ops import nms as tnms
from imcui_tpu_torch.ops import resize as tresize
from imcui_tpu_torch.ops import sampling as tsampling
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import base_model as tbase
from imcui_tpu_torch.utils import weights

ROOT = Path(__file__).resolve().parents[1]
APP_YAML = ROOT / "imcui_tpu_torch" / "config" / "app.yaml"
SP_NPZ = str(ROOT / "weights" / "superpoint_adapted.npz")


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


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

def test_deform_conv2d_matches_jax_with_offsets_past_the_border():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 13, 6)).astype(np.float32)
    off = rng.normal(0, 2.5, (2, 11, 13, 18)).astype(np.float32)
    off[0, 0, 0] = 30.0  # every tap of one pixel outside: zeros
    off[1, 5, 6, ::2] = 0.5  # half a pixel in y on every tap
    w = rng.normal(size=(3, 3, 6, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(jdeform.deform_conv2d(*map(jnp.asarray, (x, off, w,
                                                                b))))
    got = tdeform.deform_conv2d(_t(x).permute(0, 3, 1, 2),
                                _t(off).permute(0, 3, 1, 2),
                                _t(w).permute(3, 2, 0, 1), _t(b))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5
    np.testing.assert_allclose(got[0, :, 0, 0].numpy(), b, atol=1e-6)
    # zero offsets: a plain 3 x 3 convolution
    plain = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2),
                                       _t(w).permute(3, 2, 0, 1), padding=1)
    zero = tdeform.deform_conv2d(_t(x).permute(0, 3, 1, 2),
                                 torch.zeros(2, 18, 11, 13),
                                 _t(w).permute(3, 2, 0, 1))
    assert _rel(zero.numpy(), plain.numpy()) < 1e-5


def test_sample_bilinear_matches_jax_inside_on_and_past_the_border():
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(9, 12, 5)).astype(np.float32)
    kp = rng.uniform(-3, 15, (40, 2)).astype(np.float32)
    kp[:4] = [[0, 0], [11, 8], [11.0, 3.5], [4.25, 8.0]]
    want = np.asarray(jnms.sample_bilinear(jnp.asarray(fmap),
                                           jnp.asarray(kp)))
    got = tnms.sample_bilinear(_t(fmap).permute(2, 0, 1)[None], _t(kp)[None])
    assert got.shape == (1, 5, 40)
    assert _rel(got[0].T.numpy(), want) < 1e-6
    np.testing.assert_allclose(got[0, :, 1].numpy(), fmap[8, 11], atol=1e-6)


@pytest.mark.parametrize("mode,align", [("bilinear", True),
                                        ("bilinear", False),
                                        ("bicubic", False), ("bicubic", True),
                                        ("nearest", False)])
@pytest.mark.parametrize("src,dst", [((5, 7), (40, 56)), ((9, 16), (9, 32)),
                                     ((20, 30), (7, 11)), ((3, 4), (96, 128))])
def test_torch_interpolate_matches_jax(src, dst, mode, align):
    """Every mode of the JAX function, up- and down-sampling: bilinear with
    align_corners=True (ALIKE's and ALIKED's upsampling) and bicubic
    (DeDoDe's) and nearest against the JAX function and F.interpolate;
    half-pixel bilinear (DeDoDe's context, which the JAX function sends to
    jax.image.resize: it antialiases when an axis shrinks) against the JAX
    function and the port's ``resize``."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(jresize.torch_interpolate(jnp.asarray(x), dst, mode,
                                                align))
    got = tresize.torch_interpolate(_t(x).permute(0, 3, 1, 2), dst, mode,
                                    align)
    assert got.shape == (2, 3, *dst)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5
    if mode == "bilinear" and not align:
        ref = tresize.resize(_t(x).permute(0, 3, 1, 2), dst, "bilinear")
    else:
        ref = torch.nn.functional.interpolate(
            _t(x).permute(0, 3, 1, 2), size=dst, mode=mode,
            align_corners=None if mode == "nearest" else align)
    assert _rel(got.numpy(), ref.numpy()) < 1e-5
    if mode == "nearest":  # the JAX function ignores align_corners
        again = tresize.torch_interpolate(_t(x).permute(0, 3, 1, 2), dst,
                                          mode, True)
        assert torch.equal(again, got)
    with pytest.raises(ValueError):
        tresize.torch_interpolate(_t(x), dst, "area", align)


@pytest.mark.parametrize("mode", ["bicubic", "nearest"])
@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_bicubic_and_nearest_match_jax_near_the_border(mode,
                                                                   align):
    rng = np.random.default_rng(3)
    fmap = rng.normal(size=(9, 13, 4)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(6, 7, 2)).astype(np.float32)
    edge = np.array([[-1.0, -1.0], [1.0, 1.0], [-1.02, 0.3], [0.99, -0.97],
                     [1.2, 1.1], [3.0, -3.0], [-1.0 - 1 / 13, 0.0]])
    grid[0] = edge
    # exact half-pixel positions, where rounding conventions differ
    h, w = fmap.shape[:2]
    half = (np.array([2.5, 4.5, 6.5]) + (0 if align else 0.5)) \
        / ((w - 1) if align else w) * 2 - 1
    grid[1, :3, 0], grid[1, :3, 1] = half, 0.0
    want = np.asarray(jsampling.grid_sample(jnp.asarray(fmap),
                                            jnp.asarray(grid), mode, align))
    got = tsampling.grid_sample(_t(fmap).permute(2, 0, 1), _t(grid), mode,
                                align)
    assert got.shape == (4, 6, 7)
    assert _rel(got.permute(1, 2, 0).numpy(), want) < 1e-5
    assert np.abs(want[0, 5]).max() == 0.0  # every tap outside
    with pytest.raises(ValueError):
        tsampling.grid_sample(_t(fmap).permute(2, 0, 1), _t(grid), "area")


def test_xfeat_grid_matches_jax():
    kp = np.array([[0.0, 0.0], [639.0, 479.0], [100.5, 17.25]], np.float32)
    want = np.asarray(jsampling.xfeat_grid(jnp.asarray(kp), 480, 640))
    np.testing.assert_allclose(tsampling.xfeat_grid(_t(kp), 480, 640).numpy(),
                               want, atol=1e-7)


# --------------------------------------------------------------------------
# the extractors and their zoo entries, both packages
# --------------------------------------------------------------------------

# entry → (feature model overrides for the CPU, matcher overrides): the
# small variants where one exists, a cut keypoint cap for ALIKED, and for
# LightGlue two layers at a threshold that its random tree clears
ENTRIES = {
    "disk": ({}, {}),
    "alike": ({"model_name": "alike-t"}, {}),
    "aliked+lightglue": ({"max_num_keypoints": 512},
                         {"n_layers": 2, "match_threshold": 1e-6}),
    "xfeat(sparse)": ({}, {}),
}
KEY = jax.random.PRNGKey(0)
# the JAX package's init of each model, by the port's module name, for
# its tree's layout (jax.eval_shape: nothing is drawn)
JAX_INIT = {
    "aliked": lambda c: jaliked.init_params(KEY, **jaliked.SIZES[
        c["model_name"]]),
    "disk": lambda c: jdisk.init_params(KEY),
    "alike": lambda c: jalike.init_params(KEY, **jalike.SIZES[
        c["model_name"]]),
    "xfeat": lambda c: jxfeat.init_params(KEY),
    "lightglue": lambda c: jlg.init_params(KEY, c),
}


def _jax_api(conf):
    """The JAX package's ImageMatchingAPI on ``conf`` without drawing its
    random trees (the JAX init runs op by op on the CPU, ~5-16 s a
    model): each model's ``load_params`` returns no tree, and the caller
    sets one."""
    mp = pytest.MonkeyPatch()
    for mod in (jaliked, jdisk, jalike, jxfeat, jlg):
        mp.setattr(mod, "load_params",
                   lambda c: (None, {"pretrained": False}))
    try:
        return JaxAPI(conf)
    finally:
        mp.undo()


def _carry(tmodel, jmodel, conf):
    """The port's seed-0 tree in the JAX package's layout, checked against
    the layout of the JAX init for ``conf``, given to the JAX model, and
    carried back into the port's model by ``params_from_jax``."""
    jtree = weights.params_to_jax(tmodel.params)
    shapes = jax.eval_shape(lambda: JAX_INIT[conf["name"]](conf))
    want = {k: tuple(v.shape) for k, v in weights.flatten_tree(
        jax.tree_util.tree_map(lambda a: a, shapes)).items()}
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} \
        == want
    jmodel.params = jtree
    tmodel.params = weights.params_from_jax(jtree)


def _apis(key):
    """Both packages' ImageMatchingAPI on the packaged zoo entry ``key``
    with ENTRIES' overrides, both models on one tree."""
    feat, match = ENTRIES[key]
    confs = []
    for ui in (jui, tui):
        conf = ui.get_matcher_zoo(ui.load_config(APP_YAML)["matcher_zoo"])[key]
        conf["feature"]["model"].update(feat)
        conf["matcher"]["model"].update(match)
        # the raw matches are compared: no RANSAC (its draws differ anyway)
        conf["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(conf)
    japi = _jax_api(confs[0])
    tapi = TorchAPI(confs[1], device="cpu")
    _carry(tapi.extractor, japi.extractor, japi.extractor.conf)
    if hasattr(japi.matcher, "params"):
        _carry(tapi.matcher, japi.matcher, japi.matcher.conf)
    return japi, tapi


@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(101, 160, 120)


@pytest.fixture(scope="module", params=list(ENTRIES))
def entry(request, planted):
    """(key, JAX run, port run): each extractor on image 0 preprocessed as
    its conf says, then the pair through each API."""
    from imcui_tpu.pipeline import extract_features as jext
    from imcui_tpu_torch.pipeline import extract_features as text

    key = request.param
    japi, tapi = _apis(key)
    runs = []
    for api, ext in ((japi, jext), (tapi, text)):
        feats = ext.extract(api.extractor, planted[0],
                            api.extract_conf["preprocessing"])
        runs.append((feats, api(planted[0], planted[1])))
    return key, runs[0], runs[1]


def test_extractor_matches_jax(entry):
    key, (jfeat, _), (tfeat, _) = entry
    jm, tm = np.asarray(jfeat["mask"][0]), tfeat["mask"][0]
    assert tm.sum() == jm.sum() > 20, (tm.sum(), jm.sum())
    jk = np.asarray(jfeat["keypoints"][0])[jm]
    tk = tfeat["keypoints"][0][tm]
    # the same set: each port keypoint's partner in the JAX set
    d = np.abs(tk[:, None] - jk[None]).max(-1)
    j = d.argmin(1)
    assert d[np.arange(len(tk)), j].max() <= 1e-3, key
    assert len(set(j)) == len(tk)
    sc = np.asarray(jfeat["scores"][0])[jm][j]
    assert _rel(tfeat["scores"][0][tm], sc) <= 1e-4
    jd = np.asarray(jfeat["descriptors"][0])[:, jm][:, j]
    td = tfeat["descriptors"][0][:, tm]
    assert np.abs(td - jd).max() <= 1e-4, (key, np.abs(td - jd).max())
    np.testing.assert_allclose(np.linalg.norm(td, axis=0), 1.0, atol=1e-5)


def test_zoo_entry_end_to_end_matches_jax(entry):
    key, (_, want), (_, got) = entry
    assert set(got) == set(want)
    assert len(got["mkeypoints0_orig"]) > 10, key
    iou = chip_smoke.raw_match_iou(got, want, tol=1e-3)
    assert iou == 1.0, (key, iou)


def test_aliked_describe_equals_the_served_descriptors():
    """``describe`` at the keypoints ``apply`` found gives its descriptors
    (the JAX package's ``apply_describe`` contract)."""
    model = taliked.ALIKED({"model_name": "aliked-t16",
                            "max_num_keypoints": 64}, device="cpu")
    img = chip_smoke.synthetic_pair(102, 96, 64)[0]
    image = torch.from_numpy(img.transpose(2, 0, 1)[None] / 255.0).float()
    out = model({"image": image})
    desc = model.describe(image, out["keypoints"])
    np.testing.assert_allclose(desc.numpy(), out["descriptors"].numpy(),
                               atol=1e-6)
    assert model.meta["head"] == "sddh" and not model.meta["pretrained"]


def test_aliked_sddh_matches_jax():
    """The SDDH alone at M = 32 (aliked-n32) on a random tree, keypoints
    off the grid and at the border."""
    jtree = weights.params_to_jax(taliked.init_params(
        torch.Generator().manual_seed(1), **taliked.SIZES["aliked-n32"]))
    ttree = weights.params_from_jax(jtree)
    rng = np.random.default_rng(4)
    fmap = rng.normal(size=(20, 24, 128)).astype(np.float32)
    fmap /= np.linalg.norm(fmap, axis=-1, keepdims=True)
    kp = rng.uniform(0, [23, 19], (30, 2)).astype(np.float32)
    kp[0] = (0, 0)
    kp[1] = (23, 19)
    want = np.asarray(jaliked.sddh(jtree, jnp.asarray(fmap), jnp.asarray(kp),
                                   3, 32))
    got = taliked.sddh(ttree, _t(fmap).permute(2, 0, 1)[None], _t(kp)[None],
                       3, 32)
    assert got.shape == (1, 30, 128)
    assert np.abs(got[0].numpy() - want).max() <= 1e-5


# --------------------------------------------------------------------------
# the keys each extractor reads from the API's conf (ROADMAP.md, findings)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["disk", "alike", "aliked+lightglue",
                                 "xfeat(sparse)"])
def test_the_api_conf_override_reaches_some_extractors_only(key):
    """ImageMatchingAPI writes max_keypoints 1024 and keypoint_threshold
    0.015 into the feature conf in both packages. ALIKED reads neither
    (max_num_keypoints -1 serves 4096 slots at its detection_threshold
    0.2); DISK and ALIKE read max_keypoints but detection_threshold (DISK
    0.0, ALIKE 0.2); XFeat reads both."""
    want = {"disk": (1024, "detection_threshold", 0.0),
            "alike": (1024, "detection_threshold", 0.2),
            "aliked+lightglue": (4096, "detection_threshold", 0.2),
            "xfeat(sparse)": (1024, "keypoint_threshold", 0.015)}[key]
    got = []
    for ui, build in ((jui, _jax_api),
                      (tui, lambda c: TorchAPI(c, device="cpu"))):
        conf = ui.get_matcher_zoo(ui.load_config(APP_YAML)["matcher_zoo"])[key]
        api = build(conf)
        mc = api.extractor.conf
        assert mc["max_keypoints"] == 1024
        assert mc["keypoint_threshold"] == 0.015
        cap = getattr(api.extractor, "_max_kpts", mc["max_keypoints"])
        got.append((cap, want[1], mc[want[1]]))
    assert got[0] == got[1] == want


# --------------------------------------------------------------------------
# which zoo entries the port builds
# --------------------------------------------------------------------------

# the sparse entries of the packaged app.yaml the port serves: three before
# the sparse zoo's head, nine with it, eleven with D2-Net/RoRD and DeDoDe,
# fourteen with SIFT and DoG
SERVED_SPARSE = {"superpoint+lightglue", "superpoint+NN",
                 "superpoint+dual-softmax", "superglue", "superpoint+adalam",
                 "disk", "alike", "aliked+lightglue", "xfeat(sparse)",
                 "dedode", "rord", "sift+NN", "sift+lightglue",
                 "dog-hardnet+NN"}
SERVED_DENSE = {"loftr", "eloftr", "roma", "xfeat(dense)",
                # on the ViT-L trunk and on ResNet-50
                "duster", "mast3r", "dkm",
                # the line matcher on LSD, and LISRD
                "gluestick", "lisrd"}
# the dense entries whose full-width trees (ViT-L, ResNet-50) the zoo
# tests resolve but do not build: six test workers each holding one would
# exhaust the CPU's memory
NOT_BUILT = {"duster", "mast3r", "dkm", "Mast3R", "DUSt3R", "GIM(dkm)",
             "dad(RoMa)"}
# the entries of the repository's root config/app.yaml that the sparse zoo
# on parts already ported serves
SERVED_ROOT = {"xfeat+lightglue", "xfeat(dense)", "dedode",
               "superpoint+sphereglue", "d2net", "rord", "sfd2+imp",
               "sfd2+mnn",
               # SIFT and DoG, then the other extractors
               "sift", "sift+lightglue", "sift+sphereglue", "sift+sgmnet",
               "hardnet", "sosnet", "r2d2", "darkfeat", "lanet",
               "liftfeat(sparse)", "ripe(+mnn)",
               # RaCo, then the dense entries on ViT-L and ResNet-50
               "raco+lightglue", "Mast3R", "DUSt3R", "GIM(dkm)", "dkm",
               # GlueStick, LISRD's three detectors, the wrappers on RoMa
               "gluestick", "LISRD+SuperPoint", "LISRD+ALIKED",
               "LISRD+SIFT", "dad(RoMa)", "RoMaV2"}


def _resolve(conf):
    """Load both models of a zoo entry's conf: the name of the first the
    port lacks, or None."""
    names = [(tmatchers, conf["matcher"]["model"]["name"])]
    if not conf["dense"]:
        names.append((textractors, conf["feature"]["model"]["name"]))
    for root, name in names:
        try:
            tbase.dynamic_load(root, name)
        except NotImplementedError as e:
            assert repr(name) in str(e), str(e)
            return name
    return None


def test_zoo_coverage_of_the_packaged_app_yaml():
    """Every enabled entry of the packaged zoo resolves both its models in
    the port: all twenty-three are served and none raises. The fourteen
    sparse entries build on the CPU."""
    zoo = tui.get_matcher_zoo(tui.load_config(APP_YAML)["matcher_zoo"])
    missing = {key: _resolve(conf) for key, conf in zoo.items()}
    served = {key for key, name in missing.items() if name is None}
    missing = {key: name for key, name in missing.items() if name}
    assert served == SERVED_SPARSE | SERVED_DENSE, sorted(served)
    assert set(zoo) == served | set(missing)
    assert len(served) == 23 and not missing, sorted(missing)
    for key in sorted(SERVED_SPARSE):
        conf = zoo[key]
        if key == "superglue" or key.startswith("superpoint"):
            conf["feature"]["model"]["checkpoint_npz"] = SP_NPZ
        feat = tui.get_feature_model(conf["feature"], "cpu")
        match = tui.get_model(conf["matcher"], "cpu")
        assert feat.device.type == match.device.type == "cpu"


def test_zoo_coverage_of_the_root_app_yaml():
    """The thirty entries of the repository's own WebUI zoo that the zoo's
    later slices add resolve both their models, and all but the ViT-L and
    ResNet-50 ones build on the CPU; so does the yaml's disabled
    ``sold2``."""
    raw = tui.load_config(ROOT / "config" / "app.yaml")["matcher_zoo"]
    zoo = tui.get_matcher_zoo(raw)
    assert {key: _resolve(zoo[key]) for key in SERVED_ROOT} == dict.fromkeys(
        SERVED_ROOT)
    assert "sold2" not in zoo and raw["sold2"]["enable"] is False
    sold2 = tui.parse_match_config(raw["sold2"])
    assert _resolve(sold2) is None
    assert tui.get_model(sold2["matcher"], "cpu").device.type == "cpu"
    for key in sorted(SERVED_ROOT - NOT_BUILT):
        conf = zoo[key]
        if conf["dense"]:
            model = tui.get_model(conf["matcher"], "cpu")
            assert model.device.type == "cpu"
            continue
        if conf["feature"]["model"]["name"] == "superpoint":
            conf["feature"]["model"]["checkpoint_npz"] = SP_NPZ
        feat = tui.get_feature_model(conf["feature"], "cpu")
        match = tui.get_model(conf["matcher"], "cpu")
        assert feat.device.type == match.device.type == "cpu"
