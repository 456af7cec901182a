"""SIFT and DoG without OpenCV: ``imcui_tpu_torch/ops/sift.py`` held
against OpenCV itself (the JAX package calls ``cv2.SIFT_create``), the
SIFT and DoG extractors against the JAX package's, DoG's patches against
``cv2.warpAffine``, HardNet and SOSNet on the injected trees, and the
entries ``sift+NN``, ``sift+lightglue``, ``dog-hardnet+NN`` (the packaged
app.yaml) and ``sift+sgmnet`` (the root config/app.yaml) end to end
through both ``ImageMatchingAPI``s.

Tolerances:
- ``fast_atan2`` within 1e-4 degree of ``cv2.fastAtan2``; the x2
  upsample, the nearest halving and the REFLECT_101 blur within 1e-5 of
  cv2's, relative to the largest value;
- SIFT's keypoints, matched by point (0.01 px) and angle: IoU of the
  valid sets at least 0.95, sizes within 1e-4 relative, angles within
  0.1 degree, and at least 95 % of the common keypoints with RootSIFT
  descriptors at a cosine of 0.999 or more (the descriptors are integers
  before the normalisation: a one-step rounding flip is a real
  difference, which 1e-4 would call a failure);
- DoG's patches within 1e-5 of cv2.warpAffine's, HardNet's descriptors
  within 2e-5 (the HardNet fixture's bound, tests/test_torch_parity3.py);
- end to end, the IoU of the raw match sets at least 0.9.
"""

from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import dog as jdog
from imcui_tpu.models.extractors import sift as jsift
from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.models.matchers import sgmnet as jsgm
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.extractors import dog as tdog
from imcui_tpu_torch.models.extractors import sift as tsift
from imcui_tpu_torch.ops import sift as ops
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

ROOT = Path(__file__).resolve().parents[1]
PACKAGED_YAML = ROOT / "imcui_tpu_torch" / "config" / "app.yaml"
ROOT_YAML = ROOT / "config" / "app.yaml"
KEY = jax.random.PRNGKey(0)
# two textured test images, the second odd-sized (odd octaves below it)
SIZES = [(200, 150), (171, 133)]


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


def _textured(w, h, seed=7):
    return chip_smoke.textured_image(np.random.default_rng(seed), h, w)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1.0, np.abs(np.asarray(want)).max()))


# --------------------------------------------------------------------------
# the restated pieces against OpenCV
# --------------------------------------------------------------------------

def test_fast_atan2_matches_cv2():
    g = np.concatenate([np.linspace(-50, 50, 41), [0.0, -1e-3, 1e-3, 7.0]])
    ys, xs = np.meshgrid(g, g, indexing="ij")
    ys, xs = ys.astype(np.float32).ravel(), xs.astype(np.float32).ravel()
    want = np.array([cv2.fastAtan2(float(y), float(x))
                     for y, x in zip(ys, xs)], np.float32)
    got = ops.fast_atan2(torch.from_numpy(ys), torch.from_numpy(xs)).numpy()
    assert np.abs(got - want).max() <= 1e-4
    assert ((got >= 0) & (got < 360)).all()
    assert abs(ops.fast_atan2(torch.tensor(1.0), torch.tensor(1.0)).item()
               - 44.99045) < 1e-4


@pytest.mark.parametrize("h,w", [(7, 9), (37, 41)])
def test_upsample2x_matches_cv2_resize(h, w):
    x = np.random.default_rng(0).integers(0, 256, (h, w)).astype(np.float32)
    want = cv2.resize(x, (2 * w, 2 * h), interpolation=cv2.INTER_LINEAR)
    got = ops.upsample2x(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("h,w", [(9, 4), (11, 13), (101, 77), (133, 171)])
def test_halve_nearest_matches_cv2_resize(h, w):
    x = np.random.default_rng(1).random((h, w)).astype(np.float32)
    want = cv2.resize(x, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST)
    got = ops.halve_nearest(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("h,w", [(4, 5), (5, 9), (9, 7), (6, 4), (40, 523)])
def test_gaussian_blur_matches_cv2_on_small_images(h, w):
    """Every octave sigma on images smaller than the kernel's radius (the
    reflection folds more than once) and a wide one (the SIMD tail)."""
    x = np.random.default_rng(2).random((h, w)).astype(np.float32) * 255
    for sigma in [ops.base_sigma()] + ops.layer_sigmas():
        want = cv2.GaussianBlur(x, (0, 0), sigma, sigma)
        got = ops.gaussian_blur(torch.from_numpy(x), sigma).numpy()
        assert _rel(got, want) <= 1e-5, (sigma, _rel(got, want))


def _same_bits(got, want):
    """Equal bit for bit but in at most 1e-4 of the samples, and there
    within 1e-7 of the image's range of 255: OpenCV's scalar tail of a
    row (the columns past its SIMD loops) now and then rounds one step
    apart."""
    differ = got != want
    assert differ.mean() <= 1e-4, differ.mean()
    assert np.abs(got - want).max() <= 1e-7 * 255


def test_pyramid_matches_cv2_calls():
    """The base, each layer and each next octave's base equal the same
    steps done with cv2's resize and GaussianBlur (see ``_same_bits``)."""
    img = _textured(171, 133).astype(np.float32)
    sig0 = ops.base_sigma()
    assert sig0 == float(np.sqrt(np.float32(1.6) * np.float32(1.6)
                                 - np.float32(1)))
    up = cv2.resize(img, (342, 266), interpolation=cv2.INTER_LINEAR)
    g0 = cv2.GaussianBlur(up, (0, 0), sig0, sig0)
    gauss, dogs = ops.build_pyramids(torch.from_numpy(img))
    assert len(gauss) == len(dogs) == 5  # a side of 16 holds candidates
    for o, stack in enumerate(gauss):
        if o:
            g0 = cv2.resize(layers[3], (layers[3].shape[1] // 2,
                                        layers[3].shape[0] // 2),
                            interpolation=cv2.INTER_NEAREST)
        layers = [g0]
        for s in ops.layer_sigmas():
            layers.append(cv2.GaussianBlur(layers[-1], (0, 0), s, s))
        _same_bits(stack.numpy(), np.stack(layers))
        _same_bits(dogs[o].numpy(), np.diff(np.stack(layers), axis=0))


# --------------------------------------------------------------------------
# SIFT and DoG against the JAX package (OpenCV)
# --------------------------------------------------------------------------

def _pairs(kp_a, ori_a, kp_b, ori_b, tol=0.01):
    """Keypoints of a and b paired by point (within ``tol`` px) and then
    by the nearest angle (one location can hold several orientations):
    (IoU, indices into a, indices into b, angle differences in
    degrees)."""
    d = np.abs(kp_a[:, None] - kp_b[None]).max(-1)
    dang = np.abs((np.degrees(ori_a)[:, None] - np.degrees(ori_b)[None]
                   + 180) % 360 - 180)
    cost = np.where(d <= tol, dang, np.inf)
    ia, ib, used = [], [], set()
    for i in np.argsort(cost.min(1)):
        for j in np.argsort(cost[i]):
            if not np.isfinite(cost[i, j]):
                break
            if j not in used:
                used.add(j)
                ia.append(i)
                ib.append(j)
                break
    ia, ib = np.array(ia, int), np.array(ib, int)
    iou = len(ia) / (len(kp_a) + len(kp_b) - len(ia))
    return iou, ia, ib, dang[ia, ib]


def _valid(out, keys=("keypoints", "oris", "scales", "scores")):
    out = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
           for k, v in out.items()}
    m = out["mask"][0]
    got = {k: out[k][0][m] for k in keys}
    got["descriptors"] = out["descriptors"][0][:, m].T
    return got


def _hold_sift(got, want, least=0.95):
    """The bounds of the module docstring on two extractions (dicts from
    ``_valid``); returns the measured values."""
    iou, it, ij, dang = _pairs(got["keypoints"], got["oris"],
                               want["keypoints"], want["oris"])
    size = np.abs(got["scales"][it] / want["scales"][ij] - 1).max()
    cos = (got["descriptors"][it] * want["descriptors"][ij]).sum(-1)
    assert iou >= least and len(it) >= 50, (iou, len(it))
    assert size <= 1e-4 and dang.max() <= 0.1, (size, dang.max())
    assert (cos >= 0.999).mean() >= 0.95, (cos >= 0.999).mean()
    return {"iou": iou, "size": size, "angle": dang.max(),
            "cos": (cos >= 0.999).mean()}


@pytest.fixture(scope="module")
def sift_images():
    return [(_textured(w, h).astype(np.float32) / 255.0)[None, None]
            for w, h in SIZES]


@pytest.mark.parametrize("rootsift", [True, False])
@pytest.mark.parametrize("size", SIZES)
def test_sift_matches_jax(size, rootsift, sift_images):
    image = sift_images[SIZES.index(size)]
    conf = {"rootsift": rootsift, "max_keypoints": 256}
    want = _valid(jsift.SIFT(conf)({"image": image}))
    got = _valid(tsift.SIFT(conf, device="cpu")({"image": image}))
    assert len(got["scores"]) == len(want["scores"]) == 256
    _hold_sift(got, want)  # both are unit rows: the cosine is the dot
    np.testing.assert_allclose(np.linalg.norm(got["descriptors"], axis=1),
                               1.0, atol=1e-5)


def test_sift_keeps_opencvs_ties_and_order():
    """Without a cut the keypoints equal OpenCV's one for one (IoU 1 on
    the larger image), strongest first, and retainBest keeps every
    keypoint that ties the n-th response."""
    img = _textured(*SIZES[0])
    kps = cv2.SIFT_create(contrastThreshold=0.0066667, nOctaveLayers=3
                          ).detect(img, None)
    kp, _ = ops.detect(torch.from_numpy(img.astype(np.float32)), 0.0066667)
    f = ops.fields(kp)
    iou, _, _, dang = _pairs(f["points"].numpy(),
                             np.radians(f["angles"].numpy()),
                             np.array([k.pt for k in kps], np.float32),
                             np.radians([k.angle for k in kps]))
    assert iou == 1.0 and dang.max() <= 0.1
    r = f["responses"].numpy()
    assert (np.diff(r) <= 0).all()
    kept = ops.retain_best(kp, 10)["response"].numpy()
    assert len(kept) >= 10 and kept.min() == np.sort(r)[::-1][9]


def test_sift_ignores_octave_and_nms_keys_and_falls_back_to_opencv():
    """first_octave, num_octaves and nms_radius never reach OpenCV in the
    JAX package, so they change nothing; a pycolmap backend becomes
    opencv."""
    image = (_textured(96, 80).astype(np.float32) / 255.0)[None, None]
    base = tsift.SIFT({"max_keypoints": 64}, device="cpu")({"image": image})
    model = tsift.SIFT({"max_keypoints": 64, "first_octave": 0,
                        "num_octaves": 2, "nms_radius": 4,
                        "backend": "pycolmap"}, device="cpu")
    assert model.conf["backend"] == "opencv"
    other = model({"image": image})
    for k in base:
        np.testing.assert_array_equal(other[k].numpy(), base[k].numpy())
    assert model.meta["pretrained"]


@pytest.fixture(scope="module")
def dog_image():
    return (_textured(190, 140, seed=3).astype(np.float32) / 255.0)[None,
                                                                    None]


@pytest.mark.parametrize("descriptor", ["rootsift", "hardnet", "sosnet"])
def test_dog_matches_jax(descriptor, dog_image):
    conf = {"descriptor": descriptor, "max_keypoints": 200}
    jmodel = jdog.DoG(conf)
    tmodel = tdog.DoG(conf, device="cpu")
    if descriptor != "rootsift":
        assert not tmodel.meta["pretrained"]
        jmodel.net_params = weights.params_to_jax(tmodel.params)
    want = _valid(jmodel({"image": dog_image}))
    got = _valid(tmodel({"image": dog_image}))
    if descriptor == "rootsift":
        _hold_sift(got, want)
        return
    iou, it, ij, dang = _pairs(got["keypoints"], got["oris"],
                               want["keypoints"], want["oris"])
    assert iou >= 0.95 and dang.max() <= 0.1, (iou, dang.max())
    # the same keypoint gives the same patch up to its angle's last bits:
    # HardNet's descriptors of common keypoints within 2e-5 where the
    # angles agree to 1e-4 degree
    same = dang <= 1e-4
    assert same.mean() >= 0.9
    assert np.abs(got["descriptors"][it[same]]
                  - want["descriptors"][ij[same]]).max() <= 2e-5


def test_extract_patches_matches_cv2_warp_affine():
    """Keypoints inside, on and beyond the image's edges, at several
    scales and angles. The warp of the JAX module's own maps equals
    cv2.warpAffine's patches bit for bit; the port's maps are the JAX
    module's but for float32 cos and sin (numpy's and torch's differ in
    the last bit for ~1 angle in 5), which moves the full extraction by
    up to ~1.3e-5, held here at 2e-5."""
    rng = np.random.default_rng(5)
    img = rng.random((60, 80)).astype(np.float32)
    pts = np.concatenate([rng.uniform([0, 0], [80, 60], (20, 2)),
                          [[0, 0], [79.5, 59.5], [-3, 30], [82, -2]]]
                         ).astype(np.float32)
    scales = rng.uniform(1.0, 12.0, len(pts)).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, len(pts)).astype(np.float32)
    want = jdog.extract_patches(img, pts, scales, angles)
    maps = []
    for pt, s, a in zip(pts, scales, angles):  # jdog.extract_patches's M
        scale = 12 * s / 32
        c, sn = np.cos(a), np.sin(a)
        maps.append([[scale * c, -scale * sn,
                      -scale * (c * 32 / 2 - sn * 32 / 2) + pt[0]],
                     [scale * sn, scale * c,
                      -scale * (sn * 32 / 2 + c * 32 / 2) + pt[1]]])
    maps = np.array(maps, np.float32)
    warped = tdog.warp_patches(torch.from_numpy(img),
                               torch.from_numpy(maps)).numpy()
    assert np.abs(warped - want).max() <= 1e-5
    np.testing.assert_array_equal(warped, want)
    port_maps = tdog.patch_maps(*map(torch.from_numpy,
                                     (pts, scales, angles))).numpy()
    assert np.abs(port_maps - maps).max() <= 4 * np.spacing(
        np.abs(maps).max())
    got = tdog.extract_patches(*map(torch.from_numpy,
                                    (img, pts, scales, angles))).numpy()
    assert np.abs(got - want).max() <= 2e-5


def test_hardnet_matches_jax_on_patches():
    rng = np.random.default_rng(11)
    ttree = tdog.init_hardnet(torch.Generator().manual_seed(4))
    for blk in ttree["features"]:
        blk["bn"]["mean"] = torch.from_numpy(
            rng.normal(0, 0.1, blk["bn"]["mean"].shape).astype(np.float32))
        blk["bn"]["var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, blk["bn"]["var"].shape).astype(np.float32))
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(lambda: jdog.init_hardnet(KEY))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    patches = rng.uniform(size=(6, 32, 32)).astype(np.float32)
    want = np.asarray(jdog._describe(jtree, patches[..., None]))
    got = tdog.describe_patches(ttree, torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_convert_state_dict_matches_jax():
    """An upstream-shaped HardNet state dict (convs, BN statistics and the
    counters torch keeps) through both packages' order-based conversion;
    a dict with a block too few raises in both."""
    rng = np.random.default_rng(6)
    sd, cin, j = {}, 1, 0
    for cout, _, k in tdog.HARDNET_SPEC:
        sd[f"features.{j}.weight"] = rng.normal(
            size=(cout, cin, k, k)).astype(np.float32)
        sd[f"features.{j + 1}.running_mean"] = rng.normal(
            size=cout).astype(np.float32)
        sd[f"features.{j + 1}.running_var"] = rng.uniform(
            0.5, 2, cout).astype(np.float32)
        sd[f"features.{j + 1}.num_batches_tracked"] = np.array(3)
        cin, j = cout, j + 3
    want = jdog.DoG._convert(None, sd)
    got = tdog.convert_state_dict(sd)
    flat = weights.flatten_tree(weights.params_to_jax(got))
    for path, leaf in weights.flatten_tree(want).items():
        np.testing.assert_array_equal(flat[path], np.asarray(leaf))
    del sd["features.0.weight"]
    with pytest.raises(ValueError, match="hardnet conversion"):
        tdog.convert_state_dict(sd)
    with pytest.raises(ValueError, match="hardnet conversion"):
        jdog.DoG._convert(None, sd)


def test_registry_aliases_and_cuda_without_a_card():
    from imcui_tpu_torch.configs import confs_dict
    from imcui_tpu_torch.models import extractors
    from imcui_tpu_torch.utils.base_model import dynamic_load

    ext = confs_dict["extractors"]
    assert ext["hardnet"]["model"]["descriptor"] == "hardnet"
    assert ext["sosnet"]["model"]["descriptor"] == "sosnet"
    for name in ("sift", "dog"):
        cls = dynamic_load(extractors, name)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                cls({})


# --------------------------------------------------------------------------
# the zoo entries end to end through both ImageMatchingAPIs
# --------------------------------------------------------------------------

# (yaml, key) → matcher overrides: the learned matchers at 1e-6 (their
# random trees clear no other), LightGlue cut to two layers
ENTRIES = {("packaged", "sift+NN"): {},
           ("packaged", "sift+lightglue"): {"n_layers": 2,
                                            "match_threshold": 1e-6},
           ("packaged", "dog-hardnet+NN"): {},
           ("root", "sift+sgmnet"): {"match_threshold": 1e-6}}
YAMLS = {"packaged": PACKAGED_YAML, "root": ROOT_YAML}
JAX_MATCHERS = {jlg: lambda c: jlg.init_params(KEY, c),
                jsgm: lambda c: jsgm.init_params(KEY, c)}


def _apis(yaml, key):
    """Both APIs at 256 keypoints, the raw matches compared (no RANSAC),
    the learned matchers at 1e-6 on the port's seed-0 trees (layouts
    checked), DoG's HardNet on the port's tree."""
    confs = []
    for ui in (jui, tui):
        conf = ui.get_matcher_zoo(ui.load_config(YAMLS[yaml])[
            "matcher_zoo"])[key]
        conf["matcher"]["model"].update(ENTRIES[yaml, key])
        conf["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(conf)
    kw = {"max_keypoints": 256, "match_threshold": 1e-6}
    with pytest.MonkeyPatch.context() as mp:
        for mod in JAX_MATCHERS:
            mp.setattr(mod, "load_params",
                       lambda c: (None, {"pretrained": False}))
        japi = JaxAPI(confs[0], **kw)
    tapi = TorchAPI(confs[1], device="cpu", **kw)
    if tapi.extractor.params is not None:
        japi.extractor.net_params = weights.params_to_jax(
            tapi.extractor.params)
    jmod = next((m for m in JAX_MATCHERS
                 if type(japi.matcher).__module__ == m.__name__), None)
    if jmod is not None:
        jtree = weights.params_to_jax(tapi.matcher.params)
        shapes = jax.eval_shape(lambda: JAX_MATCHERS[jmod](japi.matcher.conf))
        assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} \
            == {k: tuple(v.shape)
                for k, v in weights.flatten_tree(shapes).items()}
        japi.matcher.params = jtree
    return japi, tapi


@pytest.mark.parametrize("yaml,key", list(ENTRIES))
def test_zoo_entry_end_to_end_matches_jax(yaml, key):
    """A planted 200 x 152 pair, whose sides are multiples of 8, so that
    the API resizes nothing (the resized case is
    ``test_sift_through_the_api_on_a_resized_pair_matches_jax``)."""
    planted = chip_smoke.synthetic_pair(101, 200, 152)
    japi, tapi = _apis(yaml, key)
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    assert set(got) == set(want)
    for k in ("keypoints0_orig", "keypoints1_orig"):
        assert len(got[k]) == len(want[k]) == 256, (key, k)
        assert chip_smoke.common_points(got[k], want[k], 1e-2)[0] >= 0.95
    assert len(got["mkeypoints0_orig"]) >= 10, key
    iou = chip_smoke.raw_match_iou(got, want, tol=1e-2)
    assert iou >= 0.9, (key, iou)


def test_sift_through_the_api_on_a_resized_pair_matches_jax():
    """A planted 200 x 150 pair, which the API resizes to 200 x 144 (the
    dfactor floor) by the area resize: the port's equals cv2's float
    INTER_AREA bit for bit, so SIFT truncates the same grey levels and its
    keypoints equal the JAX package's (IoU 1.0; fault C4 in ROADMAP.md
    gave 0.67 here)."""
    planted = chip_smoke.synthetic_pair(101, 200, 150)
    japi, tapi = _apis("packaged", "sift+NN")
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    for k in ("keypoints0_orig", "keypoints1_orig"):
        assert len(got[k]) == len(want[k]) == 256, k
        iou = chip_smoke.common_points(got[k], want[k], 1e-3)[0]
        assert iou == 1.0, (k, iou)
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0
