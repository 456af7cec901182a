"""The graph matchers of the sparse zoo, the port against the JAX package
on the CPU: ``mha``'s additive bias, SGMNet with the tie order of its seed
selection, IMP with its weighted 8-point solve (float64 in the port) and
the injected projection of descriptors that are not 128-d, SphereGlue
with its kNN Laplacian and the conf's ignored ``knn`` and ``K``; then the
entries end to end through both ``ImageMatchingAPI``s: the root
``config/app.yaml``'s ``superpoint+sphereglue`` and ``sfd2+imp``, and
``{"feature": "disk", "matcher": "sgmnet"}`` from the registry.

Every matcher runs on the port's seed-0 tree, carried to the JAX layout
and checked against the layout of the JAX init (``jax.eval_shape``). On
random trees these matchers decode no match at their threshold of 0.2
(their messages drown the descriptors), so the comparisons run at 1e-6,
where every mutual arg-max is a match.

Tolerances, float32 on both sides:
- ``mha``, the Laplacian and the Sampson distances: 1e-5 relative to the
  largest value;
- the matchers on seeded inputs: the same matches0, and the scores within
  1e-4 of the largest (IMP's 8-point null vector is solved in float64 in
  the port and float32 in the JAX package);
- end to end on a planted pair: the same valid keypoints and raw match
  set (points within 1e-3 px).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import disk as jdisk
from imcui_tpu.models.extractors import sfd2 as jsfd2
from imcui_tpu.models.matchers import imp as jimp
from imcui_tpu.models.matchers import sgmnet as jsgm
from imcui_tpu.models.matchers import sphereglue as jsph
from imcui_tpu.ops import attention as jatt
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import imp as timp
from imcui_tpu_torch.models.matchers import sgmnet as tsgm
from imcui_tpu_torch.models.matchers import sphereglue as tsph
from imcui_tpu_torch.ops import attention as tatt
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

ROOT = Path(__file__).resolve().parents[1]
ROOT_YAML = ROOT / "config" / "app.yaml"
SP_NPZ = str(ROOT / "weights" / "superpoint_adapted.npz")
KEY = jax.random.PRNGKey(0)
SGM_CONF = dict(tsgm.SGMNet.default_conf)


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
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1.0, np.abs(np.asarray(want)).max()))


def _carried(ttree, init):
    """The port's tree in the JAX layout, checked against the JAX init's."""
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(init)
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree


def _pairs(seed, d, b=2, n0=200, n1=180):
    """A batch of b seeded pairs: view 1 a noisy subset of view 0
    (keypoints within 1 px, descriptors at noise 0.1), the second pair
    with padded slots in both views. Returns kpts0, kpts1, scores0,
    scores1, desc0, desc1 (B, N, D), mask0, mask1, size0, size1."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform(0, [320, 240], (b, n0, 2)).astype(np.float32)
    perm = rng.permutation(n0)[:n1]
    kp1 = (kp0[:, perm] + rng.normal(0, 1, (b, n1, 2))).astype(np.float32)
    d0 = rng.normal(size=(b, n0, d))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 = d0[:, perm] + 0.1 * rng.normal(size=(b, n1, d))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0, m1 = np.ones((b, n0), bool), np.ones((b, n1), bool)
    m0[1, n0 * 3 // 4:], m1[1, n1 * 17 // 18:] = False, False
    size = np.tile(np.array([[320, 240]], np.float32), (b, 1))
    return (kp0, kp1, rng.uniform(0, 1, (b, n0)).astype(np.float32),
            rng.uniform(0, 1, (b, n1)).astype(np.float32),
            d0.astype(np.float32), d1.astype(np.float32), m0, m1, size,
            size)


def _same_matches(got, want):
    jm = np.asarray(want["matches0"])
    tm = got["matches0"].numpy()
    assert (jm > -1).sum() > 50
    np.testing.assert_array_equal(tm, jm)
    js = np.asarray(want["matching_scores0"])
    assert _rel(got["matching_scores0"].numpy() / js.max(),
                js / js.max()) <= 1e-4


# --------------------------------------------------------------------------
# mha's bias
# --------------------------------------------------------------------------

def test_mha_bias_matches_jax():
    """An additive bias shared by the heads, then the key mask on top of it
    (a masked key stays out whatever its bias)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 30, 16)).astype(np.float32)
    k = rng.normal(size=(4, 40, 16)).astype(np.float32)
    v = rng.normal(size=(4, 40, 16)).astype(np.float32)
    bias = rng.normal(0, 3, (1, 30, 40)).astype(np.float32)
    bias[0, :, 5] = 50.0  # a masked key with the largest bias
    mask = rng.uniform(size=40) > 0.3
    mask[5] = False
    want = np.asarray(jatt.mha(*map(jnp.asarray, (q, k, v)),
                               mask_k=jnp.asarray(mask),
                               bias=jnp.asarray(bias)))
    got = tatt.mha(_t(q), _t(k), _t(v), _t(mask), _t(bias))
    assert _rel(got.numpy(), want) < 1e-5
    plain = tatt.mha(_t(q), _t(k), _t(v), _t(mask))
    assert np.abs(plain.numpy() - want).max() > 1e-2


# --------------------------------------------------------------------------
# SGMNet
# --------------------------------------------------------------------------

def test_select_seeds_keeps_the_jax_tie_order():
    """Few mutual nearest neighbours: most rows of view 0 point at one
    column, so all but a few rows score NEG_INF and the 128 seeds end with
    the lowest of them, in index order, as ``lax.top_k`` takes them."""
    rng = np.random.default_rng(1)
    n0, n1, d = 200, 180, 32
    d1 = rng.normal(size=(n1, d))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d0 = d1[0] + 0.05 * rng.normal(size=(n0, d))  # all near column 0
    d0[:20] = d1[:20] + 0.01 * rng.normal(size=(20, d))  # 20 mutual rows
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d0, d1 = d0.astype(np.float32), d1.astype(np.float32)
    m0, m1 = np.ones(n0, bool), np.ones(n1, bool)
    m0[190:] = False
    j0, j1 = jsgm.select_seeds(*map(jnp.asarray, (d0, d1, m0, m1)), 128)
    t0, t1 = tsgm.select_seeds(_t(d0)[None], _t(d1)[None], _t(m0)[None],
                               _t(m1)[None], 128)
    np.testing.assert_array_equal(t0[0].numpy(), np.asarray(j0))
    np.testing.assert_array_equal(t1[0].numpy(), np.asarray(j1))
    tail = t0[0].numpy()[-100:]
    assert (np.diff(tail) > 0).all() and tail[0] < 130


def test_sgmnet_matches_jax():
    conf = {**SGM_CONF, "match_threshold": 1e-6}
    jtree = _carried(tsgm.init_params(torch.Generator().manual_seed(0), conf),
                     lambda: jsgm.init_params(KEY, conf))
    kp0, kp1, _, _, d0, d1, m0, m1, s0, s1 = _pairs(2, 128)
    jconf = {"net_channels": 128, "seed_top_k": 128,
             "sinkhorn_iterations": 30, "match_threshold": 1e-6}
    want = jax.jit(jax.vmap(lambda *a: jsgm.forward_pair(
        jtree, *a, conf=jconf)))(*map(jnp.asarray,
                                      (kp0, kp1, d0, d1, m0, m1, s0, s1)))
    model = tsgm.SGMNet({**conf, "seed_top_k": [128, 128]}, device="cpu")
    model.params = weights.params_from_jax(jtree)
    got = model({"keypoints0": kp0, "keypoints1": kp1,
                 "descriptors0": d0.transpose(0, 2, 1),
                 "descriptors1": d1.transpose(0, 2, 1), "mask0": m0,
                 "mask1": m1, "size0": s0, "size1": s1})
    _same_matches(got, want)


# --------------------------------------------------------------------------
# IMP
# --------------------------------------------------------------------------

def test_weighted_eight_point_and_sampson_match_jax():
    """F from a weighted two-view set: the port solves the null vector in
    float64 (numpy's float64 solve to 1e-6), the JAX package in float32
    (within 1e-3 of it here, F up to sign); the Sampson distance of every
    pair under one F within 1e-5 of the JAX function's."""
    rng = np.random.default_rng(3)
    p0 = rng.uniform(-0.5, 0.5, (60, 2)).astype(np.float32)
    depth = rng.uniform(2, 4, (60, 1))
    x = np.concatenate([p0, np.ones((60, 1))], 1) * depth
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    x1 = x @ rot.T + [0.3, 0.05, 0.1]
    p1 = (x1[:, :2] / x1[:, 2:] + rng.normal(0, 1e-3, (60, 2))).astype(
        np.float32)
    w = rng.uniform(0.2, 1.0, 60).astype(np.float32)
    tf = timp.weighted_eight_point(_t(p0)[None], _t(p1)[None],
                                   _t(w)[None])[0].numpy()
    a = np.stack([p1[:, 0] * p0[:, 0], p1[:, 0] * p0[:, 1], p1[:, 0],
                  p1[:, 1] * p0[:, 0], p1[:, 1] * p0[:, 1], p1[:, 1],
                  p0[:, 0], p0[:, 1], np.ones(60)], -1).astype(np.float32)
    ata = ((a * w[:, None]).T @ a).astype(np.float32).astype(np.float64)
    exact = np.linalg.eigh(ata)[1][:, 0].reshape(3, 3)
    for want, tol in ((exact, 1e-6), (np.asarray(jimp.weighted_eight_point(
            *map(jnp.asarray, (p0, p1, w)))), 1e-3)):
        sign = np.sign((want * tf).sum())
        np.testing.assert_allclose(sign * tf, want, atol=tol)
    jf = np.asarray(jimp.weighted_eight_point(*map(jnp.asarray,
                                                   (p0, p1, w))))
    q = rng.uniform(-0.5, 0.5, (30, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a: jimp.sampson(
        jnp.asarray(jf), jnp.broadcast_to(a, (60, 2)),
        jnp.asarray(p1)))(jnp.asarray(q)))
    got = timp.sampson_pairs(_t(-jf)[None], _t(q)[None], _t(p1)[None])[0]
    assert _rel(got.numpy() / want.max(), want / want.max()) < 1e-5


def _jax_projection(dd):
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (dd, 128))
                      / dd ** 0.5)


@pytest.mark.parametrize("dd", [128, 256])
def test_imp_matches_jax(dd):
    """On 128-d descriptors (SFD2's) no projection runs; on 256-d ones both
    models are given the JAX package's PRNGKey(7) projection."""
    jtree = _carried(timp.init_params(torch.Generator().manual_seed(0)),
                     lambda: jimp.init_params(KEY))
    args = _pairs(4, dd)
    conf = {"match_threshold": 1e-6}
    mp = pytest.MonkeyPatch()
    mp.setattr(jimp, "load_params", lambda c: (None, {"pretrained": False}))
    jmodel = jimp.IMP(conf)
    mp.undo()
    jmodel.params = jtree
    tmodel = timp.IMP(conf, device="cpu")
    tmodel.params = weights.params_from_jax(jtree)
    if dd != 128:
        jmodel._proj[dd] = jnp.asarray(_jax_projection(dd))
        tmodel._proj[dd] = torch.from_numpy(_jax_projection(dd))
        assert tmodel.projection(dd) is tmodel._proj[dd]
    data = {"image0": None, "image1": None}
    for i, key in enumerate(("keypoints0", "keypoints1", "scores0",
                             "scores1", "descriptors0", "descriptors1",
                             "mask0", "mask1", "size0", "size1")):
        data[key] = args[i]
    want = jmodel(data)
    got = tmodel(data)
    _same_matches(got, want)


def test_imp_draws_its_own_seeded_projection():
    """Without an injected projection the port draws a fixed (D, 128) one,
    scaled by 1/sqrt(D), the same on every build."""
    a = timp.IMP({}, device="cpu").projection(64)
    b = timp.IMP({}, device="cpu").projection(64)
    assert a.shape == (64, 128) and torch.equal(a, b)
    assert abs(float(a.std()) * 8 - 1.0) < 0.05


# --------------------------------------------------------------------------
# SphereGlue
# --------------------------------------------------------------------------

def _sphere_points(seed, n, n_valid):
    """n equirectangular keypoints of a 640 × 320 image whose first n_valid
    (the valid slots) have their KNN-th and next neighbours apart in
    cosine by more than 1e-5 on every row, so that float32's last bits do
    not decide the graph."""
    rng = np.random.default_rng(seed)
    while True:
        kp = rng.uniform(0, [640, 320], (n, 2)).astype(np.float32)
        xyz = np.asarray(jsph.to_sphere(jnp.asarray(kp[:n_valid]),
                                        jnp.asarray([640.0, 320.0])))
        dots = np.sort(xyz @ xyz.T - 3 * np.eye(n_valid), 1)[:, ::-1]
        if (dots[:, tsph.KNN - 1] - dots[:, tsph.KNN]).min() > 1e-5:
            return kp


def test_cheb_laplacian_matches_jax():
    kp = _sphere_points(5, 120, 100)
    mask = np.ones(len(kp), bool)
    mask[100:] = False
    size = np.array([640.0, 320.0], np.float32)
    xyz_j = jsph.to_sphere(jnp.asarray(kp), jnp.asarray(size))
    want = np.asarray(jsph.cheb_laplacian(xyz_j, jnp.asarray(mask)))
    xyz_t = tsph.to_sphere(_t(kp)[None], _t(size)[None])
    assert _rel(xyz_t[0].numpy(), np.asarray(xyz_j)) < 1e-6
    got = tsph.cheb_laplacian(xyz_t, _t(mask)[None])[0].numpy()
    assert _rel(got, want) < 1e-5
    adj = tsph.knn_adjacency(tsph.masked_dots(xyz_t, _t(mask)[None]))[0]
    assert adj[:100].sum(1).min() >= tsph.KNN and adj[100:].sum() == 0


def _sphere_inputs():
    """_pairs' descriptors and scores on keypoints spread as
    ``_sphere_points`` says, of 640 × 320 images."""
    args = list(_pairs(6, 256, n0=120, n1=110))
    for v in (0, 1):
        for b in range(2):
            n = args[v].shape[1]
            args[v][b] = _sphere_points(7 + 2 * b + v, n,
                                        int(args[6 + v][b].sum()))
    args[8][:] = args[9][:] = [640.0, 320.0]
    return args


def test_sphereglue_matches_jax_and_ignores_knn_and_k():
    """The JAX module takes KNN = 20 and K_CHEB = 2 whatever the conf
    says; so does the port."""
    jtree = _carried(tsph.init_params(torch.Generator().manual_seed(0)),
                     lambda: jsph.init_params(KEY))
    args = _sphere_inputs()
    jconf = {"sinkhorn_iterations": 20, "match_threshold": 1e-6}
    want = jax.jit(jax.vmap(lambda *a: jsph.forward(jtree, *a, jconf)))(
        *map(jnp.asarray, args))
    want = {"matches0": want[0], "matching_scores0": want[1]}
    keys = ("keypoints0", "keypoints1", "scores0", "scores1",
            "descriptors0", "descriptors1", "mask0", "mask1", "size0",
            "size1")
    data = {"image0": None, "image1": None, **dict(zip(keys, args))}
    outs = []
    for conf in ({}, {"knn": 5, "K": 7}):
        model = tsph.SphereGlue({**conf, "match_threshold": 1e-6},
                                device="cpu")
        model.params = weights.params_from_jax(jtree)
        outs.append(model(data))
    _same_matches(outs[0], want)
    for k in ("matches0", "matching_scores0"):
        assert torch.equal(outs[0][k], outs[1][k])


# --------------------------------------------------------------------------
# the entries end to end through both ImageMatchingAPIs
# --------------------------------------------------------------------------

def _entry(ui, name):
    if name == "disk+sgmnet":
        return ui.parse_match_config({"feature": "disk", "matcher": "sgmnet",
                                      "dense": False})
    return ui.get_matcher_zoo(ui.load_config(ROOT_YAML)["matcher_zoo"])[name]


# name → planted pair size: superpoint_max resizes every image to 640 ×
# 480, SFD2's random tree keeps tens of keypoints of its 1/4 map on a 256 ×
# 192 pair
ENTRIES = {"superpoint+sphereglue": (640, 480), "sfd2+imp": (256, 192),
           "disk+sgmnet": (128, 96)}
JAX_MODELS = {jsph: lambda c: jsph.init_params(
    KEY, c["descriptor_dim"], c["output_dim"]),
    jimp: lambda c: jimp.init_params(KEY),
    jsgm: lambda c: jsgm.init_params(KEY, c),
    jsfd2: lambda c: jsfd2.init_params(KEY),
    jdisk: lambda c: jdisk.init_params(KEY)}


def _apis(name):
    """Both packages' API at 256 keypoints: SuperPoint in fp32 on the
    trained tree, every other model on the port's seed-0 tree, the matcher
    at threshold 1e-6, no RANSAC (the raw matches are compared)."""
    confs = []
    for ui in (jui, tui):
        conf = _entry(ui, name)
        if conf["feature"]["model"]["name"] == "superpoint":
            conf["feature"]["model"].update(checkpoint_npz=SP_NPZ,
                                            precision="fp32")
        conf["matcher"]["model"]["match_threshold"] = 1e-6
        conf["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(conf)
    mp = pytest.MonkeyPatch()
    for mod in JAX_MODELS:
        mp.setattr(mod, "load_params", lambda c: (None, {"pretrained": False}))
    try:
        japi = JaxAPI(confs[0], max_keypoints=256)
    finally:
        mp.undo()
    tapi = TorchAPI(confs[1], device="cpu", max_keypoints=256)
    for part in ("extractor", "matcher"):
        jmodel, tmodel = getattr(japi, part), getattr(tapi, part)
        jmod = next((m for m in JAX_MODELS
                     if type(jmodel).__module__ == m.__name__), None)
        if jmod is not None:
            jmodel.params = _carried(
                tmodel.params, lambda: JAX_MODELS[jmod](jmodel.conf))
            tmodel.params = weights.params_from_jax(jmodel.params)
    return japi, tapi


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_end_to_end_matches_jax(name):
    planted = chip_smoke.synthetic_pair(101, *ENTRIES[name])
    japi, tapi = _apis(name)
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    assert set(got) == set(want)
    for k in ("keypoints0_orig", "keypoints1_orig"):
        assert len(got[k]) == len(want[k]) > 10, (name, k)
        iou = chip_smoke.common_points(got[k], want[k], 1e-3)[0]
        assert iou == 1.0, (name, k, iou)
    assert len(got["mkeypoints0_orig"]) >= 10, name
    iou = chip_smoke.raw_match_iou(got, want, tol=1e-3)
    assert iou == 1.0, (name, iou)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["sgmnet", "imp", "sphereglue"])
def test_matcher_on_cuda_without_a_card_raises(name):
    from imcui_tpu_torch.models import matchers
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(matchers, name)({})
