"""The port's Sinkhorn (``ops/sinkhorn.py``), SuperGlue and AdaLAM against
the JAX package on the CPU.

Inputs come from numpy seeds; SuperGlue runs a random tree in the JAX
package's layout (that of its ``init_params``), given to the JAX model
and carried across by ``weights.params_from_jax``, at 4 GNN layers (two
self, two cross). Tolerances, all float32 on both sides:
- the Sinkhorn log assignment within 1e-4 relative to its largest
  magnitude (logsumexp in another order over 50 iterations; measured
  ~1e-6), the same NaN and -inf entries where a view has no keypoint;
- SuperGlue's log assignment within 1e-5 of its largest valid entry
  (measured 9e-7), masked entries equal; the same match set, scores
  within 1e-4 relative (measured 1.4e-5);
- AdaLAM: the same surviving match set (the seeds come from
  ``torch.topk`` where JAX takes ``lax.top_k``), scores within 1e-6;
- end to end through both ``ImageMatchingAPI``s on a planted 400 × 300
  pair: the same raw match set (points within 1e-3 px).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.matchers import adalam as jadalam
from imcui_tpu.models.matchers import superglue as jsg
from imcui_tpu.ops import sinkhorn as jsk
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import adalam as tadalam
from imcui_tpu_torch.models.matchers import superglue as tsg
from imcui_tpu_torch.ops import sinkhorn as tsk
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

ROOT = Path(__file__).resolve().parents[1]
SP_NPZ = str(ROOT / "weights" / "superpoint_adapted.npz")
SG_LAYERS = 4


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


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------------
# ops/sinkhorn.py
# --------------------------------------------------------------------------

def _jax_ot(scores, alpha, iters, m0, m1):
    return np.asarray(jax.vmap(
        lambda s, a, b: jsk.log_optimal_transport(s, alpha, iters, a, b))(
            jnp.asarray(scores), jnp.asarray(m0), jnp.asarray(m1)))


@pytest.mark.parametrize("iters", [5, 50])
def test_log_optimal_transport_and_decode_match_jax(iters):
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(3, 37, 29)).astype(np.float32) * 3
    m0 = rng.random((3, 37)) > 0.2
    m1 = rng.random((3, 29)) > 0.3
    m0[2] = True  # a pair without padding
    m1[2] = True
    alpha = np.float32(1.3)
    want = _jax_ot(scores, alpha, iters, m0, m1)
    got = tsk.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(alpha), iters,
        torch.from_numpy(m0), torch.from_numpy(m1)).numpy()
    assert got.shape == (3, 38, 30)
    assert _rel(got, want) < 1e-4
    # the same log assignment decodes to the same matches in both
    z = jnp.asarray(want)
    jm, js = jax.vmap(lambda a, b, c: jsk.matches_from_assignment(
        a, 0.05, b, c))(z, jnp.asarray(m0), jnp.asarray(m1))
    tm, ts = tsk.matches_from_assignment(
        torch.from_numpy(want), 0.05, torch.from_numpy(m0),
        torch.from_numpy(m1))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm.numpy() > -1).sum() > 5
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # unmasked: the defaults are all-valid masks
    full = tsk.log_optimal_transport(torch.from_numpy(scores[2]),
                                     torch.tensor(alpha), iters).numpy()
    np.testing.assert_allclose(full, got[2], atol=1e-6)


@pytest.mark.parametrize("empty", ["view0", "view1", "both"])
def test_sinkhorn_with_a_view_without_keypoints_as_jax(empty):
    """log(0) enters the marginals in both packages: an empty view 0 sets
    the dustbin column to -inf (its count is the column dustbin's mass),
    an empty view 1 the dustbin row, and two make every entry NaN; each
    decodes to no match."""
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(1, 12, 9)).astype(np.float32)
    m0 = np.ones((1, 12), bool)
    m1 = np.ones((1, 9), bool)
    if empty in ("view0", "both"):
        m0[:] = False
    if empty in ("view1", "both"):
        m1[:] = False
    want = _jax_ot(scores, np.float32(1.0), 20, m0, m1)
    got = tsk.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(1.0), 20,
        torch.from_numpy(m0), torch.from_numpy(m1)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    if empty == "both":
        assert np.isnan(got).all()
    else:
        assert np.isneginf(got[0, :, -1] if empty == "view0"
                           else got[0, -1, :]).all()
    m, s = tsk.matches_from_assignment(torch.from_numpy(got), 0.2,
                                       torch.from_numpy(m0),
                                       torch.from_numpy(m1))
    jm, _ = jsk.matches_from_assignment(jnp.asarray(want[0]), 0.2,
                                        jnp.asarray(m0[0]),
                                        jnp.asarray(m1[0]))
    assert (m.numpy() == -1).all() and (np.asarray(jm) == -1).all()
    assert (s.numpy() == 0).all()


# --------------------------------------------------------------------------
# SuperGlue
# --------------------------------------------------------------------------

SG_CONF = {**jsg.SuperGlue.default_conf, "gnn_layers": SG_LAYERS}


def _sg_inputs(seed, n0=150, n1=130, b=2):
    """A batch of keypoint sets with partial masks and descriptors that
    share structure (so that some matches clear the threshold)."""
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0, [320, 240], (b, n0, 2)).astype(np.float32)
    k1 = rng.uniform(0, [300, 260], (b, n1, 2)).astype(np.float32)
    base = rng.normal(size=(b, max(n0, n1), 256)).astype(np.float32)
    d0 = base[:, :n0] + 0.3 * rng.normal(size=(b, n0, 256))
    d1 = base[:, :n1] + 0.3 * rng.normal(size=(b, n1, 256))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    s0 = rng.uniform(0, 1, (b, n0)).astype(np.float32)
    s1 = rng.uniform(0, 1, (b, n1)).astype(np.float32)
    m0 = np.ones((b, n0), bool)
    m1 = np.ones((b, n1), bool)
    m0[0, 120:] = False
    m1[1, 100:] = False
    size = np.array([[320, 240]] * b, np.float32)
    return (k0, k1, s0, s1, d0.astype(np.float32), d1.astype(np.float32),
            m0, m1, size, size)


def _jax_sg_assignment(params, conf, *args):
    """The JAX module's forward_pair up to its log assignment, composed of
    the module's own functions in its order."""
    def one(k0, k1, s0, s1, d0, d1, m0, m1, z0, z1):
        enc = params["kenc"]["encoder"]
        ch = jsg.KENC_CHANNELS + [256]
        x0 = d0 + jsg.mlp_apply(enc, jnp.concatenate(
            [jsg.normalize_keypoints(k0, z0), s0[:, None]], -1), ch)
        x1 = d1 + jsg.mlp_apply(enc, jnp.concatenate(
            [jsg.normalize_keypoints(k1, z1), s1[:, None]], -1), ch)
        for i, layer in enumerate(params["gnn"]["layers"]):
            if i % 2 == 0:
                e0 = jsg.attn_propagation(layer, x0, x0, m0, 4)
                e1 = jsg.attn_propagation(layer, x1, x1, m1, 4)
            else:
                e0 = jsg.attn_propagation(layer, x0, x1, m1, 4)
                e1 = jsg.attn_propagation(layer, x1, x0, m0, 4)
            x0, x1 = x0 + e0, x1 + e1
        p0 = jsg.linear(params["final_proj"], x0)
        p1 = jsg.linear(params["final_proj"], x1)
        sim = jnp.einsum("nd,md->nm", p0, p1) / 256 ** 0.5
        return jsk.log_optimal_transport(sim, params["bin_score"],
                                         conf["sinkhorn_iterations"], m0, m1)

    return np.asarray(jax.jit(jax.vmap(one))(*map(jnp.asarray, args)))


def _passing_tree(conf):
    """A random SuperGlue tree in the JAX package's layout, checked against
    that of the JAX init (``jax.eval_shape``: the JAX init runs op by op,
    seconds a tree on a CPU), made to carry descriptors through: at init
    the GNN's messages drown them and no assignment probability reaches
    0.01, so no comparison of matches would see one. The last linear of
    every message MLP is shrunk by 20 and final_proj grown by 10, so that
    the similarity of the (planted or SuperPoint) descriptors decides."""
    jtree = weights.params_to_jax(tsg.init_params(
        torch.Generator().manual_seed(0), conf))
    shapes = jax.eval_shape(
        lambda: jsg.init_params(jax.random.PRNGKey(0), conf))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    for layer in jtree["gnn"]["layers"]:
        layer["mlp"]["3"]["w"] = layer["mlp"]["3"]["w"] / 20
    jtree["final_proj"]["w"] = jtree["final_proj"]["w"] * 10
    return jtree


@pytest.fixture(scope="module")
def sg_trees():
    jtree = _passing_tree(SG_CONF)
    # a trained tree's BN statistics are not the init's 0 and 1, nor its
    # dustbin score 1: draw them, so that the carrier is checked on them
    rng = np.random.default_rng(5)
    for node in (jtree["kenc"]["encoder"]["1"],
                 jtree["gnn"]["layers"][1]["mlp"]["1"]):
        node["mean"] = rng.normal(size=node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.5, 2, node["var"].shape).astype(
            np.float32)
    jtree["bin_score"] = np.float32(2.3)
    return jtree, weights.params_from_jax(jtree)


def test_superglue_tree_carries_and_matches_the_init_tree(sg_trees):
    jtree, ttree = sg_trees
    init = tsg.init_params(torch.Generator().manual_seed(0),
                           {**tsg.SuperGlue.default_conf,
                            "gnn_layers": SG_LAYERS})
    weights.assert_tree_matches(ttree, init, "superglue")
    assert ttree["bin_score"].shape == () and float(ttree["bin_score"]) \
        == pytest.approx(2.3)
    # the 1 x 1 Conv1d layers are linears: (din, dout) -> (dout, din)
    np.testing.assert_array_equal(
        ttree["gnn"]["layers"][0]["attn"]["proj"]["1"]["w"].numpy(),
        jtree["gnn"]["layers"][0]["attn"]["proj"]["1"]["w"].T)


def test_superglue_forward_matches_jax(sg_trees):
    jtree, ttree = sg_trees
    args = _sg_inputs(3)
    want_z = _jax_sg_assignment(jtree, SG_CONF, *args)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got_z = tsg.log_assignment(ttree, *targs, 4, 50).numpy()
    assert got_z.shape == want_z.shape == (2, 151, 131)
    # the entries of valid slots and dustbins within 1e-5 of the largest
    # of them (measured 9e-7: 3.1e-5 at 33.3); masked entries exactly -1e9
    m0, m1 = args[6], args[7]
    valid = np.pad(m0, ((0, 0), (0, 1)), constant_values=True)[:, :, None] \
        & np.pad(m1, ((0, 0), (0, 1)), constant_values=True)[:, None, :]
    err = np.abs(got_z - want_z)[valid].max()
    assert err <= 1e-5 * max(1.0, np.abs(want_z[valid]).max()), err
    np.testing.assert_array_equal(got_z[~valid], want_z[~valid])

    conf_key = tuple(sorted({"num_heads": 4, "sinkhorn_iterations": 50,
                             "match_threshold": 0.2}.items()))
    want = jsg._apply_batched(jtree, *map(jnp.asarray, args),
                              conf_key=conf_key)
    model = tsg.SuperGlue({"gnn_layers": SG_LAYERS}, device="cpu")
    assert model.meta["pretrained"] is False
    assert "random init (seed 0)" in model.meta["source"]
    model.params = ttree
    k0, k1, s0, s1, d0, d1, m0, m1, z0, z1 = args
    got = model({"keypoints0": k0, "keypoints1": k1, "scores0": s0,
                 "scores1": s1, "descriptors0": d0.transpose(0, 2, 1),
                 "descriptors1": d1.transpose(0, 2, 1), "mask0": m0,
                 "mask1": m1, "size0": z0, "size1": z1})
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    assert (got["matches0"].numpy() > -1).sum() > 20
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               rtol=1e-4, atol=1e-6)


def test_superglue_size_fallbacks_and_confs():
    """``sizes()``'s three routes and the registry's two confs."""
    model = tsg.SuperGlue({"gnn_layers": 2}, device="cpu")
    k = np.array([[[10.0, 20.0], [99.0, 49.0]]], np.float32)
    base = {"keypoints0": k, "keypoints1": k, "scores0": np.ones((1, 2)),
            "scores1": np.ones((1, 2)),
            "descriptors0": np.ones((1, 256, 2), np.float32),
            "descriptors1": np.ones((1, 256, 2), np.float32)}
    sizes = [model.inputs(d)[9].tolist() for d in (
        {**base, "size0": np.array([[640.0, 480.0]])},
        {**base, "image0": np.zeros((1, 1, 48, 64), np.float32)},
        base)]
    assert sizes == [[[640.0, 480.0]], [[64.0, 48.0]], [[100.0, 50.0]]]
    assert tsg.SuperGlue.default_conf == jsg.SuperGlue.default_conf
    for name, iters in (("superglue", 50), ("superglue-fast", 5)):
        conf = tui.parse_match_config({"feature": "superpoint_aachen",
                                       "matcher": name})
        m = tui.get_model(conf["matcher"], "cpu")
        assert isinstance(m, tsg.SuperGlue)
        assert m.conf["sinkhorn_iterations"] == iters
        assert len(m.params["gnn"]["layers"]) == 18


# --------------------------------------------------------------------------
# AdaLAM
# --------------------------------------------------------------------------

def _adalam_inputs(seed, n=200):
    """Keypoints under a smooth warp with partly shared descriptors: a
    consistent core, outliers and padded slots."""
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0, [320, 240], (2, n, 2)).astype(np.float32)
    a = np.array([[1.05, 0.08], [-0.06, 0.97]], np.float32)
    k1 = k0 @ a.T + np.array([7.0, -4.0], np.float32)
    k1 += rng.normal(0, 0.8, k1.shape).astype(np.float32)
    perm = rng.permutation(n)
    k1 = k1[:, perm]
    d = rng.normal(size=(2, n, 64)).astype(np.float32)
    d0 = d + 0.1 * rng.normal(size=d.shape).astype(np.float32)
    d1 = d[:, perm] + 0.1 * rng.normal(size=d.shape).astype(np.float32)
    out = rng.random(n) < 0.3  # their partners' descriptors are noise
    d1[:, np.argsort(perm)[out]] = rng.normal(size=(2, out.sum(), 64))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0 = np.ones((2, n), bool)
    m1 = np.ones((2, n), bool)
    m0[1, 170:] = False
    m1[1, :15] = False
    size = np.array([[320, 240]] * 2, np.float32)
    return k0, k1, d0, d1, m0, m1, size


def test_fit_local_affine_recovers_an_affine_as_jax():
    rng = np.random.default_rng(2)
    k0 = rng.uniform(0, 1, (50, 2)).astype(np.float32)
    a = np.array([[0.9, 0.2], [-0.1, 1.1]], np.float32)
    k1 = k0 @ a + np.array([0.05, -0.02], np.float32)
    w = rng.uniform(0, 1, (3, 50)).astype(np.float32)
    jA, jb = jax.vmap(lambda ww: jadalam._fit_local_affine(
        jnp.asarray(k0), jnp.asarray(k1), ww))(jnp.asarray(w))
    tA, tb = tadalam._fit_local_affine(torch.from_numpy(k0),
                                       torch.from_numpy(k1),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(tA[0].numpy(), a, atol=1e-3)


def test_adalam_matches_jax():
    k0, k1, d0, d1, m0, m1, size = _adalam_inputs(4)
    want = jadalam._apply(*map(jnp.asarray, (
        k0, k1, d0.transpose(0, 2, 1), d1.transpose(0, 2, 1), m0, m1, size,
        size)), num_seeds=64, min_support=6)
    model = tadalam.AdaLAM({}, device="cpu")
    got = model({"keypoints0": k0, "keypoints1": k1,
                 "descriptors0": d0.transpose(0, 2, 1),
                 "descriptors1": d1.transpose(0, 2, 1), "mask0": m0,
                 "mask1": m1, "size0": size, "size1": size})
    wm = np.asarray(want["matches0"])
    gm = got["matches0"].numpy()
    for b in range(2):
        assert {(i, j) for i, j in enumerate(gm[b]) if j > -1} == \
            {(i, j) for i, j in enumerate(wm[b]) if j > -1}
    assert (gm > -1).sum() > 100
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               atol=1e-6)
    # the filter drops some of the ratio-test matches
    nn = tadalam.mutual_nn_match(torch.from_numpy(d0), torch.from_numpy(d1),
                                 torch.from_numpy(m0), torch.from_numpy(m1),
                                 ratio_thresh=0.95)
    assert (nn["matches0"].numpy() > -1).sum() > (gm > -1).sum()


# --------------------------------------------------------------------------
# end to end, both ImageMatchingAPIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(100, 400, 300)


def _apis(key, model_update=None):
    """Both packages' ImageMatchingAPI on the packaged zoo entry ``key``,
    SuperPoint in fp32 on the trained tree, the port's matcher on the JAX
    package's tree (SuperGlue's made to pass descriptors, as above)."""
    out = []
    mp = pytest.MonkeyPatch()  # the JAX SuperGlue's init is replaced below
    mp.setattr(jsg, "load_params", lambda c: (None, {"pretrained": False}))
    for ui, API in ((jui, JaxAPI), (tui, TorchAPI)):
        zoo = ui.get_matcher_zoo(ui.load_config(
            ROOT / "imcui_tpu/config/app.yaml")["matcher_zoo"])
        conf = zoo[key]
        conf["feature"]["model"].update(checkpoint_npz=SP_NPZ,
                                        precision="fp32")
        conf["matcher"]["model"].update(model_update or {})
        if key == "superglue":  # raw matches only: no RANSAC
            conf["ransac"] = {**TorchAPI.default_conf["ransac"],
                              "enable": False}
        out.append(API(conf, **({"device": "cpu"} if ui is tui else {})))
    mp.undo()
    japi, tapi = out
    if hasattr(tapi.matcher, "params"):
        japi.matcher.params = _passing_tree(japi.matcher.conf)
        tapi.matcher.params = weights.params_from_jax(japi.matcher.params)
    return japi, tapi


@pytest.mark.parametrize("key,update", [
    ("superglue", {"gnn_layers": SG_LAYERS}),
    ("superpoint+adalam", None),
])
def test_zoo_entry_end_to_end_matches_jax(planted, key, update):
    japi, tapi = _apis(key, update)
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["keypoints0_orig"],
                               want["keypoints0_orig"], atol=1e-3)
    assert len(got["mkeypoints0_orig"]) > 40
    iou = chip_smoke.raw_match_iou(got, want, tol=1e-3)
    assert iou == 1.0, iou
    if key == "superpoint+adalam":
        # the planted homography holds the RANSAC inliers in both
        for pred in (want, got):
            err = chip_smoke.transfer_errors(
                planted[2], pred["mmkeypoints0_orig"],
                pred["mmkeypoints1_orig"])
            assert len(err) >= 50 and np.median(err) <= 2.0
