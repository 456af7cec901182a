"""The LoFTR family in the port (``eloftr``, ``se2loftr``, ``xoftr``,
``aspanformer``, ``topicfm``, ``matchformer``, LoMa (``loma-b``; the
registry's four LoMa confs build one model), ``jamma`` and ``rdd_dense`` under
imcui_tpu_torch/models/matchers/, the ``rdd`` extractor) and RoMa's
``fpn-corr`` backbone against the JAX package on the CPU. Each runs its
JAX ``init_params`` tree, carried across by ``weights.params_from_jax``,
through both packages at 128 × 160 in float32: the JAX package's jitted
pair batch against the port's ``BaseModel``. LoMa's and JamMa's chunked
scan (``loma.linear_scan``) is also held against ``lax.associative_scan``
at 2048 tokens: 1e-5 of the largest state.

None of these models has a trained tree in the repository, and random
weights leave few matches above the registry's threshold: where they
leave none, the test lowers ``match_threshold`` (per model below) and
asserts that the set is not empty, so that no comparison passes on
nothing. Tolerances: the same valid match set, keypoints within 1e-3 px,
scores within 1e-4 (aspanformer's 2e-4, see FAMILY).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imcui_tpu.models.extractors import rdd as jrdd
from imcui_tpu.models.matchers import loma as jloma
from imcui_tpu.models.matchers import roma as jroma
from imcui_tpu_torch.configs import confs_dict
from imcui_tpu_torch.models.extractors import rdd as trdd
from imcui_tpu_torch.models.matchers import loma as tloma
from imcui_tpu_torch.models.matchers import roma as troma
from imcui_tpu_torch.utils import weights

H, W = 128, 160
# thresholds that keep matches on the random trees at this size
THR_LOMA, THR_JAMMA, THR_RDD = 1e-3, 1e-3, 1e-6
# name → (match_threshold, the class's name in the port, the scores'
# tolerance). The registry's threshold where the random tree keeps matches
# above it (xoftr 0.3, aspanformer and topicfm 0.2); else the largest of
# 1e-3, 1e-4 that does. Scores within 1e-4, aspanformer's within 2e-4: its
# coarse tokens pass through six attention layers (two of them dense
# softmaxes over flow-placed spans), and a float32 difference of ~1e-6 in
# a token becomes ~1e-4 in a dual-softmax confidence, whose exponent is
# 2/temperature = 20 times the logit (measured 1.17e-4 on 0.957).
FAMILY = {
    "eloftr": (1e-3, "ELoFTR", 1e-4),
    "se2loftr": (1e-3, "Se2LoFTR", 1e-4),
    "xoftr": (0.3, "XoFTR", 1e-4),
    "aspanformer": (0.2, "ASpanFormer", 2e-4),
    "topicfm": (0.2, "TopicFM", 1e-4),
    "matchformer": (1e-4, "MatchFormer", 1e-4),
    "loma-b": (THR_LOMA, "LoMa", 1e-4),
    "jamma": (THR_JAMMA, "JamMa", 1e-4),
    "rdd_dense": (THR_RDD, "RddDense", 1e-4),
}
SLOTS = 200
# Image-1 points of the scan family: within 1e-2 px. Their coarse tokens
# agree with the JAX package's to 3e-6 of the largest, but on these random
# trees the fine windows reach ~65, so the fine logits (a 128-d product
# over temperature 0.1) are ~1e5 and a float32 rounding of them moves a
# near-tie's expectation: the port's fine_match fed the JAX package's own
# windows differs by up to 2.8e-3 in offset (5.5e-3 px), measured on loma-b.
KP1_TOL = {"loma-b": 1e-2, "jamma": 1e-2}
# LoMa's four registry confs differ only in model_name, which names an
# upstream checkpoint; none is in the repository, so all four build loma-b's
# model (test_loma_registry_confs_build_one_model) and only loma-b is
# compared with the JAX package.
LOMA_CONFS = ("loma-b", "loma-l", "loma-g", "loma-r")


def _module(name):
    """The module of a registry name (``loma-b`` → ``loma``)."""
    return confs_dict["matchers"][name]["model"]["name"]


def _conf(name, thr):
    """The registry's model conf with SLOTS match slots at threshold
    ``thr`` (LoMa names its threshold filter_threshold)."""
    if name in ("eloftr", "se2loftr", "xoftr", "aspanformer", "topicfm",
                "matchformer"):
        return {"max_keypoints": SLOTS, "match_threshold": thr}
    conf = dict(confs_dict["matchers"][name]["model"], max_keypoints=SLOTS,
                match_threshold=thr)
    if _module(name) == "loma":
        conf["filter_threshold"] = thr
    return conf


def _jax_init(name):
    mod = _module(name)
    if mod == "rdd_dense":
        mod = "rdd"
        pkg = "extractors"
    else:
        pkg = "matchers"
    jm = importlib.import_module(f"imcui_tpu.models.{pkg}.{mod}")
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def pair():
    """Image 1 is a shifted crop of image 0 (numpy seed 8); image 1's
    valid width is W - 24, as if it were padded."""
    rng = np.random.default_rng(8)
    big = rng.random((H + 16, W + 16)).astype(np.float32)
    return (big[:H, :W][None, None], big[8:H + 8, 16:W + 16][None, None],
            np.array([[W, H]]), np.array([[W - 24, H]]))


def _rows(k0, k1, score, mask):
    r = np.concatenate([k0, k1, score[:, None]], 1)[mask]
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize("name", list(FAMILY))
def test_family_matcher_matches_jax(name, pair):
    thr, cls, score_tol = FAMILY[name]
    jm = importlib.import_module(f"imcui_tpu.models.matchers.{_module(name)}")
    tm = importlib.import_module(
        f"imcui_tpu_torch.models.matchers.{_module(name)}")
    tree = _jax_init(name)
    tp = weights.params_from_jax(tree)

    model = getattr(tm, cls)(_conf(name, thr), device="cpu")
    assert model.meta["pretrained"] is False
    assert "random init" in model.meta["source"]
    # the port's own init has the JAX tree's leaves and shapes
    weights.assert_tree_matches(model.params, tp, name)
    model.params = tp

    img0, img1, wh0, wh1 = pair
    conf = {**model.pair_conf}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    if name == "rdd_dense":  # three channels, the slots and threshold
        want = jm._apply_batched(
            jtree, *(jnp.asarray(np.repeat(x.transpose(0, 2, 3, 1), 3, -1))
                     for x in (img0, img1)), jnp.asarray(wh0),
            jnp.asarray(wh1), max_matches=conf["max_matches"],
            threshold=conf["match_threshold"])
    else:
        want = jm._apply_batched(
            jtree, jnp.asarray(img0.transpose(0, 2, 3, 1)),
            jnp.asarray(img1.transpose(0, 2, 3, 1)), jnp.asarray(wh0),
            jnp.asarray(wh1), tuple(sorted(conf.items())))
    want = {k: np.asarray(v)[0] for k, v in want.items()}
    got = model({"image0": img0, "image1": img1, "size0": wh0,
                 "size1": wh1})
    got = {k: v[0].numpy() for k, v in got.items()}

    assert got["keypoints0"].shape == (SLOTS, 2)
    assert np.array_equal(got["mconf"], got["scores"])
    for k in ("keypoints0", "keypoints1", "scores"):
        assert np.isfinite(got[k]).all()
    assert got["mask"].sum() > 0 and want["mask"].sum() > 0
    a = _rows(want["keypoints0"], want["keypoints1"], want["scores"],
              want["mask"])
    b = _rows(got["keypoints0"], got["keypoints1"], got["scores"],
              got["mask"])
    assert a.shape == b.shape
    assert np.abs(a[:, :2] - b[:, :2]).max() <= 1e-3
    assert np.abs(a[:, 2:4] - b[:, 2:4]).max() <= KP1_TOL.get(name, 1e-3)
    assert np.abs(a[:, 4] - b[:, 4]).max() <= score_tol
    # nothing matches into image 1's padding (its last three cells)
    assert got["keypoints1"][got["mask"], 0].max() < W - 24 + 8


def test_loma_registry_confs_build_one_model():
    """``loma-b/l/g/r`` build the same tree and the same pair conf, so the
    JAX comparison of ``loma-b`` above covers all four."""
    models = [tloma.LoMa(confs_dict["matchers"][n]["model"], device="cpu")
              for n in LOMA_CONFS]
    assert {_module(n) for n in LOMA_CONFS} == {"loma"}
    for n, m in zip(LOMA_CONFS[1:], models[1:]):
        assert m.pair_conf == models[0].pair_conf, n
        assert m.meta == models[0].meta, n
        weights.assert_tree_matches(m.params, models[0].params, n)
        ref = weights.flatten_tree(models[0].params)
        for k, v in weights.flatten_tree(m.params).items():
            assert torch.equal(v, ref[k]), (n, k)


def test_family_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name, (_, cls, _) in FAMILY.items():
        tm = importlib.import_module(
            f"imcui_tpu_torch.models.matchers.{_module(name)}")
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(tm, cls)({})
    with pytest.raises(RuntimeError, match="cuda"):
        trdd.Rdd({})


def test_roma_fpn_corr_matches_jax(pair):
    """RoMa's fpn-corr path on the JAX init tree: the wrapper's sampled
    correspondences (100 of the 320 coarse cells, in image 0's pixels)
    against the JAX Roma's, as sets within 1e-3 px and certainties within
    1e-5; then the warp and certainty of ``match`` within 1e-5. bf16 runs
    and stays finite."""
    conf = {"backbone": "fpn-corr", "max_keypoints": 100}
    tree = jax.tree_util.tree_map(
        np.asarray, jroma.init_params_fpn(jax.random.PRNGKey(0)))
    jm = jroma.Roma(conf)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = troma.Roma(conf, device="cpu")
    assert tm.meta["pretrained"] is False and tm.meta["backbone"] == "fpn-corr"
    tp = weights.params_from_jax(tree)
    weights.assert_tree_matches(tm.params, tp, "roma fpn-corr")
    tm.params = tp

    img0, img1 = (np.repeat(x, 3, 1) for x in pair[:2])  # the gray mean runs
    data = {"image0": img0, "image1": img1}
    want = {k: np.asarray(v)[0] for k, v in jm(data).items()}
    got = {k: v[0].numpy() for k, v in tm(data).items()}
    assert got["keypoints0"].shape == (100, 2) and got["mask"].all()
    a = _rows(want["keypoints0"], want["keypoints1"], want["scores"],
              want["mask"])
    b = _rows(got["keypoints0"], got["keypoints1"], got["scores"],
              got["mask"])
    assert a.shape == b.shape
    assert np.abs(a[:, :4] - b[:, :4]).max() <= 1e-3
    assert np.abs(a[:, 4] - b[:, 4]).max() <= 1e-5
    assert got["keypoints0"].max() <= W - 1 + 1e-3

    x0, x1 = (jnp.asarray(x[0].transpose(1, 2, 0)) for x in pair[:2])
    wj, cj = jroma.match(jm.params, x0, x1)
    with torch.inference_mode(), troma.full_fp32():
        wt, ct = troma.match(tp, torch.from_numpy(pair[0][0]),
                             torch.from_numpy(pair[1][0]))
    assert wt.shape == (H // 8, W // 8, 2) and ct.shape == (H // 8, W // 8)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)

    tb = troma.Roma({**conf, "precision": "bf16"}, device="cpu")
    out = tb(data)
    assert out["keypoints0"].shape == (1, 100, 2)
    assert torch.isfinite(out["keypoints1"]).all()
    assert bool(((out["scores"] >= 0) & (out["scores"] <= 1)).all())


def combine(c1, c2):
    return c1[0] * c2[0], c1[1] * c2[0] + c2[1]


def test_chunked_scan_matches_associative_scan():
    """``loma.linear_scan`` against the recurrence as the JAX package
    computes it (``lax.associative_scan``) at 2048 tokens, with decays
    from 1 (padded tokens) down to e⁻³⁰ a step and drives of both signs:
    within 1e-5 of the largest state; at 65 (one past a chunk) also
    against a sequential float64 loop."""
    rng = np.random.default_rng(12)
    scan = jax.jit(lambda d, v: jax.lax.associative_scan(combine, (d, v))[1])
    for n in (2048, 65):
        dt = rng.exponential(1.0, (n, 1)) * (rng.random((n, 1)) > 0.1)
        a = -np.exp(rng.normal(size=(1, 16)))
        log_decay = np.minimum(dt * a, 0).clip(-30).astype(np.float32)
        drive = rng.normal(size=(n, 16)).astype(np.float32)

        want = scan(jnp.exp(jnp.asarray(log_decay)), jnp.asarray(drive))
        got = tloma.linear_scan(torch.from_numpy(log_decay),
                                torch.from_numpy(drive))
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
        if n <= 65:
            h, ref = np.zeros(16), []
            for t in range(n):
                h = np.exp(log_decay[t].astype(np.float64)) * h + drive[t]
                ref.append(h)
            np.testing.assert_allclose(got.numpy(), np.array(ref),
                                       atol=1e-5 * np.abs(ref).max())


def test_selective_scan_matches_jax():
    """One scan layer of the JAX init (``a_log`` and the biases drawn, so
    the decays vary) over 1200 tokens with a padded tail: within 1e-4 of
    the largest output (a layer norm of the sum)."""
    rng = np.random.default_rng(13)
    layer = jax.tree_util.tree_map(
        np.asarray, jloma.init_ssm_layer(jax.random.PRNGKey(3), 256))
    layer["a_log"] = rng.normal(size=16).astype(np.float32)
    layer["dt_proj"]["b"] = rng.normal(size=1).astype(np.float32)
    x = rng.normal(size=(1200, 256)).astype(np.float32)
    mask = np.arange(1200) < 1100
    want = np.asarray(jax.jit(jloma.selective_scan)(
        jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x),
        jnp.asarray(mask)))
    got = tloma.selective_scan(weights.params_from_jax(layer),
                               torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_rdd_extractor_matches_jax():
    """The rdd extractor's apply on the JAX init tree at 128 × 160 with
    64 slots and a padded view: the same slots, keypoints within 1e-3 px,
    scores within 1e-5 and descriptors within 1e-4."""
    tree = jax.tree_util.tree_map(
        np.asarray, jrdd.init_params(jax.random.PRNGKey(0)))
    tp = weights.params_from_jax(tree)
    model = trdd.Rdd({"max_keypoints": 64}, device="cpu")
    assert model.meta["pretrained"] is False
    weights.assert_tree_matches(model.params, tp, "rdd")
    model.params = tp
    rng = np.random.default_rng(14)
    img = rng.random((2, 3, H, W)).astype(np.float32)
    vwh = np.array([[W, H], [W - 40, H - 17]])
    want = jrdd.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(img), jnp.asarray(vwh), max_keypoints=64)
    got = model({"image": img, "valid_wh": vwh})
    for b in range(2):
        mw, mg = np.asarray(want["mask"][b]), got["mask"][b].numpy()
        assert mg.sum() == mw.sum() > 20
        np.testing.assert_array_equal(mg, mw)
        # slots in score order, the same in both (distinct scores)
        c = got["keypoints"][b].numpy()[mg]
        assert np.abs(np.asarray(want["keypoints"][b])[mw] - c).max() <= 1e-3
        assert np.abs(np.asarray(want["scores"][b])[mw]
                      - got["scores"][b].numpy()[mg]).max() <= 1e-5
        assert np.abs(np.asarray(want["descriptors"][b])[:, mw]
                      - got["descriptors"][b].numpy()[:, mg]).max() <= 1e-4
        assert c[:, 0].max() < vwh[b, 0] and c[:, 1].max() < vwh[b, 1]
