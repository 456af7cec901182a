"""RoMa in the port (imcui_tpu_torch/models/matchers/roma.py) against the
JAX package on the CPU: the parameter tree, the GP coarse matcher, the
three forms of the local correlation, each refiner scale, ``match_gp`` in
float32 and bfloat16, ``sample`` and the ``Roma`` wrapper, at the JAX
tests' tiny configuration (DINOv2 "test", coarse_res 112²). Weights are
the JAX init tree with seeded biases and LayerScale gammas, converted with
``params_from_jax``; inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imcui_tpu.models import layers as jl
from imcui_tpu.models.backbones import dinov2 as jdino
from imcui_tpu.models.matchers import roma as jr
from imcui_tpu_torch.models import layers as tl
from imcui_tpu_torch.models.backbones import dinov2 as tdino
from imcui_tpu_torch.models.matchers import roma as tr
from imcui_tpu_torch.utils import weights

TINY = {"dinov2_variant": "test", "gp_dim": 512}
RES = 112


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread: RoMa's many small CPU ops wait at every
    parallel region's barrier under the suite's six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _chw(a):
    """numpy (H, W, C) → torch (C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(2, 0, 1)


def tiny_tree(seed=0):
    """The JAX init tree (numpy) with the zero biases, unit BN statistics
    and 1e-5 LayerScale gammas replaced by seeded values, so that no part
    of the network is switched off."""
    rng = np.random.default_rng(seed)
    tree = _np(jr.init_params(jax.random.PRNGKey(0), TINY))

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name == "gamma":
            return rng.uniform(0.5, 1.5, size=node.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=node.shape).astype(np.float32)
        if name in ("b", "bias", "mean"):
            return (rng.normal(size=node.shape) * 0.05).astype(np.float32)
        return node

    return walk(tree)


@pytest.fixture(scope="module")
def trees():
    """(numpy JAX-layout tree, jnp tree, torch tree)."""
    tree = tiny_tree()
    return tree, _jnp(tree), weights.params_from_jax(tree)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return (rng.uniform(size=(RES, RES, 3)).astype(np.float32),
            rng.uniform(size=(RES, RES, 3)).astype(np.float32))


# --------------------------------------------------------------------------
# the parameter tree
# --------------------------------------------------------------------------

def _torch_shape(path, shape):
    """The shape ``params_from_jax`` gives a JAX leaf."""
    if path.endswith(".w") and len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    if path.endswith(".w") and len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def test_full_width_tree_shapes_match_jax():
    """Every leaf of the published-width tree, without allocating either:
    ``jax.eval_shape`` on one side, the meta device on the other."""
    want = weights.flatten_tree(jax.eval_shape(
        lambda: jr.init_params(jax.random.PRNGKey(0), {})))
    want = {k: _torch_shape(k, v.shape) for k, v in want.items()}
    with torch.device("meta"):
        got = weights.flatten_tree(tr.init_params(torch.Generator()))
    got = {k: tuple(v.shape) for k, v in got.items()}
    assert got == want
    assert got["dinov2.patch_embed.proj.w"] == (1024, 3, 14, 14)
    assert got["dinov2.pos_embed"] == (1 + 37 * 37, 1024)
    assert got["conv_refiner.16.block1.0.w"] == (1377, 1, 5, 5)
    assert got["conv_refiner.1.block1.0.w"] == (24, 24, 5, 5)
    assert got["embedding_decoder.to_out.w"] == (64 * 64 + 1, 1024)
    assert sum(int(np.prod(s)) for s in got.values()) > 3e8


def test_tiny_tree_round_trips_and_keeps_its_levels(trees):
    tree, _, tp = trees
    weights.assert_tree_matches(
        tr.init_params(torch.Generator().manual_seed(0), TINY), tp, "roma")
    # odd leaves: depthwise kernels, the 1×1 pos_conv, cls token, BN dicts
    ref16 = tp["conv_refiner"]["16"]
    assert ref16["block1"]["0"]["w"].shape == (1377, 1, 5, 5)
    assert tp["gps"]["16"]["pos_conv"]["w"].shape == (512, 2, 1, 1)
    assert tp["dinov2"]["cls_token"].shape == (1, 64)
    assert set(ref16["block1"]["1"]) == {"scale", "bias", "mean", "var"}
    # Sequential keys 0/1/3 stay a dict, hidden_blocks becomes a list
    flat = weights.flatten_tree(tree)
    back = weights.tree_from_flat(flat)
    assert isinstance(back["conv_refiner"]["16"]["hidden_blocks"], list)
    assert isinstance(back["conv_refiner"]["16"]["block1"], dict)
    assert set(back["conv_refiner"]["16"]["block1"]) == {"0", "1", "3"}
    assert isinstance(back["proj"]["16"], list)   # keys "0", "1": a list
    again = weights.flatten_tree(weights.params_to_jax(tp))
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])


# --------------------------------------------------------------------------
# GP coarse matcher
# --------------------------------------------------------------------------

def test_gp_posterior_and_fourier_embed_match_jax(trees):
    """Cholesky solves of a 48 × 48 system in f32: atol 2e-4 on targets in
    [-1, 1]."""
    _, jp, tp = trees
    rng = np.random.default_rng(2)
    f0 = rng.normal(size=(40, 32)).astype(np.float32)
    f1 = rng.normal(size=(48, 32)).astype(np.float32)
    jemb = jr.fourier_embed(jr.coord_grid(6, 8), jp["gps"]["16"]["pos_conv"])
    temb = tr.fourier_embed(tr.coord_grid(6, 8), tp["gps"]["16"]["pos_conv"])
    np.testing.assert_allclose(tr.coord_grid(6, 8).numpy(),
                               np.asarray(jr.coord_grid(6, 8)), atol=1e-7)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=2e-4)
    np.testing.assert_allclose(
        tr.cos_kernel(torch.from_numpy(f0), torch.from_numpy(f1)).numpy(),
        np.asarray(jr.cos_kernel(jnp.asarray(f0), jnp.asarray(f1))),
        atol=1e-6)
    want = jr.gp_posterior(jnp.asarray(f0), jnp.asarray(f1), jemb)
    got = tr.gp_posterior(torch.from_numpy(f0), torch.from_numpy(f1),
                          torch.from_numpy(np.asarray(jemb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    # bf16 features and embedding: float32 out, as in the JAX function
    j16 = jr.gp_posterior(jnp.asarray(f0).astype(jnp.bfloat16),
                          jnp.asarray(f1).astype(jnp.bfloat16),
                          jemb.astype(jnp.bfloat16))
    t16 = tr.gp_posterior(torch.from_numpy(f0).bfloat16(),
                          torch.from_numpy(f1).bfloat16(),
                          torch.from_numpy(np.asarray(jemb)).bfloat16())
    assert j16.dtype == jnp.float32 and t16.dtype == torch.float32
    # the norms are rounded to bf16 in both, at different last bits
    assert np.abs(t16.numpy() - np.asarray(j16)).max() < 0.05


def test_identical_pair_gp_posterior_regresses_onto_itself(trees):
    """The property that holds without training: on identical views the GP
    posterior of the embedded grid is the embedded grid (max |error| <
    0.15, the JAX test's bound)."""
    _, _, tp = trees
    rng = np.random.default_rng(3)
    img = _chw(rng.uniform(size=(RES, RES, 3)).astype(np.float32))
    tokens, (hp, wp) = tdino.apply(tp["dinov2"], img, "test")
    emb = tr.fourier_embed(tr.coord_grid(hp, wp),
                           tp["gps"]["16"]["pos_conv"])
    post = tr.gp_posterior(tokens, tokens, emb)
    assert float((post - emb).abs().max()) < 0.15


def test_cls_to_flow_refine_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(30, 64 * 64)).astype(np.float32) * 3
    logits[0, 0] += 50          # modes on the borders of the anchor grid
    logits[1, 64 * 64 - 1] += 50
    logits[2, 63] += 50
    want = np.asarray(jr.cls_to_flow_refine(jnp.asarray(logits)))
    got = tr.cls_to_flow_refine(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# --------------------------------------------------------------------------
# local correlation and the refiners
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 7])
def test_local_correlation_forms_agree_and_match_jax(r):
    """The all-pairs form, the integer-tap form and the gather reference
    are the same function (atol 2e-5), here and against JAX; the warp
    leaves the map on two sides, so taps fall outside."""
    rng = np.random.default_rng(r)
    h, w, d = 9, 11, 16
    f0 = rng.normal(size=(h, w, d)).astype(np.float32)
    f1 = rng.normal(size=(h, w, d)).astype(np.float32)
    warp = rng.uniform(-1.3, 1.3, size=(h, w, 2)).astype(np.float32)
    want = np.asarray(jr._local_correlation_gather(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(warp), r))
    assert want.shape == (h, w, (2 * r + 1) ** 2)
    t0, t1, tw = _chw(f0), _chw(f1), torch.from_numpy(warp)
    for fn in (tr._local_correlation_mxu, tr._local_correlation_int_taps,
               tr._local_correlation_gather, tr.local_correlation):
        got = fn(t0, t1, tw, r)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    for jfn in (jr._local_correlation_mxu, jr._local_correlation_int_taps):
        np.testing.assert_allclose(
            np.asarray(jfn(jnp.asarray(f0), jnp.asarray(f1),
                           jnp.asarray(warp), r)), want, atol=2e-5)


def test_local_correlation_picks_the_form_by_grid_size(monkeypatch):
    calls = []
    monkeypatch.setattr(tr, "_local_correlation_mxu",
                        lambda *a: calls.append("all pairs"))
    monkeypatch.setattr(tr, "_local_correlation_int_taps",
                        lambda *a: calls.append("integer taps"))
    tr.local_correlation(torch.zeros(4, 80, 80), None, None, 2)
    tr.local_correlation(torch.zeros(4, 80, 81), None, None, 2)
    assert calls == ["all pairs", "integer taps"]


SCALE_GRIDS = {"16": (6, 8), "8": (8, 6), "4": (10, 12), "2": (12, 10),
               "1": (16, 12)}


@pytest.mark.parametrize("scale", ["16", "8", "4", "2", "1"])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_refiner_apply_matches_jax(trees, scale, precision):
    """One refiner step per scale at its published widths on a small grid.
    f32: atol 2e-5 on warps in [-1, 1] and 2e-4 on certainty logits. bf16
    (nine bf16 blocks, rounded at different places in the two frameworks,
    whose bf16 output is of order 10 with these weights): 2⁻⁵ of the
    largest predicted change, four bf16 steps at that size; each
    package's bf16 run sits as far from its own f32 run (measured 2⁻⁶ to
    2⁻⁵). The JAX stride-1 refiner runs folded and unfolded; the port has
    one form."""
    _, jp, tp = trees
    cfg = jr.REFINERS[scale]
    assert tr.REFINERS[scale] == cfg
    h, w = SCALE_GRIDS[scale]
    rng = np.random.default_rng(int(scale))
    f0 = rng.normal(size=(h, w, cfg["feat"])).astype(np.float32)
    f1 = rng.normal(size=(h, w, cfg["feat"])).astype(np.float32)
    warp = rng.uniform(-1.1, 1.1, size=(h, w, 2)).astype(np.float32)
    cert = rng.normal(size=(h, w)).astype(np.float32)
    jpp = jl.apply_precision(jp["conv_refiner"][scale], precision)
    tpp = tl.apply_precision(tp["conv_refiner"][scale], precision)
    jf0, jf1 = jnp.asarray(f0), jnp.asarray(f1)
    tf0, tf1 = _chw(f0), _chw(f1)
    if precision:
        jf0, jf1 = jf0.astype(jnp.bfloat16), jf1.astype(jnp.bfloat16)
        tf0, tf1 = tf0.bfloat16(), tf1.bfloat16()
    got_w, got_c = tr.refiner_apply(tpp, cfg, tf0, tf1,
                                    torch.from_numpy(warp),
                                    torch.from_numpy(cert))
    assert got_w.dtype == got_c.dtype == torch.float32
    for fold in ((True, False) if scale == "1" else (True,)):
        want_w, want_c = jr.refiner_apply(
            jpp, cfg, jf0, jf1, jnp.asarray(warp), jnp.asarray(cert),
            fold=fold)
        assert want_w.dtype == want_c.dtype == jnp.float32
        tol_w, tol_c = (2e-5, 2e-4) if precision is None else (
            2.0 ** -5 * np.abs(np.asarray(want_w) - warp).max(),
            2.0 ** -5 * np.abs(np.asarray(want_c) - cert).max())
        assert np.abs(got_w.numpy() - np.asarray(want_w)).max() <= tol_w
        assert np.abs(got_c.numpy() - np.asarray(want_c)).max() <= tol_c
    assert np.abs(got_w.numpy() - warp).max() > 10 * tol_w  # it did move


# --------------------------------------------------------------------------
# the whole match
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def matched(trees, images):
    """{precision: (JAX warp, JAX certainty, port warp, port certainty)}."""
    _, jp, tp = trees
    out = {}
    for precision in (None, "bf16"):
        jpp = jl.apply_precision(jp, precision)
        tpp = tl.apply_precision(tp, precision)
        j0, j1 = (jnp.asarray(a) for a in images)
        t0, t1 = (_chw(a) for a in images)
        if precision:
            j0, j1 = j0.astype(jnp.bfloat16), j1.astype(jnp.bfloat16)
            t0, t1 = t0.bfloat16(), t1.bfloat16()
        jw, jc = jax.jit(lambda p, a, b: jr.match_gp(p, a, b, TINY))(
            jpp, j0, j1)
        with torch.no_grad():
            tw, tc = tr.match_gp(tpp, t0, t1, TINY)
        out[precision] = (jw, jc, tw, tc)
    return out


def test_match_gp_f32_matches_jax(matched):
    """Warp atol 5e-4 in normalised units (0.14 px at 560; measured
    1.4e-4 after six f32 stages whose outputs reach tens), certainty
    atol 1e-3 (the sigmoid of logits that reach tens and differ by
    1e-3)."""
    jw, jc, tw, tc = matched[None]
    assert tw.shape == (RES, RES, 2) and tc.shape == (RES, RES)
    assert tw.dtype == tc.dtype == torch.float32
    assert np.abs(tw.numpy() - np.asarray(jw)).max() <= 5e-4
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-3
    assert float(tc.min()) >= 0.0 and float(tc.max()) <= 1.0


def test_match_gp_bf16_matches_jax_within_its_own_noise(matched):
    """bf16 rounds at other places in the two frameworks (XLA on the CPU
    keeps excess precision inside fused chains), and the random decoder
    turns a last-bit difference of the GP embedding into another anchor,
    so single cells differ by whole anchors (max |Δwarp| 0.44 here).
    Measured on this pair: port against JAX, median |Δwarp| 0.042, while
    each package's bf16 run sits about 0.06 (median) from its own f32
    run. The bounds: median ≤ 0.1 against JAX, and the port's bf16-to-f32
    distance no more than 1.5 times JAX's."""
    jw, jc, tw, tc = matched["bf16"]
    assert jw.dtype == jc.dtype == jnp.float32
    assert tw.dtype == tc.dtype == torch.float32
    diff = np.abs(tw.numpy() - np.asarray(jw))
    assert np.median(diff) <= 0.1
    # most certainties saturate; the few on the sigmoid's slope differ
    assert np.abs(tc.numpy() - np.asarray(jc)).mean() <= 0.01
    own = np.median(np.abs(tw.numpy() - matched[None][2].numpy()))
    theirs = np.median(np.abs(np.asarray(jw) - np.asarray(matched[None][0])))
    assert own <= 1.5 * theirs


def test_bf16_stage_dtypes_match_jax(trees, images):
    """Under a bf16 tree the program is not bf16 throughout; each stage's
    output has the dtype the JAX stage has."""
    _, jp, tp = trees
    jpp, tpp = jl.apply_precision(jp, "bf16"), tl.apply_precision(tp, "bf16")
    jimg = jnp.asarray(images[0]).astype(jnp.bfloat16)
    timg = _chw(images[0]).bfloat16()

    def same(j, t):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), (j.dtype,
                                                                    t.dtype)

    jd, (hp, wp) = jdino.apply(jpp["dinov2"], jimg, "test")
    td, tvgg_feats = tr.encode(tpp, timg, TINY)[::2]
    same(jd, td)                                         # bf16 tokens
    from imcui_tpu.models.backbones import vgg as jvgg
    jv = jvgg.apply(jpp["encoder_cnn"], jimg)
    for s in jv:
        same(jv[s], tvgg_feats[s])
    jproj = jl.batch_norm_inference(
        jpp["proj"]["16"]["1"],
        jl.conv2d(jpp["proj"]["16"]["0"], jd.reshape(hp, wp, -1)[None]))[0]
    tproj = tr._project(tpp, "16", td.t().reshape(-1, hp, wp))
    same(jproj, tproj)                                   # bf16 features
    jemb = jr.fourier_embed(jr.coord_grid(hp, wp),
                            jpp["gps"]["16"]["pos_conv"])
    temb = tr.fourier_embed(tr.coord_grid(hp, wp),
                            tpp["gps"]["16"]["pos_conv"])
    same(jemb, temb)                                     # bf16 embedding
    jf = jproj.reshape(hp * wp, -1)
    tf = tproj.reshape(-1, hp * wp).t()
    same(jr.cos_kernel(jf, jf), tr.cos_kernel(tf, tf))   # f32 kernel
    jgp, tgp = jr.gp_posterior(jf, jf, jemb), tr.gp_posterior(tf, tf, temb)
    same(jgp, tgp)                                       # f32 posterior
    assert jnp.concatenate([jgp, jf], -1).dtype == jnp.float32
    with torch.no_grad():
        warp, cert = tr.coarse_match(tpp, tproj, tproj)
    assert warp.dtype == cert.dtype == torch.float32     # f32 decoder
    jcorr = jr.local_correlation(jproj, jproj, jnp.asarray(warp.numpy()), 2)
    same(jcorr, tr.local_correlation(tproj, tproj, warp, 2))
    same(jr.bilinear_warp(jproj, jnp.asarray(warp.numpy())),
         tr.bilinear_warp(tproj, warp))                  # f32 samples


def test_sample_matches_jax_exact_top_k(matched):
    """The JAX side at recall_target 1.0 (its exact top-k); compared as
    sets of rows ordered by score, never by slot. The certainty is drawn
    without ties (the random network's saturates at 1)."""
    _, _, tw, tc = matched[None]
    rng = np.random.default_rng(6)
    warp = rng.uniform(-1, 1, size=(40, 48, 2)).astype(np.float32)
    cert = rng.permutation(40 * 48).reshape(40, 48).astype(np.float32) / 2e3
    want = [np.asarray(a) for a in jr.sample(
        jnp.asarray(warp), jnp.asarray(cert), 96, 128, num=200,
        recall_target=1.0)]
    got = [a.numpy() for a in tr.sample(torch.from_numpy(warp),
                                        torch.from_numpy(cert), 96, 128,
                                        num=200)]
    assert got[0].shape == (200, 2) and got[3].dtype == np.bool_

    def rows(k0, k1, score, valid):
        r = np.concatenate([k0, k1, score[:, None]], 1)[valid]
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(rows(*got), rows(*want), atol=1e-4)
    assert np.all(got[0][:, 0] <= 127.0 + 1e-3)
    assert np.all(got[0][:, 1] <= 95.0 + 1e-3)
    # a threshold zeroes the rows at or below it, and num above the grid
    # size returns the whole grid
    thr = float(np.median(got[2]))
    k0, _, score, valid = tr.sample(torch.from_numpy(warp),
                                    torch.from_numpy(cert), 96, 128, num=200,
                                    threshold=thr)
    assert not bool(valid.all()) and float(score[~valid].abs().max()) == 0.0
    assert float(k0[~valid].abs().max()) == 0.0
    assert tr.sample(tw[:4, :4], tc[:4, :4], 8, 8, num=99)[0].shape == (16, 2)
    np.testing.assert_allclose(
        tr.to_pixel_coordinates(torch.tensor([[-1.0, 1.0]]), 96, 128).numpy(),
        np.asarray(jr.to_pixel_coordinates(jnp.asarray([[-1.0, 1.0]]),
                                           96, 128)))


WRAPPER_CONF = {"backbone": "dinov2-gp", "dinov2_variant": "test",
                "gp_dim": 512, "coarse_res": (112, 112), "max_keypoints": 64,
                "model_name": "roma_outdoor.pth"}


def test_roma_refuses_what_is_not_ported():
    """precision "int8" is served now (W8A8, tests/test_torch_port_int8*):
    the wrapper quantises the decoder's linears and casts the rest to
    bf16. Without a card the default device still raises."""
    m = tr.Roma({**WRAPPER_CONF, "precision": "int8"}, device="cpu")
    head = m.params["embedding_decoder"]["to_out"]
    assert set(head) == {"w_q", "w_s", "b"} and head["w_q"].dtype == \
        torch.int8
    assert m.params["proj"]["16"]["0"]["w"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tr.Roma(WRAPPER_CONF)           # device defaults to "cuda"
