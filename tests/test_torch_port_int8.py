"""W8A8 (``precision="int8"``) in the port against the JAX package on the
CPU: the weight quantisers, ``apply_precision``'s choice of dicts, the
int8 linear and convolution, DUSt3R and MASt3R end to end, and the
thresholds at which a quantised dict meets a function that reads ``w``.
RoMa and DKM are in ``test_torch_port_int8_dense.py``.

Exactness. The weights (``w_q``, ``w_s``) are equal bit for bit. The
int8 sums are exact in both packages, and the port's plain versions
(``ops/w8a8.py``, which the kernels equal bit for bit) follow the JAX
source's order: ``sx = max(max|x|, 1e-12) / 127``, ``(f32(acc) * sx) *
w_s + b`` (linear), ``f32(acc) * (sx * w_s) + b`` (convolution). XLA's
CPU compiler changes two last bits of that: it divides by 127 as a
product with float32(1/127), and it contracts the epilogue's product and
bias into one fused multiply-add. Each layer test holds the port to a
restatement of the JAX source exactly, the JAX package to the same
restatement with XLA's two rewrites exactly, and so the port to the JAX
package within what the rewrites move: 2⁻²¹·(|want| + |b|) in float32
(a scale one ulp off and one rounding fewer), one bf16 step
(2⁻⁷·|want|, same bias term) where the output is bf16. A quantised
activation could in principle flip at a tie (x / sx = k + 0.5 under one
scale and not the other); no flip occurs on these inputs.

Models. Where the int8 layers are exact given equal inputs, the models'
other layers run in bf16 and round at other places in the two
frameworks, and a re-quantisation turns a last-bit difference of its
input into a whole quantisation step (1/127 of the row's largest value)
where it crosses a rounding edge. So the models are held as their bf16
precedents are (``test_torch_port_pointmap.py``): DUSt3R's pointmaps and
MASt3R's descriptors by the median difference relative to the largest
value, at most 2e-2 (the bf16 precedent's bound), matches compared as
sets by IoU (≥ 0.75). Every model test asserts that its tree holds quantised
dicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from imcui_tpu.models import layers as jl
from imcui_tpu.models.backbones import dpt as jdpt
from imcui_tpu.models.matchers import duster as jduster
from imcui_tpu.models.matchers import mast3r as jmast3r
from imcui_tpu_torch.models import layers as tl
from imcui_tpu_torch.models.matchers import duster as tduster
from imcui_tpu_torch.models.matchers import mast3r as tmast3r
from imcui_tpu_torch.ops import w8a8
from imcui_tpu_torch.utils import weights

R127 = np.float32(1.0 / 127.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread (the tier-1 run's six workers share eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _offline():
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, weights.params_to_jax(tree))


def _to_port(name, a):
    """A JAX-layout leaf in the port's layout (``params_from_jax``'s rule,
    also for ``w_q``)."""
    a = np.asarray(a)
    if name in ("w", "w_q") and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if name in ("w", "w_q") and a.ndim == 2:
        return a.T
    return a


# --------------------------------------------------------------------------
# restatements of the JAX source's arithmetic, with and without XLA's CPU
# rewrites
# --------------------------------------------------------------------------

def _scale(m, xla):
    m = np.maximum(m, np.float32(1e-12))
    return m * R127 if xla else m / np.float32(127.0)


def _epilogue(t, s, b, xla):
    """t * s, then + b: one fused multiply-add under XLA's CPU rewrite (the
    product of two float32 values is exact in float64)."""
    if b is None:
        return t * s
    if xla:
        return (t.astype(np.float64) * s.astype(np.float64)
                + b.astype(np.float64)).astype(np.float32)
    return t * s + b


def restate_linear(x, w_q, w_s, b, xla):
    """x (..., K) float32 values; w_q (K, N) int8 (JAX layout)."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float32)
    sx = _scale(np.abs(xf).max(-1, keepdims=True), xla)
    xq = np.clip(np.round(xf / sx), -127, 127)
    acc = (xq.astype(np.float64) @ w_q.astype(np.float64)).astype(np.float32)
    return _epilogue(acc * sx, w_s, b, xla).reshape(*x.shape[:-1], -1)


def restate_conv(x, w_q, w_s, b, stride, padding, dilation, groups, xla):
    """x (B, H, W, C) float32 values; w_q HWIO int8; padding as the port
    takes it. Returns NHWC."""
    xf = x.astype(np.float32)
    sx = _scale(np.abs(xf).max(), xla)
    xq = np.clip(np.round(xf / sx), -127, 127)
    (pt, pb), (pl, pr) = padding
    acc = F.conv2d(
        F.pad(torch.from_numpy(xq.transpose(0, 3, 1, 2).astype(np.float64)),
              (pl, pr, pt, pb)),
        torch.from_numpy(w_q.transpose(3, 2, 0, 1).astype(np.float64)),
        stride=stride, dilation=dilation, groups=groups)
    acc = acc.numpy().transpose(0, 2, 3, 1).astype(np.float32)
    return _epilogue(acc, sx * w_s, b, xla)


def _rounded(a, dtype):
    return _f32(torch.from_numpy(np.ascontiguousarray(a)).to(dtype))


def _within_rewrites(got, want, b, dtype):
    bias = 0.0 if b is None else np.abs(b)
    step = 2.0 ** -21 if dtype == torch.float32 else 2.0 ** -7
    assert np.all(np.abs(got - want) <= step * (np.abs(want) + bias))


# --------------------------------------------------------------------------
# the quantisers and apply_precision
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 300), (300, 257), (33, 5)])
def test_quantize_linear_int8_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    p = {"w": rng.normal(size=shape).astype(np.float32),
         "b": rng.normal(size=shape[1]).astype(np.float32)}
    p["w"][:, 1] = 0.0               # an all-zero channel: the 1e-12 floor
    p["w"][3, 2] = 2.5 * np.abs(p["w"][:, 2]).max()   # a round-half case
    want = jl.quantize_linear_int8(jax.tree_util.tree_map(jnp.asarray, p))
    got = tl.quantize_linear_int8(weights.params_from_jax(p))
    assert set(got) == set(want) == {"w_q", "w_s", "b"}
    assert got["w_q"].dtype == torch.int8 and got["w_s"].dtype == \
        torch.float32 and got["b"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(),
                                  _to_port("w_q", want["w_q"]))
    np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(want["w_s"]))
    np.testing.assert_array_equal(got["b"].numpy(), p["b"])
    assert got["w_s"][1] == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 64, 9),
                                   (5, 5, 24, 24), (16, 16, 3, 32)])
def test_quantize_conv_int8_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    p = {"w": rng.normal(size=shape).astype(np.float32)}
    want = jl.quantize_conv_int8(jax.tree_util.tree_map(jnp.asarray, p))
    got = tl.quantize_conv_int8(weights.params_from_jax(p))
    assert set(got) == set(want) == {"w_q", "w_s"}
    np.testing.assert_array_equal(got["w_q"].numpy(),
                                  _to_port("w_q", want["w_q"]))
    np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(want["w_s"]))


def _mixed_tree(gen):
    """Linears, convolutions (dense, depthwise, a transposed convolution's
    (cin, cout, k, k)), norms, a dict with a third key, a list and an
    integer leaf, in the port's layout."""
    def t(*shape):
        return torch.randn(shape, generator=gen)

    return {
        "lin_wide": {"w": t(300, 260), "b": t(300)},
        "lin_narrow": {"w": t(300, 100)},
        "ln": {"scale": t(64), "bias": t(64)},
        "conv": {"w": t(64, 32, 3, 3), "b": t(64)},
        "conv_wide": {"w": t(128, 128, 1, 1)},
        "dw": {"w": t(48, 1, 5, 5), "b": t(48)},
        "convT": {"w": t(96, 96, 2, 2), "b": t(96)},
        "three_keys": {"w": t(300, 300), "b": t(300), "gamma": t(300)},
        "blocks": [{"w": t(256, 256)}, {"gamma": t(8)}],
        "count": torch.arange(3),
    }


@pytest.mark.parametrize("min_dim", [100, 256, 261])
@pytest.mark.parametrize("conv_min_ch", [None, 1, 32, 97, 128])
def test_apply_precision_int8_quantises_the_same_dicts(min_dim, conv_min_ch):
    """The same dicts quantised, their w_q, w_s and bias equal bit for bit,
    w_s and the bias float32, every other floating leaf bf16, integers
    kept."""
    tree = _mixed_tree(torch.Generator().manual_seed(min_dim))
    got = weights.flatten_tree(tl.apply_precision(
        tree, "int8", min_dim=min_dim, conv_min_ch=conv_min_ch))
    want = weights.flatten_tree(jl.apply_precision(
        _jtree(tree), "int8", min_dim=min_dim, conv_min_ch=conv_min_ch))
    assert set(got) == set(want)
    quantised = {k.rsplit(".", 1)[0] for k in got if k.endswith(".w_q")}
    expect = {"lin_wide"} if min_dim <= 260 else set()
    expect |= {"blocks.0"} if min_dim <= 256 else set()
    expect |= {"lin_narrow"} if min_dim <= 100 else set()
    if conv_min_ch is not None:
        expect |= {name for name, ch in (("conv", 32), ("conv_wide", 128),
                                         ("dw", 1), ("convT", 96))
                   if ch >= conv_min_ch}
    assert quantised == expect
    for k, v in got.items():
        name = k.rsplit(".", 1)[-1]
        if not v.is_floating_point():   # int8 w_q, and the integer leaf
            np.testing.assert_array_equal(v.numpy(),
                                          _to_port(name, want[k]))
            assert (v.dtype == torch.int8) == (name == "w_q")
            continue
        keep = k.rsplit(".", 1)[0] in quantised   # w_s and the bias
        assert v.dtype == (torch.float32 if keep else torch.bfloat16), k
        assert want[k].dtype == (jnp.float32 if keep else jnp.bfloat16), k
        np.testing.assert_array_equal(_f32(v), _to_port(name, _f32(want[k])))


# --------------------------------------------------------------------------
# the int8 linear and convolution
# --------------------------------------------------------------------------

LINEAR_CASES = [(40, 300, "float32", True), (300, 257, "bfloat16", True),
                (33, 5, "float32", False), (64, 256, "bfloat16", False),
                (1000, 130, "float32", True)]


@pytest.mark.parametrize("din,dout,dtype,bias", LINEAR_CASES)
def test_linear_int8_matches_jax(din, dout, dtype, bias):
    """K not a multiple of 32 (40, 300, 33, 1000), f32 and bf16 tokens,
    leading axes, with and without bias; an all-zero row (the 1e-12
    floor)."""
    rng = np.random.default_rng(din + dout)
    p = {"w": rng.normal(size=(din, dout)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=dout).astype(np.float32)
    x = (rng.normal(size=(2, 7, din)) * 3).astype(np.float32)
    x[1, 3] = 0.0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xv = _rounded(x, tdt)   # the values both see
    jq = jl.quantize_linear_int8(jax.tree_util.tree_map(jnp.asarray, p))
    tq = tl.quantize_linear_int8(weights.params_from_jax(p))
    got = tl.linear(tq, torch.from_numpy(x).to(tdt))
    want = jax.jit(jl.linear)(jq, jnp.asarray(x).astype(jdt))
    assert got.dtype == tdt and want.dtype == jdt
    assert got.shape == (2, 7, dout)
    args = (xv, np.asarray(jq["w_q"]), np.asarray(jq["w_s"]), p.get("b"))
    np.testing.assert_array_equal(
        _f32(got), _rounded(restate_linear(*args, xla=False), tdt))
    np.testing.assert_array_equal(
        _f32(want), _rounded(restate_linear(*args, xla=True), tdt))
    _within_rewrites(_f32(got), _f32(want), p.get("b"), tdt)


CONV_CASES = [
    # cin, cout, k, stride, dilation, padding, groups, dtype, bias
    (8, 16, 3, 1, 1, "SAME", 1, "float32", True),
    (6, 10, 3, 2, 1, "SAME", 2, "bfloat16", True),
    (5, 7, 3, 1, 2, ((1, 2), (0, 3)), 1, "float32", True),
    (16, 32, 1, 1, 1, "VALID", 1, "bfloat16", False),
    (3, 24, 4, 4, 1, "VALID", 1, "float32", True),
    (24, 40, 5, 1, 1, "SAME", 1, "float32", False),
    (12, 12, 3, 2, 2, ((2, 1), (1, 2)), 3, "bfloat16", True),
]


@pytest.mark.parametrize("cin,cout,k,stride,dil,pad,groups,dtype,bias",
                         CONV_CASES)
def test_conv2d_int8_matches_jax(cin, cout, k, stride, dil, pad, groups,
                                 dtype, bias):
    """Stride 2, dilation 2, groups 2 and 3, SAME and explicit padding,
    f32 and bf16, on a 13 x 11 map."""
    rng = np.random.default_rng(cin * cout + k)
    p = {"w": rng.normal(size=(k, k, cin // groups, cout)).astype(
        np.float32)}
    if bias:
        p["b"] = rng.normal(size=cout).astype(np.float32)
    x = (rng.normal(size=(1, 13, 11, cin)) * 2).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xv = _rounded(x, tdt)
    jq = jl.quantize_conv_int8(jax.tree_util.tree_map(jnp.asarray, p))
    tq = tl.quantize_conv_int8(weights.params_from_jax(p))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt)
    got = tl.conv2d(tq, tx, stride=stride, padding=pad, dilation=dil,
                    groups=groups)
    want = jax.jit(lambda q, a: jl.conv2d(q, a, stride=stride, padding=pad,
                                          dilation=dil, groups=groups))(
        jq, jnp.asarray(x).astype(jdt))
    assert got.dtype == tdt and want.dtype == jdt
    got = _f32(got).transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    explicit = tl._explicit_padding(pad, k, k, dil)
    args = (xv, np.asarray(jq["w_q"]), np.asarray(jq["w_s"]), p.get("b"),
            stride, explicit, dil, groups)
    np.testing.assert_array_equal(
        got, _rounded(restate_conv(*args, xla=False), tdt))
    np.testing.assert_array_equal(
        _f32(want), _rounded(restate_conv(*args, xla=True), tdt))
    _within_rewrites(got, _f32(want), p.get("b"), tdt)


def test_conv2d_int8_scale_per_call_and_per_pair_under_vmap_pairs():
    """One call takes one activation scale over everything it sees (both
    packages); under the JAX package's ``vmap_pairs`` each pair gets its
    own, which the port's per-pair loop gives. The two images differ in
    scale by 100: under a shared scale the small one's int8 result is
    far from its float convolution, under its own it is near."""
    rng = np.random.default_rng(5)
    p = {"w": rng.normal(size=(3, 3, 16, 32)).astype(np.float32),
         "b": rng.normal(size=32).astype(np.float32)}
    x = rng.normal(size=(2, 9, 10, 16)).astype(np.float32)
    x[1] *= 0.01
    jq = jl.quantize_conv_int8(jax.tree_util.tree_map(jnp.asarray, p))
    tq = tl.quantize_conv_int8(weights.params_from_jax(p))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    per_pair = jl.vmap_pairs(lambda a: jl.conv2d(jq, a[None])[0])(
        jnp.asarray(x))
    got_pairs = torch.cat([tl.conv2d(tq, t[None]) for t in tx])
    batch = jax.jit(jl.conv2d)(jq, jnp.asarray(x))
    got_batch = tl.conv2d(tq, tx)
    b = p["b"]
    _within_rewrites(_f32(got_pairs).transpose(0, 2, 3, 1),
                     np.asarray(per_pair), b, torch.float32)
    _within_rewrites(_f32(got_batch).transpose(0, 2, 3, 1),
                     np.asarray(batch), b, torch.float32)
    exact = np.asarray(jax.jit(jl.conv2d)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))[1]
    err_pair = np.abs(np.asarray(per_pair)[1] - exact).max()
    err_batch = np.abs(np.asarray(batch)[1] - exact).max()
    assert err_batch > 10 * err_pair


def test_w8a8_plain_versions_refuse_what_they_do_not_take():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        w8a8.linear_int8(x, torch.zeros(4, 7, dtype=torch.int8),
                         torch.ones(4))
    with pytest.raises(ValueError):
        w8a8.linear_int8(x.double(), torch.zeros(4, 8, dtype=torch.int8),
                         torch.ones(4))
    with pytest.raises(ValueError):
        w8a8.conv2d_int8(torch.zeros(1, 6, 4, 4),
                         torch.zeros(4, 4, 3, 3, dtype=torch.int8),
                         torch.ones(4), None, 1, ((1, 1), (1, 1)), 1, 1)
    with pytest.raises(ValueError, match="padding"):
        tl.conv2d({"w": torch.zeros(2, 2, 3, 3)}, torch.zeros(1, 2, 4, 4),
                  padding="FULL")


# --------------------------------------------------------------------------
# DUSt3R and MASt3R
# --------------------------------------------------------------------------

# small depth, 256 wide (every projection and MLP reaches min_dim 256)
SMALL = {"enc_dim": 256, "enc_depth": 1, "enc_heads": 4,
         "dec_dim": 256, "dec_depth": 2, "dec_heads": 4,
         "patch": 16, "max_matches": 64, "subsample": 8,
         "pos_embed": "RoPE100", "head_type": "linear"}
MODULES = {"duster": (jduster, tduster, "Duster"),
           "mast3r": (jmast3r, tmast3r, "Mast3r")}


def _models(name, conf):
    """Both packages' BaseModels on the port's seed-0 float32 tree, each
    quantising it by its own ``apply_precision``."""
    jmod, tmod, cls = MODULES[name]
    tm = getattr(tmod, cls)(conf, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "load_params",
                   lambda *a, **k: (None, {"pretrained": False}))
        jm = getattr(jmod, cls)(conf)
    f32 = getattr(tmod, cls)({**conf, "precision": None}, device="cpu")
    jm.params = jl.apply_precision(
        _jtree(f32.params), conf.get("precision"),
        conv_min_ch=conf.get("int8_conv_min_ch"))
    return jm, tm


def _pair(seed=3, h=64, w=96):
    rng = np.random.default_rng(seed)
    return {"image0": rng.random((1, 3, h, w), np.float32),
            "image1": rng.random((1, 3, h, w), np.float32)}


def _maps(name, params, conf, pkg, x0, x1):
    """View 1's dense maps: DUSt3R's pointmap and confidence, MASt3R's
    descriptors and their confidence."""
    mod = {"duster": (jduster, tduster), "mast3r": (jmast3r, tmast3r)}[name]
    m = mod[0] if pkg == "jax" else mod[1]
    d = jduster if pkg == "jax" else tduster
    t0, grid = d.encode(params, x0, conf)
    t1, _ = d.encode(params, x1, conf)
    h0, h1 = d.decode(params, t0, t1, grid, conf)
    head = params["downstream_head2"]
    if name == "mast3r":
        return m.desc_head_apply(head["head_local_features"], h1[0], h1[-1],
                                 grid, conf["patch"], conf["desc_dim"])
    return d.head_to_pointmap(head, h1, grid, conf["patch"])


@pytest.mark.parametrize("name,conv_min_ch", [("duster", None),
                                              ("duster", 3),
                                              ("mast3r", None)])
def test_pointmap_model_int8_matches_jax(name, conv_min_ch):
    """The BaseModels end to end (matches as sets, IoU ≥ 0.75; measured
    0.84, 0.88 and 0.94: the random trees' mutual nearest neighbours of
    near-equal points flip) and view 1's maps (median difference ≤ 2e-2
    of the largest, the bf16 precedent; measured 4e-4 to 4e-3);
    ``int8_conv_min_ch`` 3 also quantises the 16 x 16 patch embedding."""
    conf = {**SMALL, "precision": "int8", "int8_conv_min_ch": conv_min_ch}
    if name == "mast3r":
        conf["desc_dim"] = tmast3r.DESC_DIM
    jm, tm = _models(name, conf)
    flat = weights.flatten_tree(tm.params)
    quantised = {k for k in flat if k.endswith(".w_q")}
    assert "enc_blocks.0.mlp.fc1.w_q" in quantised
    assert ("patch_embed.proj.w_q" in quantised) == (conv_min_ch == 3)
    assert flat["enc_norm.scale"].dtype == torch.bfloat16
    data = _pair()
    got, want = tm(data), jm(data)
    tmk, jmk = got["mask"][0].numpy(), np.asarray(want["mask"][0])
    pt = np.concatenate([got["keypoints0"][0].numpy()[tmk],
                         got["keypoints1"][0].numpy()[tmk]], 1)
    pj = np.concatenate([np.asarray(want["keypoints0"][0])[jmk],
                         np.asarray(want["keypoints1"][0])[jmk]], 1)
    assert len(pt) >= 16 and len(pj) >= 16
    assert chip_smoke.common_points(pt, pj, 1e-3)[0] >= 0.75
    x = [d[0] for d in (data["image0"], data["image1"])]
    tx = [tm._prepare(a[None])[0] for a in x]
    jx = [jnp.asarray(((a - 0.5) / 0.5).transpose(1, 2, 0)).astype(
        jnp.bfloat16) for a in x]
    with torch.no_grad():
        tmaps = _maps(name, tm.params, tm.conf, "port", *tx)
    jmaps = jax.jit(lambda p, a, b: _maps(name, p, jm.conf, "jax", a, b))(
        jm.params, *jx)
    for t, j in zip(tmaps, jmaps):
        t, j = _f32(t), _f32(j)
        assert np.isfinite(t).all()
        assert np.median(np.abs(t - j)) <= 2e-2 * np.abs(j).max()


def test_int8_differs_from_bf16_and_keeps_bf16_elsewhere():
    """Quantisation changes the result (the layers did not fall back to
    bf16); the tokens between the quantised layers are bf16."""
    conf = {**SMALL, "precision": "int8"}
    tm8 = tduster.Duster(conf, device="cpu")
    tm16 = tduster.Duster({**conf, "precision": "bf16"}, device="cpu")
    x = [tm8._prepare(a)[0] for a in _pair().values()]
    assert x[0].dtype == torch.bfloat16
    with torch.no_grad():
        t8, _ = tduster.encode(tm8.params, x[0], tm8.conf)
        t16, _ = tduster.encode(tm16.params, x[0], tm16.conf)
    assert t8.dtype == t16.dtype == torch.bfloat16
    diff = (t8.float() - t16.float()).abs()
    assert float(diff.max()) > 1e-3 * float(t16.float().abs().max())


# --------------------------------------------------------------------------
# thresholds that quantise a dict read as "w" (ROADMAP §C)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("conv_min_ch", [96, 192])
def test_dpt_transposed_convolution_at_a_low_threshold_raises_in_both(
        conv_min_ch):
    """At int8_conv_min_ch <= 192 the DPT's transposed convolutions
    ((cin, cout, k, k) 96 and 192 wide) are quantised as convolutions;
    ``conv_transpose_s`` reads ``w`` and raises KeyError in both packages.
    At 193 and above the head serves."""
    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((192, 192, 2, 2), generator=gen),
         "b": torch.randn(192, generator=gen)}
    tq = tl.apply_precision({"t": p}, "int8", conv_min_ch=conv_min_ch)["t"]
    jq = jl.apply_precision({"t": _jtree(p)}, "int8",
                            conv_min_ch=conv_min_ch)["t"]
    assert "w_q" in tq and "w_q" in jq
    with pytest.raises(KeyError, match="'w'"):
        from imcui_tpu_torch.models.backbones import dpt as tdpt
        tdpt.conv_transpose_s(tq, torch.zeros(192, 2, 3))
    with pytest.raises(KeyError, match="'w'"):
        jdpt.conv_transpose_s(jq, jnp.zeros((2, 3, 192)))
    kept = tl.apply_precision({"t": p}, "int8", conv_min_ch=193)["t"]
    assert "w" in kept and kept["w"].dtype == torch.bfloat16


def test_duster_dpt_head_at_conv_min_ch_96_raises_in_both():
    """The whole model at a DPT head: KeyError from the transposed
    convolution in both packages' forward."""
    conf = {**SMALL, "head_type": "dpt", "precision": "int8",
            "int8_conv_min_ch": 96}
    jm, tm = _models("duster", conf)
    data = _pair()
    with pytest.raises(KeyError, match="'w'"):
        tm(data)
    with pytest.raises(KeyError, match="'w'"):
        jm(data)
