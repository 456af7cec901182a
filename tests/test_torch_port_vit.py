"""The ViT side of the port's dense path against the JAX package, on the
CPU: kernel K14's plain version (``qtiled_attention_plain``) against the
Pallas kernel it replaces run in interpret mode, ``mha_auto``'s route
table, ``ops/resize`` against ``jax.image.resize``, ``grid_sample``, the
layers RoMa adds, and the VGG19, ViT and DINOv2 backbones at narrow
widths. Inputs and parameters come from a numpy seed and go through both
packages. float32 unless a test says otherwise; each tolerance is stated
where it is used.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from imcui_tpu.models import layers as jl
from imcui_tpu.models.backbones import dinov2 as jdino
from imcui_tpu.models.backbones import vgg as jvgg
from imcui_tpu.models.backbones import vit as jvit
from imcui_tpu.ops import attention as ja
from imcui_tpu.ops import sampling as jsampling
from imcui_tpu_torch.models import layers as tl
from imcui_tpu_torch.models.backbones import dinov2 as tdino
from imcui_tpu_torch.models.backbones import vgg as tvgg
from imcui_tpu_torch.models.backbones import vit as tvit
from imcui_tpu_torch.ops import attention as ta
from imcui_tpu_torch.ops import resize as tresize
from imcui_tpu_torch.ops import sampling as tsampling
from imcui_tpu_torch.utils.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(a):
    """numpy float32 → (jax bf16, torch bf16) of the same values."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------------------
# K14: the q-tiled attention
# --------------------------------------------------------------------------

def _pallas_qtiled(q, k, v, nk_valid, blk_q=64, blk_k=None):
    """The kernel body K14 replaces (``_flash_attn_kernel`` with
    blk_k = nk, n_k = 1), built as tools/try_vit_attn.py builds it and run
    in interpret mode; keys from ``nk_valid`` on are masked, as
    ``mha_auto`` masks its padding. With ``blk_k`` the same body walks
    nk / blk_k key blocks with its online softmax, the form the CUDA
    kernel computes over 128-key tiles."""
    h, nq, dh = q.shape
    nk = k.shape[1]
    blk_k = blk_k or nk
    maskf = jnp.broadcast_to(
        (jnp.arange(nk) < nk_valid).astype(jnp.float32)[None, None],
        (h, 1, nk))
    kernel = functools.partial(ja._flash_attn_kernel, blk_k=blk_k,
                               n_k=nk // blk_k, scale=1.0 / dh ** 0.5)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(h, nq // blk_q),
        in_specs=[pl.BlockSpec((1, blk_q, dh), lambda hh, i: (hh, i, 0)),
                  pl.BlockSpec((1, nk, dh), lambda hh, i: (hh, 0, 0)),
                  pl.BlockSpec((1, nk, dh), lambda hh, i: (hh, 0, 0)),
                  pl.BlockSpec((1, 1, nk), lambda hh, i: (hh, 0, 0))],
        out_specs=pl.BlockSpec((1, blk_q, dh), lambda hh, i: (hh, i, 0)),
        interpret=True)(q, k, v, maskf)


@pytest.mark.parametrize("h,n", [(4, 256), (2, 197)])
def test_qtiled_attention_plain_matches_pallas_and_mha(h, n):
    """Tolerance 2⁻⁷·max(1, |ref|): one bf16 rounding step of the output
    (2⁻⁸ relative, rounded at a different last bit in each version)."""
    rng = np.random.default_rng(n)
    q, k, v = ((rng.normal(size=(h, n, 64)) * 1.5).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    got = _f32(ta.qtiled_attention(tq, tk, tv))
    assert ta.qtiled_attention(tq, tk, tv).dtype == torch.bfloat16
    # the JAX side pads the ragged token axis to the kernel's lattice
    n_pad = -(-n // 64) * 64
    pad = ((0, 0), (0, n_pad - n), (0, 0))
    want = _f32(_pallas_qtiled(jnp.pad(jq, pad), jnp.pad(jk, pad),
                               jnp.pad(jv, pad), n))[:, :n]
    want_mha = _f32(ja.mha_auto(jq, jk, jv))
    for ref in (want, want_mha):
        tol = 2.0 ** -7 * np.maximum(1.0, np.abs(ref))
        assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("blk_k", [64, 128])
@pytest.mark.parametrize("h,n", [(2, 197), (2, 256)])
def test_online_softmax_over_key_blocks_keeps_the_contract(h, n, blk_k):
    """K14's CUDA kernel runs the softmax online over key tiles. The JAX
    body run with several key blocks (n_k = 256 / blk_k, keys past n
    masked as ``mha_auto`` masks its padding) is that computation, and
    stays within K14's tolerance of the one-pass plain version:
    2⁻⁷·max(1, |plain|) + 2⁻⁹·max|v|. Query 0 of each head has its
    largest logit, ~12 against ~N(0, 2.25), in the last key block, so its
    running maximum jumps there and the sum and the output are rescaled;
    query 1 has it in the first block."""
    rng = np.random.default_rng(n + blk_k)
    q, k, v = ((rng.normal(size=(h, n, 64)) * 1.5).astype(np.float32)
               for _ in range(3))
    for row, key in ((0, n - 1), (1, 0)):
        k[:, key] = 96.0 / (q[:, row] ** 2).sum(-1, keepdims=True) * q[:, row]
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    logits = _f32(jq) @ _f32(jk).transpose(0, 2, 1) / 8
    assert (logits[:, 0].argmax(-1) == n - 1).all()
    assert (logits[:, 1].argmax(-1) == 0).all()
    pad = ((0, 0), (0, 256 - n), (0, 0))
    got = _f32(_pallas_qtiled(jnp.pad(jq, pad), jnp.pad(jk, pad),
                              jnp.pad(jv, pad), n, blk_k=blk_k))[:, :n]
    want = _f32(ta.qtiled_attention_plain(tq, tk, tv))
    tol = 2.0 ** -7 * np.maximum(1.0, np.abs(want)) \
        + 2.0 ** -9 * np.abs(_f32(tv)).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_qtiled_attention_plain_cross_shape():
    """Nq ≠ Nk (cross-attention) against ``mha``, same tolerance."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 50, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 77, 64)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    got = _f32(ta.qtiled_attention_plain(tq, tk, tv))
    want = _f32(ja.mha(jq, jk, jv))
    assert got.shape == (2, 50, 64)
    assert (np.abs(got - want) <= 2.0 ** -7 * np.maximum(1, np.abs(want))
            ).all()


ROUTES = [  # dtype, (H, Nq, Dh), Nk, the wrapper mha_auto must call
    (torch.bfloat16, (16, 1601, 64), 1601, "qtiled_attention"),
    (torch.bfloat16, (12, 1024, 64), 640, "qtiled_attention"),
    (torch.float32, (16, 1601, 64), 1601, "fused_attention"),
    (torch.float32, (4, 128, 64), 256, "flash_attention"),   # Nq != Nk
    (torch.float32, (4, 2304, 64), 2304, "flash_attention"),  # above 2048
    (torch.bfloat16, (4, 2304, 64), 2304, "flash_attention"),
    (torch.float32, (4, 64, 16), 64, None),                   # plain mha
    (torch.bfloat16, (8, 64, 128), 64, None),
]


@pytest.mark.parametrize("dtype,qshape,nk,want", ROUTES)
def test_mha_auto_route_table(monkeypatch, dtype, qshape, nk, want):
    called = []

    def spy(name):
        def fn(q, k, v, *rest):
            called.append((name, rest))
            return torch.zeros_like(q)
        return fn

    for name in ("qtiled_attention", "fused_attention", "flash_attention"):
        monkeypatch.setattr(ta, name, spy(name))
    h, nq, dh = qshape
    q = torch.zeros(qshape, dtype=dtype)
    k = torch.zeros((h, nk, dh), dtype=dtype)
    out = ta.mha_auto(q, k, k)
    assert out.shape == q.shape and out.dtype == dtype
    assert [c[0] for c in called] == ([want] if want else [])
    if want in ("fused_attention", "flash_attention"):
        assert called[0][1] == (None, h)   # no mask, one batch of h heads


@pytest.mark.parametrize("dtype,dh,tol", [
    ("float32", 64, 1e-5), ("float32", 16, 1e-5),
    ("bfloat16", 64, 2.0 ** -7), ("bfloat16", 128, 2.0 ** -7)])
def test_mha_auto_values_match_jax(dtype, dh, tol):
    """f32: the same sums in another order; bf16: one rounding step of
    the output."""
    rng = np.random.default_rng(dh)
    q, k, v = (rng.normal(size=(3, 70, dh)).astype(np.float32)
               for _ in range(3))
    if dtype == "bfloat16":
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    else:
        jq, jk, jv = q, k, v
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _f32(ta.mha_auto(tq, tk, tv))
    want = _f32(jnp.asarray(ja.mha_auto(jq, jk, jv)))
    assert (np.abs(got - want) <= tol * np.maximum(1, np.abs(want))).all()


def test_qtiled_attention_on_the_cpu_counts_no_launch():
    """A CPU tensor takes the plain version, whatever its shape, and the
    launch counter stays where it was."""
    before = ta.qtiled_attention.launches
    q = torch.zeros((2, 8, 32), dtype=torch.bfloat16)
    assert ta.qtiled_attention(q, q, q).shape == q.shape
    assert ta.qtiled_attention.launches == before


# --------------------------------------------------------------------------
# resize, grid_sample
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [
    ((37, 37), (40, 40)), ((37, 37), (8, 11)), ((8, 8), (14, 14)),
    ((240, 320), (112, 112)), ((15, 9), (15, 23)), ((21, 33), (7, 50))])
def test_resize_matches_jax_image_resize(method, src, dst):
    """atol 1e-5: float32 weights and sums in both."""
    rng = np.random.default_rng(src[0] * 100 + dst[1])
    x = rng.normal(size=src + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (3,), method))
    got = tresize.resize(torch.from_numpy(x), dst, method, dims=(0, 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got_chw = tresize.resize(torch.from_numpy(x).permute(2, 0, 1), dst,
                             method)
    np.testing.assert_allclose(got_chw.permute(1, 2, 0).numpy(), want,
                               atol=1e-5)


def test_resize_bf16_and_bad_method():
    """bf16 in, bf16 out, within two bf16 steps of the f32 result."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 37, 4)).astype(np.float32)
    jx, tx = _bf16(x)
    want = _f32(jax.image.resize(jx, (40, 40, 4), "bicubic"))
    got = tresize.resize(tx, (40, 40), "bicubic", dims=(0, 1))
    assert got.dtype == torch.bfloat16
    assert np.abs(_f32(got) - want).max() <= 2.0 ** -6 * np.abs(want).max()
    with pytest.raises(ValueError):
        tresize.resize(tx, (40, 40), "lanczos3")


def test_grid_sample_matches_jax_with_out_of_range_taps():
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(9, 13, 5)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, size=(7, 6, 2)).astype(np.float32)
    grid[0, 0] = (-1.0, -1.0)
    grid[0, 1] = (1.0, 1.0)
    grid[0, 2] = (3.0, -3.0)       # every tap outside: zeros
    want = np.asarray(jsampling.grid_sample(jnp.asarray(fmap),
                                            jnp.asarray(grid)))
    got = tsampling.grid_sample(torch.from_numpy(fmap).permute(2, 0, 1),
                                torch.from_numpy(grid))
    assert got.shape == (5, 7, 6)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=1e-5)
    assert np.abs(want[0, 2]).max() == 0.0
    # a bf16 map at f32 coordinates comes out f32, as in the JAX function
    jf, tf = _bf16(fmap)
    want16 = jsampling.grid_sample(jf, jnp.asarray(grid))
    got16 = tsampling.grid_sample(tf.permute(2, 0, 1), torch.from_numpy(grid))
    assert want16.dtype == jnp.float32 and got16.dtype == torch.float32
    np.testing.assert_allclose(got16.permute(1, 2, 0).numpy(),
                               np.asarray(want16), atol=1e-5)
    # the bicubic and nearest modes: tests/test_torch_port_sparse_zoo.py
    with pytest.raises(ValueError, match="unknown mode"):
        tsampling.grid_sample(tf, torch.from_numpy(grid), mode="lanczos")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _conv_params(rng, kh, kw, cin, cout):
    return {"w": rng.normal(size=(kh, kw, cin, cout)).astype(np.float32)
            * (1.0 / (kh * kw * cin)) ** 0.5,
            "b": rng.normal(size=(cout,)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("precision,tol", [(None, 1e-5), ("bf16", 2.0 ** -7)])
def test_depthwise_conv_matches_jax(precision, tol):
    """A grouped convolution against JAX's shift-and-accumulate sum. f32:
    1e-5. bf16: JAX rounds each of the 25 products to bf16 before its f32
    sum, the port sums the exact products; with the one rounding of the
    result that stays inside 2⁻⁷·max(1, |ref|), one bf16 step."""
    rng = np.random.default_rng(5)
    p = _conv_params(rng, 5, 5, 1, 12)
    x = rng.normal(size=(1, 10, 11, 12)).astype(np.float32)
    jp = jl.apply_precision(jax.tree_util.tree_map(jnp.asarray, p), precision)
    tp = tl.apply_precision(params_from_jax(p), precision)
    assert tp["w"].shape == (12, 1, 5, 5)
    want = jl.depthwise_conv(jp, jnp.asarray(x))
    got = tl.depthwise_conv(tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    want, got = _f32(want), _f32(got.permute(0, 2, 3, 1))
    assert (np.abs(got - want) <= tol * np.maximum(1, np.abs(want))).all()
    # and it is the grouped convolution it stands for
    ref = _f32(jl.conv2d(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x), groups=12))
    if precision is None:
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_batch_norm_without_scale_and_with():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 6, 7, 5)).astype(np.float32)
    stats = {"mean": rng.normal(size=5).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=5).astype(np.float32)}
    affine = {**stats, "scale": rng.normal(size=5).astype(np.float32),
              "bias": rng.normal(size=5).astype(np.float32)}
    for p in (stats, affine):
        want = np.asarray(jl.batch_norm_inference(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
        got = tl.batch_norm_inference(
            params_from_jax(p), torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-6)


def test_conv2d_valid_strided_and_grouped():
    """The patch embed (14 × 14 at stride 14, VALID) and a grouped conv."""
    rng = np.random.default_rng(7)
    p = _conv_params(rng, 14, 14, 3, 8)
    x = rng.normal(size=(1, 42, 56, 3)).astype(np.float32)
    want = np.asarray(jl.conv2d(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x), stride=14, padding="VALID"))
    got = tl.conv2d(params_from_jax(p),
                    torch.from_numpy(x).permute(0, 3, 1, 2), stride=14,
                    padding="VALID")
    assert got.shape == (1, 8, 3, 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    pg = _conv_params(rng, 3, 3, 2, 6)
    xg = rng.normal(size=(1, 9, 9, 6)).astype(np.float32)
    want = np.asarray(jl.conv2d(jax.tree_util.tree_map(jnp.asarray, pg),
                                jnp.asarray(xg), groups=3))
    got = tl.conv2d(params_from_jax(pg),
                    torch.from_numpy(xg).permute(0, 3, 1, 2), groups=3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tl.conv2d(params_from_jax(pg), torch.zeros(1, 6, 9, 9), padding="X")


def test_l2_normalize_linear_promotion_and_apply_precision():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(
        tl.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jl.l2_normalize(jnp.asarray(x))), atol=1e-6)
    tree = {"a": {"w": torch.ones(3, 3), "n": torch.arange(3)},
            "l": [torch.ones(2), {"b": torch.zeros(2)}]}
    cast = tl.apply_precision(tree, "bf16")
    assert cast["a"]["w"].dtype == torch.bfloat16
    assert cast["a"]["n"].dtype == torch.int64
    assert cast["l"][1]["b"].dtype == torch.bfloat16
    assert tl.apply_precision(tree, None) is tree
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.apply_precision(tree, "int8")
    with pytest.raises(ValueError):
        tl.apply_precision(tree, "fp8")
    # float32 tokens through a bf16 linear: promoted, as x @ w in JAX
    p = {"w": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=5).astype(np.float32)}
    jp = jl.apply_precision(jax.tree_util.tree_map(jnp.asarray, p), "bf16")
    tp = tl.apply_precision(params_from_jax(p), "bf16")
    want = jl.linear(jp, jnp.asarray(x))
    got = tl.linear(tp, torch.from_numpy(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------------------
# backbones
# --------------------------------------------------------------------------

def test_vgg_apply_matches_jax():
    """The pyramid entering each pool, strides 1/2/4/8; 1e-4 on features
    of order 1 after twelve f32 convolutions."""
    rng = np.random.default_rng(9)
    jp = _np(jvgg.init_params(jax.random.PRNGKey(1)))
    for leaf in jp["layers"].values():
        leaf["b"] = rng.normal(size=leaf["b"].shape).astype(np.float32) * 0.1
    img = rng.uniform(size=(32, 48, 3)).astype(np.float32)
    want = jvgg.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                      jnp.asarray(img))
    got = tvgg.apply(params_from_jax(jp),
                     torch.from_numpy(img).permute(2, 0, 1))
    assert set(got) == {1, 2, 4, 8}
    for s in got:
        assert got[s].shape == (tvgg.FEAT_DIMS[s], 32 // s, 48 // s)
        np.testing.assert_allclose(got[s].permute(1, 2, 0).numpy(),
                                   np.asarray(want[s]), atol=1e-4)
    init = tvgg.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v["w"].shape) for k, v in init["layers"].items()} == {
        k: tuple(np.transpose(v["w"], (3, 2, 0, 1)).shape)
        for k, v in jp["layers"].items()}


def _randomise(tree, rng, scale=0.2):
    """Replace every leaf (zero biases, unit scales) by seeded values."""
    def leaf(a):
        a = np.asarray(a)
        return (a + rng.normal(size=a.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map(leaf, tree)


def test_vit_blocks_match_jax():
    """Encoder and decoder block, with and without RoPE: atol 2e-5."""
    rng = np.random.default_rng(10)
    dim, heads, hp, wp = 64, 4, 3, 5
    enc = _randomise(jvit.init_encoder_block(jax.random.PRNGKey(0), dim), rng)
    dec = _randomise(jvit.init_decoder_block(jax.random.PRNGKey(1), dim), rng)
    x = rng.normal(size=(hp * wp, dim)).astype(np.float32)
    y = rng.normal(size=(11, dim)).astype(np.float32)
    jpos = jvit.grid_positions(hp, wp)
    tpos = tvit.grid_positions(hp, wp)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jk = jnp.asarray(rng.integers(0, 6, size=(11, 2)).astype(np.int32))
    tk = torch.from_numpy(np.array(jk)).long()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for kw_j, kw_t in (({}, {}),
                       ({"pos": jpos, "rope_base": 100.0},
                        {"pos": tpos, "rope_base": 100.0})):
        want = jvit.encoder_block_apply(
            jax.tree_util.tree_map(jnp.asarray, enc), jnp.asarray(x), heads,
            **kw_j)
        got = tvit.encoder_block_apply(params_from_jax(enc), tx, heads,
                                       **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        if kw_j:
            kw_j, kw_t = {**kw_j, "kpos": jk}, {**kw_t, "kpos": tk}
        want = jvit.decoder_block_apply(
            jax.tree_util.tree_map(jnp.asarray, dec), jnp.asarray(x),
            jnp.asarray(y), heads, **kw_j)
        got = tvit.decoder_block_apply(params_from_jax(dec), tx, ty, heads,
                                       **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the init trees have the JAX trees' leaves
    gen = torch.Generator().manual_seed(0)
    for init, ref in ((tvit.init_encoder_block(gen, dim), enc),
                      (tvit.init_decoder_block(gen, dim), dec)):
        from imcui_tpu_torch.utils.weights import assert_tree_matches
        assert_tree_matches(init, params_from_jax(ref), "vit block")


def test_vit_embeddings_match_jax():
    np.testing.assert_allclose(
        tvit.sincos_pos_embed(5, 7, 32).numpy(),
        np.asarray(jvit.sincos_pos_embed(5, 7, 32)), atol=1e-6)
    rng = np.random.default_rng(11)
    p = {"proj": _conv_params(rng, 8, 8, 3, 16)}
    img = rng.uniform(size=(24, 40, 3)).astype(np.float32)
    want, grid = jvit.patch_embed_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(img), 8)
    got, tgrid = tvit.patch_embed_apply(
        params_from_jax(p), torch.from_numpy(img).permute(2, 0, 1), 8)
    assert tuple(grid) == tuple(tgrid) == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert tuple(tvit.init_patch_embed(torch.Generator().manual_seed(0), 8,
                                       3, 16)["proj"]["w"].shape) == \
        (16, 3, 8, 8)


@pytest.mark.parametrize("impl", ["xla", "fused", "flash"])
def test_vit_attention_impl_switch_bf16(monkeypatch, impl):
    """bf16 tokens through each ATTN_IMPL: "fused" reaches mha_auto and
    "flash" kernel K5's wrapper; all agree with the JAX block's plain
    attention within bf16 rounding of a 64-wide block (2⁻⁵ on values of
    order 1)."""
    rng = np.random.default_rng(12)
    dim, heads = 256, 4                      # Dh = 64
    enc = _randomise(jvit.init_encoder_block(jax.random.PRNGKey(2), dim),
                     rng, 0.05)
    x = rng.normal(size=(40, dim)).astype(np.float32)
    jx, tx = _bf16(x)
    jp = jl.apply_precision(jax.tree_util.tree_map(jnp.asarray, enc), "bf16")
    tp = tl.apply_precision(params_from_jax(enc), "bf16")
    want = _f32(jvit.encoder_block_apply(jp, jx, heads))
    calls = []
    for name in ("mha_auto", "flash_attention"):
        real = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    monkeypatch.setattr(tvit, "ATTN_IMPL", impl)
    got = tvit.encoder_block_apply(tp, tx, heads)
    assert got.dtype == torch.bfloat16
    assert calls == {"xla": [], "fused": ["mha_auto"],
                     "flash": ["flash_attention"]}[impl]
    assert np.abs(_f32(got) - want).max() <= 2.0 ** -5 * max(
        1.0, np.abs(want).max())


DINO_CFG = {"dim": 128, "depth": 2, "num_heads": 2, "mlp_ratio": 4,
            "patch": 14, "pretrain_grid": 37}     # Dh = 64: the kernel route


def _dino_params(rng):
    """The JAX init tree with every LayerScale gamma drawn in [0.5, 1.5]:
    at the init value of 1e-5 a wrong attention would be invisible in the
    output."""
    p = _np(jdino.init_params(jax.random.PRNGKey(3), DINO_CFG))
    p = _randomise(p, rng, 0.02)
    for blk in p["blocks"]:
        for ls in ("ls1", "ls2"):
            blk[ls]["gamma"] = rng.uniform(
                0.5, 1.5, size=blk[ls]["gamma"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("hw", [(112, 112), (84, 154)])
@pytest.mark.parametrize("precision,tol", [(None, 1e-4), ("bf16", 2.0 ** -4)])
def test_dinov2_apply_matches_jax(monkeypatch, hw, precision, tol):
    """Dh = 64, so the port's attention goes through mha_auto's kernel
    route (its plain version here): f32 → K3's wrapper, bf16 → K14's. f32:
    1e-4 on normed tokens of order 1; bf16: 2⁻⁴ (two blocks of bf16
    matmuls rounded at different places)."""
    rng = np.random.default_rng(13)
    p = _dino_params(rng)
    img = rng.uniform(size=hw + (3,)).astype(np.float32)
    jp = jl.apply_precision(jax.tree_util.tree_map(jnp.asarray, p), precision)
    tp = tl.apply_precision(params_from_jax(p), precision)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img).permute(2, 0, 1)
    if precision:
        jimg, timg = jimg.astype(jnp.bfloat16), timg.to(torch.bfloat16)
    routed = []
    for name in ("qtiled_attention", "fused_attention"):
        real = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _r=real, _n=name: (
            routed.append(_n), _r(*a))[1])
    want, grid = jdino.apply(jp, jimg, DINO_CFG)
    got, tgrid = tdino.apply(tp, timg, DINO_CFG)
    assert tuple(grid) == tuple(tgrid) == (hw[0] // 14, hw[1] // 14)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    assert routed == ["qtiled_attention" if precision else
                      "fused_attention"] * DINO_CFG["depth"]
    want, got = _f32(want), _f32(got)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())
    # the attention matters at these gammas: without it the tokens move
    monkeypatch.setattr(tdino, "mha_auto", lambda q, k, v: torch.zeros_like(q))
    off, _ = tdino.apply(tp, timg, DINO_CFG)
    assert np.abs(_f32(off) - want).max() > 0.5


def test_dinov2_init_tree_and_pos_embed():
    init = tdino.init_params(torch.Generator().manual_seed(0), "test")
    ref = params_from_jax(_np(jdino.init_params(jax.random.PRNGKey(0),
                                                "test")))
    from imcui_tpu_torch.utils.weights import assert_tree_matches
    assert_tree_matches(init, ref, "dinov2")
    assert float(init["blocks"][0]["ls1"]["gamma"][0]) == pytest.approx(1e-5)
    assert tdino.CONFIGS == jdino.CONFIGS
    rng = np.random.default_rng(14)
    pe = rng.normal(size=(1 + 37 * 37, 8)).astype(np.float32)
    want = np.asarray(jdino._interp_pos_embed(jnp.asarray(pe), 40, 40))
    got = tdino._interp_pos_embed(torch.from_numpy(pe), 40, 40)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    same = tdino._interp_pos_embed(torch.from_numpy(pe), 37, 37)
    np.testing.assert_array_equal(same.numpy(), pe)


# --------------------------------------------------------------------------
# the package imports nothing of the JAX side
# --------------------------------------------------------------------------

def test_port_imports_no_jax_cv2_pil_or_jax_package():
    """Import every module of imcui_tpu_torch in a fresh interpreter (the
    evaluations in imcui_tpu_torch/eval/ and the zoo's models among them)
    and look at sys.modules: no JAX, cv2, PIL, h5py, triton or
    torchvision."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import imcui_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "imcui_tpu_torch.__path__, 'imcui_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cv2', 'PIL', 'imcui_tpu', 'h5py', 'triton', "
        "'torchvision'))\n"
        "evals = {'imcui_tpu_torch.' + m for m in "
        "('eval.megadepth', 'eval.synthpose', 'eval.warp', 'ops.sinkhorn', "
        "'ops.deform', 'models.matchers.superglue', "
        "'models.matchers.adalam', 'models.extractors.aliked', "
        "'models.extractors.disk', 'models.extractors.alike', "
        "'models.extractors.xfeat', 'models.extractors.d2net', "
        "'models.extractors.dedode', 'models.extractors.sfd2', "
        "'models.backbones.resnet', 'models.matchers.xfeat_lightglue', "
        "'models.matchers.xfeat_dense', 'models.matchers.sgmnet', "
        "'models.matchers.imp', 'models.matchers.sphereglue', 'ops.sift', "
        "'models.extractors.sift', 'models.extractors.dog', "
        "'models.extractors.r2d2', 'models.extractors.darkfeat', "
        "'models.extractors.lanet', 'models.extractors.liftfeat', "
        "'models.extractors.ripe', 'models.extractors.rekd', "
        "'models.extractors.raco', 'models.backbones.dpt', "
        "'models.matchers.duster', 'models.matchers.mast3r', "
        "'models.matchers.dkm', 'ops.lsd', 'models.matchers.gluestick', "
        "'models.matchers.lisrd', 'models.matchers.sold2', "
        "'models.matchers.dad_roma', 'models.matchers.romav2')}\n"
        "print(len(names), bad, sorted(evals - set(names)))\n"
        "sys.exit(1 if bad or len(names) < 30 or evals - set(names) "
        "else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
