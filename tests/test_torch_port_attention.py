"""Attention of the port (imcui_tpu_torch/ops/attention.py): the plain
versions of kernels K3, K4 and K5 against the JAX package's XLA
restatements of its Pallas kernels and against the Pallas kernel bodies
of K3, K4 and K5 themselves (``pl.pallas_call(..., interpret=True)``), and
the rotary helpers. float32 unless a test says otherwise; tolerance 1e-5 (the
same arithmetic, summed in another order). Then LightGlue's
``forward_pair`` and ``forward_pair_adaptive`` with ``precision="bf16"``
against the JAX functions with ``conf["precision"] = "bf16"``."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.ops import attention as ja
from imcui_tpu_torch.models.matchers import lightglue as tlg
from imcui_tpu_torch.ops import attention as ta
from imcui_tpu_torch.utils import weights as tweights

HEADS = 4


def _rand(rng, *shape, scale=2.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _masks(b, n, rng):
    m = rng.uniform(size=(b, n)) < 0.8
    m[0, :] = True
    m[1, :] = False            # every key masked: attends uniformly
    return m


def test_fused_attention_plain_matches_jax():
    rng = np.random.default_rng(0)
    b, n, dh = 3, 96, 64
    q, k, v = (_rand(rng, b * HEADS, n, dh) for _ in range(3))
    mask = _masks(b, n, rng)
    got = ta.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(mask), HEADS).numpy()
    for i in range(b):
        sl = slice(i * HEADS, (i + 1) * HEADS)
        maskf = np.broadcast_to(mask[i].astype(np.float32)[None, None],
                                (HEADS, 1, n))
        want = np.asarray(ja._fused_attn_xla(q[sl], k[sl], v[sl],
                                             jnp.asarray(maskf)))
        np.testing.assert_allclose(got[sl], want, atol=1e-5, rtol=1e-5)
        want_mha = np.asarray(ja.mha(q[sl], k[sl], v[sl],
                                     mask_k=jnp.asarray(mask[i])))
        np.testing.assert_allclose(got[sl], want_mha, atol=1e-5, rtol=1e-5)
    # a query with every key masked gets the mean of V
    np.testing.assert_allclose(got[HEADS:2 * HEADS],
                               np.broadcast_to(v[HEADS:2 * HEADS].mean(
                                   1, keepdims=True), (HEADS, n, dh)),
                               atol=1e-5)


def test_bidirectional_attention_plain_matches_jax():
    rng = np.random.default_rng(1)
    b, n, m, dh = 2, 80, 112, 64
    a0, v0 = _rand(rng, b * HEADS, n, dh), _rand(rng, b * HEADS, n, dh)
    a1, v1 = _rand(rng, b * HEADS, m, dh), _rand(rng, b * HEADS, m, dh)
    m0 = _masks(b, n, rng)
    m1 = _masks(b, m, rng)
    m1[1, :5] = True           # pair 1: view 0 all masked, view 1 not
    o0, o1 = ta.bidirectional_attention(
        *(torch.from_numpy(x) for x in (a0, a1, v0, v1, m0, m1)), HEADS)
    for i in range(b):
        sl = slice(i * HEADS, (i + 1) * HEADS)
        mk0 = np.broadcast_to(m0[i].astype(np.float32)[None, :, None],
                              (HEADS, n, 1))
        mk1 = np.broadcast_to(m1[i].astype(np.float32)[None, None, :],
                              (HEADS, 1, m))
        w0, w1 = ja._bidir_xla(a0[sl], a1[sl], v0[sl], v1[sl],
                               jnp.asarray(mk0), jnp.asarray(mk1))
        np.testing.assert_allclose(o0.numpy()[sl], np.asarray(w0),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(o1.numpy()[sl], np.asarray(w1),
                                   atol=1e-5, rtol=1e-5)


def _fused_pallas(q, k, v, maskf):
    """``_fused_attn_pallas`` (attention.py:263) in interpret mode: its
    kernel body ``_fused_attn_kernel`` (:244) and the BlockSpecs of :267,
    restated without the TPU memory space. q/k/v (H, N, Dh), maskf (H, 1,
    N) float {0, 1}."""
    h, nq, dh = q.shape
    nk = k.shape[1]
    return pl.pallas_call(
        functools.partial(ja._fused_attn_kernel, scale=1.0 / dh ** 0.5),
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(h,),
        in_specs=[pl.BlockSpec((1, nq, dh), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, nk, dh), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, nk, dh), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, 1, nk), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, nq, dh), lambda i: (i, 0, 0)),
        interpret=True)(q, k, v, maskf)


def _bidir_pallas(a0, a1, v0, v1, mk0, mk1):
    """``_bidir_pallas`` (attention.py:385) in interpret mode: the body
    ``_bidir_attn_kernel`` (:339) and the BlockSpecs of :389 without the
    TPU memory space. mk0 (H, N, 1), mk1 (H, 1, M) float {0, 1}."""
    h, n, dh = a0.shape
    m = a1.shape[1]

    def spec(*shape):
        return pl.BlockSpec((1, *shape), lambda i: (i, 0, 0))

    return pl.pallas_call(
        functools.partial(ja._bidir_attn_kernel, scale=1.0 / dh ** 0.5),
        out_shape=(jax.ShapeDtypeStruct((h, n, dh), a0.dtype),
                   jax.ShapeDtypeStruct((h, m, dh), a1.dtype)),
        grid=(h,),
        in_specs=[spec(n, dh), spec(m, dh), spec(n, dh), spec(m, dh),
                  spec(n, 1), spec(1, m)],
        out_specs=(spec(n, dh), spec(m, dh)),
        interpret=True)(a0, a1, v0, v1, mk0, mk1)


def _flash_pallas(q, k, v, maskf, blk):
    """``_flash_pallas`` (attention.py:155) in interpret mode: its kernel
    body ``_flash_attn_kernel`` (:99) with blk_q = blk_k = blk and n_k =
    Nk / blk, and the BlockSpecs of :168, restated without the TPU memory
    space. q (H, Nq, Dh), k/v (H, Nk, Dh), maskf (H, 1, Nk) float {0, 1}."""
    h, nq, dh = q.shape
    nk = k.shape[1]

    def whole(*shape):
        return pl.BlockSpec((1, *shape), lambda hh, i: (hh, 0, 0))

    rows = pl.BlockSpec((1, blk, dh), lambda hh, i: (hh, i, 0))
    return pl.pallas_call(
        functools.partial(ja._flash_attn_kernel, blk_k=blk, n_k=nk // blk,
                          scale=1.0 / dh ** 0.5),
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(h, nq // blk),
        in_specs=[rows, whole(nk, dh), whole(nk, dh), whole(1, nk)],
        out_specs=rows,
        interpret=True)(q, k, v, maskf)


def _edge_masks(b, n, rng):
    """Image 0 all valid, image 1 every key masked, the rest random."""
    m = rng.uniform(size=(b, n)) < 0.7
    m[0, :] = True
    m[1, :] = False
    return m


def _close(got, want, dtype):
    """float32: 1e-5 (the same arithmetic summed in another order). bf16:
    both round P once to bf16 before P V and the output once, so they
    differ where an f32 difference of the order of an ulp moves P or the
    output across a rounding edge: 2^-7 * max(1, |ref|), one bf16 step."""
    got, want = (np.asarray(torch.as_tensor(a).float() if isinstance(
        a, torch.Tensor) else np.asarray(a, np.float32)) for a in (got, want))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want)
                      <= 2.0 ** -7 * np.maximum(1.0, np.abs(want)))


# float32 at the ids the tests had before bf16 joined them
K3_CASES = [pytest.param(n, d, id=f"{n}" if d == "float32" else f"{n}-bf16")
            for d in ("float32", "bfloat16") for n in (1, 65, 130)]
K4_CASES = [pytest.param(n, m, d, id=f"{n}-{m}" + ("" if d == "float32"
                                                   else "-bf16"))
            for d in ("float32", "bfloat16") for n, m in ((1, 65), (130, 70))]


@pytest.mark.parametrize("n,dtype", K3_CASES)
def test_fused_attention_plain_matches_pallas_kernel(n, dtype):
    """K3's plain version against the Pallas body at the sizes the CUDA
    tile's edges hit (one row, one past a 64-row tile, two tiles and a
    part), with an image whose keys are all masked; float32 and bf16
    (the body takes bf16 q, k and v and returns bf16)."""
    rng = np.random.default_rng(10 + n)
    b, dh = 3, 64
    q, k, v = (_rand(rng, b * HEADS, n, dh) for _ in range(3))
    mask = _edge_masks(b, n, rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ta.fused_attention(*(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v)),
                             torch.from_numpy(mask), HEADS)
    assert got.dtype == tdt
    maskf = np.repeat(mask.astype(np.float32), HEADS, 0)[:, None, :]
    want = _fused_pallas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                         maskf)
    assert want.dtype == jdt
    _close(got, want, dtype)


@pytest.mark.parametrize("n,m,dtype", K4_CASES)
def test_bidirectional_attention_plain_matches_pallas_kernel(n, m, dtype):
    """K4's plain version against the Pallas body, both directions, with
    a pair whose keys are all masked on one side; float32 and bf16."""
    rng = np.random.default_rng(20 + n + m)
    b, dh = 3, 64
    a0, v0 = _rand(rng, b * HEADS, n, dh), _rand(rng, b * HEADS, n, dh)
    a1, v1 = _rand(rng, b * HEADS, m, dh), _rand(rng, b * HEADS, m, dh)
    m0, m1 = _edge_masks(b, n, rng), _edge_masks(b, m, rng)
    m1[1, :] = True            # pair 1: view 0 all masked, view 1 valid
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    o0, o1 = ta.bidirectional_attention(
        *(torch.from_numpy(x).to(tdt) for x in (a0, a1, v0, v1)),
        torch.from_numpy(m0), torch.from_numpy(m1), HEADS)
    assert o0.dtype == o1.dtype == tdt
    mk0 = np.repeat(m0.astype(np.float32), HEADS, 0)[:, :, None]
    mk1 = np.repeat(m1.astype(np.float32), HEADS, 0)[:, None, :]
    w0, w1 = _bidir_pallas(*(jnp.asarray(x).astype(jdt)
                             for x in (a0, a1, v0, v1)), mk0, mk1)
    _close(o0, w0, dtype)
    _close(o1, w1, dtype)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_kernel(dh, dtype):
    """K5's plain version against its Pallas body, 64-row blocks over three
    key blocks (the online softmax's rescale runs), Nq != Nk, with a batch
    row whose keys are all masked (the mean of V) and one with random
    masks. float32: 1e-5. bf16 inputs: both widen them and keep p in f32,
    and round once at the output: 2^-7 * max(1, |ref|)."""
    rng = np.random.default_rng(30 + dh)
    b, nq, nk, blk = 3, 128, 192, 64
    q, k, v = (_rand(rng, b * HEADS, n, dh) for n in (nq, nk, nk))
    mask = _edge_masks(b, nk, rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ta.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             torch.from_numpy(mask), HEADS)
    assert got.dtype == tdt
    maskf = np.repeat(mask.astype(np.float32), HEADS, 0)[:, None, :]
    want = _flash_pallas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                         jnp.asarray(maskf), blk)
    assert want.dtype == jdt
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(got - want)
                      <= 2.0 ** -7 * np.maximum(1.0, np.abs(want)))
    # the masked batch row: the mean of V (of its bf16 values)
    vm = torch.from_numpy(v[HEADS:2 * HEADS]).to(tdt).float().numpy().mean(
        1, keepdims=True)
    np.testing.assert_allclose(want[HEADS:2 * HEADS],
                               np.broadcast_to(vm, (HEADS, nq, dh)),
                               atol=1e-5 if dtype == "float32" else 2 ** -7)


def test_rotary_helpers_match_jax():
    rng = np.random.default_rng(2)
    kpts = rng.uniform(-1, 1, size=(50, 2)).astype(np.float32)
    wr = rng.normal(size=(2, 32)).astype(np.float32)
    cos_j, sin_j = ja.learnable_fourier_encoding(jnp.asarray(kpts),
                                                 jnp.asarray(wr))
    cos_t, sin_t = ta.learnable_fourier_encoding(torch.from_numpy(kpts),
                                                 torch.from_numpy(wr.T))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    x = _rand(rng, HEADS, 50, 64)
    want = ja.apply_rotary(jnp.asarray(x), (cos_j, sin_j))
    got = ta.apply_rotary(torch.from_numpy(x), (cos_t, sin_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("nq,nk,dh,dtype,atol", [
    (80, 80, 64, "float32", 1e-5),
    (48, 112, 64, "float32", 1e-5),       # Nq != Nk
    (64, 96, 128, "float32", 1e-5),       # the wider head
    (80, 80, 64, "bfloat16", 2.0 ** -6),  # one bf16 step of values up to ~4
])
def test_flash_attention_plain_matches_jax(nq, nk, dh, dtype, atol):
    """Plain version of K5 against the JAX package's ``flash_attention``
    (off the TPU: ``mha`` with the key mask), one masked batch row
    included. f32: 1e-5, the same arithmetic summed in another order; bf16
    inputs: both compute in f32 from the same bf16 values, but JAX rounds
    the probabilities to bf16 before the readout, so within 2^-6."""
    rng = np.random.default_rng(3)
    b = 3
    q = _rand(rng, b * HEADS, nq, dh, scale=1.0)
    k = _rand(rng, b * HEADS, nk, dh, scale=1.0)
    v = _rand(rng, b * HEADS, nk, dh)
    mask = _masks(b, nk, rng)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ta.flash_attention(tq, tk, tv, torch.from_numpy(mask), HEADS)
    assert got.dtype == tdt and got.shape == (b * HEADS, nq, dh)
    got = got.float().numpy()
    for i in range(b):
        sl = slice(i * HEADS, (i + 1) * HEADS)
        want = ja.flash_attention(*(jnp.asarray(a[sl]).astype(jdt)
                                    for a in (q, k, v)), jnp.asarray(mask[i]))
        assert want.dtype == jdt
        np.testing.assert_allclose(got[sl], np.asarray(want, np.float32),
                                   atol=atol, rtol=atol)
    # every key masked: the mean of V (of its bf16 values for bf16 inputs)
    vm = tv[HEADS:2 * HEADS].float().numpy().mean(1, keepdims=True)
    np.testing.assert_allclose(got[HEADS:2 * HEADS],
                               np.broadcast_to(vm, (HEADS, nq, dh)),
                               atol=atol)


def test_flash_attention_without_mask_is_plain_mha():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, HEADS, 40, 64)) for _ in range(3))
    got = ta.flash_attention(q, k, v, None, HEADS)
    torch.testing.assert_close(got, ta.mha(q, k, v), atol=1e-6, rtol=0)


def test_attention_times_refuses_without_a_card():
    """The K3/K4 timing tool measures on a card or not at all."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    from imcui_tpu_torch.tools import attention_times
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        attention_times.main([])


@pytest.mark.parametrize("kernel", ["fused", "bidirectional", "flash",
                                    "qtiled"])
def test_sdpa_views_compute_each_kernels_function(kernel):
    """The library yardstick of K3, K4, K5 and K14 (tools/attention_times:
    one SDPA call per product on the 4-D views ``sdpa_views`` makes, which
    the fused backends take) computes the kernel's function: against its
    plain version, here through SDPA's math path on the CPU, 1e-5 of
    max(1, |plain|), including an image whose keys are all masked. K14's
    bf16 inputs go through SDPA widened to float32, against K14's rounded
    output: 2⁻⁷·max(1, |plain|), one bf16 step."""
    from imcui_tpu_torch.tools.attention_times import sdpa_views
    import torch.nn.functional as F

    rng = np.random.default_rng(11)
    b, n, m = 3, 40, 56
    t = lambda *shape: torch.from_numpy(_rand(rng, *shape))  # noqa: E731
    mask_n, mask_m = (torch.from_numpy(_masks(b, r, rng)) for r in (n, m))

    def sdpa(q, k, v, key_mask):
        views = sdpa_views(q, k, v, key_mask, HEADS)
        assert all(x.dim() == 4 for x in views)
        return F.scaled_dot_product_attention(*views[:3], attn_mask=views[3]
                                              ).reshape(q.shape)

    if kernel == "fused":
        q, k, v = t(b * HEADS, n, 64), t(b * HEADS, n, 64), t(b * HEADS, n, 64)
        pairs = [(sdpa(q, k, v, mask_n),
                  ta.fused_attention_plain(q, k, v, mask_n, HEADS))]
    elif kernel == "bidirectional":
        a0, v0 = t(b * HEADS, n, 64), t(b * HEADS, n, 64)
        a1, v1 = t(b * HEADS, m, 64), t(b * HEADS, m, 64)
        want = ta.bidirectional_attention_plain(a0, a1, v0, v1, mask_n,
                                                mask_m, HEADS)
        pairs = [(sdpa(a0, a1, v1, mask_m), want[0]),
                 (sdpa(a1, a0, v0, mask_n), want[1])]
    elif kernel == "flash":
        q, k, v = t(b * HEADS, n, 64), t(b * HEADS, m, 64), t(b * HEADS, m, 64)
        pairs = [(sdpa(q, k, v, mask_m),
                  ta.flash_attention_plain(q, k, v, mask_m, HEADS))]
    else:
        q, k, v = (t(16, r, 64).to(torch.bfloat16) for r in (n, m, m))
        views = sdpa_views(q.float(), k.float(), v.float())
        assert all(x.dim() == 4 for x in views[:3]) and views[3] is None
        got = F.scaled_dot_product_attention(*views[:3])[0]
        want = ta.qtiled_attention_plain(q, k, v).float()
        assert bool(((got - want).abs()
                     <= 2.0 ** -7 * want.abs().clamp_min(1.0)).all())
        return
    for got, want in pairs:
        assert float((got - want).abs().max()) <= 1e-5 * max(
            1.0, float(want.abs().max()))


# --------------------------------------------------------------------------
# LightGlue in bf16
# --------------------------------------------------------------------------

def _lg_inputs(seed=4, b=2, n0=64, n1=64):
    """Pairs of keypoints and unit descriptors, view 1 a perturbed subset
    of view 0, pair 1 with padded slots."""
    rng = np.random.default_rng(seed)
    kpts0 = rng.uniform(0, 120, (b, n0, 2)).astype(np.float32)
    desc0 = rng.normal(size=(b, n0, 256)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    perm = rng.permutation(n0)[:n1]
    kpts1 = kpts0[:, perm] + rng.normal(0, 1.0, (b, n1, 2)).astype(
        np.float32)
    desc1 = desc0[:, perm] + rng.normal(0, 0.05, (b, n1, 256)).astype(
        np.float32)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    mask0, mask1 = np.ones((b, n0), bool), np.ones((b, n1), bool)
    mask0[1, 50:] = False
    mask1[1, 40:] = False
    size = np.asarray([[128, 96], [120, 90]], np.float32)
    return kpts0, kpts1, desc0, desc1, mask0, mask1, size, size


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["forward_pair", "forward_pair_adaptive"])
def test_lightglue_bf16_matches_jax(adaptive):
    """The trained tree cut to 3 layers, bf16 in both packages. The two
    round at other places (the JAX CPU program rounds x @ w and + b apart,
    torch's linear once), so the matches are compared as sets of index
    pairs, IoU ≥ 0.9 (measured 63 of 64 alike), and the scores of the
    matches both keep within 0.05 (measured 0.026; float32 agrees to
    5e-4, tests/test_torch_port_models.py). The stop layer is equal, and
    the bf16 run is not the float32 one."""
    tree = tweights.load_tree_npz(Path(__file__).resolve().parents[1]
                                  / "weights" / "lightglue_selftrained.npz")
    tree["transformers"] = tree["transformers"][:3]
    tree["log_assignment"] = tree["log_assignment"][:3]
    tree["token_confidence"] = tree["token_confidence"][:2]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tweights.params_from_jax(tree)
    args = _lg_inputs()
    conf = {"num_heads": 4, "match_threshold": 0.1, "precision": "bf16",
            "depth_confidence": 0.95}
    jfn = functools.partial(
        jlg.forward_pair_adaptive if adaptive else jlg.forward_pair,
        conf=conf)
    want = jax.jit(jax.vmap(lambda *a: jfn(jp, *a)))(
        *(jnp.asarray(a) for a in args))
    tfn = tlg.forward_pair_adaptive if adaptive else tlg.forward_pair
    got = tfn(tp, *args, match_threshold=0.1, device="cpu",
              precision="bf16")
    f32 = tfn(tp, *args, match_threshold=0.1, device="cpu")
    assert got["matching_scores0"].dtype == torch.float32
    gm, wm = got["matches0"].numpy(), np.asarray(want["matches0"])

    def pairs(m):
        return {(i, j, int(k)) for i, row in enumerate(m)
                for j, k in enumerate(row) if k > -1}

    g, w = pairs(gm), pairs(wm)
    assert len(w) > 40 and len(g & w) / len(g | w) >= 0.9
    both = (gm == wm) & (gm > -1)
    assert np.abs(got["matching_scores0"].numpy()
                  - np.asarray(want["matching_scores0"]))[both].max() <= 0.05
    assert not torch.equal(got["matching_scores0"], f32["matching_scores0"])
    if adaptive:
        np.testing.assert_array_equal(got["stop_layer"].numpy(),
                                      np.asarray(want["stop_layer"]))
    with pytest.raises(ValueError, match="precision"):
        tfn(tp, *args, device="cpu", precision="int8")
