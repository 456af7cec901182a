"""Attention primitives for LightGlue and for the ViT backbones (DINOv2,
the CroCo-style blocks), with kernels K3 and K4 (``csrc/attention.cu``,
float32 and bfloat16),
K5 (entry ``csrc/flash_attention.cu``: float32 on K3's tile, bf16 on
K14's body) and K14 (``csrc/qtiled_attention.cu``).
Counterpart of ``imcui_tpu/ops/attention.py`` and of the q-tiled kernel of
``tools/try_vit_attn.py``. ``mha_auto`` is the ViTs' entry: unmasked
attention, sent to one of the kernels by type and shape.

Masks are the finite ``NEG_INF = -1e9`` on logits, never ``-inf``: a
query whose keys are all masked then attends uniformly (the mean of V),
as ``jax.nn.softmax`` does on a -1e9 row.

Layouts: a head-sequence tensor is (S, N, Dh) with S = batch · heads,
the batch index of head-sequence ``s`` being ``s // heads``; key masks
are (batch, N) bool.
"""

import ctypes

import torch

from . import _build

NEG_INF = -1e9


def mha(q, k, v, mask_k=None, bias=None):
    """Masked multi-head attention. q: (..., Nq, Dh), k/v: (..., Nk, Dh);
    mask_k: bool broadcastable to (..., 1, Nk); bias: an additive term of
    the logits broadcastable to (..., Nq, Nk) (IMP's epipolar gate), added
    before the mask, as in the JAX function."""
    dh = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)) / (dh ** 0.5)
    if bias is not None:
        logits = logits + bias
    if mask_k is not None:
        logits = torch.where(mask_k, logits, logits.new_tensor(NEG_INF))
    return torch.matmul(torch.softmax(logits, -1), v)


def rotate_half_pairs(x):
    """Rotate interleaved pairs (x1, x2) → (-x2, x1) over the last dim."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], -1).flatten(-2)


def apply_rotary(x, encoding):
    """x: (..., N, D); encoding: (cos, sin), each broadcastable to x."""
    cos, sin = encoding
    return x * cos + rotate_half_pairs(x) * sin


def learnable_fourier_encoding(kpts, wr, gamma=1.0):
    """LightGlue's learnable Fourier positional encoding → rotary
    (cos, sin). kpts: (..., N, 2); wr: (F, 2) torch-layout projection with
    F = head_dim / 2. Returns cos, sin each (..., N, 2F), every frequency
    repeated for its (x1, x2) pair."""
    projected = torch.matmul(kpts, (wr / gamma).t())
    return (torch.cos(projected).repeat_interleave(2, -1),
            torch.sin(projected).repeat_interleave(2, -1))


def _head_mask(mask, s, n, device):
    if mask is None:
        return torch.ones((s, n), dtype=torch.bool, device=device)
    return mask


def _mask_ptr(mask):
    """K3's, K4's and K5's key mask for the kernel: a null pointer when
    every key is valid, so an unmasked call allocates nothing."""
    return None if mask is None else _build.ptr(mask)


def attention_plan(s, n, m=None):
    """The launch K3 (``m`` None) or K4 takes on the current card for S
    head-sequences of N (and M) rows: query-tile height, blocks, blocks an
    SM holds at that height, SMs, and the rounds that makes."""
    out = (ctypes.c_int * 4)()
    code = _build.library().attention_f32_plan(
        s, n, n if m is None else m, int(m is not None),
        ctypes.cast(out, ctypes.c_void_p))
    _build.check(code, "attention_f32_plan")
    tile, blocks, per_sm, sms = out
    return {"query_tile": tile, "blocks": blocks, "blocks_per_sm": per_sm,
            "sms": sms, "rounds": blocks / (per_sm * sms)}


def _readout(logits, v, dim=-1):
    """Softmax of float32 ``logits`` over ``dim``, rounded once to v's
    dtype, read against v in float32 and rounded once to v's dtype (the
    JAX kernels' ``p.astype(q.dtype)``); ``dim=-2`` reads v by columns."""
    p = torch.softmax(logits, dim).to(v.dtype).float()
    if dim == -2:
        p = p.transpose(-1, -2)
    return torch.matmul(p, v.float()).to(v.dtype)


def fused_attention_plain(q, k, v, mask, heads):
    """Plain version of K3 (``_fused_attn_xla``). q/k/v: (S, N, Dh)
    float32 or bfloat16; mask: (S // heads, N) bool key validity. In
    bfloat16 the logits, the softmax and the P V sums are float32, P and
    the output are rounded once to bf16."""
    m = mask.repeat_interleave(heads, 0)[:, None, :]
    if q.dtype != torch.bfloat16:  # float32 (and float64 references)
        return mha(q, k, v, m)
    dh = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (
        dh ** 0.5)
    return _readout(torch.where(m, logits, logits.new_tensor(NEG_INF)), v)


def _k34_dtype(name, t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16, got {t.dtype}")
    return t.dtype


def fused_attention(q, k, v, mask, heads):
    """Kernel K3 on CUDA tensors; the plain version on CPU tensors.
    Self-attention over (S, N, 64) float32 or bfloat16 head-sequences
    (the output in their type); mask (S/heads, N) bool, or None for all
    valid."""
    s, n, dh = q.shape
    dtype = _k34_dtype("fused_attention", q)
    if q.device.type == "cpu":
        return fused_attention_plain(
            q, k, v, _head_mask(mask, s // heads, n, q.device), heads)
    if dh != 64 or s % heads:
        raise ValueError(f"fused_attention takes Dh = 64 and S divisible by "
                         f"heads; got {tuple(q.shape)}, heads {heads} "
                         f"(unmasked ViT attention of other shapes goes "
                         f"through mha_auto, which pads nothing and picks "
                         f"the kernel by shape)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, dtype, (s, n, 64))
    if mask is not None:
        _build.require(mask, "mask", torch.bool, (s // heads, n))
    out = torch.empty_like(q)
    lib = _build.library()
    fn = lib.fused_attention_f32 if dtype == torch.float32 else \
        lib.fused_attention_bf16
    code = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _mask_ptr(mask),
              _build.ptr(out), s, n, heads, _build.stream_of(q))
    _build.check(code, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def bidirectional_attention_plain(a0, a1, v0, v1, mask0, mask1, heads):
    """Plain version of K4 (``_bidir_xla``): one S = A0·A1ᵀ/√dh per head,
    a row softmax masked by mask1 reads V1 and a column softmax masked by
    mask0 reads V0. a0/v0: (S, N, Dh), a1/v1: (S, M, Dh), float32 or
    bfloat16 (float32 logits, softmax and sums; P and the outputs rounded
    once to bf16); masks (S/heads, N) and (S/heads, M) bool."""
    dh = a0.shape[-1]
    bf16 = a0.dtype == torch.bfloat16
    if bf16:
        a0, a1 = a0.float(), a1.float()
    logits = torch.matmul(a0, a1.transpose(-1, -2)) / (dh ** 0.5)
    neg = logits.new_tensor(NEG_INF)
    mk0 = mask0.repeat_interleave(heads, 0)[:, :, None]
    mk1 = mask1.repeat_interleave(heads, 0)[:, None, :]
    l01, l10 = torch.where(mk1, logits, neg), torch.where(mk0, logits, neg)
    if bf16:
        return _readout(l01, v1), _readout(l10, v0, -2)
    att01 = torch.softmax(l01, -1)
    att10 = torch.softmax(l10, -2)
    return (torch.matmul(att01, v1),
            torch.matmul(att10.transpose(-1, -2), v0))


def bidirectional_attention(a0, a1, v0, v1, mask0, mask1, heads):
    """Kernel K4 on CUDA tensors; the plain version on CPU tensors.
    float32 or bfloat16; returns (O0 (S, N, Dh), O1 (S, M, Dh)) in the
    inputs' type; masks may be None."""
    s, n, dh = a0.shape
    m = a1.shape[1]
    dtype = _k34_dtype("bidirectional_attention", a0)
    if a0.device.type == "cpu":
        return bidirectional_attention_plain(
            a0, a1, v0, v1, _head_mask(mask0, s // heads, n, a0.device),
            _head_mask(mask1, s // heads, m, a0.device), heads)
    if dh != 64 or s % heads:
        raise ValueError(f"bidirectional_attention takes Dh = 64 and S "
                         f"divisible by heads; got {tuple(a0.shape)}")
    for name, t, rows in (("a0", a0, n), ("a1", a1, m), ("v0", v0, n),
                          ("v1", v1, m)):
        _build.require(t, name, dtype, (s, rows, 64))
    for name, t, rows in (("mask0", mask0, n), ("mask1", mask1, m)):
        if t is not None:
            _build.require(t, name, torch.bool, (s // heads, rows))
    o0 = torch.empty_like(a0)
    o1 = torch.empty_like(a1)
    lib = _build.library()
    fn = lib.bidir_attention_f32 if dtype == torch.float32 else \
        lib.bidir_attention_bf16
    code = fn(_build.ptr(a0), _build.ptr(a1), _build.ptr(v0), _build.ptr(v1),
              _mask_ptr(mask0), _mask_ptr(mask1), _build.ptr(o0),
              _build.ptr(o1), s, n, m, heads, _build.stream_of(a0))
    _build.check(code, "bidirectional_attention")
    bidirectional_attention.launches += 1
    return o0, o1


bidirectional_attention.launches = 0


def flash_attention_plain(q, k, v, mask, heads):
    """Plain version of K5: ``mha`` with the key mask, computed in float32
    and returned in ``q``'s dtype. q: (S, Nq, Dh); k/v: (S, Nk, Dh); mask:
    (S // heads, Nk) bool key validity."""
    m = mask.repeat_interleave(heads, 0)[:, None, :]
    return mha(q.float(), k.float(), v.float(), m).to(q.dtype)


def flash_attention(q, k, v, mask, heads):
    """Kernel K5 on CUDA tensors; the plain version on CPU tensors.
    Blockwise attention of (S, Nq, Dh) queries over (S, Nk, Dh) keys and
    values, Dh 64 or 128, float32 or bfloat16 (float32 inside, the output
    in the input type); mask (S/heads, Nk) bool, or None for all valid."""
    s, nq, dh = q.shape
    nk = k.shape[1]
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, _head_mask(mask, s // heads, nk, q.device), heads)
    if dh not in (64, 128) or s % heads or q.dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise ValueError(f"flash_attention takes Dh 64 or 128, float32 or "
                         f"bfloat16, and S divisible by heads; got "
                         f"{tuple(q.shape)} {q.dtype}, heads {heads}")
    _build.require(q, "q", q.dtype, (s, nq, dh))
    _build.require(k, "k", q.dtype, (s, nk, dh))
    _build.require(v, "v", q.dtype, (s, nk, dh))
    if mask is not None:
        _build.require(mask, "mask", torch.bool, (s // heads, nk))
    out = torch.empty_like(q)
    code = _build.library().flash_attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _mask_ptr(mask),
        _build.ptr(out), s, nq, nk, heads, dh,
        int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_plan(s, nq, dh, dtype):
    """The launch K5 takes on the current card for S head-sequences of Nq
    queries at head dim ``dh`` in ``dtype``: query rows a block, blocks,
    blocks an SM holds, SMs, and the rounds that makes."""
    out = (ctypes.c_int * 4)()
    code = _build.library().flash_attention_plan(
        s, nq, dh, int(dtype == torch.bfloat16),
        ctypes.cast(out, ctypes.c_void_p))
    _build.check(code, "flash_attention_plan")
    rows, blocks, per_sm, sms = out
    return {"query_tile": rows, "blocks": blocks, "blocks_per_sm": per_sm,
            "sms": sms, "rounds": blocks / (per_sm * sms)}


def qtiled_attention_plain(q, k, v):
    """Plain version of K14: unmasked softmax attention of bfloat16
    (H, Nq, 64) queries over (H, Nk, 64) keys and values, one pass over
    all keys. Inputs are widened to float32; logits, the row maximum
    (never below -1e9), the exponentials, their sum (never below 1e-20) and
    the readout are float32; the output is rounded once to bfloat16."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (dh ** 0.5)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    out = torch.matmul(p, v.float()) / p.sum(-1, keepdim=True).clamp_min(
        1e-20)
    return out.to(q.dtype)


def qtiled_attention(q, k, v):
    """Kernel K14 on CUDA tensors; the plain version on CPU tensors.
    q: (H, Nq, 64), k/v: (H, Nk, 64), bfloat16, contiguous; Nq and Nk are
    independent and need not be multiples of anything. Returns (H, Nq, 64)
    bfloat16."""
    h, nq, dh = q.shape
    nk = k.shape[1]
    if q.device.type == "cpu":
        return qtiled_attention_plain(q, k, v)
    if dh != 64 or nk > QTILED_MAX_KEYS or nk < 1:
        raise ValueError(f"qtiled_attention takes Dh = 64 and 1 to "
                         f"{QTILED_MAX_KEYS} keys (mha_auto's route to it); "
                         f"got {tuple(q.shape)} over {tuple(k.shape)}")
    _build.require(q, "q", torch.bfloat16, (h, nq, 64))
    _build.require(k, "k", torch.bfloat16, (h, nk, 64))
    _build.require(v, "v", torch.bfloat16, (h, nk, 64))
    out = torch.empty_like(q)
    code = _build.library().qtiled_attention_bf16(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), h, nq,
        nk, _build.stream_of(q))
    _build.check(code, "qtiled_attention")
    qtiled_attention.launches += 1
    return out


qtiled_attention.launches = 0
# the most keys mha_auto sends to K14 (the JAX gate's bound; the kernel's
# online softmax itself has no limit on the keys)
QTILED_MAX_KEYS = 2048


def qtiled_plan(h, nq, nk):
    """The launch K14 takes on the current card for H heads of Nq queries
    over Nk keys: query rows a CTA (one consumer warpgroup), CTAs, CTAs an
    SM holds, SMs, the rounds that makes, and the query rows the busiest SM
    walks."""
    out = (ctypes.c_int * 4)()
    code = _build.library().qtiled_attention_plan(
        h, nq, nk, ctypes.cast(out, ctypes.c_void_p))
    _build.check(code, "qtiled_attention_plan")
    rows, ctas, per_sm, sms = out
    return {"rows_per_cta": rows, "ctas": ctas, "ctas_per_sm": per_sm,
            "sms": sms, "rounds": ctas / (per_sm * sms),
            "busiest_sm_rows": -(-ctas // sms) * rows}


def mha_wide(q, k, v, dtype=None):
    """Plain unmasked attention with float32 logits and sums whatever the
    inputs' dtype: the weights are rounded to ``dtype`` (q's by default)
    before the readout and the result is in ``dtype`` (the JAX package's
    ``mha`` on bf16; its ViT blocks round to their tokens' dtype, which
    RoPE's float32 q and k do not carry)."""
    dtype = q.dtype if dtype is None else dtype
    dh = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (
        dh ** 0.5)
    attn = torch.softmax(logits, -1).to(dtype)
    return torch.matmul(attn.float(), v.float()).to(dtype)


def mha_auto(q, k, v):
    """Unmasked multi-head attention for ViT blocks. q: (H, Nq, Dh),
    k/v: (H, Nk, Dh), contiguous; returns (H, Nq, Dh) in q's dtype.

    The JAX function pads both token axes to a multiple of 128 and masks
    the padded keys before its kernel; that is the TPU's layout, not the
    contract, and nothing is padded here. The route, by type and shape
    (each wrapper counts its launches, and uses its plain version only for
    CPU tensors):

    - bfloat16, Dh = 64, Nk <= 2048: K14 ``qtiled_attention``;
    - float32, Dh = 64, Nq = Nk <= 2048: K3 ``fused_attention`` without a
      mask;
    - any other float32 or bfloat16 shape with Dh = 64: K5
      ``flash_attention`` without a mask;
    - any other Dh: the plain ``mha_wide``, as the JAX gate ``dh % 64``
      does.
    """
    h, nq, dh = q.shape
    nk = k.shape[1]
    if dh != 64 or q.dtype not in (torch.float32, torch.bfloat16):
        return mha_wide(q, k, v)
    if q.dtype == torch.bfloat16 and nk <= QTILED_MAX_KEYS:
        return qtiled_attention(q, k, v)
    if q.dtype == torch.float32 and nq == nk and nk <= 2048:
        return fused_attention(q, k, v, None, h)
    return flash_attention(q, k, v, None, h)
