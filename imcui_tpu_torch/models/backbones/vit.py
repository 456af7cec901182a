"""Vision Transformer building blocks: a pre-LN encoder block and the
CroCo-style decoder block with cross-attention. Counterpart of
``imcui_tpu/models/backbones/vit.py``. RoMa's match decoder runs the
encoder block; the pointmap matchers (DUSt3R, MASt3R) use the rest.

Tokens are (N, dim) for one image; heads are split to (heads, N, Dh).
"""

import torch

from ...ops import attention as att_ops
from ..layers import (conv2d, gelu, init_conv, init_layer_norm, init_linear,
                      layer_norm, linear)

# Which attention bfloat16 tokens take. "xla": the plain softmax attention
# written out below (float32 logits); "fused": ``ops.attention.mha_auto``
# (kernels K14/K3/K5 by shape); "flash": the blockwise kernel K5 (the JAX
# package calls a library kernel of jax.experimental under this name).
# float32 tokens always take the plain attention, as in the JAX package.
# Deviation: blocks with RoPE (DUSt3R, MASt3R) rotate q and k in float32,
# which in the JAX package keeps them from every kernel route; with
# "fused" or "flash" the port rounds them back to bfloat16 and launches.
ATTN_IMPL = "xla"


def init_mlp(gen, dim, hidden):
    return {"fc1": init_linear(gen, dim, hidden),
            "fc2": init_linear(gen, hidden, dim)}


def mlp_apply(p, x):
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def init_attention(gen, dim):
    """Self-attention with one qkv projection."""
    return {"qkv": init_linear(gen, dim, 3 * dim),
            "proj": init_linear(gen, dim, dim)}


def init_cross_attention(gen, dim):
    """Cross-attention with separate q/k/v projections (CroCo's naming)."""
    return {"projq": init_linear(gen, dim, dim),
            "projk": init_linear(gen, dim, dim),
            "projv": init_linear(gen, dim, dim),
            "proj": init_linear(gen, dim, dim)}


def _rope_1d(t, pos, base):
    """NeoX-style rotary embedding on one coordinate.
    t: (heads, n, d); pos: (n,) positions."""
    d = t.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=t.device) / d))
    freqs = pos.float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    t1, t2 = t.chunk(2, -1)
    rotated = torch.cat([-t2, t1], -1)
    return t * cos[None] + rotated * sin[None]


def rope_2d(t, pos, base=100.0):
    """CroCo's RoPE2D: the head dim is halved into a y-half and an x-half,
    each rotated by its grid coordinate. t: (heads, n, d); pos: (n, 2)
    integer (y, x) patch coordinates."""
    ty, tx = t.chunk(2, -1)
    return torch.cat([_rope_1d(ty, pos[:, 0], base),
                      _rope_1d(tx, pos[:, 1], base)], -1)


def attention_apply(p, x, num_heads, context=None, pos=None, kpos=None,
                    rope_base=None):
    """Self-attention when ``context`` is None, else cross-attention (q
    from x, k/v from context). With ``rope_base``, q and k are rotated at
    the patch positions ``pos`` (``kpos`` for the context)."""
    n, d = x.shape
    dh = d // num_heads
    if context is None:
        qkv = linear(p["qkv"], x).reshape(n, 3, num_heads, dh)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        kpos = pos
    else:
        m = context.shape[0]
        q = linear(p["projq"], x).reshape(n, num_heads, dh)
        k = linear(p["projk"], context).reshape(m, num_heads, dh)
        v = linear(p["projv"], context).reshape(m, num_heads, dh)
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))
    if rope_base is not None and pos is not None:
        q = rope_2d(q, pos, rope_base)
        k = rope_2d(k, kpos if kpos is not None else pos, rope_base)
        if ATTN_IMPL != "xla" and v.dtype == torch.bfloat16:
            # RoPE's float32 cos and sin promote bf16 q and k to float32,
            # so in the JAX package no RoPE block reaches a kernel under
            # any ATTN_IMPL; here a kernel route takes them back to bf16
            q, k = q.to(v.dtype), k.to(v.dtype)
    if ATTN_IMPL != "xla" and q.dtype == torch.bfloat16:
        q, k, v = (t.contiguous() for t in (q, k, v))
        if ATTN_IMPL == "flash":
            out = att_ops.flash_attention(q, k, v, None, num_heads)
        else:
            out = att_ops.mha_auto(q, k, v)
    else:
        out = att_ops.mha_wide(q, k, v, x.dtype)
    return linear(p["proj"], out.transpose(0, 1).reshape(n, d))


def init_encoder_block(gen, dim, mlp_ratio=4):
    return {"norm1": init_layer_norm(dim),
            "attn": init_attention(gen, dim),
            "norm2": init_layer_norm(dim),
            "mlp": init_mlp(gen, dim, dim * mlp_ratio)}


def encoder_block_apply(p, x, num_heads, pos=None, rope_base=None):
    x = x + attention_apply(p["attn"], layer_norm(p["norm1"], x), num_heads,
                            pos=pos, rope_base=rope_base)
    return x + mlp_apply(p["mlp"], layer_norm(p["norm2"], x))


def init_decoder_block(gen, dim, mlp_ratio=4):
    """CroCo decoder block: self-attention, cross-attention, MLP."""
    return {"norm1": init_layer_norm(dim),
            "attn": init_attention(gen, dim),
            "norm2": init_layer_norm(dim),
            "cross_attn": init_cross_attention(gen, dim),
            "norm3": init_layer_norm(dim),
            "mlp": init_mlp(gen, dim, dim * mlp_ratio),
            "norm_y": init_layer_norm(dim)}


def decoder_block_apply(p, x, y, num_heads, pos=None, kpos=None,
                        rope_base=None):
    """x attends to itself, then to the other view's tokens y."""
    x = x + attention_apply(p["attn"], layer_norm(p["norm1"], x), num_heads,
                            pos=pos, rope_base=rope_base)
    x = x + attention_apply(
        p["cross_attn"], layer_norm(p["norm2"], x), num_heads,
        context=layer_norm(p["norm_y"], y), pos=pos, kpos=kpos,
        rope_base=rope_base)
    return x + mlp_apply(p["mlp"], layer_norm(p["norm3"], x))


def init_patch_embed(gen, patch, cin, dim):
    return {"proj": init_conv(gen, patch, patch, cin, dim)}


def patch_embed_apply(p, image, patch):
    """image: (C, H, W) → tokens (H/p · W/p, dim), row-major, and (hp, wp)."""
    x = conv2d(p["proj"], image[None], stride=patch, padding="VALID")[0]
    d, hp, wp = x.shape
    return x.reshape(d, hp * wp).t(), (hp, wp)


def grid_positions(hp, wp, device="cpu"):
    """(hp·wp, 2) integer (y, x) patch coordinates, row-major."""
    gy, gx = torch.meshgrid(torch.arange(hp, device=device),
                            torch.arange(wp, device=device), indexing="ij")
    return torch.stack([gy.reshape(-1), gx.reshape(-1)], -1)


def sincos_pos_embed(hp, wp, dim, device="cpu"):
    """2-D sin-cos position embedding, (hp·wp, dim): the first half of the
    channels encodes y, the second x."""
    def embed_1d(n, d):
        pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
        omega = torch.arange(d // 2, dtype=torch.float32, device=device) / (
            d // 2)
        out = pos * (1.0 / (10000.0 ** omega))[None]
        return torch.cat([torch.sin(out), torch.cos(out)], -1)

    ey = embed_1d(hp, dim // 2)
    ex = embed_1d(wp, dim // 2)
    full = torch.cat([ey[:, None, :].expand(hp, wp, -1),
                      ex[None, :, :].expand(hp, wp, -1)], -1)
    return full.reshape(hp * wp, dim)
