"""LightGlue attentional matcher, static depth, float32.

Counterpart of ``imcui_tpu/models/matchers/lightglue.py:forward_pair``
with pairs as a batch dimension in place of ``vmap``. Learnable-Fourier
rotary positional encoding, L layers of self-attention (kernel K3) and
bidirectional cross-attention (kernel K4), and the sigmoid-matchability
double-softmax assignment head of the last layer. Padded keypoint slots
carry a key mask and zero mass in the assignment.
"""

import torch

from ... import resolve_device
from ...ops.attention import (NEG_INF, apply_rotary, bidirectional_attention,
                              fused_attention, learnable_fourier_encoding)
from ..layers import full_fp32, gelu, layer_norm, linear

NUM_HEADS = 4


def _linear_init(generator, din, dout):
    w = torch.randn((dout, din), generator=generator) * (1.0 / din) ** 0.5
    return {"w": w, "b": torch.zeros(dout)}


def _ffn_init(generator, dim):
    return {"0": _linear_init(generator, 2 * dim, 2 * dim),
            "1": {"scale": torch.ones(2 * dim), "bias": torch.zeros(2 * dim)},
            "3": _linear_init(generator, 2 * dim, dim)}


def init_params(generator, n_layers=9):
    """Random init in torch layout, the tree of the JAX ``init_params``
    for SuperPoint features (256-d, 4 heads)."""
    dim, head_dim = 256, 64
    params = {
        "input_proj": _linear_init(generator, dim, dim),
        "posenc": {"Wr": {"w": torch.randn((head_dim // 2, 2),
                                           generator=generator)}},
        "transformers": [],
        "log_assignment": [],
        "token_confidence": [],
    }
    for i in range(n_layers):
        params["transformers"].append({
            "self_attn": {"Wqkv": _linear_init(generator, dim, 3 * dim),
                          "out_proj": _linear_init(generator, dim, dim),
                          "ffn": _ffn_init(generator, dim)},
            "cross_attn": {"to_qk": _linear_init(generator, dim, dim),
                           "to_v": _linear_init(generator, dim, dim),
                           "to_out": _linear_init(generator, dim, dim),
                           "ffn": _ffn_init(generator, dim)},
        })
        params["log_assignment"].append({
            "matchability": _linear_init(generator, dim, 1),
            "final_proj": _linear_init(generator, dim, dim)})
        if i < n_layers - 1:
            params["token_confidence"].append(
                {"token": _linear_init(generator, dim, 1)})
    return params


def normalize_keypoints(kpts, size_wh):
    """Centre and scale keypoints (B, N, 2) into ~[-1, 1] by their image
    size (B, 2) (w, h)."""
    size = size_wh.float()
    shift = size / 2.0
    scale = size.amax(-1, keepdim=True) / 2.0
    return (kpts - shift[:, None]) / scale[:, None]


def _heads(x, num_heads):
    """(B, N, D) → (B·H, N, Dh), contiguous."""
    b, n, d = x.shape
    return (x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)
            .reshape(b * num_heads, n, d // num_heads))


def _merge(x, b):
    """(B·H, N, Dh) → (B, N, H·Dh)."""
    s, n, dh = x.shape
    return x.reshape(b, s // b, n, dh).transpose(1, 2).reshape(b, n, -1)


def ffn_apply(p, x, message):
    h = linear(p["0"], torch.cat([x, message], -1))
    return linear(p["3"], gelu(layer_norm(p["1"], h)))


def self_block(p, x, enc, mask, num_heads):
    """x: (B, N, D); enc: (cos, sin) each (B, N, Dh); mask: (B, N)."""
    b, n, d = x.shape
    dh = d // num_heads
    # torch packing: unflatten(-1, (heads, dh, 3)), the q/k/v triple innermost
    qkv = linear(p["Wqkv"], x).reshape(b, n, num_heads, dh, 3)
    qkv = qkv.permute(4, 0, 2, 1, 3)  # 3, B, H, N, Dh
    cos, sin = (e[:, None] for e in enc)
    q = apply_rotary(qkv[0], (cos, sin)).reshape(b * num_heads, n, dh)
    k = apply_rotary(qkv[1], (cos, sin)).reshape(b * num_heads, n, dh)
    v = qkv[2].reshape(b * num_heads, n, dh)
    ctx = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          mask, NUM_HEADS)
    message = linear(p["out_proj"], _merge(ctx, b))
    return x + ffn_apply(p["ffn"], x, message)


def cross_block(p, x0, x1, mask0, mask1, num_heads):
    b = x0.shape[0]
    qk0 = _heads(linear(p["to_qk"], x0), NUM_HEADS)
    qk1 = _heads(linear(p["to_qk"], x1), NUM_HEADS)
    v0 = _heads(linear(p["to_v"], x0), NUM_HEADS)
    v1 = _heads(linear(p["to_v"], x1), NUM_HEADS)
    m0, m1 = bidirectional_attention(qk0, qk1, v0, v1, mask0, mask1,
                                     NUM_HEADS)
    m0 = linear(p["to_out"], _merge(m0, b))
    m1 = linear(p["to_out"], _merge(m1, b))
    return (x0 + ffn_apply(p["ffn"], x0, m0),
            x1 + ffn_apply(p["ffn"], x1, m1))


def sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1):
    """log P = logsoftmax_rows + logsoftmax_cols + logsigmoid(z0) +
    logsigmoid(z1), with unmatchable mass on the dustbins.
    sim: (B, N, M) → (B, N+1, M+1)."""
    b, m, n = sim.shape
    logsig = torch.nn.functional.logsigmoid
    sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim,
                      sim.new_tensor(NEG_INF))
    cert = logsig(z0)[:, :, None] + logsig(z1)[:, None, :]
    scores = sim.new_zeros((b, m + 1, n + 1))
    scores[:, :m, :n] = (torch.log_softmax(sim, 2) + torch.log_softmax(sim, 1)
                         + cert)
    scores[:, :m, n] = logsig(-z0)
    scores[:, m, :n] = logsig(-z1)
    return scores


def assignment(p, desc0, desc1, mask0, mask1):
    d = desc0.shape[-1]
    mdesc0 = linear(p["final_proj"], desc0) / d ** 0.25
    mdesc1 = linear(p["final_proj"], desc1) / d ** 0.25
    sim = torch.matmul(mdesc0, mdesc1.transpose(1, 2))
    z0 = linear(p["matchability"], desc0)[..., 0]
    z1 = linear(p["matchability"], desc1)[..., 0]
    return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1)


def filter_matches(scores, threshold, mask0, mask1):
    """Mutual-argmax decoding over exp(scores); argmax ties go to the
    first index, as ``jnp.argmax``."""
    probs = torch.exp(scores[:, :-1, :-1])
    probs = torch.where(mask0[:, :, None] & mask1[:, None, :], probs,
                        torch.zeros_like(probs))
    idx0 = probs.argmax(2)
    idx1 = probs.argmax(1)
    ar = torch.arange(probs.shape[1], device=probs.device)
    mutual = ar[None] == torch.gather(idx1, 1, idx0)
    mscores = probs.amax(2)
    valid = mutual & (mscores > threshold) & mask0
    matches0 = torch.where(valid, idx0, torch.full_like(idx0, -1))
    return matches0.to(torch.int32), torch.where(valid, mscores,
                                                 torch.zeros_like(mscores))


def forward_pair(params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0,
                 size1, match_threshold=0.1, device="cuda"):
    """Static-depth forward over a batch of B pairs, float32.

    kpts: (B, N, 2) xy; desc: (B, N, D); mask: (B, N) bool; size: (B, 2)
    (w, h). ``params`` must already be on ``device``. Returns matches0
    (B, N0) int32 (-1 = unmatched) and matching_scores0 (B, N0)."""
    dev = resolve_device(device)
    kpts0, kpts1, desc0, desc1, size0, size1 = (
        torch.as_tensor(t, dtype=torch.float32, device=dev)
        for t in (kpts0, kpts1, desc0, desc1, size0, size1))
    mask0, mask1 = (torch.as_tensor(m, device=dev).bool().contiguous()
                    for m in (mask0, mask1))
    b = kpts0.shape[0]
    with full_fp32():
        x0 = linear(params["input_proj"], desc0)
        x1 = linear(params["input_proj"], desc1)
        wr = params["posenc"]["Wr"]["w"]
        enc0 = learnable_fourier_encoding(normalize_keypoints(kpts0, size0), wr)
        enc1 = learnable_fourier_encoding(normalize_keypoints(kpts1, size1), wr)
        same = x0.shape == x1.shape
        if same:  # both views' self-attention in one launch per layer
            enc = tuple(torch.cat([a, c]) for a, c in zip(enc0, enc1))
            mask = torch.cat([mask0, mask1])
        for layer in params["transformers"]:
            sa = layer["self_attn"]
            if same:
                x0, x1 = self_block(sa, torch.cat([x0, x1]), enc, mask,
                                    NUM_HEADS).split(b)
            else:
                x0 = self_block(sa, x0, enc0, mask0, NUM_HEADS)
                x1 = self_block(sa, x1, enc1, mask1, NUM_HEADS)
            x0, x1 = cross_block(layer["cross_attn"], x0, x1, mask0, mask1,
                                 NUM_HEADS)
        scores = assignment(params["log_assignment"][-1], x0, x1, mask0,
                            mask1)
        matches0, mscores0 = filter_matches(scores, match_threshold, mask0,
                                            mask1)
    return {"matches0": matches0, "matching_scores0": mscores0}
