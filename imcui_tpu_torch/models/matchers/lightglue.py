"""LightGlue attentional matcher, static or adaptive depth, float32 or
bfloat16.

Counterpart of ``imcui_tpu/models/matchers/lightglue.py``
(``forward_pair``, ``forward_pair_adaptive`` and the ``LightGlue``
``BaseModel``) with pairs as a batch dimension in place of ``vmap``.
Learnable-Fourier rotary positional encoding, L layers of self-attention
(kernel K3 up to 2048 keypoint slots, the blockwise kernel K5 above) and
bidirectional cross-attention (kernel K4), and a sigmoid-matchability
double-softmax assignment head per layer. Padded keypoint slots carry a
key mask and zero mass in the assignment.

``precision="bf16"`` (``forward_pair`` and ``forward_pair_adaptive``, as
the JAX functions' ``conf["precision"]``) runs the transformer stack in
bfloat16: the input projection and the layers' weights and tokens are
bf16, the attention kernels take bf16 (K3, K5 and K4 keep float32 logits,
softmax and sums), and the rotary frequencies come from the float32
weights, cast to bf16 once computed. The token-confidence heads and the
assignment head run in float32 on the float32 weights and the widened
tokens. The ``LightGlue`` BaseModel, like the JAX one, passes no
precision, so it serves float32.
"""

import contextlib

import math
from pathlib import Path

import torch

from ... import resolve_device
from ...ops.attention import (NEG_INF, apply_rotary, bidirectional_attention,
                              flash_attention, fused_attention,
                              learnable_fourier_encoding)
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import apply_precision, full_fp32, gelu, layer_norm, linear
from .nearest_neighbor import pair_masks, pair_sizes

NUM_HEADS = 4
# self-attention over more key slots than this takes the blockwise kernel
FUSED_MAX_KEYS = 2048
WEIGHTS_NPZ = Path(__file__).resolve().parents[3] / "weights" \
    / "lightglue_selftrained.npz"
FEATURE_DIMS = {
    "superpoint": 256,
    "disk": 128,
    "aliked": 128,
    "raco-aliked": 128,
    "sift": 128,
    "xfeat": 64,
}


def _linear_init(generator, din, dout):
    w = torch.randn((dout, din), generator=generator) * (1.0 / din) ** 0.5
    return {"w": w, "b": torch.zeros(dout)}


def _ffn_init(generator, dim):
    return {"0": _linear_init(generator, 2 * dim, 2 * dim),
            "1": {"scale": torch.ones(2 * dim), "bias": torch.zeros(2 * dim)},
            "3": _linear_init(generator, 2 * dim, dim)}


def init_params(generator, n_layers=9, input_dim=256, pos_dim=2):
    """Random init in torch layout, the tree of the JAX ``init_params``
    (256-d, 4 heads; ``input_dim`` the feature's descriptor width,
    ``pos_dim`` 4 with scale and orientation)."""
    dim, head_dim = 256, 64
    params = {
        "input_proj": _linear_init(generator, input_dim, dim),
        "posenc": {"Wr": {"w": torch.randn((head_dim // 2, pos_dim),
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
            .reshape(b * num_heads, n, d // num_heads).contiguous())


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
    attend = fused_attention if n <= FUSED_MAX_KEYS else flash_attention
    ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                 NUM_HEADS)
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


def _bf16(precision):
    """Whether ``precision`` asks for the bfloat16 transformer."""
    if precision in (None, "fp32", "f32", "float32"):
        return False
    if precision in ("bf16", "bfloat16"):
        return True
    raise ValueError(f"LightGlue precision is None, 'fp32' or 'bf16', not "
                     f"{precision!r}")


def _stack_params(params, bf16):
    """The input projection and the layers, cast to bf16 under bf16."""
    if not bf16:
        return params
    return apply_precision({k: params[k] for k in ("input_proj",
                                                   "transformers")}, "bf16")


def _prepare(params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1,
             dev, bf16=False):
    """Inputs on ``dev``; projected descriptors and rotary encodings (in
    bf16 under ``bf16``: the descriptors cast before the projection, the
    encodings after they are computed from the float32 weights).
    Keypoints with 4 columns carry scale and orientation (SIFT mode)."""
    kpts0, kpts1, desc0, desc1, size0, size1 = (
        torch.as_tensor(t, dtype=torch.float32, device=dev)
        for t in (kpts0, kpts1, desc0, desc1, size0, size1))
    mask0, mask1 = (torch.as_tensor(m, device=dev).bool().contiguous()
                    for m in (mask0, mask1))
    tparams = _stack_params(params, bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    x0 = linear(tparams["input_proj"], desc0.to(dtype))
    x1 = linear(tparams["input_proj"], desc1.to(dtype))
    wr = params["posenc"]["Wr"]["w"]

    def encode(kpts, size):
        p = normalize_keypoints(kpts[..., :2], size)
        if wr.shape[1] == 4:
            p = torch.cat([p, kpts[..., 2:4]], -1)
        return tuple(e.to(dtype) for e in learnable_fourier_encoding(p, wr))

    return (tparams, x0, x1, encode(kpts0, size0), encode(kpts1, size1),
            mask0, mask1)


def _joined(enc0, enc1, mask0, mask1):
    """Both views' encodings and masks as one batch, for one self-attention
    launch per layer."""
    return (tuple(torch.cat([a, c]) for a, c in zip(enc0, enc1)),
            torch.cat([mask0, mask1]))


def _layer(layer, x0, x1, enc0, enc1, mask0, mask1, joined=None):
    """One transformer layer: self-attention on each view (one launch for
    both when their shapes agree), then bidirectional cross-attention."""
    sa = layer["self_attn"]
    if x0.shape == x1.shape:
        enc, mask = joined or _joined(enc0, enc1, mask0, mask1)
        x0, x1 = self_block(sa, torch.cat([x0, x1]), enc, mask,
                            NUM_HEADS).split(x0.shape[0])
    else:
        x0 = self_block(sa, x0, enc0, mask0, NUM_HEADS)
        x1 = self_block(sa, x1, enc1, mask1, NUM_HEADS)
    return cross_block(layer["cross_attn"], x0, x1, mask0, mask1, NUM_HEADS)


def forward_pair(params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0,
                 size1, match_threshold=0.1, device="cuda", precision=None):
    """Static-depth forward over a batch of B pairs.

    kpts: (B, N, 2) xy; desc: (B, N, D); mask: (B, N) bool; size: (B, 2)
    (w, h). ``params`` (float32) must already be on ``device``;
    ``precision`` None/"fp32" or "bf16" (the transformer stack in
    bfloat16, the assignment head in float32). Returns matches0 (B, N0)
    int32 (-1 = unmatched) and matching_scores0 (B, N0)."""
    dev = resolve_device(device)
    bf16 = _bf16(precision)
    with contextlib.nullcontext() if bf16 else full_fp32():
        tparams, x0, x1, enc0, enc1, mask0, mask1 = _prepare(
            params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1,
            dev, bf16)
        joined = _joined(enc0, enc1, mask0, mask1) \
            if x0.shape == x1.shape else None
        for layer in tparams["transformers"]:
            x0, x1 = _layer(layer, x0, x1, enc0, enc1, mask0, mask1, joined)
    with full_fp32():
        scores = assignment(params["log_assignment"][-1], x0.float(),
                            x1.float(), mask0, mask1)
        matches0, mscores0 = filter_matches(scores, match_threshold, mask0,
                                            mask1)
    return {"matches0": matches0, "matching_scores0": mscores0}


def forward_pair_adaptive(params, kpts0, kpts1, desc0, desc1, mask0, mask1,
                          size0, size1, match_threshold=0.1,
                          depth_confidence=0.95, device="cuda",
                          precision=None):
    """Adaptive-depth forward over a batch of B pairs.

    After layer i (but the last) a pair exits once more than
    ``depth_confidence`` of its valid tokens pass that layer's confidence
    threshold ``0.8 + 0.1·exp(−4i/L)``, and is read through the
    assignment head of the layer it stopped at. Each pair stops on its
    own: a pair that has exited keeps its state while the others run on
    (only the pairs still active go through a layer). The exit test costs
    one host synchronisation per layer; the confidence heads run in
    float32 on the widened tokens. Arguments as ``forward_pair``;
    additionally returns stop_layer (B,) int32, the number of layers each
    pair ran."""
    n_layers = len(params["transformers"])
    depth_confidence = float(depth_confidence or 0)
    if n_layers < 2 or depth_confidence <= 0:
        return forward_pair(params, kpts0, kpts1, desc0, desc1, mask0, mask1,
                            size0, size1, match_threshold, device, precision)
    dev = resolve_device(device)
    bf16 = _bf16(precision)
    with contextlib.nullcontext() if bf16 else full_fp32():
        tparams, x0, x1, enc0, enc1, mask0, mask1 = _prepare(
            params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1,
            dev, bf16)
        b = x0.shape[0]
        npts = (mask0.sum(-1) + mask1.sum(-1)).clamp_min(1).float()
        stop = [n_layers] * b
        active = list(range(b))
        for i, layer in enumerate(tparams["transformers"]):
            whole = len(active) == b
            sel = None if whole else torch.tensor(active, device=dev)

            def take(t):
                return t if whole else t[sel]

            m0, m1 = take(mask0), take(mask1)
            xa0, xa1 = _layer(layer, take(x0), take(x1),
                              tuple(take(e) for e in enc0),
                              tuple(take(e) for e in enc1), m0, m1)
            if whole:
                x0, x1 = xa0, xa1
            else:
                x0[sel], x1[sel] = xa0, xa1
            if i == n_layers - 1:
                break
            tc = params["token_confidence"][i]["token"]
            th = min(max(0.8 + 0.1 * math.exp(-4.0 * i / n_layers), 0.0), 1.0)
            with full_fp32():
                c0 = torch.sigmoid(linear(tc, xa0.float()))[..., 0]
                c1 = torch.sigmoid(linear(tc, xa1.float()))[..., 0]
            n_unconf = (m0 & (c0 < th)).sum(-1) + (m1 & (c1 < th)).sum(-1)
            ratio = 1.0 - n_unconf.float() / take(npts)
            done = (ratio > depth_confidence).tolist()  # the host waits here
            for j, d in zip(active, done):
                if d:
                    stop[j] = i + 1
            active = [j for j, d in zip(active, done) if not d]
            if not active:
                break
    with full_fp32():
        x0, x1 = x0.float(), x1.float()
        n0, n1 = x0.shape[1], x1.shape[1]
        scores = x0.new_empty((b, n0 + 1, n1 + 1))
        for depth in sorted(set(stop)):
            sel = torch.tensor([j for j in range(b) if stop[j] == depth],
                               device=dev)
            scores[sel] = assignment(params["log_assignment"][depth - 1],
                                     x0[sel], x1[sel], mask0[sel], mask1[sel])
        matches0, mscores0 = filter_matches(scores, match_threshold, mask0,
                                            mask1)
    return {"matches0": matches0, "matching_scores0": mscores0,
            "stop_layer": torch.tensor(stop, dtype=torch.int32, device=dev)}


def load_params(conf, device):
    """The trained tree in ``weights/`` (or ``conf["checkpoint_npz"]``) for
    SuperPoint features at 9 layers; no download is attempted. Any other
    feature or depth, like an absent file, takes random init from a
    generator seeded 0, recorded in ``meta``."""
    n_layers = conf["n_layers"]
    init = init_params(
        torch.Generator().manual_seed(0), n_layers=n_layers,
        input_dim=conf.get("input_dim", conf["descriptor_dim"]),
        pos_dim=4 if conf.get("add_scale_ori") else 2)
    path = conf.get("checkpoint_npz")
    if not path and conf["features"] == "superpoint" and n_layers == 9:
        path = WEIGHTS_NPZ
    return weights.load_or_init(path or None, init, "lightglue", device)


class LightGlue(BaseModel):
    """BaseModel wrapper: keypoints*, descriptors* (and mask*, size* or
    image*, scales*/oris* with ``add_scale_ori``) → matches0,
    matching_scores0 and, at adaptive depth, stop_layer."""

    default_conf = {
        "features": "superpoint",
        "model_name": "superpoint_lightglue.pth",
        "descriptor_dim": 256,
        "num_heads": 4,
        "n_layers": 9,
        "match_threshold": 0.2,
        "add_scale_ori": False,
        # depth_confidence drives the early exit (forward_pair_adaptive);
        # width_confidence is accepted for API parity and is a no-op
        "depth_confidence": 0.95,
        "width_confidence": 0.99,
        "flash": True,
    }
    required_inputs = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
    ]

    def _init(self, conf):
        if conf["num_heads"] != NUM_HEADS:
            raise ValueError(f"LightGlue runs {NUM_HEADS} heads, not "
                             f"{conf['num_heads']}")
        if conf["features"] in FEATURE_DIMS:
            conf.setdefault("input_dim", FEATURE_DIMS[conf["features"]])
        self.params, self.meta = load_params(conf, self.device)

    def _forward(self, data):
        dev = self.device

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        kpts0, kpts1 = f32(data["keypoints0"]), f32(data["keypoints1"])
        if self.conf["add_scale_ori"]:
            kpts0 = torch.cat([kpts0[..., :2], f32(data["scales0"])[..., None],
                               f32(data["oris0"])[..., None]], -1)
            kpts1 = torch.cat([kpts1[..., :2], f32(data["scales1"])[..., None],
                               f32(data["oris1"])[..., None]], -1)
        desc0, desc1 = f32(data["descriptors0"]), f32(data["descriptors1"])
        if desc0.shape[1] != kpts0.shape[1]:  # (B, D, N) → (B, N, D)
            desc0 = desc0.transpose(1, 2)
        if desc1.shape[1] != kpts1.shape[1]:
            desc1 = desc1.transpose(1, 2)
        args = (self.params, kpts0, kpts1, desc0, desc1,
                *pair_masks(data, kpts0.shape[0], kpts0.shape[1],
                            kpts1.shape[1], dev),
                *pair_sizes(data, kpts0, kpts1))
        depth_confidence = float(self.conf.get("depth_confidence") or 0)
        if depth_confidence:
            return forward_pair_adaptive(
                *args, match_threshold=float(self.conf["match_threshold"]),
                depth_confidence=depth_confidence, device=dev)
        return forward_pair(
            *args, match_threshold=float(self.conf["match_threshold"]),
            device=dev)
