"""LoFTR: detector-free coarse-to-fine matching. Counterpart of
``imcui_tpu/models/matchers/loftr.py``: a ResNet-FPN backbone (features at
1/8 and 1/2), a sinusoidal position encoding, a coarse transformer of
alternating self and cross (elu + 1) linear-attention layers, the dual-
softmax coarse assignment cut to a fixed number of match slots, and a
5 × 5-window fine refinement whose spatial expectation gives the sub-pixel
position in image 1.

The parts here are shared by the LoFTR family (``eloftr``, ``se2loftr``,
``xoftr``, ``aspanformer``, ``topicfm``, ``matchformer``) and by RoMa's
``fpn-corr`` backbone, as in the JAX package.

Layouts. Images and feature maps are NCHW; coarse tokens are ``(N, d)``
row-major over the (h, w) grid (the JAX package's NHWC flattening, so a
map is permuted before it is flattened); fine windows are ``(M, 25, d)``.
A pair is one call (``forward_pair``); a batch of pairs is a loop.

Precision. The parameter tree's dtype is the compute dtype: ``precision``
"bf16" (the default) casts it, anything else ("fp32" included) keeps
float32, as in the JAX package. Softmax, expectation and geometry
statistics are float32. Two rules of rounding are the JAX package's and
are kept on purpose:

- coarse (``coarse_match``): the features are divided by √d in their own
  dtype, then multiplied in float32 (bf16 operands are widened first;
  their products are exact in float32);
- fine (``fine_match``): the product of a window with its centre token is
  taken in the tree's dtype and rounded there, then widened for the
  softmax at temperature 0.1.

The linear attention likewise sums its three products in float32 and
rounds its output to the value dtype once.

Weights: ``conf["checkpoint_npz"]``, else the tree trained in the
repository (``weights/loftr_selftrained.npz``), else a seeded random
initialisation; ``meta`` says which (``utils/weights.py::load_trained``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (apply_precision, batch_norm_inference, conv2d,
                      full_fp32, init_bn, init_conv, init_layer_norm,
                      init_linear, layer_norm, leaky_relu, linear, relu)

D_COARSE = 256
D_FINE = 128
FINE_WINDOW = 5
TRAINED_NPZ = "loftr_selftrained.npz"


# ---------------------------------------------------------------------------
# ResNet-FPN backbone (strides 8 and 2)
# ---------------------------------------------------------------------------

def init_basic_block(gen, cin, cout, stride):
    p = {"conv1": init_conv(gen, 3, 3, cin, cout, bias=False),
         "bn1": init_bn(cout),
         "conv2": init_conv(gen, 3, 3, cout, cout, bias=False),
         "bn2": init_bn(cout)}
    if stride != 1:
        p["downsample"] = {"0": init_conv(gen, 1, 1, cin, cout, bias=False),
                           "1": init_bn(cout)}
    return p


def basic_block(p, x, stride):
    y = conv2d(p["conv1"], x, stride=stride)
    y = relu(batch_norm_inference(p["bn1"], y))
    y = batch_norm_inference(p["bn2"], conv2d(p["conv2"], y))
    if "downsample" in p:
        x = batch_norm_inference(p["downsample"]["1"], conv2d(
            p["downsample"]["0"], x, stride=stride))
    return relu(x + y)


def init_backbone(gen):
    dims = [128, 196, 256]

    def fpn_head(cin, cmid, cout):
        return {"0": init_conv(gen, 3, 3, cin, cmid, bias=False),
                "1": init_bn(cmid),
                "3": init_conv(gen, 3, 3, cmid, cout, bias=False)}

    return {
        "conv1": init_conv(gen, 7, 7, 1, 128, bias=False),
        "bn1": init_bn(128),
        "layer1": {"0": init_basic_block(gen, 128, dims[0], 1),
                   "1": init_basic_block(gen, dims[0], dims[0], 1)},
        "layer2": {"0": init_basic_block(gen, dims[0], dims[1], 2),
                   "1": init_basic_block(gen, dims[1], dims[1], 1)},
        "layer3": {"0": init_basic_block(gen, dims[1], dims[2], 2),
                   "1": init_basic_block(gen, dims[2], dims[2], 1)},
        "layer3_outconv": init_conv(gen, 1, 1, dims[2], D_COARSE,
                                    bias=False),
        "layer2_outconv": init_conv(gen, 1, 1, dims[1], D_COARSE,
                                    bias=False),
        "layer2_outconv2": fpn_head(D_COARSE, D_COARSE, dims[1]),
        "layer1_outconv": init_conv(gen, 1, 1, dims[0], dims[1], bias=False),
        "layer1_outconv2": fpn_head(dims[1], dims[1], D_FINE),
    }


def _upsample2(x):
    """Bilinear × 2 upsampling of (B, C, H, W) with align_corners=True (the
    upstream FPN's ``F.interpolate``), as the JAX package computes it: one
    gather and blend along H, then one along W, each in x's dtype with the
    weights rounded to it. (``F.interpolate`` on a bf16 tensor rounds once
    at the end instead.) A size-1 axis is repeated."""
    def up_dim(t, dim):
        n_in = t.shape[dim]
        if n_in == 1:
            return torch.repeat_interleave(t, 2, dim)
        n_out = 2 * n_in
        s = np.arange(n_out) * (n_in - 1) / (n_out - 1)
        i0 = np.clip(np.floor(s).astype(np.int64), 0, n_in - 2)
        idx = torch.as_tensor(i0, device=t.device)
        shape = [1] * t.ndim
        shape[dim] = n_out
        fr = torch.as_tensor(s - i0, dtype=torch.float64).to(
            device=t.device, dtype=t.dtype).reshape(shape)
        t0 = t.index_select(dim, idx)
        t1 = t.index_select(dim, idx + 1)
        return t0 * (1 - fr) + t1 * fr

    return up_dim(up_dim(x, 2), 3)


def backbone_apply(p, x):
    """x: (B, 1, H, W) → coarse (B, 256, H/8, W/8), fine (B, 128, H/2,
    W/2), in the weights' dtype.

    A float32 batch goes through one view at a time: for two views
    cuDNN 9.2 picks an FFT algorithm for the float32 (TF32 off) 3 × 3
    convolutions to 196 channels at 1/4, 350–415 ms each where one view
    takes ~1.2 ms; a bf16 batch is faster whole (7.5 against 9.9 ms a
    640 × 480 pair; ``tools/loftr_times.py`` on an H100)."""
    if x.dtype != torch.float32:
        return _backbone(p, x)
    views = [_backbone(p, x[i:i + 1]) for i in range(x.shape[0])]
    return (torch.cat([v[0] for v in views]),
            torch.cat([v[1] for v in views]))


def _backbone(p, x):
    x0 = relu(batch_norm_inference(p["bn1"], conv2d(p["conv1"], x,
                                                    stride=2)))
    x1 = basic_block(p["layer1"]["1"], basic_block(p["layer1"]["0"], x0, 1),
                     1)                                          # 1/2
    x2 = basic_block(p["layer2"]["1"], basic_block(p["layer2"]["0"], x1, 2),
                     1)                                          # 1/4
    x3 = basic_block(p["layer3"]["1"], basic_block(p["layer3"]["0"], x2, 2),
                     1)                                          # 1/8

    x3_out = conv2d(p["layer3_outconv"], x3)
    x2_out = conv2d(p["layer2_outconv"], x2) + _upsample2(x3_out)
    q = p["layer2_outconv2"]
    x2_out = conv2d(q["3"], leaky_relu(batch_norm_inference(
        q["1"], conv2d(q["0"], x2_out))))
    x1_out = conv2d(p["layer1_outconv"], x1) + _upsample2(x2_out)
    q = p["layer1_outconv2"]
    x1_out = conv2d(q["3"], leaky_relu(batch_norm_inference(
        q["1"], conv2d(q["0"], x1_out))))
    return x3_out, x1_out


# ---------------------------------------------------------------------------
# position encoding and the linear-attention transformer
# ---------------------------------------------------------------------------

def position_encoding(h, w, d=D_COARSE, device="cpu"):
    """LoFTR's 2-D sinusoidal encoding, (h, w, d) float32: sin x, cos x,
    sin y, cos y interleaved over channels 0::4 … 3::4."""
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    step = -torch.log(torch.tensor(10000.0, device=device)) / (d // 2)
    div = torch.exp(torch.arange(0, d // 2, 2, dtype=torch.float32,
                                 device=device) * step)[None, None, :]
    pe = torch.zeros((h, w, d), device=device)
    pe[..., 0::4] = torch.sin(x * div)
    pe[..., 1::4] = torch.cos(x * div)
    pe[..., 2::4] = torch.sin(y * div)
    pe[..., 3::4] = torch.cos(y * div)
    return pe


def init_encoder_layer(gen, d):
    return {
        "q_proj": init_linear(gen, d, d, bias=False),
        "k_proj": init_linear(gen, d, d, bias=False),
        "v_proj": init_linear(gen, d, d, bias=False),
        "merge": init_linear(gen, d, d, bias=False),
        "mlp": {"0": init_linear(gen, 2 * d, 2 * d, bias=False),
                "2": init_linear(gen, 2 * d, d, bias=False)},
        "norm1": init_layer_norm(d),
        "norm2": init_layer_norm(d),
    }


def linear_attention(q, k, v, mask_kv=None, eps=1e-6):
    """(elu + 1) linear attention. q: (..., N, h, dh); k, v: (..., M, h,
    dh); mask_kv: (..., M) bool or None. The feature maps and the mask are
    applied in the inputs' dtype; K·V, the normaliser and the readout are
    float32 products of the widened values; Σk is summed in float32 and
    rounded to the inputs' dtype, as ``k.sum(0)`` is in the JAX package;
    the output is rounded to v's dtype once."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    if mask_kv is not None:
        m = mask_kv[..., None, None].to(k.dtype)
        k = k * m
        v = v * m
    qf, kf = q.float(), k.float()
    kv = torch.einsum("...mhd,...mhv->...hdv", kf, v.float())
    ksum = kf.sum(-3).to(k.dtype).float()
    z = 1.0 / (torch.einsum("...nhd,...hd->...nh", qf, ksum) + eps)
    out = torch.einsum("...nhd,...hdv->...nhv", qf, kv) * z[..., None]
    return out.to(v.dtype)


def encoder_layer(p, x, source, mask_src=None, nhead=8):
    """LoFTREncoderLayer: x (..., N, d) attends to source (..., M, d)."""
    *lead, n, d = x.shape
    dh = d // nhead
    q = linear(p["q_proj"], x).reshape(*lead, n, nhead, dh)
    k = linear(p["k_proj"], source).reshape(*source.shape[:-1], nhead, dh)
    v = linear(p["v_proj"], source).reshape(*source.shape[:-1], nhead, dh)
    message = linear_attention(q, k, v, mask_kv=mask_src)
    message = layer_norm(p["norm1"], linear(p["merge"], message.reshape(
        *lead, n, d)))
    message = torch.cat([x, message], -1)
    message = linear(p["mlp"]["2"], relu(linear(p["mlp"]["0"], message)))
    return x + layer_norm(p["norm2"], message)


def coarse_transform(layers, fc0, fc1, m0, m1):
    """The coarse transformer: even layers self-attention, odd layers
    cross-attention, each view's keys masked by its valid cells (the loop
    of the JAX package's ``forward_pair``)."""
    for i, layer in enumerate(layers):
        if i % 2 == 0:
            fc0 = encoder_layer(layer, fc0, fc0, mask_src=m0)
            fc1 = encoder_layer(layer, fc1, fc1, mask_src=m1)
        else:
            fc0n = encoder_layer(layer, fc0, fc1, mask_src=m1)
            fc1 = encoder_layer(layer, fc1, fc0, mask_src=m0)
            fc0 = fc0n
    return fc0, fc1


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(gen, n_coarse_layers=4, n_fine_layers=2):
    """Random initialisation from ``gen`` (a CPU torch.Generator); the tree
    has the leaves of the JAX package's ``init_params``."""
    return {
        "backbone": init_backbone(gen),
        "loftr_coarse": {"layers": [init_encoder_layer(gen, D_COARSE)
                                    for _ in range(n_coarse_layers)]},
        "fine_preprocess": {
            "down_proj": init_linear(gen, D_COARSE, D_FINE),
            "merge_feat": init_linear(gen, 2 * D_FINE, D_FINE),
        },
        "loftr_fine": {"layers": [init_encoder_layer(gen, D_FINE)
                                  for _ in range(n_fine_layers)]},
    }


def load_params(conf, device):
    """(params, meta) by ``weights.load_trained``: ``checkpoint_npz``, else
    ``weights/loftr_selftrained.npz``, else the seeded random tree. The
    JAX package first tries to download and convert the upstream
    ``loftr_outdoor.ckpt`` (``_convert_state_dict``); no such checkpoint
    is in the repository and nothing is downloaded here, so that
    conversion waits until one is."""
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "loftr", device,
                                local=TRAINED_NPZ)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def grid_mask(wh, hc, wc, device):
    """(hc·wc,) validity of the coarse cells of an image whose valid part
    is ``wh`` = (width, height) pixels: the first width//8 columns and
    height//8 rows."""
    ys = torch.arange(hc, device=device)[:, None]
    xs = torch.arange(wc, device=device)[None, :]
    return ((xs < int(wh[0]) // 8) & (ys < int(wh[1]) // 8)).reshape(-1)


def coarse_match(featc0, featc1, mask0, mask1, temperature=0.1,
                 threshold=0.2, max_matches=1024):
    """Dual-softmax coarse assignment cut to fixed match slots.

    featc0: (L, d), featc1: (S, d); mask0 (L,), mask1 (S,) bool. Returns
    idx0, idx1 (M,) long, conf (M,) float32 and valid (M,) bool, M =
    min(max_matches, L), by decreasing confidence.

    The dual softmax is never built: with lse_r and lse_c the row and
    column log-sum-exps of the masked logits (-1e9 off the valid cells),
    conf[l, s] = exp(2·sim[l, s] − lse_r[l] − lse_c[s]) exactly, and the
    row and column maxima of 2·sim − lse_c and 2·sim − lse_r give the two
    argmaxes (the first index on a tie). A row is kept where the pair is
    mutual, its confidence above ``threshold`` and its cell valid. Slots
    past the kept rows hold confidence 0 and valid False; ``torch.topk``
    may order ties among them otherwise than the JAX package's
    ``lax.top_k``, so the valid rows are a set, not a slot order."""
    d = featc0.shape[-1]
    f0 = featc0 / d ** 0.5
    f1 = featc1 / d ** 0.5
    with full_fp32():
        sim = (f0.float() @ f1.float().t()) / temperature
    sim.masked_fill_(~(mask0[:, None] & mask1[None, :]), -1e9)
    lse_r = torch.logsumexp(sim, 1)
    lse_c = torch.logsumexp(sim, 0)
    sim2 = sim.mul_(2.0)
    best, idx1_of_0 = (sim2 - lse_c[None, :]).max(1)
    idx0_of_1 = (sim2 - lse_r[:, None]).argmax(0)
    del sim, sim2
    mutual = torch.arange(featc0.shape[0], device=featc0.device) \
        == idx0_of_1[idx1_of_0]
    score = torch.exp(best - lse_r)
    ok = mutual & (score > threshold) & mask0
    score = torch.where(ok, score, torch.zeros_like(score))
    top, idx0 = torch.topk(score, min(max_matches, score.shape[0]))
    return idx0, idx1_of_0[idx0], top, top > 0.0


def gather_fine_windows(feat_f, idx, wc, scale=4, window=FINE_WINDOW):
    """window × window fine patches centred on coarse cells.

    feat_f: (d, Hf, Wf); idx: (M,) flat coarse indices; wc: the coarse
    width. Cell (i, j) maps to the fine centre (i·scale + scale/2,
    j·scale + scale/2); a window that would cross the last row or column
    is moved inside (its start clipped to Hf − window, Wf − window), so at
    the edge the window's centre is not the cell's (the JAX package's
    documented shift of about 2 px). Returns (M, window², d)."""
    d, hf, wf = feat_f.shape
    r = window // 2
    cy = (idx // wc) * scale + scale // 2
    cx = (idx % wc) * scale + scale // 2
    y0 = (cy - r).clamp(0, hf - window)
    x0 = (cx - r).clamp(0, wf - window)
    ar = torch.arange(window, device=idx.device)
    ys = (y0[:, None] + ar)[:, :, None]
    xs = (x0[:, None] + ar)[:, None, :]
    return feat_f.permute(1, 2, 0)[ys, xs].reshape(-1, window * window, d)


def fine_preprocess(p, featf0, featf1, fc0, fc1, idx0, idx1, wc, scale=4):
    """The fine windows of both views around the coarse matches, each
    token concatenated with its match's projected coarse token and merged
    (``fine_preprocess.down_proj`` / ``merge_feat``). Returns (M, 25, d)
    twice."""
    out = []
    for featf, fc, idx in ((featf0, fc0, idx0), (featf1, fc1, idx1)):
        win = gather_fine_windows(featf, idx, wc, scale)
        c = linear(p["down_proj"], fc[idx])
        out.append(linear(p["merge_feat"], torch.cat(
            [win, c[:, None].expand(win.shape)], -1)))
    return out[0], out[1]


def fine_match(params, win0, win1, valid):
    """Fine refinement: the fine layers (self, then cross) on each window
    pair, the correlation of image 1's window with image 0's centre token,
    and its spatial expectation. win*: (M, W², d). Returns image 1's
    sub-pixel offsets (M, 2), (x, y) in fine pixels around the window
    centre, 0 where not ``valid``.

    The correlation is taken in the tree's dtype and rounded there before
    it is widened (the JAX package's order: the product, then the cast),
    unlike the coarse logits; the softmax and the expectation are
    float32."""
    ww = win0.shape[1]
    w = FINE_WINDOW
    p0, p1 = win0, win1
    for i, layer in enumerate(params["loftr_fine"]["layers"]):
        if i % 2 == 0:
            p0 = encoder_layer(layer, p0, p0)
            p1 = encoder_layer(layer, p1, p1)
        else:
            p0n = encoder_layer(layer, p0, p1)
            p1 = encoder_layer(layer, p1, p0)
            p0 = p0n
    center0 = p0[:, ww // 2]
    sim = torch.bmm(p1, center0[:, :, None])[..., 0].float() / (
        p1.shape[-1] ** 0.5)
    heat = torch.softmax(sim / 0.1, -1)
    ar = torch.arange(w, dtype=torch.float32, device=heat.device)
    grid = torch.stack([ar.repeat(w), ar.repeat_interleave(w)], -1)
    offsets = (heat[..., None] * grid).sum(1) - (w // 2)
    return torch.where(valid[:, None], offsets, torch.zeros_like(offsets))


def cell_centers(idx, wc, stride=8):
    """Pixel centres (x, y) of flat coarse indices, float32 (M, 2)."""
    ci = (idx // wc).float()
    cj = (idx % wc).float()
    return torch.stack([cj * stride + stride / 2, ci * stride + stride / 2],
                       -1)


def finish(idx0, idx1, score, valid, offsets1, wc, offsets0=None):
    """Keypoints at model resolution from the coarse cells and the fine
    offsets (fine stride 2), zeroed where not ``valid``."""
    kpts0 = cell_centers(idx0, wc)
    if offsets0 is not None:
        kpts0 = kpts0 + offsets0 * 2.0
    kpts1 = cell_centers(idx1, wc) + offsets1 * 2.0
    zero = torch.zeros((), device=kpts0.device)
    return {"keypoints0": torch.where(valid[:, None], kpts0, zero),
            "keypoints1": torch.where(valid[:, None], kpts1, zero),
            "scores": score, "mask": valid}


def coarse_tokens(featc):
    """(2, d, hc, wc) coarse maps → the two views' (hc·wc, d) tokens with
    the position encoding added in the maps' dtype."""
    _, d, hc, wc = featc.shape
    pe = position_encoding(hc, wc, d, featc.device).to(featc.dtype)
    tokens = (featc.permute(0, 2, 3, 1) + pe).reshape(2, hc * wc, d)
    return tokens[0], tokens[1]


def forward_pair(params, image0, image1, wh0, wh1, conf):
    """One pair. image*: (1, H, W) in [0, 1]; wh*: the valid (width,
    height). Returns keypoints0/1 (M, 2) at model resolution, scores (M,),
    mask (M,)."""
    dt = params["backbone"]["conv1"]["w"].dtype
    featc, featf = backbone_apply(params["backbone"],
                                  torch.stack([image0, image1]).to(dt))
    hc, wc = featc.shape[2:]
    fc0, fc1 = coarse_tokens(featc)
    m0 = grid_mask(wh0, hc, wc, featc.device)
    m1 = grid_mask(wh1, hc, wc, featc.device)
    fc0, fc1 = coarse_transform(params["loftr_coarse"]["layers"], fc0, fc1,
                                m0, m1)
    idx0, idx1, score, valid = coarse_match(
        fc0, fc1, m0, m1, temperature=conf.get("temperature", 0.1),
        threshold=conf.get("match_threshold", 0.2),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = fine_preprocess(params["fine_preprocess"], featf[0],
                                 featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = fine_match(params, win0, win1, valid)
    return finish(idx0, idx1, score, valid, offsets1, wc)


def forward_pairs(pair_fn, params, data, conf, device):
    """The standalone wrapper's batch: image0/1 (B, 1 or 3, H, W) in [0, 1]
    (3 channels are averaged to gray, not weighted as by cv2), size0/1
    (B, 2) the valid (width, height) of each padded view (default: the
    whole image). Runs ``pair_fn(params, img0, img1, wh0, wh1, conf)`` on
    each pair with TF32 off and stacks the outputs; ``mconf`` repeats
    ``scores``."""
    img0 = torch.as_tensor(data["image0"], dtype=torch.float32,
                           device=device)
    img1 = torch.as_tensor(data["image1"], dtype=torch.float32,
                           device=device)
    if img0.shape[1] == 3:
        img0 = img0.mean(1, keepdim=True)
        img1 = img1.mean(1, keepdim=True)
    b = img0.shape[0]

    def wh(key, img):
        if key in data:
            s = data[key]
            s = s.detach().cpu().numpy() if torch.is_tensor(s) else s
            return np.asarray(s, np.int64).reshape(b, 2)
        return np.tile([[img.shape[3], img.shape[2]]], (b, 1))

    wh0, wh1 = wh("size0", img0), wh("size1", img1)
    with full_fp32():
        rows = [pair_fn(params, img0[i], img1[i], tuple(wh0[i]),
                        tuple(wh1[i]), conf) for i in range(b)]
    out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    out["mconf"] = out["scores"]
    return out


class LoFTR(BaseModel):
    """Standalone dense matcher: image0, image1 (B, 1 or 3, H, W) in [0, 1]
    (and optionally size0/size1) → keypoints0/1 (B, M, 2) at the input
    resolution, scores, mconf (B, M) and mask (B, M)."""

    default_conf = {
        "weights": "outdoor",
        "match_threshold": 0.2,
        "max_keypoints": 1024,
        "temperature": 0.1,
        # bf16 trunk and transformer, float32 softmax and expectation
        # statistics; "fp32" for parity runs
        "precision": "bf16",
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        params, self.meta = load_params(conf, self.device)
        # the JAX LoFTR's rule: "bf16"/"bfloat16" casts the tree, any other
        # value ("fp32" included, which apply_precision refuses) is float32
        bf16 = conf.get("precision") in ("bf16", "bfloat16")
        self.params = apply_precision(params, "bf16" if bf16 else None)
        logger.info(f"loftr weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "temperature": float(conf["temperature"]),
            "max_matches": int(conf.get("max_keypoints") or 1024)}

    @torch.inference_mode()
    def _forward(self, data):
        return forward_pairs(forward_pair, self.params, data, self.pair_conf,
                             self.device)

