"""RoMa: dense feature matching with a DINOv2 coarse encoder, a Gaussian-
process coarse matcher, an anchor-classification transformer decoder and
multi-scale convolutional refiners. Counterpart of
``imcui_tpu/models/matchers/roma.py``: the DINOv2 + GP architecture
(``backbone="dinov2-gp"``) and the lightweight ``fpn-corr`` one (LoFTR's
ResNet-FPN coarse features, a soft-argmax warp over their correlation and
one convolutional refinement step, on grayscale images at the input
resolution).

``match_gp`` gives a dense warp and certainty at ``coarse_res`` (560²),
``match`` dispatches on the tree (``match_gp`` where it holds DINOv2,
else the fpn-corr path at 1/8 of the input), ``sample`` draws
``max_keypoints`` correspondences from it, and the ``Roma`` wrapper
flattens that into the standalone dense-matcher output {keypoints0,
keypoints1, scores, mask, mconf}.

Layouts: images and feature maps are (C, H, W) for one view, warps are
(H, W, 2) normalised (x, y) in [-1, 1], token matrices (N, D) row-major
over the grid. A pair is one call; a batch is a loop over pairs.

Precision. ``precision="bf16"`` casts every parameter to bfloat16
(``layers.apply_precision``). The program is then not bf16 throughout, as
in the JAX package: the GP's kernel matrices and solve are float32, so the
decoder's tokens are float32 running through bf16-valued weights; warps
and certainties are float32; each refiner widens its input at the
concatenation and narrows it again in its first convolution.
``precision="int8"`` quantises the linears at least 256 wide (DINOv2's
and the decoder's) and, with ``int8_conv_min_ch``, the convolutions whose
cin and cout both reach it (W8A8, ``ops/w8a8.py``), casts the rest to
bfloat16 and the images as under "bf16". The JAX package runs the
stride-1 refiner on 2×2-folded weights, which read ``w``: there a
threshold of 24 or less, which takes that refiner's convolutions, raises
``KeyError``; the port has no fold and serves them (a deviation, ROADMAP
§C). At 2 or less ``pos_conv`` is quantised and ``fourier_embed`` raises
``KeyError`` in both packages, at 1 the depthwise kernels.
"""

import math

import torch

from ... import logger
from ...ops import resize as resize_ops
from ...ops import sampling
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones import dinov2, vgg
from ..backbones import vit as vit_mod
from ..layers import (LOW_PRECISIONS, apply_precision, batch_norm_inference,
                      conv2d,
                      depthwise_conv, full_fp32, init_bn, init_conv,
                      init_linear, linear, relu)
from . import loftr

# per-scale refiner: projected feature dim, displacement-embedding dim,
# local-correlation radius, hidden depth, depthwise? (the published
# RoMa/DKM table; hidden width = input width at every scale)
REFINERS = {
    "16": dict(feat=512, disp=128, r=7, blocks=8, dw=True),
    "8": dict(feat=512, disp=64, r=3, blocks=8, dw=True),
    "4": dict(feat=256, disp=32, r=2, blocks=8, dw=True),
    "2": dict(feat=64, disp=16, r=0, blocks=8, dw=True),
    "1": dict(feat=9, disp=6, r=0, blocks=5, dw=False),
}
# per-scale 1×1 projection (cin, cout) from the encoder features
PROJ = {"16": (1024, 512), "8": (512, 512), "4": (256, 256),
        "2": (128, 64), "1": (64, 9)}

GP_DIM = 512
KERNEL_T = 0.2
GP_SIGMA_NOISE = 0.1
DECODER_DEPTH = 5
DECODER_HEADS = 8
ANCHOR_RES = 64
DISP_EMB_SCALE = 40.0 / 32.0
# below this many cells the local correlation goes through one all-pairs
# product; above it the all-pairs matrix would not fit
ALL_PAIRS_MAX_CELLS = 6400


def _refiner_in_dim(cfg):
    return 2 * cfg["feat"] + cfg["disp"] + (2 * cfg["r"] + 1) ** 2 * (
        1 if cfg["r"] else 0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_refiner_block(gen, cin, cout, dw):
    """5×5 (depthwise) conv, BatchNorm, ReLU, 1×1 conv: torch's Sequential
    indices 0, 1, (2), 3 are the keys."""
    return {"0": init_conv(gen, 5, 5, 1 if dw else cin, cout),
            "1": init_bn(cout),
            "3": init_conv(gen, 1, 1, cout, cout)}


def init_refiner(gen, cfg):
    in_dim = _refiner_in_dim(cfg)
    return {
        "disp_emb": init_conv(gen, 1, 1, 2, cfg["disp"]),
        "block1": _init_refiner_block(gen, in_dim, in_dim, cfg["dw"]),
        "hidden_blocks": [
            _init_refiner_block(gen, in_dim, in_dim, cfg["dw"])
            for _ in range(cfg["blocks"])],
        "out_conv": init_conv(gen, 1, 1, in_dim, 3),
    }


def init_params(gen, conf=None):
    """Random initialisation from ``gen`` (a CPU torch.Generator); the tree
    has the leaves of the JAX package's ``init_params``."""
    conf = conf or {}
    variant = conf.get("dinov2_variant", "vitl14")
    gp_dim = conf.get("gp_dim", GP_DIM)
    feat16 = PROJ["16"][1]
    dec_dim = feat16 + gp_dim
    proj = dict(PROJ)
    if variant != "vitl14":  # a smaller encoder projects from its own width
        proj["16"] = (dinov2.CONFIGS[variant]["dim"], feat16)
    return {
        "dinov2": dinov2.init_params(gen, variant),
        "encoder_cnn": vgg.init_params(gen),
        "proj": {s: {"0": init_conv(gen, 1, 1, cin, cout), "1": init_bn(cout)}
                 for s, (cin, cout) in proj.items()},
        "gps": {"16": {"pos_conv": init_conv(gen, 1, 1, 2, gp_dim)}},
        "embedding_decoder": {
            "blocks": [vit_mod.init_encoder_block(gen, dec_dim)
                       for _ in range(conf.get("decoder_depth",
                                               DECODER_DEPTH))],
            "to_out": init_linear(gen, dec_dim, ANCHOR_RES ** 2 + 1),
        },
        "conv_refiner": {s: init_refiner(gen, cfg)
                         for s, cfg in REFINERS.items()},
    }


# ---------------------------------------------------------------------------
# GP coarse matcher
# ---------------------------------------------------------------------------

def coord_grid(h, w, device="cpu"):
    """(h·w, 2) normalised (x, y) cell-centre coordinates in [-1, 1]."""
    gy, gx = torch.meshgrid(
        (torch.arange(h, device=device) + 0.5) / h * 2 - 1,
        (torch.arange(w, device=device) + 0.5) / w * 2 - 1, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def fourier_embed(coords, pos_conv):
    """The GP's "fourier" basis, cos(8π · pos_conv(coords)). coords
    (N, 2); pos_conv a 1×1 conv {w (D, 2, 1, 1), b (D,)} used as a matrix
    → (N, D) in the weights' dtype: the JAX package's coordinate grid is
    weakly typed, so under a bf16 tree the coordinates are rounded to bf16
    and the embedding is bf16. Between those two roundings the phase is
    kept in float32 (8π · proj reaches tens of radians, where one bf16
    step is a tenth of a radian)."""
    w = pos_conv["w"][:, :, 0, 0]
    proj = coords.to(w.dtype).float() @ w.float().t() + pos_conv["b"].float()
    return torch.cos(8.0 * math.pi * proj).to(w.dtype)


def cos_kernel(x, y, temperature=KERNEL_T, eps=1e-6):
    """exp((cosine similarity − 1) / T), float32 whatever the inputs.
    Products, sums and norms are float32 on the inputs' values. (The JAX
    function takes the norms in the inputs' dtype; bf16 norms move each
    entry by up to 2 %, which is enough to make K + σ·I indefinite when
    the tokens resemble each other, and its Cholesky factor NaN.)"""
    x, y = x.float(), y.float()
    den = (torch.linalg.vector_norm(x, dim=-1)[:, None]
           * torch.linalg.vector_norm(y, dim=-1)[None, :] + eps)
    return torch.exp((x @ y.t() / den - 1.0) / temperature)


def gp_posterior(f0, f1, emb1, temperature=KERNEL_T,
                 sigma_noise=GP_SIGMA_NOISE):
    """Cosine-kernel GP posterior mean, K01 (K11 + σ·I)⁻¹ emb1, by a
    Cholesky solve in full float32. f0: (N0, D) query tokens, f1: (N1, D)
    support tokens, emb1: (N1, E) targets → (N0, E)."""
    with full_fp32():
        k01 = cos_kernel(f0, f1, temperature)
        k11 = cos_kernel(f1, f1, temperature)
        n1 = k11.shape[0]
        chol = torch.linalg.cholesky(
            k11 + sigma_noise * torch.eye(n1, dtype=k11.dtype,
                                          device=k11.device))
        return k01 @ torch.cholesky_solve(emb1.float(), chol)


def cls_to_flow_refine(logits):
    """Regression by classification with a local expectation: softmax over
    the 64 × 64 anchor grid, then the expected coordinate over the mode and
    its 4 neighbours {±1, ±64}. logits: (N, A²) → (N, 2) in [-1, 1]."""
    anchors = coord_grid(ANCHOR_RES, ANCHOR_RES, logits.device)
    probs = torch.softmax(logits, -1)
    mode = probs.argmax(-1)
    idx = torch.stack([mode - 1, mode, mode + 1, mode - ANCHOR_RES,
                       mode + ANCHOR_RES], -1).clamp(0, ANCHOR_RES ** 2 - 1)
    w = torch.gather(probs, 1, idx)                      # (N, 5)
    pts = anchors[idx]                                   # (N, 5, 2)
    return (w[..., None] * pts).sum(1) / w.sum(-1, keepdim=True).clamp_min(
        1e-12)


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------

def bilinear_warp(feat, warp):
    """Sample feat (D, Hc, Wc) at normalised warp coords (..., 2):
    ``grid_sample`` with align_corners=False and zeros padding → (D, ...)."""
    return sampling.grid_sample(feat, warp, mode="bilinear",
                                align_corners=False)


def local_correlation(f0, f1, warp, r):
    """(2r+1)² local correlation f0[p] · f1[warp(p) + δ] / √d for δ in the
    (2r+1)² neighbourhood, in f1-grid units. f0/f1: (d, h, w); warp:
    (h, w, 2) → (h, w, (2r+1)²) float32, offsets row-major over (dy, dx).

    Two exact forms: on coarse grids one all-pairs product F0·F1ᵀ, whose
    scalars are then interpolated bilinearly (the dot product is linear, so
    the interpolation moves outside the channel sum); on fine grids, where
    that matrix would not fit, feature gathers at the (2r+2)² integer
    taps."""
    _, h, w = f0.shape
    if h * w <= ALL_PAIRS_MAX_CELLS:
        return _local_correlation_mxu(f0, f1, warp, r)
    return _local_correlation_int_taps(f0, f1, warp, r)


def _warp_corners(warp, h, w):
    """Unnormalise (align_corners=False) → integer corner and fraction."""
    px = ((warp[..., 0].float() + 1.0) * w - 1.0) * 0.5
    py = ((warp[..., 1].float() + 1.0) * h - 1.0) * 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    return (x0.long().reshape(-1), y0.long().reshape(-1),
            (px - x0).reshape(-1), (py - y0).reshape(-1))


def _tap_indices(x0, y0, h, w, r):
    """Flat f1 index (hw, T, T) and validity of the integer taps
    dy', dx' ∈ [-r, r+1] around each corner, T = 2r + 2."""
    d = torch.arange(-r, r + 2, device=x0.device)
    yy = y0[:, None, None] + d[None, :, None]
    xx = x0[:, None, None] + d[None, None, :]
    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    return yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1), ok


def _interp_taps(taps, ty, tx, h, w):
    """Bilinear combination of the scalar tap correlations (hw, T, T) into
    the (2r+1)² offset outputs → (h, w, (2r+1)²)."""
    ty, tx = ty[:, None, None], tx[:, None, None]
    out = ((1 - ty) * ((1 - tx) * taps[:, :-1, :-1] + tx * taps[:, :-1, 1:])
           + ty * ((1 - tx) * taps[:, 1:, :-1] + tx * taps[:, 1:, 1:]))
    return out.reshape(h, w, -1)


def _local_correlation_mxu(f0, f1, warp, r):
    """All pairs, then interpolate: exact restatement of the gather form
    on the scalar correlation surface."""
    d, h, w = f0.shape
    hw = h * w
    with full_fp32():
        corr_all = (f0.reshape(d, hw).t().float()
                    @ f1.reshape(d, hw).float()) / math.sqrt(d)
    x0, y0, tx, ty = _warp_corners(warp, h, w)
    q, ok = _tap_indices(x0, y0, h, w, r)
    taps = torch.gather(corr_all, 1, q.reshape(hw, -1)).reshape(q.shape)
    taps = torch.where(ok, taps, torch.zeros_like(taps))
    return _interp_taps(taps, ty, tx, h, w)


def _local_correlation_int_taps(f0, f1, warp, r):
    """Fine-scale form: gather f1's feature vectors at the (2r+2)² integer
    taps, one tap at a time, and interpolate the scalar correlations."""
    d, h, w = f0.shape
    hw = h * w
    f0f = f0.reshape(d, hw).t().float()
    f1f = f1.reshape(d, hw).t()
    x0, y0, tx, ty = _warp_corners(warp, h, w)
    q, ok = _tap_indices(x0, y0, h, w, r)
    n_taps = 2 * r + 2
    taps = torch.empty((hw, n_taps, n_taps), dtype=torch.float32,
                       device=f0.device)
    for i in range(n_taps):
        for j in range(n_taps):
            taps[:, i, j] = (f0f * f1f[q[:, i, j]].float()).sum(-1)
    taps = torch.where(ok, taps / math.sqrt(d), torch.zeros_like(taps))
    return _interp_taps(taps, ty, tx, h, w)


def _local_correlation_gather(f0, f1, warp, r):
    """Reference form, kept for the tests: one bilinear feature sample per
    offset."""
    d, h, w = f0.shape
    outs = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            off = torch.tensor([dx * 2.0 / w, dy * 2.0 / h],
                               device=warp.device)
            s = bilinear_warp(f1, warp + off)
            outs.append((f0 * s).sum(0) / math.sqrt(d))
    return torch.stack(outs, -1)


def _refiner_block(blk, x, dw):
    """5×5 (depthwise) conv → BN → ReLU → 1×1 conv on (1, C, h, w)."""
    y = depthwise_conv(blk["0"], x) if dw else conv2d(blk["0"], x)
    y = relu(batch_norm_inference(blk["1"], y))
    return conv2d(blk["3"], y)


def refiner_apply(p, cfg, f0, f1, warp, cert, disp_scale=DISP_EMB_SCALE):
    """One refiner step on this scale's grid. f0/f1: (feat, h, w); warp:
    (h, w, 2) normalised; cert: (h, w) logits. Returns the refined warp and
    certainty logits, float32.

    The displacement embedding reads the displacement relative to the
    identity grid, scaled by 40/32; the predicted delta is divided by four
    times the grid size to return to normalised units. The JAX package
    runs its stride-1 refiner on 2×2 pixel blocks folded into channels
    (``fold2x2``), an exact rewrite that fills the TPU's lanes; that is a
    layout choice which does not carry over, and the plain 5×5
    convolutions run here."""
    _, h, w = f0.shape
    warped = bilinear_warp(f1, warp)
    disp = warp - coord_grid(h, w, warp.device).reshape(h, w, 2)
    emb = conv2d(p["disp_emb"], (disp_scale * disp).permute(2, 0, 1)[None])[0]
    ins = [f0, warped, emb]
    if cfg["r"]:
        ins.append(local_correlation(f0, f1, warp, cfg["r"]).permute(2, 0, 1))
    dtype = ins[0].dtype
    for t in ins[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    x = torch.cat([t.to(dtype) for t in ins], 0)[None]
    x = _refiner_block(p["block1"], x, cfg["dw"])
    for blk in p["hidden_blocks"]:
        x = _refiner_block(blk, x, cfg["dw"])
    out = conv2d(p["out_conv"], x)[0]
    scale = torch.tensor([0.25 / w, 0.25 / h], device=out.device)
    dwarp = out[:2].permute(1, 2, 0) * scale
    return warp + dwarp, cert + out[2]


def _resize(x, h, w):
    """Bilinear resize of (H, W, ...) to (h, w, ...)."""
    return resize_ops.resize(x, (h, w), "bilinear", dims=(0, 1))


# ---------------------------------------------------------------------------
# full match
# ---------------------------------------------------------------------------

def encode(params, image, conf):
    """DINOv2 tokens (N, dim) with their grid (hp, wp), and the VGG
    pyramid {stride: (C, H/s, W/s)}, of one (3, H, W) view."""
    variant = conf.get("dinov2_variant", "vitl14")
    tokens, grid = dinov2.apply(params["dinov2"], image, variant)
    return tokens, grid, vgg.apply(params["encoder_cnn"], image)


def _project(params, s, feat):
    """1×1 conv + BN of one view's (C, h, w) features at scale ``s``."""
    p = params["proj"][s]
    return batch_norm_inference(p["1"], conv2d(p["0"], feat[None]))[0]


def coarse_match(params, f0_16, f1_16):
    """GP regression and the transformer match decoder on the projected
    coarse features (512, hp, wp) → warp (hp, wp, 2) and certainty logits
    (hp, wp). The token layout is [GP posterior ‖ features], then
    pre-norm ViT blocks and a plain linear head (no final norm)."""
    d, hp, wp = f0_16.shape
    t0 = f0_16.reshape(d, hp * wp).t()
    t1 = f1_16.reshape(d, hp * wp).t()
    emb1 = fourier_embed(coord_grid(hp, wp, f0_16.device),
                         params["gps"]["16"]["pos_conv"])
    gp_out = gp_posterior(t0, t1, emb1)
    tokens = torch.cat([gp_out, t0.to(gp_out.dtype)], -1)
    dec = params["embedding_decoder"]
    for blk in dec["blocks"]:
        tokens = vit_mod.encoder_block_apply(blk, tokens, DECODER_HEADS)
    out = linear(dec["to_out"], tokens)
    warp = cls_to_flow_refine(out[:, :-1]).reshape(hp, wp, 2)
    return warp, out[:, -1].reshape(hp, wp)


def match_gp(params, image0, image1, conf):
    """Dense warp and certainty on the coarse_res grid.

    image0/1: (3, H, W) RGB in [0, 1] at coarse_res (H and W multiples of
    14 and of 8). Returns warp (H, W, 2), normalised coordinates into
    image1, and certainty (H, W) in [0, 1], both float32."""
    d0, (hp, wp), v0 = encode(params, image0, conf)
    d1, _, v1 = encode(params, image1, conf)
    f0_16 = _project(params, "16", d0.t().reshape(-1, hp, wp))
    f1_16 = _project(params, "16", d1.t().reshape(-1, hp, wp))
    warp, cert = coarse_match(params, f0_16, f1_16)
    warp, cert = refiner_apply(params["conv_refiner"]["16"], REFINERS["16"],
                               f0_16, f1_16, warp, cert)
    for s in (8, 4, 2, 1):
        fs0 = _project(params, str(s), v0[s])
        fs1 = _project(params, str(s), v1[s])
        _, hs, ws = fs0.shape
        warp = _resize(warp, hs, ws)
        cert = _resize(cert, hs, ws)
        warp, cert = refiner_apply(params["conv_refiner"][str(s)],
                                   REFINERS[str(s)], fs0, fs1, warp, cert)
    return warp, torch.sigmoid(cert)


# ---------------------------------------------------------------------------
# the lightweight fpn-corr path
# ---------------------------------------------------------------------------

def init_params_fpn(gen):
    """LoFTR's backbone and a three-conv refiner whose input is [f0 (256),
    warped f1 (256), warp (2), certainty (1)]."""
    return {
        "backbone": loftr.init_backbone(gen),
        "refiner": {"conv1": init_conv(gen, 3, 3, 515, 256),
                    "conv2": init_conv(gen, 3, 3, 256, 128),
                    "out": init_conv(gen, 3, 3, 128, 3)},
    }


def correlation_warp(f0, f1, temperature=0.05):
    """Coarse warp by a soft-argmax over the correlation of the two views'
    L2-normalised features. f0/f1: (D, Hc, Wc) → warp (Hc, Wc, 2) in
    image 1's normalised coordinates and certainty (Hc, Wc), the largest
    attention weight of each cell, both float32. The normalisation is in
    the features' dtype, the correlation a float32 product."""
    d, hc, wc = f0.shape

    def unit(f):
        t = f.reshape(d, hc * wc).t()
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True
                                            ).clamp_min(1e-8)

    with full_fp32():
        sim = (unit(f0).float() @ unit(f1).float().t()) / temperature
        attn = torch.softmax(sim, -1)
        warp = attn @ coord_grid(hc, wc, f0.device)
    return warp.reshape(hc, wc, 2), attn.amax(-1).reshape(hc, wc)


def refine(params, f0, f1, warp, cert):
    """One convolutional step on [f0, f1 warped, warp, certainty]: the warp
    moves by 0.1·tanh of two outputs, the certainty is scaled by the
    sigmoid of the third. f0/f1: (D, Hc, Wc); warp (Hc, Wc, 2); cert
    (Hc, Wc)."""
    x = torch.cat([f0, bilinear_warp(f1, warp), warp.permute(2, 0, 1),
                   cert[None]], 0)[None]          # promoted to float32
    x = relu(conv2d(params["conv1"], x))
    x = relu(conv2d(params["conv2"], x))
    out = conv2d(params["out"], x)[0]
    return (warp + (0.1 * torch.tanh(out[:2])).permute(1, 2, 0),
            torch.sigmoid(out[2]) * cert)


def match(params, image0, image1, conf=None):
    """Dense warp and certainty of one pair: ``match_gp`` on a DINOv2 + GP
    tree (RGB (3, H, W) at coarse_res), else the fpn-corr path on grayscale
    (1, H, W) images, whose warp and certainty are on the 1/8 grid."""
    if "dinov2" in params:
        return match_gp(params, image0, image1, conf or {})
    featc, _ = loftr.backbone_apply(params["backbone"],
                                    torch.stack([image0, image1]))
    warp, cert = correlation_warp(featc[0], featc[1])
    return refine(params["refiner"], featc[0], featc[1], warp, cert)


def load_params(conf, device):
    """(params, meta). The trained trees (``roma_outdoor.pth`` and
    ``dinov2_vitl14_pretrain.pth`` upstream) are not in the repository and
    nothing is downloaded, so unless ``conf["checkpoint_npz"]`` names a
    converted tree the weights are a seeded random initialisation and
    ``meta["pretrained"]`` is False. ``backbone="fpn-corr"`` has no trained
    tree anywhere and runs on its random one, as in the JAX package."""
    if conf.get("backbone") == "fpn-corr":
        init = init_params_fpn(torch.Generator().manual_seed(0))
        params, meta = weights.load_trained(conf, init, "roma fpn-corr",
                                            device)
        meta["backbone"] = "fpn-corr"
        return params, meta
    init = init_params(torch.Generator().manual_seed(0), conf)
    params, meta = weights.load_or_init(conf.get("checkpoint_npz"), init,
                                        "roma", device)
    meta["backbone"] = "dinov2-gp"
    return params, meta


# ---------------------------------------------------------------------------
# sampling and the wrapper
# ---------------------------------------------------------------------------

def to_pixel_coordinates(coords, h, w):
    """Normalised [-1, 1] → pixel coordinates of an (h, w) image."""
    return torch.stack([(coords[..., 0] + 1) * 0.5 * (w - 1),
                        (coords[..., 1] + 1) * 0.5 * (h - 1)], -1)


def sample(warp, cert, h, w, num=2048, threshold=0.0):
    """The ``num`` correspondences of highest certainty, in pixels of an
    (h, w) image: (keypoints0, keypoints1, scores, valid), fixed-shape,
    rows at or below ``threshold`` zeroed. An exact ``torch.topk`` (the
    JAX package's default is an approximate top-k at recall 0.95; its
    ``sample_recall_target = 1.0`` is this)."""
    hc, wc = cert.shape
    k0 = to_pixel_coordinates(coord_grid(hc, wc, cert.device), h, w)
    k1 = to_pixel_coordinates(warp.reshape(-1, 2), h, w)
    flat = cert.reshape(-1)
    top, idx = torch.topk(flat, min(num, flat.shape[0]))
    valid = top > threshold
    zero = torch.zeros((), dtype=k0.dtype, device=k0.device)
    return (torch.where(valid[:, None], k0[idx], zero),
            torch.where(valid[:, None], k1[idx], zero),
            torch.where(valid, top, zero), valid)


class Roma(BaseModel):
    """Standalone dense matcher: image0, image1 (B, 3 or 1, H, W) in
    [0, 1] → keypoints0/1 (B, K, 2) in the input images' pixels, scores,
    mconf (B, K) and mask (B, K)."""

    default_conf = {
        "model_name": "roma_outdoor.pth",
        "model_utils_name": "dinov2_vitl14_pretrain.pth",
        "max_keypoints": 2048,
        "backbone": "dinov2-gp",   # or "fpn-corr"
        "coarse_res": (560, 560),
        "upsample_res": (864, 1152),
        "dinov2_variant": "vitl14",
        # serving precision: None/"f32", "bf16", or "int8" (W8A8 of the
        # wide DINOv2 and decoder linears, and of the convolutions at least
        # int8_conv_min_ch wide where that is set: layers.apply_precision)
        "precision": None,
        "int8_conv_min_ch": None,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        params, self.meta = load_params(conf, self.device)
        self.params = apply_precision(
            params, conf.get("precision"),
            conv_min_ch=conf.get("int8_conv_min_ch"))
        logger.info(f"roma weights: {self.meta}")

    def _prepare(self, image):
        """A DINOv2 + GP tree takes RGB at coarse_res; the fpn-corr tree
        grayscale (the channels' mean) at the input resolution."""
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if "dinov2" not in self.params:
            if x.shape[1] == 3:
                x = x.mean(1, keepdim=True)
        else:
            if x.shape[1] == 1:
                x = x.expand(-1, 3, -1, -1)
            x = resize_ops.resize(x, tuple(self.conf["coarse_res"]),
                                  "bilinear")
        if self.conf.get("precision") in LOW_PRECISIONS:
            x = x.to(torch.bfloat16)
        return x

    def match(self, image0, image1):
        """Warp (H, W, 2) and certainty (H, W) of one prepared pair. A
        float32 tree runs in full float32 (no TF32 convolutions)."""
        if self.conf.get("precision") in LOW_PRECISIONS:
            return match(self.params, image0, image1, self.conf)
        with full_fp32():
            return match(self.params, image0, image1, self.conf)

    @torch.inference_mode()
    def _forward(self, data):
        h0, w0 = data["image0"].shape[-2:]
        h1, w1 = data["image1"].shape[-2:]
        x0, x1 = self._prepare(data["image0"]), self._prepare(data["image1"])
        gp = "dinov2" in self.params
        ch, cw = self.conf["coarse_res"] if gp else x0.shape[-2:]
        rows = []
        for a, b in zip(x0, x1):
            warp, cert = self.match(a, b)
            rows.append(sample(warp, cert, ch, cw,
                               num=int(self.conf["max_keypoints"])))
        k0, k1, scores, valid = (torch.stack(t) for t in zip(*rows))
        if not gp:  # already in image 0's pixels, as in the JAX package
            return {"keypoints0": k0, "keypoints1": k1, "scores": scores,
                    "mask": valid, "mconf": scores}
        # correspondences are in coarse_res pixels: back to the inputs'
        s0 = k0.new_tensor([(w0 - 1) / (cw - 1), (h0 - 1) / (ch - 1)])
        s1 = k0.new_tensor([(w1 - 1) / (cw - 1), (h1 - 1) / (ch - 1)])
        return {"keypoints0": k0 * s0, "keypoints1": k1 * s1,
                "scores": scores, "mask": valid, "mconf": scores}
