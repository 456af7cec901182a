"""COTR, the correspondence transformer. Counterpart of
``imcui_tpu/models/matchers/cotr.py``.

Both views are resized to 256 × 256 (the half-pixel, antialiasing
``ops.resize.resize``, as ``jax.image.resize(..., "bilinear")``) and set
side by side on one 256 × 512 canvas, ImageNet-normalised. Then:

- ResNet-50 through layer3 (``bottleneck_block``, the stem's
  ``max_pool3_s2``, inference batch norm): 1024 channels at stride 16;
- ``input_proj``, a 1 × 1 conv to d = 256;
- NeRF ``lin_sine`` positions of depth 64, [sin(kπx), sin(kπy)] for k =
  1..64, then the cosines, at the grid's (i + 0.5)/n centres, and the
  same encoding of the queries (no learned query projection);
- a DETR post-norm transformer, 6 encoder and 6 decoder layers, 8 heads,
  FFN 1024 with ReLU, ``nn.MultiheadAttention``'s fused ``in_proj``;
- ``corr_embed``, a 3-layer MLP 256 → 256 → 256 → 2, which regresses each
  query's correspondence in canvas-normalised coordinates.

The queries are a 16 × 16 grid over the left half; a second decoder pass
maps the predictions back, and exp(−16·|cycle error|) is the confidence.
The attention is plain PyTorch, as it is a plain einsum in the JAX
package (no kernel there). With a random tree the confidence head means
nothing, so the confidence gate is 0 unless the tree is trained, as in
the JAX package. No COTR checkpoint (``checkpoint.pth.tar``) is in the
repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 tree (drawn on the model's device), which ``meta`` reports.
"""

import math

import torch

from ...ops.matching import _softmax
from ...ops.resize import resize
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones.resnet import bottleneck_block, init_resnet
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_conv,
                      init_layer_norm, init_linear, layer_norm, linear,
                      max_pool3_s2, relu)

D_MODEL = 256
N_ENC = 6
N_DEC = 6
NHEAD = 8
D_FFN = 1024
NERF_DEPTH = 64  # d_model / 4
GRID = 16        # 16 × 16 = 256 queries
SIZE = 256       # each view's side on the canvas

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_mha(gen, d):
    return {"in_proj": init_linear(gen, d, 3 * d),
            "out_proj": init_linear(gen, d, d)}


def init_enc_layer(gen, d):
    return {"self_attn": init_mha(gen, d),
            "linear1": init_linear(gen, d, D_FFN),
            "linear2": init_linear(gen, D_FFN, d),
            "norm1": init_layer_norm(d), "norm2": init_layer_norm(d)}


def init_dec_layer(gen, d):
    return {"self_attn": init_mha(gen, d),
            "multihead_attn": init_mha(gen, d),
            "linear1": init_linear(gen, d, D_FFN),
            "linear2": init_linear(gen, D_FFN, d),
            "norm1": init_layer_norm(d), "norm2": init_layer_norm(d),
            "norm3": init_layer_norm(d)}


def init_params(gen):
    """The JAX init's tree (``backbone`` the ResNet-50, all four layers,
    of which layer4 is never run, as upstream's checkpoint holds it)."""
    return {
        "backbone": init_resnet(gen, "resnet50"),
        "input_proj": init_conv(gen, 1, 1, 1024, D_MODEL),
        "transformer": {
            "encoder": {"layers": {str(i): init_enc_layer(gen, D_MODEL)
                                   for i in range(N_ENC)}},
            "decoder": {"layers": {str(i): init_dec_layer(gen, D_MODEL)
                                   for i in range(N_DEC)},
                        "norm": init_layer_norm(D_MODEL)}},
        "corr_embed": {"layers": {
            "0": init_linear(gen, D_MODEL, D_MODEL),
            "1": init_linear(gen, D_MODEL, D_MODEL),
            "2": init_linear(gen, D_MODEL, 2)}},
    }


def nerf_encode(xy):
    """(..., N, 2) coordinates in [0, 1] → (..., N, 4·64) ``lin_sine``
    features: sin(kπ·(x, y)) for k = 1..64, then the cosines."""
    bases = torch.arange(1, NERF_DEPTH + 1, dtype=torch.float32,
                         device=xy.device) * math.pi
    ang = xy[..., None, :] * bases[:, None]          # (..., N, D, 2)
    return torch.cat([torch.sin(ang).flatten(-2),
                      torch.cos(ang).flatten(-2)], -1)


def mha(p, q, k, v):
    """``nn.MultiheadAttention`` with a fused ``in_proj`` and the output
    projection. q (B, N, d), k/v (B, M, d)."""
    d = q.shape[-1]
    dh = d // NHEAD
    w, b = p["in_proj"]["w"], p["in_proj"]["b"]

    def heads(x, i):
        y = torch.nn.functional.linear(x, w[i * d:(i + 1) * d],
                                       b[i * d:(i + 1) * d])
        return y.unflatten(-1, (NHEAD, dh)).transpose(-2, -3)

    logits = heads(q, 0) @ heads(k, 1).transpose(-1, -2) / dh ** 0.5
    msg = _softmax(logits, -1) @ heads(v, 2)            # (B, H, N, dh)
    return linear(p["out_proj"], msg.transpose(-2, -3).flatten(-2))


def enc_layer(p, src, pos):
    q = src + pos
    src = layer_norm(p["norm1"], src + mha(p["self_attn"], q, q, src))
    ffn = linear(p["linear2"], relu(linear(p["linear1"], src)))
    return layer_norm(p["norm2"], src + ffn)


def dec_layer(p, tgt, memory, pos, query_pos):
    q = tgt + query_pos
    tgt = layer_norm(p["norm1"], tgt + mha(p["self_attn"], q, q, tgt))
    tgt = layer_norm(p["norm2"], tgt + mha(
        p["multihead_attn"], tgt + query_pos, memory + pos, memory))
    ffn = linear(p["linear2"], relu(linear(p["linear1"], tgt)))
    return layer_norm(p["norm3"], tgt + ffn)


def backbone_tokens(params, canvas):
    """canvas (B, 3, H, W), ImageNet-normalised → memory tokens (B, N,
    256), row-major over the stride-16 grid, and their NeRF positions
    (N, 256)."""
    p = params["backbone"]
    x = relu(batch_norm_inference(p["bn1"],
                                  conv2d(p["conv1"], canvas, stride=2)))
    x = max_pool3_s2(x)
    for li, n in zip((1, 2, 3), (3, 4, 6)):  # through layer3 only
        for bi in range(n):
            x = bottleneck_block(p[f"layer{li}"][str(bi)], x,
                                 2 if (bi == 0 and li > 1) else 1)
    x = conv2d(params["input_proj"], x)
    _, d, h, w = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    # PositionEmbeddingNeRF's cumsum of ones: the (i + 0.5) / n centres
    grid = torch.stack([(gx.reshape(-1) + 0.5) / w,
                        (gy.reshape(-1) + 0.5) / h], -1)
    return x.flatten(2).transpose(1, 2), nerf_encode(grid)


def decode(params, memory, pos, queries_xy):
    """Queries (B, N, 2) in canvas-normalised coordinates → their
    predicted correspondences (B, N, 2), canvas-normalised."""
    query_pos = nerf_encode(queries_xy)
    tgt = torch.zeros_like(query_pos)
    dec = params["transformer"]["decoder"]
    for i in range(N_DEC):
        tgt = dec_layer(dec["layers"][str(i)], tgt, memory, pos, query_pos)
    tgt = layer_norm(dec["norm"], tgt)
    ce = params["corr_embed"]["layers"]
    y = relu(linear(ce["1"], relu(linear(ce["0"], tgt))))
    return linear(ce["2"], y)


def query_grid(device):
    """The 16 × 16 query grid's centres on the left half: (256, 2)."""
    c = (torch.arange(GRID, dtype=torch.float32, device=device) + 0.5) / GRID
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([gx.reshape(-1) * 0.5, gy.reshape(-1)], -1)


def apply_pairs(params, image0, image1, threshold):
    """image* (B, 3, 256, 256) in [0, 1] → keypoints0/1 (B, 256, 2) in
    tile pixels, scores (B, 256) and mask (B, 256)."""
    canvas = torch.cat([image0, image1], 3)
    mean = canvas.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = canvas.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    memory, pos = backbone_tokens(params, (canvas - mean) / std)
    enc = params["transformer"]["encoder"]
    for i in range(N_ENC):
        memory = enc_layer(enc["layers"][str(i)], memory, pos)
    q0 = query_grid(canvas.device).expand(len(canvas), -1, -1)
    pred1 = decode(params, memory, pos, q0)
    # cycle consistency: the predictions (right half) mapped back
    pred_back = decode(params, memory, pos, pred1)
    conf = torch.exp(-16.0 * torch.linalg.vector_norm(pred_back - q0,
                                                      dim=-1))
    k0 = torch.stack([q0[..., 0] * 2 * SIZE, q0[..., 1] * SIZE], -1)
    x1 = (pred1[..., 0] - 0.5).clamp(0.0, 0.5)
    k1 = torch.stack([x1 * 2 * SIZE, pred1[..., 1].clamp(0.0, 1.0) * SIZE],
                     -1)
    valid = (conf > threshold) & (pred1[..., 0] > 0.5)
    return {"keypoints0": torch.where(valid[..., None], k0, 0.0),
            "keypoints1": torch.where(valid[..., None], k1, 0.0),
            "scores": torch.where(valid, conf, 0.0), "mask": valid}


class COTR(BaseModel):
    """Standalone matcher {image0, image1} → 256 query correspondences
    with their cycle confidence, in the input images' pixels."""

    default_conf = {
        "weights": "out/default",
        "match_threshold": 0.2,
        "max_keypoints": -1,
        "model_name": "checkpoint.pth.tar",
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        init = weights.seeded_init(init_params, self.device)
        self.params, self.meta = weights.load_trained(conf, init, "cotr",
                                                      self.device)

    def _forward(self, data):
        def prep(key):
            x = torch.as_tensor(data[key], dtype=torch.float32,
                                device=self.device)
            if x.shape[1] == 1:
                x = x.expand(-1, 3, -1, -1)
            scale = x.new_tensor([x.shape[3] / SIZE, x.shape[2] / SIZE])
            return resize(x, (SIZE, SIZE), "bilinear"), scale

        (x0, s0), (x1, s1) = prep("image0"), prep("image1")
        # an untrained confidence head is not calibrated: gate at 0
        thr = float(self.conf["match_threshold"]) \
            if self.meta.get("pretrained") else 0.0
        with full_fp32():
            out = apply_pairs(self.params, x0, x1, thr)
        out["keypoints0"] = out["keypoints0"] * s0
        out["keypoints1"] = out["keypoints1"] * s1
        out["mconf"] = out["scores"]
        return out
