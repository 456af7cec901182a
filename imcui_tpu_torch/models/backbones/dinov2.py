"""DINOv2 Vision Transformer (ViT-L/14 and smaller). Counterpart of
``imcui_tpu/models/backbones/dinov2.py``: 14 × 14 patch embed, cls token,
learned position embedding resampled bicubically to the input grid,
pre-LN blocks with LayerScale on both residual branches, GELU MLP, final
LayerNorm. RoMa reads the normed patch tokens without the cls token.

Every block's attention goes through ``ops.attention.mha_auto``: on the
card that is kernel K14 for a bf16 tree and K3 for a float32 one (1601
tokens at RoMa's 560² input). ``convert_state_dict`` of the JAX module
reads an upstream checkpoint and waits for one to be in the repository.
"""

import torch

from ...ops import resize as resize_ops
from ...ops.attention import mha_auto
from ..layers import (conv2d, gelu, init_conv, init_layer_norm, init_linear,
                      layer_norm, linear)

CONFIGS = {
    "vitl14": {"dim": 1024, "depth": 24, "num_heads": 16, "mlp_ratio": 4,
               "patch": 14, "pretrain_grid": 37},  # 518 / 14
    "vitb14": {"dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4,
               "patch": 14, "pretrain_grid": 37},
    # tiny configuration for tests
    "test": {"dim": 64, "depth": 2, "num_heads": 4, "mlp_ratio": 4,
             "patch": 14, "pretrain_grid": 37},
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _config(cfg):
    return CONFIGS[cfg] if isinstance(cfg, str) else cfg


def init_block(gen, dim, mlp_ratio):
    return {
        "norm1": init_layer_norm(dim),
        "attn": {"qkv": init_linear(gen, dim, 3 * dim),
                 "proj": init_linear(gen, dim, dim)},
        "ls1": {"gamma": torch.full((dim,), 1e-5)},
        "norm2": init_layer_norm(dim),
        "mlp": {"fc1": init_linear(gen, dim, dim * mlp_ratio),
                "fc2": init_linear(gen, dim * mlp_ratio, dim)},
        "ls2": {"gamma": torch.full((dim,), 1e-5)},
    }


def init_params(gen, cfg):
    c = _config(cfg)
    dim, g = c["dim"], c["pretrain_grid"]
    return {
        "patch_embed": {"proj": init_conv(gen, c["patch"], c["patch"], 3,
                                          dim)},
        "cls_token": torch.zeros((1, dim)),
        "pos_embed": torch.randn((1 + g * g, dim), generator=gen) * 0.02,
        "blocks": [init_block(gen, dim, c["mlp_ratio"])
                   for _ in range(c["depth"])],
        "norm": init_layer_norm(dim),
    }


def _interp_pos_embed(pos_embed, hp, wp):
    """Resample the (1 + g², dim) pretraining position grid bicubically to
    (1 + hp·wp, dim)."""
    cls_pe, patch_pe = pos_embed[:1], pos_embed[1:]
    g = int(round(float(patch_pe.shape[0]) ** 0.5))
    if (hp, wp) != (g, g):
        grid = resize_ops.resize(patch_pe.reshape(g, g, -1), (hp, wp),
                                 "bicubic", dims=(0, 1))
        patch_pe = grid.reshape(hp * wp, -1)
    return torch.cat([cls_pe, patch_pe], 0)


def _attn(p, x, num_heads):
    n, d = x.shape
    dh = d // num_heads
    qkv = linear(p["qkv"], x).reshape(n, 3, num_heads, dh)
    q, k, v = (qkv[:, i].transpose(0, 1).contiguous() for i in range(3))
    out = mha_auto(q, k, v).to(x.dtype)
    return linear(p["proj"], out.transpose(0, 1).reshape(n, d))


def mlp(p, x):
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def block_apply(p, x, num_heads):
    x = x + p["ls1"]["gamma"] * _attn(p["attn"], layer_norm(p["norm1"], x),
                                      num_heads)
    return x + p["ls2"]["gamma"] * mlp(p["mlp"], layer_norm(p["norm2"], x))


def apply(params, image, cfg, normalize=True):
    """image: (3, H, W) in [0, 1], H and W multiples of the patch size.
    Returns the normed patch tokens (Hp·Wp, dim), row-major, and
    (Hp, Wp)."""
    c = _config(cfg)
    if normalize:
        # float32 constants: a bf16 image is widened here and narrowed
        # again by the patch embed, as in the JAX module
        mean = torch.tensor(IMAGENET_MEAN, device=image.device)
        std = torch.tensor(IMAGENET_STD, device=image.device)
        image = (image - mean[:, None, None]) / std[:, None, None]
    x = conv2d(params["patch_embed"]["proj"], image[None],
               stride=c["patch"], padding="VALID")[0]
    dim, hp, wp = x.shape
    tokens = torch.cat([params["cls_token"], x.reshape(dim, hp * wp).t()], 0)
    tokens = tokens + _interp_pos_embed(params["pos_embed"], hp, wp)
    for blk in params["blocks"]:
        tokens = block_apply(blk, tokens, c["num_heads"])
    tokens = layer_norm(params["norm"], tokens)
    return tokens[1:], (hp, wp)
