"""FIRe global descriptor from super-features. Counterpart of
``imcui_tpu/models/extractors/fire.py``.

A ResNet-18-style trunk to stride 16 (the 7 × 7 stem, a 3 × 3 stride-2
pool without padding, then layers 1-3 of two basic blocks each, to 256
channels), then the iterative super-feature attention: 64 learned
queries attend to the feature map for 3 iterations; each iteration's
softmax runs over the query axis (each location votes for its best
query), its per-query sums are the attention mass, the attention is
renormalised by that mass, and the queries take a LayerNorm'd residual
step. The unit super-features weighted by the last iteration's mass,
summed and L2-normalised, are one scale's descriptor; the descriptors of
the scales 1.414, 1.0, 0.707 and 0.5 of the conf's pyramid (those in
[0.5, 1.5]), each a bilinear resize (``ops.resize.resize``, half-pixel
and antialiasing, as ``jax.image.resize``) to multiples of 32, are summed
and L2-normalised again.

No FIRe checkpoint (``fire_SfM_120k.pth``) is in the repository: the
model runs a user's ``checkpoint_npz`` or the port's seed-0 tree, which
``meta`` reports.
"""

import torch

from ...ops.matching import _softmax
from ...ops.resize import resize
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones.resnet import basic_block, init_basic_block
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, init_layer_norm, init_linear, l2_normalize,
                      layer_norm, linear, max_pool, relu)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
N_SUPER = 64     # super-feature queries
N_ITER = 3       # attention iterations
DIM = 256


def init_params(gen):
    return {
        "stem": {"conv": init_conv(gen, 7, 7, 3, 64, bias=False),
                 "bn": init_bn(64)},
        "layer1": [init_basic_block(gen, 64, 64, 1),
                   init_basic_block(gen, 64, 64, 1)],
        "layer2": [init_basic_block(gen, 64, 128, 2),
                   init_basic_block(gen, 128, 128, 1)],
        "layer3": [init_basic_block(gen, 128, DIM, 2),
                   init_basic_block(gen, DIM, DIM, 1)],
        "queries": torch.randn((N_SUPER, DIM), generator=gen) * 0.02,
        "q_proj": init_linear(gen, DIM, DIM),
        "k_proj": init_linear(gen, DIM, DIM),
        "v_proj": init_linear(gen, DIM, DIM),
        "ln": init_layer_norm(DIM),
    }


def load_params(conf, device):
    return weights.load_trained(
        conf, init_params(torch.Generator().manual_seed(0)), "fire", device)


def trunk(params, x):
    """x (B, 3, H, W), ImageNet-normalised → (B, 256, H/16, W/16)."""
    s = params["stem"]
    x = relu(batch_norm_inference(s["bn"], conv2d(s["conv"], x, stride=2)))
    x = max_pool(x, 3, 2)
    for name in ("layer1", "layer2", "layer3"):
        for i, blk in enumerate(params[name]):
            x = basic_block(blk, x, 2 if (i == 0 and name != "layer1")
                            else 1)
    return x


def superfeatures(params, fmap):
    """fmap (B, 256, H, W) → unit super-features (B, 64, 256) and their
    attention mass (B, 64)."""
    b, d = fmap.shape[:2]
    tokens = fmap.flatten(2).transpose(1, 2)            # (B, N, D)
    k = linear(params["k_proj"], tokens)
    v = linear(params["v_proj"], tokens)
    q = params["queries"].expand(b, -1, -1)
    mass = None
    for _ in range(N_ITER):
        logits = linear(params["q_proj"], q) @ k.transpose(1, 2)
        # softmax over the QUERY axis: each location votes for a query
        attn = _softmax(logits / d ** 0.5, 1)
        mass = attn.sum(-1)
        attn = attn / mass[..., None].clamp_min(1e-6)
        q = layer_norm(params["ln"], q + attn @ v)
    return l2_normalize(q, -1), mass


def normalized(image):
    mean = image.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = image.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    return (image - mean) / std


def apply_global(params, image):
    """One scale: image (B, 3, H, W) in [0, 1] → (B, 256)."""
    sf, mass = superfeatures(params, trunk(params, normalized(image)))
    return l2_normalize((sf * mass[..., None]).sum(1), -1)


def pyramid(image, scales):
    """The image at each scale, each side rounded to a multiple of 32
    (at least 32)."""
    h, w = image.shape[2:]
    for s in scales:
        yield resize(image, (max(32, int(round(h * s / 32)) * 32),
                             max(32, int(round(w * s / 32)) * 32)),
                     "bilinear")


def central_scales(scales):
    """The scales of the pyramid that run: those in [0.5, 1.5], which
    carry almost all of the descriptor's mass."""
    return [s for s in scales if 0.5 <= s <= 1.5]


class FIRe(BaseModel):
    """{"image" (B, C, H, W)} → {"global_descriptor" (B, 256)}; a grey
    image is repeated over three channels."""

    default_conf = {
        "global": True,
        "asmk": False,
        "model_name": "fire_SfM_120k.pth",
        "scales": [2.0, 1.414, 1.0, 0.707, 0.5, 0.353, 0.25],
        "features_num": 1000,
        "config_name": "eval_fire.yml",
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        self.scales = central_scales(conf["scales"])

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        with full_fp32():
            g = sum(apply_global(self.params, x)
                    for x in pyramid(image, self.scales))
        return {"global_descriptor": l2_normalize(g, -1)}
