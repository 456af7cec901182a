"""DeDoDe ("detect, don't describe; describe, don't detect"), float32.

Counterpart of ``imcui_tpu/models/extractors/dedode.py`` on NCHW tensors:
two independent networks, the detector (L) and the descriptor (B). Each
is a VGG19-BN encoder of its own (torchvision's ``vgg19_bn().features``
through its fourth pool, held as ``encoder.layers.{torch index}``; the
activation entering each pool is kept, at strides 1, 2, 4 and 8, and the
last pool, which feeds nothing, is not run) and a coarse-to-fine decoder
of one refiner a scale. A refiner is a block (5 × 5 conv, BatchNorm,
ReLU, 1 × 1 conv), a residual stack of such blocks (a ``lax.scan`` in the
JAX module, a loop here) and a 1 × 1 head that emits P prototype
channels and the context of the next scale. The P channels add up across
scales through ``ops/resize.py::torch_interpolate``'s bicubic, the
context goes through its half-pixel bilinear:

    detector L:   P = 1,   hidden 512/256/128/64, context 256/128/64, 8 blocks
    descriptor B: P = 256, hidden 512/256/64/32,  context 256/128/32, 5 blocks

Detection is DeDoDe's sampling without NMS: a softmax over all H·W pixels
of the canvas, divided by the square root of its own density under a
separable 51-tap Gaussian (``coverage_reweight``), −1 outside the valid
region, then the top ``max_keypoints`` at threshold −0.5, so that every
slot of the valid region is filled. Descriptors are the 256-d map
sampled bilinearly (half-pixel, ``ops/sampling.py::grid_sample``) at the
keypoints, L2-normalised. Inputs are ImageNet-normalised after a zero pad
to multiples of 8. Every convolution runs under ``layers.full_fp32``.

No trained tree (``dedode_detector_L.pth``, ``dedode_descriptor_B.pth``)
is in the repository: the model runs a user's ``checkpoint_npz`` (both
networks in one tree) or the port's seed-0 random tree, reported in
``meta``, whose residual branches start small (``RESIDUAL_INIT``).
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...ops.resize import torch_interpolate
from ...ops.sampling import grid_sample
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

DESC_DIM = 256

# torchvision vgg19_bn().features[:40]: (kind, torch index, cin, cout)
VGG19_BN = [
    ("conv", 0, 3, 64), ("conv", 3, 64, 64), ("pool", 6, None, None),
    ("conv", 7, 64, 128), ("conv", 10, 128, 128), ("pool", 13, None, None),
    ("conv", 14, 128, 256), ("conv", 17, 256, 256),
    ("conv", 20, 256, 256), ("conv", 23, 256, 256),
    ("pool", 26, None, None),
    ("conv", 27, 256, 512), ("conv", 30, 512, 512),
    ("conv", 33, 512, 512), ("conv", 36, 512, 512),
    ("pool", 39, None, None),
]

# scale: (refiner input channels, hidden channels, context channels out)
DET_REFINERS = {"8": (512, 512, 256), "4": (512, 256, 128),
                "2": (256, 128, 64), "1": (128, 64, 0)}
DET_BLOCKS = 8
DESC_REFINERS = {"8": (512, 512, 256), "4": (512, 256, 128),
                 "2": (256, 64, 32), "1": (96, 32, 0)}
DESC_BLOCKS = 5

SCALES = ("8", "4", "2", "1")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
COVERAGE_TAPS = 51
# the random tree's residual branches end in a 1 × 1 conv at this share of
# He's scale: at full scale each of the stacked residual blocks doubles the
# activations' variance, four refiners compound it through their context,
# and the detector's logits reach ~1e7, so that its softmax puts all mass on
# one pixel and every other slot ties at 0
RESIDUAL_INIT = 0.1


def init_block(gen, cin, cout, residual=False):
    """Upstream ConvRefiner.create_block: torch children 0 (5 × 5 conv),
    1 (BatchNorm), 3 (1 × 1 conv); a residual block's last conv at
    RESIDUAL_INIT of He's scale."""
    last = init_conv(gen, 1, 1, cout, cout)
    if residual:
        last["w"] = last["w"] * RESIDUAL_INIT
    return {"0": init_conv(gen, 5, 5, cin, cout), "1": init_bn(cout),
            "3": last}


def block_apply(blk, x):
    return conv2d(blk["3"], relu(batch_norm_inference(blk["1"],
                                                      conv2d(blk["0"], x))))


def init_vgg19(gen):
    layers = {}
    for kind, idx, cin, cout in VGG19_BN:
        if kind == "conv":
            layers[str(idx)] = init_conv(gen, 3, 3, cin, cout)
            layers[str(idx + 1)] = init_bn(cout)
    return {"layers": layers}


def vgg19_apply(enc, x):
    """x: (B, 3, H, W) → {1: (B, 64, H, W), 2: …, 4: …, 8: (B, 512, H/8,
    W/8)}, each the activation entering a pool."""
    feats, stride, p = {}, 1, enc["layers"]
    for kind, idx, _, _ in VGG19_BN:
        if kind == "pool":
            feats[stride] = x
            if stride < 8:
                x = max_pool(x)
            stride *= 2
        else:
            x = relu(batch_norm_inference(p[str(idx + 1)],
                                          conv2d(p[str(idx)], x)))
    return feats


def init_decoder(gen, refiners, blocks, num_prototypes):
    return {"layers": {
        scale: {"block1": init_block(gen, cin, hidden),
                "hidden_blocks": [init_block(gen, hidden, hidden, True)
                                  for _ in range(blocks)],
                "out_conv": init_conv(gen, 1, 1, hidden,
                                      num_prototypes + ctx)}
        for scale, (cin, hidden, ctx) in refiners.items()}}


def refiner_apply(p, x):
    x = block_apply(p["block1"], x)
    for blk in p["hidden_blocks"]:
        x = x + block_apply(blk, x)
    return conv2d(p["out_conv"], x)


def decoder_apply(dec, feats, num_prototypes):
    """The P-channel map at full resolution: at each scale the refiner
    reads cat(feature, context) and adds its P channels to the running
    map, which goes up a scale bicubic, the context bilinear."""
    acc = ctx = None
    for scale in SCALES:
        f = feats[int(scale)]
        x = f if ctx is None else torch.cat([f, ctx], 1)
        out = refiner_apply(dec["layers"][scale], x)
        delta, ctx = out[:, :num_prototypes], out[:, num_prototypes:]
        acc = delta if acc is None else acc + delta
        if scale != "1":
            hw = feats[int(scale) // 2].shape[-2:]
            acc = torch_interpolate(acc, hw, "bicubic")
            ctx = torch_interpolate(ctx, hw, "bilinear")
    return acc


def init_params(gen):
    return {
        "detector": {"encoder": init_vgg19(gen),
                     "decoder": init_decoder(gen, DET_REFINERS, DET_BLOCKS,
                                             1)},
        "descriptor": {"encoder": init_vgg19(gen),
                       "decoder": init_decoder(gen, DESC_REFINERS,
                                               DESC_BLOCKS, DESC_DIM)},
    }


def coverage_reweight(p, eps=1e-6):
    """p / sqrt(density), the density a separable 51-tap Gaussian
    (exp(−x²) on linspace(−2, 2, 51), zero padding 25) of p + eps, along
    W and then H. p: (B, H, W)."""
    taps = torch.exp(-torch.linspace(-2.0, 2.0, COVERAGE_TAPS,
                                     device=p.device) ** 2).to(p.dtype)
    half = COVERAGE_TAPS // 2
    with full_fp32():
        x = F.conv2d((p + eps)[:, None], taps.view(1, 1, 1, -1),
                     padding=(0, half))
        x = F.conv2d(x, taps.view(1, 1, -1, 1), padding=(half, 0))
    return p * torch.rsqrt(x[:, 0] + eps)


def detect(det, x, valid_wh, max_keypoints):
    """The detector on ImageNet-normalised x (B, 3, H, W): keypoints (B,
    K, 2), their re-weighted scores and the mask."""
    b, _, h, w = x.shape
    with full_fp32():
        logits = decoder_apply(det["decoder"], vgg19_apply(det["encoder"],
                                                           x), 1)[:, 0]
    p = torch.softmax(logits.reshape(b, -1), -1).reshape(b, h, w)
    s = coverage_reweight(p)
    valid = nms_ops.border_mask(h, w, 0, valid_wh, device=s.device)
    s = torch.where(valid, s, -1.0)
    return nms_ops.select_topk_keypoints(s, max_keypoints, -0.5)


def describe(desc, x, kpts):
    """The descriptor network on x at keypoints (B, K, 2): (B, 256, K),
    unit columns."""
    h, w = x.shape[-2:]
    with full_fp32():
        dmap = decoder_apply(desc["decoder"], vgg19_apply(desc["encoder"],
                                                          x), DESC_DIM)
    grid = torch.stack([2.0 * (kpts[..., 0] + 0.5) / w - 1.0,
                        2.0 * (kpts[..., 1] + 0.5) / h - 1.0], -1)
    d = torch.stack([grid_sample(dmap[i], grid[i], "bilinear")
                     for i in range(len(kpts))])
    return l2_normalize(d, dim=1, eps=1e-8)


def apply(params, image, valid_wh, max_keypoints=2000):
    """image: (B, 3, H, W) in [0, 1], H and W multiples of 8; valid_wh
    (B, 2) int. Returns keypoints, scores, descriptors (B, 256, K), mask."""
    mean = image.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = image.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    x = (image - mean) / std
    kpts, kscores, mask = detect(params["detector"], x, valid_wh,
                                 max_keypoints)
    return {"keypoints": kpts, "scores": kscores,
            "descriptors": describe(params["descriptor"], x, kpts),
            "mask": mask}


class DeDoDe(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "name": "dedode",
        "model_detector_name": "dedode_detector_L.pth",
        "model_descriptor_name": "dedode_descriptor_B.pth",
        "max_keypoints": 2000,
        "match_threshold": 0.2,
        "dense": False,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "dedode",
            self.device)
        if conf["max_keypoints"] in (-1, None):
            conf["max_keypoints"] = 2000

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        b, _, h, w = image.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        image = F.pad(image, (0, wp - w, 0, hp - h))
        valid_wh = torch.as_tensor(
            data["valid_wh"] if "valid_wh" in data else [[w, h]] * b,
            device=self.device).to(torch.int32)
        return apply(self.params, image, valid_wh,
                     max_keypoints=int(self.conf["max_keypoints"]))
