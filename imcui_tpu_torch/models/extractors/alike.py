"""ALIKE keypoint detector and descriptor, float32.

Counterpart of ``imcui_tpu/models/extractors/alike.py`` (ALNet and DKD)
on NCHW tensors:

- encoder: a ConvBlock (3 → c1) at full resolution, ResBlocks at 1/2,
  1/8 and 1/32 (a 2 × 2 max-pool before block2, 4 × 4 before blocks 3
  and 4); 3 × 3 bias-free convs with BatchNorm, and a biased 1 × 1
  ``downsample`` on each ResBlock's identity path;
- aggregation: bias-free 1 × 1 convs to dim/4 with ReLU, upsampling by
  ``ops/resize.py::torch_interpolate`` with ``align_corners=True``,
  concatenation; ``convhead1`` + ReLU for ``alike-l`` only, then
  ``convhead2`` to dim descriptor channels and one score channel
  (sigmoid); the descriptor map is L2-normalised;
- detection: window NMS, border mask, top-k over the threshold, the
  soft-argmax sub-pixel refinement (``sub_pixel``), descriptors sampled
  bilinearly at the keypoints (``ops/nms.py::sample_bilinear``) and
  normalised again.

Every convolution runs under ``layers.full_fp32``. No trained ALIKE
tree is in the repository: the model runs a user's ``checkpoint_npz`` or
the port's seed-0 random tree, reported in ``meta``. ALIKE reads
``max_keypoints`` and ``detection_threshold``, so ``ImageMatchingAPI``'s
``keypoint_threshold`` does not reach it.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...ops.resize import torch_interpolate
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

SIZES = {
    "alike-t": dict(c1=8, c2=16, c3=32, c4=64, dim=64, single_head=True),
    "alike-s": dict(c1=8, c2=16, c3=48, c4=96, dim=96, single_head=True),
    "alike-n": dict(c1=16, c2=32, c3=64, c4=128, dim=128, single_head=True),
    "alike-l": dict(c1=32, c2=64, c3=128, c4=128, dim=128,
                    single_head=False),
}


def init_conv_block(gen, cin, cout):
    return {"conv1": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn1": init_bn(cout),
            "conv2": init_conv(gen, 3, 3, cout, cout, bias=False),
            "bn2": init_bn(cout)}


def conv_block(p, x):
    x = relu(batch_norm_inference(p["bn1"], conv2d(p["conv1"], x)))
    return relu(batch_norm_inference(p["bn2"], conv2d(p["conv2"], x)))


def init_res_block(gen, cin, cout):
    return {"conv1": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn1": init_bn(cout),
            "conv2": init_conv(gen, 3, 3, cout, cout, bias=False),
            "bn2": init_bn(cout),
            # upstream: downsample = nn.Conv2d(cin, cout, 1), biased
            "downsample": init_conv(gen, 1, 1, cin, cout)}


def res_block(p, x):
    y = relu(batch_norm_inference(p["bn1"], conv2d(p["conv1"], x)))
    y = batch_norm_inference(p["bn2"], conv2d(p["conv2"], y))
    return relu(y + conv2d(p["downsample"], x))


def init_params(gen, c1, c2, c3, c4, dim, single_head=True):
    """Random tree in torch layout with the JAX ``init_params``'s keys."""
    q = dim // 4
    params = {
        "block1": init_conv_block(gen, 3, c1),
        "block2": init_res_block(gen, c1, c2),
        "block3": init_res_block(gen, c2, c3),
        "block4": init_res_block(gen, c3, c4),
        "conv1": init_conv(gen, 1, 1, c1, q, bias=False),
        "conv2": init_conv(gen, 1, 1, c2, q, bias=False),
        "conv3": init_conv(gen, 1, 1, c3, q, bias=False),
        "conv4": init_conv(gen, 1, 1, c4, q, bias=False),
        "convhead2": init_conv(gen, 1, 1, dim, dim + 1, bias=False),
    }
    if not single_head:
        params["convhead1"] = init_conv(gen, 1, 1, dim, dim, bias=False)
    return params


def backbone(p, x):
    """x: (B, 3, H, W), H and W multiples of 32 → the L2-normalised
    descriptor map (B, dim, H, W) and the score map (B, H, W) in (0, 1)."""
    x1 = conv_block(p["block1"], x)                       # 1
    x2 = res_block(p["block2"], max_pool(x1))             # 1/2
    x3 = res_block(p["block3"], max_pool(x2, 4, 4))       # 1/8
    x4 = res_block(p["block4"], max_pool(x3, 4, 4))       # 1/32
    hw = x.shape[-2:]

    def up(feat):
        return torch_interpolate(feat, hw, mode="bilinear",
                                 align_corners=True)

    feats = torch.cat([relu(conv2d(p["conv1"], x1)),
                       up(relu(conv2d(p["conv2"], x2))),
                       up(relu(conv2d(p["conv3"], x3))),
                       up(relu(conv2d(p["conv4"], x4)))], 1)
    if "convhead1" in p:
        feats = relu(conv2d(p["convhead1"], feats))
    head = conv2d(p["convhead2"], feats)
    return l2_normalize(head[:, :-1], dim=1), torch.sigmoid(head[:, -1])


def apply(params, image, valid_wh, max_keypoints=1024, nms_radius=2,
          detection_threshold=0.2, sub_pixel=True):
    """image: (B, 3, H, W) in [0, 1], H and W multiples of 32; valid_wh
    (B, 2). Returns keypoints (B, N, 2), scores (B, N), descriptors (B,
    dim, N) and mask (B, N)."""
    with full_fp32():
        desc_map, heat = backbone(params, image)
    h, w = heat.shape[-2:]
    s = nms_ops.simple_nms(heat, nms_radius)
    s = s * nms_ops.border_mask(h, w, 2, valid_wh, device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(
        s, max_keypoints, detection_threshold)
    if sub_pixel:
        kpts = nms_ops.soft_argmax_refinement(kpts, heat, radius=2)
    desc = l2_normalize(nms_ops.sample_bilinear(desc_map, kpts), dim=1)
    return {"keypoints": kpts, "scores": kscores, "descriptors": desc,
            "mask": mask}


class Alike(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "model_name": "alike-n",  # alike-t | alike-s | alike-n | alike-l
        "use_relu": True,
        "multiscale": False,
        "max_keypoints": 1024,
        "detection_threshold": 0.2,
        "nms_radius": 2,
        "sub_pixel": True,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0),
                              **SIZES[conf["model_name"]]),
            "alike", self.device)
        if conf["max_keypoints"] in (-1, None):
            conf["max_keypoints"] = 4096

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.repeat(1, 3, 1, 1)
        b, _, h, w = image.shape
        image = F.pad(image, (0, -w % 32, 0, -h % 32))
        if "valid_wh" in data:
            valid_wh = torch.as_tensor(data["valid_wh"], device=self.device)
        else:
            valid_wh = torch.tensor([[w, h]], device=self.device).expand(b, 2)
        return apply(self.params, image, valid_wh.to(torch.int32),
                     max_keypoints=self.conf["max_keypoints"],
                     nms_radius=self.conf["nms_radius"],
                     detection_threshold=float(
                         self.conf["detection_threshold"]),
                     sub_pixel=self.conf["sub_pixel"])
