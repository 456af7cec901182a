"""SFD2 (semantic-guided feature detection and description), float32.

Counterpart of ``imcui_tpu/models/extractors/sfd2.py`` on NCHW tensors:
ImageNet-normalised RGB through a 7 × 7 stride-2 stem (torch-symmetric
padding, BatchNorm, ReLU), a 3 × 3 stride-2 max-pool without padding
(VALID, not torchvision's padded stem pool), two layers of ResNet basic
blocks (64 and 128 wide, the second at stride 2;
``backbones/resnet.py``), and the ×2 half-pixel bilinear upsample back to
1/4 (``ops/resize.py::resize``, the JAX module's ``jax.image.resize``).
Heads: a softplus detection map times a sigmoid semantic-stability map,
and a 128-d descriptor map, L2-normalised. Detection: ``simple_nms`` at
radius 2, a border of 2 cells and the valid canvas masked at 1/4, fixed-k
selection at ``conf_th``; keypoints are cells times 4, descriptors
sampled at them with ``sample_descriptors(s=4)``. Every convolution runs
under ``layers.full_fp32``.

SFD2 reads ``max_keypoints`` and ``conf_th``, not the API's
``keypoint_threshold``. No trained tree (``resnet4x.79.pth``) is in the
repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 random tree, reported in ``meta``.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...ops.resize import resize
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones.resnet import basic_block, init_basic_block
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

DESC_DIM = 128
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_params(gen):
    return {
        "stem": {"conv": init_conv(gen, 7, 7, 3, 64, bias=False),
                 "bn": init_bn(64)},
        "layer1": [init_basic_block(gen, 64, 64, 1),
                   init_basic_block(gen, 64, 64, 1)],
        "layer2": [init_basic_block(gen, 64, 128, 2),
                   init_basic_block(gen, 128, 128, 1)],
        "det": [init_conv(gen, 3, 3, 128, 128), init_conv(gen, 1, 1, 128, 1)],
        "sem": [init_conv(gen, 3, 3, 128, 128), init_conv(gen, 1, 1, 128, 1)],
        "desc": init_conv(gen, 1, 1, 128, DESC_DIM),
    }


def backbone(params, x):
    """x: (B, 3, H, W) normalised → score (B, h, w) and the unit
    descriptor map (B, 128, h, w), (h, w) twice the stride-8 trunk's."""
    s = params["stem"]
    x = relu(batch_norm_inference(s["bn"], conv2d(s["conv"], x, stride=2)))
    x = max_pool(x, 3, 2)
    for blk in params["layer1"]:
        x = basic_block(blk, x, 1)
    for i, blk in enumerate(params["layer2"]):
        x = basic_block(blk, x, 2 if i == 0 else 1)
    h, w = x.shape[-2:]
    x4 = resize(x, (2 * h, 2 * w), "bilinear")
    det = F.softplus(conv2d(params["det"][1],
                            relu(conv2d(params["det"][0], x4))))
    sem = torch.sigmoid(conv2d(params["sem"][1],
                               relu(conv2d(params["sem"][0], x4))))
    desc = l2_normalize(conv2d(params["desc"], x4), dim=1, eps=1e-8)
    return (det * sem)[:, 0], desc


def apply(params, image, valid_wh, max_keypoints=4096, conf_th=0.001):
    """image: (B, 3, H, W) in [0, 1]; valid_wh (B, 2) int. Returns
    keypoints (B, N, 2), scores, descriptors (B, 128, N), mask."""
    mean = image.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = image.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    with full_fp32():
        score, desc_map = backbone(params, (image - mean) / std)
    h, w = score.shape[1:]
    s = nms_ops.simple_nms(score, 2)
    s = s * nms_ops.border_mask(h, w, 2, torch.div(
        valid_wh + 3, 4, rounding_mode="floor"), device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        conf_th)
    kpts = kpts * 4.0
    return {"keypoints": kpts, "scores": kscores,
            "descriptors": nms_ops.sample_descriptors(kpts, desc_map, s=4),
            "mask": mask}


class SFD2(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "max_keypoints": 4096,
        "model_name": "sfd2_20230511_210205_resnet4x.79.pth",
        "conf_th": 0.001,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "sfd2",
            self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        b, _, h, w = image.shape
        valid_wh = torch.as_tensor(
            data["valid_wh"] if "valid_wh" in data else [[w, h]] * b,
            device=self.device).to(torch.int32)
        return apply(self.params, image, valid_wh,
                     max_keypoints=int(self.conf["max_keypoints"]),
                     conf_th=float(self.conf["conf_th"]))
