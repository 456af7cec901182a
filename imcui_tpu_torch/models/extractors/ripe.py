"""RIPE (reinforcement-learned keypoints on VGG hypercolumns), float32.

Counterpart of ``imcui_tpu/models/extractors/ripe.py`` on NCHW tensors:
three VGG stages of conv-BN-ReLU (64 x 2, 128 x 2, 256 x 3) with 2 x 2
max-pools between them; the three stage maps brought to the middle
stage's plane (1/2) by ``ops.resize.resize`` (``jax.image.resize``
bilinear, which antialiases the full-resolution map as it shrinks it) and
concatenated into a 448-channel hypercolumn; a 1 x 1 detection head (64
channels, ReLU, 1, sigmoid) and a 1 x 1 256-d descriptor head,
L2-normalised. Keypoints from ``simple_nms`` at radius 2, a border of 2
and the valid canvas (halved, rounded up) masked, fixed-k selection at
threshold 0.0 (the conf's ``keypoint_threshold`` is read and ignored, as
in the JAX module), descriptors sampled at the plane's own resolution
(``s=1``), points doubled to image pixels. Every convolution runs under
``layers.full_fp32``.

No trained tree (``weights_ripe.pth``) is in the repository: the model
runs a user's ``checkpoint_npz`` or the port's seed-0 random tree,
reported in ``meta``.
"""

import torch

from ...ops import nms as nms_ops
from ...ops.resize import resize
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

DESC_DIM = 256
STAGES = [(64, 2), (128, 2), (256, 3)]  # (channels, convs) per VGG stage


def init_params(gen):
    params, cin = {"stages": []}, 3
    for cout, convs in STAGES:
        stage = []
        for _ in range(convs):
            stage.append({"conv": init_conv(gen, 3, 3, cin, cout, bias=False),
                          "bn": init_bn(cout)})
            cin = cout
        params["stages"].append(stage)
    hyper_c = sum(c for c, _ in STAGES)
    params["det"] = [init_conv(gen, 1, 1, hyper_c, 64),
                     init_conv(gen, 1, 1, 64, 1)]
    params["desc"] = init_conv(gen, 1, 1, hyper_c, DESC_DIM)
    return params


def backbone(params, x):
    """x: (B, 3, H, W) → score (B, H/2, W/2), descriptors (B, 256, H/2,
    W/2)."""
    maps = []
    for i, stage in enumerate(params["stages"]):
        for p in stage:
            x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x)))
        maps.append(x)
        if i < len(params["stages"]) - 1:
            x = max_pool(x)
    size = maps[1].shape[-2:]
    hyper = torch.cat([resize(m, size, "bilinear") for m in maps], 1)
    score = torch.sigmoid(conv2d(params["det"][1],
                                 relu(conv2d(params["det"][0], hyper))))
    desc = l2_normalize(conv2d(params["desc"], hyper), dim=1, eps=1e-8)
    return score[:, 0], desc


def apply(params, image, valid_wh, max_keypoints=5000, threshold=0.0):
    """image: (B, 3, H, W) → keypoints (B, N, 2), scores, descriptors
    (B, 256, N), mask."""
    with full_fp32():
        score, desc_map = backbone(params, image)
    h, w = score.shape[1:]
    s = nms_ops.simple_nms(score, 2)
    s = s * nms_ops.border_mask(h, w, 2, torch.div(valid_wh + 1, 2,
                                                   rounding_mode="floor"),
                                device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        threshold)
    desc = nms_ops.sample_descriptors(kpts, desc_map, s=1)
    return {"keypoints": kpts * 2.0, "scores": kscores, "descriptors": desc,
            "mask": mask}


class RIPE(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A gray image is repeated to
    three channels."""

    default_conf = {
        "keypoint_threshold": 0.05,  # read and ignored: the gate is 0.0
        "max_keypoints": 5000,
        "model_name": "weights_ripe.pth",
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "ripe",
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
                     threshold=0.0)
