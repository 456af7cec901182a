"""RaCo (ranked, covariance-aware keypoints) described by ALIKED, float32.

Counterpart of ``imcui_tpu/models/extractors/raco.py`` on NCHW tensors.
The detector is a trunk of four 3 × 3 convolutions without bias, each
with inference batch norm and ReLU, a 2 × 2 max-pool after the second,
and three 1 × 1 heads at half resolution: a sigmoid heat map, a sigmoid
ranker and a softplus covariance (σxx, σyy, σxy).

``detect`` runs ``simple_nms`` at ``nms_radius``, masks 2 px of border
inside the valid half-resolution canvas, takes the top
``max_num_keypoints`` at 0.0 by the heat (or heat × ranker with
``sort_by_ranker``), refines them by a soft-argmax over 5 × 5 windows of
heat^(1/``subpixel_temp``), reads the covariance at the refined point's
integer cell and doubles the keypoints to the input's pixels. ALIKED's
``describe`` (its SDDH head on the same image) gives the descriptors.

No trained tree (RaCo's ``raco``) is in the repository: the model runs a
user's ``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``; the describer is ALIKED's own (trained tree or seed 0).
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, max_pool, relu)
from .aliked import ALIKED


def _cbr(gen, cin, cout):
    return {"conv": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn": init_bn(cout)}


def init_params(gen):
    return {
        "trunk": [_cbr(gen, 3, 32), _cbr(gen, 32, 32),
                  _cbr(gen, 32, 64), _cbr(gen, 64, 64)],
        "heat": init_conv(gen, 1, 1, 64, 1),
        "ranker": init_conv(gen, 1, 1, 64, 1),
        "cov": init_conv(gen, 1, 1, 64, 3),
    }


def backbone(params, x):
    """x: (B, 3, H, W) → heat (B, H/2, W/2), ranker (B, H/2, W/2),
    covariance (B, 3, H/2, W/2)."""
    for i, p in enumerate(params["trunk"]):
        x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x)))
        if i == 1:
            x = max_pool(x)
    heat = torch.sigmoid(conv2d(params["heat"], x))[:, 0]
    rank = torch.sigmoid(conv2d(params["ranker"], x))[:, 0]
    return heat, rank, F.softplus(conv2d(params["cov"], x))


def detect(params, image, valid_wh, max_keypoints=1024, nms_radius=3,
           subpixel=True, subpixel_temp=0.5, sort_by_ranker=False):
    """image: (B, 3, H, W) → keypoints (B, N, 2) in the input's pixels,
    scores (B, N), covariance (B, N, 3), mask (B, N)."""
    with full_fp32():
        heat, rank, cov = backbone(params, image)
    b, h, w = heat.shape
    s = nms_ops.simple_nms(heat, nms_radius)
    s = s * nms_ops.border_mask(h, w, 2, valid_wh=(valid_wh + 1) // 2,
                                device=s.device).to(s.dtype)
    score = s * rank if sort_by_ranker else s
    kpts, kscores, mask = nms_ops.select_topk_keypoints(
        score, min(max_keypoints, h * w), 0.0)
    if subpixel:
        kpts = nms_ops.soft_argmax_refinement(
            kpts, torch.pow(s.clamp_min(0.0), 1.0 / subpixel_temp))
    ix = kpts[..., 0].to(torch.int64).clamp(0, w - 1)
    iy = kpts[..., 1].to(torch.int64).clamp(0, h - 1)
    c = torch.gather(cov.reshape(b, 3, h * w), 2,
                     (iy * w + ix)[:, None].expand(-1, 3, -1))
    return kpts * 2.0, kscores, c.transpose(1, 2), mask


class RaCo(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors (ALIKED's, at RaCo's keypoints),
    mask, and covariance with ``covariance_estimator``. A gray image is
    tiled to three channels."""

    default_conf = {
        "model_name": "raco",
        "max_num_keypoints": 1024,
        "nms_radius": 3,
        "subpixel_sampling": True,
        "subpixel_temp": 0.5,
        "ranker": True,
        "covariance_estimator": True,
        "sort_by_ranker": False,
        "aliked_model_name": "aliked-n16",
        "aliked_detection_threshold": 0.2,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "raco",
            self.device)
        self.describer = ALIKED({
            "model_name": conf["aliked_model_name"],
            "max_num_keypoints": conf["max_num_keypoints"],
            "detection_threshold": conf["aliked_detection_threshold"],
            "nms_radius": 2,
        }, device=self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.repeat(1, 3, 1, 1)
        b, _, h, w = image.shape
        valid_wh = torch.as_tensor(
            data["valid_wh"] if "valid_wh" in data else [[w, h]] * b,
            device=self.device).to(torch.int32)
        kpts, scores, cov, mask = detect(
            self.params, image, valid_wh,
            max_keypoints=int(self.conf["max_num_keypoints"]),
            nms_radius=int(self.conf["nms_radius"]),
            subpixel=bool(self.conf["subpixel_sampling"]),
            subpixel_temp=float(self.conf["subpixel_temp"]),
            sort_by_ranker=bool(self.conf["sort_by_ranker"]))
        out = {"keypoints": kpts, "scores": scores,
               "descriptors": self.describer.describe(image, kpts),
               "mask": mask}
        if self.conf["covariance_estimator"]:
            out["covariance"] = cov
        return out
