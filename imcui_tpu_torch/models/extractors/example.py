"""Template extractor, the starting point for adding a model. Counterpart
of ``imcui_tpu/models/extractors/example.py``.

It shows the port's conventions: a plain ``init_params(generator)`` and
``apply(params, ...)`` on tensors, the dict-in/dict-out ``BaseModel``, and
fixed-shape outputs with a validity mask. One 3 × 3 conv to 32 channels
and a 1 × 1 sigmoid score, window NMS at radius 2, the border and the
valid canvas masked, ``max_keypoints`` slots by an exact top-k (the JAX
function's ``lax.approx_max_k`` is exact off the TPU), and each keypoint's
32-channel feature, L2-normalised, as its descriptor. No registry conf
names it; its tree is always the seed-0 one.
"""

import torch

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (conv2d, full_fp32, init_conv, l2_normalize, relu,
                      xla_mean3)


def init_params(gen):
    return {"conv1": init_conv(gen, 3, 3, 1, 32),
            "score": init_conv(gen, 1, 1, 32, 1)}


def apply(params, image, valid_wh, max_keypoints=512):
    """image (B, 1, H, W), valid_wh (B, 2) → keypoints (B, k, 2), scores
    (B, k), descriptors (B, 32, k), mask (B, k)."""
    feat = relu(conv2d(params["conv1"], image))
    heat = torch.sigmoid(conv2d(params["score"], feat))[:, 0]
    b, h, w = heat.shape
    s = nms_ops.simple_nms(heat, 2)
    s = s * nms_ops.border_mask(h, w, 2, valid_wh=valid_wh,
                                device=s.device).to(s.dtype)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        0.0)
    ix = kpts[..., 0].long().clamp(0, w - 1)
    iy = kpts[..., 1].long().clamp(0, h - 1)
    d = feat.flatten(2).gather(2, (iy * w + ix)[:, None].expand(
        -1, feat.shape[1], -1))
    return {"keypoints": kpts, "scores": kscores,
            "descriptors": l2_normalize(d, 1), "mask": mask}


class Example(BaseModel):
    """{"image" (B, C, H, W), "valid_wh" (B, 2)?} → keypoints, scores,
    descriptors, mask. An RGB image is averaged to grey."""

    default_conf = {
        "max_keypoints": 512,
        "model_name": "example_model.pth",
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "example",
            self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 3:
            image = xla_mean3(image, 1)[:, None]
        b, _, h, w = image.shape
        valid_wh = torch.as_tensor(
            data["valid_wh"], device=self.device) if "valid_wh" in data \
            else torch.tensor([[w, h]], device=self.device).expand(b, 2)
        with full_fp32():
            return apply(self.params, image, valid_wh.long(),
                         max_keypoints=self.conf["max_keypoints"])
