"""LANet (learning-aware keypoints), float32.

Counterpart of ``imcui_tpu/models/extractors/lanet.py`` on NCHW tensors:
a VGG-style encoder (six 3 x 3 convolutions without bias, each with batch
norm and ReLU, 2 x 2 max-pools after the 2nd and 4th, then a stride-2
stage to 1/8) and three heads at 1/8: a sigmoid score, a tanh location
offset that moves each cell's centre (8x + 4, 8y + 4) by up to 4 px, and
a 256-d descriptor, L2-normalised. Cells whose score is at most
``keypoint_threshold``, or whose point lies outside the valid canvas,
score 0; the ``max_keypoints`` best cells are taken in the order of
``lax.top_k``, which puts the lower index first among equal scores (a
stable descending sort here), and a slot is valid where its score is
above 0. Every convolution runs under ``layers.full_fp32``.

No trained tree (``PointModel_v0.pth``) is in the repository: the model
runs a user's ``checkpoint_npz`` or the port's seed-0 random tree,
reported in ``meta``.
"""

import torch

from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

CELL = 8
DESC_DIM = 256
ENC_CFG = [64, 64, 128, 128, 256, 256]  # pools after idx 1 and 3


def init_params(gen):
    params, cin = {"enc": []}, 1
    for cout in ENC_CFG:
        params["enc"].append({"conv": init_conv(gen, 3, 3, cin, cout,
                                                bias=False),
                              "bn": init_bn(cout)})
        cin = cout
    params["enc"].append({"conv": init_conv(gen, 3, 3, 256, 256, bias=False),
                          "bn": init_bn(256)})
    params["score"] = [init_conv(gen, 3, 3, 256, 256),
                       init_conv(gen, 1, 1, 256, 1)]
    params["loc"] = [init_conv(gen, 3, 3, 256, 256),
                     init_conv(gen, 1, 1, 256, 2)]
    params["desc"] = [init_conv(gen, 3, 3, 256, DESC_DIM)]
    return params


def heads(params, x):
    """x: (B, 1, H, W) → score (B, Hc, Wc), points (B, Hc, Wc, 2) in
    pixels, descriptors (B, D, Hc, Wc), at 1/8."""
    for i, p in enumerate(params["enc"][:-1]):
        x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x)))
        if i in (1, 3):
            x = max_pool(x)
    p = params["enc"][-1]
    x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x, stride=2)))
    s = torch.sigmoid(conv2d(params["score"][1],
                             relu(conv2d(params["score"][0], x))))[:, 0]
    loc = torch.tanh(conv2d(params["loc"][1],
                            relu(conv2d(params["loc"][0], x))))
    desc = l2_normalize(conv2d(params["desc"][0], x), dim=1, eps=1e-8)
    hc, wc = s.shape[1:]
    gy, gx = torch.meshgrid(torch.arange(hc, device=x.device),
                            torch.arange(wc, device=x.device), indexing="ij")
    centers = torch.stack([gx, gy], -1).float() * CELL + CELL / 2
    return s, centers[None] + loc.permute(0, 2, 3, 1) * (CELL / 2), desc


def top_k_low_index_first(x, k):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply(params, image, valid_wh, max_keypoints=1024, threshold=0.1):
    """image: (B, 1, H, W) → keypoints (B, N, 2), scores, descriptors
    (B, 256, N), mask."""
    with full_fp32():
        score, kpts, desc = heads(params, image)
    b, hc, wc = score.shape
    vw = valid_wh[:, 0].view(-1, 1, 1)
    vh = valid_wh[:, 1].view(-1, 1, 1)
    in_img = (kpts[..., 0] < vw) & (kpts[..., 1] < vh)
    s = torch.where((score > threshold) & in_img, score,
                    torch.zeros_like(score))
    vals, idx = top_k_low_index_first(s.reshape(b, -1),
                                      min(max_keypoints, hc * wc))
    sel = torch.gather(kpts.reshape(b, -1, 2), 1,
                       idx[..., None].expand(-1, -1, 2))
    d = torch.gather(desc.reshape(b, DESC_DIM, -1), 2,
                     idx[:, None].expand(-1, DESC_DIM, -1))
    return {"keypoints": sel, "scores": vals, "descriptors": d,
            "mask": vals > 0.0}


class LANet(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A colour image is averaged to
    one channel."""

    default_conf = {
        "model_name": "PointModel_v0.pth",
        "keypoint_threshold": 0.1,
        "max_keypoints": 1024,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "lanet",
            self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 3:
            image = image.mean(1, keepdim=True)
        b, _, h, w = image.shape
        valid_wh = torch.as_tensor(
            data["valid_wh"] if "valid_wh" in data else [[w, h]] * b,
            device=self.device).to(torch.int32)
        return apply(self.params, image, valid_wh,
                     max_keypoints=int(self.conf["max_keypoints"]),
                     threshold=float(self.conf["keypoint_threshold"]))
