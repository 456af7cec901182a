"""DISK keypoint detector and descriptor, float32.

Counterpart of ``imcui_tpu/models/extractors/disk.py``: a thin U-Net of
5 × 5 convolutions with PReLU gates over parameter-free instance norm,
down stages [16, 32, 64, 64, 64] with 2 × 2 average pools between, four
up stages [64, 64, 64, 129] that double the resolution and concatenate
the skip of the same scale. The output is a 128-d dense descriptor map
and one detection heatmap; keypoints come from window-5 NMS and top-k,
descriptors are read at their integer positions and L2-normalised.

The upsampling is ``jax.image.resize``'s half-pixel bilinear in the JAX
module; for an exact doubling that equals ``F.interpolate(...,
scale_factor=2, mode="bilinear", align_corners=False)``: two taps an
output, and at the edges the one tap inside the map (the JAX kernel's
renormalisation, torch's clamp), which is what runs here. All
convolutions run under ``layers.full_fp32``.

No trained DISK tree is in the repository: the model runs a user's
``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``. DISK reads ``max_keypoints`` and ``detection_threshold``, so
``ImageMatchingAPI``'s ``keypoint_threshold`` does not reach it.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (avg_pool, conv2d, full_fp32, init_conv,
                      instance_norm, l2_normalize)

DOWN = [16, 32, 64, 64, 64]
UP = [64, 64, 64, 129]  # four up stages mirror the four pools
DESC_DIM = 128


def prelu(p, x):
    """PReLU with a per-channel gain p["alpha"] (C,)."""
    return torch.where(x >= 0, x, p["alpha"].view(1, -1, 1, 1) * x)


def init_gate(c):
    return {"alpha": torch.full((c,), 0.25)}


def init_params(gen):
    """Random tree in torch layout with the JAX ``init_params``'s keys;
    the last up stage has no gate (``None``)."""
    params = {"down": [], "up": []}
    cin = 3
    for cout in DOWN:
        params["down"].append({"conv": init_conv(gen, 5, 5, cin, cout),
                               "gate": init_gate(cout)})
        cin = cout
    skip_dims = DOWN[-2::-1]  # [64, 64, 32, 16]
    for i, cout in enumerate(UP):
        params["up"].append({
            "conv": init_conv(gen, 5, 5, cin + skip_dims[i], cout),
            "gate": init_gate(cout) if i < len(UP) - 1 else None})
        cin = cout
    return params


def unet_apply(params, x):
    """x: (B, 3, H, W), H and W multiples of 16 → (B, 129, H, W)."""
    skips = []
    for i, stage in enumerate(params["down"]):
        if i > 0:
            skips.append(x)
            x = avg_pool(x, 2)
        x = prelu(stage["gate"], instance_norm(conv2d(stage["conv"], x)))
    for i, stage in enumerate(params["up"]):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = conv2d(stage["conv"], torch.cat([x, skips[-1 - i]], 1))
        if stage["gate"] is not None:
            x = prelu(stage["gate"], instance_norm(x))
    return x


def apply(params, image, valid_wh, max_keypoints=2048, nms_window=5,
          detection_threshold=0.0):
    """image: (B, 3, H, W) in [0, 1], H and W multiples of 16; valid_wh
    (B, 2). Returns keypoints (B, N, 2), scores (B, N), descriptors (B,
    128, N) and mask (B, N)."""
    with full_fp32():
        out = unet_apply(params, image)
    desc_map = out[:, :DESC_DIM]
    heat = out[:, DESC_DIM]
    b, h, w = heat.shape
    scores = nms_ops.simple_nms(heat, nms_window // 2)
    scores = scores * nms_ops.border_mask(h, w, 2, valid_wh,
                                          device=heat.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(
        scores, max_keypoints, detection_threshold)
    ix = kpts[..., 0].long().clamp(0, w - 1)
    iy = kpts[..., 1].long().clamp(0, h - 1)
    q = (iy * w + ix)[:, None].expand(-1, DESC_DIM, -1)
    desc = torch.gather(desc_map.reshape(b, DESC_DIM, h * w), 2, q)
    return {"keypoints": kpts, "scores": kscores,
            "descriptors": l2_normalize(desc, dim=1), "mask": mask}


class DISK(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "weights": "depth",
        "max_keypoints": 2048,
        "nms_window_size": 5,
        "detection_threshold": 0.0,
        "pad_if_not_divisible": True,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "disk",
            self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.repeat(1, 3, 1, 1)
        b, _, h, w = image.shape
        # pad to /16: the U-Net pools four times
        image = F.pad(image, (0, -w % 16, 0, -h % 16))
        if "valid_wh" in data:
            valid_wh = torch.as_tensor(data["valid_wh"], device=self.device)
        else:
            valid_wh = torch.tensor([[w, h]], device=self.device).expand(b, 2)
        return apply(self.params, image, valid_wh.to(torch.int32),
                     max_keypoints=self.conf["max_keypoints"],
                     nms_window=self.conf["nms_window_size"],
                     detection_threshold=float(
                         self.conf["detection_threshold"]))
