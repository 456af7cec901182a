"""R2D2 (reliable and repeatable detector and descriptor), float32.

Counterpart of ``imcui_tpu/models/extractors/r2d2.py`` on NCHW tensors:
the dilated L2-Net of ``Quad_L2Net_ConfCFS`` at full resolution (the
stride-2 stages become a doubling of the dilation, the last 8 x 8 conv
three dilated 2 x 2 convs), batch norms without affine, on the
ImageNet-normalised image. Both heads read the squared features: the
reliability is the second channel of a 2-way softmax, the repeatability
the 1-channel "softmax" of upstream, sp / (1 + sp) with sp the softplus,
not a sigmoid. Keypoints are the samples whose repeatability equals its
3 x 3 maximum with both maps at or above their thresholds (0.7 each), a
border of 4 and the valid canvas masked, ranked by reliability times
repeatability; descriptors are read at their integer positions. Every
convolution runs under ``layers.full_fp32``.

The tree keeps upstream's ``ops`` ModuleList slots (convolutions at 0, 3,
..., 15 with their batch norms at +1, the 2 x 2 convs at 18, 20, 22), a
ReLU's slot holding None. No trained tree (``r2d2_WASF_N16.pt``) is in
the repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 random tree, reported in ``meta``; on a random tree the 0.7
thresholds may keep few or no keypoints.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import batch_norm_inference, conv2d, full_fp32, init_conv, l2_normalize

# (conv slot, bn slot, relu, k, cin, cout, dilation), as the JAX module
OPS_SPEC = [
    (0, 1, True, 3, 3, 32, 1),
    (3, 4, True, 3, 32, 32, 1),
    (6, 7, True, 3, 32, 64, 1),
    (9, 10, True, 3, 64, 64, 2),
    (12, 13, True, 3, 64, 128, 2),
    (15, 16, True, 3, 128, 128, 4),
    (18, 19, False, 2, 128, 128, 4),
    (20, 21, False, 2, 128, 128, 8),
    (22, None, False, 2, 128, 128, 16),
]
N_OPS = 23
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def init_bn(c):
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def init_params(gen):
    ops = [None] * N_OPS
    for ci, bi, _, k, cin, cout, _ in OPS_SPEC:
        ops[ci] = init_conv(gen, k, k, cin, cout)
        if bi is not None:
            ops[bi] = init_bn(cout)
    return {"ops": ops, "clf": init_conv(gen, 1, 1, 128, 2),
            "sal": init_conv(gen, 1, 1, 128, 1)}


def backbone(params, x):
    """x: (B, 3, H, W) ImageNet-normalised → descriptors (B, 128, H, W),
    reliability (B, H, W), repeatability (B, H, W)."""
    for ci, bi, rl, _, _, _, dil in OPS_SPEC:
        x = conv2d(params["ops"][ci], x, dilation=dil)
        if bi is not None:
            x = batch_norm_inference(params["ops"][bi], x)
        if rl:
            x = torch.relu(x)
    desc = l2_normalize(x, dim=1, eps=1e-8)
    x2 = x * x
    reliability = torch.softmax(conv2d(params["clf"], x2), 1)[:, 1]
    sp = F.softplus(conv2d(params["sal"], x2))[:, 0]
    return desc, reliability, sp / (1.0 + sp)


def apply(params, image, valid_wh, max_keypoints=4096,
          reliability_threshold=0.7, repeatability_threshold=0.7):
    """image: (B, 3, H, W) in [0, 1]; valid_wh (B, 2) int → keypoints
    (B, N, 2), scores, descriptors (B, 128, N), mask."""
    mean = image.new_tensor(MEAN).view(1, 3, 1, 1)
    std = image.new_tensor(STD).view(1, 3, 1, 1)
    with full_fp32():
        dmap, rel, rep = backbone(params, (image - mean) / std)
    b, h, w = rep.shape
    maxima = (rep == nms_ops.max_pool_2d(rep, 1)) \
        & (rep >= repeatability_threshold) & (rel >= reliability_threshold)
    s = torch.where(maxima, rel * rep, torch.zeros_like(rep))
    s = s * nms_ops.border_mask(h, w, 4, valid_wh, device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        0.0)
    ix = kpts[..., 0].long().clamp(0, w - 1)
    iy = kpts[..., 1].long().clamp(0, h - 1)
    c = dmap.shape[1]
    desc = torch.gather(dmap.reshape(b, c, h * w), 2,
                        (iy * w + ix)[:, None].expand(-1, c, -1))
    return {"keypoints": kpts, "scores": kscores, "descriptors": desc,
            "mask": mask}


class R2D2(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A gray image is repeated to
    three channels. The multi-scale keys are read and ignored, as in the
    JAX package (one scale)."""

    default_conf = {
        "model_name": "r2d2_WASF_N16.pt",
        "max_keypoints": 5000,
        "scale_factor": 2**0.25,
        "min_size": 256,
        "max_size": 1024,
        "min_scale": 0,
        "max_scale": 1,
        "reliability_threshold": 0.7,
        "repetability_threshold": 0.7,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "r2d2",
            self.device)
        if conf["max_keypoints"] in (-1, None):
            conf["max_keypoints"] = 5000

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        b, _, h, w = image.shape
        valid_wh = torch.as_tensor(
            data["valid_wh"] if "valid_wh" in data else [[w, h]] * b,
            device=self.device).to(torch.int32)
        return apply(
            self.params, image, valid_wh,
            max_keypoints=int(self.conf["max_keypoints"]),
            reliability_threshold=float(self.conf["reliability_threshold"]),
            repeatability_threshold=float(
                self.conf["repetability_threshold"]))
