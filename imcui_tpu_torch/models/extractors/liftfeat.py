"""LiftFeat (lightweight features with a surface-normal lift), float32.

Counterpart of ``imcui_tpu/models/extractors/liftfeat.py`` on NCHW
tensors: an XFeat-style pyramid of conv-BN-ReLU pairs (24, 48, 96
channels, a 2 x 2 max-pool after each of the first two pairs, so the last
pair runs at 1/4); a 65-way keypoint head whose 64 cells are spread by
depth-to-space into a heat map at twice the image's size; a descriptor
head and a surface-normal head whose 128-d outputs are added (the "lift")
and L2-normalised; a sigmoid reliability. Keypoints from ``simple_nms``
at radius 2, a border of 4 and the valid canvas masked, fixed-k
selection; each score times the reliability of its cell (keypoint / 8);
descriptors sampled as at 1/8 (``s=8``). Every convolution runs under
``layers.full_fp32``.

The detection threshold is min(``keypoint_threshold``, 0.05) on a
trained tree and min(``keypoint_threshold``, 0.0) on a random one, as in
the JAX module. No trained tree (``LiftFeat.pth``) is in the repository:
the model runs a user's ``checkpoint_npz`` or the port's seed-0 random
tree, reported in ``meta``.
"""

import torch

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

DESC_DIM = 128


def _cbr(gen, cin, cout):
    return {"conv": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn": init_bn(cout)}


def init_params(gen):
    return {
        "b1": [_cbr(gen, 1, 24), _cbr(gen, 24, 24)],
        "b2": [_cbr(gen, 24, 48), _cbr(gen, 48, 48)],
        "b3": [_cbr(gen, 48, 96), _cbr(gen, 96, 96)],
        "kpt": init_conv(gen, 1, 1, 96, 65),
        "desc": [_cbr(gen, 96, 128), init_conv(gen, 1, 1, 128, DESC_DIM)],
        "normal": [_cbr(gen, 96, 64), init_conv(gen, 1, 1, 64, DESC_DIM)],
        "rel": init_conv(gen, 1, 1, 96, 1),
    }


def _block(ps, x):
    for p in ps:
        x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x)))
    return x


def backbone(params, x):
    """x: (B, 1, H, W) → heat (B, 8 Hc, 8 Wc), descriptors (B, 128, Hc,
    Wc), reliability (B, Hc, Wc)."""
    x = max_pool(_block(params["b1"], x))
    x = max_pool(_block(params["b2"], x))
    f8 = _block(params["b3"], x)
    prob = torch.softmax(conv2d(params["kpt"], f8), 1)[:, :64]
    b, _, hc, wc = prob.shape
    heat = prob.reshape(b, 8, 8, hc, wc).permute(0, 3, 1, 4, 2)
    heat = heat.reshape(b, hc * 8, wc * 8)
    d = conv2d(params["desc"][1], _block(params["desc"][:1], f8))
    n = conv2d(params["normal"][1], _block(params["normal"][:1], f8))
    desc = l2_normalize(d + n, dim=1, eps=1e-8)
    rel = torch.sigmoid(conv2d(params["rel"], f8))[:, 0]
    return heat, desc, rel


def apply(params, image, valid_wh, max_keypoints=5000, threshold=0.05):
    """image: (B, 1, H, W) → keypoints (B, N, 2), scores, descriptors
    (B, 128, N), mask."""
    with full_fp32():
        heat, desc_map, rel = backbone(params, image)
    b, h, w = heat.shape
    s = nms_ops.simple_nms(heat, 2)
    s = s * nms_ops.border_mask(h, w, 4, valid_wh, device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        threshold)
    rh, rw = rel.shape[1:]
    ix = (kpts[..., 0] / 8).long().clamp(0, rw - 1)
    iy = (kpts[..., 1] / 8).long().clamp(0, rh - 1)
    kscores = kscores * torch.gather(rel.reshape(b, -1), 1, iy * rw + ix)
    desc = nms_ops.sample_descriptors(kpts, desc_map, s=8)
    return {"keypoints": kpts, "scores": kscores, "descriptors": desc,
            "mask": mask}


class Liftfeat(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A colour image is averaged to
    one channel."""

    default_conf = {
        "keypoint_threshold": 0.05,
        "max_keypoints": 5000,
        "model_name": "LiftFeat.pth",
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "liftfeat",
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
        thr = min(float(self.conf["keypoint_threshold"]),
                  0.05 if self.meta.get("pretrained") else 0.0)
        return apply(self.params, image, valid_wh,
                     max_keypoints=int(self.conf["max_keypoints"]),
                     threshold=thr)
