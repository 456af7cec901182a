"""D2-Net detect-and-describe extractor, float32; also RoRD, the same
network under another tree (``model_name: rord.pth``).

Counterpart of ``imcui_tpu/models/extractors/d2net.py`` on NCHW tensors:
VGG16 through conv4_3, with two 2 × 2 max-pools, then a stride-1 2 × 2
average pool and conv4 dilated by 2, so that the 512-d features are at
1/4; the soft detection score of ``d2_scores``; ``simple_nms`` at radius
1, the border and the valid canvas masked at cell resolution, fixed-k
selection, and the descriptor of each selected cell, L2-normalised. Cell
(x, y) is image point (4x + 1.5, 4y + 1.5). Every convolution runs under
``layers.full_fp32``. ``multiscale`` is read and ignored, as in the JAX
package.

``avg_pool_s1`` pads the last row and column with zeros: the JAX
function's ``reduce_window`` starts from 0 over a (0, 1) padding, whatever
its docstring says about replicating them. The code is the reference.

No trained tree (``d2_tf.pth``, ``rord.pth``) is in the repository: the
model runs a user's ``checkpoint_npz`` or the port's seed-0 random tree,
reported in ``meta``.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import conv2d, full_fp32, init_conv, l2_normalize, max_pool, relu

# VGG16 through conv4_3: (cin, cout, dilation) or a pool, slot for slot
# the JAX tree's ``features`` list (a pool's slot holds None)
VGG_CFG = [
    (3, 64, 1), (64, 64, 1), "maxpool",
    (64, 128, 1), (128, 128, 1), "maxpool",
    (128, 256, 1), (256, 256, 1), (256, 256, 1), "avgpool1",
    (256, 512, 2), (512, 512, 2), (512, 512, 2),
]
STRIDE = 4  # output stride (two stride-2 pools)


def init_params(gen):
    return {"features": [None if isinstance(spec, str)
                         else init_conv(gen, 3, 3, spec[0], spec[1])
                         for spec in VGG_CFG]}


def avg_pool_s1(x):
    """2 × 2 average pool at stride 1 over (B, C, H, W), the last row and
    column padded with zeros, so that the shape is kept."""
    return F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, stride=1)


def backbone(params, x):
    """x: (B, 3, H, W) → (B, 512, H/4, W/4)."""
    for p, spec in zip(params["features"], VGG_CFG):
        if spec == "maxpool":
            x = max_pool(x)
        elif spec == "avgpool1":
            x = avg_pool_s1(x)
        else:
            x = relu(conv2d(p, x, dilation=spec[2]))
    return x


def d2_scores(feats, eps=1e-8):
    """D2-Net's soft detection over (B, C, H, W) features: with the
    features ReLU'd and M the per-image maximum, α = exp(x/M) over its
    3 × 3 window sum (each tap outside the map counts exp(0) = 1, hence
    the sum of exp − 1 plus 9), β = x over the per-pixel channel maximum,
    the score max_c(α·β) normalised to sum 1 over the map. → (B, H, W)."""
    feats = relu(feats)
    m = feats.amax((1, 2, 3), keepdim=True)
    exp = torch.exp(feats / m.clamp_min(eps))
    window_sum = F.avg_pool2d(exp - 1.0, 3, stride=1, padding=1,
                              divisor_override=1) + 9.0
    alpha = exp / window_sum
    beta = feats / feats.amax(1, keepdim=True).clamp_min(eps)
    gamma = (alpha * beta).amax(1)
    return gamma / (gamma.sum((1, 2), keepdim=True) + eps)


def apply(params, image, valid_wh, max_keypoints=4096):
    """image: (B, 3, H, W), H and W multiples of 4; valid_wh (B, 2) int.
    Returns keypoints (B, N, 2) in image pixels, scores (B, N),
    descriptors (B, 512, N) and mask (B, N)."""
    with full_fp32():
        feats = backbone(params, image)
    scores = d2_scores(feats)
    b, c, hc, wc = feats.shape
    s = nms_ops.simple_nms(scores, 1)
    s = s * nms_ops.border_mask(hc, wc, 1, torch.div(
        valid_wh, STRIDE, rounding_mode="floor"), device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        0.0)
    ix = kpts[..., 0].long().clamp(0, wc - 1)
    iy = kpts[..., 1].long().clamp(0, hc - 1)
    desc = torch.gather(feats.reshape(b, c, hc * wc), 2,
                        (iy * wc + ix)[:, None].expand(-1, c, -1))
    return {"keypoints": kpts * float(STRIDE) + (STRIDE - 1) / 2.0,
            "scores": kscores,
            "descriptors": l2_normalize(desc, dim=1, eps=1e-8),
            "mask": mask}


class D2Net(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A gray image is repeated to
    three channels; the image is zero-padded to multiples of 4."""

    default_conf = {
        "model_name": "d2_tf.pth",
        "checkpoint_dir": None,
        "use_relu": True,
        "multiscale": False,
        "max_keypoints": 4096,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)),
            conf["model_name"], self.device)
        if conf["max_keypoints"] in (-1, None):
            conf["max_keypoints"] = 4096

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        b, _, h, w = image.shape
        hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
        image = F.pad(image, (0, wp - w, 0, hp - h))
        valid_wh = torch.as_tensor(
            data["valid_wh"] if "valid_wh" in data else [[w, h]] * b,
            device=self.device).to(torch.int32)
        return apply(self.params, image, valid_wh,
                     max_keypoints=int(self.conf["max_keypoints"]))
