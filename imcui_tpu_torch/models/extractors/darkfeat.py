"""DarkFeat (noise-robust features for dark images), float32.

Counterpart of ``imcui_tpu/models/extractors/darkfeat.py`` on NCHW
tensors: six bias-free 3 x 3 convolutions (strides 1, 1, 2, 1, 2, 1),
each followed by parameter-free instance norm and ReLU; after the 2nd,
4th and 6th a peakiness score (spatial: softplus of x minus its 3 x 3
mean with zero padding; channel: softplus of x minus its channel mean;
the maximum over channels of their product); the scores of 1/2 and 1/4
brought to full resolution by ``ops.resize.resize`` (``jax.image.resize``
bilinear) and averaged; a 1 x 1 descriptor head, L2-normalised. Keypoints
from ``simple_nms`` at radius 2, a border of 8 and the valid canvas
masked, fixed-k selection, with ``sub_pixel`` a soft-argmax refinement;
descriptors sampled at 1/4 (``s=4``). Every
convolution runs under ``layers.full_fp32``.

The conf's ``detection_threshold`` is read and ignored: the JAX module
gates at 0.0, since its fused peakiness is not normalised. No trained
tree (``DarkFeat.pth``) is in the repository: the model runs a user's
``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...ops.resize import resize
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import conv2d, full_fp32, init_conv, instance_norm, l2_normalize

DESC_DIM = 128
TRUNK = [(32, 1), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1)]


def init_params(gen):
    params, cin = {"trunk": []}, 3
    for cout, _ in TRUNK:
        params["trunk"].append(init_conv(gen, 3, 3, cin, cout, bias=False))
        cin = cout
    params["desc"] = init_conv(gen, 1, 1, 128, DESC_DIM)
    return params


def peakiness(x, ksize=3):
    """ASLFeat's score of (B, C, H, W): spatial x channel peakiness, the
    maximum over channels → (B, H, W)."""
    avg = F.avg_pool2d(x, ksize, stride=1, padding=ksize // 2,
                       count_include_pad=True)
    alpha = F.softplus(x - avg)
    beta = F.softplus(x - x.mean(1, keepdim=True))
    return (alpha * beta).amax(1)


def backbone(params, x):
    scores = []
    for i, (p, (_, stride)) in enumerate(zip(params["trunk"], TRUNK)):
        x = torch.relu(instance_norm(conv2d(p, x, stride=stride)))
        if i in (1, 3, 5):
            scores.append(peakiness(x))
    desc = l2_normalize(conv2d(params["desc"], x), dim=1, eps=1e-8)
    h, w = scores[0].shape[1:]
    fused = scores[0]
    for s in scores[1:]:
        fused = fused + resize(s, (h, w), "bilinear")
    return fused / len(scores), desc


def apply(params, image, valid_wh, max_keypoints=1000, threshold=0.5,
          sub_pixel=False):
    """image: (B, 3, H, W) → keypoints (B, N, 2), scores, descriptors
    (B, 128, N), mask."""
    with full_fp32():
        score, desc_map = backbone(params, image)
    h, w = score.shape[1:]
    s = nms_ops.simple_nms(score, 2)
    s = s * nms_ops.border_mask(h, w, 8, valid_wh, device=s.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        threshold)
    if sub_pixel:
        kpts = nms_ops.soft_argmax_refinement(kpts, s)
    desc = nms_ops.sample_descriptors(kpts, desc_map, s=4)
    return {"keypoints": kpts, "scores": kscores, "descriptors": desc,
            "mask": mask}


class DarkFeat(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A gray image is repeated to
    three channels."""

    default_conf = {
        "model_name": "DarkFeat.pth",
        "max_keypoints": 1000,
        "detection_threshold": 0.5,  # read and ignored: the gate is 0.0
        "sub_pixel": False,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "darkfeat",
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
                     threshold=0.0,
                     sub_pixel=bool(self.conf["sub_pixel"]))
