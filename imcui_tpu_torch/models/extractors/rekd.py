"""REKD (rotation-equivariant keypoint detection), float32.

Counterpart of ``imcui_tpu/models/extractors/rekd.py`` on NCHW tensors.
Convolutions over the cyclic group C4: the lifting layer applies its
5 × 5 kernel at the four ``rot90``s, and each group layer, for output
orientation g, rotates its 3 × 3 kernel by g and rolls its group-input
blocks by g (the regular representation). Each layer's four kernels are
stacked into one weight, so a layer is one convolution with 4·cout
output channels, orientation-major. A 2 × 2 max-pool follows the first
group layer; the score is the orientation max, averaged over channels,
at half resolution; the descriptor a 1 × 1 convolution of all
orientations, L2-normalised.

``apply`` runs SuperPoint's ``simple_nms`` at radius 2, masks 2 px of
border inside the valid half-resolution canvas, takes the top
``max_keypoints`` at 0.0 and samples descriptors at stride 1; keypoints
are doubled to the input's pixels. As in the JAX module, ``threshold``
(the conf's ``keypoint_threshold``) is read and not used: the selection
gate is 0.0 (``rekd.py:99-110`` of the JAX package).

No trained tree (REKD's ``v0``) is in the repository: the model runs a
user's ``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``.
"""

import torch

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import conv2d, full_fp32, init_conv, l2_normalize, max_pool, relu

GROUP = 4       # C4: 0/90/180/270°
DESC_DIM = 256
CFG = [16, 16, 32, 32]


def init_params(gen):
    params = {"lift": init_conv(gen, 5, 5, 1, CFG[0], bias=False),
              "gconv": []}
    cin = CFG[0]
    for cout in CFG[1:]:
        params["gconv"].append(init_conv(gen, 3, 3, GROUP * cin, cout,
                                         bias=False))
        cin = cout
    params["desc"] = init_conv(gen, 1, 1, GROUP * CFG[-1], DESC_DIM)
    return params


def _rot(w, g):
    """An OIHW kernel rotated spatially by g·90°, as ``jnp.rot90`` over the
    JAX package's (kh, kw) axes."""
    return torch.rot90(w, g, dims=(2, 3))


def lift_weight(w):
    """(cout, 1, k, k) → (G·cout, 1, k, k): the kernel at each rotation."""
    return torch.cat([_rot(w, g) for g in range(GROUP)], 0)


def group_weight(w):
    """(cout, G·cin, k, k) → (G·cout, G·cin, k, k): for output
    orientation g the kernel rotated by g with its group-input blocks
    rolled by g."""
    cout, gcin, kh, kw = w.shape
    out = []
    for g in range(GROUP):
        wg = _rot(w, g).reshape(cout, GROUP, gcin // GROUP, kh, kw)
        out.append(torch.roll(wg, g, dims=1).reshape(cout, gcin, kh, kw))
    return torch.cat(out, 0)


def backbone(params, x):
    """x: (B, 1, H, W) → score (B, H/2, W/2), descriptors (B, 256, H/2,
    W/2)."""
    x = relu(conv2d({"w": lift_weight(params["lift"]["w"])}, x))
    for i, p in enumerate(params["gconv"]):
        x = relu(conv2d({"w": group_weight(p["w"])}, x))
        if i == 0:
            x = max_pool(x)
    b, _, h, w = x.shape
    score = x.reshape(b, GROUP, CFG[-1], h, w).amax(1).mean(1)
    desc = l2_normalize(conv2d(params["desc"], x), dim=1, eps=1e-8)
    return score, desc


def apply(params, image, valid_wh, max_keypoints=1024, threshold=0.1):
    """image: (B, 1, H, W) → keypoints (B, N, 2), scores, descriptors
    (B, 256, N), mask. ``threshold`` is not used (module docstring)."""
    del threshold
    with full_fp32():
        score, desc = backbone(params, image)
    _, h, w = score.shape
    s = nms_ops.simple_nms(score, 2)
    s = s * nms_ops.border_mask(h, w, 2, valid_wh=(valid_wh + 1) // 2,
                                device=s.device).to(s.dtype)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(
        s, min(max_keypoints, h * w), 0.0)
    d = nms_ops.sample_descriptors(kpts, desc, s=1)
    return {"keypoints": kpts * 2.0, "scores": kscores, "descriptors": d,
            "mask": mask}


class REKD(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask. A colour image is averaged to
    one channel."""

    default_conf = {
        "model_name": "v0",
        "keypoint_threshold": 0.1,
        "max_keypoints": 1024,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "rekd",
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
