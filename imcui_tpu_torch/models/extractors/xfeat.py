"""XFeat (accelerated features), sparse ``detectAndCompute`` mode,
float32.

Counterpart of ``imcui_tpu/models/extractors/xfeat.py`` on NCHW tensors:
an instance-normalised gray input, five blocks of BasicLayers (3 × 3 or
1 × 1 bias-free conv, BatchNorm without affine, ReLU) with a 1/4
average-pool skip, the fusion at 1/8 of blocks 3–5 (blocks 4 and 5
resized to 1/8 by ``ops/resize.py::resize``, the JAX module's
``jax.image.resize``), a sigmoid reliability head, and a 65-way keypoint
head on the 8 × 8 unfold of the image (``F.pixel_unshuffle``: channel
8·iy + ix).

Detection as published: a 5 × 5 equality NMS on the cell-softmax heatmap
K1h alone, thresholded on K1h; the rank and output score K1h × H1, with
the reliability map H1 sampled at every pixel through XFeat's grid
(``ops/sampling.py::xfeat_grid``, bilinear); descriptors sampled from
the L2-normalised 1/8 map with the bicubic kernel and normalised again.
The model resizes its input down to multiples of 32 (not a pad) and
scales the keypoints back. Every convolution runs under
``layers.full_fp32``.

No trained XFeat tree is in the repository: the model runs a user's
``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``. XFeat reads ``max_keypoints`` and ``keypoint_threshold``, the
keys ``ImageMatchingAPI`` writes.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...ops import sampling
from ...ops.resize import resize
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (avg_pool, batch_norm_inference, conv2d, full_fp32,
                      init_conv, init_linear, instance_norm, l2_normalize,
                      relu)

BLOCKS = {
    # name: [(cin, cout, stride, k)], upstream XFeatModel layer for layer
    "block1": [(1, 4, 1, 3), (4, 8, 2, 3), (8, 8, 1, 3), (8, 24, 2, 3)],
    "block2": [(24, 24, 1, 3), (24, 24, 1, 3)],
    "block3": [(24, 64, 2, 3), (64, 64, 1, 3), (64, 64, 1, 1)],
    "block4": [(64, 64, 2, 3), (64, 64, 1, 3), (64, 64, 1, 3)],
    "block5": [(64, 128, 2, 3), (128, 128, 1, 3), (128, 128, 1, 3),
               (128, 64, 1, 1)],
    "block_fusion": [(64, 64, 1, 3), (64, 64, 1, 3)],
    "heatmap_head": [(64, 64, 1, 1), (64, 64, 1, 1)],
    "keypoint_head": [(64, 64, 1, 1), (64, 64, 1, 1), (64, 64, 1, 1)],
}
# fine_matcher MLP of the dense/star mode (not run by the sparse mode,
# kept so that the tree is the JAX package's): Linear / BatchNorm1d
# (affine False) / ReLU keyed by upstream indices
FINE_MLP = [(0, 128, 512), (3, 512, 512), (6, 512, 512), (9, 512, 512),
            (12, 512, 64)]


def init_bn(c):
    """BatchNorm2d(affine=False): running statistics only."""
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def init_basic(gen, cin, cout, k=3):
    return {"layer": {"0": init_conv(gen, k, k, cin, cout, bias=False),
                      "1": init_bn(cout)}}


def basic(p, x, stride=1):
    return relu(batch_norm_inference(
        p["layer"]["1"], conv2d(p["layer"]["0"], x, stride=stride)))


def init_params(gen):
    """Random tree in torch layout with the JAX ``init_params``'s keys."""
    params = {name: [init_basic(gen, cin, cout, k)
                     for cin, cout, _, k in spec]
              for name, spec in BLOCKS.items()}
    params["skip1"] = init_conv(gen, 1, 1, 1, 24)
    params["fusion_out"] = init_conv(gen, 1, 1, 64, 64)
    params["heatmap_out"] = init_conv(gen, 1, 1, 64, 1)
    params["keypoint_out"] = init_conv(gen, 1, 1, 64, 65)
    fine = {}
    for idx, din, dout in FINE_MLP:
        fine[str(idx)] = init_linear(gen, din, dout)
        if idx != 12:
            fine[str(idx + 1)] = init_bn(dout)
    params["fine_matcher"] = fine
    return params


def _run_block(plist, spec, x):
    for p, (_, _, s, _) in zip(plist, spec):
        x = basic(p, x, stride=s)
    return x


def backbone(params, x):
    """x: (B, 1, H, W) → feats (B, 64, H/8, W/8), heat (B, H/8, W/8),
    cell logits (B, 65, H/8, W/8)."""
    xn = instance_norm(x)
    x1 = _run_block(params["block1"], BLOCKS["block1"], xn)     # 1/4, 24
    skip = conv2d(params["skip1"], avg_pool(xn, 4))
    x2 = _run_block(params["block2"], BLOCKS["block2"], x1 + skip)
    x3 = _run_block(params["block3"], BLOCKS["block3"], x2)     # 1/8, 64
    x4 = _run_block(params["block4"], BLOCKS["block4"], x3)     # 1/16
    x5 = _run_block(params["block5"], BLOCKS["block5"], x4)     # 1/32, 64
    hw = x3.shape[-2:]
    fused = x3 + resize(x4, hw, "bilinear") + resize(x5, hw, "bilinear")
    feats = conv2d(params["fusion_out"], _run_block(
        params["block_fusion"], BLOCKS["block_fusion"], fused))
    heat = torch.sigmoid(conv2d(params["heatmap_out"], _run_block(
        params["heatmap_head"], BLOCKS["heatmap_head"], feats)))[:, 0]
    kpt_logits = conv2d(params["keypoint_out"], _run_block(
        params["keypoint_head"], BLOCKS["keypoint_head"],
        F.pixel_unshuffle(xn, 8)))
    return feats, heat, kpt_logits


def apply(params, image, valid_wh, max_keypoints=4096,
          detection_threshold=0.05):
    """image: (B, 1, H, W), H and W multiples of 32; valid_wh (B, 2).
    Returns keypoints (B, N, 2), scores (B, N), descriptors (B, 64, N)
    and mask (B, N)."""
    with full_fp32():
        feats, heat, kpt_logits = backbone(params, image)
    feats = l2_normalize(feats, dim=1, eps=1e-12)
    probs = torch.softmax(kpt_logits, 1)[:, :64]
    k1h = nms_ops.depth_to_space(probs, 8)[:, 0]  # (B, H, W)
    b, h, w = k1h.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=k1h.device),
        torch.arange(w, dtype=torch.float32, device=k1h.device),
        indexing="ij")
    pix_grid = sampling.xfeat_grid(torch.stack([xs, ys], -1), h, w)
    local_max = (k1h == nms_ops.max_pool_2d(k1h, 2)) \
        & (k1h > detection_threshold)
    hup = torch.stack([sampling.grid_sample(heat[i][None], pix_grid)[0]
                       for i in range(b)])
    rank = torch.where(local_max, k1h * hup, 0.0)
    rank = rank * nms_ops.border_mask(h, w, 1, valid_wh, device=rank.device)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(
        rank, max_keypoints, 0.0)
    desc = torch.stack([
        sampling.grid_sample(feats[i], sampling.xfeat_grid(kpts[i], h, w),
                             mode="bicubic") for i in range(b)])
    return {"keypoints": kpts, "scores": kscores,
            "descriptors": l2_normalize(desc, dim=1, eps=1e-12),
            "mask": mask}


class XFeat(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "keypoint_threshold": 0.05,
        "max_keypoints": 4096,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "xfeat",
            self.device)
        if conf["max_keypoints"] in (-1, None):
            conf["max_keypoints"] = 4096

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 3:
            image = image.mean(1, keepdim=True)
        b, _, h, w = image.shape
        # published preprocess_tensor: resize (half-pixel bilinear) down to
        # multiples of 32, not a pad, then scale the keypoints back
        hp, wp = max(h // 32, 1) * 32, max(w // 32, 1) * 32
        if (hp, wp) != (h, w):
            image = resize(image, (hp, wp), "bilinear")
        if "valid_wh" in data:
            vwh = torch.as_tensor(data["valid_wh"], dtype=torch.float32,
                                  device=self.device)
            valid_wh = torch.stack([vwh[:, 0] * (wp / w),
                                    vwh[:, 1] * (hp / h)], -1)
        else:
            valid_wh = torch.tensor([[wp, hp]], device=self.device).expand(
                b, 2)
        out = apply(self.params, image, valid_wh.to(torch.int32),
                    max_keypoints=self.conf["max_keypoints"],
                    detection_threshold=float(
                        self.conf["keypoint_threshold"]))
        if (hp, wp) != (h, w):
            out["keypoints"] = out["keypoints"] * out["keypoints"].new_tensor(
                [w / wp, h / hp])
        return out
