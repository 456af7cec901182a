"""RDD extractor (Robust Dense Detector, deformable-attention features).
Counterpart of ``imcui_tpu/models/extractors/rdd.py``: a CNN pyramid to
1/8 (three conv-BN-ReLU blocks, two 2 × 2 max-pools), two deformable
self-attention encoder layers over the 1/8 tokens (each token attends to
``N_POINTS`` positions at predicted offsets, sampled bilinearly), a
softplus detection head and 256-d L2-normalised descriptors. Keypoints:
radius-1 NMS on the 1/8 score map, a 1-cell border inside the valid part,
the top ``max_keypoints``, a 5 × 5 soft-argmax refinement, ×8 to pixels;
descriptors sampled there (``ops/nms.py``).

It serves the zoo's ``rdd(sparse)`` (with mutual nearest neighbour) and,
through ``backbone``, the ``rdd_dense`` matcher. The upstream
``RDD-v2.pth`` is not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
float32 throughout, as in the JAX package; as there, the detection
threshold is 0 whatever ``keypoint_threshold`` says.
"""

import torch
import torch.nn.functional as F

from ... import logger
from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, init_layer_norm, init_linear, layer_norm,
                      linear, max_pool, relu)

DESC_DIM = 256
D_MODEL = 256
N_POINTS = 4
N_LAYERS = 2


def _cbr(gen, cin, cout):
    return {"conv": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn": init_bn(cout)}


def init_deform_layer(gen, d):
    return {
        "offset": init_linear(gen, d, N_POINTS * 2),
        "attn_w": init_linear(gen, d, N_POINTS),
        "value": init_linear(gen, d, d),
        "out": init_linear(gen, d, d),
        "ffn1": init_linear(gen, d, d * 2),
        "ffn2": init_linear(gen, d * 2, d),
        "ln1": init_layer_norm(d),
        "ln2": init_layer_norm(d),
    }


def init_params(gen):
    """Random initialisation from ``gen`` with the JAX tree's leaves."""
    return {
        "b1": [_cbr(gen, 3, 32), _cbr(gen, 32, 32)],
        "b2": [_cbr(gen, 32, 64), _cbr(gen, 64, 64)],
        "b3": [_cbr(gen, 64, 128), _cbr(gen, 128, D_MODEL)],
        "enc": [init_deform_layer(gen, D_MODEL) for _ in range(N_LAYERS)],
        "det": init_conv(gen, 1, 1, D_MODEL, 1),
        "desc": init_conv(gen, 1, 1, D_MODEL, DESC_DIM),
    }


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "rdd", device)


def _bilinear_at(fmap, xy):
    """fmap: (H, W, C); xy: (..., 2) in feature coordinates, clamped to
    the map → (..., C)."""
    h, w, _ = fmap.shape
    x = xy[..., 0].clamp(0.0, w - 1.0)
    y = xy[..., 1].clamp(0.0, h - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    return ((fmap[y0, x0] * (1 - fx) + fmap[y0, x1] * fx) * (1 - fy)
            + (fmap[y1, x0] * (1 - fx) + fmap[y1, x1] * fx) * fy)


def deform_layer(p, fmap):
    """One deformable self-attention encoder layer over an (H, W, D) map:
    each location attends to N_POINTS predicted sample positions."""
    h, w, d = fmap.shape
    x = fmap.reshape(-1, d)
    gy, gx = torch.meshgrid(torch.arange(h, device=fmap.device),
                            torch.arange(w, device=fmap.device),
                            indexing="ij")
    ref = torch.stack([gx, gy], -1).reshape(-1, 2).float()
    offs = linear(p["offset"], x).reshape(-1, N_POINTS, 2)
    attn = torch.softmax(linear(p["attn_w"], x), -1)           # (N, P)
    values = linear(p["value"], fmap)                          # (H, W, D)
    sampled = _bilinear_at(values, ref[:, None, :] + offs)     # (N, P, D)
    agg = (attn[..., None] * sampled).sum(1)
    x = layer_norm(p["ln1"], x + linear(p["out"], agg))
    x = layer_norm(p["ln2"], x + linear(p["ffn2"],
                                        relu(linear(p["ffn1"], x))))
    return x.reshape(h, w, d)


def _block(ps, x):
    for p in ps:
        x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x)))
    return x


def backbone(params, x):
    """x: (B, 3, H, W) → the softplus score map (B, H/8, W/8) and the
    L2-normalised descriptor map (B, H/8, W/8, 256)."""
    x = max_pool(_block(params["b1"], x))
    x = max_pool(_block(params["b2"], x))
    f8 = _block(params["b3"], x).permute(0, 2, 3, 1)          # (B, h, w, D)
    maps = []
    for f in f8:
        for p in params["enc"]:
            f = deform_layer(p, f)
        maps.append(f)
    f8 = torch.stack(maps).permute(0, 3, 1, 2)
    score = F.softplus(conv2d(params["det"], f8))[:, 0]
    desc = conv2d(params["desc"], f8).permute(0, 2, 3, 1)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1,
                                           keepdim=True).clamp_min(1e-8)
    return score, desc


def apply(params, image, valid_wh, max_keypoints=4096, threshold=0.0):
    """image (B, 3, H, W) in [0, 1], valid_wh (B, 2) → keypoints (B, k, 2)
    in pixels, scores (B, k), descriptors (B, 256, k), mask (B, k)."""
    score, desc_map = backbone(params, image)
    h, w = score.shape[1:]
    s = nms_ops.simple_nms(score, 1)
    s = s * nms_ops.border_mask(h, w, 1, valid_wh=(valid_wh + 7) // 8,
                                device=s.device).to(s.dtype)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s, max_keypoints,
                                                        threshold)
    kpts = nms_ops.soft_argmax_refinement(kpts, s) * 8.0
    d = nms_ops.sample_descriptors(kpts, desc_map.permute(0, 3, 1, 2), s=8)
    return {"keypoints": kpts, "scores": kscores, "descriptors": d,
            "mask": mask}


class Rdd(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "keypoint_threshold": 0.1,
        "max_keypoints": 4096,
        "model_name": "RDD-v2.pth",
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"rdd weights: {self.meta}")

    @torch.inference_mode()
    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.repeat(1, 3, 1, 1)
        b, _, h, w = image.shape
        if "valid_wh" in data:
            valid_wh = torch.as_tensor(data["valid_wh"], device=self.device)
        else:
            valid_wh = torch.tensor([[w, h]], device=self.device).expand(b, 2)
        with full_fp32():
            return apply(self.params, image, valid_wh.long(),
                         max_keypoints=int(self.conf["max_keypoints"]),
                         threshold=0.0)
