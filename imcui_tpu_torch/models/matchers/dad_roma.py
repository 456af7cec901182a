"""DaD + RoMa: detector-anchored dense matches. Counterpart of
``imcui_tpu/models/matchers/dad_roma.py``.

RoMa's dense warp runs both ways; the keypoints of each view are the
local maxima of its warp certainty (NMS radius 2, the ``max_keypoints``
strongest, refined by a soft-argmax), which stands in for DaD's detector;
image 0's keypoints are carried through the warp and each snaps to the
nearest image-1 keypoint within 8 px (the first of equal distances, as
``jnp.argmin``), else keeps its warped position at half the confidence.

The full RoMa (DINOv2 + GP, the default tree) takes RGB at
``coarse_res``; its float32 blocks launch ``fused_attention`` (K3) on
the card, four encodes a request, and a bf16 tree would launch
``qtiled_attention`` (K14). The keypoints are the port's exact top-k
(the JAX package serves ``lax.approx_max_k``; ROADMAP, "Top-k"), so
tests compare correspondences as sets.
"""

import torch

from ...ops import nms as nms_ops
from ...ops import resize as resize_ops
from ...utils.base_model import BaseModel
from ..layers import full_fp32, xla_mean3
from . import roma as roma_mod

SNAP_RADIUS = 8.0  # px


def _detect(cert, stride, off, h, w, k):
    """Keypoints (k, 2), scores and mask of one certainty map (Hc, Wc)."""
    s = nms_ops.simple_nms(cert, 2)
    kpts, kscores, mask = nms_ops.select_topk_keypoints(s[None], k, 0.0)
    kpts = nms_ops.soft_argmax_refinement(kpts, cert[None])[0] * stride + off
    lim = kpts.new_tensor([w - 1.0, h - 1.0])
    return torch.minimum(kpts.clamp_min(0.0), lim), kscores[0], mask[0]


def apply_pair(params, a, b, max_matches):
    """One prepared pair (C, H, W) → keypoints0/1 (k, 2) in its pixels,
    scores and mask. RoMa's ``match`` gets no conf, as in the JAX module:
    DINOv2 takes the ViT-L variant's head count whatever the conf's
    ``dinov2_variant`` says (the two agree at the registry's conf)."""
    warp01, cert01 = roma_mod.match(params, a, b)
    warp10, cert10 = roma_mod.match(params, b, a)
    h, w = a.shape[-2:]
    # the warp grid's stride: 8 on fpn-corr, 1 on the full RoMa
    stride = h // cert01.shape[0]
    off = stride / 2.0 if stride > 1 else 0.0
    k0, _, m0 = _detect(cert01, stride, off, h, w, max_matches)
    k1, _, m1 = _detect(cert10, stride, off, h, w, max_matches)

    hc, wc = cert01.shape
    k0c = (k0 - off) / stride
    x = k0c[:, 0].clamp(0.0, wc - 1.001)
    y = k0c[:, 1].clamp(0.0, hc - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    wq = (warp01[y0, x0] * (1 - fx) * (1 - fy)
          + warp01[y0, x0 + 1] * fx * (1 - fy)
          + warp01[y0 + 1, x0] * (1 - fx) * fy
          + warp01[y0 + 1, x0 + 1] * fx * fy)
    k0_in_1 = roma_mod.to_pixel_coordinates(wq, h, w)

    d2 = ((k0_in_1[:, None] - k1[None]) ** 2).sum(-1)
    d2 = torch.where(m1[None, :], d2, 1e18)
    nn = d2.argmin(1)
    dist = torch.sqrt(d2.gather(1, nn[:, None])[:, 0])
    anchored = dist < SNAP_RADIUS
    k1_final = torch.where(anchored[:, None], k1[nn], k0_in_1)
    conf_ = cert01[y0.clamp(0, hc - 1), x0.clamp(0, wc - 1)] * torch.where(
        anchored, 1.0, 0.5)
    valid = m0 & (conf_ > 0.0)
    return {"keypoints0": torch.where(valid[:, None], k0, 0.0),
            "keypoints1": torch.where(valid[:, None], k1_final, 0.0),
            "scores": torch.where(valid, conf_, 0.0), "mask": valid}


class DadRoma(BaseModel):
    """Standalone matcher {image0, image1} (B, C, H, W) → keypoints0/1
    (B, K, 2) in the inputs' pixels, scores, mconf and mask."""

    default_conf = {
        "name": "two_view_pipeline",
        "model_name": "roma_outdoor.pth",
        "model_utils_name": "dinov2_vitl14_pretrain.pth",
        "max_keypoints": 3000,
        "coarse_res": (560, 560),
        "upsample_res": (864, 1152),
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = roma_mod.load_params(conf, self.device)

    def _prepare(self, image):
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if "dinov2" in self.params:  # the full RoMa: RGB at coarse_res
            if x.shape[1] == 1:
                x = x.expand(-1, 3, -1, -1)
            return resize_ops.resize(x, tuple(self.conf["coarse_res"]),
                                     "bilinear")
        return xla_mean3(x, 1)[:, None] if x.shape[1] == 3 else x

    @torch.inference_mode()
    def _forward(self, data):
        image0 = torch.as_tensor(data["image0"])
        image1 = torch.as_tensor(data["image1"])
        x0, x1 = self._prepare(image0), self._prepare(image1)
        k = int(self.conf["max_keypoints"])
        with full_fp32():
            rows = [apply_pair(self.params, a, b, k) for a, b in zip(x0, x1)]
        out = {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
        if "dinov2" in self.params:  # coarse_res pixels → the inputs'
            ch, cw = self.conf["coarse_res"]
            for key, img in (("keypoints0", image0), ("keypoints1", image1)):
                hh, ww = img.shape[-2:]
                out[key] = out[key] * out[key].new_tensor(
                    [(ww - 1) / (cw - 1), (hh - 1) / (ch - 1)])
        out["mconf"] = out["scores"]
        return out
