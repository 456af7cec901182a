"""RoMaV2, as the JAX package has it. Counterpart of
``imcui_tpu/models/matchers/romav2.py``.

The JAX module keeps a behavioural analogue of RoMaV2 (whose layer stack
is not in the repository) on RoMa's lightweight ``fpn-corr`` path:
LoFTR's backbone, a correlation warp and one refinement step, then one
recurrent pass (the warp corrected by a quarter of a second correlation
warp against the warped features, the certainties averaged), and
certainty-balanced sampling over 4 x 4 regions of the grid. The port
restates it on its RoMa; it reaches no kernel.

``balanced_sample`` keeps ``lax.top_k``'s order, the lower index first
among equal scores (a stable descending sort). The model runs the
``checkpoint_npz`` a user names or the port's seed-0 ``fpn-corr`` tree.
"""

import torch

from ...utils.base_model import BaseModel
from ..layers import full_fp32, xla_mean3
from . import loftr
from . import roma as roma_mod


def balanced_sample(warp, cert, h, w, num=2048):
    """Certainty-balanced sampling: each cell's certainty over its
    region's largest (4 x 4 regions) averaged with the certainty itself,
    the ``num`` best cells. warp (Hc, Wc, 2), cert (Hc, Wc) → keypoints0,
    keypoints1 (num, 2) in an (h, w) image's pixels, scores, valid."""
    hc, wc = cert.shape
    rs = 4
    dev = cert.device
    region = (torch.arange(hc, device=dev)[:, None] // max(hc // rs, 1)) \
        * rs + torch.arange(wc, device=dev)[None, :] // max(wc // rs, 1)
    flat_r = region.reshape(-1)
    flat_c = cert.reshape(-1)
    # where a side is not a multiple of 4 its last cells get a region id
    # past 15: ``segment_max`` drops them and the gather clamps the id
    keep = flat_r < rs * rs
    seg_max = torch.full((rs * rs,), float("-inf"), dtype=flat_c.dtype,
                         device=dev).scatter_reduce(0, flat_r[keep],
                                                    flat_c[keep], "amax")
    balanced = flat_c / seg_max[flat_r.clamp_max(rs * rs - 1)].clamp_min(
        1e-6)
    score = balanced * 0.5 + flat_c * 0.5
    gy, gx = torch.meshgrid(torch.arange(hc, device=dev),
                            torch.arange(wc, device=dev), indexing="ij")
    k0 = torch.stack([gx.reshape(-1) * 8.0 + 4.0,
                      gy.reshape(-1) * 8.0 + 4.0], -1)
    k1 = roma_mod.to_pixel_coordinates(warp.reshape(-1, 2), h, w)
    top, idx = torch.sort(score, descending=True, stable=True)
    n = min(num, score.shape[0])
    top, idx = top[:n], idx[:n]
    valid = top > 0.0
    return (torch.where(valid[:, None], k0[idx], 0.0),
            torch.where(valid[:, None], k1[idx], 0.0),
            torch.where(valid, flat_c[idx], 0.0), valid)


def warp_pair(params, a, b):
    """One grey pair (1, H, W) → the warp (Hc, Wc, 2) and certainty
    (Hc, Wc) on the 1/8 grid after the recurrent pass."""
    featc, _ = loftr.backbone_apply(params["backbone"], torch.stack([a, b]))
    f0, f1 = featc[0], featc[1]
    warp, cert = roma_mod.correlation_warp(f0, f1)
    warp, cert = roma_mod.refine(params["refiner"], f0, f1, warp, cert)
    f1w = roma_mod.bilinear_warp(f1, warp)
    warp2, cert2 = roma_mod.correlation_warp(f0, f1w)
    return warp + 0.25 * warp2, (cert + cert2) * 0.5


def apply_pair(params, a, b, max_matches):
    """One grey pair (1, H, W) → keypoints0/1, scores and mask."""
    warp, cert = warp_pair(params, a, b)
    h, w = a.shape[-2:]
    k0, k1, score, valid = balanced_sample(warp, cert, h, w,
                                           num=max_matches)
    return {"keypoints0": k0, "keypoints1": k1, "scores": score,
            "mask": valid}


class RomaV2(BaseModel):
    """Standalone matcher {image0, image1} (B, C, H, W) → keypoints0/1
    (B, K, 2), scores, mconf and mask."""

    default_conf = {
        "max_keypoints": 2048,
        "match_threshold": 0.2,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = roma_mod.load_params(
            {**conf, "backbone": "fpn-corr"}, self.device)

    def _prepare(self, image):
        """(B, C, H, W) → the grey (B, 1, H, W) the path takes."""
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        return xla_mean3(x, 1)[:, None] if x.shape[1] == 3 else x

    @torch.inference_mode()
    def _forward(self, data):
        x0, x1 = self._prepare(data["image0"]), self._prepare(data["image1"])
        k = int(self.conf["max_keypoints"])
        with full_fp32():
            rows = [apply_pair(self.params, a, b, k) for a, b in zip(x0, x1)]
        out = {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
        out["mconf"] = out["scores"]
        return out
