"""XFeat + LightGlue, the standalone ``xfeat_lightglue`` matcher.

Counterpart of ``imcui_tpu/models/matchers/xfeat_lightglue.py``: XFeat
(``models/extractors/xfeat.py``) at ``max_keypoints`` slots and threshold
1e-5 on each image, then LightGlue (``models/matchers/lightglue.py``)
with ``features="xfeat"`` (64-d descriptors) at ``n_layers`` layers.
With 4096 slots a view LightGlue's self-attention takes the blockwise
kernel K5 and its cross-attention K4, once each per layer run.

Standalone (dense in the zoo): it takes the two images, and the API does
not write its keypoint budget. Outputs are per slot of view 0: the
matched keypoints of both views, zero where unmatched, the matching
scores as ``scores`` and ``mconf``, and ``mask``.

No trained tree of either model is in the repository
(``xfeat_lighterglue.pth`` included): both run the port's seed-0 random
trees, reported in ``meta``.
"""

import torch

from ...utils.base_model import BaseModel
from ..extractors.xfeat import XFeat
from .lightglue import LightGlue


def gather_matched(kpts0, kpts1, matches0):
    """(keypoints0, keypoints1, ok): view 0's keypoints and their partners
    in view 1, both zero where ``matches0`` is -1. kpts: (B, N, 2);
    matches0 (B, N0)."""
    ok = matches0 > -1
    idx = matches0.long().clamp(0, kpts1.shape[1] - 1)
    k1m = torch.gather(kpts1, 1, idx[..., None].expand(-1, -1, 2))
    zero = kpts0.new_zeros(())
    return (torch.where(ok[..., None], kpts0, zero),
            torch.where(ok[..., None], k1m, zero), ok)


class XFeatLightGlue(BaseModel):
    default_conf = {
        "max_keypoints": 4096,
        "match_threshold": 0.1,
        "n_layers": 6,  # the published lighterglue is shallower
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.extractor = XFeat({"max_keypoints": conf["max_keypoints"],
                                "keypoint_threshold": 1e-5},
                               device=self.device)
        self.matcher = LightGlue({"features": "xfeat",
                                  "n_layers": conf["n_layers"],
                                  "match_threshold": conf["match_threshold"],
                                  "model_name": "xfeat_lighterglue.pth"},
                                 device=self.device)
        self.meta = {"pretrained": bool(
            self.extractor.meta.get("pretrained")
            and self.matcher.meta.get("pretrained")),
            "extractor": self.extractor.meta, "matcher": self.matcher.meta}

    def _forward(self, data):
        image0, image1 = (torch.as_tensor(data[k], dtype=torch.float32,
                                          device=self.device)
                          for k in ("image0", "image1"))
        f0 = self.extractor({"image": image0})
        f1 = self.extractor({"image": image1})
        b = image0.shape[0]

        def size(img):
            return torch.tensor([[img.shape[3], img.shape[2]]],
                                dtype=torch.float32,
                                device=self.device).expand(b, 2)

        matched = self.matcher({
            "keypoints0": f0["keypoints"], "keypoints1": f1["keypoints"],
            "descriptors0": f0["descriptors"],
            "descriptors1": f1["descriptors"],
            "mask0": f0["mask"], "mask1": f1["mask"],
            "size0": size(image0), "size1": size(image1)})
        k0, k1, ok = gather_matched(f0["keypoints"], f1["keypoints"],
                                    matched["matches0"])
        return {"keypoints0": k0, "keypoints1": k1,
                "scores": matched["matching_scores0"],
                "mconf": matched["matching_scores0"], "mask": ok}
