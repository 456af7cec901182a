"""XFeat dense, the standalone ``xfeat_dense`` matcher.

Counterpart of ``imcui_tpu/models/matchers/xfeat_dense.py``: XFeat
(``models/extractors/xfeat.py``) at ``max_keypoints`` slots (8000) and
threshold 1e-5 on each image, then the mutual nearest neighbour with the
ratio test at ``ratio_threshold`` over the 64-d descriptors
(``ops/matching.py::mutual_nn_match``), over the batch of pairs. As in
the JAX module, upstream's refinement MLP is not run. Outputs as
``xfeat_lightglue``'s. No trained XFeat tree is in the repository: the
port's seed-0 random tree, reported in ``meta``.
"""

import torch

from ...ops.matching import mutual_nn_match
from ...utils.base_model import BaseModel
from ..extractors.xfeat import XFeat
from .xfeat_lightglue import gather_matched


class XFeatDense(BaseModel):
    default_conf = {
        "max_keypoints": 8000,
        "ratio_threshold": 0.95,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.extractor = XFeat({"max_keypoints": conf["max_keypoints"],
                                "keypoint_threshold": 1e-5},
                               device=self.device)
        self.meta = dict(self.extractor.meta)

    def _forward(self, data):
        f0, f1 = (self.extractor({"image": torch.as_tensor(
            data[k], dtype=torch.float32, device=self.device)})
            for k in ("image0", "image1"))
        nn = mutual_nn_match(
            f0["descriptors"].transpose(1, 2),
            f1["descriptors"].transpose(1, 2), mask0=f0["mask"],
            mask1=f1["mask"],
            ratio_thresh=float(self.conf["ratio_threshold"]))
        k0, k1, ok = gather_matched(f0["keypoints"], f1["keypoints"],
                                    nn["matches0"])
        return {"keypoints0": k0, "keypoints1": k1,
                "scores": nn["matching_scores0"],
                "mconf": nn["matching_scores0"], "mask": ok}
