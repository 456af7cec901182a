"""RDD dense matcher. Counterpart of
``imcui_tpu/models/matchers/rdd_dense.py``: the RDD backbone's dense 1/8
descriptors of each view (``models/extractors/rdd.py``) go through LoFTR's
dual-softmax coarse assignment cut to fixed match slots
(``loftr.coarse_match``); the keypoints are the matched cells' centres.

The upstream ``RDD-v2.pth`` is not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils.base_model import BaseModel
from ..extractors.rdd import backbone as rdd_backbone, load_params
from . import loftr


def forward_pair(params, image0, image1, wh0, wh1, conf):
    """One pair. image*: (3, H, W) in [0, 1]; wh*: the valid (width,
    height). Returns keypoints0/1 (M, 2), scores (M,), mask (M,)."""
    _, desc0 = rdd_backbone(params, image0[None])
    _, desc1 = rdd_backbone(params, image1[None])
    hc, wc = desc0.shape[1:3]
    m0 = loftr.grid_mask(wh0, hc, wc, desc0.device)
    m1 = loftr.grid_mask(wh1, hc, wc, desc0.device)
    idx0, idx1, score, valid = loftr.coarse_match(
        desc0[0].reshape(hc * wc, -1), desc1[0].reshape(hc * wc, -1), m0, m1,
        threshold=conf["match_threshold"], max_matches=conf["max_matches"])
    zero = torch.zeros((), device=desc0.device)
    return {"keypoints0": torch.where(valid[:, None],
                                      loftr.cell_centers(idx0, wc), zero),
            "keypoints1": torch.where(valid[:, None],
                                      loftr.cell_centers(idx1, wc), zero),
            "scores": score, "mask": valid}


class RddDense(BaseModel):
    """Standalone dense matcher: image0, image1 (B, 1 or 3, H, W) in [0,
    1] (gray is repeated to three channels), size0/size1 optional →
    keypoints0/1 (B, M, 2), scores, mconf (B, M), mask (B, M)."""

    default_conf = {
        "keypoint_threshold": 0.1,
        "max_keypoints": 4096,
        "model_name": "RDD-v2.pth",
        "match_threshold": 0.1,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"rdd_dense weights: {self.meta}")
        self.pair_conf = {"match_threshold": float(conf["match_threshold"]),
                          "max_matches": int(conf["max_keypoints"])}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device, gray=False)
