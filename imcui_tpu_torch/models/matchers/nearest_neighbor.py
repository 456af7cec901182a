"""Nearest-neighbour descriptor matcher. Counterpart of
``imcui_tpu/models/matchers/nearest_neighbor.py``: the same conf
(``ratio_threshold``, ``distance_threshold``, ``do_mutual_check``), inputs
``descriptors0``/``descriptors1`` (B, D, N) with optional ``mask0``/``mask1``
(B, N) (all valid by default), outputs ``matches0`` (B, N0) int32 and
``matching_scores0``. The compute is ``ops/matching.py::mutual_nn_match``
over the batch; the model has no parameters.
"""

import torch

from ...ops.matching import mutual_nn_match
from ...utils.base_model import BaseModel


def descriptor_inputs(data, device):
    """(desc0 (B, N0, D), desc1 (B, N1, D), mask0, mask1) float32 and bool
    on ``device`` from a matcher's input dict."""
    desc0, desc1 = (torch.as_tensor(data[k], dtype=torch.float32,
                                    device=device).transpose(1, 2)
                    for k in ("descriptors0", "descriptors1"))
    masks = [torch.as_tensor(data[k], dtype=torch.bool, device=device)
             if data.get(k) is not None else
             torch.ones(d.shape[:2], dtype=torch.bool, device=device)
             for k, d in (("mask0", desc0), ("mask1", desc1))]
    return desc0, desc1, *masks


class NearestNeighbor(BaseModel):
    default_conf = {
        "ratio_threshold": None,
        "distance_threshold": None,
        "do_mutual_check": True,
    }
    required_inputs = ["descriptors0", "descriptors1"]

    def _init(self, conf):
        self.meta = {"pretrained": True}  # parameter-free

    def _forward(self, data):
        desc0, desc1, mask0, mask1 = descriptor_inputs(data, self.device)
        return mutual_nn_match(
            desc0, desc1, mask0, mask1,
            ratio_thresh=self.conf["ratio_threshold"],
            distance_thresh=self.conf["distance_threshold"],
            do_mutual_check=self.conf["do_mutual_check"])
