"""Dual-softmax descriptor matcher. Counterpart of
``imcui_tpu/models/matchers/dual_softmax.py``: the same conf
(``match_threshold``, ``inv_temperature``, both taken as floats), inputs
as ``nearest_neighbor``'s, outputs ``matches0``, ``matching_scores0`` and
the (B, N0, N1) assignment as ``similarity``. The compute is
``ops/matching.py::dual_softmax_match``; the model has no parameters.
"""

from ...ops.matching import dual_softmax_match
from ...utils.base_model import BaseModel
from .nearest_neighbor import descriptor_inputs


class DualSoftMax(BaseModel):
    default_conf = {
        "match_threshold": 0.2,
        "inv_temperature": 20,
    }
    required_inputs = ["descriptors0", "descriptors1"]

    def _init(self, conf):
        self.meta = {"pretrained": True}  # parameter-free

    def _forward(self, data):
        desc0, desc1, mask0, mask1 = descriptor_inputs(data, self.device)
        return dual_softmax_match(
            desc0, desc1, mask0, mask1,
            inv_temperature=float(self.conf["inv_temperature"]),
            match_threshold=float(self.conf["match_threshold"]))
