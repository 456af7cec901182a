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


def pair_masks(data, b, n0, n1, device):
    """(mask0 (B, N0), mask1 (B, N1)) bool on ``device``: a matcher's input
    masks, or all valid."""
    return [torch.as_tensor(data[k], device=device).bool()
            if data.get(k) is not None else
            torch.ones((b, n), dtype=torch.bool, device=device)
            for k, n in (("mask0", n0), ("mask1", n1))]


def pair_sizes(data, kpts0, kpts1):
    """(size0, size1) (B, 2) float32 (w, h) on the keypoints' device, by
    the JAX matchers' fallbacks: ``size*`` of the input dict, else the
    (padded) image's (w, h), else the keypoints' extent plus one."""
    b, dev = kpts0.shape[0], kpts0.device

    def size(key_img, key_wh, kpts):
        if key_wh in data:
            return torch.as_tensor(data[key_wh], dtype=torch.float32,
                                   device=dev)
        img = data.get(key_img)
        if img is not None and hasattr(img, "shape") and len(img.shape) == 4:
            h, w = img.shape[-2:]
            return torch.tensor([[w, h]], dtype=torch.float32,
                                device=dev).expand(b, 2)
        return kpts[..., :2].amax(1) + 1.0

    return size("image0", "size0", kpts0), size("image1", "size1", kpts1)


def descriptor_inputs(data, device):
    """(desc0 (B, N0, D), desc1 (B, N1, D), mask0, mask1) float32 and bool
    on ``device`` from a matcher's input dict."""
    desc0, desc1 = (torch.as_tensor(data[k], dtype=torch.float32,
                                    device=device).transpose(1, 2)
                    for k in ("descriptors0", "descriptors1"))
    return (desc0, desc1,
            *pair_masks(data, desc0.shape[0], desc0.shape[1],
                        desc1.shape[1], device))


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
