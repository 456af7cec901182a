"""FIRe's local super-features. Counterpart of
``imcui_tpu/models/extractors/fire_local.py``: the network of
``fire.py``, returning the super-features themselves rather than their
sum, those of every scale of the pyramid together, the ``features_num``
of largest attention mass first.

The JAX package selects them with ``lax.top_k``, which keeps the lower
index first among equal masses; here that is a stable descending sort.
"""

import torch

from ...utils.base_model import BaseModel
from ..layers import full_fp32
from .fire import (central_scales, load_params, normalized, pyramid,
                   superfeatures, trunk)


def select(sf, mass, k):
    """The k super-features of largest mass, (B, k, D), the lower index
    first among equal masses."""
    idx = torch.sort(mass, dim=1, descending=True, stable=True)[1][:, :k]
    return sf.gather(1, idx[..., None].expand(-1, -1, sf.shape[-1]))


class FIReLocal(BaseModel):
    """{"image" (B, C, H, W)} → {"local_descriptor" (B, k, 256)}, k =
    min(features_num, 64 · scales)."""

    default_conf = {
        "global": True,
        "asmk": False,
        "model_name": "fire_SfM_120k.pth",
        "scales": [2.0, 1.414, 1.0, 0.707, 0.5, 0.353, 0.25],
        "features_num": 1000,
        "asmk_name": "asmk_codebook.bin",
        "config_name": "eval_fire.yml",
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        self.scales = central_scales(conf["scales"])

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        with full_fp32():
            feats = [superfeatures(self.params,
                                   trunk(self.params, normalized(x)))
                     for x in pyramid(image, self.scales)]
        sf = torch.cat([f for f, _ in feats], 1)
        mass = torch.cat([m for _, m in feats], 1)
        k = min(int(self.conf["features_num"]), sf.shape[1])
        return {"local_descriptor": select(sf, mass, k)}
