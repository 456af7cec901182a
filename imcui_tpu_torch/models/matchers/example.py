"""Template dense matcher, the matcher-side twin of
``models/extractors/example.py``. Counterpart of
``imcui_tpu/models/matchers/example.py``; it serves the root
``config/app.yaml``'s ``Example`` entry, which the zoo keeps disabled.

It has no parameters and matches nothing: 512 slots of zero keypoints,
zero scores and a mask with no valid slot, the fixed-shape outputs of a
standalone matcher.
"""

import torch

from ...utils.base_model import BaseModel

SLOTS = 512


def apply(image0):
    """The empty match set of a batch of pairs, shaped from view 0 (B,
    C, H, W): keypoints0/1 (B, 512, 2), scores (B, 512), mask (B, 512)."""
    b = image0.shape[0]
    zeros = image0.new_zeros((b, SLOTS, 2))
    return {"keypoints0": zeros, "keypoints1": zeros.clone(),
            "scores": image0.new_zeros((b, SLOTS)),
            "mask": torch.zeros((b, SLOTS), dtype=torch.bool,
                                device=image0.device)}


class Example(BaseModel):
    default_conf = {
        "model_name": "example.pth",
        "match_threshold": 0.2,
        "max_keypoints": 2048,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params = {}
        self.meta = {"pretrained": False, "source": "no parameters"}

    def _forward(self, data):
        out = apply(torch.as_tensor(data["image0"], dtype=torch.float32,
                                    device=self.device))
        out["mconf"] = out["scores"]
        return out
