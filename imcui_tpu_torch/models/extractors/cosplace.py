"""CosPlace global descriptor. Counterpart of
``imcui_tpu/models/extractors/cosplace.py``.

A torchvision ResNet trunk (``backbone``: ResNet18, ResNet50 or
ResNet101, to stride 32), then CosPlace's aggregation: the features
L2-normalised over channels, GeM pooling with a learned exponent
(``gem.p``), a linear head to ``fc_output_dim`` and an L2 norm. The input
is [0, 1] RGB, ImageNet-normalised. EigenPlaces (``eigenplaces.py``) and
DIR (``dir.py``) are this network under other defaults.

No CosPlace, EigenPlaces or DIR checkpoint is in the repository: the
model runs a user's ``checkpoint_npz`` or the port's seed-0 tree, drawn
on the model's device, which ``meta`` reports.
"""

import torch

from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones.resnet import (gem_pool, init_resnet, init_resnet18,
                                resnet18_apply, resnet_apply)
from ..layers import full_fp32, init_linear, l2_normalize, linear

# the trunk's output channels per backbone
FEAT_DIMS = {"ResNet18": 512, "ResNet50": 2048, "ResNet101": 2048}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_params(gen, backbone, fc_output_dim):
    trunk = (init_resnet18(gen) if backbone == "ResNet18"
             else init_resnet(gen, backbone.lower()))
    return {"backbone": trunk,
            "gem": {"p": torch.full((1,), 3.0)},
            "fc": init_linear(gen, FEAT_DIMS[backbone], fc_output_dim)}


def apply(params, image, backbone):
    """image (B, 3, H, W) in [0, 1] → global descriptor (B,
    fc_output_dim)."""
    mean = image.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = image.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    x = (image - mean) / std
    if backbone == "ResNet18":
        feats = resnet18_apply(params["backbone"], x)
    else:
        feats = resnet_apply(params["backbone"], x, backbone.lower())
    g = gem_pool(l2_normalize(feats, 1), p=params["gem"]["p"])
    return l2_normalize(linear(params["fc"], g), -1)


class CosPlace(BaseModel):
    """{"image" (B, C, H, W)} → {"global_descriptor" (B,
    fc_output_dim)}; a grey image is repeated over three channels."""

    default_conf = {
        "backbone": "ResNet50",
        "fc_output_dim": 2048,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        init = weights.seeded_init(init_params, self.device,
                                   conf["backbone"], conf["fc_output_dim"])
        self.params, self.meta = weights.load_trained(
            conf, init, type(self).__name__.lower(), self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        with full_fp32():
            return {"global_descriptor": apply(self.params, image,
                                               self.conf["backbone"])}
