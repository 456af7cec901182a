"""Deep Image Retrieval (DIR) global descriptor. Counterpart of
``imcui_tpu/models/extractors/dir.py``: dirtorch's ``Resnet-101-AP-GeM``,
a ResNet101 trunk, GeM with a learned exponent and a 2048-d whitening
head, which is CosPlace's network (``cosplace.py``) under other defaults
(weights not in the repository)."""

from .cosplace import CosPlace


class DIR(CosPlace):
    default_conf = {
        "model_name": "Resnet-101-AP-GeM",
        "backbone": "ResNet101",
        "fc_output_dim": 2048,
        "whiten_name": "Landmarks_clean",
    }
