"""EigenPlaces global descriptor. Counterpart of
``imcui_tpu/models/extractors/eigenplaces.py``: CosPlace's network
(``cosplace.py``) on ResNet101 with a 2048-d head, trained with the
EigenPlaces objective (weights not in the repository)."""

from .cosplace import CosPlace


class EigenPlaces(CosPlace):
    default_conf = {
        "variant": "EigenPlaces",
        "backbone": "ResNet101",
        "fc_output_dim": 2048,
    }
