"""OpenIBL's SFRS global descriptor. Counterpart of
``imcui_tpu/models/extractors/openibl.py``: NetVLAD's network
(``netvlad.py``) under the name of its SFRS-trained weights, which are
not in the repository."""

from .netvlad import NetVLAD


class OpenIBL(NetVLAD):
    default_conf = {
        "model_name": "vgg16_netvlad",
        "whiten": True,
    }
