"""VGG19 fine-feature pyramid (RoMa's CNN encoder). Counterpart of
``imcui_tpu/models/backbones/vgg.py``.

The pyramid is the activation *entering* each max-pool of torchvision's
``vgg19().features``, at strides 1, 2, 4 and 8. Parameter names are the
torchvision layer indices (``layers.{i}``).
"""

from ..layers import conv2d, init_conv, max_pool, relu

# torchvision vgg19().features up to pool4: (index, cin, cout)
VGG19_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256), (16, 256, 256),
    (19, 256, 512), (21, 512, 512), (23, 512, 512), (25, 512, 512),
]
POOL_AFTER = {2, 7, 16}
COLLECT_AFTER = {2: 1, 7: 2, 16: 4, 25: 8}  # conv index → pyramid stride

FEAT_DIMS = {1: 64, 2: 128, 4: 256, 8: 512}


def init_params(gen):
    return {"layers": {str(idx): init_conv(gen, 3, 3, cin, cout)
                       for idx, cin, cout in VGG19_CONVS}}


def apply(params, image):
    """image: (3, H, W) in [0, 1] → {1: (64, H, W), 2: (128, H/2, W/2),
    4: (256, H/4, W/4), 8: (512, H/8, W/8)}."""
    x = image[None]
    feats = {}
    for idx, _, _ in VGG19_CONVS:
        x = relu(conv2d(params["layers"][str(idx)], x))
        if idx in COLLECT_AFTER:
            feats[COLLECT_AFTER[idx]] = x[0]
        if idx in POOL_AFTER:
            x = max_pool(x)
    return feats
