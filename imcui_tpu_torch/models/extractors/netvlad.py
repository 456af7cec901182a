"""NetVLAD global descriptor. Counterpart of
``imcui_tpu/models/extractors/netvlad.py``.

VGG16's conv trunk through conv5_3 (``features[:-2]``: no ReLU after
conv5_3, no pool5; 512 channels at stride 16), NetVLAD pooling over 64
clusters, then the whitening linear to 4096 and an L2 norm. The input is
[0, 1] RGB, taken to [0, 255] minus the VGG means, as the MATLAB-trained
weights expect.

NetVLAD pooling: the descriptors L2-normalised, a 1 × 1 bias-free conv
to the 64 cluster scores, their softmax, Σ_n a_nk (f_n − c_k) per
cluster, intra-normalised, then flattened D-major (index d·64 + k, the
reference's (B, D, K) view, which the whitening was trained on) and
L2-normalised.

No NetVLAD checkpoint (``VGG16-NetVLAD-Pitts30K.mat``) is in the
repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 tree, drawn on the model's device (the whitening alone is 4096 ×
32768), which ``meta`` reports.
"""

import torch

from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (conv2d, full_fp32, init_conv, init_linear,
                      l2_normalize, linear, max_pool, relu)

# VGG16's conv blocks through conv5_3; the tree keys each conv by its
# index in torchvision's ``features`` (a ReLU after each conv, a pool
# after each block)
VGG16_CFG = [(64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
             (512, 512, 512)]
N_CLUSTERS = 64
FEAT_DIM = 512
OUT_DIM = 4096
VGG_MEAN = (123.68, 116.779, 103.939)


def init_params(gen):
    backbone, idx, cin = {}, 0, 3
    for block in VGG16_CFG:
        for cout in block:
            backbone[str(idx)] = init_conv(gen, 3, 3, cin, cout)
            idx += 2  # conv + relu
            cin = cout
        idx += 1  # pool
    return {
        "backbone": backbone,
        "netvlad": {
            "score_proj": init_conv(gen, 1, 1, FEAT_DIM, N_CLUSTERS,
                                    bias=False),
            "centers": torch.randn((FEAT_DIM, N_CLUSTERS),
                                   generator=gen) * 0.01},
        "whiten": init_linear(gen, N_CLUSTERS * FEAT_DIM, OUT_DIM),
    }


def vgg16_trunk(params, x):
    """x (B, 3, H, W) → (B, 512, H/16, W/16), ending at conv5_3 without
    its ReLU."""
    idx = 0
    for bi, block in enumerate(VGG16_CFG):
        for ci in range(len(block)):
            x = conv2d(params[str(idx)], x)
            if not (bi == len(VGG16_CFG) - 1 and ci == len(block) - 1):
                x = relu(x)
            idx += 2
        idx += 1
        if bi < len(VGG16_CFG) - 1:
            x = max_pool(x)
    return x


def netvlad_pool(params, feats):
    """feats (B, 512, H, W) → (B, 64·512) VLAD vector, D-major."""
    b = feats.shape[0]
    feats = l2_normalize(feats, 1)
    assign = torch.softmax(conv2d(params["score_proj"], feats), 1)
    f = feats.flatten(2)                                # (B, D, N)
    a = assign.flatten(2)                               # (B, K, N)
    vlad = a @ f.transpose(1, 2) - a.sum(2)[..., None] * \
        params["centers"].t()[None]                     # (B, K, D)
    vlad = l2_normalize(vlad, -1)
    return l2_normalize(vlad.transpose(1, 2).reshape(b, -1), -1)


def apply(params, image):
    """image (B, 3, H, W) in [0, 1] → global descriptor (B, 4096)."""
    mean = image.new_tensor(VGG_MEAN).view(1, 3, 1, 1) / 255.0
    feats = vgg16_trunk(params["backbone"], (image - mean) * 255.0)
    vlad = netvlad_pool(params["netvlad"], feats)
    return l2_normalize(linear(params["whiten"], vlad), -1)


class NetVLAD(BaseModel):
    """{"image" (B, C, H, W)} → {"global_descriptor" (B, 4096)}; a grey
    image is repeated over three channels."""

    default_conf = {
        "model_name": "VGG16-NetVLAD-Pitts30K",
        "whiten": True,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        init = weights.seeded_init(init_params, self.device)
        self.params, self.meta = weights.load_trained(
            conf, init, type(self).__name__.lower(), self.device)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if image.shape[1] == 1:
            image = image.expand(-1, 3, -1, -1)
        with full_fp32():
            return {"global_descriptor": apply(self.params, image)}
