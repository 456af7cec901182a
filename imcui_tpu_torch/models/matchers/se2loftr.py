"""SE2-LoFTR, the rotation-equivariant LoFTR. Counterpart of
``imcui_tpu/models/matchers/se2loftr.py``: LoFTR's backbone is replaced by
cyclic group convolutions over four orientations (C4): a lifting conv
whose four 90°-rotated kernel copies are stacked on the output channels,
then group convs whose kernels are rotated and whose input orientations
are rolled for each output orientation; a max over the orientations
makes the coarse and fine features rotation-invariant. The transformer,
the coarse assignment and the fine refinement are LoFTR's.

Weight layout. The JAX package rotates HWIO kernels over axes (0, 1) and
rolls the orientation axis of the input channels (axis 2 of HWIO split as
(GROUP, cin)); on OIHW kernels the rotation is over dims (2, 3) and the
roll over dim 1 split as (GROUP, cin). The four orientations' kernels are
stacked on the output channels and run as one convolution.

The upstream checkpoint is not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import conv2d, init_conv, max_pool, relu
from . import loftr

GROUP = 4
CFG = [24, 32, 64]  # channels of one orientation at 1/2, 1/4, 1/8


def init_params(gen):
    """Random initialisation from ``gen`` with the JAX tree's leaves."""
    base = loftr.init_params(gen, n_coarse_layers=4, n_fine_layers=2)
    return {
        "loftr_coarse": base["loftr_coarse"],
        "loftr_fine": base["loftr_fine"],
        "fine_preprocess": base["fine_preprocess"],
        "lift": init_conv(gen, 7, 7, 1, CFG[0], bias=False),
        "gconv1": init_conv(gen, 3, 3, GROUP * CFG[0], CFG[1], bias=False),
        "gconv2": init_conv(gen, 3, 3, GROUP * CFG[1], CFG[2], bias=False),
        "coarse_proj": init_conv(gen, 1, 1, CFG[2], loftr.D_COARSE),
        "fine_proj": init_conv(gen, 1, 1, CFG[0], loftr.D_FINE),
    }


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "se2loftr", device)


def lift_conv(w, x, stride=2):
    """w: (cout, 1, kh, kw) → GROUP · cout output channels, orientation
    major."""
    ws = torch.cat([torch.rot90(w, g, dims=(2, 3)) for g in range(GROUP)], 0)
    return conv2d({"w": ws}, x, stride=stride)


def group_conv(w, x, stride=1):
    """w: (cout, GROUP · cin, kh, kw) on x (B, GROUP · cin, H, W) → (B,
    GROUP · cout, H, W): for orientation g the kernel rotated g times with
    its input orientations rolled by g."""
    cout, gcin, kh, kw = w.shape
    ws = []
    for g in range(GROUP):
        wg = torch.rot90(w, g, dims=(2, 3)).reshape(
            cout, GROUP, gcin // GROUP, kh, kw)
        ws.append(torch.roll(wg, g, dims=1).reshape(cout, gcin, kh, kw))
    return conv2d({"w": torch.cat(ws, 0)}, x, stride=stride)


def _orientation_max(x, c):
    b, _, h, w = x.shape
    return x.reshape(b, GROUP, c, h, w).amax(1)


def backbone_apply(params, x):
    """x: (B, 1, H, W) → rotation-invariant coarse (B, 256, H/8, W/8) and
    fine (B, 128, H/2, W/2)."""
    g1 = relu(lift_conv(params["lift"]["w"], x, stride=2))
    g2 = relu(group_conv(params["gconv1"]["w"], max_pool(g1)))
    g3 = relu(group_conv(params["gconv2"]["w"], max_pool(g2)))
    coarse = conv2d(params["coarse_proj"], _orientation_max(g3, CFG[2]))
    fine = conv2d(params["fine_proj"], _orientation_max(g1, CFG[0]))
    return coarse, fine


def forward_pair(params, image0, image1, wh0, wh1, conf):
    featc, featf = backbone_apply(params, torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    fc0, fc1 = loftr.coarse_transform(params["loftr_coarse"]["layers"], fc0,
                                      fc1, m0, m1)
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, threshold=conf.get("match_threshold", 0.2),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = loftr.fine_match(params, win0, win1, valid)
    return loftr.finish(idx0, idx1, score, valid, offsets1, wc)


class Se2LoFTR(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs."""

    default_conf = {
        "variant": "rot8",
        "max_keypoints": 2048,
        "match_threshold": 0.2,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"se2loftr weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "max_matches": int(conf.get("max_keypoints") or 2048)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
