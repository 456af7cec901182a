"""JamMa: detector-free matching by joint Mamba scans. Counterpart of
``imcui_tpu/models/matchers/jamma.py``. Where LoMa alternates per-image
and cross-image scans, every JamMa layer scans the two images' coarse
tokens jointly, interleaved token by token, forward and backward; the
layers alternate row-major and column-major orders (a fixed permutation
of the token axis). The scan is LoMa's (``loma.selective_scan`` on the
chunked ``loma.linear_scan``); the trunk and the coarse and fine stages
are LoFTR's.

The upstream ``jamma_weight.ckpt`` is not in the repository: the weights
are ``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says
which). float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from . import loftr, loma

N_LAYERS = 4


def init_params(gen):
    return loma.init_params(gen, n_layers=N_LAYERS)


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "jamma", device)


def _col_major_perm(hc, wc, device="cpu"):
    return torch.arange(hc * wc, device=device).reshape(hc, wc).T.reshape(-1)


def joint_scan(p, f0, f1, m0, m1, perm=None):
    """Interleave both images token by token ([a0, b0, a1, b1, ...]), scan
    forward and backward, split back."""
    n = f0.shape[0]
    if perm is not None:
        f0, f1, m0, m1 = f0[perm], f1[perm], m0[perm], m1[perm]
    seq = torch.stack([f0, f1], 1).reshape(2 * n, -1)
    mask = torch.stack([m0, m1], 1).reshape(2 * n)
    out = loma.bidirectional_scan(p, seq, mask).reshape(n, 2, -1)
    o0, o1 = out[:, 0], out[:, 1]
    if perm is not None:
        inv = torch.argsort(perm)
        o0, o1 = o0[inv], o1[inv]
    return o0, o1


def _mix(layers, fc0, fc1, m0, m1, hc, wc):
    colp = _col_major_perm(hc, wc, fc0.device)
    for i, p in enumerate(layers):
        fc0, fc1 = joint_scan(p, fc0, fc1, m0, m1,
                              perm=colp if i % 2 else None)
    return fc0, fc1


def forward_pair(params, image0, image1, wh0, wh1, conf):
    """One pair, as ``loma.forward_pair``."""
    out = loma.scan_pair(params, image0, image1, wh0, wh1, _mix)
    return loma.finish_pair(params, *out, conf, 0.3)


class JamMa(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs."""

    default_conf = {
        "weights": "jamma_weight.ckpt",
        "max_keypoints": 2000,
        "match_threshold": 0.3,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"jamma weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "max_matches": int(conf.get("max_keypoints") or 2000)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
