"""MASt3R: DUSt3R's trunk with a local-descriptor head, matched on the
descriptors. Counterpart of ``imcui_tpu/models/matchers/mast3r.py``.

Each view's head gains ``head_local_features``: a GELU MLP (hidden 4 ×
its input) over the concatenated encoder and last decoder tokens, whose
(desc_dim + 1)·patch² outputs per patch are laid out by pixel shuffle
into a full-resolution map of L2-normalised ``desc_dim``-d descriptors
and a 1 + exp confidence. Matches are mutual nearest neighbours of the
descriptors (cosine similarity, argmax both ways) on the grid subsampled
by ``subsample``, scored by similarity × both confidences, the best
``max_matches`` kept and valid above 0.

The trunk, its attention routes (K14 for every block in bfloat16 with
``vit.ATTN_IMPL = "fused"``) and the precision rules are DUSt3R's
(``duster.py``). No trained tree (the metric catmlpdpt checkpoint) is in
the repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 random tree.
"""

import torch

from ..layers import full_fp32, gelu, init_linear, l2_normalize, linear
from . import duster as duster_mod
from .duster import Duster

DESC_DIM = 24


def init_desc_head(gen, enc_dim, dec_dim, patch, desc_dim=DESC_DIM,
                   hidden_factor=4):
    idim = enc_dim + dec_dim
    return {"fc1": init_linear(gen, idim, hidden_factor * idim),
            "fc2": init_linear(gen, hidden_factor * idim,
                               (desc_dim + 1) * patch ** 2)}


def init_params(gen, conf):
    params = duster_mod.init_params(gen, conf)
    for key in ("downstream_head1", "downstream_head2"):
        params[key]["head_local_features"] = init_desc_head(
            gen, conf["enc_dim"], conf["dec_dim"], conf["patch"],
            conf.get("desc_dim", DESC_DIM))
    return params


def desc_head_apply(p, enc_tokens, dec_tokens, grid, patch,
                    desc_dim=DESC_DIM):
    """→ descriptors (H, W, desc_dim), L2-normalised, and their confidence
    (H, W), both float32."""
    x = torch.cat([enc_tokens, dec_tokens], -1)
    x = linear(p["fc2"], gelu(linear(p["fc1"], x)))
    x = duster_mod.pixel_shuffle(x, grid, patch, desc_dim + 1)
    desc = l2_normalize(x[..., :desc_dim].float(), dim=-1, eps=1e-8)
    return desc, 1.0 + torch.exp(x[..., desc_dim].float())


def reciprocal_nn_desc(desc0, desc1, conf0, conf1, coords,
                       max_matches=2048):
    """Mutual nearest neighbours of (N, D) descriptors by cosine
    similarity (float32, no TF32; argmax both ways, the first index among
    equal values as ``jnp.argmax``), scored by the similarity and both
    confidences, the best ``max_matches`` (``torch.topk``) valid above 0."""
    with full_fp32():
        sim = desc0 @ desc1.t()
    best, nn01, nn10 = sim.amax(1), sim.argmax(1), sim.argmax(0)
    mutual = torch.arange(sim.shape[0], device=sim.device) == nn10[nn01]
    score = torch.where(mutual, best * conf0 * conf1[nn01],
                        torch.zeros_like(best))
    return duster_mod._top_matches(score, nn01, coords, max_matches, 0.0)


def forward_pair(params, image0, image1, conf):
    t0, grid = duster_mod.encode(params, image0, conf)
    t1, _ = duster_mod.encode(params, image1, conf)
    h0, h1 = duster_mod.decode(params, t0, t1, grid, conf)
    dd = conf["desc_dim"]
    desc0, dconf0 = desc_head_apply(
        params["downstream_head1"]["head_local_features"], h0[0], h0[-1],
        grid, conf["patch"], dd)
    desc1, dconf1 = desc_head_apply(
        params["downstream_head2"]["head_local_features"], h1[0], h1[-1],
        grid, conf["patch"], dd)
    h, w = desc0.shape[:2]
    gy, gx, coords = duster_mod.subsample_grid(h, w, conf["subsample"],
                                               desc0.device)
    k0, k1, score, valid = reciprocal_nn_desc(
        desc0[gy, gx].reshape(-1, dd), desc1[gy, gx].reshape(-1, dd),
        dconf0[gy, gx].reshape(-1), dconf1[gy, gx].reshape(-1), coords,
        max_matches=conf["max_matches"])
    return {"keypoints0": k0, "keypoints1": k1, "scores": score,
            "mask": valid}


class Mast3r(Duster):
    """Standalone dense matcher, DUSt3R's contract."""

    default_conf = {
        **Duster.default_conf,
        "weights": "mast3r_vit_large",
        "desc_dim": DESC_DIM,
    }
    name = "mast3r"

    def init_params(self, gen, conf):
        return init_params(gen, conf)

    def forward_pair(self, image0, image1):
        return forward_pair(self.params, image0, image1, self.conf)
