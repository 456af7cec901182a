"""Descriptor matching: mutual nearest neighbour with the ratio and
distance tests, and the dual softmax. Counterpart of
``imcui_tpu/ops/matching.py``: the same functions on tensors, with any
leading batch dimensions (the JAX package maps them over pairs with
``vmap``).

The similarity is a strict float32 product (``layers.full_fp32``: TF32
would move near-ties on the card). Ties resolve to the lowest index, as
``lax.top_k`` and ``jnp.argmax`` do: ``torch.argmax`` returns the first
maximal index on both devices, and the second neighbour is the argmax
with the first masked out, which is top-2's second slot under that rule.
``matches0 == -1`` marks unmatched and padded slots.
"""

import torch

from ..models.layers import full_fp32

NEG_INF = -1e9


def masked_similarity(desc0, desc1, mask0=None, mask1=None):
    """Cosine-similarity matrix with invalid rows and columns at NEG_INF.
    desc0 (..., N0, D), desc1 (..., N1, D), assumed L2-normalised; masks
    (..., N0) and (..., N1) bool. Returns (..., N0, N1) float32."""
    with full_fp32():
        sim = torch.einsum("...nd,...md->...nm", desc0.float(), desc1.float())
    if mask0 is not None:
        sim = sim.masked_fill(~mask0[..., :, None], NEG_INF)
    if mask1 is not None:
        sim = sim.masked_fill(~mask1[..., None, :], NEG_INF)
    return sim


def _top2(sim):
    """Values and indices of the two largest entries of each row, ties to
    the lowest index: (..., N0, k) for k = 1 and 2 stacked."""
    i0 = sim.argmax(-1, keepdim=True)
    rest = sim.scatter(-1, i0, float("-inf"))
    i1 = rest.argmax(-1, keepdim=True)
    idx = torch.cat([i0, i1], -1)
    return sim.gather(-1, idx), idx


def find_nn(sim, ratio_thresh=None, distance_thresh=None):
    """Top-1 match per row with the optional Lowe ratio test and distance
    test, both on squared distances 2(1 - s) of unit vectors. Returns
    matches0 (..., N0) int64 in [-1, N1) and scores0 (s + 1) / 2."""
    if ratio_thresh:
        sim_nn, ind_nn = _top2(sim)
    else:
        ind_nn = sim.argmax(-1, keepdim=True)
        sim_nn = sim.gather(-1, ind_nn)
    dist_nn = 2.0 * (1.0 - sim_nn)
    mask = sim_nn[..., 0] > NEG_INF / 2
    if ratio_thresh:
        mask = mask & (dist_nn[..., 0] <= (ratio_thresh ** 2) * dist_nn[..., 1])
    if distance_thresh:
        mask = mask & (dist_nn[..., 0] <= distance_thresh ** 2)
    matches = torch.where(mask, ind_nn[..., 0], -1)
    scores = torch.where(mask, (sim_nn[..., 0] + 1) / 2.0, 0.0)
    return matches, scores


def mutual_check(m0, m1):
    """Keep only cycle-consistent matches: m1[m0[i]] == i."""
    inds0 = torch.arange(m0.shape[-1], device=m0.device)
    loop = m1.gather(-1, m0.clamp(0, m1.shape[-1] - 1))
    return torch.where((m0 > -1) & (inds0 == loop), m0, -1)


def mutual_nn_match(desc0, desc1, mask0=None, mask1=None, ratio_thresh=None,
                    distance_thresh=None, do_mutual_check=True):
    """The nearest-neighbour matcher. Returns {"matches0" (..., N0) int32,
    "matching_scores0" (..., N0) float32}."""
    sim = masked_similarity(desc0, desc1, mask0, mask1)
    m0, s0 = find_nn(sim, ratio_thresh, distance_thresh)
    if do_mutual_check:
        m1, _ = find_nn(sim.transpose(-1, -2), ratio_thresh, distance_thresh)
        m0 = mutual_check(m0, m1)
        s0 = torch.where(m0 > -1, s0, 0.0)
    return {"matches0": m0.to(torch.int32), "matching_scores0": s0}


def _softmax(x, dim):
    """exp(x - max) / sum, in the order of ``jax.nn.softmax`` (within 1e-6
    of it on the CPU; ``Tensor.softmax`` along a column is not)."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def dual_softmax_match(desc0, desc1, mask0=None, mask1=None,
                       inv_temperature=20.0, match_threshold=0.2):
    """Dual-softmax assignment: P = softmax over rows ⊙ softmax over
    columns of the scaled similarity; mutual argmaxes above the threshold
    are kept. Returns matches0 (..., N0) int32, matching_scores0 and the
    full (..., N0, N1) P as ``similarity``."""
    sim = masked_similarity(desc0, desc1, mask0, mask1) * inv_temperature
    p = _softmax(sim, -1) * _softmax(sim, -2)
    idx0 = p.argmax(-1)
    idx1 = p.argmax(-2)
    inds0 = torch.arange(p.shape[-2], device=p.device)
    mutual = inds0 == idx1.gather(-1, idx0)
    scores = p.amax(-1)
    valid = mutual & (scores > match_threshold)
    if mask0 is not None:
        valid = valid & mask0
    return {"matches0": torch.where(valid, idx0, -1).to(torch.int32),
            "matching_scores0": torch.where(valid, scores, 0.0),
            "similarity": p}
