"""Masked log-domain Sinkhorn optimal transport with dustbins: the
assignment solver inside SuperGlue. Counterpart of
``imcui_tpu/ops/sinkhorn.py``, with any leading batch dimensions (the JAX
package maps pairs with ``vmap``).

Padded keypoint slots carry zero mass: their rows and columns are left
out of the marginals and their scores set to ``NEG_INF``, the finite
-1e9 (not -inf), so one shape serves every keypoint count. The iterations
are a plain loop in the JAX scan's order: u first, then v.

A view with no valid keypoint. Its count enters the marginals as
``log(0) = -inf``, as in the JAX function: an empty view 0 (no mass for
the column dustbin) leaves the dustbin column of the result at -inf, an
empty view 1 the dustbin row; with both, the normalisation
``-log(0 + 0)`` is +inf and the whole result is NaN.
``matches_from_assignment`` masks every slot of an empty view, so either
case decodes to no match (tests/test_torch_port_superglue.py pins both
against the JAX function).
"""

import torch

NEG_INF = -1e9


def log_sinkhorn_iterations(Z, log_mu, log_nu, iters):
    """Sinkhorn in log space. Z: (..., M+1, N+1) scores with dustbins;
    log_mu (..., M+1), log_nu (..., N+1)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[..., None, :], dim=-1)
        v = log_nu - torch.logsumexp(Z + u[..., :, None], dim=-2)
    return Z + u[..., :, None] + v[..., None, :]


def log_optimal_transport(scores, alpha, iters, mask0=None, mask1=None):
    """Optimal transport with a dustbin row and column.

    scores: (..., M, N) similarity logits; alpha: the dustbin score (a
    scalar tensor); mask0 (..., M) and mask1 (..., N) bool validity of
    the rows and columns (padded slots get zero mass). Returns the
    (..., M+1, N+1) log assignment, scaled by M+N as in the JAX function."""
    *lead, m, n = scores.shape
    dev, dtype = scores.device, scores.dtype
    if mask0 is None:
        mask0 = torch.ones((*lead, m), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((*lead, n), dtype=torch.bool, device=dev)
    ms = mask0.to(dtype).sum(-1)
    ns = mask1.to(dtype).sum(-1)
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)

    # invalid scores leave the game; the dustbins stay reachable
    scores = torch.where(mask0[..., :, None] & mask1[..., None, :], scores,
                         NEG_INF)
    bins0 = torch.where(mask0[..., :, None], alpha, NEG_INF)
    bins1 = torch.where(mask1[..., None, :], alpha, NEG_INF)
    corner = alpha.expand(*lead, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1),
                           torch.cat([bins1, corner], -1)], -2)

    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(mask0, norm[..., None], NEG_INF),
                        (torch.log(ns) + norm)[..., None]], -1)
    log_nu = torch.cat([torch.where(mask1, norm[..., None], NEG_INF),
                        (torch.log(ms) + norm)[..., None]], -1)
    Z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters)
    return Z - norm[..., None, None]  # probabilities times M+N


def matches_from_assignment(Z, match_threshold=0.2, mask0=None, mask1=None):
    """Mutual-argmax matches of a (..., M+1, N+1) log assignment: the
    mutual maxima of the non-dustbin block whose probability exceeds the
    threshold. Ties go to the lowest index, as ``jnp.argmax``. Returns
    matches0 (..., M) int32 (-1 where unmatched) and matching_scores0."""
    probs = torch.exp(Z[..., :-1, :-1])
    if mask0 is not None:
        probs = torch.where(mask0[..., :, None], probs, 0.0)
    if mask1 is not None:
        probs = torch.where(mask1[..., None, :], probs, 0.0)
    idx0 = probs.argmax(-1)
    idx1 = probs.argmax(-2)
    inds0 = torch.arange(probs.shape[-2], device=probs.device)
    mutual = inds0 == idx1.gather(-1, idx0)
    scores = probs.amax(-1)
    valid = mutual & (scores > match_threshold)
    if mask0 is not None:
        valid = valid & mask0
    matches0 = torch.where(valid, idx0, -1).to(torch.int32)
    return matches0, torch.where(valid, scores, 0.0)
