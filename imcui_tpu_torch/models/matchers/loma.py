"""LoMa: detector-free matching with linear state-space token mixing.
Counterpart of ``imcui_tpu/models/matchers/loma.py`` (the registry's
``loma-b``, ``loma-l``, ``loma-g`` and ``loma-r``, one architecture). The
coarse transformer of LoFTR is replaced by Mamba-style selective scans:
even layers scan each image's tokens row-major, odd layers scan the two
images' sequences joined, forward and backward. The backbone, the coarse
assignment and the fine refinement are LoFTR's (``models/matchers/
loftr.py``).

The scan. The state recurrence hₜ = decayₜ·hₜ₋₁ + driveₜ runs over ~10⁴
tokens at 640 × 480; one launch per token would be ~10⁴ launches a scan
on the card. ``linear_scan`` computes it in chunks of ``SCAN_CHUNK``
tokens instead, with no loop: within a chunk every state is a weighted
sum of the chunk's drives, the weights exp(Lₜ − Lₛ) (s ≤ t) of the
cumulative log-decay L, and the state entering each chunk is the same
sum one level up over the chunks' end states. Every weight is a product
of decays, so it lies in [0, 1] and nothing overflows; the log-decay
prefix sums are float64, so a difference of two long sums keeps float32's
relative accuracy. The JAX package's ``lax.associative_scan`` multiplies
the same decays in another order (float32 rounding, ~1e-6 relative).

The upstream checkpoints are not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
float32 throughout, as in the JAX package.
"""

import torch
import torch.nn.functional as F

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import init_layer_norm, init_linear, layer_norm, linear
from . import loftr

N_SSM = 4
D_STATE = 16
SCAN_CHUNK = 64


def init_ssm_layer(gen, d):
    return {
        "in_proj": init_linear(gen, d, 2 * d),
        "dt_proj": init_linear(gen, d, 1),
        "b_proj": init_linear(gen, d, D_STATE),
        "c_proj": init_linear(gen, d, D_STATE),
        "out_proj": init_linear(gen, d, d),
        "ln": init_layer_norm(d),
        "a_log": torch.zeros(D_STATE),
    }


def init_params(gen, n_layers=N_SSM):
    """Random initialisation from ``gen`` with the JAX tree's leaves: the
    LoFTR backbone and fine stage (two fine layers) and the scan layers."""
    base = loftr.init_params(gen, n_coarse_layers=0, n_fine_layers=2)
    return {
        "backbone": base["backbone"],
        "fine_preprocess": base["fine_preprocess"],
        "loftr_fine": base["loftr_fine"],
        "ssm": [init_ssm_layer(gen, loftr.D_COARSE)
                for _ in range(n_layers)],
    }


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "loma", device)


def _decay_weights(L, dtype):
    """(..., T, S) inclusive prefix sums of the log-decay → (..., T, T, S)
    weights exp(Lₜ − Lₛ) for s ≤ t and 0 for s > t."""
    t = L.shape[-2]
    diff = L[..., :, None, :] - L[..., None, :, :]
    upper = ~torch.ones(t, t, dtype=torch.bool, device=L.device).tril()
    return torch.exp(diff.masked_fill(upper[:, :, None], float("-inf"))
                     ).to(dtype)


def linear_scan(log_decay, drive):
    """hₜ = exp(lₜ)·hₜ₋₁ + driveₜ from h₋₁ = 0, chunked (module docstring).
    log_decay (N, S) ≤ 0, drive (N, S) → h (N, S) in drive's dtype."""
    n, s = drive.shape
    pad = (-n) % SCAN_CHUNK
    # padded steps have decay 1 and drive 0, after every real step
    L = F.pad(log_decay.double(), (0, 0, 0, pad)).reshape(-1, SCAN_CHUNK, s)
    L = L.cumsum(1)
    dr = F.pad(drive, (0, 0, 0, pad)).reshape(-1, SCAN_CHUNK, s)
    local = torch.einsum("ktcs,kcs->kts", _decay_weights(L, dr.dtype), dr)
    G = L[:, -1].cumsum(0)[None]                            # (1, k, S)
    ends = torch.einsum("ijs,js->is", _decay_weights(G, dr.dtype)[0],
                        local[:, -1])
    carry = torch.cat([ends.new_zeros(1, s), ends[:-1]])
    h = local + torch.exp(L).to(dr.dtype) * carry[:, None]
    return h.reshape(-1, s)[:n]


def selective_scan(p, x, mask):
    """Mamba-style selective SSM over the token axis. x: (N, d), mask (N,)
    (padded tokens leave the state unchanged) → (N, d)."""
    d = x.shape[-1]
    xz = linear(p["in_proj"], x)
    u, z = xz[:, :d], xz[:, d:]
    dt = F.softplus(linear(p["dt_proj"], x))                # (N, 1)
    dt = torch.where(mask[:, None], dt, torch.zeros_like(dt))
    a = -torch.exp(p["a_log"])[None]                        # (1, S)
    bmat = linear(p["b_proj"], x) * dt                      # (N, S)
    cmat = linear(p["c_proj"], x)
    # rank-1 channel mixing: the state is (N, S), not (N, S, d)
    drive = bmat * u.mean(-1, keepdim=True)
    h = linear_scan(dt * a, drive)
    y = (cmat * h).sum(-1, keepdim=True) * u
    y = y + u * F.silu(z)
    return layer_norm(p["ln"], x + linear(p["out_proj"], y))


def bidirectional_scan(p, seq, mask):
    """The mean of a forward and a backward scan of one sequence."""
    fwd = selective_scan(p, seq, mask)
    bwd = selective_scan(p, seq.flip(0), mask.flip(0)).flip(0)
    return (fwd + bwd) * 0.5


def cross_scan(p, f0, f1, m0, m1):
    """One cross-image scan: the two images' tokens joined, scanned both
    ways, split again."""
    out = bidirectional_scan(p, torch.cat([f0, f1]), torch.cat([m0, m1]))
    return out[:f0.shape[0]], out[f0.shape[0]:]


def scan_pair(params, image0, image1, wh0, wh1, mix):
    """The LoFTR backbone, the coarse tokens, ``mix(ssm, fc0, fc1, m0,
    m1)`` over the scan layers, then LoFTR's coarse and fine stages (the
    trunk LoMa and JamMa share)."""
    featc, featf = loftr.backbone_apply(params["backbone"],
                                        torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    fc0, fc1 = mix(params["ssm"], fc0, fc1, m0, m1, hc, wc)
    return fc0, fc1, featf, m0, m1, wc


def finish_pair(params, fc0, fc1, featf, m0, m1, wc, conf, threshold):
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, threshold=conf.get("match_threshold", threshold),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = loftr.fine_match(params, win0, win1, valid)
    return loftr.finish(idx0, idx1, score, valid, offsets1, wc)


def _mix(layers, fc0, fc1, m0, m1, hc, wc):
    for i, p in enumerate(layers):
        if i % 2 == 0:  # row-major scans within each image
            fc0 = selective_scan(p, fc0, m0)
            fc1 = selective_scan(p, fc1, m1)
        else:  # the two images joined
            fc0, fc1 = cross_scan(p, fc0, fc1, m0, m1)
    return fc0, fc1


def forward_pair(params, image0, image1, wh0, wh1, conf):
    """One pair. image*: (1, H, W) in [0, 1]; wh*: the valid (width,
    height). Returns keypoints0/1 (M, 2), scores (M,), mask (M,)."""
    out = scan_pair(params, image0, image1, wh0, wh1, _mix)
    return finish_pair(params, *out, conf, 0.1)


class LoMa(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs."""

    default_conf = {
        "name": "two_view_pipeline",
        "model_name": "loma_b",
        "max_keypoints": 2048,
        "filter_threshold": 0.1,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"loma weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf.get("filter_threshold", 0.1)),
            "max_matches": int(conf.get("max_keypoints") or 2048)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
