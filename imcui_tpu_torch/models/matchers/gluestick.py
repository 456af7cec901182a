"""GlueStick: point and line matching. Counterpart of
``imcui_tpu/models/matchers/gluestick.py``.

A wireframe extractor (SuperPoint keypoints and LSD line segments) feeds
one of two matchers, which return keypoint matches and line matches:

1. the default path, which nothing learned decides: mutual nearest
   neighbours of the keypoints' descriptors, and lines matched by
   descriptor votes along five points sampled on each segment (a line
   pair needs ``min_line_votes`` mutual point pairs);
2. the GlueStick GNN (``gnn_forward``), with upstream's layer stack and
   parameter names: junction tokens (the keypoints and the line
   endpoints, described by SuperPoint), SuperGlue's keypoint encoder and
   an endpoint encoder, 18 alternating self and cross propagation layers
   with line message passing after every self layer, the Sinkhorn point
   head and the double-softmax line head. Its attention is the plain
   masked product (``ops/attention.py::mha``), as the JAX module's einsum.

No GlueStick checkpoint is in the repository, so ``use_gnn`` is False by
default and the GNN runs the port's seed-0 tree when a caller asks for
it; the upstream ``.tar`` conversion waits for such a file.

Two SuperPoint passes, as in the JAX module: the keypoints come from the
``SuperPoint`` model at its bf16 default (on the card the stem kernel,
``stage_tail`` and ``nms_cellmax``), the dense descriptor maps from a
second float32 pass of the trunk (TF32 off). The lines come from
``ops/lsd.py``, OpenCV's LSD restated, on the uint8 image
clip(g 255, 0, 255) truncated, where g is the image's one channel or the
float32 mean of its three, summed in numpy's order ((r + g) + b) / 3.

``detect_lines`` orders the kept segments by length with a stable sort,
so that equal lengths (the sides of a square) keep LSD's order; the JAX
module's ``np.argsort`` is numpy's unstable introsort, so segments of
equal length can come in another order there. Tests compare segments and
line matches as sets.
"""

import torch

from ...ops import lsd
from ...ops.matching import mutual_nn_match
from ...ops.nms import sample_descriptors
from ...ops.sinkhorn import log_optimal_transport, matches_from_assignment
from ...utils import weights
from ...utils.base_model import BaseModel
from ..extractors import superpoint as sp_mod
from ..layers import full_fp32, init_linear, linear
from .superglue import (attn_propagation, init_mlp, mlp_apply,
                        normalize_keypoints)

N_LINE_SAMPLES = 5
D_MODEL = 256
NHEAD = 4
N_GNN_LAYERS = 18  # ["self", "cross"] * 9, upstream's GNN_layers
KENC_LAYERS = [32, 64, 128, 256]


def gray_u8(image):
    """The JAX module's uint8 view of a (1, C, H, W) image in [0, 1]: the
    one channel or the float32 mean of three, times 255, clipped and
    truncated. Returns (g (H, W) float32, u (H, W) uint8)."""
    x = image[0]
    g = ((x[0] + x[1]) + x[2]) / 3.0 if x.shape[0] == 3 else x[0]
    return g, (g * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def detect_lines(gray8, max_lines=512, min_length=15.0):
    """LSD segments of a uint8 (H, W) tensor, at least ``min_length``
    long, the longest ``max_lines`` first (a stable order). Returns
    (L, 2, 2) float32 xy on the image's device."""
    lines = torch.from_numpy(lsd.detect(gray8)[0]).to(gray8.device)
    d = lines[:, 2:] - lines[:, :2]
    lengths = torch.sqrt((d * d).sum(1))
    keep = lengths >= min_length
    lines, lengths = lines[keep], lengths[keep]
    order = torch.sort(-lengths, stable=True)[1][:max_lines]
    return lines[order].reshape(-1, 2, 2)


def sample_line_points(lines, n=N_LINE_SAMPLES):
    """(L, 2, 2) → (L, n, 2) points evenly spaced along each segment,
    computed in float64 and rounded to float32 (the JAX module's numpy
    arithmetic)."""
    t = torch.linspace(0.0, 1.0, n, dtype=torch.float64,
                       device=lines.device)[None, :, None]
    p0 = lines[:, None, 0].double()
    p1 = lines[:, None, 1].double()
    return (p0 + (p1 - p0) * t).float()


def describe_points(desc_map, pts, stride=8):
    """Bilinear samples of a descriptor map (C, Hc, Wc) at image points
    (..., 2) → (..., C)."""
    flat = pts.reshape(1, -1, 2)
    d = sample_descriptors(flat, desc_map[None], s=stride)[0]
    return d.T.reshape(*pts.shape[:-1], -1)


def match_lines(desc0, desc1, min_votes=3):
    """Descriptor voting: line i matches line j when at least
    ``min_votes`` of its sampled points are mutual nearest neighbours of
    points on j, j the first line with the most votes. desc*: (L, S, C).
    Returns (L0,) int32, -1 where unmatched."""
    l0, s, c = desc0.shape
    if l0 == 0 or len(desc1) == 0:
        return torch.full((l0,), -1, dtype=torch.int32, device=desc0.device)
    l1 = len(desc1)
    with full_fp32():
        sim = desc0.reshape(-1, c) @ desc1.reshape(-1, c).T
    nn01 = sim.argmax(1)
    nn10 = sim.argmax(0)
    idx = torch.arange(l0 * s, device=sim.device)
    mutual = idx == nn10[nn01]
    votes = torch.zeros(l0 * l1, dtype=torch.int32, device=sim.device)
    votes.index_add_(0, (idx // s) * l1 + nn01 // s, mutual.to(torch.int32))
    votes = votes.reshape(l0, l1)
    best = votes.argmax(1)
    ok = votes.gather(1, best[:, None])[:, 0] >= min_votes
    return torch.where(ok, best, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# The GlueStick GNN over junction tokens
# ---------------------------------------------------------------------------

def init_gnn_params(gen):
    """Random tree in torch layout with the JAX ``init_gnn_params``'s
    keys."""
    params = {
        "kenc": {"encoder": init_mlp(gen, [3] + KENC_LAYERS + [D_MODEL])},
        "lenc": {"encoder": init_mlp(gen, [5] + KENC_LAYERS + [D_MODEL])},
        "gnn": {"layers": [], "line_layers": []},
        "final_proj": init_linear(gen, D_MODEL, D_MODEL),
        "final_line_proj": init_linear(gen, D_MODEL, D_MODEL),
        "bin_score": torch.tensor(1.0),
        "line_bin_score": torch.tensor(1.0),
    }
    for _ in range(N_GNN_LAYERS):
        params["gnn"]["layers"].append({
            "attn": {"merge": init_linear(gen, D_MODEL, D_MODEL),
                     "proj": {str(j): init_linear(gen, D_MODEL, D_MODEL)
                              for j in range(3)}},
            "mlp": init_mlp(gen, [2 * D_MODEL, 2 * D_MODEL, D_MODEL]),
        })
    for _ in range(N_GNN_LAYERS // 2):
        params["gnn"]["line_layers"].append(
            {"mlp": init_mlp(gen, [3 * D_MODEL, 2 * D_MODEL, D_MODEL])})
    return params


def _line_message(p, x, line_enc, junc_idx, mask_line):
    """Upstream's LineLayer: each endpoint token receives MLP([own,
    partner endpoint, line encoding]), averaged into its junction.
    x (T, D); junc_idx (2L,) endpoint → token (consecutive pairs are one
    line)."""
    t, d = x.shape
    ep = x[junc_idx]
    other = ep.reshape(-1, 2, d).flip(1).reshape(-1, d)
    msg = mlp_apply(p["mlp"], torch.cat([ep, other, line_enc], -1),
                    [3 * d, 2 * d, d])
    w = mask_line.repeat_interleave(2).to(x.dtype)
    upd = x.new_zeros(t, d).index_add_(0, junc_idx, msg * w[:, None])
    cnt = x.new_zeros(t).index_add_(0, junc_idx, w)
    return x + upd / cnt.clamp_min(1.0)[:, None]


def log_double_softmax(scores, bin_score):
    """Upstream's line assignment: the mean of the row and the column
    log-softmax with a learned bin. (M, N) → (M + 1, N + 1)."""
    m, n = scores.shape
    s0 = torch.cat([scores, bin_score.expand(m, 1)], 1).log_softmax(1)
    s1 = torch.cat([scores, bin_score.expand(1, n)], 0).log_softmax(0)
    out = scores.new_zeros(m + 1, n + 1)
    out[:m, :n] = (s0[:, :n] + s1[:m, :]) / 2
    out[:m, n] = s0[:, n]
    out[m, :n] = s1[m, :]
    return out


def gnn_forward(params, junc0, jdesc0, jscore0, lines0, lscore0, jidx0,
                mk0, ml0, junc1, jdesc1, jscore1, lines1, lscore1, jidx1,
                mk1, ml1, size0, size1, conf, with_assignments=False):
    """The joint point and line GNN over one pair's junction tokens,
    float32 with TF32 off.

    junc* (T, 2); jdesc* (T, 256); jscore* (T,); lines* (L, 2, 2);
    lscore* (L,); jidx* (2L,) endpoint → token; mk* (T,) and ml* (L,)
    validity; size* (2,) w, h. Returns point matches (T,) and scores,
    line matches (L,) and scores; with ``with_assignments`` also the
    point and line log assignments."""
    ll = lines0.shape[0]
    thr = conf.get("match_threshold", 0.2)

    def encode(junc, jdesc, jscore, lines, lscore, size):
        size = size[None]
        pn = normalize_keypoints(junc[None], size)[0]
        x = jdesc + mlp_apply(params["kenc"]["encoder"],
                              torch.cat([pn, jscore[:, None]], -1),
                              [3] + KENC_LAYERS + [D_MODEL])
        ep = normalize_keypoints(lines.reshape(1, -1, 2), size)[0]
        e2 = ep.reshape(-1, 2, 2)
        off = (e2.flip(1) - e2).reshape(-1, 2)
        lenc_in = torch.cat([ep, off, lscore.repeat_interleave(2)[:, None]],
                            -1)
        line_enc = mlp_apply(params["lenc"]["encoder"], lenc_in,
                             [5] + KENC_LAYERS + [D_MODEL])
        return x, line_enc

    with full_fp32():
        x0, le0 = encode(junc0, jdesc0, jscore0, lines0, lscore0, size0)
        x1, le1 = encode(junc1, jdesc1, jscore1, lines1, lscore1, size1)
        x0, x1 = x0[None], x1[None]
        m0, m1 = mk0[None], mk1[None]
        for i, p in enumerate(params["gnn"]["layers"]):
            if i % 2 == 0:  # self, then line message passing
                x0 = x0 + attn_propagation(p, x0, x0, m0, NHEAD)
                x1 = x1 + attn_propagation(p, x1, x1, m1, NHEAD)
                lp = params["gnn"]["line_layers"][i // 2]
                x0 = _line_message(lp, x0[0], le0, jidx0, ml0)[None]
                x1 = _line_message(lp, x1[0], le1, jidx1, ml1)[None]
            else:  # cross
                x0n = x0 + attn_propagation(p, x0, x1, m1, NHEAD)
                x1 = x1 + attn_propagation(p, x1, x0, m0, NHEAD)
                x0 = x0n
        x0, x1 = x0[0], x1[0]

        f0 = linear(params["final_proj"], x0)
        f1 = linear(params["final_proj"], x1)
        sim = (f0 @ f1.T) / D_MODEL ** 0.5
        z = log_optimal_transport(sim, params["bin_score"],
                                  conf.get("sinkhorn_iterations", 20),
                                  mask0=mk0, mask1=mk1)
        matches0, mscores0 = matches_from_assignment(z, thr, mask0=mk0,
                                                     mask1=mk1)

        ep0 = linear(params["final_line_proj"], x0)[jidx0]
        ep1 = linear(params["final_line_proj"], x1)[jidx1]
        s = (ep0 @ ep1.T / D_MODEL ** 0.5).reshape(ll, 2, -1, 2)
        raw = 0.5 * torch.maximum(s[:, 0, :, 0] + s[:, 1, :, 1],
                                  s[:, 0, :, 1] + s[:, 1, :, 0])
        raw = torch.where(ml0[:, None] & ml1[None, :], raw, -1e9)
        zl = log_double_softmax(raw, params["line_bin_score"])
        lmatches0, lscores0 = matches_from_assignment(zl, thr, mask0=ml0,
                                                      mask1=ml1)
    out = (matches0, mscores0, lmatches0, lscores0)
    return out + (z, zl) if with_assignments else out


def _pad_lines(lines, lmax):
    """(L, 2, 2) → (lmax, 2, 2) zero-padded, the validity, and the
    lengths over the longest as line scores."""
    k = min(len(lines), lmax)
    out = lines.new_zeros(lmax, 2, 2)
    out[:k] = lines[:k]
    valid = torch.arange(lmax, device=lines.device) < k
    d = out[:, 1] - out[:, 0]
    lengths = torch.sqrt((d * d).sum(-1))
    return out, valid, lengths / lengths.max().clamp_min(1e-6)


class GlueStick(BaseModel):
    """Standalone matcher: {"image0", "image1"} (1, C, H, W) → keypoint
    matches and line matches (``lines*``, ``raw_lines*``,
    ``line_keypoints*``: the matched segments' midpoints)."""

    default_conf = {
        "max_keypoints": 1024,
        "max_lines": 512,
        "min_line_length": 15.0,
        "min_line_votes": 3,
        "keypoint_threshold": 1e-4,
        "use_gnn": None,  # None: on only with trained GNN weights
        "match_threshold": 0.2,
        "sinkhorn_iterations": 20,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.sp = sp_mod.SuperPoint({
            "max_keypoints": conf["max_keypoints"],
            "keypoint_threshold": conf["keypoint_threshold"],
        }, device=self.device)
        self.gnn_params = weights.to_device(
            init_gnn_params(torch.Generator().manual_seed(0)), self.device)
        self.meta = {"pretrained": self.sp.meta.get("pretrained", False),
                     "gnn_pretrained": False,
                     "source": "GNN: random init (seed 0)"}
        use = conf.get("use_gnn")
        self.use_gnn = False if use is None else bool(use)

    def _views(self, g0, g1):
        """Keypoints of both views (bf16 SuperPoint) and their float32
        dense descriptor maps (256, Hc, Wc)."""
        sp = self.sp

        def dense(x):
            with full_fp32():
                trunk = sp_mod.backbone(sp.params, x)
                return sp_mod.dense_descriptors(sp.params, trunk)

        if g0.shape == g1.shape:
            x = torch.stack([g0, g1])[:, None]
            feats = sp({"image": x})
            dmaps = dense(x)
            return ({k: v[0] for k, v in feats.items()},
                    {k: v[1] for k, v in feats.items()}, dmaps[0], dmaps[1])
        out = []
        for g in (g0, g1):
            x = g[None, None]
            out.append(({k: v[0] for k, v in sp({"image": x}).items()},
                        dense(x)[0]))
        return out[0][0], out[1][0], out[0][1], out[1][1]

    def _forward(self, data):
        dev = self.device
        image0 = torch.as_tensor(data["image0"], dtype=torch.float32,
                                 device=dev)
        image1 = torch.as_tensor(data["image1"], dtype=torch.float32,
                                 device=dev)
        g0, u0 = gray_u8(image0)
        g1, u1 = gray_u8(image1)
        f0, f1, dmap0, dmap1 = self._views(g0, g1)
        d0, d1 = f0["descriptors"].T, f1["descriptors"].T
        m0, m1 = f0["mask"], f1["mask"]
        kpts0, kpts1 = f0["keypoints"], f1["keypoints"]

        lines0 = detect_lines(u0, self.conf["max_lines"],
                              self.conf["min_line_length"])
        lines1 = detect_lines(u1, self.conf["max_lines"],
                              self.conf["min_line_length"])

        if self.use_gnn:
            lmax = int(self.conf["max_lines"])
            n_kpts = len(kpts0)

            def junctions(kp, desc, ksc, mk, lines, dmap):
                pl, vl, ls = _pad_lines(lines, lmax)
                ep = pl.reshape(-1, 2)
                epd = describe_points(dmap, ep)
                return {
                    "junc": torch.cat([kp, ep], 0),
                    "jdesc": torch.cat([desc, epd], 0),
                    "jscore": torch.cat([ksc, vl.float().repeat_interleave(
                        2)], 0),
                    "mk": torch.cat([mk, vl.repeat_interleave(2)], 0),
                    "jidx": n_kpts + torch.arange(2 * lmax, device=dev),
                    "lines": pl, "ml": vl, "lscore": ls}

            j0 = junctions(kpts0, d0, f0["scores"], m0, lines0, dmap0)
            j1 = junctions(kpts1, d1, f1["scores"], m1, lines1, dmap1)
            size0 = torch.tensor([g0.shape[1], g0.shape[0]],
                                 dtype=torch.float32, device=dev)
            size1 = torch.tensor([g1.shape[1], g1.shape[0]],
                                 dtype=torch.float32, device=dev)
            matches0, mscores0, lm, _ = gnn_forward(
                self.gnn_params,
                j0["junc"], j0["jdesc"], j0["jscore"], j0["lines"],
                j0["lscore"], j0["jidx"], j0["mk"], j0["ml"],
                j1["junc"], j1["jdesc"], j1["jscore"], j1["lines"],
                j1["lscore"], j1["jidx"], j1["mk"], j1["ml"],
                size0, size1, self.conf)
            kpts0, kpts1 = j0["junc"], j1["junc"]
            lm = lm[:len(lines0)]
            lm = torch.where(lm < len(lines1), lm, -1)
        else:
            res = mutual_nn_match(d0, d1, mask0=m0, mask1=m1)
            matches0 = res["matches0"]
            mscores0 = res["matching_scores0"]
            lm = torch.full((len(lines0),), -1, dtype=torch.int32,
                            device=dev)
            if len(lines0) and len(lines1):
                ld0 = describe_points(dmap0, sample_line_points(lines0))
                ld1 = describe_points(dmap1, sample_line_points(lines1))
                lm = match_lines(ld0, ld1, self.conf["min_line_votes"])

        valid = matches0 > -1
        mk0 = kpts0[valid]
        mk1 = kpts1[matches0[valid].long().clamp(0, len(kpts1) - 1)]
        lvalid = lm > -1
        mlines0 = lines0[lvalid]
        mlines1 = lines1[lm[lvalid].long()] if bool(lvalid.any()) else \
            lines0.new_zeros(0, 2, 2)
        return {
            "keypoints0": mk0[None],
            "keypoints1": mk1[None],
            "scores": mscores0[valid][None],
            "mask": torch.ones((1, len(mk0)), dtype=torch.bool, device=dev),
            "lines0": mlines0[None],
            "lines1": mlines1[None],
            "raw_lines0": lines0[None],
            "raw_lines1": lines1[None],
            "line_keypoints0": mlines0.mean(1)[None],
            "line_keypoints1": mlines1.mean(1)[None],
        }
