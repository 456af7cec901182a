"""SOLD2: line detection and matching. Counterpart of
``imcui_tpu/models/matchers/sold2.py``.

The network is SOLD2's with the lcnn backbone (one grey channel, two
depth-4 hourglass stacks of one block, five head classes), with the
``sold2_wireframe.tar`` state_dict's names:

- ``backbone_net.net``: conv1 7 x 7 stride 2, BN and ReLU, pre-activation
  bottlenecks (expansion 2), a 2 x 2 pool to 1/4, two hourglass stacks at
  256 channels with the fc / score / fc_ / score_ wiring between them; the
  feature is the last stack's activation after fc, at 1/4;
- ``junction_decoder``: convPa 3 x 3 stride 2 and ReLU, convPb to 65
  channels, softmax, the dustbin dropped, pixel shuffle by 8;
- ``heatmap_decoder``: two (conv, BN, ReLU, pixel shuffle by 2) blocks,
  then a 1 x 1 conv to 2 channels; the heatmap is the softmax's second;
- ``descriptor_decoder``: convPa 3 x 3 and ReLU, convPb to 128, L2
  normalised.

Detection and matching are the JAX module's fixed-shape restatements: the
64 strongest junctions (NMS radius 3), every pair of them a candidate
segment scored by 8 bilinear samples of the heatmap, the 256 best
candidates kept; five descriptor samples a line, and mutual nearest
neighbours of the mean per-sample similarity, the better of both sample
orders.

Two orders differ from the JAX module, so tests compare lines as
unoriented sets: the junctions are the port's exact top-k (the JAX
package serves ``lax.approx_max_k``; ROADMAP, "Top-k"), so their slots,
and with them each segment's endpoint order, can differ; and the best
candidates are taken by a stable descending sort, which keeps
``lax.top_k``'s lower index first among equal scores.

No SOLD2 checkpoint is in the repository: the model runs the
``checkpoint_npz`` a user names or the port's seed-0 tree, which ``meta``
reports; that tree starts its residual branches and logits small
(``RESIDUAL_INIT``, ``OUT_INIT``), so that its junctions and heatmap stay
apart from 0 and 1. The trunk runs float32 with TF32 off; it reaches no
kernel.
"""

import torch
import torch.nn.functional as F

from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, max_pool, relu, xla_mean3)

MAX_JUNCTIONS = 64
N_SAMPLES = 8
N_DESC_SAMPLES = 5
MAX_LINES = 256
DESC_DIM = 128
NUM_STACKS = 2
DEPTH = 4
HEAD_SIZES = (2, 1, 2)
# the seed-0 tree starts the bottlenecks' residual branches at a tenth of
# He's scale and the junction and heatmap logits at a hundredth: at full
# scale the hourglass's activations reach ~1e4 and both softmaxes saturate
# to exactly 0 and 1, so last-bit differences flip whole junctions
RESIDUAL_INIT = 0.1
OUT_INIT = 0.01


# ---------------------------------------------------------------------------
# lcnn stacked hourglass
# ---------------------------------------------------------------------------

def _init_bottleneck(gen, inplanes, planes):
    """Pre-activation Bottleneck2D (expansion 2), biased convs, a 1 x 1
    downsample where inplanes != 2 planes."""
    p = {
        "bn1": init_bn(inplanes),
        "conv1": init_conv(gen, 1, 1, inplanes, planes),
        "bn2": init_bn(planes),
        "conv2": init_conv(gen, 3, 3, planes, planes),
        "bn3": init_bn(planes),
        "conv3": init_conv(gen, 1, 1, planes, planes * 2),
    }
    if inplanes != planes * 2:
        p["downsample"] = {"0": init_conv(gen, 1, 1, inplanes, planes * 2)}
    return p


def _bottleneck(p, x):
    y = conv2d(p["conv1"], relu(batch_norm_inference(p["bn1"], x)))
    y = conv2d(p["conv2"], relu(batch_norm_inference(p["bn2"], y)))
    y = conv2d(p["conv3"], relu(batch_norm_inference(p["bn3"], y)))
    if "downsample" in p:
        x = conv2d(p["downsample"]["0"], x)
    return y + x


def _init_hourglass(gen, planes=128):
    """hg.{i}: 4 single-block Sequentials at i = 0, 3 elsewhere."""
    return {str(i): {str(j): {"0": _init_bottleneck(gen, planes * 2,
                                                    planes)}
                     for j in range(4 if i == 0 else 3)}
            for i in range(DEPTH)}


def _hourglass_forward(hg, n, x):
    up1 = _bottleneck(hg[str(n - 1)]["0"]["0"], x)
    low1 = _bottleneck(hg[str(n - 1)]["1"]["0"], max_pool(x))
    if n > 1:
        low2 = _hourglass_forward(hg, n - 1, low1)
    else:
        low2 = _bottleneck(hg["0"]["3"]["0"], low1)
    low3 = _bottleneck(hg[str(n - 1)]["2"]["0"], low2)
    return up1 + low3.repeat_interleave(2, 2).repeat_interleave(2, 3)


def _init_head(gen, cin=256):
    """MultitaskHead: a (3 x 3 conv, ReLU, 1 x 1 conv) per partition."""
    return {"heads": {str(h): {"0": init_conv(gen, 3, 3, cin, cin // 4),
                               "2": init_conv(gen, 1, 1, cin // 4, cout)}
                      for h, cout in enumerate(HEAD_SIZES)}}


def _head(p, x):
    return torch.cat([conv2d(p["heads"][str(h)]["2"],
                             relu(conv2d(p["heads"][str(h)]["0"], x)))
                      for h in range(len(HEAD_SIZES))], 1)


def init_hourglass_net(gen):
    net = {
        "conv1": init_conv(gen, 7, 7, 1, 64),
        "bn1": init_bn(64),
        "layer1": {"0": _init_bottleneck(gen, 64, 64)},
        "layer2": {"0": _init_bottleneck(gen, 128, 128)},
        "layer3": {"0": _init_bottleneck(gen, 256, 128)},
        "hg": {}, "res": {}, "fc": {}, "score": {}, "fc_": {}, "score_": {},
    }
    for s in range(NUM_STACKS):
        net["hg"][str(s)] = {"hg": _init_hourglass(gen)}
        net["res"][str(s)] = {"0": _init_bottleneck(gen, 256, 128)}
        net["fc"][str(s)] = {"0": init_conv(gen, 1, 1, 256, 256),
                             "1": init_bn(256)}
        net["score"][str(s)] = _init_head(gen)
        if s < NUM_STACKS - 1:
            net["fc_"][str(s)] = init_conv(gen, 1, 1, 256, 256)
            net["score_"][str(s)] = init_conv(gen, 1, 1, sum(HEAD_SIZES),
                                              256)
    return net


def hourglass_net(net, x):
    """x (B, 1, H, W) → (B, 256, H/4, W/4): the last stack's feature after
    fc (``HourglassBackbone``'s outputs[1])."""
    x = relu(batch_norm_inference(net["bn1"],
                                  conv2d(net["conv1"], x, stride=2)))
    x = _bottleneck(net["layer1"]["0"], x)
    x = max_pool(x)
    x = _bottleneck(net["layer2"]["0"], x)
    x = _bottleneck(net["layer3"]["0"], x)
    y = x
    for s in range(NUM_STACKS):
        y = _hourglass_forward(net["hg"][str(s)]["hg"], DEPTH, x)
        y = _bottleneck(net["res"][str(s)]["0"], y)
        y = relu(batch_norm_inference(net["fc"][str(s)]["1"],
                                      conv2d(net["fc"][str(s)]["0"], y)))
        if s < NUM_STACKS - 1:
            score = _head(net["score"][str(s)], y)
            x = x + conv2d(net["fc_"][str(s)], y) \
                + conv2d(net["score_"][str(s)], score)
    return y


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def init_params(gen):
    """Random tree in torch layout with the JAX ``init_params``'s keys,
    its residual branches and logits started small (``RESIDUAL_INIT``,
    ``OUT_INIT``)."""
    params = {
        "backbone_net": {"net": init_hourglass_net(gen)},
        "junction_decoder": {"convPa": init_conv(gen, 3, 3, 256, 256),
                             "convPb": init_conv(gen, 1, 1, 256, 65)},
        "heatmap_decoder": {"conv_block_lst": {
            "0": {"0": init_conv(gen, 3, 3, 256, 256), "1": init_bn(256)},
            "1": {"0": init_conv(gen, 3, 3, 64, 64), "1": init_bn(64)},
            "2": init_conv(gen, 1, 1, 16, 2),
        }},
        "descriptor_decoder": {"convPa": init_conv(gen, 3, 3, 256, 256),
                               "convPb": init_conv(gen, 1, 1, 256,
                                                   DESC_DIM)},
    }
    for name, leaf in weights.flatten_tree(params).items():
        if name.endswith("conv3.w"):
            leaf *= RESIDUAL_INIT
    params["junction_decoder"]["convPb"]["w"] *= OUT_INIT
    params["heatmap_decoder"]["conv_block_lst"]["2"]["w"] *= OUT_INIT
    return params


def _pixel_shuffle(x, r=2):
    """torch's PixelShuffle channel order (k = c r^2 + i r + j)."""
    return F.pixel_shuffle(x, r)


def backbone(params, x):
    """x (B, 1, H, W), H and W multiples of 64 → junction probabilities
    (B, H, W), line heatmap (B, H, W), descriptors (B, 128, H/4, W/4)
    L2-normalised."""
    y = hourglass_net(params["backbone_net"]["net"], x)
    jd = params["junction_decoder"]
    semi = conv2d(jd["convPb"], relu(conv2d(jd["convPa"], y, stride=2)))
    junc = _pixel_shuffle(torch.softmax(semi, 1)[:, :64], 8)[:, 0]
    hd = params["heatmap_decoder"]["conv_block_lst"]
    h = relu(batch_norm_inference(hd["0"]["1"], conv2d(hd["0"]["0"], y)))
    h = _pixel_shuffle(h, 2)
    h = relu(batch_norm_inference(hd["1"]["1"], conv2d(hd["1"]["0"], h)))
    h = _pixel_shuffle(h, 2)
    heat = torch.softmax(conv2d(hd["2"], h), 1)[:, 1]
    dd = params["descriptor_decoder"]
    desc = conv2d(dd["convPb"], relu(conv2d(dd["convPa"], y)))
    desc = desc / torch.linalg.vector_norm(desc, dim=1,
                                           keepdim=True).clamp_min(1e-8)
    return junc, heat, desc


def _corners(h, w, xy):
    """Bilinear taps: the top-left indices and the fractions, the
    coordinates clipped to [0, size - 1.001]."""
    x = xy[..., 0].clamp(0.0, w - 1.001)
    y = xy[..., 1].clamp(0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    return x0, y0, x - x0, y - y0


def _bilinear(hmap, xy):
    """hmap (H, W) at xy (..., 2) → (...)."""
    h, w = hmap.shape
    x0, y0, fx, fy = _corners(h, w, xy)
    return (hmap[y0, x0] * (1 - fx) * (1 - fy)
            + hmap[y0, x0 + 1] * fx * (1 - fy)
            + hmap[y0 + 1, x0] * (1 - fx) * fy
            + hmap[y0 + 1, x0 + 1] * fx * fy)


def _bilinear_vec(fmap, xy):
    """fmap (C, H, W) at xy (..., 2) → (..., C)."""
    _, h, w = fmap.shape
    x0, y0, fx, fy = _corners(h, w, xy)
    fx, fy = fx[..., None], fy[..., None]
    f = fmap.permute(1, 2, 0)
    return (f[y0, x0] * (1 - fx) * (1 - fy)
            + f[y0, x0 + 1] * fx * (1 - fy)
            + f[y0 + 1, x0] * (1 - fx) * fy
            + f[y0 + 1, x0 + 1] * fx * fy)


def detect_lines_single(junc, heat, detect_thresh, valid_thresh,
                        valid_wh=None, min_len=8.0):
    """Fixed-shape detection on one view: the top junctions, every pair a
    candidate scored on the heatmap. junc, heat (H, W); valid_wh (2,).
    Returns lines (MAX_LINES, 2, 2) xy, scores and validity."""
    h, w = junc.shape
    s = nms_ops.simple_nms(junc, 3)
    vwh = None if valid_wh is None else valid_wh.reshape(1, 2)
    mask = nms_ops.border_mask(h, w, 0, valid_wh=vwh, device=s.device)
    s = s * mask.reshape(h, w).to(s.dtype)
    kpts, _, kmask = nms_ops.select_topk_keypoints(s[None], MAX_JUNCTIONS,
                                                   0.0)
    kpts, kmask = kpts[0], kmask[0]
    ii, jj = torch.triu_indices(MAX_JUNCTIONS, MAX_JUNCTIONS, 1,
                                device=s.device)
    p0, p1 = kpts[ii], kpts[jj]
    t = torch.linspace(0.0, 1.0, N_SAMPLES, device=s.device)[None, :, None]
    samples = _bilinear(heat, p0[:, None] + (p1 - p0)[:, None] * t)
    mean_heat = samples.mean(-1)
    inlier = (samples > valid_thresh).float().mean(-1)
    length = torch.linalg.vector_norm(p1 - p0, dim=-1)
    ok = (mean_heat > detect_thresh) & (inlier > 0.75) \
        & (length > min_len) & kmask[ii] & kmask[jj]
    score = torch.where(ok, mean_heat, 0.0)
    top, sel = torch.sort(score, descending=True, stable=True)
    top, sel = top[:MAX_LINES], sel[:MAX_LINES]
    lines = torch.stack([p0[sel], p1[sel]], 1)
    return lines, top, top > 0.0


def sample_line_desc(desc_map, lines):
    """desc_map (C, Hc, Wc) at 1/4; lines (L, 2, 2) px → (L, S, C)
    L2-normalised."""
    t = torch.linspace(0.05, 0.95, N_DESC_SAMPLES,
                       device=lines.device)[None, :, None]
    pts = lines[:, None, 0] + (lines[:, 1] - lines[:, 0])[:, None] * t
    d = _bilinear_vec(desc_map, pts / 4.0)
    return d / torch.linalg.vector_norm(d, dim=-1,
                                        keepdim=True).clamp_min(1e-8)


def match_lines(d0, d1, v0, v1):
    """Mutual nearest lines by the mean per-sample similarity, the better
    of both sample orders. d* (L, S, C). Returns matches (L0,) int32 and
    scores."""
    simf = torch.einsum("lsc,mtc->lmst", d0, d1)
    diag_f = torch.diagonal(simf, dim1=-2, dim2=-1).mean(-1)
    diag_r = torch.diagonal(simf.flip(-1), dim1=-2, dim2=-1).mean(-1)
    sim = torch.maximum(diag_f, diag_r)
    sim = torch.where(v0[:, None] & v1[None, :], sim, -1e9)
    nn01 = sim.argmax(1)
    nn10 = sim.argmax(0)
    mutual = torch.arange(sim.shape[0], device=sim.device) == nn10[nn01]
    score = sim.amax(1)
    ok = mutual & v0 & (score > 0.0)
    return (torch.where(ok, nn01, -1).to(torch.int32),
            torch.where(ok, score, 0.0))


def apply_pair(params, image0, image1, valid_wh0, valid_wh1,
               detect_thresh=0.25, valid_thresh=1e-3):
    """image* (1, H, W) on one canvas, valid_wh* (2,) → lines, validity,
    matches and scores of the pair."""
    with full_fp32():
        junc, heat, desc = backbone(params, torch.stack([image0, image1]))
        l0, _, v0 = detect_lines_single(junc[0], heat[0], detect_thresh,
                                        valid_thresh, valid_wh=valid_wh0)
        l1, _, v1 = detect_lines_single(junc[1], heat[1], detect_thresh,
                                        valid_thresh, valid_wh=valid_wh1)
        matches, mscores = match_lines(sample_line_desc(desc[0], l0),
                                       sample_line_desc(desc[1], l1),
                                       v0, v1)
    return l0, l1, v0, v1, matches, mscores


class SOLD2(BaseModel):
    """Standalone line matcher {image0, image1} → ``raw_lines*``, the
    matched ``lines*`` and their midpoints as ``line_keypoints*`` and
    ``keypoints*``."""

    default_conf = {
        "model_name": "sold2_wireframe.tar",
        "match_threshold": 0.2,
        "detect_thresh": 0.25,
        "multiscale": False,
        "valid_thresh": 1e-3,
        "num_blocks": 20,
        "overlap_ratio": 0.5,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        init = weights.seeded_init(init_params, self.device)
        self.params, self.meta = weights.load_trained(conf, init, "sold2",
                                                      self.device)

    def _forward(self, data):
        image0 = torch.as_tensor(data["image0"], dtype=torch.float32,
                                 device=self.device)
        image1 = torch.as_tensor(data["image1"], dtype=torch.float32,
                                 device=self.device)
        # four hourglass pools below 1/4: pad both views to one canvas of
        # multiples of 64
        hp = max(-(-image0.shape[2] // 64) * 64,
                 -(-image1.shape[2] // 64) * 64)
        wp = max(-(-image0.shape[3] // 64) * 64,
                 -(-image1.shape[3] // 64) * 64)

        def gray(img):
            x = img[0]
            x = xla_mean3(x, 0) if x.shape[0] == 3 else x[0]
            h, w = x.shape
            x = F.pad(x, (0, wp - w, 0, hp - h))
            return x[None], torch.tensor([w, h], dtype=torch.int32,
                                         device=img.device)

        x0, vwh0 = gray(image0)
        x1, vwh1 = gray(image1)
        l0, l1, v0, v1, matches, mscores = apply_pair(
            self.params, x0, x1, vwh0, vwh1,
            detect_thresh=float(self.conf["detect_thresh"]),
            valid_thresh=float(self.conf["valid_thresh"]))
        ok = matches > -1
        ml0 = l0[ok]
        ml1 = l1[matches[ok].long()]
        mid0, mid1 = ml0.mean(1), ml1.mean(1)
        return {
            "raw_lines0": l0[v0],
            "raw_lines1": l1[v1],
            "lines0": ml0,
            "lines1": ml1,
            "line_keypoints0": mid0,
            "line_keypoints1": mid1,
            "keypoints0": mid0,
            "keypoints1": mid1,
            "mconf": mscores[ok],
            "line_scores": mscores[ok],
        }
