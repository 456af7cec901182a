"""DKMv3, dense kernelized feature matching. Counterpart of
``imcui_tpu/models/matchers/dkm.py``.

- Encoder: ResNet-50's pyramid {1: the normalised image, 2: the stem,
  4, 8, 16, 32: layers 1-4} (``backbones/resnet.py``).
- Coarse matching at strides 32 and 16: the features projected by a
  1 × 1 convolution with BN to 512, a Gaussian process with the cosine
  kernel over the view-1 tokens regressing the fourier embedding of
  their coordinates (``roma.gp_posterior`` on ``roma.fourier_embed``),
  then the DFN decoder: the features' 1 × 1 input module, [features ‖ GP]
  through a residual block, a channel-attention block that gates them
  into the 384-d context carried across the two scales (bilinearly
  upsampled), a second residual block and a 3-channel terminal
  convolution (certainty first, then the warp).
- Refinement at strides 16, 8, 4, 2, 1 by RoMa's convolutional refiners
  (``roma.refiner_apply`` with a displacement scale of 1.0), on the
  projected features at 16 and the raw pyramid below; the warp and the
  certainty are resized (``jax.image.resize``'s bilinear, antialiased
  when shrinking: ``ops.resize``) from each scale to the next.
- ``roma.sample`` draws ``max_keypoints`` correspondences by the sigmoid
  certainty (an exact top-k; the JAX package's is approximate at recall
  0.95, so compare the sets).

The wrapper resizes both views to ``coarse_res``, or, when it is None,
to its input rounded to multiples of 32 (Python's ``round``, half to
even). Through ``ImageMatchingAPI`` that input is the bucketed canvas, as
in the JAX package: the registry's ``dkm`` forces 80 × 60, floors it to
80 × 56 and pads it to 256 × 256, so DKM runs at 256 × 256 on an image
that fills a sixteenth of it (64 × 64 if called on the image alone);
``gim(dkm)``'s 320 × 240 sits on a 256 × 320 canvas. The keypoints
return to the inputs' pixels by (w − 1)/(cw − 1) and (h − 1)/(ch − 1). A
float32 tree runs in full float32.

``precision="int8"``: DKM has no linear, so only ``int8_conv_min_ch``
quantises anything (its convolutions whose cin and cout reach it: W8A8,
``ops/w8a8.py``); the rest is cast to bfloat16 and the images as under
"bf16". The thresholds at which a quantised dict raises ``KeyError`` are
RoMa's (``roma.py``'s docstring; the stride-1 refiner is 24 wide here).

No trained tree (``DKMv3_outdoor.pth``, ``gim_dkm_100h.ckpt``) is in the
repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 random tree, drawn on the model's device (the card's is not the
CPU's), reported in ``meta``. That tree starts the residual branches and
the output convolutions small (``RESIDUAL_INIT``, ``OUT_INIT``), so that
its certainties stay apart; tests give both packages the port's tree.
"""

import torch

from ... import logger
from ...ops import resize as resize_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones import resnet
from ..layers import (LOW_PRECISIONS, apply_precision, batch_norm_inference,
                      conv2d, full_fp32, init_bn, init_conv, relu)
from . import roma as roma_mod

GP_DIM = 256
DFN_DIM = 384
# per-scale refiner (upstream DKMv3's table); "1" alone widens 12 → 24
REFINERS = {
    "16": dict(feat=512, disp=128, r=7, blocks=8, dw=True),
    "8": dict(feat=512, disp=64, r=3, blocks=8, dw=True),
    "4": dict(feat=256, disp=32, r=2, blocks=8, dw=True),
    "2": dict(feat=64, disp=16, r=0, blocks=8, dw=True),
    "1": dict(feat=3, disp=6, r=0, blocks=5, dw=False, hidden=24),
}
PROJ = {"16": (1024, 512), "32": (2048, 512)}
COARSE = ("32", "16")
# the seed-0 tree's scales: ResNet's residual branches (bn3) at a tenth,
# the DFN terminal and refiner output convolutions at a hundredth of He's
# scale; at full scale the random pyramid grows block by block and the
# certainty saturates to exactly 1.0 on most cells, so the top-k cut falls
# among tens of thousands of ties
RESIDUAL_INIT = 0.1
OUT_INIT = 0.01
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _init_refiner(gen, cfg):
    in_dim = roma_mod._refiner_in_dim(cfg)
    hidden = cfg.get("hidden", in_dim)
    return {
        "disp_emb": init_conv(gen, 1, 1, 2, cfg["disp"]),
        "block1": roma_mod._init_refiner_block(
            gen, in_dim, hidden, cfg["dw"] and hidden == in_dim),
        "hidden_blocks": [roma_mod._init_refiner_block(gen, hidden, hidden,
                                                       cfg["dw"])
                          for _ in range(cfg["blocks"])],
        "out_conv": init_conv(gen, 1, 1, hidden, 3),
    }


def init_rrb(gen, cin, cout):
    """1 × 1 in, then a residual [3 × 3, BN, ReLU, 3 × 3], ReLU."""
    return {"conv1": init_conv(gen, 1, 1, cin, cout),
            "conv2": init_conv(gen, 3, 3, cout, cout),
            "bn": init_bn(cout),
            "conv3": init_conv(gen, 3, 3, cout, cout)}


def rrb_apply(p, x):
    x = conv2d(p["conv1"], x)
    res = relu(batch_norm_inference(p["bn"], conv2d(p["conv2"], x)))
    return relu(x + conv2d(p["conv3"], res))


def init_cab(gen, cin, cout):
    return {"conv1": init_conv(gen, 1, 1, cin, cout),
            "conv2": init_conv(gen, 1, 1, cout, cout)}


def cab_apply(p, high, low):
    """Channel attention: a gate from the spatial mean of [high ‖ low]
    (1 × 1, ReLU, 1 × 1, sigmoid); returns gate · low + high."""
    g = torch.cat([high, low], 1).mean((2, 3), keepdim=True)
    g = torch.sigmoid(conv2d(p["conv2"], relu(conv2d(p["conv1"], g))))
    return g * low + high


def init_params(gen, conf=None):
    encoder = resnet.init_resnet(gen, "resnet50")
    for li in range(1, 5):
        for blk in encoder[f"layer{li}"].values():
            blk["bn3"]["scale"] *= RESIDUAL_INIT
    params = {
        "encoder": encoder,
        "proj": {s: {"0": init_conv(gen, 1, 1, cin, cout),
                     "1": init_bn(cout)} for s, (cin, cout) in PROJ.items()},
        "gps": {s: {"pos_conv": init_conv(gen, 1, 1, 2, GP_DIM)}
                for s in COARSE},
        "embedding_decoder": {
            "feat_input_modules": {s: init_conv(gen, 1, 1, 512, 512)
                                   for s in COARSE},
            "rrb_d": {s: init_rrb(gen, GP_DIM + 512, DFN_DIM)
                      for s in COARSE},
            "cab": {s: init_cab(gen, 2 * DFN_DIM, DFN_DIM) for s in COARSE},
            "rrb_u": {s: init_rrb(gen, DFN_DIM, DFN_DIM) for s in COARSE},
            "terminal_module": {s: init_conv(gen, 1, 1, DFN_DIM, 3)
                                for s in COARSE},
        },
        "conv_refiner": {s: _init_refiner(gen, cfg)
                         for s, cfg in REFINERS.items()},
    }
    for p in (*params["embedding_decoder"]["terminal_module"].values(),
              *(r["out_conv"] for r in params["conv_refiner"].values())):
        p["w"] *= OUT_INIT
    return params


def dfn_apply(dec, s, gp_out, feats, context):
    """One DFN scale on (1, C, h, w) maps → warp (h, w, 2), certainty
    logits (h, w) and the new context."""
    emb = torch.cat([conv2d(dec["feat_input_modules"][s], feats), gp_out], 1)
    emb = rrb_apply(dec["rrb_d"][s], emb)
    context = cab_apply(dec["cab"][s], context, emb)
    context = rrb_apply(dec["rrb_u"][s], context)
    preds = conv2d(dec["terminal_module"][s], context)[0]
    return preds[1:3].permute(1, 2, 0), preds[0], context


def match(params, image0, image1):
    """Dense warp (H, W, 2) into image 1 (normalised coordinates) and
    certainty (H, W) in [0, 1] of one pair of (3, H, W) RGB images in
    [0, 1], both float32."""
    mean = torch.tensor(MEAN, device=image0.device).view(3, 1, 1)
    std = torch.tensor(STD, device=image0.device).view(3, 1, 1)
    x0, x1 = (image0 - mean) / std, (image1 - mean) / std
    f0 = resnet.resnet_pyramid_apply(params["encoder"], x0)
    f1 = resnet.resnet_pyramid_apply(params["encoder"], x1)
    dec = params["embedding_decoder"]
    h32, w32 = f0[32].shape[1:]
    context = torch.zeros((1, DFN_DIM, h32, w32), device=image0.device)
    flow = torch.zeros((h32, w32, 2), device=image0.device)
    cert = torch.zeros((h32, w32), device=image0.device)
    for s_int in (32, 16, 8, 4, 2, 1):
        s = str(s_int)
        a, b = f0[s_int], f1[s_int]
        if s in params["proj"]:
            p = params["proj"][s]
            a, b = (batch_norm_inference(p["1"], conv2d(p["0"], t[None]))[0]
                    for t in (a, b))
        _, hs, ws = a.shape
        if s in params["gps"]:
            context = resize_ops.resize(context, (hs, ws), "bilinear")
            emb1 = roma_mod.fourier_embed(
                roma_mod.coord_grid(hs, ws, a.device),
                params["gps"][s]["pos_conv"])
            gp_out = roma_mod.gp_posterior(a.reshape(a.shape[0], -1).t(),
                                           b.reshape(b.shape[0], -1).t(),
                                           emb1)
            gp_out = gp_out.t().reshape(1, -1, hs, ws)
            flow, cert, context = dfn_apply(dec, s, gp_out, a[None], context)
        if s in params["conv_refiner"]:
            flow, cert = roma_mod.refiner_apply(
                params["conv_refiner"][s], REFINERS[s], a, b, flow, cert,
                disp_scale=1.0)
        if s_int != 1:
            hn, wn = f0[s_int // 2].shape[1:]
            flow = roma_mod._resize(flow, hn, wn)
            cert = roma_mod._resize(cert, hn, wn)
    return flow.float(), torch.sigmoid(cert.float())


def coarse_size(conf, h, w):
    """(ch, cw) the model runs at: ``coarse_res``, or the input rounded to
    multiples of 32 (at least 32)."""
    if conf.get("coarse_res"):
        return tuple(conf["coarse_res"])
    return max(round(h / 32), 1) * 32, max(round(w / 32), 1) * 32


class DKMv3(BaseModel):
    """Standalone dense matcher: image0, image1 (B, 3 or 1, H, W) in
    [0, 1] → keypoints0/1 (B, K, 2) in the inputs' pixels, scores, mask
    and mconf (B, K)."""

    default_conf = {
        "model_name": "DKMv3_outdoor.pth",
        "match_threshold": 0.2,
        "max_keypoints": 2048,
        # None: the input rounded to multiples of 32; the published
        # operating point 540 x 720 is (544, 704) on that lattice
        "coarse_res": None,
        # serving precision: None/"f32", "bf16", or "int8" (W8A8 of the
        # convolutions at least int8_conv_min_ch wide where that is set; DKM
        # has no linear: layers.apply_precision)
        "precision": None,
        "int8_conv_min_ch": None,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        init = weights.seeded_init(init_params, self.device, conf)
        params, self.meta = weights.load_trained(conf, init, "dkm",
                                                 self.device)
        self.params = apply_precision(
            params, conf.get("precision"),
            conv_min_ch=conf.get("int8_conv_min_ch"))
        logger.info(f"dkm weights: {self.meta}")

    def _prepare(self, image, size):
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = resize_ops.resize(x, size, "bilinear")
        if self.conf.get("precision") in LOW_PRECISIONS:
            x = x.to(torch.bfloat16)
        return x

    def match(self, image0, image1):
        if self.conf.get("precision") in LOW_PRECISIONS:
            return match(self.params, image0, image1)
        with full_fp32():
            return match(self.params, image0, image1)

    @torch.inference_mode()
    def _forward(self, data):
        h0, w0 = data["image0"].shape[-2:]
        h1, w1 = data["image1"].shape[-2:]
        ch, cw = coarse_size(self.conf, h0, w0)
        x0 = self._prepare(data["image0"], (ch, cw))
        x1 = self._prepare(data["image1"], (ch, cw))
        num = int(self.conf.get("max_keypoints") or 2048)
        rows = [roma_mod.sample(*self.match(a, b), ch, cw, num=num)
                for a, b in zip(x0, x1)]
        k0, k1, scores, valid = (torch.stack(t) for t in zip(*rows))
        s0 = k0.new_tensor([(w0 - 1) / (cw - 1), (h0 - 1) / (ch - 1)])
        s1 = k0.new_tensor([(w1 - 1) / (cw - 1), (h1 - 1) / (ch - 1)])
        return {"keypoints0": k0 * s0, "keypoints1": k1 * s1,
                "scores": scores, "mask": valid, "mconf": scores}
