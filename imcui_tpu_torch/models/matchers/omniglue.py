"""OmniGlue, sparse matching guided by a foundation model. Counterpart of
``imcui_tpu/models/matchers/omniglue.py``.

SuperPoint gives the keypoints, scores and descriptors of each view from
its grey image (the port's bf16 SuperPoint at threshold 0.005: on the
card the stem kernel, ``stage_tail`` and ``nms_cellmax``). A small ViT
(patch 14, width 384, 4 float32 blocks of 6 heads, sin-cos positions)
gives patch features, sampled at each keypoint's patch and scaled (see
``dino_features``). A position/score encoder is added to the
descriptors; four attention layers of 4 heads alternate self- and
cross-attention, the cross layers biased by the DINO similarity times
softplus(gate) + 1; a final linear, a dual softmax over the masked
similarity and its mutual check with the score gate give the matches.

Where the port restates the JAX function exactly:

- the grey image is ``layers.xla_mean3``, XLA's mean of three channels,
  not ``torch.mean``: the bf16 SuperPoint's keypoints can move on a last
  bit of its input;
- a keypoint's patch is ``kpts / 14`` truncated toward zero, then
  clipped to the grid;
- the sampled features are divided by the set's matrix −1 norm, not
  L2-normalised one by one (``dino_features``);
- ``argmax`` ties take the first index.

No OmniGlue tree is in the repository. Upstream ships ONNX graphs, which
``utils/onnx_reader.py`` can read, but the GNN here is a restatement whose
tensors map to upstream's only where the two are congruent: the model
runs a user's ``checkpoint_npz`` or the port's seed-0 tree, and ``meta``
says so and names what the conversion waits on.
"""

import torch
import torch.nn.functional as F

from ...ops.attention import mha
from ...ops.matching import _softmax
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones.vit import (encoder_block_apply, init_encoder_block,
                             init_patch_embed, patch_embed_apply,
                             sincos_pos_embed)
from ..layers import (full_fp32, init_layer_norm, init_linear,
                      layer_norm, linear, relu, xla_mean3)

D_MODEL = 256
DINO_DIM = 384
PATCH = 14
N_VIT = 4
N_GNN = 4
NHEAD = 4
VIT_HEADS = 6


def init_params(gen):
    return {
        "patch_embed": init_patch_embed(gen, PATCH, 3, DINO_DIM),
        "vit": [init_encoder_block(gen, DINO_DIM) for _ in range(N_VIT)],
        "vit_ln": init_layer_norm(DINO_DIM),
        "kenc": {"0": init_linear(gen, 3, 64),
                 "1": init_linear(gen, 64, D_MODEL)},
        "gnn": [{"qkv": init_linear(gen, D_MODEL, 3 * D_MODEL),
                 "mlp": {"0": init_linear(gen, 2 * D_MODEL, 2 * D_MODEL),
                         "2": init_linear(gen, 2 * D_MODEL, D_MODEL)}}
                for _ in range(N_GNN)],
        "dino_gate": init_linear(gen, 1, 1),
        "final": init_linear(gen, D_MODEL, D_MODEL),
    }


def dino_features(params, image, kpts):
    """ViT patch features at keypoints. image (3, H, W) in [0, 1], kpts
    (N, 2) px → (N, 384), divided by one number for the whole set: the
    JAX function's ``jnp.linalg.norm(f, -1, keepdims=True)`` passes -1 as
    ``ord``, not as the axis, so it is the (N, 384) matrix's −1 norm, the
    least column sum of |f| over the N slots (padded slots included), not
    each row's L2 norm. The port divides by the same (ROADMAP §C)."""
    _, h, w = image.shape
    img = image[:, :(h // PATCH) * PATCH, :(w // PATCH) * PATCH]
    x, (gh, gw) = patch_embed_apply(params["patch_embed"], img, PATCH)
    x = x + sincos_pos_embed(gh, gw, DINO_DIM, device=x.device)
    for blk in params["vit"]:
        x = encoder_block_apply(blk, x, VIT_HEADS)
    x = layer_norm(params["vit_ln"], x)
    ix = (kpts[:, 0] / PATCH).to(torch.int32).clamp(0, gw - 1)
    iy = (kpts[:, 1] / PATCH).to(torch.int32).clamp(0, gh - 1)
    f = x[(iy * gw + ix).long()]
    return f / f.abs().sum(0).amin().clamp_min(1e-8)


def gnn_layer(p, x, source, mask_src, bias=None):
    """x (B, N, d) attends to source (B, M, d) (keys masked by mask_src
    (B, M)), then the MLP of [x, message] is added."""
    d = x.shape[-1]

    def heads(t):
        return t.unflatten(-1, (NHEAD, d // NHEAD)).transpose(1, 2)

    q = heads(linear(p["qkv"], x)[..., :d])
    kv = linear(p["qkv"], source)
    msg = mha(q, heads(kv[..., d:2 * d]), heads(kv[..., 2 * d:]),
              mask_k=mask_src[:, None, None, :], bias=bias)
    msg = msg.transpose(1, 2).flatten(2)
    return x + linear(p["mlp"]["2"], relu(linear(
        p["mlp"]["0"], torch.cat([x, msg], -1))))


def match(params, kpts0, kpts1, scores0, scores1, desc0, desc1, dino0,
          dino1, mask0, mask1, size0, size1, threshold):
    """The matcher over a batch: kpts* (B, N, 2), scores* and mask* (B,
    N), desc* (B, N, 256), dino* (B, N, 384), size* (B, 2) (w, h) →
    keypoints0/1, scores, mask (matched slots of view 0)."""
    def enc(k, s, d, size):
        pn = (k - size[:, None] / 2) / size.amax(-1)[:, None, None]
        return d + linear(params["kenc"]["1"], relu(linear(
            params["kenc"]["0"], torch.cat([pn, s[..., None]], -1))))

    f0 = enc(kpts0, scores0, desc0, size0)
    f1 = enc(kpts1, scores1, desc1, size1)
    # the DINO guidance: the foundation similarity as a cross-attention bias
    gscale = F.softplus(params["dino_gate"]["w"][0, 0]) + 1.0
    dino_sim = (dino0 @ dino1.transpose(1, 2)) * gscale
    for i, p in enumerate(params["gnn"]):
        if i % 2 == 0:
            f0 = gnn_layer(p, f0, f0, mask0)
            f1 = gnn_layer(p, f1, f1, mask1)
        else:
            f0, f1 = (gnn_layer(p, f0, f1, mask1, bias=dino_sim[:, None]),
                      gnn_layer(p, f1, f0, mask0,
                                bias=dino_sim.transpose(1, 2)[:, None]))
    f0 = linear(params["final"], f0)
    f1 = linear(params["final"], f1)
    sim = (f0 @ f1.transpose(1, 2)) / D_MODEL ** 0.5
    sim = torch.where(mask0[..., None] & mask1[:, None], sim, -1e9)
    conf = _softmax(sim, 2) * _softmax(sim, 1)
    nn01 = conf.argmax(2)
    nn10 = conf.argmax(1)
    mutual = torch.arange(conf.shape[1], device=conf.device) == \
        nn10.gather(1, nn01)
    score = conf.amax(2)
    ok = mutual & (score > threshold) & mask0
    k1m = kpts1.gather(1, nn01[..., None].expand(-1, -1, 2))
    return {"keypoints0": torch.where(ok[..., None], kpts0, 0.0),
            "keypoints1": torch.where(ok[..., None], k1m, 0.0),
            "scores": torch.where(ok, score, 0.0), "mask": ok}


class OmniGlue(BaseModel):
    """Standalone matcher {image0, image1} → matched SuperPoint keypoints
    and their confidences."""

    default_conf = {
        "match_threshold": 0.02,
        "max_keypoints": 2048,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        from ..extractors.superpoint import SuperPoint

        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "omniglue",
            self.device)
        if not self.meta["pretrained"]:
            self.meta["conversion_blocked_on"] = (
                "an upstream-congruent GNN (the ONNX reader is "
                "utils/onnx_reader.py)")
        self.sp = SuperPoint({"max_keypoints": conf["max_keypoints"],
                              "keypoint_threshold": 0.005},
                             device=self.device)

    def _forward(self, data):
        image0 = torch.as_tensor(data["image0"], dtype=torch.float32,
                                 device=self.device)
        image1 = torch.as_tensor(data["image1"], dtype=torch.float32,
                                 device=self.device)

        def gray(img):
            return xla_mean3(img, 1)[:, None] if img.shape[1] == 3 else img

        def rgb(img):
            return img.expand(-1, 3, -1, -1) if img.shape[1] == 1 else img

        def size(img):
            return img.new_tensor([[img.shape[3], img.shape[2]]]).expand(
                len(img), 2)

        f0 = self.sp({"image": gray(image0)})
        f1 = self.sp({"image": gray(image1)})
        k0, k1 = f0["keypoints"].float(), f1["keypoints"].float()
        with full_fp32():
            g0 = torch.stack([dino_features(self.params, im, kp)
                              for im, kp in zip(rgb(image0), k0)])
            g1 = torch.stack([dino_features(self.params, im, kp)
                              for im, kp in zip(rgb(image1), k1)])
            out = match(self.params, k0, k1, f0["scores"].float(),
                        f1["scores"].float(),
                        f0["descriptors"].float().transpose(1, 2),
                        f1["descriptors"].float().transpose(1, 2), g0, g1,
                        f0["mask"].bool(), f1["mask"].bool(), size(image0),
                        size(image1), float(self.conf["match_threshold"]))
        out["mconf"] = out["scores"]
        return out
