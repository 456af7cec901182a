"""DUSt3R, the two-view pointmap matcher. Counterpart of
``imcui_tpu/models/matchers/duster.py``.

A ViT encoder shared by the two views (patch 16, RoPE-2D positions at base
100, ViT-L: 1024 wide, 24 blocks, 16 heads), two CroCo decoders, one a
view, whose blocks attend to their own view and then to the other's
(768 wide, 12 blocks, 12 heads), and a pointmap head a view (DPT over the
hooks [encoder, decoder N/2, 3N/4, N], or a linear head on the last
decoder tokens in a pixel-shuffle layout). The pointmap is the direction
times expm1 of the norm, the confidence 1 + exp. Matches are mutual 3-D
nearest neighbours on a grid subsampled by ``subsample``, ranked by the
product of the two confidences; a match is valid above 1 + 1e-6.

The JAX module runs the encoder and the decoders as ``lax.scan`` over
stacked blocks, which keeps its compiled program small; here each block
is a call in a loop. Both views take their positions from view 0's grid,
as ``decode`` does there: through ``ImageMatchingAPI`` the dense pipeline
pads the two views to one canvas, so the grids are the same.

Attention: float32 tokens take the plain ``mha_wide``, as the JAX
package's einsum; bfloat16 tokens take ``backbones.vit.ATTN_IMPL``'s
route, which with ``"fused"`` is ``mha_auto`` → K14 (``qtiled_attention``)
for every block, 96 launches a pair at ViT-L (2 × 24 encoder, 2 × 12 × 2
decoder). ``precision="bf16"`` casts the tree and the normalised images
to bfloat16; the pointmaps, confidences and matching stay float32.
``precision="int8"`` quantises the linears at least 256 wide (every ViT
projection and MLP at ViT-L, MASt3R's descriptor MLP) and, with
``int8_conv_min_ch``, the convolutions whose cin and cout reach it (W8A8,
``ops/w8a8.py``), and casts the rest as "bf16" does. At a threshold of 96
or less the DPT's transposed convolutions are quantised and
``dpt.conv_transpose_s`` raises ``KeyError``, at 3 or less the patch
embedding is quantised, as in the JAX package (ROADMAP §C).

No trained tree (``duster_vit_large``) is in the repository: the model
runs a user's ``checkpoint_npz`` or the port's seed-0 random tree,
reported in ``meta``. The tree is drawn on the model's device by that
device's generator, so the card's seed-0 tree is not the CPU's. Its DPT
output convolution starts at a hundredth of He's scale
(``DPT_OUT_INIT``): at full scale the random head's pointmaps overflow
expm1 (the JAX package's random init does; tests give both packages the
port's tree).
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..backbones import dpt, vit
from ..layers import (LOW_PRECISIONS, apply_precision, full_fp32,
                      init_layer_norm, init_linear, layer_norm, linear)

PUBLISHED = {
    "enc_dim": 1024, "enc_depth": 24, "enc_heads": 16,
    "dec_dim": 768, "dec_depth": 12, "dec_heads": 12,
    "patch": 16,
    "pos_embed": "RoPE100",
    "head_type": "dpt",
}
# the seed-0 tree's DPT output convolution, as a fraction of He's scale:
# at full scale the random pyramid's residual sums reach pointmap norms of
# 40-90, where expm1 overflows float32 and the 3-D distances turn NaN
DPT_OUT_INIT = 0.01


def hook_idx(dec_depth):
    """The DPT hooks over [encoder, decoder 1..N]: [0, 2N/4, 3N/4, N]."""
    return (0, dec_depth * 2 // 4, dec_depth * 3 // 4, dec_depth)


def init_params(gen, conf):
    c = conf
    params = {
        "patch_embed": vit.init_patch_embed(gen, c["patch"], 3, c["enc_dim"]),
        "enc_blocks": [vit.init_encoder_block(gen, c["enc_dim"])
                       for _ in range(c["enc_depth"])],
        "enc_norm": init_layer_norm(c["enc_dim"]),
        "decoder_embed": init_linear(gen, c["enc_dim"], c["dec_dim"]),
        "dec_blocks": [vit.init_decoder_block(gen, c["dec_dim"])
                       for _ in range(c["dec_depth"])],
        "dec_blocks2": [vit.init_decoder_block(gen, c["dec_dim"])
                        for _ in range(c["dec_depth"])],
        "dec_norm": init_layer_norm(c["dec_dim"]),
    }
    for head in ("downstream_head1", "downstream_head2"):
        if c.get("head_type", "dpt") == "dpt":
            dims = (c["enc_dim"], c["dec_dim"], c["dec_dim"], c["dec_dim"])
            params[head] = {"dpt": dpt.init_dpt(gen, dim_tokens=dims)}
            params[head]["dpt"]["head"]["4"]["w"] *= DPT_OUT_INIT
        else:
            params[head] = {"proj": init_linear(gen, c["dec_dim"],
                                                c["patch"] ** 2 * 4)}
    return params


def _rope(conf):
    return 100.0 if conf.get("pos_embed", "RoPE100") == "RoPE100" else None


def encode(params, image, conf):
    """image: (3, H, W) → encoder tokens (N, enc_dim), (hp, wp)."""
    tokens, (hp, wp) = vit.patch_embed_apply(params["patch_embed"], image,
                                             conf["patch"])
    rope = _rope(conf)
    pos = vit.grid_positions(hp, wp, tokens.device) if rope else None
    if rope is None:
        tokens = tokens + vit.sincos_pos_embed(
            hp, wp, tokens.shape[-1], tokens.device).to(tokens.dtype)
    for blk in params["enc_blocks"]:
        tokens = vit.encoder_block_apply(blk, tokens, conf["enc_heads"],
                                         pos=pos, rope_base=rope)
    return layer_norm(params["enc_norm"], tokens), (hp, wp)


def decode(params, t0, t1, grid, conf):
    """The two decoders, each block of view 0 and of view 1 on the
    previous block's outputs of both. Returns each view's hooks
    [encoder, decoder 2N/4, 3N/4, N], ``dec_norm`` on the last."""
    rope = _rope(conf)
    pos = vit.grid_positions(*grid, t0.device) if rope else None
    d0 = linear(params["decoder_embed"], t0)
    d1 = linear(params["decoder_embed"], t1)
    ys0, ys1 = [], []
    for b0, b1 in zip(params["dec_blocks"], params["dec_blocks2"]):
        d0, d1 = (vit.decoder_block_apply(b0, d0, d1, conf["dec_heads"],
                                          pos=pos, kpos=pos, rope_base=rope),
                  vit.decoder_block_apply(b1, d1, d0, conf["dec_heads"],
                                          pos=pos, kpos=pos, rope_base=rope))
        ys0.append(d0)
        ys1.append(d1)
    idx = hook_idx(conf["dec_depth"])
    outs0 = [t0] + [ys0[i - 1] for i in idx[1:]]
    outs1 = [t1] + [ys1[i - 1] for i in idx[1:]]
    outs0[-1] = layer_norm(params["dec_norm"], outs0[-1])
    outs1[-1] = layer_norm(params["dec_norm"], outs1[-1])
    return outs0, outs1


def postprocess(out):
    """(H, W, 4) head output → pointmap (H, W, 3) = direction ·
    expm1(norm) and confidence (H, W) = 1 + exp, float32."""
    xyz = out[..., :3].float()
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    pts = xyz / d.clamp_min(1e-8) * torch.expm1(d)
    return pts, 1.0 + torch.exp(out[..., 3].float())


def pixel_shuffle(x, grid, patch, c):
    """(N, c·p²) patch tokens → (H, W, c) in torch's pixel_shuffle
    layout (channel-major, then dy, dx)."""
    hp, wp = grid
    x = x.reshape(hp, wp, c, patch, patch).permute(0, 3, 1, 4, 2)
    return x.reshape(hp * patch, wp * patch, c)


def head_to_pointmap(head, hooks, grid, patch):
    """A view's head (DPT or linear) → pointmap (H, W, 3), confidence
    (H, W)."""
    if "dpt" in head:
        out = dpt.dpt_apply(head["dpt"], hooks, grid).permute(1, 2, 0)
    else:
        out = pixel_shuffle(linear(head["proj"], hooks[-1]), grid, patch, 4)
    return postprocess(out)


def subsample_grid(h, w, step, device):
    """Row-major (gy, gx) index grids of every ``step``-th pixel, and the
    (N, 2) xy coordinates they stand for."""
    gy, gx = torch.meshgrid(torch.arange(0, h, step, device=device),
                            torch.arange(0, w, step, device=device),
                            indexing="ij")
    return gy, gx, torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _top_matches(score, nn01, coords, max_matches, floor):
    """The ``max_matches`` best rows of ``score`` (mutual rows only) →
    keypoints of both views, scores and validity (score > floor)."""
    top, idx0 = torch.topk(score, min(max_matches, score.shape[0]))
    idx1 = nn01[idx0]
    valid = top > floor
    zero = torch.zeros((), device=top.device)
    k0, k1 = coords[idx0].float(), coords[idx1].float()
    return (torch.where(valid[:, None], k0, zero),
            torch.where(valid[:, None], k1, zero),
            torch.where(valid, top, zero), valid)


def reciprocal_nn_3d(pts0, pts1, conf0, conf1, max_matches=2048,
                     subsample=8):
    """Mutual 3-D nearest neighbours of two (H, W, 3) pointmaps on the
    grid subsampled by ``subsample``: squared distances as |a|² + |b|² −
    2a·b (float32, no TF32), argmin both ways (the first index among
    equal distances, as ``jnp.argmin``), mutual rows scored by conf0 ·
    conf1, the best ``max_matches`` kept (``torch.topk``; the JAX
    package's ``lax.top_k`` may order equal scores otherwise, so compare
    the sets) and valid above the floor 1 + 1e-6. Returns pixel keypoints
    (M, 2) of both views, scores and validity."""
    h, w = pts0.shape[:2]
    gy, gx, coords = subsample_grid(h, w, subsample, pts0.device)
    p0, p1 = pts0[gy, gx].reshape(-1, 3), pts1[gy, gx].reshape(-1, 3)
    c0, c1 = conf0[gy, gx].reshape(-1), conf1[gy, gx].reshape(-1)
    with full_fp32():
        d2 = ((p0 ** 2).sum(-1)[:, None] + (p1 ** 2).sum(-1)[None, :]
              - 2.0 * (p0 @ p1.t()))
    nn01, nn10 = d2.argmin(1), d2.argmin(0)
    mutual = torch.arange(d2.shape[0], device=d2.device) == nn10[nn01]
    score = torch.where(mutual, c0 * c1[nn01], torch.zeros_like(c0))
    return _top_matches(score, nn01, coords, max_matches, 1.0 + 1e-6)


def forward_pair(params, image0, image1, conf):
    """One prepared pair ((3, H, W) each) → keypoints0/1, scores, mask."""
    t0, grid = encode(params, image0, conf)
    t1, _ = encode(params, image1, conf)
    h0, h1 = decode(params, t0, t1, grid, conf)
    pts0, conf0 = head_to_pointmap(params["downstream_head1"], h0, grid,
                                   conf["patch"])
    pts1, conf1 = head_to_pointmap(params["downstream_head2"], h1, grid,
                                   conf["patch"])
    k0, k1, score, valid = reciprocal_nn_3d(
        pts0, pts1, conf0, conf1, max_matches=conf["max_matches"],
        subsample=conf["subsample"])
    return {"keypoints0": k0, "keypoints1": k1, "scores": score,
            "mask": valid}


class Duster(BaseModel):
    """Standalone dense matcher: image0, image1 (B, 3 or 1, H, W) in
    [0, 1] → keypoints0/1 (B, M, 2) in the inputs' pixels, scores, mask
    and mconf (B, M)."""

    default_conf = {
        **PUBLISHED,
        "max_matches": 2048,
        "subsample": 8,
        "weights": "duster_vit_large",
        # serving precision: None/"f32", "bf16", or "int8" (W8A8 of the
        # wide ViT linears, and of the convolutions at least
        # int8_conv_min_ch wide where that is set: layers.apply_precision)
        "precision": None,
        "int8_conv_min_ch": None,
    }
    required_inputs = ["image0", "image1"]
    name = "duster"

    def init_params(self, gen, conf):
        return init_params(gen, conf)

    def _init(self, conf):
        init = weights.seeded_init(self.init_params, self.device, conf)
        params, self.meta = weights.load_trained(conf, init, self.name,
                                                 self.device)
        self.params = apply_precision(
            params, conf.get("precision"),
            conv_min_ch=conf.get("int8_conv_min_ch"))
        logger.info(f"{self.name} weights: {self.meta}")

    def _prepare(self, image):
        """(B, 1 or 3, H, W) in [0, 1] → (B, 3, H, W) in [-1, 1], bf16
        under ``precision="bf16"`` or "int8"."""
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = (x - 0.5) / 0.5
        if self.conf.get("precision") in LOW_PRECISIONS:
            x = x.to(torch.bfloat16)
        return x

    def forward_pair(self, image0, image1):
        return forward_pair(self.params, image0, image1, self.conf)

    @torch.inference_mode()
    def _forward(self, data):
        x0, x1 = self._prepare(data["image0"]), self._prepare(data["image1"])
        rows = []
        for a, b in zip(x0, x1):
            if self.conf.get("precision") in LOW_PRECISIONS:
                rows.append(self.forward_pair(a, b))
            else:
                with full_fp32():
                    rows.append(self.forward_pair(a, b))
        out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        out["mconf"] = out["scores"]
        return out
