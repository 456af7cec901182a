"""ALIKED keypoint detector with its sparse deformable descriptor head,
float32.

Counterpart of ``imcui_tpu/models/extractors/aliked.py``: the same
``SIZES``, blocks, score head and SDDH, on NCHW tensors.

- SELU gates; average pools ``pool2`` before block2 and ``pool4`` before
  blocks 3 and 4 (strides 1, 1/2, 1/8, 1/32).
- block1 is a ConvBlock (two bias-free 3 × 3 convs, BatchNorm); blocks
  2–4 are ResBlocks with a biased 1 × 1 ``downsample``; blocks 3 and 4
  are deformable: a regular 3 × 3 ``offset_conv`` predicts 18 offsets,
  clamped to ±max(h, w)/4, for ``regular_conv`` through
  ``ops/deform.py::deform_conv2d``.
- Aggregation: bias-free 1 × 1 convs to dim/4, SELU, upsampling by
  ``ops/resize.py::torch_interpolate`` with ``align_corners=True``,
  concatenation; the feature map is L2-normalised; the score head is
  1 × 1 (dim → 8), then 3 × 3 (8 → 4, 4 → 4, 4 → 1), gated between,
  sigmoid at the end.
- SDDH: a K × K patch at each keypoint's integer position feeds
  ``offset_conv`` (a VALID K × K conv as one contraction, SELU, 1 × 1)
  for M offsets (Δx, Δy) clamped to ±max(h, w)/4; the normalised map is
  sampled bilinearly (``ops/nms.py::sample_bilinear``) at keypoint +
  offset, each sample passes the 1 × 1 ``sf_conv`` and SELU, and the M
  samples, flattened channel-major (input channel c·M + m) as upstream,
  go through the 1 × 1 ``convM``; descriptors are L2-normalised.

Every convolution and product runs under ``layers.full_fp32``. No
trained ALIKED tree is in the repository: the model runs a user's
``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``.

The model reads ``max_num_keypoints`` and ``detection_threshold``, as
the JAX module does; ``ImageMatchingAPI`` writes ``max_keypoints`` and
``keypoint_threshold``, so through the API ALIKED serves -1 → 4096
keypoints at 0.2 whatever the API asks (ROADMAP.md, findings).
"""

import torch

from ...ops import nms as nms_ops
from ...ops.deform import deform_conv2d
from ...ops.resize import torch_interpolate
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (avg_pool, batch_norm_inference, conv2d, full_fp32,
                      init_bn, init_conv, l2_normalize, selu)

SIZES = {
    "aliked-t16": dict(c1=8, c2=16, c3=32, c4=64, dim=64, K=3, M=16),
    "aliked-n16": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16),
    "aliked-n16rot": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3,
                          M=16),
    "aliked-n32": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=32),
}


def init_conv_block(gen, cin, cout):
    return {"conv1": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn1": init_bn(cout),
            "conv2": init_conv(gen, 3, 3, cout, cout, bias=False),
            "bn2": init_bn(cout)}


def conv_block(p, x):
    x = selu(batch_norm_inference(p["bn1"], conv2d(p["conv1"], x)))
    return selu(batch_norm_inference(p["bn2"], conv2d(p["conv2"], x)))


def _init_dcn(gen, cin, cout):
    return {"offset_conv": init_conv(gen, 3, 3, cin, 18),
            "regular_conv": init_conv(gen, 3, 3, cin, cout, bias=False)}


def _dcn(p, x):
    max_offset = max(x.shape[-2:]) / 4.0
    off = conv2d(p["offset_conv"], x).clamp(-max_offset, max_offset)
    return deform_conv2d(x, off, p["regular_conv"]["w"])


def init_res_block(gen, cin, cout, dcn=False):
    if dcn:
        c1, c2 = _init_dcn(gen, cin, cout), _init_dcn(gen, cout, cout)
    else:
        c1 = init_conv(gen, 3, 3, cin, cout, bias=False)
        c2 = init_conv(gen, 3, 3, cout, cout, bias=False)
    return {"conv1": c1, "bn1": init_bn(cout), "conv2": c2,
            "bn2": init_bn(cout),
            # upstream: downsample = nn.Conv2d(cin, cout, 1), biased
            "downsample": init_conv(gen, 1, 1, cin, cout)}


def res_block(p, x, dcn=False):
    apply1 = _dcn if dcn else conv2d
    y = selu(batch_norm_inference(p["bn1"], apply1(p["conv1"], x)))
    y = batch_norm_inference(p["bn2"], apply1(p["conv2"], y))
    return selu(y + conv2d(p["downsample"], x))


def init_params(gen, c1, c2, c3, c4, dim, K, M):
    """Random tree in torch layout with the JAX ``init_params``'s keys."""
    q = dim // 4
    return {
        "block1": init_conv_block(gen, 3, c1),
        "block2": init_res_block(gen, c1, c2),
        "block3": init_res_block(gen, c2, c3, dcn=True),
        "block4": init_res_block(gen, c3, c4, dcn=True),
        "conv1": init_conv(gen, 1, 1, c1, q, bias=False),
        "conv2": init_conv(gen, 1, 1, c2, q, bias=False),
        "conv3": init_conv(gen, 1, 1, c3, q, bias=False),
        "conv4": init_conv(gen, 1, 1, c4, q, bias=False),
        "score_head": {
            "0": init_conv(gen, 1, 1, dim, 8, bias=False),
            "2": init_conv(gen, 3, 3, 8, 4, bias=False),
            "4": init_conv(gen, 3, 3, 4, 4, bias=False),
            "6": init_conv(gen, 3, 3, 4, 1, bias=False),
        },
        "desc_head": {
            "offset_conv": {"0": init_conv(gen, K, K, dim, 2 * M),
                            "2": init_conv(gen, 1, 1, 2 * M, 2 * M)},
            "sf_conv": init_conv(gen, 1, 1, dim, dim, bias=False),
            "convM": init_conv(gen, 1, 1, dim * M, dim, bias=False),
        },
    }


def backbone(p, x):
    """x: (B, 3, H, W), H and W multiples of 32 → the L2-normalised
    feature map (B, dim, H, W) and the score map (B, H, W) in (0, 1)."""
    x1 = conv_block(p["block1"], x)                            # 1
    x2 = res_block(p["block2"], avg_pool(x1, 2))               # 1/2
    x3 = res_block(p["block3"], avg_pool(x2, 4), dcn=True)     # 1/8
    x4 = res_block(p["block4"], avg_pool(x3, 4), dcn=True)     # 1/32
    hw = x.shape[-2:]

    def up(feat):
        return torch_interpolate(feat, hw, mode="bilinear",
                                 align_corners=True)

    feats = torch.cat([selu(conv2d(p["conv1"], x1)),
                       up(selu(conv2d(p["conv2"], x2))),
                       up(selu(conv2d(p["conv3"], x3))),
                       up(selu(conv2d(p["conv4"], x4)))], 1)
    sh = p["score_head"]
    s = selu(conv2d(sh["0"], feats))
    s = selu(conv2d(sh["2"], s))
    s = selu(conv2d(sh["4"], s))
    scores = torch.sigmoid(conv2d(sh["6"], s))[:, 0]
    return l2_normalize(feats, dim=1), scores


def sddh(params, fmap, kpts, K, M):
    """The sparse deformable descriptor head for every keypoint slot.
    fmap: (B, dim, H, W) L2-normalised; kpts: (B, N, 2) xy pixels →
    (B, N, dim) L2-normalised."""
    p = params["desc_head"]
    b, dim, h, w = fmap.shape
    n = kpts.shape[1]
    r = K // 2
    max_offset = max(h, w) / 4.0
    # K × K patches at the integer keypoint positions (upstream
    # get_patches on kpts.long()), clamped to the map
    d = torch.arange(K, device=fmap.device) - r
    ix = (kpts[..., 0].long()[..., None, None] + d.view(1, 1, 1, K)).clamp(
        0, w - 1)
    iy = (kpts[..., 1].long()[..., None, None] + d.view(1, 1, K, 1)).clamp(
        0, h - 1)
    q = (iy * w + ix).reshape(b, 1, -1).expand(-1, dim, -1)
    patches = torch.gather(fmap.reshape(b, dim, h * w), 2, q).reshape(
        b, dim, n, K, K)
    # offset_conv: the VALID K × K conv as one contraction, SELU, 1 × 1
    oc = p["offset_conv"]
    off = torch.einsum("bcnyx,ocyx->bno", patches, oc["0"]["w"]) \
        + oc["0"]["b"]
    off = torch.nn.functional.linear(selu(off), oc["2"]["w"][:, :, 0, 0],
                                     oc["2"]["b"])
    off = off.clamp(-max_offset, max_offset).reshape(b, n, M, 2)
    sample_xy = (kpts[:, :, None, :] + off).reshape(b, n * M, 2)
    samples = nms_ops.sample_bilinear(fmap, sample_xy).reshape(b, dim, n, M)
    samples = selu(torch.einsum("bcnm,dc->bnmd", samples,
                                p["sf_conv"]["w"][:, :, 0, 0]))
    # upstream flattens channel-major: convM's input channel is c·M + m
    flat = samples.transpose(-1, -2).reshape(b, n, dim * M)
    desc = torch.nn.functional.linear(flat, p["convM"]["w"][:, :, 0, 0])
    return l2_normalize(desc, dim=-1)


def apply(params, image, valid_wh, max_keypoints=1024, nms_radius=2,
          detection_threshold=0.2, K=3, M=16):
    """image: (B, 3, H, W) in [0, 1], H and W multiples of 32; valid_wh
    (B, 2). Returns keypoints (B, N, 2), scores (B, N), descriptors (B,
    dim, N) and mask (B, N)."""
    with full_fp32():
        fmap, heat = backbone(params, image)
        h, w = heat.shape[-2:]
        s = nms_ops.simple_nms(heat, nms_radius)
        s = s * nms_ops.border_mask(h, w, 2, valid_wh, device=s.device)
        kpts, kscores, mask = nms_ops.select_topk_keypoints(
            s, max_keypoints, detection_threshold)
        kpts = nms_ops.soft_argmax_refinement(kpts, heat, radius=2)
        desc = sddh(params, fmap, kpts, K, M)
    return {"keypoints": kpts, "scores": kscores,
            "descriptors": desc.transpose(1, 2), "mask": mask}


def apply_describe(params, image, kpts, K=3, M=16):
    """SDDH descriptors (B, dim, N) of keypoints supplied from outside
    (upstream ALIKED's ``describe``)."""
    with full_fp32():
        fmap, _ = backbone(params, image)
        return sddh(params, fmap, kpts, K, M).transpose(1, 2)


def _pad32(image):
    """A 1-channel image tiled to 3; H and W zero-padded to multiples of
    32 for the pool schedule."""
    if image.shape[1] == 1:
        image = image.repeat(1, 3, 1, 1)
    h, w = image.shape[-2:]
    return torch.nn.functional.pad(image, (0, -w % 32, 0, -h % 32))


class ALIKED(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W), "valid_wh" (B, 2)?}
    → keypoints, scores, descriptors, mask."""

    default_conf = {
        "model_name": "aliked-n16",
        "max_num_keypoints": -1,
        "detection_threshold": 0.2,
        "nms_radius": 2,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        sizes = SIZES[conf["model_name"]]
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0), **sizes),
            "aliked", self.device)
        self.meta["head"] = "sddh"
        self._K, self._M = sizes["K"], sizes["M"]
        n = conf["max_num_keypoints"]
        self._max_kpts = 4096 if n in (-1, None) else int(n)

    def describe(self, image, kpts):
        """(B, 1 or 3, H, W), (B, N, 2) → (B, dim, N) SDDH descriptors at
        the given keypoints."""
        image = _pad32(torch.as_tensor(image, dtype=torch.float32,
                                       device=self.device))
        return apply_describe(self.params, image,
                              torch.as_tensor(kpts, dtype=torch.float32,
                                              device=self.device),
                              K=self._K, M=self._M)

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        b, _, h, w = image.shape
        if "valid_wh" in data:
            valid_wh = torch.as_tensor(data["valid_wh"], device=self.device)
        else:
            valid_wh = torch.tensor([[w, h]], device=self.device).expand(b, 2)
        return apply(self.params, _pad32(image), valid_wh.to(torch.int32),
                     max_keypoints=self._max_kpts,
                     nms_radius=self.conf["nms_radius"],
                     detection_threshold=float(
                         self.conf["detection_threshold"]),
                     K=self._K, M=self._M)
