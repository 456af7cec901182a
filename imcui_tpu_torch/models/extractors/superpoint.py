"""SuperPoint keypoint detector and descriptor.

Counterpart of ``imcui_tpu/models/extractors/superpoint.py``: the
functional ``apply`` and the ``SuperPoint`` ``BaseModel`` around it. A VGG
encoder, a 65-channel cell-softmax
detector head unfolded to full resolution, and a 256-d descriptor head
sampled bilinearly at the keypoints. Fixed-k output: ``max_keypoints``
slots with a validity mask.

``precision="bf16"`` runs the trunk and heads in bfloat16 through the
fused kernels: stages 1 and 2 as a bias-free ``conv_a`` followed by the
``stage_tail`` kernel (K1), and keypoint selection through
``nms_cellmax`` (K2) where ``cuda_nms.supported`` holds (3 <= nms_radius
<= 6), else through the reference's per-pixel chain; with
``fused="stem"`` stage 1 runs from the raw image in the ``stem_tail``
kernel (K6/K7) instead. ``precision="fp32"``
runs plain float32 layers (TF32 off) for parity with the JAX package.
"""

from pathlib import Path

import torch
import torch.nn.functional as F

from ... import resolve_device
from ...ops import cuda_nms, cuda_stage1
from ...ops import nms as nms_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import conv2d, full_fp32, max_pool, relu

WEIGHTS_NPZ = Path(__file__).resolve().parents[3] / "weights" \
    / "superpoint_adapted.npz"
# Route of the bf16 trunk's stage 1: True is conv1a + stage_tail, "stem" the
# stem_tail kernel, which an H100 runs no slower at any shape measured
# (PERF.md, "the stem decision").
BF16_FUSED = "stem"

CONV_SPECS = [
    # name, cin, cout, kernel
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3), ("convDb", 256, 256, 1),
]


def init_params(generator):
    """Random init (He-normal kernels, zero biases) in torch layout."""
    params = {}
    for name, cin, cout, k in CONV_SPECS:
        w = torch.randn((cout, cin, k, k), generator=generator)
        params[name] = {"w": w * (2.0 / (k * k * cin)) ** 0.5,
                        "b": torch.zeros(cout)}
    return params


def _stage(pa, pb, x, fused):
    """conv_a → relu → conv_b → relu → 2×2 max-pool on (B, C, H, W)."""
    if not fused:
        return max_pool(relu(conv2d(pb, relu(conv2d(pa, x)))))
    w = pa["w"]
    pad = -x.shape[1] % 8
    if pad:
        # cuDNN writes a channels-last output only for 8-aligned input
        # channels; zero channels add nothing to the sums
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        w = F.pad(w, (0, 0, 0, 0, 0, pad))
    cl = torch.channels_last
    # bias and relu of conv_a are fused into the kernel
    y_raw = conv2d({"w": w.contiguous(memory_format=cl)},
                   x.contiguous(memory_format=cl))
    out = cuda_stage1.stage_tail(y_raw.permute(0, 2, 3, 1).contiguous(),
                                 pa["b"], pb["w"], pb["b"])
    return out.permute(0, 3, 1, 2)  # NCHW view of the NHWC result


def backbone(params, x, fused=False):
    """Shared VGG encoder. x: (B, 1, H, W) → (B, 128, H/8, W/8).
    ``fused=True`` runs stages 1 and 2 through the stage_tail kernel
    (bf16); ``fused="stem"`` runs stage 1 from the image in the stem_tail
    kernel and stage 2 through stage_tail."""
    if fused == "stem":
        pa, pb = params["conv1a"], params["conv1b"]
        x = cuda_stage1.stem_tail(x[:, 0].contiguous(), pa["w"], pa["b"],
                                  pb["w"], pb["b"]).permute(0, 3, 1, 2)
    else:
        x = _stage(params["conv1a"], params["conv1b"], x, fused)
    x = _stage(params["conv2a"], params["conv2b"], x, fused)
    x = relu(conv2d(params["conv3a"], x))
    x = max_pool(relu(conv2d(params["conv3b"], x)))
    x = relu(conv2d(params["conv4a"], x))
    return relu(conv2d(params["conv4b"], x))


def dense_scores(params, feats):
    """Detector head → full-resolution heatmap (B, H, W), float32."""
    cpa = relu(conv2d(params["convPa"], feats))
    logits = conv2d(params["convPb"], cpa).float()
    probs = torch.softmax(logits, 1)[:, :-1]  # drop the dustbin
    return nms_ops.depth_to_space(probs, 8)[:, 0]


def dense_descriptors(params, feats):
    """Descriptor head → (B, 256, Hc, Wc) float32, L2-normalised per cell
    with the norm sqrt(max(‖d‖², 1e-16))."""
    cda = relu(conv2d(params["convDa"], feats))
    desc = conv2d(params["convDb"], cda).float()
    sq = (desc * desc).sum(1, keepdim=True)
    return desc / torch.sqrt(sq.clamp_min(1e-16))


def _refine_subpixel(kpts, heat, mask):
    """Radius-1 soft-argmax refinement on the raw heatmap; masked slots
    stay pinned at their sentinel coordinates."""
    ref = nms_ops.soft_argmax_refinement(kpts, heat.float(), radius=1)
    return torch.where(mask[..., None], ref, kpts)


def _select_per_pixel(heat, valid_wh, radius, border, k, threshold):
    """simple_nms -> border/valid mask -> exact top-k over every pixel,
    in the heatmap's own type."""
    h, w = heat.shape[-2:]
    scores = nms_ops.simple_nms(heat, radius)
    scores = scores * nms_ops.border_mask(h, w, border, valid_wh,
                                          device=heat.device)
    return nms_ops.select_topk_keypoints(scores, k, threshold)


def apply(params, image, valid_wh, nms_radius=4, max_keypoints=1024,
          keypoint_threshold=0.005, remove_borders=4, precision="bf16",
          subpixel=False, fused=None, device="cuda"):
    """Full SuperPoint forward.

    image: (B, 1, H, W) float32 in [0, 1], zero-padded to its canvas;
    valid_wh: (B, 2) int valid (w, h) region per image. ``params`` must
    already be on ``device``. ``subpixel`` refines the keypoints by a
    soft-argmax over the raw heatmap around each selected peak. ``fused``
    picks the bf16 trunk's route (see ``backbone``; None takes
    ``BF16_FUSED``). Returns keypoints (B, N, 2) xy, scores (B, N),
    descriptors (B, 256, N) and mask (B, N)."""
    dev = resolve_device(device)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    valid_wh = torch.as_tensor(valid_wh, device=dev).to(torch.int32)
    if precision == "bf16":
        cparams = {k: {n: t.to(torch.bfloat16) for n, t in p.items()}
                   for k, p in params.items()}
        feats = backbone(cparams, image.to(torch.bfloat16),
                         fused=BF16_FUSED if fused is None else fused)
        # NMS and top-k only compare: bf16 halves the heatmap traffic
        heat = dense_scores(cparams, feats).to(torch.bfloat16).contiguous()
        desc_map = dense_descriptors(cparams, feats)
        raw = heat
        h, w = heat.shape[-2:]
        if cuda_nms.supported(h, w, nms_radius):
            kpts, kscores, mask = cuda_nms.select_keypoints(
                heat, valid_wh, max_keypoints, keypoint_threshold,
                radius=nms_radius, border=remove_borders)
        else:
            # the reference's per-pixel chain, as its bf16 apply takes
            # outside the fused NMS's gate
            kpts, kscores, mask = _select_per_pixel(
                heat, valid_wh, nms_radius, remove_borders, max_keypoints,
                keypoint_threshold)
    elif precision == "fp32":
        with full_fp32():
            feats = backbone(params, image)
            heat = dense_scores(params, feats)
            desc_map = dense_descriptors(params, feats)
        raw = heat
        kpts, kscores, mask = _select_per_pixel(
            heat, valid_wh, nms_radius, remove_borders, max_keypoints,
            keypoint_threshold)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    if subpixel:
        kpts = _refine_subpixel(kpts, raw, mask)
    desc = nms_ops.sample_descriptors(kpts, desc_map, s=8)
    return {"keypoints": kpts, "scores": kscores.float(),
            "descriptors": desc, "mask": mask}


def load_params(conf, device):
    """The trained tree in ``weights/`` (or ``conf["checkpoint_npz"]``);
    no download is attempted. Without the file, random init from a
    generator seeded 0, recorded in ``meta``."""
    return weights.load_or_init(
        conf.get("checkpoint_npz") or WEIGHTS_NPZ,
        init_params(torch.Generator().manual_seed(0)), "superpoint", device)


class SuperPoint(BaseModel):
    """BaseModel wrapper: {"image" (B, 1, H, W), "valid_wh" (B, 2)?} →
    keypoints, scores, descriptors, mask."""

    default_conf = {
        "nms_radius": 4,
        "keypoint_threshold": 0.005,
        "max_keypoints": 1024,
        "remove_borders": 4,
        "fix_sampling": False,  # sampling is always the fixed variant
        "precision": "bf16",  # the fused-kernel trunk; "fp32" for parity
        "subpixel": False,
        # route of the bf16 trunk (see backbone); None takes BF16_FUSED
        "fused": None,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        # the reference uses -1 for "keep all"; fixed shapes need a cap
        if conf["max_keypoints"] in (-1, None):
            conf["max_keypoints"] = 4096

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        if "valid_wh" in data:
            valid_wh = torch.as_tensor(data["valid_wh"], device=self.device)
        else:
            valid_wh = torch.tensor([[image.shape[3], image.shape[2]]],
                                    device=self.device).expand(len(image), 2)
        return apply(
            self.params, image, valid_wh,
            nms_radius=self.conf["nms_radius"],
            max_keypoints=self.conf["max_keypoints"],
            keypoint_threshold=self.conf["keypoint_threshold"],
            remove_borders=self.conf["remove_borders"],
            precision=self.conf["precision"],
            subpixel=self.conf.get("subpixel", False),
            fused=self.conf.get("fused"), device=self.device)
