"""DoG keypoints with a choice of descriptors: RootSIFT, or HardNet or
SOSNet on oriented 32 x 32 patches, float32 on the device.

Counterpart of ``imcui_tpu/models/extractors/dog.py``. Detection is
OpenCV's SIFT detector at ``contrastThreshold = options.peak_threshold``
(edge threshold 10, 3 layers, sigma 1.6), restated by ``ops/sift.py`` on
the uint8 image the JAX package makes; the keypoints are sorted by
response and cut to ``max_keypoints``. ``rootsift`` is SIFT's descriptor
of those keypoints (OpenCV's ``compute`` on given keypoints reads the
same pyramid), L1-normalised and square-rooted. ``hardnet`` and
``sosnet`` warp one patch a keypoint from the float image (0..1, not the
uint8 one) with the JAX module's inverse affine map, in one batched
bilinear sample with zero taps outside the image (``extract_patches``, as
``cv2.warpAffine(INTER_LINEAR | WARP_INVERSE_MAP)`` on float32, which
interpolates in float), then run HardNet: 7 convolutions without bias,
each followed by batch norm without affine, ReLU but for the last, on
patches standardised one by one (the unbiased std plus 1e-7). SOSNet
shares the topology. The JAX module pads the patch batch to a power of
two for its jit cache; nothing here depends on the batch, so the port
does not pad.

No trained HardNet or SOSNet tree is in the repository
(``hardnet_liberty.pth``, ``sosnet_liberty.pth``): the model runs a
user's ``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``. ``convert_state_dict`` maps an upstream state dict to the tree,
as the JAX module's ``_convert`` does.
"""

import torch

from ...ops import sift as sift_ops
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_conv,
                      l2_normalize, relu)
from .sift import fill, normalize_descriptors, padded_outputs, radians

HARDNET_SPEC = [
    # cout, stride, kernel
    (32, 1, 3), (32, 1, 3), (64, 2, 3), (64, 1, 3),
    (128, 2, 3), (128, 1, 3), (128, 1, 8),
]


def init_bn_noaffine(c):
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def init_hardnet(gen):
    params, cin = [], 1
    for cout, _, k in HARDNET_SPEC:
        params.append({"conv": init_conv(gen, k, k, cin, cout, bias=False),
                       "bn": init_bn_noaffine(cout)})
        cin = cout
    return {"features": params}


def hardnet_apply(params, patches):
    """patches: (N, 1, 32, 32) standardised → (N, 128) L2-normalised."""
    x = patches
    last = len(HARDNET_SPEC) - 1
    for i, ((_, s, k), p) in enumerate(zip(HARDNET_SPEC, params["features"])):
        x = conv2d(p["conv"], x, stride=s, padding="SAME" if k == 3
                   else "VALID")
        x = batch_norm_inference(p["bn"], x)
        if i < last:
            x = relu(x)
    return l2_normalize(x.reshape(x.shape[0], -1), eps=1e-8)


def describe_patches(params, patches):
    """HardNet's input norm, then the network: patches (N, 32, 32) →
    (N, 128). The std is torch's unbiased one, plus 1e-7."""
    x = patches[:, None]
    n = x[0].numel()
    mean = x.mean((1, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).sum((1, 2, 3), keepdim=True) / (n - 1)
    return hardnet_apply(params, (x - mean) / (torch.sqrt(var) + 1e-7))


def convert_state_dict(sd):
    """An upstream HardNet/SOSNet state dict (tensors or arrays, torch
    layout) → the tree, by order: the 4-D ``weight`` leaves are the 7
    convolutions and the ``running_mean``/``running_var`` pairs the 7
    batch norms, in module order. Raises on any other count or shape."""
    def t(v):
        return torch.as_tensor(v, dtype=torch.float32)

    convs = [t(v) for k, v in sd.items()
             if len(v.shape) == 4 and k.endswith("weight")]
    means = [t(v) for k, v in sd.items() if k.endswith("running_mean")]
    vars_ = [t(v) for k, v in sd.items() if k.endswith("running_var")]
    n = len(HARDNET_SPEC)
    if not len(convs) == len(means) == len(vars_) == n:
        raise ValueError(f"hardnet conversion: {len(convs)} convs / "
                         f"{len(means)} bn stats for {n} blocks")
    params = init_hardnet(torch.Generator().manual_seed(0))
    for blk, w, m, v in zip(params["features"], convs, means, vars_):
        if w.shape != blk["conv"]["w"].shape:
            raise ValueError(f"hardnet conv mismatch {tuple(w.shape)} vs "
                             f"{tuple(blk['conv']['w'].shape)}")
        blk["conv"]["w"], blk["bn"]["mean"], blk["bn"]["var"] = w, m, v
    return params


def patch_maps(pts, scales, angles, patch_size=32, mag_factor=12.0):
    """The JAX module's per-keypoint inverse affine map (patch pixel →
    image pixel), in float32 as its numpy computes it: (N, 2, 3)."""
    scale = mag_factor * scales / patch_size
    c, sn = torch.cos(angles), torch.sin(angles)
    tx = -scale * (c * patch_size / 2 - sn * patch_size / 2) + pts[:, 0]
    ty = -scale * (sn * patch_size / 2 + c * patch_size / 2) + pts[:, 1]
    return torch.stack([torch.stack([scale * c, -scale * sn, tx], -1),
                        torch.stack([scale * sn, scale * c, ty], -1)], 1)


def extract_patches(image, pts, scales, angles, patch_size=32,
                    mag_factor=12.0):
    """Oriented, scale-normalised patches around the keypoints of the
    float32 (H, W) image: ``warp_patches`` of ``patch_maps``.
    (N, patch_size, patch_size)."""
    return warp_patches(image, patch_maps(pts, scales, angles, patch_size,
                                          mag_factor), patch_size)


def warp_patches(image, maps, patch_size=32):
    """One batched bilinear sample of (N, 2, 3) inverse affine maps:
    patch pixel (x, y) reads image point M (x, y, 1), taps outside the
    image read 0; the coordinates and the two lerps are fused
    multiply-adds, as ``cv2.warpAffine(INTER_LINEAR | WARP_INVERSE_MAP)``
    computes them on float32 on an AVX2 host (bit for bit on the tests'
    patches)."""
    h, w = image.shape
    g = torch.arange(patch_size, dtype=torch.float32, device=image.device)
    xs, ys = g.view(1, 1, -1), g.view(1, -1, 1)

    def coord(row):
        a, b, t = (maps[:, row, i].view(-1, 1, 1) for i in range(3))
        return sift_ops.fma(a, xs, b * ys + t)

    sx, sy = coord(0), coord(1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = image.reshape(-1)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))]
        return torch.where(ok, v, 0.0)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = sift_ops.fma(fx, p01 - p00, p00)
    bottom = sift_ops.fma(fx, p11 - p10, p10)
    return sift_ops.fma(fy, bottom - top, top)


class DoG(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W) in [0, 1]} →
    keypoints, scores (responses), scales, oris, descriptors (B, 128, N),
    mask."""

    default_conf = {
        "options": {
            "first_octave": -1,
            "peak_threshold": 0.01,
        },
        "descriptor": "hardnet",  # rootsift | hardnet | sosnet
        "max_keypoints": 4096,
        "patch_size": 32,
        "mr_size": 12,
    }
    required_inputs = ["image"]

    def _init(self, conf):
        desc = conf["descriptor"]
        self.params = None
        self.meta = {"pretrained": False}
        if desc in ("hardnet", "sosnet"):
            self.params, self.meta = weights.load_trained(
                conf, init_hardnet(torch.Generator().manual_seed(0)), desc,
                self.device)
        elif desc != "rootsift":
            raise ValueError(f"Unknown descriptor {desc}.")

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        n = int(self.conf["max_keypoints"])
        out = padded_outputs(image.shape[0], n, 128, self.device)
        for i in range(image.shape[0]):
            img = image[i]
            img = img[0] if img.shape[0] == 1 else sum(img.unbind(0)) / float(
                img.shape[0])
            kp, gauss = sift_ops.detect(
                sift_ops.to_gray8(image[i]),
                self.conf["options"]["peak_threshold"], 10.0, n_features=n)
            kp = sift_ops.take(kp, n)
            f = sift_ops.fields(kp)
            if self.conf["descriptor"] == "rootsift":
                desc = normalize_descriptors(
                    sift_ops.describe(gauss, kp), True)
            elif len(kp["r"]):
                patches = extract_patches(
                    img, f["points"], f["sizes"], radians(f["angles"]),
                    self.conf["patch_size"], self.conf["mr_size"])
                with full_fp32():
                    desc = describe_patches(self.params, patches)
            else:
                desc = torch.zeros((0, 128), device=self.device)
            fill(out, i, f, desc)
        return out
