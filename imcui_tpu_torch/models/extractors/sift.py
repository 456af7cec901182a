"""SIFT keypoints and descriptors on the device, without OpenCV.

Counterpart of ``imcui_tpu/models/extractors/sift.py``, which calls
``cv2.SIFT_create(contrastThreshold=detection_threshold,
nfeatures=max_keypoints, edgeThreshold=edge_threshold, nOctaveLayers=3)``
on the host; here ``ops/sift.py`` restates that detector and descriptor on
tensors. The input is the JAX package's uint8 image (the one channel, or
the channel mean of three, times 255, clipped and truncated); the
keypoints are sorted by response and cut to ``max_keypoints``; the
descriptors are RootSIFT (L1-normalised, then the square root) or
L2-normalised. Outputs are padded to ``max_keypoints`` with ``mask``,
``scales`` (OpenCV's keypoint size) and ``oris`` (radians), which
``sift-lightglue`` reads with ``add_scale_ori``.

``first_octave``, ``num_octaves`` and ``nms_radius`` are read and ignored,
as in the JAX package, which never passes them to OpenCV (its first
octave is OpenCV's -1). A ``backend`` other than ``"opencv"`` becomes
``"opencv"``: the JAX package falls back so when pycolmap is absent, and
pycolmap is not ported.

SIFT is handcrafted: it has no tree, and ``meta`` says pretrained.
"""

import math

import torch

from ...ops import sift as sift_ops
from ...utils.base_model import BaseModel


def normalize_descriptors(desc, rootsift):
    """(N, 128) → RootSIFT (L1 norm, then the square root) or L2-normalised
    rows, as the JAX package's numpy."""
    if rootsift:
        l1 = desc.abs().sum(-1, keepdim=True).clamp_min(1e-8)
        return torch.sqrt(desc / l1)
    return desc / torch.linalg.vector_norm(desc, dim=-1,
                                           keepdim=True).clamp_min(1e-8)


def padded_outputs(b, n, dim, device):
    """The zero outputs of a batch of b views with n slots."""
    return {"keypoints": torch.zeros((b, n, 2), device=device),
            "scores": torch.zeros((b, n), device=device),
            "scales": torch.zeros((b, n), device=device),
            "oris": torch.zeros((b, n), device=device),
            "descriptors": torch.zeros((b, dim, n), device=device),
            "mask": torch.zeros((b, n), dtype=torch.bool, device=device)}


def radians(degrees):
    """numpy's float32 ``deg2rad``: the angle times (float)(pi / 180)."""
    return degrees * sift_ops.f32(math.pi / 180)


def fill(out, i, fields, desc):
    """Write one view's keypoints (sorted, at most n) into slot row i."""
    m = len(fields["responses"])
    out["keypoints"][i, :m] = fields["points"]
    out["scores"][i, :m] = fields["responses"]
    out["scales"][i, :m] = fields["sizes"]
    out["oris"][i, :m] = radians(fields["angles"])
    out["descriptors"][i, :, :m] = desc.T
    out["mask"][i, :m] = True


class SIFT(BaseModel):
    """BaseModel wrapper: {"image" (B, 1 or 3, H, W) in [0, 1]} →
    keypoints, scores (responses), scales, oris, descriptors (B, 128, N),
    mask."""

    default_conf = {
        "rootsift": True,
        "nms_radius": 0,  # read and ignored, as in the JAX package
        "max_keypoints": 4096,
        "backend": "opencv",
        "detection_threshold": 0.0066667,
        "edge_threshold": 10,
        "first_octave": -1,  # read and ignored
        "num_octaves": 4,  # read and ignored
    }
    required_inputs = ["image"]

    def _init(self, conf):
        if conf["backend"] != "opencv":
            conf["backend"] = "opencv"  # pycolmap is not ported
        self.params = None
        self.meta = {"pretrained": True,
                     "source": "handcrafted (OpenCV 5.0's SIFT restated)"}

    def _forward(self, data):
        image = torch.as_tensor(data["image"], dtype=torch.float32,
                                device=self.device)
        n = int(self.conf["max_keypoints"])
        out = padded_outputs(image.shape[0], n, 128, self.device)
        for i in range(image.shape[0]):
            kp, gauss = sift_ops.detect(
                sift_ops.to_gray8(image[i]),
                self.conf["detection_threshold"],
                self.conf["edge_threshold"], n_features=n)
            kp = sift_ops.take(kp, n)
            desc = sift_ops.describe(gauss, kp)
            fill(out, i, sift_ops.fields(kp),
                 normalize_descriptors(desc, self.conf["rootsift"]))
        return out
