"""LISRD, the invariance-selective matcher. Counterpart of
``imcui_tpu/models/matchers/lisrd.py``.

Each point gets four descriptors (rotation variant or invariant, times
illumination variant or invariant) and four meta-descriptors from one
VGG-style trunk at a quarter of the resolution. At match time the
meta-descriptors' similarities, softmaxed over the four invariances,
weight the descriptors' similarities, and mutual nearest neighbours of
the weighted cosine are the matches; the raw weighted cosine is the
score, with no rescale.

A configurable detector supplies the keypoints from the grey image:
SuperPoint (bf16 at threshold 0.005, so on the card the stem kernel,
``stage_tail`` and ``nms_cellmax``), ALIKED or SIFT, each the port's own.

No LISRD checkpoint (``lisrd_aachen.pth``) is in the repository: the
model runs the ``checkpoint_npz`` a user names or the port's seed-0 tree,
which ``meta`` reports.
"""

import torch

from ...ops.matching import _softmax
from ...ops.nms import sample_descriptors
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (conv2d, full_fp32, init_conv, max_pool, relu,
                      xla_mean3)

VARIANCES = ("rot_var_illum_var", "rot_var_illum_inv",
             "rot_inv_illum_var", "rot_inv_illum_inv")
DESC_SIZE = 128
META_DESC_DIM = 128
TRUNK = (64, 64, 128, 128, 256, 256)


def init_params(gen):
    """Random tree in torch layout with the JAX ``init_params``'s keys."""
    params = {"trunk": []}
    cin = 3
    for cout in TRUNK:
        params["trunk"].append(init_conv(gen, 3, 3, cin, cout))
        cin = cout
    for v in VARIANCES:
        params[f"desc_{v}"] = init_conv(gen, 1, 1, 256, DESC_SIZE)
    for v in VARIANCES:
        params[f"meta_{v}"] = init_conv(gen, 1, 1, 256, META_DESC_DIM)
    return params


def backbone(params, x):
    """x (B, 3, H, W) → four descriptor maps and four meta maps, each
    (B, 128, H/4, W/4)."""
    for i, p in enumerate(params["trunk"]):
        x = relu(conv2d(p, x))
        if i in (1, 3):
            x = max_pool(x)
    return ([conv2d(params[f"desc_{v}"], x) for v in VARIANCES],
            [conv2d(params[f"meta_{v}"], x) for v in VARIANCES])


def normalize(x, dim=-1, eps=1e-8):
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)


def lisrd_match(desc0, desc1, meta0, meta1, mask0, mask1):
    """Meta-weighted mutual nearest neighbours. desc* (..., N, 4, D),
    meta* (..., N, 4, Dm), masks (..., N). Returns matches0 (..., N0)
    int32 and the weighted cosine as scores0."""
    desc0, desc1 = normalize(desc0), normalize(desc1)
    meta0, meta1 = normalize(meta0), normalize(meta1)
    meta_sims = torch.einsum("...nid,...mid->...nim", meta0, meta1)
    wts = _softmax(meta_sims, -2)
    desc_sims = torch.einsum("...nid,...mid->...nim", desc0, desc1)
    sims = (desc_sims * wts).sum(-2)
    sims = torch.where(mask0[..., :, None] & mask1[..., None, :], sims,
                       -1e9)
    nn01 = sims.argmax(-1)
    nn10 = sims.argmax(-2)
    mutual = torch.arange(sims.shape[-2], device=sims.device) == \
        nn10.gather(-1, nn01)
    scores = sims.amax(-1)
    valid = mutual & mask0 & (scores > -1e8)
    return (torch.where(valid, nn01, -1).to(torch.int32),
            torch.where(valid, scores, 0.0))


def _describe(params, images, kpts):
    """images (B, 3, H, W), kpts (B, N, 2) → descriptors (B, N, 4, D) and
    metas (B, N, 4, Dm), each sampled bilinearly on the stride-4 grid and
    L2-normalised."""
    descs, metas = backbone(params, images)

    def sample(maps):
        return torch.stack([sample_descriptors(kpts, m, s=4).transpose(1, 2)
                            for m in maps], 2)

    return sample(descs), sample(metas)


class Lisrd(BaseModel):
    """Standalone matcher {image0, image1} → matched keypoints, the
    detector ``superpoint``, ``aliked`` or ``sift``."""

    default_conf = {
        "model_name": "lisrd_aachen",
        "max_keypoints": 2048,
        "detector": "superpoint",
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "lisrd",
            self.device)
        det = conf["detector"]
        n = conf["max_keypoints"]
        if det == "superpoint":
            from ..extractors.superpoint import SuperPoint

            self.detector = SuperPoint(
                {"max_keypoints": n, "keypoint_threshold": 0.005},
                device=self.device)
        elif det == "aliked":
            from ..extractors.aliked import ALIKED

            self.detector = ALIKED({"max_num_keypoints": n},
                                   device=self.device)
        elif det == "sift":
            from ..extractors.sift import SIFT

            self.detector = SIFT({"max_keypoints": n}, device=self.device)
        else:
            raise ValueError(f"Unknown detector {det}")

    def _forward(self, data):
        image0 = torch.as_tensor(data["image0"], dtype=torch.float32,
                                 device=self.device)
        image1 = torch.as_tensor(data["image1"], dtype=torch.float32,
                                 device=self.device)

        def gray(img):
            return xla_mean3(img, 1)[:, None] if img.shape[1] == 3 else img

        def rgb(img):
            return img.expand(-1, 3, -1, -1) if img.shape[1] == 1 else img

        f0 = self.detector({"image": gray(image0)})
        f1 = self.detector({"image": gray(image1)})
        k0, k1 = f0["keypoints"].float(), f1["keypoints"].float()
        with full_fp32():
            d0, m0 = _describe(self.params, rgb(image0), k0)
            d1, m1 = _describe(self.params, rgb(image1), k1)
            matches, scores = lisrd_match(d0, d1, m0, m1,
                                          f0["mask"].bool(),
                                          f1["mask"].bool())
        ok = matches > -1
        idx = matches.long().clamp(0, k1.shape[1] - 1)
        k1m = k1.gather(1, idx[..., None].expand(-1, -1, 2))
        scores = torch.where(ok, scores, 0.0)
        return {
            "keypoints0": torch.where(ok[..., None], k0, 0.0),
            "keypoints1": torch.where(ok[..., None], k1m, 0.0),
            "scores": scores,
            "mconf": scores,
            "mask": ok,
        }
