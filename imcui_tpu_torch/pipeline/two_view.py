"""The two-view matching step: SuperPoint on both views in one batch,
LightGlue at static depth, fundamental-matrix RANSAC, for a batch of
pairs. Counterpart of ``imcui_tpu/pipeline/two_view.py``.
"""

from pathlib import Path

import torch

from .. import resolve_device
from ..models.extractors import superpoint as sp
from ..models.matchers import lightglue as lg
from ..ops import ransac as ransac_ops
from ..utils import weights

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "weights"
SP_NPZ = "superpoint_adapted.npz"
LG_NPZ = "lightglue_selftrained.npz"


def load_pretrained(n_layers=9, weights_dir=WEIGHTS_DIR, device="cuda"):
    """Weights of the step, read from the npz trees in ``weights_dir``
    (no download is attempted). LightGlue's tree has 9 layers; another
    depth, like an absent file, takes random init from a seeded
    generator. ``meta`` records where each tree came from."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    sp_init = sp.init_params(gen)
    lg_init = lg.init_params(gen, n_layers=n_layers)
    wdir = Path(weights_dir)
    sp_params, sp_meta = weights.load_or_init(wdir / SP_NPZ, sp_init, "superpoint", dev)
    lg_path = wdir / LG_NPZ
    if n_layers != 9:
        lg_params, lg_meta = weights.to_device(lg_init, dev), {
            "pretrained": False,
            "source": f"random init (seed 0): {lg_path} holds 9 layers, "
                      f"not {n_layers}"}
    else:
        lg_params, lg_meta = weights.load_or_init(lg_path, lg_init,
                                                  "lightglue", dev)
    return ({"superpoint": sp_params, "lightglue": lg_params},
            {"superpoint": sp_meta, "lightglue": lg_meta})


def match_step(params, image0, image1, valid_wh0, valid_wh1, generator, *,
               max_keypoints=1024, nms_radius=4, keypoint_threshold=0.0005,
               match_threshold=0.1, ransac="fundamental",
               ransac_threshold=4.0, num_hypotheses=512, precision="bf16",
               device="cuda"):
    """Pair batch in, verified matches out.

    image0/1: (B, 1, H, W) float32 in [0, 1]; valid_wh0/1: (B, 2) int;
    generator: torch.Generator on ``device`` for RANSAC's hypotheses;
    ``params`` (load_pretrained) must already be on ``device``. Returns
    keypoints0/1 (B, N, 2), scores0/1, mask0/1, matches0 (B, N),
    matching_scores0 and, unless ``ransac`` is None, inliers (B, N),
    M (B, 3, 3), num_inliers (B,), mkeypoints0/1 (B, N, 2)."""
    dev = resolve_device(device)
    image0, image1 = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                      for t in (image0, image1))
    valid_wh0, valid_wh1 = (torch.as_tensor(t, device=dev).to(torch.int32)
                            for t in (valid_wh0, valid_wh1))
    b = image0.shape[0]
    kw = dict(nms_radius=nms_radius, max_keypoints=max_keypoints,
              keypoint_threshold=keypoint_threshold, precision=precision,
              device=dev)
    if image0.shape == image1.shape:  # both views in one extractor batch
        feats = sp.apply(params["superpoint"], torch.cat([image0, image1]),
                         torch.cat([valid_wh0, valid_wh1]), **kw)
        f0 = {k: v[:b] for k, v in feats.items()}
        f1 = {k: v[b:] for k, v in feats.items()}
    else:
        f0 = sp.apply(params["superpoint"], image0, valid_wh0, **kw)
        f1 = sp.apply(params["superpoint"], image1, valid_wh1, **kw)

    matched = lg.forward_pair(
        params["lightglue"], f0["keypoints"], f1["keypoints"],
        f0["descriptors"].transpose(1, 2), f1["descriptors"].transpose(1, 2),
        f0["mask"], f1["mask"], valid_wh0.float(), valid_wh1.float(),
        match_threshold=match_threshold, device=dev)
    out = {
        "keypoints0": f0["keypoints"], "keypoints1": f1["keypoints"],
        "scores0": f0["scores"], "scores1": f1["scores"],
        "mask0": f0["mask"], "mask1": f1["mask"],
        "matches0": matched["matches0"],
        "matching_scores0": matched["matching_scores0"],
    }
    if ransac is not None:
        # slot i ↦ (kpt0[i], kpt1[matches0[i]])
        m0 = out["matches0"].long()
        idx = m0.clamp(0, f1["keypoints"].shape[1] - 1)
        p0 = out["keypoints0"]
        p1 = torch.gather(out["keypoints1"], 1, idx[..., None].expand(-1, -1, 2))
        ver = ransac_ops.ransac(p0, p1, m0 > -1, generator, model=ransac,
                                threshold=ransac_threshold,
                                num_hypotheses=num_hypotheses, device=dev)
        out.update({"inliers": ver["inliers"], "M": ver["M"],
                    "num_inliers": ver["num_inliers"],
                    "mkeypoints0": p0, "mkeypoints1": p1})
    return out
