"""Sparse matching for the pairwise path. Counterpart of
``imcui_tpu/pipeline/match_features.py``: the ``confs`` registry,
``kpt_bucket``, ``pad_features``, ``scale_keypoints`` and
``match_images(model, feat0, feat1)``. The batch ``main`` over HDF5 files
is not ported (it needs h5py).
"""

import numpy as np

from ..configs import confs_dict

confs = confs_dict["matchers"]

# fixed shape buckets for keypoint counts
KPT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)


def kpt_bucket(n):
    for b in KPT_BUCKETS:
        if b >= n:
            return b
    return int(-(-n // 4096) * 4096)


def pad_features(kpts, scores, desc, n, scales=None, oris=None):
    """Pad dynamic-count features to n slots + mask. desc: (D, m)."""
    m = len(kpts)
    if m > n:
        raise ValueError(f"{m} keypoints do not fit {n} slots")
    out = {
        "keypoints": np.zeros((n, 2), np.float32),
        "scores": np.zeros((n,), np.float32),
        "descriptors": np.zeros((desc.shape[0], n), np.float32),
        "mask": np.zeros((n,), bool),
    }
    out["keypoints"][:m] = kpts
    out["scores"][:m] = scores
    out["descriptors"][:, :m] = desc
    out["mask"][:m] = True
    if scales is not None:
        out["scales"] = np.zeros((n,), np.float32)
        out["scales"][:m] = scales
    if oris is not None:
        out["oris"] = np.zeros((n,), np.float32)
        out["oris"][:m] = oris
    return out


def scale_keypoints(kpts, scale):
    """Keypoints (n, 2) times a per-axis scale (2,); a copy."""
    kpts = np.array(kpts, copy=True)
    scale = np.asarray(scale)
    if scale.size == 2 and np.any(scale != 1.0):
        kpts[:, 0] *= scale[0]
        kpts[:, 1] *= scale[1]
    return kpts


def match_images(model, feat0, feat1):
    """Match two ``extract`` results with ``model``. Returns the valid
    keypoints and the raw matches at model and original resolution
    (keypoints*, keypoints*_orig, mkeypoints*, mkeypoints*_orig, mconf)."""
    data = {
        "image0": feat0.get("image"),
        "keypoints0": np.asarray(feat0["keypoints"]),
        "scores0": np.asarray(feat0["scores"]),
        "descriptors0": np.asarray(feat0["descriptors"]),
        "image1": feat1.get("image"),
        "keypoints1": np.asarray(feat1["keypoints"]),
        "scores1": np.asarray(feat1["scores"]),
        "descriptors1": np.asarray(feat1["descriptors"]),
    }
    for k in ("mask", "scales", "oris"):
        if k in feat0:
            data[k + "0"] = np.asarray(feat0[k])
        if k in feat1:
            data[k + "1"] = np.asarray(feat1[k])
    pred = {k: v.cpu().numpy() for k, v in model(data).items()}

    kpts0 = np.asarray(feat0["keypoints"][0])
    kpts1 = np.asarray(feat1["keypoints"][0])
    matches = pred["matches0"][0]
    confid = pred["matching_scores0"][0]
    mask0 = np.asarray(feat0.get("mask", np.ones((1, len(kpts0)), bool))[0])

    valid = (matches > -1) & mask0
    mkpts0 = kpts0[valid]
    mkpts1 = kpts1[matches[valid]]
    mconfid = confid[valid]

    s0 = np.asarray(feat0["original_size"]) / np.asarray(feat0["size"])
    s1 = np.asarray(feat1["original_size"]) / np.asarray(feat1["size"])
    kpts0_origin = scale_keypoints(kpts0 + 0.5, s0) - 0.5
    kpts1_origin = scale_keypoints(kpts1 + 0.5, s1) - 0.5
    mkpts0_origin = scale_keypoints(mkpts0 + 0.5, s0) - 0.5
    mkpts1_origin = scale_keypoints(mkpts1 + 0.5, s1) - 0.5

    # report only valid keypoints upstream (padding stays internal)
    k0 = kpts0[mask0]
    mask1 = np.asarray(feat1.get("mask", np.ones((1, len(kpts1)), bool))[0])
    k1 = kpts1[mask1]
    return {
        "image0_orig": feat0.get("image_orig"),
        "image1_orig": feat1.get("image_orig"),
        "keypoints0": k0,
        "keypoints1": k1,
        "keypoints0_orig": kpts0_origin[mask0],
        "keypoints1_orig": kpts1_origin[mask1],
        "mkeypoints0": mkpts0,
        "mkeypoints1": mkpts1,
        "mkeypoints0_orig": mkpts0_origin,
        "mkeypoints1_orig": mkpts1_origin,
        "mconf": mconfid,
    }
