"""InLoc localisation from RGB-D scans. Counterpart of
``imcui_tpu/pipeline/localize_inloc.py:1-168``: each query's matches to
its retrieved database images are lifted to 3D through the scans' XYZ
maps (``interpolate_scan``, ``:19-42``) and their alignments
(``get_scan_pose``, ``:45-62``), then the pose comes from this package's
PnP RANSAC on ``device`` (1024 hypotheses, 48 px; drawn from a
``torch.Generator`` seeded with 0 where the JAX module uses
``jax.random.PRNGKey(0)``). ``main`` writes the same pose text file and
``<results>_logs.pkl``, which holds numpy arrays and Python numbers only.

Deviation: the JAX module builds the scan's path as
``Path(dataset_dir) / r + ".mat"`` (``:93``), which raises ``TypeError``
(a ``Path`` plus a ``str``) for every query with a match; here it is
``Path(dataset_dir, r + ".mat")``, the file the expression means. The
alignment's rows are parsed with ``str.split`` where the JAX module calls
the deprecated ``np.fromstring``: equal on well-formed rows, and a row
that is not numbers raises instead of giving a short row.
"""

import pickle
from pathlib import Path

import numpy as np
import scipy.io
import torch

from .. import logger, resolve_device
from ..ops import pnp
from ..utils.geometry import rotmat2qvec
from ..utils.io import get_keypoints, get_matches, parse_retrieval
from .reconstruction import pad_slots

PNP_HYPOTHESES = 1024
PNP_THRESHOLD_PX = 48.0


def interpolate_scan(scan, kp):
    """Bilinear 3-D interpolation into an InLoc scan. scan: (H, W, 3)
    xyz; kp: (N, 2) pixels. Returns (N, 3) points and whether all four
    corners of each were finite."""
    h, w, c = scan.shape
    kp = kp / np.array([[w - 1, h - 1]]) * 2 - 1
    assert np.all(kp > -1) and np.all(kp < 1)
    # bilinear by hand
    gx = (kp[:, 0] + 1) * 0.5 * (w - 1)
    gy = (kp[:, 1] + 1) * 0.5 * (h - 1)
    x0 = np.clip(np.floor(gx).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(gy).astype(int), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    wx = gx - x0
    wy = gy - y0
    corners = np.stack(
        [scan[y0, x0], scan[y0, x1], scan[y1, x0], scan[y1, x1]], 1
    )  # (N, 4, 3)
    valid = ~np.any(np.isnan(corners), axis=(1, 2))
    weights = np.stack(
        [(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], 1
    )
    xyz = (corners * weights[..., None]).sum(1)
    return xyz, valid


def get_scan_pose(dataset_dir, rpath):
    """The 4 × 4 alignment of the scan ``rpath`` (lines 8-11 of its
    transformation file)."""
    if "cse" in rpath:
        alignment_path = (
            Path(dataset_dir) / "database/alignments" / rpath.split("/")[1]
            / "transformations/cse_transformation.txt"
        )
    else:
        alignment_path = (
            Path(dataset_dir) / "database/alignments" / rpath.split("/")[1]
            / "transformations/DUC_transformation.txt"
        )
    with open(alignment_path) as f:
        raw = f.readlines()[7:11]
    P_after_GICP = np.array(
        [np.array(ln.split(), dtype=float) for ln in raw]
    )
    return P_after_GICP


def pose_from_scan_cluster(dataset_dir, q, retrieved, feature_file,
                           match_file, skip=None, device="cuda"):
    """The query's 2D-3D correspondences through the scans of
    ``retrieved``, then its pose by PnP RANSAC on ``device``. Returns
    (query points, database points, 3D points, {success, qvec, tvec,
    num_inliers}, logs)."""
    dev = resolve_device(device)
    height, width = 1200, 1600  # InLoc query resolution
    cx, cy = 0.5 * width, 0.5 * height
    focal = 4032.0 * 28.0 / 36.0

    all_mkpq = []
    all_mkpr = []
    all_mkp3d = []
    all_indices = []
    kpq = get_keypoints(feature_file, q)
    num_matches = 0
    for i, r in enumerate(retrieved):
        kpr = get_keypoints(feature_file, r)
        pair = (q, r)
        m, _ = get_matches(match_file, *pair)
        if skip and (len(m) < skip):
            continue
        mkpq, mkpr = kpq[m[:, 0]], kpr[m[:, 1]]
        num_matches += len(mkpq)
        scan_r = scipy.io.loadmat(Path(dataset_dir, r + ".mat"))["XYZcut"]
        mkp3d, valid = interpolate_scan(scan_r, mkpr)
        Tr = get_scan_pose(dataset_dir, r)
        mkp3d = mkp3d @ Tr[:3, :3].T + Tr[:3, 3]
        all_mkpq.append(mkpq[valid])
        all_mkpr.append(mkpr[valid])
        all_mkp3d.append(mkp3d[valid])
        all_indices.append(np.full(np.count_nonzero(valid), i))
    if not all_mkpq:
        return None, None, None, None, {"num_matches": 0}
    all_mkpq = np.concatenate(all_mkpq)
    all_mkpr = np.concatenate(all_mkpr)
    all_mkp3d = np.concatenate(all_mkp3d)
    all_indices = np.concatenate(all_indices)

    K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], np.float32)
    n = len(all_mkpq)
    n_pad = pad_slots(max(n, 1))
    p2 = np.zeros((n_pad, 2), np.float32)
    p3 = np.zeros((n_pad, 3), np.float32)
    mask = np.zeros((n_pad,), bool)
    p2[:n], p3[:n], mask[:n] = all_mkpq, all_mkp3d, True
    ret = pnp.ransac_pnp(
        p2, p3, mask, K, torch.Generator(device=dev).manual_seed(0),
        threshold_px=PNP_THRESHOLD_PX, num_hypotheses=PNP_HYPOTHESES,
        device=dev,
    )
    ret = {
        "success": bool(ret["success"]),
        "qvec": rotmat2qvec(ret["R"].double().cpu().numpy()),
        "tvec": ret["t"].double().cpu().numpy(),
        "num_inliers": int(ret["num_inliers"]),
    }
    logs = {"num_matches": num_matches}
    return all_mkpq, all_mkpr, all_mkp3d, ret, logs


def main(dataset_dir, retrieval, features, matches, results,
         skip_matches=None, device="cuda"):
    """Localise every query of ``retrieval`` against the scans of its
    retrieved images; write ``results`` and ``<results>_logs.pkl`` and
    return (poses, logs)."""
    resolve_device(device)
    assert Path(retrieval).exists(), retrieval
    assert Path(features).exists(), features
    assert Path(matches).exists(), matches

    retrieval_dict = parse_retrieval(retrieval)
    queries = list(retrieval_dict.keys())

    poses = {}
    logs = {
        "features": str(features), "matches": str(matches),
        "retrieval": str(retrieval), "loc": {},
    }
    logger.info("Starting localization...")
    for q in queries:
        db = retrieval_dict[q]
        mkpq, mkpr, mkp3d, ret, log = pose_from_scan_cluster(
            dataset_dir, q, db, features, matches, skip_matches,
            device=device,
        )
        if ret is not None and ret["success"]:
            poses[q] = (ret["qvec"], ret["tvec"])
        logs["loc"][q] = {**log, "db": db, "PnP_ret": ret}

    logger.info(f"Writing poses to {results}...")
    with open(results, "w") as f:
        for q in poses:
            qvec, tvec = poses[q]
            qvec = " ".join(map(str, qvec))
            tvec = " ".join(map(str, tvec))
            name = q.split("/")[-1]
            f.write(f"{name} {qvec} {tvec}\n")
    with open(f"{results}_logs.pkl", "wb") as f:
        pickle.dump(logs, f)
    logger.info("Done!")
    return poses, logs
