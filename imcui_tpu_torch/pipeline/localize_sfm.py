"""Localisation of query images against an SfM model. Counterpart of
``imcui_tpu/pipeline/localize_sfm.py:1-207``: the same ``main()``, the
same covisibility clustering (``:23-48``, in the JAX module's set-pop
order), the same pose text file and the same ``<results>_logs.pkl``.

Each query's pose comes from this package's PnP RANSAC on ``device``
(``ops/pnp.py::ransac_pnp``, 1024 hypotheses, on ``max(64,
2**ceil(log2 n))`` padded slots, ``:51-118``). The JAX module draws the
hypotheses from ``jax.random.PRNGKey(0)``; here from a ``torch.Generator``
on the device seeded with 0, so the draws differ and only a scene whose
inlier set is unique gives both packages the same inliers. The logs hold
numpy arrays and Python numbers, never a tensor, so the JAX package reads
them.
"""

import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np

import torch

from .. import logger, resolve_device
from ..ops import pnp
from ..utils.geometry import rotmat2qvec
from ..utils.io import (get_keypoints, get_matches, parse_image_list,
                        parse_retrieval)
from ..utils.read_write_model import Camera, read_model
from .reconstruction import pad_slots
from .triangulation import camera_K

PNP_HYPOTHESES = 1024


def do_covisibility_clustering(frame_ids, images, points3D):
    """Split ``frame_ids`` into groups connected by shared 3D points,
    largest first."""
    clusters = []
    visited = set()
    for frame_id in frame_ids:
        if frame_id in visited:
            continue
        clusters.append([])
        queue = {frame_id}
        while len(queue):
            exploration_frame = queue.pop()
            if exploration_frame in visited:
                continue
            visited.add(exploration_frame)
            clusters[-1].append(exploration_frame)
            observed = images[exploration_frame].point3D_ids
            connected_frames = {
                obs_img_id
                for p3d in observed[observed != -1]
                for obs_img_id in points3D[p3d].image_ids
            }
            connected_frames &= set(frame_ids)
            connected_frames -= visited
            queue |= connected_frames
    clusters = sorted(clusters, key=len, reverse=True)
    return clusters


def pose_from_cluster(query_name, query_camera, db_ids, images, points3D,
                      features_path, matches_path, thresh_px=12.0,
                      device="cuda"):
    """The query's 2D-3D correspondences through the database images
    ``db_ids``, then its pose by PnP RANSAC on ``device``. Returns (None
    or {qvec, tvec, num_inliers, inliers}, log)."""
    dev = resolve_device(device)
    kpq = get_keypoints(features_path, query_name)
    kpq += 0.5  # COLMAP convention

    kp_idx_to_3D = defaultdict(list)
    kp_idx_to_3D_to_db = defaultdict(lambda: defaultdict(list))
    num_matches = 0
    for i, db_id in enumerate(db_ids):
        image = images[db_id]
        if image.point3D_ids.size == 0:
            continue
        points3D_ids = image.point3D_ids
        matches, _ = get_matches(matches_path, query_name, image.name)
        if len(matches) == 0:
            continue
        matches = matches[points3D_ids[matches[:, 1]] != -1]
        num_matches += len(matches)
        for idx, m in matches:
            id_3D = points3D_ids[m]
            kp_idx_to_3D_to_db[idx][id_3D].append(i)
            if id_3D not in kp_idx_to_3D[idx]:
                kp_idx_to_3D[idx].append(id_3D)

    idxs = list(kp_idx_to_3D.keys())
    mkp_idxs = [i for i in idxs for _ in kp_idx_to_3D[i]]
    mp3d_ids = [j for i in idxs for j in kp_idx_to_3D[i]]
    if len(mkp_idxs) < 6:
        return None, {"num_matches": num_matches,
                      "keypoint_index_to_db": (mkp_idxs, mp3d_ids)}

    p2d = kpq[mkp_idxs]
    p3d = np.array([points3D[j].xyz for j in mp3d_ids])
    K = camera_K(query_camera)

    n = len(p2d)
    n_pad = pad_slots(n)
    pp2 = np.zeros((n_pad, 2), np.float32)
    pp3 = np.zeros((n_pad, 3), np.float32)
    mask = np.zeros((n_pad,), bool)
    pp2[:n], pp3[:n], mask[:n] = p2d, p3d, True

    out = pnp.ransac_pnp(
        pp2, pp3, mask, K, torch.Generator(device=dev).manual_seed(0),
        threshold_px=thresh_px, num_hypotheses=PNP_HYPOTHESES, device=dev,
    )
    ret = None
    if bool(out["success"]):
        ret = {
            "qvec": rotmat2qvec(out["R"].double().cpu().numpy()),
            "tvec": out["t"].double().cpu().numpy(),
            "num_inliers": int(out["num_inliers"]),
            "inliers": out["inliers"].cpu().numpy()[:n],
        }
    log = {
        "num_matches": num_matches,
        "keypoint_index_to_db": (mkp_idxs, mp3d_ids),
        "PnP_ret": {k: v for k, v in (ret or {}).items() if k != "inliers"},
    }
    return ret, log


def main(reference_sfm, queries, retrieval, features, matches, results,
         ransac_thresh=12.0, covisibility_clustering=False,
         prepend_camera_name=False, config=None, device="cuda"):
    """Localise every query of ``queries`` (an image list with
    intrinsics) against the model ``reference_sfm`` through the images
    ``retrieval`` pairs it with; write ``results`` (one ``name qvec tvec``
    a line) and ``<results>_logs.pkl``, and return (poses, logs)."""
    resolve_device(device)
    assert Path(retrieval).exists(), retrieval
    assert Path(features).exists(), features
    assert Path(matches).exists(), matches

    queries = parse_image_list(queries, with_intrinsics=True)
    retrieval_dict = parse_retrieval(retrieval)

    logger.info("Reading the 3D model...")
    cameras, images, points3D = read_model(Path(reference_sfm))
    db_name_to_id = {image.name: i for i, image in images.items()}

    poses = {}
    logs = {
        "features": str(features),
        "matches": str(matches),
        "retrieval": str(retrieval),
        "loc": {},
    }
    logger.info("Starting localization...")
    for qname, qcam in queries:
        if qname not in retrieval_dict:
            logger.warning(f"No images retrieved for query {qname}, skipped.")
            continue
        if isinstance(qcam, dict):
            qcam = Camera(id=-1, model=qcam["model"], width=qcam["width"],
                          height=qcam["height"], params=qcam["params"])
        db_names = retrieval_dict[qname]
        db_ids = [db_name_to_id[n] for n in db_names
                  if n in db_name_to_id]
        if len(db_ids) == 0:
            logger.warning(f"No DB images found for {qname}, skipped.")
            continue

        if covisibility_clustering:
            clusters = do_covisibility_clustering(db_ids, images, points3D)
            best_inliers = 0
            best_ret, best_log = None, None
            logs_clusters = []
            for cluster_ids in clusters:
                ret, log = pose_from_cluster(
                    qname, qcam, cluster_ids, images, points3D,
                    features, matches, thresh_px=ransac_thresh,
                    device=device,
                )
                if ret is not None and ret["num_inliers"] > best_inliers:
                    best_inliers = ret["num_inliers"]
                    best_ret, best_log = ret, log
                logs_clusters.append(log)
            ret, log = best_ret, best_log or {"logs_clusters": logs_clusters}
            log = {**(log or {}), "logs_clusters": logs_clusters}
        else:
            ret, log = pose_from_cluster(
                qname, qcam, db_ids, images, points3D, features, matches,
                thresh_px=ransac_thresh, device=device,
            )
        if ret is not None:
            poses[qname] = (ret["qvec"], ret["tvec"])
        else:
            logger.info(f"Could not localize image {qname}.")
        logs["loc"][qname] = {**(log or {}), "db": db_ids}

    logger.info(f"Localized {len(poses)} / {len(queries)} images.")
    logger.info(f"Writing poses to {results}...")
    results = Path(results)
    results.parent.mkdir(exist_ok=True, parents=True)
    with open(results, "w") as f:
        for q in poses:
            qvec, tvec = poses[q]
            qvec = " ".join(map(str, qvec))
            tvec = " ".join(map(str, tvec))
            name = q.split("/")[-1] if not prepend_camera_name else \
                q.split("/")[-2] + "/" + q.split("/")[-1]
            f.write(f"{name} {qvec} {tvec}\n")

    logs_path = f"{results}_logs.pkl"
    logger.info(f"Writing logs to {logs_path}...")
    with open(logs_path, "wb") as f:
        pickle.dump(logs, f)
    logger.info("Done!")
    return poses, logs
