"""Pairs from camera poses. Counterpart of
``imcui_tpu/pipeline/pairs_from_poses.py:1-60``: the camera centres'
distances (``scipy.spatial.distance.pdist`` on the host, ``:30-31``) and
the principal axes' angles in float64 numpy, then the ``num_matched``
nearest images within ``rotation_threshold`` degrees through
``pairs_from_retrieval.pairs_from_score_matrix`` (a stable top-k on
``device``). The scores go to the device as float32, the type in which
the JAX module's top-k sees them.
"""

import numpy as np
import scipy.spatial
import torch

from .. import logger, resolve_device
from ..utils.read_write_model import read_images_binary
from .pairs_from_retrieval import pairs_from_score_matrix

DEFAULT_ROT_THRESH = 30  # degrees


def get_pairwise_distances(images):
    """(image ids, (N, N) camera-centre distances, (N, N) principal-axis
    angles in degrees)."""
    ids = np.array(list(images.keys()))
    Rs = []
    ts = []
    for id_ in ids:
        image = images[id_]
        R = image.qvec2rotmat()
        t = image.tvec
        Rs.append(R)
        ts.append(t)
    Rs = np.stack(Rs, 0)
    ts = np.stack(ts, 0)

    # camera centers: C = -R^T t
    centers = -(Rs.transpose(0, 2, 1) @ ts[:, :, None])[:, :, 0]
    dist = scipy.spatial.distance.squareform(
        scipy.spatial.distance.pdist(centers)
    )

    # principal axis = third row of R (world direction of optical axis)
    axes = Rs[:, 2]
    dots = np.einsum("mi,ni->mn", axes, axes, optimize=False)
    dR = np.rad2deg(np.arccos(np.clip(dots, -1.0, 1.0)))
    return ids, dist, dR


def main(model, output, num_matched, rotation_threshold=DEFAULT_ROT_THRESH,
         device="cuda"):
    """Write the pairs, one ``name near_name`` a line, to ``output`` and
    return them."""
    dev = resolve_device(device)
    logger.info("Reading the COLMAP model...")
    images = read_images_binary(str(model) + "/images.bin") \
        if not hasattr(model, "joinpath") else \
        read_images_binary(model / "images.bin")

    logger.info("Obtaining pairwise distances between"
                f" {len(images)} images...")
    ids, dist, dR = get_pairwise_distances(images)
    scores = -dist

    invalid = dR >= rotation_threshold
    np.fill_diagonal(invalid, True)
    pairs = pairs_from_score_matrix(
        torch.as_tensor(scores, dtype=torch.float32, device=dev),
        torch.as_tensor(invalid, device=dev), num_matched)
    pairs = [(images[ids[i]].name, images[ids[j]].name) for i, j in pairs]

    logger.info(f"Found {len(pairs)} pairs.")
    with open(output, "w") as f:
        f.write("\n".join(" ".join(p) for p in pairs))
    return pairs
