"""Pairs from covisibility in a COLMAP model. Counterpart of
``imcui_tpu/pipeline/pairs_from_covisibility.py:1-50``: for each image the
``num_matched`` images that see most of its 3D points, in numpy on the
host. ``np.argsort(-covis_num)`` and ``np.argpartition`` are not stable
sorts; ties come out in numpy's order, as in the JAX module (a top-k on
the device would order them otherwise).
"""

from collections import defaultdict
from pathlib import Path

import numpy as np

from .. import logger
from ..utils.read_write_model import read_model


def main(model, output, num_matched):
    """Write the pairs, one ``name covisible_name`` a line, to ``output``
    and return them."""
    logger.info("Reading the COLMAP model...")
    cameras, images, points3D = read_model(Path(model))

    logger.info("Extracting image pairs from covisibility info...")
    pairs = []
    for image_id, image in images.items():
        matched = image.point3D_ids != -1
        points3D_covis = image.point3D_ids[matched]

        covis = defaultdict(int)
        for point_id in points3D_covis:
            for image_covis_id in points3D[point_id].image_ids:
                if image_covis_id != image_id:
                    covis[image_covis_id] += 1

        if len(covis) == 0:
            logger.info(f"Image {image_id} does not have any covisibility.")
            continue

        covis_ids = np.array(list(covis.keys()))
        covis_num = np.array([covis[i] for i in covis_ids])

        if len(covis_ids) <= num_matched:
            top_covis_ids = covis_ids[np.argsort(-covis_num)]
        else:
            ind_top = np.argpartition(covis_num, -num_matched)
            ind_top = ind_top[-num_matched:]
            ind_top = ind_top[np.argsort(-covis_num[ind_top])]
            top_covis_ids = [covis_ids[i] for i in ind_top]

        for i in top_covis_ids:
            pairs.append((image.name, images[i].name))

    logger.info(f"Found {len(pairs)} pairs.")
    with open(output, "w") as f:
        f.write("\n".join(" ".join(p) for p in pairs))
    return pairs
