"""Verification and triangulation against a model of known poses.
Counterpart of ``imcui_tpu/pipeline/triangulation.py:1-184``: the same
``main()`` stages (a database holding the reference model's cameras and
images, keypoints and matches from the files, the epipolar gate of every
match against the known poses, then point triangulation).

The gate (``:86-138``) is host float64 numpy on ``utils/geometry.py``, as
in the JAX module, so no stage touches a device. Triangulation needs
``pycolmap``: without it ``run_triangulation`` raises the JAX module's
``ImportError`` once the database is written (``:140-146``).
"""

from pathlib import Path

import numpy as np

from .. import logger
from ..utils.database import COLMAPDatabase, image_ids_to_pair_id
from ..utils.geometry import (compute_epipolar_errors, qvec2rotmat,
                              relative_pose)
from ..utils.io import get_keypoints
from ..utils.parsers_compat import parse_pairs_file
from ..utils.read_write_model import read_model
from .reconstruction import import_features, import_matches  # noqa: F401

try:
    import pycolmap
except ImportError:  # the triangulator's backend, optional
    pycolmap = None


def create_db_from_model(reference_dir, database_path):
    """A new database at ``database_path`` holding the cameras and images
    of the model at ``reference_dir`` under their ids; {name: image id}."""
    cameras, images, _ = read_model(reference_dir)
    if database_path.exists():
        logger.warning("The database already exists, deleting it.")
        database_path.unlink()
    db = COLMAPDatabase.connect(database_path)
    db.create_tables()
    model_name_to_id = {
        "SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3,
        "OPENCV": 4, "OPENCV_FISHEYE": 5, "FULL_OPENCV": 6, "FOV": 7,
        "SIMPLE_RADIAL_FISHEYE": 8, "RADIAL_FISHEYE": 9,
        "THIN_PRISM_FISHEYE": 10,
    }
    for camera_id, camera in cameras.items():
        db.add_camera(
            model_name_to_id[camera.model], camera.width, camera.height,
            camera.params, camera_id=camera_id, prior_focal_length=True,
        )
    for image_id, image in images.items():
        db.add_image(image.name, image.camera_id, image_id=image_id)
    db.commit()
    db.close()
    return {image.name: i for i, image in images.items()}


def camera_K(camera):
    """Intrinsics matrix from a COLMAP camera record."""
    p = camera.params
    if camera.model == "SIMPLE_PINHOLE" or camera.model == "SIMPLE_RADIAL":
        f, cx, cy = p[0], p[1], p[2]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
    if camera.model in ("PINHOLE", "OPENCV", "FULL_OPENCV",
                        "OPENCV_FISHEYE"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    if camera.model in ("RADIAL", "RADIAL_FISHEYE", "FOV"):
        f, cx, cy = p[0], p[1], p[2]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
    raise ValueError(f"Unsupported camera model {camera.model}")


def geometric_verification(image_ids, reference, database_path, features_path,
                           pairs_path, max_error=4.0):
    """Keep the matches whose point-to-epipolar-line distances under the
    known relative pose are both at most ``max_error`` px (config 3)."""
    logger.info("Performing geometric verification of the matches...")
    cameras, images, _ = read_model(reference)
    name_to_image = {image.name: image for image in images.values()}

    pairs = parse_pairs_file(pairs_path)
    db = COLMAPDatabase.connect(database_path)
    inlier_ratios = []
    matched = set()
    for name0, name1 in pairs:
        id0, id1 = image_ids[name0], image_ids[name1]
        image0, image1 = name_to_image[name0], name_to_image[name1]
        if len({(id0, id1), (id1, id0)} & matched) > 0:
            continue
        matched |= {(id0, id1), (id1, id0)}

        cam0 = cameras[image0.camera_id]
        cam1 = cameras[image1.camera_id]
        R0, t0 = qvec2rotmat(image0.qvec), image0.tvec
        R1, t1 = qvec2rotmat(image1.qvec), image1.tvec
        R, t = relative_pose(R0, t0, R1, t1)

        row = db.execute(
            "SELECT data, rows FROM matches WHERE pair_id=?;",
            (image_ids_to_pair_id(id0, id1),),
        ).fetchone()
        if row is None or row[1] == 0:
            db.add_two_view_geometry(id0, id1, np.zeros((0, 2), np.uint32))
            continue
        m = np.frombuffer(row[0], np.uint32).reshape(-1, 2)
        if id0 > id1:
            m = m[:, ::-1]
        kp0 = get_keypoints(features_path, name0)[m[:, 0]]
        kp1 = get_keypoints(features_path, name1)[m[:, 1]]
        errors0, errors1 = compute_epipolar_errors(
            R, t, camera_K(cam0), camera_K(cam1), kp0, kp1
        )
        valid = np.logical_and(errors0 <= max_error, errors1 <= max_error)
        db.add_two_view_geometry(id0, id1, m[valid].astype(np.uint32),
                                 config=3)
        inlier_ratios.append(np.mean(valid) if len(valid) else 0.0)
    if inlier_ratios:
        logger.info(
            "mean/med/min/max valid matches %.2f/%.2f/%.2f/%.2f%%.",
            np.mean(inlier_ratios) * 100, np.median(inlier_ratios) * 100,
            np.min(inlier_ratios) * 100, np.max(inlier_ratios) * 100,
        )
    db.commit()
    db.close()


def run_triangulation(model_path, database_path, image_dir, reference_model):
    if pycolmap is None:
        raise ImportError(
            "Point triangulation requires pycolmap; the database with "
            f"verified matches is ready at {database_path}."
        )
    model_path.mkdir(parents=True, exist_ok=True)
    logger.info("Running 3D triangulation...")
    reference = pycolmap.Reconstruction(reference_model)
    with pycolmap.ostream():
        reconstruction = pycolmap.triangulate_points(
            reference, database_path, image_dir, model_path
        )
    return reconstruction


def main(sfm_dir, reference_model, image_dir, pairs, features, matches,
         skip_geometric_verification=False, min_match_score=None,
         verbose=False):
    """The database at ``sfm_dir/database.db``, verified against
    ``reference_model``'s poses, then the triangulator."""
    assert Path(reference_model).exists(), reference_model
    assert Path(features).exists(), features
    assert Path(pairs).exists(), pairs
    assert Path(matches).exists(), matches

    sfm_dir = Path(sfm_dir)
    sfm_dir.mkdir(parents=True, exist_ok=True)
    database = sfm_dir / "database.db"
    reference_model = Path(reference_model)

    image_ids = create_db_from_model(reference_model, database)
    import_features(image_ids, database, features)
    import_matches(image_ids, database, pairs, matches, min_match_score,
                   skip_geometric_verification)
    if not skip_geometric_verification:
        geometric_verification(
            image_ids, reference_model, database, features, pairs
        )
    reconstruction = run_triangulation(sfm_dir, database, image_dir,
                                       reference_model)
    logger.info(
        "Finished the triangulation with statistics:\n%s",
        reconstruction.summary(),
    )
    return reconstruction
