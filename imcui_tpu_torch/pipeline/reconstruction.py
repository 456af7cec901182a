"""Structure from motion up to two-view verification. Counterpart of
``imcui_tpu/pipeline/reconstruction.py:1-253``: the same ``main()`` and
stages (an empty COLMAP database, the images, keypoints and matches
imported from the feature and match files, two-view geometric
verification, then the incremental mapper and the largest model).

Two-view verification runs on ``device`` through this package's RANSAC
(``ops/ransac.py::ransac``: fundamental matrix, 1024 hypotheses, 4.0 px),
one pair at a time on ``max(64, 2**ceil(log2 n))`` padded slots so that the
card sees few shapes (``:122-173``). The JAX module draws pair ``i``'s
hypotheses from ``jax.random.PRNGKey(i)``; here a ``torch.Generator`` on
the device is seeded with the same ``i``, so the draws differ and only a
scene whose inlier set is unique gives both packages the same verified
matches. The mapper needs ``pycolmap``: without it ``run_reconstruction``
raises the JAX module's ``ImportError`` once the database is written.

``import_images`` reads image sizes with ``utils/image.py::image_size``
where the JAX module decodes each image with ``cv2.imread``: a JPEG's
size comes from its frame header, swapped for EXIF orientations 5-8 as
``cv2.imread`` turns the image. Found in the JAX module and kept:
``geometric_verification`` stores the F it estimated from ``name0`` to
``name1`` while ``add_two_view_geometry`` flips the matches of a pair with
``id0 > id1`` into ``(id1, id0)`` order without transposing F.
"""

import shutil
from pathlib import Path

import numpy as np
import torch

from .. import logger, resolve_device
from ..ops import ransac as ransac_ops
from ..utils.database import COLMAPDatabase, image_ids_to_pair_id
from ..utils.image import image_size
from ..utils.io import get_keypoints, get_matches
from ..utils.parsers_compat import parse_pairs_file
from .extract_features import list_images

try:
    import pycolmap
except ImportError:  # the mapper's backend, optional
    pycolmap = None

RANSAC_HYPOTHESES = 1024


def create_empty_db(database_path):
    if Path(database_path).exists():
        logger.warning("The database already exists, deleting it.")
        Path(database_path).unlink()
    logger.info("Creating an empty database...")
    db = COLMAPDatabase.connect(database_path)
    db.create_tables()
    db.commit()
    db.close()


def import_images(image_dir, database_path, camera_mode="AUTO",
                  image_list=None, options=None):
    """Register the images with one SIMPLE_RADIAL camera, ``[1.2·max(w,
    h), w/2, h/2, 0]``, per image size (or one for all when
    ``camera_mode`` is ``"SINGLE"``); through ``pycolmap.import_images``
    where pycolmap is installed."""
    logger.info("Importing images into the database...")
    if pycolmap is not None:
        if options is None:
            options = {}
        with pycolmap.ostream():
            pycolmap.import_images(
                database_path, image_dir, camera_mode,
                image_list=image_list or [], options=options,
            )
        return
    names = image_list or list_images(image_dir)
    db = COLMAPDatabase.connect(database_path)
    cameras = {}
    for name in names:
        w, h = image_size(Path(image_dir) / name)
        key = (w, h)
        if camera_mode == "SINGLE":
            key = "single"
        if key not in cameras:
            f = 1.2 * max(w, h)
            cameras[key] = db.add_camera(
                2, w, h, np.array([f, w / 2.0, h / 2.0, 0.0])
            )  # SIMPLE_RADIAL
        db.add_image(name, cameras[key])
    db.commit()
    db.close()


def get_image_ids(database_path):
    db = COLMAPDatabase.connect(database_path)
    images = {}
    for name, image_id in db.execute("SELECT name, image_id FROM images;"):
        images[name] = image_id
    db.close()
    return images


def import_features(image_ids, database_path, features_path):
    logger.info("Importing features into the database...")
    db = COLMAPDatabase.connect(database_path)
    for image_name, image_id in image_ids.items():
        keypoints = get_keypoints(features_path, image_name)
        keypoints += 0.5  # COLMAP origin convention
        db.add_keypoints(image_id, keypoints)
    db.commit()
    db.close()


def import_matches(image_ids, database_path, pairs_path, matches_path,
                   min_match_score=None, skip_geometric_verification=False):
    logger.info("Importing matches into the database...")
    pairs = parse_pairs_file(pairs_path)
    db = COLMAPDatabase.connect(database_path)
    matched = set()
    for name0, name1 in pairs:
        id0, id1 = image_ids[name0], image_ids[name1]
        if len({(id0, id1), (id1, id0)} & matched) > 0:
            continue
        matches, scores = get_matches(matches_path, name0, name1)
        if min_match_score:
            matches = matches[scores > min_match_score]
        db.add_matches(id0, id1, matches)
        matched |= {(id0, id1), (id1, id0)}
        if skip_geometric_verification:
            db.add_two_view_geometry(id0, id1, matches)
    db.commit()
    db.close()


def pad_slots(n):
    """Padded correspondence slots of a pair of ``n`` matches."""
    return max(64, int(2 ** np.ceil(np.log2(n))))


def geometric_verification(image_ids, database_path, pairs_path,
                           features_path, threshold=4.0, device="cuda"):
    """Each pair's matches through the fundamental-matrix RANSAC on
    ``device``; the inliers and F go into ``two_view_geometries`` (config
    3), a pair of fewer than 8 matches gets no matches."""
    dev = resolve_device(device)
    logger.info("Performing on-device geometric verification of matches...")
    pairs = parse_pairs_file(pairs_path)
    db = COLMAPDatabase.connect(database_path)
    done = set()
    for i, (name0, name1) in enumerate(pairs):
        id0, id1 = image_ids[name0], image_ids[name1]
        pid = image_ids_to_pair_id(id0, id1)
        if pid in done:
            continue
        done.add(pid)
        row = db.execute(
            "SELECT data, rows FROM matches WHERE pair_id=?;", (pid,)
        ).fetchone()
        if row is None or row[1] == 0:
            db.add_two_view_geometry(id0, id1, np.zeros((0, 2), np.uint32))
            continue
        matches = np.frombuffer(row[0], np.uint32).reshape(-1, 2)
        if id0 > id1:  # stored flipped
            matches = matches[:, ::-1]
        kp0 = get_keypoints(features_path, name0)[matches[:, 0]]
        kp1 = get_keypoints(features_path, name1)[matches[:, 1]]
        n = len(kp0)
        if n < 8:
            db.add_two_view_geometry(id0, id1, np.zeros((0, 2), np.uint32))
            continue
        n_pad = pad_slots(n)
        p0 = np.zeros((1, n_pad, 2), np.float32)
        p1 = np.zeros((1, n_pad, 2), np.float32)
        m = np.zeros((1, n_pad), bool)
        p0[0, :n], p1[0, :n], m[0, :n] = kp0, kp1, True
        gen = torch.Generator(device=dev).manual_seed(i)
        out = ransac_ops.ransac(
            p0, p1, m, gen, model="fundamental", threshold=threshold,
            num_hypotheses=RANSAC_HYPOTHESES, device=dev,
        )
        inl = out["inliers"][0, :n].cpu().numpy()
        F = out["M"][0].double().cpu().numpy()
        db.add_two_view_geometry(
            id0, id1, matches[inl].astype(np.uint32), F=F, config=3,
        )
    db.commit()
    db.close()


def run_reconstruction(sfm_dir, database_path, image_dir, verbose=False,
                       options=None):
    """Incremental mapping with pycolmap; the largest model's files are
    moved into ``sfm_dir``. Raises ``ImportError`` without pycolmap."""
    if pycolmap is None:
        raise ImportError(
            "Incremental mapping requires pycolmap (or COLMAP). The "
            "database with verified two-view geometries has been written "
            f"to {database_path}; run COLMAP's mapper on it externally."
        )
    models_path = Path(sfm_dir) / "models"
    models_path.mkdir(exist_ok=True, parents=True)
    logger.info("Running 3D reconstruction...")
    if options is None:
        options = {}
    with pycolmap.ostream():
        reconstructions = pycolmap.incremental_mapping(
            database_path, image_dir, models_path, options=options
        )
    if len(reconstructions) == 0:
        logger.error("Could not reconstruct any model!")
        return None
    logger.info(f"Reconstructed {len(reconstructions)} model(s).")
    largest_index = None
    largest_num_images = 0
    for index, rec in reconstructions.items():
        num_images = rec.num_reg_images()
        if num_images > largest_num_images:
            largest_index = index
            largest_num_images = num_images
    assert largest_index is not None
    logger.info(
        f"Largest model is #{largest_index} with "
        f"{largest_num_images} images."
    )
    for filename in ["images.bin", "cameras.bin", "points3D.bin"]:
        if (sfm_dir / filename).exists():
            (sfm_dir / filename).unlink()
        shutil.move(
            str(models_path / str(largest_index) / filename),
            str(sfm_dir),
        )
    return reconstructions[largest_index]


def main(sfm_dir, image_dir, pairs, features, matches,
         camera_mode="AUTO", verbose=False, skip_geometric_verification=False,
         min_match_score=None, image_list=None, image_options=None,
         mapper_options=None, device="cuda"):
    """The database at ``sfm_dir/database.db``, verified on ``device``,
    then the mapper."""
    assert Path(features).exists(), features
    assert Path(pairs).exists(), pairs
    assert Path(matches).exists(), matches
    resolve_device(device)

    sfm_dir = Path(sfm_dir)
    sfm_dir.mkdir(parents=True, exist_ok=True)
    database = sfm_dir / "database.db"

    create_empty_db(database)
    import_images(image_dir, database, camera_mode, image_list,
                  image_options)
    image_ids = get_image_ids(database)
    import_features(image_ids, database, features)
    import_matches(image_ids, database, pairs, matches, min_match_score,
                   skip_geometric_verification)
    if not skip_geometric_verification:
        geometric_verification(image_ids, database, pairs, features,
                               device=device)
    reconstruction = run_reconstruction(
        sfm_dir, database, image_dir, verbose, mapper_options
    )
    if reconstruction is not None:
        logger.info(
            f"Reconstruction statistics:\n{reconstruction.summary()}"
            + f"\n\tnum_input_images = {len(image_ids)}"
        )
    return reconstruction
