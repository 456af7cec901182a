"""VisualSfM NVM v3 → COLMAP model. Counterpart of
``imcui_tpu/pipeline/colmap_from_nvm.py:1-211``: the same ``main()``
(image and camera ids from a COLMAP database, intrinsics from a text file
or, with ``intrinsics=None``, from the database's ``cameras`` table, poses
and tracks from the NVM file) writing a binary model through
``utils/read_write_model.py``, byte for byte the JAX module's. Host code
only.
"""

import sqlite3
from collections import defaultdict
from pathlib import Path

import numpy as np

from .. import logger
from ..utils.database import blob_to_array
from ..utils.geometry import qvec2rotmat
from ..utils.read_write_model import (Camera, Image, Point3D,
                                      write_model)


def recover_database_images_and_ids(database_path):
    images = {}
    cameras = {}
    db = sqlite3.connect(str(database_path))
    ret = db.execute("SELECT name, image_id, camera_id FROM images;")
    for name, image_id, camera_id in ret:
        images[name] = image_id
        cameras[name] = camera_id
    db.close()
    logger.info(
        f"Found {len(images)} images and {len(cameras)} cameras in database."
    )
    return images, cameras


def quaternion_to_rotation_matrix(qvec):
    return qvec2rotmat(qvec)


def camera_center_to_translation(c, qvec):
    R = qvec2rotmat(qvec)
    return (-1) * R @ np.asarray(c)


def read_nvm_model(nvm_path, intrinsics_path, image_ids, camera_ids,
                   skip_points=False):
    """Parse an NVM v3 file into COLMAP records, the cameras from the
    intrinsics file (one ``name MODEL width height params…`` a line)."""
    with open(intrinsics_path) as f:
        raw_intrinsics = f.readlines()
    logger.info(f"Reading {len(raw_intrinsics)} cameras...")
    cameras = {}
    for intrinsics in raw_intrinsics:
        intrinsics = intrinsics.strip("\n").split(" ")
        name, camera_model, width, height = intrinsics[:4]
        params = [float(p) for p in intrinsics[4:]]
        camera_model = camera_model.upper()
        camera_id = camera_ids[name]
        camera = Camera(
            id=camera_id, model=camera_model,
            width=int(width), height=int(height), params=np.array(params),
        )
        cameras[camera_id] = camera
    return _read_nvm_with_cameras(nvm_path, cameras, image_ids,
                                  camera_ids, skip_points=skip_points)


def _read_nvm_with_cameras(nvm_path, cameras, image_ids, camera_ids,
                           skip_points=False):
    """NVM body parse given prebuilt camera records."""
    nvm_f = open(nvm_path, "r")
    line = nvm_f.readline()
    while line == "\n" or line.startswith("NVM_V3"):
        line = nvm_f.readline()
    num_images = int(line)

    logger.info(f"Reading {num_images} images...")
    image_idx_to_db_image_id = []
    image_data = []
    for i in range(num_images):
        data = nvm_f.readline().strip("\n").split(" ")
        image_data.append(data)
        image_idx_to_db_image_id.append(image_ids[data[0]])

    line = nvm_f.readline()
    while line == "\n":
        line = nvm_f.readline()
    num_points = int(line)

    if skip_points:
        logger.info(f"Skipping {num_points} points.")
        num_points = 0
    else:
        logger.info(f"Reading {num_points} points...")
    points3D = {}
    image_idx_to_keypoints = defaultdict(list)
    i = 0
    pbar_step = max(num_points // 10, 1)
    for i in range(num_points):
        data = nvm_f.readline().strip("\n").split(" ")
        x, y, z, r, g, b, num_observations = data[:7]
        obs_image_ids, point2D_idxs = [], []
        for j in range(int(num_observations)):
            s = 7 + 4 * j
            img_index, kp_index, kx, ky = data[s: s + 4]
            image_idx_to_keypoints[int(img_index)].append(
                (int(kp_index), float(kx), float(ky), i)
            )
            db_image_id = image_idx_to_db_image_id[int(img_index)]
            obs_image_ids.append(int(db_image_id))
            point2D_idxs.append(int(kp_index))

        point = Point3D(
            id=i, xyz=np.array([x, y, z], float),
            rgb=np.array([r, g, b], int), error=1.0,
            image_ids=np.array(obs_image_ids),
            point2D_idxs=np.array(point2D_idxs),
        )
        points3D[i] = point
        if (i + 1) % pbar_step == 0:
            logger.info(f"  {i + 1}/{num_points}")
    nvm_f.close()

    logger.info("Parsing image data...")
    images = {}
    for i, data in enumerate(image_data):
        # Skip the focal length. Skip the distortion and terminal 0.
        name, _, qw, qx, qy, qz, cx, cy, cz, _, _ = data
        qvec = np.array([qw, qx, qy, qz], float)
        c = np.array([cx, cy, cz], float)
        t = camera_center_to_translation(c, qvec)

        if i in image_idx_to_keypoints:
            # NVM only stores triangulated 2D keypoints: add dummy ones
            keypoints = image_idx_to_keypoints[i]
            point2D_idxs = np.array([d[0] for d in keypoints])
            tri_xys = np.array([[x, y] for _, x, y, _ in keypoints])
            tri_ids = np.array([i for _, _, _, i in keypoints])

            num_2Dpoints = max(point2D_idxs) + 1
            xys = np.zeros((num_2Dpoints, 2), float)
            point3D_ids = np.full(num_2Dpoints, -1, int)
            xys[point2D_idxs] = tri_xys
            point3D_ids[point2D_idxs] = tri_ids
        else:
            xys = np.zeros((0, 2), float)
            point3D_ids = np.full(0, -1, int)

        image_id = image_ids[name]
        image = Image(
            id=image_id, qvec=qvec, tvec=t,
            camera_id=camera_ids[name], name=name,
            xys=xys, point3D_ids=point3D_ids,
        )
        images[image_id] = image

    return cameras, images, points3D


def cameras_from_database(database_path, camera_ids_by_name):
    """The camera records of a COLMAP database's ``cameras`` table (model
    ids 0-4 by name, any other as SIMPLE_RADIAL)."""
    db = sqlite3.connect(str(database_path))
    model_names = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL",
                   3: "RADIAL", 4: "OPENCV"}
    cameras = {}
    for cam_id, model, width, height, params in db.execute(
        "SELECT camera_id, model, width, height, params FROM cameras;"
    ):
        cameras[cam_id] = Camera(
            id=cam_id, model=model_names.get(model, "SIMPLE_RADIAL"),
            width=width, height=height,
            params=blob_to_array(params, np.float64),
        )
    db.close()
    return cameras


def main(nvm, intrinsics, database, output=None, skip_points=False):
    """Write the NVM model ``nvm`` as a binary COLMAP model to ``output``.
    ``intrinsics`` may be None: the camera parameters are then read from
    the database; called with three arguments, they are (nvm, database,
    output)."""
    if output is None:  # 3-arg call convention: (nvm, database, output)
        nvm, database, output = nvm, intrinsics, database
        intrinsics = None
    assert Path(nvm).exists(), nvm
    assert Path(database).exists(), database

    image_ids, camera_ids = recover_database_images_and_ids(database)

    logger.info("Reading the NVM model...")
    if intrinsics is not None:
        assert Path(intrinsics).exists(), intrinsics
        model = read_nvm_model(
            nvm, intrinsics, image_ids, camera_ids,
            skip_points=skip_points
        )
    else:
        cameras = cameras_from_database(database, camera_ids)
        model = _read_nvm_with_cameras(
            nvm, cameras, image_ids, camera_ids, skip_points=skip_points
        )

    logger.info("Writing the COLMAP model...")
    output = Path(output)
    output.mkdir(exist_ok=True, parents=True)
    write_model(*model, path=str(output), ext=".bin")
    logger.info("Done.")
