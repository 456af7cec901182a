"""COLMAP sparse models (cameras, images, points3D) in the binary and
the text format. Counterpart of ``imcui_tpu/utils/read_write_model.py:
1-337``: the same records (``Image`` with ``qvec2rotmat``, ``:29-31``), the
same ``struct`` layouts (``:51-66``) and the same writers (``:67-326``), so
that both packages write the same bytes from the same model.
"""

import collections
import struct
from pathlib import Path

import numpy as np

from .geometry import qvec2rotmat, rotmat2qvec  # noqa: F401 (re-exported)

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"]
)
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"]
)
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def _read_next_bytes(fid, num_bytes, format_char_sequence, endian="<"):
    data = fid.read(num_bytes)
    return struct.unpack(endian + format_char_sequence, data)


def _write_next_bytes(fid, data, format_char_sequence, endian="<"):
    if isinstance(data, (list, tuple, np.ndarray)):
        fid.write(struct.pack(endian + format_char_sequence, *data))
    else:
        fid.write(struct.pack(endian + format_char_sequence, data))


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def read_cameras_text(path):
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if len(line) == 0 or line[0] == "#":
                continue
            elems = line.split()
            camera_id = int(elems[0])
            cameras[camera_id] = Camera(
                id=camera_id, model=elems[1], width=int(elems[2]),
                height=int(elems[3]),
                params=np.array(tuple(map(float, elems[4:]))),
            )
    return cameras


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as fid:
        num_cameras = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_cameras):
            props = _read_next_bytes(fid, 24, "iiQQ")
            camera_id, model_id = props[0], props[1]
            model = CAMERA_MODEL_IDS[model_id]
            params = _read_next_bytes(
                fid, 8 * model.num_params, "d" * model.num_params
            )
            cameras[camera_id] = Camera(
                id=camera_id, model=model.model_name, width=props[2],
                height=props[3], params=np.array(params),
            )
    return cameras


def write_cameras_text(cameras, path):
    with open(path, "w") as fid:
        fid.write(
            "# Camera list with one line of data per camera:\n"
            "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
            f"# Number of cameras: {len(cameras)}\n"
        )
        for cam in cameras.values():
            params = " ".join(map(str, cam.params))
            fid.write(f"{cam.id} {cam.model} {cam.width} {cam.height}"
                      f" {params}\n")


def write_cameras_binary(cameras, path):
    with open(path, "wb") as fid:
        _write_next_bytes(fid, len(cameras), "Q")
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            _write_next_bytes(
                fid, [cam.id, model.model_id, cam.width, cam.height], "iiQQ"
            )
            _write_next_bytes(fid, np.asarray(cam.params, np.float64),
                              "d" * model.num_params)


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def read_images_text(path):
    images = {}
    with open(path) as fid:
        lines = [ln.strip() for ln in fid
                 if ln.strip() and not ln.startswith("#")]
    for header, points in zip(lines[0::2], lines[1::2]):
        elems = header.split()
        image_id = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pelems = points.split()
        xys = np.column_stack(
            [tuple(map(float, pelems[0::3])),
             tuple(map(float, pelems[1::3]))]
        ) if pelems else np.zeros((0, 2))
        point3D_ids = np.array(tuple(map(int, pelems[2::3]))) if pelems \
            else np.zeros((0,), int)
        images[image_id] = Image(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
            name=name, xys=xys, point3D_ids=point3D_ids,
        )
    return images


def read_images_binary(path):
    images = {}
    with open(path, "rb") as fid:
        num_images = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_images):
            props = _read_next_bytes(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            char = fid.read(1)
            while char != b"\x00":
                name += char
                char = fid.read(1)
            num_points = _read_next_bytes(fid, 8, "Q")[0]
            data = _read_next_bytes(fid, 24 * num_points,
                                    "ddq" * num_points)
            xys = np.column_stack(
                [tuple(map(float, data[0::3])),
                 tuple(map(float, data[1::3]))]
            ) if num_points else np.zeros((0, 2))
            point3D_ids = np.array(tuple(map(int, data[2::3]))) \
                if num_points else np.zeros((0,), int)
            images[image_id] = Image(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode("utf-8"), xys=xys, point3D_ids=point3D_ids,
            )
    return images


def write_images_text(images, path):
    mean_obs = (
        sum(len(img.point3D_ids) for img in images.values()) / len(images)
        if images else 0
    )
    with open(path, "w") as fid:
        fid.write(
            "# Image list with two lines of data per image:\n"
            "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
            "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
            f"# Number of images: {len(images)}, mean observations per "
            f"image: {mean_obs}\n"
        )
        for img in images.values():
            header = [img.id, *img.qvec, *img.tvec, img.camera_id, img.name]
            fid.write(" ".join(map(str, header)) + "\n")
            points = []
            for xy, pid in zip(img.xys, img.point3D_ids):
                points.append(" ".join(map(str, [*xy, pid])))
            fid.write(" ".join(points) + "\n")


def write_images_binary(images, path):
    with open(path, "wb") as fid:
        _write_next_bytes(fid, len(images), "Q")
        for img in images.values():
            _write_next_bytes(fid, img.id, "i")
            _write_next_bytes(fid, img.qvec.tolist(), "dddd")
            _write_next_bytes(fid, img.tvec.tolist(), "ddd")
            _write_next_bytes(fid, img.camera_id, "i")
            fid.write(img.name.encode("utf-8") + b"\x00")
            _write_next_bytes(fid, len(img.point3D_ids), "Q")
            for xy, pid in zip(img.xys, img.point3D_ids):
                _write_next_bytes(fid, [*xy, pid], "ddq")


# ---------------------------------------------------------------------------
# points3D
# ---------------------------------------------------------------------------

def read_points3D_text(path):
    points3D = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if len(line) == 0 or line[0] == "#":
                continue
            elems = line.split()
            point3D_id = int(elems[0])
            xyz = np.array(tuple(map(float, elems[1:4])))
            rgb = np.array(tuple(map(int, elems[4:7])))
            error = float(elems[7])
            image_ids = np.array(tuple(map(int, elems[8::2])))
            point2D_idxs = np.array(tuple(map(int, elems[9::2])))
            points3D[point3D_id] = Point3D(
                id=point3D_id, xyz=xyz, rgb=rgb, error=error,
                image_ids=image_ids, point2D_idxs=point2D_idxs,
            )
    return points3D


def read_points3D_binary(path):
    points3D = {}
    with open(path, "rb") as fid:
        num_points = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_points):
            props = _read_next_bytes(fid, 43, "QdddBBBd")
            point3D_id = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            error = np.array(props[7])
            track_length = _read_next_bytes(fid, 8, "Q")[0]
            track = _read_next_bytes(fid, 8 * track_length,
                                     "ii" * track_length)
            points3D[point3D_id] = Point3D(
                id=point3D_id, xyz=xyz, rgb=rgb, error=error,
                image_ids=np.array(tuple(map(int, track[0::2]))),
                point2D_idxs=np.array(tuple(map(int, track[1::2]))),
            )
    return points3D


def write_points3D_text(points3D, path):
    mean_track = (
        sum(len(pt.image_ids) for pt in points3D.values()) / len(points3D)
        if points3D else 0
    )
    with open(path, "w") as fid:
        fid.write(
            "# 3D point list with one line of data per point:\n"
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
            f"# Number of points: {len(points3D)}, mean track length: "
            f"{mean_track}\n"
        )
        for pt in points3D.values():
            track = " ".join(
                map(str, np.column_stack(
                    [pt.image_ids, pt.point2D_idxs]).flatten())
            )
            fid.write(
                " ".join(map(str, [pt.id, *pt.xyz, *pt.rgb, pt.error]))
                + " " + track + "\n"
            )


def write_points3D_binary(points3D, path):
    with open(path, "wb") as fid:
        _write_next_bytes(fid, len(points3D), "Q")
        for pt in points3D.values():
            _write_next_bytes(fid, pt.id, "Q")
            _write_next_bytes(fid, pt.xyz.tolist(), "ddd")
            _write_next_bytes(fid, pt.rgb.tolist(), "BBB")
            _write_next_bytes(fid, pt.error, "d")
            _write_next_bytes(fid, len(pt.image_ids), "Q")
            for iid, p2d in zip(pt.image_ids, pt.point2D_idxs):
                _write_next_bytes(fid, [iid, p2d], "ii")


# ---------------------------------------------------------------------------
# model-level
# ---------------------------------------------------------------------------

def read_model(path, ext=None):
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".txt":
        cameras = read_cameras_text(path / "cameras.txt")
        images = read_images_text(path / "images.txt")
        points3D = read_points3D_text(path / "points3D.txt")
    else:
        cameras = read_cameras_binary(path / "cameras.bin")
        images = read_images_binary(path / "images.bin")
        points3D = read_points3D_binary(path / "points3D.bin")
    return cameras, images, points3D


def write_model(cameras, images, points3D, path, ext=".bin"):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".txt":
        write_cameras_text(cameras, path / "cameras.txt")
        write_images_text(images, path / "images.txt")
        write_points3D_text(points3D, path / "points3D.txt")
    else:
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3D_binary(points3D, path / "points3D.bin")
    return cameras, images, points3D
