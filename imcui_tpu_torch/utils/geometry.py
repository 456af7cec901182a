"""Two-view geometry and COLMAP quaternions on the host. Counterpart of
``imcui_tpu/utils/geometry.py:1-83``: the same functions in float64 numpy,
as the JAX module computes them (poses are plain (R: 3×3, t: 3) arrays,
not ``pycolmap.Rigid3d``).
"""

import numpy as np


def to_homogeneous(p):
    return np.pad(p, ((0, 0),) * (p.ndim - 1) + ((0, 1),),
                  constant_values=1)


def skew(t):
    return np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]
    )


def essential_from_pose(R, t):
    """E = [t]× R for the relative pose taking points cam0 → cam1."""
    return skew(np.asarray(t)) @ np.asarray(R)


def fundamental_from_pose(R, t, K0, K1):
    E = essential_from_pose(R, t)
    return np.linalg.inv(np.asarray(K1)).T @ E @ np.linalg.inv(np.asarray(K0))


def relative_pose(R0, t0, R1, t1):
    """cam0←world, cam1←world → cam1←cam0."""
    R = np.asarray(R1) @ np.asarray(R0).T
    t = np.asarray(t1) - R @ np.asarray(t0)
    return R, t


def compute_epipolar_errors(R, t, K0, K1, p0, p1):
    """Point-to-epipolar-line distances (px) both ways: of p0 to the lines
    of p1 in image 0, and of p1 to the lines of p0 in image 1."""
    F = fundamental_from_pose(R, t, K0, K1)
    p0h = to_homogeneous(np.asarray(p0, float))
    p1h = to_homogeneous(np.asarray(p1, float))
    l1 = p0h @ F.T  # epipolar lines in image 1
    l0 = p1h @ F
    errors0 = np.abs(np.sum(p0h * l0, -1)) / np.linalg.norm(l0[:, :2], axis=-1)
    errors1 = np.abs(np.sum(p1h * l1, -1)) / np.linalg.norm(l1[:, :2], axis=-1)
    return errors0, errors1


def qvec2rotmat(qvec):
    """COLMAP (w, x, y, z) quaternion → rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w,
             2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2,
             2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
             1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R):
    """Rotation matrix → COLMAP (w, x, y, z) quaternion, w ≥ 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array(
        [
            [Rxx - Ryy - Rzz, 0, 0, 0],
            [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
            [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
            [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
        ]
    ) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec
