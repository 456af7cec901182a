"""The port's SfM file layers against the JAX package on the CPU:
``utils/geometry.py``, ``utils/read_write_model.py``, ``utils/database.py``
and the pair generators on COLMAP models (``pairs_from_covisibility``,
``pairs_from_poses``, ``pairs_from_retrieval(db_model=)``).

Tolerances: geometry within rtol 1e-12 (float64 numpy on both sides);
model files equal byte for byte; database schema SQL and rows equal;
pair lists equal in order.
"""

import sqlite3

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.pipeline import pairs_from_covisibility as jcovis
from imcui_tpu.pipeline import pairs_from_poses as jposes
from imcui_tpu.pipeline import pairs_from_retrieval as jret
from imcui_tpu.utils import database as jdb
from imcui_tpu.utils import geometry as jgeo
from imcui_tpu.utils import read_write_model as jrwm
from imcui_tpu_torch.pipeline import pairs_from_covisibility as tcovis
from imcui_tpu_torch.pipeline import pairs_from_poses as tposes
from imcui_tpu_torch.pipeline import pairs_from_retrieval as tret
from imcui_tpu_torch.utils import database as tdb
from imcui_tpu_torch.utils import geometry as tgeo
from imcui_tpu_torch.utils import read_write_model as trwm

GEO_RTOL = 1e-12
MATCHES = np.stack([np.arange(20),
                    np.random.default_rng(8).permutation(30)[:20]], 1)
TABLES = ("cameras", "images", "keypoints", "descriptors", "matches",
          "two_view_geometries")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return jgeo.qvec2rotmat(q)


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    K0 = np.array([[700.0, 0, 320], [0, 710.0, 240], [0, 0, 1]])
    K1 = np.array([[820.0, 0, 300], [0, 800.0, 250], [0, 0, 1]])
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(tgeo.qvec2rotmat(q), jgeo.qvec2rotmat(q),
                                   rtol=GEO_RTOL)
        R = jgeo.qvec2rotmat(q)
        got, want = tgeo.rotmat2qvec(R), jgeo.rotmat2qvec(R)
        np.testing.assert_allclose(got, want, rtol=GEO_RTOL, atol=1e-15)
        assert got[0] >= 0
        R0, R1 = _rotation(rng), _rotation(rng)
        t0, t1 = rng.normal(size=3), rng.normal(size=3)
        for g, w in zip(tgeo.relative_pose(R0, t0, R1, t1),
                        jgeo.relative_pose(R0, t0, R1, t1)):
            np.testing.assert_allclose(g, w, rtol=GEO_RTOL)
        R, t = jgeo.relative_pose(R0, t0, R1, t1)
        np.testing.assert_allclose(tgeo.fundamental_from_pose(R, t, K0, K1),
                                   jgeo.fundamental_from_pose(R, t, K0, K1),
                                   rtol=GEO_RTOL)
        p0 = rng.uniform(0, 640, (50, 2))
        p1 = rng.uniform(0, 480, (50, 2))
        for g, w in zip(tgeo.compute_epipolar_errors(R, t, K0, K1, p0, p1),
                        jgeo.compute_epipolar_errors(R, t, K0, K1, p0, p1)):
            np.testing.assert_allclose(g, w, rtol=GEO_RTOL)
    h = rng.normal(size=(7, 3, 2))
    np.testing.assert_array_equal(tgeo.to_homogeneous(h),
                                  jgeo.to_homogeneous(h))


def _scene_model():
    """A planted model (chip_smoke.sfm_scene) with a second camera model,
    an image with no points and a point seen once."""
    s = chip_smoke.sfm_scene(11, 4, 40, 0.25)
    cams = dict(s["cameras"])
    cams[2] = trwm.Camera(id=2, model="SIMPLE_RADIAL", width=1600,
                          height=1200, params=np.array([1920.0, 800.0,
                                                        600.0, 0.0]))
    images = dict(s["images"])
    images[9] = trwm.Image(id=9, qvec=np.array([1.0, 0, 0, 0]),
                           tvec=np.zeros(3), camera_id=2, name="empty.png",
                           xys=np.zeros((0, 2)),
                           point3D_ids=np.zeros((0,), int))
    pts = dict(s["points3D"])
    pts[1000] = trwm.Point3D(id=1000, xyz=np.array([0.1, 0.2, 5.0]),
                             rgb=np.array([1, 2, 3]), error=1.25,
                             image_ids=np.array([1]),
                             point2D_idxs=np.array([0]))
    return cams, images, pts


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_write_model_bytes_equal_and_read_both_ways(tmp_path, ext):
    cams, images, pts = _scene_model()
    trwm.write_model(cams, images, pts, tmp_path / "port", ext=ext)
    jrwm.write_model(cams, images, pts, tmp_path / "jax", ext=ext)
    for stem in ("cameras", "images", "points3D"):
        got = (tmp_path / "port" / f"{stem}{ext}").read_bytes()
        assert got == (tmp_path / "jax" / f"{stem}{ext}").read_bytes(), stem
        assert len(got) > 0
    tc, ti, tp = trwm.read_model(tmp_path / "jax")
    jc, ji, jp = jrwm.read_model(tmp_path / "port")
    assert list(tc) == list(jc) == list(cams)
    # found in the JAX reader and kept: the text reader drops blank lines,
    # so an image without points (its points line is blank) is lost, and
    # the next image's header would be read as its points
    kept = [k for k in images if ext == ".bin" or len(images[k].xys)]
    assert list(ti) == list(ji) == kept == list(images)[:len(kept)]
    assert list(tp) == list(jp) == list(pts)
    for k in cams:
        assert (tc[k].model, tc[k].width, tc[k].height) == \
            (jc[k].model, jc[k].width, jc[k].height)
        np.testing.assert_array_equal(tc[k].params, jc[k].params)
    for k in kept:
        a, b = ti[k], ji[k]
        assert isinstance(a, trwm.Image) and isinstance(b, jrwm.Image)
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.qvec2rotmat(), b.qvec2rotmat())
    for k in pts:
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(tp[k], f),
                                          getattr(jp[k], f))
        assert float(tp[k].error) == float(jp[k].error)
    if ext == ".bin":
        # found in the JAX reader and kept: a binary point's error comes
        # back as a 0-d array, which the binary writer cannot pack, so a
        # model read from .bin is not written back as it is
        for mod, model in ((trwm, (tc, ti, tp)), (jrwm, (jc, ji, jp))):
            assert isinstance(model[2][0].error, np.ndarray)
            with pytest.raises(TypeError, match="0-d"):
                mod.write_model(*model, tmp_path / "again", ext=ext)
        tp = {k: p._replace(error=float(p.error)) for k, p in tp.items()}
        trwm.write_model(tc, ti, tp, tmp_path / "again", ext=ext)
        for stem in ("cameras", "images", "points3D"):
            assert (tmp_path / "again" / f"{stem}{ext}").read_bytes() == \
                (tmp_path / "jax" / f"{stem}{ext}").read_bytes()


def _fill(mod, path):
    """The same inserts through one package's COLMAPDatabase; pair (3, 1)
    is given with the larger id first."""
    rng = np.random.default_rng(5)
    db = mod.COLMAPDatabase.connect(path)
    db.create_tables()
    c1 = db.add_camera(2, 640, 480, np.array([768.0, 320, 240, 0.0]))
    c2 = db.add_camera(1, 1600, 1200, [1500.0, 1510.0, 800.5, 600.25],
                       prior_focal_length=True, camera_id=7)
    ids = [db.add_image("a.png", c1),
           db.add_image("b.png", c2, prior_q=(1.0, 0.0, 0.0, 0.0),
                        prior_t=(0.5, 0.25, -1.0)),
           db.add_image("c.png", c1, image_id=5)]
    for i, width in zip(ids, (2, 4, 6)):
        db.add_keypoints(i, rng.uniform(0, 640, (30, width)))
        db.add_descriptors(i, rng.integers(0, 255, (30, 128)))
    m = MATCHES
    db.add_matches(ids[0], ids[1], m)
    db.add_matches(ids[2], ids[0], m[:12])
    db.add_two_view_geometry(ids[0], ids[1], m[:15])
    db.add_two_view_geometry(ids[2], ids[0], m[:9],
                             F=rng.normal(size=(3, 3)),
                             E=rng.normal(size=(3, 3)),
                             H=rng.normal(size=(3, 3)),
                             qvec=[0.5, 0.5, 0.5, 0.5],
                             tvec=[1.0, 2.0, 3.0], config=3)
    db.commit()
    db.close()
    return ids


def _rows(path):
    db = sqlite3.connect(str(path))
    out = {t: db.execute(f"SELECT * FROM {t}").fetchall() for t in TABLES}
    out["schema"] = db.execute(
        "SELECT type, name, tbl_name, sql FROM sqlite_master "
        "ORDER BY name").fetchall()
    db.close()
    return out


def test_database_schema_and_rows_equal(tmp_path):
    assert tdb.CREATE_ALL == jdb.CREATE_ALL
    ids = _fill(tdb, tmp_path / "port.db")
    assert ids == _fill(jdb, tmp_path / "jax.db") == [1, 2, 5]
    got, want = _rows(tmp_path / "port.db"), _rows(tmp_path / "jax.db")
    assert got == want
    assert len(got["schema"]) >= 7 and len(got["two_view_geometries"]) == 2
    # the flipped pair: stored under (1, 5) with the columns swapped
    pid = tdb.image_ids_to_pair_id(5, 1)
    assert pid == jdb.image_ids_to_pair_id(1, 5) == 2**31 - 1 + 5
    assert tdb.pair_id_to_image_ids(pid) == jdb.pair_id_to_image_ids(pid) \
        == (1, 5)
    for mod, path in ((tdb, tmp_path / "jax.db"), (jdb, tmp_path / "port.db")):
        db = mod.COLMAPDatabase.connect(path)
        data, = db.execute("SELECT data FROM matches WHERE pair_id=?",
                           (pid,)).fetchone()
        m = mod.blob_to_array(data, np.uint32, (-1, 2))
        kp, = db.execute("SELECT data FROM keypoints WHERE image_id=2"
                         ).fetchone()
        assert mod.blob_to_array(kp, np.float32, (-1, 4)).shape == (30, 4)
        db.close()
        np.testing.assert_array_equal(m, MATCHES[:12, ::-1])
    for a, b in ((1, 2), (7, 3), (2**31 - 2, 4)):
        assert tdb.image_ids_to_pair_id(a, b) == jdb.image_ids_to_pair_id(
            a, b)


def _covis_model(seed=3, n_images=7, n_points=120):
    """Images seeing random subsets of the points (ties in the counts)."""
    rng = np.random.default_rng(seed)
    cams = {1: trwm.Camera(id=1, model="PINHOLE", width=640, height=480,
                           params=np.array([500.0, 500.0, 320.0, 240.0]))}
    seen = rng.random((n_images, n_points)) < rng.uniform(0.1, 0.6,
                                                          (n_images, 1))
    images, tracks = {}, {j: ([], []) for j in range(n_points)}
    for i in range(n_images):
        pids = np.where(seen[i], np.arange(n_points), -1)
        pids[rng.random(n_points) < 0.2] = -1
        for k, j in enumerate(pids):
            if j != -1:
                tracks[j][0].append(i + 1)
                tracks[j][1].append(k)
        images[i + 1] = trwm.Image(
            id=i + 1, qvec=tgeo.rotmat2qvec(_rotation(rng)),
            tvec=rng.normal(size=3), camera_id=1, name=f"im{i}.png",
            xys=rng.uniform(0, 480, (n_points, 2)), point3D_ids=pids)
    pts = {j: trwm.Point3D(id=j, xyz=rng.normal(size=3),
                           rgb=np.array([0, 0, 0]), error=0.0,
                           image_ids=np.array(tracks[j][0], int),
                           point2D_idxs=np.array(tracks[j][1], int))
           for j in range(n_points)}
    return cams, images, pts


@pytest.mark.parametrize("num_matched", [2, 4, 10])
def test_pairs_from_covisibility_matches_jax(tmp_path, num_matched):
    cams, images, pts = _covis_model()
    trwm.write_model(cams, images, pts, tmp_path / "m", ext=".bin")
    got = tcovis.main(tmp_path / "m", tmp_path / "t.txt", num_matched)
    want = jcovis.main(tmp_path / "m", tmp_path / "j.txt", num_matched)
    assert got == want and len(got) > 0
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    # the planted scene: every image sees every point, all counts tie
    s = chip_smoke.sfm_scene(12, 6, 30, 0.25)
    trwm.write_model(s["cameras"], s["images"], s["points3D"],
                     tmp_path / "s", ext=".txt")
    assert tcovis.main(tmp_path / "s", tmp_path / "t.txt", num_matched) == \
        jcovis.main(tmp_path / "s", tmp_path / "j.txt", num_matched)


@pytest.mark.parametrize("num_matched,threshold", [(2, 30), (3, 45), (8, 30)])
def test_pairs_from_poses_matches_jax(tmp_path, num_matched, threshold):
    """Cameras on a line with headings that differ by up to ~50°, two at
    the same centre (a distance tie)."""
    rng = np.random.default_rng(4)
    images = {}
    for i in range(9):
        R = chip_smoke._rot_y(np.deg2rad(rng.uniform(-25, 25)))
        c = np.array([0.5 * (i % 8), rng.normal() * 0.1, 0.0])
        images[i + 1] = trwm.Image(
            id=i + 1, qvec=tgeo.rotmat2qvec(R), tvec=-R @ c, camera_id=1,
            name=f"p{i}.png", xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), int))
    trwm.write_images_binary(images, tmp_path / "images.bin")
    for model in (tmp_path, str(tmp_path)):
        got = tposes.main(model, tmp_path / "t.txt", num_matched,
                          rotation_threshold=threshold, device="cpu")
        want = jposes.main(model, tmp_path / "j.txt", num_matched,
                           rotation_threshold=threshold)
        assert got == want and len(got) > 0
    ids, dist, dR = tposes.get_pairwise_distances(images)
    for g, w in zip((ids, dist, dR), jposes.get_pairwise_distances(images)):
        np.testing.assert_allclose(g, w, rtol=GEO_RTOL)


def test_pairs_from_retrieval_db_model_matches_jax(tmp_path):
    """db_model=: the database names come from the model's images.bin
    (here five of the file's images, in the model's id order)."""
    rng = np.random.default_rng(6)
    names = [f"db/{i}.png" for i in range(6)] + ["q/0.png", "q/1.png"]
    desc = rng.normal(size=(len(names), 16)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    path = tmp_path / "global.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for name, d in zip(names, desc):
            f.create_dataset(f"{name}/global_descriptor", data=d)
    images = {i: trwm.Image(id=i, qvec=np.array([1.0, 0, 0, 0]),
                            tvec=np.zeros(3), camera_id=1,
                            name=f"db/{j}.png", xys=np.zeros((0, 2)),
                            point3D_ids=np.zeros((0,), int))
              for i, j in zip((4, 1, 9, 2, 3), (3, 0, 5, 1, 4))}
    trwm.write_images_binary(images, tmp_path / "images.bin")
    for kw in ({}, {"query_prefix": "q/"}, {"min_score": 0.0}):
        got = tret.main(path, tmp_path / "t.txt", 2, db_model=tmp_path,
                        device="cpu", **kw)
        want = jret.main(path, tmp_path / "j.txt", 2, db_model=tmp_path,
                         **kw)
        assert sorted(got) == sorted(want) and len(got) > 0
        assert {r for _, r in got} <= {im.name for im in images.values()}
        if "query_prefix" in kw:
            assert got == want
