"""The port's SfM and localisation pipelines against the JAX package on
the CPU: ``reconstruction.main`` and ``triangulation.main`` up to the
mapper, ``localize_sfm.main``, ``localize_inloc``, ``colmap_from_nvm.main``
and ``ui/sfm.py::SfmEngine``.

The two packages draw RANSAC and PnP hypotheses from different generators
(a ``torch.Generator`` seeded as the JAX package seeds its keys), so the
scenes are planted with a unique inlier set: correct matches within 0.3 px
of the truth, wrong ones more than 50 px off their epipolar line
(``chip_smoke.sfm_scene``). Tolerances:

- database tables equal row for row, verified matches equal as bytes;
- the port's F within 4.0 px (Sampson) on its verified matches;
- localisation inlier sets equal; on the JAX package's own test scene
  (``tests/test_sfm_utils.py``) rotation within 0.01° and translation
  within 1e-4; with the JAX package's own draws fed to the port, within
  0.01° and 5e-3: every point is an inlier, many hypotheses score alike,
  the float32 argmax picks another one than XLA's, and two rounds of
  local optimisation leave 0.0033° and 4.1e-3 between the two poses;
- InLoc (focal 3136, 48 px): inlier sets equal, rotation within 0.01°
  and translation within 5e-3 of the JAX package's, both within 0.01°
  and 0.01 of the planted pose;
- model files equal byte for byte;
- SfmEngine (bf16 SuperPoint on four 320 × 240 planar views): cameras and
  images equal, keypoint IoU >= 0.9 at 0.5 px, the port's verified
  matches within ENGINE_PX of the planted homography on at least
  ENGINE_SHARE of each pair, at least ENGINE_LEAST a pair.
"""

import pickle
import re
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.pipeline import colmap_from_nvm as jnvm
from imcui_tpu.pipeline import localize_inloc as jinloc
from imcui_tpu.pipeline import localize_sfm as jloc
from imcui_tpu.pipeline import reconstruction as jrec
from imcui_tpu.pipeline import triangulation as jtri
from imcui_tpu.ui import sfm as jsfm
from imcui_tpu.utils import database as jdb
from imcui_tpu.utils import read_write_model as jrwm
from imcui_tpu.utils.io import names_to_pair
from imcui_tpu_torch.ops import pnp as tpnp
from imcui_tpu_torch.pipeline import colmap_from_nvm as tnvm
from imcui_tpu_torch.pipeline import localize_inloc as tinloc
from imcui_tpu_torch.pipeline import localize_sfm as tloc
from imcui_tpu_torch.pipeline import pairs_from_poses as tposes
from imcui_tpu_torch.pipeline import reconstruction as trec
from imcui_tpu_torch.pipeline import triangulation as ttri
from imcui_tpu_torch.ui import sfm as tsfm
from imcui_tpu_torch.utils.database import blob_to_array, pair_id_to_image_ids
from imcui_tpu_torch.utils.geometry import qvec2rotmat
from imcui_tpu_torch.utils.png import encode_png

TABLES = ("cameras", "images", "keypoints", "matches")
SAMPSON_PX = 4.0
ROT_DEG, TRANS = 0.01, 1e-4
ROT_DEG_SAME_DRAW, TRANS_SAME_DRAW = 0.01, 5e-3
INLOC_DEG, INLOC_TRANS, INLOC_GT = 0.01, 5e-3, 0.01
ENGINE_SIZE = (320, 240)
ENGINE_KPTS = 512
ENGINE_IOU, ENGINE_IOU_PX = 0.9, 0.5
ENGINE_PX, ENGINE_SHARE, ENGINE_LEAST = 3.0, 0.8, 60


@pytest.fixture(autouse=True, scope="module")
def _offline():
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A planted non-planar scene: 5 views of 300 points, 25 % wrong
    matches, a query of 600 keypoints (30 % wrong 2D-3D matches)."""
    s = chip_smoke.sfm_scene(21, 5, 300, 0.25, n_query=600)
    return s, chip_smoke.write_sfm_scene(tmp_path_factory.mktemp("scene"), s)


_table = chip_smoke.sqlite_rows


def _verified(path):
    """{pair_id: (rows, matches bytes, config, F (3, 3))}."""
    return {r[0]: (r[1], r[3], r[4], blob_to_array(r[5], np.float64,
                                                   (3, 3)))
            for r in _table(path, "two_view_geometries")}


def _mapper_error(e, path):
    return str(e).replace(str(path), "<db>")


def _run_both(fn_port, fn_jax, root):
    """Run each package's main into its own directory; both end in the
    mapper's ImportError, whose messages (the database path aside) are
    equal. Returns the two database paths."""
    dbs, msgs = [], []
    for tag, fn in (("port", fn_port), ("jax", fn_jax)):
        out = root / tag
        with pytest.raises(ImportError, match="pycolmap") as e:
            fn(out)
        dbs.append(out / "database.db")
        msgs.append(_mapper_error(e.value, dbs[-1]))
    assert msgs[0] == msgs[1]
    return dbs


def _sampson(F, p0, p1):
    h0 = np.concatenate([p0, np.ones((len(p0), 1))], 1)
    h1 = np.concatenate([p1, np.ones((len(p1), 1))], 1)
    f0, f1 = h0 @ F.T, h1 @ F
    return (h1 * f0).sum(1) ** 2 / (f0[:, 0] ** 2 + f0[:, 1] ** 2
                                    + f1[:, 0] ** 2 + f1[:, 1] ** 2)


def _estimate_f(pkg, i, f, n0, n1):
    """F of pair ``i`` (name0 → name1) as each package's
    geometric_verification estimates it: all of the pair's matches on
    padded slots, hypotheses drawn from seed ``i``."""
    from imcui_tpu.ops.ransac import ransac as jransac
    from imcui_tpu_torch.ops.ransac import ransac as transac
    from imcui_tpu_torch.utils.io import get_keypoints, get_matches

    m, _ = get_matches(f["matches"], n0, n1)
    n = len(m)
    n_pad = trec.pad_slots(n)
    p0 = np.zeros((n_pad, 2), np.float32)
    p1 = np.zeros((n_pad, 2), np.float32)
    mask = np.zeros(n_pad, bool)
    p0[:n] = get_keypoints(f["feats"], n0)[m[:, 0]]
    p1[:n] = get_keypoints(f["feats"], n1)[m[:, 1]]
    mask[:n] = True
    if pkg == "jax":
        out = jransac(jax.random.PRNGKey(i), jnp.asarray(p0), jnp.asarray(p1),
                      jnp.asarray(mask), model="fundamental", threshold=4.0,
                      num_hypotheses=1024)
        return np.asarray(out["M"], np.float64)
    out = transac(p0[None], p1[None], mask[None],
                  torch.Generator().manual_seed(i), model="fundamental",
                  threshold=4.0, num_hypotheses=1024, device="cpu")
    return out["M"][0].double().numpy()


def test_reconstruction_main_matches_jax(scene, tmp_path):
    """Tables equal, verified sets equal (and equal to the planted correct
    matches), the port's F within 4 px on its inliers. Pins the F of a
    flipped pair: stored for (name0 → name1) beside matches in (id1, id0)
    order, on both packages."""
    s, f = scene
    args = (f["images"], f["pairs"], f["feats"], f["matches"])
    port_db, jax_db = _run_both(
        lambda out: trec.main(out, *args, device="cpu"),
        lambda out: jrec.main(out, *args), tmp_path)
    for t in TABLES:
        got, want = _table(port_db, t), _table(jax_db, t)
        assert got == want and len(got) > 0, t
    cam = _table(port_db, "cameras")[0]
    w, h = s["size"]
    np.testing.assert_array_equal(
        blob_to_array(cam[4], np.float64),
        np.array([1.2 * max(w, h), w / 2.0, h / 2.0, 0.0]))
    got, want = _verified(port_db), _verified(jax_db)
    assert sorted(got) == sorted(want) and len(got) == len(s["pairs"])
    ids = {n: i + 1 for i, n in enumerate(s["names"])}
    kp = {n: k.astype(np.float64) for n, k in s["kpts"].items()}
    flipped = 0
    for n0, n1 in s["pairs"]:
        pid = jdb.image_ids_to_pair_id(ids[n0], ids[n1])
        assert got[pid][:3] == want[pid][:3], (n0, n1)
        rows, data, config, F = got[pid]
        assert config == 3
        m = np.frombuffer(data, np.uint32).reshape(-1, 2)
        if ids[n0] > ids[n1]:
            m = m[:, ::-1]
            flipped += 1
            # the stored F is the one estimated from name0 to name1 (not
            # transposed to the stored (id1, id0) order), in both packages
            i = s["pairs"].index((n0, n1))
            for pkg, db in (("port", got), ("jax", want)):
                np.testing.assert_array_equal(
                    db[pid][3], _estimate_f(pkg, i, f, n0, n1))
        assert {tuple(r) for r in m.tolist()} == s["correct"][(n0, n1)]
        err = _sampson(F, kp[n0][m[:, 0]], kp[n1][m[:, 1]])
        assert err.max() < SAMPSON_PX ** 2, (n0, n1, err.max())
    assert flipped > 0


def test_triangulation_main_matches_jax(scene, tmp_path):
    """The epipolar gate against the model's poses keeps the same matches
    in both packages, the planted correct ones; both end in the same
    ImportError."""
    s, f = scene
    args = (f["model"], f["images"], f["pairs"], f["feats"], f["matches"])
    port_db, jax_db = _run_both(lambda out: ttri.main(out, *args),
                                lambda out: jtri.main(out, *args), tmp_path)
    for t in TABLES:
        assert _table(port_db, t) == _table(jax_db, t), t
    got, want = _verified(port_db), _verified(jax_db)
    assert {k: v[:3] for k, v in got.items()} == \
        {k: v[:3] for k, v in want.items()}
    for r in _table(port_db, "two_view_geometries"):
        i0, i1 = pair_id_to_image_ids(r[0])
        n0, n1 = s["names"][i0 - 1], s["names"][i1 - 1]
        m = {tuple(x) for x in np.frombuffer(r[3], np.uint32).reshape(
            -1, 2).tolist()}
        want_m = s["correct"].get((n0, n1)) or {
            (b, a) for a, b in s["correct"][(n1, n0)]}
        assert m == want_m
    cams, _, _ = jrwm.read_model(f["model"])
    for cam in (*cams.values(), jrwm.Camera(1, "SIMPLE_RADIAL", 10, 10,
                                            np.array([9.0, 5, 5, 0.1])),
                jrwm.Camera(1, "OPENCV", 10, 10, np.arange(8.0) + 1),
                jrwm.Camera(1, "FOV", 10, 10, np.array([9.0, 5, 5, 0.3]))):
        np.testing.assert_array_equal(ttri.camera_K(cam), jtri.camera_K(cam))
    with pytest.raises(ValueError, match="Unsupported"):
        ttri.camera_K(jrwm.Camera(1, "THIN_PRISM_FISHEYE", 1, 1,
                                  np.ones(12)))


def _angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2,
                                        -1, 1)))


def _jax_test_scene(root):
    """tests/test_sfm_utils.py::test_localize_sfm_end_to_end's scene:
    three images of 150 points, a query at 0.4 px of noise, every query
    keypoint matched to its point in each image."""
    from test_sfm_utils import make_synthetic_model

    K, cameras, images, points3D = make_synthetic_model(n_points=150,
                                                        n_images=3)
    jrwm.write_model(cameras, images, points3D, root / "sfm", ext=".bin")
    rng = np.random.RandomState(1)
    R_gt = chip_smoke._rot_y(0.25)
    t_gt = np.array([0.3, 0.1, 0.2])
    X = np.stack([points3D[j].xyz for j in range(150)])
    x = (X @ R_gt.T + t_gt) @ K.T
    q_kpts = (x[:, :2] / x[:, 2:]) + rng.randn(150, 2) * 0.4
    with h5py.File(root / "feats.h5", "w", libver="latest") as fd:
        fd.create_group("query.jpg").create_dataset(
            "keypoints", data=(q_kpts - 0.5).astype(np.float32))
        for img in images.values():
            fd.create_group(img.name).create_dataset(
                "keypoints", data=(img.xys - 0.5).astype(np.float32))
    with h5py.File(root / "matches.h5", "w", libver="latest") as fd:
        for img in images.values():
            g = fd.create_group(names_to_pair("query.jpg", img.name))
            g.create_dataset("matches0", data=np.arange(150, dtype=np.int16))
            g.create_dataset("matching_scores0",
                             data=np.ones(150, np.float16))
    (root / "retrieval.txt").write_text(
        "\n".join(f"query.jpg {img.name}" for img in images.values()))
    (root / "queries.txt").write_text(
        "query.jpg PINHOLE 640 480 800 800 320 240\n")
    return R_gt, t_gt


def _localize_both(model, root, **kw):
    out = {}
    for tag, mod, extra in (("port", tloc, {"device": "cpu"}),
                            ("jax", jloc, {})):
        out[tag] = mod.main(model, root / "queries.txt",
                            root / "retrieval.txt", root / "feats.h5",
                            root / "matches.h5", root / f"{tag}.txt",
                            **kw, **extra)
    return out


def _result_line(path):
    name, *vals = path.read_text().split()
    return name, np.array(vals, float)


def _jax_pnp_draw(mask, num_hypotheses, generator):
    """The six-point sets the JAX package draws from PRNGKey(0)."""
    g = jax.random.gumbel(jax.random.PRNGKey(0),
                          (num_hypotheses, mask.shape[0]))
    g = jnp.where(jnp.asarray(mask.cpu().numpy())[None], g, -1e9)
    idx = jax.lax.top_k(g, tpnp.MIN_PNP_POINTS)[1]
    return torch.from_numpy(np.array(idx)).long()


@pytest.mark.parametrize("draw", ["own", "jax"])
def test_localize_sfm_main_matches_jax(tmp_path, monkeypatch, draw):
    """The JAX test's scene: the same inliers (all 150), the pose within
    ROT_DEG / TRANS of the JAX package's with the port's own draw and
    within the _SAME_DRAW bounds with the JAX package's draw (see the
    module's docstring); result
    lines alike within those bounds; logs of numpy and Python values that
    hold the same keys and inliers."""
    R_gt, t_gt = _jax_test_scene(tmp_path)
    if draw == "jax":
        monkeypatch.setattr(tpnp, "sample_pnp_indices", _jax_pnp_draw)
    out = _localize_both(tmp_path / "sfm", tmp_path, ransac_thresh=6.0)
    (qt, tt), (qj, tj) = (out[k][0]["query.jpg"] for k in ("port", "jax"))
    rot, trans = (ROT_DEG, TRANS) if draw == "own" else (
        ROT_DEG_SAME_DRAW, TRANS_SAME_DRAW)
    assert _angle_deg(qvec2rotmat(qt), qvec2rotmat(qj)) < rot
    assert np.abs(tt - tj).max() < trans
    assert _angle_deg(qvec2rotmat(qt), R_gt) < 1.5
    assert np.linalg.norm(tt - t_gt) < 0.1
    (nt, vt), (nj, vj) = (_result_line(tmp_path / f"{k}.txt")
                          for k in ("port", "jax"))
    assert nt == nj == "query.jpg"
    np.testing.assert_allclose(vt, vj, atol=trans + np.radians(rot))
    lt = pickle.loads(Path(f"{tmp_path / 'port.txt'}_logs.pkl").read_bytes())
    lj = pickle.loads(Path(f"{tmp_path / 'jax.txt'}_logs.pkl").read_bytes())
    assert lt.keys() == lj.keys()
    assert lt["loc"].keys() == lj["loc"].keys() == {"query.jpg"}
    a, b = lt["loc"]["query.jpg"], lj["loc"]["query.jpg"]
    assert a.keys() == b.keys()
    assert a["db"] == b["db"] and a["num_matches"] == b["num_matches"]
    assert a["keypoint_index_to_db"] == b["keypoint_index_to_db"]
    assert a["PnP_ret"]["num_inliers"] == b["PnP_ret"]["num_inliers"] == 150

    def no_tensor(x):
        if isinstance(x, dict):
            return all(no_tensor(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(no_tensor(v) for v in x)
        return not isinstance(x, torch.Tensor)

    assert no_tensor(lt)


@pytest.mark.parametrize("clustering", [False, True])
def test_localize_sfm_planted_outliers(scene, tmp_path, clustering):
    """The planted query (30 % wrong 2D-3D matches): both packages keep
    exactly the planted inliers and land within the JAX test's gates."""
    s, f = scene
    q = s["query"]
    res = {}
    for tag, mod, extra in (("port", tloc, {"device": "cpu"}),
                            ("jax", jloc, {})):
        poses, logs = mod.main(
            f["model"], f["queries"], f["retrieval"], f["feats"],
            f["matches"], tmp_path / f"{tag}.txt", ransac_thresh=6.0,
            covisibility_clustering=clustering, **extra)
        qv, tv = poses[q["name"]]
        assert _angle_deg(qvec2rotmat(qv), q["R"]) < 1.5
        assert np.linalg.norm(tv - q["t"]) < 0.1
        res[tag] = logs["loc"][q["name"]]
        if clustering:
            assert len(res[tag]["logs_clusters"]) == 1
    kp_t = res["port"]["keypoint_index_to_db"][0]
    assert kp_t == res["jax"]["keypoint_index_to_db"][0]
    ret = tloc.pose_from_cluster(
        q["name"], tloc.Camera(-1, "PINHOLE", *s["size"],
                               np.array([800.0, 800, *s["K"][:2, 2]])),
        [1, 2, 3], tloc.read_model(f["model"])[1],
        tloc.read_model(f["model"])[2], f["feats"], f["matches"],
        thresh_px=6.0, device="cpu")[0]
    inl = {int(k) for k, ok in zip(kp_t, ret["inliers"]) if ok}
    assert inl == q["inliers"]
    assert res["port"]["PnP_ret"]["num_inliers"] == \
        res["jax"]["PnP_ret"]["num_inliers"] == len(q["inliers"])


class _JoinPath(type(Path())):
    """A Path that joins ``path + str`` as a string: what the JAX
    module's ``Path(dataset_dir) / r + ".mat"`` means."""

    def __add__(self, other):
        return _JoinPath(str(self) + other)


def test_localize_inloc_matches_jax(tmp_path, monkeypatch):
    """Scans in .mat files (scipy.io.savemat): the same 2D-3D points,
    inliers and pose as the JAX module with its path join repaired; the
    JAX module as it is raises TypeError at that join."""
    q, names, Rq, tq, inliers = chip_smoke.inloc_scene(tmp_path)
    f, m = tmp_path / "feats.h5", tmp_path / "matches.h5"
    with pytest.raises(TypeError, match="PosixPath"):
        jinloc.pose_from_scan_cluster(tmp_path, q, names, f, m)
    for r in names:
        np.testing.assert_array_equal(tinloc.get_scan_pose(tmp_path, r),
                                      jinloc.get_scan_pose(tmp_path, r))
    monkeypatch.setattr(jinloc, "Path", _JoinPath)
    got = tinloc.pose_from_scan_cluster(tmp_path, q, names, f, m,
                                        device="cpu")
    want = jinloc.pose_from_scan_cluster(tmp_path, q, names, f, m)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    rt, rj = got[3], want[3]
    assert rt["success"] and rj["success"]
    assert rt["num_inliers"] == rj["num_inliers"] == len(inliers)
    for r in (rt, rj):
        assert _angle_deg(qvec2rotmat(r["qvec"]), Rq) < INLOC_DEG
        assert np.linalg.norm(r["tvec"] - tq) < INLOC_GT
    assert _angle_deg(qvec2rotmat(rt["qvec"]), qvec2rotmat(rj["qvec"])) \
        < INLOC_DEG
    assert np.abs(rt["tvec"] - rj["tvec"]).max() < INLOC_TRANS
    assert got[4] == want[4]
    poses = {}
    for tag, mod, extra in (("port", tinloc, {"device": "cpu"}),
                            ("jax", jinloc, {})):
        poses[tag], logs = mod.main(tmp_path, tmp_path / "retrieval.txt",
                                    f, m, tmp_path / f"{tag}.txt", **extra)
        assert list(logs["loc"]) == [q]
        assert logs["loc"][q]["PnP_ret"]["num_inliers"] == len(inliers)
    (nt, vt), (nj, vj) = (_result_line(tmp_path / f"{k}.txt")
                          for k in ("port", "jax"))
    assert nt == nj == "q0.png"
    np.testing.assert_allclose(vt, vj, atol=INLOC_TRANS)


NVM = """NVM_V3

3
im0.png 500 1 0 0 0 0 0 0 0 0
im1.png 510 0.9950041652780258 0 0.09983341664682815 0 0.5 0 0.1 0 0
im2.png 505 0.98 0.1 0.1 0.1 -0.5 0.2 0 0 0

4
0.1 0.2 5 255 0 0 2 0 0 10.5 20.25 1 3 11.5 21
-0.3 0.4 6 0 255 0 3 0 1 100 120 1 0 90.5 119 2 2 80 70
1.0 -0.2 4.5 0 0 255 1 1 1 30 40
0.0 0.0 7.0 10 20 30 2 0 2 300 200 2 0 310 205
"""


@pytest.mark.parametrize("intrinsics", [True, False])
def test_colmap_from_nvm_matches_jax(tmp_path, intrinsics):
    """The model written from an NVM file equals the JAX package's byte
    for byte, with the intrinsics from a text file or from the database."""
    (tmp_path / "model.nvm").write_text(NVM)
    db = jdb.COLMAPDatabase.connect(tmp_path / "db.db")
    db.create_tables()
    cams = [db.add_camera(2, 640, 480, [500.0, 320, 240, 0.01]),
            db.add_camera(4, 800, 600, np.arange(8.0) + 1)]
    for i, c in enumerate((cams[0], cams[1], cams[0])):
        db.add_image(f"im{i}.png", c)
    db.commit()
    db.close()
    (tmp_path / "intrinsics.txt").write_text(
        "im0.png SIMPLE_RADIAL 640 480 500 320 240 0.01\n"
        "im1.png opencv 800 600 1 2 3 4 5 6 7 8\n"
        "im2.png SIMPLE_RADIAL 640 480 500 320 240 0.01")
    for tag, mod in (("port", tnvm), ("jax", jnvm)):
        if intrinsics:
            mod.main(tmp_path / "model.nvm", tmp_path / "intrinsics.txt",
                     tmp_path / "db.db", tmp_path / tag)
        else:
            mod.main(tmp_path / "model.nvm", tmp_path / "db.db",
                     tmp_path / tag)
    for stem in ("cameras", "images", "points3D"):
        got = (tmp_path / "port" / f"{stem}.bin").read_bytes()
        assert got == (tmp_path / "jax" / f"{stem}.bin").read_bytes(), stem
    cams_r, images, pts = jrwm.read_model(tmp_path / "port")
    assert len(cams_r) == 2 and len(images) == 3 and len(pts) == 4
    assert cams_r[2].model == "OPENCV"
    np.testing.assert_array_equal(images[1].point3D_ids, [0, 1, 3])
    np.testing.assert_array_equal(images[2].point3D_ids, [1, 2, -1, 0])
    np.testing.assert_allclose(images[2].tvec, -qvec2rotmat(
        images[2].qvec) @ [0.5, 0, 0.1])


def _engine_views(root):
    views, hms = chip_smoke.homography_views(41, 4, *ENGINE_SIZE, zoom=2)
    files = []
    for i, v in enumerate(views):
        files.append(root / f"view{i}.png")
        files[-1].write_bytes(encode_png(v))
    return files, hms


def test_sfm_engine_matches_jax(tmp_path):
    files, hms = _engine_views(tmp_path)
    names = [p.name for p in files]
    res = {}
    for tag, mod, kw in (("port", tsfm, {"device": "cpu"}),
                         ("jax", jsfm, {})):
        (tmp_path / tag).mkdir()
        engine = mod.SfmEngine({"outputs": tmp_path / tag}, **kw)
        res[tag] = engine.call("k", files, max_keypoints=ENGINE_KPTS)
        assert engine.call_empty() is None
    for tag in res:
        assert res[tag] == {
            "sfm_dir": str(tmp_path / tag / "sfm"),
            "database": str(tmp_path / tag / "sfm" / "database.db"),
            "status": "database-only (mapper backend unavailable)"}
    port_db, jax_db = (Path(res[t]["database"]) for t in ("port", "jax"))
    for t in ("cameras", "images"):
        assert _table(port_db, t) == _table(jax_db, t), t
    w, h = ENGINE_SIZE
    cam = _table(port_db, "cameras")
    assert len(cam) == 1 and blob_to_array(cam[0][4], np.float64).tolist() \
        == [1.2 * w, w / 2, h / 2, 0.0]
    kt, kj = (_table(p, "keypoints") for p in (port_db, jax_db))
    for a, b in zip(kt, kj):
        pa, pb = (blob_to_array(x[3], np.float32, (-1, 2)) for x in (a, b))
        iou = chip_smoke.common_points(pa, pb, ENGINE_IOU_PX)[0]
        assert iou >= ENGINE_IOU, (a[0], iou)
        assert 100 < len(pa) <= ENGINE_KPTS
    gate = chip_smoke.sfm_engine_gate(port_db, names, hms, ENGINE_PX)
    assert len(gate) == 6
    for pair, (n, share) in gate.items():
        assert n >= ENGINE_LEAST and share >= ENGINE_SHARE, (pair, n, share)
    # the temporary copy of the uploads is gone
    assert not list(Path(res["port"]["sfm_dir"]).glob("*.png"))


@pytest.mark.parametrize("entry", ["engine", "reconstruction", "verify",
                                   "localize_sfm", "localize_inloc",
                                   "pairs_from_poses"])
def test_device_cuda_raises_without_a_card(scene, tmp_path, entry):
    """Every entry point of the slice that touches a device raises on
    device="cuda" here (no card), before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, f = scene
    calls = {
        "engine": lambda: tsfm.SfmEngine({"outputs": tmp_path},
                                         device="cuda"),
        "reconstruction": lambda: trec.main(
            tmp_path / "sfm", f["images"], f["pairs"], f["feats"],
            f["matches"]),
        "verify": lambda: trec.geometric_verification(
            {}, tmp_path / "absent.db", f["pairs"], f["feats"]),
        "localize_sfm": lambda: tloc.main(
            f["model"], f["queries"], f["retrieval"], f["feats"],
            f["matches"], tmp_path / "r.txt"),
        "localize_inloc": lambda: tinloc.main(
            tmp_path, f["retrieval"], f["feats"], f["matches"],
            tmp_path / "r.txt"),
        "pairs_from_poses": lambda: tposes.main(f["model"],
                                                tmp_path / "p.txt", 2)}
    with pytest.raises(RuntimeError, match=re.escape("device='cuda'")):
        calls[entry]()
    assert not (tmp_path / "sfm").exists()
    assert not (tmp_path / "r.txt").exists()
