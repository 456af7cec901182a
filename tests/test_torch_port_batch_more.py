"""The rest of the batch pipelines on the CPU: ``match_dense.
match_and_assign`` / ``main`` and ``pairs_from_retrieval`` against the
JAX package, ``find_pair`` / ``get_matches`` in the four name orders and
the parsers of ``utils/io`` and ``utils/parsers_compat`` against it, and
``extract_features.main``'s resumption, ``overwrite``, ``as_half`` and
image listing on the port alone; on a PNG directory of four 256 × 192
views (two planted pairs of ``chip_smoke.synthetic_pair``).
``tests/test_torch_port_batch.py`` holds the sparse pipelines against
the JAX package.

Tolerances: ``match_and_assign`` on the same correspondences gives equal
feature and match files (keypoints float32, matches int16, scores
float16) and an int64 ``uncertainty``; the retrieval pairs are equal,
query by query and in order; the parsers' outputs are equal.
"""

import copy
import io
from pathlib import Path

import h5py
import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
from imcui_tpu.pipeline import extract_features as jextract
from imcui_tpu.pipeline import match_dense as jdense
from imcui_tpu.pipeline import pairs_from_retrieval as jret
from imcui_tpu.utils import io as jio
from imcui_tpu.utils import parsers_compat as jparse
from imcui_tpu_torch.pipeline import extract_features as textract
from imcui_tpu_torch.pipeline import match_dense as tdense
from imcui_tpu_torch.pipeline import pairs_from_retrieval as tret
from imcui_tpu_torch.utils import h5lite
from imcui_tpu_torch.utils import io as tio
from imcui_tpu_torch.utils import parsers_compat as tparse
from imcui_tpu_torch.utils.png import encode_png

SP_NPZ = str(Path(__file__).resolve().parents[1] / "weights"
             / "superpoint_adapted.npz")
SEEDS = (100, 101)
SIZE = (256, 192)
NAMES = ["p0a.png", "p0b.png", "p1a.png", "p1b.png"]


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
def views(tmp_path_factory):
    """(image directory, {pair: homography})."""
    d = tmp_path_factory.mktemp("views")
    hms = {}
    for k, seed in enumerate(SEEDS):
        a, b, hm = chip_smoke.synthetic_pair(seed, *SIZE)
        (d / f"p{k}a.png").write_bytes(encode_png(a))
        (d / f"p{k}b.png").write_bytes(encode_png(b))
        hms[(f"p{k}a.png", f"p{k}b.png")] = hm
    return d, hms


def _sp_conf():
    """The registry's superpoint_aachen on the trained tree in float32, at
    resize_max 200."""
    conf = copy.deepcopy(textract.confs["superpoint_aachen"])
    conf["model"].update(precision="fp32", checkpoint_npz=SP_NPZ)
    conf["preprocessing"].update(resize_max=200, force_resize=False)
    return conf


def test_extract_features_resumes_and_overwrites(views, tmp_path,
                                                 monkeypatch):
    """A run over a file that holds two of the four images extracts the
    other two; a run with all four in the file does nothing; overwrite
    extracts all four again to the same values; as_half=False keeps
    float32."""
    read = []
    real = textract.image_utils.read_image
    monkeypatch.setattr(textract.image_utils, "read_image",
                        lambda p, g: read.append(Path(p).name) or real(p, g))
    conf, out = _sp_conf(), tmp_path / "f.h5"
    textract.main(conf, views[0], feature_path=out, image_list=NAMES[:2],
                  device="cpu")
    before = {n: tio.get_keypoints(out, n) for n in NAMES[:2]}
    textract.main(conf, views[0], feature_path=out, device="cpu")
    assert read == NAMES                       # two, then the other two
    raw = out.read_bytes()
    textract.main(conf, views[0], feature_path=out, device="cpu")
    assert len(read) == 4 and out.read_bytes() == raw
    textract.main(conf, views[0], feature_path=out, overwrite=True,
                  device="cpu")
    assert len(read) == 8
    for n in NAMES[:2]:
        np.testing.assert_array_equal(tio.get_keypoints(out, n), before[n])
    with h5py.File(out, "r") as f:
        assert sorted(f.keys()) == NAMES
    full = tmp_path / "full.h5"
    textract.main(conf, views[0], feature_path=full, as_half=False,
                  image_list=NAMES[:1], device="cpu")
    with h5lite.File(full) as f:
        assert f["p0a.png/descriptors"].dtype == np.float32
    image_list = tmp_path / "list.txt"
    image_list.write_text("# header\np1b.png\n")
    textract.main(conf, views[0], feature_path=full, image_list=image_list,
                  device="cpu")
    assert set(tio.list_h5_names(full)) == {"p0a.png", "p1b.png"}


def test_list_images_and_a_jpeg_raises(views, tmp_path):
    """list_images finds *.jpg as the JAX function does; main reads a real
    JPEG and raises on a malformed one naming the file instead of
    skipping it; "cuda" without a card raises."""
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    (d / "sub" / "a.png").write_bytes((views[0] / "p0a.png").read_bytes())
    buf = io.BytesIO()
    PIL.Image.open(views[0] / "p0b.png").save(buf, format="JPEG")
    (d / "sub" / "b.jpg").write_bytes(buf.getvalue())
    (d / "z.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    assert textract.list_images(d) == jextract.list_images(d) == [
        "sub/a.png", "sub/b.jpg", "z.jpg"]
    with pytest.raises(ValueError, match="z.jpg"):
        textract.main(_sp_conf(), d, tmp_path / "out", device="cpu")
    feats = tmp_path / "out" / f"{_sp_conf()['output']}.h5"
    assert sorted(tio.list_h5_names(feats)) == ["sub/a.png", "sub/b.jpg"]
    assert len(tio.get_keypoints(feats, "sub/b.jpg")) > 20
    with pytest.raises(ValueError, match="Could not find any image"):
        textract.list_images(tmp_path / "out")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            textract.main(_sp_conf(), views[0], tmp_path / "cuda")


def _fake_matches(image0, image1, n=300):
    """Seeded correspondences keyed by the two images' pixels: the same
    for both packages, which read the same PNG files. Scores on a coarse
    grid so that accumulated cell scores tie."""
    key = int(np.asarray(image0, np.int64).sum() * 31
              + np.asarray(image1, np.int64).sum()) % (2 ** 32)
    rng = np.random.default_rng(key)
    h, w = np.asarray(image0).shape[:2]
    k0 = rng.uniform([0, 0], [w - 1, h - 1], (n, 2))
    k1 = k0 + rng.normal(0, 3, (n, 2))
    return {"mkeypoints0_orig": k0, "mkeypoints1_orig": k1,
            "mconf": rng.choice([0.25, 0.5, 0.75, 1.0], n)}


def test_match_and_assign_matches_jax(views, tmp_path, monkeypatch):
    """Both packages' match_images return the same correspondences (and
    no model is built); the cell bookkeeping, the best-bin refinement,
    the max_kps cap (50, with tied cell scores) and the remaps then give
    equal feature and match files."""
    for mod in (jdense, tdense):
        monkeypatch.setattr(mod, "match_images",
                            lambda model, a, b, conf: _fake_matches(a, b))
        monkeypatch.setattr(mod, "dynamic_load",
                            lambda *_: lambda *a, **kw: None)
    conf = copy.deepcopy(tdense.confs["loftr"])
    conf["cell_size"], conf["max_error"] = 8, 2
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("p0a.png p0b.png\np0a.png p1a.png\np1b.png p0b.png\n")
    jdense.match_and_assign(conf, pairs, views[0], tmp_path / "jm.h5",
                            tmp_path / "jf.h5", max_kps=50)
    tdense.match_and_assign(conf, pairs, views[0], tmp_path / "tm.h5",
                            tmp_path / "tf.h5", max_kps=50, device="cpu")
    with h5py.File(tmp_path / "jf.h5", "r") as fj, \
            h5py.File(tmp_path / "tf.h5", "r") as ft:
        assert sorted(ft.keys()) == sorted(fj.keys()) == [
            "p0a.png", "p0b.png", "p1a.png", "p1b.png"]
        for name in fj:
            kj, kt = fj[name]["keypoints"][()], ft[name]["keypoints"][()]
            assert kt.dtype == kj.dtype == np.float32 and len(kt) == 50
            np.testing.assert_array_equal(kt, kj)
            np.testing.assert_array_equal(ft[name]["scores"][()],
                                          fj[name]["scores"][()])
            u = ft[name]["keypoints"].attrs["uncertainty"]
            assert u == 2 and u.dtype == np.int64
    with h5py.File(tmp_path / "jm.h5", "r") as fj, \
            h5py.File(tmp_path / "tm.h5", "r") as ft:
        seen = []
        fj.visititems(lambda n, o: seen.append(n))
        got = []
        ft.visititems(lambda n, o: got.append(n))
        assert got == seen
        for n in seen:
            if isinstance(fj[n], h5py.Dataset):
                assert ft[n].dtype == fj[n].dtype
                np.testing.assert_array_equal(ft[n][()], fj[n][()])
                assert (ft[n][()] != -1).sum() > 0 or n.endswith("scores0")


def test_match_dense_main_on_trained_loftr(views, tmp_path):
    """The port's match_dense.main on the trained LoFTR at resize_max
    160: files that h5py reads with the JAX package's names, dtypes and
    attribute; matches that follow the planted homography."""
    conf = copy.deepcopy(tdense.confs["loftr"])
    conf["model"]["precision"] = "fp32"
    conf["preprocessing"].update(resize_max=160, force_resize=False)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("p0a.png p0b.png")
    feats, matches = tdense.main(conf, pairs, views[0], tmp_path,
                                 device="cpu")
    assert feats == tmp_path / "feats_matches-loftr.h5"
    assert matches == tmp_path / "matches-loftr_pairs.h5"
    with h5py.File(feats, "r") as f:
        assert sorted(f.keys()) == NAMES[:2]
        assert f["p0a.png/keypoints"].dtype == np.float32
        assert f["p0a.png/scores"].dtype == np.float16
        assert f["p0a.png/keypoints"].attrs["uncertainty"] == 1
    for (n0, n1), hm in list(views[1].items())[:1]:
        m, s = tio.get_matches(matches, n0, n1)
        k0, k1 = tio.get_keypoints(feats, n0), tio.get_keypoints(feats, n1)
        assert s.dtype == np.float16 and len(m) >= 30
        err = chip_smoke.transfer_errors(hm, k0[m[:, 0]], k1[m[:, 1]])
        assert np.median(err) < 3.0, np.median(err)
    with pytest.raises(ValueError, match="matches"):
        tdense.main(conf, pairs, views[0], features=tmp_path / "x.h5",
                    device="cpu")


def _descriptor_file(path, n=7, dim=32):
    rng = np.random.default_rng(3)
    desc = rng.normal(size=(n, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    names = [f"{'db' if i < 4 else 'q'}/{i}.png" for i in range(n)]
    with h5py.File(path, "w", libver="latest") as f:
        for name, d in zip(names, desc):
            f.create_dataset(f"{name}/global_descriptor", data=d)
    return names


@pytest.mark.parametrize("kw", [
    {}, {"min_score": 0.0}, {"query_prefix": "q/", "db_prefix": "db/"},
    {"query_list": ["q/4.png", "q/6.png"], "db_list": ["db/0.png",
                                                      "db/1.png"]}])
def test_pairs_from_retrieval_matches_jax(tmp_path, kw):
    """The device top-k on a descriptor file that h5py wrote: the same
    pairs, best first, as the JAX package's."""
    path = tmp_path / "global.h5"
    _descriptor_file(path)
    want = jret.main(path, tmp_path / "j.txt", 2, **kw)
    got = tret.main(path, tmp_path / "t.txt", 2, device="cpu", **kw)
    assert len(got) > 0

    def by_query(pairs):
        out = {}
        for q, r in pairs:
            out.setdefault(q, []).append(r)
        return out

    assert by_query(got) == by_query(want)
    assert sorted((tmp_path / "t.txt").read_text().split("\n")) == sorted(
        (tmp_path / "j.txt").read_text().split("\n"))


def test_pairs_score_matrix_ties_and_refusals(tmp_path):
    """Ties keep the lower index first (a stable sort, as jnp.argsort);
    masked entries never appear; a db_model without images.bin raises
    as the JAX package's does."""
    scores = np.array([[0.5, 0.9, 0.5, 0.5], [0.1, 0.1, 0.1, 0.1]],
                      np.float32)
    invalid = np.array([[False, True, False, False],
                        [False, False, False, False]])
    for k in (1, 3, 4):
        assert tret.pairs_from_score_matrix(
            torch.from_numpy(scores), torch.from_numpy(invalid), k) == \
            jret.pairs_from_score_matrix(scores, invalid, k)
    assert tret.pairs_from_score_matrix(
        torch.from_numpy(scores), torch.from_numpy(invalid), 4,
        min_score=0.2) == [(0, 0), (0, 2), (0, 3)]
    path = tmp_path / "global.h5"
    _descriptor_file(path)
    for main, kw in ((tret.main, {"device": "cpu"}), (jret.main, {})):
        with pytest.raises(FileNotFoundError, match="images.bin"):
            main(path, tmp_path / "t.txt", 2, db_model=tmp_path, **kw)
    with pytest.raises(ValueError, match="database"):
        tret.main(path, tmp_path / "t.txt", 2, db_prefix="none/",
                  device="cpu")


def test_find_pair_and_get_matches_in_all_four_name_orders(tmp_path):
    """A file holding a/x.png–b.png in one of the four orders at a time;
    both packages find the same group and direction."""
    path = tmp_path / "m.h5"
    for i, form in enumerate(("a-x.png/b.png", "b.png/a-x.png",
                              "a-x.png_b.png", "b.png_a-x.png")):
        with h5lite.File(path, "w") as f:
            g = f.create_group(form)
            g.create_dataset("matches0", data=np.array([i, -1, 2], np.int16))
            g.create_dataset("matching_scores0",
                             data=np.array([0.5, 0, 0.25], np.float16))
        with h5lite.File(path) as ft, h5py.File(path, "r") as fj:
            assert tio.find_pair(ft, "a/x.png", "b.png") == jio.find_pair(
                fj, "a/x.png", "b.png")
            with pytest.raises(ValueError, match="Could not find pair"):
                tio.find_pair(ft, "a/x.png", "c.png")
        mt, st = tio.get_matches(path, "a/x.png", "b.png")
        mj, sj = jio.get_matches(path, "a/x.png", "b.png")
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(st, sj)
    assert tio.names_to_pair("a/b", "c") == jio.names_to_pair("a/b", "c")
    assert tio.names_to_pair_old("a/b", "c") == jio.names_to_pair_old(
        "a/b", "c")


def test_parsers_match_jax(tmp_path):
    (tmp_path / "pairs.txt").write_text("q1 r1\nq1 r2\n\nq2 r1\n")
    (tmp_path / "list_a.txt").write_text(
        "# name model w h params\nim1.png SIMPLE_RADIAL 640 480 500 320 "
        "240 0.01\n\nim2.png PINHOLE 100 50 1 2 3 4\n")
    (tmp_path / "list_b.txt").write_text("im3.png\n")
    assert tio.parse_retrieval(tmp_path / "pairs.txt") == \
        jio.parse_retrieval(tmp_path / "pairs.txt")
    for intr in (False, True):
        got = tio.parse_image_list(tmp_path / "list_a.txt", intr)
        want = jio.parse_image_list(tmp_path / "list_a.txt", intr)
        assert str(got) == str(want)
    got = tio.parse_image_lists(tmp_path / "list_*.txt")
    assert sorted(got) == sorted(jio.parse_image_lists(
        tmp_path / "list_*.txt")) == ["im1.png", "im2.png", "im3.png"]
    assert tparse.parse_pairs_file(tmp_path / "pairs.txt") == \
        jparse.parse_pairs_file(tmp_path / "pairs.txt")
    assert tparse.parse_pairs_file([["a", "b"]]) == [("a", "b")]
    with pytest.raises(FileNotFoundError):
        tparse.parse_pairs_file(tmp_path / "absent.txt")
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.raises(ValueError, match="Could not find any image"):
        tio.parse_image_list(tmp_path / "empty.txt")
