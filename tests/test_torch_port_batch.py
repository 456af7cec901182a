"""The sparse batch pipelines of the port against the JAX package on
the CPU: ``extract_features.main``, ``match_features.main`` and
``pairs_from_exhaustive`` with the file helpers of ``utils/io``, on a PNG
directory of four 256 × 192 views (two planted pairs of
``chip_smoke.synthetic_pair``). The JAX package writes its files with
h5py, the port with its own ``utils/h5lite``; each reads the other's.
``tests/test_torch_port_batch_more.py`` holds the dense and retrieval
pipelines, the parsers and the port's resumable extraction.

The JAX package's ``list_h5_names`` returns set order, so name lists are
compared as sets. Tolerances:

- keypoints (float64 in both files: the ``(kp + 0.5) * scale - 0.5``
  rescale runs in float64 and ``as_half`` halves only float32) within
  1e-3 px, every keypoint paired;
- descriptors and scores (float16) within 2e-3, two float16 steps at 1;
- the ``uncertainty`` attribute equal, with its dtype;
- matches (int16) equal; matching scores (float16) within 2e-3.
"""

import copy
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import chip_smoke
from imcui_tpu.pipeline import extract_features as jextract
from imcui_tpu.pipeline import match_features as jmatch
from imcui_tpu.pipeline import pairs_from_exhaustive as jexh
from imcui_tpu.utils import io as jio
from imcui_tpu_torch.pipeline import extract_features as textract
from imcui_tpu_torch.pipeline import match_features as tmatch
from imcui_tpu_torch.pipeline import pairs_from_exhaustive as texh
from imcui_tpu_torch.utils import h5lite
from imcui_tpu_torch.utils import io as tio
from imcui_tpu_torch.utils.png import encode_png

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
SP_NPZ = str(WEIGHTS / "superpoint_adapted.npz")
LG_NPZ = str(WEIGHTS / "lightglue_selftrained.npz")
SEEDS = (100, 101)
SIZE = (256, 192)
NAMES = ["p0a.png", "p0b.png", "p1a.png", "p1b.png"]
KPT_PX = 1e-3
F16 = 2e-3


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
    resize_max 200 (the 256 × 192 views become 200 × 144: keypoints are
    rescaled by (1.28, 1.333))."""
    conf = copy.deepcopy(textract.confs["superpoint_aachen"])
    conf["model"].update(precision="fp32", checkpoint_npz=SP_NPZ)
    conf["preprocessing"].update(resize_max=200, force_resize=False)
    return conf


@pytest.fixture(scope="module")
def extracted(views, tmp_path_factory):
    """(JAX feature file, port feature file)."""
    d = tmp_path_factory.mktemp("feats")
    conf = _sp_conf()
    jpath = jextract.main(conf, views[0], d / "jax")
    tpath = textract.main(conf, views[0], d / "port", device="cpu")
    return Path(jpath), Path(tpath)


def _pair_rows(a, b, tol):
    """Indices pairing every row of a with a row of b within ``tol``."""
    dist, idx = cKDTree(b).query(a)
    assert (dist <= tol).all(), dist.max()
    assert len(set(idx.tolist())) == len(a) == len(b)
    return idx


def test_extract_features_main_matches_jax(extracted):
    jpath, tpath = extracted
    assert set(tio.list_h5_names(tpath)) == set(jio.list_h5_names(jpath)) \
        == set(NAMES)
    assert set(tio.list_h5_names(jpath)) == set(NAMES)
    with h5py.File(jpath, "r") as fj, h5lite.File(tpath) as ft:
        for name in NAMES:
            gj, gt = fj[name], ft[name]
            assert set(gt.keys()) == set(gj.keys()) == {
                "keypoints", "scores", "descriptors"}
            for k in gj:
                assert gt[k].dtype == gj[k].dtype, (name, k)
            kj, kt = gj["keypoints"][()], np.asarray(gt["keypoints"])
            assert kt.dtype == np.float64 and len(kt) > 20
            idx = _pair_rows(kt, kj, KPT_PX)
            np.testing.assert_allclose(np.asarray(gt["scores"]),
                                       gj["scores"][()][idx], atol=F16)
            np.testing.assert_allclose(np.asarray(gt["descriptors"]),
                                       gj["descriptors"][()][:, idx],
                                       atol=F16)
            uj = gj["keypoints"].attrs["uncertainty"]
            ut = gt["keypoints"].attrs["uncertainty"]
            assert ut == uj and np.asarray(ut).dtype == uj.dtype == np.float64
            np.testing.assert_allclose(ut, np.mean([256 / 200, 192 / 144]))
    # each reads the other's file through its own helpers
    kt, ut = tio.get_keypoints(jpath, "p0a.png", return_uncertainty=True)
    kj, uj = jio.get_keypoints(jpath, "p0a.png", return_uncertainty=True)
    np.testing.assert_array_equal(kt, kj)
    assert ut == uj


def _pairs_file(path):
    pairs = texh.main(path, image_list=NAMES)
    assert pairs == jexh.main(str(path) + ".jax", image_list=NAMES)
    assert len(pairs) == 6
    return pairs


@pytest.mark.parametrize("matcher", ["NN-mutual", "superpoint-lightglue"])
def test_match_features_main_matches_jax(extracted, tmp_path, matcher):
    """Both packages match the JAX package's feature file (the port reads
    it through h5lite); the match files hold the same pairs, equal int16
    matches and float16 scores within 2e-3. Each package reads the
    other's match file."""
    jfeat, _ = extracted
    conf = copy.deepcopy(tmatch.confs[matcher])
    if matcher != "NN-mutual":
        conf["model"]["checkpoint_npz"] = LG_NPZ
    pairs = _pairs_file(tmp_path / "pairs.txt")
    jout = jmatch.main(conf, tmp_path / "pairs.txt", jfeat,
                       matches=tmp_path / "jax.h5")
    tout = tmatch.main(conf, tmp_path / "pairs.txt", jfeat,
                       matches=tmp_path / "port.h5", device="cpu")
    with h5py.File(jout, "r") as fj, h5lite.File(tout) as ft:
        assert set(ft.keys()) == set(fj.keys())
        for n0, n1 in pairs:
            pair, rev = jio.find_pair(fj, n0, n1)
            assert tio.find_pair(ft, n0, n1) == (pair, rev)
            mj, mt = fj[pair]["matches0"][()], np.asarray(
                ft[pair]["matches0"])
            assert mt.dtype == mj.dtype == np.int16
            np.testing.assert_array_equal(mt, mj)
            sj = fj[pair]["matching_scores0"][()]
            st = np.asarray(ft[pair]["matching_scores0"])
            assert st.dtype == sj.dtype == np.float16
            np.testing.assert_allclose(st, sj, atol=F16)
    total = 0
    for n0, n1 in pairs:
        mt, st = tio.get_matches(jout, n1, n0)
        mj, sj = jio.get_matches(tout, n1, n0)
        np.testing.assert_array_equal(mt, mj)
        total += len(mt)
    assert total > 0
    # the planted pairs keep matches (few: ~50 keypoints a 200 × 144 view)
    for n0, n1 in (("p0a.png", "p0b.png"), ("p1a.png", "p1b.png")):
        m, _ = tio.get_matches(tout, n0, n1)
        assert len(m) >= 5, (matcher, n0, len(m))
    # nothing left to match: the file is untouched
    raw = Path(tout).read_bytes()
    tmatch.main(conf, tmp_path / "pairs.txt", jfeat, matches=tout,
                device="cpu")
    assert Path(tout).read_bytes() == raw


def test_match_features_main_names_and_errors(extracted, tmp_path):
    """features as a name in export_dir, as JAX resolves it; a features
    path without matches raises; reversed pairs are deduplicated and a
    pair stored in any of the four name orders is skipped."""
    jfeat, _ = extracted
    (tmp_path / "feats.h5").write_bytes(jfeat.read_bytes())
    conf = tmatch.confs["NN-mutual"]
    pairs = [("p0a.png", "p0b.png"), ("p0b.png", "p0a.png"),
             ("p1a.png", "p1b.png")]
    out = tmatch.main(conf, pairs, "feats", export_dir=tmp_path,
                      device="cpu")
    assert out == Path(tmp_path, "feats_matches-NN-mutual_pairs.h5")
    with h5lite.File(out) as f:
        assert sorted(f.keys()) == ["p0a.png", "p1a.png"]
        assert sorted(f["p0a.png"].keys()) == ["p0b.png"]
    with pytest.raises(ValueError, match="matches"):
        tmatch.main(conf, pairs, tmp_path / "feats.h5", device="cpu")
    with pytest.raises(ValueError, match="export_dir"):
        tmatch.main(conf, pairs, "absent_name", device="cpu")
    with h5lite.File(out, "a") as f:
        f.create_group("p1b.png_p0b.png").create_dataset(
            "matches0", data=np.zeros(1, np.int16))
    todo = [("p0b.png", "p1b.png"), ("p1b.png", "p0a.png")]
    assert tmatch.find_unique_new_pairs(todo, out) == \
        jmatch.find_unique_new_pairs(todo, out) == [("p1b.png", "p0a.png")]


def test_pairs_from_exhaustive_matches_jax(extracted, tmp_path):
    jfeat, tfeat = extracted
    for kw in ({"features": tfeat}, {"features": jfeat},
               {"image_list": NAMES[:3], "ref_list": NAMES[3:]},
               {"features": tfeat, "ref_features": jfeat}):
        got = texh.main(tmp_path / "t.txt", **kw)
        want = jexh.main(tmp_path / "j.txt", **kw)
        assert sorted(got) == sorted(want) and len(got) == len(set(got))
    assert len(texh.main(tmp_path / "t.txt", features=tfeat)) == 6
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(NAMES))
    assert texh.main(tmp_path / "t.txt", image_list=lst) == jexh.main(
        tmp_path / "j.txt", image_list=lst)
    with pytest.raises(ValueError, match="Provide either"):
        texh.main(tmp_path / "t.txt")


