"""The offline evaluations in the port (imcui_tpu_torch/eval/: synthpose,
warp, megadepth; the CLI's ``eval pose``) against the JAX package on the
CPU. OpenCV is imported here only, to hold the port's restatements of
``cv2.resize``, ``cv2.getRotationMatrix2D`` and ``cv2.warpPerspective``
against it.

Tolerances: the synthetic scenes, homographies, renders and ground-truth
correspondences are the same numpy code, so equal; ``pairs.json`` equal
apart from the output directory; the PNGs of ``generate_pairs`` within 1
grey level of OpenCV's (resize rounding; measured 0 and 1);
``make_homographies`` within 1e-12 of OpenCV's; ``warp_image`` within 2
grey levels of ``cv2.warpPerspective`` on at most 1 % of the pixels
(OpenCV's 1/32-px position grid; measured 1 level on < 0.02 %).
"""

import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from imcui_tpu.cli import main as jcli
from imcui_tpu.eval import megadepth as jmega
from imcui_tpu.eval import synthpose as jsynth
from imcui_tpu.eval import warp as jwarp
from imcui_tpu_torch.cli import main as tcli
from imcui_tpu_torch.eval import megadepth as tmega
from imcui_tpu_torch.eval import synthpose as tsynth
from imcui_tpu_torch.eval import warp as twarp
from imcui_tpu_torch.utils.image import read_image
from imcui_tpu_torch.utils.png import encode_png

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The JAX models look for checkpoints on the hub unless told not to."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


def _textured(seed, h, w):
    img = chip_smoke.textured_image(np.random.default_rng(seed), h, w)
    return np.repeat(img[..., None], 3, -1)


# --------------------------------------------------------------------------
# synthpose
# --------------------------------------------------------------------------

def test_synthpose_arrays_equal_jax():
    img = _textured(1, 60, 80)
    for seed in (0, 1):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        sj, st = jsynth.sample_scene(rj, 80, 60), tsynth.sample_scene(
            rt, 80, 60)
        for k in ("K", "R", "t", "x_edges"):
            np.testing.assert_array_equal(st[k], sj[k])
        for (nt, dt), (nj, dj) in zip(st["planes"], sj["planes"]):
            np.testing.assert_array_equal(nt, nj)
            assert dt == dj
        for a, b in zip(tsynth._plane_homographies(st),
                        jsynth._plane_homographies(sj)):
            np.testing.assert_array_equal(a, b)
        for im in (img, img[..., 0], img.astype(np.float32) / 255):
            (it, vt), (ij, vj) = (tsynth.render_view1(im, st),
                                  jsynth.render_view1(im, sj))
            assert it.dtype == im.dtype
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_array_equal(vt, vj)
        for a, b in zip(tsynth.gt_correspondences(st, 80, 60, rt, n=64),
                        jsynth.gt_correspondences(sj, 80, 60, rj, n=64)):
            np.testing.assert_array_equal(a, b)
        assert tsynth._rotation([0, 1, 2], 0.3).tolist() == \
            jsynth._rotation([0, 1, 2], 0.3).tolist()


def test_generate_pairs_equals_jax(tmp_path):
    """A PNG corpus (one photo at the size asked, one to resize, one PPM):
    the port's pairs.json equals the JAX package's but for the directory,
    and each PNG is within 1 grey level of OpenCV's."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.png").write_bytes(encode_png(_textured(2, 48, 64)))
    (corpus / "b.png").write_bytes(encode_png(_textured(3, 61, 83)))
    rgb = _textured(4, 48, 64)
    rgb[..., 1] //= 2
    (corpus / "c.ppm").write_bytes(b"P6\n64 48\n255\n" + rgb.tobytes())
    photos = sorted(corpus.iterdir())
    want = jsynth.generate_pairs(photos, tmp_path / "j", n_pose_per_image=3,
                                 size=(48, 64), seed=5)
    got = tsynth.generate_pairs(photos, tmp_path / "t", n_pose_per_image=3,
                                size=(48, 64), seed=5)
    assert len(got) >= 6

    def rel(pairs, d):
        return [{k: (str(Path(v).relative_to(d)) if k.startswith("img")
                     else v) for k, v in p.items()} for p in pairs]

    assert rel(got, tmp_path / "t") == rel(want, tmp_path / "j")
    assert json.loads((tmp_path / "t" / "pairs.json").read_text()) == got
    names = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    worst = 0
    for n in names:
        a = read_image(tmp_path / "t" / n).astype(int)
        b = cv2.imread(str(tmp_path / "j" / n))[..., ::-1].astype(int)
        worst = max(worst, int(np.abs(a - b).max()))
    assert worst <= 1, worst
    # the photo at the size asked is copied exactly
    np.testing.assert_array_equal(
        read_image(tmp_path / "t" / "scene000_view0.png"), _textured(2, 48,
                                                                     64))


def test_generate_pairs_names_a_format_it_cannot_read(tmp_path):
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00")
    with pytest.raises(ValueError, match="JPEG"):
        tsynth.generate_pairs([tmp_path / "x.jpg"], tmp_path / "o")
    (tmp_path / "x.tif").write_bytes(b"II*\x00" + bytes(12))
    with pytest.raises(ValueError, match="TIFF"):
        tsynth.generate_pairs([tmp_path / "x.tif"], tmp_path / "o")


# --------------------------------------------------------------------------
# warp
# --------------------------------------------------------------------------

def test_make_homographies_match_cv2():
    for w, h in ((640, 480), (161, 97)):
        got = twarp.make_homographies(w, h)
        want = jwarp.make_homographies(w, h)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for c, a, s in (((3.5, 9.0), 37.0, 0.7), ((0, 0), -200.0, 2.0)):
        np.testing.assert_allclose(twarp.rotation_matrix_2d(c, a, s),
                                   cv2.getRotationMatrix2D(c, a, s),
                                   atol=1e-12)


@pytest.mark.parametrize("kind", ["textured", "noise", "float"])
def test_warp_image_matches_cv2(kind):
    rng = np.random.default_rng(6)
    if kind == "noise":
        img = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    else:
        img = _textured(7, 96, 128)
    if kind == "float":
        img = img[..., 0].astype(np.float32) / 255
    hs = twarp.make_homographies(128, 96) + [np.array(
        [[0.9, 0.1, 5], [-0.05, 1.1, -3], [2e-4, -1e-4, 1]])]
    for H in hs:
        got = twarp.warp_image(img, H, device="cpu")
        want = cv2.warpPerspective(img, H, (128, 96))
        assert got.dtype == img.dtype and got.shape == img.shape
        d = np.abs(got.astype(np.float64) - want)
        if kind == "float":
            assert d.max() <= 2 / 255, d.max()
        else:
            assert d.max() <= 2 and (d > 0).mean() <= 0.01, (d.max(),
                                                              (d > 0).mean())


def test_transfer_and_corner_errors_equal_jax():
    rng = np.random.default_rng(8)
    H = jwarp.make_homographies(640, 480)[4]
    k0, k1 = rng.uniform(0, 640, (50, 2)), rng.uniform(0, 480, (50, 2))
    np.testing.assert_array_equal(twarp.transfer_error(k0, k1, H),
                                  jwarp.transfer_error(k0, k1, H))
    assert twarp.corner_error(H, np.eye(3), 640, 480) == \
        jwarp.corner_error(H, np.eye(3), 640, 480)


def test_evaluate_warp_scores_a_planted_matcher():
    """evaluate_warp on an API stand-in that returns exact matches (and
    the true H) for even warps, shuffled ones for odd: the port and the
    JAX package give the same per-warp results."""
    img = _textured(9, 96, 128)
    hs = twarp.make_homographies(128, 96)
    calls = []

    def fake_api(image, warped):
        i = len(calls) % 5
        calls.append(warped)
        k0 = np.random.default_rng(i).uniform(10, 90, (40, 2))
        x = np.c_[k0, np.ones(40)] @ hs[i].T
        k1 = x[:, :2] / x[:, 2:]
        if i % 2:
            k1 = k1[::-1]
        return {"mmkeypoints0_orig": k0, "mmkeypoints1_orig": k1,
                "geom_info": {"Homography": hs[i]}}

    got = twarp.evaluate_warp(fake_api, img, device="cpu")
    want = jwarp.evaluate_warp(fake_api, img)
    assert got == want
    assert got[0][0] == {"n_matches": 40, "recall": 1.0, "h_corner_err": 0.0}
    for a, b in zip(calls[:5], calls[5:]):
        assert np.abs(a.astype(int) - b).max() <= 2


# --------------------------------------------------------------------------
# megadepth
# --------------------------------------------------------------------------

def _calibrated(rng):
    """test_eval_and_dense_batch.py's scene (RandomState draws)."""
    K = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    a = 0.3
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([1.0, 0.1, 0.05])
    t /= np.linalg.norm(t)
    X = rng.uniform(-2, 2, (300, 3)) + np.array([0, 0, 5.0])
    x0 = X @ K.T
    p0 = (x0[:, :2] / x0[:, 2:]).astype(np.float32)
    x1 = (X @ R.T + t) @ K.T
    p1 = (x1[:, :2] / x1[:, 2:]).astype(np.float32)
    pairs = [{"img0": "a", "img1": "b", "K0": K.tolist(), "K1": K.tolist(),
              "R": R.tolist(), "t": t.tolist()} for _ in range(3)]
    return pairs, p0, p1


def test_evaluate_pairs_good_and_bad_matchers():
    """tests/test_eval_and_dense_batch.py::test_eval_harness_synthetic on
    the port: perfect correspondences → AUC@5 > 0.5, median < 2°; garbage
    → AUC@5 < 0.3; fewer than 8 matches → 180°."""
    rng = np.random.RandomState(0)
    pairs, p0, p1 = _calibrated(rng)

    def good(_, __):
        return (p0 + rng.randn(*p0.shape) * 0.2,
                p1 + rng.randn(*p1.shape) * 0.2)

    res = tmega.evaluate_pairs(good, pairs, ransac_threshold_px=1.5,
                               num_hypotheses=512, device="cpu")
    assert res["auc@5"] > 0.5, res
    assert res["median_err_deg"] < 2.0
    assert res["mean_matches"] == 300.0 and len(res["errors"]) == 3

    def bad(_, __):
        return (rng.uniform(0, 640, (100, 2)).astype(np.float32),
                rng.uniform(0, 480, (100, 2)).astype(np.float32))

    res = tmega.evaluate_pairs(bad, pairs, ransac_threshold_px=1.5,
                               num_hypotheses=256, device="cpu")
    assert res["auc@5"] < 0.3

    res = tmega.evaluate_pairs(lambda a, b: (p0[:7], p1[:7]), pairs,
                               max_pairs=2, device="cpu")
    assert res["errors"] == [180.0, 180.0]
    assert set(res) == set(jmega.evaluate_pairs(
        lambda a, b: (p0[:7], p1[:7]), pairs, max_pairs=2))


def test_convert_scene_info_equals_jax(tmp_path):
    rng = np.random.default_rng(10)
    poses = np.tile(np.eye(4), (4, 1, 1))
    for p in poses:
        p[:3, :3] = jsynth._rotation(rng.normal(size=3), rng.uniform(0, 1))
        p[:3, 3] = rng.normal(size=3)
    info = {"poses": poses, "intrinsics": rng.uniform(100, 900, (4, 3, 3)),
            "image_paths": np.array([f"img/{i}.jpg" for i in range(4)],
                                    dtype=object),
            "pair_infos": np.array([((0, 1), 0.5, None), ((2, 3), 0.3, None),
                                    ((1, 3), 0.2, None)], dtype=object)}
    np.savez(tmp_path / "scene.npz", **info)
    want = jmega.convert_scene_info(tmp_path / "scene.npz", "/data",
                                    tmp_path / "j.json")
    got = tmega.convert_scene_info(tmp_path / "scene.npz", "/data",
                                   tmp_path / "t.json")
    assert got == want and len(got) == 3
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()


def test_evaluate_matcher_overrides_the_options_as_jax(monkeypatch):
    """Both packages build ImageMatchingAPI with its defaults, which
    overwrite the sparse feature's max_keypoints (1024) and
    keypoint_threshold (0.015) and the dense matcher's match_threshold
    (0.2): of feature_opts only subpixel survives. So LightGlue runs at
    1024 keypoints, where the port's self-attention takes the fused
    kernel's route (N ≤ 2048), not the blockwise one."""
    seen = {}

    def capture(tag):
        def fn(api):
            seen[tag] = api
            return lambda a, b: (np.zeros((0, 2)), np.zeros((0, 2)))
        return fn

    monkeypatch.setattr(jmega, "api_matcher_fn", capture("jax"))
    monkeypatch.setattr(tmega, "api_matcher_fn", capture("port"))
    monkeypatch.chdir(ROOT)
    pairs = [{"img0": "a", "img1": "b", "K0": np.eye(3).tolist(),
              "K1": np.eye(3).tolist(), "R": np.eye(3).tolist(),
              "t": [1.0, 0, 0]}]
    for matcher, fo, mo in (("superpoint+lightglue",
                             {"subpixel": True, "keypoint_threshold": 5e-4,
                              "max_keypoints": 4096},
                             {"match_threshold": 0.1}),
                            ("loftr", None, {"match_threshold": 0.5})):
        rj = jmega.evaluate_matcher(pairs, matcher, feature_opts=fo,
                                    matcher_opts=mo)
        rt = tmega.evaluate_matcher(pairs, matcher, feature_opts=fo,
                                    matcher_opts=mo, device="cpu")
        assert rj["errors"] == rt["errors"] == [180.0]
        j, t = seen["jax"], seen["port"]
        assert t.conf["ransac"] == j.conf["ransac"] == {"enable": False}
        assert t.match_conf["model"] == j.match_conf["model"]
        if matcher == "loftr":
            assert t.matcher.pair_conf["match_threshold"] == 0.2
            continue
        assert t.extract_conf["model"] == j.extract_conf["model"]
        m = t.extract_conf["model"]
        assert (m["max_keypoints"], m["keypoint_threshold"], m["subpixel"]) \
            == (1024, 0.015, True)
        assert t.extractor.conf["max_keypoints"] == 1024
        assert t.matcher.conf["match_threshold"] == 0.1


def test_cli_eval_pose_writes_the_jax_key_set(tmp_path, monkeypatch,
                                              capsys):
    """``eval pose --pairs-json … --device cpu`` with the default
    superpoint+lightglue on one synthetic pair: the printed line and a
    record with the keys of the JAX command's (the JAX command run here on
    a stand-in evaluate_matcher, to keep its models out of the test)."""
    photo = tmp_path / "photo.png"
    photo.write_bytes(encode_png(_textured(11, 480, 640)))
    pairs = tsynth.generate_pairs([photo], tmp_path / "pairs",
                                  n_pose_per_image=1, size=(480, 640),
                                  seed=1)
    assert len(pairs) == 1
    monkeypatch.chdir(ROOT)
    out = tmp_path / "out"
    assert tcli.main(["eval", "pose", "--pairs-json",
                      str(tmp_path / "pairs" / "pairs.json"), "--subpixel",
                      "--ransac-threshold-px", "1.5", "--out", str(out),
                      "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"pose eval [superpoint+lightglue] on {tmp_path}" in text
    rec = json.loads((out / "pose_superpoint+lightglue.json").read_text())
    assert rec["n_pairs"] == 1 and rec["mean_matches"] >= 50, rec
    assert rec["median_err_deg"] < 10.0, rec

    def stand_in(pairs, matcher, **kw):
        return jmega.evaluate_pairs(
            lambda a, b: (np.zeros((0, 2)), np.zeros((0, 2))), pairs)

    from click.testing import CliRunner

    monkeypatch.setattr(jmega, "evaluate_matcher", stand_in)
    res = CliRunner().invoke(jcli.cli, [
        "eval", "pose", "--pairs-json", str(tmp_path / "pairs" /
                                            "pairs.json"),
        "--out", str(tmp_path / "jout")])
    assert res.exit_code == 0, res.output
    want = json.loads((tmp_path / "jout" / "pose_superpoint+lightglue.json"
                       ).read_text())
    assert set(rec) == set(want)


def test_eval_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pairs, p0, p1 = _calibrated(np.random.RandomState(0))
    with pytest.raises(RuntimeError, match="cuda"):
        tmega.evaluate_pairs(lambda a, b: (p0, p1), pairs)
    with pytest.raises(RuntimeError, match="cuda"):
        twarp.warp_image(np.zeros((4, 4), np.uint8), np.eye(3))
