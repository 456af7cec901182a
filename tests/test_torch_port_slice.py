"""The port's serving slice end to end on the CPU: match_step against the
JAX package's, TurboMatcher under concurrent requests (mirroring
tests/test_turbo.py), and the planted-homography gate that chip_smoke.py
holds the card to, measured here on the JAX package and the port."""

import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.pipeline import two_view as jtv
from imcui_tpu.utils import image as jimage
from imcui_tpu_torch.api.turbo import TurboMatcher
from imcui_tpu_torch.pipeline import two_view as ttv
from imcui_tpu_torch.utils import image as timage
from imcui_tpu_torch.utils import weights as tweights

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _trees(n_layers=2):
    """Trained SuperPoint and the trained LightGlue cut to n_layers."""
    sp = tweights.load_tree_npz(WEIGHTS / "superpoint_adapted.npz")
    lg = tweights.load_tree_npz(WEIGHTS / "lightglue_selftrained.npz")
    for key, n in (("transformers", n_layers), ("log_assignment", n_layers),
                   ("token_confidence", n_layers - 1)):
        lg[key] = lg[key][:n]
    tree = {"superpoint": sp, "lightglue": lg}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tweights.params_from_jax(tree))


def test_match_step_matches_jax():
    """fp32, no RANSAC: keypoints and matches equal, scores within 5e-4."""
    jp, tp = _trees()
    im0, im1, wh = [], [], []
    for i, (w, h) in enumerate([(224, 160), (200, 150)]):
        a, b, _ = chip_smoke.synthetic_pair(20 + i, w, h)
        d0, d1 = (timage.preprocess(x, resize_max=224, buckets=(224,))
                  for x in (a, b))
        im0.append(d0["image"][0])
        im1.append(d1["image"][0])
        wh.append(d0["size"])
    im0, im1 = np.stack(im0), np.stack(im1)
    wh = np.stack(wh).astype(np.int32)
    kw = dict(max_keypoints=128, ransac=None, precision="fp32")
    want = jtv.match_step(jp, jnp.asarray(im0), jnp.asarray(im1),
                          jnp.asarray(wh), jnp.asarray(wh),
                          jax.random.PRNGKey(0), n_layers=2, **kw)
    got = ttv.match_step(tp, im0, im1, wh, wh, None, device="cpu", **kw)
    assert (np.asarray(want["matches0"]) > -1).sum() > 50
    for k in ("keypoints0", "keypoints1", "mask0", "mask1", "matches0"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("scores0", "scores1", "matching_scores0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-4, err_msg=k)


@pytest.fixture(scope="module")
def turbo():
    tm = TurboMatcher(canvas=128, max_keypoints=64, n_layers=1,
                      batch_size=2, match_threshold=0.0, num_hypotheses=64,
                      device="cpu")
    yield tm
    tm.close()


def test_turbo_single_request(turbo):
    img = (np.random.RandomState(0).rand(100, 120, 3) * 255).astype(np.uint8)
    out = turbo.match(img, img.copy())
    for key in ("keypoints0_orig", "mkeypoints0_orig", "mconf", "M",
                "num_inliers"):
        assert key in out
    if len(out["mkeypoints0_orig"]):
        # self pair: surviving correspondences are identities
        np.testing.assert_allclose(out["mkeypoints0_orig"],
                                   out["mkeypoints1_orig"], atol=1e-3)


def test_turbo_concurrent_requests(turbo):
    rng = np.random.RandomState(1)
    imgs = [(rng.rand(100, 120, 3) * 255).astype(np.uint8) for _ in range(4)]
    results = [None] * 4

    def worker(i):
        results[i] = turbo.match(imgs[i], imgs[i].copy())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and "num_inliers" in r for r in results)


def test_planted_homography_gate_jax_and_port():
    """One synthetic request of chip_smoke.py, at a 512 canvas (the card
    runs 1024): the JAX package's serving step and the port's, each with
    the trained weights, 1024 keypoints, 9 layers, 512 hypotheses. Both
    must pass the gate chip_smoke.py applies on the card."""
    img0, img1, hm = chip_smoke.synthetic_pair(100, 601, 451)
    canvas = 512
    d0, d1 = (jimage.preprocess(x, grayscale=True, resize_max=canvas,
                                dfactor=8, buckets=(canvas,))
              for x in (img0, img1))
    params, _ = jtv.load_pretrained(
        n_layers=9, sp_npz=WEIGHTS / "superpoint_adapted.npz",
        lg_npz=WEIGHTS / "lightglue_selftrained.npz")
    out = jtv.match_step(
        params, jnp.asarray(d0["image"]), jnp.asarray(d1["image"]),
        jnp.asarray(d0["size"][None], jnp.int32),
        jnp.asarray(d1["size"][None], jnp.int32), jax.random.PRNGKey(0),
        max_keypoints=1024, num_hypotheses=512)
    out = {k: np.asarray(v)[0] for k, v in out.items()}
    inl = out["inliers"] & (out["matches0"] > -1)
    err_jax = chip_smoke.transfer_errors(
        hm, jimage.keypoints_to_original(out["mkeypoints0"][inl],
                                         d0["original_size"] / d0["size"]),
        jimage.keypoints_to_original(out["mkeypoints1"][inl],
                                     d1["original_size"] / d1["size"]))

    tm = TurboMatcher(canvas=canvas, max_keypoints=1024, n_layers=9,
                      batch_size=1, num_hypotheses=512, device="cpu")
    try:
        res = tm.match(img0, img1)
    finally:
        tm.close()
    err_port = chip_smoke.transfer_errors(hm, res["mkeypoints0_orig"],
                                          res["mkeypoints1_orig"])
    print(f"gate pair {img0.shape[1]}x{img0.shape[0]} @ canvas {canvas}: "
          f"JAX {len(err_jax)} inliers, median {np.median(err_jax):.3f} px; "
          f"port {len(err_port)} inliers, median {np.median(err_port):.3f} px")
    for err in (err_jax, err_port):
        assert len(err) >= chip_smoke.GATE_MIN_INLIERS
        assert np.median(err) <= chip_smoke.GATE_MEDIAN_PX


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TurboMatcher(canvas=128, max_keypoints=64, n_layers=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ttv.match_step({}, np.zeros((1, 1, 8, 8)), np.zeros((1, 1, 8, 8)),
                       np.ones((1, 2)), np.ones((1, 2)), None)
