"""SuperPoint, LightGlue and RANSAC of the port against the JAX package,
on the CPU, same weights and inputs (made with numpy from a seed)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.models.extractors import superpoint as jsp
from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.ops import nms as jnms
from imcui_tpu.ops import ransac as jransac
from imcui_tpu.utils import weights as jweights
from imcui_tpu_torch.models.extractors import superpoint as tsp
from imcui_tpu_torch.models.matchers import lightglue as tlg
from imcui_tpu_torch.ops import cuda_nms
from imcui_tpu_torch.ops import ransac as transac
from imcui_tpu_torch.utils import weights as tweights

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
ATOL = 5e-4  # the goldens' precedent (tests/test_goldens.py)


@pytest.fixture(scope="module")
def sp_params():
    tree = tweights.load_tree_npz(WEIGHTS / "superpoint_adapted.npz")
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tweights.params_from_jax(tree))


def _images():
    imgs, valid = [], [[224, 160], [200, 150]]
    for seed, (w, h) in zip((5, 6), valid):
        canvas = np.zeros((160, 224), np.float32)
        canvas[:h, :w] = chip_smoke.textured_image(
            np.random.default_rng(seed), h, w) / 255.0
        imgs.append(canvas)
    return np.stack(imgs)[:, None], np.asarray(valid, np.int32)


def _by_position(kpts, mask, desc):
    return {tuple(p): desc[:, i] for i, p in enumerate(kpts) if mask[i]}


def test_superpoint_fp32_matches_jax(sp_params):
    jp, tp = sp_params
    img, vwh = _images()
    feats_j = jsp.backbone(jp, jnp.asarray(img).transpose(0, 2, 3, 1))
    heat_j = np.asarray(jsp.dense_scores(jp, feats_j))
    with torch.no_grad():
        heat_t = tsp.dense_scores(tp, tsp.backbone(tp, torch.from_numpy(img)))
    np.testing.assert_allclose(heat_t.numpy(), heat_j, atol=ATOL)

    out_j = jsp.apply(jp, jnp.asarray(img), jnp.asarray(vwh),
                      max_keypoints=256, keypoint_threshold=0.0005,
                      precision="fp32")
    out_t = tsp.apply(tp, img, vwh, max_keypoints=128,
                      keypoint_threshold=0.0005, precision="fp32",
                      device="cpu")
    for i in range(2):
        dj = _by_position(np.asarray(out_j["keypoints"][i]),
                          np.asarray(out_j["mask"][i]),
                          np.asarray(out_j["descriptors"][i]))
        dt = _by_position(out_t["keypoints"][i].numpy(),
                          out_t["mask"][i].numpy(),
                          out_t["descriptors"][i].numpy())
        assert len(dj) > 50 and set(dt) == set(dj)
        for p in dj:
            np.testing.assert_allclose(dt[p], dj[p], atol=ATOL)


def test_superpoint_bf16_keypoints_overlap_jax(sp_params):
    """bf16 runs the fused stage tail and NMS (plain versions here) where
    the JAX package runs XLA convs on the CPU; bf16 rounds at other
    places, so only the keypoint sets are compared: at least 90% of the
    JAX keypoints (intersection over union) must be found by the port."""
    jp, tp = sp_params
    img, vwh = _images()
    out_j = jsp.apply(jp, jnp.asarray(img), jnp.asarray(vwh),
                      max_keypoints=256, keypoint_threshold=0.0005,
                      precision="bf16")
    out_t = tsp.apply(tp, img, vwh, max_keypoints=128,
                      keypoint_threshold=0.0005, precision="bf16",
                      device="cpu")
    for i in range(2):
        sj = {tuple(p) for p in np.asarray(out_j["keypoints"][i])[
            np.asarray(out_j["mask"][i])]}
        st = {tuple(p) for p in out_t["keypoints"][i].numpy()[
            out_t["mask"][i].numpy()]}
        assert len(sj) > 50
        assert len(sj & st) / len(sj | st) >= 0.9


@pytest.fixture(scope="module")
def sp_init_trees():
    """The JAX package's init tree (key 0) in both packages."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jsp.init_params(jax.random.PRNGKey(0)))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tweights.params_from_jax(tree))


@pytest.mark.parametrize("radius", [2, 7])
def test_superpoint_bf16_nms_outside_the_fused_gate_matches_jax(
        sp_init_trees, radius, monkeypatch):
    """Outside 3 <= nms_radius <= 6 the bf16 apply takes the reference's
    per-pixel chain (simple_nms -> border_mask -> top-k), not K2's cell
    reduction, which keeps one survivor per 4x4 cell and so loses
    survivors below radius 3 (C1: 180 keypoints against the reference's
    223 at radius 2). On the port's own bf16 heatmap the keypoints and
    scores equal the JAX chain's exactly; end to end against the JAX
    bf16 apply the sets differ only by the trunk's bf16 rounding (230
    against 230 with 229 in common at radius 2, all 34 at radius 7)."""
    jp, tp = sp_init_trees
    img = np.random.default_rng(0).uniform(size=(1, 1, 64, 64)).astype(
        np.float32)
    vwh = np.asarray([[64, 64]], np.int32)
    kw = dict(nms_radius=radius, max_keypoints=512, keypoint_threshold=0.0,
              precision="bf16")
    heats = []
    chain = tsp._select_per_pixel

    def spy(heat, *args):
        heats.append(heat)
        return chain(heat, *args)

    def refuse(*args, **kwargs):
        raise AssertionError("K2's cell reduction ran outside its gate")

    monkeypatch.setattr(tsp, "_select_per_pixel", spy)
    monkeypatch.setattr(cuda_nms, "select_keypoints", refuse)
    out_t = tsp.apply(tp, img, vwh, device="cpu", **kw)
    assert len(heats) == 1 and heats[0].dtype == torch.bfloat16
    st = {tuple(p) for p in out_t["keypoints"][0][out_t["mask"][0]].tolist()}

    heat = jnp.asarray(heats[0][0].float().numpy()).astype(jnp.bfloat16)
    scores = jnms.simple_nms(heat, radius) * jnms.border_mask(
        64, 64, 4, valid_wh=vwh[0], dtype=heat.dtype)
    kp_c, sc_c, m_c = jnms.select_topk_keypoints(scores, 512, 0.0,
                                                 exact=True)
    sc = {tuple(p) for p in np.asarray(kp_c)[np.asarray(m_c)].tolist()}
    assert len(st) > 30 and st == sc
    np.testing.assert_array_equal(
        np.sort(out_t["scores"][0].numpy()),
        np.sort(np.asarray(sc_c.astype(jnp.float32))))

    out_j = jsp.apply(jp, jnp.asarray(img), jnp.asarray(vwh), **kw)
    sj = {tuple(p) for p in np.asarray(out_j["keypoints"][0])[
        np.asarray(out_j["mask"][0])].tolist()}
    assert abs(len(sj) - len(st)) <= 2
    assert len(sj & st) / len(sj | st) >= 0.95


def test_nms_cellmax_plain_refuses_radius_below_3():
    """Below radius 3 two survivors can share a 4x4 cell, so the cell
    reduction is not the function; the plain version refuses it as the
    kernel does, and the gate says so."""
    heat = torch.rand((1, 16, 16)).to(torch.bfloat16)
    vwh = torch.tensor([[16, 16]], dtype=torch.int32)
    for radius in (0, 1, 2):
        with pytest.raises(ValueError):
            cuda_nms.nms_cellmax_plain(heat, vwh, radius=radius)
        with pytest.raises(ValueError):
            cuda_nms.nms_cellmax(heat, vwh, radius=radius)
        assert not cuda_nms.supported(16, 16, radius)
    assert [cuda_nms.supported(16, 16, r) for r in range(3, 8)] == [
        True, True, True, True, False]
    assert not cuda_nms.supported(18, 16, 4)
    assert not cuda_nms.supported(16, 18, 4)


def _lg_trees(n_layers=2):
    """The trained 9-layer LightGlue cut to its first ``n_layers``."""
    tree = tweights.load_tree_npz(WEIGHTS / "lightglue_selftrained.npz")
    tree["transformers"] = tree["transformers"][:n_layers]
    tree["log_assignment"] = tree["log_assignment"][:n_layers]
    tree["token_confidence"] = tree["token_confidence"][:n_layers - 1]
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tweights.params_from_jax(tree))


@pytest.mark.parametrize("n1", [64, 48])
def test_lightglue_forward_pair_matches_jax(n1):
    """matches0 equal; matching_scores0 within 5e-4. n1 = 64 runs both
    views' self-attention in one batch, n1 = 48 separately."""
    jp, tp = _lg_trees()
    rng = np.random.default_rng(4)
    b, n0, d = 2, 64, 256
    kpts0 = rng.uniform(0, 120, (b, n0, 2)).astype(np.float32)
    desc0 = rng.normal(size=(b, n0, d)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    perm = rng.permutation(n0)[:n1]
    kpts1 = kpts0[:, perm] + rng.normal(0, 1.0, (b, n1, 2)).astype(np.float32)
    desc1 = desc0[:, perm] + rng.normal(0, 0.05, (b, n1, d)).astype(np.float32)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    mask0 = np.ones((b, n0), bool)
    mask1 = np.ones((b, n1), bool)
    mask0[1, 50:] = False
    mask1[1, 40:] = False
    size = np.asarray([[128, 96], [120, 90]], np.float32)
    conf = {"num_heads": 4, "match_threshold": 0.1, "precision": "fp32"}
    fn = functools.partial(jlg.forward_pair, conf=conf)
    want = jax.vmap(lambda *a: fn(jp, *a))(
        *(jnp.asarray(a) for a in (kpts0, kpts1, desc0, desc1, mask0, mask1,
                                   size, size)))
    got = tlg.forward_pair(tp, kpts0, kpts1, desc0, desc1, mask0, mask1,
                           size, size, device="cpu")
    assert (np.asarray(want["matches0"]) > -1).sum() > 20
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               atol=ATOL)


def _planted(model, rng, n=200):
    """Correspondences under a known model, 0.3 px noise, 30% outliers
    and 20 invalid slots."""
    if model == "homography":
        hm = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0],
                       [1e-4, -5e-5, 1.0]])
        p0 = rng.uniform([0, 0], [640, 480], (n, 2))
        q = np.concatenate([p0, np.ones((n, 1))], 1) @ hm.T
        p1 = q[:, :2] / q[:, 2:]
    else:
        k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        x = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3))
        a = 0.1
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        x1 = x @ rot.T + np.array([0.5, 0.05, 0.1])
        p0 = (x @ k.T)[:, :2] / x[:, 2:]
        p1 = (x1 @ k.T)[:, :2] / x1[:, 2:]
    p1 = p1 + rng.normal(0, 0.3, p1.shape)
    out = rng.choice(n, int(0.3 * n), replace=False)
    p1[out] = rng.uniform([0, 0], [640, 480], (len(out), 2))
    mask = np.ones(n, bool)
    mask[-20:] = False
    return p0.astype(np.float32), p1.astype(np.float32), mask


@pytest.mark.parametrize("model", ["homography", "fundamental"])
def test_ransac_core_matches_jax_on_injected_indices(model):
    """Given the (S, k) index set JAX drew, the port's core returns the
    same model (rtol 1e-3; F up to sign, entries compared against 1e-3 of
    its largest) and the same inliers."""
    rng = np.random.default_rng(8 if model == "homography" else 9)
    p0, p1, mask = _planted(model, rng)
    k_min = 4 if model == "homography" else 8
    key = jax.random.PRNGKey(0)
    idx = np.array(jransac._sample_indices(key, jnp.asarray(mask), 64,
                                           k_min))
    want = jransac.ransac(key, jnp.asarray(p0), jnp.asarray(p1),
                          jnp.asarray(mask), model=model, threshold=3.0,
                          num_hypotheses=64)
    got = transac.ransac_from_indices(
        torch.from_numpy(idx)[None].long(), torch.from_numpy(p0)[None],
        torch.from_numpy(p1)[None], torch.from_numpy(mask)[None],
        model=model, threshold=3.0)
    m_j = np.asarray(want["M"])
    m_t = got["M"][0].numpy()
    if model == "fundamental":
        m_t = m_t * np.sign((m_t * m_j).sum())
    np.testing.assert_allclose(m_t, m_j, rtol=1e-3,
                               atol=1e-3 * np.abs(m_j).max())
    np.testing.assert_array_equal(got["inliers"][0].numpy(),
                                  np.asarray(want["inliers"]))
    assert int(got["num_inliers"][0]) == int(want["num_inliers"]) > 100


def test_sample_indices_draws_valid_slots_without_replacement():
    mask = torch.zeros((2, 50), dtype=torch.bool)
    mask[0, :30] = True
    mask[1, 10:40] = True
    idx = transac.sample_indices(mask, 128, 8, torch.Generator().manual_seed(0))
    assert idx.shape == (2, 128, 8)
    for b in range(2):
        assert bool(mask[b][idx[b]].all())
        assert all(len(set(row.tolist())) == 8 for row in idx[b])
