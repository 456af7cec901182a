"""Two-view and absolute pose in the port (imcui_tpu_torch/ops/pose.py,
ops/pnp.py, ops/ransac.py::ransac_batch) against the JAX package on the
CPU. Inputs come from numpy seeds; where the JAX function draws with a
key, the port's core is fed the index set that key draws (the two
packages' random streams differ).

Tolerances, float32:
- essential matrix, candidate poses: 1e-5 of the largest entry (3 × 3
  SVDs in LAPACK and XLA differ in the last bits);
- depths: 1e-4 relative (a 2 × 2 solve whose determinant cancels;
  measured 1.1e-5);
- the four candidates of ``decompose_essential``: the same set (SVD sign
  conventions order them differently), each within 1e-5;
- angles: 1e-3° at angles of 5° or more (arccos amplifies a float32
  rounding of the cosine near 0°);
- poses from the same index set: R and t within 1e-4 (the RANSAC core
  agrees to ~1e-6 on these inputs);
- ``pose_auc``: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from imcui_tpu.eval import synthpose as jsynth
from imcui_tpu.ops import pnp as jpnp
from imcui_tpu.ops import pose as jpose
from imcui_tpu.ops import ransac as jransac
from imcui_tpu_torch.ops import pnp as tpnp
from imcui_tpu_torch.ops import pose as tpose
from imcui_tpu_torch.ops import ransac as transac

K_CAM = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _rot(axis, angle):
    return jsynth._rotation(axis, angle)


def _two_view(rng, n=300, noise=0.0, n_out=0):
    """Points in front of both cameras of a planted (R, t), projected by
    K_CAM; ``n_out`` of them replaced by uniform outliers."""
    R = _rot(rng.normal(size=3), rng.uniform(0.1, 0.3))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    x0 = X @ K_CAM.T
    x1 = (X @ R.T + t) @ K_CAM.T
    p0 = x0[:, :2] / x0[:, 2:] + rng.normal(size=(n, 2)) * noise
    p1 = x1[:, :2] / x1[:, 2:] + rng.normal(size=(n, 2)) * noise
    if n_out:
        p1[:n_out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return p0.astype(np.float32), p1.astype(np.float32), R, t


def test_essential_and_decomposition_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        F = rng.normal(size=(3, 3))
        K0 = K_CAM * rng.uniform(0.8, 1.2)
        K0[2, 2] = 1
        want = np.asarray(jpose.essential_from_fundamental(
            jnp.asarray(F, jnp.float32), jnp.asarray(K0, jnp.float32),
            jnp.asarray(K_CAM, jnp.float32)))
        got = tpose.essential_from_fundamental(_t(F), _t(K0), _t(K_CAM))
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())

        Rs_j, ts_j = (np.asarray(a) for a in jpose.decompose_essential(
            jnp.asarray(want)))
        Rs_t, ts_t = (a.numpy() for a in tpose.decompose_essential(
            torch.from_numpy(want.copy())))
        used = set()
        for R, t in zip(Rs_t, ts_t):
            hit = [i for i in range(4) if i not in used
                   and np.abs(R - Rs_j[i]).max() <= 1e-5
                   and np.abs(t - ts_j[i]).max() <= 1e-5]
            assert hit, "a candidate of the port is not one of JAX's"
            used.add(hit[0])
        for R in Rs_t:
            np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
            assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-5)


def test_depths_and_recover_pose_match_jax():
    rng = np.random.default_rng(1)
    p0, p1, R_gt, t_gt = _two_view(rng)
    Kinv = np.linalg.inv(K_CAM)
    x0 = np.c_[p0, np.ones(len(p0))] @ Kinv.T
    x1 = np.c_[p1, np.ones(len(p1))] @ Kinv.T
    d_j = jpose._triangulate_depths(jnp.asarray(R_gt, jnp.float32),
                                    jnp.asarray(t_gt, jnp.float32),
                                    jnp.asarray(x0, jnp.float32),
                                    jnp.asarray(x1, jnp.float32))
    d_t = tpose._triangulate_depths(_t(R_gt), _t(t_gt), _t(x0), _t(x1))
    for a, b in zip(d_t, d_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
        assert (a.numpy() > 0).all()

    tx = np.array([[0, -t_gt[2], t_gt[1]], [t_gt[2], 0, -t_gt[0]],
                   [-t_gt[1], t_gt[0], 0]])
    E = tx @ R_gt
    mask = np.ones(len(p0), bool)
    mask[::7] = False
    R_j, t_j, c_j = jpose.recover_pose(
        jnp.asarray(E, jnp.float32), jnp.asarray(p0), jnp.asarray(p1),
        jnp.asarray(K_CAM, jnp.float32), jnp.asarray(K_CAM, jnp.float32),
        mask=jnp.asarray(mask))
    R_t, t_t, c_t = tpose.recover_pose(_t(E), _t(p0), _t(p1), _t(K_CAM),
                                       _t(K_CAM), mask=torch.from_numpy(mask))
    assert int(c_t) == int(c_j) == mask.sum()
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(R_t.numpy(), R_gt, atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), t_gt, atol=1e-4)


def test_angles_and_pose_error_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(5):
        R0 = _rot(rng.normal(size=3), rng.uniform(0, np.pi))
        R1 = R0 @ _rot(rng.normal(size=3), np.deg2rad(rng.uniform(5, 170)))
        t0, t1 = rng.normal(size=3), rng.normal(size=3) * 3
        want = [float(jpose.rotation_angle_deg(jnp.asarray(R0, jnp.float32),
                                               jnp.asarray(R1, jnp.float32))),
                float(jpose.translation_angle_deg(
                    jnp.asarray(t0, jnp.float32),
                    jnp.asarray(t1, jnp.float32))),
                float(jpose.pose_error(*(jnp.asarray(a, jnp.float32)
                                         for a in (R0, t0, R1, t1))))]
        got = [float(tpose.rotation_angle_deg(_t(R0), _t(R1))),
               float(tpose.translation_angle_deg(_t(t0), _t(t1))),
               float(tpose.pose_error(_t(R0), _t(t0), _t(R1), _t(t1)))]
        np.testing.assert_allclose(got, want, atol=1e-3)
    # the sign of t does not count; identical poses are 0
    assert float(tpose.translation_angle_deg(_t(t0), _t(-2 * t0))) < 0.05
    assert float(tpose.pose_error(_t(R0), _t(t0), _t(R0), _t(t0))) < 0.05


@pytest.mark.parametrize("errors", [
    [0.5, 3.0, 7.0, 12.0, 25.0, 180.0],
    [180.0, 180.0],
    [0.0, 4.999, 5.0, 5.001, 10.0, 19.99, 20.0],
    list(np.random.default_rng(3).exponential(6.0, 97)),
])
def test_pose_auc_exact(errors):
    want = jpose.pose_auc(errors)
    got = tpose.pose_auc(errors)
    assert got == want


def _padded(p0, p1, n_pad):
    n = len(p0)
    P0 = np.zeros((n_pad, 2), np.float32)
    P1 = np.zeros((n_pad, 2), np.float32)
    m = np.zeros(n_pad, bool)
    P0[:n], P1[:n], m[:n] = p0, p1, True
    return P0, P1, m


def test_estimate_pose_from_jax_indices_matches_jax():
    """The JAX package's estimate_pose and the port's core fed the index
    set of the same key: R and t within 1e-4, the same inliers."""
    rng = np.random.default_rng(4)
    p0, p1, R_gt, t_gt = _two_view(rng, n=200, noise=0.3, n_out=40)
    P0, P1, m = _padded(p0, p1, 256)
    key = jax.random.PRNGKey(7)
    S = 256
    want = jpose.estimate_pose(key, jnp.asarray(P0), jnp.asarray(P1),
                               jnp.asarray(m), jnp.asarray(K_CAM, jnp.float32),
                               jnp.asarray(K_CAM, jnp.float32),
                               threshold_px=1.5, num_hypotheses=S)
    idx = np.asarray(jransac._sample_indices(key, jnp.asarray(m), S, 8))
    got = tpose.estimate_pose_from_indices(
        torch.from_numpy(idx.copy()).long(), _t(P0), _t(P1), torch.from_numpy(m),
        _t(K_CAM), _t(K_CAM), threshold_px=1.5)
    np.testing.assert_array_equal(got["inliers"].numpy(),
                                  np.asarray(want["inliers"]))
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               atol=1e-4)
    err = float(tpose.pose_error(got["R"], got["t"], _t(R_gt), _t(t_gt)))
    assert err < 2.0, err


def test_planted_chain_closes_on_the_port():
    """tests/test_pose_eval.py::test_pose_chain_on_planted_matches on the
    port: GT correspondences of 3 synthetic scenes at 640 × 480 → the
    port's estimate_pose (2048 hypotheses) → error < 1.5°."""
    rng = np.random.default_rng(0)
    w, h = 640, 480
    for trial in range(3):
        scene = jsynth.sample_scene(rng, w, h)
        u0, u1 = jsynth.gt_correspondences(scene, w, h, rng, n=512)
        assert len(u0) >= 200
        P0, P1, m = _padded(u0, u1, 512)
        out = tpose.estimate_pose(
            P0, P1, m, scene["K"], scene["K"],
            torch.Generator().manual_seed(trial), threshold_px=0.75,
            num_hypotheses=2048, device="cpu")
        err = float(tpose.pose_error(out["R"], out["t"], _t(scene["R"]),
                                     _t(scene["t"])))
        assert err < 1.5, (trial, err)


def test_ransac_batch_matches_jax_vmap_on_split_keys():
    """JAX's ransac_batch splits its key over the pairs; the port's core
    on those per-pair index sets gives the same models and inliers, and
    the port's ransac_batch is that core on its own draw."""
    rng = np.random.default_rng(5)
    pairs = [_two_view(rng, n=120, noise=0.3, n_out=20) for _ in range(3)]
    P0, P1, M = (np.stack(a) for a in zip(*[_padded(p0, p1, 128)
                                           for p0, p1, _, _ in pairs]))
    M[1, 100:] = False
    key = jax.random.PRNGKey(3)
    want = jransac.ransac_batch(key, jnp.asarray(P0), jnp.asarray(P1),
                                jnp.asarray(M), model="fundamental",
                                threshold=1.5, num_hypotheses=128)
    keys = jax.random.split(key, 3)
    idx = np.stack([np.asarray(jransac._sample_indices(
        keys[i], jnp.asarray(M[i]), 128, 8)) for i in range(3)])
    got = transac.ransac_from_indices(
        torch.from_numpy(idx).long(), _t(P0), _t(P1), torch.from_numpy(M),
        model="fundamental", threshold=1.5)
    np.testing.assert_array_equal(got["inliers"].numpy(),
                                  np.asarray(want["inliers"]))
    for b in range(3):
        mj, mt = np.asarray(want["M"][b]), got["M"][b].numpy()
        mt = mt * np.sign((mt * mj).sum())
        np.testing.assert_allclose(mt, mj, atol=1e-3 * np.abs(mj).max())

    gen = torch.Generator().manual_seed(11)
    out = transac.ransac_batch(P0, P1, M, gen, model="fundamental",
                               threshold=1.5, num_hypotheses=128,
                               device="cpu")
    idx = transac.sample_indices(torch.from_numpy(M), 128, 8,
                                 torch.Generator().manual_seed(11))
    ref = transac.ransac_from_indices(idx, _t(P0), _t(P1),
                                      torch.from_numpy(M), "fundamental", 1.5)
    for k in ("M", "inliers", "num_inliers", "score"):
        assert torch.equal(out[k], ref[k]), k
    assert (out["num_inliers"] >= torch.tensor([90, 75, 90])).all()


# --------------------------------------------------------------------------
# PnP
# --------------------------------------------------------------------------

def make_scene(rng, n_in=80, n_out=40, noise=0.5):
    """tests/test_ops_pnp.py's scene (RandomState draws)."""
    K = np.array([[900.0, 0, 480], [0, 900.0, 360], [0, 0, 1]])
    angle = 0.4
    R = np.array([[np.cos(angle), -np.sin(angle), 0],
                  [np.sin(angle), np.cos(angle), 0], [0, 0, 1]]) @ np.array(
        [[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
         [0, np.sin(0.2), np.cos(0.2)]])
    t = np.array([0.3, -0.2, 4.0])
    X = rng.uniform(-3, 3, (n_in, 3)) + np.array([0, 0, 2.0])
    x = (X @ R.T + t) @ K.T
    pts2d = x[:, :2] / x[:, 2:]
    pts2d += rng.randn(n_in, 2) * noise
    X_out = rng.uniform(-3, 3, (n_out, 3)) + np.array([0, 0, 2.0])
    p_out = rng.uniform(0, 900, (n_out, 2))
    pts2d = np.concatenate([pts2d, p_out]).astype(np.float32)
    X_all = np.concatenate([X, X_out]).astype(np.float32)
    return K, R, t, pts2d, X_all, n_in


def _pnp(p2, p3, mask, K, seed, **kw):
    return tpnp.ransac_pnp(p2, p3, mask, K, torch.Generator().manual_seed(
        seed), device="cpu", **kw)


def test_pnp_helpers_match_jax():
    rng = np.random.RandomState(6)
    K, R, t, p2d, p3d, _ = make_scene(rng, n_out=0, noise=0.0)
    xn = (np.c_[p2d, np.ones(len(p2d))] @ np.linalg.inv(K).T)[:, :2]
    xn = xn.astype(np.float32)
    q2 = np.stack([xn[i:i + 6] for i in range(0, 60, 6)])
    q3 = np.stack([p3d[i:i + 6] for i in range(0, 60, 6)])
    P_j = np.asarray(jpnp._dlt_camera_matrices(jnp.asarray(q2),
                                               jnp.asarray(q3)))
    P_t = tpnp._dlt_camera_matrices(_t(q2), _t(q3)).numpy()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-4,
                               atol=1e-4 * np.abs(P_j).max())
    r_j = np.asarray(jpnp._reprojection_errors(jnp.asarray(P_j),
                                               jnp.asarray(xn),
                                               jnp.asarray(p3d)))
    r_t = tpnp._reprojection_errors(_t(P_j), _t(xn), _t(p3d)).numpy()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4, atol=1e-9)
    sw = rng.uniform(0, 1, len(xn)).astype(np.float32)
    np.testing.assert_allclose(
        tpnp._weighted_dlt_rows(_t(xn), _t(p3d), _t(sw)).numpy(),
        np.asarray(jpnp._weighted_dlt_rows(jnp.asarray(xn), jnp.asarray(p3d),
                                           jnp.asarray(sw))), rtol=1e-6,
        atol=1e-6)
    R_j, t_j = jpnp._orthogonalize(jnp.asarray(P_j[0]), jnp.asarray(xn),
                                   jnp.asarray(p3d))
    R_t, t_t = tpnp._orthogonalize(_t(P_j[0]), _t(xn), _t(p3d))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(R_t.numpy(), R, atol=1e-3)


def test_ransac_pnp_from_jax_draw_matches_jax():
    """The JAX package's ransac_pnp and the port's core fed the Gumbel
    top-6 draw of the same key: R and t within 1e-4, the same inliers."""
    rng = np.random.RandomState(0)
    K, _, _, p2d, p3d, _ = make_scene(rng)
    mask = np.ones(len(p2d), bool)
    mask[-5:] = False
    key = jax.random.PRNGKey(0)
    S = 256
    want = jpnp.ransac_pnp(key, jnp.asarray(p2d), jnp.asarray(p3d),
                           jnp.asarray(mask), jnp.asarray(K, jnp.float32),
                           threshold_px=4.0, num_hypotheses=S)
    g = jax.random.gumbel(key, (S, len(p2d)))
    g = jnp.where(jnp.asarray(mask)[None, :], g, jransac.NEG_INF)
    idx = np.asarray(lax.top_k(g, tpnp.MIN_PNP_POINTS)[1])
    got = tpnp.ransac_pnp_from_indices(
        torch.from_numpy(idx).long(), _t(p2d), _t(p3d), torch.from_numpy(mask),
        _t(K), threshold_px=4.0)
    np.testing.assert_array_equal(got["inliers"].numpy(),
                                  np.asarray(want["inliers"]))
    assert int(got["num_inliers"]) == int(want["num_inliers"])
    assert bool(got["success"]) == bool(want["success"])
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               atol=1e-4)


def test_pnp_recovers_pose():
    rng = np.random.RandomState(0)
    K, R_gt, t_gt, p2d, p3d, n_in = make_scene(rng)
    out = _pnp(p2d, p3d, np.ones(len(p2d), bool), K, 0, threshold_px=4.0,
               num_hypotheses=512)
    assert bool(out["success"])
    inl = out["inliers"].numpy()
    assert inl[:n_in].sum() >= 0.9 * n_in
    assert inl[n_in:].sum() <= 3
    assert float(tpose.rotation_angle_deg(out["R"], _t(R_gt))) < 2.0
    assert float(np.linalg.norm(out["t"].numpy() - t_gt)) < 0.2


def test_pnp_respects_mask():
    rng = np.random.RandomState(0)
    K, _, _, p2d, p3d, n_in = make_scene(rng, n_out=0)
    p2 = np.concatenate([p2d, rng.uniform(0, 900, (32, 2)).astype(
        np.float32)])
    p3 = np.concatenate([p3d, rng.uniform(-3, 3, (32, 3)).astype(
        np.float32)])
    mask = np.concatenate([np.ones(len(p2d), bool), np.zeros(32, bool)])
    out = _pnp(p2, p3, mask, K, 1, threshold_px=4.0, num_hypotheses=256)
    inl = out["inliers"].numpy()
    assert not inl[len(p2d):].any()
    assert inl[:n_in].sum() >= 0.9 * n_in


def test_pnp_too_few_points():
    rng = np.random.RandomState(0)
    K = np.eye(3) * 500.0
    K[2, 2] = 1
    mask = np.zeros(16, bool)
    mask[:4] = True  # < 6 minimal
    out = _pnp(rng.rand(16, 2).astype(np.float32) * 100,
               rng.rand(16, 3).astype(np.float32), mask, K, 2,
               num_hypotheses=64)
    assert not bool(out["success"])


def test_pose_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    gen = torch.Generator()
    z2, z3, m = np.zeros((8, 2)), np.zeros((8, 3)), np.ones(8, bool)
    with pytest.raises(RuntimeError, match="cuda"):
        tpose.estimate_pose(z2, z2, m, K_CAM, K_CAM, gen)
    with pytest.raises(RuntimeError, match="cuda"):
        tpnp.ransac_pnp(z2, z3, m, K_CAM, gen)
    with pytest.raises(RuntimeError, match="cuda"):
        transac.ransac_batch(z2[None], z2[None], m[None], gen)


def test_refit_null_vector_is_solved_in_float64():
    """The 9 × 9 eigenproblem of the RANSAC refit runs in float64 and
    returns the input's dtype (in float32 cuSOLVER lost the null vector of
    a planted scene's normal matrix on the card, test_torch_port_cuda.py::
    test_pose_chain_and_pnp_on_card): a batch of float32 normal matrices
    gives exactly the float64 solve of the same matrices, cast back."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 64, 9, generator=g)
    ata = a.transpose(-1, -2) @ a
    got = transac._smallest_eigvec(ata)
    assert got.dtype == torch.float32 and got.shape == (3, 9)
    want = torch.linalg.eigh(ata.double())[1][..., :, 0].float()
    assert torch.equal(got, want)
