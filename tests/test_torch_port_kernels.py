"""Plain versions of the port's kernels K1 (stage_tail) and K2
(nms_cellmax) against the JAX package's Pallas kernels, run in interpret
mode on the CPU, and the detection ops around them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imcui_tpu.models import layers as jlayers
from imcui_tpu.ops import nms as jnms
from imcui_tpu.ops import pallas_nms, pallas_stage1
from imcui_tpu_torch.ops import cuda_nms, cuda_stage1
from imcui_tpu_torch.ops import nms as tnms


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def test_stage_tail_plain_matches_pallas_interpret():
    """As tests/test_folded_conv.py runs the Pallas tail: folded inputs
    built with the JAX package's fold helpers, the output unfolded.
    Tolerance: one bf16 rounding step of the result (2^-7 relative) plus
    1e-3 absolute — both sides accumulate the same bf16 products in f32,
    in different orders, and round once to bf16."""
    rng = np.random.default_rng(0)
    pa = {"w": jnp.asarray(rng.normal(size=(3, 3, 1, 64)) * 0.3, jnp.float32),
          "b": jnp.asarray(rng.normal(size=64) * 0.1, jnp.float32)}
    pb = {"w": jnp.asarray(rng.normal(size=(3, 3, 64, 64)) * 0.05,
                           jnp.float32),
          "b": jnp.asarray(rng.normal(size=64) * 0.1, jnp.float32)}
    x = jnp.asarray(rng.uniform(size=(2, 64, 256, 1)), jnp.float32)
    fa = jlayers.fold_conv3x3(pa)
    fb = jlayers.fold_conv3x3(pb)
    y_raw = jlayers.conv2d({"w": fa["w"].astype(jnp.bfloat16)},
                           jlayers.fold_width(x).astype(jnp.bfloat16))
    want = pallas_stage1.stage_tail(y_raw.astype(jnp.bfloat16), fa["b"],
                                    fb["w"], fb["b"], interpret=True)
    want = np.asarray(jlayers.unfold_width(want), np.float32)

    y_t = torch.from_numpy(np.asarray(jlayers.unfold_width(y_raw),
                                      np.float32)).to(torch.bfloat16)
    got = cuda_stage1.stage_tail(
        y_t, torch.from_numpy(np.asarray(pa["b"])),
        torch.from_numpy(np.asarray(pb["w"]).transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(np.asarray(pb["b"])))
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 32, 128, 64)
    assert np.all(np.abs(got - want) <= 1e-3 + 2.0 ** -7 * np.abs(want))


def _heat(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, h, w)).astype(np.float32)


@pytest.mark.parametrize("valid", [[[256, 128], [200, 100]],
                                   [[96, 128], [256, 81]]])
def test_nms_cellmax_plain_matches_pallas_interpret(valid):
    """Exact on both maps, including a valid_wh smaller than the canvas."""
    heat = _heat(2, 128, 256, 7)
    vwh = np.asarray(valid, np.int32)
    cm_j, cs_j = pallas_nms.nms_cellmax(_bf16(heat), jnp.asarray(vwh),
                                        radius=4, border=4, interpret=True)
    heat_t = torch.from_numpy(heat).to(torch.bfloat16)
    cm_t, cs_t = cuda_nms.nms_cellmax(heat_t, torch.from_numpy(vwh))
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))
    np.testing.assert_array_equal(cs_t.numpy(), np.asarray(cs_j))


def test_nms_cellmax_ties_take_first_column_then_row():
    """A cell holding two equal survivors reports the one in the first
    column, as the Pallas kernel's vertical-then-horizontal reduction."""
    heat = np.zeros((1, 128, 256), np.float32)
    heat[0, 40, 43] = 0.5          # cell (10, 10): dy 0, dx 3
    heat[0, 42, 41] = 0.5          # dy 2, dx 1: first column wins
    vwh = np.asarray([[256, 128]], np.int32)
    cm_j, cs_j = pallas_nms.nms_cellmax(_bf16(heat), jnp.asarray(vwh),
                                        interpret=True)
    cm_t, cs_t = cuda_nms.nms_cellmax(torch.from_numpy(heat).bfloat16(),
                                      torch.from_numpy(vwh))
    assert float(cs_t[0, 10, 10]) == float(np.asarray(cs_j)[0, 10, 10]) == 9.0
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))


def test_select_keypoints_sets_match_jax():
    """Keypoint sets equal. The heat holds 400 peaks of distinct bf16
    values over a zero floor, so no tie straddles the k-th slot."""
    rng = np.random.default_rng(3)
    heat = np.zeros((2, 128, 256), np.float32)
    vals = np.unique(np.asarray(_bf16(rng.uniform(0.01, 1.0, 4000)),
                                np.float32))
    for i in range(2):
        sel = rng.choice(vals, 400, replace=False)
        pos = rng.choice(128 * 256, 400, replace=False)
        heat[i].reshape(-1)[pos] = sel
    vwh = np.asarray([[256, 128], [200, 100]], np.int32)
    k = 200
    kp_j, sc_j, m_j = pallas_nms.select_keypoints(
        _bf16(heat), jnp.asarray(vwh), k, 0.005, interpret=True)
    kp_t, sc_t, m_t = cuda_nms.select_keypoints(
        torch.from_numpy(heat).bfloat16(), torch.from_numpy(vwh), k, 0.005)
    for i in range(2):
        sj = {tuple(p) for p in np.asarray(kp_j)[i][np.asarray(m_j)[i]]}
        st = {tuple(p) for p in kp_t[i][m_t[i]].numpy()}
        assert st == sj
    np.testing.assert_array_equal(np.sort(sc_t.numpy(), 1),
                                  np.sort(np.asarray(sc_j), 1))


def test_detection_ops_match_jax():
    heat = _heat(2, 64, 96, 11)
    vwh = np.asarray([[96, 64], [80, 50]], np.int32)
    t = torch.from_numpy(heat)
    for b in range(2):
        want = jnms.simple_nms(jnp.asarray(heat[b]), 4)
        want = want * jnms.border_mask(64, 96, 4, valid_wh=vwh[b],
                                       dtype=want.dtype)
        got = tnms.simple_nms(t[b], 4) * tnms.border_mask(
            64, 96, 4, torch.from_numpy(vwh[b:b + 1]))[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        kp_j, sc_j, m_j = jnms.select_topk_keypoints(want, 32, 0.1,
                                                     exact=True)
        kp_t, sc_t, m_t = tnms.select_topk_keypoints(got[None], 32, 0.1)
        np.testing.assert_array_equal(sc_t[0].numpy(), np.asarray(sc_j))
        np.testing.assert_array_equal(kp_t[0].numpy(), np.asarray(kp_j))
        np.testing.assert_array_equal(m_t[0].numpy(), np.asarray(m_j))
    # depth_to_space is torch's pixel shuffle
    x = np.random.default_rng(1).normal(size=(64, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tnms.depth_to_space(torch.from_numpy(x)[None], 8)[0].numpy(),
        np.asarray(jnms.depth_to_space(jnp.asarray(x), 8)))
    # descriptor sampling (f32, 1e-6: same bilinear arithmetic)
    rng = np.random.default_rng(2)
    dmap = rng.normal(size=(32, 8, 12)).astype(np.float32)
    kpts = rng.uniform(0, 90, size=(20, 2)).astype(np.float32)
    want = np.asarray(jnms.sample_descriptors(jnp.asarray(kpts),
                                              jnp.asarray(dmap), s=8))
    got = tnms.sample_descriptors(torch.from_numpy(kpts)[None],
                                  torch.from_numpy(dmap)[None], s=8)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
