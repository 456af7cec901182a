"""Plain versions of the port's kernels K1 (stage_tail), K2
(nms_cellmax) and K6/K7 (stem_tail) against the JAX package's Pallas
kernels, run in interpret mode on the CPU, or their XLA references, and
the detection ops around them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from imcui_tpu.models import layers as jlayers
from imcui_tpu.ops import nms as jnms
from imcui_tpu.ops import pallas_conv, pallas_nms, pallas_stage1
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


def _stem_weights(rng):
    pa = {"w": jnp.asarray(rng.normal(size=(3, 3, 1, 64)) * 0.3, jnp.float32),
          "b": jnp.asarray(rng.normal(size=64) * 0.1, jnp.float32)}
    pb = {"w": jnp.asarray(rng.normal(size=(3, 3, 64, 64)) * 0.05,
                           jnp.float32),
          "b": jnp.asarray(rng.normal(size=64) * 0.1, jnp.float32)}
    return pa, pb


def _stem_torch(image, pa, pb):
    def oihw(w):
        return torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy())

    return cuda_stage1.stem_tail(
        image, oihw(pa["w"]), torch.from_numpy(np.asarray(pa["b"])),
        oihw(pb["w"]), torch.from_numpy(np.asarray(pb["b"]))).float().numpy()


# One bf16 rounding step of the result (2^-7 relative) plus 1e-3, as K1: both
# sides add the same bf16 products in f32, in another order, and round conv_a's
# output and the result to bf16.
def _stem_close(got, want):
    return np.all(np.abs(got - want) <= 1e-3 + 2.0 ** -7 * np.abs(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_tail_plain_matches_stem_xla(dtype):
    """The yardstick of the stem kernel: pallas_conv._stem_xla (which pools
    too), for an f32 image (K7's input) and a bf16 one (K6's)."""
    rng = np.random.default_rng(0)
    pa, pb = _stem_weights(rng)
    image = rng.uniform(size=(2, 40, 72)).astype(np.float32)
    timg = torch.from_numpy(image).to(getattr(torch, dtype))
    want = np.asarray(pallas_conv._stem_xla(
        jnp.asarray(timg.float().numpy()), pa["w"], pa["b"], pb["w"],
        pb["b"]), np.float32)
    got = _stem_torch(timg, pa, pb)
    assert got.shape == want.shape == (2, 20, 36, 64)
    assert _stem_close(got, want)
    # zero padding applies to conv_b's input: the border row is not what a
    # relu(b_a) halo would give
    assert np.abs(want[:, 0]).max() > 0


def test_stem_tail_plain_matches_pallas_stem_interpret():
    """pallas_stage1.stem_tail in interpret mode on the folded image, as
    tests/test_folded_conv.py runs the Pallas kernels on the CPU; its
    output unfolded. That kernel keeps conv_a's weights in f32 where
    _stem_xla (the yardstick) rounds them to bf16, so the test feeds conv_a
    weights that are bf16 values already: then both compute one function
    and the same tolerance holds."""
    rng = np.random.default_rng(1)
    pa, pb = _stem_weights(rng)
    pa["w"] = pa["w"].astype(jnp.bfloat16).astype(jnp.float32)
    image = rng.uniform(size=(1, 64, 256)).astype(np.float32)
    img16 = jnp.asarray(image).astype(jnp.bfloat16)
    fa = jlayers.fold_conv3x3(pa)
    fb = jlayers.fold_conv3x3(pb)
    want = pallas_stage1.stem_tail(jlayers.fold_width(img16[..., None]),
                                   fa["w"], fa["b"], fb["w"], fb["b"],
                                   interpret=True)
    want = np.asarray(jlayers.unfold_width(want), np.float32)
    got = _stem_torch(torch.from_numpy(image).to(torch.bfloat16), pa, pb)
    assert got.shape == want.shape == (1, 32, 128, 64)
    assert _stem_close(got, want)


def _pallas_stem_interpret(image, pa, pb):
    """``superpoint_stem_fused``'s Pallas call (pallas_conv.py:140-190) in
    interpret mode: its kernel body ``_stem_kernel`` (:66), the packed
    weights and padded image it builds, and its BlockSpecs restated with
    ``pl.ANY`` for the padded image and whole-array blocks for the
    weights, without the TPU memory spaces."""
    b, h, w = image.shape
    w1a = jnp.zeros((16, 64), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            w1a = w1a.at[dy * 4 + dx].set(pa["w"][dy, dx, 0])
    wpad = pallas_conv._round_up(w + 4, pallas_conv.LANES) + pallas_conv.LANES
    xpad = jnp.pad(image, ((0, 0), (2, pallas_conv.ROWS), (2, wpad - w - 2)))

    def whole(*shape):
        return pl.BlockSpec(shape, lambda i, j: (0,) * len(shape))

    return np.asarray(pl.pallas_call(
        functools.partial(pallas_conv._stem_kernel, w=w, wpad=wpad),
        out_shape=jax.ShapeDtypeStruct((b, h // 2, w // 2, 64), jnp.bfloat16),
        grid=(b, h // pallas_conv.T2),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), whole(16, 64),
                  whole(1, 64), whole(9, 64, 64), whole(1, 64)],
        out_specs=pl.BlockSpec((1, pallas_conv.TILE_R, w // 2, 64),
                               lambda i, j: (i, j, 0, 0)),
        interpret=True)(xpad, w1a, pa["b"].reshape(1, 64),
                        pb["w"].reshape(9, 64, 64), pb["b"].reshape(1, 64)),
        np.float32)


def test_stem_tail_plain_against_pallas_stem_body_interpret():
    """K7's own Pallas body (pallas_conv._stem_kernel) run on the CPU
    against stem_tail_plain, which follows _stem_xla's SAME padding.
    Interior outputs agree to one bf16 step at unit scale, 2^-7·max(1,
    |plain|): the body rounds conv1a's three row-tap sums and its bias add
    to bf16, so the kernel tolerance 1e-3 + 2^-7·|plain| does not hold for
    it value by value. The first and last output rows and columns differ
    by far more: the frozen body's deviation (its docstring's "~0.3
    absolute"). A restatement confirms the cause: conv1a evaluated past the
    image's edge on the zero-padded image, + b1a, relu, fed to conv1b as
    its halo where SAME padding feeds zeros, gives the body's output
    everywhere to the same bound."""
    rng = np.random.default_rng(0)
    pa, pb = _stem_weights(rng)
    image = rng.uniform(size=(2, 16, 256)).astype(np.float32)
    got = _pallas_stem_interpret(jnp.asarray(image), pa, pb)
    timg = torch.from_numpy(image)

    def oihw(w):
        return torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy())

    plain = _stem_torch(timg, pa, pb)
    assert got.shape == plain.shape == (2, 8, 128, 64)
    unit = 2.0 ** -7 * np.maximum(1.0, np.abs(plain))
    border = np.ones(plain.shape, bool)
    border[:, 1:-1, 1:-1] = False
    assert np.all(np.abs(got - plain)[~border] <= unit[~border])
    assert np.abs(got - plain)[border].max() > 0.1

    # the restatement: conv1a's outputs one pixel outside the image kept
    x = timg.to(torch.bfloat16).float()[:, None]
    wa = oihw(pa["w"]).to(torch.bfloat16).float()
    ya = torch.relu(F.conv2d(x, wa, torch.from_numpy(np.asarray(pa["b"])),
                             padding=2)).to(torch.bfloat16).float()
    z = torch.relu(F.conv2d(ya, oihw(pb["w"]).to(torch.bfloat16).float(),
                            torch.from_numpy(np.asarray(pb["b"]))))
    halo = F.max_pool2d(z, 2, 2).to(torch.bfloat16).permute(0, 2, 3, 1)
    halo = halo.float().numpy()
    assert np.all(np.abs(got - halo) <= 2.0 ** -7 * np.maximum(1.0,
                                                               np.abs(halo)))
    assert _stem_close(halo[~border], plain[~border])


def test_stem_route_of_the_backbone_matches_the_staged_route():
    """backbone(fused="stem") against backbone(fused=True) on the CPU
    (both through plain versions): the routes round conv_a's output at
    different places, so features agree to bf16 accuracy, not bitwise."""
    from imcui_tpu_torch.models.extractors import superpoint as tsp

    params = tsp.init_params(torch.Generator().manual_seed(0))
    cparams = {k: {n: t.to(torch.bfloat16) for n, t in p.items()}
               for k, p in params.items()}
    x = torch.rand((1, 1, 32, 48),
                   generator=torch.Generator().manual_seed(1)).bfloat16()
    a = tsp.backbone(cparams, x, fused=True).float()
    b = tsp.backbone(cparams, x, fused="stem").float()
    assert a.shape == b.shape == (1, 128, 4, 6)
    assert (a - b).abs().max() <= 0.05 * a.abs().max()


def test_soft_argmax_refinement_matches_jax():
    rng = np.random.default_rng(5)
    heat = rng.uniform(0, 1, (2, 40, 56)).astype(np.float32)
    kpts = np.stack([rng.integers(0, 56, (2, 30)),
                     rng.integers(0, 40, (2, 30))], -1).astype(np.float32)
    kpts[0, 0] = (0, 0)          # the patch is clamped at the corner
    kpts[1, 1] = (55, 39)
    for radius in (1, 2):
        got = tnms.soft_argmax_refinement(torch.from_numpy(kpts),
                                          torch.from_numpy(heat), radius)
        for b in range(2):
            want = jnms.soft_argmax_refinement(jnp.asarray(kpts[b]),
                                               jnp.asarray(heat[b]), radius)
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                       atol=1e-5)
    # an all-zero patch moves nothing
    still = tnms.soft_argmax_refinement(torch.from_numpy(kpts),
                                        torch.zeros((2, 40, 56)), 1)
    np.testing.assert_array_equal(still.numpy(), kpts)


def test_conv_times_refuses_without_a_card():
    """The stem/K1 timing tool measures on a card or not at all."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    from imcui_tpu_torch.tools import conv_times
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        conv_times.main([])


def test_nms_times_refuses_without_a_card():
    """K2's timing tool measures on a card or not at all."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    from imcui_tpu_torch.tools import nms_times
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        nms_times.main([])


def test_nms_times_bound_counts_the_compulsory_work():
    """K2's bound at the turbo step's 8 x 1024^2: 16.8 MB of bf16 heat read
    and 4.2 MB of cell maps written over 3.35 TB/s (6.26 us) against the
    chain's 42.375 operations a pixel at radius 4 over 67e12 a second
    (5.31 us): bytes bound it; each count grows with what it counts."""
    from imcui_tpu_torch.tools import nms_times
    nbytes, ops = nms_times.work(8, 1024, 1024, 4)
    assert nbytes == 8 * 1024 * 1024 * 2 + 2 * 8 * 256 * 256 * 4 + 8 * 8
    assert ops == 42.375 * 8 * 1024 * 1024
    b = nms_times.bound(8, 1024, 1024, 4)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    assert abs(b["bytes_ms"] - 0.006260) < 1e-6
    assert abs(b["operations_ms"] - 0.005305) < 1e-6
    assert nms_times.work(8, 1024, 1024, 6)[1] > ops > \
        nms_times.work(8, 1024, 1024, 3)[1]
    assert nms_times.work(2, 1024, 1024, 4)[0] * 4 == nbytes
