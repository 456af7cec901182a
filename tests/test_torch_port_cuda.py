"""The port's CUDA kernels against their plain versions on the card, at
small shapes that do not fill the kernels' tiles (ragged edges, odd
keypoint counts, fully masked images). Needs a CUDA device and nvcc;
skips without a card. Run on the card with

    python -m pytest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from imcui_tpu_torch.models.layers import full_fp32
from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1, tap_matmul
from imcui_tpu_torch.utils import weights


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# The conv tile (csrc/stage_conv.cuh) is 4 conv rows x 64 columns: shapes at
# its edges (W 2, 62, 64, 66, 130; H on both sides of 4 and 8), three images
# of different scales (a read across images would show), the paths' shapes
# (the served request's 1 x 768 x 1024 view and its stage 2 among them) and
# the full ones.
STAGE_SHAPES = [(3, 40, 72), (1, 16, 32), (2, 130, 66),
                (1, 2, 2), (2, 6, 62), (1, 4, 64), (2, 10, 66), (1, 8, 130),
                (2, 2, 130), (3, 6, 66), (3, 12, 130),
                (8, 512, 512), (1, 640, 1024), (1, 384, 512), (1, 768, 1024),
                (8, 1024, 1024), (1, 1280, 2048)]
SCALED = {(3, 6, 66): (1.0, 8.0, 0.125), (3, 12, 130): (0.125, 1.0, 8.0)}


def _image_scales(shape, dims):
    """Per-image factors of a SCALED shape, (B, 1, ...) for a tensor of
    ``dims`` dimensions; else 1."""
    if shape not in SCALED:
        return 1.0
    return torch.tensor(SCALED[shape], device="cuda").view(
        -1, *[1] * (dims - 1))


@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_stage_tail_kernel_matches_plain(gen, shape):
    """Tolerance: one bf16 rounding step of the result."""
    b, h, w = shape
    y = (torch.randn((b, h, w, 64), generator=gen, device="cuda") * 0.5
         * _image_scales(shape, 4)).to(torch.bfloat16)
    ba = torch.randn(64, generator=gen, device="cuda") * 0.1
    wb = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * 0.05
    bb = torch.randn(64, generator=gen, device="cuda") * 0.1
    before = cuda_stage1.stage_tail.launches
    with full_fp32():
        got = cuda_stage1.stage_tail(y, ba, wb, bb).float()
        want = cuda_stage1.stage_tail_plain(y, ba, wb, bb).float()
    assert cuda_stage1.stage_tail.launches == before + 1
    assert got.shape == (b, h // 2, w // 2, 64)
    assert bool(((got - want).abs() <= 1e-3 + 2.0 ** -7 * want.abs()).all())


# K2's tile is 64 rows x 192 columns of a 256-column region: shapes at and
# off its edges (H, W multiples of 4, not of the tile), every radius, and
# heatmaps whose equal values exercise the ties: 4 bf16 levels, zero
# plateaus with -0.0 among them, negative values, and a heatmap 2 bytes
# past a 16-byte boundary (the kernel's unaligned loads).
NMS_CASES = [
    # the first cases: torch.rand, radius 3 and 4
    (3, 100, 136, 3, "rand", 4), (3, 100, 136, 4, "rand", 4),
    *[(2, 132, 260, r, kind, 4) for kind in ("rand", "ties", "plateau")
      for r in (3, 4, 5, 6)],
    (1, 4, 4, 3, "rand", 4), (1, 4, 4, 6, "ties", 0), (2, 8, 12, 4, "rand", 0),
    (1, 64, 192, 4, "ties", 8), (1, 68, 196, 4, "plateau", 8),
    (2, 60, 188, 5, "rand", 0), (1, 124, 380, 6, "plateau", 0),
    (1, 260, 580, 3, "signed", 8), (3, 132, 260, 4, "offset", 4),
    (2, 132, 260, 6, "offset", 0),
    # the paths' shapes: the turbo step, the general canvas, the served
    # request's view, a 2048 x 1536 batch at radius 3
    (8, 1024, 1024, 4, "rand", 4), (8, 1024, 1024, 4, "ties", 4),
    (1, 768, 1024, 4, "rand", 4), (1, 768, 1024, 4, "plateau", 4),
    (1, 1280, 2048, 4, "plateau", 4), (2, 1536, 2048, 3, "ties", 4)]


def nms_heat(gen, b, h, w, kind):
    """A (B, H, W) bf16 heatmap on the card of one of NMS_CASES' kinds."""
    dev = "cuda"
    if kind == "ties":
        levels = torch.tensor([0.125, 0.25, 0.5, 0.75], device=dev)
        heat = levels[torch.randint(0, 4, (b, h, w), generator=gen,
                                    device=dev)]
    elif kind == "signed":
        heat = torch.randn((b, h, w), generator=gen, device=dev)
    else:
        heat = torch.rand((b, h, w), generator=gen, device=dev)
    if kind == "plateau":
        # zero plateaus (a suppressed score is 0, not -inf), -0.0 inside
        # them and along some rows, and a lone peak on a plateau
        heat[:, h // 8:h // 2, w // 8:3 * w // 4] = 0.0
        heat[:, h // 4:h // 4 + 3, :] = -0.0
        heat[:, h // 8 + 1:h // 2:3, w // 8 + 2:3 * w // 4:5] = -0.0
        heat[:, h // 8 + 5, w // 8 + 7] = 0.5
    heat = heat.to(torch.bfloat16)
    if kind == "offset":
        flat = torch.empty(b * h * w + 1, dtype=torch.bfloat16, device=dev)
        heat = flat[1:].view(b, h, w).copy_(heat)
    return heat


def nms_valid_wh(b, h, w):
    """Image 0 fills the canvas; the others are smaller, one very narrow."""
    rows = [[w, h], [max(0, w - 46), max(0, h - 23)], [13, h],
            [w, max(0, h - 60)]]
    return torch.tensor([rows[i % 4] for i in range(b)], dtype=torch.int32,
                        device="cuda")


@pytest.mark.parametrize("b,h,w,radius,kind,border", NMS_CASES)
def test_nms_cellmax_kernel_matches_plain(gen, b, h, w, radius, kind,
                                          border):
    """Exact on both maps."""
    heat = nms_heat(gen, b, h, w, kind)
    vwh = torch.tensor([[136, 100], [90, 61], [13, 100]], dtype=torch.int32,
                       device="cuda") if (b, h, w) == (3, 100, 136) \
        else nms_valid_wh(b, h, w)
    before = cuda_nms.nms_cellmax.launches
    cm, cs = cuda_nms.nms_cellmax(heat, vwh, radius=radius, border=border)
    pm, ps = cuda_nms.nms_cellmax_plain(heat, vwh, radius=radius,
                                        border=border)
    assert cuda_nms.nms_cellmax.launches == before + 1
    assert torch.equal(cm, pm) and torch.equal(cs, ps)


@pytest.mark.parametrize("radius", [3, 4])
def test_nms_cellmax_kernel_on_a_trained_heatmap(gen, radius, monkeypatch):
    """The trained detector's bf16 heatmap of a planted pair (both views on
    a 768 x 1024 canvas, as the turbo path pads them), through the kernel
    and the plain version: exact."""
    import numpy as np

    import chip_smoke
    from imcui_tpu_torch.models.extractors import superpoint as sp
    from imcui_tpu_torch.pipeline import two_view

    params, meta = two_view.load_pretrained(device="cuda")
    assert meta["superpoint"]["pretrained"]
    img0, img1, _ = chip_smoke.synthetic_pair(100, 1000, 752)
    canvas = np.zeros((2, 1, 768, 1024), np.float32)
    canvas[0, 0, :752, :1000] = img0[..., 0] / 255.0
    canvas[1, 0, :752, :1000] = img1[..., 0] / 255.0
    vwh = np.array([[1000, 752]] * 2, np.int32)
    heats = []
    select = cuda_nms.select_keypoints

    def spy(heat, *args, **kwargs):
        heats.append(heat)
        return select(heat, *args, **kwargs)

    monkeypatch.setattr(cuda_nms, "select_keypoints", spy)
    sp.apply(params["superpoint"], canvas, vwh, nms_radius=radius,
             device="cuda")
    heat = heats[0]
    assert heat.dtype == torch.bfloat16 and heat.shape == (2, 768, 1024)
    vwh_t = torch.from_numpy(vwh).cuda()
    cm, cs = cuda_nms.nms_cellmax(heat, vwh_t, radius=radius)
    pm, ps = cuda_nms.nms_cellmax_plain(heat, vwh_t, radius=radius)
    assert int((pm > 0.0005).sum()) > 500
    assert torch.equal(cm, pm) and torch.equal(cs, ps)


def test_nms_plan_covers_every_cell(gen):
    """Blocks of 64 x 192 output pixels cover the canvas; each loads
    64 + 10r rows; the radii the path uses fit two blocks an SM."""
    for b, h, w, radius in ((8, 1024, 1024, 4), (1, 1280, 2048, 4),
                            (2, 1536, 2048, 3), (1, 4, 4, 6)):
        plan = cuda_nms.nms_plan(b, h, w, radius)
        assert plan["tile_rows"] * plan["tile_cols"] * plan["blocks"] >= \
            b * h * w
        assert plan["blocks"] == b * -(-h // plan["tile_rows"]) * \
            -(-w // plan["tile_cols"])
        assert plan["region_rows"] == plan["tile_rows"] + 10 * radius
        assert plan["blocks_per_sm"] >= (2 if radius <= 4 else 1)
        assert plan["rounds"] == -(-plan["blocks"] // (
            plan["blocks_per_sm"] * plan["sms"]))


def test_nms_cellmax_back_to_back_launches(gen):
    """Launches queued on one stream with different radii and shapes, none
    waiting for the last: each equals its plain version."""
    calls = [(nms_heat(gen, 2, 132, 260, "ties"), 3),
             (nms_heat(gen, 1, 68, 196, "plateau"), 6),
             (nms_heat(gen, 8, 1024, 1024, "rand"), 4)]
    outs = [cuda_nms.nms_cellmax(hm, nms_valid_wh(*hm.shape), radius=r)
            for hm, r in calls]
    for (hm, r), (cm, cs) in zip(calls, outs):
        pm, ps = cuda_nms.nms_cellmax_plain(hm, nms_valid_wh(*hm.shape),
                                            radius=r)
        assert torch.equal(cm, pm) and torch.equal(cs, ps)


def _masks(b, n):
    m = torch.ones((b, n), dtype=torch.bool, device="cuda")
    m[1] = False
    m[-1, n // 2:] = False
    return m


@pytest.mark.parametrize("b,n", [
    (3, 100),
    # the new tile's edges, at 12 head-sequences so that the last round of
    # blocks is partial: one query, one key tile short, exact, one over
    (3, 1), (3, 63), (3, 64), (3, 65),
    (3, 1601),                 # DINOv2 at 560^2 (the f32 dense path)
    (3, 2048)])                # mha_auto's largest K3 shape
def test_fused_attention_kernel_matches_plain(gen, b, n):
    """1e-5 · max(1, max|plain|): the same f32 arithmetic, summed in
    another order."""
    heads = 4
    q, k, v = (torch.randn((b * heads, n, 64), generator=gen, device="cuda")
               * 2 for _ in range(3))
    mask = _masks(b, n)
    with full_fp32():
        got = attention.fused_attention(q, k, v, mask, heads)
        want = attention.fused_attention_plain(q, k, v, mask, heads)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("b,n,m,tol", [
    (2, 100, 70, 1e-5),
    (3, 1, 1024, 1e-5),
    (3, 130, 70, 1e-5),
    # f32 sums over 4096 keys: the bound chip_smoke.py holds this size to
    (3, 4096, 4096, 2e-5)])
def test_bidirectional_attention_kernel_matches_plain(gen, b, n, m, tol):
    heads = 4
    a0, v0 = (torch.randn((b * heads, n, 64), generator=gen, device="cuda")
              * 2 for _ in range(2))
    a1, v1 = (torch.randn((b * heads, m, 64), generator=gen, device="cuda")
              * 2 for _ in range(2))
    m0, m1 = _masks(b, n), _masks(b, m)
    with full_fp32():
        got = attention.bidirectional_attention(a0, a1, v0, v1, m0, m1, heads)
        want = attention.bidirectional_attention_plain(a0, a1, v0, v1, m0, m1,
                                                       heads)
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol * scale


def test_attention_without_mask_equals_all_valid_mask(gen):
    """K3 and K4 with a null mask and with an all-ones mask: bit-identical
    outputs (the kernel reads no mask when none is given)."""
    b, n, m, heads = 2, 300, 200, 4
    x = [torch.randn((b * heads, r, 64), generator=gen, device="cuda")
         for r in (n, m, n, m)]     # a0, a1, v0, v1
    ones_n = torch.ones((b, n), dtype=torch.bool, device="cuda")
    ones_m = torch.ones((b, m), dtype=torch.bool, device="cuda")
    assert torch.equal(attention.fused_attention(x[0], x[0], x[2], None, heads),
                       attention.fused_attention(x[0], x[0], x[2], ones_n,
                                                 heads))
    for g, w in zip(
            attention.bidirectional_attention(*x, None, None, heads),
            attention.bidirectional_attention(*x, ones_n, ones_m, heads)):
        assert torch.equal(g, w)


def test_attention_launches_back_to_back(gen):
    """Two launches of each kernel queued on one stream before either
    output is read agree with their plain versions (1e-5 · max(1,
    max|plain|))."""
    heads = 4
    x = [torch.randn((2 * heads, n, 64), generator=gen, device="cuda") * 2
         for n in (1024, 777, 1024, 777)]
    m = [_masks(2, 1024), _masks(2, 777)]
    calls = [(attention.fused_attention, attention.fused_attention_plain,
              (x[0], x[0], x[2], m[0])),
             (attention.fused_attention, attention.fused_attention_plain,
              (x[1], x[1], x[3], m[1])),
             (attention.bidirectional_attention,
              attention.bidirectional_attention_plain,
              (x[0], x[1], x[2], x[3], m[0], m[1])),
             (attention.bidirectional_attention,
              attention.bidirectional_attention_plain,
              (x[1], x[0], x[3], x[2], m[1], m[0]))]
    with full_fp32():
        got = [kernel(*args, heads) for kernel, _, args in calls]
        torch.cuda.synchronize()
        for g, (_, plain, args) in zip(got, calls):
            want = plain(*args, heads)
            for gg, w in zip(g if isinstance(g, tuple) else (g,),
                             want if isinstance(want, tuple) else (want,)):
                assert (gg - w).abs().max().item() <= 1e-5 * max(
                    1.0, w.abs().max().item())


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    with pytest.raises(ValueError):
        cuda_stage1.stage_tail(
            torch.zeros((1, 8, 8, 64), device="cuda"),  # float32, not bf16
            torch.zeros(64, device="cuda"),
            torch.zeros((64, 64, 3, 3), device="cuda"),
            torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError):
        cuda_nms.nms_cellmax(torch.zeros((1, 10, 16), dtype=torch.bfloat16,
                                         device="cuda"),
                             torch.ones((1, 2), dtype=torch.int32,
                                        device="cuda"))
    q = torch.zeros((4, 16, 32), device="cuda")  # head dim 32, not 64
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, q, None, 4)


def test_lightglue_on_card_matches_cpu(gen):
    """forward_pair through K3/K4 on the card against the plain versions
    on the CPU: matches0 equal, scores within 1e-4 (f32, TF32 off)."""
    from imcui_tpu_torch.models.matchers import lightglue as lg
    from imcui_tpu_torch.utils.weights import to_device as _to

    params = lg.init_params(torch.Generator().manual_seed(1), n_layers=2)
    g = torch.Generator().manual_seed(2)
    b, n = 2, 100
    kpts0 = torch.rand((b, n, 2), generator=g) * 120
    desc0 = torch.nn.functional.normalize(torch.randn((b, n, 256),
                                                      generator=g), dim=-1)
    perm = torch.randperm(n, generator=g)
    kpts1 = kpts0[:, perm] + torch.randn((b, n, 2), generator=g)
    desc1 = torch.nn.functional.normalize(
        desc0[:, perm] + 0.05 * torch.randn((b, n, 256), generator=g), dim=-1)
    mask0 = torch.ones((b, n), dtype=torch.bool)
    mask1 = torch.ones((b, n), dtype=torch.bool)
    mask1[1, 70:] = False
    size = torch.tensor([[128.0, 96.0], [120.0, 90.0]])
    args = (kpts0, kpts1, desc0, desc1, mask0, mask1, size, size)
    want = lg.forward_pair(params, *args, match_threshold=0.0, device="cpu")
    launches = attention.fused_attention.launches
    got = lg.forward_pair(_to(params, "cuda"), *args, match_threshold=0.0,
                          device="cuda")
    assert attention.fused_attention.launches == launches + 2
    assert torch.equal(got["matches0"].cpu(), want["matches0"])
    assert torch.allclose(got["matching_scores0"].cpu(),
                          want["matching_scores0"], atol=1e-4)


def test_superpoint_bf16_on_card_matches_cpu(gen):
    """SuperPoint bf16 through K1/K2 on the card against the plain versions
    on the CPU. cuDNN and the CPU round bf16 convolutions differently, so
    keypoint sets are compared: IoU >= 0.9 per image."""
    import numpy as np

    import chip_smoke
    from imcui_tpu_torch.models.extractors import superpoint as sp
    from imcui_tpu_torch.pipeline import two_view
    from imcui_tpu_torch.utils.weights import to_device

    params, _ = two_view.load_pretrained(device="cpu")
    img = np.stack([chip_smoke.textured_image(np.random.default_rng(s),
                                              160, 224)
                    for s in (5, 6)])[:, None].astype(np.float32) / 255
    vwh = np.array([[224, 160], [200, 150]], np.int32)
    kw = dict(max_keypoints=256, keypoint_threshold=0.0005)
    want = sp.apply(params["superpoint"], img, vwh, device="cpu", **kw)
    got = sp.apply(to_device(params["superpoint"], "cuda"), img, vwh,
                   device="cuda", **kw)
    for i in range(2):
        sw = {tuple(p) for p in want["keypoints"][i][want["mask"][i]].tolist()}
        sg = {tuple(p) for p in
              got["keypoints"][i][got["mask"][i]].cpu().tolist()}
        assert len(sw) > 50 and len(sw & sg) / len(sw | sg) >= 0.9


@pytest.mark.parametrize("radius", [2, 7])
def test_superpoint_bf16_outside_the_nms_gate_launches_no_k2(gen, radius,
                                                             monkeypatch):
    """Outside 3 <= nms_radius <= 6 the bf16 apply on the card routes to the
    reference's per-pixel chain: no K2 launch, and the keypoints and
    scores equal the CPU's chain on the same heatmap."""
    import numpy as np

    import chip_smoke
    from imcui_tpu_torch.models.extractors import superpoint as sp
    from imcui_tpu_torch.pipeline import two_view
    from imcui_tpu_torch.utils.weights import to_device

    params, _ = two_view.load_pretrained(device="cpu")
    img = np.stack([chip_smoke.textured_image(np.random.default_rng(s),
                                              160, 224)
                    for s in (5, 6)])[:, None].astype(np.float32) / 255
    vwh = np.array([[224, 160], [200, 150]], np.int32)
    # more slots than survivors, so no tie straddles the last slot
    kw = dict(nms_radius=radius, max_keypoints=8192,
              keypoint_threshold=0.0005)
    heats = []
    chain = sp._select_per_pixel

    def spy(heat, *args):
        heats.append(heat)
        return chain(heat, *args)

    monkeypatch.setattr(sp, "_select_per_pixel", spy)
    before = cuda_nms.nms_cellmax.launches
    got = sp.apply(to_device(params["superpoint"], "cuda"), img, vwh,
                   device="cuda", **kw)
    assert cuda_nms.nms_cellmax.launches == before
    assert len(heats) == 1 and heats[0].is_cuda
    want = chain(heats[0].cpu(), torch.from_numpy(vwh), radius, 4, 8192,
                 0.0005)
    for i in range(2):
        sw = {tuple(p) for p in want[0][i][want[2][i]].tolist()}
        sg = {tuple(p) for p in
              got["keypoints"][i][got["mask"][i]].cpu().tolist()}
        assert len(sw) > 20 and sg == sw
        assert torch.equal(got["scores"][i].cpu().sort().values,
                           want[1][i].float().sort().values)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("nq,nk,dh,dtype,b", [
    (100, 100, 64, F32, 3), (70, 333, 64, F32, 3), (129, 65, 128, F32, 3),
    (100, 100, 64, BF16, 3), (65, 200, 128, BF16, 3),
    # the new bodies' key-tile edges: one key, a 64-key tile (the f32 tile)
    # and a 128-key tile (the bf16 one) short, exact and one over
    *[(100, nk, 64, t, 3) for nk in (1, 63, 64, 65, 127, 128, 129)
      for t in (F32, BF16)],
    # query tiles: on both sides of 64, 112 and 128 rows
    *[(nq, 200, 64, t, 3) for nq in (63, 65, 111, 113, 127, 129)
      for t in (F32, BF16)],
    # the general path's launch: both views of one pair, 4 heads each
    (4096, 4096, 64, F32, 2), (4096, 4096, 64, BF16, 2),
    # head dim 128: its key tiles (32 keys f32, 64 bf16) and a long walk
    (100, 33, 128, F32, 3), (100, 65, 128, BF16, 3),
    (130, 2048, 128, F32, 2), (130, 2048, 128, BF16, 2)])
def test_flash_attention_kernel_matches_plain(gen, nq, nk, dh, dtype, b):
    """f32: 1e-5 · max(1, max|plain|), the same arithmetic summed in another
    order; bf16 in and out: one rounding step of the result, 2^-7."""
    heads = 4
    q = (torch.randn((b * heads, nq, dh), generator=gen, device="cuda") * 2
         ).to(dtype)
    k, v = ((torch.randn((b * heads, nk, dh), generator=gen, device="cuda")
             * 2).to(dtype) for _ in range(2))
    mask = _masks(b, nk)
    before = attention.flash_attention.launches
    with full_fp32():
        got = attention.flash_attention(q, k, v, mask, heads)
        want = attention.flash_attention_plain(q, k, v, mask, heads)
    assert attention.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def _flash_inputs(gen, s, nq, nk, dh, dtype):
    return [(torch.randn((s, n, dh), generator=gen, device="cuda") * 2
             ).to(dtype) for n in (nq, nk, nk)]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_without_mask_equals_all_valid_mask(gen, dtype, dh):
    """K5 with a null mask and with an all-ones mask: bit-identical."""
    q, k, v = _flash_inputs(gen, 8, 300, 333, dh, dtype)
    ones = torch.ones((2, 333), dtype=torch.bool, device="cuda")
    assert torch.equal(attention.flash_attention(q, k, v, None, 4),
                       attention.flash_attention(q, k, v, ones, 4))


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_every_view_masked_is_mean_of_v(gen, dtype, dh):
    """Every key of every view masked: each query gets the mean of V (of
    its bf16 values), over keys that span several tiles of either body and
    a ragged last one. f32: 1e-5 · max(1, |mean|); bf16: 2^-7 · max(1,
    |mean|)."""
    q, k, v = _flash_inputs(gen, 8, 77, 300, dh, dtype)
    none = torch.zeros((2, 300), dtype=torch.bool, device="cuda")
    got = attention.flash_attention(q, k, v, none, 4).float()
    mean = v.float().mean(1, keepdim=True).expand_as(got)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got - mean).abs() <= tol * mean.abs().clamp_min(1.0)).all())


def test_flash_attention_back_to_back_launches(gen):
    """Four launches of other types, head dims and shapes (other bodies and
    plans) queued on one stream before any output is read: each matches."""
    calls = [(8, 4096, 4096, 64, F32), (12, 257, 129, 64, BF16),
             (8, 130, 2048, 128, BF16), (12, 300, 70, 128, F32)]
    args = [(*_flash_inputs(gen, s, nq, nk, dh, t), _masks(s // 4, nk))
            for s, nq, nk, dh, t in calls]
    before = attention.flash_attention.launches
    with full_fp32():
        got = [attention.flash_attention(*a, 4) for a in args]
        torch.cuda.synchronize()
        assert attention.flash_attention.launches == before + 4
        for g, a, (*_, t) in zip(got, args, calls):
            want = attention.flash_attention_plain(*a, 4).float()
            tol = 1e-5 if t == F32 else 2.0 ** -7
            assert (g.float() - want).abs().max().item() <= tol * max(
                1.0, want.abs().max().item())


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_bf16_cancellation(gen, dh):
    """Two live keys, v = +16 and -16, weights w and 1 - w near 1/2 that
    are not bf16 values: the output 16 (2w - 1) lies near 0, in (-0.4,
    0.4), where the tolerance is 2^-7. Weights rounded once to bf16 (error
    up to 2^-9 each) miss it, which the test shows on the card; K5 carries
    P as a bf16 high and low part and must hold it. The other keys of the
    tile are masked."""
    s, nq, nk = 4, 256, 130
    q = torch.randn((s, nq, dh), generator=gen, device="cuda")
    q[:, :, 0] = torch.linspace(-0.05, 0.05, nq, device="cuda")
    k = torch.randn((s, nk, dh), generator=gen, device="cuda")
    k[:, :2] = 0.0
    k[:, 0, 0] = dh ** 0.5           # logit of key 0: q[:, :, 0]; key 1: 0
    v = torch.randn((s, nk, dh), generator=gen, device="cuda")
    v[:, 0], v[:, 1] = 16.0, -16.0
    mask = torch.zeros((1, nk), dtype=torch.bool, device="cuda")
    mask[0, :2] = True
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    with full_fp32():
        want = attention.flash_attention_plain(q, k, v, mask, 4).float()
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / dh ** 0.5
        p = torch.exp(logits - logits[:, :, :2].amax(-1, keepdim=True))
        p[:, :, 2:] = 0.0
        once = torch.matmul(p.to(torch.bfloat16).float(), v.float()) / p.sum(
            -1, keepdim=True)
    assert want.abs().max().item() < 1.0
    assert (once - want).abs().max().item() > 2.0 ** -7
    got = attention.flash_attention(q, k, v, mask, 4).float()
    assert (got - want).abs().max().item() <= 2.0 ** -7


@pytest.mark.parametrize("shape,dtype", [
    ((3, 40, 72), torch.float32), ((1, 16, 32), torch.bfloat16),
    ((2, 130, 66), torch.float32), ((1, 2, 2), torch.bfloat16)] + [
    (shape, dtype) for shape in STAGE_SHAPES[3:]
    for dtype in (torch.float32, torch.bfloat16)])
def test_stem_tail_kernel_matches_plain(gen, shape, dtype):
    """Tolerance: one bf16 rounding step of the result, as stage_tail."""
    img = (torch.rand(shape, generator=gen, device="cuda")
           * _image_scales(shape, 3)).to(dtype)
    wa = torch.randn((64, 1, 3, 3), generator=gen, device="cuda") * 0.3
    ba = torch.randn(64, generator=gen, device="cuda") * 0.1
    wb = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * 0.05
    bb = torch.randn(64, generator=gen, device="cuda") * 0.1
    before = cuda_stage1.stem_tail.launches
    got = cuda_stage1.stem_tail(img, wa, ba, wb, bb).float()
    want = cuda_stage1.stem_tail_plain(img, wa, ba, wb, bb).float()
    assert cuda_stage1.stem_tail.launches == before + 1
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    assert bool(((got - want).abs() <= 1e-3 + 2.0 ** -7 * want.abs()).all())


def _conv_weights(gen, halo_test=False):
    """w_a, b_a, w_b, b_b of a stage. ``halo_test``: b_a > 0, W_b < 0 and
    b_b = 20, so on an input of zeros conv_b's output falls with every tap
    that reads relu(b_a) and stays positive: a corner sums 4 such taps, an
    edge 6, the interior 9."""
    wa = torch.randn((64, 1, 3, 3), generator=gen, device="cuda") * 0.3
    ba = torch.randn(64, generator=gen, device="cuda") * 0.1
    wb = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * 0.05
    bb = torch.randn(64, generator=gen, device="cuda") * 0.1
    if halo_test:
        ba, wb, bb = ba.abs() + 0.5, -0.2 * wb.abs(), bb * 0 + 20.0
    return wa, ba, wb, bb


@pytest.mark.parametrize("shape", [(2, 6, 66), (1, 8, 130)])
def test_conv_kernels_keep_relu_of_b_a_out_of_the_halo(gen, shape):
    """On an input of zeros conv_b reads relu(0 + b_a) > 0 inside the image
    and must read 0 outside it (SAME padding after the prologue). With
    _conv_weights' halo test a pooled corner then holds the conv corner's
    value, above the interior's by 5 of 9 taps; relu(b_a) leaking into the
    halo would bring it down to the interior's. Both kernels also match
    their plain versions, which pad with zeros."""
    b, h, w = shape
    wa, ba, wb, bb = _conv_weights(gen, halo_test=True)
    y = torch.zeros((b, h, w, 64), device="cuda", dtype=torch.bfloat16)
    img = torch.zeros((b, h, w), device="cuda")
    for got, want in (
            (cuda_stage1.stage_tail(y, ba, wb, bb),
             cuda_stage1.stage_tail_plain(y, ba, wb, bb)),
            (cuda_stage1.stem_tail(img, wa, ba, wb, bb),
             cuda_stage1.stem_tail_plain(img, wa, ba, wb, bb))):
        got, want = got.float(), want.float()
        assert bool(((got - want).abs() <= 1e-3 + 2.0 ** -7 * want.abs()
                     ).all())
        inner = got[:, 1, 1]
        assert (inner > 0).all()
        for corner in (got[:, 0, 0], got[:, -1, -1], got[:, 0, -1],
                       got[:, -1, 0]):
            assert (corner - inner > 0.03 * inner).all()


def test_conv_kernels_back_to_back_launches(gen):
    """Launches at different shapes and image types (other grids, another
    weight map each) queued on one stream before any output is read."""
    wa, ba, wb, bb = _conv_weights(gen)
    wb2 = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * 0.05
    imgs = [torch.rand((3, 40, 72), generator=gen, device="cuda"),
            torch.rand((1, 130, 66), generator=gen, device="cuda"
                       ).to(torch.bfloat16)]
    y = (torch.randn((2, 36, 130, 64), generator=gen, device="cuda") * 0.5
         ).to(torch.bfloat16)
    before = (cuda_stage1.stem_tail.launches, cuda_stage1.stage_tail.launches)
    got = [cuda_stage1.stem_tail(imgs[0], wa, ba, wb, bb),
           cuda_stage1.stage_tail(y, ba, wb2, bb),
           cuda_stage1.stem_tail(imgs[1], wa, ba, wb2, bb)]
    torch.cuda.synchronize()
    assert (cuda_stage1.stem_tail.launches,
            cuda_stage1.stage_tail.launches) == (before[0] + 2, before[1] + 1)
    want = [cuda_stage1.stem_tail_plain(imgs[0], wa, ba, wb, bb),
            cuda_stage1.stage_tail_plain(y, ba, wb2, bb),
            cuda_stage1.stem_tail_plain(imgs[1], wa, ba, wb2, bb)]
    for g, t in zip(got, want):
        g, t = g.float(), t.float()
        assert bool(((g - t).abs() <= 1e-3 + 2.0 ** -7 * t.abs()).all())


def test_conv_plan_covers_every_tile(gen):
    """The launch plan: tiles of 4 conv rows x 64 columns; every 64-column
    strip of every image cut into segments that cover all its tiles, none
    of them empty; one CTA an SM and at most one a segment (the persistent
    grid walks the rest)."""
    for b, h, w in STAGE_SHAPES:
        plan = cuda_stage1.conv_plan(b, h, w)
        tiles_h = -(-h // 4)
        assert (plan["tile_rows"], plan["tile_cols"]) == (4, 64)
        assert plan["strips"] == b * -(-w // 64)
        segs, length = plan["segments_per_strip"], plan["segment_tiles"]
        assert segs * length >= tiles_h > (segs - 1) * length
        assert plan["ctas"] == min(plan["strips"] * segs, plan["sms"])


def test_new_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.zeros((4, 16, 32), device="cuda")  # head dim 32
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q, None, 4)
    q = torch.zeros((4, 16, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q, None, 4)
    w = torch.zeros((64, 64, 3, 3), device="cuda")
    with pytest.raises(ValueError):
        cuda_stage1.stem_tail(torch.zeros((1, 15, 16), device="cuda"),
                              w[:, :1], w[0, :, 0, 0], w, w[0, :, 0, 0])


def test_adaptive_lightglue_on_card_matches_cpu(gen):
    """forward_pair_adaptive through K5/K4 on the card (2304 keypoint slots,
    above K3's range) against the plain versions on the CPU: stop_layer and
    matches0 equal, scores within 1e-4 (f32, TF32 off). Head 0 is saturated
    so both pairs leave after the first layer through head 0."""
    from imcui_tpu_torch.models.matchers import lightglue as lg
    from imcui_tpu_torch.utils.weights import to_device

    params = lg.init_params(torch.Generator().manual_seed(1), n_layers=3)
    tok = params["token_confidence"][0]["token"]
    tok["w"].zero_()
    tok["b"].fill_(10.0)
    g = torch.Generator().manual_seed(2)
    b, n = 2, 2304
    kpts0 = torch.rand((b, n, 2), generator=g) * 1500
    desc0 = torch.nn.functional.normalize(torch.randn((b, n, 256),
                                                      generator=g), dim=-1)
    perm = torch.randperm(n, generator=g)
    kpts1 = kpts0[:, perm] + torch.randn((b, n, 2), generator=g)
    desc1 = torch.nn.functional.normalize(
        desc0[:, perm] + 0.05 * torch.randn((b, n, 256), generator=g), dim=-1)
    mask0 = torch.ones((b, n), dtype=torch.bool)
    mask1 = torch.ones((b, n), dtype=torch.bool)
    mask1[1, 2000:] = False
    size = torch.tensor([[1600.0, 1200.0]] * b)
    args = (kpts0, kpts1, desc0, desc1, mask0, mask1, size, size)
    want = lg.forward_pair_adaptive(params, *args, match_threshold=0.0,
                                    device="cpu")
    launches = attention.flash_attention.launches
    got = lg.forward_pair_adaptive(to_device(params, "cuda"), *args,
                                   match_threshold=0.0, device="cuda")
    assert attention.flash_attention.launches == launches + 1
    assert got["stop_layer"].tolist() == want["stop_layer"].tolist() == [1, 1]
    assert torch.equal(got["matches0"].cpu(), want["matches0"])
    assert torch.allclose(got["matching_scores0"].cpu(),
                          want["matching_scores0"], atol=1e-4)


def test_image_matching_api_on_card(gen):
    """ImageMatchingAPI on the card at a small canvas: the planted
    homography gate of chip_smoke.py, and K1, K2, K3, K4 launched."""
    import numpy as np

    import chip_smoke
    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.ui import utils as ui

    conf = ui.parse_match_config({"feature": "superpoint_inloc",
                                  "matcher": "superpoint-lightglue",
                                  "dense": False})
    api = ImageMatchingAPI(conf, device="cuda", max_keypoints=1024,
                           detect_threshold=0.005)
    img0, img1, hm = chip_smoke.synthetic_pair(100, 601, 451)
    before = (cuda_stage1.stage_tail.launches, cuda_nms.nms_cellmax.launches,
              attention.fused_attention.launches,
              attention.bidirectional_attention.launches)
    res = api(img0, img1)
    after = (cuda_stage1.stage_tail.launches, cuda_nms.nms_cellmax.launches,
             attention.fused_attention.launches,
             attention.bidirectional_attention.launches)
    assert all(a > b for a, b in zip(after, before))
    err = chip_smoke.transfer_errors(hm, res["mmkeypoints0_orig"],
                                     res["mmkeypoints1_orig"])
    assert len(err) >= chip_smoke.GATE_MIN_INLIERS
    assert np.median(err) <= chip_smoke.GATE_MEDIAN_PX


# K14's shapes: the dense paths' (RoMa's DINOv2 at 1601 tokens, DUSt3R's
# and MASt3R's 768-token encoder at 16 heads and decoder at 12); one key
# (tile) and one query; keys on
# both sides of the 64- and 128-key edges and at the route's limit; queries
# on both sides of the 64-row CTA's edges, and ragged against the 128- and
# 192-row multiples; and heads enough for several rounds of CTAs (64 x 1000:
# 1024 CTAs, two an SM on 132 SMs).
QTILED_SHAPES = [
    (16, 1601, 1601), (12, 1024, 1024), (16, 768, 768), (12, 768, 768),
    (3, 50, 77), (2, 197, 197),
    (1, 1, 1), (2, 33, 2048), (4, 1024, 16),
    (3, 65, 63), (3, 129, 64), (3, 191, 65), (5, 127, 127), (5, 255, 128),
    (5, 257, 129), (2, 1000, 2048), (16, 4607, 129), (16, 4609, 65),
    (64, 1000, 63)]


def _qtiled_inputs(gen, h, nq, nk):
    """bf16 q, k, v whose heads differ in scale: the logits by up to 4x and
    v by 16x from head to head, so that a read across a head boundary
    shows against the head's own tolerance."""
    g = torch.tensor([0.5, 1.0, 2.0], device="cuda")[torch.arange(h) % 3]
    gv = torch.tensor([1.0, 16.0, 1 / 16], device="cuda")[torch.arange(h) % 3]
    q, k, v = (torch.randn((h, n, 64), generator=gen, device="cuda") * 1.5
               for n in (nq, nk, nk))
    return ((q * g[:, None, None]).to(torch.bfloat16),
            (k * g[:, None, None]).to(torch.bfloat16),
            (v * gv[:, None, None]).to(torch.bfloat16))


def _assert_qtiled_close(got, q, k, v):
    """One bf16 rounding of the output, 2^-7 * max(1, |plain|), plus 2^-9 *
    max|v| of the head for the weights the kernel rounds to bf16 before its
    tensor-core readout."""
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention.qtiled_attention_plain(q, k, v).float()
    tol = 2.0 ** -7 * want.abs().clamp_min(1.0) \
        + 2.0 ** -9 * v.float().abs().amax((1, 2), keepdim=True)
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("h,nq,nk", QTILED_SHAPES)
def test_qtiled_attention_kernel_matches_plain(gen, h, nq, nk):
    """bf16 in and out, within _assert_qtiled_close's tolerance."""
    q, k, v = _qtiled_inputs(gen, h, nq, nk)
    before = attention.qtiled_attention.launches
    got = attention.qtiled_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.qtiled_attention.launches == before + 1
    _assert_qtiled_close(got, q, k, v)


def test_qtiled_attention_plan_covers_every_row(gen):
    """The launch plan: CTAs of 64 query rows covering every row of every
    head, two of them an SM (the design's occupancy, which the registers
    and shared memory of the built kernel must allow)."""
    for h, nq, nk in QTILED_SHAPES:
        plan = attention.qtiled_plan(h, nq, nk)
        assert plan["rows_per_cta"] == 64
        assert plan["ctas"] == h * -(-nq // 64)
        assert plan["ctas_per_sm"] == 2
        assert plan["busiest_sm_rows"] == -(-plan["ctas"] // plan["sms"]) * 64


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("nk", [129, 1601])
def test_qtiled_attention_peak_in_first_or_last_key_tile(gen, where, nk):
    """Rows whose largest logit lies in the first key tile, and rows whose
    largest lies in the last (ragged) one, where the running maximum jumps
    and the sum and the output are rescaled. The first 64 rows of each head
    lie near one direction u and the peak key is along u, with a logit of
    ~12 against ~N(0, 2.25) for the others, so the rest still weigh in."""
    h, nq = 3, 200
    q, k, v = (torch.randn((h, n, 64), generator=gen, device="cuda") * 1.5
               for n in (nq, nk, nk))
    u = torch.randn((h, 1, 64), generator=gen, device="cuda") * 1.5
    key = 0 if where == "first" else nk - 1
    q[:, :64] = u + 0.1 * q[:, :64]
    k[:, key] = (96.0 / (u * u).sum(-1)) * u[:, 0]
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / 8
    assert bool((logits[:, :64].argmax(-1) == key).all())
    got = attention.qtiled_attention(q, k, v)
    torch.cuda.synchronize()
    _assert_qtiled_close(got, q, k, v)


def test_qtiled_attention_back_to_back_launches(gen):
    """Two launches at different shapes (other plans and tensor maps)
    queued on one stream before either output is read: both match."""
    a = _qtiled_inputs(gen, 16, 1601, 1601)
    b = _qtiled_inputs(gen, 5, 257, 129)
    before = attention.qtiled_attention.launches
    got_a = attention.qtiled_attention(*a)
    got_b = attention.qtiled_attention(*b)
    torch.cuda.synchronize()
    assert attention.qtiled_attention.launches == before + 2
    _assert_qtiled_close(got_a, *a)
    _assert_qtiled_close(got_b, *b)


def test_qtiled_attention_peaked_rows_and_refusals(gen):
    """Rows whose softmax is one-hot return that key's v exactly; shapes
    the kernel does not take raise before any launch."""
    q = torch.zeros((2, 40, 64), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((2, 100, 64), device="cuda", dtype=torch.bfloat16)
    q[:, :, 0] = 64.0
    k[:, 37, 0] = 64.0           # logit 512 at key 37, 0 elsewhere
    v = torch.randn((2, 100, 64), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    got = attention.qtiled_attention(q, k, v)
    assert torch.equal(got, v[:, 37:38].expand(-1, 40, -1))
    with pytest.raises(ValueError):
        attention.qtiled_attention(q[..., :32].contiguous(),
                                   k[..., :32].contiguous(),
                                   v[..., :32].contiguous())
    with pytest.raises(ValueError):
        attention.qtiled_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        attention.qtiled_attention(q.transpose(0, 1), k, v)
    big = torch.zeros((1, 4096, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.qtiled_attention(big, big, big)


@pytest.mark.parametrize("dtype,n,kernel", [
    (torch.float32, 1601, "fused_attention"),
    (torch.bfloat16, 1601, "qtiled_attention"),
    (torch.float32, 2304, "flash_attention")])
def test_mha_auto_on_card_counts_its_kernel(gen, dtype, n, kernel):
    """Each route of mha_auto launches its kernel once and agrees with the
    plain attention: f32 1e-5 * max(1, |plain|), bf16 as above."""
    q, k, v = (torch.randn((16, n, 64), generator=gen, device="cuda"
                           ).to(dtype) for _ in range(3))
    fn = getattr(attention, kernel)
    before = fn.launches
    with full_fp32():
        got = attention.mha_auto(q, k, v).float()
        want = attention.mha(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 + 2.0 ** -9 * float(
        v.float().abs().max())
    assert float((got - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("precision,kernel,tol", [
    (None, "fused_attention", 1e-4), ("bf16", "qtiled_attention", 2.0 ** -4)])
def test_dinov2_on_card_matches_cpu(gen, precision, kernel, tol):
    """A two-block DINOv2 with Dh = 64 at a ragged 8 x 11 grid: the card
    (K3 in f32, K14 in bf16) against the CPU's plain versions on the same
    weights, LayerScale drawn near 1. f32: 1e-4 of normed tokens of order
    1; bf16: 2^-4, as the CPU test against the JAX package."""
    from imcui_tpu_torch.models import layers
    from imcui_tpu_torch.models.backbones import dinov2
    from imcui_tpu_torch.utils.weights import to_device

    cfg = {"dim": 128, "depth": 2, "num_heads": 2, "mlp_ratio": 4,
           "patch": 14, "pretrain_grid": 37}
    cpu_gen = torch.Generator().manual_seed(1)
    params = dinov2.init_params(cpu_gen, cfg)
    for blk in params["blocks"]:
        for ls in ("ls1", "ls2"):
            blk[ls]["gamma"] = torch.rand(128, generator=cpu_gen) + 0.5
    params = layers.apply_precision(params, precision)
    img = torch.rand((3, 112, 154), generator=cpu_gen)
    if precision:
        img = img.to(torch.bfloat16)
    fn = getattr(attention, kernel)
    before = fn.launches
    with full_fp32():
        got, grid = dinov2.apply(to_device(params, "cuda"), img.cuda(), cfg)
        want, _ = dinov2.apply(params, img, cfg)
    assert grid == (8, 11) and fn.launches == before + 2
    err = float((got.float().cpu() - want.float()).abs().max())
    assert err <= tol * max(1.0, float(want.float().abs().max()))


def test_roma_tiny_on_card_matches_cpu(gen):
    """The whole of RoMa (tiny DINOv2, published widths elsewhere) at
    112 x 112 in f32: warp and certainty on the card against the CPU, 1e-3
    of warps that reach a few units (cuDNN and cuBLAS sum in another
    order through six stages)."""
    from imcui_tpu_torch.models.matchers import roma
    from imcui_tpu_torch.utils.weights import to_device

    conf = {"dinov2_variant": "test", "gp_dim": 512}
    cpu_gen = torch.Generator().manual_seed(2)
    params = roma.init_params(cpu_gen, conf)
    img0, img1 = (torch.rand((3, 112, 112), generator=cpu_gen)
                  for _ in range(2))
    with torch.inference_mode(), full_fp32():
        want_w, want_c = roma.match_gp(params, img0, img1, conf)
        got_w, got_c = roma.match_gp(to_device(params, "cuda"), img0.cuda(),
                                     img1.cuda(), conf)
    assert got_w.shape == (112, 112, 2)
    assert float((got_w.cpu() - want_w).abs().max()) <= 1e-3
    assert float((got_c.cpu() - want_c).abs().max()) <= 1e-3


def _tap_inputs(gen, m, n, r, dtype, layout="taps"):
    if dtype == "int8":
        x = torch.randint(-128, 128, (m, 128), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (r, 128, n), generator=gen,
                          device="cuda", dtype=torch.int8)
    else:
        x = torch.randn((m, 128), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        w = (torch.randn((r, 128, n), generator=gen, device="cuda") * 0.1
             ).to(torch.bfloat16)
    if layout == "wide":   # w_wide[k, t * n + j] = w[t, k, j]
        w = w.permute(1, 0, 2).reshape(128, r * n).contiguous()
    return x, w


def _assert_tap_close(got, want, dtype):
    """int8: exact (the integer sums stay far below 2^24, so both round
    the same integer once); bf16: 2^-7 * max(1, |plain|), one bf16 step of
    the output (the f32 partials are summed in another order)."""
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        tol = 2.0 ** -7 * want.float().abs().clamp_min(1.0)
        assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 9])
@pytest.mark.parametrize("n, layout", [(128, "taps"), (256, "taps"),
                                       (384, "taps"), (512, "taps"),
                                       (1152, "taps"), (2048, "taps"),
                                       (128, "wide")])
@pytest.mark.parametrize("m", [1, 255, 257, 1000, 4097,
                               132 * 256 * 3 + 77])
def test_tap_matmul_kernel_matches_plain(gen, m, n, layout, r, dtype):
    """Row counts at the kernel's edges: one row, one short of and one past
    a 256-row item (the second consumer warpgroup's rows partly or wholly
    past M), ragged counts, and one where every CTA of a 132-SM grid walks
    several items; N of one to sixteen 128-column tiles; every tap count
    of the probes; both layouts of w (the wide one at K13's N = 128)."""
    x, w = _tap_inputs(gen, m, n, r, dtype, layout)
    before = tap_matmul.tap_matmul.launches
    got = tap_matmul.tap_matmul(x, w, layout=layout)
    want = tap_matmul.tap_matmul_plain(x, w, layout=layout)
    torch.cuda.synchronize()
    assert tap_matmul.tap_matmul.launches == before + 1
    assert got.shape == (m, n)
    _assert_tap_close(got, want, dtype)


def test_tap_matmul_partial_last_row_tile_repeated(gen):
    """M = 256 k + 77: the second consumer warpgroup's rows of the last
    row tile all lie past M, so it stores nothing there; its epilogue once
    overwrote the output stage while the previous item's last box was
    still being stored (zeros in ~2.5 % of launches at this shape). 400
    launches, each against the plain version."""
    m = 132 * 256 * 3 + 77
    x, w = _tap_inputs(gen, m, 2048, 1, "bf16")
    want = tap_matmul.tap_matmul_plain(x, w)
    for _ in range(400):
        _assert_tap_close(tap_matmul.tap_matmul(x, w), want, "bf16")


@pytest.mark.parametrize("xs, ws, r", [((0, 128), (0, 128), 8),
                                       ((100, 128), (100, 128), 9),
                                       ((-128, -100), (100, 128), 9)])
def test_tap_matmul_int8_sums_past_float_mantissa(gen, xs, ws, r):
    """The int8 epilogue rounds sums below 2^22 in magnitude through float
    and larger ones through double: sums that straddle 2^22 (the first
    case), and sums of about +-1.5e7, match exactly."""
    x = torch.randint(*xs, (5000, 128), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(*ws, (r, 128, 256), generator=gen, device="cuda",
                      dtype=torch.int8)
    got = tap_matmul.tap_matmul(x, w)
    want = tap_matmul.tap_matmul_plain(x, w)
    large = float((want.float().abs() >= 2 ** 22).float().mean())
    assert (0.05 < large < 0.95) if xs == (0, 128) else large == 1.0
    _assert_tap_close(got, want, "int8")


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_tap_matmul_back_to_back_calls_on_one_stream(gen, dtype):
    """Two launches queued on one stream before either is read, at other
    shapes (so other tensor maps, grids and item runs): both match."""
    x1, w1 = _tap_inputs(gen, 70_001, 1152, 1, dtype)
    x2, w2 = _tap_inputs(gen, 3_001, 256, 9, dtype)
    before = tap_matmul.tap_matmul.launches
    got1 = tap_matmul.tap_matmul(x1, w1)
    got2 = tap_matmul.tap_matmul(x2, w2)
    torch.cuda.synchronize()
    assert tap_matmul.tap_matmul.launches == before + 2
    _assert_tap_close(got1, tap_matmul.tap_matmul_plain(x1, w1), dtype)
    _assert_tap_close(got2, tap_matmul.tap_matmul_plain(x2, w2), dtype)


def test_tap_matmul_one_row_leading_axes_and_refusals(gen):
    """One row (an item of 255 empty rows); x with the scripts' leading
    axes; and what the kernel does not take raises on the card."""
    w = (torch.randn((9, 128, 128), generator=gen, device="cuda") * 0.1
         ).to(torch.bfloat16)
    for shape in ((1, 128), (2, 3, 40, 128)):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        got = tap_matmul.tap_matmul(x, w)
        want = tap_matmul.tap_matmul_plain(x, w)
        assert got.shape == shape[:-1] + (128,)
        tol = 2.0 ** -7 * want.float().abs().clamp_min(1.0)
        assert bool(((got.float() - want.float()).abs() <= tol).all())
    x = torch.randn((64, 128), generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError):   # not contiguous
        tap_matmul.tap_matmul(x, w.transpose(1, 2))
    with pytest.raises(ValueError):   # float32
        tap_matmul.tap_matmul(x.float(), w.float())
    with pytest.raises(ValueError):   # N = 192
        tap_matmul.tap_matmul(x, w[..., :64].repeat(1, 1, 3).contiguous())
    with pytest.raises(RuntimeError, match="tap_matmul"):  # 16-byte alignment
        tap_matmul.tap_matmul(x.view(-1)[4:4 + 63 * 128].view(63, 128), w)


# --------------------------------------------------------------------------
# LoFTR, the LoFTR family and RoMa's fpn-corr on the card against the CPU
# --------------------------------------------------------------------------

def _loftr_data(size=(601, 451), seed=100):
    """The planted pair through the LoFTR test conf's preprocessing
    (resize 320): the model's input dict, and the homography."""
    import chip_smoke
    from imcui_tpu_torch.utils import image as timage

    img0, img1, hm = chip_smoke.synthetic_pair(seed, *size)
    d = [timage.preprocess(img, grayscale=True, resize_max=320, dfactor=8)
         for img in (img0, img1)]
    return {"image0": d[0]["image"], "image1": d[1]["image"],
            "size0": d[0]["size"][None], "size1": d[1]["size"][None]}, hm


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_loftr_on_card_matches_cpu(gen, precision):
    """The LoFTR wrapper on the trained tree, card against CPU on one pair:
    f32 the same valid set and keypoints within 1e-3 px (TF32 off: sums in
    another order only); bf16 an IoU of the valid image-0 points of at
    least 0.9 (cuDNN and oneDNN round the bf16 trunk in other places)."""
    from imcui_tpu_torch.models.matchers import loftr

    data, _ = _loftr_data()
    out = []
    for device in ("cuda", "cpu"):
        model = loftr.LoFTR({"max_keypoints": 1024, "precision": precision},
                            device=device)
        assert model.meta["pretrained"] is True
        out.append({k: v[0].cpu().numpy() for k, v in model(data).items()})
    got, want = out
    pts = [{tuple(o["keypoints0"][j]): o["keypoints1"][j]
            for j in np.flatnonzero(o["mask"])} for o in out]
    assert len(pts[1]) > 500
    common = pts[0].keys() & pts[1].keys()
    if precision == "fp32":
        assert pts[0].keys() == pts[1].keys()
        assert max(np.abs(pts[0][k] - pts[1][k]).max() for k in common) \
            <= 1e-3
    else:
        assert len(common) / len(pts[0].keys() | pts[1].keys()) >= 0.9


def test_loftr_phase7_gate_on_card(gen):
    """chip_smoke.py phase 7's gate on one planted 1600 x 1200 pair at the
    registry's loftr conf (640 x 480, 2000 slots, bf16, the trained tree
    by the offline route)."""
    import chip_smoke
    from imcui_tpu_torch.api.core import ImageMatchingAPI
    from imcui_tpu_torch.ui import utils as ui

    conf = ui.parse_match_config({"matcher": "loftr", "dense": True})
    api = ImageMatchingAPI(conf, device="cuda")
    assert api.matcher.meta["source"].startswith("local:")
    img0, img1, hm = chip_smoke.synthetic_pair(chip_smoke.L_SEEDS[0],
                                               *chip_smoke.L_SIZE)
    res = api(img0, img1)
    assert len(res["mkeypoints0_orig"]) == 2000
    err = chip_smoke.transfer_errors(hm, res["mmkeypoints0_orig"],
                                     res["mmkeypoints1_orig"])
    assert len(err) >= chip_smoke.GATE_MIN_INLIERS
    assert np.median(err) <= chip_smoke.GATE_MEDIAN_PX


FAMILY_CLASSES = {"eloftr": "ELoFTR", "se2loftr": "Se2LoFTR",
                  "xoftr": "XoFTR", "aspanformer": "ASpanFormer",
                  "topicfm": "TopicFM", "matchformer": "MatchFormer",
                  "loma": "LoMa", "jamma": "JamMa", "rdd_dense": "RddDense"}


@pytest.mark.parametrize("name", list(FAMILY_CLASSES))
def test_loftr_family_on_card_matches_cpu(gen, name):
    """Each family matcher on its seeded random tree at 128 x 160 and a
    threshold of 0 (every mutual pair): the device defaults to "cuda" and
    the parameters live there; card against CPU the valid image-0 points'
    IoU at least 0.9 (a point common where within 0.01 px: xoftr moves
    image 0's points too) and the scores of the common ones within
    1e-3."""
    import importlib

    mod = importlib.import_module(f"imcui_tpu_torch.models.matchers.{name}")
    cls = getattr(mod, FAMILY_CLASSES[name])
    rng = np.random.default_rng(8)
    big = rng.random((144, 176)).astype(np.float32)
    data = {"image0": big[:128, :160][None, None],
            "image1": big[8:136, 16:176][None, None]}
    import chip_smoke

    out = []
    for model in (cls({"max_keypoints": 200}), cls({"max_keypoints": 200},
                                                   device="cpu")):
        model.pair_conf["match_threshold"] = 0.0
        o = {k: v[0].cpu().numpy() for k, v in model(data).items()}
        out.append((o["keypoints0"][o["mask"]], o["scores"][o["mask"]]))
    assert next(iter(weights.flatten_tree(cls({}).params).values())
                ).device.type == "cuda"
    iou, ia, ib = chip_smoke.common_points(out[0][0], out[1][0], 1e-2)
    assert len(out[1][0]) and iou >= 0.9
    assert np.abs(out[0][1][ia] - out[1][1][ib]).max() <= 1e-3


def test_roma_fpn_corr_on_card_matches_cpu(gen):
    """RoMa's fpn-corr path on its seeded random tree at 240 x 320: warp
    and certainty, card against CPU, within 1e-3."""
    from imcui_tpu_torch.models.matchers import roma
    from imcui_tpu_torch.utils.weights import to_device

    params, meta = roma.load_params({"backbone": "fpn-corr"}, "cpu")
    assert meta["pretrained"] is False
    cpu_gen = torch.Generator().manual_seed(3)
    img0, img1 = (torch.rand((1, 240, 320), generator=cpu_gen)
                  for _ in range(2))
    with torch.inference_mode(), full_fp32():
        want_w, want_c = roma.match(params, img0, img1)
        got_w, got_c = roma.match(to_device(params, "cuda"), img0.cuda(),
                                  img1.cuda())
    assert got_w.shape == (30, 40, 2)
    assert float((got_w.cpu() - want_w).abs().max()) <= 1e-3
    assert float((got_c.cpu() - want_c).abs().max()) <= 1e-3


@pytest.mark.parametrize("kind", ["nearest_neighbor", "dual_softmax"])
@pytest.mark.parametrize("conf", [{}, {"ratio_threshold": 0.8,
                                       "do_mutual_check": False}])
def test_descriptor_matchers_on_card_match_cpu(gen, kind, conf):
    """NearestNeighbor and DualSoftMax at 2 x 256 x (512, 384) with padded
    masks: the same matches as on the CPU (the similarity is strict f32;
    ties go to the lowest index on both), scores within 1e-6."""
    from imcui_tpu_torch.models.matchers.dual_softmax import DualSoftMax
    from imcui_tpu_torch.models.matchers.nearest_neighbor import \
        NearestNeighbor

    if kind == "dual_softmax" and conf:
        conf = {"inv_temperature": 10, "match_threshold": 0.05}
    cls = NearestNeighbor if kind == "nearest_neighbor" else DualSoftMax
    rng = np.random.default_rng(4)
    d0 = rng.standard_normal((2, 256, 512)).astype(np.float32)
    d1 = np.concatenate([d0[:, :, rng.permutation(512)[:200]]
                         + 0.3 * rng.standard_normal((2, 256, 200)),
                         rng.standard_normal((2, 256, 184))], 2)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(np.float32)
    data = {"descriptors0": d0, "descriptors1": d1,
            "mask0": np.arange(512)[None].repeat(2, 0) < [[450], [512]],
            "mask1": np.arange(384)[None].repeat(2, 0) < [[350], [300]]}
    got = cls(conf)(data)
    want = cls(conf, device="cpu")(data)
    assert got["matches0"].device.type == "cuda"
    np.testing.assert_array_equal(got["matches0"].cpu().numpy(),
                                  want["matches0"].numpy())
    assert (want["matches0"] > -1).sum() > 100
    np.testing.assert_allclose(got["matching_scores0"].cpu().numpy(),
                               want["matching_scores0"].numpy(), atol=1e-6)


def test_served_request_launches_k1_and_k2_and_holds_no_tensor(gen):
    """MatchingService(device="cuda") on the packaged api.yaml (bf16
    SuperPoint at nms_radius 4 + mutual NN) answers one planted PNG pair
    over HTTP: stage_tail and nms_cellmax are launched, the response is
    plain JSON, and the gate of chip_smoke.py phase 8 holds."""
    import json
    import threading

    import chip_smoke
    from imcui_tpu_torch.api import client, server
    from imcui_tpu_torch.utils.png import encode_png

    service = server.MatchingService(device="cuda")
    assert service.api.extractor.conf["precision"] == "bf16"
    httpd = server.serve_stdlib(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        img0, img1, hm = chip_smoke.synthetic_pair(100, 800, 600)
        body, ctype = chip_smoke.multipart_body(
            {"image0": encode_png(img0), "image1": encode_png(img1)})
        before = (cuda_stage1.stage_tail.launches,
                  cuda_nms.nms_cellmax.launches)
        out = json.loads(_post_body(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/match", body,
            ctype))
        assert cuda_stage1.stage_tail.launches > before[0]
        assert cuda_nms.nms_cellmax.launches == before[1] + 2
        direct = service.match(img0, img1)
        json.dumps(direct)
        assert not any(isinstance(v, torch.Tensor) for v in direct.values())
        assert set(out) == set(direct)
        assert client.get_api_version(
            f"http://127.0.0.1:{httpd.server_address[1]}")["version"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    err = chip_smoke.transfer_errors(hm, np.array(out["mmkeypoints0_orig"]),
                                     np.array(out["mmkeypoints1_orig"]))
    assert len(err) >= chip_smoke.GATE_MIN_INLIERS
    assert np.median(err) <= chip_smoke.GATE_MEDIAN_PX


def _post_body(url, body, ctype):
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_pose_chain_and_pnp_on_card(gen):
    """tests/test_pose_eval.py's planted chain on the card (3 scenes at 640
    x 480, 2048 hypotheses from a CUDA generator): < 1.5°; and PnP on
    tests/test_ops_pnp.py's scene recovers R and t with the mask kept."""
    from imcui_tpu_torch.eval import synthpose
    from imcui_tpu_torch.ops import pnp, pose

    rng = np.random.default_rng(0)
    for trial in range(3):
        scene = synthpose.sample_scene(rng, 640, 480)
        u0, u1 = synthpose.gt_correspondences(scene, 640, 480, rng, n=512)
        p0, p1 = np.zeros((512, 2), np.float32), np.zeros((512, 2),
                                                            np.float32)
        m = np.zeros(512, bool)
        p0[:len(u0)], p1[:len(u0)], m[:len(u0)] = u0, u1, True
        out = pose.estimate_pose(
            p0, p1, m, scene["K"], scene["K"],
            torch.Generator(device="cuda").manual_seed(trial),
            threshold_px=0.75)
        assert out["R"].device.type == "cuda"
        err = float(pose.pose_error(out["R"], out["t"], *(
            torch.as_tensor(scene[k], dtype=torch.float32, device="cuda")
            for k in ("R", "t"))))
        assert err < 1.5, (trial, err)

    r = np.random.RandomState(0)
    K = np.array([[900.0, 0, 480], [0, 900.0, 360], [0, 0, 1]])
    a = 0.4
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    t = np.array([0.3, -0.2, 4.0])
    X = r.uniform(-3, 3, (80, 3)) + np.array([0, 0, 2.0])
    x = (X @ R.T + t) @ K.T
    p2 = np.concatenate([x[:, :2] / x[:, 2:] + r.randn(80, 2) * 0.5,
                         r.uniform(0, 900, (40, 2))]).astype(np.float32)
    p3 = np.concatenate([X, r.uniform(-3, 3, (40, 3))]).astype(np.float32)
    mask = np.ones(120, bool)
    mask[-10:] = False
    out = pnp.ransac_pnp(p2, p3, mask, K,
                         torch.Generator(device="cuda").manual_seed(0),
                         threshold_px=4.0)
    inl = out["inliers"].cpu().numpy()
    assert bool(out["success"]) and inl[:80].sum() >= 72
    assert not inl[-10:].any() and inl[80:].sum() <= 3
    assert float(pose.rotation_angle_deg(out["R"], torch.as_tensor(
        R, dtype=torch.float32, device="cuda"))) < 2.0
    assert float(np.linalg.norm(out["t"].cpu().numpy() - t)) < 0.2


@pytest.mark.parametrize("n", [1, 63, 64, 65, 4800, 9600])
def test_chunked_scan_on_card_matches_cpu(gen, n):
    """loma.linear_scan on the card against the CPU, within 1e-5 of the
    largest state, at lengths on both sides of the 64-token chunk and at
    the registry's 640 x 480 (one view, both views joined)."""
    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.models.matchers import loma

    rng = np.random.default_rng(n)
    log_decay = -(rng.exponential(1.0, (n, 16)) * rng.exponential(
        1.0, (1, 16))).clip(max=30).astype(np.float32)
    drive = rng.normal(size=(n, 16)).astype(np.float32)
    with full_fp32():
        got = loma.linear_scan(torch.from_numpy(log_decay).cuda(),
                               torch.from_numpy(drive).cuda()).cpu()
        want = loma.linear_scan(torch.from_numpy(log_decay),
                                torch.from_numpy(drive))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_eval_pair_through_the_api_on_card(gen, tmp_path):
    """One synthetic pose pair at 640 x 480 through evaluate_matcher on
    the flagship (superpoint+lightglue, subpixel) on the card: matches
    found, error < 10°, and the pair went through the fused self-attention
    (K3) and the bidirectional cross-attention (K4) at 1024 keypoints."""
    import os

    import chip_smoke
    from imcui_tpu_torch.eval import megadepth, synthpose
    from imcui_tpu_torch.utils.png import encode_png

    img = chip_smoke.textured_image(np.random.default_rng(900), 480, 640)
    (tmp_path / "p.png").write_bytes(encode_png(np.repeat(img[..., None], 3,
                                                          -1)))
    pairs = synthpose.generate_pairs([tmp_path / "p.png"], tmp_path / "o",
                                     n_pose_per_image=1, size=(480, 640))
    before = (attention.fused_attention.launches,
              attention.bidirectional_attention.launches)
    cwd = os.getcwd()
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        res = megadepth.evaluate_matcher(
            pairs, "superpoint+lightglue", ransac_threshold_px=1.5,
            feature_opts={"subpixel": True})
    finally:
        os.chdir(cwd)
    assert res["mean_matches"] >= 50 and res["median_err_deg"] < 10.0, res
    assert attention.fused_attention.launches > before[0]
    assert attention.bidirectional_attention.launches > before[1]


# --------------------------------------------------------------------------
# the head of the sparse zoo (chip_smoke.py phase 10)
# --------------------------------------------------------------------------

def _to_cpu(model, card):
    """``model`` (built on the CPU) on ``card``'s tree."""
    model.params = weights.to_device(card.params, "cpu")
    return model


@pytest.mark.parametrize("name,cls,conf", [
    ("disk", "DISK", {"max_keypoints": 1024}),
    ("alike", "Alike", {"model_name": "alike-n", "max_keypoints": 1024}),
    ("aliked", "ALIKED", {"model_name": "aliked-n16"}),
    ("xfeat", "XFeat", {"max_keypoints": 1024, "keypoint_threshold": 0.015}),
])
def test_sparse_extractor_on_card_matches_cpu(gen, name, cls, conf):
    """Each extractor of the zoo on its seeded random tree at its registry
    widths on a 384 x 512 planted image: card against CPU, strict f32 on
    both, the valid keypoint sets at IoU >= 0.98 within 0.01 px and the
    descriptors at common keypoints within 1e-4."""
    import importlib

    import chip_smoke

    mod = importlib.import_module(f"imcui_tpu_torch.models.extractors.{name}")
    card = getattr(mod, cls)(conf)
    assert card.meta["pretrained"] is False
    cpu = _to_cpu(getattr(mod, cls)(conf, device="cpu"), card)
    img = chip_smoke.synthetic_pair(110, 512, 384)[0]
    data = {"image": img.transpose(2, 0, 1)[None].astype(np.float32) / 255,
            "valid_wh": np.array([[500, 380]])}
    if name == "xfeat":
        data["image"] = data["image"].mean(1, keepdims=True)
    out = []
    for model in (card, cpu):
        o = {k: v[0].cpu().numpy() for k, v in model(data).items()}
        out.append((o["keypoints"][o["mask"]], o["descriptors"][:, o["mask"]]))
    iou, ia, ib = chip_smoke.common_points(out[0][0], out[1][0], 1e-2)
    assert len(out[1][0]) > 50 and iou >= 0.98, iou
    assert np.abs(out[0][1][:, ia] - out[1][1][:, ib]).max() <= 1e-4


def test_superglue_and_adalam_on_card_match_cpu(gen):
    """SuperGlue at the registry's widths (18 layers, 50 iterations) on its
    seeded random tree and AdaLAM, on 2 x (1024, 900) keypoint slots with
    padded masks: the log assignment within 1e-4 of its largest valid
    entry, and the same matches for AdaLAM (strict f32 on both)."""
    from imcui_tpu_torch.models.matchers.adalam import AdaLAM
    from imcui_tpu_torch.models.matchers.superglue import SuperGlue

    rng = np.random.default_rng(9)
    k0 = rng.uniform(0, [1024, 768], (2, 1024, 2)).astype(np.float32)
    k1 = k0[:, :900] @ np.array([[1.02, 0.05], [-0.04, 0.98]], np.float32) \
        + 5.0
    d0 = rng.standard_normal((2, 256, 1024)).astype(np.float32)
    d1 = d0[:, :, :900] + 0.2 * rng.standard_normal((2, 256, 900))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(np.float32)
    data = {"keypoints0": k0, "keypoints1": k1.astype(np.float32),
            "descriptors0": d0, "descriptors1": d1,
            "scores0": rng.uniform(0, 1, (2, 1024)).astype(np.float32),
            "scores1": rng.uniform(0, 1, (2, 900)).astype(np.float32),
            "mask0": np.arange(1024)[None].repeat(2, 0) < [[1000], [1024]],
            "mask1": np.arange(900)[None].repeat(2, 0) < [[900], [850]],
            "size0": np.array([[1024, 768]] * 2, np.float32),
            "size1": np.array([[1024, 768]] * 2, np.float32)}
    card = SuperGlue({})
    cpu = _to_cpu(SuperGlue({}, device="cpu"), card)
    z = [m.log_assignment(data).cpu().numpy() for m in (card, cpu)]
    v0 = np.pad(data["mask0"], ((0, 0), (0, 1)), constant_values=True)
    v1 = np.pad(data["mask1"], ((0, 0), (0, 1)), constant_values=True)
    valid = v0[:, :, None] & v1[:, None, :]
    assert np.abs(z[0] - z[1])[valid].max() <= 1e-4 * max(
        1.0, np.abs(z[1][valid]).max())
    got, want = AdaLAM({})(data), AdaLAM({}, device="cpu")(data)
    assert got["matches0"].device.type == "cuda"
    np.testing.assert_array_equal(got["matches0"].cpu().numpy(),
                                  want["matches0"].numpy())
    assert (want["matches0"] > -1).sum() > 1000


@pytest.mark.parametrize("cin,cout,h,w", [(32, 64, 96, 128),
                                          (64, 64, 96, 128),
                                          (64, 128, 24, 32),
                                          (128, 128, 24, 32)])
def test_deform_conv2d_on_card_matches_cpu(gen, cin, cout, h, w):
    """ALIKED-n16's four deformable convs at the served 768 x 1024 canvas
    (blocks 3 and 4 at 1/8 and 1/32), offsets clamped to ±max(h, w)/4 as
    the model does: card against CPU within 1e-5 of the largest output."""
    from imcui_tpu_torch.ops.deform import deform_conv2d

    x = torch.randn((1, cin, h, w), generator=gen, device="cuda")
    off = (torch.randn((1, 18, h, w), generator=gen, device="cuda") * 3
           ).clamp(-max(h, w) / 4, max(h, w) / 4)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * 0.1
    with full_fp32():
        got = deform_conv2d(x, off, wt)
    want = deform_conv2d(x.cpu(), off.cpu(), wt.cpu())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
def test_grid_sample_on_card_matches_cpu_at_the_xfeat_shapes(gen, mode):
    """XFeat's 1/8 descriptor map of the served 1280 x 2048 canvas (64 x 160
    x 256) sampled at 1024 keypoints through xfeat_grid, some on and past
    the border: card against CPU within 1e-5."""
    from imcui_tpu_torch.ops import sampling

    fmap = torch.randn((64, 160, 256), generator=gen, device="cuda")
    kp = torch.rand((1024, 2), generator=gen, device="cuda") \
        * torch.tensor([2060.0, 1290.0], device="cuda") - 6.0
    grid = sampling.xfeat_grid(kp, 1280, 2048)
    got = sampling.grid_sample(fmap, grid, mode=mode)
    want = sampling.grid_sample(fmap.cpu(), grid.cpu(), mode=mode)
    assert got.shape == (64, 1024)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_adalam_zoo_entry_passes_the_gate_on_card(gen):
    """The packaged zoo's superpoint+adalam (bf16 SuperPoint on the trained
    tree, K6, K1 and K2) on chip_smoke.py phase 10's planted pairs: >= 50
    inliers at a median transfer error <= 2 px on each."""
    import chip_smoke

    api = chip_smoke._zoo_api("superpoint+adalam", "cuda")
    assert api.extractor.meta["pretrained"]
    before = cuda_nms.nms_cellmax.launches
    for seed in chip_smoke.Z_SEEDS:
        img0, img1, hm = chip_smoke.synthetic_pair(seed, *chip_smoke.Z_SIZE)
        pred = api(img0, img1)
        err = chip_smoke.transfer_errors(hm, pred["mmkeypoints0_orig"],
                                         pred["mmkeypoints1_orig"])
        assert len(err) >= chip_smoke.GATE_MIN_INLIERS, (seed, len(err))
        assert np.median(err) <= chip_smoke.GATE_MEDIAN_PX
    assert cuda_nms.nms_cellmax.launches == before + 2 * len(
        chip_smoke.Z_SEEDS)


def test_aliked_lightglue_request_launches_k5_and_k4_held_to_plain(gen):
    """The packaged zoo's aliked+lightglue on one planted 1600 x 1200 pair:
    ALIKED serves 4096 slots (it reads max_num_keypoints, not the API's
    max_keypoints), so LightGlue's self-attention takes K5 and its
    cross-attention K4; each launch of the request held against its plain
    version on its own tensors (chip_smoke.py's tolerances)."""
    import chip_smoke

    api = chip_smoke._zoo_api("aliked+lightglue", "cuda")
    assert api.extractor._max_kpts == 4096
    img0, img1, _ = chip_smoke.synthetic_pair(chip_smoke.Z_SEEDS[0],
                                              *chip_smoke.Z_SIZE)
    names = ("flash_attention", "bidirectional_attention", "fused_attention")
    seen = chip_smoke._capture_kernel_args(lambda: api(img0, img1), names)
    assert seen["flash_attention"] and seen["bidirectional_attention"]
    assert not seen["fused_attention"]
    assert seen["flash_attention"][0][0][0].shape[1] == 4096
    checks = chip_smoke._check_served_kernels(
        {n: c for n, c in seen.items() if c}, "aliked+lightglue request")
    assert all(not c["over"] for cs in checks.values() for c in cs)


@pytest.mark.parametrize("hw", [(240, 320), (101, 157), (768, 1024)])
def test_lsd_on_the_card_equals_its_cpu_run(gen, hw):
    """``ops/lsd.py``: the device stages are integer or float64 arithmetic
    (the angle's polynomial float32), so the segments, widths and
    precisions found from a card tensor equal the CPU run's exactly."""
    from imcui_tpu_torch.ops import lsd

    rng = np.random.default_rng(sum(hw))
    img = rng.integers(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1))
    img = np.kron(img, np.ones((8, 8)))[:hw[0], :hw[1]].astype(np.uint8)
    u = torch.from_numpy(img)
    card, cpu = lsd.detect(u.cuda()), lsd.detect(u)
    assert len(cpu[0]) > 10
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)
