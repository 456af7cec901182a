"""LoFTR in the port (imcui_tpu_torch/models/matchers/loftr.py) against the
JAX package on the CPU: each part on the JAX test tree
(``init_params(PRNGKey(31), n_coarse_layers=2)``, carried across by
``weights.params_from_jax``) at 128 × 160 in float32 and bfloat16, then
the ``LoFTR`` wrapper and ``ImageMatchingAPI`` on the trained tree
(``weights/loftr_selftrained.npz``) at ``test_accuracy_warp.py``'s
configuration (resize 320, 1024 slots) on ``chip_smoke``'s planted pair,
and the three routes by which the weights are found.

Tolerances. float32: 1e-5 of the largest value (sums in another order);
bfloat16: one or two bf16 steps of the largest value, because XLA keeps
elementwise chains in float32 inside a fusion and rounds once where
PyTorch rounds after each operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models import layers as jlay
from imcui_tpu.models.matchers import loftr as jl
from imcui_tpu.utils.weights import save_tree_npz
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models import layers as tlay
from imcui_tpu_torch.models.matchers import loftr as tl
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

H, W = 128, 160
TRAINED = weights.local_trained_npz("loftr_selftrained.npz")
# bf16: two bf16 steps of the largest value (2^-7 is one)
BF16_TOL = 2.0 ** -6
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    """{precision: (JAX tree, port tree)} for the JAX test tree."""
    params = jl.init_params(jax.random.PRNGKey(31), n_coarse_layers=2)
    tp = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return {p: (jlay.apply_precision(params, p), tlay.apply_precision(tp, p))
            for p in (None, "bf16")}


def _jdt(precision):
    return jnp.bfloat16 if precision else jnp.float32


def _tdt(precision):
    return torch.bfloat16 if precision else torch.float32


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, precision, scale=None):
    tol = (BF16_TOL if precision else F32_TOL) * (
        scale if scale is not None else max(1.0, np.abs(want).max()))
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def _nchw(a):
    """numpy NHWC → torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# the parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bf16"])
def test_backbone_matches_jax(trees, precision):
    jp, tp = trees[precision]
    img = np.random.default_rng(0).random((2, H, W, 1)).astype(np.float32)
    cj, fj = jl.backbone_apply(jp["backbone"],
                               jnp.asarray(img).astype(_jdt(precision)))
    ct, ft = tl.backbone_apply(tp["backbone"],
                               _nchw(img).to(_tdt(precision)))
    assert ct.dtype == ft.dtype == _tdt(precision)
    assert ct.shape == (2, 256, H // 8, W // 8)
    assert ft.shape == (2, 128, H // 2, W // 2)
    _close(_f32(ct.permute(0, 2, 3, 1)), _f32(cj), precision)
    _close(_f32(ft.permute(0, 2, 3, 1)), _f32(fj), precision)


@pytest.mark.parametrize("hw", [(5, 7), (1, 4), (3, 1), (1, 1)])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_upsample2_matches_jax_at_odd_and_unit_sizes(hw, precision):
    """align_corners=True at odd sizes and the repeat of a size-1 axis:
    the same gathers and blends in the same dtype, so equal to one
    rounding of the blend (2^-8 of the largest value in bf16)."""
    x = np.random.default_rng(1).standard_normal(
        (2, *hw, 3)).astype(np.float32)
    want = _f32(jl._upsample2(jnp.asarray(x).astype(_jdt(precision))))
    got = tl._upsample2(_nchw(x).to(_tdt(precision)))
    assert got.shape == (2, 3, 2 * hw[0], 2 * hw[1])
    tol = (2.0 ** -8 if precision else 1e-6) * np.abs(want).max()
    assert np.abs(_f32(got.permute(0, 2, 3, 1)) - want).max() <= tol


def test_position_encoding_matches_jax():
    """Within 1e-5: XLA's vectorised sin and cos on the CPU are off by a
    few 1e-6 at arguments up to 80 (the 640 × 480 grid's)."""
    want = np.asarray(jl.position_encoding(60, 80))
    got = tl.position_encoding(60, 80).numpy()
    assert got.shape == (60, 80, 256)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_linear_attention_matches_jax(masked, precision):
    """One rounding of the output in bf16 (2^-7 of the largest value)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((n, 8, 32)).astype(np.float32)
               for n in (300, 280, 280))
    mask = (np.arange(280) < 250) if masked else None
    want = _f32(jl.linear_attention(
        *(jnp.asarray(a).astype(_jdt(precision)) for a in (q, k, v)),
        mask_kv=None if mask is None else jnp.asarray(mask)))
    got = tl.linear_attention(
        *(torch.from_numpy(a).to(_tdt(precision)) for a in (q, k, v)),
        mask_kv=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == _tdt(precision) and got.shape == (300, 8, 32)
    tol = (2.0 ** -7 if precision else 1e-6) * np.abs(want).max()
    assert np.abs(_f32(got) - want).max() <= tol


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_encoder_layer_matches_jax(trees, precision):
    jp, tp = trees[precision]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 256)).astype(np.float32)
    s = rng.standard_normal((280, 256)).astype(np.float32)
    m = np.arange(280) < 250
    want = _f32(jl.encoder_layer(
        jp["loftr_coarse"]["layers"][1], jnp.asarray(x).astype(
            _jdt(precision)), jnp.asarray(s).astype(_jdt(precision)),
        mask_src=jnp.asarray(m)))
    got = tl.encoder_layer(
        tp["loftr_coarse"]["layers"][1], torch.from_numpy(x).to(
            _tdt(precision)), torch.from_numpy(s).to(_tdt(precision)),
        torch.from_numpy(m))
    _close(_f32(got), want, precision)
    # a batch of windows: each row its own attention
    got_b = tl.encoder_layer(tp["loftr_fine"]["layers"][0],
                             torch.from_numpy(x[:50, :128].reshape(2, 25, 128)
                                              ).to(_tdt(precision)),
                             torch.from_numpy(x[:50, :128].reshape(2, 25, 128)
                                              ).to(_tdt(precision)))
    for i in range(2):
        xi = jnp.asarray(x[25 * i:25 * (i + 1), :128]).astype(_jdt(precision))
        _close(_f32(got_b[i]), _f32(jl.encoder_layer(
            jp["loftr_fine"]["layers"][0], xi, xi)), precision)


def _coarse_inputs(seed, L, S, d):
    rng = np.random.default_rng(seed)
    f0 = rng.standard_normal((L, d)).astype(np.float32)
    f1 = np.concatenate([f0[:S // 2] + 0.3 * rng.standard_normal(
        (S // 2, d)), rng.standard_normal((S - S // 2, d))]).astype(np.float32)
    return f0, f1


def _valid_rows(idx0, idx1, score, valid):
    return {int(a): (int(b), float(s)) for a, b, s, v in zip(
        np.asarray(idx0), np.asarray(idx1), _f32(score), np.asarray(valid))
            if v}


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_coarse_match_matches_jax(precision):
    """The same valid (idx0 → idx1) set; f32 confidences within 1e-5;
    masked cells never match. bf16 features: the same set (the logits are
    float32 products of the same rounded values)."""
    f0, f1 = _coarse_inputs(4, 300, 280, 256)
    m0, m1 = np.arange(300) < 290, np.arange(280) < 260
    args = dict(temperature=0.1, threshold=0.05, max_matches=200)
    want = _valid_rows(*jl.coarse_match(
        jnp.asarray(f0).astype(_jdt(precision)),
        jnp.asarray(f1).astype(_jdt(precision)), jnp.asarray(m0),
        jnp.asarray(m1), **args))
    out = tl.coarse_match(torch.from_numpy(f0).to(_tdt(precision)),
                          torch.from_numpy(f1).to(_tdt(precision)),
                          torch.from_numpy(m0), torch.from_numpy(m1), **args)
    assert out[0].shape == (200,) and out[2].dtype == torch.float32
    got = _valid_rows(*out)
    assert len(want) > 20 and got.keys() == want.keys()
    for a, (b, s) in got.items():
        assert b == want[a][0] and m0[a] and m1[b]
        assert abs(s - want[a][1]) <= 1e-5
    # slots past the valid rows hold confidence 0
    assert float(out[2][~out[3]].abs().max()) == 0.0


def test_coarse_match_clamps_slots_to_cells_and_is_the_dual_softmax():
    """Fewer cells than slots: M = L. And the log-sum-exp form is the
    naive dual softmax (the JAX test test_coarse_match_lse_form_exact),
    masked rows included."""
    L, S, d = 96, 80, 32
    f0, f1 = (np.random.default_rng(7).standard_normal((n, d)).astype(
        np.float32) for n in (L, S))
    m0, m1 = np.arange(L) < 90, np.arange(S) < 72
    idx0, idx1, score, valid = tl.coarse_match(
        torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(m0),
        torch.from_numpy(m1), temperature=0.1, threshold=0.01,
        max_matches=1024)
    assert idx0.shape == (L,) and sorted(idx0.tolist()) == list(range(L))
    sim = (torch.from_numpy(f0) / d ** 0.5) @ (torch.from_numpy(f1)
                                               / d ** 0.5).t() / 0.1
    sim = torch.where(torch.from_numpy(m0[:, None] & m1[None, :]), sim,
                      torch.tensor(-1e9))
    conf = torch.softmax(sim, 1) * torch.softmax(sim, 0)
    i1_of_0, i0_of_1 = conf.argmax(1), conf.argmax(0)
    mutual = torch.arange(L) == i0_of_1[i1_of_0]
    best = conf.max(1).values
    ref = torch.where(mutual & (best > 0.01) & torch.from_numpy(m0), best,
                      torch.tensor(0.0))
    got = _valid_rows(idx0, idx1, score, valid)
    want = {i: (int(i1_of_0[i]), float(ref[i])) for i in range(L)
            if ref[i] > 0}
    assert len(want) > 5 and got.keys() == want.keys()
    for a, (b, s) in got.items():
        assert b == want[a][0]
        np.testing.assert_allclose(s, want[a][1], rtol=1e-5)
    # the JAX package's on the same inputs
    jwant = _valid_rows(*jl.coarse_match(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(m0), jnp.asarray(m1),
        temperature=0.1, threshold=0.01, max_matches=1024))
    assert jwant.keys() == got.keys()


def test_gather_fine_windows_clips_at_the_edge_as_jax():
    """Cells in the last row and column: the window is moved inside, so
    its centre is 2 fine px from the cell's (the documented shift), in both
    packages."""
    hc, wc = 4, 5
    feat = np.random.default_rng(5).standard_normal(
        (4 * hc, 4 * wc, 16)).astype(np.float32)
    idx = np.array([0, 6, wc - 1, hc * wc - 1, (hc - 1) * wc])
    want = np.asarray(jl.gather_fine_windows(jnp.asarray(feat),
                                             jnp.asarray(idx), wc))
    got = tl.gather_fine_windows(torch.from_numpy(feat).permute(2, 0, 1),
                                 torch.from_numpy(idx), wc).numpy()
    assert got.shape == (5, 25, 16)
    np.testing.assert_array_equal(got, want)
    # the last cell's centre (14, 18) would want the window at (12, 16);
    # it starts at (11, 15): the window's centre token is feat[13, 17]
    np.testing.assert_array_equal(got[3, 12], feat[4 * hc - 3, 4 * wc - 3])
    np.testing.assert_array_equal(got[1, 12], feat[6, 6])


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_fine_match_matches_jax(trees, precision):
    """Offsets in fine px: f32 within 1e-4; bf16 within 0.05 (the
    correlation is rounded to bf16 before the softmax at temperature 0.1,
    where one bf16 step of a logit of ~10 moves the weights by a few
    per cent)."""
    jp, tp = trees[precision]
    rng = np.random.default_rng(6)
    w0, w1 = (rng.standard_normal((40, 25, 128)).astype(np.float32)
              for _ in range(2))
    valid = np.arange(40) % 7 != 3
    want = np.asarray(jl.fine_match(
        jp, jnp.asarray(w0).astype(_jdt(precision)),
        jnp.asarray(w1).astype(_jdt(precision)), jnp.asarray(valid)))
    got = tl.fine_match(tp, torch.from_numpy(w0).to(_tdt(precision)),
                        torch.from_numpy(w1).to(_tdt(precision)),
                        torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (40, 2)
    assert float(got[~torch.from_numpy(valid)].abs().max()) == 0.0
    assert float(got.abs().max()) <= 2.0
    tol = 0.05 if precision else 1e-4
    assert np.abs(got.numpy() - want).max() <= tol


def _pair_rows(out, mask):
    r = np.concatenate([_f32(out["keypoints0"]), _f32(out["keypoints1"]),
                        _f32(out["scores"])[:, None]], 1)[mask]
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_forward_pair_matches_jax(trees, precision):
    """One pair at 128 × 160, image 1 a shifted crop of image 0, threshold
    0.05 so that the random tree keeps matches. f32: the same valid set,
    keypoints within 1e-3 px, confidences within 2e-4 (a logit's float32
    error after the backbone and two layers, ~1e-6, is multiplied by
    2/temperature = 20 in the exponent). bf16: the valid
    sets' IoU at least 0.8."""
    jp, tp = trees[precision]
    rng = np.random.default_rng(8)
    big = rng.random((H + 16, W + 16)).astype(np.float32)
    img0, img1 = big[:H, :W, None], big[8:H + 8, 16:W + 16, None]
    conf = {"match_threshold": 0.05, "temperature": 0.1, "max_matches": 200}
    wh0, wh1 = (W, H), (W - 24, H)
    want = jl.forward_pair(jp, jnp.asarray(img0), jnp.asarray(img1),
                           jnp.asarray(wh0), jnp.asarray(wh1), conf)
    with tlay.full_fp32():
        got = tl.forward_pair(tp, torch.from_numpy(img0).permute(2, 0, 1),
                              torch.from_numpy(img1).permute(2, 0, 1), wh0,
                              wh1, conf)
    mj, mt = np.asarray(want["mask"]), got["mask"].numpy()
    assert got["keypoints1"].shape == (200, 2) and mj.sum() > 10
    # image 1's valid width is W - 24: no match lands in its last 3 cells
    assert float(got["keypoints1"][got["mask"], 0].max()) < W - 24 + 8
    if precision is None:
        a, b = _pair_rows(want, mj), _pair_rows(got, mt)
        assert a.shape == b.shape
        assert np.abs(a[:, :4] - b[:, :4]).max() <= 1e-3
        assert np.abs(a[:, 4] - b[:, 4]).max() <= 2e-4
    else:
        a = {tuple(r) for r in _f32(want["keypoints0"])[mj]}
        b = {tuple(r) for r in _f32(got["keypoints0"])[mt]}
        assert len(a & b) / len(a | b) >= 0.8


# --------------------------------------------------------------------------
# the trained tree through the wrapper and the API
# --------------------------------------------------------------------------

def _warp_conf(precision):
    """test_accuracy_warp.py's loftr_trained configuration."""
    return {
        "matcher": {
            "output": "matches-loftr",
            "model": {"name": "loftr", "max_keypoints": 1024,
                      "match_threshold": 0.2, "checkpoint_npz": str(TRAINED),
                      "precision": precision},
            "preprocessing": {"grayscale": True, "resize_max": 320,
                              "dfactor": 8},
        },
        "dense": True, "standalone": True,
    }


@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(100, 601, 451)


@pytest.fixture(scope="module")
def apis():
    """{precision: (JAX API, port API)} on the trained tree."""
    return {p: (JaxAPI(_warp_conf(p)), TorchAPI(_warp_conf(p), device="cpu"))
            for p in ("fp32", "bf16")}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_loftr_wrapper_on_trained_tree_matches_jax(apis, planted, precision):
    """The ``LoFTR`` BaseModel on the same prepared pair (3 channels, so
    the gray average runs): f32 the same valid set, keypoints within 1e-3
    px and confidences within 1e-4 (four transformer layers of float32
    sums in another order); bf16 an IoU of the valid image-0 cells of at
    least 0.95 (measured 0.994)."""
    ja, ta = apis[precision]
    assert ta.matcher.meta == {"pretrained": True, "source": str(TRAINED)}
    assert next(iter(weights.flatten_tree(ta.matcher.params).values())
                ).dtype == (torch.bfloat16 if precision == "bf16"
                            else torch.float32)
    from imcui_tpu_torch.utils import image as timage
    d = [timage.preprocess(img, grayscale=False, resize_max=320, dfactor=8)
         for img in planted[:2]]
    data = {"image0": d[0]["image"], "image1": d[1]["image"],
            "size0": d[0]["size"][None], "size1": d[1]["size"][None]}
    want = {k: np.asarray(v) for k, v in ja.matcher(data).items()}
    got = {k: v.numpy() for k, v in ta.matcher(data).items()}
    assert got["keypoints0"].shape == (1, 1024, 2)
    assert np.array_equal(got["mconf"], got["scores"])
    mj, mt = want["mask"][0], got["mask"][0]
    assert mj.sum() > 500
    if precision == "fp32":
        a = _pair_rows({k: v[0] for k, v in want.items()}, mj)
        b = _pair_rows({k: v[0] for k, v in got.items()}, mt)
        assert a.shape == b.shape
        assert np.abs(a[:, :4] - b[:, :4]).max() <= 1e-3
        assert np.abs(a[:, 4] - b[:, 4]).max() <= 1e-4
    else:
        a = {tuple(r) for r in want["keypoints0"][0][mj]}
        b = {tuple(r) for r in got["keypoints0"][0][mt]}
        assert len(a & b) / len(a | b) >= 0.95


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_api_on_trained_tree_matches_jax_and_passes_the_gate(
        apis, planted, precision):
    """ImageMatchingAPI standalone end to end. Port against JAX: f32 the
    same raw correspondences to 1e-3 px at the original resolution; bf16
    an IoU of the image-0 points of at least 0.95. The planted-homography
    gate on the port: at least 0.8 of the raw matches within 2 px and a
    median transfer error of at most 2 px (the JAX package: 0.96 and
    0.57 px in f32, 0.91 and 0.98 px in bf16)."""
    ja, ta = apis[precision]
    img0, img1, hm = planted
    want, got = ja(img0, img1), ta(img0, img1)
    assert set(got) <= set(want)
    k0, k1 = got["mkeypoints0_orig"], got["mkeypoints1_orig"]
    assert len(k0) > 500 and np.isfinite(k1).all()
    if precision == "fp32":
        def rows(r):
            x = np.concatenate([r["mkeypoints0_orig"], r["mkeypoints1_orig"]],
                               1)
            return x[np.lexsort(x.T[::-1])]
        a, b = rows(want), rows(got)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-3
    else:
        a = {tuple(np.round(r, 3)) for r in want["mkeypoints0_orig"]}
        b = {tuple(np.round(r, 3)) for r in k0}
        assert len(a & b) / len(a | b) >= 0.95
    err = chip_smoke.transfer_errors(hm, k0, k1)
    assert (err <= 2.0).mean() >= 0.8 and np.median(err) <= 2.0
    assert got["H"] is not None and len(got["mmkeypoints0_orig"]) >= 50


# --------------------------------------------------------------------------
# where the weights come from
# --------------------------------------------------------------------------

def _registry_model_conf():
    return tui.parse_match_config({"matcher": "loftr", "dense": True})[
        "matcher"]["model"]


def test_offline_route_finds_the_trained_tree(monkeypatch, tmp_path):
    """With IMCUI_WEIGHTS_DIR unset the registry's loftr conf loads
    weights/loftr_selftrained.npz; pointed at an empty directory it falls
    back to the seeded random tree and says so."""
    monkeypatch.delenv("IMCUI_WEIGHTS_DIR", raising=False)
    model = tl.LoFTR(_registry_model_conf(), device="cpu")
    assert model.meta == {"pretrained": True, "source": f"local:{TRAINED}"}
    assert model.params["loftr_coarse"]["layers"][3]["q_proj"]["w"].dtype \
        == torch.bfloat16
    with np.load(TRAINED) as z:
        np.testing.assert_array_equal(
            model.params["backbone"]["conv1"]["w"].float().numpy(),
            z["backbone.conv1.w"].transpose(3, 2, 0, 1).astype(
                np.float32).astype(jnp.bfloat16).astype(np.float32))
    monkeypatch.setenv("IMCUI_WEIGHTS_DIR", str(tmp_path))
    model = tl.LoFTR({**_registry_model_conf(), "precision": "fp32"},
                     device="cpu")
    assert model.meta["pretrained"] is False
    assert "random init" in model.meta["source"]
    assert model.params["backbone"]["conv1"]["w"].dtype == torch.float32
    ref = tl.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(model.params["backbone"]["conv1"]["w"],
                       ref["backbone"]["conv1"]["w"])


def test_mismatched_tree_raises(monkeypatch, tmp_path):
    """A tree with two coarse layers where the model has four raises, by
    checkpoint_npz and by the local route alike; a checkpoint_npz that is
    absent raises too."""
    small = jl.init_params(jax.random.PRNGKey(0), n_coarse_layers=2)
    save_tree_npz(tmp_path / "loftr_selftrained.npz", small)
    with pytest.raises(ValueError, match="mismatch"):
        tl.LoFTR({"checkpoint_npz": str(tmp_path / "loftr_selftrained.npz")},
                 device="cpu")
    monkeypatch.setenv("IMCUI_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="mismatch"):
        tl.LoFTR({}, device="cpu")
    with pytest.raises(FileNotFoundError):
        tl.LoFTR({"checkpoint_npz": str(tmp_path / "absent.npz")},
                 device="cpu")


def test_loftr_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tl.LoFTR({})
