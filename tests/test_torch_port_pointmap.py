"""DUSt3R and MASt3R: the port against the JAX package on the CPU. The
DPT head's parts and the whole head, the trunk (encoder, decoders, hooks)
with both pointmap heads, the 3-D and descriptor reciprocal matchers,
both BaseModels, the dense ``ImageMatchingAPI`` branch (also on two views
of different shapes), and the bfloat16 route through ``mha_auto`` with
``vit.ATTN_IMPL = "fused"``.

The models run at ``tests/test_pointmap.py``'s ``TINY`` configuration
(64 wide, 2 + 2 blocks, the linear head) and at ``TINY`` with the DPT
head; the routing cases at head dim 64 (``TINY64``), which ``mha_auto``
needs. Every tree is the port's seed-0 tree carried to the JAX layout by
``params_to_jax`` and checked against ``jax.eval_shape`` of the JAX init;
no full-width ViT-L is built.

Tolerances: float32 parts within 1e-5 of the largest value (the
upsample, the transposed convolution), the DPT head, the trunk's hooks,
pointmaps, confidences and descriptors within 1e-4 relative to the
largest (longer chains of float32 sums in another order); matches as
sets of point pairs within 1e-3 px, IoU 1.0 (``torch.topk`` and
``lax.top_k`` may order equal scores differently; no argmin or argmax
flip occurred on these inputs). bfloat16 against the JAX package's
bfloat16: the median relative pointmap difference at most 2e-2 (the two
round at different places; a random tree amplifies that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models import layers as jlayers
from imcui_tpu.models.backbones import dpt as jdpt
from imcui_tpu.models.backbones import vit as jvit
from imcui_tpu.models.matchers import duster as jduster
from imcui_tpu.models.matchers import mast3r as jmast3r
from imcui_tpu.ops import attention as jatt
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.backbones import dpt as tdpt
from imcui_tpu_torch.models.backbones import vit as tvit
from imcui_tpu_torch.models.matchers import duster as tduster
from imcui_tpu_torch.models.matchers import mast3r as tmast3r
from imcui_tpu_torch.ops import attention as tatt
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

KEY = jax.random.PRNGKey(0)
TINY = {
    "enc_dim": 64, "enc_depth": 2, "enc_heads": 4,
    "dec_dim": 64, "dec_depth": 2, "dec_heads": 4,
    "patch": 16, "max_matches": 64, "subsample": 8,
    "pos_embed": "RoPE100", "head_type": "linear",
}
TINY_DPT = {**TINY, "head_type": "dpt"}
TINY64 = {**TINY, "enc_dim": 128, "enc_heads": 2, "dec_dim": 128,
          "dec_heads": 2}
MODULES = {"duster": (jduster, tduster), "mast3r": (jmast3r, tmast3r)}


@pytest.fixture(autouse=True, scope="module")
def _offline():
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread (the tier-1 run's six workers share eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-30, np.abs(want).max())


def _jax_init(name, conf):
    """The JAX init's layout, traced only."""
    if name == "duster":
        return jax.eval_shape(lambda: jduster.init_params(KEY, conf))

    def init():
        tree = jduster.init_params(KEY, conf)
        for k in ("downstream_head1", "downstream_head2"):
            tree[k]["head_local_features"] = jmast3r.init_desc_head(
                KEY, conf["enc_dim"], conf["dec_dim"], conf["patch"],
                conf.get("desc_dim", jmast3r.DESC_DIM))
        return tree

    return jax.eval_shape(init)


def _carried(ttree, shapes):
    jtree = weights.params_to_jax(ttree)
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree


def _models(name, conf, precision=None):
    """Both packages' BaseModels on the port's seed-0 tree."""
    jmod, tmod = MODULES[name]
    cls = {"duster": "Duster", "mast3r": "Mast3r"}[name]
    conf = {**conf, "precision": precision}
    tm = getattr(tmod, cls)(conf, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "load_params",
                   lambda *a, **k: (None, {"pretrained": False}))
        jm = getattr(jmod, cls)(conf)
    ttree = getattr(tmod, cls)({**conf, "precision": None}, device="cpu"
                               ).params
    jm.params = jlayers.apply_precision(
        _carried(ttree, _jax_init(name, {**jm.conf})), precision)
    return jm, tm


def _pair(seed=3, h=64, w=96):
    rng = np.random.default_rng(seed)
    return {"image0": rng.random((1, 3, h, w), np.float32),
            "image1": rng.random((1, 3, h, w), np.float32)}


def _jax_trunk(jm, x0, x1):
    """The JAX package's hooks of both views and view 1's pointmap and
    confidence, in one jitted program (op by op, the JAX CPU runtime
    takes seconds a call)."""
    conf = jm.conf

    def run(params, a, b):
        t0, grid = jduster.encode(params, a, conf)
        t1, _ = jduster.encode(params, b, conf)
        h0, h1 = jduster.decode(params, t0, t1, grid, conf)
        return (h0, h1) + jduster.head_to_pointmap(
            params["downstream_head2"], h1, grid, conf["patch"])

    return jax.jit(run)(jm.params, x0, x1)


def _same_matches(got, want, least=1):
    jm, tm = np.asarray(want["mask"][0]), got["mask"][0].numpy()
    assert tm.sum() == jm.sum() >= least, (tm.sum(), jm.sum())
    pj = np.concatenate([np.asarray(want["keypoints0"][0])[jm],
                         np.asarray(want["keypoints1"][0])[jm]], 1)
    pt = np.concatenate([got["keypoints0"][0].numpy()[tm],
                         got["keypoints1"][0].numpy()[tm]], 1)
    iou, it, ij = chip_smoke.common_points(pt, pj, 1e-3)
    assert iou == 1.0, iou
    js = np.asarray(want["scores"][0])[jm][ij]
    assert _rel(got["scores"][0].numpy()[tm][it], js) <= 1e-4
    return int(tm.sum())


# --------------------------------------------------------------------------
# DPT
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw,out", [((4, 6), (8, 12)), ((5, 3), (9, 7)),
                                    ((7, 7), (7, 7))])
def test_resize_align_corners_matches_jax_and_torch(hw, out):
    x = np.random.default_rng(0).standard_normal((3,) + hw).astype(
        np.float32)
    got = tdpt.resize_align_corners(torch.from_numpy(x), out)
    want = jdpt.resize_align_corners(jnp.asarray(x.transpose(1, 2, 0)), out)
    assert _rel(got.numpy(), np.asarray(want).transpose(2, 0, 1)) <= 1e-5
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x)[None], size=out, mode="bilinear",
        align_corners=True)[0]
    assert _rel(got.numpy(), ref.numpy()) <= 1e-5


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_s_matches_jax(k):
    gen = torch.Generator().manual_seed(1)
    p = tdpt.init_conv_transpose(gen, k, 6, 5)
    jp = weights.params_to_jax(p)
    assert jp["w"].shape == (k, k, 5, 6)
    x = torch.randn((6, 3, 4), generator=gen)
    got = tdpt.conv_transpose_s(p, x)
    want = jdpt.conv_transpose_s(jp, jnp.asarray(x.numpy().transpose(1, 2,
                                                                     0)))
    assert got.shape == (5, 3 * k, 4 * k)
    assert _rel(got.numpy(), np.asarray(want).transpose(2, 0, 1)) <= 1e-5


def test_dpt_head_matches_jax():
    """The whole head on four random hook matrices of a 4 x 6 grid, at
    narrow widths (the models' tests run it at the published ones)."""
    kw = dict(dim_tokens=(64, 48, 48, 48), layer_dims=(16, 24, 32, 40),
              feature_dim=32, last_dim=16)
    ttree = tdpt.init_dpt(torch.Generator().manual_seed(0), **kw)
    jtree = _carried(ttree, jax.eval_shape(lambda: jdpt.init_dpt(KEY, **kw)))
    rng = np.random.default_rng(1)
    hooks = [rng.standard_normal((24, d)).astype(np.float32)
             for d in kw["dim_tokens"]]
    with torch.no_grad():
        got = tdpt.dpt_apply(weights.params_from_jax(jtree),
                             [torch.from_numpy(h) for h in hooks], (4, 6))
    want = jax.jit(jdpt.dpt_apply, static_argnums=2)(
        jtree, [jnp.asarray(h) for h in hooks], (4, 6))
    assert got.shape == (4, 64, 96)
    assert _rel(got.numpy(), np.asarray(want).transpose(2, 0, 1)) <= 1e-4


# --------------------------------------------------------------------------
# the trunk and the heads
# --------------------------------------------------------------------------

@pytest.mark.parametrize("conf", [TINY, TINY_DPT], ids=["linear", "dpt"])
def test_duster_trunk_and_heads_match_jax(conf):
    """Encoder, decoders, hooks (dec_norm on the last) and a view's
    pointmap and confidence, on one pair of 64 x 96 views."""
    jm, tm = _models("duster", conf)
    data = _pair()
    x = [d[0] for d in (data["image0"], data["image1"])]
    tx = [torch.from_numpy((a - 0.5) / 0.5) for a in x]
    jx = [jnp.asarray(((a - 0.5) / 0.5).transpose(1, 2, 0)) for a in x]
    c = tm.conf
    with torch.no_grad():
        t0, grid = tduster.encode(tm.params, tx[0], c)
        t1, _ = tduster.encode(tm.params, tx[1], c)
        th0, th1 = tduster.decode(tm.params, t0, t1, grid, c)
        pts, cf = tduster.head_to_pointmap(tm.params["downstream_head2"],
                                           th1, grid, c["patch"])
    jh0, jh1, jpts, jcf = _jax_trunk(jm, *jx)
    assert grid == (4, 6)
    for a, b in zip(th0 + th1, jh0 + jh1):
        assert _rel(a.numpy(), b) <= 1e-4
    assert pts.shape == (64, 96, 3) and cf.shape == (64, 96)
    assert torch.isfinite(pts).all() and torch.isfinite(cf).all()
    assert _rel(pts.numpy(), jpts) <= 1e-4 and _rel(cf.numpy(), jcf) <= 1e-4


@pytest.mark.parametrize("name,conf", [("duster", TINY),
                                       ("duster", TINY_DPT),
                                       ("mast3r", TINY)],
                         ids=["duster-linear", "duster-dpt", "mast3r"])
def test_model_matches_jax(name, conf):
    jm, tm = _models(name, conf)
    data = _pair()
    want = jm(data)
    got = tm(data)
    assert set(got) == set(want)
    assert got["keypoints0"].shape == (1, 64, 2)
    _same_matches(got, want)


def test_mast3r_descriptor_head_matches_jax():
    jm, tm = _models("mast3r", TINY)
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((24, 64)).astype(np.float32)
    dec = rng.standard_normal((24, 64)).astype(np.float32)
    with torch.no_grad():
        d, c = tmast3r.desc_head_apply(
            tm.params["downstream_head1"]["head_local_features"],
            torch.from_numpy(enc), torch.from_numpy(dec), (4, 6), 16)
    jd, jc = jmast3r.desc_head_apply(
        jm.params["downstream_head1"]["head_local_features"],
        jnp.asarray(enc), jnp.asarray(dec), (4, 6), 16)
    assert d.shape == (64, 96, 24)
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(),
                               1.0, atol=1e-5)
    assert _rel(d.numpy(), jd) <= 1e-4 and _rel(c.numpy(), jc) <= 1e-4


def test_reciprocal_nn_3d_matches_jax_and_keeps_the_floor():
    """Mutual 3-D nearest neighbours on identical maps map each cell to
    itself; a pair whose confidences multiply to exactly 1 stays under
    the 1 + 1e-6 floor."""
    rng = np.random.default_rng(4)
    pts0 = rng.standard_normal((32, 48, 3)).astype(np.float32)
    pts1 = (pts0 + 0.05 * rng.standard_normal(pts0.shape)).astype(
        np.float32)
    conf0 = (1.0 + rng.random((32, 48))).astype(np.float32)
    conf1 = (1.0 + rng.random((32, 48))).astype(np.float32)
    conf0[:16] = conf1[:16] = 1.0
    got = tduster.reciprocal_nn_3d(*(torch.from_numpy(a) for a in
                                     (pts0, pts1, conf0, conf1)),
                                   max_matches=24, subsample=8)
    want = jduster.reciprocal_nn_3d(*(jnp.asarray(a) for a in
                                      (pts0, pts1, conf0, conf1)),
                                    max_matches=24, subsample=8)
    keys = ("keypoints0", "keypoints1", "scores", "mask")
    _same_matches({k: v[None] for k, v in zip(keys, got)},
                  {k: np.asarray(v)[None] for k, v in zip(keys, want)}, 5)
    k0, k1, valid = got[0][got[3]], got[1][got[3]], got[3]
    assert ((k0[:, 1] >= 16) | (k1[:, 1] >= 16)).all()
    k0, k1, _, valid = tduster.reciprocal_nn_3d(
        *(torch.from_numpy(a) for a in (pts0, pts0, conf0, conf0)),
        max_matches=24, subsample=8)
    assert valid.sum() == 12 and torch.equal(k0[valid], k1[valid])
    assert (k0[valid][:, 1] >= 16).all()


def test_reciprocal_nn_desc_matches_jax():
    rng = np.random.default_rng(5)
    d0 = rng.standard_normal((40, 24)).astype(np.float32)
    d1 = (d0[::-1] + 0.1 * rng.standard_normal(d0.shape)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    c0 = (1.0 + rng.random(40)).astype(np.float32)
    c1 = (1.0 + rng.random(40)).astype(np.float32)
    coords = np.stack(np.meshgrid(np.arange(8) * 8, np.arange(5) * 8),
                      -1).reshape(-1, 2)
    got = tmast3r.reciprocal_nn_desc(
        *(torch.from_numpy(a) for a in (d0, d1, c0, c1, coords)),
        max_matches=32)
    want = jmast3r.reciprocal_nn_desc(
        *(jnp.asarray(a) for a in (d0, d1, c0, c1, coords)), max_matches=32)
    keys = ("keypoints0", "keypoints1", "scores", "mask")
    n = _same_matches({k: v[None] for k, v in zip(keys, got)},
                      {k: np.asarray(v)[None] for k, v in zip(keys, want)},
                      20)
    assert n <= 32


# --------------------------------------------------------------------------
# served through the dense ImageMatchingAPI branch
# --------------------------------------------------------------------------

def _apis(name, conf, size1=None):
    confs = []
    for ui in (jui, tui):
        c = ui.parse_match_config({"matcher": name, "dense": True})
        c["matcher"]["model"].update(conf)
        c["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(c)
    jmod, _ = MODULES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "load_params",
                   lambda *a, **k: (None, {"pretrained": False}))
        japi = JaxAPI(confs[0])
    tapi = TorchAPI(confs[1], device="cpu")
    japi.matcher.params = _carried(tapi.matcher.params,
                                   _jax_init(name, japi.matcher.conf))
    return japi, tapi


@pytest.mark.parametrize("name", ["duster", "mast3r"])
def test_served_through_the_dense_api_matches_jax(name):
    """The registry's conf (resize_max 512, dfactor 16) at ``TINY`` on a
    planted 160 x 112 pair: the views are floored to 160 x 112 and padded
    to a 256 x 256 canvas, 16 x 16 tokens."""
    japi, tapi = _apis(name, TINY)
    assert tapi.conf["matcher"]["preprocessing"]["resize_max"] == 512
    assert tapi.conf["matcher"]["preprocessing"]["dfactor"] == 16
    planted = chip_smoke.synthetic_pair(101, 160, 120)
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    assert set(got) == set(want)
    assert len(got["mkeypoints0_orig"]) == len(want["mkeypoints0_orig"]) > 5
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0


def test_two_views_of_different_shapes_share_one_grid():
    """A 160 x 120 view against a 120 x 160 one: the dense pipeline pads
    both to one canvas, so ``decode``'s positions (view 0's grid in the
    JAX package) fit both views; both packages agree."""
    japi, tapi = _apis("duster", TINY)
    seen = []
    real = tduster.encode

    def spy(params, image, conf):
        seen.append(tuple(image.shape))
        return real(params, image, conf)

    a = chip_smoke.synthetic_pair(102, 160, 120)[0]
    b = chip_smoke.synthetic_pair(103, 120, 160)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tduster, "encode", spy)
        got = tapi(a, b)
    want = japi(a, b)
    assert seen == [(3, 256, 256)] * 2
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0


# --------------------------------------------------------------------------
# attention routes
# --------------------------------------------------------------------------

def _bf16_pointmaps(tm, jm, data, impl="xla"):
    """View 1's pointmap from both packages in bfloat16, the port's with
    ``vit.ATTN_IMPL = impl``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvit, "ATTN_IMPL", impl)
        with torch.no_grad():
            x = [tm._prepare(data[k])[0] for k in ("image0", "image1")]
            t0, grid = tduster.encode(tm.params, x[0], tm.conf)
            t1, _ = tduster.encode(tm.params, x[1], tm.conf)
            _, th1 = tduster.decode(tm.params, t0, t1, grid, tm.conf)
            pts, _ = tduster.head_to_pointmap(tm.params["downstream_head2"],
                                              th1, grid, 16)
    assert th1[-1].dtype == torch.bfloat16
    jx = [jnp.asarray(((data[k][0] - 0.5) / 0.5).transpose(1, 2, 0)).astype(
        jnp.bfloat16) for k in ("image0", "image1")]
    _, jh1, jpts, _ = _jax_trunk(jm, *jx)
    assert jh1[-1].dtype == jnp.bfloat16
    return pts.numpy(), np.asarray(jpts, np.float64)


def _median_rel(got, want):
    return float(np.median(np.abs(got - want)) / np.abs(want).max())


def test_bf16_matches_jax():
    """bfloat16 on the default route: RoPE's float32 q and k take the
    plain attention in both packages, whose weights and output round to
    the tokens' bfloat16."""
    jm, tm = _models("duster", TINY64, "bf16")
    pts, jpts = _bf16_pointmaps(tm, jm, _pair())
    assert _median_rel(pts, jpts) <= 2e-2


@pytest.mark.parametrize("name", ["duster", "mast3r"])
def test_bf16_fused_routes_every_block_through_k14(name):
    """bfloat16 with ``ATTN_IMPL = "fused"``: the port rounds RoPE's q and
    k back to bfloat16 and sends every attention of the trunk through
    ``mha_auto`` to K14 (``qtiled_attention``; its plain version on the
    CPU), 2 x 2 encoder and 2 x 2 x 2 decoder calls a pair at head dim 64;
    the result stays within bfloat16 of the JAX package's."""
    jm, tm = _models(name, TINY64, "bf16")
    calls = []
    real = tatt.qtiled_attention

    def spy(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape), q.dtype, k.dtype))
        return real(q, k, v)

    data = _pair()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tatt, "qtiled_attention", spy)
        pts, jpts = _bf16_pointmaps(tm, jm, data, "fused")
        assert len(calls) == 2 * 2 + 2 * 2 * 2
        calls.clear()
        mp.setattr(tvit, "ATTN_IMPL", "fused")
        got = tm(data)
    assert len(calls) == 2 * 2 + 2 * 2 * 2
    assert set(calls) == {((2, 24, 64), (2, 24, 64), torch.bfloat16,
                           torch.bfloat16)}
    assert got["mask"].any()
    assert _median_rel(pts, jpts) <= 2e-2


def test_jax_rope_blocks_reach_no_kernel_in_bf16():
    """In the JAX package RoPE multiplies bf16 q and k by float32 cos and
    sin, which promotes them to float32, so ``vit.py:114`` sends DUSt3R's
    blocks to the einsum even with ``ATTN_IMPL = "fused"``: its
    ``mha_auto`` is never called (the port's deviation is above)."""
    jm, _ = _models("duster", TINY64, "bf16")
    seen = []
    x = jnp.asarray(np.zeros((64, 96, 3), np.float32)).astype(jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "ATTN_IMPL", "fused")
        mp.setattr(jatt, "mha_auto",
                   lambda *a: seen.append(1) or jatt.mha(*a))
        t, _ = jax.jit(lambda p, a: jduster.encode(p, a, jm.conf))(
            jm.params, x)
    assert seen == [] and t.dtype == jnp.bfloat16


def test_f32_vit_reaches_no_kernel_in_either_package():
    """float32 tokens take the plain attention whatever ``ATTN_IMPL``
    says: ``vit.py:114`` of the JAX package and the port route to a
    kernel only when q is bfloat16."""
    seen = []
    jm, tm = _models("duster", TINY64)
    data = _pair()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvit, "ATTN_IMPL", "fused")
        mp.setattr(jvit, "ATTN_IMPL", "fused")
        mp.setattr(tatt, "mha_auto", lambda *a: seen.append("port"))
        mp.setattr(jatt, "mha_auto", lambda *a: seen.append("jax"))
        got, want = tm(data), jm(data)
    assert seen == []
    _same_matches(got, want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["duster", "mast3r"])
def test_model_on_cuda_without_a_card_raises(name):
    from imcui_tpu_torch.models import matchers
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(matchers, name)(TINY)
