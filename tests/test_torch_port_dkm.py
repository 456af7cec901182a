"""ResNet-50 and DKMv3: the port against the JAX package on the CPU.
``layers.max_pool3_s2``, the bottleneck block, GeM pooling, the
ResNet-50 pyramid DKM reads, DKM's DFN pieces, the BaseModel, the
registry's ``dkm`` through both dense ``ImageMatchingAPI``s at the same
256 x 256 operating point (one JAX compile for the file), and the
registry's resize rule.

Every tree is the port's seed-0 tree carried to the JAX layout by
``params_to_jax`` and checked against ``jax.eval_shape`` of the JAX init
(the JAX random init of ResNet-50 is never drawn); the JAX side runs
jitted.

Tolerances, float32: the pool exact; the bottleneck block, GeM and the
pyramid within 1e-4 of each map's largest value (convolutions summing in
another order over 50 layers); correspondences as sets of point pairs
within 1e-4 of the largest coordinate (the random tree's warps reach
thousands of normalised units) at IoU ≥ 0.98 (the JAX sample's top-k is
approximate at recall 0.95 on a TPU and exact here; certainties within
1e-4 can swap places at the cut, the D2-Net precedent), the sorted
certainties within 1e-4; through the API, where 15/16 of the canvas is
padding, the correspondences of the cells both packages picked (IoU of
the cells ≥ 0.5) within the same 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models import layers as jlayers
from imcui_tpu.models.backbones import resnet as jresnet
from imcui_tpu.models.matchers import dkm as jdkm
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models import layers as tlayers
from imcui_tpu_torch.models.backbones import resnet as tresnet
from imcui_tpu_torch.models.matchers import dkm as tdkm
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

KEY = jax.random.PRNGKey(0)


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


@pytest.fixture(scope="module")
def dkm_trees():
    """The port's seed-0 DKM tree, and the same in the JAX layout."""
    ttree = tdkm.init_params(torch.Generator().manual_seed(0))
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(lambda: jdkm.init_params(KEY))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree, ttree


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-30, np.abs(want).max())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (3, 5)])
def test_max_pool3_s2_matches_jax(hw):
    """3 × 3, stride 2, padding 1 with −inf: on negative inputs a zero pad
    would show."""
    x = (np.random.default_rng(0).standard_normal((1,) + hw + (3,))
         - 5.0).astype(np.float32)
    got = tlayers.max_pool3_s2(_nchw(x))
    want = np.asarray(jlayers.max_pool3_s2(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    assert (got < -1.0).all()
    two = torch.nn.functional.max_pool2d(_nchw(x), 2, 2)
    if hw == (8, 8):
        assert two.shape == got.shape and not torch.equal(two, got)


@pytest.mark.parametrize("stride,cin", [(1, 64), (2, 128), (1, 256)])
def test_bottleneck_block_matches_jax(stride, cin):
    p = tresnet.init_bottleneck(torch.Generator().manual_seed(1), cin, 64,
                                stride)
    assert ("downsample" in p) == (stride != 1 or cin != 256)
    x = np.random.default_rng(1).standard_normal((1, 9, 11, cin)).astype(
        np.float32)
    jp = weights.params_to_jax(p)
    want = jax.jit(jresnet.bottleneck_block, static_argnums=2)(
        jp, jnp.asarray(x), stride)
    got = tresnet.bottleneck_block(weights.params_from_jax(jp), _nchw(x),
                                   stride)
    assert _rel(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)) <= 1e-4


def test_gem_pool_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 6, 7)).astype(
        np.float32)
    for p in (3.0, np.float32(2.5)):
        got = tresnet.gem_pool(_nchw(x), torch.tensor(p))
        want = jresnet.gem_pool(jnp.asarray(x), p)
        assert _rel(got.numpy(), want) <= 1e-5


def test_resnet50_pyramid_matches_jax(dkm_trees):
    """Strides 1-32 of a 96 x 128 view, and ``resnet_apply`` on a batch."""
    jtree, ttree = dkm_trees
    x = np.random.default_rng(3).standard_normal((96, 128, 3)).astype(
        np.float32)
    want = jax.jit(jresnet.resnet_pyramid_apply)(jtree["encoder"],
                                                 jnp.asarray(x))
    with torch.no_grad():
        got = tresnet.resnet_pyramid_apply(
            ttree["encoder"], torch.from_numpy(x.transpose(2, 0, 1).copy()))
        top = tresnet.resnet_apply(ttree["encoder"],
                                   _nchw(np.stack([x, x[::-1]])))
    assert sorted(got) == sorted(want) == [1, 2, 4, 8, 16, 32]
    for s in got:
        w = np.asarray(want[s]).transpose(2, 0, 1)
        assert got[s].shape == w.shape == (
            {1: 3, 2: 64, 4: 256, 8: 512, 16: 1024, 32: 2048}[s],
            96 // s, 128 // s), s
        assert _rel(got[s].numpy(), w) <= 1e-4, s
    assert top.shape == (2, 2048, 3, 4)
    assert _rel(top[0].numpy(), np.asarray(want[32]).transpose(2, 0, 1)) \
        <= 1e-4


def test_dfn_blocks_match_jax(dkm_trees):
    jtree, ttree = dkm_trees
    dec_j, dec_t = jtree["embedding_decoder"], ttree["embedding_decoder"]
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((1, 3, 4, 512)).astype(np.float32)
    gp = rng.standard_normal((1, 3, 4, 256)).astype(np.float32)
    ctx = rng.standard_normal((1, 3, 4, 384)).astype(np.float32)
    wf, wc, wctx = jdkm._dfn_apply(dec_j, "16", jnp.asarray(gp),
                                   jnp.asarray(feats), jnp.asarray(ctx))
    with torch.no_grad():
        tf, tc, tctx = tdkm.dfn_apply(dec_t, "16", _nchw(gp), _nchw(feats),
                                      _nchw(ctx))
    assert _rel(tf.numpy(), wf[0]) <= 1e-4
    assert _rel(tc.numpy(), wc[0]) <= 1e-4
    assert _rel(tctx.numpy(), np.asarray(wctx).transpose(0, 3, 1, 2)) <= 1e-4


def _pairs_tol(pts):
    """1e-4 of the largest coordinate: the random tree's warps run to
    thousands of normalised units, so its image-1 points reach 1e5 px."""
    return 1e-4 * max(1.0, float(np.abs(pts).max()))


def _same_correspondences(got, want, least):
    """Point pairs as sets, IoU ≥ 0.98 within ``_pairs_tol``."""
    jm, tm = np.asarray(want["mask"][0]), got["mask"][0].numpy()
    assert tm.sum() >= least and jm.sum() >= least
    pj = np.concatenate([np.asarray(want["keypoints0"][0])[jm],
                         np.asarray(want["keypoints1"][0])[jm]], 1)
    pt = np.concatenate([got["keypoints0"][0].numpy()[tm],
                         got["keypoints1"][0].numpy()[tm]], 1)
    iou = chip_smoke.common_points(pt, pj, _pairs_tol(pj))[0]
    assert iou >= 0.98, iou


# the registry's operating point inside the API: its 80 x 56 image on the
# 256 x 256 canvas, 2000 slots; the BaseModel test runs the same program,
# so the JAX package compiles DKM once for the file
CANVAS = (256, 256)


def test_model_matches_jax(dkm_trees):
    """The BaseModel at coarse_res 256 x 256 on a 200 x 150 pair: the
    correspondences (each the warp at a cell of top certainty) and their
    certainties."""
    jtree, ttree = dkm_trees
    planted = chip_smoke.synthetic_pair(101, 200, 150)
    data = {f"image{i}": (planted[i].transpose(2, 0, 1)[None] / 255.0
                          ).astype(np.float32) for i in (0, 1)}
    conf = {"coarse_res": CANVAS, "max_keypoints": 2000}
    tm = tdkm.DKMv3(conf, device="cpu")
    tm.params = weights.params_from_jax(jtree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdkm, "load_params",
                   lambda *a, **k: (jtree, {"pretrained": False}))
        jm = jdkm.DKMv3(conf)
    got, want = tm(data), jm(data)
    assert got["keypoints0"].shape == (1, 2000, 2)
    _same_correspondences(got, want, 1900)
    js = np.sort(np.asarray(want["scores"][0]))
    assert np.abs(np.sort(got["scores"][0].numpy()) - js).max() <= 1e-4


def test_model_called_directly_rounds_its_input():
    """Without ``coarse_res`` the model runs at its input rounded to
    multiples of 32, half to even: 80 x 56 → 64 x 64, 320 x 240 → 256 x
    320 (round(7.5) = 8), 100 x 72 → 64 x 96."""
    assert tdkm.coarse_size({"coarse_res": None}, 56, 80) == (64, 64)
    assert tdkm.coarse_size({}, 240, 320) == (256, 320)
    assert tdkm.coarse_size({}, 72, 100) == (64, 96)
    assert tdkm.coarse_size({"coarse_res": (544, 704)}, 9, 9) == (544, 704)


@pytest.mark.parametrize("key,size", [("dkm", CANVAS),
                                      ("gim(dkm)", (256, 320))])
def test_registry_resize_runs_on_the_canvas_as_jax(key, size):
    """Through the API the model sees the bucketed canvas, not the valid
    image: the registry's ``dkm`` forces 80 x 60, floored by dfactor 8 to
    80 x 56, padded to 256 x 256, and ``coarse_res`` None rounds the
    canvas, so DKM runs at 256 x 256 (64 x 64 on the image alone) in both
    packages; ``gim(dkm)``'s 320 x 240 sits on a 256 x 320 canvas."""
    seen = {}

    def spy_jax(params, image0, image1, max_matches):
        seen["jax"] = tuple(image0.shape[1:3])
        n = max_matches
        return {"keypoints0": jnp.zeros((1, n, 2)),
                "keypoints1": jnp.zeros((1, n, 2)),
                "scores": jnp.zeros((1, n)), "mask": jnp.zeros((1, n), bool)}

    def spy_port(self, a, b):
        seen["port"] = tuple(a.shape[1:])
        return (torch.zeros(a.shape[1:] + (2,)),
                torch.zeros(a.shape[1:]))

    planted = chip_smoke.synthetic_pair(101, 160, 120)
    conf_j = jui.parse_match_config({"matcher": key, "dense": True})
    conf_t = tui.parse_match_config({"matcher": key, "dense": True})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdkm, "load_params",
                   lambda *a, **k: (None, {"pretrained": False}))
        mp.setattr(jdkm, "_apply_batched", spy_jax)
        mp.setattr(tdkm, "init_params", lambda gen, conf=None: {})
        mp.setattr(tdkm.DKMv3, "match", spy_port)
        JaxAPI(conf_j)(planted[0], planted[1])
        TorchAPI(conf_t, device="cpu")(planted[0], planted[1])
    assert (seen["jax"], seen["port"]) == (size, size), seen


def test_served_through_the_dense_api_matches_jax(dkm_trees):
    """The registry's ``dkm`` (80 x 60 forced, the 256 x 256 canvas, 2000
    slots) through both APIs on a planted 160 x 120 pair."""
    jtree, ttree = dkm_trees
    confs = []
    for ui in (jui, tui):
        c = ui.parse_match_config({"matcher": "dkm", "dense": True})
        c["ransac"] = {**TorchAPI.default_conf["ransac"], "enable": False}
        confs.append(c)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdkm, "load_params",
                   lambda *a, **k: (jtree, {"pretrained": False}))
        japi = JaxAPI(confs[0])
        mp.setattr(tdkm, "init_params", lambda gen, conf=None: ttree)
        tapi = TorchAPI(confs[1], device="cpu")
    assert tapi.matcher.meta["pretrained"] is False
    planted = chip_smoke.synthetic_pair(101, 160, 120)
    want = japi(planted[0], planted[1])
    got = tapi(planted[0], planted[1])
    assert set(got) == set(want)
    assert len(got["mkeypoints0_orig"]) == len(want["mkeypoints0_orig"]) \
        == 2000
    # 15/16 of the canvas is zero padding, whose cells' certainties differ
    # in the last bits only, so the two top-k cuts pick partly different
    # cells there; where both picked a cell, both warp it alike
    iou, it, ij = chip_smoke.common_points(got["mkeypoints0_orig"],
                                           want["mkeypoints0_orig"], 1e-3)
    assert iou >= 0.5, iou
    k1, jk1 = got["mkeypoints1_orig"][it], want["mkeypoints1_orig"][ij]
    assert np.abs(k1 - jk1).max() <= _pairs_tol(jk1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_model_on_cuda_without_a_card_raises():
    from imcui_tpu_torch.models import matchers
    from imcui_tpu_torch.utils.base_model import dynamic_load

    with pytest.raises(RuntimeError, match="cuda"):
        dynamic_load(matchers, "dkm")({})
