"""The root zoo's last matchers: the port against the JAX package on the
CPU. The ONNX reader on hand-encoded ``ModelProto`` bytes; the Example
extractor and matcher; MicKey; COTR; OmniGlue; each part by part and end
to end through both ``ImageMatchingAPI``s at the root ``config/app.yaml``
entry (the disabled ``Example`` and ``cotr`` by their conf).

Every model runs the port's seed-0 tree, carried to the JAX package's
layout by ``params_to_jax`` and checked against the layout of the JAX
init (``jax.eval_shape``); OmniGlue's SuperPoint runs the trained
``weights/superpoint_adapted.npz`` in both.

Tolerances: the readers' arrays equal bit for bit; scores, features and
tokens within 1e-5 of the largest (5e-5 through COTR's twelve layers and
ResNet-50); keypoints equal, or within 1e-3 px where a position comes out
of a network; MicKey's ``R`` and ``t`` within 1e-4 (the port fits them in
float64, the JAX package in float32), never its singular vectors; match
masks equal. End to end, the raw match sets at IoU 1.0 within 1e-3 px,
but for OmniGlue at its bf16 SuperPoint default, whose keypoints can
differ from the JAX package's (ROADMAP, "bf16 SuperPoint"): each view's
keypoints at IoU >= 0.8 and the matches on the keypoints both keep at
IoU >= 0.9. The random learned
matchers keep matches only at ``match_threshold`` 1e-6, the threshold
these comparisons use.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import superpoint as jsuperpoint
from imcui_tpu.models.extractors import example as jexample
from imcui_tpu.models.matchers import cotr as jcotr
from imcui_tpu.models.matchers import mickey as jmickey
from imcui_tpu.models.matchers import omniglue as jomni
from imcui_tpu.ui import utils as jui
from imcui_tpu.utils import onnx_reader as jonnx
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.extractors import example as texample
from imcui_tpu_torch.models.matchers import cotr as tcotr
from imcui_tpu_torch.models.matchers import mickey as tmickey
from imcui_tpu_torch.models.matchers import omniglue as tomni
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import onnx_reader as tonnx
from imcui_tpu_torch.utils import weights

KEY = jax.random.PRNGKey(0)
ROOT = Path(__file__).resolve().parents[1]
LOW = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _offline():
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(init, ttree):
    jtree = weights.params_to_jax(ttree)
    shapes = jax.eval_shape(init)
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jtree


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _root_conf(ui, key):
    """The root config/app.yaml entry ``key``, enabled or not."""
    raw = ui.load_config(ROOT / "config" / "app.yaml")["matcher_zoo"][key]
    return ui.parse_match_config(raw)


# --------------------------------------------------------------------------
# the ONNX reader
# --------------------------------------------------------------------------

def _varint(v):
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _field(num, wire, payload):
    tag = _varint((num << 3) | wire)
    return tag + _varint(len(payload)) + payload if wire == 2 \
        else tag + payload


def _tensor(name, arr, how="raw"):
    """A TensorProto: dims unpacked, or packed where ``how`` is "packed
    dims"; the data as raw_data, packed float/double/int64 data, or one
    unpacked float per field."""
    dtype_id = {np.float32: 1, np.int64: 7, np.float16: 10, np.float64: 11,
                "bf16": 16}
    if how == "packed dims":
        body = _field(1, 2, b"".join(_varint(d) for d in arr.shape))
    else:
        body = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    if how == "bf16":
        body += _field(2, 0, _varint(dtype_id["bf16"]))
    else:
        body += _field(2, 0, _varint(dtype_id[arr.dtype.type]))
    body += _field(8, 2, name.encode())
    if how == "bf16":
        u32 = np.ascontiguousarray(arr, "<f4").view("<u4")
        body += _field(9, 2, (u32 >> 16).astype("<u2").tobytes())
    elif how in ("raw", "packed dims"):
        body += _field(9, 2, arr.astype(arr.dtype.newbyteorder("<"))
                       .tobytes())
    elif how == "typed" and arr.dtype == np.float32:
        body += _field(4, 2, arr.astype("<f4").tobytes())
    elif how == "typed" and arr.dtype == np.float64:
        body += _field(10, 2, arr.astype("<f8").tobytes())
    elif how == "typed":
        body += _field(7, 2, b"".join(_varint(int(v))
                                      for v in arr.reshape(-1)))
    elif how == "unpacked":
        body += b"".join(_field(4, 5, np.float32(v).astype("<f4").tobytes())
                         for v in arr.reshape(-1))
    return body


def _model(tensors):
    graph = _field(1, 2, b"") + b"".join(_field(5, 2, t) for t in tensors)
    return _field(1, 0, _varint(8)) + _field(7, 2, graph)


def test_onnx_reader_matches_jax(tmp_path):
    """Both readers on one hand-encoded ModelProto: raw, packed-typed and
    unpacked data, packed dims, float16, float64, int64, bfloat16 (whose
    bits are the float32's top half), a scalar; the same arrays bit for
    bit, the same state-dict names, and the same error on a tensor with
    external data."""
    rng = np.random.default_rng(0)
    bf = rng.normal(size=(3, 5)).astype(np.float32)
    bf = (bf.view(np.uint32) & 0xFFFF0000).view(np.float32)
    tensors = [
        ("model/kenc/Conv_W:0", rng.normal(size=(8, 3, 1, 1))
         .astype(np.float32), "raw"),
        ("gnn.layers.0.weight", rng.normal(size=(4, 6)).astype(np.float32),
         "typed"),
        ("gnn/layers/1/bias:7", rng.normal(size=(6,)).astype(np.float32),
         "unpacked"),
        ("shape_info", np.asarray([3, 128, 64], np.int64), "typed"),
        ("half_bias", rng.normal(size=(5,)).astype(np.float16), "raw"),
        ("double", rng.normal(size=(2, 3)).astype(np.float64), "typed"),
        ("packed_dims", rng.normal(size=(2, 3, 4)).astype(np.float32),
         "packed dims"),
        ("bf16_w", bf, "bf16"),
        ("scalar", np.asarray(2.5, np.float32), "raw"),
    ]
    path = tmp_path / "synthetic.onnx"
    path.write_bytes(_model([_tensor(n, a, h) for n, a, h in tensors]))
    got, want = (m.read_onnx_initializers(path) for m in (tonnx, jonnx))
    assert set(got) == set(want) == {n for n, _, _ in tensors}
    for name, arr, _ in tensors:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    rename = ((r"^model\.", ""), (r"^gnn\.", "matcher."))
    sd_got, sd_want = (m.onnx_to_state_dict(path, rename=rename)
                       for m in (tonnx, jonnx))
    assert sorted(sd_got) == sorted(sd_want)
    assert {"kenc.Conv_W", "matcher.layers.1.bias"} <= set(sd_got)
    ext = tmp_path / "external.onnx"
    ext.write_bytes(_model([_tensor("w", bf, "raw") + _field(13, 2, b"")]))
    for m in (tonnx, jonnx):
        with pytest.raises(ValueError, match="external data"):
            m.read_onnx_initializers(ext)


# --------------------------------------------------------------------------
# Example
# --------------------------------------------------------------------------

def test_example_extractor_matches_jax():
    """``apply`` on a 2-image batch with different valid regions: the
    keypoints equal, scores and descriptors within 1e-5."""
    ttree = texample.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jexample.init_params(KEY), ttree)
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(2, 1, 48, 64)).astype(np.float32)
    vwh = np.asarray([[64, 48], [50, 40]], np.int32)
    want = jexample.apply(jtree, jnp.asarray(img), jnp.asarray(vwh),
                          max_keypoints=64)
    got = texample.apply(weights.params_from_jax(jtree), _t(img),
                         _t(vwh).long(), max_keypoints=64)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert got["mask"].all()
    np.testing.assert_array_equal(got["keypoints"].numpy(), want["keypoints"])
    assert _rel(got["scores"], want["scores"]) <= 1e-5
    assert _rel(got["descriptors"], want["descriptors"]) <= 1e-5
    assert (got["keypoints"][1, :, 0] < 48).all()


def test_example_entry_through_both_apis():
    """The root yaml's disabled ``Example``, constructed by its conf: the
    same empty match set from both packages."""
    raw = tui.load_config(ROOT / "config" / "app.yaml")["matcher_zoo"]
    assert raw["Example"]["enable"] is False
    img0, img1, _ = chip_smoke.synthetic_pair(100, 160, 120)
    got = TorchAPI(_root_conf(tui, "Example"), device="cpu")(img0, img1)
    want = JaxAPI(_root_conf(jui, "Example"))(img0, img1)
    for k in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf"):
        assert len(got[k]) == len(want[k]) == 0, k


# --------------------------------------------------------------------------
# MicKey
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mickey_trees():
    ttree = tmickey.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jmickey.init_params(KEY), ttree)
    return jtree, weights.params_from_jax(jtree)


def test_mickey_heads_and_pose_match_jax(mickey_trees):
    """``heads`` on two views, then the matching and the two Kabsch fits
    on the JAX package's head outputs: keypoints, depth, score and
    descriptors within 1e-5; the inlier mask equal; R and t within 1e-4
    (float64 here, float32 there)."""
    jtree, ttree = mickey_trees
    rng = np.random.default_rng(2)
    imgs = rng.uniform(size=(2, 3, 64, 96)).astype(np.float32)
    heads = jax.jit(jmickey.heads)
    want = [heads(jtree, jnp.asarray(x.transpose(0, 2, 3, 1)))
            for x in (imgs[:1], imgs[1:])]
    got = [tmickey.heads(ttree, _t(x)) for x in (imgs[:1], imgs[1:])]
    for g, w in zip(got, want):
        assert g[0].shape == (1, 8, 12, 2)
        for a, b in zip(g, w):
            assert _rel(a, b) <= 1e-5
    size = np.asarray([[96, 64]], np.float32)
    jout = jax.jit(jax.vmap(
        lambda *a: jmickey.forward_pair(a[:8], a[8], a[9], LOW)))(
        *want[0], *want[1], jnp.asarray(size), jnp.asarray(size))
    tout = tmickey.match_pose(
        [_t(x) for x in want[0]], [_t(x) for x in want[1]], _t(size),
        _t(size), LOW)
    np.testing.assert_array_equal(tout["mask"].numpy(), jout["mask"])
    assert tout["mask"].sum() >= 20
    for k in ("keypoints0", "keypoints1", "scores"):
        assert _rel(tout[k], jout[k]) <= 1e-5, k
    np.testing.assert_allclose(tout["R"].numpy(), jout["R"], atol=1e-4)
    np.testing.assert_allclose(tout["t"].numpy(), jout["t"], atol=1e-4)
    r = tout["R"][0].double()
    assert torch.allclose(r @ r.T, torch.eye(3, dtype=torch.float64),
                          atol=1e-6)
    assert abs(torch.linalg.det(r).item() - 1.0) <= 1e-6


def test_mickey_kabsch_recovers_a_planted_motion():
    """Weighted points under a known rotation and translation: R and t
    come back to 1e-9; zero weights leave a point out."""
    gen = torch.Generator().manual_seed(3)
    p = torch.randn(1, 50, 3, generator=gen, dtype=torch.float64)
    a = torch.linalg.qr(torch.randn(3, 3, generator=gen,
                                    dtype=torch.float64))[0]
    a = a * torch.sign(torch.linalg.det(a))
    t = torch.tensor([[0.3, -1.2, 2.0]], dtype=torch.float64)
    q = p @ a.T + t[:, None]
    w = torch.rand(1, 50, generator=gen, dtype=torch.float64)
    w[0, :5] = 0.0
    q[0, :5] += 10.0  # outliers, weighted 0
    r, tt = tmickey.kabsch(p, q, w)
    assert torch.allclose(r[0], a, atol=1e-9)
    assert torch.allclose(tt, t, atol=1e-9)


def _apis(key, jtree, ttree, jmod, size=(160, 120), threshold=LOW):
    """Both packages' API on the root entry ``key`` at a cut canvas, with
    the port's tree in both."""
    apis = []
    for ui in (jui, tui):
        conf = _root_conf(ui, key)
        conf["matcher"]["preprocessing"].update(
            width=size[0], height=size[1], resize_max=max(size))
        if ui is jui:
            mp = pytest.MonkeyPatch()
            mp.setattr(jmod, "load_params",
                       lambda c: (jtree, {"pretrained": False}))
            try:
                apis.append(JaxAPI(conf, match_threshold=threshold))
            finally:
                mp.undo()
        else:
            api = TorchAPI(conf, device="cpu", match_threshold=threshold)
            api.matcher.params = ttree
            apis.append(api)
    return apis


def test_mickey_through_both_apis(mickey_trees):
    """The root ``mickey`` entry (force-resized to 160 × 120 here): the
    same inlier matches (IoU 1.0 within 1e-3 px) and pose."""
    jtree, ttree = mickey_trees
    japi, tapi = _apis("mickey", jtree, ttree, jmickey)
    img0, img1, _ = chip_smoke.synthetic_pair(100, 320, 240)
    outs = []
    hook = tapi.matcher.register_forward_hook(
        lambda mod, args, o: outs.append(o))
    try:
        got = tapi(img0, img1)
    finally:
        hook.remove()
    want = japi(img0, img1)
    assert len(got["mkeypoints0_orig"]) >= 20
    assert chip_smoke.raw_match_iou(got, want, 1e-3) == 1.0
    jpred = japi.matcher({"image0": _prep(img0), "image1": _prep(img1)})
    np.testing.assert_allclose(outs[0]["R"].numpy(), jpred["R"], atol=1e-4)
    np.testing.assert_allclose(outs[0]["t"].numpy(), jpred["t"], atol=1e-4)


def _prep(img, size=(160, 120)):
    from imcui_tpu_torch.utils import image as timage

    return timage.preprocess(img, grayscale=False, resize_max=max(size),
                             force_resize=True, width=size[0],
                             height=size[1])["image"]


# --------------------------------------------------------------------------
# COTR
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cotr_trees():
    """The port's seed-0 tree with ``corr_embed``'s last layer scaled by
    0.1 and its x bias at 0.75, so that the random decoder's predictions
    land on the right half and the queries are matches (seed 0 alone
    predicts x near 0: no match on either side, nothing to compare)."""
    ttree = weights.seeded_init(tcotr.init_params, "cpu")
    last = ttree["corr_embed"]["layers"]["2"]
    last["w"] *= 0.1
    last["b"][0] = 0.75
    jtree = _carried(lambda: jcotr.init_params(KEY), ttree)
    return jtree, weights.params_from_jax(jtree)


def test_cotr_parts_match_jax(cotr_trees):
    """``backbone_tokens`` on a 64 × 128 canvas, an encoder layer, a
    decoder layer and ``decode`` on 8 queries: within 5e-5 of the
    largest."""
    jtree, ttree = cotr_trees
    rng = np.random.default_rng(4)
    canvas = rng.normal(size=(64, 128, 3)).astype(np.float32)
    jmem, jpos = jax.jit(jcotr.backbone_tokens)(jtree, jnp.asarray(canvas))
    tmem, tpos = tcotr.backbone_tokens(ttree,
                                       _t(canvas.transpose(2, 0, 1))[None])
    assert tmem.shape == (1, 32, 256) and tpos.shape == (32, 256)
    assert _rel(tmem[0], jmem) <= 5e-5 and _rel(tpos, jpos) <= 1e-5
    enc = jtree["transformer"]["encoder"]["layers"]["0"]
    dec = jtree["transformer"]["decoder"]["layers"]["0"]
    tenc = ttree["transformer"]["encoder"]["layers"]["0"]
    tdec = ttree["transformer"]["decoder"]["layers"]["0"]
    mem = np.asarray(jmem)
    jm = jax.jit(jcotr.enc_layer)(enc, jmem, jpos)
    tm = tcotr.enc_layer(tenc, _t(mem)[None], _t(jpos))
    assert _rel(tm[0], jm) <= 1e-5
    q = rng.uniform(size=(8, 2)).astype(np.float32)
    qpos = np.asarray(jcotr.nerf_encode(jnp.asarray(q)))
    assert _rel(tcotr.nerf_encode(_t(q)), qpos) <= 1e-5
    tgt = rng.normal(size=(8, 256)).astype(np.float32)
    jd = jax.jit(jcotr.dec_layer)(dec, jnp.asarray(tgt), jm, jpos,
                                  jnp.asarray(qpos))
    td = tcotr.dec_layer(tdec, _t(tgt)[None], _t(np.asarray(jm))[None],
                         _t(jpos), _t(qpos)[None])
    assert _rel(td[0], jd) <= 1e-5
    jy = jax.jit(jcotr.decode)(jtree, jm, jpos, jnp.asarray(q))
    ty = tcotr.decode(ttree, _t(np.asarray(jm))[None], _t(jpos), _t(q)[None])
    assert _rel(ty[0], jy) <= 5e-5


def test_cotr_through_both_apis(cotr_trees):
    """The root yaml's disabled ``cotr``, by its conf, on a 320 × 240
    pair (force-resized to 160 × 120, then to COTR's 256 × 256 tiles): the
    whole model once, the same 256 correspondences within 1e-3 px and
    confidences within 5e-5."""
    jtree, ttree = cotr_trees
    japi, tapi = _apis("cotr", jtree, ttree, jcotr, threshold=0.2)
    assert not tapi.matcher.meta["pretrained"]
    img0, img1, _ = chip_smoke.synthetic_pair(100, 320, 240)
    got, want = tapi(img0, img1), japi(img0, img1)
    assert len(got["mkeypoints0_orig"]) == len(want["mkeypoints0_orig"])
    assert len(got["mkeypoints0_orig"]) >= 200
    for k in ("mkeypoints0_orig", "mkeypoints1_orig"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    np.testing.assert_allclose(got["mconf"], want["mconf"], atol=5e-5)


# --------------------------------------------------------------------------
# OmniGlue
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def omniglue_trees():
    ttree = tomni.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jomni.init_params(KEY), ttree)
    return jtree, weights.params_from_jax(jtree)


def test_omniglue_dino_and_matcher_match_jax(omniglue_trees):
    """``dino_features`` on a 70 × 100 view (cropped to 70 × 98), then
    the matcher on padded keypoint sets of the entry's 2000 slots at
    threshold 1e-6: features and scores within 1e-5, the match mask and
    keypoints equal; the features scaled by the set's matrix −1 norm, as
    the JAX function scales them."""
    jtree, ttree = omniglue_trees
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(3, 70, 100)).astype(np.float32)
    n = 2000
    kp = [np.stack([rng.uniform(0, 99.9, n), rng.uniform(0, 69.9, n)],
                   -1).astype(np.float32) for _ in range(2)]
    kp[0][-300:] = 0.0
    dino = jax.jit(jomni.dino_features)
    want_g = [dino(jtree, jnp.asarray(img), jnp.asarray(k)) for k in kp]
    got_g = [tomni.dino_features(ttree, _t(img), _t(k)) for k in kp]
    for g, w in zip(got_g, want_g):
        assert _rel(g, w) <= 1e-5
        # the JAX function's norm(f, -1) is the matrix −1 norm (ROADMAP
        # §C): the least column sum of |f| comes out 1, the rows are not
        # unit vectors
        assert abs(g.abs().sum(0).min().item() - 1.0) <= 1e-5
        assert (torch.linalg.vector_norm(g, dim=1) < 0.5).all()
    m0 = np.ones(n, bool)
    m0[-300:] = False
    m1 = np.ones(n, bool)
    m1[:200] = False
    s = [rng.uniform(size=n).astype(np.float32) for _ in range(2)]
    d = [rng.normal(size=(n, 256)).astype(np.float32) for _ in range(2)]
    size = np.asarray([[100, 70]], np.float32)
    g = [np.asarray(w) for w in want_g]
    want = jomni._apply_batched(
        jtree, *(jnp.asarray(x[None]) for x in
                 (kp[0], kp[1], s[0], s[1], d[0], d[1], g[0], g[1], m0, m1)),
        jnp.asarray(size), jnp.asarray(size), LOW)
    got = tomni.match(ttree, *(_t(x[None]) for x in
                               (kp[0], kp[1], s[0], s[1], d[0], d[1], g[0],
                                g[1], m0, m1)), _t(size), _t(size), LOW)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert 100 <= got["mask"].sum() <= n - 300
    np.testing.assert_array_equal(got["keypoints1"].numpy(),
                                  want["keypoints1"])
    assert _rel(got["scores"], want["scores"]) <= 1e-5


class _Recorded:
    """The JAX OmniGlue's SuperPoint, keeping each call's outputs."""

    def __init__(self, model):
        self.model, self.out = model, []

    def __call__(self, data):
        o = self.model(data)
        self.out.append({k: np.asarray(v) for k, v in o.items()})
        return o

    def __getattr__(self, name):
        return getattr(self.model, name)


def test_omniglue_through_both_apis(omniglue_trees, monkeypatch):
    """The root ``omniglue`` entry at resize_max 320 on a planted 320 ×
    240 pair, at threshold 1e-6, with its bf16 SuperPoint on the trained
    tree in both packages: each view's keypoints at IoU >= 0.8 (measured
    0.96 and 0.94), the matches on the keypoints both packages keep at IoU
    >= 0.9 within 1e-3 px (measured 1.0), all matches at IoU >= 0.8
    (measured 0.94). The matcher alone is held exactly on the same
    keypoints in ``test_omniglue_dino_and_matcher_match_jax``."""
    jtree, ttree = omniglue_trees
    sp_tree = TorchAPI(_root_conf(tui, "omniglue"), device="cpu"
                       ).matcher.sp.params
    monkeypatch.setattr(jsuperpoint, "load_params", lambda c: (
        weights.params_to_jax(sp_tree), {"pretrained": True}))
    # the JAX model maps its ViT over the batch eagerly, op by op; its
    # function jitted is the same arithmetic, compiled once
    monkeypatch.setattr(jomni, "dino_features",
                        jax.jit(jomni.dino_features))
    japi, tapi = _apis("omniglue", jtree, ttree, jomni, size=(320, 240))
    assert tapi.matcher.sp.meta["pretrained"]
    rec = _Recorded(japi.matcher.sp)
    monkeypatch.setattr(japi.matcher, "sp", rec)
    tout = []
    hook = tapi.matcher.sp.register_forward_hook(
        lambda mod, args, o: tout.append(
            {k: v.detach().float().numpy() for k, v in o.items()}))
    img0, img1, _ = chip_smoke.synthetic_pair(100, 320, 240)
    try:
        got, want = tapi(img0, img1), japi(img0, img1)
    finally:
        hook.remove()
    kps = []
    for v in (0, 1):
        kp = [f["keypoints"][0][f["mask"][0].astype(bool)]
              for f in (rec.out[v], tout[v])]
        iou, ia, _ = chip_smoke.common_points(kp[0], kp[1], 0.01)
        kps.append((kp[0][ia], iou))
    assert min(len(k) for k, _ in kps) >= 60

    def on_common(pred):
        keep = np.ones(len(pred["mkeypoints0"]), bool)
        for v, (kp, _) in enumerate(kps):
            mk = np.asarray(pred[f"mkeypoints{v}"])
            keep &= (np.abs(mk[:, None] - kp[None]).max(-1) <= 0.01).any(1)
        return {k: np.asarray(pred[k])[keep]
                for k in ("mkeypoints0_orig", "mkeypoints1_orig")}

    iou_common = chip_smoke.raw_match_iou(on_common(got), on_common(want),
                                          1e-3)
    iou = chip_smoke.raw_match_iou(got, want, 1e-3)
    assert len(want["mkeypoints0_orig"]) >= 10
    assert min(i for _, i in kps) >= 0.8 and iou_common >= 0.9 \
        and iou >= 0.8, ([i for _, i in kps], iou_common, iou)
