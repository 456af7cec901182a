"""DaD-RoMa and RoMaV2, the two wrappers on RoMa: the port against the JAX
package on the CPU, model by model and end to end through both
``ImageMatchingAPI``s.

DaD's wrapper (the certainty's keypoints, the transport through the
warp, the snap) runs on a stand-in for RoMa's ``match``, computed the same
way in both packages: RoMa itself is held to the JAX package in
``test_torch_port_roma.py``, and the JAX package's jitted DaD program
(two full RoMa matches a pair) takes about a minute to compile on a CPU.
RoMaV2 runs the port's seed-0 ``fpn-corr`` tree, carried to the JAX
package's layout by ``params_to_jax`` and checked against the layout of
the JAX init (``jax.eval_shape``).

Tolerances, float32: the correspondences equal as sets (both points
within 1e-3 px; the keypoints are an exact top-k in the port and
``lax.approx_max_k`` in the JAX package, so slots are compared as sets),
scores within 1e-5; ``balanced_sample`` picks ``lax.top_k``'s indices
on scores full of ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.matchers import dad_roma as jdad
from imcui_tpu.models.matchers import roma as jroma
from imcui_tpu.models.matchers import romav2 as jromav2
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import roma as troma
from imcui_tpu_torch.models.matchers import romav2 as tromav2
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

KEY = jax.random.PRNGKey(0)
TINY = {"coarse_res": (112, 112), "max_keypoints": 64}


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


def _same_matches(got, want, least):
    """Valid correspondences of one pair as sets within 1e-3 px, scores
    within 1e-5."""
    def rows(out):
        m = np.asarray(out["mask"][0]).astype(bool)
        r = np.concatenate([np.asarray(out["keypoints0"][0])[m],
                            np.asarray(out["keypoints1"][0])[m]], 1)
        return r, np.asarray(out["scores"][0])[m]

    (rg, sg), (rw, sw) = rows(got), rows(want)
    assert len(rw) >= least and rg.shape == rw.shape
    iou, ig, iw = chip_smoke.common_points(rg, rw, 1e-3)
    assert iou == 1.0, iou
    assert np.abs(sg[ig] - sw[iw]).max() <= 1e-5


def _apis(name, ttree, jtree, mod, update):
    apis = []
    for ui in (jui, tui):
        conf = ui.parse_match_config({"matcher": name, "dense": True})
        conf["matcher"]["model"].update(update)
        conf["matcher"]["preprocessing"].update(width=160, height=120)
        if ui is jui:
            mp = pytest.MonkeyPatch()
            mp.setattr(mod, "load_params",
                       lambda c: (jtree, {"pretrained": False}))
            try:
                apis.append(JaxAPI(conf))
            finally:
                mp.undo()
        else:
            api = TorchAPI(conf, device="cpu")
            api.matcher.params = ttree
            apis.append(api)
    return apis


# --------------------------------------------------------------------------
# DaD-RoMa
# --------------------------------------------------------------------------

def _jax_warp(params, a, b, conf=None):
    """A stand-in for RoMa's ``match`` of (H, W, 3) views: a smooth warp
    and a textured certainty computed from both images the same way in
    each package (RoMa itself is held to the JAX package in
    ``test_torch_port_roma.py``; its jitted program at two matches a
    pair takes about a minute to compile on a CPU)."""
    h, w = a.shape[:2]
    g = jroma.coord_grid(h, w).reshape(h, w, 2)
    d = (a[..., 0] - b[..., 1])[..., None]
    return g + 0.02 * d, jax.nn.sigmoid(4.0 * (a[..., 0] - 0.5) + b[..., 2])


def _torch_warp(params, a, b, conf=None):
    h, w = a.shape[-2:]
    g = troma.coord_grid(h, w, a.device).reshape(h, w, 2)
    d = (a[0] - b[1])[..., None]
    return g + 0.02 * d, torch.sigmoid(4.0 * (a[0] - 0.5) + b[2])


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(jroma, "match", _jax_warp)
    monkeypatch.setattr(troma, "match", _torch_warp)


def test_stand_in_warps_agree():
    rng = np.random.default_rng(3)
    a, b = rng.uniform(size=(2, 40, 50, 3)).astype(np.float32)
    want = _jax_warp(None, jnp.asarray(a), jnp.asarray(b))
    got = _torch_warp(None, torch.from_numpy(a).permute(2, 0, 1),
                      torch.from_numpy(b).permute(2, 0, 1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_dad_roma_matches_jax(stand_in):
    """The ``DadRoma`` models on one 3-channel 96 x 128 pair: detection,
    transport through the warp, snap and confidence."""
    from imcui_tpu_torch.models.matchers import dad_roma as tdad

    conf = {**TINY, "max_keypoints": 48}
    tree = {"dinov2": {}}  # the full RoMa's route: RGB at coarse_res
    mp = pytest.MonkeyPatch()
    mp.setattr(jdad, "load_params", lambda c: (tree, {}))
    try:
        jm = jdad.DadRoma(conf)
    finally:
        mp.undo()
    tm = tdad.DadRoma(conf, device="cpu")
    tm.params = tree
    a, b, _ = chip_smoke.synthetic_pair(104, 128, 96)
    x0 = (a.transpose(2, 0, 1)[None] / 255.0).astype(np.float32)
    x1 = (b.transpose(2, 0, 1)[None] / 255.0).astype(np.float32)
    want = jm({"image0": x0, "image1": x1})
    got = tm({"image0": torch.from_numpy(x0), "image1": torch.from_numpy(x1)})
    _same_matches({k: v.numpy() for k, v in got.items()}, want, 40)
    scores = np.asarray(want["scores"][0])
    # both snapped (confidence whole) and unsnapped (halved) points
    assert (scores > 0.5).any() and (scores < 0.5).any()


def test_dad_roma_through_both_apis(stand_in):
    """The registry's ``dad_roma`` (forced to 160 x 120 here, coarse_res
    112²): the raw match sets agree."""
    tree = {"dinov2": {}}
    japi, tapi = _apis("dad_roma", tree, tree, jdad, TINY)
    a, b, _ = chip_smoke.synthetic_pair(105, 200, 150)
    want, got = japi(a, b), tapi(a, b)
    assert len(want["mkeypoints0_orig"]) >= 30
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0


# --------------------------------------------------------------------------
# RoMaV2
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fpn_trees():
    ttree = troma.init_params_fpn(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jroma.init_params_fpn(KEY), ttree)
    return ttree, jtree


def test_balanced_sample_keeps_the_lax_top_k_order():
    """A certainty with few distinct values: the same cells, in the same
    order, as the JAX function's ``lax.top_k``."""
    rng = np.random.default_rng(2)
    cert = (rng.integers(0, 4, (15, 20)) / 4.0).astype(np.float32)
    warp = rng.uniform(-1, 1, (15, 20, 2)).astype(np.float32)
    want = jromav2.balanced_sample(jnp.asarray(warp), jnp.asarray(cert),
                                   120, 160, num=100)
    got = tromav2.balanced_sample(torch.from_numpy(warp),
                                  torch.from_numpy(cert), 120, 160, num=100)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_romav2_matches_jax_through_both_apis(fpn_trees):
    """The registry's ``romav2`` (forced to 160 x 120 here): the raw match
    sets agree."""
    ttree, jtree = fpn_trees
    japi, tapi = _apis("romav2", ttree, jtree, jromav2,
                       {"max_keypoints": 128})
    a, b, _ = chip_smoke.synthetic_pair(106, 200, 150)
    want, got = japi(a, b), tapi(a, b)
    assert len(want["mkeypoints0_orig"]) >= 100
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0
