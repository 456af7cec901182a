"""LISRD: the port against the JAX package on the CPU, part by part and
end to end through both ``ImageMatchingAPI``s with each of its three
detectors.

LISRD runs the port's seed-0 tree, carried to the JAX package's layout by
``params_to_jax`` and checked against the layout of the JAX init
(``jax.eval_shape``); its ALIKED detector runs the port's seed-0 ALIKED
tree the same way, its SuperPoint the trained
``weights/superpoint_adapted.npz``.

Tolerances: descriptors and meta-descriptors within 1e-5 of the largest,
the matches equal on the same keypoints; end to end the raw match set at
IoU 1.0 within 1e-3 px for each detector, with scores within 1e-5
(SuperPoint in float32 there); the packaged entry at its bf16 SuperPoint,
whose keypoints can differ (ROADMAP, "bf16 SuperPoint"), at IoU >= 0.9
within 0.5 px (measured 1.0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.extractors import aliked as jaliked
from imcui_tpu.models.matchers import lisrd as jlisrd
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import lisrd as tlisrd
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


@pytest.fixture(scope="module")
def lisrd_trees():
    ttree = tlisrd.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jlisrd.init_params(KEY), ttree)
    return jtree, weights.params_from_jax(jtree)


def test_lisrd_describe_and_match_match_jax(lisrd_trees):
    """``_describe`` on a 2-image batch at the same keypoints, then
    ``lisrd_match`` with padded slots."""
    jtree, ttree = lisrd_trees
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 3, 96, 128)).astype(np.float32)
    kp = np.stack([rng.uniform(0, 127, (2, 80)),
                   rng.uniform(0, 95, (2, 80))], -1).astype(np.float32)
    want_d, want_m = jlisrd._describe(jtree, jnp.asarray(imgs),
                                      jnp.asarray(kp))
    got_d, got_m = tlisrd._describe(ttree, torch.from_numpy(imgs),
                                    torch.from_numpy(kp))
    assert got_d.shape == (2, 80, 4, 128)
    assert _rel(got_d, want_d) <= 1e-5 and _rel(got_m, want_m) <= 1e-5
    m0 = np.ones(80, bool)
    m0[70:] = False
    m1 = np.ones(80, bool)
    m1[:5] = False
    # view 1 describes view 0's points, shuffled: many mutual matches
    perm = rng.permutation(80)
    d1, mt1 = np.asarray(want_d[0])[perm], np.asarray(want_m[0])[perm]
    d1 = d1 + rng.normal(size=d1.shape).astype(np.float32) * 0.02
    want = jlisrd.lisrd_match(want_d[0], jnp.asarray(d1), want_m[0],
                              jnp.asarray(mt1), jnp.asarray(m0),
                              jnp.asarray(m1))
    got = tlisrd.lisrd_match(got_d[0], torch.from_numpy(d1), got_m[0],
                             torch.from_numpy(mt1), torch.from_numpy(m0),
                             torch.from_numpy(m1))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _rel(got[1], want[1]) <= 1e-5
    assert (np.asarray(want[0]) > -1).sum() >= 50


def _lisrd_apis(key, lisrd_trees, yaml_pkg):
    """Both packages' API on the zoo entry ``key``, with the port's LISRD
    tree (and seed-0 ALIKED tree) in both."""
    from pathlib import Path

    jtree, ttree = lisrd_trees
    apis = []
    for ui, pkg in ((jui, "imcui_tpu"), (tui, "imcui_tpu_torch")):
        path = Path(__file__).resolve().parents[1] / (
            pkg + "/config/app.yaml" if yaml_pkg else "config/app.yaml")
        conf = ui.get_matcher_zoo(ui.load_config(path)["matcher_zoo"])[key]
        pre = conf["matcher"]["preprocessing"]
        pre.update(width=160, height=120, resize_max=160)
        if ui is jui:
            mp = pytest.MonkeyPatch()
            mp.setattr(jlisrd, "load_params",
                       lambda c: (jtree, {"pretrained": False}))
            mp.setattr(jaliked, "load_params",
                       lambda c: (None, {"pretrained": False}))
            try:
                apis.append(JaxAPI(conf))
            finally:
                mp.undo()
        else:
            api = TorchAPI(conf, device="cpu")
            api.matcher.params = ttree
            apis.append(api)
    det = conf["matcher"]["model"]["detector"]
    if det == "aliked":
        tdet = apis[1].matcher.detector
        apis[0].matcher.detector.params = _carried(
            lambda: jaliked.init_params(KEY, **jaliked.SIZES["aliked-n16"]),
            tdet.params)
    return apis, det


@pytest.mark.parametrize("key", ["LISRD+SuperPoint", "LISRD+ALIKED",
                                 "LISRD+SIFT"])
def test_lisrd_entries_through_both_apis(lisrd_trees, key):
    """The root ``config/app.yaml``'s entries (forced to 160 x 120 here),
    SuperPoint in float32: the raw match set at IoU 1.0 within 1e-3 px."""
    (japi, tapi), det = _lisrd_apis(key, lisrd_trees, yaml_pkg=False)
    if det == "superpoint":
        for api in (japi, tapi):
            api.matcher.detector.conf["precision"] = "fp32"
    a, b, _ = chip_smoke.synthetic_pair(103, 200, 150)
    want, got = japi(a, b), tapi(a, b)
    assert len(want["mkeypoints0_orig"]) >= 20
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0
    np.testing.assert_allclose(np.sort(got["mconf"]), np.sort(want["mconf"]),
                               atol=1e-5)


def test_packaged_lisrd_at_its_bf16_superpoint(lisrd_trees):
    """The packaged ``lisrd`` (bf16 SuperPoint at 0.005): raw matches at
    IoU >= 0.9 within 0.5 px (measured 1.0)."""
    (japi, tapi), det = _lisrd_apis("lisrd", lisrd_trees, yaml_pkg=True)
    assert det == "superpoint"
    assert tapi.matcher.detector.conf["precision"] == "bf16"
    a, b, _ = chip_smoke.synthetic_pair(103, 200, 150)
    want, got = japi(a, b), tapi(a, b)
    assert len(want["mkeypoints0_orig"]) >= 20
    iou = chip_smoke.raw_match_iou(got, want)
    assert iou >= 0.9, iou
