"""The GlueStick GNN (``use_gnn=True``): the port against the JAX package
on the CPU, the function on the same junction tokens and the model end to
end through both ``ImageMatchingAPI``s.

No GlueStick checkpoint is in the repository: both packages run the
port's seed-0 GNN tree, carried to the JAX package's layout by
``params_to_jax`` and checked against the layout of the JAX init
(``jax.eval_shape``).

Tolerances, float32: the point and line log assignments within 1e-4 of
the largest, the matches at threshold 1e-6 equal; end to end (float32
SuperPoint, 96 keypoints, 24 lines) the same point matches within 1e-3
px and the same matched segments as sets within 1e-4 px.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.matchers import gluestick as jgs
from imcui_tpu.ops import sinkhorn as jsinkhorn
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import gluestick as tgs
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights

KEY = jax.random.PRNGKey(0)
ROOT = Path(__file__).resolve().parents[1]


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


def _same_segment_set(a, b, tol):
    a, b = chip_smoke.segment_rows(a), chip_smoke.segment_rows(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not len(a):
        return
    d = np.abs(a[:, None] - b[None]).max(-1)
    assert d.min(1).max() <= tol and d.min(0).max() <= tol


@pytest.fixture(scope="module")
def gnn_trees():
    ttree = tgs.init_gnn_params(torch.Generator().manual_seed(0))
    return _carried(lambda: jgs.init_gnn_params(KEY), ttree), ttree


def _gnn_inputs(seed, n=24, lines=6):
    rng = np.random.default_rng(seed)
    t = n + 2 * lines
    size = np.array([160.0, 120.0], np.float32)

    def view():
        ln = rng.uniform(0, 120, (lines, 2, 2)).astype(np.float32)
        kp = rng.uniform(0, 120, (n, 2)).astype(np.float32)
        junc = np.concatenate([kp, ln.reshape(-1, 2)])
        desc = rng.normal(size=(t, 256)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        mk = np.ones(t, bool)
        mk[n - 3:n] = False
        ml = np.ones(lines, bool)
        ml[-1] = False
        mk[-2:] = False
        return [junc, desc, rng.uniform(0, 1, t).astype(np.float32), ln,
                rng.uniform(0, 1, lines).astype(np.float32),
                (n + np.arange(2 * lines)).astype(np.int32), mk, ml]

    return view() + view() + [size, size]


def test_gnn_forward_matches_jax(gnn_trees):
    """Point and line log assignments within 1e-4 of the largest, and the
    same matches at threshold 1e-6."""
    jtree, ttree = gnn_trees
    args = _gnn_inputs(0)
    conf = {"match_threshold": 1e-6, "sinkhorn_iterations": 20}
    seen = []
    real = jsinkhorn.matches_from_assignment

    def keep(z, *a, **k):
        seen.append(z)
        return real(z, *a, **k)

    @jax.jit
    def run(params, *xs):
        seen.clear()
        out = jgs.gnn_forward(params, *xs, conf)
        return out, tuple(seen)

    mp = pytest.MonkeyPatch()
    mp.setattr(jsinkhorn, "matches_from_assignment", keep)
    try:
        want, (z, zl) = run(jtree, *map(jnp.asarray, args))
    finally:
        mp.undo()
    got = tgs.gnn_forward(ttree, *map(torch.from_numpy, args), conf,
                          with_assignments=True)
    assert _rel(got[4], z) <= 1e-4
    assert _rel(got[5], zl) <= 1e-4
    for g, w in zip(got[:4:2], want[::2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) > -1).sum() >= 3
    assert (np.asarray(want[2]) > -1).sum() >= 1




def test_gluestick_gnn_through_both_apis(gluestick_apis, planted):
    """``use_gnn=True`` on the seed-0 GNN, float32 SuperPoint, threshold
    1e-6, fewer keypoints and lines: the same point and line matches."""
    saved = []
    for api in gluestick_apis:
        m = api.matcher
        saved.append((m.use_gnn, dict(m.conf)))
        m.use_gnn = True
        m.conf.update(max_lines=24, match_threshold=1e-6)
        m.sp.conf.update(max_keypoints=96, precision="fp32")
        if hasattr(m, "_gnn_conf_key"):
            m._gnn_conf_key = tuple(sorted({
                "match_threshold": 1e-6, "sinkhorn_iterations": 20}.items()))
    try:
        want, got = (api(planted[0], planted[1]) for api in gluestick_apis)
    finally:
        for api, (use, conf) in zip(gluestick_apis, saved):
            api.matcher.use_gnn = use
            api.matcher.conf.clear()
            api.matcher.conf.update(conf)
            api.matcher.sp.conf.update(max_keypoints=conf["max_keypoints"],
                                       precision="bf16")
    assert len(want["mkeypoints0_orig"]) >= 10
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0
    _same_segment_set(got["lines0"][0], want["lines0"][0], 1e-4)
    _same_segment_set(got["lines1"][0], want["lines1"][0], 1e-4)


def _zoo(ui, pkg):
    return ui.get_matcher_zoo(ui.load_config(
        ROOT / pkg / "config" / "app.yaml")["matcher_zoo"])["gluestick"]


@pytest.fixture(scope="module")
def gluestick_apis(gnn_trees):
    jtree = gnn_trees[0]
    mp = pytest.MonkeyPatch()
    mp.setattr(jgs, "init_gnn_params", lambda key: jtree)
    try:
        japi = JaxAPI(_zoo(jui, "imcui_tpu"))
    finally:
        mp.undo()
    return japi, TorchAPI(_zoo(tui, "imcui_tpu_torch"), device="cpu")


@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(100, 320, 240)


def test_gluestick_gnn_through_both_apis(gluestick_apis, planted):
    """``use_gnn=True`` on the seed-0 GNN, float32 SuperPoint, threshold
    1e-6, fewer keypoints and lines: the same point and line matches."""
    saved = []
    for api in gluestick_apis:
        m = api.matcher
        saved.append((m.use_gnn, dict(m.conf)))
        m.use_gnn = True
        m.conf.update(max_lines=24, match_threshold=1e-6)
        m.sp.conf.update(max_keypoints=96, precision="fp32")
        if hasattr(m, "_gnn_conf_key"):
            m._gnn_conf_key = tuple(sorted({
                "match_threshold": 1e-6, "sinkhorn_iterations": 20}.items()))
    try:
        want, got = (api(planted[0], planted[1]) for api in gluestick_apis)
    finally:
        for api, (use, conf) in zip(gluestick_apis, saved):
            api.matcher.use_gnn = use
            api.matcher.conf.clear()
            api.matcher.conf.update(conf)
            api.matcher.sp.conf.update(max_keypoints=conf["max_keypoints"],
                                       precision="bf16")
    assert len(want["mkeypoints0_orig"]) >= 10
    assert chip_smoke.raw_match_iou(got, want, tol=1e-3) == 1.0
    _same_segment_set(got["lines0"][0], want["lines0"][0], 1e-4)
    _same_segment_set(got["lines1"][0], want["lines1"][0], 1e-4)
