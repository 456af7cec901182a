"""SOLD2, the line detector and matcher: the port against the JAX package
on the CPU, part by part and end to end through both
``ImageMatchingAPI``s.

SOLD2 runs the port's seed-0 tree with non-trivial BN statistics and
biases drawn from a numpy seed (so that no layer is the identity),
carried to the JAX package's layout by ``params_to_jax`` and checked
against the layout of the JAX init (``jax.eval_shape``).

Tolerances: the hourglass, the heads and the descriptors within 1e-5 of
the largest value; lines and line matches equal as unoriented sets
(within 1e-3 px: the junctions are an exact top-k in the port and
``lax.approx_max_k`` in the JAX package, so their slots, and each
segment's endpoint order, can differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.matchers import sold2 as jsold2
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import sold2 as tsold2
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


def _same_segment_set(a, b, tol):
    a, b = chip_smoke.segment_rows(a), chip_smoke.segment_rows(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not len(a):
        return
    d = np.abs(a[:, None] - b[None]).max(-1)
    assert d.min(1).max() <= tol and d.min(0).max() <= tol


# --------------------------------------------------------------------------
# SOLD2
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sold2_trees():
    ttree = tsold2.init_params(torch.Generator().manual_seed(0))
    # non-trivial BN statistics, so that no layer is the identity
    rng = np.random.default_rng(0)
    jtree = _carried(lambda: jsold2.init_params(KEY), ttree)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name == "var":
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if name in ("mean", "b", "bias"):
            return (rng.normal(size=node.shape) * 0.05).astype(np.float32)
        return node

    jtree = walk(jtree)
    return jtree, weights.params_from_jax(jtree)


def _grey(seed, w=128, h=128):
    img = chip_smoke.textured_image(np.random.default_rng(seed), h, w)
    return (img / 255.0).astype(np.float32)


def test_sold2_hourglass_and_heads_match_jax(sold2_trees):
    jtree, ttree = sold2_trees
    x = np.stack([_grey(1), _grey(2)])
    net_j = jax.jit(jsold2.hourglass_net)(jtree["backbone_net"]["net"],
                                          jnp.asarray(x[..., None]))
    net_t = tsold2.hourglass_net(ttree["backbone_net"]["net"],
                                 torch.from_numpy(x[:, None]))
    assert _rel(net_t.permute(0, 2, 3, 1), net_j) <= 1e-5
    want = jax.jit(jsold2.backbone)(jtree, jnp.asarray(x[..., None]))
    got = tsold2.backbone(ttree, torch.from_numpy(x[:, None]))
    assert _rel(got[0], want[0]) <= 1e-5
    assert _rel(got[1], want[1]) <= 1e-5
    assert _rel(got[2].permute(0, 2, 3, 1), want[2]) <= 1e-5


def test_sold2_detection_and_matching_match_jax(sold2_trees):
    """``apply_pair`` on a 128 x 128 pair whose second view is valid on
    120 x 112 only: lines and matches as unoriented sets."""
    jtree, ttree = sold2_trees
    a, b = _grey(3), _grey(3)
    b[112:] = 0.0
    b[:, 120:] = 0.0
    vwh = [np.array([128, 128], np.int32), np.array([120, 112], np.int32)]
    want = jsold2.apply_pair(jtree, jnp.asarray(a[..., None]),
                             jnp.asarray(b[..., None]), *map(jnp.asarray,
                                                             vwh),
                             detect_thresh=0.25, valid_thresh=1e-3)
    got = tsold2.apply_pair(ttree, torch.from_numpy(a[None]),
                            torch.from_numpy(b[None]),
                            *map(torch.from_numpy, vwh))
    wl0, wl1, wv0, wv1, wm, _ = map(np.asarray, want)
    gl0, gl1, gv0, gv1, gm, _ = (t.numpy() for t in got)
    _same_segment_set(gl0[gv0], wl0[wv0], 1e-3)
    _same_segment_set(gl1[gv1], wl1[wv1], 1e-3)
    assert wv0.sum() >= 5

    def matched(l0, l1, m):
        ok = m > -1
        return np.concatenate([chip_smoke.segment_rows(l0[ok]),
                               chip_smoke.segment_rows(l1[m[ok]])], 1)

    pw, pg = matched(wl0, wl1, wm), matched(gl0, gl1, gm)
    assert pw.shape == pg.shape and len(pw) >= 3
    d = np.abs(pw[:, None] - pg[None]).max(-1)
    assert d.min(1).max() <= 1e-3 and d.min(0).max() <= 1e-3


def test_sold2_through_both_apis(sold2_trees):
    """The registry's ``sold2`` (640 x 480 forced), the same tree, on a
    small planted pair: raw and matched lines as unoriented sets."""
    jtree, ttree = sold2_trees
    a, b, _ = chip_smoke.synthetic_pair(102, 200, 150)
    runs = []
    for ui, build, tree in (
            (jui, lambda c: JaxAPI(c), jtree),
            (tui, lambda c: TorchAPI(c, device="cpu"), ttree)):
        conf = ui.parse_match_config({"matcher": "sold2", "dense": True})
        conf["matcher"]["preprocessing"].update(width=128, height=128)
        if ui is jui:
            mp = pytest.MonkeyPatch()
            mp.setattr(jsold2, "load_params",
                       lambda c: (tree, {"pretrained": False}))
            try:
                api = build(conf)
            finally:
                mp.undo()
        else:
            api = build(conf)
            api.matcher.params = tree
        runs.append(api(a, b))
    want, got = runs
    for k in ("raw_lines0", "raw_lines1", "lines0", "lines1"):
        _same_segment_set(got[k], want[k], 1e-3)
    assert len(want["raw_lines0"]) >= 5
    assert len(want["lines0_orig"]) == len(got["lines0_orig"])
