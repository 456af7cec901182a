"""Adaptive-depth LightGlue of the port against the JAX package's
``forward_pair_adaptive`` under ``vmap`` (mirroring
tests/test_lightglue_adaptive.py): each pair of a batch stops on its own,
keeps its own state and is read through the assignment head of its own
layer. fp32; stop_layer and matches0 equal, scores within 5e-4."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu_torch.models.matchers import lightglue as tlg
from imcui_tpu_torch.ops import attention as tattention
from imcui_tpu_torch.utils import weights as tweights

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
CONF = {"features": "superpoint", "descriptor_dim": 256, "num_heads": 4,
        "n_layers": 4, "add_scale_ori": False, "match_threshold": 0.1,
        "precision": "fp32", "depth_confidence": 0.95}
ATOL = 5e-4


def _params(seed=5, n_layers=4):
    jp = jlg.init_params(jax.random.PRNGKey(seed),
                         {**CONF, "n_layers": n_layers})
    return jp, tweights.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))


def _saturate(jp, head, bias=10.0):
    """Confidence after layer ``head`` ≈ sigmoid(bias) for every token."""
    tok = jp["token_confidence"][head]["token"]
    tok["w"] = tok["w"] * 0
    tok["b"] = tok["b"] * 0 + bias


def _inputs(seed, b, n0, n1):
    rng = np.random.default_rng(seed)
    mask0 = np.ones((b, n0), bool)
    mask1 = np.ones((b, n1), bool)
    mask1[-1, n1 // 2:] = False
    return (rng.uniform(0, 96, (b, n0, 2)).astype(np.float32),
            rng.uniform(0, 96, (b, n1, 2)).astype(np.float32),
            rng.normal(size=(b, n0, 256)).astype(np.float32),
            rng.normal(size=(b, n1, 256)).astype(np.float32),
            mask0, mask1,
            np.tile(np.array([[96.0, 80.0]], np.float32), (b, 1)),
            np.tile(np.array([[96.0, 80.0]], np.float32), (b, 1)))


def _jax_batched(jp, args, conf=CONF):
    fn = functools.partial(jlg.forward_pair_adaptive, conf=conf)
    return jax.vmap(lambda *a: fn(jp, *a))(*(jnp.asarray(a) for a in args))


def _agree(got, want):
    np.testing.assert_array_equal(got["stop_layer"].numpy(),
                                  np.asarray(want["stop_layer"]))
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(got["matching_scores0"].numpy(),
                               np.asarray(want["matching_scores0"]),
                               atol=ATOL)


def test_exit_after_second_layer_reads_second_head():
    """Head 0 never fires (bias -10) and head 1 always does: every pair
    runs two layers and is read through log_assignment[1]."""
    jp, _ = _params()
    _saturate(jp, 0, bias=-10.0)
    _saturate(jp, 1)
    tp = tweights.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    args = _inputs(0, 3, 24, 20)
    want = _jax_batched(jp, args)
    got = tlg.forward_pair_adaptive(tp, *args, match_threshold=0.1,
                                    depth_confidence=0.95, device="cpu")
    assert np.asarray(want["stop_layer"]).tolist() == [2, 2, 2]
    _agree(got, want)


def test_per_pair_exit_with_trained_heads():
    """The trained network (weights/lightglue_selftrained.npz, 9 layers)
    on a batch holding an easy pair (a permutation of the same keypoints
    and descriptors), a noisy pair and a pair of unrelated features: the
    pairs leave at different layers, and each is read through its own
    layer's head."""
    tree = tweights.load_tree_npz(WEIGHTS / "lightglue_selftrained.npz")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tweights.params_from_jax(tree)
    rng = np.random.default_rng(7)
    b, n = 3, 128
    kpts0 = rng.uniform(8, 300, (b, n, 2)).astype(np.float32)
    desc0 = rng.normal(size=(b, n, 256)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    perm = rng.permutation(n)
    kpts1 = kpts0[:, perm].copy()
    desc1 = desc0[:, perm].copy()
    kpts1[1] += rng.normal(size=(n, 2)).astype(np.float32) * 2
    desc1[1] += 0.08 * rng.normal(size=(n, 256)).astype(np.float32)
    kpts1[2] = rng.uniform(8, 300, (n, 2))
    desc1[2] = rng.normal(size=(n, 256))
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    mask = np.ones((b, n), bool)
    size = np.tile(np.array([[320.0, 320.0]], np.float32), (b, 1))
    args = (kpts0, kpts1, desc0, desc1, mask, mask, size, size)
    conf = {**CONF, "n_layers": 9}
    want = _jax_batched(jp, args, conf)
    got = tlg.forward_pair_adaptive(tp, *args, match_threshold=0.1,
                                    depth_confidence=0.95, device="cpu")
    stops = np.asarray(want["stop_layer"]).tolist()
    print("stop layers of the batch:", stops)
    assert len(set(stops)) > 1, stops
    _agree(got, want)
    # each pair alone gives what it gave in the batch
    for i in range(b):
        one = tlg.forward_pair_adaptive(
            tp, *(a[i:i + 1] for a in args), match_threshold=0.1,
            depth_confidence=0.95, device="cpu")
        assert one["stop_layer"].tolist() == [stops[i]]
        np.testing.assert_array_equal(one["matches0"][0].numpy(),
                                      got["matches0"][i].numpy())


def test_full_depth_matches_static():
    """Random-init confidence heads never saturate: the adaptive loop runs
    every layer and reproduces the static forward."""
    jp, tp = _params()
    args = _inputs(1, 2, 12, 10)
    want = _jax_batched(jp, args)
    got = tlg.forward_pair_adaptive(tp, *args, match_threshold=0.1,
                                    device="cpu")
    assert got["stop_layer"].tolist() == [4, 4]
    _agree(got, want)
    static = tlg.forward_pair(tp, *args, match_threshold=0.1, device="cpu")
    assert torch.equal(static["matches0"], got["matches0"])
    torch.testing.assert_close(static["matching_scores0"],
                               got["matching_scores0"], atol=1e-6, rtol=0)


def test_saturated_head_exits_through_its_own_assignment_head():
    jp, _ = _params()
    _saturate(jp, 0)
    tp = tweights.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    args = _inputs(2, 2, 12, 10)
    got = tlg.forward_pair_adaptive(tp, *args, match_threshold=0.1,
                                    device="cpu")
    assert got["stop_layer"].tolist() == [1, 1]
    _agree(got, _jax_batched(jp, args))
    one = {**tp, "transformers": tp["transformers"][:1],
           "log_assignment": tp["log_assignment"][:1], "token_confidence": []}
    want = tlg.forward_pair(one, *args, match_threshold=0.1, device="cpu")
    assert torch.equal(want["matches0"], got["matches0"])


def test_last_layer_never_exits_early_and_zero_confidence_is_static():
    """``done`` can only fire before the last layer; depth_confidence 0
    routes to the static path (no stop_layer)."""
    jp, _ = _params(n_layers=2)
    _saturate(jp, 0, bias=-10.0)  # never confident after layer 0
    tp = tweights.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    args = _inputs(3, 1, 12, 10)
    got = tlg.forward_pair_adaptive(tp, *args, match_threshold=0.1,
                                    device="cpu")
    assert got["stop_layer"].tolist() == [2]
    _agree(got, _jax_batched(jp, args, {**CONF, "n_layers": 2}))
    out = tlg.forward_pair_adaptive(tp, *args, depth_confidence=0,
                                    device="cpu")
    assert "stop_layer" not in out


def test_empty_views_count_one_point():
    """npts = max(Σmask0 + Σmask1, 1): a pair without keypoints is
    'confident' at once and exits after layer 1."""
    jp, tp = _params()
    args = list(_inputs(4, 2, 12, 10))
    args[4] = args[4].copy()
    args[5] = args[5].copy()
    args[4][0] = False
    args[5][0] = False
    want = _jax_batched(jp, args)
    got = tlg.forward_pair_adaptive(tp, *args, match_threshold=0.1,
                                    device="cpu")
    assert got["stop_layer"].tolist() == [1, 4]
    _agree(got, want)


@pytest.mark.parametrize("n", [2304])
def test_self_block_routes_by_key_count(n, monkeypatch):
    """Above 2048 key slots self-attention takes the blockwise kernel's
    wrapper, as the JAX self_block does; the block's output agrees with
    the JAX one to 1e-4 (f32, sums in another order over 2304 keys)."""
    jp, tp = _params(n_layers=1)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, 256)).astype(np.float32)
    kpts = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    from imcui_tpu.ops import attention as jattention

    enc_j = jattention.learnable_fourier_encoding(
        jnp.asarray(kpts), jp["posenc"]["Wr"]["w"])
    want = jlg.self_block(jp["transformers"][0]["self_attn"], jnp.asarray(x),
                          enc_j, jnp.asarray(mask), 4)
    calls = []
    flash = tattention.flash_attention
    monkeypatch.setattr(
        tlg, "flash_attention",
        lambda *a: calls.append("flash") or flash(*a))
    monkeypatch.setattr(
        tlg, "fused_attention",
        lambda *a: calls.append("fused") or tattention.fused_attention(*a))
    enc_t = tattention.learnable_fourier_encoding(
        torch.from_numpy(kpts)[None], tp["posenc"]["Wr"]["w"])
    got = tlg.self_block(tp["transformers"][0]["self_attn"],
                         torch.from_numpy(x)[None], enc_t,
                         torch.from_numpy(mask)[None], 4)
    assert calls == ["flash"]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-4)
    tlg.self_block(tp["transformers"][0]["self_attn"],
                   torch.from_numpy(x[:2048])[None],
                   tuple(e[:, :2048] for e in enc_t),
                   torch.from_numpy(mask[:2048])[None], 4)
    assert calls == ["flash", "fused"]
