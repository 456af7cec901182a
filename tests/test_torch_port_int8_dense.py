"""W8A8 (``precision="int8"``) RoMa in the port against the JAX package
on the CPU, end to end, and the thresholds at which its quantised dicts
meet a function that reads ``w`` (``test_torch_port_int8.py`` has the
layers and the pointmap models, ``test_torch_port_int8_dkm.py`` DKM).

RoMa runs at its tests' tiny configuration (DINOv2 "test", 64 wide, so
its blocks stay bf16; gp_dim 512, so the decoder's 1024-wide linears are
quantised) at ``int8_conv_min_ch`` 64, which also quantises the VGG
trunk's, the projections' and the refiners' convolutions from 64
channels up, on the port's seed-0 tree with seeded biases, statistics
and gammas, quantised by each package's own ``apply_precision``.

Tolerances. The int8 layers equal the JAX package's given equal inputs
(to XLA's two CPU rewrites, ``test_torch_port_int8.py``); the bf16
layers between them round at other places in the two frameworks, and a
re-quantisation turns such a last-bit difference into a whole step
where it crosses a rounding edge. RoMa's random anchor decoder turns
that into another anchor for a cell (the bf16 precedent,
``test_torch_port_roma.py``: max |Δwarp| 0.44 at a median of 0.042): the
int8 warp within a median |Δwarp| of 0.35 against JAX (measured 0.153;
the port's own int8 and bf16 runs are 0.110 apart), certainties within a
mean |Δ| of 0.03 (measured 0.0115; int8 to bf16 in the port 0.0108).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imcui_tpu.models import layers as jl
from imcui_tpu.models.matchers import roma as jr
from imcui_tpu_torch.models import layers as tl
from imcui_tpu_torch.models.matchers import roma as tr
from imcui_tpu_torch.utils import weights

TINY = {"dinov2_variant": "test", "gp_dim": 512}
RES = 112

ROMA_CONV = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread (the tier-1 run's six workers share eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(2, 0, 1)


def _quantised(tree):
    return {k[:-4] for k in weights.flatten_tree(tree) if k.endswith(".w_q")}


@pytest.fixture(scope="module")
def roma_trees():
    """The port's seed-0 tiny tree with its zero biases, unit BN
    statistics and 1e-5 LayerScale gammas replaced by seeded values (as
    ``test_torch_port_roma.tiny_tree`` does to the JAX init, whose random
    draw runs op by op), carried to the JAX layout and checked against
    ``jax.eval_shape`` of the JAX init."""
    rng = np.random.default_rng(0)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name in ("gamma", "var"):
            return torch.from_numpy(rng.uniform(0.5, 1.5, tuple(node.shape))
                                    .astype(np.float32))
        if name in ("b", "bias", "mean"):
            return torch.from_numpy((rng.normal(size=tuple(node.shape))
                                     * 0.05).astype(np.float32))
        return node

    tp = walk(tr.init_params(torch.Generator().manual_seed(0), TINY))
    jtree = weights.params_to_jax(tp)
    shapes = jax.eval_shape(lambda: jr.init_params(jax.random.PRNGKey(0),
                                                   TINY))
    assert {k: v.shape for k, v in weights.flatten_tree(jtree).items()} == \
        {k: tuple(v.shape) for k, v in weights.flatten_tree(shapes).items()}
    return jax.tree_util.tree_map(jnp.asarray, jtree), tp


@pytest.fixture(scope="module")
def roma_images():
    rng = np.random.default_rng(1)
    return (rng.uniform(size=(RES, RES, 3)).astype(np.float32),
            rng.uniform(size=(RES, RES, 3)).astype(np.float32))


def _roma_inputs(images):
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in images],
            [_chw(a).bfloat16() for a in images])


def test_roma_int8_tree_quantises_the_decoder_and_the_wide_convolutions(
        roma_trees):
    _, tp = roma_trees
    q = _quantised(tl.apply_precision(tp, "int8", conv_min_ch=ROMA_CONV))
    assert "embedding_decoder.blocks.0.mlp.fc1" in q
    assert "embedding_decoder.to_out" in q
    assert "proj.16.0" in q and "conv_refiner.4.block1.3" in q
    assert "encoder_cnn.layers.2" in q          # VGG's 64 -> 64
    assert "encoder_cnn.layers.0" not in q      # 3 -> 64
    assert not any(k.startswith("dinov2.") for k in q)   # 64 wide, bf16
    assert "conv_refiner.1.block1.0" not in q   # 24 wide
    assert len(q) == 72


def test_roma_int8_match_matches_jax(roma_trees, roma_images):
    jp, tp = roma_trees
    jq = jl.apply_precision(jp, "int8", conv_min_ch=ROMA_CONV)
    tq = tl.apply_precision(tp, "int8", conv_min_ch=ROMA_CONV)
    (j0, j1), (t0, t1) = _roma_inputs(roma_images)
    jw, jc = jax.jit(lambda p, a, b: jr.match_gp(p, a, b, TINY))(jq, j0, j1)
    with torch.no_grad():
        tw, tc = tr.match_gp(tq, t0, t1, TINY)
        bw, _ = tr.match_gp(tl.apply_precision(tp, "bf16"), t0, t1, TINY)
    assert tw.dtype == tc.dtype == torch.float32
    assert tw.shape == (RES, RES, 2) and np.isfinite(tw.numpy()).all()
    assert np.median(np.abs(tw.numpy() - np.asarray(jw))) <= 0.35
    assert np.abs(tc.numpy() - np.asarray(jc)).mean() <= 0.03
    # quantisation moved the result: it is not the bf16 run
    assert np.median(np.abs(tw.numpy() - bw.numpy())) > 0.05


def test_roma_thresholds_that_quantise_a_dict_read_as_w(roma_trees):
    """At 24 the stride-1 refiner's 24-wide convolutions are quantised:
    the JAX package folds them 2 x 2 (``fold2x2_conv5x5`` reads ``w``) and
    raises KeyError, the port has no fold and serves (a deviation). At 2
    ``pos_conv`` is quantised and ``fourier_embed`` raises KeyError in
    both."""
    jp, tp = roma_trees
    jq = jl.apply_precision(jp, "int8", conv_min_ch=24)
    tq = tl.apply_precision(tp, "int8", conv_min_ch=24)
    assert "conv_refiner.1.block1.0" in _quantised(tq)
    assert "gps.16.pos_conv" not in _quantised(tq)
    rng = np.random.default_rng(2)
    h = w = 16
    f0, f1 = (rng.normal(size=(h, w, 9)).astype(np.float32)
              for _ in range(2))
    warp = rng.uniform(-1, 1, (h, w, 2)).astype(np.float32)
    cert = rng.normal(size=(h, w)).astype(np.float32)
    cfg = tr.REFINERS["1"]
    with pytest.raises(KeyError, match="'w'"):
        jr.refiner_apply(jq["conv_refiner"]["1"], cfg, *(
            jnp.asarray(a) for a in (f0, f1, warp, cert)))
    with torch.no_grad():
        tw, tc = tr.refiner_apply(tq["conv_refiner"]["1"], cfg, _chw(f0),
                                  _chw(f1), torch.from_numpy(warp),
                                  torch.from_numpy(cert))
    assert np.isfinite(tw.numpy()).all() and np.isfinite(tc.numpy()).all()
    jq = jl.apply_precision(jp, "int8", conv_min_ch=2)
    tq = tl.apply_precision(tp, "int8", conv_min_ch=2)
    coords = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    with pytest.raises(KeyError, match="'w'"):
        jr.fourier_embed(jnp.asarray(coords), jq["gps"]["16"]["pos_conv"])
    with pytest.raises(KeyError, match="'w'"):
        tr.fourier_embed(torch.from_numpy(coords),
                         tq["gps"]["16"]["pos_conv"])
