"""W8A8 (``precision="int8"``) DKM in the port against the JAX package on
the CPU, end to end (``test_torch_port_int8.py`` has the layers).

DKM has no linear, so only ``int8_conv_min_ch`` quantises anything: at
256, the ResNet-50 trunk's, the projections' and the DFN's convolutions
whose cin and cout reach 256, on the port's seed-0 tree quantised by each
package's own ``apply_precision``, at a 64 x 64 canvas. Tolerances: the
int8 layers equal the JAX package's given equal inputs (to XLA's two CPU
rewrites); the bf16 layers between them round at other places, and a
re-quantisation turns that into whole steps where it crosses a rounding
edge. The warp within a median |Δwarp| of a tenth of the median |warp|
(measured 0.024 of it), the certainty within 0.1 (measured 0.055).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.models import layers as jl
from imcui_tpu.models.matchers import dkm as jdkm
from imcui_tpu_torch.models import layers as tl
from imcui_tpu_torch.models.matchers import dkm as tdkm
from imcui_tpu_torch.utils import weights

DKM_CONV = 256


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
def dkm_trees():
    ttree = tdkm.init_params(torch.Generator().manual_seed(0))
    jtree = jax.tree_util.tree_map(jnp.asarray, weights.params_to_jax(ttree))
    return jtree, ttree


def test_dkm_int8_match_matches_jax(dkm_trees):
    jtree, ttree = dkm_trees
    assert not _quantised(tl.apply_precision(ttree, "int8"))  # no linear
    jq = jl.apply_precision(jtree, "int8", conv_min_ch=DKM_CONV)
    tq = tl.apply_precision(ttree, "int8", conv_min_ch=DKM_CONV)
    q = _quantised(tq)
    assert "encoder.layer3.0.conv2" in q and "proj.32.0" in q
    assert "embedding_decoder.rrb_d.16.conv1" in q
    assert "encoder.layer1.0.conv1" not in q   # 64 wide
    assert len(q) == 77
    planted = chip_smoke.synthetic_pair(101, 64, 64)
    x0, x1 = ((planted[i] / 255.0).astype(np.float32) for i in (0, 1))
    jw, jc = jax.jit(jdkm.match)(jq, jnp.asarray(x0).astype(jnp.bfloat16),
                                 jnp.asarray(x1).astype(jnp.bfloat16))
    with torch.no_grad():
        tw, tc = tdkm.match(tq, _chw(x0).bfloat16(), _chw(x1).bfloat16())
    jw, jc = np.asarray(jw), np.asarray(jc)
    assert tw.shape == jw.shape == (64, 64, 2)
    assert np.isfinite(tw.numpy()).all()
    assert np.median(np.abs(tw.numpy() - jw)) <= 0.1 * np.median(np.abs(jw))
    assert np.abs(tc.numpy() - jc).max() <= 0.1
