"""Weight bridge of the PyTorch port (imcui_tpu_torch/utils/weights.py)
against the JAX package's checkpoint reader. Exact: no arithmetic."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from imcui_tpu.models.extractors import superpoint as jsp
from imcui_tpu.models.matchers import lightglue as jlg
from imcui_tpu.pipeline import two_view as jtv
from imcui_tpu.utils import weights as jweights
from imcui_tpu_torch.pipeline import two_view as ttv
from imcui_tpu_torch.utils import weights as tweights

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
LG_CONF = {"features": "superpoint", "descriptor_dim": 256, "num_heads": 4,
           "n_layers": 9, "add_scale_ori": False}


def _jax_init(name):
    if name == "superpoint_adapted.npz":
        return jsp.init_params(jax.random.PRNGKey(0))
    return jlg.init_params(jax.random.PRNGKey(0), LG_CONF)


@pytest.mark.parametrize("name", ["superpoint_adapted.npz",
                                  "lightglue_selftrained.npz"])
def test_npz_leaves_equal_jax_reader(name):
    want = jweights.load_tree_npz(WEIGHTS / name, _jax_init(name), name)
    got = tweights.load_tree_npz(WEIGHTS / name)
    flat_want = tweights.flatten_tree(want)
    flat_got = tweights.flatten_tree(got)
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        assert np.array_equal(flat_got[k], np.asarray(v)), k


def test_params_from_jax_round_trip_and_layout():
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtv.init_params(jax.random.PRNGKey(3),
                                                  n_layers=2))
    port = tweights.params_from_jax(tree)
    back = tweights.params_to_jax(port)
    flat_in, flat_back = (tweights.flatten_tree(t) for t in (tree, back))
    assert set(flat_in) == set(flat_back)
    for k, v in flat_in.items():
        assert np.array_equal(flat_back[k], v), k
    # conv kernels become OIHW, linear weights (dout, din)
    assert tuple(port["superpoint"]["conv1a"]["w"].shape) == (64, 1, 3, 3)
    wqkv = port["lightglue"]["transformers"][0]["self_attn"]["Wqkv"]["w"]
    assert tuple(wqkv.shape) == (768, 256)
    assert tuple(port["lightglue"]["posenc"]["Wr"]["w"].shape) == (32, 2)
    # the port's own random init has the same tree
    gen = torch.Generator().manual_seed(0)
    tweights.assert_tree_matches(
        port["lightglue"],
        ttv.lg.init_params(gen, n_layers=2), "lightglue")
    tweights.assert_tree_matches(port["superpoint"],
                                 ttv.sp.init_params(gen), "superpoint")


def test_load_pretrained_reads_weights_dir(tmp_path):
    params, meta = ttv.load_pretrained(n_layers=9, device="cpu")
    assert meta["superpoint"]["pretrained"] and meta["lightglue"]["pretrained"]
    want = np.load(WEIGHTS / "superpoint_adapted.npz")["conv3b.w"]
    got = params["superpoint"]["conv3b"]["w"].numpy().transpose(2, 3, 1, 0)
    assert np.array_equal(got, want)
    # an absent file or another depth is random init, recorded in meta
    _, meta = ttv.load_pretrained(n_layers=2, weights_dir=tmp_path,
                                  device="cpu")
    assert not meta["superpoint"]["pretrained"]
    assert not meta["lightglue"]["pretrained"]
    assert "absent" in meta["superpoint"]["source"]


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttv.load_pretrained(device="cuda")


def test_token_confidence_heads_reach_the_wrappers():
    """The 8 token_confidence heads adaptive depth needs: read by the
    LightGlue wrapper from weights/ as (1, 256) linear weights equal to the
    npz leaves transposed, with their biases; SuperPoint's wrapper reads
    its tree the same way."""
    from imcui_tpu_torch.models.extractors.superpoint import SuperPoint
    from imcui_tpu_torch.models.matchers.lightglue import LightGlue

    lg = LightGlue({}, device="cpu")
    assert lg.meta["pretrained"]
    heads = lg.params["token_confidence"]
    assert len(heads) == 8 and len(lg.params["log_assignment"]) == 9
    with np.load(WEIGHTS / "lightglue_selftrained.npz") as z:
        for i, head in enumerate(heads):
            w, b = head["token"]["w"], head["token"]["b"]
            assert tuple(w.shape) == (1, 256) and tuple(b.shape) == (1,)
            assert np.array_equal(w.numpy().T, z[f"token_confidence.{i}.token.w"])
            assert np.array_equal(b.numpy(), z[f"token_confidence.{i}.token.b"])
    sp = SuperPoint({}, device="cpu")
    assert sp.meta["pretrained"]
    want = np.load(WEIGHTS / "superpoint_adapted.npz")["convPb.w"]
    assert np.array_equal(
        sp.params["convPb"]["w"].numpy().transpose(2, 3, 1, 0), want)
    moved = tweights.to_device(lg.params, "cpu")
    tweights.assert_tree_matches(moved, lg.params, "lightglue")
