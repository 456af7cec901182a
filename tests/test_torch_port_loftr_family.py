"""The LoFTR family in the port (``eloftr``, ``se2loftr``, ``xoftr``,
``aspanformer``, ``topicfm``, ``matchformer`` under
imcui_tpu_torch/models/matchers/) and RoMa's ``fpn-corr`` backbone against
the JAX package on the CPU. Each runs its JAX ``init_params`` tree,
carried across by ``weights.params_from_jax``, through both packages at
128 × 160 in float32: the JAX package's jitted pair batch against the
port's ``BaseModel``.

None of these models has a trained tree in the repository, and random
weights leave few matches above the registry's threshold: where they
leave none, the test lowers ``match_threshold`` (per model below) and
asserts that the set is not empty, so that no comparison passes on
nothing. Tolerances: the same valid match set, keypoints within 1e-3 px,
scores within 1e-4 (aspanformer's 2e-4, see FAMILY).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imcui_tpu.models.matchers import roma as jroma
from imcui_tpu_torch.models.matchers import roma as troma
from imcui_tpu_torch.utils import weights

H, W = 128, 160
# name → (match_threshold, the class's name in the port, the scores'
# tolerance). The registry's threshold where the random tree keeps matches
# above it (xoftr 0.3, aspanformer and topicfm 0.2); else the largest of
# 1e-3, 1e-4 that does. Scores within 1e-4, aspanformer's within 2e-4: its
# coarse tokens pass through six attention layers (two of them dense
# softmaxes over flow-placed spans), and a float32 difference of ~1e-6 in
# a token becomes ~1e-4 in a dual-softmax confidence, whose exponent is
# 2/temperature = 20 times the logit (measured 1.17e-4 on 0.957).
FAMILY = {
    "eloftr": (1e-3, "ELoFTR", 1e-4),
    "se2loftr": (1e-3, "Se2LoFTR", 1e-4),
    "xoftr": (0.3, "XoFTR", 1e-4),
    "aspanformer": (0.2, "ASpanFormer", 2e-4),
    "topicfm": (0.2, "TopicFM", 1e-4),
    "matchformer": (1e-4, "MatchFormer", 1e-4),
}
SLOTS = 200


@pytest.fixture(scope="module")
def pair():
    """Image 1 is a shifted crop of image 0 (numpy seed 8); image 1's
    valid width is W - 24, as if it were padded."""
    rng = np.random.default_rng(8)
    big = rng.random((H + 16, W + 16)).astype(np.float32)
    return (big[:H, :W][None, None], big[8:H + 8, 16:W + 16][None, None],
            np.array([[W, H]]), np.array([[W - 24, H]]))


def _rows(k0, k1, score, mask):
    r = np.concatenate([k0, k1, score[:, None]], 1)[mask]
    return r[np.lexsort(r.T[::-1])]


@pytest.mark.parametrize("name", list(FAMILY))
def test_family_matcher_matches_jax(name, pair):
    thr, cls, score_tol = FAMILY[name]
    jm = importlib.import_module(f"imcui_tpu.models.matchers.{name}")
    tm = importlib.import_module(f"imcui_tpu_torch.models.matchers.{name}")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(0)))
    tp = weights.params_from_jax(tree)

    model = getattr(tm, cls)({"max_keypoints": SLOTS,
                              "match_threshold": thr}, device="cpu")
    assert model.meta["pretrained"] is False
    assert "random init" in model.meta["source"]
    # the port's own init has the JAX tree's leaves and shapes
    weights.assert_tree_matches(model.params, tp, name)
    model.params = tp

    img0, img1, wh0, wh1 = pair
    conf = {**model.pair_conf}
    want = jm._apply_batched(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(img0.transpose(0, 2, 3, 1)),
        jnp.asarray(img1.transpose(0, 2, 3, 1)), jnp.asarray(wh0),
        jnp.asarray(wh1), tuple(sorted(conf.items())))
    want = {k: np.asarray(v)[0] for k, v in want.items()}
    got = model({"image0": img0, "image1": img1, "size0": wh0,
                 "size1": wh1})
    got = {k: v[0].numpy() for k, v in got.items()}

    assert got["keypoints0"].shape == (SLOTS, 2)
    assert np.array_equal(got["mconf"], got["scores"])
    for k in ("keypoints0", "keypoints1", "scores"):
        assert np.isfinite(got[k]).all()
    assert got["mask"].sum() > 0 and want["mask"].sum() > 0
    a = _rows(want["keypoints0"], want["keypoints1"], want["scores"],
              want["mask"])
    b = _rows(got["keypoints0"], got["keypoints1"], got["scores"],
              got["mask"])
    assert a.shape == b.shape
    assert np.abs(a[:, :4] - b[:, :4]).max() <= 1e-3
    assert np.abs(a[:, 4] - b[:, 4]).max() <= score_tol
    # nothing matches into image 1's padding (its last three cells)
    assert got["keypoints1"][got["mask"], 0].max() < W - 24 + 8


def test_family_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name, (_, cls, _) in FAMILY.items():
        tm = importlib.import_module(f"imcui_tpu_torch.models.matchers.{name}")
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(tm, cls)({})


def test_roma_fpn_corr_matches_jax(pair):
    """RoMa's fpn-corr path on the JAX init tree: the wrapper's sampled
    correspondences (100 of the 320 coarse cells, in image 0's pixels)
    against the JAX Roma's, as sets within 1e-3 px and certainties within
    1e-5; then the warp and certainty of ``match`` within 1e-5. bf16 runs
    and stays finite."""
    conf = {"backbone": "fpn-corr", "max_keypoints": 100}
    tree = jax.tree_util.tree_map(
        np.asarray, jroma.init_params_fpn(jax.random.PRNGKey(0)))
    jm = jroma.Roma(conf)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = troma.Roma(conf, device="cpu")
    assert tm.meta["pretrained"] is False and tm.meta["backbone"] == "fpn-corr"
    tp = weights.params_from_jax(tree)
    weights.assert_tree_matches(tm.params, tp, "roma fpn-corr")
    tm.params = tp

    img0, img1 = (np.repeat(x, 3, 1) for x in pair[:2])  # the gray mean runs
    data = {"image0": img0, "image1": img1}
    want = {k: np.asarray(v)[0] for k, v in jm(data).items()}
    got = {k: v[0].numpy() for k, v in tm(data).items()}
    assert got["keypoints0"].shape == (100, 2) and got["mask"].all()
    a = _rows(want["keypoints0"], want["keypoints1"], want["scores"],
              want["mask"])
    b = _rows(got["keypoints0"], got["keypoints1"], got["scores"],
              got["mask"])
    assert a.shape == b.shape
    assert np.abs(a[:, :4] - b[:, :4]).max() <= 1e-3
    assert np.abs(a[:, 4] - b[:, 4]).max() <= 1e-5
    assert got["keypoints0"].max() <= W - 1 + 1e-3

    x0, x1 = (jnp.asarray(x[0].transpose(1, 2, 0)) for x in pair[:2])
    wj, cj = jroma.match(jm.params, x0, x1)
    with torch.inference_mode(), troma.full_fp32():
        wt, ct = troma.match(tp, torch.from_numpy(pair[0][0]),
                             torch.from_numpy(pair[1][0]))
    assert wt.shape == (H // 8, W // 8, 2) and ct.shape == (H // 8, W // 8)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)

    tb = troma.Roma({**conf, "precision": "bf16"}, device="cpu")
    out = tb(data)
    assert out["keypoints0"].shape == (1, 100, 2)
    assert torch.isfinite(out["keypoints1"]).all()
    assert bool(((out["scores"] >= 0) & (out["scores"] <= 1)).all())
