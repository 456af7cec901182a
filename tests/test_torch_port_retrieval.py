"""The global-descriptor zoo: the port against the JAX package on the CPU.
ResNet-18's trunk; NetVLAD's VGG16 trunk and pooling; FIRe's trunk and
super-features; the top-k of FIRe's local features; then each of the
seven retrieval confs of the registry (``netvlad``, ``openibl``,
``cosplace``, ``eigenplaces``, ``dir``, ``fire``, ``fire_local``) end to
end through both packages' ``extract()`` at ``resize_max`` 1024 on one
256 × 192 photo (a 256 × 256 canvas).

Every model runs the port's seed-0 tree, carried to the JAX package's
layout by ``params_to_jax`` and checked against the layout of the JAX
init (``jax.eval_shape``). EigenPlaces and DIR are CosPlace's network on
ResNet101; the JAX package compiles one program per model instance, so
they are held to it end to end on ResNet18 (``backbone`` in the conf),
and their registry confs on ResNet101 run on the port alone (unit
2048-d descriptors); ResNet-101's trunk is ``resnet_apply``, held
against the JAX package at depth 50 in
``test_torch_port_dkm.py::test_resnet50_pyramid_matches_jax`` (depth 101
differs only in layer3's block count).

Tolerances: trunk features, VLAD vectors and super-features within 1e-5
of the largest (5e-5 through VGG16's thirteen layers); the unit global
descriptors with cosine >= 1 − 1e-6 and max abs error <= 1e-5; FIRe's
local features in the same order within 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.models.backbones import resnet as jresnet
from imcui_tpu.models.extractors import cosplace as jcosplace
from imcui_tpu.models.extractors import fire as jfire
from imcui_tpu.models.extractors import fire_local as jfire_local
from imcui_tpu.models.extractors import netvlad as jnetvlad
from imcui_tpu.pipeline import extract_features as jextract
from imcui_tpu.ui import utils as jui
from imcui_tpu.utils.base_model import dynamic_load as jload
from imcui_tpu_torch.models import extractors as textractors
from imcui_tpu_torch.models.backbones import resnet as tresnet
from imcui_tpu_torch.models.extractors import fire as tfire
from imcui_tpu_torch.models.extractors import fire_local as tfire_local
from imcui_tpu_torch.models.extractors import netvlad as tnetvlad
from imcui_tpu_torch.pipeline import extract_features as textract
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import weights
from imcui_tpu_torch.utils.base_model import dynamic_load as tload

KEY = jax.random.PRNGKey(0)
ROOT = Path(__file__).resolve().parents[1]
RETRIEVAL = ("netvlad", "openibl", "cosplace", "eigenplaces", "dir",
             "fire", "fire_local")


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
    return torch.from_numpy(np.array(x))


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


@pytest.fixture(scope="module")
def photo():
    rng = np.random.default_rng(7)
    return chip_smoke.textured_image(rng, 192, 256)


def test_retrieval_confs_and_zoo_load():
    """The packaged app.yaml's ``retrieval_zoo`` loads, and each of the
    seven retrieval confs is the JAX package's, resolves to the port's
    model by its registry name and outputs its key."""
    raw = tui.load_config(ROOT / "imcui_tpu_torch" / "config" / "app.yaml")
    assert raw["retrieval_zoo"] == jui.load_config(
        ROOT / "imcui_tpu" / "config" / "app.yaml")["retrieval_zoo"]
    assert set(raw["retrieval_zoo"]) <= set(RETRIEVAL)
    names = {"netvlad": "NetVLAD", "openibl": "OpenIBL",
             "cosplace": "CosPlace", "eigenplaces": "EigenPlaces",
             "dir": "DIR", "fire": "FIRe", "fire_local": "FIReLocal"}
    for key in RETRIEVAL:
        conf = textract.confs[key]
        assert conf == jextract.confs[key], key
        assert conf["preprocessing"]["resize_max"] == 1024
        model = tload(textractors, conf["model"]["name"])
        assert model.__name__ == names[key]
        assert jload(__import__("imcui_tpu.models.extractors",
                                fromlist=["x"]),
                     conf["model"]["name"]).__name__ == names[key]


def test_resnet18_matches_jax():
    """``resnet18_apply`` on a 2-image 64 × 96 batch: within 1e-5 of the
    largest, (2, 512, 2, 3)."""
    ttree = weights.seeded_init(tresnet.init_resnet18, "cpu")
    jtree = _carried(lambda: jresnet.init_resnet18(KEY), ttree)
    x = np.random.default_rng(8).normal(size=(2, 3, 64, 96)).astype(
        np.float32)
    want = jax.jit(jresnet.resnet18_apply)(jtree, _nhwc(x))
    got = tresnet.resnet18_apply(weights.params_from_jax(jtree), _t(x))
    assert got.shape == (2, 512, 2, 3)
    assert _rel(got.permute(0, 2, 3, 1), want) <= 1e-5


@pytest.fixture(scope="module")
def netvlad_trees():
    """The port's seed-0 NetVLAD tree (the whitening alone 4096 × 32768)
    and its JAX layout, drawn once for the module."""
    ttree = weights.seeded_init(tnetvlad.init_params, "cpu")
    return ttree, _carried(lambda: jnetvlad.init_params(KEY), ttree)


def test_netvlad_trunk_and_pool_match_jax(netvlad_trees):
    """VGG16 through conv5_3 (no last ReLU) on a 64 × 80 batch of two, and
    NetVLAD pooling of its 4 × 5 maps: within 5e-5 and 1e-5; the pooled
    vector D-major (index d·64 + k)."""
    ttree, jtree = netvlad_trees
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, 64, 80)).astype(np.float32)
    want = jax.jit(jnetvlad.vgg16_trunk)(jtree["backbone"], _nhwc(x))
    got = tnetvlad.vgg16_trunk(ttree["backbone"], _t(x))
    assert got.shape == (2, 512, 4, 5) and (got < 0).any()
    assert _rel(got.permute(0, 2, 3, 1), want) <= 5e-5
    feats = np.asarray(want)
    wv = jax.jit(jnetvlad.netvlad_pool)(jtree["netvlad"], jnp.asarray(feats))
    gv = tnetvlad.netvlad_pool(ttree["netvlad"],
                               _t(feats.transpose(0, 3, 1, 2)))
    assert gv.shape == (2, 64 * 512)
    assert _rel(gv, wv) <= 1e-5


def test_fire_parts_match_jax():
    """FIRe's trunk on a 64 × 96 batch of two (256 channels at 1/16) and
    the super-features with their mass: within 1e-5; the local top-k of
    equal masses keeps the lower index first, as ``lax.top_k``."""
    ttree = tfire.init_params(torch.Generator().manual_seed(0))
    jtree = _carried(lambda: jfire.init_params(KEY), ttree)
    ttree = weights.params_from_jax(jtree)
    x = np.random.default_rng(10).normal(size=(2, 3, 64, 96)).astype(
        np.float32)
    want = jax.jit(jfire.trunk)(jtree, _nhwc(x))
    got = tfire.trunk(ttree, _t(x))
    assert got.shape == (2, 256, 4, 6)
    assert _rel(got.permute(0, 2, 3, 1), want) <= 1e-5
    wq, wm = jax.jit(jfire.superfeatures)(jtree, want)
    gq, gm = tfire.superfeatures(ttree, _t(np.asarray(want)).permute(
        0, 3, 1, 2))
    assert gq.shape == (2, 64, 256)
    assert _rel(gq, wq) <= 1e-5 and _rel(gm, wm) <= 1e-5
    mass = torch.tensor([[1.0, 3.0, 2.0, 3.0, 1.0, 2.0]])
    sf = torch.arange(6.0).view(1, 6, 1)
    np.testing.assert_array_equal(
        tfire_local.select(sf, mass, 4)[0, :, 0].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(mass.numpy()), 4)[1][0]))


def _extract_pair(key, photo, jinit, conf_update=None, trees=None):
    """Both packages' extract() at the registry conf ``key`` (with
    ``conf_update`` in its model conf), on the port's seed-0 tree, or on
    ``trees`` (the port's and the JAX package's) where given. The JAX
    model is handed the tree, carried by ``_carried`` against its init
    ``jinit(model conf)``, where it would draw its own (its random init
    runs op by op, seconds a model)."""
    conf = textract.confs[key]
    mconf = {**conf["model"], **(conf_update or {})}
    mp = pytest.MonkeyPatch()
    if trees is not None:
        mp.setattr(weights, "seeded_init", lambda *a, **k: trees[0])
    try:
        tmodel = tui.get_feature_model({"model": mconf}, "cpu")
    finally:
        mp.undo()
    jconf = {**type(tmodel).default_conf, **mconf}
    jtree = trees[1] if trees is not None else _carried(
        lambda: jinit(jconf), tmodel.params)
    meta = {"pretrained": False}
    for mod, name, fn in ((jnetvlad, "load_params", lambda c: (jtree, meta)),
                          (jfire, "load_params", lambda c: (jtree, meta)),
                          (jfire_local, "load_params",
                           lambda c: (jtree, meta)),
                          (jcosplace, "init_params", lambda *a: jtree)):
        mp.setattr(mod, name, fn)
    try:
        jmodel = jui.get_feature_model({"model": mconf})
    finally:
        mp.undo()
    return (textract.extract(tmodel, photo, conf["preprocessing"]),
            jextract.extract(jmodel, photo, conf["preprocessing"]))


def _same_global(got, want):
    g, w = got["global_descriptor"], np.asarray(want["global_descriptor"])
    assert g.shape == w.shape and g.shape[0] == 1
    cos = float((g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w))
    assert cos >= 1 - 1e-6 and np.abs(g - w).max() <= 1e-5, cos
    assert abs(np.linalg.norm(g) - 1.0) <= 1e-5
    out = textract.trim_valid(got)
    assert set(out) == {"global_descriptor"} and out[
        "global_descriptor"].shape == (g.shape[1],)


@pytest.mark.parametrize("key", ["netvlad", "openibl"])
def test_netvlad_entries_through_extract(key, photo, netvlad_trees):
    got, want = _extract_pair(key, photo, None, trees=netvlad_trees)
    assert got["global_descriptor"].shape == (1, 4096)
    _same_global(got, want)


@pytest.mark.parametrize("key,backbone", [
    ("cosplace", None), ("eigenplaces", "ResNet18"), ("dir", "ResNet18")])
def test_cosplace_entries_through_extract(key, backbone, photo):
    """CosPlace at its registry conf (ResNet50, 2048-d); EigenPlaces and
    DIR on ResNet18 (a 2048-d head on 512 channels)."""
    update = {"backbone": backbone} if backbone else None
    got, want = _extract_pair(
        key, photo, lambda c: jcosplace.init_params(
            KEY, c["backbone"], c["fc_output_dim"]), update)
    assert got["global_descriptor"].shape == (1, 2048)
    _same_global(got, want)


@pytest.mark.parametrize("key", ["eigenplaces", "dir"])
def test_resnet101_entries_on_the_port(key, photo):
    """The registry's EigenPlaces and DIR on ResNet101: unit 2048-d
    descriptors, finite, through the port's extract()."""
    conf = textract.confs[key]
    model = tui.get_feature_model(conf, "cpu")
    assert model.conf["backbone"] == "ResNet101"
    assert len(model.params["backbone"]["layer3"]) == 23
    got = textract.extract(model, photo, conf["preprocessing"])
    g = got["global_descriptor"]
    assert g.shape == (1, 2048) and np.isfinite(g).all()
    assert abs(np.linalg.norm(g) - 1.0) <= 1e-5


@pytest.mark.parametrize("key", ["fire", "fire_local"])
def test_fire_entries_through_extract(key, photo):
    """FIRe at its registry conf over the scales 1.414, 1.0, 0.707 and
    0.5; FIRe-local's 256 super-features (features_num 1000 keeps all 4 ×
    64), by decreasing mass."""
    got, want = _extract_pair(key, photo,
                              lambda c: jfire.init_params(KEY))
    if key == "fire":
        assert got["global_descriptor"].shape == (1, 256)
        _same_global(got, want)
        return
    g, w = got["local_descriptor"], np.asarray(want["local_descriptor"])
    assert g.shape == w.shape == (1, 256, 256)
    assert np.abs(g - w).max() <= 1e-5
    assert textract.trim_valid(got)["local_descriptor"].shape == (256, 256)
