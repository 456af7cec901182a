"""GlueStick, the point and line matcher: the port against the JAX
package on the CPU, part by part and end to end through both
``ImageMatchingAPI``s, with the line contract of the dense branch
(``keypoints_to_original`` on (L, 2, 2) segments and ``filter_matches``'
line branch). SOLD2 and LISRD are in ``test_torch_port_sold2_lisrd.py``.

GlueStick's default path runs the trained SuperPoint
(``weights/superpoint_adapted.npz``), LSD, mutual nearest neighbours and
the descriptor vote along the lines (the GNN is in
``test_torch_port_gluestick_gnn.py``).

Tolerances: GlueStick's uint8 images equal the JAX package's bit for bit;
``raw_lines*`` equal as sets (endpoints within 1e-4 px), line matches
equal as sets of segment pairs; point matches at IoU 1.0 with both
SuperPoints in float32. At the bf16 default the two SuperPoints round
their scores apart (by up to 0.025), which moves keypoints at GlueStick's
threshold of 1e-4 and swaps NMS winners (ROADMAP "bf16 SuperPoint"):
each view's keypoints at IoU >= 0.8 (measured 0.84-0.93 on four 320 x
240 pairs, 0.90 and 0.93 on the planted one), the matches whose two
points both packages keep at IoU >= 0.9 (measured 0.95-0.98; 0.98), and
all matches at IoU >= 0.8 (measured 0.72-0.87; 0.87);
the planted gate's inliers within 10 %
of the JAX package's at a median transfer error within 0.1 px of it,
and its share of lines within 3 px of their match's line within 0.05.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu.api.core import ImageMatchingAPI as JaxAPI
from imcui_tpu.models.matchers import gluestick as jgs
from imcui_tpu.ui import utils as jui
from imcui_tpu.utils import image as jimage
from imcui_tpu_torch.api.core import ImageMatchingAPI as TorchAPI
from imcui_tpu_torch.models.matchers import gluestick as tgs
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils import image as timage
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
# GlueStick: parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
def test_gluestick_uint8_image_equals_jax(channels):
    """The JAX module's grey image and its clip(g 255).astype(uint8), bit
    for bit, on values that sit at the edges of grey levels."""
    rng = np.random.default_rng(channels)
    x = rng.integers(0, 256, (1, channels, 37, 53)) / 255.0
    x = (x + rng.choice([-1e-7, 0.0, 1e-7], x.shape)).astype(np.float32)
    g = x[0].mean(0) if channels == 3 else x[0, 0]
    want = np.clip(g * 255, 0, 255).astype(np.uint8)
    tg, tu = tgs.gray_u8(torch.from_numpy(x))
    np.testing.assert_array_equal(tg.numpy(), g)
    np.testing.assert_array_equal(tu.numpy(), want)


@pytest.mark.parametrize("max_lines", [512, 10])
def test_detect_lines_equals_jax(max_lines):
    """On a textured image and on squares (equal lengths), as sets."""
    img = chip_smoke.textured_image(np.random.default_rng(3), 180, 240)
    sq = np.full((160, 200), 40, np.uint8)
    sq[30:90, 30:90] = 200
    sq[100:140, 120:160] = 120
    for u in (img, sq):
        want = jgs.detect_lines(u, max_lines, 15.0)
        got = tgs.detect_lines(torch.from_numpy(u), max_lines, 15.0).numpy()
        assert len(want) > 0
        if max_lines < len(jgs.detect_lines(u, 512, 15.0)):
            # the cut falls where lengths differ on these images
            lw = np.linalg.norm(want[:, 1] - want[:, 0], axis=1)
            lg = np.linalg.norm(got[:, 1] - got[:, 0], axis=1)
            assert np.sort(lw)[0] == np.sort(lg)[0]
        _same_segment_set(got, want, 1e-4)


def test_line_points_descriptors_and_votes_equal_jax():
    rng = np.random.default_rng(0)
    lines = rng.uniform(0, 150, (20, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.sample_line_points(torch.from_numpy(lines)).numpy(),
        jgs.sample_line_points(lines), atol=1e-5)
    dmap = rng.normal(size=(256, 20, 25)).astype(np.float32)
    pts = jgs.sample_line_points(lines)
    want = jgs.describe_points(dmap, pts)
    got = tgs.describe_points(torch.from_numpy(dmap),
                              torch.from_numpy(pts.astype(np.float32)))
    assert _rel(got, want) <= 1e-5
    # votes: line i of view 1 is line perm[i] of view 0 with noise
    d0 = rng.normal(size=(30, 5, 64)).astype(np.float32)
    perm = rng.permutation(30)
    d1 = d0[perm] + rng.normal(size=d0.shape).astype(np.float32) * 0.4
    d1[5:9] = rng.normal(size=(4, 5, 64))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    for votes in (1, 3, 5):
        want = jgs.match_lines(d0, d1, votes)
        got = tgs.match_lines(torch.from_numpy(d0), torch.from_numpy(d1),
                              votes)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want > -1).sum() >= 10
    assert tgs.match_lines(torch.from_numpy(d0), torch.zeros(0, 5, 64)
                           ).tolist() == [-1] * 30


# --------------------------------------------------------------------------
# GlueStick end to end
# --------------------------------------------------------------------------

def _zoo(ui, pkg):
    from pathlib import Path
    return ui.get_matcher_zoo(ui.load_config(
        Path(__file__).resolve().parents[1] / pkg / "config" / "app.yaml"
    )["matcher_zoo"])["gluestick"]


@pytest.fixture(scope="module")
def gnn_tree():
    ttree = tgs.init_gnn_params(torch.Generator().manual_seed(0))
    return _carried(lambda: jgs.init_gnn_params(KEY), ttree)


@pytest.fixture(scope="module")
def gluestick_apis(gnn_tree):
    jtree = gnn_tree
    mp = pytest.MonkeyPatch()
    mp.setattr(jgs, "init_gnn_params", lambda key: jtree)
    try:
        japi = JaxAPI(_zoo(jui, "imcui_tpu"))
    finally:
        mp.undo()
    tapi = TorchAPI(_zoo(tui, "imcui_tpu_torch"), device="cpu")
    assert tapi.matcher.meta["pretrained"] and not tapi.matcher.use_gnn
    return japi, tapi


@pytest.fixture(scope="module")
def planted():
    return chip_smoke.synthetic_pair(100, 320, 240)


def _set_sp_precision(apis, precision):
    for api in apis:
        api.matcher.sp.conf["precision"] = precision


class _Recorded:
    """The JAX GlueStick's SuperPoint, keeping each call's outputs."""

    def __init__(self, model):
        self.model, self.out = model, []

    def __call__(self, data):
        o = self.model(data)
        self.out.append({k: np.asarray(v) for k, v in o.items()})
        return o

    def __getattr__(self, name):
        return getattr(self.model, name)


def _common_keypoints(feats):
    """Per view, the keypoints both packages keep (within 0.01 px) and the
    IoU of the two sets. ``feats``: the JAX and the port SuperPoint's
    outputs on the batched pair."""
    out = []
    for v in (0, 1):
        kp = [f["keypoints"][v][f["mask"][v].astype(bool)] for f in feats]
        iou, ia, _ = chip_smoke.common_points(kp[0], kp[1], 0.01)
        out.append((kp[0][ia], iou))
    return out


def _on_keypoints(pred, common):
    """The matches of ``pred`` whose two points are both in ``common``."""
    keep = np.ones(len(pred["mkeypoints0"]), bool)
    for v, (kp, _) in enumerate(common):
        mk = np.asarray(pred[f"mkeypoints{v}"])
        keep &= (np.abs(mk[:, None] - kp[None]).max(-1) <= 0.01).any(1)
    return {k: np.asarray(pred[k])[keep]
            for k in ("mkeypoints0_orig", "mkeypoints1_orig")}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gluestick_through_both_apis(gluestick_apis, planted, precision,
                                     monkeypatch):
    japi, tapi = gluestick_apis
    rec = _Recorded(japi.matcher.sp)
    monkeypatch.setattr(japi.matcher, "sp", rec)
    tout = []
    hook = tapi.matcher.sp.register_forward_hook(
        lambda mod, args, o: tout.append(
            {k: v.detach().numpy() for k, v in o.items()}))
    _set_sp_precision(gluestick_apis, precision)
    try:
        want, got = (api(planted[0], planted[1]) for api in gluestick_apis)
    finally:
        _set_sp_precision(gluestick_apis, "bf16")
        hook.remove()
    for k in ("raw_lines0", "raw_lines1"):
        _same_segment_set(got[k][0], want[k][0], 1e-4)
        assert len(want[k][0]) >= 40
    pairs = [np.concatenate([chip_smoke.segment_rows(r["lines0"][0]),
                             chip_smoke.segment_rows(r["lines1"][0])], 1)
             for r in (want, got)]
    assert len(pairs[0]) >= 20
    d = np.abs(pairs[0][:, None] - pairs[1][None]).max(-1)
    assert pairs[0].shape == pairs[1].shape
    assert d.min(1).max() <= 1e-4 and d.min(0).max() <= 1e-4
    common = _common_keypoints([rec.out[0], tout[0]])
    kpt_iou = [iou for _, iou in common]
    iou_common = chip_smoke.raw_match_iou(_on_keypoints(got, common),
                                          _on_keypoints(want, common))
    iou = chip_smoke.raw_match_iou(got, want)
    if precision == "fp32":
        assert kpt_iou == [1.0, 1.0] and iou == iou_common == 1.0, (
            kpt_iou, iou, iou_common)
    else:
        assert min(kpt_iou) >= 0.8 and iou_common >= 0.9 and iou >= 0.8, (
            kpt_iou, iou, iou_common)


def test_gluestick_planted_gate_beside_jax(gluestick_apis, planted):
    """On the planted pair: point inliers within 10 % of the JAX package's
    at a median transfer error within 0.1 px of it, and the share of
    matched lines whose H-mapped endpoints lie within 3 px of the matched
    segment's line within 0.05 of it."""
    hm = planted[2]
    stats = []
    for api in gluestick_apis:
        pred = api(planted[0], planted[1])
        err = chip_smoke.transfer_errors(hm, pred["mmkeypoints0_orig"],
                                         pred["mmkeypoints1_orig"])
        lerr = chip_smoke.line_transfer_errors(
            hm, np.asarray(pred["lines0_orig"][0]),
            np.asarray(pred["lines1_orig"][0]))
        stats.append((len(err), float(np.median(err)),
                      float((lerr <= 3.0).mean())))
    (jn, jmed, jshare), (tn, tmed, tshare) = stats
    assert jn >= 100 and tn >= 0.9 * jn, stats
    assert tmed <= jmed + 0.1 and tmed <= 2.0, stats
    assert jshare >= 0.5 and tshare >= jshare - 0.05, stats


def test_line_outputs_through_keypoints_to_original_and_filter_matches():
    """(1, L, 2, 2) segments and (1, L, 2) midpoints map back as the JAX
    package maps them; ``filter_matches`` takes the line branch where no
    point matches exist, and on exact planted correspondences both
    packages keep every line and find the same homography."""
    rng = np.random.default_rng(4)
    lines = rng.uniform(0, 200, (1, 40, 2, 2)).astype(np.float32)
    scale = np.array([1.6, 1.25])
    np.testing.assert_allclose(timage.keypoints_to_original(lines, scale),
                               jimage.keypoints_to_original(lines, scale),
                               rtol=0, atol=0)
    hm = chip_smoke.random_homography(rng, 240, 320)
    mid0 = lines[0].mean(1)
    p = np.concatenate([mid0, np.ones((40, 1))], 1) @ hm.T
    mid1 = (p[:, :2] / p[:, 2:]).astype(np.float32)
    preds = []
    for ui, kw in ((jui, {}), (tui, {"device": "cpu"})):
        pred = {"line_keypoints0_orig": mid0.copy(),
                "line_keypoints1_orig": mid1.copy()}
        preds.append(ui.filter_matches(pred, "TPU_LORANSAC", 3.0, 0.999,
                                       2000, **kw))
    for pred in preds:
        assert "mmkeypoints0_orig" not in pred
        assert len(pred["mline_keypoints0_orig"]) == 40
        h = np.asarray(pred["H"]) / pred["H"][2][2]
        assert np.abs(h - hm / hm[2, 2]).max() <= 1e-3 * np.abs(hm).max()


def test_gluestick_through_the_cache_the_server_and_the_cli(
        gluestick_apis, planted, tmp_path, monkeypatch):
    """The surfaces serve the entry with no change of their own: the
    model cache (``run_matching``), the HTTP server with its client, and
    the CLI's ``match --matcher gluestick``; each returns the API's raw
    lines on the same input."""
    import pickle
    import threading

    from imcui_tpu_torch.api import client as tclient
    from imcui_tpu_torch.api import server as tserver
    from imcui_tpu_torch.cli import main as tcli
    from imcui_tpu_torch.utils.png import encode_png

    a, b, _ = planted
    want = gluestick_apis[1](a, b)
    from pathlib import Path
    zoo = tui.get_matcher_zoo(tui.load_config(
        Path(tui.__file__).resolve().parents[1] / "config" / "app.yaml"
    )["matcher_zoo"])
    got = tui.run_matching(a, b, key="gluestick", matcher_zoo=zoo,
                           device="cpu")
    _same_segment_set(got["raw_lines0"][0], want["raw_lines0"][0], 1e-4)
    assert "H" in got and len(got["lines0"][0]) >= 20

    files = []
    for name, img in (("a.png", a), ("b.png", b)):
        (tmp_path / name).write_bytes(encode_png(img))
        files.append(str(tmp_path / name))
    service = tserver.MatchingService(_zoo(tui, "imcui_tpu_torch"),
                                      device="cpu")
    httpd = tserver.serve_stdlib(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        pred = tclient.send_request_match(
            *files, f"http://127.0.0.1:{httpd.server_address[1]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    _same_segment_set(np.asarray(pred["raw_lines1"])[0],
                      want["raw_lines1"][0], 1e-4)

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "pred.pkl"
    assert tcli.main(["match", *files, "--matcher", "gluestick", "-o",
                      str(out), "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        pred = pickle.load(f)
    _same_segment_set(pred["raw_lines0"][0], want["raw_lines0"][0], 1e-4)
    assert len(pred["lines0_orig"][0]) == len(want["lines0_orig"][0])
