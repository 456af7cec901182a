"""The port's user surfaces on the CPU against the JAX package: the request
schema and base64 helpers, the HTTP server (one module-scoped server on
device="cpu", on synthetic PNGs), the client, the CLI in-process, and the
three findings in the frozen JAX code that the port keeps, each pinned on
both packages. Tolerances are stated per test."""

import base64
import copy
import io
import json
import pickle
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
import imcui_tpu
import imcui_tpu_torch
from imcui_tpu import api as japi
from imcui_tpu.api import client as jclient
from imcui_tpu.api import server as jserver
from imcui_tpu.cli import main as jcli
from imcui_tpu.ui import utils as jui
from imcui_tpu_torch import api as tapi
from imcui_tpu_torch.api import client as tclient
from imcui_tpu_torch.api import server as tserver
from imcui_tpu_torch.cli import main as tcli
from imcui_tpu_torch.ui import utils as tui
from imcui_tpu_torch.utils.io import read_yaml
from imcui_tpu_torch.utils.png import encode_png

ROOT = Path(__file__).resolve().parents[1]
SP_NPZ = str(ROOT / "weights" / "superpoint_adapted.npz")
# tests/test_server_cli.py's conf, with both packages reading the trained
# tree and SuperPoint in fp32, where they find the same keypoints (in bf16
# they round in other places by design, ROADMAP.md section C)
CONF = {
    "feature": {
        "output": "f",
        "model": {"name": "superpoint", "max_keypoints": 256,
                  "keypoint_threshold": 1e-4, "checkpoint_npz": SP_NPZ,
                  "precision": "fp32"},
        "preprocessing": {"grayscale": True, "resize_max": 256,
                          "dfactor": 8},
    },
    "matcher": {"output": "m",
                "model": {"name": "nearest_neighbor",
                          "do_mutual_check": True}},
    "dense": False,
    "standalone": False,
    "ransac": {"enable": True, "method": "TPU_LORANSAC",
               "reproj_threshold": 8, "confidence": 0.9999,
               "max_iter": 10000},
}


@pytest.fixture(autouse=True, scope="module")
def _offline():
    """The JAX models look for checkpoints on the hub unless told not to."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HF_HUB_OFFLINE", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A planted 320 x 240 pair as PNG files (the port's encoder), a JPEG,
    and the homography."""
    d = tmp_path_factory.mktemp("pair")
    img0, img1, hm = chip_smoke.synthetic_pair(100, 320, 240)
    (d / "a.png").write_bytes(encode_png(img0))
    (d / "b.png").write_bytes(encode_png(img1))
    buf = io.BytesIO()
    PIL.Image.fromarray(img0).save(buf, format="JPEG")
    (d / "a.jpg").write_bytes(buf.getvalue())
    return {"a": d / "a.png", "b": d / "b.png", "jpg": d / "a.jpg",
            "hm": hm, "img0": img0, "img1": img1}


@pytest.fixture(scope="module")
def server():
    service = tserver.MatchingService(copy.deepcopy(CONF), device="cpu")
    httpd = tserver.serve_stdlib(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def jax_service():
    return jserver.MatchingService(copy.deepcopy(CONF))


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# --------------------------------------------------------------------------
# api/__init__.py
# --------------------------------------------------------------------------

def test_images_input_defaults_equal_jax():
    assert tapi.ImagesInput().model_dump() == \
        japi.ImagesInput().model_dump()
    assert list(tapi.ImagesInput.model_fields) == \
        list(japi.ImagesInput.model_fields)
    body = {"data": ["x"], "max_keypoints": [7, 9], "timestamps": ["0"],
            "grayscale": True, "image_hw": [[2, 3], [4, 5]],
            "feature_type": 1, "rotates": [0.5], "scales": [1.5],
            "reference_points": [[1.0, 2.0]], "binarize": True}
    assert tapi.ImagesInput(**body).model_dump() == \
        japi.ImagesInput(**body).model_dump()


@pytest.mark.parametrize("body", [
    {"data": [], "colour": 1},        # an unknown key: ignored
    {"max_keypoints": ["7"]},         # coerced
    {"data": "abc"},
    {"max_keypoints": [1.5]},
    {"binarize": "maybe"},
    {"image_hw": [1, 2]},
])
def test_images_input_validates_as_jax(body):
    """A body the JAX schema takes gives the same values; one it refuses
    raises ``ValueError`` (pydantic's ValidationError) naming the field."""
    try:
        want = japi.ImagesInput(**body).model_dump()
    except ValueError as e:
        field = next(iter(body))
        assert field in str(e)
        with pytest.raises(ValueError, match=field):
            tapi.ImagesInput(**body)
    else:
        assert tapi.ImagesInput(**body).model_dump() == want


@pytest.mark.parametrize("prefix", ["", "data:image/png;base64,"])
def test_decode_base64_equals_jax(files, prefix):
    """Exact: the same RGB array as the JAX package's PIL decode, for the
    PNG and for PIL's JPEG of the same image (the port's JPEG decoder)."""
    b64 = prefix + base64.b64encode(files["a"].read_bytes()).decode()
    got = tapi.to_base64_nparray(b64)
    np.testing.assert_array_equal(got, japi.to_base64_nparray(b64))
    assert got.dtype == np.uint8 and got.shape == (240, 320, 3)
    jpg = prefix + base64.b64encode(files["jpg"].read_bytes()).decode()
    got = tapi.decode_base64_to_image(jpg)
    np.testing.assert_array_equal(got, japi.decode_base64_to_image(jpg))
    assert got.dtype == np.uint8 and got.shape == (240, 320, 3)


# --------------------------------------------------------------------------
# api/server.py and api/client.py
# --------------------------------------------------------------------------

def test_root_version_and_404(server):
    url, _ = server
    assert _get(f"{url}/") == (200, {"message": "OK"})
    assert _get(f"{url}/version") == (200, {"version": "0.1.0"})
    assert tclient.get_api_version(url) == {
        "version": imcui_tpu_torch.__version__}
    assert imcui_tpu_torch.__version__ == imcui_tpu.__version__
    assert _get(f"{url}/nope")[0] == 404
    assert _post(f"{url}/nope", b"{}", "application/json") == (
        404, {"detail": "Not found"})


def test_match_json_and_multipart_agree(server, files):
    """The JSON base64 route (the client) and the multipart route give the
    same response (RANSAC's hypotheses are seeded); the planted homography
    holds for the inliers (median transfer error <= 2 px)."""
    url, _ = server
    pred = tclient.send_request_match(files["a"], files["b"], base_url=url)
    assert "mkeypoints0_orig" in pred and "mmkeypoints0_orig" in pred
    assert "image0_orig" not in pred
    body, ctype = chip_smoke.multipart_body(
        {"image0": files["a"].read_bytes(), "image1": files["b"].read_bytes()})
    code, multi = _post(f"{url}/v1/match", body, ctype)
    assert code == 200
    assert set(multi) == set(pred)
    for k, v in multi.items():
        np.testing.assert_array_equal(np.array(v), pred[k])
    err = chip_smoke.transfer_errors(files["hm"], pred["mmkeypoints0_orig"],
                                     pred["mmkeypoints1_orig"])
    assert len(err) >= 20 and np.median(err) <= chip_smoke.GATE_MEDIAN_PX


def test_match_response_equals_jax(server, files, jax_service):
    """The same PNG request: the JAX service's response keys, and raw
    matches at IoU >= 0.9 within 0.5 px (measured 1.0; fp32 SuperPoint)."""
    url, _ = server
    got = tclient.send_request_match(files["a"], files["b"], base_url=url)
    images = [japi.to_base64_nparray(base64.b64encode(
        files[k].read_bytes()).decode()) for k in ("a", "b")]
    want = jax_service.match(*images)
    assert set(got) == set(want)
    want = {k: np.asarray(v) for k, v in want.items()
            if k.startswith("mkeypoints")}
    assert len(want["mkeypoints0_orig"]) > 30
    assert chip_smoke.raw_match_iou(got, want) >= 0.9


def test_extract_endpoint(server, files):
    """Two images at max_keypoints 16 and 24 with binarize: those counts,
    keypoints_orig, (N, 256) sign bits; the extractor's conf is put back
    (the finding below)."""
    url, service = server
    saved = dict(service.api.extractor.conf)
    payload = {"data": [tclient.read_image_to_base64(files[k])
                        for k in ("a", "b")],
               "max_keypoints": [16, 24], "binarize": True}
    try:
        code, preds = _post(f"{url}/v1/extract",
                            json.dumps(payload).encode(), "application/json")
        single = tclient.send_request_extract(files["a"], base_url=url,
                                              max_keypoints=8)
    finally:
        service.api.extractor.conf.update(saved)
    assert code == 200 and len(preds) == 2
    for pred, n in zip(preds, (16, 24)):
        assert np.asarray(pred["keypoints"]).shape == (n, 2)
        assert np.asarray(pred["keypoints_orig"]).shape == (n, 2)
        desc = np.asarray(pred["descriptors"])
        assert desc.shape == (n, 256) and set(np.unique(desc)) <= {0, 1}
    assert len(single) == 1 and single[0]["keypoints"].shape == (8, 2)


def test_errors_answer_500_and_the_server_goes_on(server, files):
    url, _ = server
    code, out = _post(f"{url}/v1/match", b"{not json", "application/json")
    assert code == 500 and "Expecting" in out["detail"]
    cut = files["jpg"].read_bytes()
    cut = cut[:len(cut) // 2]  # a JPEG truncated in its entropy data
    jpg = base64.b64encode(cut).decode()
    code, out = _post(f"{url}/v1/match", json.dumps(
        {"image0": jpg, "image1": jpg}).encode(), "application/json")
    assert code == 500 and "JPEG" in out["detail"]
    body, ctype = chip_smoke.multipart_body({"image0": cut, "image1": cut})
    code, out = _post(f"{url}/v1/match", body, ctype)
    assert code == 500 and "JPEG" in out["detail"]
    code, out = _post(f"{url}/v1/extract", json.dumps(
        {"data": "abc"}).encode(), "application/json")
    assert code == 500 and "data" in out["detail"]
    code, out = _post(f"{url}/v1/extract", json.dumps(
        {"data": [], "colour": 1}).encode(), "application/json")
    assert (code, out) == (200, [])  # an unknown key is ignored, as in JAX
    code, out = _post(f"{url}/v1/match", b'{"bad": 1}', "application/json")
    assert code == 500 and "image0" in out["detail"]
    assert _get(f"{url}/") == (200, {"message": "OK"})


def test_postprocess_lets_no_tensor_through():
    out = tserver.MatchingService.postprocess(
        {"a": np.zeros((2, 2)), "t": torch.zeros(2), "s": np.float32(1),
         "d": {"H": [[1.0]]}, "n": None, "skip": np.ones(1)}, ["skip"])
    assert out == {"a": [[0.0, 0.0], [0.0, 0.0]], "d": {"H": [[1.0]]},
                   "n": None}
    json.dumps(out)


def test_client_constants_and_encoding_equal_jax(files):
    for name in ("API_VERSION_URL", "API_URL_MATCH", "API_URL_EXTRACT",
                 "BASE_URL"):
        assert getattr(tclient, name) == getattr(jclient, name)
    for k in ("a", "b"):  # the same pixels as the JAX client's cv2 PNG
        np.testing.assert_array_equal(
            japi.to_base64_nparray(tclient.read_image_to_base64(files[k])),
            japi.to_base64_nparray(jclient.read_image_to_base64(files[k])))


def test_entry_points_default_to_the_card_and_raise_without_one(files,
                                                                tmp_path):
    """device="cuda" by default everywhere; without a card that raises
    instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        tserver.MatchingService(copy.deepcopy(CONF))
    zoo = tui.get_matcher_zoo(tui.load_config(
        ROOT / "imcui_tpu_torch/config/app.yaml")["matcher_zoo"])
    with pytest.raises(RuntimeError, match="cuda"):
        tui.run_matching(files["img0"], files["img1"], key="superpoint+NN",
                         matcher_zoo=zoo)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["match", str(files["a"]), str(files["b"]), "-o",
                   str(tmp_path / "x.pkl")])


# --------------------------------------------------------------------------
# findings in the frozen JAX code, pinned on both packages
# --------------------------------------------------------------------------

def test_extract_changes_later_matches_in_both(server, jax_service, files):
    """ImageMatchingAPI.extract writes max_keypoints and keypoint_threshold
    into the live extractor's conf: a later match serves with them."""
    _, service = server
    b64 = base64.b64encode(files["a"].read_bytes()).decode()
    for svc, mod in ((service, tapi), (jax_service, japi)):
        saved = dict(svc.api.extractor.conf)
        try:
            svc.extract(mod.ImagesInput(data=[b64], max_keypoints=[7]))
            assert svc.api.extractor.conf["max_keypoints"] == 7
            assert svc.api.extractor.conf["keypoint_threshold"] == 0.0
            out = svc.match(files["img0"], files["img1"])
            assert len(out["keypoints0_orig"]) == 7
        finally:
            svc.api.extractor.conf.update(saved)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_main_port_zero_serves_on_the_config_port(tmp_path, pkg):
    """main(port=0) reads ``port or conf[...]``: the 0 falls back to the
    config's http_port instead of a free port."""
    port = chip_smoke.free_port()
    text = (ROOT / "imcui_tpu_torch/config/api.yaml").read_text()
    text = text.replace('host: "0.0.0.0"', 'host: "127.0.0.1"').replace(
        "http_port: 8001", f"http_port: {port}")
    (tmp_path / "api.yaml").write_text(text)
    assert read_yaml(tmp_path / "api.yaml")["service"]["http_port"] == port
    kw = {"device": "cpu"} if pkg == "port" else {}
    mod = tserver if pkg == "port" else jserver
    httpd = mod.main(config_path=tmp_path / "api.yaml", port=0, block=False,
                     **kw)
    try:
        assert httpd.server_address[1] == port
    finally:
        httpd.server_close()


# --------------------------------------------------------------------------
# cli/main.py
# --------------------------------------------------------------------------

def test_cli_version(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == \
        f"imcui-tpu-torch, version {imcui_tpu_torch.__version__}"
    assert imcui_tpu.__version__ in CliRunner().invoke(
        jcli.cli, ["--version"]).output


def test_cli_config_resolution_order_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tcli.get_default_config_path() == \
        ROOT / "imcui_tpu_torch" / "config" / "app.yaml"
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "app.yaml").write_text("server: {}\n")
    (tmp_path / "app.yaml").write_text("server: {name: x, port: 1}\n")
    for name in ("app.yaml", "config/app.yaml"):
        assert tcli.get_default_config_path() == tmp_path / name
        assert jcli.get_default_config_path() == tmp_path / name
        (tmp_path / name).unlink()
    assert read_yaml(tcli.get_default_config_path())["server"]


@pytest.mark.parametrize("argv,what", [
    ([], "gradio"), (["webui"], "gradio"),
    (["train", "lightglue", "--steps", "3"], "A.8"),
])
def test_cli_commands_not_ported_exit_nonzero(capsys, argv, what):
    assert tcli.main(argv) == 2
    assert what in capsys.readouterr().err


def test_cli_eval_without_a_command_exits_as_the_jax_group(capsys):
    """``eval`` is ported: alone it prints its help, which names ``pose``,
    and exits 2, as the JAX package's click group does."""
    from click.testing import CliRunner

    res = CliRunner().invoke(jcli.cli, ["eval"])
    assert tcli.main(["eval"]) == res.exit_code == 2
    err = capsys.readouterr().err
    assert "pose" in err and "pose" in res.output and "A.3" not in err


def test_cli_run_maps_keyboard_interrupt_to_130(monkeypatch):
    def interrupted():
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli, "main", interrupted)
    with pytest.raises(SystemExit) as e:
        tcli.run()
    assert e.value.code == 130


def test_cli_match_writes_the_pickle_with_the_jax_key_set(
        tmp_path, monkeypatch, capsys, files, jax_service):
    """``match`` with the default superpoint+lightglue of the packaged zoo
    on the CPU: the printed line, and a pickle of numpy values with the
    keys of the JAX package's pred dict."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "pred.pkl"
    assert tcli.main(["match", str(files["a"]), str(files["b"]), "-o",
                      str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()
    with open(out, "rb") as f:
        pred = pickle.load(f)
    assert printed[-2] == (f"raw matches: {len(pred['mkeypoints0_orig'])}, "
                           f"ransac inliers: "
                           f"{len(pred['mmkeypoints0_orig'])}")
    assert printed[-1] == f"wrote {out}"
    want = jax_service.api(files["img0"], files["img1"])
    assert set(pred) == set(want)
    assert not any(isinstance(v, torch.Tensor) for v in pred.values())
    assert len(pred["mmkeypoints0_orig"]) > 20


def test_cli_match_ignores_the_group_config_in_both(tmp_path, monkeypatch,
                                                    files):
    """``match`` resolves its zoo from get_default_config_path(), not from
    the group's --config: a zoo given with --config is never read."""
    monkeypatch.chdir(tmp_path)  # no app.yaml: the packaged one
    other = tmp_path / "other.yaml"
    other.write_text("matcher_zoo:\n  only+here:\n    matcher: NN-mutual\n"
                     "    feature: superpoint_1024\n    dense: false\n")
    seen = {}

    def stub(image0, image1, key, matcher_zoo, **kw):
        seen[len(seen)] = (key, set(matcher_zoo))
        return {"mkeypoints0_orig": np.zeros((3, 2)),
                "mmkeypoints0_orig": np.zeros((1, 2))}

    monkeypatch.setattr(tui, "run_matching", stub)
    monkeypatch.setattr(jui, "run_matching", stub)
    args = ["--config", str(other), "match", str(files["a"]),
            str(files["b"]), "--matcher", "superpoint+NN"]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    res = CliRunner().invoke(jcli.cli, args)
    assert res.exit_code == 0, res.output
    assert "raw matches: 3, ransac inliers: 1" in res.output
    for key, zoo in seen.values():
        assert key == "superpoint+NN"
        assert "superpoint+NN" in zoo and "only+here" not in zoo
    assert len(seen) == 2
