"""HTTP matching service. Counterpart of ``imcui_tpu/api/server.py``: the
same routes (``GET /``, ``GET /version``, ``POST /v1/match`` as multipart
or JSON base64, ``POST /v1/extract`` as JSON base64), the same response
shapes, the 404 and the 500 envelope ``{"detail": ...}``.

One process serves on one device (``device="cuda"`` by default; it raises
without a card). ``ImageMatchingAPI`` runs under one lock, so requests
from the threads of the HTTP server are answered one at a time.

Deviations from the JAX package:

- only the standard library's ``ThreadingHTTPServer`` transport: the JAX
  package serves through FastAPI and uvicorn when they import. The
  machine the CPU tests run on has neither, so a FastAPI transport could
  not be held against the JAX one there: ``build_fastapi_app`` is not
  ported yet, and ``main`` always serves the stdlib transport, whatever
  is installed;
- images are decoded by this package's PNG, JPEG and PGM/PPM reader
  (``utils/image.py::decode_image_bytes``), the pixels PIL's
  ``convert("RGB")`` gives (a JPEG's EXIF orientation not applied); a
  format or a JPEG kind it does not read answers 500 with a detail
  naming it.

Kept as the JAX package has them:

- ``main(port=0)`` serves on the config's port, not on a free one: it
  reads ``port or conf["service"]["http_port"]``;
- ``/v1/extract`` writes its ``max_keypoints`` and ``keypoint_threshold``
  into the live extractor's conf (``ImageMatchingAPI.extract``), so later
  ``/v1/match`` requests serve with those values.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from .. import __version__, logger
from ..utils.image import decode_image_bytes
from ..utils.io import read_yaml
from . import ImagesInput, to_base64_nparray
from .core import ImageMatchingAPI

CONF_DIR = Path(__file__).parent.parent / "config"


def load_api_conf(config_path=None):
    """The API config (``config/api.yaml`` of this package by default)."""
    path = Path(config_path) if config_path else CONF_DIR / "api.yaml"
    return read_yaml(path)


class MatchingService:
    """The service core, independent of the transport."""

    def __init__(self, conf=None, config_path=None, device="cuda"):
        if conf is None:
            conf = load_api_conf(config_path)["api"]
        self.conf = conf
        self.api = ImageMatchingAPI(conf=conf, device=device)
        self._lock = threading.Lock()

    def version(self):
        return {"version": __version__}

    def match(self, image0: np.ndarray, image1: np.ndarray):
        with self._lock:
            output = self.api(image0, image1)
        skip_keys = ["image0_orig", "image1_orig"]
        return self.postprocess(output, skip_keys)

    def extract(self, input_images: ImagesInput):
        preds = []
        for i, input_image in enumerate(input_images.data):
            image_array = to_base64_nparray(input_image)
            max_keypoints = (
                input_images.max_keypoints[i]
                if i < len(input_images.max_keypoints) else 512
            )
            with self._lock:
                pred = self.api.extract(
                    image_array,
                    max_keypoints=max_keypoints,
                    binarize=input_images.binarize,
                )
            pred = self.postprocess(pred, ["image", "image_orig"])
            preds.append(pred)
        return preds

    @staticmethod
    def postprocess(output: dict, skip_keys, binarize=True):
        """JSON-ready copy: numpy arrays as lists; ints, floats, strings,
        lists, dicts and None as they are; every other value (tensors and
        numpy scalars among them) dropped, as in the JAX package."""
        pred = {}
        for key, value in output.items():
            if key in skip_keys:
                continue
            if isinstance(value, np.ndarray):
                pred[key] = value.tolist()
            elif isinstance(value, (int, float, str, list, dict,
                                    type(None))):
                pred[key] = value
        return pred


# ---------------------------------------------------------------------------
# stdlib transport
# ---------------------------------------------------------------------------

def _parse_multipart(handler):
    """multipart/form-data body of a request → {field name: bytes}."""
    import email
    import email.policy

    ctype = handler.headers.get("Content-Type", "")
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
        policy=email.policy.HTTP,
    )
    files = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        files[name] = part.get_payload(decode=True)
    return files


def _encode(payload) -> bytes:
    """The JSON body of a response."""
    return json.dumps(payload).encode()


class _Handler(BaseHTTPRequestHandler):
    service: MatchingService = None

    def _send(self, code, payload):
        body = _encode(payload)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        logger.info("HTTP " + fmt % args)

    def do_GET(self):
        if self.path == "/":
            self._send(200, {"message": "OK"})
        elif self.path == "/version":
            self._send(200, self.service.version())
        else:
            self._send(404, {"detail": "Not found"})

    def do_POST(self):
        try:
            if self.path == "/v1/match":
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("multipart/"):
                    files = _parse_multipart(self)
                    image0 = decode_image_bytes(files["image0"],
                                                orientation=False)
                    image1 = decode_image_bytes(files["image1"],
                                                orientation=False)
                else:  # JSON base64
                    length = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(length))
                    image0 = to_base64_nparray(data["image0"])
                    image1 = to_base64_nparray(data["image1"])
                self._send(200, self.service.match(image0, image1))
            elif self.path == "/v1/extract":
                length = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(length))
                inp = ImagesInput(**data)
                self._send(200, self.service.extract(inp))
            else:
                self._send(404, {"detail": "Not found"})
        except Exception as e:  # the 500 JSON envelope; the server goes on
            logger.exception("request failed")
            self._send(500, {"detail": str(e)})


def serve_stdlib(service, host="0.0.0.0", port=8001):
    """A ThreadingHTTPServer bound to (host, port) for ``service``; the
    caller runs ``serve_forever`` and ``shutdown``."""
    handler = type("Handler", (_Handler,), {"service": service})
    httpd = ThreadingHTTPServer((host, port), handler)
    logger.info(f"Serving (stdlib) on http://{host}:{port}")
    return httpd


def main(config_path=None, host=None, port=None, block=True, device="cuda"):
    """Serve the API config's ``api`` conf on ``device``: the stdlib
    transport always (see the module docstring)."""
    conf = load_api_conf(config_path)
    service = MatchingService(conf["api"], device=device)
    host = host or conf.get("service", {}).get("host", "0.0.0.0")
    port = port or int(conf.get("service", {}).get("http_port", 8001))
    httpd = serve_stdlib(service, host, port)
    if block:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    return httpd


if __name__ == "__main__":
    main()
