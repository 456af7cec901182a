"""HTTP API client. Counterpart of ``imcui_tpu/api/client.py``: the same
functions (``get_api_version``, ``send_request_match``,
``send_request_extract``, ``read_image_to_base64``), URL constants and
``REMOTE_URL_RAILWAY`` environment variable, over the standard library's
urllib. Images are read by ``utils/image.py::read_image`` (PNG, JPEG
and PGM/PPM files, a JPEG's EXIF orientation applied as ``cv2.imread``
applies it) and sent as base64 PNG from ``utils/png.py``.

    python -m imcui_tpu_torch.api.client --image0 a.png --image1 b.png \\
        [--url http://127.0.0.1:8001] [--out pred.pkl]
"""

import base64
import json
import os
import pickle
import urllib.request
from pathlib import Path

import numpy as np

from ..utils.image import read_image
from ..utils.png import encode_png

API_VERSION_URL = "{}/version"
API_URL_MATCH = "{}/v1/match"
API_URL_EXTRACT = "{}/v1/extract"

BASE_URL = os.environ.get("REMOTE_URL_RAILWAY", "http://127.0.0.1:8001")


def _post_json(url, payload, timeout=120):
    data = json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def read_image_to_base64(path):
    """An image file as base64 PNG (RGB)."""
    return base64.b64encode(encode_png(read_image(path))).decode("utf-8")


def _lists_to_arrays(pred):
    for k, v in pred.items():
        if isinstance(v, list):
            try:
                pred[k] = np.array(v)
            except ValueError:
                pass
    return pred


def get_api_version(base_url=BASE_URL):
    return _get(API_VERSION_URL.format(base_url))


def send_request_match(path0, path1, base_url=BASE_URL):
    """Match two image files through the JSON base64 route. Returns the
    pred dict with its lists turned back into numpy arrays."""
    payload = {
        "image0": read_image_to_base64(path0),
        "image1": read_image_to_base64(path1),
    }
    return _lists_to_arrays(_post_json(API_URL_MATCH.format(base_url),
                                       payload))


def send_request_extract(image_path, base_url=BASE_URL, binarize=False,
                         max_keypoints=1024):
    """Extract features from one image file or several; one pred dict each,
    lists turned back into numpy arrays."""
    if isinstance(image_path, (str, Path)):
        paths = [image_path]
    else:
        paths = list(image_path)
    payload = {
        "data": [read_image_to_base64(p) for p in paths],
        "max_keypoints": [max_keypoints] * len(paths),
        "timestamps": [str(i) for i in range(len(paths))],
        "grayscale": False,
        "binarize": binarize,
    }
    preds = _post_json(API_URL_EXTRACT.format(base_url), payload)
    return [_lists_to_arrays(pred) for pred in preds]


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--image0", type=str, required=True)
    parser.add_argument("--image1", type=str, required=True)
    parser.add_argument("--url", type=str, default=BASE_URL)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args()
    print(get_api_version(args.url))
    pred = send_request_match(args.image0, args.image1, args.url)
    print({k: getattr(v, "shape", v) for k, v in pred.items()})
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(pred, f)
