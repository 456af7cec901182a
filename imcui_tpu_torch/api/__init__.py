"""HTTP API package: the request schema and the base64 image helpers.
Counterpart of ``imcui_tpu/api/__init__.py``: the same pydantic
``ImagesInput``. Images travel as base64 PNG, JPEG (or PGM/PPM), decoded
by ``utils/image.py::decode_image_bytes`` as PIL's ``convert("RGB")``
decodes them: a JPEG's EXIF orientation is not applied.
"""

import base64
import binascii
from typing import List

import numpy as np
from pydantic import BaseModel

from ..utils.image import decode_image_bytes


class ImagesInput(BaseModel):
    data: List[str] = []
    max_keypoints: List[int] = []
    timestamps: List[str] = []
    grayscale: bool = False
    image_hw: List[List[int]] = [[], []]
    feature_type: int = 0
    rotates: List[float] = []
    scales: List[float] = []
    reference_points: List[List[float]] = []
    binarize: bool = False


def decode_base64_to_image(encoding: str) -> np.ndarray:
    """base64 PNG, JPEG (or PGM/PPM), with or without a
    ``data:image/...;base64,`` prefix → (H, W, 3) RGB uint8, EXIF
    orientation not applied (as PIL's ``convert("RGB")``)."""
    if encoding.startswith("data:image/"):
        encoding = encoding.split(";")[1].split(",")[1]
    try:
        data = base64.b64decode(encoding)
    except binascii.Error as e:
        raise ValueError(f"invalid base64 image: {e}") from None
    return decode_image_bytes(data, orientation=False)


def to_base64_nparray(encoding: str) -> np.ndarray:
    return np.array(decode_base64_to_image(encoding)).astype("uint8")
