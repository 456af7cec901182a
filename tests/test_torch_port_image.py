"""The port's cv2-free preprocessing (imcui_tpu_torch/utils/image.py)
against OpenCV and the JAX package's preprocess. Tolerances: the area
resize bit for bit on float32 (the port restates OpenCV's weight tables,
its 2 × 2 SIMD sums and its float32 accumulation order), 1e-5 on the 0–1
canvas."""

import numpy as np
import pytest

from imcui_tpu.utils import image as jimage
from imcui_tpu_torch.utils import image as timage

cv2 = pytest.importorskip("cv2")


# (h, w) → (h, w): the API's sizes (the dfactor floor of a 200 x 150
# image, the 1024 side of a 1600 x 1200 one, an odd image to 448), integer
# factors (2 x 2 with and without a SIMD tail, 3 x 3, 1 x 2) and odd sizes
@pytest.mark.parametrize("src,dst", [((757, 1003), (752, 1000)),
                                     ((901, 1203), (767, 1024)),
                                     ((100, 120), (37, 61)),
                                     ((64, 96), (32, 48)),
                                     ((150, 200), (144, 200)),
                                     ((1200, 1600), (768, 1024)),
                                     ((451, 601), (336, 448)),
                                     ((480, 640), (240, 320)),
                                     ((480, 642), (240, 321)),
                                     ((99, 99), (33, 33)),
                                     ((300, 200), (150, 200)),
                                     ((97, 131), (31, 45))])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_matches_cv2(src, dst, channels):
    rng = np.random.default_rng(0)
    shape = src + ((channels,) if channels else ())
    img = (rng.uniform(0, 255, shape)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = timage.resize_area(img, dst[::-1])
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_grayscale_matches_cv2(dtype):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (40, 50, 3)).astype(dtype)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    got = timage.to_grayscale(img)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=1e-3)


@pytest.mark.parametrize("hw", [(757, 1003), (1013, 997), (901, 1203),
                                (100, 120)])
def test_preprocess_matches_jax(hw):
    rng = np.random.default_rng(2)
    img = (rng.uniform(0, 255, hw + (3,))).astype(np.uint8)
    want = jimage.preprocess(img, grayscale=True, resize_max=1024, dfactor=8,
                             buckets=(1024,))
    got = timage.preprocess(img, grayscale=True, resize_max=1024, dfactor=8,
                            buckets=(1024,))
    for k in ("size", "original_size", "scale"):
        np.testing.assert_array_equal(got[k], want[k], k)
    assert got["image"].shape == want["image"].shape
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-5)
    assert timage.bucket_size(*hw) == jimage.bucket_size(*hw)
    kp = rng.uniform(0, 500, (10, 2))
    np.testing.assert_array_equal(
        timage.keypoints_to_original(kp, want["scale"]),
        jimage.keypoints_to_original(kp, want["scale"]))
