"""``imcui_tpu_torch/ops/lsd.py`` against OpenCV's line segment detector
(``cv2.createLineSegmentDetector()`` at its defaults) on the CPU.

Tolerances: the blur and the 0.8 downscale equal ``cv2.GaussianBlur``
and ``cv2.resize(INTER_LINEAR_EXACT)`` on uint8 bit for bit; the
segments come in OpenCV's order, the same count, endpoints within 1e-4
px (they are equal float32 on every image here), widths within 1e-5 px
and precisions within 1e-5. The images: ``chip_smoke.textured_image``,
both views of a planted pair, rectangles, a ramp and stripes (whose
gradients fall into few bins, so ties inside a bin are everywhere), and
sizes whose 0.8 scale rounds.
"""

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from imcui_tpu_torch.ops import lsd


def _rectangles(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30, np.uint8)
    for _ in range(12):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        hh, ww = rng.integers(10, 80, 2)
        img[y0:y0 + hh, x0:x0 + ww] = rng.integers(60, 250)
    return img


def _ramp(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx * 3 + yy) % 256).astype(np.uint8)


def _stripes(h, w):
    xx = np.mgrid[0:h, 0:w][1]
    return (((xx // 20) % 2) * 200 + 20).astype(np.uint8)


def _pair_view(i):
    return chip_smoke.synthetic_pair(100, 320, 240)[i][..., 0]


IMAGES = {
    "textured": lambda: chip_smoke.textured_image(
        np.random.default_rng(0), 240, 320),
    "planted0": lambda: _pair_view(0),
    "planted1": lambda: _pair_view(1),
    "rectangles": lambda: _rectangles(203, 317, 5),
    "ramp": lambda: _ramp(241, 333),
    "stripes": lambda: _stripes(241, 333),
    "odd_101x157": lambda: chip_smoke.textured_image(
        np.random.default_rng(7), 101, 157),
    "odd_77x211": lambda: chip_smoke.textured_image(
        np.random.default_rng(8), 77, 211),
    "tiny_9x9": lambda: chip_smoke.textured_image(
        np.random.default_rng(9), 9, 9),
    "flat": lambda: np.full((50, 50), 128, np.uint8),
}


def _cv2_lines(img):
    lines, widths, precs, nfa = cv2.createLineSegmentDetector().detect(img)
    if lines is None:
        return np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0), nfa
    return lines.reshape(-1, 4), widths.ravel(), precs.ravel(), nfa


@pytest.mark.parametrize("hw", [(240, 320), (101, 157), (77, 211), (9, 9),
                                (3, 5), (1, 7)])
def test_blur_is_cv2_bit_for_bit(hw):
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw, np.uint8)
    want = cv2.GaussianBlur(img, (7, 7), 0.75)
    got = lsd.gaussian_blur_u8(torch.from_numpy(img)).numpy()
    assert lsd.blur_taps() == [0, 4, 56, 136, 56, 4, 0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(240, 320), (101, 157), (77, 211), (9, 9),
                                (5, 6), (199, 33)])
def test_resize_linear_exact_is_cv2_bit_for_bit(hw):
    img = np.random.default_rng(sum(hw) + 1).integers(0, 256, hw, np.uint8)
    want = cv2.resize(img, None, fx=0.8, fy=0.8,
                      interpolation=cv2.INTER_LINEAR_EXACT)
    got = lsd.resize_linear_exact_u8(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == lsd.scaled_size(*hw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_matches_cv2(name):
    img = IMAGES[name]()
    want, wwidth, wprec, nfa = _cv2_lines(img)
    assert nfa is None  # LSD_REFINE_STD: no NFA
    got, width, prec = lsd.detect(torch.from_numpy(img))
    assert got.dtype == np.float32 and got.shape == want.shape
    if len(want):
        assert np.abs(got - want).max() <= 1e-4
        assert np.abs(width - wwidth).max() <= 1e-5
        assert np.abs(prec - wprec).max() <= 1e-5
    if name not in ("flat", "tiny_9x9"):
        assert len(want) >= 4


def test_the_order_inside_a_bin_decides_the_segments(monkeypatch):
    """On the textured image the seeds' order inside a gradient bin moves
    segments: the stable order (OpenCV 5.0's) gives cv2's segments, the
    reverse order inside each bin does not."""
    img = IMAGES["textured"]()
    want = _cv2_lines(img)[0]

    def reversed_ties(bins):
        flat = bins.ravel()
        return len(flat) - 1 - np.argsort(-flat[::-1], kind="stable")

    monkeypatch.setattr(lsd, "seed_order", reversed_ties)
    got = lsd.detect(torch.from_numpy(img))[0]
    same = got.shape == want.shape and np.abs(got - want).max() <= 1e-4
    assert not same
    monkeypatch.undo()
    np.testing.assert_array_equal(lsd.detect(torch.from_numpy(img))[0],
                                  want)


def test_gradient_bins_and_notdef_edges():
    """The last row and column are NOTDEF, the strongest pixel is in bin
    1023, and the seed order is bins descending, row-major among ties."""
    img = torch.from_numpy(IMAGES["rectangles"]())
    angles, sq = lsd.gradient(lsd.resize_linear_exact_u8(
        lsd.gaussian_blur_u8(img)))
    assert (angles[-1] == lsd.NOTDEF).all() and \
        (angles[:, -1] == lsd.NOTDEF).all()
    norm, bins = lsd.norms_and_bins(sq.numpy())
    assert int(bins.max()) == lsd.N_BINS - 1
    assert ((norm > lsd.RHO) == (angles[:-1, :-1] != lsd.NOTDEF).numpy()
            ).all()
    # the integer test equals OpenCV's sqrt(sq / 4) > RHO on every square
    # norm two uint8 differences can make (|gx|, |gy| <= 510)
    s = np.arange(2 * 510 * 510 + 1)
    assert ((np.sqrt(s / 4.0) > lsd.RHO) == (s > lsd.SQ_UNDEF_MAX)).all()
    order = lsd.seed_order(bins)
    b = bins.ravel()[order]
    assert (b[:-1] >= b[1:]).all()
    ties = b[:-1] == b[1:]
    assert (order[:-1][ties] < order[1:][ties]).all()


def test_detect_takes_a_uint8_image_only():
    with pytest.raises(ValueError):
        lsd.detect(torch.zeros(20, 20))
