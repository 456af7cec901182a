"""Host-side image reading and request preprocessing without OpenCV.

Counterpart of ``imcui_tpu/utils/image.py``'s ``read_image``,
``preprocess``, ``load_conf``, ``bucket_size`` and
``keypoints_to_original``. The JAX package reads files, converts to
grayscale and resizes with OpenCV; this module restates them in numpy.
``read_image`` and ``decode_image_bytes`` read PNG (``utils/png.py``),
JPEG (``utils/jpeg.py``: baseline and progressive Huffman, gray or YCbCr,
bit for bit as libjpeg-turbo decodes them) and binary PGM/PPM (P5/P6,
maxval 255); GIF, BMP, TIFF, WebP and JPEG 2000 data, and the JPEG kinds
``utils/jpeg.py`` lists as refused, raise ``ValueError`` naming the
format or the feature. The other restatements: ``to_grayscale`` as ``cv2.cvtColor(...,
COLOR_RGB2GRAY)`` (fixed-point for uint8), ``resize_area`` as
``cv2.resize(..., INTER_AREA)`` for downscaling, each output pixel the
coverage-weighted mean of the source box it spans, and ``resize_linear``
as ``cv2.resize(..., INTER_LINEAR)``. The other OpenCV and PIL
interpolations are not restated and raise ``NotImplementedError``.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .jpeg import SOI as JPEG_SOI
from .jpeg import decode_jpeg, jpeg_size
from .png import SIGNATURE as PNG_SIGNATURE
from .png import decode_png

DEFAULT_BUCKETS = (256, 320, 384, 448, 512, 640, 768, 896, 1024, 1152, 1280,
                   1536, 2048)


def to_grayscale(image):
    """RGB → gray with OpenCV's weights: 0.299 R + 0.587 G + 0.114 B, in
    15-bit fixed point with rounding for uint8 (as cvtColor does)."""
    if image.ndim != 3 or image.shape[2] != 3:
        return image
    if image.dtype == np.uint8:
        rgb = image.astype(np.int32)
        y = (rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735
             + (1 << 14)) >> 15
        return y.astype(np.uint8)
    rgb = image.astype(np.float32)
    return (rgb[..., 0] * np.float32(0.299) + rgb[..., 1] * np.float32(0.587)
            + rgb[..., 2] * np.float32(0.114)).astype(image.dtype)


# leading bytes of the formats this module cannot decode
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"), (b"\x00\x00\x00\x0cjP", "JPEG 2000"))
_PNM_HEADER = re.compile(rb"(P[56])(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+"
                         rb"(\d+)(?:\s|#[^\n]*\n)+(\d+)\s")


def _png_gray(rgb):
    """libpng's RGB → gray, which OpenCV's PNG reader applies for
    IMREAD_GRAYSCALE: coefficients 0.299, 0.587 in 15-bit fixed point,
    truncated (a gray pixel stays itself: the three sum to 2^15)."""
    x = rgb.astype(np.int32)
    return ((x[..., 0] * 9797 + x[..., 1] * 19234 + x[..., 2] * 3737)
            >> 15).astype(np.uint8)


def _pnm_gray(rgb):
    """OpenCV's PGM/PPM reader's RGB → gray: 14-bit fixed point, rounded."""
    x = rgb.astype(np.int32)
    return ((x[..., 0] * 4899 + x[..., 1] * 9617 + x[..., 2] * 1868 + 8192)
            >> 14).astype(np.uint8)


def decode_image_bytes(data, grayscale=False, *, orientation):
    """PNG, JPEG or binary PGM/PPM bytes → (H, W, 3) RGB uint8, or (H, W)
    gray as OpenCV's IMREAD_GRAYSCALE reads the file when ``grayscale``.
    RGB is what PIL's ``convert("RGB")`` gives (alpha dropped, gray
    repeated). ``orientation``: apply a JPEG's EXIF orientation tag, as
    ``cv2.imread`` does (True), or leave the pixels as stored, as PIL's
    ``convert("RGB")`` does (False)."""
    data = bytes(data)
    if data.startswith(JPEG_SOI + b"\xff"):
        return decode_jpeg(data, grayscale, orientation)
    if data.startswith(PNG_SIGNATURE):
        rgb = decode_png(data)
        return _png_gray(rgb) if grayscale else rgb
    m = _PNM_HEADER.match(data)
    if m:
        kind, w, h, maxval = m.group(1), *map(int, m.groups()[1:])
        if maxval != 255:
            raise ValueError(f"PGM/PPM maxval {maxval} is not supported "
                             "(8-bit samples, maxval 255, only)")
        c = 1 if kind == b"P5" else 3
        body = np.frombuffer(data, np.uint8, h * w * c, m.end()) \
            if len(data) >= m.end() + h * w * c else None
        if body is None:
            raise ValueError("truncated PGM/PPM data")
        pix = body.reshape(h, w, c)
        if c == 1:
            return pix[..., 0].copy() if grayscale else np.repeat(pix, 3, -1)
        return _pnm_gray(pix) if grayscale else pix.copy()
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            break
    else:
        name = "RIFF WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP" \
            else None
    if name:
        raise ValueError(f"{name} images cannot be decoded: this package "
                         "reads PNG, JPEG and binary PGM/PPM only")
    raise ValueError("unknown image format (this package reads PNG, JPEG "
                     "and binary PGM/PPM only)")


def read_image(path, grayscale=False):
    """An image file as (H, W, 3) RGB uint8, or (H, W) gray when
    ``grayscale``, as the JAX package's OpenCV reader gives it, for PNG,
    JPEG (its EXIF orientation applied, as ``cv2.imread`` does) and binary
    PGM/PPM files. Other formats raise ``ValueError`` naming the file and
    the format."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise ValueError(f"Cannot read image {path}: {e}") from None
    try:
        return decode_image_bytes(data, grayscale, orientation=True)
    except ValueError as e:
        raise ValueError(f"Cannot read image {path}: {e}") from None


def image_size(path):
    """(width, height) of the image ``read_image`` reads from ``path``: a
    JPEG's from its frame header and EXIF tag, without decoding it."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise ValueError(f"Cannot read image {path}: {e}") from None
    try:
        if data.startswith(JPEG_SOI + b"\xff"):
            return jpeg_size(data)
        h, w = decode_image_bytes(data, orientation=True).shape[:2]
        return w, h
    except ValueError as e:
        raise ValueError(f"Cannot read image {path}: {e}") from None


def _area_taps(src, dst):
    """INTER_AREA's table along one axis for a downscale src → dst, as
    OpenCV's ``computeResizeAreaTab`` builds it: for each output pixel its
    source pixels in ascending order and their float32 weights (the
    partial cells' coverage and the whole cells' 1/cell, computed in
    double and rounded once). Returned as (dst, T) index and weight
    arrays, padded with weight 0 on pixel 0: a float32 sum plus +0 is
    itself."""
    scale = src / dst
    taps = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    t = max(map(len, taps))
    idx = np.zeros((dst, t), np.int64)
    wgt = np.zeros((dst, t), np.float32)
    for d, row in enumerate(taps):
        for k, (s, a) in enumerate(row):
            idx[d, k], wgt[d, k] = s, a
    return idx, wgt


def _area_general(x, size):
    """OpenCV's ``ResizeArea_Invoker`` on float32: each source row summed
    across in tap order (``buf += S·alpha``), then the rows summed down in
    tap order (``sum += beta·buf``), every product and sum rounded to
    float32. Rows are (W·C) wide, channels interleaved, as OpenCV's."""
    h, w, c = x.shape
    (ix, ax), (iy, ay) = _area_taps(w, size[0]), _area_taps(h, size[1])
    ix = (ix[:, None, :] * c + np.arange(c)[None, :, None]).reshape(
        size[0] * c, -1)
    ax = np.repeat(ax, c, axis=0)
    flat = x.reshape(h, w * c)
    rows = np.zeros((h, size[0] * c), np.float32)
    for k in range(ix.shape[1]):
        rows += np.take(flat, ix[:, k], axis=1) * ax[:, k]
    out = np.zeros((size[1], size[0] * c), np.float32)
    for k in range(iy.shape[1]):
        out += ay[:, k, None] * np.take(rows, iy[:, k], axis=0)
    return out.reshape(size[1], size[0], c)


def _area_fast(x, sx, sy):
    """OpenCV's ``resizeAreaFast_`` on float32, for integer factors: each
    cell summed in row-major order, four taps at a time (``sum += ((a + b)
    + c) + d``, then the rest one by one), times (float)1/(sx·sy). At 2 × 2
    its SSE loop sums ``(a + b) + (c + d)`` instead, over the whole row for
    four channels and over the first multiple of four outputs of a row
    for one; three channels take the scalar loop."""
    h, w = x.shape[0] // sy, x.shape[1] // sx
    cells = [x[i::sy, j::sx][:h, :w] for i in range(sy) for j in range(sx)]
    total = np.zeros_like(cells[0])
    for k in range(0, len(cells) - 3, 4):
        total = total + (((cells[k] + cells[k + 1]) + cells[k + 2])
                         + cells[k + 3])
    for k in range(len(cells) - len(cells) % 4, len(cells)):
        total = total + cells[k]
    out = total * np.float32(1.0 / len(cells))
    c = x.shape[2]
    if (sx, sy) == (2, 2) and c in (1, 4):
        simd = ((cells[0] + cells[1]) + (cells[2] + cells[3])) \
            * np.float32(0.25)
        n = w if c == 4 else w - w % 4
        out[:, :n] = simd[:, :n]
    return out


def resize_area(image, size):
    """Area-averaging downscale of an (H, W) or (H, W, C) image to
    ``size`` = (w, h), as ``cv2.resize(image, size, INTER_AREA)`` on
    float32 bit for bit (OpenCV 5.0's x86 build: no IPP for INTER_AREA,
    128-bit SIMD in the 2 × 2 fast path). Integer factors take OpenCV's
    fast path, other sizes its weight tables; any other dtype is
    resized as float32."""
    h, w = image.shape[:2]
    wn, hn = size
    if wn > w or hn > h:
        raise ValueError(f"resize_area only downscales: {(w, h)} → {size}")
    x = np.asarray(image, np.float32)
    x = x[..., None] if x.ndim == 2 else x
    if (wn, hn) == (w, h):
        out = x.copy()
    elif w % wn == 0 and h % hn == 0:
        out = _area_fast(x, w // wn, h // hn)
    else:
        out = _area_general(x, size)
    return out[..., 0] if image.ndim == 2 else out


def _linear_weights(src, dst):
    """(dst, src) matrix of INTER_LINEAR's weights along one axis: output
    pixel d samples the source at (d + 0.5)·src/dst − 0.5, clamped to the
    edge pixels."""
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = x - x0
    w = np.zeros((dst, src), np.float64)
    rows = np.arange(dst)
    np.add.at(w, (rows, np.clip(x0, 0, src - 1)), 1.0 - frac)
    np.add.at(w, (rows, np.clip(x0 + 1, 0, src - 1)), frac)
    return w


def _separable(image, wy, wx):
    out = np.tensordot(wy, image.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(out, wx, axes=(1, 1)), -1, 1)
    return out.astype(np.float32)


def resize_linear(image, size):
    """Bilinear resize of an (H, W) or (H, W, C) float image to ``size`` =
    (w, h), as ``cv2.resize(image, size, INTER_LINEAR)`` (no antialiasing
    when shrinking)."""
    h, w = image.shape[:2]
    return _separable(image, _linear_weights(h, size[1]),
                      _linear_weights(w, size[0]))


def resize_image(image, size, interp="cv2_area"):
    """Resize to ``size`` = (w, h) by interpolation name. ``cv2_area``
    turns into ``cv2_linear`` when either side grows, as in the JAX
    package; any other interpolation needs OpenCV or PIL, which this
    package does not import."""
    h, w = image.shape[:2]
    if interp == "cv2_area" and (w < size[0] or h < size[1]):
        interp = "cv2_linear"
    if interp == "cv2_area":
        return resize_area(image, size)
    if interp == "cv2_linear":
        return resize_linear(image, size)
    package = "PIL" if interp.startswith("pil_") else "cv2"
    raise NotImplementedError(
        f"interpolation {interp!r} needs the {package} package, which the "
        f"port does not use; cv2_area and cv2_linear are restated in numpy")


def bucket_size(h, w, buckets=DEFAULT_BUCKETS):
    """Smallest bucket ≥ each dim; beyond the last, the next multiple of
    128."""
    def up(x):
        for b in buckets:
            if b >= x:
                return b
        return int(-(-x // 128) * 128)

    return up(h), up(w)


def preprocess(image, grayscale=True, resize_max=1024, force_resize=False,
               width=640, height=480, dfactor=8, interpolation="cv2_area",
               buckets=DEFAULT_BUCKETS):
    """Reference-equivalent preprocessing onto a fixed canvas.

    Optional grayscale; downscale so the long edge is ``resize_max``
    (only when that shrinks the image); optional ``force_resize`` to
    (``width``, ``height``); floor each side to a multiple of ``dfactor``
    by an area resize; scale to [0, 1]; zero-pad bottom/right up to a
    shape bucket. Returns image (1, C, Hb, Wb) float32, size (w, h) valid
    inside the canvas, original_size (w, h) and scale = original /
    valid."""
    image = np.asarray(image)
    if grayscale:
        image = to_grayscale(image)
    image = image.astype(np.float32, copy=False)
    size = np.array(image.shape[:2][::-1])  # (w, h)
    if resize_max:
        s = resize_max / max(size)
        if s < 1.0:
            image = resize_image(image, tuple(int(round(x * s)) for x in size),
                                 interpolation)
    if force_resize:
        image = resize_image(image, (width, height), interpolation)
    h, w = image.shape[:2]
    h_new, w_new = (h // dfactor) * dfactor, (w // dfactor) * dfactor
    if (h_new, w_new) != (h, w):
        image = resize_area(image, (w_new, h_new))
        h, w = h_new, w_new
    image = image[None] if image.ndim == 2 else image.transpose(2, 0, 1)
    image = image / 255.0
    hb, wb = bucket_size(h, w, buckets)
    if (hb, wb) != (h, w):
        pad = np.zeros((image.shape[0], hb, wb), np.float32)
        pad[:, :h, :w] = image
        image = pad
    valid = np.array([w, h])
    return {"image": image[None].astype(np.float32), "size": valid,
            "original_size": size,
            "scale": size.astype(np.float64) / valid}


def keypoints_to_original(kpts, scale):
    """Model-resolution keypoints → original resolution with the
    half-pixel-centre convention ``(kp + 0.5) * scale - 0.5``."""
    return (np.asarray(kpts) + 0.5) * np.asarray(scale) - 0.5


def load_conf(conf):
    """dict → attribute namespace with ``preprocess``'s defaults applied."""
    defaults = {
        "grayscale": True,
        "resize_max": 1024,
        "force_resize": False,
        "width": 640,
        "height": 480,
        "dfactor": 8,
        "interpolation": "cv2_area",
    }
    return SimpleNamespace(**{**defaults, **(conf or {})})
