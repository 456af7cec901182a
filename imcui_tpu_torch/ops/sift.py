"""SIFT on tensors: a restatement of OpenCV 5.0's ``cv::SIFT`` (the
``sift.simd.hpp`` algorithm at 3 layers an octave, sigma 1.6, first octave
-1), so that SIFT and DoG run on the card without OpenCV.

The JAX package calls ``cv2.SIFT_create(...).detectAndCompute`` on the
host (``imcui_tpu/models/extractors/sift.py``, ``dog.py``); this module
computes the same keypoints and descriptors with batched tensor stages:

(a) the base: the uint8 image as float, doubled by bilinear interpolation
    (edges clamped; every tap is exact in float32 at x2), blurred with
    sigma sqrt(max(1.6^2 - 4 * 0.5^2, 0.01));
(b) octaves: cvRound(log2(min side of the base) - 2) + 1 of them, six
    Gaussian layers each at the incremental sigmas, ``cvRound(8 sigma +
    1) | 1`` taps, BORDER_REFLECT_101 folded as often as a small octave
    needs. The row pass is a running fused multiply-add in tap order and
    the column pass adds the mirrored taps first, as OpenCV's filter
    engine does (``_fma`` rounds each step once); octaves too small to
    hold a candidate (a side of 10 or less) are left out, which is exact
    because each later octave is smaller;
(c) the next octave's base: ``cv2.resize(INTER_NEAREST)`` of layer 3 to
    (w // 2, h // 2), source index floor(x * w / (w // 2));
(d) the DoG layers and the candidates: |v| > floor(0.5 * contrast / 3 *
    255) (0 at the thresholds the zoo uses), v at least every one of its
    26 neighbours where v > 0 or at most every one where v < 0 (ties
    count), inside a border of 5, on layers 1-3;
(e) refinement of every candidate at once, at most 5 steps: the 3 x 3
    Hessian solve by Cramer's rule in float32 (OpenCV's ``Matx``
    3 x 3 solve; a zero determinant gives a zero step), shifts rounded
    half to even, rejection where a step leaves the border or the layer
    range, then the contrast test |contr| * 3 < contrast and the edge
    test det <= 0 or tr^2 r >= (r + 1)^2 det;
(f) orientation: a 36-bin histogram over radius cvRound(4.5 s), Gaussian
    weight of sigma 1.5 s, angles from OpenCV's ``fastAtan2`` polynomial
    (``fast_atan2``), smoothed circularly by [1, 4, 6, 4, 1] / 16; every
    peak above both neighbours and at least 0.8 of the maximum gives a
    keypoint at the parabolically interpolated angle 360 - 10 bin;
(g) the points and sizes halved (first octave -1), duplicates removed
    (two candidates that refine to the same sample give the same
    keypoints: ``removeDuplicatedSorted``), and ``retainBest(n)``, which
    keeps every keypoint whose response ties the n-th;
(h) the descriptor: 4 x 4 cells of 8 bins over a window of width 3 s a
    cell, rotated by the keypoint's angle, trilinear votes with Gaussian
    weight exp(-(x^2 + y^2) / (0.5 d^2)), clipped at 0.2 of the norm,
    scaled by 512 / norm and rounded and saturated to integers 0..255.

Deviations from OpenCV that remain (pinned by
``tests/test_torch_port_sift.py``): OpenCV's SIMD code contracts some
products and sums into fused multiply-adds and sums histograms in its own
order, and its ``exp``, ``sqrt`` and ``cos`` are its own; so a value can
differ in its last bits, which can move a candidate across a tie, a
refined offset across a rounding edge, or a descriptor entry by one
step. On textured images the keypoint sets agree to an IoU of at least
0.95 within 0.01 px, sizes to 1e-4, angles to 0.1 degree. OpenCV orders
the keypoints it returns by no rule; the caller sorts by response, and
keypoints that tie are compared as sets.

Host synchronisations a view, nine whatever the size of the image
(``chip_smoke.py`` phase 11 counts them on the card): the two tables of
the pyramid (``Flat``) and the candidates' one, each a small
host-to-device copy, the candidates' ``nonzero``, the refined
keypoints' ``nonzero`` and ``unique``, the orientation peaks'
``nonzero``, ``retain_best``'s ``nonzero`` and one read of the
descriptor radii to group the windows. Everything between runs on the
device of the image.
"""

import math

import torch
import torch.nn.functional as F

N_LAYERS = 3
SIGMA = 1.6
INIT_SIGMA = 0.5
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 4.5
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
FLT_EPSILON = 1.1920928955078125e-07
# the most samples (keypoints x window pixels) one step of the
# orientation or descriptor stage holds at once
WINDOW_BUDGET = 1 << 23


def f32(x):
    """x rounded to the nearest float32, as a Python float (the value of a
    C++ ``float`` constant)."""
    return torch.tensor(x, dtype=torch.float32).item()


IMG_SCALE = f32(1.0 / 255.0)
DERIV_SCALE = f32(IMG_SCALE * 0.5)
CROSS_SCALE = f32(IMG_SCALE * 0.25)
# OpenCV's hal::fastAtan2 in degrees: c (0.9997878, -0.3258084, 0.1555787,
# -0.0443266), each float32 constant times (float)(180 / pi)
_DEG = f32(180.0 / math.pi)
ATAN_P = [f32(f32(c) * _DEG) for c in (0.9997878412794807,
                                      -0.3258083974640975,
                                      0.1555786518463281,
                                      -0.04432655554792128)]
_DBL_EPS = f32(2.220446049250313e-16)


def _fma(acc, k, x64):
    """acc + k * x in float32, rounded once (a fused multiply-add), with x
    given in float64: the product of two float32 values is exact in
    float64 (one kernel computes the sum in float64, a second rounds
    it)."""
    return torch.add(acc, x64, alpha=k).float()


def fma(a, b, c):
    """a * b + c rounded once to float32, elementwise (the product of two
    float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def fast_atan2(y, x):
    """OpenCV's ``fastAtan2`` in degrees, [0, 360), elementwise in
    float32: a degree-7 polynomial in min(|x|, |y|) / max(|x|, |y|)."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + _DBL_EPS)
    c2 = c * c
    p1, p3, p5, p7 = ATAN_P
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def to_gray8(image):
    """The JAX package's uint8 image, as float32 integers 0..255: image
    (C, H, W) in [0, 1], its one channel or the channel mean (not cv2's
    grey weights), times 255, clipped and truncated."""
    img = image[0] if image.shape[0] == 1 else sum(image.unbind(0)) / float(
        image.shape[0])
    return (img * 255.0).clamp(0.0, 255.0).floor()


def upsample2x(img):
    """``cv2.resize(INTER_LINEAR)`` to twice the size of (H, W): weights
    1/4 and 3/4, the edge rows and columns clamped."""
    return F.interpolate(img[None, None], scale_factor=2, mode="bilinear",
                         align_corners=False)[0, 0]


def halve_nearest(img):
    """``cv2.resize(INTER_NEAREST)`` of (H, W) to (H // 2, W // 2): source
    index floor(x * n / (n // 2)), computed in double as OpenCV does."""
    def idx(n):
        m = n // 2
        i = torch.arange(m, dtype=torch.float64, device=img.device)
        return torch.floor(i * (1.0 / (m / n))).long().clamp_max(n - 1)

    h, w = img.shape[-2:]
    return img.index_select(-2, idx(h)).index_select(-1, idx(w))


def gaussian_kernel(sigma):
    """OpenCV's float32 Gaussian kernel of ``cvRound(8 sigma + 1) | 1``
    taps (``getGaussianKernel``'s bit-exact recipe: the centre tap is one
    minus the others), as Python floats."""
    n = int(round(sigma * 8 + 1)) | 1
    half = (n - 1) // 2
    scale2 = -0.5 * 0.25 / (sigma * sigma)
    vals = [math.exp(float(x * x) * scale2) for x in range(1 - n, 0, 2)]
    mul = 1.0 / (2.0 * sum(vals) + 1.0)
    vals = [v * mul for v in vals]
    centre = 1.0 - 2.0 * sum(vals)
    half_k = vals + [centre]
    return [f32(v) for v in half_k + half_k[:half][::-1]]


def reflect101(n, lo, hi, device):
    """Indices lo..hi-1 folded into 0..n-1 by BORDER_REFLECT_101, as
    often as the range needs (cv::borderInterpolate)."""
    idx = torch.arange(lo, hi, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    p = 2 * (n - 1)
    idx = torch.remainder(idx, p)
    return torch.where(idx >= n, p - idx, idx)


def _vector_columns(w, widths):
    """How many leading columns OpenCV's SIMD loops cover, the loop steps
    ``widths`` taken in turn (8 floats, then 4); the rest are scalar."""
    n = 0
    for v in widths:
        n += (w - n) // v * v
    return n


def gaussian_blur(img, sigma):
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of float32 (..., H, W)
    with BORDER_REFLECT_101, bit for bit as OpenCV 5.0's filter engine
    on an AVX2 host: the row pass a running sum over the taps in order,
    the column pass from the centre tap outwards with each mirrored pair
    added before it is weighted; each step a fused multiply-add in the
    columns its SIMD loops cover (8 then 4 floats a step in the row pass,
    8 in the column pass) and a product and a sum, rounded apart, in the
    scalar tail."""
    k = gaussian_kernel(sigma)
    r = len(k) // 2
    h, w = img.shape[-2:]
    xp = img.index_select(-1, reflect101(w, -r, w + r, img.device))
    xp64 = xp.double()
    acc = torch.zeros_like(img)
    for j, kj in enumerate(k):
        acc = _fma(acc, kj, xp64[..., j:j + w])
    v = _vector_columns(w, (8, 4))
    if v < w:
        tail = torch.zeros_like(acc[..., v:])
        for j, kj in enumerate(k):
            tail = tail + xp[..., v + j:j + w] * kj
        acc[..., v:] = tail
    yp = acc.index_select(-2, reflect101(h, -r, h + r, img.device))

    def pair(j):
        return yp[..., r + j:r + j + h, :] + yp[..., r - j:r - j + h, :]

    out = yp[..., r:r + h, :] * k[r]
    v = _vector_columns(w, (8,))
    tail = out[..., v:].clone()
    for j in range(1, r + 1):
        p = pair(j)
        out = _fma(out, k[r + j], p.double())
        if v < w:
            tail = tail + p[..., v:] * k[r + j]
    out[..., v:] = tail
    return out


def layer_sigmas(n_layers=N_LAYERS, sigma=SIGMA):
    """The incremental sigmas of an octave's layers 1..n_layers + 2."""
    k = 2.0 ** (1.0 / n_layers)
    sig = []
    for i in range(1, n_layers + 3):
        prev = k ** (i - 1) * sigma
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def n_octaves(h, w):
    """OpenCV's octave count for an (h, w) image at first octave -1."""
    return int(round(math.log(min(2 * h, 2 * w)) / math.log(2.0) - 2)) + 1


def base_sigma(sigma=SIGMA):
    """The blur of the doubled image: sqrt(max(sigma^2 - 4 * 0.5^2,
    0.01)), in float32, as OpenCV computes it from (float)sigma."""
    s = torch.tensor(sigma, dtype=torch.float32)
    return torch.sqrt(torch.clamp_min(s * s - INIT_SIGMA * INIT_SIGMA * 4,
                                      f32(0.01))).item()


def base_image(gray8, sigma=SIGMA):
    """(a): the doubled, blurred base of the pyramid."""
    return gaussian_blur(upsample2x(gray8), base_sigma(sigma))


def build_pyramids(gray8, n_layers=N_LAYERS, sigma=SIGMA):
    """(a)-(c): the Gaussian pyramid, one (n_layers + 3, h, w) stack an
    octave that can hold a candidate, and the DoG stacks
    (n_layers + 2, h, w)."""
    h, w = gray8.shape
    sig = layer_sigmas(n_layers, sigma)
    gauss, dogs = [], []
    g0 = base_image(gray8, sigma)
    for o in range(n_octaves(h, w)):
        if o:
            g0 = halve_nearest(gauss[-1][n_layers])
        if min(g0.shape) <= 2 * IMG_BORDER:
            break  # no candidate here or in any smaller octave
        layers = [g0]
        for s in sig:
            layers.append(gaussian_blur(layers[-1], s))
        stack = torch.stack(layers)
        gauss.append(stack)
        dogs.append(stack[1:] - stack[:-1])
    return gauss, dogs


class Flat:
    """Stacks of different sizes in one flat buffer, addressed by
    (octave, layer, row, column) tensors."""

    def __init__(self, stacks):
        self.buf = torch.cat([s.reshape(-1) for s in stacks])
        off = [0]
        for st in stacks[:-1]:
            off.append(off[-1] + st.numel())
        # one host-to-device copy for the three tables
        self.off, self.h, self.w = torch.tensor(
            [off, [st.shape[1] for st in stacks],
             [st.shape[2] for st in stacks]], device=stacks[0].device)

    def index(self, o, layer, r, c):
        h, w = self.h[o], self.w[o]
        return self.off[o] + (layer * h + r) * w + c

    def at(self, o, layer, r, c):
        return self.buf[self.index(o, layer, r, c)]


def find_candidates(dogs, contrast_threshold, n_layers=N_LAYERS):
    """(d): (octave, layer, row, column) of every candidate, as int64
    tensors. One host synchronisation (the ``nonzero``)."""
    thr = math.floor(0.5 * contrast_threshold / n_layers * 255)
    masks, shapes = [], []
    for d in dogs:
        _, h, w = d.shape
        # the 3 x 3 x 3 extremes, as the 3 x 3 extremes of each layer
        # taken over three neighbouring layers (exact: a max of maxima)
        mx2, mn2 = F.max_pool2d(d, 3, stride=1), -F.max_pool2d(-d, 3,
                                                               stride=1)
        mx = torch.maximum(torch.maximum(mx2[:-2], mx2[1:-1]), mx2[2:])
        mn = torch.minimum(torch.minimum(mn2[:-2], mn2[1:-1]), mn2[2:])
        b = IMG_BORDER
        v = d[1:n_layers + 1, b:h - b, b:w - b]
        mx = mx[:, b - 1:h - b - 1, b - 1:w - b - 1]
        mn = mn[:, b - 1:h - b - 1, b - 1:w - b - 1]
        m = (v.abs() > thr) & torch.where(v > 0, v >= mx, v <= mn)
        masks.append(m.reshape(-1))
        shapes.append((h - 2 * b, w - 2 * b))
    idx = torch.cat(masks).nonzero()[:, 0]
    sizes, hh, ww = torch.tensor(  # one host-to-device copy
        [[n_layers * a * b for a, b in shapes], [a for a, _ in shapes],
         [b for _, b in shapes]], device=dogs[0].device)
    ends = sizes.cumsum(0)
    o = torch.searchsorted(ends, idx, right=True)
    local = idx - (ends - sizes)[o]
    hh, ww = hh[o], ww[o]
    layer = local // (hh * ww) + 1
    rc = local % (hh * ww)
    return o, layer, rc // ww + IMG_BORDER, rc % ww + IMG_BORDER


def _derivatives(dog, o, layer, r, c):
    """The DoG value, gradient and Hessian at integer samples, in
    float32 with OpenCV's scales and operation order."""
    def at(dl, dr, dc):
        return dog.at(o, layer + dl, r + dr, c + dc)

    v = at(0, 0, 0)
    grad = ((at(0, 0, 1) - at(0, 0, -1)) * DERIV_SCALE,
            (at(0, 1, 0) - at(0, -1, 0)) * DERIV_SCALE,
            (at(1, 0, 0) - at(-1, 0, 0)) * DERIV_SCALE)
    v2 = v * 2.0
    dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * IMG_SCALE
    dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * IMG_SCALE
    dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * IMG_SCALE
    dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) \
        * CROSS_SCALE
    dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) \
        * CROSS_SCALE
    dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) \
        * CROSS_SCALE
    return v, grad, (dxx, dyy, dss, dxy, dxs, dys)


def _minor(a, b, c, d):
    """a * b - c * d as OpenCV's build contracts it: the first product
    fused, the second rounded."""
    return fma(a, b, -(c * d))


def _solve3(hess, b):
    """x with H x = b for the symmetric 3 x 3 H, by Cramer's rule in
    float32 as OpenCV's ``Matx`` solve (a zero determinant gives 0), with
    the fused multiply-adds its AVX2 build makes of each a * b - c * d
    and of each sum of a product: the rounding of the 2 x 2 minors, which
    cancel, moves the offsets by up to ~1e-4 otherwise."""
    dxx, dyy, dss, dxy, dxs, dys = hess
    a00, a01, a02 = dxx, dxy, dxs
    a10, a11, a12 = dxy, dyy, dys
    a20, a21, a22 = dxs, dys, dss
    b0, b1, b2 = b

    def cofactor_sum(p, m0, q, m1, r, m2):
        # p m0 - q m1 + r m2
        return fma(r, m2, fma(p, m0, -(q * m1)))

    det = cofactor_sum(a00, _minor(a11, a22, a21, a12),
                       a01, _minor(a10, a22, a20, a12),
                       a02, _minor(a10, a21, a20, a11))
    ok = det != 0
    d = 1.0 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * cofactor_sum(b0, _minor(a11, a22, a12, a21),
                          a01, _minor(b1, a22, a12, b2),
                          a02, _minor(b1, a21, a11, b2))
    x1 = d * cofactor_sum(a00, _minor(b1, a22, a12, b2),
                          b0, _minor(a10, a22, a12, a20),
                          a02, _minor(a10, b2, b1, a20))
    x2 = d * cofactor_sum(a00, _minor(a11, b2, b1, a21),
                          a01, _minor(a10, b2, b1, a20),
                          b0, _minor(a10, a21, a11, a20))
    zero = torch.zeros_like(det)
    return (torch.where(ok, x0, zero), torch.where(ok, x1, zero),
            torch.where(ok, x2, zero))


def refine(dog, cand, contrast_threshold, edge_threshold,
           n_layers=N_LAYERS, sigma=SIGMA):
    """(e): the candidates that survive refinement, as a dict of
    tensors: octave, layer, r, c (the final integer sample), the offsets
    xc, xr, xi, the point and size at the octave's scale times 2^octave
    (OpenCV's before the first octave's halving) and the response."""
    o, layer, r, c = cand
    alive = torch.ones_like(o, dtype=torch.bool)
    done = torch.zeros_like(alive)
    zero = torch.zeros(o.shape, dtype=torch.float32, device=o.device)
    xc, xr, xi = zero, zero, zero
    for _ in range(MAX_INTERP_STEPS):
        _, grad, hess = _derivatives(dog, o, layer, r, c)
        x0, x1, x2 = _solve3(hess, grad)
        sc, sr, si = -x0, -x1, -x2
        step = alive & ~done
        conv = step & (si.abs() < 0.5) & (sr.abs() < 0.5) & (sc.abs() < 0.5)
        xc = torch.where(conv, sc, xc)
        xr = torch.where(conv, sr, xr)
        xi = torch.where(conv, si, xi)
        done = done | conv
        move = step & ~conv
        big = f32(2147483647 // 3)
        # OpenCV's cvRound of a NaN lands out of bounds: rejected too
        huge = ~((si.abs() <= big) & (sr.abs() <= big) & (sc.abs() <= big))
        alive = alive & ~(move & huge)
        move = move & ~huge
        nc = c + torch.round(sc).long().where(move, torch.zeros_like(c))
        nr = r + torch.round(sr).long().where(move, torch.zeros_like(r))
        nl = layer + torch.round(si).long().where(move, torch.zeros_like(r))
        h, w = dog.h[o], dog.w[o]
        out = (nl < 1) | (nl > n_layers) | (nc < IMG_BORDER) \
            | (nc >= w - IMG_BORDER) | (nr < IMG_BORDER) \
            | (nr >= h - IMG_BORDER)
        alive = alive & ~(move & out)
        keep = move & ~out
        c = torch.where(keep, nc, c)
        r = torch.where(keep, nr, r)
        layer = torch.where(keep, nl, layer)
    alive = alive & done
    v, grad, (dxx, dyy, _, dxy, _, _) = _derivatives(dog, o, layer, r, c)
    t = fma(grad[2], xi, fma(grad[1], xr, grad[0] * xc))
    contr = fma(v, torch.full_like(v, IMG_SCALE), t * 0.5)
    alive = alive & ~(contr.abs() * float(n_layers) < f32(contrast_threshold))
    tr = dxx + dyy
    det = _minor(dxx, dyy, dxy, dxy)
    e = f32(edge_threshold)
    alive = alive & (det > 0) & ~(tr * tr * e >= f32((e + 1) * (e + 1)) * det)
    keep = alive.nonzero()[:, 0]
    kp = {"octave": o[keep], "layer": layer[keep], "r": r[keep],
          "c": c[keep], "xc": xc[keep], "xr": xr[keep], "xi": xi[keep],
          "response": contr[keep].abs()}
    scale = (2 ** kp["octave"]).float()
    kp["x"] = (kp["c"].float() + kp["xc"]) * scale
    kp["y"] = (kp["r"].float() + kp["xr"]) * scale
    kp["size"] = f32(sigma) * torch.pow(
        2.0, (kp["layer"].float() + kp["xi"]) / float(n_layers)) * scale * 2.0
    return _unique_samples(kp, dog)


def _unique_samples(kp, dog):
    """One keypoint a final sample: candidates that refine to the same
    (octave, layer, row, column) are the same keypoint in every field, so
    OpenCV's ``removeDuplicatedSorted`` keeps one of them."""
    key = dog.index(kp["octave"], kp["layer"], kp["r"], kp["c"])
    uniq, inv = torch.unique(key, return_inverse=True)
    first = torch.full_like(uniq, key.numel()).scatter_reduce_(
        0, inv, torch.arange(key.numel(), device=key.device), "amin")
    return {k: v[first] for k, v in kp.items()}


def _windows(n, budget_radius):
    """Keypoint chunks of a stage whose windows are (2R + 1)^2."""
    per = max(1, WINDOW_BUDGET // (2 * budget_radius + 1) ** 2)
    return [(s, min(s + per, n)) for s in range(0, n, per)]


def orientations(gauss, kp, n_layers=N_LAYERS):
    """(f): every keypoint of ``kp`` once per orientation peak, with its
    ``angle`` in degrees (OpenCV's convention, 360 - the gradient
    angle)."""
    scl = kp["size"] * 0.5 / (2 ** kp["octave"]).float()
    radius = torch.round(scl * ORI_RADIUS).long()
    sig = scl * ORI_SIG_FCTR
    expf_scale = -1.0 / (sig * 2.0 * sig)
    n = ORI_HIST_BINS
    # the largest radius any keypoint can have: layer + xi < n_layers + 0.5
    rmax = int(round(ORI_RADIUS * f32(SIGMA * 2 ** ((n_layers + 0.5)
                                                    / n_layers))))
    hists = []
    for s, e in _windows(len(radius), rmax):
        hists.append(_orientation_hist(
            gauss, kp["octave"][s:e], kp["layer"][s:e], kp["r"][s:e],
            kp["c"][s:e], radius[s:e], expf_scale[s:e], rmax, n))
    hist = torch.cat(hists) if hists else torch.zeros(
        (0, n), device=scl.device)
    omax = hist.amax(1, keepdim=True) if len(hist) else hist[:, :1]
    left, right = hist.roll(1, 1), hist.roll(-1, 1)
    peak = (hist > left) & (hist > right) & (hist >= omax * ORI_PEAK_RATIO)
    k, j = peak.nonzero().unbind(1)
    hl, hj, hr = left[k, j], hist[k, j], right[k, j]
    b = j.float() + (0.5 * (hl - hr)) / (hl - 2 * hj + hr)
    b = torch.where(b < 0, n + b, torch.where(b >= n, b - n, b))
    angle = 360.0 - (360.0 / n) * b
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON,
                        torch.zeros_like(angle), angle)
    out = {key: v[k] for key, v in kp.items()}
    out["angle"] = angle
    return out


def _orientation_hist(gauss, o, layer, r, c, radius, expf_scale, rmax, n):
    """The smoothed 36-bin histograms of one chunk of keypoints."""
    dev = r.device
    d = torch.arange(-rmax, rmax + 1, device=dev)
    di, dj = d.view(1, -1, 1), d.view(1, 1, -1)
    rad = radius.view(-1, 1, 1)
    h, w = gauss.h[o].view(-1, 1, 1), gauss.w[o].view(-1, 1, 1)
    y, x = r.view(-1, 1, 1) + di, c.view(-1, 1, 1) + dj
    ok = (di.abs() <= rad) & (dj.abs() <= rad) & (y > 0) & (y < h - 1) \
        & (x > 0) & (x < w - 1)
    y, x = torch.where(ok, y, 1), torch.where(ok, x, 1)
    o3, l3 = o.view(-1, 1, 1), layer.view(-1, 1, 1)
    dx = gauss.at(o3, l3, y, x + 1) - gauss.at(o3, l3, y, x - 1)
    dy = gauss.at(o3, l3, y - 1, x) - gauss.at(o3, l3, y + 1, x)
    wgt = torch.exp((di * di + dj * dj).float() * expf_scale.view(-1, 1, 1))
    ori = fast_atan2(dy, dx)
    mag = torch.sqrt(dx * dx + dy * dy)
    b = torch.round(ori * f32(n / 360.0)).long()
    b = torch.where(b >= n, b - n, b)
    b = torch.where(b < 0, b + n, b)
    row = torch.arange(len(r), device=dev).view(-1, 1, 1) * n
    # a sample outside the window or the image votes 0 into bin 0
    vote = torch.where(ok, wgt * mag, 0.0)
    temp = torch.zeros(len(r) * n, device=dev).index_add_(
        0, (row + torch.where(ok, b, 0)).reshape(-1),
        vote.reshape(-1)).view(-1, n)
    return ((temp.roll(2, 1) + temp.roll(-2, 1)) * (1.0 / 16.0)
            + (temp.roll(1, 1) + temp.roll(-1, 1)) * (4.0 / 16.0)
            + temp * (6.0 / 16.0))


def retain_best(kp, n):
    """``KeyPointsFilter::retainBest``: with more than n keypoints, every
    keypoint whose response is at least the n-th largest."""
    m = len(kp["response"])
    if n <= 0 or m <= n:
        return kp
    thr = torch.topk(kp["response"], n).values[-1]
    keep = (kp["response"] >= thr).nonzero()[:, 0]
    return {k: v[keep] for k, v in kp.items()}


def _descriptor_chunk(gauss, kp, hist_width, radius, rmax):
    d, n = DESCR_WIDTH, DESCR_HIST_BINS
    dev = radius.device
    m = len(radius)
    ptx = kp["c"].float() + kp["xc"]
    pty = kp["r"].float() + kp["xr"]
    px, py = torch.round(ptx).long(), torch.round(pty).long()
    ori = 360.0 - kp["angle"]
    ori = torch.where((ori - 360.0).abs() < FLT_EPSILON,
                      torch.zeros_like(ori), ori)
    rad_ori = ori * f32(math.pi / 180)
    cos_t = (torch.cos(rad_ori) / hist_width).view(-1, 1, 1)
    sin_t = (torch.sin(rad_ori) / hist_width).view(-1, 1, 1)
    g = torch.arange(-rmax, rmax + 1, device=dev)
    i, j = g.view(1, -1, 1), g.view(1, 1, -1)
    fi, fj = i.float(), j.float()
    c_rot = fj * cos_t - fi * sin_t
    r_rot = fj * sin_t + fi * cos_t
    rbin = (r_rot + d // 2) - 0.5
    cbin = (c_rot + d // 2) - 0.5
    o3, l3 = kp["octave"].view(-1, 1, 1), kp["layer"].view(-1, 1, 1)
    h, w = gauss.h[o3], gauss.w[o3]
    y, x = py.view(-1, 1, 1) + i, px.view(-1, 1, 1) + j
    rad = radius.view(-1, 1, 1)
    ok = (i.abs() <= rad) & (j.abs() <= rad) & (rbin > -1) & (rbin < d) \
        & (cbin > -1) & (cbin < d) & (y > 0) & (y < h - 1) & (x > 0) \
        & (x < w - 1)
    y, x = torch.where(ok, y, 1), torch.where(ok, x, 1)
    dx = gauss.at(o3, l3, y, x + 1) - gauss.at(o3, l3, y, x - 1)
    dy = gauss.at(o3, l3, y - 1, x) - gauss.at(o3, l3, y + 1, x)
    wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
    kk = torch.arange(m, device=dev).view(-1, 1, 1).expand_as(ok)
    # a sample outside the window or the image votes 0 into cell (0, 0)
    rbin = torch.where(ok, rbin, 0.0)
    cbin = torch.where(ok, cbin, 0.0)
    obin = (fast_atan2(dy, dx) - ori.view(-1, 1, 1)) * f32(n / 360.0)
    obin = torch.where(ok, obin, 0.0)
    mag = torch.where(ok, torch.sqrt(dx * dx + dy * dy) * wgt, 0.0)
    r0, c0, o0 = rbin.floor(), cbin.floor(), obin.floor()
    rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
    r0, c0, o0 = r0.long(), c0.long(), o0.long()
    o0 = torch.where(o0 < 0, o0 + n, torch.where(o0 >= n, o0 - n, o0))
    v_r1 = mag * rbin
    v_r0 = mag - v_r1
    v_rc11 = v_r1 * cbin
    v_rc10 = v_r1 - v_rc11
    v_rc01 = v_r0 * cbin
    v_rc00 = v_r0 - v_rc01
    votes = []
    for v in (v_rc00, v_rc01, v_rc10, v_rc11):
        v1 = v * obin
        votes += [v - v1, v1]
    # the eight corners in OpenCV's order: (r, c, o) in
    # 000 001 010 011 100 101 110 111
    nb = (d + 2) * (d + 2) * (n + 2)
    base = kk * nb + ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0
    offs = [0, 1, n + 2, n + 3, (d + 2) * (n + 2), (d + 2) * (n + 2) + 1,
            (d + 3) * (n + 2), (d + 3) * (n + 2) + 1]
    hist = torch.zeros(m * nb, device=dev).index_add_(
        0, torch.cat([(base + off).reshape(-1) for off in offs]),
        torch.cat([v.reshape(-1) for v in votes]))
    hist = hist.view(m, d + 2, d + 2, n + 2)[:, 1:d + 1, 1:d + 1]
    raw = hist[..., :n].clone()
    raw[..., 0] += hist[..., n]
    raw[..., 1] += hist[..., n + 1]
    raw = raw.reshape(m, d * d * n)
    thr = torch.sqrt((raw * raw).sum(1, keepdim=True)) * DESCR_MAG_THR
    raw = torch.minimum(raw, thr)
    nrm = INT_DESCR_FCTR / torch.sqrt((raw * raw).sum(1, keepdim=True)
                                      ).clamp_min(FLT_EPSILON)
    return torch.round(raw * nrm).clamp(0.0, 255.0)


def _empty(dev):
    kp = {k: torch.zeros(0, device=dev) for k in (
        "x", "y", "size", "angle", "response", "xc", "xr", "xi")}
    kp.update({k: torch.zeros(0, dtype=torch.long, device=dev)
               for k in ("octave", "layer", "r", "c")})
    return kp


def detect(gray8, contrast_threshold, edge_threshold=10.0, n_features=0,
           n_layers=N_LAYERS, sigma=SIGMA):
    """SIFT's keypoints of the float32 uint8-valued (H, W) image,
    strongest first (OpenCV returns equal responses in no set order).
    Returns (kp, gauss): kp a dict of (N,) tensors (the sample, offsets
    and angle of each keypoint at its octave), gauss the Gaussian pyramid
    that ``describe`` reads; ``fields(kp)`` gives OpenCV's fields."""
    gauss, dogs = build_pyramids(gray8, n_layers, sigma)
    if not dogs:
        return _empty(gray8.device), None
    dog, gstack = Flat(dogs), Flat(gauss)
    cand = find_candidates(dogs, contrast_threshold, n_layers)
    kp = refine(dog, cand, contrast_threshold, edge_threshold, n_layers,
                sigma)
    kp = retain_best(orientations(gstack, kp, n_layers), n_features)
    order = torch.argsort(kp["response"], descending=True, stable=True)
    return {k: v[order] for k, v in kp.items()}, gstack


def take(kp, n):
    """The first n keypoints of ``kp``."""
    return {k: v[:n] for k, v in kp.items()}


def fields(kp):
    """OpenCV's KeyPoint fields at the image's scale: ``points`` (N, 2)
    xy, ``sizes``, ``angles`` (degrees), ``responses``, ``octaves``
    (first octave -1) and ``layers``."""
    return {"points": torch.stack([kp["x"], kp["y"]], -1) * 0.5,
            "sizes": kp["size"] * 0.5, "angles": kp["angle"],
            "responses": kp["response"], "octaves": kp["octave"] - 1,
            "layers": kp["layer"]}


def describe(gauss, kp):
    """(h) for every keypoint of ``kp`` on the pyramid ``gauss`` (None
    where the image held no octave): (N, 128) float32 integers."""
    d, n = DESCR_WIDTH, DESCR_HIST_BINS
    dev = kp["r"].device
    if gauss is None or not len(kp["r"]):
        return torch.zeros((len(kp["r"]), d * d * n), device=dev)
    scl = f32(SIGMA) * torch.pow(
        2.0, (kp["layer"].float() + kp["xi"]) / float(N_LAYERS))
    hist_width = scl * DESCR_SCL_FCTR
    radius = torch.round(hist_width * f32(math.sqrt(2.0)) * float(d + 1)
                         * 0.5).long()
    diag = torch.sqrt(gauss.w[kp["octave"]].double() ** 2
                      + gauss.h[kp["octave"]].double() ** 2).long()
    radius = torch.minimum(radius, diag)
    order = torch.argsort(radius)
    radii = radius[order].tolist()  # host synchronisation: the groups
    out = torch.empty((len(radii), d * d * n), device=dev)
    s = 0
    while s < len(radii):
        e = s + 1
        while e < len(radii) and (e + 1 - s) * (2 * radii[e] + 1) ** 2 \
                <= WINDOW_BUDGET:
            e += 1
        idx = order[s:e]
        out[idx] = _descriptor_chunk(
            gauss, {k: v[idx] for k, v in kp.items()}, hist_width[idx],
            radius[idx], radii[e - 1])
        s = e
    return out
