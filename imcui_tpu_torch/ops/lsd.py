"""LSD, the line segment detector, as OpenCV 5.0's
``cv2.createLineSegmentDetector()`` at its defaults: ``LSD_REFINE_STD``,
scale 0.8, sigma_scale 0.6, quant 2.0, ang_th 22.5, log_eps 0,
density_th 0.7, n_bins 1024.

The JAX package calls OpenCV on the host (``imcui_tpu/models/matchers/
gluestick.py::detect_lines``); this module computes the same segments
without it. Stages (a)-(c) are tensor stages on the image's device, in
integer arithmetic but for the angle (OpenCV's float32 polynomial, then
float64), so the card and the CPU agree bit for bit; the norms, the seed
order and the regions, (c)'s square root and (d)-(f), run on the host in
float64, as OpenCV's ``lsd.cpp`` does:

(a) the blur: ``GaussianBlur`` of the uint8 image at sigma 0.6 / 0.8 =
    0.75 over 7 x 7 taps (h = ceil(sigma sqrt(6 ln 10)) = 3), which on
    uint8 is OpenCV's bit-exact fixed-point filter: 8-bit taps from the
    kernel computed in double (``getGaussianKernelBitExact``, each tap
    rounded with its error carried to the next, the centre one minus the
    rest; here 0, 4, 56, 136, 56, 4, 0 over 256), the row sums exact
    integers, the column sums rounded half up from 16 fraction bits,
    BORDER_REFLECT_101;
(b) the downscale: ``resize(INTER_LINEAR_EXACT)`` by 0.8 to
    (cvRound(0.8 w), cvRound(0.8 h)), again fixed point: source position
    1.25 (x + 0.5) - 0.5 in double, 8-bit weights, the edge samples
    clamped, the result rounded half up from 16 fraction bits;
(c) the gradient (``ll_angle``): DA = I[y+1, x+1] - I[y, x], BC =
    I[y, x+1] - I[y+1, x], gx = DA + BC, gy = DA - BC in integers, the
    angle OpenCV's float ``fastAtan2(gx, -gy)`` times pi / 180 in double,
    NOTDEF (-1024) where the norm sqrt((gx^2 + gy^2) / 4) is at most
    2 / sin(22.5 deg) and on the last row and column; on the host the
    norm in double (numpy's IEEE sqrt: the card's ``torch.sqrt`` in
    float64 differs from it in the last bit of some values) and each
    pixel's bin int(norm 1023 / max_norm);
(d) the seed order: the pixels of the first H - 1 rows and W - 1
    columns sorted by bin, descending, and in row-major order inside a
    bin: a stable sort on the host (``seed_order``). Which seed grows
    first decides which region claims a contested pixel. OpenCV 5.0's
    order inside a bin is the stable one: probed against cv2 5.0.0, the
    order that libstdc++'s unstable introsort would leave changes 81 of
    193 segments on ``tests/test_torch_port_lsd.py``'s textured image,
    and the stable order changes none;
(e) the regions (``region_grow`` over 8-neighbours, the region angle
    from float32 running sums of cos and sin and ``fastAtan2``;
    ``region2rect`` with the inertia eigenvector's angle, turned by pi
    where it is off the region angle; ``refine`` and
    ``reduce_region_radius``), at least floor(-logNT / log10(1/8)) points
    a region, all in double with libm's cos and sin, as ``lsd.cpp``, over
    the angles and norms copied to the host once;
(f) the output: in STD mode there is no NFA test (``detect``'s fourth
    output is None); the endpoints get +0.5 and are divided by the scale
    and rounded to float32, the widths divided by the scale, and every
    precision is 22.5 / 180.

OpenCV computes ``cos`` and ``sin`` of a float angle in float (glibc's
``cosf``); the host computes them in double and rounds to float, which
can differ in the last bit of a rare value (no image of the tests
shows one). ``tests/test_torch_port_lsd.py``
holds the whole detector to ``cv2`` on its images: the same segments,
endpoints within 1e-4 px, the blur and the resize bit for bit.

The JAX package falls back to Canny and ``HoughLinesP`` where
``cv2.createLineSegmentDetector`` raises (OpenCV builds of the patent
era). The OpenCV it runs against ships LSD, so that branch is never
taken, and this module does not restate it.
"""

import math
import struct
import time

import numpy as np
import torch

from .sift import ATAN_P, fast_atan2, reflect101

SCALE = 0.8
SIGMA_SCALE = 0.6
QUANT = 2.0
ANG_TH = 22.5
DENSITY_TH = 0.7
N_BINS = 1024
NOTDEF = -1024.0
DEG_TO_RADS = math.pi / 180
M_3_2_PI = 3 * math.pi / 2
M_2__PI = 2 * math.pi
PREC = math.pi * ANG_TH / 180
P_ALIGNED = ANG_TH / 180
RHO = QUANT / math.sin(PREC)
# sqrt(sq / 4) > RHO for an integer sq exactly where sq > 4 RHO^2 = 109.25
# rounded down: no integer lies within a rounding step of 109.25, so the
# comparison needs no sqrt
SQ_UNDEF_MAX = math.floor(4.0 * RHO * RHO)

_F32 = struct.Struct("f")


def f32(x):
    """x rounded to float32, as a Python float: ``sift.f32``'s value in a
    fraction of its time (the region growing calls it per pixel)."""
    return _F32.unpack(_F32.pack(x))[0]


_DBL_EPS_F = f32(2.220446049250313e-16)


def fast_atan2_scalar(y, x):
    """OpenCV's ``fastAtan2`` on two float32 values, each operation
    rounded to float32 (the host twin of ``sift.fast_atan2``)."""
    p1, p3, p5, p7 = ATAN_P
    ax, ay = abs(x), abs(y)
    if ax >= ay:
        c = f32(ay / f32(ax + _DBL_EPS_F))
        c2 = f32(c * c)
        a = f32(f32(f32(f32(f32(f32(f32(p7 * c2) + p5) * c2) + p3) * c2)
                    + p1) * c)
    else:
        c = f32(ax / f32(ay + _DBL_EPS_F))
        c2 = f32(c * c)
        a = f32(90.0 - f32(f32(f32(f32(f32(f32(f32(p7 * c2) + p5) * c2)
                                        + p3) * c2) + p1) * c))
    if x < 0:
        a = f32(180.0 - a)
    if y < 0:
        a = f32(360.0 - a)
    return a


# ---------------------------------------------------------------------------
# (a)-(d): tensor stages, then the norms and the seed order on the host
# ---------------------------------------------------------------------------

def blur_taps(sigma=SIGMA_SCALE / SCALE, frac_bits=8):
    """The integer taps of OpenCV's bit-exact uint8 Gaussian kernel
    (``getGaussianKernelBitExact``, then ``getGaussianKernelFixedPoint_ED``):
    2h + 1 taps with h = ceil(sigma sqrt(2 * 3 * ln 10)), summing to
    2^frac_bits."""
    h = int(math.ceil(sigma * math.sqrt(2 * 3 * math.log(10.0))))
    n = 2 * h + 1
    scale2 = -0.125 / (sigma * sigma)
    vals = [math.exp(float(x * x) * scale2) for x in range(1 - n, -1, 2)]
    mul = 1.0 / (sum(vals) * 2.0 + 1.0)
    unit = float(1 << frac_bits)
    err, taps = 0.0, []
    for v in vals:
        adj = v * mul * unit + err
        t = round(adj)  # cvRound: half to even, as Python's round
        err = adj - t
        taps.append(t)
    return taps + [(1 << frac_bits) - 2 * sum(taps)] + taps[::-1]


def gaussian_blur_u8(img, taps=None):
    """``cv2.GaussianBlur`` of a uint8 (H, W) tensor on its fixed-point
    path, bit for bit: exact integer row sums, column sums rounded half up
    from 16 fraction bits, BORDER_REFLECT_101."""
    taps = blur_taps() if taps is None else taps
    r = len(taps) // 2
    h, w = img.shape
    x = img.to(torch.int32)
    xc = x.index_select(1, reflect101(w, -r, w + r, x.device))
    rows = sum(t * xc[:, i:i + w] for i, t in enumerate(taps) if t)
    rc = rows.index_select(0, reflect101(h, -r, h + r, x.device))
    out = sum(t * rc[i:i + h] for i, t in enumerate(taps) if t)
    return ((out + 32768) >> 16).to(torch.uint8)


def _linear_exact_table(n_src, n_dst, inv_scale):
    """Per output sample: the first source index and the 8-bit weight of
    the second (``interpolationLinear::getCoeffs`` in softdouble, which
    is IEEE double here); samples past either edge take the edge sample
    whole."""
    scale = 1.0 / inv_scale
    first, weight = [], []
    for v in range(n_dst):
        f = scale * (v + 0.5) - 0.5
        i = math.floor(f)
        if i < 0:
            first.append(0)
            weight.append(0)
        elif i < n_src - 1:
            first.append(i)
            weight.append(round((f - i) * 256))
        else:
            first.append(n_src - 1)
            weight.append(0)
    return first, weight


def scaled_size(h, w, scale=SCALE):
    """(cvRound(h scale), cvRound(w scale)): ``resize``'s size when it is
    given only the factors."""
    return round(h * scale), round(w * scale)


def resize_linear_exact_u8(img, scale=SCALE):
    """``cv2.resize(img, None, fx=scale, fy=scale,
    interpolation=INTER_LINEAR_EXACT)`` of a uint8 (H, W) tensor, bit for
    bit."""
    h, w = img.shape
    dh, dw = scaled_size(h, w, scale)
    dev = img.device

    def table(n, m):
        first, wt = _linear_exact_table(n, m, scale)
        i0 = torch.tensor(first, device=dev)
        return (i0, (i0 + 1).clamp_max(n - 1),
                torch.tensor(wt, dtype=torch.int32, device=dev))

    x0, x1, wx = table(w, dw)
    y0, y1, wy = table(h, dh)
    x = img.to(torch.int32)
    rows = x.index_select(1, x0) * (256 - wx) + x.index_select(1, x1) * wx
    out = (rows.index_select(0, y0) * (256 - wy)[:, None]
           + rows.index_select(0, y1) * wy[:, None])
    return ((out + 32768) >> 16).to(torch.uint8)


def gradient(img):
    """The device half of ``ll_angle`` on a uint8 (H, W) tensor: angles
    (H, W) float64 with NOTDEF on undefined pixels and the last row and
    column, and the squared norms gx^2 + gy^2 (H - 1, W - 1) int32."""
    x = img.to(torch.int32)
    da = x[1:, 1:] - x[:-1, :-1]
    bc = x[:-1, 1:] - x[1:, :-1]
    gx, gy = da + bc, da - bc
    sq = gx * gx + gy * gy
    defined = sq > SQ_UNDEF_MAX
    ang = fast_atan2(gx.float(), (-gy).float()).double() * DEG_TO_RADS
    angles = torch.full(x.shape, NOTDEF, dtype=torch.float64,
                        device=x.device)
    angles[:-1, :-1] = torch.where(defined, ang, NOTDEF)
    return angles, sq


def norms_and_bins(sq, n_bins=N_BINS):
    """The host half of ``ll_angle``: the norms sqrt(sq / 4) in float64
    (numpy's sqrt is IEEE's, as C's; the card's ``torch.sqrt`` differs in
    the last bit of some values, which moves segments' last bits) and each
    pixel's bin int(norm (n_bins - 1) / max_norm) over the defined
    pixels' largest norm."""
    norm = np.sqrt(sq / 4.0)
    defined = sq > SQ_UNDEF_MAX
    max_grad = float(norm[defined].max()) if defined.any() else -1.0
    coef = (n_bins - 1) / max_grad if max_grad > 0 else 0.0
    return norm, (norm * coef).astype(np.int64)


# ---------------------------------------------------------------------------
# (e)-(f): regions, rectangles and refinement on the host
# ---------------------------------------------------------------------------

def _angle_diff_signed(a, b):
    diff = a - b
    while diff <= -math.pi:
        diff += M_2__PI
    while diff > math.pi:
        diff -= M_2__PI
    return diff


def _double_equal(a, b):
    if a == b:
        return True
    abs_max = max(abs(a), abs(b), 2.2250738585072014e-308)
    return abs(a - b) / abs_max <= 100.0 * 2.220446049250313e-16


class _Detector:
    """The host half of ``LineSegmentDetectorImpl::flsd`` over one scaled
    image's angles and norms (flat Python lists, row-major)."""

    def __init__(self, angles, modgrad, h, w):
        self.angles = angles
        self.modgrad = modgrad
        self.h, self.w = h, w
        self.used = bytearray(h * w)

    def region_grow(self, seed, prec):
        angles, used, w, h = self.angles, self.used, self.w, self.h
        reg_angle = angles[seed]
        reg = [seed]
        sumdx = f32(math.cos(reg_angle))
        sumdy = f32(math.sin(reg_angle))
        used[seed] = 1
        i = 0
        while i < len(reg):
            p = reg[i]
            i += 1
            py, px = divmod(p, w)
            x0, x1 = max(px - 1, 0), min(px + 1, w - 1)
            for yy in range(max(py - 1, 0), min(py + 1, h - 1) + 1):
                row = yy * w
                for q in range(row + x0, row + x1 + 1):
                    if used[q]:
                        continue
                    a = angles[q]
                    if a == NOTDEF:
                        continue
                    d = reg_angle - a
                    if d < 0:
                        d = -d
                    if d > M_3_2_PI:
                        d -= M_2__PI
                        if d < 0:
                            d = -d
                    if d > prec:
                        continue
                    used[q] = 1
                    reg.append(q)
                    af = f32(a)
                    sumdx = f32(sumdx + f32(math.cos(af)))
                    sumdy = f32(sumdy + f32(math.sin(af)))
                    reg_angle = fast_atan2_scalar(sumdy, sumdx) * DEG_TO_RADS
        return reg, reg_angle

    def region2rect(self, reg, reg_angle, prec):
        modgrad, w = self.modgrad, self.w
        x = y = s = 0.0
        pts = []
        for p in reg:
            py, px = divmod(p, w)
            g = modgrad[p]
            x += float(px) * g
            y += float(py) * g
            s += g
            pts.append((float(px), float(py), g))
        x /= s
        y /= s
        theta = self.get_theta(pts, x, y, reg_angle, prec)
        dx, dy = math.cos(theta), math.sin(theta)
        l_min = l_max = w_min = w_max = 0.0
        for px, py, _ in pts:
            rx, ry = px - x, py - y
            l = rx * dx + ry * dy
            wd = -rx * dy + ry * dx
            if l > l_max:
                l_max = l
            elif l < l_min:
                l_min = l
            if wd > w_max:
                w_max = wd
            elif wd < w_min:
                w_min = wd
        width = w_max - w_min
        return {"x1": x + l_min * dx, "y1": y + l_min * dy,
                "x2": x + l_max * dx, "y2": y + l_max * dy,
                "width": width if width >= 1.0 else 1.0}

    @staticmethod
    def get_theta(pts, x, y, reg_angle, prec):
        ixx = iyy = ixy = 0.0
        for px, py, g in pts:
            dx, dy = px - x, py - y
            ixx += dy * dy * g
            iyy += dx * dx * g
            ixy -= dx * dy * g
        if _double_equal(ixx, 0) and _double_equal(iyy, 0) and \
                _double_equal(ixy, 0):
            raise RuntimeError("LSD: null inertia matrix")
        lam = 0.5 * (ixx + iyy - math.sqrt((ixx - iyy) * (ixx - iyy)
                                           + 4.0 * ixy * ixy))
        if abs(ixx) > abs(iyy):
            theta = fast_atan2_scalar(f32(lam - ixx), f32(ixy))
        else:
            theta = fast_atan2_scalar(f32(ixy), f32(lam - iyy))
        theta *= DEG_TO_RADS
        if abs(_angle_diff_signed(theta, reg_angle)) > prec:
            theta += math.pi
        return theta

    @staticmethod
    def _density(n, rec):
        length = math.sqrt((rec["x2"] - rec["x1"]) * (rec["x2"] - rec["x1"])
                           + (rec["y2"] - rec["y1"]) * (rec["y2"] - rec["y1"]))
        return float(n) / (length * rec["width"])

    def refine(self, reg, reg_angle, prec, rec):
        if self._density(len(reg), rec) >= DENSITY_TH:
            return reg, rec
        w, angles, used = self.w, self.angles, self.used
        yc, xc = divmod(reg[0], w)
        xc, yc = float(xc), float(yc)
        ang_c = angles[reg[0]]
        s = s_sum = 0.0
        n = 0
        for p in reg:
            used[p] = 0
            py, px = divmod(p, w)
            if math.sqrt((px - xc) * (px - xc) + (py - yc) * (py - yc)) \
                    < rec["width"]:
                ang_d = _angle_diff_signed(angles[p], ang_c)
                s += ang_d
                s_sum += ang_d * ang_d
                n += 1
        mean_angle = s / float(n)
        tau = 2.0 * math.sqrt((s_sum - 2.0 * mean_angle * s) / float(n)
                              + mean_angle * mean_angle)
        reg, reg_angle = self.region_grow(reg[0], tau)
        if len(reg) < 2:
            return None
        rec = self.region2rect(reg, reg_angle, prec)
        density = self._density(len(reg), rec)
        if density < DENSITY_TH:
            return self.reduce_region_radius(reg, reg_angle, prec, rec,
                                             density)
        return reg, rec

    def reduce_region_radius(self, reg, reg_angle, prec, rec, density):
        w, used = self.w, self.used
        yc, xc = divmod(reg[0], w)
        xc, yc = float(xc), float(yc)
        r1 = (rec["x1"] - xc) * (rec["x1"] - xc) + \
            (rec["y1"] - yc) * (rec["y1"] - yc)
        r2 = (rec["x2"] - xc) * (rec["x2"] - xc) + \
            (rec["y2"] - yc) * (rec["y2"] - yc)
        rad_sq = r1 if r1 > r2 else r2
        while density < DENSITY_TH:
            rad_sq *= 0.75 * 0.75
            i = 0
            while i < len(reg):
                py, px = divmod(reg[i], w)
                if (xc - px) * (xc - px) + (yc - py) * (yc - py) > rad_sq:
                    used[reg[i]] = 0
                    reg[i] = reg[-1]
                    reg.pop()
                else:
                    i += 1
            if len(reg) < 2:
                return None
            rec = self.region2rect(reg, reg_angle, prec)
            density = self._density(len(reg), rec)
        return reg, rec

    def run(self, order, min_reg_size):
        angles, used = self.angles, self.used
        out = []
        for p in order:
            if used[p] or angles[p] == NOTDEF:
                continue
            reg, reg_angle = self.region_grow(p, PREC)
            if len(reg) < min_reg_size:
                continue
            rec = self.region2rect(reg, reg_angle, PREC)
            got = self.refine(reg, reg_angle, PREC, rec)
            if got is None:
                continue
            out.append(got[1])
        return out


def seed_order(bins):
    """Indices of the flattened (H - 1, W - 1) ``bins``, bins descending,
    row-major inside a bin."""
    return np.argsort(-bins.ravel(), kind="stable")


def _seconds(device, t0):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def detect(gray8, timings=None):
    """``cv2.createLineSegmentDetector().detect`` on a uint8 (H, W)
    tensor. Returns (lines (N, 4) float32 x1, y1, x2, y2, widths (N,)
    float64, precisions (N,) float64) as numpy arrays; OpenCV's fourth
    output, the NFA, is None in this mode. ``timings``, a dict, receives
    each stage's seconds (the device stages synchronised)."""
    if gray8.dtype != torch.uint8 or gray8.dim() != 2:
        raise ValueError("LSD takes a uint8 (H, W) image")
    dev = gray8.device
    t0 = time.perf_counter()
    blurred = gaussian_blur_u8(gray8)
    t_blur = _seconds(dev, t0)
    t0 = time.perf_counter()
    scaled = resize_linear_exact_u8(blurred)
    t_resize = _seconds(dev, t0)
    t0 = time.perf_counter()
    angles, sq = gradient(scaled)
    t_grad = _seconds(dev, t0)
    h, w = scaled.shape
    t0 = time.perf_counter()
    angles_h, sq = angles.cpu().numpy(), sq.cpu().numpy()
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    norm, bins = norms_and_bins(sq)
    order = seed_order(bins)
    # seed k is pixel (k // (w - 1), k % (w - 1)) of the scaled image
    flat = ((order // (w - 1)) * w + order % (w - 1)).tolist()
    modgrad = np.zeros((h, w))
    modgrad[:-1, :-1] = norm
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    log_nt = 5 * (math.log10(float(w)) + math.log10(float(h))) / 2 \
        + math.log10(11.0)
    min_reg_size = int(-log_nt / math.log10(P_ALIGNED))
    rects = _Detector(angles_h.ravel().tolist(), modgrad.ravel().tolist(),
                      h, w).run(flat, min_reg_size)
    lines = np.array([[(r[k] + 0.5) / SCALE for k in ("x1", "y1", "x2", "y2")]
                      for r in rects], np.float64).reshape(-1, 4)
    widths = np.array([r["width"] / SCALE for r in rects], np.float64)
    t_grow = time.perf_counter() - t0
    if timings is not None:
        timings.update(blur=t_blur, resize=t_resize, gradient=t_grad,
                       copy=t_copy, sort=t_sort, grow=t_grow)
    return (lines.astype(np.float32), widths,
            np.full(len(rects), P_ALIGNED, np.float64))
