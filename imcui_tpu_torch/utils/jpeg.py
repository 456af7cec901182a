"""JPEG decoding without OpenCV or PIL.

The JAX package reads JPEG files with ``cv2.imread`` and request bodies
with PIL, both through libjpeg-turbo. ``decode_jpeg`` gives the same
pixels bit for bit: this module parses the markers and tables and checks
the file against what it reads; the host library
(``csrc/host/jpeg_decode.cpp``, built with ``c++`` on first use by
``ops/_build.py``) decodes each scan's Huffman data into coefficients and
runs libjpeg-turbo's default output stages (the islow IDCT, fancy
upsampling, fixed-point YCbCr → RGB). There is no other decoder behind
it: when the library cannot be built, decoding raises.

What it reads: baseline, extended (8-bit) and progressive Huffman frames
(SOF0, SOF1, SOF2) of one component or three YCbCr components, with
sampling factors 1-4 in whole-number ratios (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1), interleaved and non-interleaved scans, restart intervals, 8- and
16-bit quantisation tables, and the EXIF orientation tag of IFD0 in both
byte orders. Colour output is RGB; gray output is libjpeg's
``JCS_GRAYSCALE``, the (upsampled) Y plane, which is what
``cv2.IMREAD_GRAYSCALE`` gives; a one-component file read in colour
repeats its plane three times.

What raises ``ValueError`` naming the feature: arithmetic coding
(SOF9-SOF15), lossless (SOF3) and hierarchical (SOF5-SOF7) frames,
precision other than 8 bits, 2 or 4 components (CMYK, YCCK), RGB colour
(Adobe transform 0, or component ids R, G, B without a marker),
fractional sampling ratios, a progressive file whose scans leave some
coefficient bits unrefined (libjpeg would smooth its blocks), Huffman
tables a scan uses but the file never defines, more than 2^30 pixels
(``cv2.imread``'s limit; PIL refuses above 178956970 already), and a
truncated or corrupt stream. libjpeg warns and pads a truncated or
corrupt stream with zeros; this module raises instead.
"""

import ctypes

import numpy as np

from ..ops import _build

SOI = b"\xff\xd8"
MAX_PIXELS = 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_PIXELS
# zigzag position -> natural (row-major) position in an 8 x 8 block
_NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
            26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
            56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
            45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
_UNSUPPORTED_SOF = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding, lossless (SOF11)",
    0xCD: "arithmetic coding, hierarchical (SOF13)",
    0xCE: "arithmetic coding, hierarchical (SOF14)",
    0xCF: "arithmetic coding, hierarchical (SOF15)"}
_SCAN_ERRORS = {
    1: "truncated or corrupt JPEG data: a scan needs more data than it has",
    2: "corrupt JPEG data: bad Huffman code or table",
    3: "corrupt JPEG data: restart marker missing or out of sequence",
    5: "corrupt JPEG data: bad progressive refinement"}


def _u16(b, i):
    return (b[i] << 8) | b[i + 1]


def _exif_orientation(segment):
    """The orientation tag (0x0112) of IFD0 in an APP1 ``Exif`` segment's
    payload, 1 when absent or out of range. Both TIFF byte orders."""
    t = segment[6:]
    order = {b"II": "little", b"MM": "big"}.get(bytes(t[:2]))
    if order is None or len(t) < 8:
        return 1

    def u(i, n):
        return int.from_bytes(t[i:i + n], order) if i + n <= len(t) else None

    ifd = u(4, 4)
    count = u(ifd, 2) if ifd is not None else None
    for k in range(count or 0):
        e = ifd + 2 + 12 * k
        if u(e, 2) == 0x0112:
            v = u(e + 8, 2)
            return v if v is not None and 1 <= v <= 8 else 1
    return 1


def _apply_orientation(image, tag):
    """An (H, W[, C]) image as EXIF orientation ``tag`` says to show it:
    2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 rotate 90 clockwise,
    7 transverse, 8 rotate 90 anticlockwise."""
    views = {1: lambda a: a, 2: lambda a: a[:, ::-1],
             3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
             5: lambda a: a.swapaxes(0, 1),
             6: lambda a: a.swapaxes(0, 1)[:, ::-1],
             7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
             8: lambda a: a.swapaxes(0, 1)[::-1]}
    return np.ascontiguousarray(views[tag](image))


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None   # latched at the component's first scan
        self.coef = None    # (rows, stride, 64) int16
        self.bits = None    # progressive: bits still to come a coefficient
        self.scanned = False


class _Decoder:
    """One pass over the markers of ``data``. With ``header_only`` it
    stops at the first scan, having read the frame and the EXIF tag."""

    def __init__(self, data, header_only=False):
        self.data = data
        self.header_only = header_only
        self.comps = []
        self.frame = None          # SOF marker byte
        self.width = self.height = 0
        self.quant = [None] * 4
        self.huff = np.zeros((8, 272), np.uint8)
        self.defined = [False] * 8
        self.restart = 0
        self.jfif = False
        self.adobe = None
        self.orientation = None    # from the first APP1 Exif segment
        self.scans = 0

    def run(self):
        data = self.data
        if data[:2] != SOI:
            raise ValueError("not a JPEG file (no SOI marker)")
        pos, n = 2, len(data)
        while True:
            while pos < n and data[pos] != 0xFF:
                pos += 1
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                raise ValueError("truncated JPEG data: no EOI marker")
            m = data[pos]
            pos += 1
            if m == 0xD9:
                break
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            if m == 0xD8:
                raise ValueError("corrupt JPEG data: a second SOI marker")
            if pos + 2 > n or _u16(data, pos) < 2 \
                    or pos + _u16(data, pos) > n:
                raise ValueError("truncated JPEG data: a marker segment "
                                 "runs past the end")
            seg = data[pos + 2:pos + _u16(data, pos)]
            pos += _u16(data, pos)
            if m == 0xDA:
                if self.header_only:
                    return self
                pos = self._scan(seg, pos)
            elif m in (0xC0, 0xC1, 0xC2):
                self._frame(m, seg)
            elif m in _UNSUPPORTED_SOF:
                raise ValueError(f"JPEG {_UNSUPPORTED_SOF[m]} is not "
                                 "supported")
            elif m == 0xC4:
                self._dht(seg)
            elif m == 0xDB:
                self._dqt(seg)
            elif m == 0xDD:
                if len(seg) != 2:
                    raise ValueError("corrupt JPEG data: bad DRI segment")
                self.restart = _u16(seg, 0)
            elif m == 0xE0:
                self.jfif = self.jfif or seg[:5] == b"JFIF\x00"
            elif m == 0xE1:
                if seg[:6] == b"Exif\x00\x00" and self.orientation is None:
                    self.orientation = _exif_orientation(seg)
            elif m == 0xEE:
                if len(seg) >= 12 and seg[:5] == b"Adobe":
                    self.adobe = seg[11]
            elif m == 0xCC:
                raise ValueError("JPEG arithmetic coding (DAC) is not "
                                 "supported")
            elif not (0xE2 <= m <= 0xEF or m in (0xFE, 0xDC)):
                raise ValueError(f"corrupt JPEG data: unknown marker "
                                 f"0x{m:02X}")
        if self.frame is None or self.scans == 0:
            raise ValueError("JPEG data without an image (no frame or "
                             "scan before EOI)")
        return self

    def _frame(self, marker, seg):
        if self.frame is not None:
            raise ValueError("corrupt JPEG data: a second frame header")
        if len(seg) < 6:
            raise ValueError("corrupt JPEG data: short frame header")
        prec, self.height, self.width, nc = seg[0], _u16(seg, 1), \
            _u16(seg, 3), seg[5]
        if prec != 8:
            raise ValueError(f"JPEG {prec}-bit precision is not supported "
                             "(8-bit only)")
        if nc in (2, 4):
            raise ValueError(f"JPEG with {nc} components (CMYK/YCCK) is not "
                             "supported: one (gray) or three (YCbCr) only")
        if nc not in (1, 3) or len(seg) != 6 + 3 * nc:
            raise ValueError(f"corrupt JPEG data: {nc} components")
        if self.width == 0 or self.height == 0:
            raise ValueError("JPEG with a zero size (or a DNL marker) is "
                             "not supported")
        if self.width * self.height > MAX_PIXELS:
            raise ValueError(f"JPEG of {self.width} x {self.height} pixels: "
                             "more than 2^30 pixels is not supported")
        for i in range(nc):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise ValueError("corrupt JPEG data: sampling factors "
                                 f"{h}x{v} or quantisation table {tq}")
            self.comps.append(_Component(cid, h, v, tq))
        self.frame = marker
        self.max_h = max(c.h for c in self.comps)
        self.max_v = max(c.v for c in self.comps)
        if any(self.max_h % c.h or self.max_v % c.v for c in self.comps):
            raise ValueError(
                "JPEG with fractional sampling ratios is not supported ("
                + ", ".join(f"{c.h}x{c.v}" for c in self.comps) + ")")
        self.mcux = -(-self.width // (8 * self.max_h))
        self.mcuy = -(-self.height // (8 * self.max_v))
        for c in self.comps:
            c.coef = np.zeros((self.mcuy * c.v, self.mcux * c.h, 64),
                              np.int16)
            c.bits = np.full(64, -1)
            c.dw = -(-self.width * c.h // self.max_h)
            c.dh = -(-self.height * c.v // self.max_v)

    def _rgb(self):
        """libjpeg's guess of a three-component colour space (jdapimin.c):
        JFIF means YCbCr; else an Adobe marker's transform 0 means RGB;
        else component ids 'R', 'G', 'B' do. Anything else is YCbCr."""
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return tuple(c.id for c in self.comps) == (82, 71, 66)

    def _dht(self, seg):
        i = 0
        while i < len(seg):
            if i + 17 > len(seg):
                raise ValueError("corrupt JPEG data: short DHT segment")
            tc, th = seg[i] >> 4, seg[i] & 15
            counts = seg[i + 1:i + 17]
            total = sum(counts)
            if tc > 1 or th > 3 or total > 256 or i + 17 + total > len(seg):
                raise ValueError("corrupt JPEG data: bad Huffman table")
            slot = 4 * tc + th
            self.huff[slot] = 0
            self.huff[slot, :16] = np.frombuffer(counts, np.uint8)
            self.huff[slot, 16:16 + total] = np.frombuffer(
                seg[i + 17:i + 17 + total], np.uint8)
            self.defined[slot] = True
            i += 17 + total

    def _dqt(self, seg):
        i = 0
        while i < len(seg):
            pq, tq = seg[i] >> 4, seg[i] & 15
            size = 128 if pq else 64
            if pq > 1 or tq > 3 or i + 1 + size > len(seg):
                raise ValueError("corrupt JPEG data: bad quantisation table")
            vals = np.frombuffer(seg[i + 1:i + 1 + size],
                                 ">u2" if pq else np.uint8)
            table = np.zeros(64, np.uint16)
            table[list(_NATURAL)] = vals
            self.quant[tq] = table
            i += 1 + size

    def _scan(self, seg, pos):
        if self.frame is None:
            raise ValueError("corrupt JPEG data: a scan before the frame "
                             "header")
        if self.scans == 0 and len(self.comps) == 3 and self._rgb():
            raise ValueError("JPEG with RGB components (Adobe transform 0) "
                             "is not supported: YCbCr only")
        ns = seg[0] if seg else 0
        if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
            raise ValueError("corrupt JPEG data: bad scan header")
        comps, dc, ac = [], [], []
        for k in range(ns):
            cid, t = seg[1 + 2 * k], seg[2 + 2 * k]
            found = [c for c in self.comps if c.id == cid]
            if not found or found[0] in comps:
                raise ValueError(f"corrupt JPEG data: scan component {cid}")
            comps.append(found[0])
            dc.append(t >> 4)
            ac.append(t & 15)
        ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], \
            seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
        progressive = self.frame == 0xC2
        if progressive:
            self._progression(comps, ss, se, ah, al)
        else:
            ss, se, ah, al = 0, 63, 0, 0
        if ns > 1 and sum(c.h * c.v for c in comps) > 10:
            raise ValueError("corrupt JPEG data: more than 10 blocks an MCU")
        uses_dc, uses_ac = ss == 0 and ah == 0, se > 0
        for k, c in enumerate(comps):
            for used, cls, t in ((uses_dc, 0, dc[k]), (uses_ac, 1, ac[k])):
                if used and (t > 3 or not self.defined[4 * cls + t]):
                    raise ValueError(f"JPEG scan uses Huffman table {t} "
                                     "which the file does not define")
            if uses_dc and self.huff[dc[k], 16:16 + int(
                    self.huff[dc[k], :16].sum())].max(initial=0) > 15:
                raise ValueError("corrupt JPEG data: bad DC Huffman table")
            if c.quant is None:
                if self.quant[c.tq] is None:
                    raise ValueError(f"JPEG quantisation table {c.tq} is "
                                     "not defined")
                c.quant = self.quant[c.tq]
        if ns > 1:
            mcux, mcuy = self.mcux, self.mcuy
        else:
            c = comps[0]
            mcux, mcuy = -(-c.dw // 8), -(-c.dh // 8)
        desc = [ns, ss, se, ah, al, self.restart, mcux, mcuy,
                int(progressive)]
        for k, c in enumerate(comps):  # a table id the scan does not use
            desc += [c.h, c.v, c.coef.shape[1],  # may be any 4 bits
                     min(dc[k], 3), min(ac[k], 3)]
        desc = np.asarray(desc, np.int32)
        ptrs = (ctypes.c_void_p * ns)(*(c.coef.ctypes.data for c in comps))
        end = ctypes.c_int64(0)
        buf = np.frombuffer(self.data, np.uint8)
        code = _build.host_library().jpeg_decode_scan(
            buf.ctypes.data, len(buf), pos, desc.ctypes.data,
            self.huff.ctypes.data, ptrs, ctypes.byref(end))
        if code:
            raise ValueError(_SCAN_ERRORS.get(code, f"JPEG decoder error "
                                              f"{code}"))
        self.scans += 1
        for c in comps:
            c.scanned = True
        return end.value

    def _progression(self, comps, ss, se, ah, al):
        """jdphuff.c's checks of a progressive scan's parameters; what
        libjpeg only warns about raises here."""
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or len(comps) != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise ValueError(f"corrupt JPEG data: bad progression Ss={ss} "
                             f"Se={se} Ah={ah} Al={al}")
        for c in comps:
            if ss and c.bits[0] < 0:
                raise ValueError("corrupt JPEG data: AC scan before the "
                                 "component's DC scan")
            expected = np.maximum(c.bits[ss:se + 1], 0)
            if (expected != ah).any():
                raise ValueError("corrupt JPEG data: progressive scans out "
                                 "of order")
            c.bits[ss:se + 1] = al

    def image(self, grayscale):
        comps = self.comps
        if self.frame == 0xC2:
            if any((c.bits != 0).any() for c in comps):
                raise ValueError(
                    "progressive JPEG whose scans leave coefficient bits "
                    "unrefined is not supported (libjpeg smooths such "
                    "blocks)")
        elif not all(c.scanned for c in comps):
            raise ValueError("truncated JPEG data: a component has no scan")
        gray = grayscale or len(comps) == 1
        used = comps[:1] if gray else comps
        mode = 0 if grayscale else (2 if len(comps) == 1 else 1)
        desc = [len(used), self.width, self.height, self.max_h, self.max_v,
                mode]
        for c in used:
            desc += [c.h, c.v, c.coef.shape[1]]
        desc = np.asarray(desc, np.int32)
        quant = np.concatenate([c.quant for c in used]).astype(np.uint16)
        ptrs = (ctypes.c_void_p * len(used))(*(c.coef.ctypes.data
                                               for c in used))
        shape = (self.height, self.width) if mode == 0 else \
            (self.height, self.width, 3)
        out = np.empty(shape, np.uint8)
        code = _build.host_library().jpeg_output(
            desc.ctypes.data, ptrs, quant.ctypes.data, out.ctypes.data)
        if code:
            raise ValueError(f"JPEG decoder error {code}")
        return out


def decode_jpeg(data, grayscale=False, orientation=True):
    """JPEG bytes → (H, W, 3) RGB uint8, or the (H, W) Y plane when
    ``grayscale``, as libjpeg-turbo decodes them. With ``orientation``
    the EXIF orientation tag is applied, as ``cv2.imread`` does; without
    it the pixels come as stored, as PIL's ``convert("RGB")`` gives them."""
    dec = _Decoder(bytes(data)).run()
    image = dec.image(grayscale)
    return _apply_orientation(image, dec.orientation or 1) if orientation \
        else image


def jpeg_size(data):
    """(width, height) of a JPEG as ``decode_jpeg`` turns it, from its
    frame header and EXIF tag, without decoding the image."""
    dec = _Decoder(bytes(data), header_only=True).run()
    if dec.frame is None:
        raise ValueError("JPEG data without a frame header")
    w, h = dec.width, dec.height
    return (h, w) if (dec.orientation or 1) >= 5 else (w, h)
