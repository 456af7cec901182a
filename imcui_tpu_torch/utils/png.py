"""PNG decoding and encoding with zlib and numpy.

The JAX package decodes request images with PIL and reads and writes
files with OpenCV; this package imports neither, and restates the part of
PNG those paths use.

``decode_png`` reads non-interlaced PNGs of colour types 0 (gray), 2
(RGB), 3 (palette, at bit depth 1, 2, 4 or 8; ``tRNS`` is ignored), 4
(gray + alpha) and 6 (RGBA) at bit depth 8, with all five row filters,
and returns RGB ``uint8`` as PIL's ``Image.open(...).convert("RGB")`` does
(alpha is dropped, gray is repeated over the three channels, palette
indices past the end of ``PLTE`` read black). 16-bit samples, gray below 8
bits and Adam7 interlace raise ``ValueError`` naming the feature, as do a
bad signature, a bad CRC and truncated data.

``encode_png`` writes 8-bit gray, RGB or RGBA with one filter type for
every row, or one per row.

The Average and Paeth filters predict a byte from the one to its left in
the same row, so a row cannot be undone in one vector operation. The
decoder undoes every row at once along anti-diagonals: pixel (r, j)
depends on (r, j - 1), (r - 1, j) and (r - 1, j - 1) only, so every pixel
with r + j = d follows from the two diagonals before it. In the
row-major layout with one padding row and column, the pixels of one
diagonal are equally spaced, and each step is a few strided slices over
at most min(H, W) pixels: H + W - 1 steps in all.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels → colour type, for encoding


def _chunks(data):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: a (left), b (up), c (up-left)."""
    da, db = b - c, a - c  # p - a, p - b for p = a + b - c
    pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw, filters, bpp):
    """Undo the row filters. ``raw`` (H, S) uint8 filtered bytes,
    ``filters`` (H,) filter types, ``bpp`` bytes per complete pixel (1 for
    sub-byte depths). Returns (H, S) uint8."""
    h, s = raw.shape
    if s % bpp:
        raise ValueError("PNG row length is not a whole number of pixels")
    if filters.size and int(filters.max()) > PAETH:
        raise ValueError(f"PNG filter type {int(filters.max())} is invalid")
    p = s // bpp
    if not (filters >= AVERAGE).any():
        # rows of None, Sub and Up: one vector operation a row
        out = np.empty((h, p, bpp), np.uint8)
        prior = np.zeros((p, bpp), np.uint8)
        for r in range(h):
            row = raw[r].reshape(p, bpp)
            if filters[r] == SUB:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif filters[r] == UP:
                row = row + prior
            out[r] = prior = row
        return out.reshape(h, s)
    # anti-diagonal sweep over the padded image: pixel (r, j) sits at flat
    # index (r + 1)(p + 1) + j + 1; a diagonal's pixels are p apart
    w1 = p + 1
    x = np.zeros(((h + 1) * w1, bpp), np.int16)
    r_pad = np.zeros_like(x)
    r_pad.reshape(h + 1, w1, bpp)[1:, 1:] = raw.reshape(h, p, bpp)
    kind = np.zeros((h + 1) * w1, np.int8)
    kind.reshape(h + 1, w1)[1:, 1:] = filters[:, None]
    used = set(np.unique(filters).tolist()) - {NONE}
    for d in range(h + p - 1):
        r0, r1 = max(0, d - p + 1), min(h - 1, d)
        first = (r0 + 1) * w1 + (d - r0) + 1
        stop = first + p * (r1 - r0) + 1
        a = x[first - 1:stop - 1:p]
        b = x[first - w1:stop - w1:p]
        f = kind[first:stop:p][:, None]
        out = r_pad[first:stop:p].copy()
        if SUB in used:
            out += np.where(f == SUB, a, 0)
        if UP in used:
            out += np.where(f == UP, b, 0)
        if AVERAGE in used:
            out += np.where(f == AVERAGE, (a + b) >> 1, 0)
        if PAETH in used:
            c = x[first - w1 - 1:stop - w1 - 1:p]
            out += np.where(f == PAETH, _paeth(a, b, c), 0)
        x[first:stop:p] = out & 255
    return x.reshape(h + 1, w1, bpp)[1:, 1:].astype(np.uint8).reshape(h, s)


def decode_png(data):
    """PNG bytes → (H, W, 3) RGB uint8."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(bytes(data)):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color} is invalid")
    if depth == 16:
        raise ValueError("16-bit PNG samples are not supported")
    if depth != 8 and not (color == 3 and depth in (1, 2, 4)):
        raise ValueError(f"PNG bit depth {depth} is not supported for colour "
                         f"type {color} (only palette images go below 8)")
    if interlace:
        raise ValueError("Adam7-interlaced PNGs are not supported")
    if compression or filter_method:
        raise ValueError("PNG compression or filter method is invalid")
    channels = _CHANNELS[color]
    stride = (w * channels * depth + 7) // 8
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if flat.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = flat[:h * (stride + 1)].reshape(h, stride + 1)
    pix = unfilter(rows[:, 1:], rows[:, 0], max(1, channels * depth // 8))
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        if depth < 8:
            bits = np.unpackbits(pix, axis=1).reshape(h, -1, depth)
            weights = 1 << np.arange(depth - 1, -1, -1)
            pix = (bits * weights).sum(-1)[:, :w]
        # indices past the end of PLTE read black, as in PIL and libpng
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[pix]
    pix = pix.reshape(h, w, channels)
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, -1)
    return np.ascontiguousarray(pix[..., :3])


def encode_png(image, filter_type=UP, level=1):
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 → PNG bytes.
    ``filter_type`` is one of NONE, SUB, UP, AVERAGE, PAETH for every row,
    or a sequence of one per row; ``level`` the zlib level (1, the
    fastest, is OpenCV's default for PNG). UP is the default: on the
    planted 1600 x 1200 test images it gives the smallest file of the five
    and the fastest encode and decode here."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, bpp = image.shape
    if bpp not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, got {bpp}")
    filters = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    if int(filters.max(initial=0)) > PAETH:
        raise ValueError(f"PNG filter type {int(filters.max())} is invalid")
    # predictions of the filters in use only; uint8 differences wrap mod 256
    x = image
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    f = filters[:, None, None]
    used = set(np.unique(filters).tolist())
    out = x.copy()
    if SUB in used:
        out = np.where(f == SUB, x - a, out)
    if UP in used:
        out = np.where(f == UP, x - b, out)
    if AVERAGE in used:
        avg = (a.astype(np.int16) + b) >> 1
        out = np.where(f == AVERAGE, x - avg.astype(np.uint8), out)
    if PAETH in used:
        c = np.zeros_like(x)
        c[1:, 1:] = x[:-1, :-1]
        pth = _paeth(*(v.astype(np.int16) for v in (a, b, c)))
        out = np.where(f == PAETH, x - pth.astype(np.uint8), out)
    rows = out.reshape(h, w * bpp)
    body = np.concatenate([filters[:, None], rows], 1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOR_TYPE[bpp], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + chunk(b"IEND", b""))
