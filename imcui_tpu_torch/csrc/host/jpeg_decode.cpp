// JPEG entropy decoding and output stages on the host, as libjpeg-turbo
// 3.x decodes by default (cv2.imread / PIL's convert("RGB")).
//
// utils/jpeg.py parses the markers and tables and calls this library once
// per scan (jpeg_decode_scan: Huffman data into int16 coefficient planes,
// one per component, in natural order) and once at the end (jpeg_output:
// dequantisation, jidctint.c's islow IDCT, jdsample.c's upsampling and
// jdcolor.c's YCbCr -> RGB). Plain C interface over caller-owned buffers,
// bound with ctypes; no allocation crosses it.
//
// Where libjpeg warns and pads (a marker or the end of the data inside a
// scan, a bad Huffman code, a restart marker out of sequence), these
// functions return an error code instead.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the bit reader assumes a little-endian host");

namespace {

enum {
  OK = 0,
  ERR_TRUNCATED = 1,   // the scan needs bits past its data
  ERR_HUFFMAN = 2,     // a code of more than 16 bits
  ERR_RESTART = 3,     // a restart marker missing or out of sequence
  ERR_BAD_ARGS = 4,
  ERR_REFINEMENT = 5,  // progressive: new coefficient of size other than 1
};

// Zigzag index -> natural (row-major) index, with 16 extra entries that
// keep a corrupt run inside the block, as jpeg_natural_order has.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer code
  // AC symbols whose code and extra bits fit in kLookBits: (value << 8)
  // | (run << 4) | bits consumed; 0 where they do not
  int32_t fast[1 << kLookBits];
  int32_t maxcode[18];            // largest code of each length, -1 if none
  int32_t valoffset[18];
  uint8_t huffval[256];

  // ``spec``: 16 code counts then 256 symbols (jdhuff.c's derived table).
  bool build(const uint8_t* spec) {
    const uint8_t* bits = spec;
    std::memcpy(huffval, spec + 16, 256);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l - 1]; i++) {
        if (p >= 256) return false;
        huffsize[p++] = l;
      }
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) return false;
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++)
      for (int i = 0; i < bits[l - 1]; i++, p++) {
        int first = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); c++)
          look[first + c] = uint16_t((l << 8) | huffval[p]);
      }
    for (int i = 0; i < (1 << kLookBits); i++) {
      const int l = look[i] >> 8, run = (look[i] >> 4) & 15, s = look[i] & 15;
      fast[i] = 0;
      if (l && s && l + s <= kLookBits) {
        const int v = (i >> (kLookBits - l - s)) & ((1 << s) - 1);
        const int value = v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
        fast[i] = value * 256 + (run << 4) + l + s;
      }
    }
    return true;
  }
};

// MSB-first bit reader over entropy-coded data: FF 00 is a data byte FF,
// FF FF ... fill bytes are skipped, and any other FF xx is a marker, at
// which (or at the end of the data) reading stops and zero bits are
// supplied. ``fake`` counts the zeros so that consuming one is an error.
struct Bits {
  const uint8_t* data;
  int64_t size, pos;
  uint64_t buf = 0;
  int n = 0, fake = 0;
  bool stopped = false;
  int64_t marker_pos = -1;  // offset of the FF that starts the marker

  void fill() {  // called with n < 16
    // the common case: the next bytes hold no FF, eight at a time
    if (!stopped && pos + 8 <= size) {
      uint64_t w;
      std::memcpy(&w, data + pos, 8);
      w = __builtin_bswap64(w);
      const int k = (64 - n) >> 3;
      const uint64_t top = k == 8 ? w : w >> (64 - 8 * k);
      const uint64_t x = ~top;
      if (!((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull)) {
        buf |= top << (64 - 8 * k - n);
        n += 8 * k;
        pos += k;
        return;
      }
    }
    while (n <= 56) {
      if (stopped) {
        n += 8;
        fake += 8;
        continue;
      }
      if (pos >= size) {
        stopped = true;
        continue;
      }
      uint32_t c = data[pos];
      if (c == 0xFF) {
        int64_t q = pos + 1;
        while (q < size && data[q] == 0xFF) q++;
        if (q < size && data[q] == 0) {
          pos = q + 1;
        } else {
          stopped = true;
          if (q < size) marker_pos = pos;
          continue;
        }
      } else {
        pos++;
      }
      buf |= uint64_t(c) << (56 - n);
      n += 8;
    }
  }
  inline uint32_t get(int k) {  // 1 <= k <= 16
    if (n < k) fill();
    uint32_t v = uint32_t(buf >> (64 - k));
    buf <<= k;
    n -= k;
    return v;
  }
  bool overrun() const { return n < fake; }
  void reset_at(int64_t p) {
    pos = p;
    buf = 0;
    n = fake = 0;
    stopped = false;
    marker_pos = -1;
  }
};

inline int decode(Bits& b, const Huffman& h, int& err) {
  if (b.n < 16) b.fill();
  int e = h.look[b.buf >> (64 - kLookBits)];
  if (e) {
    int l = e >> 8;
    b.buf <<= l;
    b.n -= l;
    return e & 0xFF;
  }
  int l = kLookBits + 1;
  int32_t code = int32_t(b.buf >> (64 - l));
  while (code > h.maxcode[l]) {
    if (++l > 16) {
      err = ERR_HUFFMAN;
      return 0;
    }
    code = int32_t(b.buf >> (64 - l));
  }
  b.buf <<= l;
  b.n -= l;
  return h.huffval[(code + h.valoffset[l]) & 0xFF];
}

inline int extend(uint32_t v, int s) {
  return int(v) < (1 << (s - 1)) ? int(v) - (1 << s) + 1 : int(v);
}

// Offset of the next marker at or after ``p`` (skipping stuffed FF 00
// data bytes and whatever else precedes it, as libjpeg's next_marker
// does), or -1 at the end of the data.
int64_t next_marker(const uint8_t* data, int64_t size, int64_t p) {
  while (p + 1 < size) {
    if (data[p] != 0xFF) {
      p++;
      continue;
    }
    int64_t q = p + 1;
    while (q < size && data[q] == 0xFF) q++;
    if (q >= size) return -1;
    if (data[q] != 0) return p;
    p = q + 1;
  }
  return -1;
}

struct ScanComp {
  int16_t* coef;     // (rows, stride, 64)
  int h, v, stride;  // sampling factors, blocks per row of the plane
  int dc, ac;        // table slots
};

struct Scan {
  int ns, ss, se, ah, al, restart, mcux, mcuy, progressive;
  ScanComp comp[4];
  Huffman dc[4], ac[4];
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int err = OK;

  void block_sequential(Bits& b, int ci, int16_t* blk) {
    int s = decode(b, dc[comp[ci].dc], err);
    if (s) last_dc[ci] += extend(b.get(s), s);
    blk[0] = int16_t(last_dc[ci]);
    const Huffman& t = ac[comp[ci].ac];
    for (int k = 1; k < 64; k++) {
      if (b.n < 16) b.fill();
      const int f = t.fast[b.buf >> (64 - kLookBits)];
      if (f) {
        k += (f >> 4) & 15;
        b.buf <<= f & 15;
        b.n -= f & 15;
        blk[kNatural[k]] = int16_t(f >> 8);
        continue;
      }
      s = decode(b, t, err);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(Bits& b, int ci, int16_t* blk) {
    int s = decode(b, dc[comp[ci].dc], err);
    if (s) last_dc[ci] += extend(b.get(s), s);
    blk[0] = int16_t(uint32_t(last_dc[ci]) << al);
  }

  void block_dc_refine(Bits& b, int16_t* blk) {
    if (b.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void block_ac_first(Bits& b, int ci, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman& t = ac[comp[ci].ac];
    for (int k = ss; k <= se; k++) {
      int s = decode(b, t, err);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(uint32_t(extend(b.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        eobrun--;
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine.
  void block_ac_refine(Bits& b, int ci, int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huffman& t = ac[comp[ci].ac];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int s = decode(b, t, err);
        int r = s >> 4;
        s &= 15;
        if (s) {
          if (s != 1) err = ERR_REFINEMENT;
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (b.get(1) && (*c & p1) == 0)
              *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0 && b.get(1) && (*c & p1) == 0)
          *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
      }
      eobrun--;
    }
  }

  void block(Bits& b, int ci, int16_t* blk) {
    if (!progressive) block_sequential(b, ci, blk);
    else if (ss == 0 && ah == 0) block_dc_first(b, ci, blk);
    else if (ss == 0) block_dc_refine(b, blk);
    else if (ah == 0) block_ac_first(b, ci, blk);
    else block_ac_refine(b, ci, blk);
  }
};

// ---------------------------------------------------------------------------
// Output stages
// ---------------------------------------------------------------------------

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

// Values the descaled IDCT output (centred on 0) can take map to samples
// by clamping. jidctint.c's range-limit table clamps the same way over
// -384..383, the whole span of data a conforming encoder produces, and
// libjpeg-turbo's SIMD islow kernels (which cv2 and PIL run on x86 and
// Arm) saturate everywhere.
inline uint8_t sample(int32_t x) {
  x += 128;
  return uint8_t(std::min(std::max(x, 0), 255));
}

// jidctint.c's jpeg_idct_islow: dequantise, columns then rows, with the
// descale by CONST_BITS - PASS1_BITS after the first pass and by
// CONST_BITS + PASS1_BITS + 3 after the second. In 32-bit arithmetic
// (built with -fwrapv), as the SIMD kernels compute; the C code's wider
// JLONG gives the same values wherever neither overflows.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int32_t dc = int32_t(ip[0]) * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int32_t z2 = int32_t(ip[16]) * qp[16], z3 = int32_t(ip[48]) * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(ip[0]) * qp[0];
    z3 = int32_t(ip[32]) * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(ip[56]) * qp[56];
    tmp1 = int32_t(ip[40]) * qp[40];
    tmp2 = int32_t(ip[24]) * qp[24];
    tmp3 = int32_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      std::memset(op, sample(descale(wp[0], PASS1_BITS + 3)), 8);
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = sample(descale(tmp10 + tmp3, sh));
    op[7] = sample(descale(tmp10 - tmp3, sh));
    op[1] = sample(descale(tmp11 + tmp2, sh));
    op[6] = sample(descale(tmp11 - tmp2, sh));
    op[2] = sample(descale(tmp12 + tmp1, sh));
    op[5] = sample(descale(tmp12 - tmp1, sh));
    op[3] = sample(descale(tmp13 + tmp0, sh));
    op[4] = sample(descale(tmp13 - tmp0, sh));
  }
}

// jdcolor.c's YCbCr -> RGB in 16-bit fixed point: R = Y + Cr_r[cr],
// G = Y + ((Cb_g[cb] + Cr_g[cr]) >> 16), B = Y + Cb_b[cb], clamped to
// 0..255, with FIX(1.40200) = 91881, FIX(1.77200) = 116130,
// FIX(0.71414) = 46802, FIX(0.34414) = 22554 and ONE_HALF = 32768.
inline uint8_t clamp255(int x) {
  return uint8_t(std::min(std::max(x, 0), 255));
}

inline void ycc_rgb_pixel(int l, int cb, int cr, uint8_t* o) {
  const int b = cb - 128, r = cr - 128;
  o[0] = clamp255(l + ((91881 * r + 32768) >> 16));
  o[1] = clamp255(l + ((32768 - 22554 * b - 46802 * r) >> 16));
  o[2] = clamp255(l + ((116130 * b + 32768) >> 16));
}

void ycc_rgb_row(const uint8_t* yy, const uint8_t* cb, const uint8_t* cr,
                 uint8_t* o, int width) {
  for (int x = 0; x < width; x++) ycc_rgb_pixel(yy[x], cb[x], cr[x], o + 3 * x);
}

// One component after the IDCT: ``dw`` x ``dh`` samples in rows of
// ``stride``, upsampled by whole ratios (hr, vr) to the output.
struct Plane {
  const uint8_t* px;
  int stride, dw, dh, hr, vr;
  const uint8_t* row(int y) const {
    return px + int64_t(y < 0 ? 0 : y >= dh ? dh - 1 : y) * stride;
  }
};

// Output row ``y`` of plane ``p`` (at least ``width`` samples, in
// ``dst``, which holds 2 * dw + 8, or in the plane itself at 1:1), as
// jdsample.c's methods give it: fancy (triangle) h2v1, h1v2 and h2v2,
// the h2 ones only for inputs wider than 2 samples, and replication for
// every other ratio. Rows above the top and below ``dh`` repeat the edge
// rows, as jdmainct.c's context pointers do.
const uint8_t* upsample_row(const Plane& p, int y, int width, uint8_t* dst,
                            int* colsum) {
  const int hr = p.hr, vr = p.vr, dw = p.dw;
  if (hr == 1 && vr == 1) {
    return p.row(y);
  } else if (hr == 1 && vr == 2) {
    const int iy = y >> 1, odd = y & 1;
    const uint8_t* a = p.row(iy);
    const uint8_t* b = p.row(odd ? iy + 1 : iy - 1);
    const int bias = odd ? 2 : 1;
    for (int x = 0; x < width; x++) dst[x] = uint8_t((a[x] * 3 + b[x] + bias) >> 2);
  } else if (hr == 2 && vr == 1 && dw > 2) {
    const uint8_t* in = p.row(y);
    dst[0] = in[0];
    dst[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; i++) {
      const int v = in[i] * 3;
      dst[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
      dst[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
    }
    const int i = dw - 1;
    dst[2 * i] = uint8_t((in[i] * 3 + in[i - 1] + 1) >> 2);
    dst[2 * i + 1] = in[i];
  } else if (hr == 2 && vr == 2 && dw > 2) {
    const int iy = y >> 1, odd = y & 1;
    const uint8_t* a = p.row(iy);
    const uint8_t* b = p.row(odd ? iy + 1 : iy - 1);
    const int* cs = colsum;
    for (int i = 0; i < dw; i++) colsum[i] = a[i] * 3 + b[i];
    dst[0] = uint8_t((cs[0] * 4 + 8) >> 4);
    dst[1] = uint8_t((cs[0] * 3 + cs[1] + 7) >> 4);
    for (int i = 1; i < dw - 1; i++) {
      dst[2 * i] = uint8_t((cs[i] * 3 + cs[i - 1] + 8) >> 4);
      dst[2 * i + 1] = uint8_t((cs[i] * 3 + cs[i + 1] + 7) >> 4);
    }
    const int i = dw - 1;
    dst[2 * i] = uint8_t((cs[i] * 3 + cs[i - 1] + 8) >> 4);
    dst[2 * i + 1] = uint8_t((cs[i] * 4 + 7) >> 4);
  } else {
    const uint8_t* in = p.row(y / vr);
    for (int x = 0; x < width; x++) dst[x] = in[x / hr];
  }
  return dst;
}

}  // namespace

extern "C" {

// Decode one scan. ``desc``: ns, Ss, Se, Ah, Al, restart interval, MCUs
// a row, MCU rows (of one block each in a non-interleaved scan),
// progressive, then per component in scan order h, v, plane stride
// (blocks), DC slot, AC slot. ``tables``: 8 slots (DC 0-3,
// AC 0-3) of 16 counts + 256 symbols. ``coefs``: each scan component's
// int16 plane. Writes to ``end`` the offset of the marker after the
// scan's data. Returns 0 or an error code.
int jpeg_decode_scan(const uint8_t* data, int64_t size, int64_t start,
                     const int32_t* desc, const uint8_t* tables,
                     void** coefs, int64_t* end) {
  static thread_local Scan sc;
  sc = Scan();
  sc.ns = desc[0];
  sc.ss = desc[1];
  sc.se = desc[2];
  sc.ah = desc[3];
  sc.al = desc[4];
  sc.restart = desc[5];
  sc.mcux = desc[6];
  sc.mcuy = desc[7];
  sc.progressive = desc[8];
  if (sc.ns < 1 || sc.ns > 4) return ERR_BAD_ARGS;
  for (int i = 0; i < sc.ns; i++) {
    const int32_t* d = desc + 9 + 5 * i;
    ScanComp& c = sc.comp[i];
    c.coef = static_cast<int16_t*>(coefs[i]);
    c.h = d[0];
    c.v = d[1];
    c.stride = d[2];
    c.dc = d[3];
    c.ac = d[4];
    if (c.dc < 0 || c.dc > 3 || c.ac < 0 || c.ac > 3) return ERR_BAD_ARGS;
  }
  for (int t = 0; t < 4; t++) {
    const uint8_t* dc = tables + t * 272;
    const uint8_t* ac = tables + (4 + t) * 272;
    if (!sc.dc[t].build(dc) || !sc.ac[t].build(ac)) return ERR_HUFFMAN;
  }
  Bits b{data, size, start};
  int restart_num = 0, to_go = sc.restart;
  const int64_t total = int64_t(sc.mcux) * sc.mcuy;
  const bool interleaved = sc.ns > 1;
  for (int64_t m = 0; m < total; m++) {
    if (sc.restart) {
      if (to_go == 0) {
        if (b.overrun()) return ERR_TRUNCATED;
        int64_t mp = b.marker_pos >= 0 ? b.marker_pos
                                       : next_marker(data, size, b.pos);
        if (mp < 0) return ERR_TRUNCATED;
        int64_t q = mp + 1;
        while (data[q] == 0xFF) q++;
        if (data[q] != 0xD0 + (restart_num & 7)) return ERR_RESTART;
        restart_num++;
        b.reset_at(q + 1);
        std::memset(sc.last_dc, 0, sizeof(sc.last_dc));
        sc.eobrun = 0;
        to_go = sc.restart;
      }
      to_go--;
    }
    const int my = int(m / sc.mcux), mx = int(m % sc.mcux);
    if (interleaved) {
      for (int ci = 0; ci < sc.ns; ci++) {
        const ScanComp& c = sc.comp[ci];
        for (int by = 0; by < c.v; by++)
          for (int bx = 0; bx < c.h; bx++) {
            int64_t idx = int64_t(my * c.v + by) * c.stride + mx * c.h + bx;
            sc.block(b, ci, c.coef + idx * 64);
          }
      }
    } else {
      const ScanComp& c = sc.comp[0];
      sc.block(b, 0, c.coef + (int64_t(my) * c.stride + mx) * 64);
    }
    if (sc.err) return sc.err;
  }
  if (b.overrun()) return ERR_TRUNCATED;
  int64_t mp = b.marker_pos >= 0 ? b.marker_pos : next_marker(data, size, b.pos);
  if (mp < 0) return ERR_TRUNCATED;
  *end = mp;
  return OK;
}

// Dequantise, IDCT, upsample and convert. ``desc``: components used,
// width, height, max h, max v, mode (0 gray: component 0; 1 RGB from
// YCbCr; 2 RGB from one component), then per component h, v, plane
// stride (blocks). ``quant``: 64 natural-order values a component.
// ``out``: (height, width) for mode 0, else (height, width, 3).
int jpeg_output(const int32_t* desc, void** coefs, const uint16_t* quant,
                uint8_t* out) {
  const int nc = desc[0], width = desc[1], height = desc[2];
  const int max_h = desc[3], max_v = desc[4], mode = desc[5];
  if (nc < 1 || nc > 3 || width < 1 || height < 1) return ERR_BAD_ARGS;
  std::vector<std::vector<uint8_t>> px(nc);
  std::vector<Plane> planes(nc);
  for (int ci = 0; ci < nc; ci++) {
    const int h = desc[6 + 3 * ci], v = desc[7 + 3 * ci];
    if (h < 1 || v < 1 || max_h % h || max_v % v) return ERR_BAD_ARGS;
    Plane& p = planes[ci];
    p.dw = int((int64_t(width) * h + max_h - 1) / max_h);
    p.dh = int((int64_t(height) * v + max_v - 1) / max_v);
    p.hr = max_h / h;
    p.vr = max_v / v;
    p.stride = (p.dw + 7) / 8 * 8;
    px[ci].resize(size_t(p.stride) * ((p.dh + 7) / 8) * 8);
    p.px = px[ci].data();
    for (int by = 0; by < (p.dh + 7) / 8; by++) {
      const int16_t* cf = static_cast<const int16_t*>(coefs[ci]) +
                          int64_t(by) * desc[8 + 3 * ci] * 64;
      uint8_t* dst = px[ci].data() + int64_t(by) * 8 * p.stride;
      for (int bx = 0; bx < p.stride / 8; bx++)
        idct_islow(cf + bx * 64, quant + 64 * ci, dst + bx * 8, p.stride);
    }
  }
  const size_t row = width + 16;  // upsampled samples a component
  std::vector<uint8_t> rows(nc * row);
  std::vector<int> colsum(width + 16);
  for (int y = 0; y < height; y++) {
    const uint8_t* r[3];
    for (int ci = 0; ci < nc; ci++)
      r[ci] = upsample_row(planes[ci], y, width, rows.data() + ci * row,
                           colsum.data());
    if (mode == 0) {
      std::memcpy(out + int64_t(y) * width, r[0], width);
    } else if (mode == 2) {
      uint8_t* o = out + int64_t(y) * width * 3;
      for (int x = 0; x < width; x++)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r[0][x];
    } else {
      ycc_rgb_row(r[0], r[1], r[2], out + int64_t(y) * width * 3, width);
    }
  }
  return OK;
}

}  // extern "C"
