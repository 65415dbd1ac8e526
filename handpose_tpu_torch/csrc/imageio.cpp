// Batched PNG/JPEG decode and PNG/JPEG writers for the host data loader.
//
// Counterpart of native/fastdecode.cpp (a thread pool that decodes a whole
// batch into one preallocated (B, H, W, C) uint8 buffer, called through
// ctypes so the interpreter lock is released for the whole batch), written
// against zlib alone: the card's host has zlib but neither libpng nor
// libjpeg.  So this file carries its own codecs.
//
// * PNG: chunk parse with CRC checks, zlib inflate, the five row filters,
//   bit depths 1-16, gray/RGB/palette with or without alpha.  Alpha is
//   dropped and 16-bit samples keep their high byte, as cv2.imread does.
//   Lossless, so the pixels equal any conforming decoder's.
// * JPEG: baseline and extended sequential Huffman, 8-bit, 1 or 3
//   components, any sampling factors up to 2, restart intervals.  It
//   follows libjpeg-turbo's default decompression path step by step --
//   the accurate integer IDCT (jidctint.c), "fancy" triangle upsampling
//   of the chroma planes with edge rows replicated (jdsample.c,
//   jdmainct.c), and the fixed-point YCbCr->RGB tables (jdcolor.c) -- so
//   its pixels are bit-identical to cv2.imread's and to the JAX package's
//   decoder.  Progressive and arithmetic-coded files raise.
// * Writers: PNG (gray or RGB, zlib level 1, per-row adaptive filter) and
//   baseline JPEG (4:2:0 for RGB, the IJG quality scaling of the standard
//   tables, standard Huffman tables), the counterparts of cv2.imwrite.
//
// Build (handpose_tpu_torch/ops/cuda_build.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libimageio-<hash>.so imageio.cpp \
//       -lz -lpthread

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Fail{m}; }

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  buf->resize((size_t)n);
  size_t got = n ? std::fread(buf->data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n;
}

// The destination of one decoded image: the top-left h x w of a padded
// (Ht, Wt, C) slot; the rest of the slot is zeroed.
struct Dest {
  uint8_t* base;
  int h, w;      // the size the caller expects
  int Ht, Wt, C;
  uint8_t* row(int y) const { return base + (size_t)y * Wt * C; }
};

void check_size(const Dest& d, int h, int w) {
  if (h != d.h || w != d.w)
    fail("image is " + std::to_string(h) + "x" + std::to_string(w) +
         " (h x w), expected " + std::to_string(d.h) + "x" +
         std::to_string(d.w));
}

void zero_padding(const Dest& d) {
  if (d.w < d.Wt)
    for (int y = 0; y < d.h; ++y)
      std::memset(d.row(y) + (size_t)d.w * d.C, 0,
                  (size_t)(d.Wt - d.w) * d.C);
  for (int y = d.h; y < d.Ht; ++y) std::memset(d.row(y), 0, (size_t)d.Wt * d.C);
}

// ======================================================================
// PNG
// ======================================================================

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Undo one row's filter in place (PNG spec section 9); prev is the
// previous row, already un-filtered, or null for the first row.
void unfilter_row(int ft, uint8_t* cur, const uint8_t* prev, size_t n,
                  size_t bpp) {
  switch (ft) {
    case 0:
      return;
    case 1:
      for (size_t i = bpp; i < n; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return;
    case 2:
      if (prev)
        for (size_t i = 0; i < n; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
      return;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        cur[i] = (uint8_t)(cur[i] + ((a + b) >> 1));
      }
      return;
    case 4:
      if (!prev) {                      // Paeth(a, 0, 0) == a: Sub
        for (size_t i = bpp; i < n; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        return;
      }
      for (size_t i = 0; i < bpp && i < n; ++i)   // Paeth(0, b, 0) == b
        cur[i] = (uint8_t)(cur[i] + prev[i]);
      for (size_t i = bpp; i < n; ++i)
        cur[i] = (uint8_t)(cur[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
      return;
    default:
      fail("corrupt PNG: bad filter type");
  }
}

void decode_png(const std::vector<uint8_t>& f, const Dest& d) {
  size_t pos = 8;
  int W = 0, H = 0, depth = 0, ctype = -1, interlace = 0;
  std::vector<uint8_t> idat, plte;
  bool seen_end = false;
  while (pos + 12 <= f.size()) {
    uint32_t len = be32(&f[pos]);
    if (len > f.size() - pos - 12) fail("corrupt PNG: chunk runs past the file");
    const uint8_t* type = &f[pos + 4];
    const uint8_t* body = &f[pos + 8];
    uint32_t crc = be32(&f[pos + 8 + len]);
    if ((uint32_t)crc32(0L, type, len + 4) != crc) fail("corrupt PNG: CRC mismatch");
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) fail("corrupt PNG: bad IHDR");
      W = (int)be32(body);
      H = (int)be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
    } else if (!std::memcmp(type, "PLTE", 4)) {
      plte.assign(body, body + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      seen_end = true;
      break;
    }
    pos += 12 + len;
  }
  if (ctype < 0) fail("corrupt PNG: no IHDR");
  if (!seen_end) fail("corrupt PNG: truncated (no IEND)");
  if (interlace) fail("unsupported PNG: Adam7 interlacing");
  int chans;
  switch (ctype) {
    case 0: chans = 1; break;
    case 2: chans = 3; break;
    case 3: chans = 1; break;
    case 4: chans = 2; break;
    case 6: chans = 4; break;
    default: fail("corrupt PNG: bad colour type");
  }
  bool depth_ok = depth == 8 || depth == 16 ||
                  ((ctype == 0 || ctype == 3) && (depth == 1 || depth == 2 ||
                                                  depth == 4));
  if (!depth_ok || (ctype == 3 && depth == 16)) fail("corrupt PNG: bad bit depth");
  if (ctype == 3 && plte.empty()) fail("corrupt PNG: palette image without PLTE");
  check_size(d, H, W);
  if (d.C == 1 && (ctype == 2 || ctype == 3 || ctype == 6))
    fail("unsupported PNG: colour image read as gray");

  const size_t bits_px = (size_t)chans * depth;
  const size_t rowbytes = ((size_t)W * bits_px + 7) / 8;
  const size_t bpp = std::max<size_t>(1, bits_px / 8);
  std::vector<uint8_t> raw((rowbytes + 1) * H);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) fail("zlib inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = (uInt)idat.size();
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zr = inflate(&zs, Z_FINISH);
  size_t produced = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if ((zr != Z_STREAM_END && zr != Z_BUF_ERROR) || produced != raw.size())
    fail("corrupt PNG: image data does not inflate to its size");

  // rows are un-filtered in place: each row's predecessor is the row
  // before it in the inflated buffer
  const uint8_t* prev = nullptr;
  for (int y = 0; y < H; ++y) {
    uint8_t* cur = &raw[(size_t)y * (rowbytes + 1)] + 1;
    unfilter_row(cur[-1], cur, prev, rowbytes, bpp);
    prev = cur;
    uint8_t* out = d.row(y);
    if (depth == 8 && ((ctype == 2 && d.C == 3) || (ctype == 0 && d.C == 1))) {
      std::memcpy(out, cur, rowbytes);
      continue;
    }
    auto sample = [&](size_t idx) -> int {   // idx-th sample of the row
      if (depth == 8) return cur[idx];
      if (depth == 16) return cur[2 * idx];  // high byte, as cv2
      size_t bit = idx * depth;
      int v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
      return v;
    };
    for (int x = 0; x < W; ++x) {
      if (ctype == 3) {
        int i = sample((size_t)x);
        if ((size_t)(3 * i + 2) >= plte.size()) fail("corrupt PNG: palette index out of range");
        for (int k = 0; k < 3; ++k) out[3 * x + k] = plte[3 * i + k];
        continue;
      }
      if (ctype == 0 || ctype == 4) {
        int g = sample((size_t)x * chans);
        if (depth < 8) g = g * 255 / ((1 << depth) - 1);
        if (d.C == 1) {
          out[x] = (uint8_t)g;
        } else {
          out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = (uint8_t)g;
        }
        continue;
      }
      for (int k = 0; k < 3; ++k)                // RGB or RGBA
        out[3 * x + k] = (uint8_t)sample((size_t)x * chans + k);
    }
  }
}

// ======================================================================
// JPEG decode
// ======================================================================

int kNatural[64 + 16];   // zigzag position -> natural (row-major) index

void init_zigzag() {
  int k = 0;
  for (int s = 0; s < 15; ++s) {
    if (s % 2 == 0) {
      for (int r = std::min(s, 7); r >= std::max(0, s - 7); --r)
        kNatural[k++] = r * 8 + (s - r);
    } else {
      for (int r = std::max(0, s - 7); r <= std::min(s, 7); ++r)
        kNatural[k++] = r * 8 + (s - r);
    }
  }
  for (int i = 64; i < 80; ++i) kNatural[i] = 63;   // overrun guard, as libjpeg
}

struct Huff {
  bool defined = false;
  uint8_t lookup_len[512];   // 9-bit fast path: code length (0: slow path)
  uint8_t lookup_val[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_huff(Huff* h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memcpy(h->vals, vals, nvals);
  std::memset(h->lookup_len, 0, sizeof h->lookup_len);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h->valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          h->lookup_len[(code << shift) | j] = (uint8_t)len;
          h->lookup_val[(code << shift) | j] = vals[k];
        }
      }
    }
    h->maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  h->defined = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker && p < end) {
        if (*p == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;   // fill bytes
          if (q < end && *q == 0x00) {
            byte = 0xFF;
            p = q + 1;
          } else {
            hit_marker = true;                 // zeros past a marker, as libjpeg
            p = q - 1;
          }
        } else {
          byte = *p++;
        }
      }
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int decode(const Huff& h) {
    if (nbits < 16) fill();
    int look = (int)(acc >> (64 - 9));
    int len = h.lookup_len[look];
    if (len) {
      acc <<= len;
      nbits -= len;
      return h.lookup_val[look];
    }
    int code = (int)(acc >> (64 - 10));
    len = 10;
    while (code > h.maxcode[len]) {
      ++len;
      if (len > 16) fail("corrupt JPEG: bad Huffman code");
      code = (int)(acc >> (64 - len));
    }
    acc <<= len;
    nbits -= len;
    return h.vals[(code + h.valoffset[len]) & 0xFF];
  }
  // restart: drop the partial byte, step over the RSTn marker
  void restart() {
    acc = 0;
    nbits = 0;
    if (hit_marker) {
      // p sits on the 0xFF of the marker
      if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
      hit_marker = false;
    } else {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
      if (p + 1 < end) p += 2;
    }
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// libjpeg's range-limit table after the IDCT: x -> clamp(x + 128), indexed
// by x & 1023 (wrapping beyond +-512 as libjpeg's table does).
uint8_t kIdctLimit[1024];
// jdcolor.c's tables
int kCrR[256], kCbB[256], kCrG[256], kCbG[256];

void init_tables() {
  for (int i = 0; i < 1024; ++i) {
    int x = i < 512 ? i : i - 1024;
    kIdctLimit[i] = (uint8_t)std::min(255, std::max(0, x + 128));
  }
  const int SCALEBITS = 16;
  const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
  auto FIX = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    kCrR[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    kCbB[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    kCrG[i] = -FIX(0.71414) * x;
    kCbG[i] = -FIX(0.34414) * x + ONE_HALF;
  }
  init_zigzag();
}

// jidctint.c jpeg_idct_islow, one block, into out with stride.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const int CONST_BITS = 13, PASS1_BITS = 2;
  const int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  auto DESCALE = [](int32_t x, int n) { return (x + (1 << (n - 1))) >> n; };
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (in[0] * qt[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
    int32_t z1 = (z2 + z3) * F0_541;
    int32_t tmp2 = z1 + z3 * (-F1_847);
    int32_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0] * qt[0];
    z3 = in[32] * qt[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qt[56];
    tmp1 = in[40] * qt[40];
    tmp2 = in[24] * qt[24];
    tmp3 = in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    w[0] = DESCALE(tmp10 + tmp3, n);
    w[56] = DESCALE(tmp10 - tmp3, n);
    w[8] = DESCALE(tmp11 + tmp2, n);
    w[48] = DESCALE(tmp11 - tmp2, n);
    w[16] = DESCALE(tmp12 + tmp1, n);
    w[40] = DESCALE(tmp12 - tmp1, n);
    w[24] = DESCALE(tmp13 + tmp0, n);
    w[32] = DESCALE(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    const int n = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kIdctLimit[DESCALE(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * F0_541;
    int32_t tmp2 = z1 + z3 * (-F1_847);
    int32_t tmp3 = z1 + z2 * F0_765;
    int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kIdctLimit[DESCALE(tmp10 + tmp3, n) & 1023];
    o[7] = kIdctLimit[DESCALE(tmp10 - tmp3, n) & 1023];
    o[1] = kIdctLimit[DESCALE(tmp11 + tmp2, n) & 1023];
    o[6] = kIdctLimit[DESCALE(tmp11 - tmp2, n) & 1023];
    o[2] = kIdctLimit[DESCALE(tmp12 + tmp1, n) & 1023];
    o[5] = kIdctLimit[DESCALE(tmp12 - tmp1, n) & 1023];
    o[3] = kIdctLimit[DESCALE(tmp13 + tmp0, n) & 1023];
    o[4] = kIdctLimit[DESCALE(tmp13 - tmp0, n) & 1023];
  }
}

struct Comp {
  int id, h, v, tq;
  int dw, dh;           // downsampled_width / _height (jdinput.c)
  int bw, bh;           // plane size in blocks (whole MCUs)
  std::vector<uint8_t> plane;   // (bh*8) x (bw*8) decoded samples
  int td = 0, ta = 0, pred = 0;
};

// One component's plane brought to full resolution (W x H), as
// libjpeg-turbo's upsampler does with do_fancy_upsampling (its default).
void upsample(const Comp& c, int hmax, int vmax, int W, int H,
              std::vector<uint8_t>* out) {
  const int pw = c.bw * 8;
  out->resize((size_t)W * H);
  const int hr = hmax / c.h, vr = vmax / c.v;
  if (hmax % c.h || vmax % c.v) fail("unsupported JPEG: fractional sampling ratio");
  auto in_row = [&](int r) {           // edge rows replicated (jdmainct.c)
    r = std::max(0, std::min(r, c.dh - 1));
    return &c.plane[(size_t)r * pw];
  };
  std::vector<uint8_t> tmp((size_t)2 * c.dw + 2);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = &(*out)[(size_t)y * W];
    if (hr == 1 && vr == 1) {
      std::memcpy(o, in_row(y), W);
    } else if (hr == 2 && vr == 1 && c.dw > 2) {          // h2v1_fancy
      const uint8_t* in = in_row(y);
      uint8_t* t = tmp.data();
      t[0] = in[0];
      t[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < c.dw - 1; ++i) {
        int v = in[i] * 3;
        t[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        t[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      int l = c.dw - 1;
      t[2 * l] = (uint8_t)((in[l] * 3 + in[l - 1] + 1) >> 2);
      t[2 * l + 1] = in[l];
      std::memcpy(o, t, W);
    } else if (hr == 2 && vr == 2 && c.dw > 2) {          // h2v2_fancy
      const int i = y / 2;
      const uint8_t* in0 = in_row(i);
      const uint8_t* in1 = in_row(y % 2 == 0 ? i - 1 : i + 1);
      uint8_t* t = tmp.data();
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      t[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      t[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int k = 1; k < c.dw - 1; ++k) {
        next_sum = in0[k + 1] * 3 + in1[k + 1];
        t[2 * k] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        t[2 * k + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      int l = c.dw - 1;
      t[2 * l] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      t[2 * l + 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(o, t, W);
    } else if (hr == 1 && vr == 2) {                      // h1v2_fancy
      const int i = y / 2;
      const uint8_t* in0 = in_row(i);
      const bool up = y % 2 == 0;
      const uint8_t* in1 = in_row(up ? i - 1 : i + 1);
      const int bias = up ? 1 : 2;
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {                                              // int_upsample
      const uint8_t* in = &c.plane[(size_t)std::min(y / vr, c.bh * 8 - 1) * pw];
      for (int x = 0; x < W; ++x) o[x] = in[x / hr];
    }
  }
}

void decode_jpeg(const std::vector<uint8_t>& f, const Dest& d) {
  if (f.size() < 4 || f[0] != 0xFF || f[1] != 0xD8) fail("not a PNG or JPEG file");
  uint16_t qt[4][64];
  bool qt_def[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
  int W = 0, H = 0, hmax = 1, vmax = 1, restart = 0;
  bool frame = false, done = false, adobe = false, adobe_rgb = false;
  size_t pos = 2;
  auto u16 = [&](size_t p) {
    if (p + 2 > f.size()) fail("corrupt JPEG: truncated");
    return (f[p] << 8) | f[p + 1];
  };
  while (!done) {
    while (pos < f.size() && f[pos] != 0xFF) ++pos;     // garbage before a marker
    while (pos < f.size() && f[pos] == 0xFF) ++pos;
    if (pos >= f.size()) fail("corrupt JPEG: truncated (no EOI)");
    int m = f[pos++];
    if (m == 0xD9) break;                                 // EOI
    if (m >= 0xD0 && m <= 0xD7) continue;                 // stray RSTn
    int len = u16(pos);
    if (len < 2 || pos + len > f.size()) fail("corrupt JPEG: segment runs past the file");
    const uint8_t* s = &f[pos + 2];
    const int n = len - 2;
    if (m == 0xDB) {                                      // DQT
      int i = 0;
      while (i < n) {
        int pq = s[i] >> 4, tq = s[i] & 15;
        if (tq > 3 || i + 1 + 64 * (pq + 1) > n) fail("corrupt JPEG: bad DQT");
        for (int k = 0; k < 64; ++k)
          qt[tq][kNatural[k]] = pq ? (uint16_t)((s[i + 1 + 2 * k] << 8) | s[i + 2 + 2 * k])
                                   : s[i + 1 + k];
        qt_def[tq] = true;
        i += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xC4) {                               // DHT
      int i = 0;
      while (i < n) {
        if (i + 17 > n) fail("corrupt JPEG: bad DHT");
        int tc = s[i] >> 4, th = s[i] & 15;
        int total = 0;
        for (int k = 0; k < 16; ++k) total += s[i + 1 + k];
        if (th > 3 || tc > 1 || total > 256 || i + 17 + total > n)
          fail("corrupt JPEG: bad DHT");
        build_huff(tc ? &ac[th] : &dc[th], s + i + 1, s + i + 17, total);
        i += 17 + total;
      }
    } else if (m == 0xC0 || m == 0xC1) {                  // SOF0/1
      if (n < 6 || s[0] != 8) fail("unsupported JPEG: sample precision other than 8 bits");
      H = (s[1] << 8) | s[2];
      W = (s[3] << 8) | s[4];
      int nf = s[5];
      if (H == 0 || W == 0) fail("unsupported JPEG: zero height (DNL)");
      if (nf != 1 && nf != 3) fail("unsupported JPEG: " + std::to_string(nf) + " components");
      if (n < 6 + 3 * nf) fail("corrupt JPEG: bad SOF");
      check_size(d, H, W);
      for (int k = 0; k < nf; ++k) {
        Comp c;
        c.id = s[6 + 3 * k];
        c.h = s[7 + 3 * k] >> 4;
        c.v = s[7 + 3 * k] & 15;
        c.tq = s[8 + 3 * k];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
          fail("corrupt JPEG: bad sampling factors");
        comps.push_back(c);
        hmax = std::max(hmax, c.h);
        vmax = std::max(vmax, c.v);
      }
      const int mcux = (W + 8 * hmax - 1) / (8 * hmax);
      const int mcuy = (H + 8 * vmax - 1) / (8 * vmax);
      for (auto& c : comps) {
        c.dw = (int)(((long)W * c.h + hmax - 1) / hmax);
        c.dh = (int)(((long)H * c.v + vmax - 1) / vmax);
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
      }
      frame = true;
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      fail(m == 0xC2 ? "unsupported JPEG: progressive" : "unsupported JPEG: coding process");
    } else if (m == 0xDD) {                               // DRI
      if (n < 2) fail("corrupt JPEG: bad DRI");
      restart = (s[0] << 8) | s[1];
    } else if (m == 0xEE) {                               // APP14 Adobe
      if (n >= 12 && !std::memcmp(s, "Adobe", 5)) {
        adobe = true;
        adobe_rgb = s[11] == 0;
      }
    } else if (m == 0xDA) {                               // SOS
      if (!frame) fail("corrupt JPEG: scan before frame");
      int ns = s[0];
      if (ns < 1 || ns > 4 || n < 1 + 2 * ns + 3) fail("corrupt JPEG: bad SOS");
      std::vector<Comp*> sc;
      for (int k = 0; k < ns; ++k) {
        int id = s[1 + 2 * k];
        Comp* c = nullptr;
        for (auto& cc : comps)
          if (cc.id == id) c = &cc;
        if (!c) fail("corrupt JPEG: scan names an unknown component");
        c->td = s[2 + 2 * k] >> 4;
        c->ta = s[2 + 2 * k] & 15;
        if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
          fail("corrupt JPEG: missing Huffman table");
        if (!qt_def[c->tq]) fail("corrupt JPEG: missing quantisation table");
        c->pred = 0;
        sc.push_back(c);
      }
      if (s[1 + 2 * ns] != 0 || s[2 + 2 * ns] != 63) fail("unsupported JPEG: spectral selection");
      pos += len;
      BitReader br{&f[pos], f.data() + f.size()};
      alignas(16) int16_t blk[64];
      auto decode_block = [&](Comp* c, int bx, int by) {
        std::memset(blk, 0, sizeof blk);
        int t = br.decode(dc[c->td]);
        if (t > 16) fail("corrupt JPEG: bad DC magnitude");
        int diff = t ? extend(br.bits(t), t) : 0;
        c->pred += diff;
        blk[0] = (int16_t)c->pred;
        for (int k = 1; k < 64; ++k) {
          int rs = br.decode(ac[c->ta]);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            blk[kNatural[k]] = (int16_t)extend(br.bits(sz), sz);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        const int pw = c->bw * 8;
        idct_islow(blk, qt[c->tq], &c->plane[(size_t)by * 8 * pw + bx * 8], pw);
      };
      int todo = restart;
      auto maybe_restart = [&]() {
        if (!restart) return;
        if (todo == 0) {
          br.restart();
          for (Comp* c : sc) c->pred = 0;
          todo = restart;
        }
        --todo;
      };
      if (ns == 1) {                                      // non-interleaved
        Comp* c = sc[0];
        const int nbx = (c->dw + 7) / 8, nby = (c->dh + 7) / 8;
        for (int by = 0; by < nby; ++by)
          for (int bx = 0; bx < nbx; ++bx) {
            maybe_restart();
            decode_block(c, bx, by);
          }
      } else {
        const int mcux = (W + 8 * hmax - 1) / (8 * hmax);
        const int mcuy = (H + 8 * vmax - 1) / (8 * vmax);
        for (int my = 0; my < mcuy; ++my)
          for (int mx = 0; mx < mcux; ++mx) {
            maybe_restart();
            for (Comp* c : sc)
              for (int j = 0; j < c->v; ++j)
                for (int i = 0; i < c->h; ++i)
                  decode_block(c, mx * c->h + i, my * c->v + j);
          }
      }
      // step to the next marker after the entropy-coded data
      const uint8_t* q = br.p;
      pos = (size_t)(q - f.data());
      while (pos + 1 < f.size() &&
             !(f[pos] == 0xFF && f[pos + 1] != 0x00 &&
               !(f[pos + 1] >= 0xD0 && f[pos + 1] <= 0xD7)))
        ++pos;
      continue;
    }
    pos += len;
  }
  if (!frame) fail("corrupt JPEG: no frame");

  const bool rgb_space = comps.size() == 3 &&
      ((adobe && adobe_rgb) ||
       (!adobe && comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B'));
  if (d.C == 1) {
    if (comps.size() == 3 && rgb_space) fail("unsupported JPEG: RGB file read as gray");
    std::vector<uint8_t> y;
    upsample(comps[0], hmax, vmax, W, H, &y);
    for (int r = 0; r < H; ++r) std::memcpy(d.row(r), &y[(size_t)r * W], W);
    return;
  }
  std::vector<uint8_t> p0, p1, p2;
  upsample(comps[0], hmax, vmax, W, H, &p0);
  if (comps.size() == 1) {
    for (int r = 0; r < H; ++r) {
      uint8_t* o = d.row(r);
      const uint8_t* g = &p0[(size_t)r * W];
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
    }
    return;
  }
  upsample(comps[1], hmax, vmax, W, H, &p1);
  upsample(comps[2], hmax, vmax, W, H, &p2);
  for (int r = 0; r < H; ++r) {
    uint8_t* o = d.row(r);
    const size_t off = (size_t)r * W;
    for (int x = 0; x < W; ++x) {
      int a = p0[off + x], b = p1[off + x], c = p2[off + x];
      if (rgb_space) {
        o[3 * x] = (uint8_t)a;
        o[3 * x + 1] = (uint8_t)b;
        o[3 * x + 2] = (uint8_t)c;
        continue;
      }
      auto lim = [](int v) { return (uint8_t)std::min(255, std::max(0, v)); };
      o[3 * x] = lim(a + kCrR[c]);
      o[3 * x + 1] = lim(a + ((kCbG[b] + kCrG[c]) >> 16));
      o[3 * x + 2] = lim(a + kCbB[b]);
    }
  }
}

void decode_any(const char* path, const Dest& d) {
  std::vector<uint8_t> f;
  if (!read_file(path, &f)) fail("cannot read the file");
  if (f.size() >= 8 && !std::memcmp(f.data(), kPngSig, 8)) {
    decode_png(f, d);
  } else {
    decode_jpeg(f, d);
  }
  zero_padding(d);
}

// ======================================================================
// Writers
// ======================================================================

struct Out {
  std::vector<uint8_t> b;
  void put(uint8_t v) { b.push_back(v); }
  void put16(int v) {
    put((uint8_t)(v >> 8));
    put((uint8_t)v);
  }
  void put32(uint32_t v) {
    put16((int)(v >> 16));
    put16((int)(v & 0xFFFF));
  }
};

void write_file(const char* path, const std::vector<uint8_t>& b) {
  FILE* f = std::fopen(path, "wb");
  if (!f) fail("cannot open for writing");
  size_t put = std::fwrite(b.data(), 1, b.size(), f);
  int rc = std::fclose(f);
  if (put != b.size() || rc != 0) fail("write failed");
}

void png_chunk(Out* o, const char* type, const uint8_t* data, size_t n) {
  o->put32((uint32_t)n);
  size_t start = o->b.size();
  o->b.insert(o->b.end(), type, type + 4);
  if (n) o->b.insert(o->b.end(), data, data + n);
  o->put32((uint32_t)crc32(0L, &o->b[start], (uInt)(n + 4)));
}

void write_png_impl(const char* path, const uint8_t* img, int H, int W, int C) {
  if (C != 1 && C != 3) fail("PNG writer takes 1 or 3 channels");
  const size_t rb = (size_t)W * C;
  std::vector<uint8_t> filt((rb + 1) * H);
  std::vector<uint8_t> cand(rb);
  for (int y = 0; y < H; ++y) {
    const uint8_t* cur = img + (size_t)y * rb;
    const uint8_t* up = y ? cur - rb : nullptr;
    uint8_t* dst = &filt[(size_t)y * (rb + 1)];
    long best = -1;
    for (int ft = 0; ft < 5; ++ft) {             // least sum of |signed byte|
      long cost = 0;
      for (size_t i = 0; i < rb; ++i) {
        int a = i >= (size_t)C ? cur[i - C] : 0;
        int b = up ? up[i] : 0;
        int c = (up && i >= (size_t)C) ? up[i - C] : 0;
        int p = ft == 0 ? 0 : ft == 1 ? a : ft == 2 ? b : ft == 3 ? (a + b) >> 1
                                                                  : paeth(a, b, c);
        uint8_t v = (uint8_t)(cur[i] - p);
        cand[i] = v;
        cost += v < 128 ? v : 256 - v;
      }
      if (best < 0 || cost < best) {
        best = cost;
        dst[0] = (uint8_t)ft;
        std::memcpy(dst + 1, cand.data(), rb);
      }
    }
  }
  uLongf zn = compressBound((uLong)filt.size());
  std::vector<uint8_t> z(zn);
  if (compress2(z.data(), &zn, filt.data(), (uLong)filt.size(), 1) != Z_OK)
    fail("zlib compress failed");
  Out o;
  o.b.insert(o.b.end(), kPngSig, kPngSig + 8);
  uint8_t ihdr[13];
  for (int k = 0; k < 4; ++k) {
    ihdr[k] = (uint8_t)((uint32_t)W >> (24 - 8 * k));
    ihdr[4 + k] = (uint8_t)((uint32_t)H >> (24 - 8 * k));
  }
  ihdr[8] = 8;
  ihdr[9] = C == 3 ? 2 : 0;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  png_chunk(&o, "IHDR", ihdr, 13);
  png_chunk(&o, "IDAT", z.data(), zn);
  png_chunk(&o, "IEND", nullptr, 0);
  write_file(path, o.b);
}

// Standard tables of ITU-T T.81 Annex K.
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t len[256];
};

void build_enc(EncTable* t, const uint8_t* bits, const uint8_t* vals) {
  std::memset(t->len, 0, sizeof t->len);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      t->code[vals[k]] = (uint16_t)code;
      t->len[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct BitWriter {
  Out* o;
  uint32_t acc = 0;
  int n = 0;
  void put(uint32_t v, int len) {
    for (int i = len - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) {
        o->put((uint8_t)acc);
        if ((acc & 0xFF) == 0xFF) o->put(0);            // byte stuffing
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {
    while (n) put(1, 1);                                 // pad with 1 bits
  }
};

int bit_size(int v) {
  v = std::abs(v);
  int s = 0;
  while (v) {
    ++s;
    v >>= 1;
  }
  return s;
}

void encode_block(BitWriter* bw, const float* px, const uint16_t* q, int* pred,
                  const EncTable& dct, const EncTable& act) {
  // orthonormal 2-D DCT-II of the level-shifted block, then quantisation
  static thread_local float cosv[8][8];
  static thread_local bool init = false;
  if (!init) {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        cosv[u][x] = (float)((u ? std::sqrt(0.25) : std::sqrt(0.125)) *
                             std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0));
    init = true;
  }
  float tmp[64], F[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += cosv[u][x] * (px[8 * y + x] - 128.0f);
      tmp[8 * y + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += cosv[v][y] * tmp[8 * y + u];
      F[8 * v + u] = s;
    }
  int zz[64];
  for (int k = 0; k < 64; ++k) {
    int nat = kNatural[k];
    zz[k] = (int)std::lround(F[nat] / q[nat]);
  }
  int diff = zz[0] - *pred;
  *pred = zz[0];
  int s = bit_size(diff);
  bw->put(dct.code[s], dct.len[s]);
  if (s) bw->put((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << s) - 1), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    if (!zz[k]) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw->put(act.code[0xF0], act.len[0xF0]);
      run -= 16;
    }
    int sz = bit_size(zz[k]);
    int sym = (run << 4) | sz;
    bw->put(act.code[sym], act.len[sym]);
    bw->put((uint32_t)(zz[k] < 0 ? zz[k] - 1 : zz[k]) & ((1u << sz) - 1), sz);
    run = 0;
  }
  if (run) bw->put(act.code[0], act.len[0]);
}

void write_jpeg_impl(const char* path, const uint8_t* img, int H, int W, int C,
                     int quality) {
  if (C != 1 && C != 3) fail("JPEG writer takes 1 or 3 channels");
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("JPEG size out of range");
  quality = std::max(1, std::min(100, quality));
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int k = 0; k < 64; ++k) {
    q[0][k] = (uint16_t)std::max(1, std::min(255, (kStdLumaQ[k] * scale + 50) / 100));
    q[1][k] = (uint16_t)std::max(1, std::min(255, (kStdChromaQ[k] * scale + 50) / 100));
  }
  EncTable dct[2], act[2];
  build_enc(&dct[0], kDcLumaBits, kDcVals);
  build_enc(&dct[1], kDcChromaBits, kDcVals);
  build_enc(&act[0], kAcLumaBits, kAcLumaVals);
  build_enc(&act[1], kAcChromaBits, kAcChromaVals);

  // planes: Y full size, Cb/Cr 2x2-averaged (4:2:0), all padded by edge
  // replication to whole MCUs
  const int hs = C == 3 ? 2 : 1;
  const int mw = 8 * hs, mcux = (W + mw - 1) / mw, mcuy = (H + mw - 1) / mw;
  const int PW = mcux * mw, PH = mcuy * mw;
  std::vector<float> Y((size_t)PW * PH), Cb, Cr;
  if (C == 3) {
    Cb.resize((size_t)(PW / 2) * (PH / 2));
    Cr.resize(Cb.size());
  }
  std::vector<float> cbf, crf;
  if (C == 3) {
    cbf.resize((size_t)PW * PH);
    crf.resize((size_t)PW * PH);
  }
  for (int y = 0; y < PH; ++y)
    for (int x = 0; x < PW; ++x) {
      const uint8_t* p = img + ((size_t)std::min(y, H - 1) * W + std::min(x, W - 1)) * C;
      size_t i = (size_t)y * PW + x;
      if (C == 1) {
        Y[i] = p[0];
        continue;
      }
      float r = p[0], g = p[1], b = p[2];
      Y[i] = 0.299f * r + 0.587f * g + 0.114f * b;
      cbf[i] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.0f;
      crf[i] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.0f;
    }
  if (C == 3)
    for (int y = 0; y < PH / 2; ++y)
      for (int x = 0; x < PW / 2; ++x) {
        size_t a = (size_t)(2 * y) * PW + 2 * x;
        Cb[(size_t)y * (PW / 2) + x] = 0.25f * (cbf[a] + cbf[a + 1] + cbf[a + PW] + cbf[a + PW + 1]);
        Cr[(size_t)y * (PW / 2) + x] = 0.25f * (crf[a] + crf[a + 1] + crf[a + PW] + crf[a + PW + 1]);
      }

  Out o;
  o.put16(0xFFD8);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.put16(0xFFE0);
  o.put16(16);
  o.b.insert(o.b.end(), jfif, jfif + 14);
  for (int t = 0; t < (C == 3 ? 2 : 1); ++t) {
    o.put16(0xFFDB);
    o.put16(67);
    o.put((uint8_t)t);
    for (int k = 0; k < 64; ++k) o.put((uint8_t)q[t][kNatural[k]]);
  }
  o.put16(0xFFC0);
  o.put16(8 + 3 * C);
  o.put(8);
  o.put16(H);
  o.put16(W);
  o.put((uint8_t)C);
  for (int c = 0; c < C; ++c) {
    o.put((uint8_t)(c + 1));
    o.put(c == 0 ? (uint8_t)((hs << 4) | hs) : 0x11);
    o.put(c == 0 ? 0 : 1);
  }
  auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int k = 0; k < 16; ++k) n += bits[k];
    o.put16(0xFFC4);
    o.put16(19 + n);
    o.put((uint8_t)((cls << 4) | id));
    o.b.insert(o.b.end(), bits, bits + 16);
    o.b.insert(o.b.end(), vals, vals + n);
  };
  dht(0, 0, kDcLumaBits, kDcVals);
  dht(1, 0, kAcLumaBits, kAcLumaVals);
  if (C == 3) {
    dht(0, 1, kDcChromaBits, kDcVals);
    dht(1, 1, kAcChromaBits, kAcChromaVals);
  }
  o.put16(0xFFDA);
  o.put16(6 + 2 * C);
  o.put((uint8_t)C);
  for (int c = 0; c < C; ++c) {
    o.put((uint8_t)(c + 1));
    o.put(c == 0 ? 0x00 : 0x11);
  }
  o.put(0);
  o.put(63);
  o.put(0);
  BitWriter bw{&o};
  int pred[3] = {0, 0, 0};
  float blk[64];
  auto take = [&](const std::vector<float>& p, int pw, int bx, int by) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) blk[8 * y + x] = p[(size_t)(by * 8 + y) * pw + bx * 8 + x];
  };
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      for (int j = 0; j < hs; ++j)
        for (int i = 0; i < hs; ++i) {
          take(Y, PW, mx * hs + i, my * hs + j);
          encode_block(&bw, blk, q[0], &pred[0], dct[0], act[0]);
        }
      if (C == 3) {
        take(Cb, PW / 2, mx, my);
        encode_block(&bw, blk, q[1], &pred[1], dct[1], act[1]);
        take(Cr, PW / 2, mx, my);
        encode_block(&bw, blk, q[1], &pred[2], dct[1], act[1]);
      }
    }
  bw.flush();
  o.put16(0xFFD9);
  write_file(path, o.b);
}

struct Init {
  Init() { init_tables(); }
} g_init;

void set_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) {
    std::strncpy(err, m.c_str(), (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decode n images into out, slot i at out + i * Ht * Wt * C: image i must
// be hw[2i] x hw[2i+1] (h x w) and lands in the slot's top-left corner,
// the rest of the slot zeroed.  C = 3 gives RGB, C = 1 gray.  Returns 0,
// 1 + the index of a failing image (the first failure detected), with its
// reason in err, or -1 when no worker thread could be started.
int imageio_decode_batch(const char** paths, int n, const int* hw, uint8_t* out,
                         int Ht, int Wt, int C, int n_threads, char* err,
                         int errlen) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      Dest d{out + (size_t)i * Ht * Wt * C, hw[2 * i], hw[2 * i + 1], Ht, Wt, C};
      try {
        if (d.h > Ht || d.w > Wt || d.h < 1 || d.w < 1)
          fail("expected size does not fit the output slot");
        decode_any(paths[i], d);
      } catch (const Fail& e) {
        int expect = 0;
        if (failed.compare_exchange_strong(expect, i + 1)) set_err(err, errlen, e.msg);
        return;
      } catch (const std::exception& e) {   // std::bad_alloc and the like
        int expect = 0;
        if (failed.compare_exchange_strong(expect, i + 1)) set_err(err, errlen, e.what());
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  int k = n_threads < n ? n_threads : n;
  threads.reserve(k);
  for (int t = 0; t < k; ++t) {
    try {
      threads.emplace_back(work);
    } catch (...) {
      break;
    }
  }
  if (k > 0 && threads.empty()) return -1;
  for (auto& t : threads) t.join();
  return failed.load();
}

int imageio_write_png(const char* path, const uint8_t* img, int H, int W, int C,
                      char* err, int errlen) {
  try {
    write_png_impl(path, img, H, W, C);
  } catch (const Fail& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
  return 0;
}

int imageio_write_jpeg(const char* path, const uint8_t* img, int H, int W, int C,
                       int quality, char* err, int errlen) {
  try {
    write_jpeg_impl(path, img, H, W, C, quality);
  } catch (const Fail& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
  return 0;
}

int imageio_abi_version() { return 1; }

}  // extern "C"
