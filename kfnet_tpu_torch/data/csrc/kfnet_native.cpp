// kfnet_native — the host data path of kfnet_tpu_torch (the port's own
// copy of the JAX package's native library, built at first use with the
// host's C++ compiler by kernels/_build.py; bound with ctypes in
// data/native_io.py):
//
//   * kfn_png_info / kfn_png_decode — a minimal PNG decoder (zlib inflate
//     + scanline unfilter, all five filter types) for the datasets' frame
//     formats: 8-bit grey, grey+alpha, RGB and RGBA, and 16-bit of each
//     (depth is 16-bit grey). Non-interlaced only (every dataset file is).
//   * kfn_png_decode_rgb_f32 — 8-bit colour straight to float32 RGB in
//     [0, 1] (value / 255, rounded as numpy's float32 division rounds).
//   * kfn_depth_to_labels — fused decode + scene-coordinate labels: 16-bit
//     depth PNG bytes + intrinsics + camera-to-world pose -> the strided
//     (h, w, 3) world-coordinate map and its validity mask, in one pass.
//   * kfn_load_batch — n frames in one call over a std::thread pool.
//   * kfn_jpeg_info / kfn_jpeg_decode — a baseline / extended sequential
//     Huffman JPEG decoder (12-Scenes colour; the port's own addition):
//     8-bit, 1 or 3 components, luma sampled 1x1, 2x1 or 2x2 over 1x1
//     chroma, restart intervals. Its arithmetic is libjpeg's (the integer
//     islow IDCT of jidctint.c, the fancy upsampling of jdsample.c, the
//     fixed-point colour tables of jdcolor.c), the same as the plain numpy
//     version data/image_io.py::decode_jpeg_plain that the tests hold it
//     against.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct PngInfo {
  uint32_t width = 0, height = 0;
  uint8_t bit_depth = 0, color_type = 0, interlace = 0;
  bool ok = false;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int channels_for(uint8_t color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0; // palette unsupported
  }
}

// Header dims are UNTRUSTED input. Without a cap, a crafted IHDR of
// ~2^32 x 2^32 makes (row_bytes+1)*height wrap size_t, so the decode
// buffers come out undersized while unfilter() still walks the full
// claimed height — an out-of-bounds write driven by file contents. The
// cap also bounds allocations (worst case under it is ~4 GiB claimed →
// rejected; largest real dataset frame is 1920x1080). 16384 px per side
// is generous for every supported dataset.
constexpr uint32_t kMaxDim = 16384;

PngInfo parse_info(const uint8_t* buf, size_t len) {
  PngInfo info;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 33 || std::memcmp(buf, sig, 8) != 0) return info;
  // first chunk must be IHDR
  if (std::memcmp(buf + 12, "IHDR", 4) != 0) return info;
  info.width = be32(buf + 16);
  info.height = be32(buf + 20);
  info.bit_depth = buf[24];
  info.color_type = buf[25];
  info.interlace = buf[28];
  info.ok = info.width && info.height && info.width <= kMaxDim &&
            info.height <= kMaxDim && info.interlace == 0 &&
            channels_for(info.color_type) > 0 &&
            (info.bit_depth == 8 || info.bit_depth == 16);
  return info;
}

// Collect and inflate all IDAT chunks.
bool inflate_idat(const uint8_t* buf, size_t len, std::vector<uint8_t>& out,
                  size_t expected) {
  std::vector<uint8_t> compressed;
  size_t pos = 8;
  while (pos + 12 <= len) {
    uint32_t clen = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (pos + 12 + clen > len) return false;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      compressed.insert(compressed.end(), data, data + clen);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + clen;
  }
  if (compressed.empty()) return false;
  out.resize(expected);
  uLongf dest_len = expected;
  int rc = uncompress(out.data(), &dest_len, compressed.data(),
                      compressed.size());
  return rc == Z_OK && dest_len == expected;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Unfilter in place into `pixels` (row-major, stride bytes per row).
bool unfilter(std::vector<uint8_t>& raw, uint8_t* pixels, uint32_t height,
              size_t row_bytes, int bpp) {
  const uint8_t* src = raw.data();
  for (uint32_t y = 0; y < height; ++y) {
    uint8_t filter = src[y * (row_bytes + 1)];
    const uint8_t* in = src + y * (row_bytes + 1) + 1;
    uint8_t* cur = pixels + y * row_bytes;
    const uint8_t* up = y ? pixels + (y - 1) * row_bytes : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(cur, in, row_bytes);
        break;
      case 1:
        for (size_t x = 0; x < row_bytes; ++x)
          cur[x] = in[x] + (x >= size_t(bpp) ? cur[x - bpp] : 0);
        break;
      case 2:
        for (size_t x = 0; x < row_bytes; ++x)
          cur[x] = in[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (size_t x = 0; x < row_bytes; ++x) {
          int a = x >= size_t(bpp) ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          cur[x] = in[x] + uint8_t((a + b) / 2);
        }
        break;
      case 4:
        for (size_t x = 0; x < row_bytes; ++x) {
          int a = x >= size_t(bpp) ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
          cur[x] = in[x] + uint8_t(paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
  }
  return true;
}

// noexcept at the C ABI boundary: allocation failure on a hostile-but-
// under-cap size claim must surface as a decode error, not an unwound
// C++ exception through extern "C" frames (= std::terminate).
bool decode_png(const uint8_t* buf, size_t len, PngInfo& info,
                std::vector<uint8_t>& pixels) try {
  info = parse_info(buf, len);
  if (!info.ok) return false;
  int ch = channels_for(info.color_type);
  int bpp = ch * info.bit_depth / 8;
  // kMaxDim bounds these well below size_t wrap (≤ 16384²·8 + 16384 B).
  size_t row_bytes = size_t(info.width) * bpp;
  size_t expected = (row_bytes + 1) * info.height;
  std::vector<uint8_t> raw;
  if (!inflate_idat(buf, len, raw, expected)) return false;
  pixels.resize(row_bytes * info.height);
  return unfilter(raw, pixels.data(), info.height, row_bytes, bpp);
} catch (const std::exception&) {
  return false;
}

// The resize must not throw out of here: this runs on kfn_load_batch's
// std::thread workers, where an escaped bad_alloc (e.g. a huge on-disk
// file) cannot unwind past the thread entry and would terminate the
// whole process.
bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n <= 0) { std::fclose(f); return false; }
  std::fseek(f, 0, SEEK_SET);
  try {
    out.resize(size_t(n));
  } catch (const std::exception&) {
    std::fclose(f);
    return false;
  }
  size_t got = std::fread(out.data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}


// ---- JPEG ------------------------------------------------------------------

// Return codes of kfn_jpeg_info / kfn_jpeg_decode (image_io.jpeg_exception):
// -1 corrupt or truncated; -2 a component count or sampling outside the
// scope; -3 a sample precision other than 8 bits; -(256 + m) a frame
// marker m this decoder does not take (progressive, lossless,
// hierarchical, arithmetic-coded).
constexpr int kJpegCorrupt = -1, kJpegSampling = -2, kJpegPrecision = -3;

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct JpegComp {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;   // samples at the component's own sampling
  int bw = 0, bh = 0;          // blocks across and down (MCU-padded)
  bool q_latched = false;
  int32_t q[64] = {0};
  std::vector<int32_t> coef;   // (bh, bw, 64), zigzag order
};

struct JpegDecoder {
  const uint8_t* buf;
  size_t len;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0, adobe_transform = -1, precision = 0;
  bool have_sof = false, have_q[4] = {false, false, false, false};
  int32_t qt[4][64];
  // 16-bit peek -> (length << 8 | symbol); 0 where no code starts
  std::vector<uint16_t> dc_lut[4], ac_lut[4];
  std::vector<JpegComp> comps;

  JpegDecoder(const uint8_t* b, size_t n) : buf(b), len(n) {}

  static int unsupported(int marker) { return -256 - marker; }

  int read_dqt(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      ++i;
      if (tq > 3) return kJpegCorrupt;
      size_t need = pq ? 128 : 64;
      if (i + need > n) return kJpegCorrupt;
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (p[i + 2 * k] << 8) | p[i + 2 * k + 1] : p[i + k];
        qt[tq][kZigzag[k]] = v;
      }
      have_q[tq] = true;
      i += need;
    }
    return 0;
  }

  int read_dht(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      if (i + 17 > n) return kJpegCorrupt;
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) return kJpegCorrupt;
      const uint8_t* bits = p + i + 1;
      int total = 0;
      for (int k = 0; k < 16; ++k) total += bits[k];
      if (total > 256 || i + 17 + total > n) return kJpegCorrupt;
      const uint8_t* vals = p + i + 17;
      std::vector<uint16_t>& lut = tc ? ac_lut[th] : dc_lut[th];
      lut.assign(1 << 16, 0);
      int code = 0, k = 0;
      for (int length = 1; length <= 16; ++length) {
        for (int j = 0; j < bits[length - 1]; ++j) {
          if (code >= (1 << length)) return kJpegCorrupt;
          int lo = code << (16 - length), count = 1 << (16 - length);
          for (int e = 0; e < count; ++e)
            lut[lo + e] = uint16_t((length << 8) | vals[k]);
          ++code;
          ++k;
        }
        code <<= 1;
      }
      i += 17 + total;
    }
    return 0;
  }

  int read_sof(int marker, const uint8_t* p, size_t n) {
    if (marker != 0xC0 && marker != 0xC1) return unsupported(marker);
    if (n < 6) return kJpegCorrupt;
    precision = p[0];
    if (precision != 8) return kJpegPrecision;
    height = (p[1] << 8) | p[2];
    width = (p[3] << 8) | p[4];
    int nf = p[5];
    if (n < size_t(6 + 3 * nf)) return kJpegCorrupt;
    if (width == 0 || height == 0) return kJpegSampling;  // DNL
    if (width > int(kMaxDim) || height > int(kMaxDim)) return kJpegCorrupt;
    if (nf != 1 && nf != 3) return kJpegSampling;
    comps.assign(nf, JpegComp());
    for (int c = 0; c < nf; ++c) {
      comps[c].id = p[6 + 3 * c];
      comps[c].h = p[7 + 3 * c] >> 4;
      comps[c].v = p[7 + 3 * c] & 15;
      comps[c].tq = p[8 + 3 * c];
      if (comps[c].h < 1 || comps[c].h > 4 || comps[c].v < 1 ||
          comps[c].v > 4 || comps[c].tq > 3)
        return kJpegCorrupt;
    }
    if (nf == 3) {
      int lh = comps[0].h, lv = comps[0].v;
      bool luma_ok = (lh == 1 && lv == 1) || (lh == 2 && lv == 1) ||
                     (lh == 2 && lv == 2);
      for (int c = 1; c < 3; ++c)
        if (comps[c].h != 1 || comps[c].v != 1) luma_ok = false;
      if (!luma_ok) return kJpegSampling;
    }
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.width = (width * c.h + hmax - 1) / hmax;
      c.height = (height * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    have_sof = true;
    return 0;
  }

  // MSB-first bits of one restart segment (stuffed zeros removed); reads
  // past its end give 0s and are caught by the caller's overrun check.
  struct Bits {
    const std::vector<uint8_t>* seg;
    size_t pos = 0;  // in bits
    uint32_t peek(int n) const {
      // the 32 bits from pos's byte, shifted by its bit offset: a code
      // needs at most 7 + 16 of them
      size_t byte = pos >> 3;
      uint32_t w = 0;
      for (size_t k = 0; k < 4; ++k)
        w = (w << 8) | (byte + k < seg->size() ? (*seg)[byte + k] : 0);
      return uint32_t((uint64_t(w) << (pos & 7)) & 0xFFFFFFFFu) >> (32 - n);
    }
    bool overrun() const { return pos > seg->size() * 8; }
  };

  static bool decode_symbol(Bits& b, const std::vector<uint16_t>& lut,
                            int* sym) {
    uint16_t e = lut[b.peek(16)];
    if (!e) return false;
    b.pos += e >> 8;
    *sym = e & 0xFF;
    return true;
  }

  static int receive_extend(Bits& b, int s) {
    if (!s) return 0;
    int v = int(b.peek(s));
    b.pos += s;
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  static bool decode_block(Bits& b, const std::vector<uint16_t>& dc,
                           const std::vector<uint16_t>& ac, int* pred,
                           int32_t* out) {
    int s;
    if (!decode_symbol(b, dc, &s)) return false;
    *pred += receive_extend(b, s & 15);
    out[0] = *pred;
    for (int k = 1; k < 64;) {
      int rs;
      if (!decode_symbol(b, ac, &rs)) return false;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return false;
        out[k] = receive_extend(b, s);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    return true;
  }

  // The scan's entropy-coded bytes from pos, split at RSTn markers with
  // the stuffed zeros taken out; *end is the marker that ends the scan.
  bool entropy_segments(size_t pos, std::vector<std::vector<uint8_t>>& segs,
                        size_t* end) {
    segs.assign(1, {});
    while (pos < len) {
      uint8_t c = buf[pos];
      if (c != 0xFF) {
        segs.back().push_back(c);
        ++pos;
        continue;
      }
      if (pos + 1 >= len) return false;
      uint8_t nxt = buf[pos + 1];
      if (nxt == 0x00) {
        segs.back().push_back(0xFF);
        pos += 2;
      } else if (nxt == 0xFF) {
        ++pos;  // fill bytes before a marker
      } else if (nxt >= 0xD0 && nxt <= 0xD7) {
        segs.emplace_back();
        pos += 2;
      } else {
        *end = pos;
        return true;
      }
    }
    return false;
  }

  int read_scan(const uint8_t* p, size_t n, size_t pos, size_t* end) {
    if (!have_sof || n < 1) return kJpegCorrupt;
    int ns = p[0];
    if (ns < 1 || ns > 3 || n < size_t(1 + 2 * ns + 3)) return kJpegCorrupt;
    int idx[3], td[3], ta[3];
    for (int j = 0; j < ns; ++j) {
      idx[j] = -1;
      for (size_t c = 0; c < comps.size(); ++c)
        if (comps[c].id == p[1 + 2 * j]) idx[j] = int(c);
      td[j] = p[2 + 2 * j] >> 4;
      ta[j] = p[2 + 2 * j] & 15;
      if (idx[j] < 0 || td[j] > 3 || ta[j] > 3 || dc_lut[td[j]].empty() ||
          ac_lut[ta[j]].empty())
        return kJpegCorrupt;
      JpegComp& c = comps[idx[j]];
      if (!c.q_latched) {  // latched at the component's first scan
        if (!have_q[c.tq]) return kJpegCorrupt;
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.q_latched = true;
        c.coef.assign(size_t(c.bh) * c.bw * 64, 0);
      }
    }
    if (p[1 + 2 * ns] != 0 || p[2 + 2 * ns] != 63 || p[3 + 2 * ns] != 0)
      return kJpegCorrupt;
    std::vector<std::vector<uint8_t>> segs;
    if (!entropy_segments(pos, segs, end)) return kJpegCorrupt;
    // the scan's units (MCUs): one block each for a one-component scan
    // over the component's own blocks, else the interleaved MCUs
    int ux, uy;
    if (ns == 1) {
      ux = (comps[idx[0]].width + 7) / 8;
      uy = (comps[idx[0]].height + 7) / 8;
    } else {
      ux = mcux;
      uy = mcuy;
    }
    long units = long(ux) * uy;
    long per_seg = restart ? restart : units;
    if ((units + per_seg - 1) / per_seg != long(segs.size()))
      return kJpegCorrupt;
    int32_t blk[64];
    for (size_t si = 0; si < segs.size(); ++si) {
      Bits bits{&segs[si], 0};
      int preds[3] = {0, 0, 0};
      long u_end = std::min(units, long(si + 1) * per_seg);
      for (long u = long(si) * per_seg; u < u_end; ++u) {
        int my = int(u / ux), mx = int(u % ux);
        for (int j = 0; j < ns; ++j) {
          JpegComp& c = comps[idx[j]];
          int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
          for (int v = 0; v < nv; ++v) {
            for (int h = 0; h < nh; ++h) {
              std::memset(blk, 0, sizeof(blk));
              if (!decode_block(bits, dc_lut[td[j]], ac_lut[ta[j]],
                                &preds[j], blk))
                return kJpegCorrupt;
              int by = my * nv + v, bx = mx * nh + h;
              std::memcpy(&c.coef[(size_t(by) * c.bw + bx) * 64], blk,
                          sizeof(blk));
            }
          }
        }
      }
      if (bits.overrun()) return kJpegCorrupt;
    }
    return 0;
  }

  // Walk the markers; with decode false, stop after the frame header.
  int parse(bool decode) {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kJpegCorrupt;
    size_t pos = 2;
    while (pos < len) {
      if (buf[pos] != 0xFF) return kJpegCorrupt;
      while (pos < len && buf[pos] == 0xFF) ++pos;
      if (pos >= len) break;
      int marker = buf[pos++];
      if (marker == 0xD9) return have_sof ? 0 : kJpegCorrupt;
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (pos + 2 > len) return kJpegCorrupt;
      size_t length = (size_t(buf[pos]) << 8) | buf[pos + 1];
      if (length < 2 || pos + length > len) return kJpegCorrupt;
      const uint8_t* p = buf + pos + 2;
      size_t n = length - 2;
      pos += length;
      int rc = 0;
      if (marker == 0xDB) {
        rc = read_dqt(p, n);
      } else if (marker == 0xC4) {
        rc = read_dht(p, n);
      } else if (marker >= 0xC0 && marker <= 0xCF) {
        rc = read_sof(marker, p, n);  // 0xC4 and 0xC8..: handled above/here
        if (rc == 0 && !decode) return 0;
      } else if (marker == 0xDD) {
        if (n < 2) return kJpegCorrupt;
        restart = (p[0] << 8) | p[1];
      } else if (marker == 0xEE) {
        if (n >= 12 && std::memcmp(p, "Adobe", 5) == 0)
          adobe_transform = p[11];
      } else if (marker == 0xDC) {
        return kJpegSampling;  // DNL
      } else if (marker == 0xDA) {
        if (!decode) return kJpegCorrupt;
        size_t end = 0;
        rc = read_scan(p, n, pos, &end);
        pos = end;
      }
      if (rc) return rc;
    }
    return kJpegCorrupt;  // no EOI
  }
};

// jidctint.c (libjpeg's "islow" integer IDCT), on one block of
// dequantized coefficients in natural order -> 8x8 samples.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline void idct_1d(const int64_t* in, int stride, int shift, int64_t* out,
                    int ostride) {
  int64_t z2 = in[2 * stride], z3 = in[6 * stride];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 - z3 * FIX_1_847759065;
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  int64_t tmp0 = (in[0] + in[4 * stride]) * (int64_t(1) << kConstBits);
  int64_t tmp1 = (in[0] - in[4 * stride]) * (int64_t(1) << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = in[7 * stride], t1 = in[5 * stride], t2 = in[3 * stride],
          t3 = in[1 * stride];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  t0 *= FIX_0_298631336;
  t1 *= FIX_2_053119869;
  t2 *= FIX_3_072711026;
  t3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t half = int64_t(1) << (shift - 1);
  const int64_t r[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
  for (int k = 0; k < 8; ++k) out[k * ostride] = (r[k] + half) >> shift;
}

void idct_islow(const int32_t* zz, const int32_t* q, uint8_t* out,
                size_t out_stride) {
  int64_t in[64], ws[64], row[8];
  for (int k = 0; k < 64; ++k) in[kZigzag[k]] = int64_t(zz[k]) * q[kZigzag[k]];
  for (int c = 0; c < 8; ++c)  // columns
    idct_1d(in + c, 8, kConstBits - kPass1Bits, ws + c, 8);
  for (int r = 0; r < 8; ++r) {  // rows, then the range limit
    idct_1d(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, row, 1);
    for (int c = 0; c < 8; ++c) {
      int64_t x = ((row[c] + 512) & 1023) - 512;  // wraps as libjpeg's table
      x += 128;
      out[r * out_stride + c] = uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
  }
}

// jdsample.c's fancy upsampling of one (h, w) plane to (h, 2w) (h2v1) or
// (2h, 2w) (h2v2); edges repeated.
void fancy_upsample(const std::vector<uint8_t>& in, int h, int w, bool v2,
                    std::vector<uint8_t>& out) {
  int ow = 2 * w, oh = v2 ? 2 * h : h;
  out.assign(size_t(oh) * ow, 0);
  std::vector<int> col(w);
  for (int y = 0; y < h; ++y) {
    const uint8_t* cur = &in[size_t(y) * w];
    for (int half = 0; half < (v2 ? 2 : 1); ++half) {
      uint8_t* o = &out[size_t(v2 ? 2 * y + half : y) * ow];
      if (!v2) {
        for (int x = 0; x < w; ++x) {
          int l = cur[x > 0 ? x - 1 : 0], r = cur[x < w - 1 ? x + 1 : x];
          o[2 * x] = uint8_t((3 * cur[x] + l + 1) >> 2);
          o[2 * x + 1] = uint8_t((3 * cur[x] + r + 2) >> 2);
        }
        continue;
      }
      int ny = half == 0 ? (y > 0 ? y - 1 : 0) : (y < h - 1 ? y + 1 : y);
      const uint8_t* nb = &in[size_t(ny) * w];
      for (int x = 0; x < w; ++x) col[x] = 3 * cur[x] + nb[x];
      for (int x = 0; x < w; ++x) {
        int l = col[x > 0 ? x - 1 : 0], r = col[x < w - 1 ? x + 1 : x];
        o[2 * x] = uint8_t((3 * col[x] + l + 8) >> 4);
        o[2 * x + 1] = uint8_t((3 * col[x] + r + 7) >> 4);
      }
    }
  }
}

inline int fix16(double x) { return int(x * 65536 + 0.5); }

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}
}  // namespace

extern "C" {

int kfn_depth_to_labels(const uint8_t*, size_t, const float*, const float*,
                        int, float, float, float, uint16_t, float*, uint8_t*,
                        int*, int*);
int kfn_png_decode_rgb_f32(const uint8_t*, size_t, float*);

// Multi-threaded batch example loader (the executor role the reference left
// to TF's C++ queue runners). One call loads n frames: read file → PNG decode → (color)
// float RGB, (depth) fused strided label generation, fanned out over a
// std::thread pool with the GIL released (ctypes call).
//
//   color_paths[n]: NUL-terminated paths; depth_paths[i] may be NULL or
//     empty (frame then gets valid=0 labels).
//   K: row-major 3x3 shared intrinsics. T_wc: (n, 16) row-major poses.
//   images: (n, height, width, 3) f32 out. coords: (n, h, w, 3) f32 out.
//   valid: (n, h, w) u8 out, where h = height/stride, w = width/stride.
//
// Returns 0 on success, else -(1 + 2*index + which) for the lowest-index
// failure observed, where which = 0 for the color file and 1 for the
// depth file (a plain "first writer" store would let a racing later
// frame mask an earlier one, and the caller could not tell which of the
// two files to inspect).
int kfn_load_batch(const char** color_paths, const char** depth_paths,
                   int n, int width, int height, const float* K,
                   const float* T_wc, int stride, float depth_scale,
                   float min_depth, float max_depth, uint16_t invalid_value,
                   int num_threads, float* images, float* coords,
                   uint8_t* valid) {
  const int hs = height / stride, ws = width / stride;
  const size_t img_stride = size_t(height) * width * 3;
  const size_t lab_stride = size_t(hs) * ws;
  std::atomic<int> next(0);
  std::atomic<int> first_error(-1);  // packed 2*index + which, CAS-min
  auto record_error = [&](int i, int which) {
    int packed = i * 2 + which;
    int cur = first_error.load();
    while ((cur < 0 || packed < cur) &&
           !first_error.compare_exchange_weak(cur, packed)) {
    }
  };

  auto worker = [&]() {
    std::vector<uint8_t> bytes;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || first_error.load() >= 0) return;
      // color
      if (!read_file(color_paths[i], bytes)) {
        record_error(i, 0);
        return;
      }
      PngInfo info = parse_info(bytes.data(), bytes.size());
      if (!info.ok || int(info.width) != width || int(info.height) != height ||
          kfn_png_decode_rgb_f32(bytes.data(), bytes.size(),
                                 images + size_t(i) * img_stride) != 0) {
        record_error(i, 0);
        return;
      }
      // labels
      float* c = coords + size_t(i) * lab_stride * 3;
      uint8_t* v = valid + size_t(i) * lab_stride;
      if (depth_paths == nullptr || depth_paths[i] == nullptr ||
          depth_paths[i][0] == '\0') {
        std::memset(c, 0, lab_stride * 3 * sizeof(float));
        std::memset(v, 0, lab_stride);
        continue;
      }
      int oh = 0, ow = 0;
      if (!read_file(depth_paths[i], bytes)) {
        record_error(i, 1);
        return;
      }
      // Pre-check the depth file's header dims BEFORE decoding: the
      // label writer sizes its output from the decoded header, so an
      // oversized on-disk depth PNG would overflow the caller-allocated
      // (hs, ws) slot (the oh/ow check below would run only after the
      // write). Mirrors the color path's pre-check.
      PngInfo dinfo = parse_info(bytes.data(), bytes.size());
      if (!dinfo.ok || int(dinfo.width) != width ||
          int(dinfo.height) != height ||
          kfn_depth_to_labels(bytes.data(), bytes.size(), K,
                              T_wc + size_t(i) * 16, stride, depth_scale,
                              min_depth, max_depth, invalid_value, c, v,
                              &oh, &ow) != 0 ||
          oh != hs || ow != ws) {
        record_error(i, 1);
        return;
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > n) nt = n;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int err = first_error.load();
  return err >= 0 ? -(1 + err) : 0;
}

// Query dims: returns 0 on success.
int kfn_png_info(const uint8_t* buf, size_t len, int* width, int* height,
                 int* channels, int* bit_depth) {
  PngInfo info = parse_info(buf, len);
  if (!info.ok) return -1;
  *width = int(info.width);
  *height = int(info.height);
  *channels = channels_for(info.color_type);
  *bit_depth = int(info.bit_depth);
  return 0;
}

// Decode into caller buffer (size = w*h*channels elements).
// 8-bit images write uint8; 16-bit write uint16 (native endian).
int kfn_png_decode(const uint8_t* buf, size_t len, void* out) {
  PngInfo info;
  std::vector<uint8_t> pixels;
  if (!decode_png(buf, len, info, pixels)) return -1;
  int ch = channels_for(info.color_type);
  size_t n = size_t(info.width) * info.height * ch;
  if (info.bit_depth == 8) {
    std::memcpy(out, pixels.data(), n);
  } else {
    uint16_t* o = static_cast<uint16_t*>(out);
    for (size_t i = 0; i < n; ++i)  // PNG 16-bit is big-endian
      o[i] = (uint16_t(pixels[2 * i]) << 8) | pixels[2 * i + 1];
  }
  return 0;
}

// Decode an 8-bit color PNG straight to float32 [0,1] RGB (HWC). Grayscale
// broadcasts; alpha is dropped (as PIL's convert("RGB") does).
int kfn_png_decode_rgb_f32(const uint8_t* buf, size_t len, float* out) {
  PngInfo info;
  std::vector<uint8_t> pixels;
  if (!decode_png(buf, len, info, pixels)) return -1;
  if (info.bit_depth != 8) return -2;
  int ch = channels_for(info.color_type);
  size_t npix = size_t(info.width) * info.height;
  // a division, not a product with 1/255: the same float32 as numpy's
  // uint8 -> float32 array divided by 255.0
  for (size_t i = 0; i < npix; ++i) {
    const uint8_t* p = pixels.data() + i * ch;
    float r, g, b;
    if (ch >= 3) { r = p[0]; g = p[1]; b = p[2]; }
    else { r = g = b = p[0]; }
    out[3 * i + 0] = r / 255.0f;
    out[3 * i + 1] = g / 255.0f;
    out[3 * i + 2] = b / 255.0f;
  }
  return 0;
}

// Fused: 16-bit grayscale depth PNG bytes -> strided world-coordinate
// labels. K is row-major 3x3; T_wc row-major 4x4 camera-to-world. Outputs:
// coords (h/stride, w/stride, 3) float32, valid (h/stride, w/stride) uint8.
// Returns 0 on success; fills out_h/out_w.
int kfn_depth_to_labels(const uint8_t* buf, size_t len, const float* K,
                        const float* T_wc, int stride, float depth_scale,
                        float min_depth, float max_depth, uint16_t invalid_value,
                        float* coords, uint8_t* valid, int* out_h, int* out_w) {
  PngInfo info;
  std::vector<uint8_t> pixels;
  if (!decode_png(buf, len, info, pixels)) return -1;
  if (info.bit_depth != 16 || channels_for(info.color_type) != 1) return -2;
  int W = int(info.width), H = int(info.height);
  int hs = H / stride, ws = W / stride;
  *out_h = hs;
  *out_w = ws;
  int off = (stride - 1) / 2;  // matches core/geometry.py cell_center_grid
  float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const float* R = T_wc;  // rows of 4
  for (int i = 0; i < hs; ++i) {
    int v = i * stride + off;
    for (int j = 0; j < ws; ++j) {
      int u = j * stride + off;
      size_t idx = size_t(v) * W + u;
      uint16_t raw = (uint16_t(pixels[2 * idx]) << 8) | pixels[2 * idx + 1];
      float d = (raw == invalid_value || raw == 0) ? 0.0f
                                                   : float(raw) * depth_scale;
      bool ok = d > min_depth && d < max_depth;
      float* c = coords + (size_t(i) * ws + j) * 3;
      if (!ok) {
        c[0] = c[1] = c[2] = 0.0f;
        valid[size_t(i) * ws + j] = 0;
        continue;
      }
      float xc = (float(u) - cx) / fx * d;
      float yc = (float(v) - cy) / fy * d;
      float zc = d;
      c[0] = R[0] * xc + R[1] * yc + R[2] * zc + R[3];
      c[1] = R[4] * xc + R[5] * yc + R[6] * zc + R[7];
      c[2] = R[8] * xc + R[9] * yc + R[10] * zc + R[11];
      valid[size_t(i) * ws + j] = 1;
    }
  }
  return 0;
}

// JPEG header: width, height and output channels (1 grey, 3 RGB); 0 or a
// return code (JpegDecoder). *channels carries the sample precision when
// the code is kJpegPrecision.
int kfn_jpeg_info(const uint8_t* buf, size_t len, int* width, int* height,
                  int* channels) try {
  JpegDecoder d(buf, len);
  int rc = d.parse(false);
  if (rc == kJpegPrecision) *channels = d.precision;
  if (rc) return rc;
  *width = d.width;
  *height = d.height;
  *channels = int(d.comps.size());
  return 0;
} catch (const std::exception&) {
  return kJpegCorrupt;
}

// Decode into (height, width, channels) uint8: grey, or RGB through
// jdcolor.c's fixed-point YCbCr tables (RGB as stored where an Adobe
// marker says transform 0, or the components are named 'R', 'G', 'B').
int kfn_jpeg_decode(const uint8_t* buf, size_t len, uint8_t* out) try {
  JpegDecoder d(buf, len);
  int rc = d.parse(true);
  if (rc) return rc;
  const int W = d.width, H = d.height, nc = int(d.comps.size());
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int ci = 0; ci < nc; ++ci) {
    JpegComp& c = d.comps[ci];
    if (!c.q_latched) return kJpegCorrupt;  // no scan carried it
    size_t pw = size_t(c.bw) * 8;
    std::vector<uint8_t> full(size_t(c.bh) * 8 * pw);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.q,
                   &full[size_t(by) * 8 * pw + size_t(bx) * 8], pw);
    std::vector<uint8_t>& p = planes[ci];
    p.resize(size_t(c.height) * c.width);
    for (int y = 0; y < c.height; ++y)
      std::memcpy(&p[size_t(y) * c.width], &full[size_t(y) * pw], c.width);
  }
  if (nc == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + size_t(y) * W, &planes[0][size_t(y) * W], W);
    return 0;
  }
  int pw[3], ph[3];
  for (int ci = 0; ci < 3; ++ci) {
    pw[ci] = d.comps[ci].width;
    ph[ci] = d.comps[ci].height;
  }
  if (d.comps[0].h == 2) {
    for (int ci = 1; ci < 3; ++ci) {
      std::vector<uint8_t> up;
      fancy_upsample(planes[ci], ph[ci], pw[ci], d.comps[0].v == 2, up);
      pw[ci] *= 2;
      if (d.comps[0].v == 2) ph[ci] *= 2;
      planes[ci].swap(up);
    }
  }
  bool rgb = d.adobe_transform >= 0
                 ? d.adobe_transform == 0
                 : (d.comps[0].id == 82 && d.comps[1].id == 71 &&
                    d.comps[2].id == 66);
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = int((fix16(1.40200) * x + (1 << 15)) >> 16);
    cb_b[i] = int((fix16(1.77200) * x + (1 << 15)) >> 16);
    cr_g[i] = -int64_t(fix16(0.71414)) * x;
    cb_g[i] = -int64_t(fix16(0.34414)) * x + (1 << 15);
  }
  for (int y = 0; y < H; ++y) {
    const uint8_t* py = &planes[0][size_t(y) * pw[0]];
    const uint8_t* pb = &planes[1][size_t(y) * pw[1]];
    const uint8_t* pr = &planes[2][size_t(y) * pw[2]];
    uint8_t* o = out + size_t(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      int Y = py[x], cb = pb[x], cr = pr[x];
      if (rgb) {
        o[3 * x] = uint8_t(Y);
        o[3 * x + 1] = uint8_t(cb);
        o[3 * x + 2] = uint8_t(cr);
        continue;
      }
      o[3 * x] = clamp255(Y + cr_r[cr]);
      o[3 * x + 1] = clamp255(Y + int((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(Y + cb_b[cb]);
    }
  }
  return 0;
} catch (const std::exception&) {
  return kJpegCorrupt;
}

}  // extern "C"
