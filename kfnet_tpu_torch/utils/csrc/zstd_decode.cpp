// A zstd frame decoder (RFC 8878), decoding only, for the JAX package's
// checkpoints: OCDBT manifests and B-tree nodes and zarr chunks are zstd
// frames. It links nothing but libc.
//
// Covered: zstd and skippable frames one after another; raw, RLE and
// compressed blocks; raw, RLE, Huffman-compressed and treeless literals
// (one or four streams); sequences with predefined, RLE, FSE-compressed
// and repeated tables; the three repeat offsets; the optional content
// checksum (XXH64), checked where present. A frame that names a
// dictionary is refused.
//
// C interface (ctypes, utils/ocdbt.py):
//   int kfn_zstd_frame_size(src, n, *bound): walks the frames' headers and
//     block headers without decoding; *bound is an upper bound of the
//     decoded size (exact where every frame states its content size).
//   int kfn_zstd_decompress(src, n, dst, cap, *written): decodes every
//     frame of src into dst.
//   const char* kfn_zstd_error(code): the text of an error code.
// Both return 0, or a negative error code; no input makes them read or
// write outside the buffers they are given.

#include <cstdint>
#include <cstring>

namespace {

enum Err {
  kOk = 0,
  kTruncated = -1,
  kBadMagic = -2,
  kReserved = -3,
  kDictionary = -4,
  kCorrupt = -5,
  kChecksum = -6,
  kTooSmall = -7,
  kSizeMismatch = -8,
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kMaxBlock = 128 * 1024;
constexpr int kMaxHufBits = 11;
constexpr int kMaxSymbols = 256;

inline int highbit(uint32_t v) {  // index of the highest set bit; v > 0
  return 31 - __builtin_clz(v);
}

inline uint32_t rd_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint32_t(p[i]) << (8 * i);
  return v;
}

inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ---- XXH64 (seed 0), for the content checksum ----

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xx_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xx_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xx_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xx_round(v1, rd64(p));
      v2 = xx_round(v2, rd64(p + 8));
      v3 = xx_round(v3, rd64(p + 16));
      v4 = xx_round(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xx_merge(xx_merge(xx_merge(xx_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xx_round(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(rd_le(p, 4)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---- bit streams ----

// A forward little-endian bit reader over [p, p + n) (FSE table headers).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  bool overrun = false;
  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i, ++bit) {
      if ((bit >> 3) >= n) {
        overrun = true;
        return 0;
      }
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// A backward bit reader (Huffman streams, FSE streams): bits are taken
// from the end toward the start, after the padding of the last byte; bits
// before the start read as 0 and drive `off` below 0.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t off = 0;  // bits still above the stream's start

  bool init(const uint8_t* src, size_t len) {
    p = src;
    n = len;
    if (len == 0 || src[len - 1] == 0) return false;
    off = int64_t(len) * 8 - (8 - highbit(src[len - 1]));
    return true;
  }
  // up to 32 bits; the stream's bits [off - nbits, off) as an integer
  uint64_t read(int nbits) {
    if (nbits == 0) return 0;
    off -= nbits;
    int64_t start = off;
    int take = nbits;
    if (start < 0) {
      take += int(start);
      if (take <= 0) return 0;
      start = 0;
    }
    size_t byte = size_t(start >> 3);
    int shift = int(start & 7);
    uint64_t w;
    if (byte + 8 <= n) {
      w = rd64(p + byte);
    } else {
      w = 0;
      for (size_t i = 0; byte + i < n; ++i) w |= uint64_t(p[byte + i]) << (8 * i);
    }
    uint64_t v = (w >> shift) & ((uint64_t(1) << take) - 1);
    return off < 0 ? v << (-off) : v;
  }
};

// ---- FSE ----

struct Fse {
  int log = 0;
  uint8_t sym[512];
  uint8_t bits[512];
  uint16_t base[512];
};

// The decoding table of a normalised distribution (RFC 8878 4.1.1).
int fse_build(Fse& t, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  uint16_t next[kMaxSymbols];
  int high = size;
  t.log = log;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high == 0) return kCorrupt;
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) return kCorrupt;
  for (int i = 0; i < size; ++i) {
    uint16_t d = next[t.sym[i]]++;
    t.bits[i] = uint8_t(log - highbit(d));
    t.base[i] = uint16_t((d << t.bits[i]) - size);
  }
  return kOk;
}

void fse_rle(Fse& t, uint8_t s) {
  t.log = 0;
  t.sym[0] = s;
  t.bits[0] = 0;
  t.base[0] = 0;
}

// An FSE table header (RFC 8878 4.1.1) from [p, p + n); *used gets its
// size in bytes.
int fse_read_header(Fse& t, const uint8_t* p, size_t n, int max_log,
                    int max_sym, size_t* used) {
  FwdBits r{p, n};
  int log = 5 + int(r.read(4));
  if (log > max_log) return kCorrupt;
  int32_t remaining = 1 << log;
  int16_t norm[kMaxSymbols];
  int s = 0;
  while (remaining > 0 && s < max_sym) {
    int nb = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t v = r.read(nb);
    uint32_t low = (1u << (nb - 1)) - 1;
    uint32_t thresh = (1u << nb) - 1 - uint32_t(remaining + 1);
    if ((v & low) < thresh) {
      r.bit -= 1;  // a small value uses one bit less
      v &= low;
    } else if (v > low) {
      v -= thresh;
    }
    int16_t prob = int16_t(int(v) - 1);
    remaining -= prob < 0 ? -prob : prob;
    norm[s++] = prob;
    if (prob == 0) {
      for (;;) {
        uint32_t rep = r.read(2);
        for (uint32_t i = 0; i < rep && s < max_sym; ++i) norm[s++] = 0;
        if (rep != 3 || r.overrun) break;
      }
    }
    if (r.overrun) return kTruncated;
  }
  if (r.overrun) return kTruncated;
  if (remaining != 0) return kCorrupt;
  *used = r.bytes_used();
  return fse_build(t, norm, s, log);
}

inline uint8_t fse_decode(const Fse& t, uint16_t& state, BackBits& b) {
  uint8_t s = t.sym[state];
  state = uint16_t(t.base[state] + b.read(t.bits[state]));
  return s;
}

// ---- Huffman ----

struct Huf {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << kMaxHufBits];
  uint8_t bits[1 << kMaxHufBits];
};

// The Huffman tree description (RFC 8878 4.2.1) from [p, p + n) into h;
// *used gets its size.
int huf_read(Huf& h, const uint8_t* p, size_t n, size_t* used) {
  if (n < 1) return kTruncated;
  uint8_t w[kMaxSymbols] = {0};
  int nw = 0;
  int hb = p[0];
  if (hb >= 128) {  // direct: 4 bits a weight
    nw = hb - 127;
    size_t bytes = size_t(nw + 1) / 2;
    if (1 + bytes > n) return kTruncated;
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    *used = 1 + bytes;
  } else {  // FSE-compressed weights, two interleaved states
    size_t csize = size_t(hb);
    if (csize == 0 || 1 + csize > n) return kTruncated;
    static thread_local Fse t;
    size_t hsize = 0;
    int rc = fse_read_header(t, p + 1, csize, 6, kMaxSymbols, &hsize);
    if (rc) return rc;
    if (hsize >= csize) return kCorrupt;
    BackBits b;
    if (!b.init(p + 1 + hsize, csize - hsize)) return kCorrupt;
    uint16_t s1 = uint16_t(b.read(t.log)), s2 = uint16_t(b.read(t.log));
    for (;;) {
      if (nw + 2 > kMaxSymbols - 1) return kCorrupt;
      w[nw++] = fse_decode(t, s1, b);
      if (b.off < 0) {
        w[nw++] = t.sym[s2];
        break;
      }
      w[nw++] = fse_decode(t, s2, b);
      if (b.off < 0) {
        w[nw++] = t.sym[s1];
        break;
      }
    }
    *used = 1 + csize;
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kMaxHufBits) return kCorrupt;
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) return kCorrupt;
  int max_bits = highbit(sum) + 1;
  if (max_bits > kMaxHufBits) return kCorrupt;
  uint32_t left = (1u << max_bits) - sum;
  if (left & (left - 1)) return kCorrupt;
  if (nw >= kMaxSymbols) return kCorrupt;
  w[nw++] = uint8_t(highbit(left) + 1);
  // code lengths, then the table: longest codes first, a symbol's range
  // 2^(max_bits - length) entries wide
  uint8_t len[kMaxSymbols];
  uint32_t count[kMaxHufBits + 2] = {0};
  for (int i = 0; i < nw; ++i) {
    len[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    count[len[i]]++;
  }
  uint32_t start[kMaxHufBits + 2];
  start[max_bits] = 0;
  for (int l = max_bits; l >= 1; --l) {
    start[l - 1] = start[l] + count[l] * (1u << (max_bits - l));
    if (start[l - 1] > (1u << max_bits)) return kCorrupt;
    std::memset(h.bits + start[l], l, start[l - 1] - start[l]);
  }
  if (start[0] != (1u << max_bits)) return kCorrupt;
  for (int i = 0; i < nw; ++i) {
    if (!len[i]) continue;
    uint32_t wide = 1u << (max_bits - len[i]);
    std::memset(h.sym + start[len[i]], i, wide);
    start[len[i]] += wide;
  }
  h.max_bits = max_bits;
  return kOk;
}

// One Huffman stream of [p, p + n) into out[0, count).
int huf_stream(const Huf& h, const uint8_t* p, size_t n, uint8_t* out,
               size_t count) {
  BackBits b;
  if (!b.init(p, n)) return kCorrupt;
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  uint32_t state = uint32_t(b.read(mb));
  for (size_t i = 0; i < count; ++i) {
    out[i] = h.sym[state];
    int nb = h.bits[state];
    state = ((state << nb) | uint32_t(b.read(nb))) & mask;
  }
  return b.off == -int64_t(mb) ? kOk : kCorrupt;
}

// ---- sequences ----

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// The state one frame carries from block to block.
struct FrameState {
  Huf huf;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

int read_table(Fse& t, bool& have, int mode, const int16_t* def, int ndef,
               int def_log, int max_log, int max_sym, const uint8_t* p,
               size_t n, size_t* used) {
  *used = 0;
  switch (mode) {
    case 0: {
      int rc = fse_build(t, def, ndef, def_log);
      if (rc) return rc;
      break;
    }
    case 1:
      if (n < 1) return kTruncated;
      if (p[0] >= max_sym) return kCorrupt;
      fse_rle(t, p[0]);
      *used = 1;
      break;
    case 2: {
      int rc = fse_read_header(t, p, n, max_log, max_sym, used);
      if (rc) return rc;
      break;
    }
    default:
      if (!have) return kCorrupt;
      return kOk;
  }
  have = true;
  return kOk;
}

// One compressed block [p, p + n) appended at out[pos]; out[0, pos) is
// the frame's output so far (a match may reach back to its start).
int decode_block(FrameState& fs, const uint8_t* p, size_t n, uint8_t* out,
                 size_t cap, size_t& pos) {
  static thread_local uint8_t lit[kMaxBlock];
  const size_t block_start = pos;
  if (n < 1) return kTruncated;
  // literals section
  int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  if (ltype < 2) {
    if ((sf & 1) == 0) {
      hdr = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (n < hdr) return kTruncated;
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hdr = 3;
      if (n < hdr) return kTruncated;
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
  } else {
    hdr = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hdr) return kTruncated;
    uint64_t v = 0;
    for (size_t i = 0; i < hdr; ++i) v |= uint64_t(p[i]) << (8 * i);
    if (hdr == 3) {
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (hdr == 4) {
      regen = (v >> 4) & 0x3FFF;
      csize = (v >> 18) & 0x3FFF;
    } else {
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
    }
  }
  if (regen > kMaxBlock) return kCorrupt;
  size_t q = hdr;
  if (ltype == 0) {
    if (n - q < regen) return kTruncated;
    std::memcpy(lit, p + q, regen);
    q += regen;
  } else if (ltype == 1) {
    if (n - q < 1) return kTruncated;
    std::memset(lit, p[q], regen);
    q += 1;
  } else {
    if (n - q < csize) return kTruncated;
    const uint8_t* c = p + q;
    size_t cn = csize;
    if (ltype == 2) {
      size_t used = 0;
      int rc = huf_read(fs.huf, c, cn, &used);
      if (rc) return rc;
      c += used;
      cn -= used;
    } else if (fs.huf.max_bits == 0) {
      return kCorrupt;  // treeless literals with no earlier table
    }
    if (sf == 0) {
      int rc = huf_stream(fs.huf, c, cn, lit, regen);
      if (rc) return rc;
    } else {
      if (cn < 6) return kTruncated;
      size_t s1 = rd_le(c, 2), s2 = rd_le(c + 2, 2), s3 = rd_le(c + 4, 2);
      if (s1 + s2 + s3 > cn - 6) return kCorrupt;
      size_t s4 = cn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) return kCorrupt;
      const uint8_t* sp = c + 6;
      size_t sizes[4] = {s1, s2, s3, s4};
      for (int i = 0; i < 4; ++i) {
        size_t cnt = i < 3 ? seg : regen - 3 * seg;
        int rc = huf_stream(fs.huf, sp, sizes[i], lit + i * seg, cnt);
        if (rc) return rc;
        sp += sizes[i];
      }
    }
    q += csize;
  }
  // sequences section
  if (q >= n) return kTruncated;
  size_t nseq = p[q++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (q >= n) return kTruncated;
      nseq = ((nseq - 128) << 8) + p[q++];
    } else {
      if (n - q < 2) return kTruncated;
      nseq = p[q] + (size_t(p[q + 1]) << 8) + 0x7F00;
      q += 2;
    }
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (q >= n) return kTruncated;
    uint8_t modes = p[q++];
    if (modes & 3) return kReserved;
    size_t used = 0;
    int rc = read_table(fs.ll, fs.have_ll, modes >> 6, kLLDefault, 36, 6, 9,
                        36, p + q, n - q, &used);
    if (rc) return rc;
    q += used;
    rc = read_table(fs.of, fs.have_of, (modes >> 4) & 3, kOFDefault, 29, 5, 8,
                    32, p + q, n - q, &used);
    if (rc) return rc;
    q += used;
    rc = read_table(fs.ml, fs.have_ml, (modes >> 2) & 3, kMLDefault, 53, 6, 9,
                    53, p + q, n - q, &used);
    if (rc) return rc;
    q += used;
    BackBits b;
    if (!b.init(p + q, n - q)) return kCorrupt;
    uint16_t sll = uint16_t(b.read(fs.ll.log));
    uint16_t sof = uint16_t(b.read(fs.of.log));
    uint16_t sml = uint16_t(b.read(fs.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t ofc = fs.of.sym[sof], llc = fs.ll.sym[sll], mlc = fs.ml.sym[sml];
      if (ofc > 31 || llc > 35 || mlc > 52) return kCorrupt;
      uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
      uint64_t ml = kMLBase[mlc] + b.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + b.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        sll = uint16_t(fs.ll.base[sll] + b.read(fs.ll.bits[sll]));
        sml = uint16_t(fs.ml.base[sml] + b.read(fs.ml.bits[sml]));
        sof = uint16_t(fs.of.base[sof] + b.read(fs.of.bits[sof]));
      }
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      } else {
        uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fs.rep[0];
        } else {
          off = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
          if (idx > 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = off;
        }
      }
      if (ll > regen - lit_pos) return kCorrupt;
      if (pos - block_start + ll + ml > kMaxBlock) return kCorrupt;
      if (ll + ml > cap - pos) return kTooSmall;
      std::memcpy(out + pos, lit + lit_pos, ll);
      pos += ll;
      lit_pos += ll;
      if (off == 0 || off > pos) return kCorrupt;
      const uint8_t* from = out + pos - off;
      if (off >= ml) {
        std::memcpy(out + pos, from, ml);
      } else {
        for (uint64_t k = 0; k < ml; ++k) out[pos + k] = from[k];
      }
      pos += ml;
    }
    if (b.off != 0) return kCorrupt;
  } else if (q != n) {
    return kCorrupt;
  }
  size_t rest = regen - lit_pos;
  if (pos - block_start + rest > kMaxBlock) return kCorrupt;
  if (rest > cap - pos) return kTooSmall;
  std::memcpy(out + pos, lit + lit_pos, rest);
  pos += rest;
  return kOk;
}

struct Header {
  size_t size = 0;        // header bytes after the magic
  uint64_t content = 0;   // content size, where the header states it
  bool has_content = false;
  bool checksum = false;
};

int read_header(const uint8_t* p, size_t n, Header& h) {
  if (n < 1) return kTruncated;
  uint8_t d = p[0];
  int fcs_flag = d >> 6, single = (d >> 5) & 1, did_flag = d & 3;
  if (d & 8) return kReserved;
  h.checksum = (d >> 2) & 1;
  size_t q = 1;
  if (!single) q += 1;  // window descriptor
  int did_size = did_flag == 3 ? 4 : did_flag;
  if (n < q + did_size) return kTruncated;
  if (rd_le(p + q, did_size) != 0) return kDictionary;
  q += did_size;
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
  if (n < q + fcs_size) return kTruncated;
  h.has_content = fcs_size > 0;
  if (fcs_size == 8) {
    h.content = rd64(p + q);
  } else if (fcs_size > 0) {
    h.content = rd_le(p + q, fcs_size) + (fcs_size == 2 ? 256 : 0);
  }
  h.size = q + fcs_size;
  return kOk;
}

// The frame at p (magic included): its size in bytes, and the bound of
// its decoded size.
int walk_frame(const uint8_t* p, size_t n, size_t* frame, uint64_t* bound) {
  if (n < 4) return kTruncated;
  uint32_t magic = rd_le(p, 4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (n < 8) return kTruncated;
    uint64_t len = rd_le(p + 4, 4);
    if (n - 8 < len) return kTruncated;
    *frame = size_t(8 + len);
    *bound = 0;
    return kOk;
  }
  if (magic != kMagic) return kBadMagic;
  Header h;
  int rc = read_header(p + 4, n - 4, h);
  if (rc) return rc;
  size_t q = 4 + h.size;
  uint64_t sum = 0;
  for (;;) {
    if (n - q < 3) return kTruncated;
    uint32_t bh = rd_le(p + q, 3);
    q += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) return kReserved;
    size_t body = type == 1 ? 1 : size;
    if (n - q < body) return kTruncated;
    sum += type == 2 ? kMaxBlock : size;
    q += body;
    if (last) break;
  }
  if (h.checksum) {
    if (n - q < 4) return kTruncated;
    q += 4;
  }
  *frame = q;
  *bound = h.has_content ? h.content : sum;
  return kOk;
}

int decode_frame(const uint8_t* p, size_t n, uint8_t* out, size_t cap,
                 size_t* frame, size_t* written) {
  uint32_t magic = rd_le(p, 4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    uint64_t ignored;
    *written = 0;
    return walk_frame(p, n, frame, &ignored);
  }
  Header h;
  int rc = read_header(p + 4, n - 4, h);
  if (rc) return rc;
  static thread_local FrameState fs;
  fs = FrameState();
  size_t q = 4 + h.size, pos = 0;
  for (;;) {
    if (n - q < 3) return kTruncated;
    uint32_t bh = rd_le(p + q, 3);
    q += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (size > kMaxBlock) return kCorrupt;
    if (type == 0) {
      if (n - q < size) return kTruncated;
      if (cap - pos < size) return kTooSmall;
      std::memcpy(out + pos, p + q, size);
      pos += size;
      q += size;
    } else if (type == 1) {
      if (n - q < 1) return kTruncated;
      if (cap - pos < size) return kTooSmall;
      std::memset(out + pos, p[q], size);
      pos += size;
      q += 1;
    } else if (type == 2) {
      if (n - q < size) return kTruncated;
      rc = decode_block(fs, p + q, size, out, cap, pos);
      if (rc) return rc;
      q += size;
    } else {
      return kReserved;
    }
    if (last) break;
  }
  if (h.has_content && h.content != pos) return kSizeMismatch;
  if (h.checksum) {
    if (n - q < 4) return kTruncated;
    if (uint32_t(xxh64(out, pos)) != rd_le(p + q, 4)) return kChecksum;
    q += 4;
  }
  *frame = q;
  *written = pos;
  return kOk;
}

}  // namespace

extern "C" {

int kfn_zstd_frame_size(const uint8_t* src, size_t n, uint64_t* bound) {
  if (!src && n) return kTruncated;
  uint64_t total = 0;
  size_t q = 0;
  do {
    size_t frame = 0;
    uint64_t b = 0;
    int rc = walk_frame(src + q, n - q, &frame, &b);
    if (rc) return rc;
    q += frame;
    total += b;
  } while (q < n);
  *bound = total;
  return kOk;
}

int kfn_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t cap, uint64_t* written) {
  if (!src && n) return kTruncated;
  size_t q = 0, pos = 0;
  do {
    if (n - q < 4) return kTruncated;
    size_t frame = 0, w = 0;
    int rc = decode_frame(src + q, n - q, dst + pos, cap - pos, &frame, &w);
    if (rc) return rc;
    q += frame;
    pos += w;
  } while (q < n);
  *written = pos;
  return kOk;
}

const char* kfn_zstd_error(int code) {
  switch (code) {
    case kOk: return "ok";
    case kTruncated: return "truncated input";
    case kBadMagic: return "not a zstd frame (bad magic number)";
    case kReserved: return "a reserved field or block type is set";
    case kDictionary: return "the frame needs a dictionary (not supported)";
    case kCorrupt: return "corrupt compressed data";
    case kChecksum: return "content checksum mismatch";
    case kTooSmall: return "decoded data larger than its stated bound";
    case kSizeMismatch: return "decoded size differs from the frame's "
                               "content size";
    default: return "unknown error";
  }
}

}  // extern "C"
