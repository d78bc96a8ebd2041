// Deterministic mutation fuzzer for the port's hand-written decoders: the
// PNG and JPEG decoders of data/csrc/kfnet_native.cpp and the zstd frame
// decoder of utils/csrc/zstd_decode.cpp. Built with ASan + UBSan (by
// tests/test_torch_native_fuzz.py):
//
//   g++ -O1 -g -std=c++17 -fsanitize=address,undefined \
//       -fno-sanitize-recover=all -o fuzz_native fuzz_native.cpp \
//       kfnet_native.cpp zstd_decode.cpp -lz
//   fuzz_native <iters> <seed> [<seed> ...]
//
// Any out-of-bounds access, overflow or leak aborts the process. Each
// decoder's contract under corruption: a non-zero return, no crash, and
// writes confined to the caller's buffer, sized from its info call.
//
// A seed's kind is read from its magic number (PNG, JPEG or a zstd
// frame). Each iteration (xorshift PRNG seeded by the iteration index, so
// a run is reproducible) takes one seed and applies one mutation: a
// truncation, 1..8 byte flips, or a patched header: a PNG's IHDR size, a
// JPEG's SOF size, a zstd frame's first block header, or the first bytes
// of that block (the literals header, the Huffman and FSE table
// descriptions and the sequences header).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int kfn_png_info(const uint8_t*, size_t, int*, int*, int*, int*);
int kfn_png_decode(const uint8_t*, size_t, void*);
int kfn_png_decode_rgb_f32(const uint8_t*, size_t, float*);
int kfn_jpeg_info(const uint8_t*, size_t, int*, int*, int*);
int kfn_jpeg_decode(const uint8_t*, size_t, uint8_t*);
int kfn_zstd_frame_size(const uint8_t*, size_t, uint64_t*);
int kfn_zstd_decompress(const uint8_t*, size_t, uint8_t*, size_t,
                        uint64_t*);
}

namespace {

enum Kind { kPng, kJpeg, kZstd };

uint64_t state;
uint64_t rnd() {  // xorshift64*
  state ^= state >> 12;
  state ^= state << 25;
  state ^= state >> 27;
  return state * 0x2545F4914F6CDD1DULL;
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(size_t(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

bool kind_of(const std::vector<uint8_t>& d, Kind* k) {
  if (d.size() >= 8 && d[0] == 0x89 && d[1] == 'P' && d[2] == 'N') {
    *k = kPng;
  } else if (d.size() >= 2 && d[0] == 0xFF && d[1] == 0xD8) {
    *k = kJpeg;
  } else if (d.size() >= 4 && d[0] == 0x28 && d[1] == 0xB5 &&
             d[2] == 0x2F && d[3] == 0xFD) {
    *k = kZstd;
  } else {
    return false;
  }
  return true;
}

void die(const char* what, long a, long b) {
  std::fprintf(stderr, "%s: %ld %ld\n", what, a, b);
  std::abort();
}

void exercise_png(const std::vector<uint8_t>& d) {
  int w = 0, h = 0, ch = 0, bits = 0;
  if (kfn_png_info(d.data(), d.size(), &w, &h, &ch, &bits) != 0) return;
  if (w <= 0 || h <= 0 || w > 16384 || h > 16384)
    die("kfn_png_info accepted dims", w, h);
  std::vector<uint8_t> out(size_t(w) * h * ch * (bits / 8));
  (void)kfn_png_decode(d.data(), d.size(), out.data());
  if (bits == 8) {
    std::vector<float> rgb(size_t(w) * h * 3);
    (void)kfn_png_decode_rgb_f32(d.data(), d.size(), rgb.data());
  }
}

void exercise_jpeg(const std::vector<uint8_t>& d) {
  int w = 0, h = 0, ch = 0;
  if (kfn_jpeg_info(d.data(), d.size(), &w, &h, &ch) != 0) return;
  if (w <= 0 || h <= 0 || w > 16384 || h > 16384)
    die("kfn_jpeg_info accepted dims", w, h);
  if (ch != 1 && ch != 3) die("kfn_jpeg_info channels", ch, 0);
  std::vector<uint8_t> out(size_t(w) * h * ch);
  (void)kfn_jpeg_decode(d.data(), d.size(), out.data());
}

void exercise_zstd(const std::vector<uint8_t>& d) {
  uint64_t bound = 0;
  if (kfn_zstd_frame_size(d.data(), d.size(), &bound) != 0) return;
  // the caller's cap: a patched content size may claim any size
  if (bound > (uint64_t(64) << 20)) return;
  std::vector<uint8_t> out(size_t(bound) + 1);
  uint64_t written = 0;
  if (kfn_zstd_decompress(d.data(), d.size(), out.data(), size_t(bound),
                          &written) == 0 && written > bound)
    die("kfn_zstd_decompress wrote past its bound", long(written),
        long(bound));
  // a buffer smaller than the bound must be refused, not overrun
  std::vector<uint8_t> half(size_t(bound / 2) + 1);
  (void)kfn_zstd_decompress(d.data(), d.size(), half.data(),
                            size_t(bound / 2), &written);
}

void exercise(Kind k, const std::vector<uint8_t>& d) {
  if (k == kPng) exercise_png(d);
  if (k == kJpeg) exercise_jpeg(d);
  if (k == kZstd) exercise_zstd(d);
}

void be16_store(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 8);
  p[1] = uint8_t(v);
}

void be32_store(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

// The offset of a zstd frame's first block header, or 0.
size_t zstd_first_block(const std::vector<uint8_t>& d) {
  if (d.size() < 5) return 0;
  uint8_t fhd = d[4];
  int fcs = fhd >> 6, single = (fhd >> 5) & 1, did = fhd & 3;
  size_t n = 5 + (single ? 0 : 1) + (did == 3 ? 4 : did) +
             (fcs == 0 ? (single ? 1 : 0) : (1u << fcs));
  return n + 3 <= d.size() ? n : 0;
}

void patch_header(Kind k, std::vector<uint8_t>& d) {
  static const uint32_t dims[] = {0u, 1u, 479u, 16384u, 16385u, 65535u,
                                  0x7FFFFFFFu, 0x80000000u, 0xFFFFFFFFu};
  if (k == kPng) {
    if (d.size() < 33) return;
    be32_store(d.data() + 16, dims[rnd() % 9]);
    be32_store(d.data() + 20, dims[rnd() % 9]);
  } else if (k == kJpeg) {
    for (size_t i = 2; i + 9 <= d.size(); ++i) {
      if (d[i] == 0xFF && (d[i + 1] == 0xC0 || d[i + 1] == 0xC1)) {
        be16_store(d.data() + i + 5, dims[rnd() % 9] & 0xFFFF);
        be16_store(d.data() + i + 7, dims[rnd() % 9] & 0xFFFF);
        return;
      }
    }
  } else {
    size_t b = zstd_first_block(d);
    if (!b) return;
    if (rnd() % 2) {  // the block header: type, last flag and size
      static const uint32_t sizes[] = {0, 1, 127, 128 * 1024,
                                       128 * 1024 + 1, (1u << 21) - 1};
      uint32_t size = rnd() % 2 ? sizes[rnd() % 6] : uint32_t(rnd() % 4096);
      uint32_t bh = (size << 3) | uint32_t(rnd() % 8);
      d[b] = uint8_t(bh);
      d[b + 1] = uint8_t(bh >> 8);
      d[b + 2] = uint8_t(bh >> 16);
    } else {  // the literals, Huffman, sequences and FSE headers
      size_t n = 1 + rnd() % 4;
      for (size_t i = 0; i < n; ++i) {
        size_t at = b + 3 + rnd() % 24;
        if (at < d.size()) d[at] = uint8_t(rnd());
      }
    }
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <iters> <seed> [...]\n", argv[0]);
    return 2;
  }
  long iters = std::atol(argv[1]);
  std::vector<std::vector<uint8_t>> seeds;
  std::vector<Kind> kinds;
  for (int i = 2; i < argc; ++i) {
    std::vector<uint8_t> s;
    Kind k;
    if (!read_file(argv[i], s) || !kind_of(s, &k)) {
      std::fprintf(stderr, "cannot read seed %s (PNG, JPEG or zstd)\n",
                   argv[i]);
      return 2;
    }
    exercise(k, s);  // pristine seeds decode without tripping a sanitizer
    seeds.push_back(std::move(s));
    kinds.push_back(k);
  }
  for (long it = 0; it < iters; ++it) {
    state = uint64_t(it) * 0x9E3779B97F4A7C15ULL + 0xD1B54A32D192ED03ULL;
    size_t pick = rnd() % seeds.size();
    std::vector<uint8_t> data = seeds[pick];
    switch (rnd() % 3) {
      case 0:  // truncate
        data.resize(rnd() % (data.size() + 1));
        break;
      case 1: {  // 1..8 byte flips
        uint64_t flips = 1 + rnd() % 8;
        for (uint64_t f = 0; f < flips && !data.empty(); ++f)
          data[rnd() % data.size()] ^= uint8_t(1 + rnd() % 255);
        break;
      }
      case 2:
        patch_header(kinds[pick], data);
        break;
    }
    exercise(kinds[pick], data);
  }
  std::printf("ok %ld iterations over %zu seeds\n", iters, seeds.size());
  return 0;
}
