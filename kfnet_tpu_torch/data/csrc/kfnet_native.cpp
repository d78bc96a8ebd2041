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

}  // extern "C"
