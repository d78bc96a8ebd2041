// 3x3 SAME stride-1 convolutions on (h, w, C) bf16 maps, for NVIDIA Hopper.
//
// Replaces the two Pallas TPU kernels of kfnet_tpu/kernels/conv3x3.py:
//   * conv3x3_same (body _kernel): y = round(relu?(sum_taps shift(x) W + b)),
//     bf16 operands, float32 accumulation, one rounding to bf16 or float32;
//   * conv3x3_gn_chain (body _fused_kernel): the same product after a
//     prologue bf16(relu?(x * scale + shift)) applied per input channel to
//     the taps that lie inside the map (taps outside it read 0, as the
//     Pallas kernel zeroes its pad before writing the normalized interior),
//     and an epilogue writing y = bf16(acc) and the per-channel sums of acc
//     and acc^2 over the pixels, taken from the unrounded accumulator.
//
// Design: an implicit GEMM with M = h*w pixels, N = cout, K = 9*cin. A block
// computes a 64x128 output tile with 8 warps (2 along M, 4 along N), each
// warp 32x32 as 2x2 bf16 WMMA fragments (mma.sync on the tensor cores,
// float32 accumulation). K is walked one (tap, 32-channel chunk) at a time:
// each thread loads its share of the next A tile (the shifted pixels, with
// the prologue applied in registers) and B tile (weights laid out as
// (3, 3, cin, cout) bf16) from device memory while the warps multiply the
// current one in shared memory. The accumulators then go through shared
// memory (34 KB) to the epilogue. Of the tiles tried on the card
// (BM 64 or 128 by BK 32 or 64), this one was fastest at the main path's
// shapes: the 60x80 maps give 75 pixel tiles, enough blocks to fill the
// card, and the tile needs no more than the default 48 KB of shared
// memory.
//
// The Pallas grid walked cout tiles in order and carried its sums from step
// to step. Here blocks run in no order, so each M tile writes its partial
// sums to a scratch buffer the wrapper allocates, and a second kernel adds
// them per channel in tile order: no float atomics, and two runs agree bit
// for bit. conv3x3_gn_chain is therefore 2 CUDA launches per call;
// conv3x3_same is 1.
//
// Bound on this card: 2*h*w*9*cin*cout tensor-core operations per call, at
// 989 TFLOP/s dense bf16 (22.6 GFLOP, 22.9 us, for the 512->512 layers at
// 60x80); the bytes (x once, W once, y once) are an order of magnitude
// below it at 3.35 TB/s except for the 15x20 decoder map. This simple form
// (no TMA, no wgmma, no multi-stage pipeline) is expected well below that
// bound; making it fast is later work.
//
// Built with the port's shared flags (-fmad=false, no fast math): the
// prologue's multiply and add round separately, as in the plain PyTorch
// version; the tensor-core products are of bf16 values and exact in float32,
// so the kernel and its plain version differ only in the order (and the
// tensor cores' internal rounding) of the float32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // pixels per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 32;   // input channels per K step (one tap)
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;  // bf16; rows 80 B apart (32 B-aligned fragments)
constexpr int LDB = BN + 8;  // bf16; rows 272 B apart
constexpr int LDC = BN + 4;  // float
constexpr int A_BYTES = BM * LDA * 2;
constexpr int B_BYTES = BK * LDB * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES =
    (A_BYTES + B_BYTES > C_BYTES) ? A_BYTES + B_BYTES : C_BYTES;
constexpr int A_LOADS = BM * BK / 8 / THREADS;  // 16-byte loads per thread
constexpr int B_LOADS = BK * BN / 8 / THREADS;
static_assert(A_LOADS * THREADS * 8 == BM * BK, "A tile split");
static_assert(B_LOADS * THREADS * 8 == BK * BN, "B tile split");
static_assert(THREADS == 2 * BN, "moment epilogue: two threads per channel");
// within the 48 KB a launch gets without cudaFuncSetAttribute (a larger
// tile would have to raise cudaFuncAttributeMaxDynamicSharedMemorySize)
static_assert(SMEM_BYTES + 2 * 2 * BN * 4 <= 48 * 1024, "shared memory");
constexpr int WARPS_M = BM / 32;  // a warp computes 32 rows ...
constexpr int WARPS_N = THREADS / 32 / WARPS_M;
constexpr int WARP_N = BN / WARPS_N;  // ... by WARP_N columns
constexpr int FRAGS_N = WARP_N / 16;
static_assert(WARPS_M * WARPS_N * 32 == THREADS && FRAGS_N * 16 == WARP_N,
              "warp tiling");

struct ConvArgs {
  const bf16* x;       // (h, w, cin)
  const bf16* wk;      // (3, 3, cin, cout)
  const float* scale;  // (cin,), chain only
  const float* shift;  // (cin,), chain only
  const float* bias;   // (cout,) or null, conv3x3_same only
  void* y;             // (h, w, cout), bf16 or float32
  float* partial;      // (m_tiles, 2, cout), chain only
  int h, w, cin, cout, m;
  int relu;     // conv3x3_same: epilogue ReLU; chain: prologue ReLU
  int out_f32;  // conv3x3_same: float32 output
};

// Eight input channels [c, c + 8) of the pixel that tap `tap` of output pixel
// `pix` reads, as 8 bf16 in a uint4; 0 outside the map and past the last
// pixel. CHAIN applies the prologue to taps inside the map only.
template <bool CHAIN>
__device__ __forceinline__ uint4 load_a(const ConvArgs& p, int pix, int tap,
                                        int c) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pix >= p.m) return v;
  const int py = pix / p.w;
  const int px = pix - py * p.w;
  const int sy = py + tap / 3 - 1;
  const int sx = px + tap % 3 - 1;
  if (sy < 0 || sy >= p.h || sx < 0 || sx >= p.w) return v;
  v = *reinterpret_cast<const uint4*>(
      p.x + ((size_t)(sy * p.w + sx) * p.cin + c));
  if (CHAIN) {
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(e[j]) * p.scale[c + j];
      f = f + p.shift[c + j];
      if (p.relu) f = fmaxf(f, 0.0f);
      e[j] = __float2bfloat16_rn(f);
    }
  }
  return v;
}

template <bool CHAIN>
__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][2][BN];  // chain: (s1|s2, row half, channel)
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = p.cin / BK;
  const int steps = 9 * chunks;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FRAGS_N];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FRAGS_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[A_LOADS];
  uint4 rb[B_LOADS];
  auto fetch = [&](int step) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * BK;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (BK / 8);
      const int seg = idx % (BK / 8);
      ra[i] = load_a<CHAIN>(p, m0 + row, tap, c0 + seg * 8);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / (BN / 8);
      const int seg = idx % (BN / 8);
      rb[i] = *reinterpret_cast<const uint4*>(
          p.wk + ((size_t)(tap * p.cin + c0 + k) * p.cout + n0 + seg * 8));
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (idx / (BK / 8)) * LDA +
                                (idx % (BK / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(Bs + (idx / (BN / 8)) * LDB +
                                (idx % (BN / 8)) * 8) = rb[i];
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) fetch(step + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[FRAGS_N];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FRAGS_N; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * WARP_N + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FRAGS_N; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (step + 1 < steps) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FRAGS_N; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * 32 + i * 16) * LDC + wn * WARP_N + j * 16, acc[i][j], LDC,
          wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    const int pix = m0 + r;
    if (pix >= p.m) break;  // rows are in order: every later one is past too
    float v = Cs[r * LDC + c];
    const size_t o = (size_t)pix * p.cout + n0 + c;
    if (CHAIN) {
      reinterpret_cast<bf16*>(p.y)[o] = __float2bfloat16_rn(v);
    } else {
      if (p.bias) v = v + p.bias[n0 + c];
      if (p.relu) v = fmaxf(v, 0.0f);
      if (p.out_f32)
        reinterpret_cast<float*>(p.y)[o] = v;
      else
        reinterpret_cast<bf16*>(p.y)[o] = __float2bfloat16_rn(v);
    }
  }

  if (CHAIN) {
    // this tile's per-channel sums, in a fixed order: rows of each half in
    // turn, then the two halves
    const int c = tid % BN;
    const int half = tid / BN;
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
      if (m0 + r >= p.m) break;
      const float v = Cs[r * LDC + c];
      s1 = s1 + v;
      s2 = s2 + v * v;
    }
    red[0][half][c] = s1;
    red[1][half][c] = s2;
    __syncthreads();
    if (tid < BN) {
      float* out = p.partial + (size_t)blockIdx.x * 2 * p.cout;
      out[n0 + c] = red[0][0][c] + red[0][1][c];
      out[p.cout + n0 + c] = red[1][0][c] + red[1][1][c];
    }
  }
}

// s1[n] = sum over tiles of partial[t][0][n], s2 likewise, in tile order.
__global__ void moments_kernel(const float* __restrict__ partial,
                               float* __restrict__ s1, float* __restrict__ s2,
                               int tiles, int cout) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cout) return;
  float a = 0.0f, b = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    a = a + partial[(size_t)t * 2 * cout + n];
    b = b + partial[(size_t)t * 2 * cout + cout + n];
  }
  s1[n] = a;
  s2[n] = b;
}

template <bool CHAIN>
cudaError_t launch_conv(const ConvArgs& p, cudaStream_t stream) {
  const dim3 grid((p.m + BM - 1) / BM, p.cout / BN);
  conv3x3_kernel<CHAIN><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

bool shapes_ok(int h, int w, int cin, int cout) {
  return h > 0 && w > 0 && cin > 0 && cout > 0 && cin % BK == 0 &&
         cout % BN == 0;
}

}  // namespace

extern "C" {

// The pixel tile: the chain's partial-sum scratch holds ceil(h*w / this)
// tiles.
int kfnet_conv3x3_block_m() { return BM; }

// Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take. Device
// pointers; x and wk 16-byte aligned; bias may be null.
int kfnet_conv3x3_same(const bf16* x, const bf16* wk, const float* bias,
                       void* y, int h, int w, int cin, int cout, int relu,
                       int out_f32, int device, void* stream) {
  if (!shapes_ok(h, w, cin, cout)) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ConvArgs p = {x, wk, nullptr, nullptr, bias, y, nullptr,
                h, w, cin, cout, h * w, relu, out_f32};
  return (int)launch_conv<false>(p, (cudaStream_t)stream);
}

// Two launches: the conv with its per-tile sums into `partial`
// (ceil(h*w / kfnet_conv3x3_block_m()) x 2 x cout floats), then their sum.
int kfnet_conv3x3_gn_chain(const bf16* x, const float* scale,
                           const float* shift, const bf16* wk, bf16* y,
                           float* partial, float* s1, float* s2, int h, int w,
                           int cin, int cout, int prologue_relu, int device,
                           void* stream) {
  if (!shapes_ok(h, w, cin, cout)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ConvArgs p = {x, wk, scale, shift, nullptr, y, partial,
                h, w, cin, cout, h * w, prologue_relu, 0};
  err = launch_conv<true>(p, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (h * w + BM - 1) / BM;
  moments_kernel<<<(cout + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      partial, s1, s2, tiles, cout);
  return (int)cudaGetLastError();
}

const char* kfnet_conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
