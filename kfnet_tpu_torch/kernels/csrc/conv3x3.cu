// 3x3 SAME stride-1 convolutions on (h, w, C) bf16 maps, for NVIDIA Hopper
// (sm_90a): a wgmma implicit GEMM fed by TMA.
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
// What bounds a call on this card: the GEMM has M = h*w pixels, N = cout,
// K = 9*cin. At 60x80 the operations do: 2*M*N*K at 989 TFLOP/s dense bf16
// (22.6 GFLOP, 22.9 us, for the 512->512 trunk layers) against 14.5 MB of
// x, weights and y at 3.35 TB/s (4.3 us). The 15x20 decoder map (0.35
// GFLOP, 0.36 us) is bound by its bytes (1.5 MB, 1.2 of them weights,
// 0.44 us) and, in practice, by the latency of a short pipeline.
//
// Design:
//   * An implicit GEMM on the tensor cores through wgmma.mma_async with
//     both operands in shared memory and the float32 accumulator in
//     registers: each consumer warpgroup computes an 8 x 8-pixel tile (its
//     m64) by BN = 128 output channels (m64n128k16).
//   * K is walked by chunks of BK = 64 input channels; for each chunk a
//     block needs the halo patch (TH + 2) x 10 pixels x 64 channels, which
//     one TMA load brings into shared memory with a 128-byte swizzle. The
//     load starts at signed coordinates (x0 - 1, y0 - 1): the hardware
//     zero-fills what lies outside the map, and that zero is the SAME pad.
//     So every input element is read from device memory once per tile and
//     chunk, not once per tap.
//   * The nine taps are shifted windows of the patch, and with 8-pixel-wide
//     tiles each window is one wgmma shared-memory descriptor: the m64's
//     eight groups of eight rows are the tile's eight map rows, each eight
//     consecutive 128-byte patch rows, the groups one patch row (10 x 128
//     bytes) apart; the window of tap (dy, dx) starts dy patch rows and dx
//     pixels in. (The swizzle is a function of the address, so a start
//     that is not 1024-byte aligned needs no base offset.) A first form
//     took A into registers with ldmatrix and issued wgmma with A from
//     registers, on 16-pixel-wide tiles: ptxas serializes those wgmmas
//     (warning C7513: registers of a wgmma defined while earlier ones are
//     in flight), and it was the slower of the two on the card.
//   * Weights (B) are prepared once per weight tensor as (cout, 9*cin) bf16,
//     K-major (K = tap*cin + c), and loaded by TMA, one 64 x 128 tile per
//     tap and chunk, into a ring of B_STAGES stages with a 128-byte swizzle,
//     which the wgmma descriptor reads as is (no transpose bit).
//   * One producer warp (one thread) keeps the TMA loads in flight, paced by
//     full/empty mbarriers for the patch ring (2 stages) and the B ring; the
//     next chunk's patch goes out as soon as its stage is free. The
//     consumers keep one wgmma group (a tap: four k16 steps) in flight
//     behind the one they issue, and free a stage when the group that read
//     it is done.
//   * Persistent blocks: the grid is the blocks the card holds at once
//     (two an SM with one consumer warpgroup, one with two), and each takes
//     units (pixel tile x 128 channels x K split) in turn, its pipeline
//     running on from unit to unit, so the units beyond the first wave do
//     not wait for a whole second wave of blocks.
//   * conv3x3_gn_chain normalizes the patch once per chunk in shared memory
//     (8 channels of scale/shift per thread, in registers), skipping pixels
//     outside the map so that they stay 0, not relu(shift); a proxy fence
//     and a named barrier then hand the patch to wgmma.
//   * Epilogue: bias and ReLU (conv3x3_same) or the moments (chain) come
//     straight from the accumulator registers; the values then go through a
//     small staging area, 8 rows at a time, so that each warp writes its
//     rows with 16-byte stores. The chain's per-channel sums: each thread
//     sums its two rows, a butterfly of warp shuffles sums the warp's 16,
//     the warps are added in order, and each pixel tile writes one row of
//     partial sums to a scratch buffer; moments_kernel adds the rows in a
//     fixed order. No float atomics: two runs give the same bits.
//   * Small maps (the decoder's 15x20 and 30x40) give few pixel tiles, so
//     conv3x3_same may split K by channel chunks across units; each split
//     writes float32 partials and split_sum_kernel adds them in split
//     order, then applies bias, ReLU and the one rounding, as the Pallas
//     body does after its full sum.
//   * The wrapper's plan (kernels/conv3x3.py::plan) picks the consumer
//     warpgroups per block and the splits from the card's times of every
//     plan (kfnet_tpu_torch/tools/conv_tiles.py).
//
// Built with the port's shared flags (-fmad=false, no fast math): the
// prologue's multiply and add round separately, as in the plain PyTorch
// version; the tensor-core products are of bf16 values and exact in float32,
// so the kernel and its plain version differ only in the order of the
// float32 sums.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE_W = 8;    // pixels along a map row: one 8-row core group
constexpr int WG_ROWS = 8;   // map rows per consumer warpgroup (its m64)
constexpr int BN = 128;      // output channels per block
constexpr int BK = 64;       // input channels per chunk: one 128-byte row
constexpr int KSTEPS = BK / 16;
constexpr int PATCH_W = TILE_W + 2;
constexpr int A_STAGES = 2;
constexpr int B_STAGE_BYTES = BN * BK * 2;
constexpr int ACC = BN / 2;  // float accumulators per thread (m64n128)

template <int WGS>
struct Cfg {
  static constexpr int TH = WG_ROWS * WGS;
  static constexpr int PATCH_PIX = (TH + 2) * PATCH_W;
  static constexpr int A_BYTES = PATCH_PIX * BK * 2;  // one TMA load
  static constexpr int A_STAGE = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr int B_STAGES = 3;
  static constexpr int WARPS = 4 * WGS;  // consumer warps
  static constexpr int CONSUMERS = 32 * WARPS;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int PIPE_BYTES =
      A_STAGES * A_STAGE + B_STAGES * B_STAGE_BYTES;
  // epilogue staging, apart from the ring (which already holds the next
  // tile's loads): 8 rows a warp at a time, float32 at most, each row 16
  // bytes longer than its data to spread the banks
  static constexpr int STAGE_ROW = BN * 4 + 16;
  static constexpr int EPI_BYTES = WARPS * 8 * STAGE_ROW;
  static constexpr int RED_BYTES = WARPS * 2 * BN * 4;  // chain sums
  static constexpr int DATA_BYTES = PIPE_BYTES + EPI_BYTES + RED_BYTES;
  static constexpr int BARS = 2 * (A_STAGES + B_STAGES);
  static constexpr int SMEM = DATA_BYTES + BARS * 8 + 1024;  // + alignment
  // one warpgroup: two blocks an SM (registers and shared memory allow it)
  static constexpr int MIN_BLOCKS = WGS == 1 ? 2 : 1;
};
static_assert(2 * (Cfg<1>::SMEM + 1024) <= 228 * 1024, "two blocks an SM");
static_assert(Cfg<2>::SMEM <= 227 * 1024, "shared memory");

struct Params {
  const float* scale;  // (cin,), chain only
  const float* shift;  // (cin,), chain only
  const float* bias;   // (cout,) or null; conv3x3_same without split only
  void* y;             // (h, w, cout) bf16 or float32
  float* partial;      // chain: (tiles, 2, cout); split: (splits, h*w, cout)
  int h, w, cin, cout;
  int tiles_x;  // pixel tiles along a map row
  int tiles;    // pixel tiles
  int splits;   // K splits
  int units;    // tiles x splits x cout / BN: the work, one unit at a time
  int chunks;   // K chunks (BK channels, all nine taps) per unit
  int relu;     // conv3x3_same: epilogue ReLU; chain: prologue ReLU
  int out_f32;  // conv3x3_same: float32 output
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of more than
// some 2^33 cycles (seconds) can only be a fault of the pipeline: it traps,
// so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 33)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void keep_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major tile of 128-byte rows with a 128-byte swizzle and
// 8-row groups `group_bytes` apart, starting at shared address `addr` (any
// 128-byte row). The base offset field stays 0: the 128-byte swizzle is
// taken from the address itself, and a base offset set to the start's
// phase within its 1024-byte pattern gave wrong sums on the card.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr,
                                                uint32_t group_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(group_bytes >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64x128] += A[64x16] * B[16x128], both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[ACC],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

// ----------------------------------------------------------------- kernel

// Shared byte offset of 16-byte chunk `c` of patch pixel `pix` (a 128-byte
// row each), as the 128-byte TMA swizzle lays it out.
__device__ __forceinline__ uint32_t swz(int pix, int c) {
  return (uint32_t)(pix * 128 + ((c ^ (pix & 7)) << 4));
}

// The chain's prologue on one patch in shared memory: bf16(relu?(x * scale
// + shift)) for the pixels inside the map; those outside stay 0 (the pad).
// Consumer thread `tid` of CONSUMERS takes channels 8(tid % 8).. of chunk
// `kc` and every (CONSUMERS / 8)-th pixel.
template <int PATCH_PIX, int CONSUMERS>
__device__ __forceinline__ void normalize_patch(unsigned char* patch,
                                                const Params& p, int kc,
                                                int y0, int x0, int tid) {
  const int c8 = tid & 7;
  const int c = kc * BK + c8 * 8;
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = __ldg(p.scale + c + j);
    sh[j] = __ldg(p.shift + c + j);
  }
  for (int pix = tid >> 3; pix < PATCH_PIX; pix += CONSUMERS / 8) {
    const int py = pix / PATCH_W;
    const int my = y0 - 1 + py;
    const int mx = x0 - 1 + (pix - py * PATCH_W);
    if (my < 0 || my >= p.h || mx < 0 || mx >= p.w) continue;
    uint4* v4 = reinterpret_cast<uint4*>(patch + swz(pix, c8));
    uint4 v = *v4;
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(e[j]) * sc[j];
      f = f + sh[j];
      if (p.relu) f = fmaxf(f, 0.0f);
      e[j] = __float2bfloat16_rn(f);
    }
    *v4 = v;
  }
  // the normalized patch is read by wgmma and written again by TMA: both
  // are the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


template <int WGS, bool CHAIN>
__global__ void __launch_bounds__(Cfg<WGS>::THREADS, Cfg<WGS>::MIN_BLOCKS)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const Params p) {
  using C = Cfg<WGS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + A_STAGES * C::A_STAGE;
  const uint32_t bars = smem_u32(smem + C::DATA_BYTES);
  auto full_a = [&](int s) { return bars + 8 * s; };
  auto empty_a = [&](int s) { return bars + 8 * (A_STAGES + s); };
  auto full_b = [&](int s) { return bars + 8 * (2 * A_STAGES + s); };
  auto empty_b = [&](int s) {
    return bars + 8 * (2 * A_STAGES + C::B_STAGES + s);
  };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), C::WARPS);
    }
    for (int s = 0; s < C::B_STAGES; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), C::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A persistent block: it takes units blockIdx.x, + gridDim.x, ... in
  // turn. Unit u is pixel tile u % tiles, K split (u / tiles) % splits and
  // output channel tile u / (tiles * splits). Producer and consumers walk
  // the same units, their stage counters running on from unit to unit.
  if (warp == C::WARPS) {  // the producer
    if (lane == 0) {
      int sa = 0, pa = 0, sb = 0, pb = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int tile = u % p.tiles;
        const int rest = u / p.tiles;
        const int y0 = (tile / p.tiles_x) * C::TH;
        const int x0 = (tile % p.tiles_x) * TILE_W;
        const int n0 = (rest / p.splits) * BN;
        const int kc0 = (rest % p.splits) * p.chunks;
        auto load_patch = [&](int kc) {
          mbar_wait(empty_a(sa), pa ^ 1);
          mbar_expect_tx(full_a(sa), C::A_BYTES);
          tma_load_3d(a_base + sa * C::A_STAGE, &xmap, full_a(sa), kc * BK,
                      x0 - 1, y0 - 1);
          if (++sa == A_STAGES) { sa = 0; pa ^= 1; }
        };
        load_patch(kc0);
        for (int kc = kc0; kc < kc0 + p.chunks; ++kc) {
          for (int tap = 0; tap < 9; ++tap) {
            // the next chunk's patch goes out right after this chunk's
            // second weights: the consumers free its stage at their second
            // step of this chunk
            if (tap == 1 && kc + 1 < kc0 + p.chunks) load_patch(kc + 1);
            mbar_wait(empty_b(sb), pb ^ 1);
            mbar_expect_tx(full_b(sb), B_STAGE_BYTES);
            tma_load_2d(b_base + sb * B_STAGE_BYTES, &wmap, full_b(sb),
                        tap * p.cin + kc * BK, n0);
            if (++sb == C::B_STAGES) { sb = 0; pb ^= 1; }
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g computes map rows 8g .. 8g + 7 of the tile;
  // warp w (of the block) holds rows 2w and 2w + 1
  const int wg = warp / 4;
  const int q = lane & 3;
  const int r = lane >> 2;
  const bool f32 = !CHAIN && (p.out_f32 || p.splits > 1);
  const int row_bytes = BN * (f32 ? 4 : 2);
  const int stage_row = row_bytes + 16;
  unsigned char* stg = smem + C::PIPE_BYTES + warp * 8 * C::STAGE_ROW;
  float* red = reinterpret_cast<float*>(smem + C::PIPE_BYTES + C::EPI_BYTES);
  int sa = 0, pa = 0, sb = 0, pb = 0;

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int tile = u % p.tiles;
    const int rest = u / p.tiles;
    const int y0 = (tile / p.tiles_x) * C::TH;
    const int x0 = (tile % p.tiles_x) * TILE_W;
    const int n0 = (rest / p.splits) * BN;
    const int split = rest % p.splits;
    const int kc0 = split * p.chunks;

    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
    int prev_sb = -1, prev_sa = -1;

    for (int i = 0; i < p.chunks; ++i) {
      const int kc = kc0 + i;
      mbar_wait(full_a(sa), pa);
      const uint32_t patch = a_base + sa * C::A_STAGE;
      if (CHAIN) {
        // the prologue, once per chunk; then every consumer's share of the
        // patch is in place. (Normalizing the next chunk's patch while this
        // chunk's products run, in quarters between the steps, was slower
        // on the card.)
        normalize_patch<C::PATCH_PIX, C::CONSUMERS>(smem + sa * C::A_STAGE,
                                                    p, kc, y0, x0, tid);
        named_bar_sync(1, C::CONSUMERS);
      }
      // tap (dy, dx) of the warpgroup's 8 x 8 pixels is the window of the
      // patch at row 8g + dy, column dx: 8 groups of 8 consecutive 128-byte
      // rows, one patch row (PATCH_W rows of 128 bytes) apart
      const uint32_t wg_patch = patch + (8 * wg) * PATCH_W * 128;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t a0 = wg_patch + ((tap / 3) * PATCH_W + tap % 3) * 128;
        mbar_wait(full_b(sb), pb);
        wgmma_fence();
        const uint32_t bst = b_base + sb * B_STAGE_BYTES;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_m64n128k16(acc, kmajor_desc(a0 + ks * 32, PATCH_W * 128),
                           kmajor_desc(bst + ks * 32, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done
        if (lane == 0) {
          if (prev_sb >= 0) mbar_arrive(empty_b(prev_sb));
          if (tap == 0 && prev_sa >= 0) mbar_arrive(empty_a(prev_sa));
        }
        prev_sb = sb;
        if (++sb == C::B_STAGES) { sb = 0; pb ^= 1; }
      }
      prev_sa = sa;  // free once the chunk's last group is done
      if (++sa == A_STAGES) { sa = 0; pa ^= 1; }
    }
    wgmma_wait<0>();
    keep_acc(acc);
    if (lane == 0) {  // the unit's last stages
      mbar_arrive(empty_b(prev_sb));
      mbar_arrive(empty_a(prev_sa));
    }
    // the previous unit's sums have been read: red may be written again
    named_bar_sync(1, C::CONSUMERS);

    // this thread's accumulators: rows r and r + 8 of the warp's 16 (pixel
    // x0 + r of map rows gy and gy + 1), columns 8j + 2q and 8j + 2q + 1
    const int gy = y0 + 2 * warp;
    const bool ok0 = gy < p.h && x0 + r < p.w;
    const bool ok1 = gy + 1 < p.h && x0 + r < p.w;
    const bool bias = !CHAIN && p.splits == 1 && p.bias;
    float bb[BN / 4];  // this thread's columns of the bias
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      bb[2 * j] = bias ? __ldg(p.bias + n0 + 8 * j + 2 * q) : 0.0f;
      bb[2 * j + 1] = bias ? __ldg(p.bias + n0 + 8 * j + 2 * q + 1) : 0.0f;
    }
    if (CHAIN) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a0 = ok0 ? acc[4 * j + e] : 0.0f;
          const float a1 = ok1 ? acc[4 * j + 2 + e] : 0.0f;
          float t1 = a0 + a1;
          float t2 = a0 * a0 + a1 * a1;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            t1 = t1 + __shfl_xor_sync(0xffffffffu, t1, o);
            t2 = t2 + __shfl_xor_sync(0xffffffffu, t2, o);
          }
          if (r == 0) {
            red[(warp * 2) * BN + 8 * j + 2 * q + e] = t1;
            red[(warp * 2 + 1) * BN + 8 * j + 2 * q + e] = t2;
          }
        }
      }
    }
    unsigned char* out = reinterpret_cast<unsigned char*>(
        p.splits > 1 ? reinterpret_cast<void*>(
                           p.partial + (size_t)split * p.h * p.w * p.cout)
                     : p.y);
    const int esize = f32 ? 4 : 2;
    const int lanes_per_row = row_bytes / 16;
    const int rows_per_pass = 32 / lanes_per_row;
    // two passes of 8 rows (one map row each) through the staging area,
    // then 16-byte stores
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * q;
        float v0 = acc[4 * j + 2 * h2];
        float v1 = acc[4 * j + 2 * h2 + 1];
        if (!CHAIN && p.splits == 1) {
          v0 = v0 + bb[2 * j];
          v1 = v1 + bb[2 * j + 1];
          if (p.relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
        }
        unsigned char* dst = stg + r * stage_row;
        if (f32) {
          *reinterpret_cast<float2*>(dst + col * 4) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + col * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
      const int py = gy + h2;
      for (int rr = lane / lanes_per_row; rr < 8; rr += rows_per_pass) {
        const int px = x0 + rr;
        const int seg = lane % lanes_per_row;
        if (py < p.h && px < p.w) {
          *reinterpret_cast<uint4*>(
              out + ((size_t)(py * p.w + px) * p.cout + n0) * esize +
              seg * 16) =
              *reinterpret_cast<const uint4*>(stg + rr * stage_row +
                                              seg * 16);
        }
      }
      __syncwarp();
    }

    if (CHAIN) {
      named_bar_sync(1, C::CONSUMERS);
      if (tid < BN) {  // this tile's sums, the warps in order
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int wi = 0; wi < C::WARPS; ++wi) {
          s1 = s1 + red[(wi * 2) * BN + tid];
          s2 = s2 + red[(wi * 2 + 1) * BN + tid];
        }
        float* dst = p.partial + (size_t)tile * 2 * p.cout + n0 + tid;
        dst[0] = s1;
        dst[p.cout] = s2;
      }
    }
  }
}

// s1[n] = sum over tiles of partial[t][0][n], s2 likewise, in a fixed
// order: warp k of a block sums tiles k, k + 8, ... of its 32 channels in
// turn, and the eight warps' sums are added in warp order.
constexpr int MOMENT_WARPS = 8;

__global__ void __launch_bounds__(32 * MOMENT_WARPS)
    moments_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                   float* __restrict__ s2, int tiles, int cout) {
  __shared__ float part[2][MOMENT_WARPS][32];
  const int lane = threadIdx.x % 32;
  const int k = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  float a = 0.0f, b = 0.0f;
  for (int t = k; t < tiles; t += MOMENT_WARPS) {
    a = a + partial[(size_t)t * 2 * cout + n];
    b = b + partial[(size_t)t * 2 * cout + cout + n];
  }
  part[0][k][lane] = a;
  part[1][k][lane] = b;
  __syncthreads();
  if (k == 0) {
    a = part[0][0][lane];
    b = part[1][0][lane];
#pragma unroll
    for (int i = 1; i < MOMENT_WARPS; ++i) {
      a = a + part[0][i][lane];
      b = b + part[1][i][lane];
    }
    s1[n] = a;
    s2[n] = b;
  }
}

// y = round(relu?(sum over splits, in order, of partial + bias)), four
// channels a thread.
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ bias, void* y,
                                 int m, int cout, int splits, int relu,
                                 int out_f32) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // float4 index
  const int n4 = m * cout / 4;
  if (i >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(partial);
  float4 s = src[i];
  for (int k = 1; k < splits; ++k) {
    const float4 t = src[(size_t)k * n4 + i];
    s.x = s.x + t.x;
    s.y = s.y + t.y;
    s.z = s.z + t.z;
    s.w = s.w + t.w;
  }
  const int c = (i * 4) % cout;
  if (bias) {
    s.x = s.x + bias[c];
    s.y = s.y + bias[c + 1];
    s.z = s.z + bias[c + 2];
    s.w = s.w + bias[c + 3];
  }
  if (relu) {
    s.x = fmaxf(s.x, 0.0f);
    s.y = fmaxf(s.y, 0.0f);
    s.z = fmaxf(s.z, 0.0f);
    s.w = fmaxf(s.w, 0.0f);
  }
  if (out_f32) {
    reinterpret_cast<float4*>(y)[i] = s;
  } else {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(y) + 2 * i;
    o[0] = __floats2bfloat162_rn(s.x, s.y);
    o[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

// --------------------------------------------------------------------- host

// kfnet_* return codes above this are a failed cuTensorMapEncodeTiled (the
// CUresult added to it); below, a cudaError_t.
constexpr int TENSOR_MAP_ERROR = 100000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
  }
  return fn;
}

// A bf16 tensor map with a 128-byte swizzle: dims and box innermost first,
// strides in bytes of dims 1.. .
int encode(CUtensorMap* m, const void* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (!fn) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult res = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                    const_cast<void*>(base), dims, strides, box, ones,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

template <int WGS, bool CHAIN>
int launch_conv(const bf16* x, const bf16* wk, Params p, int device,
                cudaStream_t stream) {
  using C = Cfg<WGS>;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {(cuuint64_t)p.cin, (cuuint64_t)p.w,
                               (cuuint64_t)p.h};
  const cuuint64_t xstrides[2] = {(cuuint64_t)p.cin * 2,
                                  (cuuint64_t)p.w * p.cin * 2};
  const cuuint32_t xbox[3] = {BK, PATCH_W, C::TH + 2};
  int err = encode(&xmap, x, 3, xdims, xstrides, xbox);
  if (err) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * p.cin, (cuuint64_t)p.cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * p.cin * 2};
  const cuuint32_t wbox[2] = {BK, BN};
  err = encode(&wmap, wk, 2, wdims, wstrides, wbox);
  if (err) return err;
  // once per device: allow the dynamic shared memory (above 48 KB) and
  // count the blocks the card holds at once, the persistent grid
  static int resident[32] = {};
  if (device < 0 || device >= 32) return (int)cudaErrorInvalidDevice;
  if (!resident[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma<WGS, CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    int per_sm = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv3x3_wgmma<WGS, CHAIN>, C::THREADS, C::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[device] = per_sm * sms;
  }
  const int grid = p.units < resident[device] ? p.units : resident[device];
  conv3x3_wgmma<WGS, CHAIN><<<grid, C::THREADS, C::SMEM, stream>>>(xmap, wmap,
                                                                   p);
  return (int)cudaGetLastError();
}

template <bool CHAIN>
int launch_wgs(int wgs, const bf16* x, const bf16* wk, const Params& p,
               int device, cudaStream_t stream) {
  if (wgs == 1) return launch_conv<1, CHAIN>(x, wk, p, device, stream);
  return launch_conv<2, CHAIN>(x, wk, p, device, stream);
}

bool shapes_ok(int h, int w, int cin, int cout, int wgs) {
  return h > 0 && w > 0 && cin > 0 && cout > 0 && cin % BK == 0 &&
         cout % BN == 0 && (wgs == 1 || wgs == 2);
}

Params make_params(int h, int w, int cin, int cout, int relu, int wgs,
                   int splits) {
  Params p = {};
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.tiles_x = (w + TILE_W - 1) / TILE_W;
  p.tiles = (h + WG_ROWS * wgs - 1) / (WG_ROWS * wgs) * p.tiles_x;
  p.splits = splits;
  p.units = p.tiles * splits * (cout / BN);
  p.chunks = cin / BK / splits;
  p.relu = relu;
  return p;
}

}  // namespace

extern "C" {

// The kernels' fixed geometry, for the wrapper to check against its own:
// tile width in pixels, map rows per consumer warpgroup, output channels
// per block, input channels per K chunk.
void kfnet_conv3x3_geometry(int* out) {
  out[0] = TILE_W;
  out[1] = WG_ROWS;
  out[2] = BN;
  out[3] = BK;
}

// conv3x3_same: one launch, or with splits > 1 (a divisor of cin / 64) the
// split conv into `partial` ((splits, h*w, cout) floats) and split_sum.
// Returns 0 on success, else a cudaError_t or a tensor-map error code.
// Device pointers; x, wk ((cout, 9*cin) bf16, K-major) and y 16-byte
// aligned; bias may be null.
int kfnet_conv3x3_same(const bf16* x, const bf16* wk, const float* bias,
                       void* y, float* partial, int h, int w, int cin,
                       int cout, int relu, int out_f32, int wgs, int splits,
                       int device, void* stream) {
  if (!shapes_ok(h, w, cin, cout, wgs) || splits < 1 ||
      (cin / BK) % splits != 0)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p = make_params(h, w, cin, cout, relu, wgs, splits);
  p.bias = bias;
  p.y = y;
  p.out_f32 = out_f32;
  p.partial = partial;
  int err = launch_wgs<false>(wgs, x, wk, p, device, (cudaStream_t)stream);
  if (err || splits == 1) return err;
  const int n4 = h * w * cout / 4;
  split_sum_kernel<<<(n4 + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, bias, y, h * w, cout, splits, relu, out_f32);
  return (int)cudaGetLastError();
}

// conv3x3_gn_chain: the conv with its per-tile sums into `partial`
// ((pixel tiles, 2, cout) floats), then moments_kernel.
int kfnet_conv3x3_gn_chain(const bf16* x, const float* scale,
                           const float* shift, const bf16* wk, bf16* y,
                           float* partial, float* s1, float* s2, int h, int w,
                           int cin, int cout, int prologue_relu, int wgs,
                           int device, void* stream) {
  if (!shapes_ok(h, w, cin, cout, wgs)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p = make_params(h, w, cin, cout, prologue_relu, wgs, 1);
  p.scale = scale;
  p.shift = shift;
  p.y = y;
  p.partial = partial;
  int err = launch_wgs<true>(wgs, x, wk, p, device, (cudaStream_t)stream);
  if (err) return err;
  moments_kernel<<<cout / 32, 32 * MOMENT_WARPS, 0, (cudaStream_t)stream>>>(
      partial, s1, s2, p.tiles, cout);
  return (int)cudaGetLastError();
}


const char* kfnet_conv3x3_error_string(int code) {
  if (code >= TENSOR_MAP_ERROR) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
