// The fused filter update for NVIDIA Hopper: the two heads' output steps,
// the flow clip, the bilinear warp and the chi^2-gated Kalman update of B
// maps in one launch.
//
// Replaces the Pallas TPU kernel kfnet_tpu/kernels/fused_filter.py::_kernel
// (reached through fused_warp_kalman -> _fused_call). What it computes, per
// pixel p of each (h, w) map:
//   * a bilinear warp of the previous state x (3 channels) and covariance P
//     by the backward flow. The sample uses the flow clipped to [-r, r],
//     with its corners clamped to the map; validity uses the flow before the
//     clip and holds iff p + flow lies in [0, w-1] x [0, h-1], inclusive.
//   * P- = warp(P) + W. Out of bounds: x- = 0 and P- = invalid_cov.
//   * S = P- + V, d = z - x-, consistent = |d|^2 / S <= threshold.
//   * consistent: x+ = x- + (P-/S) d and P+ = P- V / S. Otherwise x+ = z and
//     P+ = V.
// Two entries share that body:
//   * kfnet_fused_warp_kalman takes (flow, W, z, V) as the TPU kernel does;
//   * kfnet_fused_filter_step takes the raw float32 heads instead, OFlowNet's
//     (h, w, 3) and SCoordNet's (h, w, 4), and computes in registers what
//     the nets' output steps and the model compute around the TPU kernel:
//     flow = clip(r tanh(raw[0:2]), -r, r), W = exp(clamp(raw[2])) w_scale,
//     z = raw[0:3] coord_scale + offset, V = exp(clamp(raw[3])) coord_scale^2.
//     It writes flow, W, z and V beside x+, P+ and the mask.
// Both take (B, h, w, C) maps, B = 1 for one (h, w, C) map: the grid's last
// axis walks the maps, as the TPU kernel runs under vmap for B streams.
//
// Arithmetic. Every operation is float32 and in the order of the plain
// PyTorch versions (kernels/fused_filter.py: models/oflownet.py and
// models/scoordnet.py's output steps, core/warp.py, core/kalman.py), with
// libdevice's tanhf and expf (not __expf). Built with -fmad=false and
// without --use_fast_math, so no multiply and add fuse into one rounding.
//
// Bound. The heads-in entry moves 11 float32 in (raw heads 3 + 4, x 3, P 1)
// and 11 float32 plus 1 byte out (x+ 3, P+ 1, flow 2, W 1, z 3, V 1, mask)
// per pixel: 0.43 MB for one 60x80 map, 0.128 us at 3.35 TB/s. Its
// operations (about 130 a pixel, float32) take far less. So the work is a
// tenth of a microsecond and a kernel launch is several times that: what
// the design cuts is launches. This entry replaces the TPU kernel's launch
// and the eleven elementwise launches around it (the heads' output steps,
// W * w_scale, the flow clip), takes all B maps of a batch in one launch,
// and allocates nothing and never synchronises, so that the served filter
// step can be captured in a CUDA graph and replayed with one host call
// (eval/online.py).
//
// Design, for a latency-bound launch of a few thousand pixels:
//   * One thread a pixel, the four bilinear taps of x and P gathered
//     straight from device memory through the read-only cache: no padded
//     copy, no transposes.
//   * SCoordNet's (h, w, 4) head is read as one 16-byte load a pixel.
//   * Small blocks, so that a single 60x80 map spreads over the card's 132
//     SMs (4800 pixels: 38 blocks of 128 threads, 150 of 32).
//   * What the card showed (NVIDIA H100 80GB HBM3, 700 W; the heads-in
//     entry alone, 20 launches in a CUDA graph, timed by chip_smoke.py
//     phase "times" in four runs while the block size was still an
//     argument; PERF.md section 6), lowest-highest us over the runs:
//         block size (threads)   32         64         128        256
//         B = 1                  2.31-2.56  2.51-2.66  2.51-2.67  2.66-2.83
//         B = 4                  2.93-2.99  2.95-3.03  2.86-3.27  2.83-3.06
//     The spread is under 0.5 us, and 32 was the fastest or within 0.16 us
//     of it in every run, so the block size is fixed at 32 (THREADS):
//     about 20 times the bound at B = 1. A second form that first copied
//     each block's source window, the tile plus r before and r + 1 after it
//     on each axis, into shared memory (so that the taps' reads, whose
//     addresses come from the flow, need no second trip to memory) took
//     3.3-4.4 us at B = 1: the copy and the barrier cost more than the
//     gather they save, and it is not kept. Four maps cost 0.3-0.7 us more than one: the launch, not
//     the bytes, is the time, and a CUDA graph of the filter step
//     (eval/online.py) hides its host side.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // the block size (the note above)

struct Heads {        // the nets' output steps (kfnet_fused_filter_step)
  float w_scale;      // W = exp(clamp(raw, w_lo, w_hi)) * w_scale
  float w_lo, w_hi;
  float coord_scale;  // z = raw * coord_scale + off
  float off0, off1, off2;
  float coord_scale_sq;  // V = exp(clamp(raw, v_lo, v_hi)) * coord_scale_sq
  float v_lo, v_hi;
};

struct Maps {  // one launch's tensors; (B, h, w, C) float32, contiguous
  const float* x;      // (.., 3) previous state
  const float* P;      // (.., 1) previous covariance
  const float* flow;   // (.., 2) heads == false: the flow
  const float* Wn;     // (.., 1) heads == false: the process noise
  const float* z;      // (.., 3) heads == false: the measurement
  const float* V;      // (.., 1) heads == false: its noise
  const float* fhead;  // (.., 3) heads == true: OFlowNet's raw head
  const float* chead;  // (.., 4) heads == true: SCoordNet's, 16-byte aligned
  float* xo;           // (.., 3)
  float* Po;           // (.., 1)
  unsigned char* cons;  // (.., 1) bool
  float* flow_o;       // heads == true: (.., 2) flow, (.., 1) W, (.., 3) z,
  float* W_o;          //   (.., 1) V as computed
  float* z_o;
  float* V_o;
  int h, w, r;  // map size, flow clip bound (an integer radius)
  float threshold, invalid_cov;
  Heads hd;
};

// (x0, x1, x2, P) of pixel i of a previous map, through the read-only cache
__device__ __forceinline__ float4 tap(const float* x, const float* P, int i) {
  return make_float4(__ldg(x + 3 * i), __ldg(x + 3 * i + 1),
                     __ldg(x + 3 * i + 2), __ldg(P + i));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The pixel's inputs of the update: from the maps, or from the raw heads
// through the nets' output steps (written out as it goes).
template <bool HEADS>
__device__ __forceinline__ void pixel_inputs(const Maps& m, long p,
                                             float& fx_raw, float& fy_raw,
                                             float& Wn, float z[3],
                                             float& Vp) {
  if (HEADS) {
    const float r = (float)m.r;
    const float a = m.fhead[3 * p + 0], b = m.fhead[3 * p + 1];
    const float lw = m.fhead[3 * p + 2];
    const float4 c = __ldg(reinterpret_cast<const float4*>(m.chead) + p);
    // OFlowNet: r tanh(raw) then the model's clip; exp(clamp) * w_scale
    fx_raw = clampf(r * tanhf(a), -r, r);
    fy_raw = clampf(r * tanhf(b), -r, r);
    Wn = expf(clampf(lw, m.hd.w_lo, m.hd.w_hi)) * m.hd.w_scale;
    // SCoordNet: raw * coord_scale + offset; exp(clamp) * coord_scale^2
    z[0] = c.x * m.hd.coord_scale + m.hd.off0;
    z[1] = c.y * m.hd.coord_scale + m.hd.off1;
    z[2] = c.z * m.hd.coord_scale + m.hd.off2;
    Vp = expf(clampf(c.w, m.hd.v_lo, m.hd.v_hi)) * m.hd.coord_scale_sq;
    m.flow_o[2 * p + 0] = fx_raw;
    m.flow_o[2 * p + 1] = fy_raw;
    m.W_o[p] = Wn;
    m.z_o[3 * p + 0] = z[0];
    m.z_o[3 * p + 1] = z[1];
    m.z_o[3 * p + 2] = z[2];
    m.V_o[p] = Vp;
  } else {
    fx_raw = m.flow[2 * p + 0];
    fy_raw = m.flow[2 * p + 1];
    Wn = m.Wn[p];
    z[0] = m.z[3 * p + 0];
    z[1] = m.z[3 * p + 1];
    z[2] = m.z[3 * p + 2];
    Vp = m.V[p];
  }
}

// Warp and update of pixel p = (row, col) of its map, whose previous state
// and covariance are x (h, w, 3) and P (h, w, 1).
__device__ __forceinline__ void update(const Maps& m, long p, int row,
                                       int col, float fx_raw, float fy_raw,
                                       float Wn, const float z[3], float Vp,
                                       const float* x, const float* P) {
  const int h = m.h, w = m.w;
  const float radius = (float)m.r;
  const float fx = fminf(fmaxf(fx_raw, -radius), radius);
  const float fy = fminf(fmaxf(fy_raw, -radius), radius);

  // validity from the flow before the clip (core/warp.bilinear_sample)
  const float uf = (float)col + fx_raw;
  const float vf = (float)row + fy_raw;
  const bool valid = (uf >= 0.0f) && (uf <= (float)(w - 1)) &&
                     (vf >= 0.0f) && (vf <= (float)(h - 1));

  // sample at the clipped flow, corners clamped to the map
  const float u = (float)col + fx;
  const float v = (float)row + fy;
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  const float du = u - u0;
  const float dv = v - v0;
  const int x0 = min(max((int)u0, 0), w - 1);
  const int x1 = min(max(x0 + 1, 0), w - 1);
  const int y0 = min(max((int)v0, 0), h - 1);
  const int y1 = min(max(y0 + 1, 0), h - 1);
  const float4 c00 = tap(x, P, y0 * w + x0), c01 = tap(x, P, y0 * w + x1);
  const float4 c10 = tap(x, P, y1 * w + x0), c11 = tap(x, P, y1 * w + x1);

  const float w00 = (1.0f - du) * (1.0f - dv);
  const float w01 = du * (1.0f - dv);
  const float w10 = (1.0f - du) * dv;
  const float w11 = du * dv;

  float xp[3];
  xp[0] = w00 * c00.x + w01 * c01.x + w10 * c10.x + w11 * c11.x;
  xp[1] = w00 * c00.y + w01 * c01.y + w10 * c10.y + w11 * c11.y;
  xp[2] = w00 * c00.z + w01 * c01.z + w10 * c10.z + w11 * c11.z;
#pragma unroll
  for (int c = 0; c < 3; ++c) xp[c] = valid ? xp[c] : 0.0f;
  const float Ps = w00 * c00.w + w01 * c01.w + w10 * c10.w + w11 * c11.w;
  const float P_pr = valid ? Ps + Wn : m.invalid_cov;

  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = z[c] - xp[c];
  const float S = P_pr + Vp;
  const float maha = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) / S;
  const bool ok = maha <= m.threshold;
  const float K = P_pr / S;
#pragma unroll
  for (int c = 0; c < 3; ++c) m.xo[3 * p + c] = ok ? xp[c] + K * d[c] : z[c];
  m.Po[p] = ok ? (P_pr * Vp) / S : Vp;
  m.cons[p] = ok ? 1 : 0;
}

// One thread a pixel: THREADS pixels of map blockIdx.y a block.
template <bool HEADS>
__global__ void fused_filter_kernel(Maps m) {
  const int hw = m.h * m.w;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= hw) return;
  const long base = (long)blockIdx.y * hw;
  const long p = base + q;
  const int row = q / m.w;
  const int col = q - row * m.w;
  float fx_raw, fy_raw, Wn, z[3], Vp;
  pixel_inputs<HEADS>(m, p, fx_raw, fy_raw, Wn, z, Vp);
  update(m, p, row, col, fx_raw, fy_raw, Wn, z, Vp, m.x + 3 * base,
         m.P + base);
}

template <bool HEADS>
int launch(const Maps& m, int b, int device, cudaStream_t stream) {
  const int hw = m.h * m.w;
  if (hw <= 0 || b <= 0) return 0;
  if (m.r < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + THREADS - 1) / THREADS, b);
  fused_filter_kernel<HEADS><<<grid, THREADS, 0, stream>>>(m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entries launch on `stream`, allocate nothing, never synchronise, and
// return cudaGetLastError() (0 on success). Pointers are device pointers to
// contiguous float32 (b, h, w, C) maps; cons is a (b, h, w) byte map (a
// torch.bool tensor).

// The TPU kernel's contract: (x, P, flow, W, z, V) -> (x+, P+, consistent).
int kfnet_fused_warp_kalman(const float* x, const float* P, const float* flow,
                            const float* Wn, const float* z, const float* V,
                            float* xo, float* Po, unsigned char* cons, int b,
                            int h, int w, int radius, float threshold,
                            float invalid_cov, int device, void* stream) {
  Maps m = {};
  m.x = x;
  m.P = P;
  m.flow = flow;
  m.Wn = Wn;
  m.z = z;
  m.V = V;
  m.xo = xo;
  m.Po = Po;
  m.cons = cons;
  m.h = h;
  m.w = w;
  m.r = radius;
  m.threshold = threshold;
  m.invalid_cov = invalid_cov;
  return launch<false>(m, b, device, (cudaStream_t)stream);
}

// The raw heads in: fhead (b, h, w, 3) OFlowNet's, chead (b, h, w, 4)
// SCoordNet's (16-byte aligned); out: x+ (.., 3), P+ (.., 1), the mask,
// flow (.., 2), W (.., 1), z (.., 3), V (.., 1). `step` holds the output
// steps' constants: w_scale, W's log-variance clamp (lo, hi), coord_scale,
// the 3 coord offsets, coord_scale^2, V's log-variance clamp (lo, hi).
int kfnet_fused_filter_step(const float* fhead, const float* chead,
                            const float* x, const float* P, float* xo,
                            float* Po, unsigned char* cons, float* flow_o,
                            float* W_o, float* z_o, float* V_o, int b, int h,
                            int w, int radius, const float* step,
                            float threshold, float invalid_cov, int device,
                            void* stream) {
  Maps m = {};
  m.x = x;
  m.P = P;
  m.fhead = fhead;
  m.chead = chead;
  m.xo = xo;
  m.Po = Po;
  m.cons = cons;
  m.flow_o = flow_o;
  m.W_o = W_o;
  m.z_o = z_o;
  m.V_o = V_o;
  m.h = h;
  m.w = w;
  m.r = radius;
  m.threshold = threshold;
  m.invalid_cov = invalid_cov;
  m.hd = {step[0], step[1], step[2], step[3], step[4],
          step[5], step[6], step[7], step[8], step[9]};
  return launch<true>(m, b, device, (cudaStream_t)stream);
}

const char* kfnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
