// Fused warp + Kalman update, one thread per pixel, for NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel kfnet_tpu/kernels/fused_filter.py::_kernel
// (reached through fused_warp_kalman). What it computes, per pixel p of the
// (h, w) map:
//   * a bilinear warp of the previous state x (3 channels) and covariance P
//     by the backward flow. The sample uses the flow clipped to [-r, r],
//     with its corners clamped to the map; validity uses the raw flow and
//     holds iff p + flow lies in [0, w-1] x [0, h-1], inclusive.
//   * P- = warp(P) + W. Out of bounds: x- = 0 and P- = invalid_cov.
//   * S = P- + V, d = z - x-, consistent = |d|^2 / S <= threshold.
//   * consistent: x+ = x- + (P-/S) d and P+ = P- V / S. Otherwise x+ = z and
//     P+ = V.
//
// Design. The TPU has no gather, so the Pallas body sums (2r+2)^2 shifted
// reads weighted by selectors. Hopper gathers, so this kernel reads the four
// bilinear taps directly from the (h, w, C) layout as it lies in memory: no
// transposes, no padded copy. Every operation is float32 and in the order of
// core/warp.py then core/kalman.py; built with -fmad=false and without
// --use_fast_math, the kernel matches the plain PyTorch version bit for bit.
//
// Bound. At the main path's 60x80 map it moves 11 float32 in and 4 float32
// plus 1 byte out per pixel, 0.29 MB: 0.09 us at 3.35 TB/s. Its time on the
// card is therefore one kernel launch, a few us. Fusing it with its
// neighbours, or capturing the step in a CUDA graph, is what would move it.

#include <cuda_runtime.h>

namespace {

__global__ void fused_warp_kalman_kernel(
    const float* __restrict__ x, const float* __restrict__ P,
    const float* __restrict__ flow, const float* __restrict__ Wn,
    const float* __restrict__ z, const float* __restrict__ V,
    float* __restrict__ xo, float* __restrict__ Po,
    unsigned char* __restrict__ cons, int h, int w, float radius,
    float threshold, float invalid_cov) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h * w) return;
  const int row = p / w;
  const int col = p - row * w;

  const float fx_raw = flow[2 * p + 0];
  const float fy_raw = flow[2 * p + 1];
  const float fx = fminf(fmaxf(fx_raw, -radius), radius);
  const float fy = fminf(fmaxf(fy_raw, -radius), radius);

  // validity from the raw flow (matches core/warp.bilinear_sample)
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
  const int i00 = y0 * w + x0, i01 = y0 * w + x1;
  const int i10 = y1 * w + x0, i11 = y1 * w + x1;

  const float w00 = (1.0f - du) * (1.0f - dv);
  const float w01 = du * (1.0f - dv);
  const float w10 = (1.0f - du) * dv;
  const float w11 = du * dv;

  float xp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = w00 * x[3 * i00 + c] + w01 * x[3 * i01 + c] +
                    w10 * x[3 * i10 + c] + w11 * x[3 * i11 + c];
    xp[c] = valid ? s : 0.0f;
  }
  const float Ps = w00 * P[i00] + w01 * P[i01] + w10 * P[i10] + w11 * P[i11];
  const float P_pr = valid ? Ps + Wn[p] : invalid_cov;

  const float Vp = V[p];
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = z[3 * p + c] - xp[c];
  const float S = P_pr + Vp;
  const float maha = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) / S;
  const bool ok = maha <= threshold;
  const float K = P_pr / S;
#pragma unroll
  for (int c = 0; c < 3; ++c) xo[3 * p + c] = ok ? xp[c] + K * d[c] : z[3 * p + c];
  Po[p] = ok ? (P_pr * Vp) / S : Vp;
  cons[p] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers to contiguous float32 (h, w, C) maps; cons is
// a (h, w) byte map (a torch.bool tensor).
int kfnet_fused_warp_kalman(const float* x, const float* P, const float* flow,
                            const float* Wn, const float* z, const float* V,
                            float* xo, float* Po, unsigned char* cons, int h,
                            int w, float radius, float threshold,
                            float invalid_cov, int device, void* stream) {
  const int n = h * w;
  if (n <= 0) return 0;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  fused_warp_kalman_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, P, flow, Wn, z, V, xo, Po, cons, h, w, radius, threshold,
      invalid_cov);
  return (int)cudaGetLastError();
}

const char* kfnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
