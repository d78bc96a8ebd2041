// The served pose solve after its draws, for NVIDIA Hopper: PnP-RANSAC's
// hypotheses, their scores, the pick and the Levenberg-Marquardt polish of
// T frames in three launches.
//
// Replaces no Pallas kernel. The JAX package's solve
// (kfnet_tpu/pose/ransac.py, pnp.py, p3p.py) is plain JAX, which XLA fuses
// under jit and vmap into a few kernels. The port has no such fusion: its
// plain composition (kernels/ransac.py, the *_reference functions) is about
// 2150 one-op kernels a solve, on 3x3, 6x6 and 12x12 matrices and short
// vectors, which a CUDA graph replays at about 1.9 us a node (4.1 ms a
// frame for the DLT at B = 1, 5.1 ms at B = 4, 8.5 ms for ESAC's P3P over
// 19 maps a frame). These kernels do the same work in three launches:
//   * ransac_hypothesize: one thread a hypothesis (t, m). It gathers its
//     draw's points from its pool (frame t's, or map map_of[t, m] of the
//     stack) and solves the minimal problem in registers: the 6-point DLT
//     (Hartley normalisation, the 12x12 normal matrix, a shifted Cholesky,
//     8 rounds of inverse iteration, de-normalisation, the sign vote, the
//     det flip and 8 polar Newton steps) or Grunert's P3P (the quartic by
//     40 Durand-Kerner iterations in complex float32, then 4 candidates).
//   * ransac_score: one block a hypothesis. Its threads walk the pool's k
//     points once and score each of the hypothesis' c candidates (1 or 4):
//     reprojection error, the clamp at 1e6, the behind-camera rule, the
//     weighted inlier sum.
//   * ransac_refine: one block a frame. The first maximum of the frame's
//     M c scores (torch.argmax's rule), then 10 LM iterations on the
//     winner's pool with the winner's inliers as weights: [J'WJ | J'Wr] and
//     the cost in one pass over the points, a 6x6 LU solve with partial
//     pivoting, the SE(3) update, the accept rule (lambda x 0.5 or x 4).
//     Then the final errors and inliers, and T_wc, num_inliers,
//     inlier_ratio and mean_inlier_error_px.
// The draws (the top-k and the Exp(1) keys) stay in PyTorch: these kernels
// draw nothing.
//
// Bound. The work is small: for ESAC's 1024 hypotheses of 4 candidates
// against 4800 points, about 20 M point evaluations (0.6 GFLOP, 9 us at the
// float32 rate), and a frame's pools are under 100 KB. What bounds a solve
// on this card is its serial depth: the minimal solvers' dependent chains
// (one thread each), and the LM's 10 iterations, each a pass over the
// points, a block-wide reduction of 28 sums and a 6x6 solve on one thread,
// one after the other; plus three launches. The design keeps every
// intermediate in registers or shared memory, runs every hypothesis at
// once (one warp solves 32), gives the scoring all of the card's SMs (one
// block a hypothesis), and folds each LM iteration's cost of the trial
// pose and its normal equations into one pass (a rejected step keeps the
// normal equations it had, which are those the plain version recomputes).
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase
// "ransac", device time of 20 launches in a CUDA graph, ms a launch; the
// plain composition of the same stage as one CUDA graph beside it):
//     shape                 hypothesize     score           pick_and_refine
//     DLT, T = 1, k 2048    0.057 (1.14)    0.006 (0.097)   0.068 (2.21)
//     DLT, T = 4, k 2048    0.058 (1.31)    0.012 (0.32)    0.073 (2.74)
//     P3P, T = 4, 76 maps   0.063 (1.32)    0.074 (3.09)    0.110 (4.56)
// The three together 0.132 / 0.138 / 0.246 ms against 3.85 / 4.20 / 9.08
// ms. The serial kernels are the longest: the DLT's one thread a draw and
// the LM's ten iterations, which wait on each other. ptxas: 48-127
// registers a thread, no spills; the DLT's 12x12 matrix lives in a
// 784-byte stack frame (local memory, in L1).
//
// Arithmetic. float32 throughout, every operation in the order of the plain
// PyTorch versions (pose/pnp.py, pose/p3p.py, core/geometry.py), with the
// same constants, clamps, iteration counts and NaN rules (torch.clamp and
// torch.where keep a NaN, torch.sign(NaN) is 0, argmax takes the first
// maximum), and rounded as the plain version's own CUDA kernels round on
// this card, read from probes there: cuBLAS's short products as chains of
// fused multiply-adds (dot3f, matvec3, the 12x12 normal matrix),
// cuSOLVER's Cholesky and cuBLAS's triangular solves, PyTorch's complex
// product and division and its cross product (one fused multiply-add
// each), its sums of up to 16 floats (tree16), its division by a number
// (a multiplication by the reciprocal). Built with -fmad=false, so nothing
// else fuses. So the candidates and their scores equal the plain
// version's bit for bit: a float32 minimal solver turns any other rounding
// into another pose on a poorly conditioned draw, and RANSAC's pick among
// near-ties follows it. The LM's sums over the points and its 6x6 solve
// round in their own fixed order, so the refined pose agrees with the
// plain one to float32 rounding. No sum uses atomics: a launch gives the
// same bits every time.
//
// Libraries. The probes ran under torch 2.11.0+cu128 (CUDA 12.8) with
// cuBLAS 12.9.2 and cuSOLVER 11.7.3 (chip_smoke.py's RANSAC_PROBED; its
// environment line prints the versions loaded). The rounding copied above
// is theirs, not a rule of the arithmetic: another torch, cuBLAS or
// cuSOLVER may round otherwise, and then the bit-equality checks
// (chip_smoke.py phase "ransac", tests/test_torch_ransac_cuda.py) and
// nonorm-fleet4's pose_mismatch can fail with no change here. Where the
// versions differ, probe the plain version's rounding again before
// suspecting the kernels.

#include <cuda_runtime.h>

namespace {

constexpr int HYP_THREADS = 32;      // one thread a hypothesis
constexpr int SCORE_THREADS = 256;   // one block a hypothesis
constexpr int REFINE_THREADS = 512;  // one block a frame
constexpr int MAX_CANDIDATES = 4;    // P3P's; the DLT gives 1
constexpr int MAX_DLT_POINTS = 16;   // a DLT draw: 6 to 16 points
constexpr int CAND = 12;             // a candidate: R (3x3, row-major), t
constexpr int NSUM = 28;             // an LM pass: J'WJ (21), J'Wr (6), cost

enum Solver { DLT = 0, P3P = 1 };

struct Pools {  // the pools of points the hypotheses read
  const float* uv;          // (E, k, 2), or one (k, 2) grid (uv_shared)
  const float* X;           // (E, k, 3)
  const float* w;           // (E, k)
  const long long* map_of;  // (T, M): the pool of hypothesis (t, m); null:
                            //   hypothesis (t, m) reads pool t
  const float* K;           // (3, 3)
  int T, M, k, maps, uv_shared;
};

__device__ __forceinline__ int pool_of(const Pools& p, int t, int m) {
  if (p.map_of == nullptr) return t;
  const long long e = p.map_of[(long long)t * p.M + m];
  if (e < 0 || e >= p.maps) __trap();  // as PyTorch's index check
  return (int)e;
}

__device__ __forceinline__ const float* uv_of(const Pools& p, int e) {
  return p.uv + (p.uv_shared ? 0ll : (long long)e * p.k * 2);
}

__device__ __forceinline__ const float* X_of(const Pools& p, int e) {
  return p.X + (long long)e * p.k * 3;
}

__device__ __forceinline__ const float* w_of(const Pools& p, int e) {
  return p.w + (long long)e * p.k;
}

// torch.clamp_min and clamp_max: a NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// A product of (.., 3) by (3, ..) as cuBLAS computes it on this card: fused
// multiply-adds in the order of the sum (seen on the card for the plain
// version's (.., 3) @ (3, 3) and batched (3, 3) @ (3, 3) products)
__device__ __forceinline__ float dot3f(float a0, float b0, float a1, float b1,
                                       float a2, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// A (3, 3) @ (3, 1) product as cuBLAS computes it on this card (its
// matrix-vector order, seen on the card)
__device__ __forceinline__ float matvec3(float a0, float b0, float a1,
                                         float b1, float a2, float b2) {
  return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

// torch.sum over a last axis of n <= 16 floats on this card: x_i in lane i,
// then a shuffle-down tree (offsets 8, 4, 2, 1; seen on the card for the
// sums and norms of 3, 6 and 12). For three: (x0 + x2) + x1.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}
__device__ __forceinline__ float tree16(const float* x, int n) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < n ? x[i] : 0.0f;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < off; ++i) v[i] = v[i] + v[i + off];
  return v[0];
}

// torch.sum(a * b, -1): the products, then sum3
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// torch.linalg.vector_norm over a last axis of three
__device__ __forceinline__ float norm3(const float* a) {
  return sqrtf(sum3(a[0] * a[0], a[1] * a[1], a[2] * a[2]));
}

// A tensor over a Python number on the card: PyTorch multiplies by the
// number's reciprocal; a number over a tensor: the tensor's reciprocal times
// the number
__device__ __forceinline__ float div_scalar(float x, float c) {
  return x * (1.0f / c);
}
__device__ __forceinline__ float rdiv(float c, float x) {
  return (1.0f / x) * c;
}

// torch.sign: 0 for 0 and NaN
__device__ __forceinline__ float sgn(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

// ----------------------------------------------------------------------
// 3x3 helpers (core/geometry.py)

__device__ __forceinline__ float det3(const float* M) {
  return M[0] * (M[4] * M[8] - M[5] * M[7]) +
         M[1] * (M[5] * M[6] - M[3] * M[8]) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

// _inv3: the adjugate over the determinant, |det| < 1e-20 clamped
__device__ void inv3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h;
  const float B = f * g - d * i;
  const float C = d * h - e * g;
  float det = a * A + b * B + c * C;
  if (fabsf(det) < 1e-20f) det = sgn(det) * 1e-20f + 1e-30f;
  out[0] = A / det;
  out[1] = (c * h - b * i) / det;
  out[2] = (b * f - c * e) / det;
  out[3] = B / det;
  out[4] = (a * i - c * g) / det;
  out[5] = (c * d - a * f) / det;
  out[6] = C / det;
  out[7] = (b * g - a * h) / det;
  out[8] = (a * e - b * d) / det;
}

// orthonormalize_rotation: flip the last column where det < 0, then
// polar_rotation's 8 determinant-scaled Newton steps X <- (gX + (gX)^-T)/2
__device__ void orthonormalize(float* M) {
  const float flip = det3(M) < 0.0f ? -1.0f : 1.0f;
  M[2] *= flip;
  M[5] *= flip;
  M[8] *= flip;
  for (int it = 0; it < 8; ++it) {
    float g = powf(fabsf(det3(M)), (float)(-1.0 / 3.0));
    if (!isfinite(g)) g = 1.0f;
    g = clamp_max(clamp_min(g, 1e-4f), 1e4f);
    float Xs[9], inv[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) Xs[j] = M[j] * g;
    inv3(Xs, inv);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        M[3 * r + c] = 0.5f * (Xs[3 * r + c] + inv[3 * c + r]);
  }
}

// ----------------------------------------------------------------------
// The 6-point DLT (pose/pnp.dlt_pnp with unit weights)

// Hartley normalisation of n points of D coordinates in place (_normalize_2d
// and _normalize_3d with unit weights): returns the scale, sets the mean.
// The mean sums over the points axis as torch.sum(dim=-2) does on this card
// (four accumulators over consecutive points, then ((a0 + a1) + a2) + a3).
template <int D>
__device__ float normalize(float (*x)[D], int n, float* mean, float root) {
  const float wsum = clamp_min((float)n, 1e-8f);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < n; ++i)
      acc[i & 3] = i < 4 ? x[i][j] * 1.0f : acc[i & 3] + x[i][j] * 1.0f;
    mean[j] = (((acc[0] + acc[1]) + acc[2]) + acc[3]) / wsum;
  }
  float dist[MAX_DLT_POINTS];
  for (int i = 0; i < n; ++i) {
    float d[3];
#pragma unroll
    for (int j = 0; j < D; ++j) d[j] = x[i][j] - mean[j];
    const float q = D == 3 ? sum3(d[0] * d[0], d[1] * d[1], d[2] * d[2])
                           : d[0] * d[0] + d[1] * d[1];
    dist[i] = sqrtf(q) * 1.0f;
  }
  const float dsum = tree16(dist, n);
  const float scale = rdiv(root, clamp_min(dsum / wsum, 1e-8f));
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) x[i][j] = (x[i][j] - mean[j]) * scale;
  return scale;
}

// _smallest_eigvec_12: one Cholesky of M + eps I, then 8 rounds of two
// triangular solves and a normalisation, each rounded as cuSOLVER's
// Cholesky (fused multiply-adds in order, the column scaled by the
// pivot's reciprocal) and cuBLAS's triangular solves (fused multiply-adds,
// the forward one in ascending order, the backward one in descending
// order, then a division) round on this card. M is symmetric.
__device__ void smallest_eigvec_12(float (*M)[12], float* v) {
  float diag[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) diag[i] = M[i][i];
  const float eps = div_scalar(1e-7f * tree16(diag, 12), 12.0f) + 1e-30f;
#pragma unroll
  for (int i = 0; i < 12; ++i) M[i][i] = M[i][i] + eps * 1.0f;
  // Cholesky in place, the lower triangle of M becoming L. As cuSOLVER, a
  // pivot that is not positive does not stop it: its NaN runs on, and the
  // degenerate draw's candidate is NaN, which scores no inlier
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    float s = M[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = fmaf(-M[j][q], M[j][q], s);
    const float d = sqrtf(s);
    const float inv = 1.0f / d;
    M[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 12; ++i) {
      float r = M[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) r = fmaf(-M[i][q], M[j][q], r);
      M[i][j] = r * inv;
    }
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) v[i] = (float)(1.0 / 3.4641016151377544);
  for (int it = 0; it < 8; ++it) {
    float y[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {  // L y = v
      float r = v[i];
#pragma unroll
      for (int q = 0; q < i; ++q) r = fmaf(-M[i][q], y[q], r);
      y[i] = r / M[i][i];
    }
#pragma unroll
    for (int i = 11; i >= 0; --i) {  // L' v = y
      float r = y[i];
#pragma unroll
      for (int q = 11; q > i; --q) r = fmaf(-M[q][i], v[q], r);
      v[i] = r / M[i][i];
    }
    float sq[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) sq[i] = v[i] * v[i];
    const float nrm = clamp_min(sqrtf(tree16(sq, 12)), 1e-30f);
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = v[i] / nrm;
  }
}

__device__ void dlt(const float (*uv)[2], const float (*X)[3], int n,
                    const float* Kinv, float* out) {
  float xn[MAX_DLT_POINTS][2], Xn[MAX_DLT_POINTS][3];
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      xn[i][r] = dot3f(uv[i][0], Kinv[3 * r], uv[i][1], Kinv[3 * r + 1], 1.0f,
                       Kinv[3 * r + 2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) Xn[i][j] = X[i][j];
  }
  float m2[2], m3[3];
  const float s2 = normalize<2>(xn, n, m2, (float)1.4142135623730951);
  const float s3 = normalize<3>(Xn, n, m3, (float)1.7320508075688772);
  // M = A'A over the 2n rows [Xh, 0, -x Xh] (n of them), then [0, Xh, -y Xh]
  float M[12][12];
#pragma unroll
  for (int a = 0; a < 12; ++a)
#pragma unroll
    for (int b = 0; b < 12; ++b) M[a][b] = 0.0f;
  for (int r = 0; r < 2 * n; ++r) {
    const int i = r < n ? r : r - n;
    const int half = r < n ? 0 : 1;
    const float Xh[4] = {Xn[i][0], Xn[i][1], Xn[i][2], 1.0f};
    const float nx = -xn[i][half];
    float row[12];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      row[j] = half == 0 ? Xh[j] : 0.0f;
      row[4 + j] = half == 0 ? 0.0f : Xh[j];
      row[8 + j] = nx * Xh[j];
    }
#pragma unroll
    for (int a = 0; a < 12; ++a)
#pragma unroll
      for (int b = a; b < 12; ++b) M[a][b] = fmaf(row[a], row[b], M[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 12; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b) M[a][b] = M[b][a];
  float p[12];
  smallest_eigvec_12(M, p);
  // P = T2^-1 [p as 3x4] T3
  const float T2[9] = {s2, 0.0f, -m2[0] * s2, 0.0f, s2, -m2[1] * s2,
                       0.0f, 0.0f, 1.0f};
  float iT2[9];
  inv3(T2, iT2);
  float Q[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      Q[r][c] = dot3f(iT2[3 * r], p[c], iT2[3 * r + 1], p[4 + c],
                      iT2[3 * r + 2], p[8 + c]);
  float T3[4][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) T3[r][c] = c == r ? s3 : 0.0f;
    T3[r][3] = -m3[r] * s3;
  }
  T3[3][0] = T3[3][1] = T3[3][2] = 0.0f;
  T3[3][3] = 1.0f;
  float P[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      P[r][c] = fmaf(Q[r][3], T3[3][c],
                     dot3f(Q[r][0], T3[0][c], Q[r][1], T3[1][c], Q[r][2],
                           T3[2][c]));
  const float sc = clamp_min(norm3(P[2]), 1e-12f);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) P[r][c] = P[r][c] / sc;
  // the sign that puts the points in front of the camera
  float vote = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float z = matvec3(X[i][0], P[2][0], X[i][1], P[2][1], X[i][2],
                            P[2][2]) + P[2][3];
    vote += sgn(z) * 1.0f;
  }
  const float sign = vote >= 0.0f ? 1.0f : -1.0f;
  float R[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[3 * r + c] = P[r][c] * sign;
    out[9 + r] = P[r][3] * sign;
  }
  orthonormalize(R);
#pragma unroll
  for (int j = 0; j < 9; ++j) out[j] = R[j];
}

// ----------------------------------------------------------------------
// Grunert's P3P (pose/p3p.p3p_grunert)

struct cfloat {  // c10::complex<float>'s arithmetic
  float re, im;
};

__device__ __forceinline__ cfloat cadd(cfloat a, cfloat b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ cfloat csub(cfloat a, cfloat b) {
  return {a.re - b.re, a.im - b.im};
}
// c10::complex's product and numpy's division as PyTorch's CUDA kernels
// compute them: the compiler fuses one multiply and add of each pair (its
// choice, seen on the card)
__device__ __forceinline__ cfloat cmul(cfloat a, cfloat b) {
  return {fmaf(a.re, b.re, -(a.im * b.im)), fmaf(a.re, b.im, a.im * b.re)};
}
__device__ __forceinline__ cfloat cdiv(cfloat x, cfloat y) {
  const float a = x.re, b = x.im, c = y.re, d = y.im;
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) return {a / abs_c, b / abs_d};
    const float rat = d / c;
    const float scl = 1.0f / fmaf(d, rat, c);
    return {fmaf(b, rat, a) * scl, fmaf(-a, rat, b) * scl};
  }
  const float rat = c / d;
  const float scl = 1.0f / fmaf(c, rat, d);
  return {fmaf(a, rat, b) * scl, fmaf(b, rat, -a) * scl};
}

// torch.linalg.cross as its CUDA kernel computes it (one fused multiply-add)
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = fmaf(a[1], b[2], -(a[2] * b[1]));
  o[1] = fmaf(a[2], b[0], -(a[0] * b[2]));
  o[2] = fmaf(a[0], b[1], -(a[1] * b[0]));
}

__device__ __forceinline__ void unit3(float* a) {
  const float n = clamp_min(norm3(a), 1e-12f);
  a[0] = a[0] / n;
  a[1] = a[1] / n;
  a[2] = a[2] / n;
}

// _triad: columns u1 (along P1 - P0), u3 x u1, u3 (the normal); B row-major
__device__ void triad(const float (*P)[3], float* B) {
  float a[3], b[3], u1[3], u2[3], u3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j] = P[1][j] - P[0][j];
    b[j] = P[2][j] - P[0][j];
    u1[j] = a[j];
  }
  unit3(u1);
  cross3(a, b, u3);
  unit3(u3);
  cross3(u3, u1, u2);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    B[3 * r] = u1[r];
    B[3 * r + 1] = u2[r];
    B[3 * r + 2] = u3[r];
  }
}

__device__ void p3p(const float (*uv)[2], const float (*X)[3],
                    const float* Kinv, float* out /* 4 candidates */) {
  float f[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      f[i][r] = dot3f(uv[i][0], Kinv[3 * r], uv[i][1], Kinv[3 * r + 1], 1.0f,
                      Kinv[3 * r + 2]);
    const float n = norm3(f[i]);
#pragma unroll
    for (int r = 0; r < 3; ++r) f[i][r] = f[i][r] / n;
  }
  float d12[3], d02[3], d01[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d12[j] = X[1][j] - X[2][j];
    d02[j] = X[0][j] - X[2][j];
    d01[j] = X[0][j] - X[1][j];
  }
  const float a2 = dot3(d12, d12), b2 = dot3(d02, d02), c2 = dot3(d01, d01);
  const float ca = dot3(f[1], f[2]);  // cos alpha (rays 2, 3)
  const float cb = dot3(f[0], f[2]);  // cos beta (rays 1, 3)
  const float cg = dot3(f[0], f[1]);  // cos gamma (rays 1, 2)
  const float b2s = fabsf(b2) < 1e-12f ? 1e-12f : b2;
  const float q1 = (a2 - c2) / b2s;
  const float q2 = (a2 + c2) / b2s;
  const float ca2 = ca * ca, cb2 = cb * cb, cg2 = cg * cg;
  float A[5];
  A[0] = (q1 - 1.0f) * (q1 - 1.0f) - 4.0f * (c2 / b2s) * ca2;
  A[1] = 4.0f * (q1 * (1.0f - q1) * cb - (1.0f - q2) * ca * cg +
                 2.0f * (c2 / b2s) * ca2 * cb);
  A[2] = 2.0f * (q1 * q1 - 1.0f + 2.0f * (q1 * q1) * cb2 +
                 2.0f * ((b2 - c2) / b2s) * ca2 - 4.0f * q2 * ca * cb * cg +
                 2.0f * ((b2 - a2) / b2s) * cg2);
  A[3] = 4.0f * (-q1 * (1.0f + q1) * cb + 2.0f * (a2 / b2s) * cg2 * cb -
                 (1.0f - q2) * ca * cg);
  A[4] = (1.0f + q1) * (1.0f + q1) - 4.0f * (a2 / b2s) * cg2;
  // durand_kerner_quartic: monic coefficients, 40 iterations from the
  // powers 1..4 of 0.4 + 0.9i
  const float safe = fabsf(A[0]) < 1e-12f ? 1e-12f : A[0];
  cfloat c[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) c[i] = {A[i] / safe, 0.0f};
  // torch.polar(|b|^k, arg(b) k) on the card, b = 0.4 + 0.9i, k = 1..4
  cfloat z[4] = {{0.3999999761581421f, 0.8999999761581421f},
                 {-0.6500000953674316f, 0.7199999690055847f},
                 {-0.9079999327659607f, -0.2969999611377716f},
                 {-0.09589984267950058f, -0.9359999299049377f}};
  for (int it = 0; it < 40; ++it) {
    cfloat nz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cfloat denom = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cfloat d = csub(z[i], z[j]);
        d = cadd(d, cfloat{i == j ? 1.0f : 0.0f, 0.0f});
        denom = j == 0 ? d : cmul(denom, d);
      }
      cfloat poly = cadd(z[i], c[1]);
      poly = cadd(cmul(poly, z[i]), c[2]);
      poly = cadd(cmul(poly, z[i]), c[3]);
      poly = cadd(cmul(poly, z[i]), c[4]);
      nz[i] = csub(z[i], cdiv(poly, denom));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i] = nz[i];
  }
  for (int i = 0; i < 4; ++i) {
    const float v = z[i].re;
    bool bad = (fabsf(z[i].im) > 1e-3f) || (v <= 1e-6f);
    float du = 2.0f * (cg - v * ca);
    du = fabsf(du) < 1e-9f ? 1e-9f : du;
    const float u =
        ((-1.0f + q1) * (v * v) - 2.0f * q1 * cb * v + 1.0f + q1) / du;
    const float den = 1.0f + v * v - 2.0f * v * cb;
    const float s1 = sqrtf(clamp_min(b2 / clamp_min(den, 1e-9f), 1e-12f));
    const float s2 = u * s1;
    const float s3 = v * s1;
    bad = bad || (s2 <= 1e-6f) || (s3 <= 1e-6f);
    const float s[3] = {bad ? 1.0f : s1, bad ? 1.0f : s2, bad ? 1.0f : s3};
    float Pc[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int r = 0; r < 3; ++r) Pc[j][r] = f[j][r] * s[j];
    // _kabsch_w2c: R = B_c B_w', t = mean(Pc) - R mean(X)
    float Bc[9], Bw[9];
    triad(Pc, Bc);
    triad(X, Bw);
    float* o = out + CAND * i;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        o[3 * r + cc] = dot3f(Bc[3 * r], Bw[3 * cc], Bc[3 * r + 1],
                              Bw[3 * cc + 1], Bc[3 * r + 2], Bw[3 * cc + 2]);
    // torch.mean on the card: the sum times 1/3 (MeanOps' factor)
    const float third = 1.0f / 3.0f;
    float mc[3], mw[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      mc[j] = (Pc[0][j] + Pc[1][j] + Pc[2][j]) * third;
      mw[j] = (X[0][j] + X[1][j] + X[2][j]) * third;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
      o[9 + r] = mc[r] - matvec3(o[3 * r], mw[0], o[3 * r + 1], mw[1],
                                 o[3 * r + 2], mw[2]);
  }
}

// ----------------------------------------------------------------------
// Reprojection (pose/pnp.project_w2c, reprojection_errors)

struct Intrinsics {
  float fx, cx, fy, cy;
};

__device__ __forceinline__ Intrinsics intrinsics(const float* K) {
  return {K[0], K[2], K[4], K[5]};
}

// the camera-frame point: X @ R' (a cuBLAS product), then + t
__device__ __forceinline__ void to_camera(const float* Rt, const float* X,
                                          float* pc) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    pc[r] = dot3f(X[0], Rt[3 * r], X[1], Rt[3 * r + 1], X[2], Rt[3 * r + 2]) +
            Rt[9 + r];
}

// reprojection_errors: the pixel error, 1e6 behind the camera, clamped at
// 1e6 (a NaN stays NaN, as torch.clamp_max keeps it)
__device__ __forceinline__ float reprojection_error(const float* Rt,
                                                    const Intrinsics& K,
                                                    const float* X,
                                                    const float* uv) {
  float pc[3];
  to_camera(Rt, X, pc);
  const float z = pc[2];
  const float zs = fabsf(z) < 1e-8f ? 1e-8f : z;
  const float u = K.fx * pc[0] / zs + K.cx;
  const float v = K.fy * pc[1] / zs + K.cy;
  const float du = u - uv[0], dv = v - uv[1];
  float err = sqrtf(du * du + dv * dv);
  err = z > 1e-6f ? err : 1e6f;
  return clamp_max(err, 1e6f);
}

// the inlier weight: (err < threshold) w
__device__ __forceinline__ float inlier(float err, float threshold, float w) {
  return (err < threshold ? 1.0f : 0.0f) * w;
}

// ----------------------------------------------------------------------
// Block-wide sums in a fixed order: a butterfly inside each warp (every
// lane ends with the same value), then warp 0..W-1's partials in order.

template <int N, int THREADS>
__device__ void block_sums(float (&v)[N], float* scratch /* N x warps */,
                           float* out /* N */) {
  constexpr int WARPS = THREADS / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) scratch[j * WARPS + warp] = v[j];
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += scratch[threadIdx.x * WARPS + q];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// ----------------------------------------------------------------------
// Kernel 1: hypotheses, one thread each

template <int SOLVER>
__global__ void __launch_bounds__(HYP_THREADS)
    ransac_hypothesize(Pools p, const long long* idx, int s, float* cands) {
  const long long h = (long long)blockIdx.x * HYP_THREADS + threadIdx.x;
  if (h >= (long long)p.T * p.M) return;
  const int t = (int)(h / p.M), m = (int)(h % p.M);
  const int e = pool_of(p, t, m);
  const float* uvp = uv_of(p, e);
  const float* Xp = X_of(p, e);
  float uv[MAX_DLT_POINTS][2], X[MAX_DLT_POINTS][3];
  for (int j = 0; j < s; ++j) {
    const long long i = idx[h * s + j];
    if (i < 0 || i >= p.k) __trap();
    uv[j][0] = uvp[2 * i];
    uv[j][1] = uvp[2 * i + 1];
    X[j][0] = Xp[3 * i];
    X[j][1] = Xp[3 * i + 1];
    X[j][2] = Xp[3 * i + 2];
  }
  float Kinv[9];
  inv3(p.K, Kinv);
  if (SOLVER == P3P) {
    float out[4 * CAND];
    p3p(uv, X, Kinv, out);
#pragma unroll
    for (int j = 0; j < 4 * CAND; ++j) cands[h * 4 * CAND + j] = out[j];
  } else {
    float out[CAND];
    dlt(uv, X, s, Kinv, out);
#pragma unroll
    for (int j = 0; j < CAND; ++j) cands[h * CAND + j] = out[j];
  }
}

// ----------------------------------------------------------------------
// Kernel 2: scores, one block a hypothesis

template <int C>
__global__ void __launch_bounds__(SCORE_THREADS)
    ransac_score(Pools p, const float* cands, float threshold,
                 float* score) {
  __shared__ float cand[C * CAND];
  __shared__ float scratch[C * (SCORE_THREADS / 32)];
  __shared__ float sums[C];
  const long long h = blockIdx.x;  // t M + m
  const int t = (int)(h / p.M), m = (int)(h % p.M);
  const int e = pool_of(p, t, m);
  if (threadIdx.x < C * CAND)
    cand[threadIdx.x] = cands[h * C * CAND + threadIdx.x];
  __syncthreads();
  const Intrinsics K = intrinsics(p.K);
  const float* uv = uv_of(p, e);
  const float* X = X_of(p, e);
  const float* w = w_of(p, e);
  float acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.0f;
  for (int i = threadIdx.x; i < p.k; i += SCORE_THREADS) {
    const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
    const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
    const float wi = w[i];
#pragma unroll
    for (int j = 0; j < C; ++j)
      acc[j] += inlier(reprojection_error(cand + CAND * j, K, Xi, uvi),
                       threshold, wi);
  }
  block_sums<C, SCORE_THREADS>(acc, scratch, sums);
  if (threadIdx.x < C) score[h * C + threadIdx.x] = sums[threadIdx.x];
}

// ----------------------------------------------------------------------
// Kernel 3: the pick and the LM polish, one block a frame

// whether score a (index ia) goes before score b as torch.argmax ranks them:
// the larger, a NaN above all, the first of equals
__device__ __forceinline__ bool ranks_first(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

// refine_pnp_lm's residual (z clamped at 1e-6) of one point
__device__ __forceinline__ void residual(const float* Rt, const Intrinsics& K,
                                         const float* X, const float* uv,
                                         float* pc, float& z, float* r) {
  to_camera(Rt, X, pc);
  z = clamp_min(pc[2], 1e-6f);
  r[0] = K.fx * pc[0] / z + K.cx - uv[0];
  r[1] = K.fy * pc[1] / z + K.cy - uv[1];
}

// One LM pass over the block's share of the pool at the pose Rt: the
// weighted cost, and with JAC its [J'WJ | J'Wr] (upper triangle by rows,
// then J'Wr). The weights are the winner's inliers (R0t0) times w.
template <bool JAC>
__device__ void lm_pass(const Pools& p, const float* uv, const float* X,
                        const float* w, const float* R0t0, float threshold,
                        const Intrinsics& K, const float* Rt,
                        float (&acc)[NSUM]) {
#pragma unroll
  for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
  for (int i = threadIdx.x; i < p.k; i += REFINE_THREADS) {
    const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
    const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
    const float wt =
        inlier(reprojection_error(R0t0, K, Xi, uvi), threshold, w[i]);
    float pc[3], z, r[2];
    residual(Rt, K, Xi, uvi, pc, z, r);
    acc[NSUM - 1] += wt * (r[0] * r[0] + r[1] * r[1]);
    if (!JAC) continue;
    const float zinv = 1.0f / z;
    // Jp = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]; Jw = -Jp hat(pc)
    const float Jp[2][3] = {{K.fx * zinv, 0.0f, -K.fx * pc[0] * zinv * zinv},
                            {0.0f, K.fy * zinv, -K.fy * pc[1] * zinv * zinv}};
    const float hat[3][3] = {{0.0f, -pc[2], pc[1]},
                             {pc[2], 0.0f, -pc[0]},
                             {-pc[1], pc[0], 0.0f}};
    float J[2][7];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        J[row][c] = dot3f(-Jp[row][0], hat[0][c], -Jp[row][1], hat[1][c],
                          -Jp[row][2], hat[2][c]);
        J[row][3 + c] = Jp[row][c];
      }
      J[row][6] = r[row];
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      float wJ[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) wJ[c] = wt * J[row][c];
      int q = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[q++] += J[row][a] * wJ[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += J[row][a] * wJ[6];
    }
  }
}

// torch.linalg.solve_ex of the 6x6 system H x = b: LU with partial pivoting
__device__ void solve6(float (*H)[6], float* b, float* x) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(H[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(H[r][c]) > best) {
        best = fabsf(H[r][c]);
        piv = r;
      }
    if (piv != c) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float tmp = H[c][j];
        H[c][j] = H[piv][j];
        H[piv][j] = tmp;
      }
      const float tmp = b[c];
      b[c] = b[piv];
      b[piv] = tmp;
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float l = H[r][c] / H[c][c];
#pragma unroll
      for (int j = c + 1; j < 6; ++j) H[r][j] -= l * H[c][j];
      b[r] -= l * b[c];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= H[i][j] * x[j];
    x[i] = s / H[i][i];
  }
}

// _se3_apply: (R, t) <- (dR R, dR t + dt), dR = axis_angle_to_matrix(dw)
__device__ void se3_apply(const float* d, const float* Rt, float* out) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float theta2 = sum3(w0 * w0, w1 * w1, w2 * w2);
  const float theta = sqrtf(theta2 + 1e-24f);
  const bool small = theta2 < 1e-12f;
  const float a = small ? 1.0f - div_scalar(theta2, 6.0f) : sinf(theta) / theta;
  const float b =
      small ? 0.5f - div_scalar(theta2, 24.0f) : (1.0f - cosf(theta)) / theta2;
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float dR[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float WW = dot3f(W[3 * r], W[c], W[3 * r + 1], W[3 + c],
                             W[3 * r + 2], W[6 + c]);
      dR[3 * r + c] = (r == c ? 1.0f : 0.0f) + a * W[3 * r + c] + b * WW;
    }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = dot3f(dR[3 * r], Rt[c], dR[3 * r + 1], Rt[3 + c],
                             dR[3 * r + 2], Rt[6 + c]);
    out[9 + r] = matvec3(dR[3 * r], Rt[9], dR[3 * r + 1], Rt[10],
                         dR[3 * r + 2], Rt[11]) + d[3 + r];
  }
}

struct Refine {  // the pick-and-refine launch's settings and outputs
  const float* cands;  // (T, M C, 12)
  const float* score;  // (T, M C)
  float inlier_threshold, refine_threshold, damping;
  int iters;
  float* T_wc;         // (T, 4, 4)
  float* num_inliers;  // (T,)
  float* inlier_ratio;
  float* mean_error;
};

template <int C>
__global__ void __launch_bounds__(REFINE_THREADS)
    ransac_refine(Pools p, Refine q) {
  constexpr int WARPS = REFINE_THREADS / 32;
  __shared__ float scratch[NSUM * WARPS];
  __shared__ float sums[NSUM];
  __shared__ float pick_v[WARPS];
  __shared__ int pick_i[WARPS];
  __shared__ float R0t0[CAND], cur[CAND], trial[CAND];
  __shared__ int winner;
  const int t = blockIdx.x;
  const int n = p.M * C;

  // the first maximum of the frame's scores
  const float* sc = q.score + (long long)t * n;
  float bv = 0.0f;
  int bi = -1;
  for (int i = threadIdx.x; i < n; i += REFINE_THREADS)
    if (bi < 0 || ranks_first(sc[i], i, bv, bi)) {
      bv = sc[i];
      bi = i;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (oi >= 0 && (bi < 0 || ranks_first(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    pick_v[threadIdx.x >> 5] = bv;
    pick_i[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = pick_v[0];
    int b = pick_i[0];
    for (int wi = 1; wi < WARPS; ++wi)
      if (pick_i[wi] >= 0 &&
          (b < 0 || ranks_first(pick_v[wi], pick_i[wi], v, b))) {
        v = pick_v[wi];
        b = pick_i[wi];
      }
    winner = b;
  }
  __syncthreads();
  const int best = winner;
  if (threadIdx.x < CAND) {
    R0t0[threadIdx.x] = q.cands[((long long)t * n + best) * CAND + threadIdx.x];
    cur[threadIdx.x] = R0t0[threadIdx.x];
  }
  const int e = pool_of(p, t, best / C);  // the winner's pool
  const float* uv = uv_of(p, e);
  const float* X = X_of(p, e);
  const float* w = w_of(p, e);
  const Intrinsics K = intrinsics(p.K);
  __syncthreads();

  // LM: the cost and normal equations at the start, then each iteration's
  // trial pose; a rejected trial keeps the pose and its normal equations
  float acc[NSUM];
  float G[NSUM];  // thread 0's: the accepted pose's sums
  float cost = 0.0f, lam = q.damping;
  lm_pass<true>(p, uv, X, w, R0t0, q.inlier_threshold, K, cur, acc);
  block_sums<NSUM, REFINE_THREADS>(acc, scratch, sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < NSUM; ++j) G[j] = sums[j];
    cost = G[NSUM - 1];
  }
  for (int it = 0; it < q.iters; ++it) {
    if (threadIdx.x == 0) {
      float H[6][6], g[6], x[6];
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) {
          H[a][b] = G[k];
          H[b][a] = G[k];
          ++k;
        }
      float tr = 0.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) tr += H[a][a];
      const float damp = lam * clamp_min(div_scalar(tr, 6.0f), 1e-8f);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b)
          H[a][b] = H[a][b] + damp * (a == b ? 1.0f : 0.0f);
        g[a] = G[21 + a];
      }
      solve6(H, g, x);
#pragma unroll
      for (int a = 0; a < 6; ++a) x[a] = -x[a];
      se3_apply(x, cur, trial);
    }
    __syncthreads();
    if (it + 1 < q.iters)
      lm_pass<true>(p, uv, X, w, R0t0, q.inlier_threshold, K, trial, acc);
    else
      lm_pass<false>(p, uv, X, w, R0t0, q.inlier_threshold, K, trial, acc);
    block_sums<NSUM, REFINE_THREADS>(acc, scratch, sums);
    if (threadIdx.x == 0) {
      const float c_new = sums[NSUM - 1];
      const bool improved = c_new < cost;
      if (improved) {
#pragma unroll
        for (int j = 0; j < NSUM; ++j) G[j] = sums[j];
#pragma unroll
        for (int j = 0; j < CAND; ++j) cur[j] = trial[j];
        cost = c_new;
      }
      lam = improved ? lam * 0.5f : lam * 4.0f;
    }
    __syncthreads();
  }

  // the final errors and inliers at the polished pose
  float fin[3] = {0.0f, 0.0f, 0.0f};  // inliers, their error, the weights
  for (int i = threadIdx.x; i < p.k; i += REFINE_THREADS) {
    const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
    const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
    const float err = reprojection_error(cur, K, Xi, uvi);
    const float in = inlier(err, q.refine_threshold, w[i]);
    fin[0] += in;
    fin[1] += err * in;
    fin[2] += w[i];
  }
  block_sums<3, REFINE_THREADS>(fin, scratch, sums);
  if (threadIdx.x == 0) {
    const float n_in = sums[0];
    q.num_inliers[t] = n_in;
    q.inlier_ratio[t] = n_in / clamp_min(sums[2], 1.0f);
    q.mean_error[t] = sums[1] / clamp_min(n_in, 1.0f);
    // invert_pose(make_pose(R, t)): [R' | -R' t]
    float* T = q.T_wc + (long long)t * 16;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) T[4 * r + c] = cur[3 * c + r];
      T[4 * r + 3] = -matvec3(cur[r], cur[9], cur[3 + r], cur[10],
                              cur[6 + r], cur[11]);
    }
    T[12] = 0.0f;
    T[13] = 0.0f;
    T[14] = 0.0f;
    T[15] = 1.0f;
  }
}

int prepare(int device) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching on its stream
  return (int)cudaSetDevice(device);
}

Pools pools(const float* uv, const float* X, const float* w,
            const long long* map_of, const float* K, int T, int M, int k,
            int maps, int uv_shared) {
  Pools p;
  p.uv = uv;
  p.X = X;
  p.w = w;
  p.map_of = map_of;
  p.K = K;
  p.T = T;
  p.M = M;
  p.k = k;
  p.maps = maps;
  p.uv_shared = uv_shared;
  return p;
}

bool bad_sizes(int T, int M, int k, int maps) {
  return T <= 0 || M <= 0 || k <= 0 || maps <= 0 ||
         (long long)T * M > 0x7fffffffll / MAX_CANDIDATES;
}

}  // namespace

extern "C" {

// Every entry launches on `stream`, allocates nothing, never synchronises,
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for sizes it does not take. Pointers are device pointers to contiguous
// tensors: uv (maps, k, 2) float32, or one (k, 2) grid where uv_shared; X
// (maps, k, 3); w (maps, k); map_of (T, M) int64 or null (then maps == T
// and hypothesis (t, m) reads pool t); K (3, 3); idx (T, M, s) int64.
// solver: 0 the DLT (one candidate a draw, 6 <= s <= 16), 1 P3P (four, s
// == 3). cands (T, M c, 12): each candidate's R (row-major) and t.

int kfnet_ransac_hypothesize(const float* uv, const float* X,
                             const long long* map_of, const float* K,
                             const long long* idx, float* cands, int T,
                             int M, int s, int k, int maps, int uv_shared,
                             int solver, int device, void* stream) {
  if (bad_sizes(T, M, k, maps)) return (int)cudaErrorInvalidValue;
  if (solver == P3P ? s != 3 : (solver != DLT || s < 6 || s > MAX_DLT_POINTS))
    return (int)cudaErrorInvalidValue;
  const int err = prepare(device);
  if (err != 0) return err;
  const Pools p = pools(uv, X, nullptr, map_of, K, T, M, k, maps, uv_shared);
  const long long n = (long long)T * M;
  const dim3 grid((unsigned)((n + HYP_THREADS - 1) / HYP_THREADS));
  cudaStream_t st = (cudaStream_t)stream;
  if (solver == P3P)
    ransac_hypothesize<P3P><<<grid, HYP_THREADS, 0, st>>>(p, idx, s, cands);
  else
    ransac_hypothesize<DLT><<<grid, HYP_THREADS, 0, st>>>(p, idx, s, cands);
  return (int)cudaGetLastError();
}

// score (T, M c): each candidate's inlier weight, sum over the pool of
// (error < threshold) w
int kfnet_ransac_score(const float* uv, const float* X, const float* w,
                       const long long* map_of, const float* K,
                       const float* cands, float* score, int T, int M, int c,
                       int k, int maps, int uv_shared, float threshold,
                       int device, void* stream) {
  if (bad_sizes(T, M, k, maps) || (c != 1 && c != 4))
    return (int)cudaErrorInvalidValue;
  const int err = prepare(device);
  if (err != 0) return err;
  const Pools p = pools(uv, X, w, map_of, K, T, M, k, maps, uv_shared);
  const dim3 grid((unsigned)((long long)T * M));
  cudaStream_t st = (cudaStream_t)stream;
  if (c == 4)
    ransac_score<4><<<grid, SCORE_THREADS, 0, st>>>(p, cands, threshold, score);
  else
    ransac_score<1><<<grid, SCORE_THREADS, 0, st>>>(p, cands, threshold, score);
  return (int)cudaGetLastError();
}

// The pick and the LM polish of each frame; outputs T_wc (T, 4, 4)
// camera-to-world, num_inliers, inlier_ratio, mean_error (T,) each.
int kfnet_ransac_refine(const float* uv, const float* X, const float* w,
                        const long long* map_of, const float* K,
                        const float* cands, const float* score, float* T_wc,
                        float* num_inliers, float* inlier_ratio,
                        float* mean_error, int T, int M, int c, int k,
                        int maps, int uv_shared, float inlier_threshold,
                        int iters, float refine_threshold, float damping,
                        int device, void* stream) {
  if (bad_sizes(T, M, k, maps) || (c != 1 && c != 4) || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int err = prepare(device);
  if (err != 0) return err;
  const Pools p = pools(uv, X, w, map_of, K, T, M, k, maps, uv_shared);
  Refine q;
  q.cands = cands;
  q.score = score;
  q.inlier_threshold = inlier_threshold;
  q.refine_threshold = refine_threshold;
  q.damping = damping;
  q.iters = iters;
  q.T_wc = T_wc;
  q.num_inliers = num_inliers;
  q.inlier_ratio = inlier_ratio;
  q.mean_error = mean_error;
  cudaStream_t st = (cudaStream_t)stream;
  if (c == 4)
    ransac_refine<4><<<T, REFINE_THREADS, 0, st>>>(p, q);
  else
    ransac_refine<1><<<T, REFINE_THREADS, 0, st>>>(p, q);
  return (int)cudaGetLastError();
}

const char* kfnet_ransac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
