// Sliding-grid attentive-statistics pooling for Hopper (sm_90a).
//
// Replaces: speech_diarization_tpu/ops/pallas/asp_grid.py::asp_grid_stats
// (Pallas kernel _asp_kernel).
//
// Per grid window j (rows s = j*hop_f .. s+win_f of the trunk features):
//   h = x[s+r] @ w1x^T + bw[j];  a = tanh(relu(h) * s_bn + t_bn)
//   e = bf16(a) @ w2^T + b2;     p = softmax over the window's rows
//   mu = sum p x;  sd = sqrt(max(sum p x^2 - mu^2, 1e-12))
// with bf16 matmul operands and float32 accumulation, as the Pallas kernel.
//
// What bounds it on the H100: one 60 s chunk (W=600 windows of win_f=201
// rows, CC=768 channels, A=64) needs 11.9 GFLOP of logits, 0.7 GFLOP of
// pre-projection and ~0.9 GFLOP of softmax/statistics elementwise work,
// against 10.7 MB of bf16 features read once (L2-resident on the 50 MB L2)
// and 3.7 MB of stats written: bound by operations.  On bf16 tensor cores
// the logits would take ~13 us; this first version runs them as float32
// FMAs on the CUDA cores (67 TFLOP/s roof: ~0.18 ms for the logits alone).
// wgmma/TMA come in a later version.
//
// Design.  The TPU kernel held a whole block span (~272 rows x 768 channels)
// plus [span, 768] float32 logits per window in VMEM; a Hopper block has
// 227 KB of shared memory, so the work is tiled over channels instead: the
// softmax and the statistics are per channel, and only the pre-projection
// contracts over channels.
//  * Phase 1 (asp_preproj_kernel): hx = x @ w1x^T, [n_rows, A] float32,
//    computed ONCE for every row the grid touches (the TPU recomputed it per
//    window block).  A 64x64x32 shared-memory tiled product.
//  * Phase 2 (asp_window_kernel): one block per (window, 128-channel tile).
//    The block stages the window's a rows (201 x 64 float32, 51 KB) in
//    shared memory, rounded to bf16 like the Pallas operand.  Each thread
//    owns one channel: its 64 w2 weights live in registers, it walks the
//    window's rows once with an online softmax (running max, sum, sum p*x,
//    sum p*x^2), reading a[r] as shared-memory broadcasts and x[r, c] from
//    global memory (a warp reads 64 contiguous bytes per row).  Nothing of
//    size [W, CC, win_f] ever reaches device memory; the only outputs are
//    the [W, 2*CC] stats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 256;
constexpr int A_DIM = 64;           // attention width of the shipped encoders
constexpr int WIN_THREADS = 128;    // channels per phase-2 block

__global__ void __launch_bounds__(GEMM_THREADS)
asp_preproj_kernel(const __nv_bfloat16* __restrict__ x_t,   // [n_rows, cc]
                   int cc,
                   const __nv_bfloat16* __restrict__ w1x,   // [a_dim, cc]
                   int a_dim, int n_rows,
                   float* __restrict__ hx) {                // [n_rows, a_dim]
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cc; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gr = row0 + m, gk = k0 + k;
      xs[k][m] = (gr < n_rows && gk < cc)
                     ? __bfloat162float(x_t[(size_t)gr * cc + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int n = idx / BK, k = idx % BK;
      const int ga = col0 + n, gk = k0 + k;
      ws[k][n] = (ga < a_dim && gk < cc)
                     ? __bfloat162float(w1x[(size_t)ga * cc + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = col0 + tx * 4 + j;
      if (r < n_rows && a < a_dim) hx[(size_t)r * a_dim + a] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(WIN_THREADS)
asp_window_kernel(const __nv_bfloat16* __restrict__ x_t,   // [n_rows, cc]
                  int cc,
                  const float* __restrict__ hx,            // [n_rows, A]
                  const float* __restrict__ bw,            // [W, A]
                  const float* __restrict__ s_bn,          // [A]
                  const float* __restrict__ t_bn,          // [A]
                  const __nv_bfloat16* __restrict__ w2,    // [cc, A]
                  const float* __restrict__ b2,            // [cc]
                  int hop_f, int win_f,
                  float* __restrict__ out) {               // [W, 2*cc]
  extern __shared__ __align__(16) float a_s[];              // [win_f, A]
  const int j = blockIdx.x;
  const int c = blockIdx.y * WIN_THREADS + threadIdx.x;
  const int r0 = j * hop_f;

  for (int idx = threadIdx.x; idx < win_f * A_DIM; idx += WIN_THREADS) {
    const int r = idx / A_DIM, a = idx % A_DIM;
    const float h = hx[(size_t)(r0 + r) * A_DIM + a] + bw[(size_t)j * A_DIM + a];
    const float v = tanhf(fmaxf(h, 0.f) * s_bn[a] + t_bn[a]);
    a_s[idx] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();
  if (c >= cc) return;

  float w[A_DIM];
#pragma unroll
  for (int a = 0; a < A_DIM; ++a) w[a] = __bfloat162float(w2[(size_t)c * A_DIM + a]);
  const float bias = b2[c];
  float m = -INFINITY, z = 0.f, s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < win_f; ++r) {
    const float4* ar = reinterpret_cast<const float4*>(a_s + r * A_DIM);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < A_DIM / 4; ++q) {
      const float4 v = ar[q];
      acc = fmaf(v.x, w[4 * q + 0], acc);
      acc = fmaf(v.y, w[4 * q + 1], acc);
      acc = fmaf(v.z, w[4 * q + 2], acc);
      acc = fmaf(v.w, w[4 * q + 3], acc);
    }
    const float e = acc + bias;
    const float x = __bfloat162float(x_t[(size_t)(r0 + r) * cc + c]);
    const float mn = fmaxf(m, e);
    const float sc = expf(m - mn);  // 0 on the first row (m = -inf)
    const float p = expf(e - mn);
    z = fmaf(z, sc, p);
    s1 = fmaf(s1, sc, p * x);
    s2 = fmaf(s2, sc, p * x * x);
    m = mn;
  }
  const float mu = s1 / z;
  const float m2 = s2 / z;
  out[(size_t)j * 2 * cc + c] = mu;
  out[(size_t)j * 2 * cc + cc + c] = sqrtf(fmaxf(m2 - mu * mu, 1e-12f));
}

}  // namespace

// C entry point: two launches on `stream`, no synchronisation; returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported a_dim).
// x_t starts at the grid's first row; hx is caller-allocated scratch
// [n_rows, a_dim] float32 with n_rows = (n_windows-1)*hop_f + win_f.
extern "C" int sdt_asp_grid_stats(const void* x_t, int cc, const float* bw,
                                  const void* w1x, const float* s_bn,
                                  const float* t_bn, const void* w2,
                                  const float* b2, int a_dim, int hop_f,
                                  int win_f, int n_windows, int n_rows,
                                  float* hx, float* out, void* stream) {
  if (a_dim != A_DIM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x_t);
  dim3 g1((n_rows + BM - 1) / BM, (a_dim + BN - 1) / BN);
  asp_preproj_kernel<<<g1, GEMM_THREADS, 0, st>>>(
      xb, cc, static_cast<const __nv_bfloat16*>(w1x), a_dim, n_rows, hx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)win_f * A_DIM * sizeof(float);
  err = cudaFuncSetAttribute(asp_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g2(n_windows, (cc + WIN_THREADS - 1) / WIN_THREADS);
  asp_window_kernel<<<g2, WIN_THREADS, smem, st>>>(
      xb, cc, hx, bw, s_bn, t_bn, static_cast<const __nv_bfloat16*>(w2), b2,
      hop_f, win_f, out);
  return (int)cudaGetLastError();
}
