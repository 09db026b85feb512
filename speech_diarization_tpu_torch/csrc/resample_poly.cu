// K3: polyphase resampling for Hopper (sm_90a): scipy.signal.resample_poly
// with its default Kaiser filter (dsp/resample.py::_poly_filter) and zero
// extension at both ends, along the last axis of a contiguous float32
// [C, T], ceil(T * up / down) samples a row out, float32.
//
// Replaces no Pallas kernel.  Its JAX counterpart is
// speech_diarization_tpu/dsp/resample.py::resample_poly_jax, an XLA dilated
// convolution.  It was added because the demix-dialog front-end resampled
// 16 <-> 44.1 kHz with scipy on the host, between a copy of the wave off
// the card and a copy back, while the card waited: in a traced run of the
// htdemucs.babble benchmark cell the two steps were 21 % of the window.
//
// What bounds it on the H100: bytes.  Output m sums
//     x[j] * h[m*down + half - j*up]
// over the j whose tap falls inside the filter (L = 20*max(up, down) + 1
// taps, centre tap `half` on the first sample): ceil(L/up) taps or one
// fewer, 20-21 at 16 -> 44.1 kHz and 55-56 back.  A 120 s wave moves about
// 29 MB either way (9 us at 3.35 TB/s) and needs about 110 M float64 FMAs
// (7 us at the 33.5 TFLOP/s of float64 outside the tensor cores).  A
// zero-stuffed convolution multiplies all L taps at every output, up times
// the work, after writing a (T-1)*up + 1 stuffed copy of the wave.
//
// Each output is summed in float64 over its taps in order and rounded once
// to float32: scipy's arithmetic (float64 products and sums) in another
// order, so the two agree to a float32 rounding.  A float32 sum would not
// hold the demixed stem's 2e-5 limit.
//
// Design.
//  * Polyphase: no zero is stuffed, stored or read.  Output m's phase is
//    r = (m*down + half) % up and its newest input sample
//    jf = (m*down + half) / up; its taps are bank[r][i] = h[r + i*up]
//    against x[jf - i].  The host reorders the filter by phase into an
//    [up, n_taps] float64 bank, zero-padded to the longest phase, once per
//    (up, down, device).
//  * The phase depends on m % up alone.  A tile is a whole number of
//    periods of `up` outputs from a multiple of up; output m0 + q + k*up of
//    a tile has residue q and period k, and the outputs of one residue
//    share a bank row, their newest samples `down` apart.
//  * Shared memory holds the whole bank, staged once a block and laid out
//    by residue, not by phase (72-74 KB at 16 <-> 44.1 kHz: above the 48 KB
//    default, so the entry raises the block's dynamic shared memory limit),
//    and the tile's input span with zeros outside [0, T), so the zero
//    extension costs the sum no branch.  Blocks walk the (row, tile) pairs
//    with a grid stride, as many blocks as fit on the SMs at once, so the
//    bank is staged once a block and not once a tile.
//  * Upsampling (down < up; resample_up_kernel): thread q owns the K
//    outputs of residue q in a tile of K periods.  Each tap is read once
//    for K sums (K chains of FMAs in flight a thread); the lanes of a warp
//    read neighbouring bank rows at an odd row stride (no bank conflict) and
//    span samples at most one apart (broadcasts), so the span is staged in
//    float64: converted once a sample, not once a product.  For each k the
//    lanes store consecutive outputs: coalesced.
//  * Downsampling (resample_down_kernel): lanes that owned neighbouring
//    residues would read the span down/up samples apart, a 3-way bank
//    conflict at 44.1 -> 16 kHz.  Instead a tile is 32 periods, lane k owns
//    period k, and a warp walks residues: the lanes read one bank row (a
//    broadcast) and span samples `down` apart, on 32 distinct banks for an
//    odd down.  The span stays float32 (a float64 one would be 113 KB at
//    44.1 -> 16 kHz).  The lanes' outputs lie up apart, so the tile is
//    gathered in shared memory (row stride up + 1, conflict-free for an
//    even up) and stored in one coalesced pass.
//  * Each output is one float64 sum over its taps in order: the walk that
//    dsp/resample.py::_polyphase_walk repeats on the CPU.
#include <cuda_runtime.h>

namespace {

constexpr int K = 8;        // periods a tile upsampling (dsp/resample.py::K3_PERIODS)
constexpr int LANES = 32;   // periods a tile downsampling: one a lane (K3_LANES)
constexpr int UP_THREADS = 512;
constexpr int DOWN_THREADS = 1024;
constexpr size_t SMEM_LIMIT = 232448;

// the bank by residue: row q holds the phase of residue q's outputs
__device__ void stage_bank(double* bank_s, const double* __restrict__ bank,
                           int up, int down, int n_taps, int row, int half) {
  for (int e = threadIdx.x; e < up * n_taps; e += blockDim.x) {
    const int q = e / n_taps, i = e - q * n_taps;
    const int r = (int)(((long long)q * down + half) % up);
    bank_s[q * row + i] = bank[(size_t)r * n_taps + i];
  }
}

// residue q's newest sample in the staged span of its tile's first period
__device__ __forceinline__ int span_offset(int q, int up, int down, int half,
                                           int n_taps) {
  return (int)(((long long)q * down + half) / up) - half / up + n_taps - 1;
}

template <typename XT>
__device__ void stage_span(XT* xs, const float* __restrict__ xc, long long t,
                           long long j_lo, int span) {
  for (int s = threadIdx.x; s < span; s += blockDim.x) {
    const long long j = j_lo + s;
    xs[s] = (j >= 0 && j < t) ? (XT)__ldg(xc + j) : (XT)0;
  }
}

__global__ void __launch_bounds__(UP_THREADS)
resample_up_kernel(const float* __restrict__ x, long long t,
                   const double* __restrict__ bank, int up, int down,
                   int n_taps, int row, int half, float* __restrict__ out,
                   long long n_out, long long n_work, long long n_tiles,
                   int span) {
  extern __shared__ double smem[];
  double* bank_s = smem;                 // [up][row], by residue
  double* xs = smem + (size_t)up * row;  // [span]
  stage_bank(bank_s, bank, up, down, n_taps, row, half);
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const long long c = w / n_tiles, tile = w - c * n_tiles;
    const long long m0 = tile * K * up;
    __syncthreads();  // the bank is in; the previous tile's span is read
    stage_span(xs, x + c * t, t, tile * K * down + half / up - (n_taps - 1),
               span);
    __syncthreads();
    float* oc = out + c * n_out;
    for (int q = threadIdx.x; q < up; q += blockDim.x) {
      const double* b = bank_s + q * row;
      const double* xq = xs + span_offset(q, up, down, half, n_taps);
      double acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0;
#pragma unroll 4
      for (int i = 0; i < n_taps; ++i) {
        const double h = b[i];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fma(h, xq[k * down - i], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long m = m0 + q + (long long)k * up;
        if (m < n_out) oc[m] = (float)acc[k];
      }
    }
  }
}

__global__ void __launch_bounds__(DOWN_THREADS)
resample_down_kernel(const float* __restrict__ x, long long t,
                     const double* __restrict__ bank, int up, int down,
                     int n_taps, int half, float* __restrict__ out,
                     long long n_out, long long n_work, long long n_tiles,
                     int span) {
  extern __shared__ double smem[];
  double* bank_s = smem;                                            // [up][n_taps]
  float* xs = reinterpret_cast<float*>(smem + (size_t)up * n_taps);  // [span]
  float* os = xs + span;  // [LANES][up + 1]: the tile's outputs by lane
  stage_bank(bank_s, bank, up, down, n_taps, n_taps, half);
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const long long tile_out = (long long)LANES * up;
  for (long long w = blockIdx.x; w < n_work; w += gridDim.x) {
    const long long c = w / n_tiles, tile = w - c * n_tiles;
    const long long m0 = tile * tile_out;
    __syncthreads();  // the bank is in; the previous tile is stored
    stage_span(xs, x + c * t, t,
               tile * LANES * down + half / up - (n_taps - 1), span);
    __syncthreads();
    for (int q = threadIdx.x >> 5; q < up; q += n_warps) {
      const double* b = bank_s + q * n_taps;
      const float* xq = xs + span_offset(q, up, down, half, n_taps) + lane * down;
      double acc = 0.0;
#pragma unroll 8
      for (int i = 0; i < n_taps; ++i) acc = fma(b[i], (double)xq[-i], acc);
      os[lane * (up + 1) + q] = (float)acc;
    }
    __syncthreads();
    float* oc = out + c * n_out + m0;
    const int n = (int)(n_out - m0 < tile_out ? n_out - m0 : tile_out);
    for (int j = threadIdx.x; j < n; j += blockDim.x) oc[j] = os[j + j / up];
  }
}

// blocks: as many as fit on the SMs at once, at most one a (row, tile)
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, int threads, size_t smem, long long n_work,
                      int* blocks) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  const long long fill = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(n_work < fill ? n_work : fill);
  return err;
}

}  // namespace

// C entry point: launches on `stream`, does not synchronise, returns
// cudaGetLastError().  `x` is [n_ch, t] float32, contiguous; `bank` the
// [up, n_taps] float64 phase bank of dsp/resample.py::_poly_bank (bank[r][i]
// = h[r + i*up], zero past the filter); `half` the filter's centre tap; `out`
// [n_ch, n_out] float32 with n_out = ceil(t * up / down).  Requires up, down,
// n_taps, n_ch, t >= 1 (checked by the Python wrapper);
// cudaErrorInvalidValue when the bank and a tile's span do not fit shared
// memory (about 20 * max(up, down) * 8 bytes: up to ratios near 1,400).
extern "C" int sdt_resample_poly(const float* x, int n_ch, long long t,
                                 const double* bank, int up, int down,
                                 int n_taps, int half, float* out,
                                 long long n_out, void* stream) {
  if (n_ch < 1 || t < 1 || up < 1 || down < 1 || n_taps < 1 || n_out < 1)
    return (int)cudaErrorInvalidValue;
  // the newest samples of a tile's outputs run from half/up to `last`
  // (relative to the tile), and the span reaches n_taps - 1 below
  const int periods = down < up ? K : LANES;
  const long long last = (long long)(periods - 1) * down +
                         ((long long)(up - 1) * down + half) / up;
  const long long span = last - half / up + n_taps;
  const long long n_tiles = (n_out + (long long)periods * up - 1) /
                            ((long long)periods * up);
  const long long n_work = (long long)n_ch * n_tiles;
  int blocks = 0;
  cudaError_t err;
  if (down < up) {
    const int row = n_taps | 1;  // odd: neighbouring rows on other banks
    const size_t smem = sizeof(double) * ((size_t)up * row + span);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const int threads = up < UP_THREADS ? (up + 31) / 32 * 32 : UP_THREADS;
    err = grid_size(resample_up_kernel, threads, smem, n_work, &blocks);
    if (err != cudaSuccess) return (int)err;
    resample_up_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        x, t, bank, up, down, n_taps, row, half, out, n_out, n_work, n_tiles,
        (int)span);
  } else {
    const size_t smem = sizeof(double) * (size_t)up * n_taps +
                        sizeof(float) * (span + (size_t)LANES * (up + 1));
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    err = grid_size(resample_down_kernel, DOWN_THREADS, smem, n_work, &blocks);
    if (err != cudaSuccess) return (int)err;
    resample_down_kernel<<<blocks, DOWN_THREADS, smem, (cudaStream_t)stream>>>(
        x, t, bank, up, down, n_taps, half, out, n_out, n_work, n_tiles,
        (int)span);
  }
  return (int)cudaGetLastError();
}
