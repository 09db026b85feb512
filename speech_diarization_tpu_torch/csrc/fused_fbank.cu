// Fused log-mel filterbank for Hopper (sm_90a): reflect pad + Hann-windowed
// DFT + power + mel product + log in one kernel; only [n_frames, n_mels] is
// written to device memory.
//
// Replaces: speech_diarization_tpu/ops/pallas/fused_fbank.py::fused_log_mel
// (Pallas kernel _fbank_kernel).
//
// What bounds it on the H100: the main-path call (one 60 s chunk with its
// margins, 1,118,400 samples -> 6,991 frames of 40 mels) moves 4.5 MB of
// waveform in and 1.1 MB of features out (1.7 us at 3.35 TB/s) but does
// 2.37 GFLOP, almost all in the 400-tap x 201-bin windowed DFT.  In float32
// on the CUDA cores (67 TFLOP/s) that is 35 us, so the work is bound by
// operations, not bytes; on bf16 tensor cores it would be ~2.4 us, which is
// why a later version may move the DFT to wgmma.
//
// Design: one block per tile of 32 frames.  The tile's waveform
// (32*hop + n_fft - hop samples, 21 KB) is staged once in shared memory,
// reflect-padded on the fly, so the [N, 400] frame tensor never exists.
// One thread per DFT bin keeps the tile's 32 real and 32 imaginary sums in
// registers and walks the 400 taps four at a time: per step it reads four
// cos and four sin basis values (coalesced across the bins, L1/L2-resident:
// the two bases are 640 KB together, too large for shared memory) and one
// float4 of samples per frame (a shared-memory broadcast), then issues 256
// FMAs.  The power spectrum goes to shared memory; the mel product and the
// log run in the same block.  Everything accumulates in float32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;      // frames per block
constexpr int THREADS = 256;  // >= n_bins (201 on the main path)

__global__ void __launch_bounds__(THREADS)
fused_log_mel_kernel(const float* __restrict__ y, int t,
                     const float* __restrict__ cosw,   // [n_fft, n_bins]
                     const float* __restrict__ sinw,   // [n_fft, n_bins]
                     const float* __restrict__ mel,    // [n_bins, n_mels]
                     int n_fft, int hop, int n_bins, int n_mels, float eps,
                     float* __restrict__ out,          // [n_frames, n_mels]
                     int n_frames) {
  extern __shared__ __align__(16) float smem[];
  const int span = TILE * hop + (n_fft - hop);
  const int span4 = (span + 3) & ~3;
  float* ys = smem;             // [span4] reflect-padded samples of the tile
  float* pw = smem + span4;     // [TILE, n_bins] power spectrum
  const int f0 = blockIdx.x * TILE;
  const int pad = n_fft / 2;

  // padded index p = f0*hop + i holds sample g = p - pad, reflected at both
  // ends (numpy/torch 'reflect': the edge sample is not repeated)
  for (int i = threadIdx.x; i < span4; i += blockDim.x) {
    long long g = (long long)f0 * hop + i - pad;
    float v = 0.f;
    if (i < span) {
      if (g < 0) g = -g;
      if (g >= t) g = 2LL * (t - 1) - g;
      if (g >= 0 && g < t) v = y[g];
    }
    ys[i] = v;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < n_bins) {
    float re[TILE], im[TILE];
#pragma unroll
    for (int f = 0; f < TILE; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int s = 0; s < n_fft; s += 4) {
      const float c0 = __ldg(cosw + (s + 0) * n_bins + k);
      const float c1 = __ldg(cosw + (s + 1) * n_bins + k);
      const float c2 = __ldg(cosw + (s + 2) * n_bins + k);
      const float c3 = __ldg(cosw + (s + 3) * n_bins + k);
      const float s0 = __ldg(sinw + (s + 0) * n_bins + k);
      const float s1 = __ldg(sinw + (s + 1) * n_bins + k);
      const float s2 = __ldg(sinw + (s + 2) * n_bins + k);
      const float s3 = __ldg(sinw + (s + 3) * n_bins + k);
#pragma unroll
      for (int f = 0; f < TILE; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(ys + f * hop + s);
        float r = re[f], m = im[f];
        r = fmaf(v.x, c0, r);
        m = fmaf(v.x, s0, m);
        r = fmaf(v.y, c1, r);
        m = fmaf(v.y, s1, m);
        r = fmaf(v.z, c2, r);
        m = fmaf(v.z, s2, m);
        r = fmaf(v.w, c3, r);
        m = fmaf(v.w, s3, m);
        re[f] = r;
        im[f] = m;
      }
    }
#pragma unroll
    for (int f = 0; f < TILE; ++f)
      pw[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TILE * n_mels; idx += blockDim.x) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    if (f0 + f >= n_frames) continue;
    float acc = 0.f;
    for (int b = 0; b < n_bins; ++b)
      acc = fmaf(pw[f * n_bins + b], __ldg(mel + b * n_mels + m), acc);
    out[(long long)(f0 + f) * n_mels + m] = logf(acc + eps);
  }
}

}  // namespace

// C entry point: launches on `stream`, does not synchronise, returns
// cudaGetLastError().  Requires n_fft % 4 == 0, hop % 4 == 0,
// n_bins <= 256 and t > n_fft / 2 (checked by the Python wrapper).
extern "C" int sdt_fused_log_mel(const float* y, int t, const float* cosw,
                                 const float* sinw, const float* mel,
                                 int n_fft, int hop, int n_bins, int n_mels,
                                 float eps, float* out, int n_frames,
                                 void* stream) {
  const int span = TILE * hop + (n_fft - hop);
  const int span4 = (span + 3) & ~3;
  const size_t smem = (size_t)(span4 + TILE * n_bins) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + TILE - 1) / TILE;
  fused_log_mel_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      y, t, cosw, sinw, mel, n_fft, hop, n_bins, n_mels, eps, out, n_frames);
  return (int)cudaGetLastError();
}
