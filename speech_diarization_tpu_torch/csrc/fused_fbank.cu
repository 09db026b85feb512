// Fused log-mel filterbank for Hopper (sm_90a): reflect pad + Hann-windowed
// DFT + power + mel product + log in one kernel; only [n_frames, n_mels] is
// written to device memory.
//
// Replaces: speech_diarization_tpu/ops/pallas/fused_fbank.py::fused_log_mel
// (Pallas kernel _fbank_kernel).
//
// What bounds it on the H100: the main-path call (one 60 s chunk with its
// margins, 1,118,400 samples -> 6,991 frames of 40 mels) moves 4.5 MB of
// waveform in and 1.1 MB of features out but contracts every frame's 400
// taps against 201 cos and 201 sin bins: bound by operations, not bytes.
// The result feeds a log, and a quiet mel band sees the rounding error of
// the loud bins, so the products need float32 accuracy: one TF32 or bf16
// pass does not hold the 1e-4 tolerance (tests/test_torch_dsp.py shows it).
//
// Design.
//  * Half the work, exactly.  The periodic Hann window and the cosine basis
//    are symmetric about tap n_fft/2 and the sine basis is antisymmetric,
//    and the window is 0 at tap 0.  Each frame is folded once in shared
//    memory, e[n] = x[n] + x[n_fft-n] and o[n] = x[n] - x[n_fft-n] for
//    n = 1..n_fft/2-1 (tap n_fft/2 stands alone), and 200 taps are
//    contracted against cos and 200 (one a zero pad) against sin.
//  * Tensor cores at float32 accuracy: 3xTF32.  Both operands are split
//    into a TF32 high part and a TF32 low part of the remainder;
//    lo*hi + hi*lo + hi*hi accumulate in float32 (the dropped lo*lo term is
//    2^-22 of the product).  The basis is split once on the host; the
//    folded frames are split as their fragments are read.
//  * wgmma, not mma.sync.  One block owns 64 frames (110 blocks on the main
//    path, one wave on 132 SMs) and two warpgroups, one for the real part
//    and one for the imaginary: per 8-tap slice each starts three
//    wgmma.m64n208k8 (tf32 in, float32 out; 104 accumulators a thread) with
//    its A fragments in registers (the split needs them there anyway) and B
//    read from shared memory through a descriptor.  With the same
//    products as 78 mma.sync.m16n8k8 a warp and slice the kernel took 1.5
//    times as long: with its loads knocked out, mma.sync alone ran at some
//    60 % of the tensor cores' TF32 rate.  The products of a slice stay in
//    flight while the
//    next slice's fragments are read and split (two sets of fragment
//    registers take turns).
//  * The basis (cos|sin, hi|lo: 650 KB) is stored by the host in the
//    layout the descriptor names, K-major without swizzle: core matrices
//    of 8 bins x 4 taps (128 contiguous bytes), 26 of them along the bins
//    and 2 along the taps of a slice.  One slice (26 KB) is one stage of a
//    three-stage ring, filled by the copy engine: one thread starts one
//    bulk copy (cp.async.bulk) per slice and an mbarrier counts its bytes.
//    Filling the ring with per-thread cp.async (1,664 16-byte copies a
//    slice) cost 15 % of the mma.sync kernel's time on the load/store
//    path.  The tile's waveform (42 KB) is staged once with the reflect pad
//    built on the fly, so no [N, 400] frame tensor exists.
//  * The tile's samples are fetched with cp.async, all in flight at once
//    (16 bytes a copy inside the waveform, 4 at the reflected ends), and
//    folded without branches, a warp's eight frames of one tap together,
//    so the loads do not wait on each other.
//  * Power goes to shared memory bin-major (real warps write re^2,
//    imaginary warps add im^2).  The mel product walks only each filter's
//    nonzero bins (triangular filters: ~10 of 201, weights packed by the
//    host and kept in shared memory) in float32 FMAs: a warp takes one
//    filter for all 64 frames, so the walk is uniform over the warp, the
//    weights are broadcasts and the power reads are 32 neighbours.  Then
//    log, and the tile leaves as one contiguous block.
//  * A batch [B, T] is one launch: frame tiles along grid x, waveforms
//    along grid y, each row padded on its own.  Rows are addressed by a
//    stride, so windows cut from one signal (the overlap detector's 24
//    five-second windows at a 2.5 s hop: 24 x 8 = 192 blocks) are read in
//    place, without a copy that would write every sample twice.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE_M = 64;      // frames per block
constexpr int THREADS = 256;    // 8 warps
constexpr int N_TILES = 26;     // 8-bin tiles: n_bins <= 208
constexpr int STAGES = 3;
// one 8-tap slice of the basis:
// [part][hi | lo][4-tap half][bin tile][8 bins][4 taps]
constexpr int STAGE_FLOATS = 2 * 2 * 2 * N_TILES * 8 * 4;
constexpr int PW_STRIDE = 68;   // floats per bin of the power tile [bin][frame]

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D[64 x 208] += A[64 x 8] (registers, this warp's 16 rows) x B[8 x 208]
// (shared memory, K-major core matrices), TF32 in, float32 out
__device__ __forceinline__ void wgmma_tf32(float (&d)[104], const uint32_t (&a)[4],
                                           uint64_t desc) {
  // operands 0..103: the accumulators; 104..107: A; 108: B's descriptor
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38,"
      " %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64,"
      " %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77,"
      " %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90,"
      " %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103}, "
      "{%104, %105, %106, %107}, %108, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes; lbo between core matrices along K, sbo along N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One thread's bulk copy global -> shared through the copy engine; `bar`
// counts the bytes as they land.  Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(d),
      "l"(gmem), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the barrier's phase of the given parity is complete.  The spin
// is bounded, so a lost copy shows as a wrong result and not as a kernel
// that never ends.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  for (int spin = 0; spin < (1 << 20); ++spin) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(b), "r"(parity)
        : "memory");
    if (ok) return;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_log_mel_kernel(const float* __restrict__ y,      // [rows] x t, row r at
                                                       // y + r * y_stride
                     long long y_stride, int t,
                     const float* __restrict__ basis,  // [nks] x STAGE_FLOATS
                     int nks,                          // 8-tap slices
                     const int* __restrict__ mel_idx,  // [3, n_mels]: first
                                                       // bin, end bin, offset
                     const float* __restrict__ mel_w,  // [nnz] packed weights
                     int nnz, int n_fft, int hop, int n_mels, float eps,
                     float* __restrict__ out,   // [rows, n_frames, n_mels]
                     int n_frames) {
  extern __shared__ __align__(16) float smem[];
  const int kp = nks * 8;                 // padded taps per part
  const int a_stride = kp + 4;            // 204: rows 12 banks apart
  const int span = TILE_M * hop + (n_fft - hop);
  float* As = smem;                              // [2][TILE_M][a_stride]
  float* Bs = As + 2 * TILE_M * a_stride;        // [STAGES][STAGE_FLOATS]
  float* ys = Bs + STAGES * STAGE_FLOATS;        // [span] padded samples
  int* mi = reinterpret_cast<int*>(ys + span);   // [3][n_mels]
  float* mw = reinterpret_cast<float*>(mi + 3 * n_mels);   // [nnz]
  float* pw = Bs;    // [bins][PW_STRIDE] power, once the products are done
  float* res = As;   // [TILE_M][n_mels] log-mel, once the products are done
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * TILE_M;
  const int half = n_fft / 2;
  // one waveform of the batch per blockIdx.y, each reflect-padded on its
  // own; rows may overlap in memory (windows cut from one signal)
  y += (long long)blockIdx.y * y_stride;
  out += (long long)blockIdx.y * n_frames * n_mels;

  // slice ks of the basis -> its buffer of the ring, by one thread; the
  // fence orders the ring's earlier reads before the copy engine's write
  __shared__ __align__(8) uint64_t full[STAGES];
  auto load_stage = [&](int ks) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_load(Bs + (ks % STAGES) * STAGE_FLOATS,
              basis + (size_t)ks * STAGE_FLOATS,
              STAGE_FLOATS * sizeof(float), &full[ks % STAGES]);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          (uint32_t)__cvta_generic_to_shared(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < nks) load_stage(s);
  }

  // padded index p = f0*hop + i holds sample g = p - half, reflected at both
  // ends (numpy/torch 'reflect': the edge sample is not repeated).  Four
  // samples a copy where they lie inside the waveform and 16 bytes are
  // aligned on both sides, one sample a copy elsewhere.
  const long long p0 = (long long)f0 * hop - half;
  const bool al16 = ((reinterpret_cast<uintptr_t>(y) + 4 * p0) & 15) == 0;
  for (int i = 4 * tid; i < span; i += 4 * THREADS) {
    if (al16 && p0 + i >= 0 && p0 + i + 3 < t && i + 3 < span) {
      cp_async16(ys + i, y + p0 + i);
      continue;
    }
    for (int e = i; e < min(i + 4, span); ++e) {
      long long g = p0 + e;
      if (g < 0) g = -g;
      if (g >= t) g = 2LL * (t - 1) - g;
      if (g >= 0 && g < t) cp_async4(ys + e, y + g);
      else ys[e] = 0.f;
    }
  }
  for (int i = tid; i < 3 * n_mels; i += THREADS) cp_async4(mi + i, mel_idx + i);
  for (int i = tid; i < nnz; i += THREADS) cp_async4(mw + i, mel_w + i);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();   // the samples landed; the barriers are set up for all
  const int warp = tid >> 5, lane = tid & 31;
  // fold: column j holds tap n = j + 1.  Without branches: from tap half on
  // both reads are tap half itself, so the difference is 0, and the sum is
  // scaled by 1, by 1/2 (tap half stands alone) or by 0 (the taps' zero pad).
  // A warp's eight frames of one tap are independent loads in flight.
  for (int j = lane; j < kp; j += 32) {
    const int n = min(j + 1, half);
    const float we = j + 1 < half ? 1.f : (j + 1 == half ? 0.5f : 0.f);
    const float* ya = ys + n;
    const float* yb = ys + n_fft - n;
#pragma unroll
    for (int mm = 0; mm < TILE_M / (THREADS / 32); ++mm) {
      const int m = warp + mm * (THREADS / 32);
      const float a = ya[m * hop], b = yb[m * hop];
      As[m * a_stride + j] = (a + b) * we;
      As[(TILE_M + m) * a_stride + j] = a - b;
    }
  }

  const int g = lane >> 2, tq = lane & 3;
  const int part = warp >> 2, w4 = warp & 3;   // warpgroup: real | imaginary
  const float* Aw = As + (part * TILE_M + w4 * 16 + g) * a_stride + tq;
  float acc[104];
#pragma unroll
  for (int i = 0; i < 104; ++i) acc[i] = 0.f;
  if (tid == 0 && STAGES - 1 < nks) load_stage(STAGES - 1);

  __syncthreads();   // the fold is complete
  // One 8-tap slice a step: split this warp's A fragments, then three
  // products on the slice, left in flight while the next step's fragments
  // are prepared (two sets of fragment registers take turns).
  uint32_t ahi[2][4], alo[2][4];
  auto step = [&](int ks, auto set) {
    constexpr int S = decltype(set)::value;
    const float* p = Aw + ks * 8;
    const float v[4] = {p[0], p[8 * a_stride], p[4], p[8 * a_stride + 4]};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ahi[S][q] = tf32_rna(v[q]);
      alo[S][q] = tf32_rna(v[q] - __uint_as_float(ahi[S][q]));
    }
    bar_wait(&full[ks % STAGES], (ks / STAGES) & 1);   // slice ks landed
    // the slice: [part][hi | lo][k core 2][bin tile 26][8 bins][4 taps]
    const float* bs = Bs + (ks % STAGES) * STAGE_FLOATS + part * (STAGE_FLOATS / 2);
    const uint64_t d_hi = smem_desc(bs, N_TILES * 128, 128);
    const uint64_t d_lo = smem_desc(bs + STAGE_FLOATS / 4, N_TILES * 128, 128);
    wgmma_fence();
    wgmma_tf32(acc, alo[S], d_hi);
    wgmma_tf32(acc, ahi[S], d_lo);
    wgmma_tf32(acc, ahi[S], d_hi);
    wgmma_commit();
    wgmma_wait<1>();   // the step before is complete
    __syncthreads();   // ... in both warpgroups: its slice's buffer is free
    if (tid == 0 && ks >= 1 && ks + STAGES - 1 < nks) load_stage(ks + STAGES - 1);
  };
  for (int ks = 0; ks < nks; ks += 2) {
    step(ks, std::integral_constant<int, 0>{});
    if (ks + 1 < nks) step(ks + 1, std::integral_constant<int, 1>{});
  }
  wgmma_wait<0>();
  __syncthreads();   // every warp is done with the ring and the folded tile

  // power, bin-major: real warps write re^2, then imaginary warps add
  // im^2.  A warp's 32 lanes hit 32 banks (68 * 2 tq = 8 tq mod 32, plus g).
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (part == pass) {
#pragma unroll
        for (int i = 0; i < N_TILES; ++i) {
          const int row = w4 * 16 + g;
          const int col = i * 8 + 2 * tq;
          float* p = pw + col * PW_STRIDE + row;
          const float* c = acc + 4 * i;
          float v[4] = {c[0] * c[0], c[1] * c[1], c[2] * c[2], c[3] * c[3]};
          if (pass == 1) {
            v[0] += p[0];
            v[1] += p[PW_STRIDE];
            v[2] += p[8];
            v[3] += p[PW_STRIDE + 8];
          }
          p[0] = v[0];
          p[PW_STRIDE] = v[1];
          p[8] = v[2];
          p[PW_STRIDE + 8] = v[3];
        }
    }
    __syncthreads();
  }

  // mel product and log: a warp takes one filter for the tile's 64 frames
  for (int m0 = 0; m0 < n_mels; m0 += THREADS / 32) {
    // filters widen with frequency: every other round runs the warps backwards
    const int m = m0 + ((m0 / (THREADS / 32)) & 1 ? THREADS / 32 - 1 - warp : warp);
    if (m >= n_mels) continue;
    const int lo = mi[m], hi = mi[n_mels + m];
    const float* w = mw + mi[2 * n_mels + m] - lo;
    const float* p = pw + lane;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int b = lo;
    for (; b + 1 < hi; b += 2) {
      const float w0 = w[b], w1 = w[b + 1];
      s0 = fmaf(p[b * PW_STRIDE], w0, s0);
      s1 = fmaf(p[b * PW_STRIDE + 32], w0, s1);
      s2 = fmaf(p[(b + 1) * PW_STRIDE], w1, s2);
      s3 = fmaf(p[(b + 1) * PW_STRIDE + 32], w1, s3);
    }
    if (b < hi) {
      s0 = fmaf(p[b * PW_STRIDE], w[b], s0);
      s1 = fmaf(p[b * PW_STRIDE + 32], w[b], s1);
    }
    res[lane * n_mels + m] = logf(s0 + s2 + eps);
    res[(lane + 32) * n_mels + m] = logf(s1 + s3 + eps);
  }
  __syncthreads();
  const int n_out = min(TILE_M, n_frames - f0) * n_mels;
  float* o = out + (long long)f0 * n_mels;
  for (int idx = tid; idx < n_out; idx += THREADS) o[idx] = res[idx];
}

}  // namespace

// C entry point: launches on `stream`, does not synchronise, returns
// cudaGetLastError().  `y` holds `n_batch` waveforms of `t` samples,
// `y_stride` elements apart (any stride, rows may overlap), and `out` is
// [n_batch, n_frames, n_mels]: one launch, frame tiles along grid x and
// waveforms along grid y.  `basis` is the folded, split basis in core-matrix
// order of dsp/mel.py::_basis_fragments with `nks` 8-tap slices; `mel_idx` and
// `mel_w` are the packed filterbank of dsp/mel.py::_mel_sparse.  Requires n_fft
// even, n_fft/2 + 1 <= 208 bins, nks*8 >= n_fft/2 and t > n_fft/2 (checked
// by the Python wrapper); cudaErrorInvalidValue when the tile does not fit
// shared memory.
extern "C" int sdt_fused_log_mel(const float* y, int n_batch,
                                 long long y_stride, int t, const float* basis,
                                 int nks, const int* mel_idx,
                                 const float* mel_w, int nnz, int n_fft,
                                 int hop, int n_mels, float eps, float* out,
                                 int n_frames, void* stream) {
  if (n_fft % 2 || n_fft / 2 + 1 > N_TILES * 8 || nks * 8 < n_fft / 2 ||
      n_batch < 1 || n_batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int span = TILE_M * hop + (n_fft - hop);
  const size_t smem = sizeof(float) * ((size_t)2 * TILE_M * (nks * 8 + 4) +
                                       STAGES * STAGE_FLOATS + span +
                                       3 * n_mels + nnz);
  // the ring's barriers are static shared memory beside it
  if (smem + STAGES * sizeof(uint64_t) > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + TILE_M - 1) / TILE_M;
  fused_log_mel_kernel<<<dim3(blocks, n_batch), THREADS, smem,
                         (cudaStream_t)stream>>>(
      y, y_stride, t, basis, nks, mel_idx, mel_w, nnz, n_fft, hop, n_mels, eps,
      out, n_frames);
  return (int)cudaGetLastError();
}
