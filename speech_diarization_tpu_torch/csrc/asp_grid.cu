// Sliding-grid attentive-statistics pooling for Hopper (sm_90a).
//
// Replaces: speech_diarization_tpu/ops/pallas/asp_grid.py::asp_grid_stats
// (Pallas kernel _asp_kernel).
//
// Per grid window j (rows s = first_f + j*hop_f .. s+win_f of the trunk
// features x [CC, T_f], channel-major as the trunk leaves them):
//   h = x[:, s+r] . w1x^T + bw[j];  a = tanh(relu(h) * s_bn + t_bn)
//   e = bf16(a) @ w2^T + b2;        p = softmax over the window's rows
//   mu = sum p x;  sd = sqrt(max(sum p x^2 - mu^2, 1e-12))
// with bf16 matmul operands and float32 accumulation, as the Pallas kernel.
// b2 is constant over a channel's rows, so the softmax does not see it and
// the kernel does not read it.
//
// Attention width.  The kernels walk A in 64-wide slices, a count NSL that
// is a template parameter, instantiated for A 64 and A 128: phase 1 runs
// one row of blocks per slice, and phase 2 keeps every slice of the
// window's activations and of each w2 tile in shared memory and
// accumulates the logits over the slices (more k-steps of the same mma
// chain).  The caller zero-pads a narrower A (rows of w1x, columns of bw
// and w2, s_bn, and t_bn with 0): a padded unit gives
// tanh(relu(0) * s + 0) = 0 and meets a zero column of w2, so the padding
// is exact.  EcapaTdnn pads once, at load; A 32 runs as A 64.  The slice
// count is a template parameter and not a runtime loop because the
// runtime loop cost the shipped main-path encoder (A 64) 10 % on the card
// (0.1428 -> 0.1566 ms a 60 s chunk): the NSL = 1 instance is the A-64
// kernel as it was, with the same shared memory (112,384 B) and two blocks
// an SM.  At A 128 the two slices take 160,768 B, so phase 2 runs one
// block an SM; the activations are still computed once per window, where
// keeping one slice resident at a time would recompute them for every
// channel tile.
//
// What bounds it on the H100: one 60 s chunk (W=600 windows of win_f=201
// rows, CC=768 channels, A=64) needs 11.9 GFLOP of logits and 0.6 GFLOP of
// pre-projection (both bf16 tensor-core work), against 10.7 MB of bf16
// features and 3.7 MB of stats: bound by operations.  Beside the products
// stand 93 M exponentials on the special-function units (16 results a
// clock an SM) and about nine float32 instructions per (window, row,
// channel) for the softmax and the two weighted sums.  Taking the kernel
// apart on the card showed three parts of similar size that add up instead
// of overlapping: the tensor-core products at mma.sync's rate, the softmax
// at one instruction a clock a scheduler, and the copies of x and w2 into
// shared memory (258 MB over all windows, since neighbouring windows share
// 95 % of their rows but not their block).
//
// Design.  Softmax and statistics are per channel; only the pre-projection
// contracts over channels.
//  * Phase 1 (asp_preproj_kernel): hx^T = w1x . x for every row the grid
//    touches, once, through mma.sync.m16n8k16 (bf16 in, float32 out).  A
//    block owns 16 rows and reads its fragments straight from global memory
//    / L1 (w1x, 98 KB, stays cached); its four warps take a quarter of the
//    channels each, which keeps the chains of dependent loads short, and add
//    up through shared memory.  A B fragment register is two neighbouring
//    channels of one row, so the same kernel writes the time-major copy
//    x_t [rows, CC] that phase 2 wants: every window tile is then rows of
//    128 aligned bytes, whatever T_f and first_f are.
//  * Phase 2 (asp_window_kernel): one block of eight warps owns a window.
//    It computes the window's tanh activations ONCE (rows padded to 208
//    with zeros, bf16, 30 KB in shared memory; tanh through
//    ex2 and a reciprocal), then walks the channels in tiles of 64.  Per
//    tile the logits are computed transposed, e^T [64 ch, rows] =
//    w2_tile [64, 64] . a^T: A fragments come from the staged w2 tile, B
//    fragments from the activations with ldmatrix.  A warp takes 16
//    channels and half of the rows, so a channel's logits for its half sit
//    in the registers of the four lanes of one quad (52 floats a thread at
//    208 rows; holding all rows in one warp took 248 registers and left 8
//    warps an SM).  The softmax then needs two quad shuffles and no shared
//    memory: the accumulators start at -inf for rows outside the window
//    (no other masking), take the max, one ex2 per element with log2(e)
//    folded into an FMA, and accumulate sum p, sum p*x, sum p*x^2; x comes
//    from the tile as one 32-bit word per row for the thread's two
//    channels (mma row g is channel 2g, row g+8 channel 2g+1).  The two row
//    halves meet as (max, sum p, sum p x, sum p x^2) in shared memory and
//    are merged one tile later.
//  * A window of more than 208 rows is walked in chunks of 208: each chunk
//    is a window of its own to everything above, and its (max, sum p,
//    sum p x, sum p x^2) per channel is merged into a running state in
//    shared memory (16 bytes a channel, asked for only when there is more
//    than one chunk: it costs the second resident block of an SM).  So one
//    build takes any win_f; the main path's 201 rows are one chunk and
//    never touch the state.
//  * The two warps of a channel group form a pair that copies its own slice
//    of every tile (16-byte cp.async, the next tile in flight while this one
//    is computed) and meets only its partner, at a named barrier; the four
//    pairs of a block share nothing but the activations.
//  * mma.sync, not wgmma: the softmax wants each channel's logits inside
//    one quad, which is the mma.sync accumulator layout at 16 channels a
//    warp, and the products are a third of the time.
//  * Nothing of size [W, CC, win_f] reaches device memory; outputs are the
//    [W, 2*CC] stats, scratch is x_t and hx.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int A_SL = 64;         // attention units per slice
constexpr int A_STRIDE = 72;     // bf16 per staged row of a / w2 / x (144 B)
constexpr int CT = 64;           // channels per phase-2 tile
constexpr int P1_THREADS = 128;  // four warps: 16 rows, a quarter of K each
constexpr int P2_THREADS = 256;  // eight warps: 4 x 16 channels, 2 row halves
constexpr int NTW = 13;          // 8-row tiles per warp of phase 2
constexpr int ROWS = 2 * NTW * 8;   // rows per chunk of a window: 208
// phase 2's shared memory for n_sl slices of A: activations, two w2 tiles,
// two x tiles, the row halves' partial stats; past it the running state of
// a window of several chunks, one float4 a channel
constexpr size_t p2_smem(int n_sl) {
  return sizeof(__nv_bfloat16) *
             (n_sl * ROWS * A_STRIDE + 2 * n_sl * CT * A_STRIDE + 2 * ROWS * A_STRIDE) +
         2 * 2 * CT * sizeof(float4);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16-byte global -> shared copy; `smem` is a shared-window address
__device__ __forceinline__ void cp_async16s(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// tanh(v) = 1 - 2 / (exp(2v) + 1) on the special-function units: absolute
// error ~1e-7, far below the bf16 rounding the result goes through
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, ex2(2.f * 1.4426950408889634f * v) + 1.f);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// hx[r][a] = sum_c x[c][first_f + r] * w1x[a][c], r < n_rows.  A block owns
// 16 rows and one 64-wide slice of A (blockIdx.y); its four warps take a
// quarter of the channels each (short dependent load chains, four times
// the warps in flight) and add up through shared memory.  The blocks of
// slice 0 also write x_t.
template <int NSL>
__global__ void __launch_bounds__(P1_THREADS)
asp_preproj_kernel(const unsigned short* __restrict__ x,   // [cc, t_f] bf16
                   long long t_f, int first_f, int cc,
                   const __nv_bfloat16* __restrict__ w1x,   // [a_dim, cc]
                   int n_rows,
                   uint32_t* __restrict__ x_t,   // [n_rows, cc] bf16, in pairs
                   float* __restrict__ hx) {                // [n_rows, a_dim]
  __shared__ float red[P1_THREADS / 32][16 * A_SL];
  constexpr int a_dim = NSL * A_SL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * 16;
  const int a0 = NSL == 1 ? 0 : blockIdx.y * A_SL;   // this block's slice of A
  const bool write_xt = NSL == 1 || blockIdx.y == 0;
  w1x += (size_t)a0 * cc;
  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  // a row past n_rows reads row n_rows-1 (in bounds) and is not stored
  const unsigned short* xr[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    xr[nt] = x + first_f + min(r0 + nt * 8 + g, n_rows - 1);

  const int kq = cc / (P1_THREADS / 32);
#pragma unroll 4
  for (int k0 = warp * kq; k0 < (warp + 1) * kq; k0 += 16) {
    uint32_t b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned short* p = xr[nt] + (long long)(k0 + 8 * h + 2 * tq) * t_f;
        b[nt][h] = (uint32_t)p[0] | ((uint32_t)p[t_f] << 16);
        // the B fragment is two neighbouring channels of one row: the
        // time-major copy phase 2 reads
        const int r = r0 + nt * 8 + g;
        if (write_xt && r < n_rows)
          x_t[((size_t)r * cc + k0 + 8 * h + 2 * tq) >> 1] = b[nt][h];
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* w = w1x + (size_t)(mt * 16 + g) * cc + k0 + 2 * tq;
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(w),
          *reinterpret_cast<const uint32_t*>(w + 8 * (size_t)cc),
          *reinterpret_cast<const uint32_t*>(w + 8),
          *reinterpret_cast<const uint32_t*>(w + 8 * (size_t)cc + 8)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        red[warp][(nt * 8 + 2 * tq + (q & 1)) * A_SL + mt * 16 + g + 8 * (q >> 1)] =
            acc[mt][nt][q];
  __syncthreads();
  for (int o = threadIdx.x; o < 16 * A_SL; o += P1_THREADS) {
    const int r = r0 + o / A_SL;
    if (r >= n_rows) break;
    float v = red[0][o];
#pragma unroll
    for (int w = 1; w < P1_THREADS / 32; ++w) v += red[w][o];
    hx[(size_t)r * a_dim + a0 + o % A_SL] = v;
  }
}

template <int NSL>
__global__ void __launch_bounds__(P2_THREADS, 2)
asp_window_kernel(const __nv_bfloat16* __restrict__ x_t,  // [n_rows, cc]
                  int n_rows, int cc,
                  const float* __restrict__ hx,            // [n_rows, a_dim]
                  const float* __restrict__ bw,            // [W, a_dim]
                  const float* __restrict__ s_bn,          // [a_dim]
                  const float* __restrict__ t_bn,          // [a_dim]
                  const __nv_bfloat16* __restrict__ w2,    // [cc, a_dim]
                  int hop_f, int win_f,
                  float* __restrict__ out) {               // [W, 2*cc]
  static_assert(P2_THREADS == 2 * 32 * (CT / 16), "a pair of warps per 16 channels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int a_dim = NSL * A_SL;
  // a_s [NSL][ROWS][A_STRIDE], w2_s [2][NSL][CT][A_STRIDE],
  // x_s [2][ROWS][A_STRIDE]: one slice of a_s / of a w2 tile has the layout
  // of the whole of it at A 64
  constexpr int A_SLICE_E = ROWS * A_STRIDE;   // elements per slice of a_s
  constexpr int W_SLICE_E = CT * A_STRIDE;     // elements per slice of a w2 tile
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w2_s = a_s + NSL * A_SLICE_E;
  __nv_bfloat16* x_s = w2_s + 2 * NSL * W_SLICE_E;
  // per tile buffer, row half and channel: (max, sum p, sum p x, sum p x^2)
  float4* part = reinterpret_cast<float4*>(x_s + 2 * ROWS * A_STRIDE);   // [2][2][CT]
  float4* state = part + 2 * 2 * CT;   // [cc], only when win_f > ROWS
  const int tid = threadIdx.x;
  const int j = blockIdx.x;
  const int n_ct = cc / CT;
  const float L2E = 1.4426950408889634f;
  const float NEG_INF = __int_as_float(0xff800000);

  // A pair of warps (row halves 0 and 1 of one 16-channel group) shares
  // nothing but a_s with the other pairs: it copies its own slice of every
  // tile and meets only its partner, at a named barrier.  Warps 2k and 2k+1
  // pair up, so a pair's two warps sit on different schedulers.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int cg = warp >> 1;                 // 16 channels of the tile
  const int rh = warp & 1;                  // row half
  const int row0 = rh * NTW * 8;            // this warp's first row of a chunk
  const int pt = rh * 32 + lane;            // thread within the pair
  auto pair_barrier = [&]() {
    asm volatile("bar.sync %0, 64;" ::"r"(1 + cg) : "memory");
  };

  // The pair's slice of a tile: w2 rows of its 16 channels (128 B each per
  // slice of A, two pieces a thread) and the chunk's rows of those channels
  // in x_t (32 B a row, KX pieces a thread).  All but the tile and the
  // chunk is fixed per thread.
  constexpr int KX = (ROWS * 2 + 63) / 64;
  const int w2_row = cg * 16 + (pt >> 3);
  const uint32_t w2_dst = (uint32_t)__cvta_generic_to_shared(
      w2_s + w2_row * A_STRIDE + (pt & 7) * 8);
  const __nv_bfloat16* w2_src = w2 + (size_t)w2_row * a_dim + (pt & 7) * 8;
  const int x_r = pt >> 1;
  const int x_col = cg * 16 + (pt & 1) * 8;
  const uint32_t x_dst = (uint32_t)__cvta_generic_to_shared(
      x_s + x_r * A_STRIDE + x_col);
  const size_t x_step = (size_t)32 * cc;
  // mma row g is channel 2g of the warp's 16, row g+8 channel 2g+1: a
  // thread's two channels are neighbours, one 32-bit word of x_s
  const int ch = cg * 16 + 2 * g;   // first of the two channels, in the tile
  const __nv_bfloat16* w2w = w2_s + ch * A_STRIDE + 2 * tq;
  const __nv_bfloat16* a_l = a_s + (row0 + (lane & 7)) * A_STRIDE + (lane >> 3) * 8;
  const uint32_t* xw0 =
      reinterpret_cast<const uint32_t*>(x_s + (row0 + 2 * tq) * A_STRIDE + ch);

  // the window's rows in chunks of ROWS: c0 the chunk's first window row, wl
  // its length.  The main path's windows are one chunk.
  for (int c0 = 0; c0 < win_f; c0 += ROWS) {
    const int wl = min(ROWS, win_f - c0);
    const int c_first = j * hop_f + c0;   // chunk's first row among the grid's
    if (c0) __syncthreads();   // every warp is done with the chunk before
    const __nv_bfloat16* x_src = x_t + (size_t)(c_first + x_r) * cc + x_col;
    auto load_tile = [&](int ct, int buf) {
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl) {
        const uint32_t wd = w2_dst + 2 * ((buf * NSL + sl) * W_SLICE_E);
        const __nv_bfloat16* ws = w2_src + (size_t)ct * CT * a_dim + sl * A_SL;
        cp_async16s(wd, ws);
        cp_async16s(wd + 2 * 8 * A_STRIDE, ws + 8 * a_dim);
      }
      const uint32_t xd = x_dst + buf * (2 * ROWS * A_STRIDE);
      const __nv_bfloat16* xs = x_src + ct * CT;
#pragma unroll
      for (int k = 0; k < KX; ++k)
        if (x_r + 32 * k < wl)
          cp_async16s(xd + 2 * 32 * k * A_STRIDE, xs + k * x_step);
      cp_async_commit();
    };
    // rows past wl stay zero in both buffers: with p = 0 there, 0 * x = 0
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int r = x_r + 32 * k;
      if (r >= wl && r < ROWS) {
        *reinterpret_cast<uint4*>(x_s + r * A_STRIDE + x_col) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(x_s + (ROWS + r) * A_STRIDE + x_col) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // the two row halves of channel tile ct, and the chunks before this one,
    // -> that tile's stats.  A channel is always merged by the same thread.
    auto merge_store = [&](int ct, int buf) {
      const int mc = cg * 16 + pt;             // pt < 16
      const float4 p0 = part[(buf * 2 + 0) * CT + mc];
      const float4 p1 = part[(buf * 2 + 1) * CT + mc];
      float m = fmaxf(p0.x, p1.x);             // finite: row 0 is in half 0
      const float f0 = ex2((p0.x - m) * L2E), f1 = ex2((p1.x - m) * L2E);
      float z = p0.y * f0 + p1.y * f1;
      float s1 = p0.z * f0 + p1.z * f1;
      float s2 = p0.w * f0 + p1.w * f1;
      if (c0) {
        const float4 st = state[ct * CT + mc];
        const float mm = fmaxf(m, st.x);
        const float fc = ex2((m - mm) * L2E), fs = ex2((st.x - mm) * L2E);
        m = mm;
        z = z * fc + st.y * fs;
        s1 = s1 * fc + st.z * fs;
        s2 = s2 * fc + st.w * fs;
      }
      if (c0 + ROWS < win_f) {
        state[ct * CT + mc] = make_float4(m, z, s1, s2);
        return;
      }
      const float iz = 1.f / z;
      const float mu = s1 * iz;
      const float m2 = s2 * iz;
      float* o = out + (size_t)j * 2 * cc + ct * CT + mc;
      o[0] = mu;
      o[cc] = sqrtf(fmaxf(m2 - mu * mu, 1e-12f));
    };
    load_tile(0, 0);

    // the chunk's activations, once: a_s[r][a], zero rows past wl.  A
    // thread keeps its two attention units and walks the rows eight apart.
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) {
      const int al = (tid & 31) * 2;          // unit within the slice
      const int a = sl * A_SL + al;
      const float2 b = *reinterpret_cast<const float2*>(bw + (size_t)j * a_dim + a);
      const float2 s = *reinterpret_cast<const float2*>(s_bn + a);
      const float2 sh = *reinterpret_cast<const float2*>(t_bn + a);
      const float* hw = hx + (size_t)c_first * a_dim + a;
      __nv_bfloat16* as = a_s + sl * A_SLICE_E + al;
#pragma unroll 13
      for (int r = tid >> 5; r < ROWS; r += P2_THREADS / 32) {
        float v0 = 0.f, v1 = 0.f;
        if (r < wl) {
          const float2 h = *reinterpret_cast<const float2*>(hw + (size_t)r * a_dim);
          v0 = tanh_fast(fmaxf(h.x + b.x, 0.f) * s.x + sh.x);
          v1 = tanh_fast(fmaxf(h.y + b.y, 0.f) * s.y + sh.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(as + r * A_STRIDE) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();   // a_s is complete; from here on only pairs meet

    // fixed per thread over the tiles: which of its columns lie inside the
    // chunk (column i*8 + k of this thread is chunk row row0 + 2*tq + i*8 + k:
    // inside iff i*8 + k < nv)
    const int nv = wl - row0 - 2 * tq;

    for (int ct = 0; ct < n_ct; ++ct) {
      const int buf = ct & 1;
      cp_async_wait_all();
      pair_barrier();    // the pair's slice of tile ct and its partial stats of
                         // tile ct-1 are visible; its slice of buffer buf^1 is free
      if (ct + 1 < n_ct) load_tile(ct + 1, buf ^ 1);
      if (ct > 0 && pt < 16) merge_store(ct - 1, buf ^ 1);

      // logits e^T[this warp's 16 channels][its NTW*8 rows]
      const __nv_bfloat16* w2b = w2w + buf * NSL * W_SLICE_E;
      // the accumulators start at 0 inside the window and at -inf outside it,
      // which is all the masking the softmax needs
      float acc[NTW][4];
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        acc[i][0] = acc[i][2] = i * 8 < nv ? 0.f : NEG_INF;
        acc[i][1] = acc[i][3] = i * 8 + 1 < nv ? 0.f : NEG_INF;
      }
      // over the slices of A, two k-steps at a time: their A fragments,
      // then one ldmatrix per row tile for its B fragments of both
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl) {
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          uint32_t af[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat16* w = w2b + sl * W_SLICE_E + (2 * kp + h) * 16;
            af[h][0] = *reinterpret_cast<const uint32_t*>(w);
            af[h][1] = *reinterpret_cast<const uint32_t*>(w + A_STRIDE);
            af[h][2] = *reinterpret_cast<const uint32_t*>(w + 8);
            af[h][3] = *reinterpret_cast<const uint32_t*>(w + A_STRIDE + 8);
          }
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            uint32_t b[4];
            ldmatrix_x4(b, a_l + sl * A_SLICE_E + i * 8 * A_STRIDE + kp * 32);
            mma_bf16(acc[i], af[0], b[0], b[1]);
            mma_bf16(acc[i], af[1], b[2], b[3]);
          }
        }
      }

      // softmax over this warp's rows: channel ch in acc[..][0..1], channel
      // ch + 1 in acc[..][2..3]; window rows row0 + i*8 + 2*tq + {0, 1}
      float m_lo = NEG_INF, m_hi = NEG_INF;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        m_lo = fmaxf(m_lo, fmaxf(acc[i][0], acc[i][1]));
        m_hi = fmaxf(m_hi, fmaxf(acc[i][2], acc[i][3]));
      }
      m_lo = quad_max(m_lo);
      m_hi = quad_max(m_hi);
      // a half with no row inside the window: p = ex2(-inf) = 0, not NaN
      const float nm_lo = m_lo == NEG_INF ? 0.f : -m_lo * L2E;
      const float nm_hi = m_hi == NEG_INF ? 0.f : -m_hi * L2E;

      const uint32_t* xw = xw0 + buf * (ROWS * A_STRIDE / 2);
      float z_lo = 0.f, s1_lo = 0.f, s2_lo = 0.f;
      float z_hi = 0.f, s1_hi = 0.f, s2_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const uint32_t w0 = xw[i * 8 * (A_STRIDE / 2)];          // row, 2 channels
        const uint32_t w1 = xw[(i * 8 + 1) * (A_STRIDE / 2)];    // next row
        const float x0 = __uint_as_float(w0 << 16), x1 = __uint_as_float(w1 << 16);
        const float x2 = __uint_as_float(w0 & 0xffff0000u);
        const float x3 = __uint_as_float(w1 & 0xffff0000u);
        const float p0 = ex2(fmaf(acc[i][0], L2E, nm_lo));
        const float p1 = ex2(fmaf(acc[i][1], L2E, nm_lo));
        const float p2 = ex2(fmaf(acc[i][2], L2E, nm_hi));
        const float p3 = ex2(fmaf(acc[i][3], L2E, nm_hi));
        const float q0 = p0 * x0, q1 = p1 * x1, q2 = p2 * x2, q3 = p3 * x3;
        z_lo += p0 + p1;
        z_hi += p2 + p3;
        s1_lo += q0 + q1;
        s1_hi += q2 + q3;
        s2_lo = fmaf(q0, x0, fmaf(q1, x1, s2_lo));
        s2_hi = fmaf(q2, x2, fmaf(q3, x3, s2_hi));
      }
      z_lo = quad_sum(z_lo);  s1_lo = quad_sum(s1_lo);  s2_lo = quad_sum(s2_lo);
      z_hi = quad_sum(z_hi);  s1_hi = quad_sum(s1_hi);  s2_hi = quad_sum(s2_hi);
      if (tq == 0) {
        float4* pp = part + (buf * 2 + rh) * CT + ch;
        pp[0] = make_float4(m_lo, z_lo, s1_lo, s2_lo);
        pp[1] = make_float4(m_hi, z_hi, s1_hi, s2_hi);
      }
    }
    pair_barrier();
    if (pt < 16) merge_store(n_ct - 1, (n_ct - 1) & 1);
  }
}

template <int NSL>
int launch_k1(const void* x, int t_f, int first_f, int cc, const float* bw,
              const void* w1x, const float* s_bn, const float* t_bn,
              const void* w2, int hop_f, int win_f, int n_windows, int n_rows,
              void* x_t, float* hx, float* out, cudaStream_t st) {
  const size_t smem = p2_smem(NSL) + (win_f > ROWS ? cc * sizeof(float4) : 0);
  if (cc % CT || win_f < 1 || first_f + n_rows > t_f || smem > 232448)
    return (int)cudaErrorInvalidValue;
  asp_preproj_kernel<NSL><<<dim3((n_rows + 15) / 16, NSL), P1_THREADS, 0, st>>>(
      static_cast<const unsigned short*>(x), t_f, first_f, cc,
      static_cast<const __nv_bfloat16*>(w1x), n_rows,
      static_cast<uint32_t*>(x_t), hx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(asp_window_kernel<NSL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  asp_window_kernel<NSL><<<n_windows, P2_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x_t), n_rows, cc, hx, bw, s_bn, t_bn,
      static_cast<const __nv_bfloat16*>(w2), hop_f, win_f, out);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: two launches on `stream`, no synchronisation; returns
// cudaGetLastError().  x is the whole [cc, t_f] bf16 feature map with
// first_f + n_rows <= t_f; x_t [n_rows, cc] bf16 and hx [n_rows, a_dim]
// float32 are caller-allocated scratch, n_rows = (n_windows-1)*hop_f + win_f.
// cudaErrorInvalidValue for what the kernels do not take: a_dim other than
// 64 or 128 (pad a narrower one), cc not a multiple of 64, and with
// win_f > 208 more channels than the running state has shared memory for
// (about 7,500 at A 64, 4,400 at A 128).
extern "C" int sdt_asp_grid_stats(const void* x, int t_f, int first_f, int cc,
                                  const float* bw, const void* w1x,
                                  const float* s_bn, const float* t_bn,
                                  const void* w2, int a_dim, int hop_f,
                                  int win_f, int n_windows, int n_rows,
                                  void* x_t, float* hx, float* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a_dim == A_SL)
    return launch_k1<1>(x, t_f, first_f, cc, bw, w1x, s_bn, t_bn, w2, hop_f,
                        win_f, n_windows, n_rows, x_t, hx, out, st);
  if (a_dim == 2 * A_SL)
    return launch_k1<2>(x, t_f, first_f, cc, bw, w1x, s_bn, t_bn, w2, hop_f,
                        win_f, n_windows, n_rows, x_t, hx, out, st);
  return (int)cudaErrorInvalidValue;
}
