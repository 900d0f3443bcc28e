// Mamba-2 chunked SSD scan for repro_torch.kernels.ssd_scan (B6).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). On the TPU the chunk axis is the sequential grid
// dimension and the f32 (P, N) state is VMEM scratch carried across it.
// The card runs blocks in no order, so the scan is Mamba-2's own chunked
// decomposition in three launches, each over every chunk at once, with no
// atomics and a fixed order of every sum (two calls give the same bits):
//
//   1. ssd_chunk_state, one CTA per (batch, head, chunk):
//        cum = prefix-sum(a_log) over the chunk                 -> cum scratch
//        S_c = x_c^T (B_c o e^(cum_last - cum)), P x N f32      -> states
//        e^(cum_last)                                           -> decay
//   2. ssd_state_pass, one thread per (batch, head, state entry), walking
//      the chunks in order:
//        carried[0] = 0, carried[c] = e^(cum_last[c-1]) carried[c-1] + S_{c-1}
//   3. ssd_chunk_out_{mma,ffma}, one CTA per (batch, head, chunk, 64 query
//      rows):
//        y = ((C B^T) o L) x + (C o e^cum) carried[c]^T,
//        L[t, s] = e^(cum_t - cum_s) for t >= s, masked before the exp.
//
// bf16 ("mma"): C B^T runs on mma.sync m16n8k16 bf16 -> f32 (products of
// bf16 are exact, as in the plain version's f32 einsum); the decayed f32
// scores are split into bf16 hi + lo, two A fragments of y += P x on the
// same instruction, which keeps P to ~2^-16 where one bf16 rounding would
// be 2^-8 (B5 splits its P the same way). Each of 4 warps owns 16 query
// rows and walks 16-key slices of the key tiles at or below them (slices
// above the diagonal are skipped); x comes to the B fragments by
// ldmatrix.trans. The two state terms (pass 1's x^T (B o decay) and pass
// 3's (C o e^cum) carried^T) have an f32 operand, are under a fifth of the
// flops and run on IEEE FFMA. f32 ("ffma"): the same passes with every
// product on IEEE FFMA (never TF32), pass 3 on 4 x (P/16) register tiles.
//
// Every tile reaches shared memory by cp.async (16-byte copies where a row
// is contiguous and aligned, else 4-byte ones; bf16 with strided elements
// is loaded by the threads), so a CTA has all its copies in flight at once
// instead of one load latency per element; pass 1 and the bf16 pass 3
// double-buffer their tiles, fetching the next while computing this one.
//
// A ragged last chunk is cut to its valid length: the reference pads it
// with a_log = 0 and zero x / B / C, which adds exact zeros. Operands are
// read through their (batch, seq, head, element) strides, so the model
// layout is read without a copy. The wrapper allocates the scratch (cum,
// states, decay, carried: f32) with torch.empty.
//
// Bound: bytes at the hymba prefill shape (x 2x50x4096x64, N = 16, chunk
// 256, bf16): x, B, C and y cross HBM once in bf16 and a_log once in f32,
// 133 MB or 0.040 ms at 3.35 TB/s; the t >= s products and the state
// terms are ~1e10 flops, 0.010 ms at the bf16 tensor-core peak. The three
// passes read x and B twice and add ~20 MB of f32 scratch traffic; that is
// the design's cost, not the function's bound. Grids there: 1600 CTAs
// (pass 1), 400 (pass 2), 6400 (pass 3) on 132 SMs.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace repro {
namespace {

constexpr int TS = 64;          // rows of a tile: queries, keys, state rows
constexpr int T1 = 256;         // threads of pass 1
constexpr int T2 = 256;         // threads of pass 2
constexpr int T3_MMA = 128;     // pass 3, bf16: 4 warps x 16 query rows
constexpr int T3_FFMA = 256;    // pass 3, f32: 16 x 16 threads

struct Strides {
  long long b, l, h, e;   // batch, seq, head, element (P or N)
};

__host__ __device__ inline int pad_pow2(int v) {   // 16 .. 128, 0 above
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : v <= 128 ? 128 : 0;
}

// dynamic shared memory (bytes) of each pass for padded head dim pp,
// padded state np, state n, chunk and storage size; kernels/ssd_scan.py's
// ssd_scan_plan mirrors these
__host__ __device__ inline long long smem_pass1(int pp, int np, int chunk,
                                                int item) {
  // f32 tiles and two stages in the storage type, or the group partials
  const long long tiles = 4LL * TS * (pp + np) + 2LL * TS * (pp + np) * item;
  const long long red = 4LL * 32 * T1;
  return 8LL * ((chunk + 3) / 4 * 4) + (tiles > red ? tiles : red);
}
__host__ __device__ inline long long smem_pass3_mma(int pp, int np) {
  return 2LL * (3 * TS * (np + 8) + 2 * TS * (pp + 8)) +
         4LL * (np * (pp + 2) + 3 * TS);
}
__host__ __device__ inline long long smem_pass3_ffma(int pp, int n) {
  return 4LL * (2 * TS * (n + 1) + TS * pp + TS * (TS + 1) + pp * (n + 1) +
                2 * TS);
}

// ------------------------------ asynchronous copies ---------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Rows [row0, row0 + TS) x columns [0, cols_pad) of one (batch, head)
// operand into dst (row stride ld elements), zero past `rows` / `cols`.
// vec16: the rows are contiguous and 16-byte aligned, cols is a whole
// number of 16-byte vectors and so are ld and dst; else f32 goes by 4-byte
// copies and bf16 by the threads' own loads (visible after the barrier
// that follows the wait, as the copies are).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          const Strides& s, long long row0,
                                          int rows, int cols, int cols_pad,
                                          int vec16, int nthreads) {
  if (vec16) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = cols_pad / V;
    for (int idx = threadIdx.x; idx < TS * per_row; idx += nthreads) {
      const int r = idx / per_row, c = (idx - r * per_row) * V;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + (row0 + r) * s.l + c : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < TS * cols_pad; idx += nthreads) {
    const int r = idx / cols_pad, c = idx - r * cols_pad;
    const bool ok = r < rows && c < cols;
    const T* p = ok ? src + (row0 + r) * s.l + c * s.e : src;
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst + r * ld + c, p, ok);
    } else {
      dst[r * ld + c] = ok ? *p : zero_of<T>();
    }
  }
}

// TS floats of a cum row (zero past `rows`)
__device__ __forceinline__ void copy_cum(float* dst, const float* src,
                                         int rows, int nthreads) {
  for (int i = threadIdx.x; i < TS; i += nthreads)
    cp_async4(dst + i, i < rows ? src + i : src, i < rows);
}

// inclusive prefix sum of v[0, count) in place, in a fixed order: 256-wide
// segments, each a warp scan by shuffles then a scan of the 8 warp sums
__device__ __forceinline__ void block_scan(float* v, int count) {
  __shared__ float wsum[T1 / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float carry = 0.f;
  for (int base = 0; base < count; base += T1) {
    const int i = base + threadIdx.x;
    float run = i < count ? v[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += up;
    }
    if (lane == 31) wsum[warp] = run;
    __syncthreads();
    if (warp == 0) {
      float w = lane < T1 / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < T1 / 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += up;
      }
      if (lane < T1 / 32) wsum[lane] = w;
    }
    __syncthreads();
    if (warp > 0) run += wsum[warp - 1];
    if (i < count) v[i] = run + carry;
    carry += wsum[T1 / 32 - 1];
    __syncthreads();
  }
}

// ----------------------------- pass 1: chunk states --------------------------

// widen 8 storage values to f32, scaled by w (16-byte aligned src, 32-byte
// aligned dst)
__device__ __forceinline__ void widen8(const float* src, float* dst,
                                       float w) {
  float4 a = *reinterpret_cast<const float4*>(src);
  float4 b = *reinterpret_cast<const float4*>(src + 4);
  a.x *= w, a.y *= w, a.z *= w, a.w *= w;
  b.x *= w, b.y *= w, b.z *= w, b.w *= w;
  *reinterpret_cast<float4*>(dst) = a;
  *reinterpret_cast<float4*>(dst + 4) = b;
}
__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst,
                                       float w) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16) * w;
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u) * w;
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Each thread owns K micro-tiles of 8 (p) x 4 (n) state entries; when the
// (PP/8) x (NP/4) micro-tiles are fewer than the threads, G = 256 / tiles
// groups split the chunk's rows (row r to group r % G) and their partial
// states are summed in group order. x and B arrive in their storage type
// in two stages of shared memory (the next tile's copies in flight while
// this one is used); each tile is widened once to f32, B times its row's
// decay e^(cum_last - cum), the f32 product the plain version forms. With
// one micro-tile per thread, a cap of 64 registers lets four CTAs share
// an SM.
template <typename T, int K>
__global__ void __launch_bounds__(T1, K == 1 ? 4 : 1)
ssd_chunk_state(const T* __restrict__ x, Strides xs, int xvec,
                const float* __restrict__ a, Strides as,
                const T* __restrict__ bm, Strides bs, int bvec,
                float* __restrict__ cum_out, float* __restrict__ states,
                float* __restrict__ decay, int heads, int L, int p, int n,
                int pp, int np, int chunk, int nch) {
  extern __shared__ __align__(16) float smem[];
  // heads vary fastest, so CTAs running together read neighbouring heads'
  // slices of the same rows (one DRAM page) rather than far-apart rows
  const int h = blockIdx.x % heads, ci = blockIdx.x / heads, b = blockIdx.y;
  const long long l0 = static_cast<long long>(ci) * chunk;
  const int cv = static_cast<int>(L - l0 < chunk ? L - l0 : chunk);
  const long long bh = static_cast<long long>(b) * heads + h;
  const int c4 = (chunk + 3) / 4 * 4;
  float* cum = smem;
  float* w = smem + c4;                  // e^(cum_last - cum)
  float* xt = smem + 2 * c4;             // TS x pp, f32
  float* bt = xt + TS * pp;              // TS x np, f32, decayed
  T* stage = reinterpret_cast<T*>(bt + TS * np);   // [2] TS x (pp + np)
  const int tid = threadIdx.x;
  const int ntiles = (cv + TS - 1) / TS;

  const T* xp = x + b * xs.b + h * xs.h + l0 * xs.l;
  const T* bp = bm + b * bs.b + h * bs.h + l0 * bs.l;
  auto fetch = [&](int kt) {   // rows [kt TS, kt TS + TS) into a stage
    T* xr = stage + (kt & 1) * TS * (pp + np);
    const int s0 = kt * TS, rows = cv - s0 < TS ? cv - s0 : TS;
    copy_rows(xr, pp, xp, xs, s0, rows, p, pp, xvec, T1);
    copy_rows(xr + TS * pp, np, bp, bs, s0, rows, n, np, bvec, T1);
  };
  const float* ap = a + b * as.b + h * as.h + l0 * as.l;
  for (int i = tid; i < cv; i += T1) cp_async4(cum + i, ap + i * as.l, true);
  cp_async_commit();
  fetch(0);
  cp_async_commit();
  cp_async_wait<1>();   // cum here, tile 0 may be in flight
  __syncthreads();
  block_scan(cum, cv);
  for (int i = tid; i < cv; i += T1) cum_out[bh * L + l0 + i] = cum[i];
  const float cl = cum[cv - 1];
  for (int i = tid; i < cv; i += T1) w[i] = expf(cl - cum[i]);
  if (tid == 0) decay[bh * nch + ci] = expf(cl);

  const int nt = np / 4, mt = (pp / 8) * nt;
  const int groups = mt >= T1 ? 1 : T1 / mt;
  const int grp = groups > 1 ? tid / mt : 0;
  const int tile0 = groups > 1 ? tid % mt : tid;
  float acc[K][8][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][i][j] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();   // tile kt (and w) visible; the last tile's readers done
    if (kt + 1 < ntiles) fetch(kt + 1);   // into the stage read at kt - 1
    cp_async_commit();
    const T* xr = stage + (kt & 1) * TS * (pp + np);
    const T* br = xr + TS * pp;
    const int s0 = kt * TS, rows = cv - s0 < TS ? cv - s0 : TS;
    for (int i = 8 * tid; i < TS * pp; i += 8 * T1) widen8(xr + i, xt + i, 1.f);
    for (int i = 8 * tid; i < TS * np; i += 8 * T1) {
      const int r = i / np;   // 8 values never cross a row (np >= 16)
      widen8(br + i, bt + i, r < rows ? w[s0 + r] : 0.f);
    }
    __syncthreads();
    for (int r = grp; r < rows; r += groups) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int tile = tile0 + k * T1;
        const int pi = tile / nt, ni = tile - pi * nt;
        const float4 x0 = *reinterpret_cast<const float4*>(&xt[r * pp + 8 * pi]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&xt[r * pp + 8 * pi + 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&bt[r * np + 4 * ni]);
        const float xa[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[k][i][j] = __fmaf_rn(xa[i], ba[j], acc[k][i][j]);
      }
    }
  }

  float* out = states + (bh * nch + ci) * p * n;
  auto put = [&](int tile, int ij, float v) {
    const int pc = 8 * (tile / nt) + ij / 4, nc = 4 * (tile % nt) + ij % 4;
    if (pc < p && nc < n) out[pc * n + nc] = v;
  };
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int ij = 0; ij < 32; ++ij)
        put(tile0 + k * T1, ij, acc[k][ij / 4][ij % 4]);
    return;
  }
  __syncthreads();   // every thread is done with the tiles
  // 32 x T1 floats, entry-major: a warp's threads write neighbouring words
  float* red = xt;
#pragma unroll
  for (int ij = 0; ij < 32; ++ij) red[ij * T1 + tid] = acc[0][ij / 4][ij % 4];
  __syncthreads();
  for (int idx = tid; idx < mt * 32; idx += T1) {
    const int tile = idx % mt, ij = idx / mt;
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += red[ij * T1 + g * mt + tile];
    put(tile, ij, v);
  }
}

// ----------------------------- pass 2: state passing --------------------------

__global__ void __launch_bounds__(T2)
ssd_state_pass(const float* __restrict__ states,
               const float* __restrict__ decay, float* __restrict__ carried,
               int heads, int pn, int nch) {
  const int e = blockIdx.x * T2 + threadIdx.x;
  if (e >= pn) return;
  const long long bh = static_cast<long long>(blockIdx.z) * heads + blockIdx.y;
  const float* s = states + bh * nch * pn + e;
  const float* d = decay + bh * nch;
  float* out = carried + bh * nch * pn + e;
  float run = 0.f;
#pragma unroll 8
  for (int c = 0; c < nch; ++c) {
    out[static_cast<long long>(c) * pn] = run;
    run = __fmaf_rn(d[c], run, s[static_cast<long long>(c) * pn]);
  }
}

// ------------------------ pass 3, bf16: chunk output on mma -------------------

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(row)));
}

// e^x as 2^(x log2 e) on the SFU (ex2.approx: ~2^-22 relative; results
// under 2^-126 flush to zero), far inside the bf16 route's 2^-16 split
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// With g = lane / 4 and t = lane % 4, an m16n8 accumulator holds (row g,
// columns 2t, 2t + 1) in d[0], d[1] and row g + 8 in d[2], d[3]; the A
// fragment of m16n8k16 holds (row g, k 2t..2t+1), (row g + 8, k 2t..),
// (row g, k 2t+8..), (row g + 8, k 2t+8..); B holds (k 2t..2t+1, col g),
// (k 2t+8.., col g). The carried state's term is accumulated first, on
// FFMA into the same fragments: (C o e^cum) row by row times carried^T,
// kept transposed ([n][p]) in shared memory so each thread reads its two
// columns as one float2.
template <int PP>
__global__ void __launch_bounds__(T3_MMA, PP <= 64 ? 6 : 1)
ssd_chunk_out_mma(const __nv_bfloat16* __restrict__ x, Strides xs, int xvec,
                  const __nv_bfloat16* __restrict__ bm, Strides bs, int bvec,
                  const __nv_bfloat16* __restrict__ cm, Strides cs, int cvec,
                  const float* __restrict__ cum,
                  const float* __restrict__ carried,
                  __nv_bfloat16* __restrict__ y, Strides ys, int ypair,
                  int heads, int L, int p, int n, int np, int chunk, int nch,
                  int qblocks) {
  constexpr int JP = PP / 8;          // n8 tiles of y across P
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char raw[];
  const int RS = np + 8, RX = PP + 8;  // padded bf16 rows: no bank conflicts
  bf16* Cs = reinterpret_cast<bf16*>(raw);   // TS x RS
  bf16* Bs = Cs + TS * RS;                   // [2] TS x RS
  bf16* Xs = Bs + 2 * TS * RS;               // [2] TS x RX
  // carried^T [np][PP + 2]: rows padded so the transposed copies land in
  // distinct banks, and even so each thread reads its pair as a float2
  constexpr int SP = PP + 2;
  float* st = reinterpret_cast<float*>(Xs + 2 * TS * RX);
  float* cq = st + np * SP;                  // TS
  float* ck = cq + TS;                       // [2] TS

  const int h = blockIdx.x % heads, blk = blockIdx.x / heads;   // as pass 1
  const int ci = blk / qblocks, q0 = (blk % qblocks) * TS, b = blockIdx.y;
  const long long l0 = static_cast<long long>(ci) * chunk;
  const int cv = static_cast<int>(L - l0 < chunk ? L - l0 : chunk);
  if (q0 >= cv) return;
  const long long bh = static_cast<long long>(b) * heads + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* xp = x + b * xs.b + h * xs.h + l0 * xs.l;
  const bf16* bp = bm + b * bs.b + h * bs.h + l0 * bs.l;
  const bf16* cp = cm + b * cs.b + h * cs.h + l0 * cs.l;
  const float* cumc = cum + bh * L + l0;
  const int ntiles = q0 / TS + 1;
  auto fetch = [&](int kt) {   // key tile kt into stage kt & 1
    const int s0 = kt * TS, rows = cv - s0 < TS ? cv - s0 : TS;
    const int stage = kt & 1;
    copy_rows(Bs + stage * TS * RS, RS, bp, bs, s0, rows, n, np, bvec,
              T3_MMA);
    copy_rows(Xs + stage * TS * RX, RX, xp, xs, s0, rows, p, PP, xvec,
              T3_MMA);
    copy_cum(ck + stage * TS, cumc + s0, rows, T3_MMA);
  };
  const int qrows = cv - q0 < TS ? cv - q0 : TS;
  copy_rows(Cs, RS, cp, cs, q0, qrows, n, np, cvec, T3_MMA);
  copy_cum(cq, cumc + q0, qrows, T3_MMA);
  const float* cs_src = carried + (bh * nch + ci) * p * n;
  for (int i = tid; i < np * PP; i += T3_MMA) {   // read along n, store [n][p]
    const int pc = i / np, nc = i % np;
    const bool ok = pc < p && nc < n;
    cp_async4(&st[nc * SP + pc], ok ? cs_src + pc * n + nc : cs_src, ok);
  }
  fetch(0);
  cp_async_commit();

  const int rw = warp * 16;            // the warp's first row in the block
  const int row[2] = {q0 + rw + g, q0 + rw + g + 8};   // chunk-relative
  float acc[JP][4];
#pragma unroll
  for (int j = 0; j < JP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();   // key tile kt (and C, cq, the carried state) here
    if (kt + 1 < ntiles) fetch(kt + 1);   // into the stage read at kt - 1
    cp_async_commit();
    if (kt == 0) {     // acc = (C o e^cum) carried^T, rows past cv unused
      float seg[2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        seg[half] = row[half] < cv ? expf(cq[row[half] - q0]) : 0.f;
      for (int nc = 0; nc < n; ++nc) {
        const float c0 = __bfloat162float(Cs[(rw + g) * RS + nc]) * seg[0];
        const float c1 = __bfloat162float(Cs[(rw + g + 8) * RS + nc]) * seg[1];
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const float2 sv =
              *reinterpret_cast<const float2*>(&st[nc * SP + j * 8 + 2 * t]);
          acc[j][0] = __fmaf_rn(c0, sv.x, acc[j][0]);
          acc[j][1] = __fmaf_rn(c0, sv.y, acc[j][1]);
          acc[j][2] = __fmaf_rn(c1, sv.x, acc[j][2]);
          acc[j][3] = __fmaf_rn(c1, sv.y, acc[j][3]);
        }
      }
    }
    const bf16* Bt = Bs + (kt & 1) * TS * RS;
    const bf16* Xt = Xs + (kt & 1) * TS * RX;
    const float* ckt = ck + (kt & 1) * TS;
    const int s0 = kt * TS;
    // 16-key slices; on the diagonal tile the slices past the warp's rows
    // are all masked
    const int last = s0 == q0 ? warp : TS / 16 - 1;
    for (int kk = 0; kk <= last; ++kk) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int e0 = 0; e0 < np; e0 += 16) {
        uint32_t af[4];
        af[0] = ld_u32(&Cs[(rw + g) * RS + e0 + 2 * t]);
        af[1] = ld_u32(&Cs[(rw + g + 8) * RS + e0 + 2 * t]);
        af[2] = ld_u32(&Cs[(rw + g) * RS + e0 + 2 * t + 8]);
        af[3] = ld_u32(&Cs[(rw + g + 8) * RS + e0 + 2 * t + 8]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const bf16* br = &Bt[(kk * 16 + jj * 8 + g) * RS + e0 + 2 * t];
          mma_bf16(sc[jj], af, ld_u32(br), ld_u32(br + 8));
        }
      }
      // mask before the exp, decay in f32, split into bf16 hi + lo
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row[half];
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = s0 + kk * 16 + jj * 8 + 2 * t + e;
            v[e] = s <= r && r < cv
                       ? sc[jj][2 * half + e] *
                             ex2((cq[r - q0] - ckt[s - s0]) * kLog2e)
                       : 0.f;
          }
          const int f = 2 * jj + half;
          hi[f] = hopper::pack_bf16(v[0], v[1]);
          lo[f] = hopper::pack_bf16(v[0] - __uint_as_float(hi[f] << 16),
                                    v[1] - __uint_as_float(hi[f] & 0xffff0000u));
        }
      // y += P x over the slice: B fragments of two n8 tiles per ldmatrix
#pragma unroll
      for (int j = 0; j < JP; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &Xt[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                      * RX + (j + (lane >> 4)) * 8]);
        mma_bf16(acc[j], hi, bf[0], bf[1]);
        mma_bf16(acc[j], lo, bf[0], bf[1]);
        mma_bf16(acc[j + 1], hi, bf[2], bf[3]);
        mma_bf16(acc[j + 1], lo, bf[2], bf[3]);
      }
    }
  }

  bf16* yp = y + b * ys.b + h * ys.h + l0 * ys.l;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row[half];
    if (r >= cv) continue;
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int pc = j * 8 + 2 * t;
      if (pc >= p) continue;
      const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
      bf16* dst = yp + r * ys.l + pc * ys.e;
      if (ypair && pc + 1 < p) {
        store_pair(dst, v0, v1);
      } else {
        store(dst, v0);
        if (pc + 1 < p) store(dst + ys.e, v1);
      }
    }
  }
}

// ------------------------ pass 3, f32: chunk output on FFMA -------------------

template <int PP>
__global__ void __launch_bounds__(T3_FFMA)
ssd_chunk_out_ffma(const float* __restrict__ x, Strides xs, int xvec,
                   const float* __restrict__ bm, Strides bs, int bvec,
                   const float* __restrict__ cm, Strides cs, int cvec,
                   const float* __restrict__ cum,
                   const float* __restrict__ carried, float* __restrict__ y,
                   Strides ys, int heads, int L, int p, int n, int chunk,
                   int nch, int qblocks) {
  constexpr int JP = PP / 16;
  extern __shared__ __align__(16) float smem[];
  const int NS = n + 1;
  float* Xs = smem;                 // TS x PP (16-byte aligned rows)
  float* Cs = Xs + TS * PP;         // TS x NS
  float* Bs = Cs + TS * NS;         // TS x NS
  float* Ss = Bs + TS * NS;         // TS x (TS + 1) decayed scores
  float* st = Ss + TS * (TS + 1);   // carried [p][n], PP x NS
  float* cq = st + PP * NS;
  float* ck = cq + TS;

  const int h = blockIdx.x % heads, blk = blockIdx.x / heads;   // as pass 1
  const int ci = blk / qblocks, q0 = (blk % qblocks) * TS, b = blockIdx.y;
  const long long l0 = static_cast<long long>(ci) * chunk;
  const int cv = static_cast<int>(L - l0 < chunk ? L - l0 : chunk);
  if (q0 >= cv) return;
  const long long bh = static_cast<long long>(b) * heads + h;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const float* xp = x + b * xs.b + h * xs.h + l0 * xs.l;
  const float* bp = bm + b * bs.b + h * bs.h + l0 * bs.l;
  const float* cp = cm + b * cs.b + h * cs.h + l0 * cs.l;
  const float* cumc = cum + bh * L + l0;
  const int qrows = cv - q0 < TS ? cv - q0 : TS;
  // rows of n + 1 floats are not 16-byte aligned: 4-byte copies into them
  copy_rows(Cs, NS, cp, cs, q0, qrows, n, n, 0, T3_FFMA);
  copy_cum(cq, cumc + q0, qrows, T3_FFMA);
  const float* cs_src = carried + (bh * nch + ci) * p * n;
  for (int i = tid; i < PP * NS; i += T3_FFMA) {
    const int pc = i / NS, nc = i % NS;
    const bool ok = pc < p && nc < n;
    cp_async4(&st[i], ok ? cs_src + pc * n + nc : cs_src, ok);
  }

  float acc[4][JP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JP; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 <= q0; s0 += TS) {
    const int krows = cv - s0 < TS ? cv - s0 : TS;
    copy_rows(Bs, NS, bp, bs, s0, krows, n, n, 0, T3_FFMA);
    copy_rows(Xs, PP, xp, xs, s0, krows, p, PP, xvec, T3_FFMA);
    copy_cum(ck, cumc + s0, krows, T3_FFMA);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int e = 0; e < n; ++e) {
      float cv4[4], bv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv4[i] = Cs[(ty + 16 * i) * NS + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv4[j] = Bs[(tx + 16 * j) * NS + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = __fmaf_rn(cv4[i], bv4[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        Ss[(ty + 16 * i) * (TS + 1) + tx + 16 * j] =
            s <= r && r < cv
                ? sc[i][j] * expf(cq[r - q0] - ck[s - s0]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < TS; ++s) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * (TS + 1) + s];
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const float xv = Xs[s * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(sv[i], xv, acc[i][j]);
      }
    }
    __syncthreads();   // before the next key tile overwrites Bs / Xs / Ss
  }

  float* yp = y + b * ys.b + h * ys.h + l0 * ys.l;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i, r = q0 + rr;
    if (r >= cv) continue;
    const float seg = expf(cq[rr]);
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int pc = tx + 16 * j;
      if (pc >= p) continue;
      float dot = 0.f;
      for (int e = 0; e < n; ++e)
        dot = __fmaf_rn(Cs[rr * NS + e] * seg, st[pc * NS + e], dot);
      yp[r * ys.l + pc * ys.e] = acc[i][j] + dot;
    }
  }
}

// ---------------------------------- launches ----------------------------------

struct Args {
  const void *x, *bm, *cm;
  Strides xs, as, bs, cs, ys;
  int xvec, bvec, cvec, ypair;
  const float* a;
  void* y;
  float *cum, *states, *decay, *carried;
  int batch, heads, L, p, n, chunk;
};

template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int K>
cudaError_t pass1(const Args& g, int pp, int np, int nch, cudaStream_t s) {
  const long long bytes = smem_pass1(pp, np, g.chunk, sizeof(T));
  auto kernel = ssd_chunk_state<T, K>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nch * g.heads, g.batch), T1, bytes, s>>>(
      static_cast<const T*>(g.x), g.xs, g.xvec, g.a, g.as,
      static_cast<const T*>(g.bm), g.bs, g.bvec, g.cum, g.states, g.decay,
      g.heads, g.L, g.p, g.n, pp, np, g.chunk, nch);
  return cudaGetLastError();
}

template <int PP>
cudaError_t pass3(const Args& g, int kbf16, int np, int nch, int qb,
                  cudaStream_t s) {
  const dim3 grid(nch * qb * g.heads, g.batch);
  if (kbf16) {
    const long long bytes = smem_pass3_mma(PP, np);
    auto kernel = ssd_chunk_out_mma<PP>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    using B = __nv_bfloat16;
    kernel<<<grid, T3_MMA, bytes, s>>>(
        static_cast<const B*>(g.x), g.xs, g.xvec, static_cast<const B*>(g.bm),
        g.bs, g.bvec, static_cast<const B*>(g.cm), g.cs, g.cvec, g.cum,
        g.carried, static_cast<B*>(g.y), g.ys, g.ypair, g.heads, g.L, g.p,
        g.n, np, g.chunk, nch, qb);
  } else {
    const long long bytes = smem_pass3_ffma(PP, g.n);
    auto kernel = ssd_chunk_out_ffma<PP>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, T3_FFMA, bytes, s>>>(
        static_cast<const float*>(g.x), g.xs, g.xvec,
        static_cast<const float*>(g.bm), g.bs, g.bvec,
        static_cast<const float*>(g.cm), g.cs, g.cvec, g.cum, g.carried,
        static_cast<float*>(g.y), g.ys, g.heads, g.L, g.p, g.n, g.chunk, nch,
        qb);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& g, cudaStream_t s) {
  const int pp = pad_pow2(g.p), np = pad_pow2(g.n);
  const int nch = static_cast<int>((g.L + g.chunk - 1) / g.chunk);
  const int qb = (g.chunk + TS - 1) / TS;
  const int tiles = (pp / 8) * (np / 4);
  cudaError_t err = tiles <= T1 ? pass1<T, 1>(g, pp, np, nch, s)
                                : pass1<T, 2>(g, pp, np, nch, s);
  if (err != cudaSuccess) return err;
  const int pn = g.p * g.n;
  ssd_state_pass<<<dim3((pn + T2 - 1) / T2, g.heads, g.batch), T2, 0, s>>>(
      g.states, g.decay, g.carried, g.heads, pn, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kbf16 = sizeof(T) == 2;
  switch (pp) {
    case 16: return pass3<16>(g, kbf16, np, nch, qb, s);
    case 32: return pass3<32>(g, kbf16, np, nch, qb, s);
    case 64: return pass3<64>(g, kbf16, np, nch, qb, s);
    case 128: return pass3<128>(g, kbf16, np, nch, qb, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// Dynamic shared memory (bytes) of pass 1, 2 or 3 for dtype, head dim p,
// state n and chunk; 0 when p or n exceeds 128. kernels/ssd_scan.py's
// ssd_scan_plan computes the same numbers.
extern "C" long long repro_ssd_scan_smem_bytes(int dtype, int p, int n,
                                               int chunk, int pass) {
  using namespace repro;
  const int pp = pad_pow2(p), np = pad_pow2(n);
  if (pp == 0 || np == 0) return 0;
  if (pass == 1) return smem_pass1(pp, np, chunk, dtype == kBF16 ? 2 : 4);
  if (pass == 3)
    return dtype == kBF16 ? smem_pass3_mma(pp, np) : smem_pass3_ffma(pp, n);
  return 0;
}

// y[b, l, h, :] of the chunked SSD scan over x (b, l, h, p), a_log
// (b, l, h) float32 and B / C (b, l, h, n), every operand through its
// (batch, seq, head, element) strides in elements; x, B, C and y share the
// dtype. *vec says the operand's rows are read as 16-byte vectors, ypair
// that y takes two-element stores. cum (batch, heads, L), states and
// carried (batch, heads, chunks, p, n) and decay (batch, heads, chunks)
// are float32 scratch. Returns the cudaError_t of the three launches.
extern "C" int repro_ssd_scan(
    int dtype, const void* x, long long xb, long long xl, long long xh,
    long long xe, int xvec, const void* a, long long ab, long long al,
    long long ah, const void* bm, long long bb, long long bl, long long bh,
    long long be, int bvec, const void* cm, long long cb, long long cl,
    long long ch, long long ce, int cvec, void* y, long long yb,
    long long yl, long long yh, long long ye, int ypair, int batch,
    int heads, int L, int p, int n, int chunk, void* cum, void* states,
    void* decay, void* carried, void* stream) {
  using namespace repro;
  Args g{x, bm, cm, {xb, xl, xh, xe}, {ab, al, ah, 1}, {bb, bl, bh, be},
         {cb, cl, ch, ce}, {yb, yl, yh, ye}, xvec, bvec, cvec, ypair,
         static_cast<const float*>(a), y, static_cast<float*>(cum),
         static_cast<float*>(states), static_cast<float*>(decay),
         static_cast<float*>(carried), batch, heads, L, p, n, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || L < 1 || pad_pow2(p) == 0 || pad_pow2(n) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) return static_cast<int>(run<float>(g, s));
  if (dtype == kBF16) return static_cast<int>(run<__nv_bfloat16>(g, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
