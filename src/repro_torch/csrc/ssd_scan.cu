// Mamba-2 chunked SSD scan for repro_torch.kernels.ssd_scan (B6).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). On the TPU the chunk axis is the sequential grid
// dimension and the f32 (P, N) state is VMEM scratch carried across it.
// Here one CTA owns one (batch, head) and walks the chunks in order itself,
// with the f32 state in shared memory. Per chunk of c steps:
//
//   cum = prefix-sum(a_log)                         (one warp, f32)
//   y   = ((C B^T) o L) x + (C o e^cum) state^T,    L[t, s] = e^(cum_t - cum_s), t >= s
//   state <- e^(cum_last) state + x^T (B o e^(cum_last - cum))
//
// Only the t >= s terms are computed (query tiles walk key tiles at or
// below the diagonal, and the mask is applied before the exp), so no exp
// of a positive difference ever happens. The c x c score block of a
// 256-step chunk (256 KB in f32) does not fit the 227 KB of shared memory,
// so it is tiled by 64 query rows x 64 key rows; each thread holds a 4 x
// (P/16) tile of y in registers. The state term and the state update read
// the state from shared memory after every query tile of the chunk is done.
//
// A ragged last chunk is cut to the valid length: the reference pads L
// with a_log = 0 and zero x / B / C, which adds exact zeros and leaves the
// state's decay unchanged, so the cut chunk computes the same thing.
// Operands are read through their (batch, seq, head, ...) strides, so both
// the model layout and the kernel layout of repro.kernels.ops.ssd are read
// without a copy.
//
// Bound: bytes at the hymba prefill shape (x 2x50x4096x64, N = 16, chunk
// 256, bf16). x, B, C and y cross HBM once in bf16 and a_log once in f32,
// 133 MB or 0.040 ms at 3.35 TB/s; the t >= s within-chunk products and
// the state terms are ~1e10 flops, 0.010 ms at the bf16 tensor-core peak
// (989 TFLOP/s) that prices bf16 inputs. This first kernel runs them on
// the FP32 FFMA pipes, so it sits well above that bound. B x H CTAs are
// 100 for the hymba prefill at batch 2, under one wave of 132 SMs; a
// chunk-parallel two-pass design (states first, then every chunk at once)
// is later work.
#include "common.cuh"

#include <math.h>

namespace repro {
namespace {

constexpr int TT = 64, THREADS = 256;   // query / key tile rows

struct Strides {
  long long b, l, h, e;   // batch, seq, head, element (P or N)
};

// shared floats for a chunk of c, head dim padded to PP, state N
__host__ __device__ inline long long smem_floats(int pp, int n, int c) {
  return static_cast<long long>(c)        // cum
         + 2LL * TT * (n + 1)             // C tile, B tile
         + 1LL * TT * pp                  // x tile
         + 1LL * TT * (TT + 1)            // score tile
         + 1LL * pp * (n + 1)             // state
         + TT;                            // per-row decays of the update
}

template <typename T, int PP>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, Strides xs, const float* __restrict__ a,
           Strides as, const T* __restrict__ bm, Strides bs,
           const T* __restrict__ cm, Strides cs, T* __restrict__ y,
           Strides ys, int L, int p, int n, int chunk) {
  constexpr int JP = PP / 16;
  extern __shared__ float smem[];
  const int NS = n + 1;
  float* cum = smem;
  float* Cs = cum + chunk;
  float* Bs = Cs + TT * NS;
  float* Xs = Bs + TT * NS;
  float* Ss = Xs + TT * PP;
  float* st = Ss + TT * (TT + 1);
  float* w = st + PP * NS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* xp = x + b * xs.b + h * xs.h;
  const float* ap = a + b * as.b + h * as.h;
  const T* bp = bm + b * bs.b + h * bs.h;
  const T* cp = cm + b * cs.b + h * cs.h;
  T* yp = y + b * ys.b + h * ys.h;

  for (int i = tid; i < PP * NS; i += THREADS) st[i] = 0.f;

  // rows [r0, r0 + TT) of B (or C) and x into their tiles, zero past cv
  auto load_rows = [&](float* dst, const T* src, const Strides& s, int cols,
                       int stride, long long l0, int r0, int cv) {
    for (int idx = tid; idx < TT * cols; idx += THREADS) {
      const int r = idx / cols, e = idx % cols;
      dst[r * stride + e] =
          r0 + r < cv ? to_acc(src[(l0 + r0 + r) * s.l + e * s.e]) : 0.f;
    }
  };

  for (long long l0 = 0; l0 < L; l0 += chunk) {
    const int cv = static_cast<int>(L - l0 < chunk ? L - l0 : chunk);
    __syncthreads();   // the last chunk's readers of cum / tiles are done
    for (int i = tid; i < cv; i += THREADS) cum[i] = ap[(l0 + i) * as.l];
    __syncthreads();
    if (warp == 0) {   // inclusive prefix sum: lane segments, then a scan
      const int per = (cv + 31) / 32, beg = lane * per;
      const int end = beg + per < cv ? beg + per : cv;
      float run = 0.f;
      for (int i = beg; i < end; ++i) {
        run += cum[i];
        cum[i] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float excl = tot - run;
      for (int i = beg; i < end; ++i) cum[i] += excl;
    }
    __syncthreads();

    for (int t0 = 0; t0 < cv; t0 += TT) {
      load_rows(Cs, cp, cs, n, NS, l0, t0, cv);
      float acc[4][JP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JP; ++j) acc[i][j] = 0.f;

      for (int s0 = 0; s0 <= t0; s0 += TT) {
        load_rows(Bs, bp, bs, n, NS, l0, s0, cv);
        load_rows(Xs, xp, xs, p, PP, l0, s0, cv);   // columns >= p unused
        __syncthreads();
        // scores (C B^T) o L on the 64 x 64 tile, masked before the exp
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
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            Ss[(ty + 16 * i) * (TT + 1) + tx + 16 * j] =
                (t >= s && t < cv) ? sc[i][j] * expf(cum[t] - cum[s]) : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < TT; ++s) {
          float sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * (TT + 1) + s];
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const float xv = Xs[s * PP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(sv[i], xv, acc[i][j]);
          }
        }
        __syncthreads();   // before the next key tile overwrites Bs / Xs
      }

      // the carried state's contribution, then the store
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, t = t0 + r;
        if (t >= cv) continue;
        const float seg = expf(cum[t]);
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int pc = tx + 16 * j;
          if (pc >= p) continue;
          float dot = 0.f;
          for (int e = 0; e < n; ++e)
            dot = __fmaf_rn(Cs[r * NS + e], st[pc * NS + e], dot);
          store(&yp[(l0 + t) * ys.l + pc * ys.e], acc[i][j] + seg * dot);
        }
      }
      __syncthreads();   // before the next query tile overwrites Cs
    }

    // state <- e^(cum_last) state + x^T (B o e^(cum_last - cum))
    const float cl = cum[cv - 1];
    const float decay = expf(cl);
    for (int i = tid; i < p * n; i += THREADS) st[(i / n) * NS + i % n] *= decay;
    for (int s0 = 0; s0 < cv; s0 += TT) {
      __syncthreads();
      load_rows(Bs, bp, bs, n, NS, l0, s0, cv);
      load_rows(Xs, xp, xs, p, PP, l0, s0, cv);
      if (tid < TT) w[tid] = s0 + tid < cv ? expf(cl - cum[s0 + tid]) : 0.f;
      __syncthreads();
      for (int i = tid; i < p * n; i += THREADS) {
        const int pc = i / n, e = i % n;
        float upd = 0.f;
        for (int s = 0; s < TT; ++s)
          upd = __fmaf_rn(Xs[s * PP + pc], Bs[s * NS + e] * w[s], upd);
        st[pc * NS + e] += upd;
      }
    }
  }
}

template <typename T, int PP>
int launch(const void* x, Strides xs, const float* a, Strides as,
           const void* bm, Strides bs, const void* cm, Strides cs, void* y,
           Strides ys, int batch, int heads, int L, int p, int n, int chunk,
           cudaStream_t stream) {
  const long long bytes = smem_floats(PP, n, chunk) * sizeof(float);
  auto kernel = ssd_kernel<T, PP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), xs, a, as, static_cast<const T*>(bm), bs,
      static_cast<const T*>(cm), cs, static_cast<T*>(y), ys, L, p, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

inline int padded_p(int p) {
  return p <= 16 ? 16 : p <= 32 ? 32 : p <= 64 ? 64 : p <= 128 ? 128 : 0;
}

template <typename T>
int dispatch_p(const void* x, Strides xs, const float* a, Strides as,
               const void* bm, Strides bs, const void* cm, Strides cs,
               void* y, Strides ys, int batch, int heads, int L, int p, int n,
               int chunk, cudaStream_t s) {
  switch (padded_p(p)) {
    case 16: return launch<T, 16>(x, xs, a, as, bm, bs, cm, cs, y, ys, batch,
                                  heads, L, p, n, chunk, s);
    case 32: return launch<T, 32>(x, xs, a, as, bm, bs, cm, cs, y, ys, batch,
                                  heads, L, p, n, chunk, s);
    case 64: return launch<T, 64>(x, xs, a, as, bm, bs, cm, cs, y, ys, batch,
                                  heads, L, p, n, chunk, s);
    case 128: return launch<T, 128>(x, xs, a, as, bm, bs, cm, cs, y, ys,
                                    batch, heads, L, p, n, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// Dynamic shared memory of one CTA (bytes) for head dim p, state n and
// chunk c; 0 when p > 128.
extern "C" long long repro_ssd_scan_smem_bytes(int p, int n, int chunk) {
  const int pp = repro::padded_p(p);
  return pp == 0 ? 0 : repro::smem_floats(pp, n, chunk) * sizeof(float);
}

// y[b, l, h, :] of the chunked SSD scan over x (b, l, h, p), a_log
// (b, l, h) float32 and B / C (b, l, h, n), every operand through its
// (batch, seq, head, element) strides in elements; x, B, C and y share the
// dtype. Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan(
    int dtype, const void* x, long long xb, long long xl, long long xh,
    long long xe, const void* a, long long ab, long long al, long long ah,
    const void* bm, long long bb, long long bl, long long bh, long long be,
    const void* cm, long long cb, long long cl, long long ch, long long ce,
    void* y, long long yb, long long yl, long long yh, long long ye,
    int batch, int heads, int L, int p, int n, int chunk, void* stream) {
  using repro::Strides;
  const Strides xs{xb, xl, xh, xe}, as{ab, al, ah, 1}, bs{bb, bl, bh, be},
      cs{cb, cl, ch, ce}, ys{yb, yl, yh, ye};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  if (chunk < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kF32)
    return repro::dispatch_p<float>(x, xs, af, as, bm, bs, cm, cs, y, ys,
                                    batch, heads, L, p, n, chunk, s);
  if (dtype == repro::kBF16)
    return repro::dispatch_p<__nv_bfloat16>(x, xs, af, as, bm, bs, cm, cs, y,
                                            ys, batch, heads, L, p, n, chunk,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}
