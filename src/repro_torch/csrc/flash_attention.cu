// Streaming-softmax attention for repro_torch.kernels.flash_attention (B5).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::attention
// (_attn_kernel). On the TPU the KV axis is the innermost, sequential grid
// dimension and the f32 running (m, l, acc) live in VMEM scratch across
// its steps. Here one CTA owns one (batch, query head, query block) and
// walks the KV blocks itself, staging each in shared memory, so CTAs are
// independent and run in any order. GQA maps query head h to KV head
// h / (Hq / Hkv), which need not be a power of two (hymba: 25 over 5).
//
// Two variants, which the wrapper picks from dtype, head dim and layout
// alone (kernels/flash_attention.py::attention_variant):
//
// - "wgmma" (bf16, head dim <= 128 a multiple of 8, operands TMA can read):
//   the tensor cores, described above attn_tc_kernel below. The model paths
//   (hymba D = 64, the zoo's D = 128) take it.
// - "ffma" (f32, D up to 256, and any strides): one CTA per (batch, query
//   head, 64-row query block), K / V staged in shared memory as f32; per KV
//   block S = Q K^T on FFMA (a 4 x (BK/16) register tile per thread), the
//   causal / window / kv_len mask, the online-softmax rescale through a
//   shared-memory score block (one warp per 8 rows), and acc = alpha * acc
//   + P V with the 64 x D f32 accumulator in registers. The bf16 tensor
//   cores cannot take f32 without TF32, which the reference tolerance rules
//   out.
//
// Both read the operands through their (batch, head, seq, dim) strides, so
// the model's moveaxis views need no copy, and divide each row by its l at
// the end (0 where l = 0), storing in q's dtype.
//
// KV blocks that the masks cover entirely for the whole query block are
// skipped: the loop runs only over [max(0, q_min - window + 1), min(kv_len,
// q_max + 1)) (causal), which on the windowed layers of a 4096-token
// prefill with window 1024 leaves about 45 % of the causal triangle.
//
// A row with no unmasked key at all gets 0, as repro.kernels.ref.attention
// gives it; the Pallas kernel and ref.blocked_attention score masked keys
// as -1e30 instead and so return the mean of the first block's values for
// such a row. No row of the model paths is fully masked.
//
// Bound: operations. At the prefill shape (q 2x25x4096x64, k/v 2x5x4096x64
// bf16) the live part of QK^T and PV is ~1e11 flops against ~80 MB moved,
// so the bf16 tensor-core peak (989 TFLOP/s) prices the bound.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace repro {
namespace {

constexpr int BQ = 64, THREADS = 256;

template <int DP>
struct Tile {
  static constexpr int BK = DP > 128 ? 32 : 64;   // keys per staged block
  static constexpr int QS = DP + 1;               // padded row strides
  static constexpr int KS = DP + 1;
  static constexpr int SS = BK + 1;
  static constexpr int FLOATS = BQ * QS + BK * KS + BK * DP + BQ * SS + 3 * BQ;
};

struct Strides {
  long long b, h, s, d;
};

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k,
            Strides ks, const T* __restrict__ v, Strides vs,
            T* __restrict__ o, Strides os, int group, int sq, int sk, int d,
            float scale, int causal, long long q_offset, long long window,
            int kv_len) {
  using TL = Tile<DP>;
  constexpr int BK = TL::BK, JS = BK / 16, JD = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * TL::QS;
  float* Vs = Ks + BK * TL::KS;
  float* Ss = Vs + BK * DP;
  float* row_m = Ss + BQ * TL::SS;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    Qs[r * TL::QS + c] =
        (q0 + r < sq && c < d) ? to_acc(qp[(q0 + r) * qs.s + c * qs.d]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  // the live key range of this query block
  const int q_last = (q0 + BQ < sq ? q0 + BQ : sq) - 1;
  const long long qmin = q_offset + q0, qmax = q_offset + q_last;
  long long kend = kv_len;
  if (causal && qmax + 1 < kend) kend = qmax + 1;
  long long kbeg = 0;
  if (window >= 0 && qmin - window + 1 > 0) kbeg = qmin - window + 1;

  for (long long k0 = (kbeg / BK) * BK; k0 < kend; k0 += BK) {
    __syncthreads();   // the last block's readers of Ks / Vs / Ss are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP;
      const long long kr = k0 + r;
      const bool in = kr < sk && c < d;
      Ks[r * TL::KS + c] = in ? to_acc(kp[kr * ks.s + c * ks.d]) : 0.f;
      Vs[r * DP + c] = in ? to_acc(vp[kr * vs.s + c * vs.d]) : 0.f;
    }
    __syncthreads();

    float s[4][JS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qv[4], kv[JS];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * TL::QS + c];
#pragma unroll
      for (int j = 0; j < JS; ++j) kv[j] = Ks[(tx + 16 * j) * TL::KS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JS; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int c = tx + 16 * j;
        const long long kpos = k0 + c;
        bool ok = kpos < kv_len && q0 + r < sq;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && qpos - kpos < window;
        Ss[r * TL::SS + c] = ok ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows [w * BQ/8, (w+1) * BQ/8)
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* srow = Ss + r * TL::SS;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {         // nothing unmasked yet in this row
        for (int c = lane; c < BK; c += 32) srow[c] = 0.f;
      } else {
        alpha = expf(m_prev - m_new);   // 0 when m_prev is -inf
        for (int c = lane; c < BK; c += 32) {
          const float sv = srow[c];
          const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
          srow[c] = p;
          sum += p;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * TL::SS + c];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const float vv = Vs[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

  T* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = row_l[r];
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(&op[(q0 + r) * os.s + c * os.d], l > 0.f ? acc[i][j] / l : 0.f);
    }
  }
}

template <int DP>
constexpr int smem_bytes() {
  return Tile<DP>::FLOATS * static_cast<int>(sizeof(float));
}

template <typename T, int DP>
int launch(const void* q, Strides qs, const void* k, Strides ks,
           const void* v, Strides vs, void* o, Strides os, int b, int hq,
           int hkv, int sq, int sk, int d, float scale, int causal,
           long long q_offset, long long window, int kv_len,
           cudaStream_t stream) {
  auto kernel = attn_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<DP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kernel<<<grid, THREADS, smem_bytes<DP>(), stream>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks,
      static_cast<const T*>(v), vs, static_cast<T*>(o), os, hq / hkv, sq, sk,
      d, scale, causal, q_offset, window, kv_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, Strides qs, const void* k, Strides ks,
               const void* v, Strides vs, void* o, Strides os, int b, int hq,
               int hkv, int sq, int sk, int d, float scale, int causal,
               long long q_offset, long long window, int kv_len,
               cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(q, qs, k, ks, v, vs, o, os, b, hq, hkv, sq, sk, d,
                         scale, causal, q_offset, window, kv_len, s);
  if (d <= 64)
    return launch<T, 64>(q, qs, k, ks, v, vs, o, os, b, hq, hkv, sq, sk, d,
                         scale, causal, q_offset, window, kv_len, s);
  if (d <= 128)
    return launch<T, 128>(q, qs, k, ks, v, vs, o, os, b, hq, hkv, sq, sk, d,
                          scale, causal, q_offset, window, kv_len, s);
  if (d <= 256)
    return launch<T, 256>(q, qs, k, ks, v, vs, o, os, b, hq, hkv, sq, sk, d,
                          scale, causal, q_offset, window, kv_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------- "wgmma": bf16 on the tensor cores --------------------
//
// One CTA owns 128 query rows of one (batch, query head): two consumer
// warpgroups of 64 rows each and one producer warp. The producer loads the
// Q tile once and streams K / V tiles of 128 keys through a 3-stage ring by
// TMA (4-D tensor maps over the operands' own strides, 128-byte swizzle,
// zero fill past the ends), each stage tracked by a full / empty mbarrier
// pair. Per KV tile a consumer runs S = Q K^T as wgmma m64n128k16 (Q and K
// K-major in shared memory), masks S in registers (only on tiles that cross
// the causal diagonal, the window edge or kv_len), runs the online softmax
// on the accumulator fragment (row max and sum over the four lanes that
// share a row, by shuffles), splits P in registers into bf16 hi + lo parts,
// the A operands of O += P_hi V + P_lo V (wgmma m64nDk16, V MN-major through
// the transpose bit), and keeps O, m and l in registers. The reference
// multiplies P in f32; the split keeps P to ~2^-17 relative, where rounding
// it once to bf16 (2^-9 per term, the same order as the output's own bf16
// step) fails the elementwise check on the 1500-key windowed case.

namespace tc {
constexpr int BQ = 128, BKV = 128, STAGES = 3, CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;
template <int DP>
struct Layout {
  static constexpr int CH = DP / 64;                  // 64-wide head-dim chunks
  static constexpr int Q_BYTES = CH * BQ * 128;       // [CH][BQ][64] bf16
  static constexpr int KV_BYTES = CH * BKV * 128;     // [CH][BKV][64], K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;    // K, then V
  static constexpr int SMEM =
      Q_BYTES + STAGES * STAGE_BYTES + (1 + 2 * STAGES) * 8 + 1024;
};
// which coordinate of a tensor map holds the sequence, head and batch axes
struct Pos {
  int s, h, b;
};
}  // namespace tc

__device__ __forceinline__ int coord(int slot, tc::Pos p, int s, int h, int b) {
  return slot == p.s ? s : slot == p.h ? h : b;
}

__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map,
                                          tc::Pos p, uint64_t* bar, int ch,
                                          int s, int h, int b) {
  hopper::tma_load_4d(dst, map, bar, 64 * ch, coord(1, p, s, h, b),
                      coord(2, p, s, h, b), coord(3, p, s, h, b));
}

template <int DP>
__device__ __forceinline__ void pv_wgmma(float* o, const uint32_t* a,
                                         uint64_t desc) {
  if constexpr (DP == 64)
    hopper::wgmma_m64n64k16_rs<1>(o, a, desc);
  else
    hopper::wgmma_m64n128k16_rs<1>(o, a, desc);
}

template <int DP>
__global__ void __launch_bounds__(tc::THREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, tc::Pos pq,
               tc::Pos pk, tc::Pos pv, __nv_bfloat16* __restrict__ o,
               Strides os, int nb, int hq, int group, int sq, int d,
               float scale, int causal, long long q_offset, long long window,
               int kv_len) {
  using namespace hopper;
  using L = tc::Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* kvs = smem + L::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kvs + tc::STAGES * L::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + tc::STAGES;

  // the slowest-varying index is the query block, longest (last) first
  const int per = hq * nb, nqb = (sq + tc::BQ - 1) / tc::BQ;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * tc::BQ;
  const int h = (blockIdx.x % per) % hq, b = (blockIdx.x % per) / hq;
  const int hk = h / group;
  // the live key tiles of this query block
  const long long qmin = q_offset + q0, qmax = q_offset + min(q0 + tc::BQ, sq) - 1;
  long long kend = kv_len;
  if (causal && qmax + 1 < kend) kend = qmax + 1;
  long long kbeg = 0;
  if (window >= 0 && qmin - window + 1 > 0) kbeg = qmin - window + 1;
  const int kt0 = static_cast<int>(kbeg / tc::BKV);
  const int nkt = kend > kbeg ? static_cast<int>((kend + tc::BKV - 1) / tc::BKV) - kt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < tc::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], tc::CONSUMERS * 4);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == tc::CONSUMERS) {                     // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < L::CH; ++ch)
        load_tile(qs + ch * tc::BQ * 128, &map_q, pq, qbar, ch, q0, h, b);
      for (int t = 0; t < nkt; ++t) {
        const int s = t % tc::STAGES;
        mbar_wait(&empty[s], ((t / tc::STAGES) & 1) ^ 1);
        uint8_t* st = kvs + s * L::STAGE_BYTES;
        const int k0 = (kt0 + t) * tc::BKV;
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
#pragma unroll
        for (int ch = 0; ch < L::CH; ++ch) {
          load_tile(st + ch * tc::BKV * 128, &map_k, pk, &full[s], ch, k0, hk, b);
          load_tile(st + L::KV_BYTES + ch * tc::BKV * 128, &map_v, pv, &full[s],
                    ch, k0, hk, b);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // fragment of a 64-row accumulator: register i of this lane holds row
  // 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  const long long wq_min = q_offset + q0 + wg * 64, wq_max = wq_min + 63;
  const long long qrow = wq_min + warp * 16 + lane / 4;
  const float sl2 = scale * 1.4426950408889634f;   // exp(x) = 2^(x log2 e)
  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const uint8_t* qw = qs + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int t = 0; t < nkt; ++t) {
    const int s = t % tc::STAGES;
    mbar_wait(&full[s], (t / tc::STAGES) & 1);
    const uint8_t* ks = kvs + s * L::STAGE_BYTES;
    const uint8_t* vs = ks + L::KV_BYTES;
    float sacc[tc::BKV / 2];
#pragma unroll
    for (int i = 0; i < tc::BKV / 2; ++i) {
      sacc[i] = 0.f;
      fence_operand(sacc[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n128k16_ss<0, 0>(
          sacc,
          desc_sw128(qw + (kk / 4) * tc::BQ * 128 + 32 * (kk % 4), 16, 1024),
          desc_sw128(ks + (kk / 4) * tc::BKV * 128 + 32 * (kk % 4), 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < tc::BKV / 2; ++i) fence_operand(sacc[i]);

    const long long k0 = static_cast<long long>(kt0 + t) * tc::BKV;
    const bool edge = k0 + tc::BKV > kv_len ||
                      (causal && k0 + tc::BKV - 1 > wq_min) ||
                      (window >= 0 && k0 <= wq_max - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < tc::BKV / 2; ++i) {
        const long long kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const long long qpos = qrow + 8 * ((i / 2) % 2);
        bool ok = kpos < kv_len;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && qpos - kpos < window;
        if (!ok) sacc[i] = -INFINITY;
      }
    }
    // online softmax on the two rows this lane holds
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < tc::BKV / 2; ++i)
        if ((i / 2) % 2 == r) mx = fmaxf(mx, sacc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m_r[r] - m_use) * sl2);   // 0 from -inf
      const float shift = -m_use * sl2;
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < tc::BKV / 2; ++i)
        if ((i / 2) % 2 == r) {
          sacc[i] = exp2f(fmaf(sacc[i], sl2, shift));
          sum += sacc[i];
        }
      l_r[r] = l_r[r] * alpha + sum;         // this lane's part of the row
#pragma unroll
      for (int i = 0; i < DP / 2; ++i)
        if ((i / 2) % 2 == r) oacc[i] *= alpha;
    }
    // P = hi + lo as two sets of bf16 A fragments of O += P V (16 keys per
    // wgmma): the two products keep P to ~2^-17 where one bf16 rounding
    // (2^-9) would move the output by up to a bf16 step on its own
    uint32_t hi[tc::BKV / 16][4], lo[tc::BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < tc::BKV / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = sacc[8 * kk + 2 * e], x1 = sacc[8 * kk + 2 * e + 1];
        hi[kk][e] = pack_bf16(x0, x1);
        lo[kk][e] = pack_bf16(x0 - __uint_as_float(hi[kk][e] << 16),
                              x1 - __uint_as_float(hi[kk][e] & 0xffff0000u));
      }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(oacc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < tc::BKV / 16; ++kk) {
      const uint64_t dv = desc_sw128(vs + 2048 * kk, tc::BKV * 128, 1024);
      pv_wgmma<DP>(oacc, hi[kk], dv);
      pv_wgmma<DP>(oacc, lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(oacc[i]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* op = o + b * os.b + h * os.h;
  const bool pairs = os.d == 1 && os.s % 2 == 0 && os.h % 2 == 0 &&
                     os.b % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= d) continue;
      const float v0 = l > 0.f ? oacc[4 * j + 2 * r] / l : 0.f;
      const float v1 = l > 0.f ? oacc[4 * j + 2 * r + 1] / l : 0.f;
      __nv_bfloat16* p = op + row * os.s + col * os.d;
      if (pairs && col + 1 < d) {
        store_pair(p, v0, v1);
      } else {
        store(p, v0);
        if (col + 1 < d) store(p + os.d, v1);
      }
    }
  }
}

// a 4-D tensor map over a (batch, head, seq, dim) bf16 operand read through
// its strides (elements): dim first, then the other three axes by rising
// stride (axes of extent 1 last, packed), boxes of 64 dims x `rows`
int attn_map(CUtensorMap* map, tc::Pos* pos, const void* base, Strides st,
             int nb, int nh, int ns, int d, int rows) {
  struct Axis {
    long long size, stride;
    int which;                                   // 0 seq, 1 head, 2 batch
  } ax[3] = {{ns, st.s, 0}, {nh, st.h, 1}, {nb, st.b, 2}};
  auto before = [](const Axis& x, const Axis& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  };
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (before(ax[j + 1], ax[j])) {
        const Axis tmp = ax[j];
        ax[j] = ax[j + 1];
        ax[j + 1] = tmp;
      }
  cuuint64_t dims[4] = {cuuint64_t(d), 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint64_t packed = (cuuint64_t(d) * 2 + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = cuuint64_t(ax[i].size);
    strides[i] = ax[i].size == 1 ? packed : cuuint64_t(ax[i].stride) * 2;
    packed = strides[i] * dims[i + 1];
    if (ax[i].which == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
    (ax[i].which == 0 ? pos->s : ax[i].which == 1 ? pos->h : pos->b) = i + 1;
  }
  return hopper::make_map(map, base, 4, dims, strides, box);
}

// may the tensor-core variant read this operand? (TMA: unit dim stride,
// 16-byte aligned base and strides on every axis longer than 1)
bool tma_ok(const void* p, Strides st, int nb, int nh, int ns) {
  auto ok = [](long long stride, int size) {
    return size == 1 || (stride > 0 && (stride * 2) % 16 == 0);
  };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.d == 1 &&
         ok(st.s, ns) && ok(st.h, nh) && ok(st.b, nb);
}

template <int DP>
int launch_tc(const void* q, Strides qs, const void* k, Strides ks,
              const void* v, Strides vs, void* o, Strides os, int b, int hq,
              int hkv, int sq, int sk, int d, float scale, int causal,
              long long q_offset, long long window, int kv_len,
              cudaStream_t stream) {
  using L = tc::Layout<DP>;
  CUtensorMap mq, mk, mv;
  tc::Pos pq, pk, pv;
  int err = attn_map(&mq, &pq, q, qs, b, hq, sq, d, tc::BQ);
  if (err == 0) err = attn_map(&mk, &pk, k, ks, b, hkv, sk, d, tc::BKV);
  if (err == 0) err = attn_map(&mv, &pv, v, vs, b, hkv, sk, d, tc::BKV);
  if (err != 0) return err;
  auto kernel = attn_tc_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>((sq + tc::BQ - 1) / tc::BQ) *
                         hq * b;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ctas), tc::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, pq, pk, pv, static_cast<__nv_bfloat16*>(o), os, b, hq,
      hq / hkv, sq, d, scale, causal, q_offset, window, kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// o[b, h, :sq, :d] = softmax(mask(q k^T * scale)) v for q (b, hq, sq, d)
// and k, v (b, hkv, sk, d), each through its four strides (in elements);
// o is written through its own. window < 0 means no window; keys at or
// past kv_len (<= sk) are masked. `variant` is 0 for the FFMA kernel (f32 or
// bf16, d <= 256, any strides) and 1 for the tensor-core kernel (bf16,
// d <= 128 a multiple of 8, q / k / v readable by TMA); the wrapper picks it
// (kernels/flash_attention.py::attention_variant) and a variant that cannot
// take the operands is refused, never replaced. Returns the cudaError_t of
// the launch.
extern "C" int repro_attention(
    int variant, int dtype, const void* q, long long qb, long long qh,
    long long qs, long long qd, const void* k, long long kb, long long kh,
    long long ks, long long kd, const void* v, long long vb, long long vh,
    long long vs, long long vd, void* o, long long ob, long long oh,
    long long os, long long od, int b, int hq, int hkv, int sq, int sk, int d,
    float scale, int causal, long long q_offset, long long window,
    int kv_len, void* stream) {
  using repro::Strides;
  const Strides sq_{qb, qh, qs, qd}, sk_{kb, kh, ks, kd}, sv_{vb, vh, vs, vd},
      so_{ob, oh, os, od};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (hkv < 1 || hq % hkv != 0) return bad;
  if (variant == 1) {
    if (dtype != repro::kBF16 || d < 1 || d > 128 || d % 8 != 0 ||
        !repro::tma_ok(q, sq_, b, hq, sq) || !repro::tma_ok(k, sk_, b, hkv, sk) ||
        !repro::tma_ok(v, sv_, b, hkv, sk))
      return bad;
    if (d <= 64)
      return repro::launch_tc<64>(q, sq_, k, sk_, v, sv_, o, so_, b, hq, hkv,
                                  sq, sk, d, scale, causal, q_offset, window,
                                  kv_len, s);
    return repro::launch_tc<128>(q, sq_, k, sk_, v, sv_, o, so_, b, hq, hkv,
                                 sq, sk, d, scale, causal, q_offset, window,
                                 kv_len, s);
  }
  if (variant != 0) return bad;
  if (dtype == repro::kF32)
    return repro::dispatch_d<float>(q, sq_, k, sk_, v, sv_, o, so_, b, hq,
                                    hkv, sq, sk, d, scale, causal, q_offset,
                                    window, kv_len, s);
  if (dtype == repro::kBF16)
    return repro::dispatch_d<__nv_bfloat16>(q, sq_, k, sk_, v, sv_, o, so_,
                                            b, hq, hkv, sq, sk, d, scale,
                                            causal, q_offset, window, kv_len,
                                            s);
  return bad;
}
