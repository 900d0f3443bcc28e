// Streaming-softmax attention for repro_torch.kernels.flash_attention (B5).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::attention
// (_attn_kernel). On the TPU the KV axis is the innermost, sequential grid
// dimension and the f32 running (m, l, acc) live in VMEM scratch across
// its steps. Here one CTA owns one (batch, query head, 64-row query block)
// and walks the KV blocks itself, staging each in shared memory, so CTAs
// are independent and run in any order. GQA maps query head h to KV head
// h / (Hq / Hkv), which need not be a power of two (hymba: 25 over 5).
//
// Per KV block: S = Q K^T on FFMA in f32 (a 4 x (BK/16) register tile per
// thread), the causal / window / kv_len mask, the online-softmax rescale
// (one warp per 8 rows), and acc = alpha * acc + P V with the 64 x D f32
// accumulator in registers (a 4 x (D/16) tile per thread). At the end each
// row is divided by its l (0 where l = 0) and stored in q's dtype. Operands
// are read through their (batch, head, seq, dim) strides, so the model's
// moveaxis views need no copy; ragged Sq / Sk / D are masked in-kernel.
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
// so the bf16 tensor-core peak prices the bound; this first kernel runs on
// the FP32 FFMA pipes (no mma/wgmma yet), so it sits well above that
// bound. Tensor cores (wgmma) and TMA-fed KV rings are later work.
#include "common.cuh"

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

}  // namespace
}  // namespace repro

// o[b, h, :sq, :d] = softmax(mask(q k^T * scale)) v for q (b, hq, sq, d)
// and k, v (b, hkv, sk, d), each through its four strides (in elements);
// o is written through its own. window < 0 means no window; keys at or
// past kv_len (<= sk) are masked. Returns the cudaError_t of the launch.
extern "C" int repro_attention(
    int dtype, const void* q, long long qb, long long qh, long long qs,
    long long qd, const void* k, long long kb, long long kh, long long ks,
    long long kd, const void* v, long long vb, long long vh, long long vs,
    long long vd, void* o, long long ob, long long oh, long long os,
    long long od, int b, int hq, int hkv, int sq, int sk, int d, float scale,
    int causal, long long q_offset, long long window, int kv_len,
    void* stream) {
  using repro::Strides;
  const Strides sq_{qb, qh, qs, qd}, sk_{kb, kh, ks, kd}, sv_{vb, vh, vs, vd},
      so_{ob, oh, os, od};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kF32)
    return repro::dispatch_d<float>(q, sq_, k, sk_, v, sv_, o, so_, b, hq,
                                    hkv, sq, sk, d, scale, causal, q_offset,
                                    window, kv_len, s);
  if (dtype == repro::kBF16)
    return repro::dispatch_d<__nv_bfloat16>(q, sq_, k, sk_, v, sv_, o, so_,
                                            b, hq, hkv, sq, sk, d, scale,
                                            causal, q_offset, window, kv_len,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}
