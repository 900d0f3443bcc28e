// <x, y> in float32 for repro_torch.kernels.dotp (B4).
//
// Replaces the Pallas TPU kernel repro/kernels/dotp.py::dotp
// (_dotp_kernel). On the TPU one core streams (U, 128) tiles of x*y into a
// VMEM accumulator tile over a sequential grid, U independent chains
// hiding the VPU's add latency, and sums the tile at the end. Here the
// same idea is spread over the card: each thread keeps ILP independent
// partial sums over a grid-stride walk (consecutive threads on
// consecutive 16-byte vectors, so each warp load is one coalesced 512-byte
// segment); each CTA reduces its threads in shared memory in a fixed tree
// order and writes one partial to a scratch vector; the last CTA to
// finish, found by an integer ticket, sums the partials in index order and
// resets the ticket, so one launch does both passes. No float atomics: the
// result depends only on n and the grid, never on which CTA came last.
//
// Bound: bytes. 2 operations per element against 2 * itemsize bytes read
// (0.25 FLOP/byte in f32), far below the ridge of either FP32 peak, so
// the kernel can at best stream both vectors once at the HBM rate. Two
// things keep the stream full: 16-byte loads (4 f32, 8 bf16, 2 f64) when
// both vectors have stride 1 and 16-byte aligned starts (strided or
// unaligned operands take 4-, 2- or 8-byte loads), and a grid of exactly
// one wave, at most four CTAs per SM (fewer if the occupancy query says
// so) times the SM count (kernels/dotp.py::dotp_grid), so every SM streams
// the same share to the end instead of a tail of SMs finishing a second
// partial wave; each thread keeps ILP 16-byte loads of both vectors in
// flight, so a few full CTAs per SM keep enough bytes in flight.
#include "common.cuh"

namespace repro {
namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;            // independent partial sums per thread

__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    __syncthreads();
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
  }
  __syncthreads();
  return red[0];
}

// one 16-byte vector of T as V floats
template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = static_cast<float>(to_acc(e[i]));
  }
};

// VEC: x and y have stride 1 and 16-byte aligned starts; the first
// (n / V) * V elements are read as vectors, the last < V by CTA 0
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dotp_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ y,
            long long sy, long long n, float* __restrict__ partials,
            unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float red[THREADS];
  __shared__ bool last;
  constexpr int V = VEC ? Vec<T>::V : 1;
  float acc[ILP];
#pragma unroll
  for (int u = 0; u < ILP; ++u) acc[u] = 0.f;
  const long long units = n / V;     // vectors (or elements) of the walk
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  auto step = [&](long long j, float& a) {
    if constexpr (VEC) {
      float xv[V], yv[V];
      Vec<T>::load(x + j * V, xv);
      Vec<T>::load(y + j * V, yv);
#pragma unroll
      for (int e = 0; e < V; ++e) a = __fmaf_rn(xv[e], yv[e], a);
    } else {
      a = __fmaf_rn(static_cast<float>(to_acc(x[j * sx])),
                    static_cast<float>(to_acc(y[j * sy])), a);
    }
  };
  for (; i + (ILP - 1) * stride < units; i += ILP * stride) {
    if constexpr (VEC) {   // every load of the ILP steps issued first
      float xv[ILP][V], yv[ILP][V];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        Vec<T>::load(x + (i + u * stride) * V, xv[u]);
        Vec<T>::load(y + (i + u * stride) * V, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[u] = __fmaf_rn(xv[u][e], yv[u][e], acc[u]);
    } else {
#pragma unroll
      for (int u = 0; u < ILP; ++u) step(i + u * stride, acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < ILP - 1; ++u) {   // the ragged tail: < ILP strides
    const long long j = i + u * stride;
    if (j < units) step(j, acc[u]);
  }
  if (VEC && blockIdx.x == 0 && threadIdx.x < n - units * V) {
    const long long j = units * V + threadIdx.x;   // the last < V elements
    acc[ILP - 1] = __fmaf_rn(static_cast<float>(to_acc(x[j])),
                             static_cast<float>(to_acc(y[j])), acc[ILP - 1]);
  }
  float v = 0.f;
#pragma unroll
  for (int u = 0; u < ILP; ++u) v += acc[u];
  v = block_sum(v, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();   // the partial is visible before the ticket moves
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every partial is in; sum them in index order, read past
  // the L1 (which may hold none of them)
  float s = 0.f;
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS)
    s += __ldcg(partials + b);
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    out[0] = s;
    *ticket = 0u;   // ready for the next call that shares it
  }
}

template <typename T, bool VEC>
int launch(const void* x, long long sx, const void* y, long long sy,
           long long n, int blocks, float* partials, unsigned* ticket,
           float* out, cudaStream_t stream) {
  dotp_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(y), sy, n,
      partials, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int vec, const void* x, long long sx, const void* y,
             long long sy, long long n, int blocks, float* p, unsigned* t,
             float* o, cudaStream_t s) {
  return vec ? launch<T, true>(x, sx, y, sy, n, blocks, p, t, o, s)
             : launch<T, false>(x, sx, y, sy, n, blocks, p, t, o, s);
}

template <typename T>
int per_sm(int vec) {
  int got = 0;
  const cudaError_t err =
      vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &got, dotp_kernel<T, true>, THREADS, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &got, dotp_kernel<T, false>, THREADS, 0);
  return err == cudaSuccess ? got : -static_cast<int>(err);
}

}  // namespace
}  // namespace repro

// CTAs of the kernel one SM holds at once (the occupancy query) for the
// dtype and load width, or minus the cudaError_t of the query.
extern "C" int repro_dotp_blocks_per_sm(int dtype, int vec) {
  switch (dtype) {
    case repro::kF32: return repro::per_sm<float>(vec);
    case repro::kF64: return repro::per_sm<double>(vec);
    case repro::kBF16: return repro::per_sm<__nv_bfloat16>(vec);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// out[0] = sum_i x[i * sx] * y[i * sy] in float32, for n >= 1. vec = 1
// reads 16-byte vectors (the caller has checked stride 1 and alignment);
// blocks (kernels/dotp.py::dotp_grid) CTAs write partials, a float32
// scratch of at least `blocks` entries. ticket is an unsigned int that is
// 0 before the call and 0 again after it; calls that share one must run in
// order (one stream). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_dotp(int dtype, int vec, const void* x, long long sx,
                          const void* y, long long sy, long long n,
                          int blocks, void* partials, void* ticket,
                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  unsigned* t = static_cast<unsigned*>(ticket);
  float* o = static_cast<float*>(out);
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case repro::kF32:
      return repro::dispatch<float>(vec, x, sx, y, sy, n, blocks, p, t, o, s);
    case repro::kF64:
      return repro::dispatch<double>(vec, x, sx, y, sy, n, blocks, p, t, o,
                                     s);
    case repro::kBF16:
      return repro::dispatch<__nv_bfloat16>(vec, x, sx, y, sy, n, blocks, p,
                                            t, o, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
