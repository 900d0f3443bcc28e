// <x, y> in float32 for repro_torch.kernels.dotp (B4).
//
// Replaces the Pallas TPU kernel repro/kernels/dotp.py::dotp
// (_dotp_kernel). On the TPU one core streams (U, 128) tiles of x*y into a
// VMEM accumulator tile over a sequential grid, U independent chains
// hiding the VPU's add latency, and sums the tile at the end. Here the
// same idea is spread over the card: each thread keeps ILP independent
// partial sums over a grid-stride walk (consecutive threads on
// consecutive elements, so each warp load is one coalesced segment); each
// CTA reduces its threads in shared memory in a fixed tree order and
// writes one partial to a scratch vector; a second single-CTA pass sums
// the partials, again in a fixed order. No float atomics: the result
// depends only on n, never on scheduling.
//
// Bound: bytes. 2 operations per element against 2 * itemsize bytes read
// (0.25 FLOP/byte in f32), far below the ridge of either FP32 peak, so
// the kernel can at best stream both vectors once at the HBM rate. The
// grid is capped at MAX_BLOCKS CTAs (about eight per SM on 132 SMs), so
// large n keeps every SM's load queue full and small n still launches
// one CTA per THREADS * ILP elements.
#include "common.cuh"

namespace repro {
namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;            // independent partial sums per thread
constexpr int MAX_BLOCKS = 1024;  // size of the partials scratch

__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    __syncthreads();
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
  }
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dotp_partials(const T* __restrict__ x, long long sx, const T* __restrict__ y,
              long long sy, long long n, float* __restrict__ partials) {
  __shared__ float red[THREADS];
  float acc[ILP];
#pragma unroll
  for (int u = 0; u < ILP; ++u) acc[u] = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (; i + (ILP - 1) * stride < n; i += ILP * stride) {
    float xv[ILP], yv[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      xv[u] = to_acc(x[(i + u * stride) * sx]);
      yv[u] = to_acc(y[(i + u * stride) * sy]);
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) acc[u] = __fmaf_rn(xv[u], yv[u], acc[u]);
  }
#pragma unroll
  for (int u = 0; u < ILP - 1; ++u) {   // the ragged tail: < ILP strides
    const long long j = i + u * stride;
    if (j < n) acc[u] = __fmaf_rn(to_acc(x[j * sx]), to_acc(y[j * sy]), acc[u]);
  }
  float v = 0.f;
#pragma unroll
  for (int u = 0; u < ILP; ++u) v += acc[u];
  v = block_sum(v, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

__global__ void __launch_bounds__(THREADS)
dotp_final(const float* __restrict__ partials, int count,
           float* __restrict__ out) {
  __shared__ float red[THREADS];
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += THREADS) v += partials[i];
  v = block_sum(v, red);
  if (threadIdx.x == 0) out[0] = v;
}

template <typename T>
int launch(const void* x, long long sx, const void* y, long long sy,
           long long n, float* partials, float* out, cudaStream_t stream) {
  long long want = (n + THREADS * ILP - 1) / (THREADS * ILP);
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  dotp_partials<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(y), sy, n,
      partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dotp_final<<<1, THREADS, 0, stream>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// out[0] = sum_i x[i * sx] * y[i * sy] in float32, for n >= 1. partials
// is a float32 scratch of at least MAX_BLOCKS (1024) entries. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_dotp(int dtype, const void* x, long long sx,
                          const void* y, long long sy, long long n,
                          void* partials, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case repro::kF32: return repro::launch<float>(x, sx, y, sy, n, p, o, s);
    case repro::kF64: return repro::launch<double>(x, sx, y, sy, n, p, o, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, sx, y, sy, n, p, o, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
