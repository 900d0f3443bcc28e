// Dependent-op chains for repro_torch.kernels.fpu_chain, the device side of
// repro_torch.arch.calibrate's per-op-class pipeline probe.
//
// Not a port of a TPU kernel: it replaces the jitted lax.fori_loop chains of
// repro/arch/calibrate.py::run_microbenchmarks. Run eagerly from PyTorch,
// one op per launch, such a chain would time the launch (microseconds), not
// the FPU (nanoseconds); here the whole chain is one kernel.
//
// What it measures: dependent-issue latency. Each of 8 lanes of one warp
// (the reference's 8-lane value) applies one op of its class to its own
// loop-carried value for `iters` steps, so every op waits for the one before
// it, and clock64() around the loop gives the SM cycles of the chain. One
// warp on purpose: a second warp on the SM would issue into the first one's
// stalls and hide the latency. Bound by nothing but that latency (8 * iters
// operations and 64 bytes are nothing to the card's rates).
//
// The classes, each IEEE round-to-nearest so the plain PyTorch loop gives
// the same bits:
//   0 mul:  v = v * c              (FMUL)
//   1 add:  v = v + c              (FADD)
//   2 div:  v = v / c              (div.rn.f32: on Hopper a multi-instruction
//                                   sequence, reciprocal + Newton steps + a
//                                   correction; its fitted "depth" is that
//                                   sequence's latency)
//   3 sqrt: v = sqrt(v) + 0.5      (sqrt.rn.f32, also a sequence, then FADD)
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int LANES = 8;

// keep v in a register at this point: nothing computing v moves past it
__device__ __forceinline__ void pin(float v) {
  asm volatile("" ::"f"(v) : "memory");
}

template <int OP>
__global__ void __launch_bounds__(32)
fpu_chain_kernel(const float* __restrict__ v0, float c, int iters,
                 float* __restrict__ out, long long* __restrict__ cycles) {
  const int lane = threadIdx.x;
  if (lane >= LANES) return;
  float v = v0[lane];
  pin(v);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if constexpr (OP == 0)
      v = __fmul_rn(v, c);
    else if constexpr (OP == 1)
      v = __fadd_rn(v, c);
    else if constexpr (OP == 2)
      v = __fdiv_rn(v, c);
    else
      v = __fadd_rn(__fsqrt_rn(v), 0.5f);
  }
  pin(v);
  const long long t1 = clock64();
  out[lane] = v;
  if (lane == 0) *cycles = t1 - t0;
}

}  // namespace
}  // namespace repro

// out[0:8] = the chain of op class `op` (0 mul, 1 add, 2 div, 3 sqrt) over
// `iters` steps from v0[0:8] with constant c; cycles[0] = its clock64 span.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_fpu_chain(int op, const void* v0, float c, int iters,
                               void* out, void* cycles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(v0);
  float* y = static_cast<float*>(out);
  long long* t = static_cast<long long*>(cycles);
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (op) {
    case 0: repro::fpu_chain_kernel<0><<<1, 32, 0, s>>>(x, c, iters, y, t); break;
    case 1: repro::fpu_chain_kernel<1><<<1, 32, 0, s>>>(x, c, iters, y, t); break;
    case 2: repro::fpu_chain_kernel<2><<<1, 32, 0, s>>>(x, c, iters, y, t); break;
    case 3: repro::fpu_chain_kernel<3><<<1, 32, 0, s>>>(x, c, iters, y, t); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
