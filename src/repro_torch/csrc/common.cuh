// Shared device helpers for the repro_torch kernels: dtype codes, the
// storage -> accumulator conversions and the fused epilogues.
//
// Storage types and their accumulators follow the reference's
// per-precision rule (repro/kernels/gemm.py::accumulator_dtype):
// float32 and bfloat16 accumulate in float32, float64 in float64.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes shared with the Python wrappers (repro_torch/kernels/_build.py)
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

// epilogue codes shared with repro_torch/kernels/fused.py::EPILOGUES
enum Epilogue : int { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round-to-nearest-even on the narrowing store, as the reference's astype
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// two neighbouring outputs in one store (p aligned to the pair)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// IEEE fused multiply-add at the accumulator width (never TF32)
__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ float tanh_acc(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_acc(double x) { return tanh(x); }

// repro/kernels/fused.py::apply_epilogue on one accumulator value: relu
// keeps NaN (as jnp.maximum does), gelu is the tanh approximation
template <typename Acc>
__device__ __forceinline__ Acc activate(Acc x, int epilogue) {
  if (epilogue == kRelu) return x < Acc(0) ? Acc(0) : x;
  if (epilogue == kGelu) {
    const Acc k = Acc(0.7978845608028654);  // sqrt(2 / pi)
    Acc inner = k * (x + Acc(0.044715) * (x * x * x));
    return x * (Acc(0.5) * (Acc(1) + tanh_acc(inner)));
  }
  return x;
}

}  // namespace repro
