// C = epilogue(A @ B [+ bias]) for repro_torch.kernels.gemm (B1) and
// repro_torch.kernels.fused.gemm_bias_act (B3).
//
// Replaces the Pallas TPU kernels repro/kernels/gemm.py::gemm
// (_gemm_kernel) and repro/kernels/fused.py::gemm_bias_act
// (_gemm_epilogue_kernel). On the TPU the K axis is a sequential grid
// dimension carrying a VMEM accumulator; here each CTA owns one 64x64
// output tile and loops over K inside the block, so CTAs are independent
// and run in any order.
//
// Bound: at the main path's shapes (8192^3) the product is bound by
// operations (2mnk flops against (mk+kn+mn) elements moved). float32 runs
// on IEEE FFMA, never TF32 (the reference tolerance, rtol 2e-4, rules TF32
// out), so its ceiling is the 67 TFLOP/s non-tensor FP32 rate; float64
// also runs FFMA. This first kernel keeps a simple shared-memory tiling
// (64x64x16 tiles, a 4x4 register micro-tile per thread) that cuts the
// device-memory traffic by the tile edge; wgmma/TMA pipelines for bf16
// are later work.
//
// Operands are read through (row, column) strides, so transposed and
// sliced views need no copy; ragged edges are masked in-kernel (the TPU
// kernel padded to its VMEM-sized plan blocks instead). The bias (length
// n, contiguous) and the activation are applied to the register
// accumulator, in the accumulator type, before the single store.
#include "common.cuh"

namespace repro {
namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

template <typename T, typename Acc, typename TO>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, long long sa0, long long sa1,
            const T* __restrict__ b, long long sb0, long long sb1,
            const T* __restrict__ bias, int epilogue,
            TO* __restrict__ c, long long sc0, int m, int n, int k) {
  __shared__ Acc As[BK][BM + 1];
  __shared__ Acc Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // consecutive threads walk the operand's unit-stride axis
#pragma unroll
    for (int s = 0; s < (BM * BK) / THREADS; ++s) {
      const int idx = tid + s * THREADS;
      const int r = sa1 == 1 ? idx / BK : idx % BM;
      const int kk = sa1 == 1 ? idx % BK : idx / BM;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k) ? to_acc(a[gr * sa0 + gk * sa1]) : Acc(0);
    }
#pragma unroll
    for (int s = 0; s < (BK * BN) / THREADS; ++s) {
      const int idx = tid + s * THREADS;
      const int cc = sb1 == 1 ? idx % BN : idx / BK;
      const int kk = sb1 == 1 ? idx / BN : idx % BK;
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < k && gc < n) ? to_acc(b[gk * sb0 + gc * sb1]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_acc(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx + 16 * j;
      if (cc >= n) continue;
      Acc v = acc[i][j];
      if (bias != nullptr) v += to_acc(bias[cc]);
      store(&c[r * sc0 + cc], activate(v, epilogue));
    }
  }
}

template <typename T, typename Acc, typename TO>
int launch(const void* a, long long sa0, long long sa1, const void* b,
           long long sb0, long long sb1, const void* bias, int epilogue,
           void* c, long long sc0, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T, Acc, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), sa0, sa1, static_cast<const T*>(b), sb0, sb1,
      static_cast<const T*>(bias), epilogue, static_cast<TO*>(c), sc0, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, int out_dtype, const void* a, long long sa0,
             long long sa1, const void* b, long long sb0, long long sb1,
             const void* bias, int epilogue, void* c, long long sc0, int m,
             int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32)
    return launch<float, float, float>(a, sa0, sa1, b, sb0, sb1, bias,
                                       epilogue, c, sc0, m, n, k, s);
  if (dtype == kF64 && out_dtype == kF64)
    return launch<double, double, double>(a, sa0, sa1, b, sb0, sb1, bias,
                                          epilogue, c, sc0, m, n, k, s);
  if (dtype == kBF16 && out_dtype == kBF16)
    return launch<__nv_bfloat16, float, __nv_bfloat16>(
        a, sa0, sa1, b, sb0, sb1, bias, epilogue, c, sc0, m, n, k, s);
  if (dtype == kBF16 && out_dtype == kF32)
    return launch<__nv_bfloat16, float, float>(a, sa0, sa1, b, sb0, sb1, bias,
                                               epilogue, c, sc0, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// C[m, n] (row stride sc0, unit column stride) = A[m, k] @ B[k, n].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_gemm(int dtype, int out_dtype, const void* a,
                          long long sa0, long long sa1, const void* b,
                          long long sb0, long long sb1, void* c,
                          long long sc0, int m, int n, int k, void* stream) {
  return repro::dispatch(dtype, out_dtype, a, sa0, sa1, b, sb0, sb1, nullptr,
                         repro::kNone, c, sc0, m, n, k, stream);
}

// C = act(A @ B + bias); bias may be null (no bias), epilogue is a
// repro::Epilogue code.
extern "C" int repro_gemm_bias_act(int dtype, int out_dtype, const void* a,
                                   long long sa0, long long sa1,
                                   const void* b, long long sb0,
                                   long long sb1, const void* bias,
                                   int epilogue, void* c, long long sc0,
                                   int m, int n, int k, void* stream) {
  return repro::dispatch(dtype, out_dtype, a, sa0, sa1, b, sb0, sb1, bias,
                         epilogue, c, sc0, m, n, k, stream);
}
