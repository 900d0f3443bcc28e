// Rate of the FP64 mma.sync shapes on one NVIDIA Hopper card, and a check of
// the m16n8k8 fragment layout that csrc/gemm.cu's "dmma" variant assumes.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//        -o build/repro_torch/f64_mma_rate src/repro_torch/tools/f64_mma_rate.cu
//   build/repro_torch/f64_mma_rate
//
// Each warp issues 8 independent accumulations per step from registers (no
// memory traffic), with 32 and with 8 warps per SM (4 or 1 CTAs of 8 warps);
// prints TFLOP/s per shape.
#include <cstdio>
#include <cuda_runtime.h>

template <int SHAPE>
__global__ void rate(double* out, int iters) {
  double acc[8][4] = {}, a[4], b[2];
  for (int r = 0; r < 4; ++r) a[r] = 1e-3 * (threadIdx.x + r);
  for (int r = 0; r < 2; ++r) b[r] = 1e-3 * (threadIdx.x - r);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (SHAPE == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(acc[i][0]), "+d"(acc[i][1]) : "d"(a[0]), "d"(b[0]));
      else if (SHAPE == 1)
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+d"(acc[i][0]), "+d"(acc[i][1]), "+d"(acc[i][2]),
                       "+d"(acc[i][3])
                     : "d"(a[0]), "d"(a[1]), "d"(b[0]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+d"(acc[i][0]), "+d"(acc[i][1]), "+d"(acc[i][2]),
                       "+d"(acc[i][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                       "d"(b[1]));
    }
  }
  double s = 0;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// D = A B for A[i][k] = 100 i + k, B[k][n] = (k == n) + 0.5 (k == n + 1),
// with the fragments placed as gemm.cu's DmmaMma reads them; writes
// D through the C layout
__global__ void layout(double* d) {
  const int l = threadIdx.x, g = l / 4, t = l % 4;
  double a[4], b[2], c[4] = {0, 0, 0, 0};
  for (int r = 0; r < 4; ++r) a[r] = 100.0 * (g + 8 * (r % 2)) + t + 4 * (r / 2);
  for (int r = 0; r < 2; ++r) {
    const int k = t + 4 * r;
    b[r] = (k == g) + 0.5 * (k == g + 1);
  }
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                 "d"(b[1]));
  for (int r = 0; r < 4; ++r)
    d[(g + 8 * (r / 2)) * 8 + 2 * t + r % 2] = c[r];
}

int main() {
  double* d;
  if (cudaMalloc(&d, 1 << 24) != cudaSuccess) return 1;
  double h[128];
  layout<<<1, 32>>>(d);
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < 16; ++i)
    for (int n = 0; n < 8; ++n) {
      const double want = 100.0 * i + n + (n + 1 < 8 ? 0.5 * (100.0 * i + n + 1) : 0);
      bad += h[i * 8 + n] != want;
    }
  printf("m16n8k8 f64 fragment layout: %s (%d of 128 wrong)\n",
         bad ? "MISMATCH" : "as assumed", bad);
  const char* names[3] = {"m8n8k4", "m16n8k4", "m16n8k8"};
  const double flops[3] = {512, 1024, 2048};
  const int iters = 2000, threads = 256;
  for (int per_sm : {4, 1}) {                // CTAs of 8 warps per SM
    const int blocks = 132 * per_sm;
    for (int sh = 0; sh < 3; ++sh) {
      cudaEvent_t t0, t1;
      cudaEventCreate(&t0);
      cudaEventCreate(&t1);
      float ms = 0;
      for (int rep = 0; rep < 2; ++rep) {    // the first run warms up
        cudaEventRecord(t0);
        if (sh == 0) rate<0><<<blocks, threads>>>(d, iters);
        if (sh == 1) rate<1><<<blocks, threads>>>(d, iters);
        if (sh == 2) rate<2><<<blocks, threads>>>(d, iters);
        cudaEventRecord(t1);
        cudaEventSynchronize(t1);
        cudaEventElapsedTime(&ms, t0, t1);
      }
      const double total = flops[sh] * 8.0 * iters * blocks * (threads / 32);
      printf("%s, %d warps per SM: %.3f ms, %.1f TFLOP/s\n", names[sh],
             8 * per_sm, ms, total / ms / 1e9);
    }
  }
  return bad != 0 || cudaGetLastError() != cudaSuccess;
}
