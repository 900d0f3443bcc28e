// Latency of the dependent chains behind B8's bound (csrc/pe_scoreboard.cu,
// chip_smoke.py's PE_STEP_CYCLES) on one NVIDIA Hopper card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//        -o build/repro_torch/int_chain src/repro_torch/tools/int_chain.cu
//   build/repro_torch/int_chain
//
// One thread of one warp (nothing else on the SM to issue into its stalls)
// walks a chain of STEPS dependent steps, 8 operands in registers taken in
// turn, and clock64() around the chain gives its SM cycles. Prints one JSON
// line of cycles per step for:
//   addmax     v = max(v + a, b)  by __viaddmax_s32 (one VIADDMNMX: the
//              scoreboard's issue[i] = max(issue[i-1] + a[i], m[i]))
//   add_max    v = max(v + a, b)  as two PTX instructions (add.s32, max.s32)
//   smem_load  v = ring[v]        a shared-memory load-to-use chain (the
//              30 cycles that B8's earlier bound assumed)
#include <cstdio>
#include <cuda_runtime.h>

constexpr int STEPS = 1 << 20;

template <int KIND>
__global__ void chain(const int* in, int* out, long long* cycles) {
  __shared__ int ring[1024];
  int a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = in[k];
    b[k] = in[8 + k];
  }
  for (int k = threadIdx.x; k < 1024; k += blockDim.x)
    ring[k] = (k * 37 + 11) & 1023;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int v = in[16];
  const long long t0 = clock64();
  for (int s = 0; s < STEPS; s += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (KIND == 0) {
        v = __viaddmax_s32(v, a[k], b[k]);
      } else if constexpr (KIND == 1) {
        asm volatile("add.s32 %0, %0, %1;\n\tmax.s32 %0, %0, %2;"
                     : "+r"(v) : "r"(a[k]), "r"(b[k]));
      } else {
        v = ring[v];
      }
    }
  }
  const long long t1 = clock64();
  out[0] = v;
  *cycles = t1 - t0;
}

template <int KIND>
double cycles_per_step(const int* in, int* out, long long* cyc) {
  long long host = 0;
  for (int rep = 0; rep < 3; ++rep) {        // the last of 3: warm
    chain<KIND><<<1, 32>>>(in, out, cyc);
    cudaMemcpy(&host, cyc, sizeof(host), cudaMemcpyDeviceToHost);
  }
  return static_cast<double>(host) / STEPS;
}

int main() {
  int h[17];
  for (int k = 0; k < 8; ++k) {
    h[k] = 1 + k % 3;        // a: small increments
    h[8 + k] = -5 - k;       // b: below v, so the chain never saturates
  }
  h[16] = 0;
  int *in, *out;
  long long* cyc;
  cudaMalloc(&in, sizeof(h));
  cudaMalloc(&out, sizeof(int));
  cudaMalloc(&cyc, sizeof(long long));
  cudaMemcpy(in, h, sizeof(h), cudaMemcpyHostToDevice);
  struct Row { const char* name; double cycles; };
  const Row rows[] = {
      {"addmax", cycles_per_step<0>(in, out, cyc)},
      {"add_max", cycles_per_step<1>(in, out, cyc)},
      {"smem_load", cycles_per_step<2>(in, out, cyc)},
  };
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    std::printf("{\"error\": \"%s\"}\n", cudaGetErrorString(err));
    return 1;
  }
  std::printf("{\"steps\": %d", STEPS);
  for (const Row& r : rows) std::printf(", \"%s\": %.4f", r.name, r.cycles);
  std::printf("}\n");
  return 0;
}
