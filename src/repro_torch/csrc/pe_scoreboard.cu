// The paper's cycle-level PE scoreboard for repro_torch.kernels.pe_scoreboard
// (repro_torch.core.pe: simulate / sweep / sweep_joint).
//
// Not a port of a TPU kernel: it replaces the jitted, vmapped lax.scan of
// repro/core/pe.py::_scoreboard / _scoreboard_sweep, the one program of the
// paper's section-5 apparatus that runs on the accelerator. Per depth
// configuration c, over an SSA instruction stream of n instructions
// (opcode / src1 / src2, src = -1 an RF-resident operand ready at cycle 0):
//
//   issue[i] = max(issue[i-1] + 1, ready[src1[i]], ready[src2[i]])
//   ready[i] = issue[i] + lat[c][opcode[i]]
//   cycles[c] = max_i ready[i],  stalls[c] = sum_i (issue[i] - issue[i-1] - 1)
//
// with issue[-1] = -1, in int32 as the reference. The reference's gather
// semantics are kept for any int32 input: a negative opcode wraps once
// (-1 is DOT4) and is then clamped to [0, 6], a source >= n reads ready[n-1],
// and ready[] starts at 0 (the wrapper zeroes it), so an operand not yet
// produced reads 0 as in the scan's zero-initialised carry. Compiled
// streams never take those paths.
//
// What bounds it: the recurrence is serial in i, so a configuration's time
// is n times the dependent latency of one step (load ready[src], max, add,
// store ready[i], which the next step may load). The bytes are nothing to
// the card (12 B of stream per instruction per configuration, a few ms of
// HBM time at most). The design is the simple right one: one CTA per
// configuration, the configurations' CTAs on separate SMs in parallel. One
// thread carries issue, stalls and max(fin); ready[] lives in a C x n int32
// scratch buffer in device memory that the wrapper allocates (8 MB per
// configuration at n = 2M). The CTA's other three warps stage the next
// chunk of src1 / src2 / lat[opcode] into shared memory (double-buffered)
// while the thread walks the current one, so the serial thread reads its
// stream from shared memory and only ready[] from device memory.
#include <climits>
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 1024;        // instructions staged per buffer
constexpr int N_OPCODES = 7;

__device__ __forceinline__ void stage(const int* __restrict__ opcode,
                                      const int* __restrict__ src1,
                                      const int* __restrict__ src2,
                                      const int* lat, int start, int len,
                                      int t0, int stride, int* s1, int* s2,
                                      int* l) {
  for (int j = t0; j < len; j += stride) {
    int op = opcode[start + j];
    if (op < 0) op += N_OPCODES;                  // numpy-style wrap once,
    op = min(max(op, 0), N_OPCODES - 1);          // then clamp, as jnp
    l[j] = lat[op];
    s1[j] = src1[start + j];
    s2[j] = src2[start + j];
  }
}

__global__ void __launch_bounds__(THREADS)
pe_scoreboard_kernel(const int* __restrict__ opcode,
                     const int* __restrict__ src1,
                     const int* __restrict__ src2, int n,
                     const int* __restrict__ lat, int* ready,
                     int* __restrict__ cycles, int* __restrict__ stalls) {
  __shared__ int s1[2][CHUNK];
  __shared__ int s2[2][CHUNK];
  __shared__ int l[2][CHUNK];
  __shared__ int lat_c[N_OPCODES];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  if (t < N_OPCODES) lat_c[t] = lat[c * N_OPCODES + t];
  __syncthreads();
  int* rdy = ready + static_cast<long long>(c) * n;
  stage(opcode, src1, src2, lat_c, 0, min(CHUNK, n), t, THREADS, s1[0],
        s2[0], l[0]);
  __syncthreads();
  int prev = -1, st = 0, mx = INT_MIN;
  int buf = 0;
  for (int base = 0; base < n; base += CHUNK, buf ^= 1) {
    const int next = base + CHUNK;
    if (t == 0) {
      const int len = min(CHUNK, n - base);
      const int* a = s1[buf];
      const int* b = s2[buf];
      const int* d = l[buf];
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const int x = a[j], y = b[j];
        const int r1 = x >= 0 ? rdy[min(x, n - 1)] : 0;
        const int r2 = y >= 0 ? rdy[min(y, n - 1)] : 0;
        const int issue = max(prev + 1, max(r1, r2));
        const int fin = issue + d[j];
        rdy[base + j] = fin;
        st += issue - prev - 1;
        mx = max(mx, fin);
        prev = issue;
      }
    } else if (t >= 32 && next < n) {
      stage(opcode, src1, src2, lat_c, next, min(CHUNK, n - next), t - 32,
            THREADS - 32, s1[buf ^ 1], s2[buf ^ 1], l[buf ^ 1]);
    }
    __syncthreads();
  }
  if (t == 0) {
    cycles[c] = mx;
    stalls[c] = st;
  }
}

}  // namespace
}  // namespace repro

// cycles[c], stalls[c] of the stream opcode/src1/src2[0:n] (int32) at each
// of `configs` latency vectors lat[c][0:7] (int32); ready: configs x n
// int32 scratch, zeroed by the caller. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_pe_scoreboard(const void* opcode, const void* src1,
                                   const void* src2, int n, const void* lat,
                                   int configs, void* ready, void* cycles,
                                   void* stalls, void* stream) {
  if (n <= 0 || configs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::pe_scoreboard_kernel<<<configs, repro::THREADS, 0, s>>>(
      static_cast<const int*>(opcode), static_cast<const int*>(src1),
      static_cast<const int*>(src2), n, static_cast<const int*>(lat),
      static_cast<int*>(ready), static_cast<int*>(cycles),
      static_cast<int*>(stalls));
  return static_cast<int>(cudaGetLastError());
}
