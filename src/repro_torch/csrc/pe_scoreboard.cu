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
// (-1 is DOT4) and is then clamped to [0, 6]; a negative source reads 0;
// a source >= i reads 0 (ready[] starts at 0 and slot i is written after
// step i reads, and the reference clamps a source >= n to slot n-1, still
// 0 when read). Compiled streams never take those paths.
//
// What bounds it: the recurrence is serial in i. Written as
//
//   issue[i] = max(issue[i-1] + a[i], m[i])
//
// (a[i] = max(1, lat[i-1]) when a source is i-1, else 1; m[i] the largest
// ready[] value of the other sources), a step's dependent chain is one
// integer add and one max: one DPX instruction, VIADDMNMX
// (__viaddmax_s32), 4 cycles when m[i] is ready in time
// (tools/int_chain.cu). That is the bound. The bytes are nothing to the
// card (12 B of stream per instruction per configuration). What paces this
// kernel is the walking thread's instruction issue: about 12 instructions
// a step (two 16-byte and two 4-byte shared loads, one store, five integer
// max / add-max ops, an add), each holding the warp's issue for about two
// cycles, with the chain and every load's latency hidden behind them.
//
// The design: one CTA per configuration (the configurations' CTAs on
// separate SMs), one thread walking the recurrence, nothing on its
// dependent chain in device memory.
//
//  - ready[] on chip: the walking thread writes ready[i] only into a ring of
//    the last WINDOW values in dynamic shared memory (128 KB; the opt-in
//    above 48 KB is requested at every launch and its error returned).
//  - Near sources from registers: the thread keeps issue[] of its last NEAR
//    steps in registers. A source at distance d = i - src in [2, NEAR]
//    enters as issue[i-d] + lat[src] (one VIADDMNMX), one at d = 1 through
//    a[i], so dgemm's chains (sources 4 and 8 back) never wait on memory.
//  - Far sources as values or early loads: a source at d in (NEAR, WINDOW]
//    is a ring slot, loaded NEAR steps before its step (after the store of
//    step src, before the walk's next store), and joins the max last, so
//    the shared-memory latency hides behind NEAR steps. A source at d >
//    WINDOW is final long before: the other warps resolve it from device
//    memory while staging and store its value in a slot of the chunk's
//    buffer, which the thread loads the same way. The staged format is an
//    address per source (a ring slot, a value slot, or a slot holding
//    INT_MIN for "no source"), so no value is tagged.
//  - Staging off the chain: the thread walks CHUNK steps out of one of two
//    shared-memory buffers while the other warps stage the next chunk into
//    the other (opcode -> lat, the source classes above, a[i] and the near
//    latencies, far values) and copy the last finished chunk from the ring
//    to the device-memory ready[] (where the staging reads far values; no
//    slot is read there before it was written, so nothing zeroes it) and
//    take its max for cycles. The walking warp's own sub-partition (warp
//    index mod 4) holds no staging warp, so staging issues no instruction
//    in its slots; with the staging warps idle the walk takes as long.
//
// Sources classed as "no source" (negative, >= i) and candidates below
// issue[i-1] + 1 never change the max, since issue[i] >= i >= 0: a missing
// near source enters as issue + (INT_MIN + 1), which cannot wrap for
// issue >= -1. A chunk's walk is padded to UNROLL steps with steps that
// repeat the last issue (a = 0, no source), so issue of the last step is
// issue[n-1] and stalls[c] = issue[n-1] + 1 - n (the sum telescopes).
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int THREADS = 512;       // warp 0 walks; warps 4, 8, 12 idle
constexpr int CHUNK = 1024;        // instructions staged per buffer
constexpr int WINDOW = 32768;      // ring of ready[] in shared memory
constexpr int NEAR = 4;            // issue[] kept in registers
constexpr int UNROLL = 8;          // steps per unrolled group of the walk
constexpr int N_OPCODES = 7;
constexpr int ABSENT = INT_MIN + 1;  // near latency of no source
constexpr int STAGERS = (THREADS / 32 - THREADS / 128) * 32;
static_assert(WINDOW >= 3 * CHUNK && (WINDOW & (WINDOW - 1)) == 0,
              "far sources must be in device memory before they are staged");
static_assert(CHUNK % UNROLL == 0 && UNROLL % NEAR == 0 && NEAR == 4,
              "the walk's register rotation");

struct __align__(16) Buffer {
  int4 near[CHUNK + UNROLL];          // {a, lat at d = 2, 3, 4}
  // rec[e] = {lat of step e - NEAR, slot address of src1 / src2 of step e}
  int4 rec[CHUNK + NEAR + UNROLL];
  int val[CHUNK][2];                  // far sources' values
};

struct __align__(16) Smem {
  int ring[WINDOW];
  Buffer buf[2];
  int lat[8];
  int none;                           // INT_MIN: the slot of no source
  int stalls;
  int red[THREADS / 32];
};

__device__ __forceinline__ int lat_of(const int* __restrict__ opcode, int i,
                                      const int* lat) {
  int op = opcode[i];
  if (op < 0) op += N_OPCODES;               // numpy-style wrap once,
  return lat[min(max(op, 0), N_OPCODES - 1)];  // then clamp, as jnp
}

__device__ __forceinline__ int addr_of(const char* base, const void* p) {
  return static_cast<int>(static_cast<const char*>(p) - base);
}

// Stage instructions [base, base + CHUNK + NEAR + UNROLL) of the stream
// into b (those at or past n, or past the chunk, as padding steps).
__device__ void stage(const int* __restrict__ opcode,
                      const int* __restrict__ src1,
                      const int* __restrict__ src2, const int* rdy, int n,
                      int base, Smem& S, Buffer& b, int t0, int stride) {
  const char* sm = reinterpret_cast<const char*>(&S);
  const int none = addr_of(sm, &S.none);
  const int len = min(CHUNK, n - base);
  for (int q = t0; q < CHUNK + NEAR + UNROLL; q += stride) {
    int a = 0, lat = 0, addr[2] = {none, none};
    int l2 = ABSENT, l3 = ABSENT, l4 = ABSENT;   // lat at d = 2, 3, 4
    if (q < len) {
      const int i = base + q;
      lat = lat_of(opcode, i, S.lat);
      a = 1;
      const int src[2] = {src1[i], src2[i]};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = src[k];
        if (s < 0 || s >= i) continue;       // reads 0: no source
        const int d = i - s;
        if (d == 1) {
          a = max(1, lat_of(opcode, s, S.lat));
        } else if (d <= NEAR) {
          const int l = lat_of(opcode, s, S.lat);
          if (d == 2) l2 = l;
          else if (d == 3) l3 = l;
          else l4 = l;
        } else if (d <= WINDOW) {
          addr[k] = addr_of(sm, &S.ring[s & (WINDOW - 1)]);
        } else {
          b.val[q][k] = rdy[s];
          addr[k] = addr_of(sm, &b.val[q][k]);
        }
      }
    }
    if (q < CHUNK + UNROLL) b.near[q] = make_int4(a, l2, l3, l4);
    b.rec[q].y = addr[0];
    b.rec[q].z = addr[1];
    if (q < CHUNK + UNROLL) b.rec[q + NEAR].x = lat;
  }
}

__device__ __forceinline__ int slot(const char* sm, int addr) {
  return *reinterpret_cast<const int*>(sm + addr);
}

// The walking thread: steps [0, steps) of buffer b, ready[] into ring
// (the chunk's slots). iss[k] holds issue of the last step = k mod 4.
__device__ __forceinline__ void walk(const char* sm, const Buffer& b,
                                     int* ring, int steps, int (&iss)[NEAR]) {
  int4 nr[UNROLL], rc[UNROLL];
  int v1[NEAR], v2[NEAR];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    nr[u] = b.near[u];
    rc[u] = b.rec[u + NEAR];
  }
#pragma unroll
  for (int q = 0; q < NEAR; ++q) {
    v1[q] = slot(sm, b.rec[q].y);
    v2[q] = slot(sm, b.rec[q].z);
  }
  for (int j0 = 0; j0 < steps; j0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u, q = u % NEAR;
      const int far1 = v1[q], far2 = v2[q];
      // step j + NEAR's far sources, at most step j - 1: already stored
      v1[q] = slot(sm, rc[u].y);
      v2[q] = slot(sm, rc[u].z);
      // d = 4, 3, 2 from registers; the far values join last
      int m = __viaddmax_s32(iss[q], nr[u].w, iss[(q + 1) % NEAR] + nr[u].z);
      m = __viaddmax_s32(iss[(q + 2) % NEAR], nr[u].y, m);
      iss[q] = __viaddmax_s32(iss[(q + 3) % NEAR], nr[u].x,
                              __vimax3_s32(far1, far2, m));
      ring[j] = iss[q] + rc[u].x;
      nr[u] = b.near[j + UNROLL];
      rc[u] = b.rec[j + UNROLL + NEAR];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
pe_scoreboard_kernel(const int* __restrict__ opcode,
                     const int* __restrict__ src1,
                     const int* __restrict__ src2, int n,
                     const int* __restrict__ lat, int* __restrict__ ready,
                     int* __restrict__ cycles, int* __restrict__ stalls) {
  extern __shared__ __align__(16) char smem[];
  Smem& S = *reinterpret_cast<Smem*>(smem);
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t / 32;
  // stagers: every warp but 0 and its sub-partition's 4, 8, 12
  const bool stager = warp % 4 != 0;
  const int sid = (warp - warp / 4 - 1) * 32 + t % 32;
  int* rdy = ready + static_cast<long long>(c) * n;
  if (t < N_OPCODES) S.lat[t] = lat[c * N_OPCODES + t];
  if (t == 0) S.none = INT_MIN;
  __syncthreads();
  stage(opcode, src1, src2, rdy, n, 0, S, S.buf[0], t, THREADS);
  __syncthreads();
  const int chunks = (n + CHUNK - 1) / CHUNK;
  int iss[NEAR] = {-1, -1, -1, -1};
  int mx = INT_MIN;
  for (int k = 0; k < chunks; ++k) {
    const int base = k * CHUNK;
    if (t == 0) {
      const int steps = (min(CHUNK, n - base) + UNROLL - 1) / UNROLL * UNROLL;
      walk(smem, S.buf[k & 1], S.ring + (base & (WINDOW - 1)), steps, iss);
    } else if (stager) {
      if (k + 1 < chunks)
        stage(opcode, src1, src2, rdy, n, base + CHUNK, S, S.buf[(k + 1) & 1],
              sid, STAGERS);
      if (k > 0) {                 // chunk k - 1: to device memory, its max
        const int prev = base - CHUNK;
        const int* r = S.ring + (prev & (WINDOW - 1));
        for (int q = sid; q < CHUNK; q += STAGERS) {
          const int v = r[q];
          rdy[prev + q] = v;
          mx = max(mx, v);
        }
      }
    }
    __syncthreads();
  }
  if (stager) {                    // the last chunk's max
    const int last = (chunks - 1) * CHUNK;
    const int* r = S.ring + (last & (WINDOW - 1));
    for (int q = sid; q < n - last; q += STAGERS) mx = max(mx, r[q]);
  }
  // the walk's steps number a multiple of NEAR: its last is in iss[NEAR - 1]
  if (t == 0) S.stalls = iss[NEAR - 1] + 1 - n;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mx = max(mx, __shfl_xor_sync(~0u, mx, o));
  if (t % 32 == 0) S.red[warp] = mx;
  __syncthreads();
  if (t == 0) {
    int m = INT_MIN;
    for (int w = 0; w < THREADS / 32; ++w) m = max(m, S.red[w]);
    cycles[c] = m;
    stalls[c] = S.stalls;
  }
}

}  // namespace
}  // namespace repro

// cycles[c], stalls[c] of the stream opcode/src1/src2[0:n] (int32) at each
// of `configs` latency vectors lat[c][0:7] (int32); ready: configs x n
// int32 scratch (not read before written: no zeroing). Returns the
// cudaError_t of the shared-memory opt-in or of the launch (0 on success).
extern "C" int repro_pe_scoreboard(const void* opcode, const void* src1,
                                   const void* src2, int n, const void* lat,
                                   int configs, void* ready, void* cycles,
                                   void* stalls, void* stream) {
  if (n <= 0 || configs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(repro::Smem));
  cudaError_t err = cudaFuncSetAttribute(
      repro::pe_scoreboard_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::pe_scoreboard_kernel<<<configs, repro::THREADS, bytes, s>>>(
      static_cast<const int*>(opcode), static_cast<const int*>(src1),
      static_cast<const int*>(src2), n, static_cast<const int*>(lat),
      static_cast<int*>(ready), static_cast<int*>(cycles),
      static_cast<int*>(stalls));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's geometry, for the wrapper's constants and the card tests:
// 0 CHUNK, 1 WINDOW, 2 NEAR, 3 UNROLL, 4 dynamic shared memory bytes.
extern "C" int repro_pe_scoreboard_geometry(int what) {
  switch (what) {
    case 0: return repro::CHUNK;
    case 1: return repro::WINDOW;
    case 2: return repro::NEAR;
    case 3: return repro::UNROLL;
    case 4: return static_cast<int>(sizeof(repro::Smem));
    default: return -1;
  }
}
