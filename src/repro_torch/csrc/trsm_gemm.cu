// Fused X = L11^{-1} AP, then C' = C - BL X ("lu") or C - X^T X ("syrk"),
// for repro_torch.kernels.fused.trsm_gemm (B2).
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py::trsm_gemm
// (_trsm_gemm_kernel). That kernel leans on ordered grid steps: step 0
// solves all of X into VMEM scratch and every later step reads it. CTAs on
// the card run in no order, so here one cooperative launch keeps the order
// the TPU had, with a grid barrier in place of the grid step:
//
// Phase 1, the solve. The CTAs (all co-resident: the wrapper sizes the grid
// from the occupancy query) stride over X's column blocks of WIDTH columns
// and solve each block exactly once, in shared memory at the accumulator
// width: a blocked forward substitution, DB rows at a time, where a
// left-looking update of the DB rows from the rows already solved (all
// threads, one output each) is followed by the DB x DB diagonal block (one
// thread per column, in registers): two barriers per DB rows, none per row.
// L11's lower triangle sits in shared memory when it fits (copied once per
// CTA by cp.async), else it is read through the cache.
// Each block is written out once: the output X (storage dtype) and X at the
// accumulator width into a workspace xw, [nbp][ldx] with zero padding, so
// bf16 updates from the unrounded X as the TPU kernel does. For "lu" the
// CTAs then copy BL transposed into a second workspace blt, [nbp][ldm], at
// the accumulator width (tile transposes through shared memory, read along
// BL's unit-stride axis).
//
// One grid.sync().
//
// Phase 2, the update. The CTAs stride over C's 128 x 128 tiles: acc =
// A^T B over K = nbp with A = xw ("syrk") or blt ("lu") and B = xw, both
// [k][m]-major and padded, so a cp.async ring of 16-deep stages reads them
// with no bounds. f32 and bf16 run B1's "ffma" micro-tile (IEEE FFMA, never
// TF32: 256 threads, 8 x 8 outputs each); f64 runs B1's "dmma" shape
// (mma.sync m16n8k8, eight warps of 64 x 32). C is read once in the
// epilogue (prefetched into L2 when the tile starts), and C - acc is stored
// once into the contiguous c_out.
//
// Bound: operations (2 m n nb flops of update against (m n + ...)
// elements moved; the solve adds nb^2 n / 2). Each X column block is solved
// once per launch; there are no float atomics and no split-K, so every
// output is one fixed-order sum and a result depends only on the inputs.
// All blocks run at once (a cooperative launch): a grid larger than what
// fits is refused by the runtime and the wrapper raises.
//
// A batch of independent updates (the batched drivers' lockstep panels;
// the counterpart of vmap over the TPU kernel) is the same one launch: the
// item is folded into the task index of both phases, so the CTAs stride
// over (item, solve block or transpose tile), then over (item, C tile),
// with the one grid.sync() between. Each input has its own batch stride;
// the outputs and the workspaces hold the items one after another. A CTA
// stages an item's L11 in shared memory when its first solve task of that
// item comes. Every item's blocks run the tile, the K order and the
// substitution of a launch on that item alone, so item i of a batched
// launch is bitwise the 2-D launch on item i. A batch is its own kernel
// (trsm_gemm_batched_kernel, the same device functions on each item's
// pointers); one item runs trsm_gemm_kernel, the code a 2-D launch ran
// before the batch axis, its pointers read from the launch's parameters.
#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int DB = 16;                       // rows per diagonal block
constexpr int TT = 32;                       // side of a BL transpose tile
constexpr int BM = 128, BN = 128, BK = 16, STAGES = 3;   // the update tile
constexpr int PAD = 128;                     // ldx, ldm: multiples of this

// leading dimension of an update stage row: f64 pads 4 doubles, so that the
// 16 lanes of a half-warp's 64-bit fragment read (k rows t, columns g; four
// of each) fall on 16 distinct bank pairs
template <typename Acc>
__host__ __device__ constexpr int stage_ld() {
  return sizeof(Acc) == 8 ? BM + 4 : BM;
}

// dynamic shared memory of one launch: max(phase 1, phase 2)
template <typename Acc>
__host__ __device__ size_t smem_bytes(int nb, int width, int l_smem) {
  const size_t nbp = (nb + BK - 1) / BK * BK;
  size_t xs = nbp * (width + 1);
  if (xs < static_cast<size_t>(TT) * (TT + 1)) xs = TT * (TT + 1);
  const size_t solve =
      (xs + (l_smem ? static_cast<size_t>(nb) * nb : 0)) * sizeof(Acc);
  const size_t update =
      static_cast<size_t>(STAGES) * 2 * BK * stage_ld<Acc>() * sizeof(Acc);
  return solve > update ? solve : update;
}

struct Params {
  const void* l;
  long long sl0, sl1;
  const void* ap;
  long long sap0, sap1;
  const void* bl;
  long long sbl0, sbl1;
  const void* c;
  long long sc0, sc1;
  void* x;          // nb x n, storage dtype, contiguous
  void* cout;       // m x n, storage dtype, contiguous
  void* xw;         // nbp x ldx, accumulator dtype
  void* blt;        // nbp x ldm, accumulator dtype ("lu")
  int nb, nbp, m, n, ldx, ldm, width, l_smem, syrk, unit_diag;
  int batch;        // items; the inputs' batch strides, in elements
  long long slb, sapb, sblb, scb;
};

// p's pointers moved to item `item`: the inputs by their batch strides, the
// outputs (x, cout) and the workspaces (xw, blt) by one item's extent
template <typename T, typename Acc>
__device__ __forceinline__ Params at_item(const Params& p, long long item) {
  Params q = p;
  q.l = static_cast<const T*>(p.l) + item * p.slb;
  q.ap = static_cast<const T*>(p.ap) + item * p.sapb;
  q.bl = static_cast<const T*>(p.bl) + item * p.sblb;
  q.c = static_cast<const T*>(p.c) + item * p.scb;
  q.x = static_cast<T*>(p.x) + item * p.nb * p.n;
  q.cout = static_cast<T*>(p.cout) + item * p.m * p.n;
  q.xw = static_cast<Acc*>(p.xw) + item * p.nbp * p.ldx;
  if (p.blt != nullptr) q.blt = static_cast<Acc*>(p.blt) + item * p.nbp * p.ldm;
  return q;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// one 4- or 8-byte element (any alignment of its size) into shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------ phase 1 --------------------------------------

// X[:, c0 : c0 + W] = L11^{-1} AP[:, c0 : c0 + W] in xs ([nbp][W + 1]), then
// written to x and xw; L11 from shared memory (ls, LS) or through the cache
template <typename T, typename Acc, bool LS>
__device__ void solve_block(const Params& p, const Acc* ls, Acc* xs, int c0) {
  const T* l = static_cast<const T*>(p.l);
  const T* ap = static_cast<const T*>(p.ap);
  const int tid = threadIdx.x, w = p.width, ld = w + 1, nb = p.nb;
  auto lval = [&](int r, int q) -> Acc {
    if constexpr (LS) return ls[r * nb + q];
    else return to_acc(__ldg(&l[r * p.sl0 + q * p.sl1]));
  };
  // AP's block, read along its unit-stride axis; padding reads as zero
  const bool by_row = p.sap0 == 1;
  constexpr int U = 16;
  for (int i0 = tid; i0 < p.nbp * w; i0 += U * THREADS) {
    Acc v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int r = by_row ? i % p.nbp : i / w, cc = by_row ? i / p.nbp : i % w;
      const int gc = c0 + cc;
      v[u] = (i < p.nbp * w && r < nb && gc < p.n)
                 ? to_acc(__ldg(&ap[r * p.sap0 + gc * p.sap1]))
                 : Acc(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int r = by_row ? i % p.nbp : i / w, cc = by_row ? i / p.nbp : i % w;
      if (i < p.nbp * w) xs[r * ld + cc] = v[u];
    }
  }
  __syncthreads();
  for (int r0 = 0; r0 < nb; r0 += DB) {
    if (r0 > 0) {
      // rows r0 .. r0 + DB - 1 -= L[rows, :r0] X[:r0]; four partial sums
      for (int o = tid; o < DB * w; o += THREADS) {
        const int r = r0 + o / w, cc = o % w;
        if (r >= nb) continue;
        Acc s[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
        int q = 0;
#pragma unroll 4
        for (; q + 4 <= r0; q += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            s[u] = fma_acc(lval(r, q + u), xs[(q + u) * ld + cc], s[u]);
        for (; q < r0; ++q) s[0] = fma_acc(lval(r, q), xs[q * ld + cc], s[0]);
        xs[r * ld + cc] -= (s[0] + s[1]) + (s[2] + s[3]);
      }
      __syncthreads();
    }
    // the diagonal block, one column per thread, in registers
    if (tid < w) {
      Acc v[DB];
#pragma unroll
      for (int i = 0; i < DB; ++i) v[i] = xs[(r0 + i) * ld + tid];
#pragma unroll
      for (int i = 0; i < DB; ++i) {
        if (r0 + i >= nb) break;
        if (!p.unit_diag) v[i] = v[i] / lval(r0 + i, r0 + i);
#pragma unroll
        for (int q = i + 1; q < DB; ++q)
          if (r0 + q < nb) v[q] = fma_acc(-lval(r0 + q, r0 + i), v[i], v[q]);
      }
#pragma unroll
      for (int i = 0; i < DB; ++i) xs[(r0 + i) * ld + tid] = v[i];
    }
    __syncthreads();
  }
  T* x = static_cast<T*>(p.x);
  Acc* xw = static_cast<Acc*>(p.xw);
  for (int i = tid; i < p.nbp * w; i += THREADS) {
    const int r = i / w, cc = i % w, gc = c0 + cc;
    const bool live = r < nb && gc < p.n;
    const Acc v = live ? xs[r * ld + cc] : Acc(0);
    xw[static_cast<long long>(r) * p.ldx + gc] = v;
    if (live) store(&x[static_cast<long long>(r) * p.n + gc], v);
  }
  __syncthreads();                         // xs is reused by the next task
}

// blt[k0 : k0 + TT, r0 : r0 + TT] = BL[r0 : r0 + TT, k0 : k0 + TT]^T, zero
// past BL
template <typename T, typename Acc>
__device__ void transpose_tile(const Params& p, Acc* tile, int k0, int r0) {
  const T* bl = static_cast<const T*>(p.bl);
  Acc* blt = static_cast<Acc*>(p.blt);
  const bool by_row = p.sbl0 == 1;         // BL column-major: walk rows
  constexpr int U = TT * TT / THREADS;
  Acc v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int rr = by_row ? i % TT : i / TT, kk = by_row ? i / TT : i % TT;
    const int r = r0 + rr, k = k0 + kk;
    v[u] = (r < p.m && k < p.nb) ? to_acc(__ldg(&bl[r * p.sbl0 + k * p.sbl1]))
                                 : Acc(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int rr = by_row ? i % TT : i / TT, kk = by_row ? i / TT : i % TT;
    tile[kk * (TT + 1) + rr] = v[u];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TT * TT; i += THREADS) {
    const int rr = i % TT, kk = i / TT;
    const int r = r0 + rr, k = k0 + kk;
    if (k < p.nbp && r < p.ldm)
      blt[static_cast<long long>(k) * p.ldm + r] = tile[kk * (TT + 1) + rr];
  }
  __syncthreads();
}

// ------------------------------ phase 2 --------------------------------------

// one BK-deep stage of A (lda) and B (ldb) from row k0: BK x BM each
template <typename Acc>
__device__ __forceinline__ void load_stage(Acc* sa, Acc* sb, const Acc* a,
                                           int lda, const Acc* b, int ldb,
                                           int k0, int row0, int col0) {
  constexpr int LD = stage_ld<Acc>(), PER = 16 / sizeof(Acc);
  constexpr int CHUNKS = BK * BM / PER;    // 16-byte chunks per operand
#pragma unroll
  for (int s = 0; s < CHUNKS / THREADS; ++s) {
    const int i = threadIdx.x + s * THREADS;
    const int kk = i / (BM / PER), cc = (i % (BM / PER)) * PER;
    cp_async16(sa + kk * LD + cc, a + static_cast<long long>(k0 + kk) * lda + row0 + cc);
    cp_async16(sb + kk * LD + cc, b + static_cast<long long>(k0 + kk) * ldb + col0 + cc);
  }
}

// f32: thread (ty, tx) owns rows {4 ty + i, 64 + 4 ty + i} and columns
// {4 tx + j, 64 + 4 tx + j}, i, j < 4; one FFMA chain per output in k order
__device__ __forceinline__ void mac_stage(const float* sa, const float* sb,
                                          float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * BM + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * BM + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * BM + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * BM + 64 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

// f64: warp w owns the 64 x 32 block at rows 64 (w / 4), columns 32 (w % 4)
// as 4 x 4 mma.sync m16n8k8 tiles. With g = lane / 4, t = lane % 4: A
// register r holds row g + 8 (r % 2), k t + 4 (r / 2); B register r holds
// k t + 4 r, column g; C register r holds row g + 8 (r / 2), column
// 2 t + r % 2 (the layout csrc/gemm.cu's "dmma" uses).
__device__ __forceinline__ void mac_stage(const double* sa, const double* sb,
                                          double (&acc)[4][4][4]) {
  constexpr int LD = stage_ld<double>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    double bv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bv[j][r] = sb[(k8 + t + 4 * r) * LD + wn + 8 * j + g];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      double av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = sa[(k8 + t + 4 * (r / 2)) * LD + wm + 16 * i + g + 8 * (r % 2)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+d"(acc[i][j][0]), "+d"(acc[i][j][1]), "+d"(acc[i][j][2]),
              "+d"(acc[i][j][3])
            : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]),
              "d"(bv[j][0]), "d"(bv[j][1]));
    }
  }
}

// C's tile into L2 ahead of its epilogue (unit column stride only), so that
// its reads from device memory overlap the tile's products
template <typename T>
__device__ __forceinline__ void prefetch_c(const Params& p, int row0,
                                           int col0) {
  if (p.sc1 != 1) return;
  constexpr int PER_LINE = 128 / sizeof(T), LINES = BN / PER_LINE;
  const T* c = static_cast<const T*>(p.c);
  for (int i = threadIdx.x; i < BM * LINES; i += THREADS) {
    const int r = row0 + i / LINES, cc = col0 + (i % LINES) * PER_LINE;
    if (r < p.m && cc < p.n)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + r * p.sc0 + cc));
  }
}

// the epilogue in two passes, acc = C - acc then the stores, so that all of
// a thread's C loads are in flight together
template <typename T, typename Acc>
__device__ __forceinline__ void c_minus(const Params& p, int r, int cc,
                                        Acc& acc) {
  if (r < p.m && cc < p.n)
    acc = to_acc(__ldg(&static_cast<const T*>(p.c)[r * p.sc0 + cc * p.sc1])) -
          acc;
}
template <typename T, typename Acc>
__device__ __forceinline__ void store_out(const Params& p, int r, int cc,
                                          Acc acc) {
  if (r < p.m && cc < p.n)
    store(&static_cast<T*>(p.cout)[static_cast<long long>(r) * p.n + cc], acc);
}

// acc += A^T B over K = nbp for the tile at (row0, col0), A and B
// [k][m]-major, through a STAGES-deep cp.async ring: one barrier per stage
// both publishes the stage just waited for and frees the one multiplied
// last, which the next load refills
template <typename Acc, typename Frag>
__device__ __forceinline__ void update_loop(const Params& p, Acc* smem,
                                            int row0, int col0, Frag& acc) {
  constexpr int STAGE = BK * stage_ld<Acc>();
  const Acc* a = static_cast<const Acc*>(p.syrk ? p.xw : p.blt);
  const Acc* b = static_cast<const Acc*>(p.xw);
  const int lda = p.syrk ? p.ldx : p.ldm, ktiles = p.nbp / BK;
  Acc* sa = smem;                          // STAGES x [BK][LD]
  Acc* sb = smem + STAGES * STAGE;
  __syncthreads();                         // the previous tile's reads are done
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ktiles)
      load_stage(sa + t * STAGE, sb + t * STAGE, a, lda, b, p.ldx, t * BK, row0,
                 col0);
    cp_async_commit();                     // empty groups keep the count even
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ktiles)
      load_stage(sa + (next % STAGES) * STAGE, sb + (next % STAGES) * STAGE, a,
                 lda, b, p.ldx, next * BK, row0, col0);
    cp_async_commit();
    mac_stage(sa + (t % STAGES) * STAGE, sb + (t % STAGES) * STAGE, acc);
  }
  cp_async_wait<0>();
}

// c_out[tile] = C[tile] - acc
template <typename T>
__device__ void update_tile(const Params& p, float* smem, int row0, int col0) {
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  prefetch_c<T>(p, row0, col0);
  update_loop(p, smem, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto row = [&](int i) { return row0 + (i / 4) * 64 + 4 * ty + i % 4; };
  auto col = [&](int j) { return col0 + (j / 4) * 64 + 4 * tx + j % 4; };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c_minus<T>(p, row(i), col(j), acc[i][j]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) store_out<T>(p, row(i), col(j), acc[i][j]);
}

template <typename T>
__device__ void update_tile(const Params& p, double* smem, int row0,
                            int col0) {
  double acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;
  prefetch_c<T>(p, row0, col0);
  update_loop(p, smem, row0, col0, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + (warp / 4) * 64 + lane / 4;
  const int c0 = col0 + (warp % 4) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        c_minus<T>(p, r0 + 16 * i + 8 * (q / 2), c0 + 8 * j + q % 2,
                   acc[i][j][q]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store_out<T>(p, r0 + 16 * i + 8 * (q / 2), c0 + 8 * j + q % 2,
                     acc[i][j][q]);
}

// ------------------------------ the kernel -----------------------------------

// L11's lower triangle (of the item p points at) into ls, all loads in
// flight; the block's previous reads of ls are done (every task ends on a
// barrier)
template <typename T, typename Acc>
__device__ void load_l11(const Params& p, Acc* ls) {
  const T* l = static_cast<const T*>(p.l);
  if constexpr (sizeof(T) == sizeof(Acc)) {
    for (int i = threadIdx.x; i < p.nb * p.nb; i += THREADS) {
      const int r = i / p.nb, q = i % p.nb;
      if (q <= r) cp_async_elem<sizeof(T)>(&ls[i], &l[r * p.sl0 + q * p.sl1]);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {                                 // bf16: eight loads in flight
    constexpr int U = 8;
    const int count = p.nb * p.nb;
    for (int i0 = threadIdx.x; i0 < count; i0 += U * THREADS) {
      Acc v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS, r = i / p.nb, q = i % p.nb;
        v[u] = i < count && q <= r ? to_acc(__ldg(&l[r * p.sl0 + q * p.sl1]))
                                   : Acc(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * THREADS < count) ls[i0 + u * THREADS] = v[u];
    }
  }
  __syncthreads();
}

// one launch on one item (p.batch == 1): the kernel as it was before the
// batch axis, with p's pointers read straight from the launch's parameters
template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS, sizeof(Acc) == 4 ? 2 : 1)
trsm_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* smem = reinterpret_cast<Acc*>(smem_raw);
  const int solves = p.ldx / p.width;
  const int tk = (p.nbp + TT - 1) / TT, tr = p.syrk ? 0 : p.ldm / TT;

  // phase 1: L11 into shared memory (when it fits and this CTA solves),
  // then the column blocks, then BL's transpose tiles
  Acc* ls = smem;
  Acc* xs = p.l_smem ? smem + static_cast<size_t>(p.nb) * p.nb : smem;
  if (p.l_smem && blockIdx.x < solves) load_l11<T, Acc>(p, ls);
  for (int task = blockIdx.x; task < solves + tk * tr; task += gridDim.x) {
    if (task < solves && p.l_smem) {
      solve_block<T, Acc, true>(p, ls, xs, task * p.width);
    } else if (task < solves) {
      solve_block<T, Acc, false>(p, ls, xs, task * p.width);
    } else {
      const int id = task - solves;
      transpose_tile<T, Acc>(p, xs, (id / tr) * TT, (id % tr) * TT);
    }
  }

  cg::this_grid().sync();

  // phase 2: C's tiles, row-major
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = p.m > 0 ? ((p.m + BM - 1) / BM) * tiles_n : 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    update_tile<T>(p, smem, (tile / tiles_n) * BM, (tile % tiles_n) * BN);
}

// a batch of items (p.batch > 1), each task on its item's pointers
template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS, sizeof(Acc) == 4 ? 2 : 1)
trsm_gemm_batched_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* smem = reinterpret_cast<Acc*>(smem_raw);
  const int solves = p.ldx / p.width;
  const int tk = (p.nbp + TT - 1) / TT, tr = p.syrk ? 0 : p.ldm / TT;
  const int per_item = solves + tk * tr;

  // phase 1, over (item, task): an item's L11 into shared memory (when it
  // fits) before this CTA's first solve of that item, then the column
  // blocks, then BL's transpose tiles
  Acc* ls = smem;
  Acc* xs = p.l_smem ? smem + static_cast<size_t>(p.nb) * p.nb : smem;
  long long staged = -1;                   // the item whose L11 is in ls
  for (long long task = blockIdx.x; task < 1LL * p.batch * per_item;
       task += gridDim.x) {
    const long long item = task / per_item;
    const int t = static_cast<int>(task % per_item);
    const Params q = at_item<T, Acc>(p, item);
    if (t < solves && p.l_smem) {
      if (item != staged) {
        load_l11<T, Acc>(q, ls);
        staged = item;
      }
      solve_block<T, Acc, true>(q, ls, xs, t * p.width);
    } else if (t < solves) {
      solve_block<T, Acc, false>(q, ls, xs, t * p.width);
    } else {
      const int id = t - solves;
      transpose_tile<T, Acc>(q, xs, (id / tr) * TT, (id % tr) * TT);
    }
  }

  cg::this_grid().sync();

  // phase 2, over (item, C tile): each item's tiles row-major
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = p.m > 0 ? ((p.m + BM - 1) / BM) * tiles_n : 0;
  for (long long task = blockIdx.x; task < 1LL * p.batch * tiles;
       task += gridDim.x) {
    const int tile = static_cast<int>(task % tiles);
    update_tile<T>(at_item<T, Acc>(p, task / tiles), smem,
                   (tile / tiles_n) * BM, (tile % tiles_n) * BN);
  }
}

template <typename T, typename Acc>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = p.batch > 1 ? trsm_gemm_batched_kernel<T, Acc>
                            : trsm_gemm_kernel<T, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<Params*>(&p)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS), args,
      static_cast<size_t>(smem), stream));
}

// blocks per SM of one kernel at `smem` bytes, or minus the cudaError_t
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// the fewer of the two kernels' (a grid sized by it launches either)
template <typename T, typename Acc>
int co_resident(int smem) {
  int per_sm = blocks_per_sm(trsm_gemm_kernel<T, Acc>, smem);
  const int batched = blocks_per_sm(trsm_gemm_batched_kernel<T, Acc>, smem);
  if (per_sm < 0) return per_sm;
  if (batched < 0) return batched;
  if (batched < per_sm) per_sm = batched;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

}  // namespace
}  // namespace repro

// CTAs of one launch that fit on the current device at once with `smem`
// bytes of dynamic shared memory (blocks per SM x SMs), or minus the
// cudaError_t of the query.
extern "C" int repro_trsm_gemm_co_resident(int dtype, int smem) {
  switch (dtype) {
    case repro::kF32: return repro::co_resident<float, float>(smem);
    case repro::kF64: return repro::co_resident<double, double>(smem);
    case repro::kBF16: return repro::co_resident<__nv_bfloat16, float>(smem);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// X (nb x n, contiguous) and C' (m x n, contiguous) from L11 (nb x nb),
// AP (nb x n), BL (m x nb, ignored when syrk) and C (m x n), all strided,
// for each of `batch` items: item i's inputs at the batch strides slb,
// sapb, sblb, scb (elements) from the first's, its outputs and workspaces
// after the previous items'. xw (nbp x ldx a item) and, for "lu", blt
// (nbp x ldm a item) are accumulator-width workspaces: nbp = nb rounded up
// to 16, ldx = n and ldm = m rounded up to 128. width (a power of two up to
// 32), l_smem, smem and grid come from kernels/fused.py::trsm_gemm_plan and
// trsm_gemm_grid; a plan that does not fit its smem is refused. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_trsm_gemm(int dtype, int syrk, int unit_diag,
                               const void* l, long long sl0, long long sl1,
                               const void* ap, long long sap0, long long sap1,
                               const void* bl, long long sbl0, long long sbl1,
                               const void* c, long long sc0, long long sc1,
                               void* x, void* cout, void* xw, void* blt,
                               int nb, int m, int n, int width, int l_smem,
                               int smem, int grid, long long batch,
                               long long slb, long long sapb, long long sblb,
                               long long scb, void* stream) {
  using namespace repro;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const size_t need = dtype == kF64 ? smem_bytes<double>(nb, width, l_smem)
                                    : smem_bytes<float>(nb, width, l_smem);
  if (width < 1 || width > 32 || (width & (width - 1)) != 0 || grid < 1 ||
      need > static_cast<size_t>(smem) || (!syrk && m > 0 && blt == nullptr) ||
      batch < 1 || batch > (1LL << 30))
    return bad;
  Params p{l, sl0, sl1, ap, sap0, sap1, bl, sbl0, sbl1, c, sc0, sc1, x,
           cout, xw, blt, nb, (nb + BK - 1) / BK * BK, m, n,
           (n + PAD - 1) / PAD * PAD, (m + PAD - 1) / PAD * PAD, width,
           l_smem, syrk, unit_diag, static_cast<int>(batch), slb, sapb, sblb,
           scb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float, float>(p, grid, smem, s);
    case kF64: return launch<double, double>(p, grid, smem, s);
    case kBF16: return launch<__nv_bfloat16, float>(p, grid, smem, s);
  }
  return bad;
}
