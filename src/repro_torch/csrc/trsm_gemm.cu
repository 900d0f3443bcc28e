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
// the counterpart of vmap over the TPU kernel) is one launch of a kernel of
// its own, trsm_gemm_batched_kernel, with no grid barrier. One item runs
// trsm_gemm_kernel above, the code a 2-D launch ran before the batch axis.
//
// The task list. Per item: its X column blocks (W columns each), then its C
// tiles. The list puts the solve blocks of `ahead` items (two grids' worth)
// first, then item i's tiles followed by item i + ahead's solve blocks, then
// the last items' tiles, so that a tile seldom waits. CTAs (a persistent
// grid: the co-resident count, or the list's length if that is less) take
// tasks in list order by an integer ticket (atomicAdd). Readiness replaces
// the barrier: a solve block publishes after its xw stores (a barrier, a
// fence, then a count added to its item's counter), and a tile waits, with
// an acquire load of that counter, only for its own item's solve blocks,
// its C tile already on its way. The ticket and the counters sit in a
// zeroed workspace (`sync`); there are no float atomics, so no result
// depends on the schedule.
//
// No deadlock, whatever the grid and whichever CTAs are resident (the launch
// is a plain one): a tile waits only on solve blocks of its item, which come
// earlier in the list, so their tickets were handed out before its own, to
// CTAs that were running when they took them; a solve block waits on
// nothing, so each of them ends, and every wait ends.
//
// The parameters are a __grid_constant__ struct read in place; each task
// forms its item's pointers from the batch strides as scalars, so nothing
// is copied to local memory. The solve runs solve_block's sums in their
// order (four partial sums by q mod 4, then the 16-row diagonal block, each
// value updated in pivot order and then divided), 64 columns a block, with
// L11 staged once per solve task as a packed lower triangle by 16-byte
// copies (element copies for odd strides and bf16); where that does not fit,
// L11 read through the cache (and 32 columns past 64's room); a thread of
// the left-looking update
// holds 2 rows x 2 columns, reading L11 four q at a time, and the diagonal
// block runs row by row on 64 threads. AP is read by 16-byte loads, X
// written four columns a store. "lu" reads BL in place: each stage copies
// BL's [rows][k] window as it lies (16-byte cp.async along BL's unit-stride
// axis) and transposes it into the [k][m] stage between two barriers, so no
// transposed copy is written. The update keeps B1's shapes, 64 x 128 tiles
// for f32 and bf16 ("ffma" 64 x 128 x 16: one FFMA chain per output in k
// order from zero) and 128 x 128 for f64 (mma.sync m16n8k8 over the same k8
// steps); C's tile is staged in shared memory, by one round of copies
// issued as the tile starts (f32, bf16; f64, whose rings leave no room,
// after its products), and c_out is written four columns a store. So item i
// of a batched launch is bitwise the 2-D launch on item i. Its bound is the
// same sum over the items (operations at 64 x (128, 384) f32: 2.82 GFLOP,
// 0.0421 ms at the FP32 peak).
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
  int* sync;        // batched: the ticket, then each item's solved blocks
  int smem_work;    // batched: the ticket's byte offset in shared memory
  // batched: the task list (solve blocks and C tiles an item, C's tile
  // columns; `ahead` items' solves go first, then item i's tiles and item
  // i + ahead's solves, then the last items' tiles: head, body, total)
  int solves, tiles, tiles_n, ahead, head, body, total;
};

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

// ------------------------- the batched kernel --------------------------------

// The split probe (built only with -DREPRO_B2_SPLIT, by tools/b2_split.py):
// thread 0 of each CTA writes %globaltimer at SPLIT_STEPS points of each
// task of a batched launch, indexed by its ticket; the production build has
// none of it.
#ifdef REPRO_B2_SPLIT
constexpr int SPLIT_STEPS = 8, SPLIT_TASKS = 1 << 16;
__device__ unsigned long long g_split[SPLIT_TASKS * SPLIT_STEPS];
__shared__ long long s_split_task;
__device__ __forceinline__ unsigned long long split_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void split_put(int k, unsigned long long v) {
  if (threadIdx.x == 0 && s_split_task < SPLIT_TASKS)
    g_split[s_split_task * SPLIT_STEPS + k] = v;
}
__device__ __forceinline__ void split(int k) { split_put(k, split_now()); }
#else
__device__ __forceinline__ void split(int) {}
#endif

// The batched kernel's solve: X column blocks of W columns in xs
// ([nbp][W + 2]); L11 staged in ls when W is 128 (its lower triangle
// packed, each row padded to a multiple of 4: row r at l_row(r)), else read
// through the cache.
__host__ __device__ constexpr int bxs_ld(int width) { return width + 2; }
constexpr int RAW_LD = BK * 8 + 16;        // "lu"'s raw BL rows, in bytes
__host__ __device__ constexpr int l_row(int r) {
  return 4 * (r / 4 + 1) * (2 * (r / 4) + r % 4);
}

// dynamic shared memory of one batched launch: max(solve, update), then the
// CTA's ticket (an int) at batched_work_bytes
template <typename Acc>
__host__ __device__ size_t batched_work_bytes(int nb, int width, int l_smem) {
  const size_t nbp = (nb + BK - 1) / BK * BK;
  const size_t solve =
      (nbp * bxs_ld(width) + (l_smem ? l_row(static_cast<int>(nbp)) : 0)) *
      sizeof(Acc);
  // the update: B's and syrk's A rings, or lu's B ring, one A stage and
  // BL's raw ring; and the staged C tile
  constexpr int MB = sizeof(Acc) == 8 ? BM : 64;   // tile_rows<Acc>()
  const size_t ring_a = static_cast<size_t>(BK) *
                        (sizeof(Acc) == 8 ? stage_ld<Acc>() : MB) * sizeof(Acc);
  const size_t ring_b = static_cast<size_t>(BK) * stage_ld<Acc>() * sizeof(Acc);
  size_t update = STAGES * ring_b + ring_a + STAGES * MB * RAW_LD;
  if (update < STAGES * (ring_a + ring_b)) update = STAGES * (ring_a + ring_b);
  const size_t ctile = static_cast<size_t>(MB) * BN * sizeof(Acc);
  if (sizeof(Acc) == 4) update += ctile;   // C staged beside the rings
  else if (update < ctile) update = ctile;  // f64: over them, after
  return solve > update ? solve : update;
}
template <typename Acc>
__host__ __device__ size_t batched_smem_bytes(int nb, int width, int l_smem) {
  return batched_work_bytes<Acc>(nb, width, l_smem) + 16;
}

// four (two) consecutive accumulator values from shared memory, one 16-byte
// (8- or 16-byte) load each
__device__ __forceinline__ void lds4(const float* s, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void lds4(const double* s, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(s)[0];
  const double2 b = reinterpret_cast<const double2*>(s)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void lds2(const float* s, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(s);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void lds2(const double* s, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(s);
  v[0] = t.x, v[1] = t.y;
}

// cp.async of `bytes` (0 .. 16) from src, zero-filling the rest of 16
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int BYTES>
__device__ __forceinline__ void cp_async_elem_zfill(void* dst,
                                                    const void* src,
                                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(BYTES), "r"(bytes)
               : "memory");
}

// L11's lower triangle of one item into ls, packed: 16-byte copies of each
// row's whole chunks where the storage is the accumulator and the rows are
// unit-stride and 16-byte aligned, element copies for the rest, odd strides
// and bf16 (converted through registers). The CTA's previous reads of this
// shared memory are done (every task ends on a barrier).
template <typename T, typename Acc>
__device__ __forceinline__ void stage_l11(const Params& p, const T* l,
                                          Acc* ls) {
  const int nb = p.nb;
  if constexpr (sizeof(T) == sizeof(Acc)) {
    constexpr int PER = 16 / sizeof(T);
    const bool vec = p.sl1 == 1 && p.sl0 % PER == 0 &&
                     reinterpret_cast<unsigned long long>(l) % 16 == 0;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (vec) {                             // a warp a row, a lane a chunk
      for (int r = warp; r < nb; r += THREADS / 32) {
        for (int q0 = lane * PER; q0 <= r; q0 += 32 * PER) {
          if (q0 + PER <= nb) {
            cp_async16(&ls[l_row(r) + q0], &l[r * p.sl0 + q0]);
          } else {
            for (int q = q0; q < nb && q <= r; ++q)
              cp_async_elem<sizeof(T)>(&ls[l_row(r) + q], &l[r * p.sl0 + q]);
          }
        }
      }
    } else {
      for (int r = warp; r < nb; r += THREADS / 32)
        for (int q = lane; q <= r; q += 32)
          cp_async_elem<sizeof(T)>(&ls[l_row(r) + q],
                                   &l[r * p.sl0 + q * p.sl1]);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {                                 // bf16: eight loads in flight
    constexpr int U = 8;
    const int count = nb * nb;
    for (int i0 = threadIdx.x; i0 < count; i0 += U * THREADS) {
      Acc v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS, r = i / nb, q = i % nb;
        v[u] = i < count && q <= r ? to_acc(__ldg(&l[r * p.sl0 + q * p.sl1]))
                                   : Acc(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS, r = i / nb, q = i % nb;
        if (i < count && q <= r) ls[l_row(r) + q] = v[u];
      }
    }
  }
  __syncthreads();
}

// four neighbouring values into memory in one access (16-byte aligned; 8
// for bf16)
__device__ __forceinline__ void st4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* o, const double (&v)[4]) {
  reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* o, const float (&v)[4]) {
  store_pair(o, v[0], v[1]);
  store_pair(o + 2, v[2], v[3]);
}

// two neighbouring accumulator values into shared memory in one store
__device__ __forceinline__ void st2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void st2(double* o, double a, double b) {
  *reinterpret_cast<double2*>(o) = make_double2(a, b);
}

// AP's block of one item, AP[:, c0 : c0 + W], into xs at the accumulator
// width, zero past AP, read along AP's unit-stride axis. Where that axis is
// contiguous and 16-byte aligned (f32, f64), by 16-byte loads, eight in
// flight a thread (load_ap_vec): a warp reads 4 neighbouring chunks of 8
// columns (AP's rows unit-stride: 32 chunks of one row), so that its shared
// stores meet no bank twice; else by element loads, sixteen in flight.
template <typename T, typename Acc, int W>
__device__ __forceinline__ void load_ap_vec(const Params& p, const T* ap,
                                            Acc* xs, int c0) {
  constexpr int LD = bxs_ld(W), VP = 16 / sizeof(T), U = 8;
  const int nb = p.nb;
  const bool by_row = p.sap0 == 1;         // AP column-major: walk rows
  const int chunks = (by_row ? p.nbp : W) / VP;      // along the unit axis
  const int count = chunks * (by_row ? W : p.nbp);
  for (int i0 = threadIdx.x; i0 < count; i0 += U * THREADS) {
    Acc v[U][VP];
    int rs[U], cs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      int r, cc;
      if (by_row) {                        // lanes: 4 chunks x 8 columns
        const int rest = i / 32, ch = (rest % (chunks / 4)) * 4 + i % 4;
        r = ch * VP, cc = (rest / (chunks / 4)) * 8 + (i / 4) % 8;
      } else {
        r = i / chunks, cc = (i % chunks) * VP;
      }
      rs[u] = r, cs[u] = cc;
      const int gc = c0 + cc;
      const bool whole = i < count && (by_row ? r + VP <= nb && gc < p.n
                                              : r < nb && gc + VP <= p.n);
      if (whole) {
        const uint4 t = __ldg(
            reinterpret_cast<const uint4*>(ap + r * p.sap0 + gc * p.sap1));
        memcpy(v[u], &t, 16);
      } else {
#pragma unroll
        for (int e = 0; e < VP; ++e) {
          const int re = by_row ? r + e : r, ge = by_row ? gc : gc + e;
          v[u][e] = i < count && re < nb && ge < p.n
                        ? to_acc(__ldg(&ap[re * p.sap0 + ge * p.sap1]))
                        : Acc(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * THREADS >= count) continue;
#pragma unroll
      for (int e = 0; e < VP; e += 2) {
        if (by_row) {
          xs[(rs[u] + e) * LD + cs[u]] = v[u][e];
          xs[(rs[u] + e + 1) * LD + cs[u]] = v[u][e + 1];
        } else {
          st2(xs + rs[u] * LD + cs[u] + e, v[u][e], v[u][e + 1]);
        }
      }
    }
  }
}

template <typename T, typename Acc, int W>
__device__ __forceinline__ void load_ap(const Params& p, const T* ap, Acc* xs,
                                        int c0) {
  constexpr int LD = bxs_ld(W), U = 16;
  const int nb = p.nb, nbp = p.nbp;
  const bool by_row = p.sap0 == 1;
  if constexpr (sizeof(T) == sizeof(Acc)) {
    if ((by_row ? p.sap1 : p.sap0) % (16 / sizeof(T)) == 0 &&
        (by_row || p.sap1 == 1) &&
        reinterpret_cast<unsigned long long>(ap) % 16 == 0) {
      load_ap_vec<T, Acc, W>(p, ap, xs, c0);
      __syncthreads();
      return;
    }
  }
  for (int i0 = threadIdx.x; i0 < nbp * W; i0 += U * THREADS) {
    Acc v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int r = by_row ? i % nbp : i / W, cc = by_row ? i / nbp : i % W;
      const int gc = c0 + cc;
      v[u] = (i < nbp * W && r < nb && gc < p.n)
                 ? to_acc(__ldg(&ap[r * p.sap0 + gc * p.sap1]))
                 : Acc(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int r = by_row ? i % nbp : i / W, cc = by_row ? i / nbp : i % W;
      if (i < nbp * W) xs[r * LD + cc] = v[u];
    }
  }
  __syncthreads();
}

// one column's values of the diagonal block, v[q] for q < rows, row by row:
// each takes its updates in pivot order, FMAs with the pivots already
// divided, then its own division unless UNIT; row4(q, i0, lv) reads L11's
// row q at pivots i0 .. i0 + 3, diag(q) its diagonal. FULL (all 16 rows
// inside L11) has no per-row test, so that the loads may run ahead.
template <bool FULL, bool UNIT, typename Acc, typename Row4, typename Diag>
__device__ __forceinline__ void diag_rows(Acc (&v)[DB], int rows, Row4 row4,
                                          Diag diag) {
#pragma unroll
  for (int q = 0; q < DB; ++q) {
    if (FULL || q < rows) {
#pragma unroll
      for (int i0 = 0; i0 < q; i0 += 4) {
        Acc lv[4];
        row4(q, i0, lv);
#pragma unroll
        for (int i = i0; i < i0 + 4 && i < q; ++i)
          v[q] = fma_acc(-lv[i - i0], v[i], v[q]);
      }
      if constexpr (!UNIT) v[q] = v[q] / diag(q);
    }
  }
}

// X[:, c0 : c0 + W] = L11^{-1} AP[:, c0 : c0 + W] of one item, written to x
// and xw. The order of every sum is solve_block's: a row's left-looking
// update keeps four partial sums by q mod 4 in q order, combined as
// (s0 + s1) + (s2 + s3); then in the 16-row diagonal block each value takes
// its updates in pivot order, each an FMA with the pivot already divided,
// then its own division. Only the mapping differs: in the left-looking
// update a thread owns RR = W / 32 rows x 2 columns of the DB rows (lanes:
// 16 column pairs x 2 runs of RR rows; warps: W / 32 column groups x
// 256 / W row groups) and reads L11 four q at a time in one 16-byte load and
// X two columns at a time in one; the diagonal block runs row by row, so
// that L11's row is read four pivots at a time, on W threads, one column
// each.
template <typename T, typename Acc, int W, bool LS>
__device__ __forceinline__ void batched_solve(const Params& p, const T* l,
                                              const T* ap, T* x, Acc* xw,
                                              const Acc* ls, Acc* xs,
                                              int c0) {
  constexpr int LD = bxs_ld(W), RR = W / 32, CG = W / 32;
  const int tid = threadIdx.x, nb = p.nb, nbp = p.nbp;
  auto lval = [&](int r, int q) -> Acc {
    if constexpr (LS) return ls[l_row(r) + q];
    else return to_acc(__ldg(&l[r * p.sl0 + q * p.sl1]));
  };
  // four neighbours of L11's row r from column q (q % 4 == 0, q + 3 < nb
  // or r's padding)
  auto lrow4 = [&](int r, int q, Acc (&lv)[4]) {
    if constexpr (LS) {
      lds4(ls + l_row(r) + q, lv);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) lv[u] = q + u <= r ? lval(r, q + u) : Acc(0);
    }
  };
  load_ap<T, Acc, W>(p, ap, xs, c0);
  split(2);
#ifdef REPRO_B2_SPLIT
  unsigned long long left_ns = 0;
#endif
  const int warp = tid / 32, lane = tid % 32;
  const int col = 32 * (warp % CG) + 2 * (lane % 16);
  const int rsub = (warp / CG) * 2 * RR + (lane / 16) * RR;
  for (int r0 = 0; r0 < nb; r0 += DB) {
    if (r0 > 0) {
#ifdef REPRO_B2_SPLIT
      const unsigned long long t_left = split_now();
#endif
      // rows r0 + rsub .. + RR - 1 -= L[rows, :r0] X[:r0] at two columns
      Acc s[RR][2][4];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) s[i][j][u] = Acc(0);
      auto step = [&](int q) {
        Acc xv[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) lds2(xs + (q + u) * LD + col, xv[u]);
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          const int r = min(r0 + rsub + i, nb - 1);   // rows past nb: unused
          Acc lv[4];
          lrow4(r, q, lv);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              s[i][j][u] = fma_acc(lv[u], xv[u][j], s[i][j][u]);
        }
      };
      if constexpr (LS) {
#pragma unroll 2
        for (int q = 0; q < r0; q += 4) step(q);
      } else {                           // global loads: fewer in flight
#pragma unroll 1
        for (int q = 0; q < r0; q += 4) step(q);
      }
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int r = r0 + rsub + i;
        if (r < nb)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            xs[r * LD + col + j] -=
                (s[i][j][0] + s[i][j][1]) + (s[i][j][2] + s[i][j][3]);
      }
      __syncthreads();
#ifdef REPRO_B2_SPLIT
      left_ns += split_now() - t_left;
#endif
    }
    // the diagonal block, one column per thread, in registers, row by row
    if (tid < W) {
      Acc v[DB];
#pragma unroll
      for (int i = 0; i < DB; ++i) v[i] = xs[(r0 + i) * LD + tid];
      const int rows = min(DB, nb - r0);
      auto row4 = [&](int q, int i0, Acc(&lv)[4]) { lrow4(r0 + q, r0 + i0, lv); };
      auto diag = [&](int q) { return lval(r0 + q, r0 + q); };
      if (LS && rows == DB) {            // (through the cache: loads wait)
        if (p.unit_diag) diag_rows<true, true>(v, rows, row4, diag);
        else diag_rows<true, false>(v, rows, row4, diag);
      } else {
        if (p.unit_diag) diag_rows<false, true>(v, rows, row4, diag);
        else diag_rows<false, false>(v, rows, row4, diag);
      }
#pragma unroll
      for (int i = 0; i < DB; ++i) xs[(r0 + i) * LD + tid] = v[i];
    }
    __syncthreads();
  }
  split(3);
#ifdef REPRO_B2_SPLIT
  split_put(5, left_ns);
#endif
  // X out, four neighbouring columns a thread: xw whole (zero past X), x
  // in one access where its rows allow
  const bool xvec = p.n % 4 == 0;
  for (int i = tid; i < nbp * W / 4; i += THREADS) {
    const int r = i / (W / 4), cc = (i % (W / 4)) * 4, gc = c0 + cc;
    Acc v[4], h[2];
    lds2(xs + r * LD + cc, h);
    v[0] = h[0], v[1] = h[1];
    lds2(xs + r * LD + cc + 2, h);
    v[2] = h[0], v[3] = h[1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r >= nb || gc + j >= p.n) v[j] = Acc(0);
    st4(xw + static_cast<long long>(r) * p.ldx + gc, v);
    T* xo = x + static_cast<long long>(r) * p.n + gc;
    if (r < nb && xvec && gc + 3 < p.n) {
      st4(xo, v);
    } else if (r < nb) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < p.n) store(xo + j, v[j]);
    }
  }
  __syncthreads();                         // xs is reused by the next task
}

// The batched update's tile: MB x BN, MB = tile_rows<Acc>(): 64 rows for
// f32 and bf16 (B1's "ffma" 64 x 128 x 16: 4 x 8 outputs a thread, half
// the 128-row tile's registers), 128 for f64 (the "dmma" shape). A's
// stages are [BK][a_ld] ([k][m]-major), B's [BK][stage_ld] over BN columns.
template <typename Acc>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(Acc) == 8 ? BM : 64;
}
template <typename Acc>
__host__ __device__ constexpr int a_ld() {
  return sizeof(Acc) == 8 ? stage_ld<Acc>() : tile_rows<Acc>();
}

// one BK-deep stage of COLS columns of a [k][m]-major operand (xw: B, and
// A for "syrk") by cp.async, as load_stage does
template <int COLS, int LD, typename Acc>
__device__ __forceinline__ void load_half(Acc* s, const Acc* a, int lda,
                                          int k0, int col0) {
  constexpr int PER = 16 / sizeof(Acc), ROW = COLS / PER;   // chunks a row
  constexpr int STEP = THREADS / ROW;      // rows apart, one chunk to the next
  const int kk = threadIdx.x / ROW, cc = (threadIdx.x % ROW) * PER;
  const Acc* src = a + static_cast<long long>(k0 + kk) * lda + col0 + cc;
#pragma unroll
  for (int i0 = 0; i0 < BK / STEP; ++i0, src += STEP * lda)
    cp_async16(s + (kk + i0 * STEP) * LD + cc, src);
}

// "lu"'s A stage read in place, as BL holds it: BL[row0 : row0 + MB,
// k0 : k0 + BK] into a raw ring slot ([m][k] in the storage dtype, rows of
// RAW_LD bytes), zero past BL: 16-byte cp.async along k where BL's rows are
// unit-stride and 16-byte aligned, else element loads through registers.
// transpose_bl then writes the slot into the [k][m] stage the products
// read, at the accumulator width: the values blt held, so the products are
// the 2-D kernel's.
template <int MB, typename T>
__device__ __forceinline__ void load_bl(const Params& p, const T* bl,
                                        bool vec, unsigned char* raw, int k0,
                                        int row0) {
  constexpr int PER = 16 / sizeof(T), CH = (BK + PER - 1) / PER;
  if (vec) {
    for (int i = threadIdx.x; i < MB * CH; i += THREADS) {
      const int rr = i / CH, kk = (i % CH) * PER, r = row0 + rr, k = k0 + kk;
      const int live = r < p.m ? min(max(p.nb - k, 0), PER) : 0;
      cp_async16_zfill(raw + rr * RAW_LD + kk * sizeof(T),
                       live ? bl + r * p.sbl0 + k : bl,
                       live * static_cast<int>(sizeof(T)));
    }
  } else {
    constexpr int U = MB * BK / THREADS;
    const int rr = threadIdx.x / (BK / U), kk = (threadIdx.x % (BK / U)) * U;
    const int r = row0 + rr;
    T v[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      v[j] = r < p.m && k0 + kk + j < p.nb
                 ? bl[r * p.sbl0 + (k0 + kk + j) * p.sbl1]
                 : T(0.f);
    T* d = reinterpret_cast<T*>(raw + rr * RAW_LD) + kk;
#pragma unroll
    for (int j = 0; j < U; ++j) d[j] = v[j];
  }
}
template <int MB, int LD, typename T, typename Acc>
__device__ __forceinline__ void transpose_bl(const unsigned char* raw,
                                             Acc* sa) {
  constexpr int U = MB * BK / THREADS;     // 4 (f32, bf16) or 8 (f64)
  const int rr = threadIdx.x % MB, kk = (threadIdx.x / MB) * U;
  constexpr int WORDS = (U * sizeof(T) + 15) / 16;
  uint4 w[WORDS];
  if constexpr (U * sizeof(T) >= 16) {
    const uint4* src =
        reinterpret_cast<const uint4*>(raw + rr * RAW_LD + kk * sizeof(T));
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = src[i];
  } else {                                 // bf16: 8 bytes
    *reinterpret_cast<uint2*>(w) =
        *reinterpret_cast<const uint2*>(raw + rr * RAW_LD + kk * sizeof(T));
  }
  const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int j = 0; j < U; ++j) sa[(kk + j) * LD + rr] = to_acc(v[j]);
}

// f32, 64-row tile: thread (ty, tx) owns rows 4 ty + i, i < 4, and columns
// {4 tx + j, 64 + 4 tx + j}, j < 4; one FFMA chain per output in k order.
// "syrk" unrolls all sixteen k; "lu", whose stages keep more values live,
// IN of them (4 in f32, 2 in bf16), so that no register spills.
template <int IN>
__device__ __forceinline__ void mac_stage64(const float* sa, const float* sb,
                                            float (&acc)[4][8]) {
  constexpr int LA = tile_rows<float>();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto step = [&](int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * LA + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * BN + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * BN + 64 + 4 * tx);
    const float av[4] = {a0.x, a0.y, a0.z, a0.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  };
  if constexpr (IN == 2) {
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) step(kk);
  } else if constexpr (IN == 4) {
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) step(kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) step(kk);
  }
}
template <bool SYRK, typename T>
__device__ __forceinline__ void mac_batched(const float* sa, const float* sb,
                                            float (&acc)[4][8]) {
  mac_stage64<SYRK ? BK : (sizeof(T) == 2 ? 2 : 4)>(sa, sb, acc);
}
template <bool SYRK, typename T>
__device__ __forceinline__ void mac_batched(const double* sa,
                                            const double* sb,
                                            double (&acc)[4][4][4]) {
  mac_stage(sa, sb, acc);
}

// acc += A^T B over K = nbp for one item's tile at (row0, col0), A = xw
// ("syrk") or BL read in place ("lu"), B = xw, through update_loop's ring;
// "lu" lands BL's stages in a raw ring beside it and transposes each into
// one [k][m] stage between two barriers before its products
template <typename T, typename Acc, bool SYRK, typename Frag>
__device__ __forceinline__ void batched_update_loop(const Params& p,
                                                    const T* bl,
                                                    const Acc* xw, Acc* smem,
                                                    int row0, int col0,
                                                    Frag& acc) {
  constexpr int MB = tile_rows<Acc>(), LA = a_ld<Acc>(), LB = stage_ld<Acc>();
  constexpr int SA = BK * LA, SB = BK * LB;
  const int ktiles = p.nbp / BK;
  Acc* sb = smem;                          // STAGES x [BK][LB]
  Acc* sa = smem + STAGES * SB;            // syrk: STAGES x [BK][LA]; lu: 1
  unsigned char* raw = reinterpret_cast<unsigned char*>(sa + SA);
  [[maybe_unused]] bool vec = false;
  if constexpr (!SYRK)
    vec = p.sbl1 == 1 && p.sbl0 % (16 / sizeof(T)) == 0 &&
          reinterpret_cast<unsigned long long>(bl) % 16 == 0;
  auto load = [&](int t, int slot) {
    if constexpr (SYRK)
      load_half<MB, LA>(sa + slot * SA, xw, p.ldx, t * BK, row0);
    else
      load_bl<MB>(p, bl, vec, raw + slot * MB * RAW_LD, t * BK, row0);
    load_half<BN, LB>(sb + slot * SB, xw, p.ldx, t * BK, col0);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ktiles) load(t, t);
    cp_async_commit();                     // empty groups keep the count even
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if constexpr (!SYRK) {
      transpose_bl<MB, LA, T>(raw + (t % STAGES) * MB * RAW_LD, sa);
      __syncthreads();
    }
    const int next = t + STAGES - 1;
    if (next < ktiles) load(next, next % STAGES);
    cp_async_commit();
    mac_batched<SYRK, T>(SYRK ? sa + (t % STAGES) * SA : sa,
                      sb + (t % STAGES) * SB, acc);
  }
  cp_async_wait<0>();
}

// one item's C tile into L2 ahead of its epilogue (unit column stride only)
template <int MB, typename T>
__device__ __forceinline__ void prefetch_tile(const Params& p, const T* c,
                                              int row0, int col0) {
  if (p.sc1 != 1) return;
  constexpr int PER_LINE = 128 / sizeof(T), LINES = BN / PER_LINE;
  for (int i = threadIdx.x; i < MB * LINES; i += THREADS) {
    const int r = row0 + i / LINES, cc = col0 + (i % LINES) * PER_LINE;
    if (r < p.m && cc < p.n)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + r * p.sc0 + cc));
  }
}

// out = C - acc of one item: C's tile staged whole in shared memory by one
// round of copies (stage_c), so that no thread waits on its loads one after
// another; each thread then reads its values from there and writes its
// outputs, neighbours in one access where c_out's rows allow
template <typename T, typename Acc>
__device__ __forceinline__ void item_store(const Params& p, T* cout, int r,
                                           int cc, Acc acc) {
  if (r < p.m && cc < p.n)
    store(&cout[static_cast<long long>(r) * p.n + cc], acc);
}

// C[row0 : row0 + MB, col0 : col0 + BN] of one item into sc ([MB][BN] of
// the storage dtype), zero past C: 16-byte cp.async where C's rows are
// unit-stride and aligned, else element copies (bf16: through registers).
// The CTA's previous reads of sc are done. stage_c_issue commits the copies
// as one group and returns; stage_c waits for them.
template <int MB, typename T>
__device__ __forceinline__ void stage_c_issue(const Params& p, const T* c,
                                              T* sc, int row0, int col0) {
  constexpr int PER = 16 / sizeof(T), CH = BN / PER;
  if (p.sc1 == 1 && p.sc0 % PER == 0 &&
      reinterpret_cast<unsigned long long>(c) % 16 == 0) {
    for (int i = threadIdx.x; i < MB * CH; i += THREADS) {
      const int rr = i / CH, cc = (i % CH) * PER;
      const int r = row0 + rr, col = col0 + cc;
      const int live = r < p.m ? min(max(p.n - col, 0), PER) : 0;
      cp_async16_zfill(sc + rr * BN + cc, live ? c + r * p.sc0 + col : c,
                       live * static_cast<int>(sizeof(T)));
    }
  } else if constexpr (sizeof(T) >= 4) {
    for (int i = threadIdx.x; i < MB * BN; i += THREADS) {
      const int r = row0 + i / BN, col = col0 + i % BN;
      const bool live = r < p.m && col < p.n;
      cp_async_elem_zfill<sizeof(T)>(sc + i,
                                     live ? c + r * p.sc0 + col * p.sc1 : c,
                                     live ? static_cast<int>(sizeof(T)) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < MB * BN; i += THREADS) {
      const int r = row0 + i / BN, col = col0 + i % BN;
      sc[i] = r < p.m && col < p.n ? c[r * p.sc0 + col * p.sc1] : T(0.f);
    }
  }
  cp_async_commit();
}
template <int MB, typename T>
__device__ __forceinline__ void stage_c(const Params& p, const T* c, T* sc,
                                        int row0, int col0) {
  stage_c_issue<MB>(p, c, sc, row0, col0);
  cp_async_wait<0>();
  __syncthreads();
}

// four neighbouring values of a staged C tile at the accumulator width
__device__ __forceinline__ void lds_c4(const float* s, float (&v)[4]) {
  lds4(s, v);
}
__device__ __forceinline__ void lds_c4(const __nv_bfloat16* s, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(s);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a), v[1] = __high2float(a);
  v[2] = __low2float(b), v[3] = __high2float(b);
}

// c_out[tile] = C[tile] - acc of one item, once its X is ready (`ready`
// waits for it); f32 and bf16 stage C first, f64 (whose rings leave no room
// beside it) after the products, prefetched into L2 first
template <typename T, bool SYRK, typename Ready>
__device__ __forceinline__ void batched_tile(const Params& p, long long at,
                                             const float* xw, float* smem,
                                             int row0, int col0,
                                             Ready ready) {
  constexpr int MB = tile_rows<float>();
  const T* c = static_cast<const T*>(p.c) + at * p.scb;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // C's tile lands in its own shared memory while the item's X is awaited
  // and the products run: the oldest copy group, complete at the first
  // stage's wait, published by its barrier
  T* sc = reinterpret_cast<T*>(smem);
  stage_c_issue<MB>(p, c, sc, row0, col0);
  ready();
  split(1);
  batched_update_loop<T, float, SYRK>(
      p, static_cast<const T*>(p.bl) + at * p.sblb, xw, smem + MB * BN, row0,
      col0, acc);
  split(2);
  T* cout = static_cast<T*>(p.cout) + at * p.m * p.n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = p.n % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 4 * ty + i, cc = h * 64 + 4 * tx;
      const int r = row0 + rr, col = col0 + cc;
      float v[4];
      lds_c4(sc + rr * BN + cc, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = v[j] - acc[i][4 * h + j];
      if (vec && r < p.m && col + 3 < p.n) {
        st4(cout + static_cast<long long>(r) * p.n + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) item_store<T>(p, cout, r, col + j, v[j]);
      }
    }
  split(3);
}

template <typename T, bool SYRK, typename Ready>
__device__ __forceinline__ void batched_tile(const Params& p, long long at,
                                             const double* xw, double* smem,
                                             int row0, int col0,
                                             Ready ready) {
  constexpr int MB = tile_rows<double>();
  double acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;
  prefetch_tile<MB>(p, static_cast<const T*>(p.c) + at * p.scb, row0, col0);
  ready();
  split(1);
  batched_update_loop<T, double, SYRK>(
      p, static_cast<const T*>(p.bl) + at * p.sblb, xw, smem, row0, col0, acc);
  split(2);
  __syncthreads();                         // the ring's last reads are done
  T* sc = reinterpret_cast<T*>(smem);
  stage_c<MB>(p, static_cast<const T*>(p.c) + at * p.scb, sc, row0, col0);
  split(4);
  T* cout = static_cast<T*>(p.cout) + at * p.m * p.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * 64 + lane / 4;
  const int c0 = (warp % 4) * 32 + 2 * (lane % 4);
  const bool vec = p.n % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r0 + 16 * i + 8 * h, cc = c0 + 8 * j;
        const int r = row0 + rr, col = col0 + cc;
        double v[2];
        lds2(sc + rr * BN + cc, v);
        v[0] = v[0] - acc[i][j][2 * h];
        v[1] = v[1] - acc[i][j][2 * h + 1];
        if (vec && r < p.m && col + 1 < p.n) {
          *reinterpret_cast<double2*>(cout + static_cast<long long>(r) * p.n +
                                      col) = make_double2(v[0], v[1]);
        } else {
          item_store<T>(p, cout, r, col, v[0]);
          item_store<T>(p, cout, r, col + 1, v[1]);
        }
      }
  split(3);
}

__device__ __forceinline__ int load_acquire(const int* a) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(a)
               : "memory");
  return v;
}

// a batch of items (p.batch > 1), one task list over the items, claimed by
// ticket; SYRK is the form. p.sync holds the ticket, then each item's count
// of finished solve blocks, all zero at the launch.
template <typename T, typename Acc, int W, bool LS, bool SYRK>
__global__ void __launch_bounds__(THREADS, sizeof(Acc) == 4 ? 2 : 1)
trsm_gemm_batched_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* smem = reinterpret_cast<Acc*>(smem_raw);
  int* slot = reinterpret_cast<int*>(smem_raw + p.smem_work);
  Acc* ls = smem;
  Acc* xs = LS ? smem + l_row(p.nbp) : smem;
  int staged = -1;                         // the item whose L11 is in ls
  for (;;) {
    if (threadIdx.x == 0) *slot = atomicAdd(p.sync, 1);
    __syncthreads();
    int u = *slot, item;
    if (u >= p.total) break;
    int solve = -1, tile = 0;              // a solve block, else a C tile
    if (u < p.head) {
      item = u / p.solves, solve = u % p.solves;
    } else if ((u -= p.head) < p.body) {
      const int group = p.solves + p.tiles, r = u % group;
      item = u / group;
      if (r < p.tiles) tile = r;
      else item += p.ahead, solve = r - p.tiles;
    } else {
      u -= p.body;
      item = p.batch - p.ahead + u / p.tiles, tile = u % p.tiles;
    }
#ifdef REPRO_B2_SPLIT
    if (threadIdx.x == 0) s_split_task = *slot;
    split(0);
    split_put(7, (solve >= 0 ? 1ULL << 62 : 0) |
                     static_cast<unsigned long long>(item) << 20 |
                     static_cast<unsigned long long>(solve >= 0 ? solve
                                                                : tile));
#endif
    const long long at = item;
    Acc* xw = static_cast<Acc*>(p.xw) + at * p.nbp * p.ldx;
    if (solve >= 0) {
      const T* l = static_cast<const T*>(p.l) + at * p.slb;
      if (LS && item != staged) {
        stage_l11<T, Acc>(p, l, ls);
        staged = item;
      }
      split(1);
      batched_solve<T, Acc, W, LS>(
          p, l, static_cast<const T*>(p.ap) + at * p.sapb,
          static_cast<T*>(p.x) + at * p.nb * p.n, xw, ls, xs, solve * W);
      split(4);
      // publish: every thread's xw stores (the barrier that ends the
      // solve), then the count, behind a fence (release)
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(p.sync + 1 + item, 1);
      }
    } else {
      staged = -1;                         // the stages overwrite ls
      const int* count = p.sync + 1 + item;
      batched_tile<T, SYRK>(
          p, at, xw, smem, (tile / p.tiles_n) * tile_rows<Acc>(),
          (tile % p.tiles_n) * BN, [&] {
            // acquire: the item's X is written before its tiles read it
            if (threadIdx.x == 0)
              while (load_acquire(count) < p.solves) __nanosleep(64);
            __syncthreads();
          });
    }
  }
}

// one 2-D launch (p.batch == 1): cooperative, for its grid barrier
template <typename T, typename Acc>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = trsm_gemm_kernel<T, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<Params*>(&p)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS), args,
      static_cast<size_t>(smem), stream));
}

// one batched launch (launch_batched below) is a plain launch: no CTA waits
// on one that has not claimed its task yet, so none needs the others
// resident

// f(kernel) for the batched instantiation of a solve width and L11's place
// (64 columns with L11 staged; 64 or 32 with L11 through the cache) and a
// form, or minus the error code of one it lacks
template <typename T, typename Acc, bool SYRK, typename F>
int with_batched(int width, int l_smem, F f) {
  if (l_smem) {
    if (width == 64) return f(trsm_gemm_batched_kernel<T, Acc, 64, true, SYRK>);
  } else {
    if (width == 64) return f(trsm_gemm_batched_kernel<T, Acc, 64, false, SYRK>);
    if (width == 32) return f(trsm_gemm_batched_kernel<T, Acc, 32, false, SYRK>);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}
template <typename T, typename Acc, typename F>
int with_batched(int width, int l_smem, int syrk, F f) {
  return syrk ? with_batched<T, Acc, true>(width, l_smem, f)
              : with_batched<T, Acc, false>(width, l_smem, f);
}

template <typename T, typename Acc>
int launch_batched(const Params& p, int grid, int smem, cudaStream_t stream) {
  const int err = with_batched<T, Acc>(
      p.width, p.l_smem, p.syrk, [&](auto kernel) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        void* args[] = {const_cast<Params*>(&p)};
        return static_cast<int>(cudaLaunchKernel(
            reinterpret_cast<const void*>(kernel), dim3(grid), dim3(THREADS),
            args, static_cast<size_t>(smem), stream));
      });
  return err < 0 ? -err : err;
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

// CTAs of one kernel that fit on the current device at once
template <typename Kernel>
int co_resident(Kernel kernel, int smem) {
  const int per_sm = blocks_per_sm(kernel, smem);
  if (per_sm < 0) return per_sm;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// registers per thread and local-memory bytes per thread of one kernel
template <typename Kernel>
int attributes(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// f<T, Acc>() of a dtype code
template <template <typename, typename> class F, typename... Args>
int by_dtype(int dtype, Args... args) {
  switch (dtype) {
    case kF32: return F<float, float>::run(args...);
    case kF64: return F<double, double>::run(args...);
    case kBF16: return F<__nv_bfloat16, float>::run(args...);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename Acc>
struct CoResident2d {
  static int run(int smem) { return co_resident(trsm_gemm_kernel<T, Acc>, smem); }
};
template <typename T, typename Acc>
struct CoResidentBatched {
  static int run(int width, int l_smem, int syrk, int smem) {
    return with_batched<T, Acc>(width, l_smem, syrk, [&](auto kernel) {
      return co_resident(kernel, smem);
    });
  }
};
template <typename T, typename Acc>
struct Attributes {
  static int run(int batched, int width, int l_smem, int syrk, int* out) {
    if (!batched) return attributes(trsm_gemm_kernel<T, Acc>, out);
    const int err = with_batched<T, Acc>(
        width, l_smem, syrk,
        [&](auto kernel) { return attributes(kernel, out); });
    return err < 0 ? -err : err;
  }
};

}  // namespace
}  // namespace repro

// CTAs of the 2-D kernel (trsm_gemm_kernel) that fit on the current device
// at once with `smem` bytes of dynamic shared memory (blocks per SM x SMs),
// or minus the cudaError_t of the query.
extern "C" int repro_trsm_gemm_co_resident(int dtype, int smem) {
  return repro::by_dtype<repro::CoResident2d>(dtype, smem);
}

// the same for the batched kernel at solve width `width` (64 or 32), L11 in
// shared memory or not (l_smem), of form syrk or lu: its own registers and
// shared memory
extern "C" int repro_trsm_gemm_batched_co_resident(int dtype, int width,
                                                   int l_smem, int syrk,
                                                   int smem) {
  return repro::by_dtype<repro::CoResidentBatched>(dtype, width, l_smem,
                                                   syrk, smem);
}

// out[0] = registers per thread, out[1] = local-memory bytes per thread of
// the 2-D kernel (batched = 0) or of the batched kernel at (width, l_smem,
// syrk); returns the cudaError_t of the query (0 on success)
extern "C" int repro_trsm_gemm_attributes(int batched, int dtype, int width,
                                          int l_smem, int syrk, int* out) {
  const int err = repro::by_dtype<repro::Attributes>(dtype, batched, width,
                                                     l_smem, syrk, out);
  return err < 0 ? -err : err;
}

#ifdef REPRO_B2_SPLIT
// the split probe's stamps: `bytes` of them into `out`
extern "C" int repro_trsm_gemm_split(void* out, long long bytes) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, repro::g_split, static_cast<size_t>(bytes)));
}
#endif

// X (nb x n, contiguous) and C' (m x n, contiguous) from L11 (nb x nb),
// AP (nb x n), BL (m x nb, ignored when syrk) and C (m x n), all strided,
// for each of `batch` items: item i's inputs at the batch strides slb,
// sapb, sblb, scb (elements) from the first's, its outputs and workspaces
// after the previous items'. xw (nbp x ldx a item) is an accumulator-width
// workspace: nbp = nb rounded up to 16, ldx = n rounded up to 128. One item
// runs the 2-D kernel, which for "lu" also takes blt (nbp x ldm, ldm = m
// rounded up to 128); a batch runs the batched kernel, which takes sync,
// 1 + batch ints, all zero, and at most 2^31 - 1 tasks. width, l_smem,
// smem and grid come from kernels/fused.py::trsm_gemm_plan (one item) or
// trsm_gemm_batched_plan, and trsm_gemm_grid; a plan that does not fit its
// smem is refused.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_trsm_gemm(int dtype, int syrk, int unit_diag,
                               const void* l, long long sl0, long long sl1,
                               const void* ap, long long sap0, long long sap1,
                               const void* bl, long long sbl0, long long sbl1,
                               const void* c, long long sc0, long long sc1,
                               void* x, void* cout, void* xw, void* blt,
                               int nb, int m, int n, int width, int l_smem,
                               int smem, int grid, long long batch,
                               long long slb, long long sapb, long long sblb,
                               long long scb, void* sync, void* stream) {
  using namespace repro;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool batched = batch > 1;
  const bool f64 = dtype == kF64;
  const size_t need =
      batched ? (f64 ? batched_smem_bytes<double>(nb, width, l_smem)
                     : batched_smem_bytes<float>(nb, width, l_smem))
              : (f64 ? smem_bytes<double>(nb, width, l_smem)
                     : smem_bytes<float>(nb, width, l_smem));
  const int work = static_cast<int>(
      f64 ? batched_work_bytes<double>(nb, width, l_smem)
          : batched_work_bytes<float>(nb, width, l_smem));
  if (width < 1 || width > 32 * (batched ? 2 : 1) ||
      (width & (width - 1)) != 0 || (batched && width < 32) ||
      (batched && width == 32 && l_smem) || grid < 1 ||
      need > static_cast<size_t>(smem) ||
      (!batched && !syrk && m > 0 && blt == nullptr) ||
      (batched && sync == nullptr) || batch < 1 || batch > (1LL << 30))
    return bad;
  Params p{l, sl0, sl1, ap, sap0, sap1, bl, sbl0, sbl1, c, sc0, sc1, x,
           cout, xw, blt, nb, (nb + BK - 1) / BK * BK, m, n,
           (n + PAD - 1) / PAD * PAD, (m + PAD - 1) / PAD * PAD, width,
           l_smem, syrk, unit_diag, static_cast<int>(batch), slb, sapb, sblb,
           scb, static_cast<int*>(sync), work};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batched) {
    // the task list: `ahead` items' solves, two grids of them, go before
    // the first tiles, so a tile seldom waits for its item's X
    p.solves = p.ldx / width;
    p.tiles_n = (n + BN - 1) / BN;
    const int mb = dtype == kF64 ? tile_rows<double>() : tile_rows<float>();
    p.tiles = m > 0 ? ((m + mb - 1) / mb) * p.tiles_n : 0;
    const int group = p.solves + p.tiles;
    if (batch * group >= (1LL << 31)) return bad;
    p.ahead = (2 * grid + p.solves - 1) / p.solves;
    if (p.ahead > batch) p.ahead = static_cast<int>(batch);
    p.head = p.ahead * p.solves;
    p.body = static_cast<int>((batch - p.ahead) * group);
    p.total = static_cast<int>(batch * group);
    switch (dtype) {
      case kF32: return launch_batched<float, float>(p, grid, smem, s);
      case kF64: return launch_batched<double, double>(p, grid, smem, s);
      case kBF16: return launch_batched<__nv_bfloat16, float>(p, grid, smem, s);
    }
    return bad;
  }
  switch (dtype) {
    case kF32: return launch<float, float>(p, grid, smem, s);
    case kF64: return launch<double, double>(p, grid, smem, s);
    case kBF16: return launch<__nv_bfloat16, float>(p, grid, smem, s);
  }
  return bad;
}
