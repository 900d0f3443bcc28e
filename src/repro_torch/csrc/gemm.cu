// C = epilogue(A @ B [+ bias]) for repro_torch.kernels.gemm (B1) and
// repro_torch.kernels.fused.gemm_bias_act (B3).
//
// Replaces the Pallas TPU kernels repro/kernels/gemm.py::gemm
// (_gemm_kernel) and repro/kernels/fused.py::gemm_bias_act
// (_gemm_epilogue_kernel). On the TPU the K axis is a sequential grid
// dimension carrying a VMEM accumulator; here each CTA owns one output tile
// and loops over K inside the block, so CTAs are independent and run in any
// order (no split-K, no atomics: every output is one fixed-order sum, so a
// result depends only on the inputs and the variant).
//
// Bound: at the main path's shapes (8192^3, 4096^3) the product is bound by
// operations (2mnk flops against (mk+kn+mn) elements moved); the skinny
// products (n <= 16) by the bytes of A. Five variants, which the wrapper
// (kernels/gemm.py::gemm_variant) picks from dtype, shape and layout alone,
// one main loop each, all sharing the epilogue:
//
// - "wgmma" (bf16 -> bf16 / f32): the tensor cores. A 128x256 (4-stage
//   ring) or 128x128 (6-stage ring) CTA tile, 64-deep k stages filled by
//   TMA (128-byte swizzle) and tracked by mbarriers; one producer warp
//   issues the loads, two consumer warpgroups each run wgmma m64nBNk16 on
//   64 rows (A K-major, the row-major B MN-major through the transpose
//   bit), f32 accumulators in registers. Needs unit column strides and
//   16-byte aligned row strides and bases (TMA); ragged edges read TMA's
//   zero fill.
// - "ffma" (f32): IEEE FFMA, never TF32 (the reference tolerance, rtol
//   2e-4, rules TF32 out), so its ceiling is the 67 TFLOP/s FP32 rate. A
//   128x128x16 (256 threads) or 64x128x16 (128 threads) CTA tile in a
//   3-stage cp.async ring, an 8x8 register micro-tile per thread fed by
//   16-byte shared-memory reads. Each output is one FMA chain in k order,
//   as in "simt".
// - "dmma" (f64): the FP64 tensor cores through mma.sync m16n8k8 (IEEE
//   FP64 FMA; only the order of the sums differs from an FFMA chain). A
//   128x128 or 64x128 CTA tile, 32-deep k stages in a 3-stage TMA ring, a
//   producer (a warpgroup at 128 rows, for setmaxnreg; a warp at 64) and
//   one consumer warp per 64x32 block.
//
// The tiled variants are templates on the CTA tile; the wrapper passes the
// tile of the plan it was handed (kernels/gemm.py::launch_tile) and the C
// side launches that instantiation, or refuses a tile it was not compiled
// for. The compiled sets (the default first): wgmma Wg<256>, Wg<128>; ffma
// Ff<128>, Ff<64>; dmma Dm<128>, Dm<64>; mirrored, with each tile's stages,
// by core/codesign.py::HOPPER_TILES.
// - "gemv" (any dtype; n <= 16, m > 16, A with a unit column stride): the
//   blocked TRSM's 128 x k x nrhs updates and linalg.gemv. K is split over
//   the CTAs so that all SMs stream A, and the partials are summed in a
//   fixed order by a second pass (below).
// - "simt" (any dtype, any strides): the first port's 64x64x16 tile with a
//   4x4 micro-tile and synchronous loads. It takes the products with m <= 16
//   or a transposed skinny A, and the layouts the tiled variants cannot read
//   (transposed or misaligned views).
//
// The bias (length n, contiguous) and the activation are applied to the
// register accumulator, in the accumulator type, before the single store.
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

// variant codes shared with repro_torch/kernels/gemm.py::VARIANTS ("gemv",
// the fifth, has its own entry point, repro_gemv)
enum Variant : int { kSimt = 0, kWgmma = 1, kFfma = 2, kDmma = 3 };

// bias + activation on one accumulator value, then the narrowing store
template <typename T, typename Acc, typename TO>
__device__ __forceinline__ void finish(TO* p, Acc v, const T* bias, int col,
                                       int epilogue) {
  if (bias != nullptr) v += to_acc(bias[col]);
  store(p, activate(v, epilogue));
}

// grouped tile order: GROUP_M row tiles share each column sweep, so the
// CTAs in flight reuse A and B tiles in L2
__device__ __forceinline__ void tile_of(int id, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  constexpr int GROUP_M = 16;
  const int per_group = GROUP_M * tiles_n;
  const int first = (id / per_group) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  tm = first + (id % per_group) % rows;
  tn = (id % per_group) / rows;
}

// ------------------------------- "simt" --------------------------------------

namespace simt {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
}

template <typename T, typename Acc, typename TO>
__global__ void __launch_bounds__(simt::THREADS)
gemm_simt_kernel(const T* __restrict__ a, long long sa0, long long sa1,
                 const T* __restrict__ b, long long sb0, long long sb1,
                 const T* __restrict__ bias, int epilogue,
                 TO* __restrict__ c, long long sc0, int m, int n, int k) {
  using namespace simt;
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
      if (cc < n) finish(&c[r * sc0 + cc], acc[i][j], bias, cc, epilogue);
    }
  }
}

// ------------------------------- "wgmma" -------------------------------------

// the compiled wgmma tiles: BM 128, BK 64, BN 256 (4 stages) or 128 (6)
template <int BN_>
struct Wg {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int CONSUMERS = 2;                       // warpgroups of 64 rows
  static constexpr int THREADS = CONSUMERS * 128 + 32;      // + one producer warp
  static constexpr int A_BYTES = BM * BK * 2;               // [128 m][64 k], K-major
  static constexpr int B_CHUNK = BK * 64 * 2;               // one [64 k][64 n] box
  static constexpr int B_BYTES = (BN / 64) * B_CHUNK;       // MN-major, BN / 64 boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

template <int BN, typename TO>
__global__ void __launch_bounds__(Wg<BN>::THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __nv_bfloat16* __restrict__ bias, int epilogue,
                  TO* __restrict__ c, long long sc0, int m, int n, int k) {
  using W = Wg<BN>;
  using namespace hopper;
  constexpr int BM = W::BM, BK = W::BK, STAGES = W::STAGES;
  constexpr int CONSUMERS = W::CONSUMERS, A_BYTES = W::A_BYTES;
  constexpr int B_CHUNK = W::B_CHUNK, STAGE_BYTES = W::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int tm, tn;
  tile_of(blockIdx.x, (m + BM - 1) / BM, (n + BN - 1) / BN, tm, tn);
  const int ktiles = (k + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int group = threadIdx.x / 128;

  if (group == CONSUMERS) {                  // the producer warp
    if (threadIdx.x % 32 == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        uint8_t* sa = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(sa, &map_a, &full[s], t * BK, tm * BM);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(sa + A_BYTES + j * B_CHUNK, &map_b, &full[s],
                      tn * BN + 64 * j, t * BK);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < ktiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* sa = smem + s * STAGE_BYTES + group * 64 * 128;
    const uint8_t* sb = smem + s * STAGE_BYTES + A_BYTES;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_sw128(sa + 32 * kk, 16, 1024);
      const uint64_t db = desc_sw128(sb + 2048 * kk, B_CHUNK, 1024);
      if constexpr (BN == 256)
        wgmma_m64n256k16_ss<0, 1>(acc, da, db);
      else
        wgmma_m64n128k16_ss<0, 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }

  // accumulator fragment: register i of lane l in warp w holds row
  // 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = tm * BM + group * 64 + warp * 16 + lane / 4;
  const bool pairs = sc0 % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = tn * BN + 8 * j + 2 * (lane % 4);
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      TO* p = c + row * sc0 + col;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (bias != nullptr) {
        v0 += to_acc(bias[col]);
        if (col + 1 < n) v1 += to_acc(bias[col + 1]);
      }
      v0 = activate(v0, epilogue);
      v1 = activate(v1, epilogue);
      if (pairs && col + 1 < n) {
        store_pair(p, v0, v1);
      } else {
        store(p, v0);
        if (col + 1 < n) store(p + 1, v1);
      }
    }
  }
}

// ------------------------------- "ffma" --------------------------------------

// the compiled ffma tiles: BN 128, BK 16, BM 128 (256 threads) or 64 (128);
// every thread holds an 8x8 micro-tile
template <int BM_>
struct Ff {
  static constexpr int BM = BM_, BN = 128, BK = 16, STAGES = 3;
  static constexpr int THREADS = BM * BN / 64;
  struct Stage {
    float a[BM][BK + 4];   // the pad keeps the rows 16-byte aligned for cp.async
    float b[BK][BN];
  };
  static constexpr int SMEM = STAGES * sizeof(Stage);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes of a 16-byte chunk (four floats) that lie inside [0, limit) from
// element `idx` on
__device__ __forceinline__ int chunk_bytes(int idx, int limit) {
  const int left = (limit - idx) * 4;
  return left <= 0 ? 0 : (left >= 16 ? 16 : left);
}

// one BM x BK tile of A and one BK x BN tile of B (both row-major, rows
// 16-byte aligned) into a stage; cells past the matrix read as zero
template <int BM>
__device__ __forceinline__ void load_stage(typename Ff<BM>::Stage& st,
                                           const float* a, long long sa0,
                                           const float* b, long long sb0,
                                           int row0, int col0, int k0, int m,
                                           int n, int k) {
  using F = Ff<BM>;
  constexpr int BK = F::BK, BN = F::BN, THREADS = F::THREADS;
  constexpr int A_CHUNKS = BM * BK / 4, B_CHUNKS = BK * BN / 4;
  static_assert(A_CHUNKS % THREADS == 0 && B_CHUNKS % THREADS == 0, "");
#pragma unroll
  for (int s = 0; s < A_CHUNKS / THREADS; ++s) {
    const int i = threadIdx.x + s * THREADS;
    const int r = i / (BK / 4), cc = (i % (BK / 4)) * 4;
    const int gr = row0 + r, gk = k0 + cc;
    const int bytes = gr < m ? chunk_bytes(gk, k) : 0;
    cp_async16(&st.a[r][cc], bytes ? a + gr * sa0 + gk : a, bytes);
  }
#pragma unroll
  for (int s = 0; s < B_CHUNKS / THREADS; ++s) {
    const int i = threadIdx.x + s * THREADS;
    const int r = i / (BN / 4), cc = (i % (BN / 4)) * 4;
    const int gk = k0 + r, gc = col0 + cc;
    const int bytes = gk < k ? chunk_bytes(gc, n) : 0;
    cp_async16(&st.b[r][cc], bytes ? b + gk * sb0 + gc : b, bytes);
  }
}

// thread (ty, tx) owns rows {4 ty + i, BM / 2 + 4 ty + i} and columns
// {4 tx + j, 64 + 4 tx + j}, i, j < 4: one FFMA chain per output, in k order
template <int BM>
__device__ __forceinline__ void ffma_stage(const typename Ff<BM>::Stage& st,
                                           float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k4 = 0; k4 < Ff<BM>::BK; k4 += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          &st.a[(i / 4) * (BM / 2) + 4 * ty + i % 4][k4]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(&st.b[k4 + kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&st.b[k4 + kk][64 + 4 * tx]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = kk == 0 ? av[i].x
                         : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(ai, bv[j], acc[i][j]);
      }
    }
  }
}

// the main loop keeps STAGES - 1 stages in flight while the block multiplies
// the oldest; one barrier per stage both publishes the stage just waited for
// and frees the one multiplied last, which the next load refills
template <int BM>
__global__ void __launch_bounds__(Ff<BM>::THREADS, 1)
gemm_ffma_kernel(const float* __restrict__ a, long long sa0,
                 const float* __restrict__ b, long long sb0,
                 const float* __restrict__ bias, int epilogue,
                 float* __restrict__ c, long long sc0, int m, int n, int k) {
  using F = Ff<BM>;
  constexpr int BN = F::BN, BK = F::BK, STAGES = F::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  auto* st = reinterpret_cast<typename F::Stage*>(smem_raw);
  int tm, tn;
  tile_of(blockIdx.x, (m + BM - 1) / BM, (n + BN - 1) / BN, tm, tn);
  const int row0 = tm * BM, col0 = tn * BN;
  const int ktiles = (k + BK - 1) / BK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ktiles)
      load_stage<BM>(st[t], a, sa0, b, sb0, row0, col0, t * BK, m, n, k);
    cp_async_commit();                  // empty groups keep the count even
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ktiles)
      load_stage<BM>(st[next % STAGES], a, sa0, b, sb0, row0, col0,
                     next * BK, m, n, k);
    cp_async_commit();
    ffma_stage<BM>(st[t % STAGES], acc);
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i / 4) * (BM / 2) + 4 * ty + i % 4;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = col0 + (j / 4) * 64 + 4 * tx + j % 4;
      if (cc < n) finish(&c[r * sc0 + cc], acc[i][j], bias, cc, epilogue);
    }
  }
}

// ------------------------------- "dmma" --------------------------------------
//
// f64 on the FP64 tensor cores. A BM x 128 CTA tile, 32-deep k stages in a
// 3-stage ring filled by TMA and tracked by full / empty mbarriers: one
// producer warp (8 lanes issuing loads) and BM / 16 consumer warps, each
// multiplying a 64x32 block with mma.sync m16n8k8 (64 f64 accumulators in
// registers). TMA writes each operand as boxes four doubles wide (A:
// [k / 4][BM m][4 k],
// B: [n / 4][32 k][4 n]), so the 32 bytes a lane group reads for one
// fragment row are contiguous and a half-warp's 16 reads cover 128 distinct
// bytes: no bank conflicts and no padding, which TMA cannot write.

// the compiled dmma tiles: BN 128, BK 32, BM 128 or 64. One consumer warp
// per 64x32 block; the producer is a warpgroup at BM 128 (setmaxnreg moves
// registers between the warpgroups of a CTA, so the consumers' 232 come
// from the four producer warps dropping from the 168 a 384-thread launch
// gets to 40) and one warp at BM 64 (a 160-thread launch leaves every
// thread the registers the accumulators need, no setmaxnreg)
template <int BM_>
struct Dm {
  static constexpr int BM = BM_, BN = 128, BK = 32, STAGES = 3;
  static constexpr int CONSUMERS = (BM / 64) * (BN / 32);   // warps
  static constexpr bool SETMAXNREG = BM == 128;
  static constexpr int THREADS = CONSUMERS * 32 + (SETMAXNREG ? 128 : 32);
  static constexpr int A_BOX = BM * 4 * 8, B_BOX = BK * 4 * 8;  // bytes per box
  static constexpr int A_BYTES = (BK / 4) * A_BOX, B_BYTES = (BN / 4) * B_BOX;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// warp w owns the 64 x 32 block at rows 64 (w / 4), columns 32 (w % 4), as
// 4 x 4 mma.sync m16n8k8 tiles. With g = lane / 4, t = lane % 4: A register r
// holds row g + 8 (r % 2), column t + 4 (r / 2) of its 16 x 8 slice; B
// register r holds row t + 4 r, column g; C register r holds row g + 8 (r / 2),
// column 2 t + r % 2. (m8n8k4 runs at half this shape's rate on the H100:
// src/repro_torch/tools/f64_mma_rate.cu.)
template <int BM>
__device__ __forceinline__ void dmma_stage(const uint8_t* sa, const uint8_t* sb,
                                           double (&acc)[4][4][4]) {
  using D = Dm<BM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 64 + g;
  // column c0 + 8 j sits in B box c0 / 4 + 2 j at offset g % 4
  const uint8_t* bcol = sb + ((warp % 4) * 8 + g / 4) * D::B_BOX + (g % 4) * 8;
#pragma unroll
  for (int k8 = 0; k8 < D::BK; k8 += 8) {
    double bv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bv[j][r] = *reinterpret_cast<const double*>(
            bcol + 2 * j * D::B_BOX + (k8 + t + 4 * r) * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      double av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const double*>(
            sa + (k8 / 4 + r / 2) * D::A_BOX +
            (r0 + 16 * i + 8 * (r % 2)) * 32 + t * 8);
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

template <int BM>
__global__ void __launch_bounds__(Dm<BM>::THREADS, 1)
gemm_dmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const double* __restrict__ bias, int epilogue,
                 double* __restrict__ c, long long sc0, int m, int n, int k) {
  using namespace hopper;
  using D = Dm<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + D::STAGES * D::STAGE_BYTES);
  uint64_t* empty = full + D::STAGES;
  int tm, tn;
  tile_of(blockIdx.x, (m + BM - 1) / BM, (n + D::BN - 1) / D::BN, tm, tn);
  const int ktiles = (k + D::BK - 1) / D::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], D::CONSUMERS);    // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= D::CONSUMERS) {                // the producer
    if constexpr (D::SETMAXNREG) setmaxnreg_dec<40>();
    if (warp > D::CONSUMERS) return;         // one warp issues the loads
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % D::STAGES;
      mbar_wait(&empty[s], ((t / D::STAGES) & 1) ^ 1);
      uint8_t* sa = smem + s * D::STAGE_BYTES;
      uint8_t* sb = sa + D::A_BYTES;
      if (lane == 0) mbar_expect_tx(&full[s], D::STAGE_BYTES);
      __syncwarp();
      if (lane < D::BK / 4) {                // lane q: A box q, B boxes 4q..
        tma_load_2d(sa + lane * D::A_BOX, &map_a, &full[s],
                    t * D::BK + 4 * lane, tm * BM);
#pragma unroll
        for (int q = 4 * lane; q < 4 * lane + 4; ++q)
          tma_load_2d(sb + q * D::B_BOX, &map_b, &full[s],
                      tn * D::BN + 4 * q, t * D::BK);
      }
    }
  } else {
    if constexpr (D::SETMAXNREG) setmaxnreg_inc<232>();
    double acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % D::STAGES;
      mbar_wait(&full[s], (t / D::STAGES) & 1);
      const uint8_t* sa = smem + s * D::STAGE_BYTES;
      dmma_stage<BM>(sa, sa + D::A_BYTES, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int r0 = tm * BM + (warp / 4) * 64 + lane / 4;
    const int c0 = tn * D::BN + (warp % 4) * 32 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * i + 8 * h;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = c0 + 8 * j + e;
            if (cc < n)
              finish(&c[r * sc0 + cc], acc[i][j][2 * h + e], bias, cc,
                     epilogue);
          }
      }
  }
}

template <int BM>
int launch_dmma(const void* a, long long sa0, const void* b, long long sb0,
                const void* bias, int epilogue, void* c, long long sc0, int m,
                int n, int k, cudaStream_t stream) {
  using D = Dm<BM>;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {cuuint64_t(k), cuuint64_t(m)};
  const cuuint64_t dims_b[2] = {cuuint64_t(n), cuuint64_t(k)};
  const cuuint64_t stride_a[1] = {cuuint64_t(sa0) * 8};
  const cuuint64_t stride_b[1] = {cuuint64_t(sb0) * 8};
  const cuuint32_t box_a[2] = {4, BM}, box_b[2] = {4, D::BK};
  int err = hopper::make_map(&map_a, a, 2, dims_a, stride_a, box_a,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = hopper::make_map(&map_b, b, 2, dims_b, stride_b, box_b,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_dmma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      D::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>((m + BM - 1) / BM) *
                          ((n + D::BN - 1) / D::BN);
  gemm_dmma_kernel<BM><<<static_cast<unsigned>(tiles), D::THREADS, D::SMEM,
                         stream>>>(map_a, map_b,
                                   static_cast<const double*>(bias), epilogue,
                                   static_cast<double*>(c), sc0, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- "gemv" --------------------------------------
//
// n <= 16 outputs per row (the blocked TRSM's 128 x k x nrhs updates,
// linalg.gemv): bound by the bytes of A. The grid is (K segments) x (row
// groups of 16), sized by the wrapper (kernels/gemm.py::gemv_split) so that
// every SM streams A. Each warp owns two rows of its CTA's group; a lane
// reads VEC consecutive k of each row per step (16-byte loads when A's base
// and row stride are 16-byte aligned, scalar loads otherwise) against B's
// segment, staged in shared memory at the accumulator width from any
// strides. A fixed xor-shuffle tree sums the warp. One segment writes C
// directly; several write partials that gemv_final sums in segment order.
// No atomics: every output is one fixed-order sum.

namespace gv {
constexpr int THREADS = 256, WARPS = THREADS / 32, ROWS = 2;   // per warp
constexpr int BM = WARPS * ROWS;        // rows per CTA
constexpr int KC = 256;                 // k per staged chunk of B
}  // namespace gv

// V consecutive values of A at p (16-byte aligned when V > 1) as Acc
template <int V, typename T, typename Acc>
__device__ __forceinline__ void load_row(const T* p, Acc (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_acc(__ldg(p));
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte load");
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    T t[V];
    memcpy(t, &w, 16);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = to_acc(t[v]);
  }
}

template <typename T, typename Acc, typename TO, int NB, int V>
__global__ void __launch_bounds__(gv::THREADS)
gemm_gemv_kernel(const T* __restrict__ a, long long sa0,
                 const T* __restrict__ b, long long sb0, long long sb1,
                 const T* __restrict__ bias, int epilogue,
                 TO* __restrict__ c, long long sc0,
                 Acc* __restrict__ partials, int m, int n, int k, int ks) {
  using namespace gv;
  __shared__ __align__(16) Acc bs[NB][KC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM + warp * ROWS;
  const int kbeg = blockIdx.x * ks, kend = min(k, kbeg + ks);
  Acc acc[ROWS][NB];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[r][j] = Acc(0);
  // B's rows contiguous (n > 1, row-major): neighbouring threads take
  // neighbouring columns; else neighbouring k
  const bool by_col = sb1 == 1 && sb0 != 1;
  for (int kc0 = kbeg; kc0 < kend; kc0 += KC) {
    __syncthreads();                         // the previous chunk is read
    for (int i = threadIdx.x; i < NB * KC; i += THREADS) {
      const int j = by_col ? i % NB : i / KC, kk = by_col ? i / NB : i % KC;
      const int gk = kc0 + kk;
      bs[j][kk] = (j < n && gk < kend) ? to_acc(b[gk * sb0 + j * sb1]) : Acc(0);
    }
    __syncthreads();
    for (int kk = lane * V; kk < KC && kc0 + kk < kend; kk += 32 * V) {
      const int gk = kc0 + kk;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r;
        if (row >= m) continue;
        const T* p = a + row * sa0 + gk;
        Acc av[V];
        if (gk + V <= kend) {
          load_row<V>(p, av);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            av[v] = gk + v < kend ? to_acc(p[v]) : Acc(0);
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int j = 0; j < NB; ++j)
            acc[r][j] = fma_acc(av[v], bs[j][kk + v], acc[r][j]);
      }
    }
  }
  // the xor tree leaves the same sum on every lane; lane j stores column j
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Acc v = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(~0u, v, off);
      if (lane != j || j >= n || row >= m) continue;
      if (gridDim.x == 1)
        finish(&c[row * sc0 + j], v, bias, j, epilogue);
      else
        partials[(static_cast<long long>(blockIdx.x) * m + row) * n + j] = v;
    }
  }
}

// C[row, j] = epilogue(sum over segments, in order, of the partials)
template <typename T, typename Acc, typename TO>
__global__ void __launch_bounds__(gv::THREADS)
gemm_gemv_final(const Acc* __restrict__ partials, int segs,
                const T* __restrict__ bias, int epilogue, TO* __restrict__ c,
                long long sc0, int m, int n) {
  const int i = blockIdx.x * gv::THREADS + threadIdx.x;
  if (i >= m * n) return;
  const int row = i / n, j = i % n;
  Acc s = Acc(0);
  for (int seg = 0; seg < segs; ++seg)
    s += partials[(static_cast<long long>(seg) * m + row) * n + j];
  finish(&c[row * sc0 + j], s, bias, j, epilogue);
}

template <typename T, typename Acc, typename TO, int NB>
int launch_gemv_nb(bool vec, const void* a, long long sa0, const void* b,
                   long long sb0, long long sb1, const void* bias,
                   int epilogue, void* c, long long sc0, void* partials,
                   int m, int n, int k, int ks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int segs = (k + ks - 1) / ks;
  const dim3 grid(segs, (m + gv::BM - 1) / gv::BM);
  auto kernel = vec ? gemm_gemv_kernel<T, Acc, TO, NB, V>
                    : gemm_gemv_kernel<T, Acc, TO, NB, 1>;
  kernel<<<grid, gv::THREADS, 0, stream>>>(
      static_cast<const T*>(a), sa0, static_cast<const T*>(b), sb0, sb1,
      static_cast<const T*>(bias), epilogue, static_cast<TO*>(c), sc0,
      static_cast<Acc*>(partials), m, n, k, ks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || segs == 1) return static_cast<int>(err);
  gemm_gemv_final<T, Acc, TO>
      <<<(m * n + gv::THREADS - 1) / gv::THREADS, gv::THREADS, 0, stream>>>(
          static_cast<const Acc*>(partials), segs,
          static_cast<const T*>(bias), epilogue, static_cast<TO*>(c), sc0, m,
          n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc, typename TO>
int launch_gemv(bool vec, const void* a, long long sa0, const void* b,
                long long sb0, long long sb1, const void* bias, int epilogue,
                void* c, long long sc0, void* partials, int m, int n, int k,
                int ks, cudaStream_t s) {
  if (n <= 1)
    return launch_gemv_nb<T, Acc, TO, 1>(vec, a, sa0, b, sb0, sb1, bias,
                                         epilogue, c, sc0, partials, m, n, k,
                                         ks, s);
  if (n <= 4)
    return launch_gemv_nb<T, Acc, TO, 4>(vec, a, sa0, b, sb0, sb1, bias,
                                         epilogue, c, sc0, partials, m, n, k,
                                         ks, s);
  return launch_gemv_nb<T, Acc, TO, 16>(vec, a, sa0, b, sb0, sb1, bias,
                                        epilogue, c, sc0, partials, m, n, k,
                                        ks, s);
}

// -------------------------------- dispatch -----------------------------------

bool aligned16(const void* p, long long stride, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (stride * elem) % 16 == 0;
}

int gemv(int dtype, int out_dtype, const void* a, long long sa0,
         const void* b, long long sb0, long long sb1, const void* bias,
         int epilogue, void* c, long long sc0, void* partials, int m, int n,
         int k, int ks, cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || n > 16 || k < 1 || ks < 1 || ks % gv::KC != 0 ||
      ((k + ks - 1) / ks > 1 && partials == nullptr))
    return bad;
  const int elem = dtype == kF64 ? 8 : dtype == kF32 ? 4 : 2;
  const bool vec = aligned16(a, sa0, elem);
  if (dtype == kF32 && out_dtype == kF32)
    return launch_gemv<float, float, float>(vec, a, sa0, b, sb0, sb1, bias,
                                            epilogue, c, sc0, partials, m, n,
                                            k, ks, s);
  if (dtype == kF64 && out_dtype == kF64)
    return launch_gemv<double, double, double>(vec, a, sa0, b, sb0, sb1, bias,
                                               epilogue, c, sc0, partials, m,
                                               n, k, ks, s);
  if (dtype == kBF16 && out_dtype == kBF16)
    return launch_gemv<__nv_bfloat16, float, __nv_bfloat16>(
        vec, a, sa0, b, sb0, sb1, bias, epilogue, c, sc0, partials, m, n, k,
        ks, s);
  if (dtype == kBF16 && out_dtype == kF32)
    return launch_gemv<__nv_bfloat16, float, float>(
        vec, a, sa0, b, sb0, sb1, bias, epilogue, c, sc0, partials, m, n, k,
        ks, s);
  return bad;
}

template <typename T, typename Acc, typename TO>
int launch_simt(const void* a, long long sa0, long long sa1, const void* b,
                long long sb0, long long sb1, const void* bias, int epilogue,
                void* c, long long sc0, int m, int n, int k,
                cudaStream_t stream) {
  const dim3 grid((n + simt::BN - 1) / simt::BN, (m + simt::BM - 1) / simt::BM);
  gemm_simt_kernel<T, Acc, TO><<<grid, simt::THREADS, 0, stream>>>(
      static_cast<const T*>(a), sa0, sa1, static_cast<const T*>(b), sb0, sb1,
      static_cast<const T*>(bias), epilogue, static_cast<TO*>(c), sc0, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename TO>
int launch_wgmma(const void* a, long long sa0, const void* b, long long sb0,
                 const void* bias, int epilogue, void* c, long long sc0, int m,
                 int n, int k, cudaStream_t stream) {
  using W = Wg<BN>;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {cuuint64_t(k), cuuint64_t(m)};
  const cuuint64_t dims_b[2] = {cuuint64_t(n), cuuint64_t(k)};
  const cuuint64_t stride_a[1] = {cuuint64_t(sa0) * 2};
  const cuuint64_t stride_b[1] = {cuuint64_t(sb0) * 2};
  const cuuint32_t box_a[2] = {W::BK, W::BM}, box_b[2] = {64, W::BK};
  int err = hopper::make_map(&map_a, a, 2, dims_a, stride_a, box_a);
  if (err == 0) err = hopper::make_map(&map_b, b, 2, dims_b, stride_b, box_b);
  if (err != 0) return err;
  auto kernel = gemm_wgmma_kernel<BN, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles =
      static_cast<long long>((m + W::BM - 1) / W::BM) * ((n + BN - 1) / BN);
  kernel<<<static_cast<unsigned>(tiles), W::THREADS, W::SMEM, stream>>>(
      map_a, map_b, static_cast<const __nv_bfloat16*>(bias), epilogue,
      static_cast<TO*>(c), sc0, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_ffma(const void* a, long long sa0, const void* b, long long sb0,
                const void* bias, int epilogue, void* c, long long sc0, int m,
                int n, int k, cudaStream_t stream) {
  using F = Ff<BM>;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_ffma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>((m + BM - 1) / BM) *
                          ((n + F::BN - 1) / F::BN);
  gemm_ffma_kernel<BM><<<static_cast<unsigned>(tiles), F::THREADS, F::SMEM,
                         stream>>>(static_cast<const float*>(a), sa0,
                                   static_cast<const float*>(b), sb0,
                                   static_cast<const float*>(bias), epilogue,
                                   static_cast<float*>(c), sc0, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// is (bm, bn, bk) the tile of instantiation T?
template <typename T>
bool is_tile(int bm, int bn, int bk) {
  return bm == T::BM && bn == T::BN && bk == T::BK;
}

// launches `variant` at the CTA tile (bm, bn, bk); cudaErrorInvalidValue
// when the variant does not take these dtypes or this layout, or was not
// compiled for this tile (the wrapper never asks for that: it picks the
// variant from the same facts, kernels/gemm.py::gemm_variant, and the tile
// from the compiled set, kernels/gemm.py::launch_tile). "simt" has one tile.
int dispatch(int variant, int bm, int bn, int bk, int dtype, int out_dtype,
             const void* a, long long sa0, long long sa1, const void* b,
             long long sb0, long long sb1, const void* bias, int epilogue,
             void* c, long long sc0, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (variant == kSimt) {
    if (bm != simt::BM || bn != simt::BN || bk != simt::BK) return bad;
    if (dtype == kF32 && out_dtype == kF32)
      return launch_simt<float, float, float>(a, sa0, sa1, b, sb0, sb1, bias,
                                              epilogue, c, sc0, m, n, k, s);
    if (dtype == kF64 && out_dtype == kF64)
      return launch_simt<double, double, double>(
          a, sa0, sa1, b, sb0, sb1, bias, epilogue, c, sc0, m, n, k, s);
    if (dtype == kBF16 && out_dtype == kBF16)
      return launch_simt<__nv_bfloat16, float, __nv_bfloat16>(
          a, sa0, sa1, b, sb0, sb1, bias, epilogue, c, sc0, m, n, k, s);
    if (dtype == kBF16 && out_dtype == kF32)
      return launch_simt<__nv_bfloat16, float, float>(
          a, sa0, sa1, b, sb0, sb1, bias, epilogue, c, sc0, m, n, k, s);
    return bad;
  }
  const int elem = dtype == kF64 ? 8 : dtype == kF32 ? 4 : 2;
  if (sa1 != 1 || sb1 != 1 || !aligned16(a, sa0, elem) ||
      !aligned16(b, sb0, elem))
    return bad;
  if (variant == kWgmma && dtype == kBF16 &&
      (out_dtype == kBF16 || out_dtype == kF32)) {
    const bool f32 = out_dtype == kF32;
    if (is_tile<Wg<256>>(bm, bn, bk))
      return f32 ? launch_wgmma<256, float>(a, sa0, b, sb0, bias, epilogue, c,
                                            sc0, m, n, k, s)
                 : launch_wgmma<256, __nv_bfloat16>(a, sa0, b, sb0, bias,
                                                    epilogue, c, sc0, m, n, k,
                                                    s);
    if (is_tile<Wg<128>>(bm, bn, bk))
      return f32 ? launch_wgmma<128, float>(a, sa0, b, sb0, bias, epilogue, c,
                                            sc0, m, n, k, s)
                 : launch_wgmma<128, __nv_bfloat16>(a, sa0, b, sb0, bias,
                                                    epilogue, c, sc0, m, n, k,
                                                    s);
    return bad;
  }
  if (variant == kFfma && dtype == kF32 && out_dtype == kF32) {
    if (is_tile<Ff<128>>(bm, bn, bk))
      return launch_ffma<128>(a, sa0, b, sb0, bias, epilogue, c, sc0, m, n, k,
                              s);
    if (is_tile<Ff<64>>(bm, bn, bk))
      return launch_ffma<64>(a, sa0, b, sb0, bias, epilogue, c, sc0, m, n, k,
                             s);
    return bad;
  }
  if (variant == kDmma && dtype == kF64 && out_dtype == kF64) {
    if (is_tile<Dm<128>>(bm, bn, bk))
      return launch_dmma<128>(a, sa0, b, sb0, bias, epilogue, c, sc0, m, n, k,
                              s);
    if (is_tile<Dm<64>>(bm, bn, bk))
      return launch_dmma<64>(a, sa0, b, sb0, bias, epilogue, c, sc0, m, n, k,
                             s);
    return bad;
  }
  return bad;
}

}  // namespace
}  // namespace repro

// C[m, n] (row stride sc0, unit column stride) = A[m, k] @ B[k, n] on
// `variant` (repro::Variant) at the CTA tile (bm, bn, bk). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_gemm(int variant, int bm, int bn, int bk, int dtype,
                          int out_dtype, const void* a, long long sa0,
                          long long sa1, const void* b, long long sb0,
                          long long sb1, void* c, long long sc0, int m, int n,
                          int k, void* stream) {
  return repro::dispatch(variant, bm, bn, bk, dtype, out_dtype, a, sa0, sa1, b,
                         sb0, sb1, nullptr, repro::kNone, c, sc0, m, n, k,
                         stream);
}

// C = act(A @ B + bias) on the "gemv" variant (n <= 16, A with a unit
// column stride). ks is the K segment (a multiple of 256); when k > ks,
// partials holds ceil(k / ks) * m * n accumulator-width values. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_gemv(int dtype, int out_dtype, const void* a,
                          long long sa0, const void* b, long long sb0,
                          long long sb1, const void* bias, int epilogue,
                          void* partials, int ks, void* c, long long sc0,
                          int m, int n, int k, void* stream) {
  return repro::gemv(dtype, out_dtype, a, sa0, b, sb0, sb1, bias, epilogue, c,
                     sc0, partials, m, n, k, ks,
                     static_cast<cudaStream_t>(stream));
}

// C = act(A @ B + bias) at the CTA tile (bm, bn, bk); bias may be null (no
// bias), epilogue is a repro::Epilogue code.
extern "C" int repro_gemm_bias_act(int variant, int bm, int bn, int bk,
                                   int dtype, int out_dtype, const void* a,
                                   long long sa0, long long sa1,
                                   const void* b, long long sb0,
                                   long long sb1, const void* bias,
                                   int epilogue, void* c, long long sc0, int m,
                                   int n, int k, void* stream) {
  return repro::dispatch(variant, bm, bn, bk, dtype, out_dtype, a, sa0, sa1, b,
                         sb0, sb1, bias, epilogue, c, sc0, m, n, k, stream);
}
