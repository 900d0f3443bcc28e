// Fused X = L11^{-1} AP, then C' = C - BL X ("lu") or C - X^T X ("syrk"),
// for repro_torch.kernels.fused.trsm_gemm (B2).
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py::trsm_gemm
// (_trsm_gemm_kernel). That kernel leans on ordered grid steps: step 0
// solves all of X into VMEM scratch and every later step reads it. CTAs on
// the card run in no order and share nothing, so here every CTA of the 2-D
// grid over C's TILE x TILE tiles re-solves, by forward substitution in
// shared memory at the accumulator width, only the X column blocks its tile
// needs: X[:, j-block] for "lu", and also X[:, i-block] for "syrk". X never
// round-trips device memory between the two stages; the CTAs of the first
// row-block write it out once, as the kernel's first output.
//
// Bound: operations (the trailing update is 2 m n nb flops against
// (m n + ...) elements moved). The re-solve adds about nb / (2 TILE) of the
// update's flops (syrk: twice that off the diagonal) and one barrier per
// row of L11: that is what this simple design pays for having no grid
// order. A cluster/DSMEM or persistent design is later work.
//
// Shared memory: the X blocks (nb x TILE each, accumulator width) plus,
// for "lu", a KC x TILE chunk of BL; L11 is staged in shared memory when
// it fits beside them (l_smem) and otherwise read through the cache from
// device memory, so every panel width the drivers pass runs. The wrapper
// picks TILE (64, 32, ..., 1) as the largest whose X blocks fit, with the
// same byte formula as smem_bytes() below. Narrow tiles (down to one
// column) are slow and exist so that very wide panels still run.
#include "common.cuh"

namespace repro {
namespace {

constexpr int THREADS = 256, KC = 16;

template <typename Acc>
__host__ __device__ size_t smem_bytes(int nb, int tile, int syrk, int l_smem) {
  const size_t x = static_cast<size_t>(nb) * tile;
  const size_t second = syrk ? x : static_cast<size_t>(KC) * tile;
  const size_t l = l_smem ? static_cast<size_t>(nb) * nb : 0;
  return (x + second + l) * sizeof(Acc);
}

template <typename T, typename Acc, int TILE>
__global__ void __launch_bounds__(THREADS)
trsm_gemm_kernel(int syrk, int unit_diag, int l_smem,
                 const T* __restrict__ l, long long sl0, long long sl1,
                 const T* __restrict__ ap, long long sap0, long long sap1,
                 const T* __restrict__ bl, long long sbl0, long long sbl1,
                 const T* __restrict__ c, long long sc0, long long sc1,
                 T* __restrict__ x, T* __restrict__ cout, int nb, int m,
                 int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* xj = reinterpret_cast<Acc*>(smem_raw);
  Acc* second = xj + static_cast<size_t>(nb) * TILE;  // X_i (syrk) | BL chunk
  Acc* ls = second + (syrk ? static_cast<size_t>(nb) * TILE : KC * TILE);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;

  if (l_smem)
    for (int idx = tid; idx < nb * nb; idx += THREADS)
      ls[idx] = to_acc(l[(idx / nb) * sl0 + (idx % nb) * sl1]);
  auto lval = [&](int r, int q) -> Acc {
    return l_smem ? ls[r * nb + q] : to_acc(l[r * sl0 + q * sl1]);
  };

  // X[:, c0:c0+TILE] = L11^{-1} AP[:, c0:c0+TILE] into xs (nb x TILE):
  // row r is final once rows < r are eliminated; divide it, then
  // eliminate it from the rows below (padding columns solve to zero)
  auto solve = [&](Acc* xs, int c0) {
    for (int idx = tid; idx < nb * TILE; idx += THREADS) {
      const int gc = c0 + idx % TILE;
      xs[idx] = gc < n ? to_acc(ap[(idx / TILE) * sap0 + gc * sap1]) : Acc(0);
    }
    __syncthreads();
    for (int r = 0; r < nb; ++r) {
      if (!unit_diag) {
        if (tid < TILE) xs[r * TILE + tid] /= lval(r, r);
        __syncthreads();
      }
      const int rem = (nb - r - 1) * TILE;
      for (int idx = tid; idx < rem; idx += THREADS) {
        const int q = r + 1 + idx / TILE, cc = idx % TILE;
        xs[q * TILE + cc] = fma_acc(-lval(q, r), xs[r * TILE + cc],
                                    xs[q * TILE + cc]);
      }
      __syncthreads();
    }
  };

  solve(xj, col0);
  Acc* xi = xj;
  if (syrk && row0 != col0) {
    xi = second;
    solve(xi, row0);
  }

  if (blockIdx.y == 0)
    for (int idx = tid; idx < nb * TILE; idx += THREADS) {
      const int gc = col0 + idx % TILE;
      if (gc < n) store(&x[static_cast<long long>(idx / TILE) * n + gc], xj[idx]);
    }

  // the update tile: thread (ty, tx) owns rows ty + 16 i, cols tx + 16 j
  constexpr int R = TILE >= 16 ? TILE / 16 : 1;
  const int tx = tid % 16, ty = tid / 16;
  const bool active = TILE >= 16 || (tx < TILE && ty < TILE);
  Acc acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = Acc(0);

  if (syrk) {
    // C_ij -= X[:, i-block]^T X[:, j-block]
    if (active)
      for (int kk = 0; kk < nb; ++kk) {
        Acc av[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) av[i] = xi[kk * TILE + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = xj[kk * TILE + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] = fma_acc(av[i], bv[j], acc[i][j]);
      }
  } else {
    // C_ij -= BL[i-block, :] X[:, j-block], BL staged KC columns at a time
    Acc* bc = second;
    for (int k0 = 0; k0 < nb; k0 += KC) {
      for (int idx = tid; idx < KC * TILE; idx += THREADS) {
        const int r = sbl0 == 1 ? idx % TILE : idx / KC;
        const int kk = sbl0 == 1 ? idx / TILE : idx % KC;
        const int gr = row0 + r, gk = k0 + kk;
        bc[kk * TILE + r] =
            (gr < m && gk < nb) ? to_acc(bl[gr * sbl0 + gk * sbl1]) : Acc(0);
      }
      __syncthreads();
      const int kend = nb - k0 < KC ? nb - k0 : KC;
      if (active)
        for (int kk = 0; kk < kend; ++kk) {
          Acc av[R], bv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) av[i] = bc[kk * TILE + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < R; ++j) bv[j] = xj[(k0 + kk) * TILE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) acc[i][j] = fma_acc(av[i], bv[j], acc[i][j]);
        }
      __syncthreads();
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int cc = col0 + tx + 16 * j;
      if (cc >= n) continue;
      store(&cout[static_cast<long long>(r) * n + cc],
            to_acc(c[r * sc0 + cc * sc1]) - acc[i][j]);
    }
  }
}

template <typename T, typename Acc, int TILE>
int launch(int syrk, int unit_diag, int l_smem, const void* l, long long sl0,
           long long sl1, const void* ap, long long sap0, long long sap1,
           const void* bl, long long sbl0, long long sbl1, const void* c,
           long long sc0, long long sc1, void* x, void* cout, int nb, int m,
           int n, cudaStream_t stream) {
  const size_t bytes = smem_bytes<Acc>(nb, TILE, syrk, l_smem);
  auto kernel = trsm_gemm_kernel<T, Acc, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least one row-block, so the X output is written even when m == 0
  const int row_blocks = m > 0 ? (m + TILE - 1) / TILE : 1;
  const dim3 grid((n + TILE - 1) / TILE, row_blocks);
  kernel<<<grid, THREADS, bytes, stream>>>(
      syrk, unit_diag, l_smem, static_cast<const T*>(l), sl0, sl1,
      static_cast<const T*>(ap), sap0, sap1, static_cast<const T*>(bl), sbl0,
      sbl1, static_cast<const T*>(c), sc0, sc1, static_cast<T*>(x),
      static_cast<T*>(cout), nb, m, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int by_tile(int tile, int syrk, int unit_diag, int l_smem, const void* l,
            long long sl0, long long sl1, const void* ap, long long sap0,
            long long sap1, const void* bl, long long sbl0, long long sbl1,
            const void* c, long long sc0, long long sc1, void* x, void* cout,
            int nb, int m, int n, cudaStream_t s) {
#define REPRO_TILE_CASE(TL)                                                   \
  case TL:                                                                    \
    return launch<T, Acc, TL>(syrk, unit_diag, l_smem, l, sl0, sl1, ap, sap0, \
                              sap1, bl, sbl0, sbl1, c, sc0, sc1, x, cout, nb,  \
                              m, n, s);
  switch (tile) {
    REPRO_TILE_CASE(64)
    REPRO_TILE_CASE(32)
    REPRO_TILE_CASE(16)
    REPRO_TILE_CASE(8)
    REPRO_TILE_CASE(4)
    REPRO_TILE_CASE(2)
    REPRO_TILE_CASE(1)
  }
#undef REPRO_TILE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// Shared-memory bytes the kernel asks for at (dtype, nb, tile, syrk,
// l_smem); the wrapper checks its tile choice against this.
extern "C" long long repro_trsm_gemm_smem_bytes(int dtype, int nb, int tile,
                                                int syrk, int l_smem) {
  return dtype == repro::kF64
             ? static_cast<long long>(repro::smem_bytes<double>(nb, tile, syrk, l_smem))
             : static_cast<long long>(repro::smem_bytes<float>(nb, tile, syrk, l_smem));
}

// X (nb x n, contiguous) and C' (m x n, contiguous) from L11 (nb x nb),
// AP (nb x n), BL (m x nb, ignored when syrk) and C (m x n), all strided.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_trsm_gemm(int dtype, int syrk, int unit_diag,
                               const void* l, long long sl0, long long sl1,
                               const void* ap, long long sap0, long long sap1,
                               const void* bl, long long sbl0, long long sbl1,
                               const void* c, long long sc0, long long sc1,
                               void* x, void* cout, int nb, int m, int n,
                               int tile, int l_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::by_tile<float, float>(tile, syrk, unit_diag, l_smem, l,
                                          sl0, sl1, ap, sap0, sap1, bl, sbl0,
                                          sbl1, c, sc0, sc1, x, cout, nb, m, n,
                                          s);
    case repro::kF64:
      return repro::by_tile<double, double>(tile, syrk, unit_diag, l_smem, l,
                                            sl0, sl1, ap, sap0, sap1, bl, sbl0,
                                            sbl1, c, sc0, sc1, x, cout, nb, m,
                                            n, s);
    case repro::kBF16:
      return repro::by_tile<__nv_bfloat16, float>(
          tile, syrk, unit_diag, l_smem, l, sl0, sl1, ap, sap0, sap1, bl, sbl0,
          sbl1, c, sc0, sc1, x, cout, nb, m, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
