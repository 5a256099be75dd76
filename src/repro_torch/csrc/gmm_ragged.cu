// Count-aware (ragged) grouped matmul for the MoE expert FFN.
//
// Replaces the TPU kernels src/repro/kernels/gmm/ragged.py::gmm_ragged
// (_ragged_kernel) and ::gmm_dual_act_ragged (_ragged_dual_kernel):
//
//   plain: y[g, m, :] = x[g, m, :] @ w[g / gpw]                  for m < gs[g]
//   dual:  h[g, m, :] = silu(x[g, m] @ wg[g / gpw]) * (x[g, m] @ wu[g / gpw])
//
// with rows m >= gs[g] stored as exact zeros (the combine reads them) and
// never read on input (they may hold garbage; the tests poison them with
// NaN).
//
// The same bodies also replace ::gmm_dual_act_gather (_gather_dual_kernel),
// ::gmm_gather (_gather_kernel) and ::gmm_scatter (_scatter_kernel), and
// src/repro/kernels/gmm/gmm.py::gmm (_gmm_kernel) and ::gmm_dual_act
// (_gmm_dual_kernel), which differ only in where a group's rows live
// (struct Rows, common.cuh, a template parameter):
//
// * gather input (dual: gmm_dual_act_gather; single: gmm_gather): row m of
//   group g is row xofs[g] + m of a flat (R, D) array (the dispatch order
//   of collectives.dispatch_metadata) instead of row g * C + m of padded
//   buckets, so the (G, C, D) dispatch buffer is never written;
// * every row live (gmm, gmm_dual_act): padded buckets with no count, gs
//   null, weights (G, D, F) (gpw = 1); every row of the output is stored;
// * scatter output: row m of group g is stored at row oofs[g] + m of a
//   flat (R, F) array, and ONLY rows m < count are stored. The TPU kernel
//   stores whole row tiles in grid order and lets a partial tile's zero
//   spill be overwritten by the next bucket; CUDA blocks have no store
//   order, so nothing is spilled: rows outside every live segment keep
//   whatever the output held (the gap rows of dropped copies, which the
//   combine never reads).
//
// Accumulation is fp32; the dual form applies silu(g) * u to the two fp32
// accumulators and casts once to the I/O type, which is also the type the
// hidden tensor is stored in between the two kernels.
//
// What bounds it on an H100: at decode (8 tokens x top-4 over 20 slots,
// capacity 8) every live group streams its whole (D, F) weight panel for a
// handful of rows, so the kernel is bound by weight bytes over HBM
// bandwidth (3.35 TB/s). At prefill (capacity 820) it is bound by
// operations, 2 * sum(gs) * D * F per product. The every-row layout has
// no dead group or row to skip: at decode it streams all G weight panels
// (the bound of torch.bmm over the same buckets), at prefill it does
// 2 * G * C * D * F operations per product, and the WMMA body computes
// every row tile of every group.
//
// What the design does about it: every block reads gs[g] itself; a group
// (or row tile) with no live rows writes its zeros and exits without
// touching the weights, so weight traffic tracks live groups. Three
// bodies, chosen from the bucket capacity C and the dtype:
//
// * C <= 8 (decode): a skinny kernel. Each thread streams 16-byte weight
//   vectors from HBM straight into registers and multiplies them by the
//   (at most 8) live rows of x, read as warp-wide broadcasts; the block's
//   warps split D and reduce once through shared memory. Each weight byte
//   is read once and no shared-memory load sits in the inner loop, so the
//   kernel streams weights at close to the HBM rate.
// * C > 8, bf16 (prefill): 128 x 128 output tiles on the tensor cores
//   (WMMA 16x16x16, fp32 accumulate), bf16 tiles double-buffered in shared
//   memory with cp.async so the next tile's loads overlap the products.
// * C > 8, fp32: 64 x 128 tiles of fp32 FMAs on the CUDA cores (TF32
//   would change the numbers; fp32 is the comparison dtype).
//
// wgmma, TMA and deeper pipelines are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN, bool DUAL, class RW>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gmm_ragged_kernel(const T* __restrict__ x, const T* __restrict__ wa,
                  const T* __restrict__ wb, const int* __restrict__ gs,
                  T* __restrict__ out, int C, int D, int F, int gpw, RW rw) {
  constexpr int NX = BN / TN;            // threads along n
  constexpr int NT = (BM / TM) * NX;     // threads per block
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  static_assert(BK % VEC == 0 && BN % VEC == 0, "tile must hold whole vectors");

  __shared__ float xs[BK][BM];
  __shared__ float as[BK][BN];
  __shared__ float bs[DUAL ? BK : 1][DUAL ? BN : 1];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / NX, tx = tid % NX;
  const int count = rw.count(gs, g, C);
  const int n_out = rw.stored(C, count);
  T* og = rw.out(out, g, C, F);

  if (m0 >= count) {
    // Dead row tile: zero output (padded layout only), no weight reads.
    for (int i = tid; i < BM * BN; i += NT) {
      const int m = m0 + i / BN, n = n0 + i % BN;
      if (m < n_out && n < F) og[(size_t)m * F + n] = from_f<T>(0.f);
    }
    return;
  }

  const T* xg = rw.in(x, g, C, D);
  const size_t wofs = (size_t)(g / gpw) * D * F;
  const T* ag = wa + wofs;
  const T* bg = DUAL ? wb + wofs : nullptr;

  float acc_a[TM][TN];
  float acc_b[DUAL ? TM : 1][DUAL ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_a[i][j] = 0.f;
      if constexpr (DUAL) acc_b[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile, transposed into xs[k][m]; rows at or past the count are
    // never read (masked to zero on load).
    for (int i = tid; i < BM * (BK / VEC); i += NT) {
      const int mm = i / (BK / VEC), kk = (i % (BK / VEC)) * VEC;
      const int m = m0 + mm, k = k0 + kk;
      float v[VEC];
      if (m < count && k < D) {
        load_vec16(xg + (size_t)m * D + k, v);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) xs[kk + e][mm] = v[e];
    }
    // weight tiles (BK x BN), 16-byte loads along F.
    for (int i = tid; i < BK * (BN / VEC); i += NT) {
      const int kk = i / (BN / VEC), nn = (i % (BN / VEC)) * VEC;
      const int k = k0 + kk, n = n0 + nn;
      float va[VEC], vb[VEC];
      if (k < D && n < F) {
        load_vec16(ag + (size_t)k * F + n, va);
        if constexpr (DUAL) load_vec16(bg + (size_t)k * F + n, vb);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { va[e] = 0.f; vb[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        as[kk][nn + e] = va[e];
        if constexpr (DUAL) bs[kk][nn + e] = vb[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float a = as[kk][tx + j * NX];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc_a[i][j] = fmaf(xr[i], a, acc_a[i][j]);
        if constexpr (DUAL) {
          const float b = bs[kk][tx + j * NX];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc_b[i][j] = fmaf(xr[i], b, acc_b[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= n_out) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n >= F) continue;
      float v = 0.f;
      if (m < count) {
        if constexpr (DUAL) {
          const float h = acc_a[i][j];
          v = h / (1.f + expf(-h)) * acc_b[i][j];
        } else {
          v = acc_a[i][j];
        }
      }
      og[(size_t)m * F + n] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// decode: skinny GEMM, C <= SKINNY_ROWS rows per group
// ---------------------------------------------------------------------------

constexpr int SKINNY_ROWS = 8;
constexpr int SKINNY_WARPS = 8;

// The single-product form must keep two blocks per SM (at most 128
// registers a thread): it streams weights with little work per load, and
// at one block per SM it runs at half the rate. The dual form holds two
// accumulator sets and runs one block per SM either way.
template <typename T, bool DUAL, class RW>
__global__ void __launch_bounds__(SKINNY_WARPS * 32, DUAL ? 1 : 2)
gmm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ wa,
                  const T* __restrict__ wb, const int* __restrict__ gs,
                  T* __restrict__ out, int C, int D, int F, int gpw, RW rw) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int COLS = 32 * VEC;          // output columns per block
  constexpr int NT = SKINNY_WARPS * 32;
  __shared__ float red_a[SKINNY_WARPS][COLS];
  __shared__ float red_b[DUAL ? SKINNY_WARPS : 1][DUAL ? COLS : 1];

  const int g = blockIdx.y;
  const int n0 = blockIdx.x * COLS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = rw.count(gs, g, C);
  if (count == 0) {
    T* og = rw.out(out, g, C, F);
    for (int i = tid; i < rw.stored(C, 0) * COLS; i += NT) {
      const int m = i / COLS, n = n0 + i % COLS;
      if (n < F) og[(size_t)m * F + n] = from_f<T>(0.f);
    }
    return;
  }
  const T* xg = rw.in(x, g, C, D);
  const size_t wofs = (size_t)(g / gpw) * D * F;
  const T* ag = wa + wofs;
  const T* bg = DUAL ? wb + wofs : nullptr;
  const int n = n0 + lane * VEC;
  const bool n_ok = n < F;                 // F % VEC == 0: whole vectors
  const int kper = (D + SKINNY_WARPS - 1) / SKINNY_WARPS;
  const int k_lo = warp * kper, k_hi = min(D, k_lo + kper);

  float acc_a[SKINNY_ROWS][VEC];
  float acc_b[DUAL ? SKINNY_ROWS : 1][DUAL ? VEC : 1];
#pragma unroll
  for (int r = 0; r < SKINNY_ROWS; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc_a[r][v] = 0.f;
      if constexpr (DUAL) acc_b[r][v] = 0.f;
    }

  if (n_ok) {
#pragma unroll 4
    for (int k = k_lo; k < k_hi; ++k) {
      float wv[VEC], uv[VEC];
      load_vec16(ag + (size_t)k * F + n, wv);
      if constexpr (DUAL) load_vec16(bg + (size_t)k * F + n, uv);
#pragma unroll
      for (int r = 0; r < SKINNY_ROWS; ++r) {
        // rows at or past the count are never read (count is uniform
        // across the block, so this branch does not diverge)
        const float xr = r < count ? to_f(xg[(size_t)r * D + k]) : 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc_a[r][v] = fmaf(xr, wv[v], acc_a[r][v]);
          if constexpr (DUAL) acc_b[r][v] = fmaf(xr, uv[v], acc_b[r][v]);
        }
      }
    }
  }

  // reduce the warps' K slices, one row at a time (the output's layout is
  // read only now, so it holds no register through the loop above)
  const int n_out = rw.stored(C, count);
  T* og = rw.out(out, g, C, F);
#pragma unroll
  for (int r = 0; r < SKINNY_ROWS; ++r) {
    if (r >= n_out) break;   // block-uniform: the barriers below stay paired
    __syncthreads();
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      red_a[warp][lane * VEC + v] = acc_a[r][v];
      if constexpr (DUAL) red_b[warp][lane * VEC + v] = acc_b[r][v];
    }
    __syncthreads();
    for (int c = tid; c < COLS; c += NT) {
      const int col = n0 + c;
      if (col >= F) continue;
      float v = 0.f;
      if (r < count) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int w = 0; w < SKINNY_WARPS; ++w) {
          a += red_a[w][c];
          if constexpr (DUAL) b += red_b[w][c];
        }
        if constexpr (DUAL) v = a / (1.f + expf(-a)) * b;
        else v = a;
      }
      og[(size_t)r * F + col] = from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// prefill, bf16: tensor-core tiles (WMMA 16x16x16, fp32 accumulate)
// ---------------------------------------------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
constexpr int WM_BM = 128, WM_BN = 128, WM_BK = 32;
constexpr int WM_LDA = WM_BK + 8, WM_LDB = WM_BN + 8;   // 16-byte row padding
// one pipeline stage: x tile (BM x LDA) + two weight tiles (BK x LDB), bf16
constexpr int WM_STAGE = WM_BM * WM_LDA + 2 * WM_BK * WM_LDB;
constexpr size_t WM_SMEM =
    2 * WM_STAGE * sizeof(bf16) + 8 * 2 * 16 * 16 * sizeof(float);

// 16-byte global -> shared copy that bypasses registers; with pred false
// it reads nothing and fills zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool DUAL, class RW>
__global__ void __launch_bounds__(256)
gmm_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wa,
                const bf16* __restrict__ wb, const int* __restrict__ gs,
                bf16* __restrict__ out, int C, int D, int F, int gpw, RW rw) {
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char wm_smem[];
  bf16* const smem = reinterpret_cast<bf16*>(wm_smem);
  // epilogue staging: a 16 x 16 fp32 tile (two for the dual form) per warp
  float* const stage = reinterpret_cast<float*>(wm_smem + 2 * WM_STAGE * sizeof(bf16));

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * WM_BM, n0 = blockIdx.x * WM_BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 2, wn = warp % 2;   // warp tile: rows wm*32, cols wn*64
  const int count = rw.count(gs, g, C);
  const int n_out = rw.stored(C, count);
  bf16* og = rw.out(out, g, C, F);
  if (m0 >= count) {
    for (int i = tid; i < WM_BM * WM_BN; i += 256) {
      const int m = m0 + i / WM_BN, n = n0 + i % WM_BN;
      if (m < n_out && n < F) og[(size_t)m * F + n] = __float2bfloat16(0.f);
    }
    return;
  }
  const bf16* xg = rw.in(x, g, C, D);
  const size_t wofs = (size_t)(g / gpw) * D * F;
  const bf16* ag = wa + wofs;
  const bf16* bg = DUAL ? wb + wofs : nullptr;

  // Stage s: x tile at smem + s*WM_STAGE, weight tiles after it.
  auto load_stage = [&](int s, int k0) {
    bf16* xs = smem + s * WM_STAGE;
    bf16* wsa = xs + WM_BM * WM_LDA;
    bf16* wsb = wsa + WM_BK * WM_LDB;
    for (int i = tid; i < WM_BM * (WM_BK / 8); i += 256) {
      const int r = i / (WM_BK / 8), kk = (i % (WM_BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < count && k < D;   // rows past the count: zeros
      cp_async16(xs + r * WM_LDA + kk, ok ? xg + (size_t)m * D + k : xg, ok);
    }
    for (int i = tid; i < WM_BK * (WM_BN / 8); i += 256) {
      const int kk = i / (WM_BN / 8), nn = (i % (WM_BN / 8)) * 8;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < D && n < F;
      const size_t off = ok ? (size_t)k * F + n : 0;
      cp_async16(wsa + kk * WM_LDB + nn, ag + off, ok);
      if constexpr (DUAL) cp_async16(wsb + kk * WM_LDB + nn, bg + off, ok);
    }
  };

  FragC fa[2][4], fb[DUAL ? 2 : 1][DUAL ? 4 : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fill_fragment(fa[i][j], 0.f);
      if constexpr (DUAL) wmma::fill_fragment(fb[i][j], 0.f);
    }

  // Two-stage pipeline: tile t+1's copies are in flight while tile t
  // feeds the tensor cores.
  const int nk = (D + WM_BK - 1) / WM_BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load_stage((t + 1) & 1, (t + 1) * WM_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = smem + (t & 1) * WM_STAGE;
    const bf16* wsa = xs + WM_BM * WM_LDA;
    const bf16* wsb = wsa + WM_BK * WM_LDB;
#pragma unroll
    for (int kk = 0; kk < WM_BK; kk += 16) {
      FragA af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], xs + (wm * 32 + i * 16) * WM_LDA + kk, WM_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bfr;
        wmma::load_matrix_sync(bfr, wsa + kk * WM_LDB + wn * 64 + j * 16, WM_LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(fa[i][j], af[i], bfr, fa[i][j]);
        if constexpr (DUAL) {
          wmma::load_matrix_sync(bfr, wsb + kk * WM_LDB + wn * 64 + j * 16, WM_LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(fb[i][j], af[i], bfr, fb[i][j]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it refills
  }

  // epilogue: through the warp's 16 x 16 fp32 staging tiles
  float* sa = stage + warp * 2 * 256;
  float* sb = sa + 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sa, fa[i][j], 16, wmma::mem_row_major);
      if constexpr (DUAL) wmma::store_matrix_sync(sb, fb[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane * 8 + t, r = e / 16, c = e % 16;
        const int m = m0 + wm * 32 + i * 16 + r, n = n0 + wn * 64 + j * 16 + c;
        if (m < n_out && n < F) {
          float v = 0.f;
          if (m < count) {
            const float a = sa[e];
            if constexpr (DUAL) v = a / (1.f + expf(-a)) * sb[e];
            else v = a;
          }
          og[(size_t)m * F + n] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, bool DUAL, class RW>
void launch(const void* x, const void* wa, const void* wb, const int* gs,
            void* out, int G, int C, int D, int F, int gpw, RW rw,
            cudaStream_t st) {
  dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, G);
  dim3 block((BM / TM) * (BN / TN));
  gmm_ragged_kernel<T, BM, BN, BK, TM, TN, DUAL, RW><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wa),
      static_cast<const T*>(wb), gs, static_cast<T*>(out), C, D, F, gpw, rw);
}

template <typename T, bool DUAL, class RW>
void dispatch(const void* x, const void* wa, const void* wb, const int* gs,
              void* out, int G, int C, int D, int F, int gpw, RW rw,
              cudaStream_t st) {
  if (C <= SKINNY_ROWS) {
    constexpr int COLS = 32 * (16 / sizeof(T));
    dim3 grid((F + COLS - 1) / COLS, G);
    gmm_skinny_kernel<T, DUAL, RW><<<grid, SKINNY_WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(wa),
        static_cast<const T*>(wb), gs, static_cast<T*>(out), C, D, F, gpw, rw);
  } else if constexpr (std::is_same<T, bf16>::value) {
    dim3 grid((F + WM_BN - 1) / WM_BN, (C + WM_BM - 1) / WM_BM, G);
    // > 48 KB of dynamic shared memory needs the opt-in; a failure here is
    // reported through cudaGetLastError like a refused launch.
    cudaFuncSetAttribute(gmm_wmma_kernel<DUAL, RW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WM_SMEM);
    gmm_wmma_kernel<DUAL, RW><<<grid, 256, WM_SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wa),
        static_cast<const bf16*>(wb), gs, static_cast<bf16*>(out), C, D, F, gpw,
        rw);
  } else {
    launch<T, 64, 128, 16, 4, 8, DUAL, RW>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
  }
}

// The forms the wrappers launch: padded with counts (both products),
// padded with every row live (both products; gs null), gather (both
// products: the SwiGLU front half, or the single product) and scatter (the
// single product of the down projection).
template <typename T>
int dispatch_layout(const void* x, const void* wa, const void* wb, const int* gs,
                    const int* xofs, const int* oofs, void* out, int G, int C,
                    int D, int F, int gpw, int in_rows, int out_rows, bool dual,
                    cudaStream_t st) {
  if (!gs) {
    if (xofs || oofs) return static_cast<int>(cudaErrorInvalidValue);
    const Rows<false, false, true> rw{nullptr, nullptr, 0, 0};
    if (dual) dispatch<T, true>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
    else dispatch<T, false>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
  } else if (!xofs && !oofs) {
    const Rows<false, false> rw{nullptr, nullptr, 0, 0};
    if (dual) dispatch<T, true>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
    else dispatch<T, false>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
  } else if (xofs && !oofs) {
    const Rows<true, false> rw{xofs, nullptr, in_rows, 0};
    if (dual) dispatch<T, true>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
    else dispatch<T, false>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
  } else if (!xofs && oofs && !dual) {
    const Rows<false, true> rw{nullptr, oofs, 0, out_rows};
    dispatch<T, false>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (G, C, D) or, with xofs, flat (in_rows, D); wa/wb (G/gpw, D, F);
// gs (G,) int32, or null for every row live (padded only); out (G, C, F)
// or, with oofs, flat (out_rows, F); xofs and oofs (G,) int32 or null:
// padded, gather or scatter (single product only). All contiguous,
// 16-byte aligned, D and F multiples of 16 / sizeof(T). wb is read only
// when dual != 0. Returns cudaGetLastError() after launch.
extern "C" int gmm_ragged_launch(const void* x, const void* wa, const void* wb,
                                 const void* gs, const void* xofs,
                                 const void* oofs, void* out, int G, int C,
                                 int D, int F, int gpw, int in_rows,
                                 int out_rows, int dtype, int dual,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gs);
  const int* xo = static_cast<const int*>(xofs);
  const int* oo = static_cast<const int*>(oofs);
  if (dtype == DT_F32)
    return dispatch_layout<float>(x, wa, wb, g, xo, oo, out, G, C, D, F, gpw,
                                  in_rows, out_rows, dual != 0, st);
  if (dtype == DT_BF16)
    return dispatch_layout<__nv_bfloat16>(x, wa, wb, g, xo, oo, out, G, C, D, F,
                                          gpw, in_rows, out_rows, dual != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
