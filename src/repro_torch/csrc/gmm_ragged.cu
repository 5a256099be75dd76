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
// handful of rows, so the kernel is bound by the live groups' weight bytes
// over HBM bandwidth (3.35 TB/s); at about 1 us of latency that asks for
// some 25 KB of loads in flight on each SM. At prefill (capacity 820) it
// is bound by operations, 2 * sum(gs) * D * F per product over the 989
// TFLOP/s bf16 tensor-core peak (2.19 ms for the served dual form, 1.09 ms
// for the single product). The every-row layout has no dead group or row
// to skip: at decode it streams all G weight panels (the bound of
// torch.bmm over the same buckets), at prefill it does 2 * G * C * D * F
// operations per product.
//
// What the design does about it: every block reads gs[g] itself; a group
// (or row tile) with no live rows writes its zeros and exits without
// touching the weights, so weight traffic tracks live groups. Three
// bodies, chosen from the bucket capacity C and the dtype:
//
// * C <= 8 (decode; replaces, at decode, ragged.py:151, 223, 371, 469 and
//   605 and gmm.py:71 and 123): gmm_decode_kernel. A block takes a strip
//   of 128 output columns (fp32: 64) of one group over a K range of whole
//   64-deep stages; the number of K splits S comes from static shapes only
//   (gmm/ragged.py::decode_splits: enough blocks for two waves of the
//   card's resident blocks with half the groups live, or all of them in
//   the every-row layout, at most one split per 512 k), so the wrapper
//   reads no count. A producer warp keeps a
//   ring of about 96 KB of weight tiles in flight through TMA (two blocks
//   an SM, so some 190 KB of loads an SM, well past the 25 KB HBM needs)
//   and stages each stage's x rows with cp.async, zero-filling the rows at
//   or past the count without reading them. The loads hold no registers,
//   and the products take no issue slots from them: bf16 runs mma.sync
//   m16n8k16 with the output transposed (W^T by ldmatrix.trans from the
//   swizzled tile, x^T by ldmatrix; C <= 8 is the mma's n), fp32 FMAs on
//   the CUDA cores with x read as shared-memory broadcasts (TF32 would
//   change the numbers). With S > 1 each block stores fp32 partials, and
//   the last of a strip's S blocks to arrive (one acquire-release atomic
//   on a self-resetting counter) adds them in split order before silu(a) *
//   b and the one cast, so two calls are bitwise equal. mma.sync, not
//   wgmma m64n8k16, because its 16-column A tile lets four warps each take
//   32 columns of a 128-column strip with no warpgroup sync, and a decode
//   stage is a few instructions a warp either way.
// * C > 8, bf16 (prefill): output tiles of 128 rows x 128 columns of both
//   products (dual) or 256 of one (single) on Hopper's warpgroup tensor
//   cores (wgmma m64n128k16, fp32 accumulate), fed by a producer warp's TMA
//   loads through a 4-stage ring of 64-deep K steps in 128-byte-swizzled
//   shared memory, so loads run ahead of the products and no block-wide
//   barrier sits in the K loop; the epilogue applies silu(a) * b to the
//   fp32 fragments and stores bf16 pairs straight from registers
//   (gmm_wgmma_kernel; the PTX, wgmma.mma_async and the TMA loads
//   cp.async.bulk.tensor against mbarriers, is in hopper.cuh).
// * C > 8, fp32: 64 x 128 tiles of fp32 FMAs on the CUDA cores (TF32
//   would change the numbers; fp32 is the comparison dtype).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
// decode: C <= 8 rows per group, weights through a TMA ring
// ---------------------------------------------------------------------------

constexpr int DEC_ROWS = 8;                        // rows a group (the mma's n)
constexpr int DEC_BK = 64;                         // k a stage
constexpr int DEC_CONSUMERS = 4;                   // consumer warps
constexpr int DEC_THREADS = DEC_CONSUMERS * 32 + 32;   // and one producer warp
constexpr int DEC_BOX = 64;                        // columns a TMA box
constexpr uint32_t DEC_W_BYTES = 16384;            // one product's weights a stage
// output columns a block: 128 bf16 (two 128-byte-swizzled boxes), 64 fp32
// (one box of 256-byte rows); either way 16 KB of weights a product a stage
template <typename T> constexpr int dec_cols = DEC_W_BYTES / (DEC_BK * sizeof(T));
template <typename T> constexpr uint32_t dec_box_bytes = DEC_BOX * DEC_BK * sizeof(T);
// a stage's x rows: 8 x 64 k, bf16 rows padded by 16 bytes so that the
// ldmatrix rows fall in distinct banks; fp32 rows are read as broadcasts
template <typename T>
constexpr uint32_t dec_x_row = DEC_BK * sizeof(T) + (sizeof(T) == 2 ? 16 : 0);
template <typename T> constexpr uint32_t dec_x_bytes = DEC_ROWS * dec_x_row<T>;
// stages in flight: about 96 KB of weights a block, two blocks an SM
template <bool DUAL> constexpr int dec_stages = DUAL ? 3 : 6;
template <typename T, bool DUAL>
constexpr size_t dec_smem =
    (size_t)dec_stages<DUAL> * ((DUAL ? 2 : 1) * DEC_W_BYTES + dec_x_bytes<T>) + 1024 +
    16 * dec_stages<DUAL> + 16;

// One block per (column strip, K split, group): grid (strips * S, G), the S
// splits of a strip adjacent. Warp 4 is the producer: lane 0 keeps the
// ring full with TMA loads of the strip's weights (a box of 64 k x 64
// columns; bf16 128-byte swizzled), and every lane stages the stage's x
// chunk with cp.async (16 bytes a copy, 8 rows x 64 k): rows at or past the
// count, and k at or past D, are never read (source size 0 zero-fills
// them), so a NaN in a dead row, a gap row or past the array never reaches
// a product. The stage's full barrier completes on the weights' bytes and
// the 32 lanes' cp.async arrivals. Warps 0-3 consume: bf16 on the tensor
// cores, mma.sync m16n8k16 with the output transposed (16 columns x 8
// rows += W^T 16 x 16 k, by ldmatrix.trans from the [k][n] tile, times x^T
// 16 k x 8 rows, by ldmatrix from the staged rows), each warp 32 columns;
// fp32 on the CUDA cores, a thread a column and 4 rows, x read as
// broadcasts. With S = 1 the consumers apply the epilogue to their fp32
// sums and store by the layout; with S > 1 they store fp32 partials to
// `part` (S, G, C, F) per product, count in on the strip's counter with one
// acquire-release atomic, and the last block resets the counter and sums
// the S partials in split order before the epilogue: no float atomics, so
// two calls are bitwise equal. A group with no live row loads nothing; its
// split 0 writes the padded layouts' zeros.
template <typename T, bool DUAL, class RW>
__global__ void __launch_bounds__(DEC_THREADS, 2)
gmm_decode_kernel(const __grid_constant__ CUtensorMap wamap,
                  const __grid_constant__ CUtensorMap wbmap, const T* __restrict__ x,
                  const int* __restrict__ gs, T* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ arrived, int C, int D, int F, int gpw, int S, int per,
                  RW rw) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NB = dec_cols<T>, ST = dec_stages<DUAL>, NP = DUAL ? 2 : 1;
  constexpr uint32_t WST = NP * DEC_W_BYTES, XR = dec_x_row<T>, XST = dec_x_bytes<T>;
  constexpr uint32_t BOX = dec_box_bytes<T>;
  constexpr int EPT = DEC_ROWS * NB / (DEC_CONSUMERS * 32);   // outputs a consumer thread: 8, 4
  extern __shared__ unsigned char dec_smem_raw[];
  const int strip = blockIdx.x / S, s = blockIdx.x % S, g = blockIdx.y;
  const int n0 = strip * NB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int count = rw.count(gs, g, C);
  if (count == 0) {
    // no live row: the padded layouts' zeros, no loads
    if (s == 0) {
      T* og = rw.out(out, g, C, F);
      for (int i = tid; i < rw.stored(C, 0) * NB; i += DEC_THREADS) {
        const int n = n0 + i % NB;
        if (n < F) og[(size_t)(i / NB) * F + n] = from_f<T>(0.f);
      }
    }
    return;
  }
  const int nk = (D + DEC_BK - 1) / DEC_BK;
  const int t0 = s * per, nt = min(per, nk - t0);   // this split's stages

  // the ring (1024-byte aligned: swizzle atoms), the x chunks, full[ST],
  // empty[ST], the last-arrival flag
  const uint32_t base = smem_addr(dec_smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;
  const uint32_t xring = ring + ST * WST;
  const uint32_t full = xring + ST * XST, empty = full + 8 * ST;
  unsigned char* const gen = dec_smem_raw + (ring - base);   // generic view of the ring
  int* const last_flag = reinterpret_cast<int*>(gen + (empty + 8 * ST - ring));
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1 + 32);
      mbar_init(empty + 8 * i, DEC_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == DEC_CONSUMERS) {
    constexpr int VEC = 16 / sizeof(T), CPR = DEC_BK / VEC;   // 16-byte copies a row
    const T* xg = rw.in(x, g, C, D);
    const int gw = g / gpw;
    for (int t = 0; t < nt; ++t) {
      const int st = t % ST, k0 = (t0 + t) * DEC_BK;
      if (t >= ST) mbar_wait(empty + 8 * st, (t / ST - 1) & 1);
      const uint32_t bar = full + 8 * st, w = ring + st * WST;
      if (lane == 0) {
        mbar_expect_tx(bar, WST);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int h = 0; h < NB / DEC_BOX; ++h)
            tma_load_3d(w + p * DEC_W_BYTES + h * BOX, p ? &wbmap : &wamap, bar,
                        n0 + DEC_BOX * h, k0, gw);
      }
#pragma unroll
      for (int i = lane; i < DEC_ROWS * CPR; i += 32) {
        const int r = i / CPR, k = k0 + (i % CPR) * VEC;
        const bool live = r < count && k < D;
        cp_async_zfill16(xring + st * XST + r * XR + (i % CPR) * 16,
                         live ? xg + (size_t)r * D + k : xg, live ? 16 : 0);
      }
      cp_async_mbar_arrive(bar);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // none in flight past exit
    return;
  }

  // consumers: acc[p][e / 4][e % 4] is output e of this thread (row_of,
  // col_of below) for product p; bf16: the two mma tiles' fragments
  float acc[NP][EPT / 4][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[p][e / 4][e % 4] = 0.f;
  const int gid = lane / 4, tig = lane % 4;
  for (int t = 0; t < nt; ++t) {
    const int st = t % ST;
    mbar_wait(full + 8 * st, (t / ST) & 1);
    if constexpr (BF16) {
      // warp w: columns 32w..32w+31 = box w/2, two 16-column tiles j; lane
      // addresses: ldmatrix.trans tile i = (k + 8 if i >= 2, columns + 8 if
      // i odd), ldmatrix x tile i = k 8i..8i+7 of a 32-k group, row lane % 8
      const uint32_t w = ring + st * WST + (warp / 2) * BOX;
      const int a_k = (lane & 7) + (lane >> 4) * 8, a_c = (warp % 2) * 4 + ((lane >> 3) & 1);
      const uint32_t xa = xring + st * XST + (lane & 7) * XR + (lane >> 3) * 16;
#pragma unroll
      for (int kg = 0; kg < DEC_BK / 32; ++kg) {
        uint32_t b[4];
        ldmatrix_x4(b, xa + kg * 64);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = kg * 32 + h * 16 + a_k;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // 16-byte chunk (a_c + 2j) of row kr, 128-byte swizzled
            const uint32_t off = kr * 128 + (((a_c + 2 * j) ^ (kr & 7)) << 4);
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              uint32_t a[4];
              ldmatrix_x4_trans(a, w + p * DEC_W_BYTES + off);
              mma_16816(acc[p][j], a, b[2 * h], b[2 * h + 1]);
            }
          }
        }
      }
    } else {
      // thread: column tid % 64, rows 4 (tid / 64) .. + 3
      const float* w = reinterpret_cast<const float*>(gen + st * WST) + tid % NB;
      const float* xs = reinterpret_cast<const float*>(gen + ST * WST + st * XST) +
                        (tid / NB) * EPT * DEC_BK;
#pragma unroll 8
      for (int k = 0; k < DEC_BK; ++k) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float wv = w[p * (DEC_W_BYTES / 4) + k * NB];
#pragma unroll
          for (int e = 0; e < EPT; ++e)
            acc[p][0][e] = fmaf(xs[e * DEC_BK + k], wv, acc[p][0][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // output e of this thread: (row, column of the strip)
  auto row_of = [&](int e) {
    return BF16 ? 2 * tig + (e & 1) : (tid / NB) * EPT + e;
  };
  auto col_of = [&](int e) {
    return BF16 ? 32 * warp + 16 * (e / 4) + gid + ((e >> 1) & 1) * 8 : tid % NB;
  };
  const int n_out = rw.stored(C, count);
  if (S > 1) {
    // partials of the live rows, then count in; the last block merges
    const size_t plane = (size_t)S * gridDim.y * C * F;   // one product's partials
    float* const mine = part + ((size_t)s * gridDim.y + g) * C * F;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int r = row_of(e), n = n0 + col_of(e);
      if (r < count && n < F) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
          mine[p * plane + (size_t)r * F + n] = acc[p][e / 4][e % 4];
      }
    }
    __threadfence();
    named_sync(1, DEC_CONSUMERS * 32);
    if (tid == 0) {
      int* c = arrived + (size_t)g * (gridDim.x / S) + strip;
      const bool last = add_acq_rel(c) == S - 1;
      if (last) *c = 0;
      *last_flag = last;
    }
    named_sync(1, DEC_CONSUMERS * 32);
    if (!*last_flag) return;
    const float* const all = part + (size_t)g * C * F;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int r = row_of(e), n = n0 + col_of(e);
      if (r >= count || n >= F) continue;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float v = 0.f;
        for (int q = 0; q < S; ++q)
          v += __ldcg(all + p * plane + (size_t)q * gridDim.y * C * F + (size_t)r * F + n);
        acc[p][e / 4][e % 4] = v;
      }
    }
  }
  // epilogue on the full fp32 sums: silu(a) * b (dual), one cast; rows in
  // [count, n_out) are the padded layouts' zeros
  T* og = rw.out(out, g, C, F);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int r = row_of(e), n = n0 + col_of(e);
    if (r >= n_out || n >= F) continue;
    float v = 0.f;
    if (r < count) {
      const float a = acc[0][e / 4][e % 4];
      if constexpr (DUAL) v = a / (1.f + expf(-a)) * acc[1][e / 4][e % 4];
      else v = a;
    }
    og[(size_t)r * F + n] = from_f<T>(v);
  }
}

// Encodes the weights' tensor maps, 3-D over (G / gpw, D, F), and launches
// the decode body: grid (strips * S, G). `S` splits of ceil(nk / S) stages,
// every split non-empty; with S > 1 `part` holds S * G * C * F floats per
// product and `arrived` G * strips zeroed counters, which the launch leaves
// zeroed. An encode or attribute failure is returned, never worked around.
template <typename T, bool DUAL, class RW>
cudaError_t launch_decode(const void* x, const void* wa, const void* wb, const int* gs,
                          void* out, float* part, int* arrived, int G, int C, int D, int F,
                          int gpw, int S, RW rw, cudaStream_t st) {
  constexpr int NB = dec_cols<T>;
  const int nk = (D + DEC_BK - 1) / DEC_BK;
  const int per = S > 0 ? (nk + S - 1) / S : 0;
  if (S < 1 || (nk == 0 ? S != 1 : (S - 1) * per >= nk) || (S > 1 && (!part || !arrived)))
    return cudaErrorInvalidValue;
  if (G == 0 || F == 0) return cudaSuccess;
  CUtensorMap amap{}, bmap{};
  if (nk > 0) {   // D = 0: no stage, no load reads the maps
    const CUtensorMapDataType type =
        sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const CUtensorMapSwizzle swz =
        sizeof(T) == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
    const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)(G / gpw)};
    const cuuint64_t strides[2] = {(cuuint64_t)F * sizeof(T), (cuuint64_t)F * D * sizeof(T)};
    const cuuint32_t box[3] = {DEC_BOX, DEC_BK, 1};
    cudaError_t err = encode_map(&amap, type, wa, 3, dims, strides, box, swz);
    if (err == cudaSuccess && DUAL) err = encode_map(&bmap, type, wb, 3, dims, strides, box, swz);
    if (err != cudaSuccess) return err;
  }
  auto kern = gmm_decode_kernel<T, DUAL, RW>;
  constexpr size_t smem = dec_smem<T, DUAL>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((F + NB - 1) / NB) * S, G);
  kern<<<grid, DEC_THREADS, smem, st>>>(amap, bmap, static_cast<const T*>(x), gs,
                                        static_cast<T*>(out), part, arrived, C, D, F, gpw, S,
                                        per, rw);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// prefill, bf16: wgmma on a TMA ring, one producer warp
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG_BM = 128, WG_BK = 64;                // block rows, K per stage
constexpr int WG_CONSUMERS = 2;                        // warpgroups of 64 rows
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;    // and one producer warp
constexpr uint32_t X_BYTES = WG_BM * WG_BK * 2;        // 128 rows of 128 B
constexpr uint32_t W_BOX = WG_BK * 64 * 2;             // 64 k x 64 columns
constexpr uint32_t W_BYTES = 2 * W_BOX;                // one accumulator's 128 columns
constexpr uint32_t WG_STAGE = X_BYTES + 2 * W_BYTES;   // 48 KB
constexpr int WG_STAGES = 4;                           // 192 KB
constexpr size_t WG_SMEM = (size_t)WG_STAGES * WG_STAGE + 1024 + 16 * WG_STAGES;
// columns per block: the dual form's two accumulators are its two products
// over 128 columns, the single product's are 256 columns of one
template <bool DUAL> constexpr int wg_cols = DUAL ? 128 : 256;

// One block per (row tile of 128, column tile, group): 128 columns of both
// products (dual) or 256 of one (single), so that every stage feeds the
// tensor cores as many operations per loaded byte either way (2 x 128 x 256
// per 48 KB). The row tiles of one (group, column tile) are adjacent block
// indices, so they read the group's weight panel from HBM once and from L2
// after. Warps 0-7 are two consumer warpgroups (rows 0-63, 64-127 of the
// tile), each with two 64 x 128 fp32 accumulators; warp 8 is the producer:
// its lane 0 keeps the 4-stage ring full with TMA loads (x: 128 rows x 64
// k; weights: 64 k x 256 columns as four 64-column boxes, 128-byte swizzle)
// and the consumers run wgmma m64n128k16 on each stage as it lands. x is
// the K-major A operand; the weights (D, F) with F contiguous are the
// MN-major B operand. The tensor maps zero whatever lies outside
// the tensor (rows past C or R, k past D, columns past F), and the weights'
// map is 3-D over (G / gpw, D, F), so a K tail never reads the next
// expert's rows. Rows of a live tile past the count may hold anything (a
// neighbour's rows, gap rows, NaN): a row of A reaches only its own row of
// the product, and the epilogue stores zeros or nothing there. The 288
// threads get 224 registers each at one block per SM, enough for the two
// 64 x 128 fp32 accumulators per warpgroup (128 a thread), so no register
// rebalancing (setmaxnreg) is needed.
template <bool DUAL, class RW>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wamap,
                 const __grid_constant__ CUtensorMap wbmap, const int* __restrict__ gs,
                 bf16* __restrict__ out, int C, int D, int F, int gpw, RW rw) {
  constexpr int ST = WG_STAGES, BN = wg_cols<DUAL>;
  constexpr uint32_t STAGE = WG_STAGE;
  extern __shared__ unsigned char wg_smem_raw[];
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * BN, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int count = rw.count(gs, g, C);
  const int n_out = rw.stored(C, count);
  bf16* og = rw.out(out, g, C, F);
  if (m0 >= count) {
    // Dead row tile: zeros where the layout stores them, no loads.
    for (int i = tid; i < WG_BM * BN / 2; i += WG_THREADS) {
      const int m = m0 + i / (BN / 2), n = n0 + 2 * (i % (BN / 2));
      if (m < n_out && n < F) *reinterpret_cast<uint32_t*>(og + (size_t)m * F + n) = 0u;
    }
    return;
  }

  // the ring (1024-byte aligned: 128-byte swizzle atoms), then the barriers:
  // full[s] (the producer's arrival + the stage's bytes), empty[s] (one
  // arrival per consumer warp once its products have read the stage)
  const uint32_t ring = (smem_addr(wg_smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + ST * STAGE, empty = full + 8 * ST;
  const int nk = (D + WG_BK - 1) / WG_BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS * 4) {
    if (lane == 0) {
      const int gw = g / gpw;
      for (int t = 0; t < nk; ++t) {
        const int s = t % ST, k0 = t * WG_BK;
        if (t >= ST) mbar_wait(empty + 8 * s, (t / ST - 1) & 1);
        const uint32_t st = ring + s * STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE);
        if constexpr (RW::gather) tma_load_2d(st, &xmap, bar, k0, rw.xofs[g] + m0);
        else tma_load_3d(st, &xmap, bar, k0, m0, g);
        // the B tiles of the two accumulators: wg's and wu's 128 columns,
        // or 256 columns of w
#pragma unroll
        for (int h = 0; h < 4; ++h)
          tma_load_3d(st + X_BYTES + h * W_BOX, DUAL && h >= 2 ? &wbmap : &wamap, bar,
                      n0 + 64 * (DUAL ? h % 2 : h), k0, gw);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc_a[64], acc_b[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc_a[i] = 0.f;
    acc_b[i] = 0.f;
  }

  for (int t = 0; t < nk; ++t) {
    const int s = t % ST;
    mbar_wait(full + 8 * s, (t / ST) & 1);
    const uint32_t st = ring + s * STAGE;
    const uint32_t xa = st + wg * 64 * 128;   // this warpgroup's 64 rows
    fence_regs(acc_a);
    fence_regs(acc_b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: 16 k = 32 bytes along each swizzled row; B: 16 rows of 128 B
      const uint64_t da = gmma_desc(xa + kk * 32, 16, 1024, SWIZZLE_128B);
      wgmma_ss<1>(acc_a, da, gmma_desc(st + X_BYTES + kk * 2048, W_BOX, 1024, SWIZZLE_128B),
                  1);
      wgmma_ss<1>(acc_b, da,
                  gmma_desc(st + X_BYTES + W_BYTES + kk * 2048, W_BOX, 1024, SWIZZLE_128B), 1);
    }
    wgmma_commit();
    // the previous stage's products are done: hand it back to the producer
    wgmma_wait<1>();
    fence_regs(acc_a);
    fence_regs(acc_b);
    if (t > 0 && lane == 0) mbar_arrive(empty + 8 * ((t - 1) % ST));
  }
  wgmma_wait<0>();
  fence_regs(acc_a);
  fence_regs(acc_b);

  // epilogue from the fragments: fp32 silu(a) * b (dual) or the two column
  // halves (single), one cast, bf16x2 stores
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = r0 + 8 * half;
    if (m >= n_out) continue;
    const bool live = m < count;
    bf16* orow = og + (size_t)m * F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = 4 * j + 2 * half, n = n0 + 8 * j + 2 * (lane % 4);
      if constexpr (DUAL) {
        if (n >= F) continue;   // F is even: n + 1 < F too
        float v0 = 0.f, v1 = 0.f;
        if (live) {
          v0 = acc_a[i] / (1.f + expf(-acc_a[i])) * acc_b[i];
          v1 = acc_a[i + 1] / (1.f + expf(-acc_a[i + 1])) * acc_b[i + 1];
        }
        *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16x2(v0, v1);
      } else {
        if (n < F)
          *reinterpret_cast<uint32_t*>(orow + n) =
              live ? pack_bf16x2(acc_a[i], acc_a[i + 1]) : 0u;
        if (n + 128 < F)
          *reinterpret_cast<uint32_t*>(orow + n + 128) =
              live ? pack_bf16x2(acc_b[i], acc_b[i + 1]) : 0u;
      }
    }
  }
}

// Encodes the three tensor maps and launches the wgmma body. x: 3-D over
// (G, C, D), or with a gather 2-D over the flat (R, D); weights 3-D over
// (G / gpw, D, F). An encode or attribute failure is returned, never
// worked around.
template <bool DUAL, class RW>
cudaError_t launch_wgmma(const void* x, const void* wa, const void* wb, const int* gs,
                         void* out, int G, int C, int D, int F, int gpw, RW rw,
                         cudaStream_t st) {
  constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap xmap{}, amap, bmap;
  const cuuint64_t row = (cuuint64_t)D * 2;
  cudaError_t err = cudaSuccess;
  if constexpr (RW::gather) {
    // no flat rows: every tile is dead and no load reads the map
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rw.in_rows};
    const cuuint64_t strides[1] = {row};
    const cuuint32_t box[2] = {WG_BK, WG_BM};
    if (rw.in_rows > 0)
      err = encode_map(&xmap, type, x, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)G};
    const cuuint64_t strides[2] = {row, row * C};
    const cuuint32_t box[3] = {WG_BK, WG_BM, 1};
    err = encode_map(&xmap, type, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)(G / gpw)};
  const cuuint64_t wstrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)F * 2 * D};
  const cuuint32_t wbox[3] = {64, WG_BK, 1};
  err = encode_map(&amap, type, wa, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  bmap = amap;   // the single product reads one weight
  if (DUAL) err = encode_map(&bmap, type, wb, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kern = gmm_wgmma_kernel<DUAL, RW>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + WG_BM - 1) / WG_BM, (F + wg_cols<DUAL> - 1) / wg_cols<DUAL>, G);
  kern<<<grid, WG_THREADS, WG_SMEM, st>>>(xmap, amap, bmap, gs,
                                                   static_cast<bf16*>(out), C, D, F, gpw, rw);
  return cudaSuccess;
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
cudaError_t dispatch(const void* x, const void* wa, const void* wb, const int* gs,
                     void* out, float* part, int* arrived, int G, int C, int D, int F,
                     int gpw, int S, RW rw, cudaStream_t st) {
  if (C <= DEC_ROWS)
    return launch_decode<T, DUAL, RW>(x, wa, wb, gs, out, part, arrived, G, C, D, F, gpw, S,
                                      rw, st);
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_wgmma<DUAL, RW>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
  } else {
    launch<T, 64, 128, 16, 4, 8, DUAL, RW>(x, wa, wb, gs, out, G, C, D, F, gpw, rw, st);
    return cudaSuccess;
  }
}

// The forms the wrappers launch: padded with counts (both products),
// padded with every row live (both products; gs null), gather (both
// products: the SwiGLU front half, or the single product) and scatter (the
// single product of the down projection).
template <typename T>
int dispatch_layout(const void* x, const void* wa, const void* wb, const int* gs,
                    const int* xofs, const int* oofs, void* out, float* part, int* arrived,
                    int G, int C, int D, int F, int gpw, int in_rows, int out_rows, bool dual,
                    int S, cudaStream_t st) {
  auto run = [&](auto rw, auto dual_form) {
    constexpr bool DUAL = decltype(dual_form)::value;
    return dispatch<T, DUAL>(x, wa, wb, gs, out, part, arrived, G, C, D, F, gpw, S, rw, st);
  };
  using Dual = std::true_type;
  using Single = std::false_type;
  cudaError_t err;
  if (!gs) {
    if (xofs || oofs) return static_cast<int>(cudaErrorInvalidValue);
    const Rows<false, false, true> rw{nullptr, nullptr, 0, 0};
    err = dual ? run(rw, Dual{}) : run(rw, Single{});
  } else if (!xofs && !oofs) {
    const Rows<false, false> rw{nullptr, nullptr, 0, 0};
    err = dual ? run(rw, Dual{}) : run(rw, Single{});
  } else if (xofs && !oofs) {
    const Rows<true, false> rw{xofs, nullptr, in_rows, 0};
    err = dual ? run(rw, Dual{}) : run(rw, Single{});
  } else if (!xofs && oofs && !dual) {
    const Rows<false, true> rw{nullptr, oofs, 0, out_rows};
    err = run(rw, Single{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (G, C, D) or, with xofs, flat (in_rows, D); wa/wb (G/gpw, D, F);
// gs (G,) int32, or null for every row live (padded only); out (G, C, F)
// or, with oofs, flat (out_rows, F); xofs and oofs (G,) int32 or null:
// padded, gather or scatter (single product only). All contiguous,
// 16-byte aligned, D and F multiples of 16 / sizeof(T). wb is read only
// when dual != 0. At decode (C <= 8) `splits` is the K split count S (the
// wrapper's gmm/ragged.py::decode_splits, from static shapes), and with
// S > 1 part holds S * G * C * F floats per product and arrived
// G * ceil(F / strip) zeroed int32 counters (strip 128 bf16, 64 fp32), left
// zeroed; both may be null when S = 1, and all three are ignored for
// C > 8. Returns cudaGetLastError() after launch.
extern "C" int gmm_ragged_launch(const void* x, const void* wa, const void* wb,
                                 const void* gs, const void* xofs,
                                 const void* oofs, void* out, void* part, void* arrived,
                                 int G, int C, int D, int F, int gpw, int in_rows,
                                 int out_rows, int dtype, int dual, int splits,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gs);
  const int* xo = static_cast<const int*>(xofs);
  const int* oo = static_cast<const int*>(oofs);
  float* pt = static_cast<float*>(part);
  int* ar = static_cast<int*>(arrived);
  if (dtype == DT_F32)
    return dispatch_layout<float>(x, wa, wb, g, xo, oo, out, pt, ar, G, C, D, F, gpw,
                                  in_rows, out_rows, dual != 0, splits, st);
  if (dtype == DT_BF16)
    return dispatch_layout<__nv_bfloat16>(x, wa, wb, g, xo, oo, out, pt, ar, G, C, D, F,
                                          gpw, in_rows, out_rows, dual != 0, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory the bf16 prefill body asks for at launch, in bytes.
extern "C" long long gmm_wgmma_smem_bytes() { return static_cast<long long>(WG_SMEM); }
