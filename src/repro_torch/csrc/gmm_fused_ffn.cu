// Fused SwiGLU expert FFN over flat rows: gather prologue, hidden block on
// chip, scatter epilogue, in one kernel.
//
// Replaces the TPU kernel src/repro/kernels/gmm/ragged.py::gmm_fused_ffn
// (_fused_ffn_kernel):
//
//   rows_g = x[ofs[g] : ofs[g] + count_g]                        (R, D)
//   h      = silu(rows_g @ wg[g / gpw]) * (rows_g @ wu[g / gpw])  cast to T
//   out[ofs[g] : ofs[g] + count_g] = h @ wd[g / gpw]              (R, D_out)
//
// count_g = min(gs[g], C). Rows outside every live segment are never
// written, and never reach a stored value: the TPU kernel stores whole row
// tiles in grid order and relies on a later bucket overwriting a partial
// tile's spill; CUDA blocks have no store order, so only rows < count_g are
// stored. A dead group reads no weights. The hidden block is cast to the I/O
// type before the down projection, as the two-kernel pair stores it, so
// fused and pair differ only in summation order.
//
// What bounds it on an H100: at decode (C <= 8) the three weight panels of
// every live group (3 D F bytes of bf16 each) over HBM bandwidth; at
// prefill the operations, 2 * 3 * sum(count) * D * F, over the bf16
// tensor-core peak. The TPU kernel keeps a (bm, D_out) fp32 accumulator in
// VMEM for the whole hidden loop, so the hidden tensor never leaves the
// chip and the front half runs once per row tile. Three bodies:
//
// * bf16, C <= 8 (decode): fused_decode_kernel splits the HIDDEN dimension
//   over blocks, grid (S slices, G). A block computes its slice's gate and
//   up products once over all of D, keeps silu(a) * b in shared memory
//   (rounded to bf16; 8 rows x 512 columns at most, 8 KB), then streams the
//   slice's rows of wd through the same ring into fp32 partial outputs,
//   256 columns at a time. The machinery is gmm_ragged.cu's decode body: a
//   producer warp's TMA ring of 32 KB weight stages (3 stages, two blocks an
//   SM), x rows by cp.async with dead rows zero-filled (source size 0),
//   mma.sync m16n8k16 on the transposed product (W^T by ldmatrix.trans from
//   the 128-byte-swizzled tile; x^T, then h^T, by ldmatrix from rows padded
//   by 16 bytes). The slice width comes from static shapes
//   (kernels/gmm/ragged.py::fused_decode_slice); with S > 1 slices each
//   block stores fp32 partials of each 256-column strip and counts in on
//   that strip's zeroed counter, and the last of its S blocks adds them in
//   slice order and stores bf16 rows at the offsets, so two calls are
//   bitwise equal. The hidden slice never touches HBM; the partials are
//   S x count x D_out x 4 bytes a group, about 2% of its weight bytes at
//   mixtral's decode layout (S = 32, 2 rows a group).
// * bf16, C > 8 (prefill): fused_cluster_kernel keeps the TPU kernel's
//   (bm, D_out) accumulator on chip across a cluster of 16 CTAs (the
//   non-portable size) per (group, 128-row tile): CTA r owns output columns
//   [256 r, 256 r + 256) of one 4096-column pass (wider outputs take more
//   passes, each recomputing the front half), held by two consumer
//   warpgroups as 64 x 256 fp32 wgmma accumulators (m64n256k16, 128
//   registers a thread; setmaxnreg moves the producer warpgroup's registers
//   to them). For each hidden block of 1024 columns, CTA r computes the gate
//   and up products of its 64 of them over all of D (one m64n128k16 per
//   warpgroup over the adjacent wg and wu boxes), rounds silu * up to bf16
//   into its own shared memory as a 128-byte-swizzled K-major 128 x 64
//   slice, meets the cluster at a barrier, and accumulates the 16 slices,
//   each copied from its rank through distributed shared memory (staggered:
//   CTA r starts at rank r), @ wd[block, its 256 columns]. The front half
//   runs once per row tile and the hidden tensor never leaves the chip;
//   slices are double-buffered, so one cluster barrier a block suffices.
//   128 rows, not 64: at 64 the weights stream through each SM at 64
//   operations a byte and the body was bound by the loads (PERF.md).
// * fp32 (the comparison dtype and the small fp32 models): a block owns a
//   (BM rows) x (128 output columns) tile, walks the hidden dimension in
//   blocks of 128 and recomputes each hidden block from x, wg and wu as
//   fp32 FMA tiles on the CUDA cores (TF32 would change the numbers).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// fp32: FMA tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BN = 128;   // output columns per block
constexpr int BF = 128;   // hidden columns per step
constexpr int BK = 16;    // reduction tile
constexpr int TN = 8;     // columns per thread
constexpr int NX = BN / TN;
static_assert(BF == BN, "one thread layout serves both halves");

template <int BM>
constexpr size_t smem_floats() {
  return (size_t)BK * BM + 2 * BK * BF + (size_t)BF * BM + BK * BN;
}

template <typename T, int BM, int TM>
__global__ void __launch_bounds__((BM / TM) * NX)
gmm_fused_ffn_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                     const T* __restrict__ wu, const T* __restrict__ wd,
                     const int* __restrict__ ofs, const int* __restrict__ gs,
                     T* __restrict__ out, int C, int D, int F, int DO, int gpw,
                     int R) {
  constexpr int NT = (BM / TM) * NX;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                 // [BK][BM]   x tile, transposed
  float* as = xs + BK * BM;        // [BK][BF]   wg tile
  float* bs = as + BK * BF;        // [BK][BF]   wu tile
  float* hs = bs + BK * BF;        // [BF][BM]   hidden block, rounded to T
  float* ds = hs + BF * BM;        // [BK][BN]   wd tile

  const Rows<true, true> rw{ofs, ofs, R, R};
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / NX, tx = tid % NX;
  const int count = rw.count(gs, g, C);
  if (m0 >= count) return;   // nothing live: no reads, no stores
  const T* xg = rw.in(x, g, C, D);
  const size_t w = (size_t)(g / gpw);
  const T* gg = wg + w * D * F;
  const T* ug = wu + w * D * F;
  const T* dg = wd + w * F * DO;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += BF) {
    // front half: hidden block h[BM, BF] over the whole of D
    float ha[TM][TN], hb[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) ha[i][j] = hb[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int i = tid; i < BM * (BK / VEC); i += NT) {
        const int mm = i / (BK / VEC), kk = (i % (BK / VEC)) * VEC;
        const int m = m0 + mm, k = k0 + kk;
        float v[VEC];
        if (m < count && k < D) {   // rows past the count are never read
          load_vec16(xg + (size_t)m * D + k, v);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) xs[(kk + e) * BM + mm] = v[e];
      }
      for (int i = tid; i < BK * (BF / VEC); i += NT) {
        const int kk = i / (BF / VEC), nn = (i % (BF / VEC)) * VEC;
        const int k = k0 + kk, f = f0 + nn;
        float va[VEC], vb[VEC];
        if (k < D && f < F) {
          load_vec16(gg + (size_t)k * F + f, va);
          load_vec16(ug + (size_t)k * F + f, vb);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) va[e] = vb[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          as[kk * BF + nn + e] = va[e];
          bs[kk * BF + nn + e] = vb[e];
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float xr[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[i] = xs[kk * BM + ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float a = as[kk * BF + tx + j * NX];
          const float b = bs[kk * BF + tx + j * NX];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            ha[i][j] = fmaf(xr[i], a, ha[i][j]);
            hb[i][j] = fmaf(xr[i], b, hb[i][j]);
          }
        }
      }
      __syncthreads();
    }
    // activation, masked to the live rows and cast to the I/O type (the
    // pair stores the hidden tensor in T between its two kernels)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int mm = ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float a = ha[i][j];
        const float h = m0 + mm < count ? a / (1.f + expf(-a)) * hb[i][j] : 0.f;
        hs[(tx + j * NX) * BM + mm] = round_to<T>(h);
      }
    }
    __syncthreads();
    // down projection of this hidden block into the output tile
    for (int kk0 = 0; kk0 < BF; kk0 += BK) {
      for (int i = tid; i < BK * (BN / VEC); i += NT) {
        const int kk = i / (BN / VEC), nn = (i % (BN / VEC)) * VEC;
        const int f = f0 + kk0 + kk, n = n0 + nn;
        float v[VEC];
        if (f < F && n < DO) {
          load_vec16(dg + (size_t)f * DO + n, v);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) ds[kk * BN + nn + e] = v[e];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float hr[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) hr[i] = hs[(kk0 + kk) * BM + ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float d = ds[kk * BN + tx + j * NX];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(hr[i], d, acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // scatter epilogue: live rows only
  T* og = rw.out(out, g, C, DO);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= count) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n < DO) og[(size_t)m * DO + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <int BM, int TM>
cudaError_t launch_fma(const void* x, const void* wg, const void* wu, const void* wd,
                       const int* ofs, const int* gs, void* out, int G, int C, int D, int F,
                       int DO, int gpw, int R, cudaStream_t st) {
  auto kern = gmm_fused_ffn_kernel<float, BM, TM>;
  const size_t smem = smem_floats<BM>() * sizeof(float);
  // > 48 KB of dynamic shared memory needs the opt-in
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((DO + BN - 1) / BN, (C + BM - 1) / BM, G);
  kern<<<grid, (BM / TM) * NX, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), static_cast<const float*>(wd), ofs, gs,
      static_cast<float*>(out), C, D, F, DO, gpw, R);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 decode (C <= 8): hidden slices, a TMA ring, mma.sync
// ---------------------------------------------------------------------------

constexpr int FD_ROWS = 8;                          // rows a group (the mma's n)
constexpr int FD_BK = 64;                           // k a stage (D, then the slice)
constexpr int FD_CONSUMERS = 4;                     // consumer warps
constexpr int FD_THREADS = FD_CONSUMERS * 32 + 32;  // and one producer warp
constexpr int FD_STRIP = 128;                       // hidden columns a front strip
constexpr int FD_OSTRIP = 256;                      // output columns a down strip
constexpr int FD_MAX_SLICE = 512;                   // hidden columns a block
constexpr uint32_t FD_BOX = 64 * 64 * 2;            // a TMA box: 64 k x 64 columns
constexpr uint32_t FD_STAGE = 4 * FD_BOX;           // wg, wu x 128 columns; or wd x 256
constexpr int FD_STAGES = 3;                        // about 96 KB in flight a block
constexpr uint32_t FD_XROW = FD_BK * 2 + 16;        // x rows padded by 16 bytes
constexpr uint32_t FD_XST = FD_ROWS * FD_XROW;
constexpr uint32_t FD_HROW = FD_MAX_SLICE * 2 + 16; // hidden rows padded by 16 bytes
// the ring (1024-byte aligned), x chunks, hidden rows, full[], empty[], a flag
constexpr size_t FD_SMEM = 1024 + (size_t)FD_STAGES * (FD_STAGE + FD_XST) +
                           FD_ROWS * FD_HROW + 16 * FD_STAGES + 16;

// One block per (hidden slice s of FS columns, group): grid (S, G). Warp 4
// is the producer: lane 0 keeps the ring full with TMA loads, first the
// front half's stages (per 128-column strip of the slice, every 64-deep k of
// D: wg's and wu's two 64 x 64 boxes each), then the down half's (per
// 256-column strip of the output, every 64 hidden rows of the slice: four
// boxes of wd); in the front stages every lane stages the x rows with
// cp.async (rows at or past the count, and k past D, zero-filled without a
// read). Warps 0-3 consume. Front: warp w takes strip columns 32w..32w+31 of
// both products (mma.sync, output transposed); at a strip's end silu(a) * b
// is rounded to bf16 into the hidden rows. Down: warp w takes 64 columns of
// the output strip, B = h^T from the hidden rows. With S = 1 the strip is
// stored as bf16 rows at the group's offset; with S > 1 as fp32 partials
// (S, G, C, DO) that the strip's last block sums in slice order.
__global__ void __launch_bounds__(FD_THREADS, 2)
fused_decode_kernel(const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap umap,
                    const __grid_constant__ CUtensorMap dmap, const bf16* __restrict__ x,
                    const int* __restrict__ ofs, const int* __restrict__ gs,
                    bf16* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ arrived, int C, int D, int F, int DO, int gpw, int R,
                    int FS) {
  extern __shared__ unsigned char fd_smem_raw[];
  const int s = blockIdx.x, S = gridDim.x, g = blockIdx.y, G = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Rows<true, true> rw{ofs, ofs, R, R};
  const int count = rw.count(gs, g, C);
  if (count == 0) return;   // a dead group: no loads, no stores
  const int f0 = s * FS, nf = min(FS, F - f0);
  const int nkd = (D + FD_BK - 1) / FD_BK;             // front stages a strip
  const int nfront = (nf + FD_STRIP - 1) / FD_STRIP;   // front strips
  const int nkf = (nf + FD_BK - 1) / FD_BK;            // down stages an output strip
  const int nout = (DO + FD_OSTRIP - 1) / FD_OSTRIP;   // output strips
  const int n_front = nfront * nkd, total = n_front + nout * nkf;

  const uint32_t base = smem_addr(fd_smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;
  const uint32_t xring = ring + FD_STAGES * FD_STAGE;
  const uint32_t hs = xring + FD_STAGES * FD_XST;
  const uint32_t full = hs + FD_ROWS * FD_HROW, empty = full + 8 * FD_STAGES;
  unsigned char* const gen = fd_smem_raw + (ring - base);   // generic view of the ring
  int* const last_flag = reinterpret_cast<int*>(gen + (empty + 8 * FD_STAGES - ring));
  if (tid == 0) {
    for (int i = 0; i < FD_STAGES; ++i) {
      mbar_init(full + 8 * i, 1 + 32);
      mbar_init(empty + 8 * i, FD_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == FD_CONSUMERS) {
    constexpr int CPR = FD_BK / 8;   // 16-byte copies a row
    const bf16* xg = rw.in(x, g, C, D);
    const int gw = g / gpw;
    for (int t = 0; t < total; ++t) {
      const int st = t % FD_STAGES;
      if (t >= FD_STAGES) mbar_wait(empty + 8 * st, (t / FD_STAGES - 1) & 1);
      const uint32_t bar = full + 8 * st, w = ring + st * FD_STAGE;
      if (t < n_front) {
        const int c0 = f0 + (t / nkd) * FD_STRIP, k0 = (t % nkd) * FD_BK;
        if (lane == 0) {
          mbar_expect_tx(bar, FD_STAGE);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_load_3d(w + b * FD_BOX, b < 2 ? &gmap : &umap, bar, c0 + 64 * (b & 1), k0, gw);
        }
#pragma unroll
        for (int i = lane; i < FD_ROWS * CPR; i += 32) {
          const int r = i / CPR, k = k0 + (i % CPR) * 8;
          const bool live = r < count && k < D;
          cp_async_zfill16(xring + st * FD_XST + r * FD_XROW + (i % CPR) * 16,
                           live ? xg + (size_t)r * D + k : xg, live ? 16 : 0);
        }
      } else {
        const int u = t - n_front;
        const int n0 = (u / nkf) * FD_OSTRIP, k0 = f0 + (u % nkf) * FD_BK;
        if (lane == 0) {
          mbar_expect_tx(bar, FD_STAGE);
#pragma unroll
          for (int b = 0; b < 4; ++b) tma_load_3d(w + b * FD_BOX, &dmap, bar, n0 + 64 * b, k0, gw);
        }
      }
      cp_async_mbar_arrive(bar);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");   // none in flight past exit
    return;
  }

  // consumers. Fragments (mma m16n8k16, output transposed): lane l holds
  // rows 2 (l % 4) (+1) of columns l / 4 (+8) of each 16-column tile; the
  // ldmatrix lane addresses as in gmm_ragged.cu's decode body
  const int gid = lane / 4, tig = lane % 4;
  const int a_k = (lane & 7) + (lane >> 4) * 8, a_hi = (lane >> 3) & 1;
  const uint32_t x_lane = (lane & 7) * FD_XROW + (lane >> 3) * 16;
  const uint32_t h_lane = hs + (lane & 7) * FD_HROW + (lane >> 3) * 16;
  int t = 0;
  for (int strip = 0; strip < nfront; ++strip) {
    float acc[2][2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
    for (int kt = 0; kt < nkd; ++kt, ++t) {
      const int st = t % FD_STAGES;
      mbar_wait(full + 8 * st, (t / FD_STAGES) & 1);
      const uint32_t w = ring + st * FD_STAGE + (warp / 2) * FD_BOX;
      const uint32_t xa = xring + st * FD_XST + x_lane;
#pragma unroll
      for (int kg = 0; kg < FD_BK / 32; ++kg) {
        uint32_t b[4];
        ldmatrix_x4(b, xa + kg * 64);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = kg * 32 + h * 16 + a_k;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // 16-byte chunk of row kr, 128-byte swizzled
            const int chunk = (warp % 2) * 4 + 2 * j + a_hi;
            const uint32_t off = kr * 128 + ((chunk ^ (kr & 7)) << 4);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              uint32_t a[4];
              ldmatrix_x4_trans(a, w + p * 2 * FD_BOX + off);
              mma_16816(acc[p][j], a, b[2 * h], b[2 * h + 1]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    // silu(a) * b on the full fp32 sums, one rounding to bf16, into the
    // slice's hidden rows (rows past the count hold zeros: their x was)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * tig + (e & 1);
        const int c = strip * FD_STRIP + 32 * warp + 16 * j + gid + (e >> 1) * 8;
        const float a = acc[0][j][e];
        *reinterpret_cast<bf16*>(gen + (hs - ring) + r * FD_HROW + c * 2) =
            __float2bfloat16(a / (1.f + expf(-a)) * acc[1][j][e]);
      }
  }
  named_sync(1, FD_CONSUMERS * 32);   // the hidden rows are complete

  bf16* const og = rw.out(out, g, C, DO);
  for (int o = 0; o < nout; ++o) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kt = 0; kt < nkf; ++kt, ++t) {
      const int st = t % FD_STAGES;
      mbar_wait(full + 8 * st, (t / FD_STAGES) & 1);
      const uint32_t w = ring + st * FD_STAGE + warp * FD_BOX;
      const uint32_t ha = h_lane + kt * FD_BK * 2;
#pragma unroll
      for (int kg = 0; kg < FD_BK / 32; ++kg) {
        uint32_t b[4];
        ldmatrix_x4(b, ha + kg * 64);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = kg * 32 + h * 16 + a_k;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int chunk = 2 * j + a_hi;
            uint32_t a[4];
            ldmatrix_x4_trans(a, w + kr * 128 + ((chunk ^ (kr & 7)) << 4));
            mma_16816(acc[j], a, b[2 * h], b[2 * h + 1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    // output (row 2 tig + (e & 1), column n0 + 16 j + gid + 8 (e >> 1))
    const int n0 = o * FD_OSTRIP + 64 * warp;
    if (S == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * tig + (e & 1), n = n0 + 16 * j + gid + (e >> 1) * 8;
          if (r < count && n < DO) og[(size_t)r * DO + n] = __float2bfloat16(acc[j][e]);
        }
      continue;
    }
    // partials of the live rows, then count in; the strip's last block merges
    float* const mine = part + ((size_t)s * G + g) * C * DO;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * tig + (e & 1), n = n0 + 16 * j + gid + (e >> 1) * 8;
        if (r < count && n < DO) mine[(size_t)r * DO + n] = acc[j][e];
      }
    __threadfence();
    named_sync(1, FD_CONSUMERS * 32);
    if (tid == 0) {
      int* c = arrived + (size_t)g * nout + o;
      const bool last = add_acq_rel(c) == S - 1;
      if (last) *c = 0;
      *last_flag = last;
    }
    named_sync(1, FD_CONSUMERS * 32);
    if (!*last_flag) continue;
    // the merge: thread c takes columns 2c, 2c + 1 of the strip in every
    // live row and adds the S partials in slice order, 16 loads in flight
    const int n = o * FD_OSTRIP + 2 * tid;
    if (n >= DO) continue;   // DO is even: n + 1 < DO too
    const size_t step = (size_t)G * C * DO;   // one slice's partials
    for (int r = 0; r < count; ++r) {
      const float* const p = part + ((size_t)g * C + r) * DO + n;
      float2 v = make_float2(0.f, 0.f);
      int q = 0;
      for (; q + 16 <= S; q += 16) {
        float2 l[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) l[u] = __ldcg(reinterpret_cast<const float2*>(p + (q + u) * step));
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          v.x += l[u].x;
          v.y += l[u].y;
        }
      }
      for (; q < S; ++q) {
        const float2 l = __ldcg(reinterpret_cast<const float2*>(p + q * step));
        v.x += l.x;
        v.y += l.y;
      }
      *reinterpret_cast<uint32_t*>(og + (size_t)r * DO + n) = pack_bf16x2(v.x, v.y);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill (C > 8): a cluster of 16 CTAs per (group, 128-row tile)
// ---------------------------------------------------------------------------

constexpr int FC_RANKS = 16;                           // CTAs a cluster (non-portable size)
constexpr int FC_BM = 128;                             // rows a tile: 64 a warpgroup
constexpr int FC_SLICE = 64;                           // hidden columns a rank a block
constexpr int FC_BF = FC_RANKS * FC_SLICE;             // hidden columns a block: 1024
constexpr int FC_COLS = 256;                           // output columns a rank
constexpr int FC_PASS = FC_RANKS * FC_COLS;            // output columns a cluster: 4096
constexpr int FC_BK = 64;                              // k a stage (D, then the block)
constexpr int FC_CONSUMERS = 2;                        // warpgroups
constexpr int FC_THREADS = FC_CONSUMERS * 128 + 128;   // and a producer warpgroup
constexpr int FC_CONSUMER_REGS = 240, FC_PRODUCER_REGS = 24;   // setmaxnreg: 2 x 240 + 24 <= 512
constexpr uint32_t FC_BOX = 64 * 64 * 2;               // a weight box: 64 k x 64 columns
constexpr uint32_t FC_CHUNK = FC_BM * 64 * 2;          // 128 rows x 64 k: an x tile, a slice
constexpr uint32_t FC_SLOT = FC_CHUNK + 2 * FC_BOX;    // x + wg + wu, or 4 wd boxes
static_assert(FC_SLOT == 4 * FC_BOX, "one slot size serves both halves");
constexpr int FC_STAGES = 5;
// shared memory after the 1024-byte alignment: the ring, two staging
// slices, two chunk buffers, full[STAGES], empty[STAGES]
constexpr uint32_t FC_STAGING = FC_STAGES * FC_SLOT;
constexpr uint32_t FC_CHUNKS = FC_STAGING + 2 * FC_CHUNK;
constexpr uint32_t FC_BARS = FC_CHUNKS + 2 * FC_CHUNK;
constexpr size_t FC_SMEM = 1024 + FC_BARS + 8 * 2 * FC_STAGES;

// Grid (16 x row tiles, output passes, G), clusters of 16 along x: rank r of
// tile m owns output columns pass * 4096 + [256 r, 256 r + 256) of the
// tile's 128 rows. Warps 0-7 are two consumer warpgroups, warpgroup w the
// rows 64 w .. 64 w + 63; warps 8-11 the producer warpgroup (lane 0 of warp
// 8 issues every load), which hands its registers to the consumers
// (setmaxnreg: 240 a consumer thread, 24 a producer thread). Each consumer
// holds a 64 x 256 fp32 accumulator (m64n256k16, 128 registers) across the
// whole hidden loop. Per hidden block i (1024 columns, 64 a rank):
//  1. front: one stage per 64 k of D, each the tile's 128 x 64 x block and
//     this rank's 64 columns of wg and wu, side by side; warpgroup w
//     accumulates gate and up of its rows as one m64n128k16 (64 registers:
//     A is read once for both), one stage's products in flight behind the
//     next one's issue;
//  2. silu(gate) * up, rounded to bf16, into staging[i % 2] as a
//     128-byte-swizzled K-major 128 x 64 slice (each warpgroup its rows);
//  3. a cluster barrier (release / acquire): every rank's slice is written.
//     The producer warpgroup arrives once it has issued the block's front
//     stages and waits before its next arrival, so it never holds the
//     barrier up and the ring keeps filling;
//  4. down: for j = 0..15, q = (r + j) % 16, the stage of wd rows
//     [1024 i + 64 q, + 64) x this rank's 256 columns times rank q's slice,
//     which travels through distributed shared memory into registers two
//     steps ahead and into chunk buffer j % 2 one step ahead, beside the
//     products, each warpgroup moving the rows it multiplies (so that a
//     warpgroup never waits for the other). Starting at its own rank, each
//     CTA reads another peer than every other CTA at every step.
// A rank's staging slice of block i is rewritten at block i + 2, after the
// barrier of block i + 1, which every peer reaches only after reading block
// i. Rows of a live tile past the count (other groups' rows, gap rows, NaN)
// reach only their own output row, which is never stored; rows, k and
// columns past the arrays are zeros from the tensor maps. A dead tile exits
// before any cluster barrier, in every CTA of its cluster alike; a live one
// leaves through a cluster barrier, so no peer reads a CTA's shared memory
// after it exited.
__global__ void __launch_bounds__(FC_THREADS, 1)
fused_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap umap,
                     const __grid_constant__ CUtensorMap dmap, const int* __restrict__ ofs,
                     const int* __restrict__ gs, bf16* __restrict__ out, int C, int D, int F,
                     int DO, int gpw, int R) {
  extern __shared__ unsigned char fc_smem_raw[];
  const int rank = static_cast<int>(cluster_rank());
  const int m0 = (blockIdx.x / FC_RANKS) * FC_BM, g = blockIdx.z;
  const int n0 = blockIdx.y * FC_PASS + rank * FC_COLS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Rows<true, true> rw{ofs, ofs, R, R};
  const int count = rw.count(gs, g, C);
  if (m0 >= count) return;   // the whole cluster: one group, one tile
  const int nkd = (D + FC_BK - 1) / FC_BK, nb = (F + FC_BF - 1) / FC_BF;

  const uint32_t ring = (smem_addr(fc_smem_raw) + 1023) & ~1023u;
  const uint32_t staging = ring + FC_STAGING, chunks = ring + FC_CHUNKS;
  const uint32_t full = ring + FC_BARS, empty = full + 8 * FC_STAGES;
  if (tid == 0) {
    for (int i = 0; i < FC_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, FC_CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (warp >= FC_CONSUMERS * 4) {
    regs_shrink<FC_PRODUCER_REGS>();
    if (warp == FC_CONSUMERS * 4) {
      const int gw = g / gpw, row0 = rw.xofs[g] + m0;
      int t = 0;
      for (int i = 0; i < nb; ++i) {
        const int fb = i * FC_BF;
        for (int kt = 0; kt < nkd + FC_RANKS; ++kt, ++t) {
          if (kt == nkd) {   // block i's front is issued: its barrier may complete
            if (i > 0) cluster_wait();
            cluster_arrive_relaxed();
          }
          const int s = t % FC_STAGES;
          if (t >= FC_STAGES) mbar_wait(empty + 8 * s, (t / FC_STAGES - 1) & 1);
          if (lane == 0) {
            const uint32_t slot = ring + s * FC_SLOT, bar = full + 8 * s;
            mbar_expect_tx(bar, FC_SLOT);
            if (kt < nkd) {   // front: x, wg, wu
              tma_load_2d(slot, &xmap, bar, kt * FC_BK, row0);
              tma_load_3d(slot + FC_CHUNK, &gmap, bar, fb + rank * FC_SLICE, kt * FC_BK, gw);
              tma_load_3d(slot + FC_CHUNK + FC_BOX, &umap, bar, fb + rank * FC_SLICE,
                          kt * FC_BK, gw);
            } else {          // down: 64 rows of wd x this rank's 256 columns
#pragma unroll
              for (int b = 0; b < 4; ++b)
                tma_load_3d(slot + b * FC_BOX, &dmap, bar, n0 + 64 * b,
                            fb + ((rank + kt - nkd) % FC_RANKS) * FC_SLICE, gw);
            }
          }
          __syncwarp();
        }
      }
      cluster_wait();   // the last block's barrier
    } else {
      for (int i = 0; i < nb; ++i) {   // the other producer warps: one barrier a block
        cluster_arrive_relaxed();
        cluster_wait();
      }
    }
    cluster_sync();
    return;
  }

  regs_grow<FC_CONSUMER_REGS>();
  const int wg = warp / 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // this thread's rows of the tile: r, r + 8 of its warp's 16
  const int ar = wg * 64 + (warp % 4) * 16 + lane / 4;
  // a warpgroup moves its own rows of a slice (the slice's 8 KB half w),
  // thread c of the 128 the 16-byte pieces c, c + 128, c + 256, c + 384:
  // from rank q's staging buffer into registers, from registers into chunk
  // buffer b; only the warpgroup's own products read them
  const int wt = tid % 128;
  const uint32_t half = wg * (FC_CHUNK / 2);
  auto fetch = [&](uint4 (&v)[4], uint32_t stg, int q) {
    const uint32_t src = map_rank(stg + half, q);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = ld_cluster16(src + (wt + 128 * u) * 16);
  };
  auto put = [&](const uint4 (&v)[4], int b) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      st_shared16(chunks + b * FC_CHUNK + half + (wt + 128 * u) * 16, v[u]);
  };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(empty + 8 * (t % FC_STAGES));
  };
  // down step j of a block: chunk buffer j % 2 @ the stage's 64 rows of wd,
  // the products of step j - 1 done behind them; then chunk j + 1 goes from
  // `in` into the other buffer (step j - 1's, now read) and chunk j + 2's
  // loads from rank (r + j + 2) % 16 into `out` run beside the products
  auto down_step = [&](int j, int t, uint32_t stg, const uint4 (&in)[4], uint4 (&out)[4]) {
    const int s = t % FC_STAGES;
    mbar_wait(full + 8 * s, (t / FC_STAGES) & 1);
    const uint32_t slot = ring + s * FC_SLOT;
    const uint32_t a = chunks + (j & 1) * FC_CHUNK + half;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FC_BK / 16; ++kk)
      wgmma_ss<1>(acc, gmma_desc(a + kk * 32, 16, 1024, SWIZZLE_128B),
                  gmma_desc(slot + kk * 2048, FC_BOX, 1024, SWIZZLE_128B), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (j > 0) release(t - 1);
    if (j + 1 < FC_RANKS) put(in, (j + 1) & 1);
    if (j + 2 < FC_RANKS) fetch(out, stg, (rank + j + 2) % FC_RANKS);
    fence_proxy_async();   // the chunk is a wgmma operand
    named_sync(2 + wg, 128);
  };
  int t = 0;
  for (int i = 0; i < nb; ++i) {
    // 1. front: gate and up of this warpgroup's 64 rows x this rank's 64
    // columns, one m64n128k16 over the stage's adjacent wg and wu boxes
    // (f[0..31] gate, f[32..63] up)
    float f[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) f[j] = 0.f;
    for (int kt = 0; kt < nkd; ++kt, ++t) {
      const int s = t % FC_STAGES;
      mbar_wait(full + 8 * s, (t / FC_STAGES) & 1);
      const uint32_t slot = ring + s * FC_SLOT, xa = slot + wg * (FC_CHUNK / 2);
      fence_regs(f);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FC_BK / 16; ++kk)
        wgmma_ss<1>(f, gmma_desc(xa + kk * 32, 16, 1024, SWIZZLE_128B),
                    gmma_desc(slot + FC_CHUNK + kk * 2048, FC_BOX, 1024, SWIZZLE_128B), 1);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done: hand it back
      fence_regs(f);
      if (kt > 0) release(t - 1);
    }
    wgmma_wait<0>();
    fence_regs(f);
    release(t - 1);

    // 2. this rank's slice: silu(gate) * up, one rounding, swizzled rows
    const uint32_t stg = staging + (i & 1) * FC_CHUNK;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ar + 8 * half, e = 4 * j + 2 * half;
        st_shared4(stg + r * 128 + ((j ^ (r & 7)) << 4) + (lane % 4) * 4,
                   pack_bf16x2(f[e] / (1.f + expf(-f[e])) * f[32 + e],
                               f[e + 1] / (1.f + expf(-f[e + 1])) * f[33 + e]));
      }

    // 3. every rank's slice of block i is written
    cluster_arrive();
    cluster_wait();

    // 4. down: step j takes chunk q = (rank + j) % 16, rank q's slice, two
    // steps a loop so that the in-flight pieces stay in named registers
    uint4 va[4], vb[4];
    fetch(va, stg, rank);
    put(va, 0);
    fence_proxy_async();
    named_sync(2 + wg, 128);
    fetch(vb, stg, (rank + 1) % FC_RANKS);
    for (int j = 0; j < FC_RANKS; j += 2, t += 2) {
      down_step(j, t, stg, vb, va);
      down_step(j + 1, t + 1, stg, va, vb);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(t - 1);
  }

  // epilogue: live rows only, bf16 pairs straight from the fragments
  bf16* const og = rw.out(out, g, C, DO);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + ar + 8 * half;
    if (m >= count) continue;
    bf16* const orow = og + (size_t)m * DO;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n < DO)   // DO is even: n + 1 < DO too
        *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16x2(acc[4 * j + 2 * half],
                                                             acc[4 * j + 2 * half + 1]);
    }
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr CUtensorMapDataType BF16_MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A 3-D map over (G / gpw, rows, cols) bf16 weights, 128-byte swizzled boxes
// of 64 columns x `box_rows` rows.
cudaError_t weight_map(CUtensorMap* map, const void* w, int n, int rows, int cols,
                       int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_map(map, BF16_MAP, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The decode body: S = ceil(F / FS) slices of FS (128, 256 or 512) hidden
// columns; with S > 1 `part` holds S * G * C * DO floats and `arrived`
// G * ceil(DO / 256) zeroed counters, left zeroed.
cudaError_t launch_decode(const void* x, const void* wg, const void* wu, const void* wd,
                          const int* ofs, const int* gs, void* out, float* part, int* arrived,
                          int G, int C, int D, int F, int DO, int gpw, int R, int FS,
                          cudaStream_t st) {
  if (FS != 128 && FS != 256 && FS != 512) return cudaErrorInvalidValue;
  const int S = (F + FS - 1) / FS;
  if (S > 1 && (!part || !arrived)) return cudaErrorInvalidValue;
  CUtensorMap gmap{}, umap{}, dmap{};
  cudaError_t err = weight_map(&gmap, wg, G / gpw, D, F, FD_BK);
  if (err == cudaSuccess) err = weight_map(&umap, wu, G / gpw, D, F, FD_BK);
  if (err == cudaSuccess) err = weight_map(&dmap, wd, G / gpw, F, DO, FD_BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FD_SMEM);
  if (err != cudaSuccess) return err;
  fused_decode_kernel<<<dim3(S, G), FD_THREADS, FD_SMEM, st>>>(
      gmap, umap, dmap, static_cast<const bf16*>(x), ofs, gs, static_cast<bf16*>(out), part,
      arrived, C, D, F, DO, gpw, R, FS);
  return cudaSuccess;
}

// The prefill body's launch attributes: its dynamic shared memory, and
// clusters of 16 (past the portable 8).
cudaError_t cluster_attributes() {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FC_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The prefill body: clusters of 16 along x, launched with cudaLaunchKernelEx.
cudaError_t launch_cluster(const void* x, const void* wg, const void* wu, const void* wd,
                           const int* ofs, const int* gs, void* out, int G, int C, int D,
                           int F, int DO, int gpw, int R, cudaStream_t st) {
  CUtensorMap xmap{}, gmap{}, umap{}, dmap{};
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)R};
  const cuuint64_t xstrides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {FC_BK, FC_BM};
  cudaError_t err =
      encode_map(&xmap, BF16_MAP, x, 2, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) err = weight_map(&gmap, wg, G / gpw, D, F, FC_BK);
  if (err == cudaSuccess) err = weight_map(&umap, wu, G / gpw, D, F, FC_BK);
  if (err == cudaSuccess) err = weight_map(&dmap, wd, G / gpw, F, DO, FC_SLICE);
  if (err != cudaSuccess) return err;
  err = cluster_attributes();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FC_RANKS * ((C + FC_BM - 1) / FC_BM), (DO + FC_PASS - 1) / FC_PASS, G);
  cfg.blockDim = dim3(FC_THREADS);
  cfg.dynamicSmemBytes = FC_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FC_RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_cluster_kernel, xmap, gmap, umap, dmap, ofs, gs,
                            static_cast<bf16*>(out), C, D, F, DO, gpw, R);
}

}  // namespace

// x (R, D) flat rows; wg/wu (G/gpw, D, F); wd (G/gpw, F, DO); ofs/gs (G,)
// int32; out (R, DO), written only at live rows. All contiguous, 16-byte
// aligned, D, F and DO positive multiples of 16 / sizeof(T). bf16 at
// C <= 8 takes the decode body with hidden slices of `slice` columns
// (kernels/gmm/ragged.py::fused_decode_slice) and, with more than one
// slice, part (S * G * C * DO floats) and arrived (G * ceil(DO / 256)
// zeroed int32 counters, left zeroed); both may be null with one slice and
// are ignored otherwise. Returns cudaGetLastError() after launch.
extern "C" int gmm_fused_ffn_launch(const void* x, const void* wg, const void* wu,
                                    const void* wd, const void* ofs, const void* gs, void* out,
                                    void* part, void* arrived, int G, int C, int D, int F,
                                    int DO, int gpw, int R, int dtype, int slice,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(ofs);
  const int* g = static_cast<const int*>(gs);
  if (D <= 0 || F <= 0 || DO <= 0 || gpw <= 0 || G % gpw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || R == 0) return static_cast<int>(cudaSuccess);   // no row is live
  cudaError_t err;
  if (dtype == DT_F32) {
    err = C <= 16 ? launch_fma<16, 1>(x, wg, wu, wd, o, g, out, G, C, D, F, DO, gpw, R, st)
                  : launch_fma<64, 4>(x, wg, wu, wd, o, g, out, G, C, D, F, DO, gpw, R, st);
  } else if (dtype == DT_BF16) {
    err = C <= FD_ROWS
              ? launch_decode(x, wg, wu, wd, o, g, out, static_cast<float*>(part),
                              static_cast<int*>(arrived), G, C, D, F, DO, gpw, R, slice, st)
              : launch_cluster(x, wg, wu, wd, o, g, out, G, C, D, F, DO, gpw, R, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a block of a bf16 body asks for at launch, in
// bytes: body 0 the decode body, 1 the prefill (cluster) body.
extern "C" long long gmm_fused_ffn_smem_bytes(int body) {
  return static_cast<long long>(body == 0 ? FD_SMEM : FC_SMEM);
}

// How many 16-CTA clusters of the prefill body the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int gmm_fused_ffn_max_clusters() {
  if (cluster_attributes() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FC_RANKS, 1, 1);
  cfg.blockDim = dim3(FC_THREADS);
  cfg.dynamicSmemBytes = FC_SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FC_RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fused_cluster_kernel, &cfg) != cudaSuccess) return -1;
  return n;
}
