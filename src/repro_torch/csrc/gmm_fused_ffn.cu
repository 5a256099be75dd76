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
// count_g = min(gs[g], C). Rows outside every live segment are neither read
// (they may hold NaN) nor written: the TPU kernel stores whole row tiles in
// grid order and relies on a later bucket overwriting a partial tile's
// spill; CUDA blocks have no store order, so only rows < count_g are
// stored. The hidden block is cast to the I/O type before the down
// projection, as the two-kernel pair stores it, so fused and pair differ
// only in summation order.
//
// What bounds it on an H100: operations (2 * 3 * sum(count) * D * F at
// prefill) or, at decode, the three weight panels of every live group.
//
// Design (a first version: right, not fast). The TPU kernel keeps a
// (bm, D_out) fp32 output accumulator in VMEM for the whole hidden loop; at
// D_out = 4096 and a usable row tile that is more shared memory than an SM
// has. Here each block owns a (BM rows) x (BN = 128 output columns) tile of
// one group, walks the hidden dimension in blocks of BF = 128, and
// recomputes each hidden block from x, wg and wu: the front half is
// recomputed once per output column block (D_out / 128 times). Both halves
// run as fp32 FMA tiles on the CUDA cores (fp32 accumulate, shared-memory
// tiles), BM = 16 rows when the capacity is at most 16 (decode) and 64
// otherwise. Tensor cores, and a split that does not recompute the front
// half, are later work.
#include "common.cuh"

namespace {

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

template <typename T, int BM, int TM>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const int* ofs, const int* gs, void* out, int G, int C, int D,
           int F, int DO, int gpw, int R, cudaStream_t st) {
  auto kern = gmm_fused_ffn_kernel<T, BM, TM>;
  const size_t smem = smem_floats<BM>() * sizeof(float);
  // > 48 KB of dynamic shared memory needs the opt-in
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((DO + BN - 1) / BN, (C + BM - 1) / BM, G);
  kern<<<grid, (BM / TM) * NX, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), ofs, gs,
      static_cast<T*>(out), C, D, F, DO, gpw, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* wg, const void* wu, const void* wd,
             const int* ofs, const int* gs, void* out, int G, int C, int D,
             int F, int DO, int gpw, int R, cudaStream_t st) {
  if (C <= 16)
    return launch<T, 16, 1>(x, wg, wu, wd, ofs, gs, out, G, C, D, F, DO, gpw, R, st);
  return launch<T, 64, 4>(x, wg, wu, wd, ofs, gs, out, G, C, D, F, DO, gpw, R, st);
}

}  // namespace

// x (R, D) flat rows; wg/wu (G/gpw, D, F); wd (G/gpw, F, DO); ofs/gs (G,)
// int32; out (R, DO), written only at live rows. All contiguous, 16-byte
// aligned, D, F and DO multiples of 16 / sizeof(T). Returns
// cudaGetLastError() after launch.
extern "C" int gmm_fused_ffn_launch(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    const void* ofs, const void* gs, void* out,
                                    int G, int C, int D, int F, int DO,
                                    int gpw, int R, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(ofs);
  const int* g = static_cast<const int*>(gs);
  if (dtype == DT_F32)
    return dispatch<float>(x, wg, wu, wd, o, g, out, G, C, D, F, DO, gpw, R, st);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(x, wg, wu, wd, o, g, out, G, C, D, F, DO, gpw, R, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
