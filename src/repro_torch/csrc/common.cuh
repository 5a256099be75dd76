// Shared helpers for the port's CUDA kernels: dtype codes and the
// fp32 <-> storage-type conversions (fp32 and bf16 are the types the
// wrappers accept).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value through the storage type (the "p.astype(v.dtype)"
// cast the reference kernels apply before the PV product).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16-byte vector load of VEC = 16 / sizeof(T) consecutive elements,
// widened to fp32. The caller guarantees 16-byte alignment.
template <typename T>
__device__ __forceinline__ void load_vec16(const T* __restrict__ src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int v = 0; v < VEC; ++v) dst[v] = to_f(e[v]);
}

// Where group g's rows of a grouped matmul live (gmm_ragged.cu,
// gmm_fused_ffn.cu), fixed at compile time so that the padded layout
// compiles to exactly the code it had before the flat layouts existed.
// Padded: row m of group g at g * C + m, and (for the output) rows m in
// [count, C) stored as zeros. GATHER: input row m at xofs[g] + m of a flat
// array; SCATTER: output row m at oofs[g] + m, only rows m < count stored.
// A flat layout is bounds-checked against its row count, so a malformed
// offset can shorten a group but never reach outside the array. ALL: the
// padded layout with every one of the C rows live (the dense grouped
// matmul); gs is never read and may be null.
template <bool GATHER, bool SCATTER, bool ALL = false>
struct Rows {
  static_assert(!ALL || (!GATHER && !SCATTER), "ALL is a padded layout");
  static constexpr bool gather = GATHER;
  const int* xofs;   // gather input offsets (GATHER)
  const int* oofs;   // scatter output offsets (SCATTER)
  int in_rows, out_rows;

  __device__ int count(const int* gs, int g, int C) const {
    if constexpr (ALL) {
      return C;
    } else {
      int n = min(gs[g], C);
      if constexpr (GATHER) n = min(n, in_rows - xofs[g]);
      if constexpr (SCATTER) n = min(n, out_rows - oofs[g]);
      return max(n, 0);
    }
  }
  template <typename T>
  __device__ const T* in(const T* x, int g, int C, int D) const {
    if constexpr (GATHER) return x + (size_t)xofs[g] * D;
    else return x + (size_t)g * C * D;
  }
  template <typename T>
  __device__ T* out(T* o, int g, int C, int F) const {
    if constexpr (SCATTER) return o + (size_t)oofs[g] * F;
    else return o + (size_t)g * C * F;
  }
  // output rows a group stores: all C (zero tails) or only its live rows
  __device__ int stored(int C, int live) const { return SCATTER ? live : C; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
