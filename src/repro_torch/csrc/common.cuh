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
