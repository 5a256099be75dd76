// Single-token GQA decode attention over a dense KV cache with a per-key
// validity mask.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode/flash_decode.py::flash_decode
// (_decode_kernel, normalised output):
//
//   out[b, h] = softmax_{t : valid[b, t]}(q[b, h] . k[b, t, h / G] / sqrt(hd))
//               @ v[b, t, h / G]
//
// with k, v (B, T, K, hd) and G = H / K. Online softmax in fp32; p is
// rounded to the value type before the PV product, as the reference does.
// An invalid key gets p = 0 (score -inf): its K and V rows are never read,
// so garbage in them (NaN included) never reaches the output. The TPU
// kernel scores masked keys NEG_INF = -1e30 and lets a later rescale wipe
// them out, which gives p = 1 to every key of a fully masked prefix; here
// a row with no valid key at all returns zeros (the plain version gives
// the same: its uniform p meets value rows selected to zero). Any T works:
// the key loop is bounds-checked, so there is no T % 128 gate.
//
// What bounds it on an H100: the valid K/V bytes over HBM bandwidth
// (3.35 TB/s); at the serving shapes (8 requests, <= 288 valid keys of a
// 1024-slot cache, 8 KV heads of 128) a few microseconds, so launch
// latency and the per-block dependency chain dominate.
//
// Design: one block per (KV head, request) holds the G query heads of the
// group as one panel, so each K/V row is read once for the whole group.
// The block walks the cache in tiles of 128 keys; a tile with no valid key
// is skipped with one block-wide vote, and inside a tile only valid keys
// are loaded. Scores: each warp takes key rows, lanes split the head dim.
// Softmax: one warp per query head. PV: threads own head-dim columns.
//
// Partials mode (PARTIALS = true), replacing the same TPU kernel's
// return_partials epilogue (write_outputs): the walk is the same, and the
// epilogue writes the block's fp32 shared-memory state as it stands, not
// normalised: acc (B, H, hd), the running max m (B, H) and the running
// sum l (B, H). A slice with no valid key gives m = -1e30, l = 0, acc = 0
// (the TPU kernel's l and acc are non-zero there; both merge to the same
// output whenever some slice has a live key). The sequence-parallel decode
// merges the partials of every slice with an all-reduce (LSE merge). The
// normalised instantiation is the code above, unchanged.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 16;       // query heads per KV head
constexpr int MAX_HD_LANE = 8;  // head dim <= 32 * 8
constexpr int TB = 128;         // keys per tile

template <typename T, bool PARTIALS>
__global__ void __launch_bounds__(128)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ valid,
                    void* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int H, int K, int hd, int T_len) {
  extern __shared__ float sm[];
  const int G = H / K;
  float* qs = sm;                  // (G, hd)
  float* ss = qs + G * hd;         // (G, TB) scores, then p
  float* accs = ss + G * TB;       // (G, hd)
  float* ms = accs + G * hd;       // (G,) running max
  float* ls = ms + G;              // (G,) running denominator
  float* als = ls + G;             // (G,) this tile's rescale factor
  int* ok = reinterpret_cast<int*>(als + G);   // (TB,) key validity

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  const size_t row_stride = (size_t)K * hd;   // between keys
  const T* kb = kc + (size_t)b * T_len * row_stride + (size_t)kh * hd;
  const T* vb = vc + (size_t)b * T_len * row_stride + (size_t)kh * hd;
  const int* vrow = valid + (size_t)b * T_len;

  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f(q[((size_t)b * H + kh * G + g) * hd + d]);
    accs[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  const int per_lane = hd / 32;
  for (int t0 = 0; t0 < T_len; t0 += TB) {
    const int rows = min(TB, T_len - t0);
    int mine = 0;
    for (int r = tid; r < TB; r += blockDim.x) {
      const int v = r < rows && vrow[t0 + r] != 0;
      ok[r] = v;
      mine |= v;
    }
    // block-wide vote (also the barrier after the flags are written)
    if (!__syncthreads_or(mine)) continue;

    // scores s[g, r] = q_g . k_r / sqrt(hd) for valid keys; -inf otherwise
    for (int r = warp; r < rows; r += nwarps) {
      if (!ok[r]) {
        for (int g = lane; g < G; g += 32) ss[g * TB + r] = __uint_as_float(0xff800000u);   // -inf
        continue;
      }
      float kv[MAX_HD_LANE];
#pragma unroll
      for (int i = 0; i < MAX_HD_LANE; ++i)
        kv[i] = i < per_lane ? to_f(kb[(t0 + r) * row_stride + lane + 32 * i]) : 0.f;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_HD_LANE; ++i)
          if (i < per_lane) part = fmaf(qs[g * hd + lane + 32 * i], kv[i], part);
        part = warp_sum(part);
        if (lane == 0) ss[g * TB + r] = part / sqrt_hd;
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head; m stays finite
    // (it starts at NEG_INF), so an invalid key's exp(-inf - m) is 0
    for (int g = warp; g < G; g += nwarps) {
      float mx = NEG_INF;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, ss[g * TB + r]);
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(ss[g * TB + r] - m_new);
        sum += p;
        ss[g * TB + r] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        als[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + sum over valid keys of p[g, r] * v[r, d]
    for (int d = tid; d < hd; d += blockDim.x) {
      float a[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) a[g] = accs[g * hd + d] * als[g];
      for (int r = 0; r < rows; ++r) {
        if (!ok[r]) continue;   // never read an invalid value row
        const float v = to_f(vb[(t0 + r) * row_stride + d]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) a[g] = fmaf(ss[g * TB + r], v, a[g]);
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) accs[g * hd + d] = a[g];
    }
    __syncthreads();
  }

  __syncthreads();   // the last tile may have been skipped
  if constexpr (PARTIALS) {
    float* acc_out = static_cast<float*>(out);
    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i % hd;
      acc_out[((size_t)b * H + kh * G + g) * hd + d] = accs[i];
    }
    for (int g = tid; g < G; g += blockDim.x) {
      m_out[(size_t)b * H + kh * G + g] = ms[g];
      l_out[(size_t)b * H + kh * G + g] = ls[g];
    }
  } else {
    T* o = static_cast<T*>(out);
    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i % hd;
      const float l = fmaxf(ls[g], 1e-30f);
      o[((size_t)b * H + kh * G + g) * hd + d] = from_f<T>(accs[i] / l);
    }
  }
}

template <bool PARTIALS>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, float* m_out, float* l_out, int B, int H, int K, int hd,
           int T_len, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const size_t smem =
      sizeof(float) * (size_t)(2 * G * hd + G * TB + 3 * G) + sizeof(int) * TB;
  dim3 grid(K, B);
  dim3 block(128);
  const int* vl = static_cast<const int*>(valid);
  if (dtype == DT_F32) {
    dense_decode_kernel<float, PARTIALS><<<grid, block, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), vl, out, m_out, l_out, H, K, hd, T_len);
  } else if (dtype == DT_BF16) {
    dense_decode_kernel<__nv_bfloat16, PARTIALS><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), vl, out, m_out, l_out, H, K, hd,
        T_len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, hd), k/v (B, T, K, hd), valid (B, T) int32 -> out (B, H, hd).
// H % K == 0, H / K <= 16, hd % 32 == 0, hd <= 256. Returns
// cudaGetLastError() after launch.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* valid, void* out, int B, int H,
                                   int K, int hd, int T_len, int dtype,
                                   void* stream) {
  return launch<false>(q, k, v, valid, out, nullptr, nullptr, B, H, K, hd,
                       T_len, dtype, stream);
}

// The same inputs -> fp32 partials acc (B, H, hd), m (B, H), l (B, H), not
// normalised. Same gates; returns cudaGetLastError() after launch.
extern "C" int flash_decode_partials_launch(const void* q, const void* k,
                                            const void* v, const void* valid,
                                            void* acc, void* m, void* l, int B,
                                            int H, int K, int hd, int T_len,
                                            int dtype, void* stream) {
  return launch<true>(q, k, v, valid, acc, static_cast<float*>(m),
                      static_cast<float*>(l), B, H, K, hd, T_len, dtype,
                      stream);
}
