// Paged single-token GQA decode attention over a shared KV page pool.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode/paged.py::flash_decode_paged (_paged_kernel):
//
//   out[b, h] = softmax(q[b, h] . K_b^T / sqrt(hd)) V_b
//
// where request b's keys/values are rows [0, lengths[b]) of its logical
// view: logical block j lives in pool page tables[b, j] (pool layout
// (P, bs, K, hd)). Query head h reads KV head h / (H / K). Online softmax in
// fp32 with NEG_INF = -1e30 and the 1e-30 floor on the denominator; p is
// rounded to the value type before the PV product, as the reference does.
//
// What bounds it on an H100: every live K/V byte is read once, so the bound
// is live KV bytes over HBM bandwidth (3.35 TB/s); at the serving shapes
// (8 requests, <= 288 tokens, 8 KV heads of 128) that is a few
// microseconds, so in practice launch latency and the short per-block
// dependency chain dominate.
//
// What the design does about it: one block per (KV head, request), which
// holds the H/K query heads of the group as one panel, so each K/V row is
// read once for the whole group. The block walks only the ceil(len / bs)
// live pages of its request (the TPU version's clamp-to-last-page trick to
// skip copies is unnecessary here) and reads only rows < len of the last
// page, so dead pages and dead rows are never touched (they may hold
// garbage, and the tests poison them with NaN). Scores: each warp takes
// key rows, lanes split the head dim, one shuffle reduction per query
// head. Softmax: one warp per query head. PV: threads own head-dim columns.
//
// Partials mode (PARTIALS = true), replacing the same TPU kernel's
// return_partials epilogue (flash_decode.py::write_outputs): the walk is the
// same, and the epilogue writes the block's fp32 shared-memory state as it
// stands, not normalised: acc (B, H, hd), the running max m (B, H) and the
// running sum l (B, H). A request of length 0 walks no page and gives
// m = -1e30, l = 0, acc = 0, the dense partials' contract; partials over
// disjoint page ranges merge exactly (the LSE merge). The normalised
// instantiation is the code above, unchanged.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 16;       // query heads per KV head
constexpr int MAX_HD_LANE = 8;  // head dim <= 32 * 8

template <typename T, bool PARTIALS>
__global__ void __launch_bounds__(128)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                    const T* __restrict__ pv, const int* __restrict__ tables,
                    const int* __restrict__ lengths, void* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int H, int K, int hd, int bs, int NB) {
  extern __shared__ float sm[];
  const int G = H / K;
  float* qs = sm;                  // (G, hd)
  float* ss = qs + G * hd;         // (G, bs) scores, then p
  float* accs = ss + G * bs;       // (G, hd)
  float* ms = accs + G * hd;       // (G,) running max
  float* ls = ms + G;              // (G,) running denominator
  float* als = ls + G;             // (G,) this page's rescale factor

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = max(0, min(lengths[b], NB * bs));
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  const size_t row_stride = (size_t)K * hd;   // between rows of one page

  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f(q[((size_t)b * H + kh * G + g) * hd + d]);
    accs[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int n_pages = (len + bs - 1) / bs;
  const int per_lane = hd / 32;
  for (int j = 0; j < n_pages; ++j) {
    const int page = tables[(size_t)b * NB + j];
    const int rows = min(bs, len - j * bs);
    const T* kp = pk + (size_t)page * bs * row_stride + (size_t)kh * hd;
    const T* vp = pv + (size_t)page * bs * row_stride + (size_t)kh * hd;

    // scores s[g, r] = q_g . k_r / sqrt(hd) for the live rows only
    for (int r = warp; r < rows; r += nwarps) {
      float kv[MAX_HD_LANE];
#pragma unroll
      for (int i = 0; i < MAX_HD_LANE; ++i)
        kv[i] = i < per_lane ? to_f(kp[r * row_stride + lane + 32 * i]) : 0.f;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_HD_LANE; ++i)
          if (i < per_lane) part = fmaf(qs[g * hd + lane + 32 * i], kv[i], part);
        part = warp_sum(part);
        if (lane == 0) ss[g * bs + r] = part / sqrt_hd;
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += nwarps) {
      float mx = NEG_INF;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, ss[g * bs + r]);
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(ss[g * bs + r] - m_new);
        sum += p;
        ss[g * bs + r] = round_to<T>(p);
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

    // acc[g, d] = acc * alpha + sum_r p[g, r] * v[r, d]
    for (int d = tid; d < hd; d += blockDim.x) {
      float a[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) a[g] = accs[g * hd + d] * als[g];
      for (int r = 0; r < rows; ++r) {
        const float v = to_f(vp[r * row_stride + d]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) a[g] = fmaf(ss[g * bs + r], v, a[g]);
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) accs[g * hd + d] = a[g];
    }
    __syncthreads();
  }

  // (a request with no live page reaches here from the barrier after the
  // state's initialisation)
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
int launch(const void* q, const void* pk, const void* pv, const void* tables,
           const void* lengths, void* out, float* m_out, float* l_out, int B,
           int H, int K, int hd, int bs, int NB, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  const size_t smem = sizeof(float) * (size_t)(2 * G * hd + G * bs + 3 * G);
  dim3 grid(K, B);
  dim3 block(128);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == DT_F32) {
    paged_decode_kernel<float, PARTIALS><<<grid, block, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(pk),
        static_cast<const float*>(pv), tb, ln, out, m_out, l_out, H, K, hd, bs,
        NB);
  } else if (dtype == DT_BF16) {
    paged_decode_kernel<__nv_bfloat16, PARTIALS><<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(pk),
        static_cast<const __nv_bfloat16*>(pv), tb, ln, out, m_out, l_out, H, K,
        hd, bs, NB);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, hd), pool_k/pool_v (P, bs, K, hd), tables (B, NB) int32,
// lengths (B,) int32 -> out (B, H, hd). H % K == 0, H / K <= 16,
// hd % 32 == 0, hd <= 256. Returns cudaGetLastError() after launch.
extern "C" int flash_decode_paged_launch(const void* q, const void* pk,
                                         const void* pv, const void* tables,
                                         const void* lengths, void* out, int B,
                                         int H, int K, int hd, int bs, int NB,
                                         int dtype, void* stream) {
  return launch<false>(q, pk, pv, tables, lengths, out, nullptr, nullptr, B, H,
                       K, hd, bs, NB, dtype, stream);
}

// The same inputs -> fp32 partials acc (B, H, hd), m (B, H), l (B, H), not
// normalised. Same gates; returns cudaGetLastError() after launch.
extern "C" int flash_decode_paged_partials_launch(
    const void* q, const void* pk, const void* pv, const void* tables,
    const void* lengths, void* acc, void* m, void* l, int B, int H, int K,
    int hd, int bs, int NB, int dtype, void* stream) {
  return launch<true>(q, pk, pv, tables, lengths, acc, static_cast<float*>(m),
                      static_cast<float*>(l), B, H, K, hd, bs, NB, dtype,
                      stream);
}
