// Paged single-token GQA decode attention over a shared KV page pool,
// split over the keys (flash-decoding).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode/paged.py::flash_decode_paged
// (_paged_kernel, its pallas_call at paged.py:140), in both of its modes:
// the normalised output and, with return_partials, the fp32 (acc, m, l)
// state of write_outputs (flash_decode.py:36-50):
//
//   out[b, h] = softmax(q[b, h] . K_b^T / sqrt(hd)) V_b
//
// where request b's keys/values are rows [0, lengths[b]) of its logical
// view: logical row t lives in pool page tables[b, t / bs], row t % bs
// (pool layout (P, bs, K, hd)). Query head h reads KV head h / (H / K).
// Rows past lengths[b] and the table entries past ceil(len / bs) are never
// read (they may hold garbage or name any page; the tests poison them
// with NaN). A request of length 0 gives zeros, or in partials mode
// m = -1e30, l = 0, acc = 0; partials over disjoint page ranges merge
// exactly (the LSE merge).
//
// What bounds it on an H100: every live K/V byte is read once, so the
// bound is live KV bytes over HBM bandwidth (3.35 TB/s), plus launch
// latency. At the serving shapes (8 requests of 257-288 tokens, 8 KV heads
// of 128, pages of 128, bf16) that is about 8.9 MB, 2.7 us. The body it
// replaced ran one block per (KV head, request), 64 blocks on 132 SMs,
// each walking its pages in series with a few KB in flight.
//
// What the design does about it (decode_split.cuh): the logical view is
// cut into chunks of 64 keys (half a page of 128) and the grid is
// (K, B, S) with S = ceil(NB * bs / 64) (at most 32; beyond that a split
// takes several chunks), from the static shapes alone. A block whose
// chunk starts at or past lengths[b] reads that length and returns
// without a write; the ~320 live blocks at the serving shapes look up
// their rows' pages, stage 16 KB of K and 16 KB of V with cp.async, so the
// live bytes are in flight at once, and run their scores and PV product on
// the tensor cores (bf16; fp32 on the CUDA cores). The last live block of
// each (request, KV head) merges the splits in the same launch (LSE,
// split-index order, deterministic).
#include "decode_split.cuh"

namespace {

template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  const int* tables;
  const int* lengths;
  int bs, NB, K, hd;

  __device__ int keys(int b) const { return max(0, min(lengths[b], NB * bs)); }
  __device__ bool live(int, int) const { return true; }   // every row below the length
  __device__ size_t row(int b, int kh, int t) const {
    const size_t page = (size_t)tables[(size_t)b * NB + t / bs];
    return (page * bs + t % bs) * K * hd + (size_t)kh * hd;
  }
  // the splits (of `span` keys) below the length: the first ceil(len / span)
  __device__ unsigned live_splits(int b, int span) const {
    const int n = (keys(b) + span - 1) / span;   // at most 32 (S * span >= NB * bs)
    return n >= 32 ? ~0u : (1u << n) - 1u;
  }
};

template <bool PARTIALS>
int launch(const void* q, const void* pk, const void* pv, const void* tables,
           const void* lengths, void* out, float* m_out, float* l_out, void* scratch,
           void* arrived, int B, int H, int K, int hd, int bs, int NB, int S, int dtype,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* scr = static_cast<float*>(scratch);
  int* arr = static_cast<int*>(arrived);
  if (dtype == DT_F32) {
    using T = float;
    const PagedRows<T> src{static_cast<const T*>(pk), static_cast<const T*>(pv), tb, ln, bs,
                           NB, K, hd};
    return split_decode::launch<T, PARTIALS>(static_cast<const T*>(q), src, out, m_out,
                                             l_out, scr, arr, B, H, K, hd, NB * bs, S, st);
  }
  if (dtype == DT_BF16) {
    using T = __nv_bfloat16;
    const PagedRows<T> src{static_cast<const T*>(pk), static_cast<const T*>(pv), tb, ln, bs,
                           NB, K, hd};
    return split_decode::launch<T, PARTIALS>(static_cast<const T*>(q), src, out, m_out,
                                             l_out, scr, arr, B, H, K, hd, NB * bs, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, hd), pool_k/pool_v (P, bs, K, hd) 16-byte aligned, tables
// (B, NB) int32, lengths (B,) int32 -> out (B, H, hd); scratch
// S * B * H * (hd + 2) floats, arrived B * K zeroed int32 counters (left
// zeroed). H % K == 0, H / K <= 16, hd % 32 == 0, hd <= 256,
// 1 <= S <= 32. Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_paged_launch(const void* q, const void* pk, const void* pv,
                                         const void* tables, const void* lengths, void* out,
                                         void* scratch, void* arrived, int B, int H, int K,
                                         int hd, int bs, int NB, int S, int dtype,
                                         void* stream) {
  return launch<false>(q, pk, pv, tables, lengths, out, nullptr, nullptr, scratch, arrived,
                       B, H, K, hd, bs, NB, S, dtype, stream);
}

// The same inputs -> fp32 partials acc (B, H, hd), m (B, H), l (B, H), not
// normalised. Same gates.
extern "C" int flash_decode_paged_partials_launch(
    const void* q, const void* pk, const void* pv, const void* tables, const void* lengths,
    void* acc, void* m, void* l, void* scratch, void* arrived, int B, int H, int K, int hd,
    int bs, int NB, int S, int dtype, void* stream) {
  return launch<true>(q, pk, pv, tables, lengths, acc, static_cast<float*>(m),
                      static_cast<float*>(l), scratch, arrived, B, H, K, hd, bs, NB, S, dtype,
                      stream);
}

// Dynamic shared memory the split kernel takes per block (the gate's
// footprint): G query heads per KV head, head dim hd, dtype code.
extern "C" long long flash_decode_paged_smem_bytes(int G, int hd, int dtype) {
  return (long long)split_decode::smem_bytes(G, hd, dtype == DT_F32 ? 4 : 2);
}
