// Single-token GQA decode attention over a dense KV cache with a per-key
// validity mask, split over the keys (flash-decoding).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_decode/flash_decode.py::flash_decode
// (_decode_kernel, its pallas_call at flash_decode.py:151), in both of its
// modes: the normalised output and, with return_partials, the fp32
// (acc, m, l) state of write_outputs (flash_decode.py:36-50):
//
//   out[b, h] = softmax_{t : valid[b, t]}(q[b, h] . k[b, t, h / G] / sqrt(hd))
//               @ v[b, t, h / G]
//
// with k, v (B, T, K, hd) and G = H / K. An invalid key gets p = 0 and its
// K and V rows are never read, so garbage in them (NaN included) never
// reaches the output. The TPU kernel scores masked keys NEG_INF = -1e30
// and lets a later rescale wipe them out, which gives p = 1 to every key
// of a fully masked prefix; here a row with no valid key returns zeros
// (the plain version gives the same), and in partials mode
// m = -1e30, l = 0, acc = 0. The mask is arbitrary, not a prefix: the
// windowed ring cache wraps.
//
// What bounds it on an H100: the valid K/V bytes over HBM bandwidth
// (3.35 TB/s), plus launch latency. At the serving shapes (8 requests,
// 257-288 valid keys of a 1024-slot cache, 8 KV heads of 128, bf16) that
// is about 8.9 MB, 2.7 us. The body it replaced ran one block per
// (KV head, request), 64 blocks on 132 SMs, each walking its ~270 keys in
// series with a few KB in flight: 1.5% of the HBM rate.
//
// What the design does about it (decode_split.cuh): the keys are cut into
// chunks of 64 and the grid is (K, B, S) with S = ceil(T / 64) (at most
// 32; beyond that a split takes several chunks), from the static shape T
// alone. At the serving shapes that is 1024 blocks; the ~320 with a valid
// key each stage a 16 KB K tile and a 16 KB V tile with cp.async, so the
// live bytes are in flight at once, and run their scores and PV product
// on the tensor cores (bf16; fp32 on the CUDA cores). A chunk with no
// valid key costs one read of its 64 flags and writes nothing. The last
// live block of each (request, KV head) merges the splits in the same
// launch (LSE, split-index order, deterministic).
#include "decode_split.cuh"

namespace {

template <typename T>
struct DenseRows {
  const T* k;
  const T* v;
  const int* valid;
  int T_len, K, hd;

  __device__ int keys(int) const { return T_len; }
  __device__ bool live(int b, int t) const { return valid[(size_t)b * T_len + t] != 0; }
  __device__ size_t row(int b, int kh, int t) const {
    return ((size_t)b * T_len + t) * K * hd + (size_t)kh * hd;
  }
  // this thread's share of the splits (of `span` keys, a multiple of 64)
  // with a valid key: four flags a load where the row allows it
  __device__ unsigned live_splits(int b, int span) const {
    const int* row = valid + (size_t)b * T_len;
    unsigned bits = 0u;
    if (T_len % 4 == 0 && reinterpret_cast<size_t>(row) % 16 == 0) {
#pragma unroll 2
      for (int t = 4 * threadIdx.x; t < T_len; t += 4 * blockDim.x) {
        const int4 f = __ldg(reinterpret_cast<const int4*>(row + t));
        if (f.x | f.y | f.z | f.w) bits |= 1u << (t / span);
      }
    } else {
      for (int t = threadIdx.x; t < T_len; t += blockDim.x)
        if (row[t]) bits |= 1u << (t / span);
    }
    return bits;
  }
};

template <bool PARTIALS>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           float* m_out, float* l_out, void* scratch, void* arrived, int B, int H, int K,
           int hd, int T_len, int S, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid);
  float* scr = static_cast<float*>(scratch);
  int* arr = static_cast<int*>(arrived);
  if (dtype == DT_F32) {
    using T = float;
    const DenseRows<T> src{static_cast<const T*>(k), static_cast<const T*>(v), vl, T_len, K, hd};
    return split_decode::launch<T, PARTIALS>(static_cast<const T*>(q), src, out, m_out,
                                             l_out, scr, arr, B, H, K, hd, T_len, S, st);
  }
  if (dtype == DT_BF16) {
    using T = __nv_bfloat16;
    const DenseRows<T> src{static_cast<const T*>(k), static_cast<const T*>(v), vl, T_len, K, hd};
    return split_decode::launch<T, PARTIALS>(static_cast<const T*>(q), src, out, m_out,
                                             l_out, scr, arr, B, H, K, hd, T_len, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, hd), k/v (B, T, K, hd) 16-byte aligned, valid (B, T) int32 ->
// out (B, H, hd); scratch S * B * H * (hd + 2) floats, arrived B * K
// zeroed int32 counters (left zeroed). H % K == 0, H / K <= 16,
// hd % 32 == 0, hd <= 256, 1 <= S <= 32. Returns cudaGetLastError() after
// the launch.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* valid, void* out, void* scratch,
                                   void* arrived, int B, int H, int K, int hd, int T_len,
                                   int S, int dtype, void* stream) {
  return launch<false>(q, k, v, valid, out, nullptr, nullptr, scratch, arrived, B, H, K,
                       hd, T_len, S, dtype, stream);
}

// The same inputs -> fp32 partials acc (B, H, hd), m (B, H), l (B, H), not
// normalised. Same gates.
extern "C" int flash_decode_partials_launch(const void* q, const void* k, const void* v,
                                            const void* valid, void* acc, void* m, void* l,
                                            void* scratch, void* arrived, int B, int H,
                                            int K, int hd, int T_len, int S, int dtype,
                                            void* stream) {
  return launch<true>(q, k, v, valid, acc, static_cast<float*>(m), static_cast<float*>(l),
                      scratch, arrived, B, H, K, hd, T_len, S, dtype, stream);
}

// Dynamic shared memory the split kernel takes per block (the gate's
// footprint): G query heads per KV head, head dim hd, dtype code.
extern "C" long long flash_decode_smem_bytes(int G, int hd, int dtype) {
  return (long long)split_decode::smem_bytes(G, hd, dtype == DT_F32 ? 4 : 2);
}
