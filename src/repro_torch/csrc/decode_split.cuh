// Split-KV (flash-decoding) body shared by the two single-token decode
// attention kernels: the dense cache with a per-key validity mask
// (flash_decode.cu) and the paged pool walked through block tables
// (flash_decode_paged.cu). Each file supplies a row source (which keys of
// a request are live, and where a key's K/V row lies); the walk, the
// softmax state and the merge are the same.
//
// One launch on the caller's stream, split_kernel, grid (K, B, S), 128
// threads:
//
// 1. Block (kh, b, s) takes the G = H / K query heads of KV head kh of
//    request b against its split s of the keys, `cps` consecutive chunks of
//    CHUNK = 64 keys each. For a chunk it first reads which keys are live
//    (a chunk with no live key is skipped: a dead split costs one flag
//    read, or one length read when paged, and writes nothing), then stages
//    the live K rows and V rows in shared memory with 16-byte cp.async (two
//    commit groups, so the scores start while V is in flight). A row that
//    is not live is never read: its copy has source size 0, which
//    zero-fills the staged row; its score is set to -inf (p exactly 0) and
//    the PV product stops at the chunk's last live row.
//    bf16: scores and PV on the tensor cores, mma.sync m16n8k16 with fp32
//    accumulators: a warp takes 16 keys against the q panel (the heads
//    padded to 8 or 16 columns), then 16-column tiles of V^T (ldmatrix
//    .trans) against p, which the softmax has already rounded to bf16 as
//    the plain version rounds it, so the bf16 operand is exact.
//    fp32: on the CUDA cores, two threads per key, each half of the head
//    dim in interleaved 16-byte pieces against an fp32 q panel (one
//    shuffle adds the halves), and a thread per pair of head-dim columns
//    in the PV product. Loops over heads run to G padded to 4, 8 or 16, a
//    template argument, so none is predicated; the padded heads' q rows are
//    zero and their sums dropped.
//    Softmax: a half-warp per head, fp32, expf. A live block writes its
//    fp32 (acc, m, l) to the split scratch.
// 2. A live block also learns which splits of its request hold a live key
//    (from the length when paged; from one scan of the request's flags
//    when dense, while its K and V are in flight), and counts itself in on
//    a counter of (b, kh) with one acquire-release atomic. The last live
//    block to arrive resets the counter to 0 and merges the live splits
//    (merge_splits): the LSE merge in split-index order, no float atomics,
//    so two calls are bitwise equal. The normalised mode writes
//    acc* / max(l*, 1e-30) in the value type; the partials mode writes
//    (acc*, m*, l*) in fp32. Block 0 of a request with no live key writes
//    zeros, or (0, -1e30, 0).
//
// The dead split blocks, the many at the serving shapes, thus wait on
// nothing and hold up no merge. A second launch for the merge would cost a
// launch's host time and a kernel boundary on the device. The wrapper
// allocates the scratch (S x B x H x (hd + 2) floats) with torch.empty,
// keeps the B x K zeroed counters across calls (each launch leaves them
// zero, and launches on one stream run in order), and picks S from static
// shapes only: it never reads the lengths or the mask on the host.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace split_decode {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 64;              // keys a chunk
constexpr int THREADS = 2 * CHUNK;     // four warps of 16 keys (two threads a key in fp32)
constexpr int MAX_G = 16;              // query heads per KV head
constexpr int MAX_HD = 256;            // head dim, a multiple of 32
constexpr int MAX_SPLITS = 32;         // the merge holds every split's weight

// the heads a block computes: G padded to 4, 8 or 16 (a template argument,
// so that no loop over heads is predicated; the padded heads are dropped)
inline int group_pad(int G) { return G <= 4 ? 4 : G <= 8 ? 8 : 16; }

// Bytes after each staged K/V row, so that the rows of a warp's 16-byte
// accesses fall in distinct banks: 16 for the bf16 ldmatrix rows, 32 for
// the fp32 key-pair rows.
template <typename T>
__host__ __device__ constexpr int row_pad() { return std::is_same<T, float>::value ? 32 : 16; }

// Dynamic shared memory of one block: the K and V tiles; the q panel
// (fp32 at the padded group, or bf16 at 8 or 16 padded rows for the mma);
// the scores (key-major, fp32); p head-major in bf16 (mma); m / l /
// alpha; row offsets, liveness and the request's live-split mask.
inline size_t smem_bytes(int G, int hd, int elem) {
  const size_t NG = group_pad(G), NH = NG <= 8 ? 8 : 16;
  const size_t tail = 4 * CHUNK * NG + 4 * 3 * MAX_G + 8 * CHUNK + 4 * CHUNK + 16;
  if (elem == 4) return 2 * (size_t)CHUNK * (hd * 4 + 32) + 4 * NG * hd + tail;
  return 2 * (size_t)CHUNK * (hd * 2 + 16) + 2 * NH * (hd + 8) + 2 * NH * (CHUNK + 8) + tail;
}

inline bool shape_ok(int G, int hd) {
  return G >= 1 && G <= MAX_G && hd % 32 == 0 && hd > 0 && hd <= MAX_HD;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// OR into *bits the splits of `span` keys of request b that hold a live
// key (the row source's live_splits: from the length when paged, from a
// scan of the mask when dense), reduced over the block through one word.
template <typename Src>
__device__ __forceinline__ void or_live_splits(const Src& src, int b, int span,
                                               unsigned* bits) {
  const unsigned part = __reduce_or_sync(0xffffffffu, src.live_splits(b, span));
  if ((threadIdx.x & 31) == 0 && part) atomicOr(bits, part);
}

// 16 staged bytes widened to fp32 (4 floats or 8 bf16)
template <typename T>
__device__ __forceinline__ void unpack16(const unsigned char* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = to_f(e[i]);
}

// The last live split block of (request, KV head) to arrive merges the
// live splits of its G heads from the scratch: m* = max m_s,
// l* = sum l_s e^(m_s - m*), acc* = sum acc_s e^(m_s - m*), both sums in
// split-index order over the splits of `live` (bit s: split s has a live
// key; the others wrote nothing). One warp per head reads the splits'
// (m, l) a lane each; then a thread takes 4 consecutive elements of the
// (G, hd) output at a time and loads them from up to 8 live splits before
// it adds them.
template <typename T, bool PARTIALS>
__device__ void merge_splits(float* red, const float* acc_s, const float* m_s,
                             const float* l_s, void* out, float* m_out, float* l_out,
                             unsigned live, int b, int kh, int B, int H, int G, int hd) {
  constexpr int U = 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* w = red;                   // (32, G) merge weights e^(m_s - m*)
  float* lw = w + MAX_SPLITS * G;   // (32, G) l_s
  const size_t bh = (size_t)b * H + (size_t)kh * G;
  for (int g = warp; g < G; g += THREADS / 32) {
    float m = NEG_INF, l = 0.f;
    if ((live >> lane) & 1u) {
      const size_t j = ((size_t)lane * B + b) * H + (size_t)kh * G + g;
      m = __ldcg(m_s + j);
      l = __ldcg(l_s + j);
    }
    const float mx = warp_max(m);
    w[lane * G + g] = l > 0.f ? expf(m - mx) : 0.f;
    lw[lane * G + g] = l;
    if constexpr (PARTIALS) {
      if (lane == 0) m_out[bh + g] = mx;
    }
  }
  __syncthreads();
  const size_t split_stride = (size_t)B * H * hd;   // one split's acc
  const float* a0 = acc_s + bh * hd;                 // split 0's (G, hd) block
  for (int i = 4 * tid; i < G * hd; i += 4 * THREADS) {
    const int g = i / hd;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    for (unsigned rest = live; rest;) {
      int sp[U];
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {   // the next U live splits, ascending
        sp[u] = rest ? __ffs(rest) - 1 : -1;
        rest &= rest - 1;
        x[u] = __ldcg(reinterpret_cast<const float4*>(a0 + max(sp[u], 0) * split_stride + i));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (sp[u] >= 0) {
          const float wt = w[sp[u] * G + g];
          num.x = fmaf(x[u].x, wt, num.x);
          num.y = fmaf(x[u].y, wt, num.y);
          num.z = fmaf(x[u].z, wt, num.z);
          num.w = fmaf(x[u].w, wt, num.w);
          den = fmaf(lw[sp[u] * G + g], wt, den);
        }
      }
    }
    if constexpr (PARTIALS) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + bh * hd + i) = num;
      if (i % hd == 0) l_out[bh + g] = den;
    } else {
      const float l = fmaxf(den, 1e-30f);
      T* o = static_cast<T*>(out) + bh * hd + i;
      o[0] = from_f<T>(num.x / l);
      o[1] = from_f<T>(num.y / l);
      o[2] = from_f<T>(num.z / l);
      o[3] = from_f<T>(num.w / l);
    }
  }
}

template <typename T, int NG, bool PARTIALS, typename Src>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, Src src, void* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ l_out, float* acc_s, float* m_s,
             float* l_s, int* __restrict__ arrived, int B, int H, int K, int hd, int cps) {
  constexpr bool MMA = !std::is_same<T, float>::value;   // bf16 on the tensor cores
  constexpr int VEC = 16 / sizeof(T);                     // elements of a 16-byte piece
  constexpr int NH = NG <= 8 ? 8 : 16;                    // mma: heads as n columns
  constexpr int NT = NH / 8;                              // mma: n tiles
  constexpr int PT = CHUNK + 8;                           // mma: p row stride (bf16)
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  const int kh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;              // mma fragment coordinates
  const int row_bytes = hd * (int)sizeof(T) + row_pad<T>();
  const int pieces = hd / VEC;                            // 16-byte pieces of a row
  const int qh_stride = hd + 8;                           // mma: q row stride (bf16)
  unsigned char* ks = smem;
  unsigned char* vs = ks + CHUNK * row_bytes;
  unsigned char* qp = vs + CHUNK * row_bytes;             // q panel
  float* ps = reinterpret_cast<float*>(qp + (MMA ? 2 * NH * qh_stride : 4 * NG * hd));
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(ps + CHUNK * NG);   // (NH, PT) p
  float* ms = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(pt) +
                                       (MMA ? 2 * NH * PT : 0));   // (G,) running max
  float* ls = ms + MAX_G;               // (G,) running sum
  float* als = ls + MAX_G;              // (G,) this chunk's rescale
  long long* offs = reinterpret_cast<long long*>(als + MAX_G);    // (CHUNK,) row offsets
  int* ok = reinterpret_cast<int*>(offs + CHUNK);                 // (CHUNK,) liveness
  unsigned* live_bits = reinterpret_cast<unsigned*>(ok + CHUNK);  // the request's live splits

  if (tid < G) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  if (tid == 0) *live_bits = 0u;
  const int span = cps * CHUNK;   // keys of a split
  const float sqrt_hd = sqrtf(static_cast<float>(hd));
  // PV accumulators: mma fragments of the warp's 16-column tiles of
  // (hd, NH), or the fp32 columns d0, d0 + 1 of every head
  const int d0 = 2 * tid;
  float oacc[MAX_HD / 64][NT][4];
  float acc[NG][2];
#pragma unroll
  for (int j = 0; j < MAX_HD / 64; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      oacc[j][n][0] = oacc[j][n][1] = oacc[j][n][2] = oacc[j][n][3] = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g][0] = acc[g][1] = 0.f;
  bool seen = false;        // a live key in this split (uniform)

  // the split's keys; a split that starts at or past them takes no chunk
  const int lo = s * span;
  const int hi = min(src.keys(b), lo + span);
  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    const int rows = min(CHUNK, hi - c0);
    int live = 0;
    if (tid < CHUNK) {
      live = tid < rows && src.live(b, c0 + tid);
      ok[tid] = live;
      if (live) offs[tid] = (long long)src.row(b, kh, c0 + tid);
    }
    // block-wide vote, also the barrier after the flags and offsets
    if (!__syncthreads_or(live)) continue;

    // stage K then V; a dead row is zero-filled and never read
    for (int i = tid; i < CHUNK * pieces; i += THREADS) {
      const int r = i / pieces, c = i % pieces;
      const T* from = ok[r] ? src.k + offs[r] + c * VEC : src.k;
      cp_async_zfill16(smem_addr(ks + r * row_bytes + c * 16), from, ok[r] ? 16 : 0);
    }
    cp_async_commit();
    for (int i = tid; i < CHUNK * pieces; i += THREADS) {
      const int r = i / pieces, c = i % pieces;
      const T* from = ok[r] ? src.v + offs[r] + c * VEC : src.v;
      cp_async_zfill16(smem_addr(vs + r * row_bytes + c * 16), from, ok[r] ? 16 : 0);
    }
    cp_async_commit();
    if (!seen) {   // the request's live splits and the q panel while K and V fly
      or_live_splits(src, b, span, live_bits);
      const uint4* qb =
          reinterpret_cast<const uint4*>(q + ((size_t)b * H + (size_t)kh * G) * hd);
      if constexpr (MMA) {   // bf16 rows; padded heads and their p rows zero
        for (int i = tid; i < NH * pieces; i += THREADS) {
          const int g = i / pieces, c = i % pieces;
          *reinterpret_cast<uint4*>(qp + 2 * (g * qh_stride + c * VEC)) =
              g < G ? __ldg(qb + g * pieces + c) : make_uint4(0, 0, 0, 0);
        }
        for (int i = tid; i < NH * PT / 2; i += THREADS)
          if (i / (PT / 2) >= G) reinterpret_cast<uint32_t*>(pt)[i] = 0u;
      } else {               // fp32 rows, padded heads zero
        float* qs = reinterpret_cast<float*>(qp);
        for (int i = tid; i < NG * pieces; i += THREADS) {
          float f[VEC];
          if (i < G * pieces) {
            const uint4 raw = __ldg(qb + i);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) f[j] = to_f(e[j]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) f[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < VEC; j += 4)
            *reinterpret_cast<float4*>(qs + i * VEC + j) =
                make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
        }
      }
      seen = true;
    }
    cp_async_wait<1>();   // this thread's K pieces have landed
    __syncthreads();

    // scores s[r, g] = q_g . k_r / sqrt(hd) for live keys, -inf for dead ones
    if constexpr (MMA) {
      // warp w: keys 16w..16w+15 (the A rows) against the heads (n = q rows)
      const int key0 = 16 * warp;
      float c[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
      if (key0 < rows) {
        // ldmatrix rows: tile i of lanes 8i..8i+7 = (keys + 8 if i odd,
        // dims + 8 if i >= 2)
        const unsigned char* arow =
            ks + (key0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_bytes + (lane >> 4) * 16;
        for (int kb = 0; kb < hd; kb += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_addr(arow + 2 * kb));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const unsigned char* qrow = qp + 2 * ((8 * n + gid) * qh_stride + kb + 2 * tig);
            mma_16816(c[n], a, lds32(qrow), lds32(qrow + 16));
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // key gid (+8), head 2 tig (+1)
          const int r = key0 + gid + (e >> 1) * 8, g = 8 * n + 2 * tig + (e & 1);
          if (g < NG) ps[r * NG + g] = ok[r] ? c[n][e] / sqrt_hd : __uint_as_float(0xff800000u);
        }
      }
    } else {
      // key r = tid / 2; thread half h takes pieces h, h + 2, ...
      const float* qs = reinterpret_cast<const float*>(qp);
      const int r = tid >> 1, h = tid & 1;
      float part[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) part[g] = 0.f;
      if (ok[r]) {
        const unsigned char* krow = ks + r * row_bytes;
#pragma unroll 2
        for (int c = h; c < pieces; c += 2) {
          float kv[VEC];
          unpack16<T>(krow + c * 16, kv);
          const float* qc = qs + c * VEC;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qc + g * hd + j);
              part[g] = fmaf(qq.x, kv[j], part[g]);
              part[g] = fmaf(qq.y, kv[j + 1], part[g]);
              part[g] = fmaf(qq.z, kv[j + 2], part[g]);
              part[g] = fmaf(qq.w, kv[j + 3], part[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float full = part[g] + __shfl_xor_sync(0xffffffffu, part[g], 1);
        if ((g & 1) == h)
          ps[r * NG + g] = ok[r] ? full / sqrt_hd : __uint_as_float(0xff800000u);   // -inf
      }
    }
    __syncthreads();

    // online softmax, a half-warp per head (both halves of a warp take a
    // head together; a half past G computes and stores nothing), four keys
    // a lane; m stays finite (it starts at NEG_INF), so a dead key's
    // e^(-inf - m) is exactly 0. p is rounded to the value type: key-major
    // fp32 for the CUDA cores, head-major bf16 for the mma.
    for (int g0 = 2 * warp; g0 < G; g0 += THREADS / 16) {
      const int g = g0 + (lane >> 4), hl = lane & 15;
      const bool mine = g < G;
      float sv[4], mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[j] = mine ? ps[(hl + 16 * j) * NG + g] : NEG_INF;
        mx = fmaxf(mx, sv[j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = mine ? ms[g] : NEG_INF;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv[j] - m_new);
        sum += p;
        if (mine) {
          if constexpr (MMA) pt[g * PT + hl + 16 * j] = from_f<T>(p);
          else ps[(hl + 16 * j) * NG + g] = round_to<T>(p);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (mine && hl == 0) {
        const float alpha = expf(m_prev - m_new);
        als[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    cp_async_wait<0>();   // this thread's V pieces have landed
    __syncthreads();

    // acc[g, d] = acc * alpha + sum over keys of p[r, g] * v[r, d], the
    // keys past the chunk's last live one skipped; a dead key inside (a
    // hole of the dense mask) adds p = 0 times its zero-filled row:
    // nothing. The padded heads' sums (no softmax ran on their p) are never
    // stored.
    if constexpr (MMA) {
      // warp w: 16-column tiles w, w + 4, ... of V^T (the A rows = head
      // dims) against p (k = keys, n = heads); fragment e of n tile n
      // holds dim gid (+8), head 8n + 2 tig (+1)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 8 * n + 2 * tig + (e & 1);
          const float a = g < G ? als[g] : 0.f;
#pragma unroll
          for (int j = 0; j < MAX_HD / 64; ++j) oacc[j][n][e] *= a;
        }
      }
      // ldmatrix.trans rows: tile i of lanes 8i..8i+7 = (dims + 8 if i odd,
      // keys + 8 if i >= 2)
      const int vkey = (lane & 7) + (lane >> 4) * 8, vdim = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < MAX_HD / 64; ++j) {
        const int dt = 16 * (warp + 4 * j);
        if (dt < hd) {
          for (int kb = 0; kb < rows; kb += 16) {
            uint32_t a[4];
            ldmatrix_x4_trans(a,
                              smem_addr(vs + (kb + vkey) * row_bytes + 2 * (dt + vdim)));
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const __nv_bfloat16* prow = pt + (8 * n + gid) * PT + kb + 2 * tig;
              mma_16816(oacc[j][n], a, lds32(prow), lds32(prow + 8));
            }
          }
        }
      }
    } else if (d0 < hd) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float a = g < G ? als[g] : 0.f;
        acc[g][0] *= a;
        acc[g][1] *= a;
      }
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float p[NG];
#pragma unroll
        for (int g = 0; g < NG; g += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(ps + r * NG + g);
          p[g] = pp.x;
          p[g + 1] = pp.y;
          p[g + 2] = pp.z;
          p[g + 3] = pp.w;
        }
        const float2 v = *reinterpret_cast<const float2*>(vs + r * row_bytes + 4 * d0);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[g][0] = fmaf(p[g], v.x, acc[g][0]);
          acc[g][1] = fmaf(p[g], v.y, acc[g][1]);
        }
      }
    }
    __syncthreads();   // the tiles, p and the flags are rewritten next chunk
  }

  if (!seen) {
    // A split without a live key writes nothing: the merge knows it from
    // the live-split mask. Split 0 also writes the result of a request
    // that has no live key in any split, which no block merges.
    if (s != 0) return;
    __syncthreads();   // the mask's zeroing before any OR into it
    or_live_splits(src, b, span, live_bits);
    __syncthreads();
    if (*live_bits) return;
    const size_t bh = (size_t)b * H + (size_t)kh * G;
    for (int i = tid; i < G * hd; i += THREADS) {
      if constexpr (PARTIALS) static_cast<float*>(out)[bh * hd + i] = 0.f;
      else static_cast<T*>(out)[bh * hd + i] = from_f<T>(0.f);
    }
    if constexpr (PARTIALS) {
      if (tid < G) {
        m_out[bh + tid] = NEG_INF;
        l_out[bh + tid] = 0.f;
      }
    }
    return;
  }

  // this split's (acc, m, l) into the scratch
  const size_t bh0 = ((size_t)s * B + b) * H + (size_t)kh * G;
  if (tid < G) {
    m_s[bh0 + tid] = ms[tid];
    l_s[bh0 + tid] = ls[tid];
  }
  if constexpr (MMA) {
#pragma unroll
    for (int j = 0; j < MAX_HD / 64; ++j) {
      const int dt = 16 * (warp + 4 * j);
      if (dt < hd) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = 8 * n + 2 * tig + (e & 1), d = dt + gid + (e >> 1) * 8;
            if (g < G) acc_s[(bh0 + g) * hd + d] = oacc[j][n][e];
          }
        }
      }
    }
  } else if (d0 < hd) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g < G)
        *reinterpret_cast<float2*>(acc_s + (bh0 + g) * hd + d0) =
            make_float2(acc[g][0], acc[g][1]);
    }
  }
  // count the live arrivals of (b, kh): one thread adds with release
  // semantics after the barrier, so the block's scratch writes are visible
  // to the block that acquires the last count; that block resets the
  // counter to 0 for the next call and merges
  __syncthreads();
  const unsigned live = *live_bits;
  if (tid == 0) {
    int* c = arrived + (size_t)b * K + kh;
    const bool last = add_acq_rel(c) == __popc(live) - 1;
    if (last) *c = 0;
    ok[0] = last;
  }
  __syncthreads();
  if (!ok[0]) return;
  merge_splits<T, PARTIALS>(reinterpret_cast<float*>(ks), acc_s, m_s, l_s, out, m_out, l_out,
                            live, b, kh, B, H, G, hd);
}

template <typename T, int NG, bool PARTIALS, typename Src>
cudaError_t launch_split(const T* q, const Src& src, void* out, float* m_out, float* l_out,
                         float* acc_s, float* m_s, float* l_s, int* arrived, int B, int H,
                         int K, int hd, int S, int cps, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(split_kernel<T, NG, PARTIALS, Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  split_kernel<T, NG, PARTIALS, Src><<<dim3(K, B, S), THREADS, smem, st>>>(
      q, src, out, m_out, l_out, acc_s, m_s, l_s, arrived, B, H, K, hd, cps);
  return cudaGetLastError();
}

// One launch; returns cudaGetLastError() after it. `n_keys` is the key
// slots of a request (T, or NB * bs); `S` the wrapper's split count;
// `arrived` B * K zeroed counters that the launch leaves zeroed.
template <typename T, bool PARTIALS, typename Src>
int launch(const T* q, const Src& src, void* out, float* m_out, float* l_out,
           float* scratch, int* arrived, int B, int H, int K, int hd, int n_keys, int S,
           cudaStream_t st) {
  if (K <= 0 || H % K || !shape_ok(H / K, hd) || S < 1 || S > MAX_SPLITS || n_keys < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  const int chunks = (n_keys + CHUNK - 1) / CHUNK;
  const int cps = (chunks + S - 1) / S;
  const size_t smem = smem_bytes(G, hd, sizeof(T));
  const size_t BH = (size_t)B * H;
  float* acc_s = scratch;
  float* m_s = acc_s + (size_t)S * BH * hd;
  float* l_s = m_s + (size_t)S * BH;
  const int NG = group_pad(G);
  const cudaError_t e =
      NG == 4 ? launch_split<T, 4, PARTIALS>(q, src, out, m_out, l_out, acc_s, m_s, l_s,
                                             arrived, B, H, K, hd, S, cps, smem, st)
      : NG == 8
          ? launch_split<T, 8, PARTIALS>(q, src, out, m_out, l_out, acc_s, m_s, l_s,
                                         arrived, B, H, K, hd, S, cps, smem, st)
          : launch_split<T, 16, PARTIALS>(q, src, out, m_out, l_out, acc_s, m_s, l_s,
                                          arrived, B, H, K, hd, S, cps, smem, st);
  return static_cast<int>(e);
}

}  // namespace split_decode
