// K4 on Hopper: paged decode attention, one query token per request
// against a block-pool KV cache, gathered through a block table.
//
// Replaces the Pallas kernel `paged_attention` (`_paged_kernel`,
// pallas_call at src/repro/kernels/paged_attention.py:119). Inputs, as
// there:
//   q            (R, Hq, D)          one incoming token per request slot
//   k/v pool     (P, page, Hkv, D)   one layer's shared block pools
//   block_tables (R, M) int32        slot j of request r holds positions
//                                    [j*page, (j+1)*page)
//   seq_lens     (R,) int32          live cached tokens per request
//   out          (R, Hq, D)          in q's dtype; arithmetic in float32
// float32, bfloat16 and float16 at head dims 32, 64, 112 (zamba2's
// shared block) and 128, any page size. A length past the table is cut
// to M*page; seq_lens == 0 gives exact zeros; the probabilities are
// taken under the mask, so a dead token adds zero mass, never
// exp(NEG_INF - NEG_INF) = 1 (the reference's dead-block lesson).
//
// Bound: bytes. A call reads each live K and V row once,
// 2 * sum(min(seq_lens, M*page)) * Hkv * D * sizeof(T), plus q, out and
// the live table entries: 8.4 MB, 2.5 us at 3.35 TB/s, for llama3.2-3b's
// heads at 8 requests of up to 512 tokens. Its ~4 * sum(seq) * Hq * D
// flops are G = Hq/Hkv flops a byte of K/V (3 for llama3.2-3b, 1 for
// zamba2-7b), far under the ~295 flops a byte at which bf16 tensor cores
// would become the limit, so the G x page products stay on CUDA cores:
// wgmma would wait on the same bytes.
//
// What a call must do, then, is keep megabytes of K/V in flight across
// the card with little latency in each CTA's chain. The route `sm90`
// (sm90_paged_attention_kernel, and its merge):
//   * Split context. The grid is (KV head [x query-head group], request,
//     split): split s takes table slots [s*pps, (s+1)*pps) of its
//     request. The number of splits and pps come from the wrapper's
//     `split_plan`, a function of shapes only (R, Hkv, M, page and the
//     card's SM count), so a call reads no device value on the host and
//     needs no sync. At llama3.2-3b's serve shape (R*Hkv = 64, M = 32)
//     it gives 8 splits of 4 pages, 512 CTAs where the first version had
//     64; when R*Hkv fills two waves of SMs alone it gives one split. A
//     CTA whose first token lies at or past its request's length exits
//     at once (with one split, after writing the request's zeros).
//   * Many bytes in flight. Each of the CTA's 4 warps takes whole pages
//     (pages w, w+4, ... of the split) and stages them, in chunks of 16
//     rows in 16 bits or 8 in float32 (a page of 16 tokens is one chunk
//     or two), with 16-byte cp.async.cg copies into a ring of 2 chunks
//     of K and V in its own part of shared memory, in the pool's dtype
//     (converted to float32 at use): 8 KB in flight a warp at D 128. Every supported (dtype, D) row is a whole number of
//     16-byte vectors (D 112 in bf16 is 14, D 32 in f32 is 8); the
//     wrapper refuses pointers that are not 16-byte aligned. cp.async
//     and not TMA: the pages are scattered and every layer has its own
//     pool, so TMA would need two tensor maps encoded on the host per
//     layer per decode step, which is what makes K2q's wrapper outlast
//     its kernel at S 256.
//   * Few barriers. A warp waits on its own ring (cp.async.wait_group
//     and __syncwarp); there is no block-wide barrier per page. A warp's
//     lanes split a row into 16-byte vectors, kL lanes a row and 32/kL
//     rows at once; each lane keeps its rows' (m, l, acc) for the G
//     query heads of its KV head in float32 registers (acc: G x 8 floats
//     a lane in 16 bits, G x 4 in float32). The rows of a warp merge by
//     shuffles, the warps once through shared memory (one
//     __syncthreads), in a fixed order.
//   * One merge. With one split the CTA writes out directly. With more,
//     each live split writes (acc, m, l) in float32 to scratch that the
//     wrapper allocates from shapes, and sm90_paged_attention_merge_kernel
//     (launched from the same C entry) takes
//       out = sum_s exp(m_s - m*) acc_s / sum_s exp(m_s - m*) l_s
//     over the splits that hold a live token, m* their max, in split
//     order: no atomics, the same bits from run to run. A split with no
//     live token is never read; a request with none gets exact zeros.
//
// The first version (paged_attention_kernel below: one 128-thread CTA
// per (KV head, request) walking its live pages one after another, each
// page staged in float32 by scalar loads, four block-wide barriers a
// page) stays as the route `simt`, for timing beside `sm90` only.
//
// The C interface takes every pointer and the stream as void*, launches
// on that stream and returns cudaGetLastError(). The caller (the wrapper
// in kernels/paged_attention.py) checks shapes, dtypes, contiguity,
// alignment and devices before the call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);               // round to nearest even
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int hq, int hkv, int page, int m_slots, float scale) {
  // a warp's lanes split D; at D = 112 (zamba2) the last slice is ragged
  constexpr int kPerLane = (D + 31) / 32;
  const int h = blockIdx.x, r = blockIdx.y;
  const int n_g = hq / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [G][D] queries, float32
  float* acc = q_s + n_g * D;         // [G][D] running output
  float* p_s = acc + n_g * D;         // [G][page] scores, then probabilities
  float* m_s = p_s + n_g * page;      // [G] running max
  float* l_s = m_s + n_g;             // [G] running sum
  float* a_s = l_s + n_g;             // [G] this block's rescale factor
  float* k_s = a_s + n_g;             // [page][D] this block's live K rows
  float* v_s = k_s + page * D;        // [page][D] and V rows

  // a length past the table is cut to it, as the reference's mask does
  const int len = max(0, min(seq_lens[r], m_slots * page));
  const size_t head0 = ((size_t)r * hq + (size_t)h * n_g) * D;
  for (int e = tid; e < n_g * D; e += kThreads) {
    q_s[e] = to_f32(q[head0 + e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < n_g; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const size_t tok_stride = (size_t)hkv * D;   // one token row of a pool
  const int n_blocks = (len + page - 1) / page;
  for (int j = 0; j < n_blocks; ++j) {
    const size_t blk = (size_t)block_tables[(size_t)r * m_slots + j];
    const int live = min(page, len - j * page);
    const T* k_blk = k_pool + blk * page * tok_stride + (size_t)h * D;
    const T* v_blk = v_pool + blk * page * tok_stride + (size_t)h * D;

    // 0. stage the live K and V rows; unrolled, so that a thread has
    //    several loads in flight before its first store waits on one
#pragma unroll 8
    for (int e = tid; e < live * D; e += kThreads) {
      const size_t src = (size_t)(e / D) * tok_stride + e % D;
      k_s[e] = to_f32(k_blk[src]);
      v_s[e] = to_f32(v_blk[src]);
    }
    __syncthreads();

    // 1. scores, masked past the live length
    for (int t = warp; t < page; t += kWarps) {
      if (t < live) {
        float kv[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          kv[i] = lane + 32 * i < D ? k_s[t * D + lane + 32 * i] : 0.f;
        for (int g = 0; g < n_g; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            if (lane + 32 * i < D) s += q_s[g * D + lane + 32 * i] * kv[i];
          s = warp_sum(s);
          if (lane == 0) p_s[g * page + t] = s * scale;
        }
      } else if (lane == 0) {
        for (int g = 0; g < n_g; ++g) p_s[g * page + t] = kNegInf;
      }
    }
    __syncthreads();

    // 2. online softmax, the probabilities computed under the mask
    for (int g = warp; g < n_g; g += kWarps) {
      float* p = p_s + g * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = t < live ? expf(p[t] - m_new) : 0.f;
        p[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // 3. rescale and accumulate p @ v over the live tokens
    for (int e = tid; e < n_g * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* p = p_s + g * page;
      float a = acc[e] * a_s[g];
      for (int t = 0; t < live; ++t) a += p[t] * v_s[t * D + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < n_g * D; e += kThreads)
    out[head0 + e] = from_f32<T>(acc[e] / fmaxf(l_s[e / D], 1e-30f));
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* bt,
            const void* seq, void* out, int r, int hq, int hkv, int page,
            int m_slots, float scale, size_t smem, cudaStream_t stream) {
  paged_attention_kernel<T, D><<<dim3(hkv, r), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(seq), static_cast<T*>(out), hq, hkv, page,
      m_slots, scale);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* bt, const void* seq, void* out, int r, int hq,
             int hkv, int page, int m_slots, float scale, size_t smem,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      launch<T, 32>(q, k, v, bt, seq, out, r, hq, hkv, page, m_slots, scale,
                    smem, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, bt, seq, out, r, hq, hkv, page, m_slots, scale,
                    smem, stream);
      break;
    case 112:
      launch<T, 112>(q, k, v, bt, seq, out, r, hq, hkv, page, m_slots, scale,
                     smem, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, bt, seq, out, r, hq, hkv, page, m_slots, scale,
                     smem, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ route sm90 --

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kRing = 2;                    // chunks in flight a warp
constexpr int kChunkRowBytes = 32;          // a chunk is 32 / sizeof(T)
                                            // rows: 16 in 16 bits, 8 in f32
constexpr int kMergeThreads = 128;         // a merge CTA: one an element

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the float32 values of one 16-byte vector of T
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4 u,
                                                        float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {           // bfloat16 is float32's top half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<__half>(const uint4 u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

// Shared memory of a CTA: each warp's ring of kRing chunks of K and V,
// then the warps' (acc, m, l) for the merge.
__host__ __device__ constexpr size_t sm90_ring_bytes(int d) {
  return (size_t)kSplitWarps * kRing * 2 * kChunkRowBytes * d;
}
__host__ __device__ constexpr size_t sm90_smem_bytes(int d, int g) {
  return sm90_ring_bytes(d) + sizeof(float) * kSplitWarps * g * (d + 2);
}

// The minimum of 1 CTA an SM gives ptxas an explicit register budget
// (shared memory caps residency at 3 CTAs at D 128 anyway); without it,
// its default target spilled 8-16 bytes in some float32 and float16
// instances.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kSplitThreads, 1)
sm90_paged_attention_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ seq_lens,
                            T* __restrict__ out, float* __restrict__ part_acc,
                            float* __restrict__ part_ml, int hq, int hkv,
                            int page, int m_slots, int pps, float scale) {
  constexpr int kE = 16 / sizeof(T);        // elements in a 16-byte vector
  constexpr int kNV = D / kE;               // vectors in a row
  constexpr int kL = kNV <= 4 ? 4 : kNV <= 8 ? 8 : kNV <= 16 ? 16 : 32;
  constexpr int kTP = 32 / kL;              // rows a warp reads at once
  constexpr int kChunk = kChunkRowBytes / (int)sizeof(T);   // rows a chunk
  constexpr int kNP = kChunk / kTP;         // passes over a chunk
  static_assert(kNV * kE == D && kNV <= 32, "a row is whole 16-byte vectors");
  static_assert(kChunk % kTP == 0, "passes tile a chunk");

  const int n_req = gridDim.y, n_split = gridDim.z;
  const int n_g = hq / hkv, n_gc = n_g / G;
  const int h = blockIdx.x / n_gc;                         // KV head
  const int g0 = h * n_g + (blockIdx.x - h * n_gc) * G;    // first q head
  const int r = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t out0 = ((size_t)r * hq + g0) * D;

  // a length past the table is cut to it, as the reference's mask does
  const int len = max(0, min(seq_lens[r], m_slots * page));
  if (split * pps * page >= len) {          // no live token in this split
    if (n_split == 1)
      for (int e = threadIdx.x; e < G * D; e += kSplitThreads)
        out[out0 + e] = from_f32<T>(0.f);
    return;
  }

  // the same dynamic shared memory as the simt kernel's smem, in bytes
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* ring = reinterpret_cast<T*>(smem_bytes)
            + (size_t)warp * kRing * 2 * kChunk * D;
  float* red_acc = reinterpret_cast<float*>(smem_bytes + sm90_ring_bytes(D));
  float* red_m = red_acc + kSplitWarps * G * D;
  float* red_l = red_m + kSplitWarps * G;

  // this warp's pages: j0 + warp, j0 + warp + 4, ... below the split's
  // last live page; each walked in chunks of kChunk rows
  const int j0 = split * pps;
  const int j1 = min(j0 + pps, (len + page - 1) / page);
  const int n_pages = j0 + warp < j1
                          ? (j1 - j0 - warp + kSplitWarps - 1) / kSplitWarps
                          : 0;
  const int cpp = (page + kChunk - 1) / kChunk;
  const int n_chunks = n_pages * cpp;
  const size_t row_stride = (size_t)hkv * D;   // one token row of a pool

  // chunk i: its page j, first row t0 and live rows (<= 0 only past the
  // last live token of the request's last page)
  auto rows_of = [&](int i, int& j, int& t0) {
    j = j0 + warp + (i / cpp) * kSplitWarps;
    t0 = (i % cpp) * kChunk;
    return min(min(kChunk, page - t0), len - j * page - t0);
  };
  // stage chunk i's live K and V rows into ring slot i % kRing; one
  // commit group a chunk, empty past the last, so the waits stay uniform
  auto stage = [&](int i) {
    if (i < n_chunks) {
      int j, t0;
      const int rows = rows_of(i, j, t0);
      if (rows > 0) {
        const size_t blk = (size_t)block_tables[(size_t)r * m_slots + j];
        const size_t base = (blk * page + t0) * row_stride + (size_t)h * D;
        T* ks = ring + (i % kRing) * 2 * kChunk * D;
        T* vs = ks + kChunk * D;
        for (int e = lane; e < rows * kNV; e += 32) {
          const int t = e / kNV;
          const size_t src = base + t * row_stride + (e - t * kNV) * kE;
          cp_async16(ks + e * kE, k_pool + src);
          cp_async16(vs + e * kE, v_pool + src);
        }
      }
    }
    cp_async_commit();
  };

  // lane (slot, c) reads vector c of rows slot, slot + kTP, ...; lanes
  // with c >= kNV (D 112) hold no vector and add zeros to the sums
  const int slot = lane / kL, c = lane % kL;
  const bool active = c < kNV;
  float qf[G][kE], acc[G][kE], m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active) {
      unpack16<T>(*reinterpret_cast<const uint4*>(q + out0 + g * D + c * kE),
                  qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) qf[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }

  for (int i = 0; i < kRing - 1; ++i) stage(i);
  for (int i = 0; i < n_chunks; ++i) {
    stage(i + kRing - 1);       // into the slot chunk i - 1 left
    cp_async_wait<kRing - 1>();  // this lane's copies of chunk i landed
    __syncwarp();                // and every lane's
    int j, t0;
    const int rows = rows_of(i, j, t0);
    const T* ks = ring + (i % kRing) * 2 * kChunk * D;
    const T* vs = ks + kChunk * D;

    // scores of this lane's rows, NEG_INF past the live length
    float s[kNP][G], mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = kNegInf;
#pragma unroll
    for (int p = 0; p < kNP; ++p) {   // no branch around the shuffles
      const int t = p * kTP + slot;
      const bool live = t < rows;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (live && active) {
        float kf[kE];
        unpack16<T>(*reinterpret_cast<const uint4*>(ks + t * D + c * kE), kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < kE; ++e) part[g] += qf[g][e] * kf[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = part[g];
#pragma unroll
        for (int o = kL / 2; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        s[p][g] = live ? v * scale : kNegInf;
        mx[g] = fmaxf(mx[g], s[p][g]);
      }
    }
    // online softmax, the probabilities under the mask
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m_run[g], mx[g]);
      const float alpha = expf(m_run[g] - m_new);
      m_run[g] = m_new;
      l_run[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int t = p * kTP + slot;
      if (t < rows) {
        float vf[kE];
        if (active)
          unpack16<T>(*reinterpret_cast<const uint4*>(vs + t * D + c * kE),
                      vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = expf(s[p][g] - m_run[g]);
          l_run[g] += pr;
          if (active)
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[g][e] += pr * vf[e];
        }
      }
    }
    __syncwarp();               // slot i % kRing is read before reuse
  }
  cp_async_wait<0>();

  // merge the warp's row slots (lanes kL, 2kL, ... apart): a slot that
  // saw no live token has m = NEG_INF, l = 0, acc = 0 and weighs 0
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m_run[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_run[g], o);
      const float m_new = fmaxf(m_run[g], m_o);
      const float a = expf(m_run[g] - m_new), b = expf(m_o - m_new);
      l_run[g] = l_run[g] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[g][e] = acc[g][e] * a
                    + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * b;
      m_run[g] = m_new;
    }
  }
  if (slot == 0 && active)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e)
        red_acc[(warp * G + g) * D + c * kE + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red_m[warp * G + g] = m_run[g];
      red_l[warp * G + g] = l_run[g];
    }
  __syncthreads();

  // merge the warps in order; warp 0 holds the split's first live page,
  // so m* is finite and a warp without live tokens weighs exp(-2^30) = 0
  for (int e = threadIdx.x; e < G * D; e += kSplitThreads) {
    const int g = e / D, d = e - g * D;
    float m_star = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      m_star = fmaxf(m_star, red_m[w * G + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = expf(red_m[w * G + g] - m_star);
      num += wt * red_acc[(w * G + g) * D + d];
      den += wt * red_l[w * G + g];
    }
    if (n_split == 1) {
      // den >= 1 (the top score weighs exp(0)), where __fdividef is good
      // to 2 ulp; IEEE division's slow-path call made ptxas spill
      out[out0 + e] = from_f32<T>(__fdividef(num, den));
    } else {
      const size_t row = ((size_t)split * n_req + r) * hq + g0 + g;
      part_acc[row * D + d] = num;
      if (d == 0) {
        part_ml[2 * row] = m_star;
        part_ml[2 * row + 1] = den;
      }
    }
  }
}

// out[r, head, d], one thread each, from the splits that hold a live
// token of request r, in split order; exact zeros where there is none.
// The split loops are unrolled so that their loads are in flight
// together (the rows' m and l are shared through L1 by their D threads).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
sm90_paged_attention_merge_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml,
                                  const int* __restrict__ seq_lens,
                                  T* __restrict__ out, int n_req, int hq,
                                  int d, int page, int m_slots, int pps,
                                  int n_split) {
  const int idx = blockIdx.x * kMergeThreads + threadIdx.x;
  if (idx >= n_req * hq * d) return;
  const int row = idx / d, dd = idx - row * d;
  const int len = max(0, min(seq_lens[row / hq], m_slots * page));
  const int span = pps * page;
  const int n_live = min(n_split, (len + span - 1) / span);
  const size_t stride = (size_t)n_req * hq;   // rows between splits
  float m_star = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s)
    m_star = fmaxf(m_star, part_ml[2 * (s * stride + row)]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const float w = expf(part_ml[2 * (s * stride + row)] - m_star);
    den += w * part_ml[2 * (s * stride + row) + 1];
    num += w * part_acc[(s * stride + row) * d + dd];
  }
  out[idx] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

struct Sm90Args {
  const void *q, *k, *v, *bt, *seq;
  void *out, *part_acc, *part_ml;
  int r, hq, hkv, page, m_slots, pps, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int G>
int launch_sm90(const Sm90Args& a) {
  constexpr size_t smem = sm90_smem_bytes(D, G);
  auto kernel = sm90_paged_attention_kernel<T, D, G>;
  if (smem > 48 * 1024) {       // opt in above 48 KB, once a device
    static bool opted[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted[dev] = true;
    }
  }
  const int n_gc = a.hq / a.hkv / G;
  kernel<<<dim3(a.hkv * n_gc, a.r, a.n_split), kSplitThreads, smem,
           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.seq), static_cast<T*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml), a.hq,
      a.hkv, a.page, a.m_slots, a.pps, a.scale);
  if (a.n_split > 1) {
    const int n = a.r * a.hq * D;
    sm90_paged_attention_merge_kernel<T>
        <<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
           a.stream>>>(static_cast<const float*>(a.part_acc),
                       static_cast<const float*>(a.part_ml),
                       static_cast<const int*>(a.seq), static_cast<T*>(a.out),
                       a.r, a.hq, D, a.page, a.m_slots, a.pps, a.n_split);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_sm90_g(int g, const Sm90Args& a) {
  switch (g) {
    case 1: return launch_sm90<T, D, 1>(a);
    case 2: return launch_sm90<T, D, 2>(a);
    case 3: return launch_sm90<T, D, 3>(a);
    case 4: return launch_sm90<T, D, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_sm90_d(int d, int g, const Sm90Args& a) {
  switch (d) {
    case 32: return launch_sm90_g<T, 32>(g, a);
    case 64: return launch_sm90_g<T, 64>(g, a);
    case 112: return launch_sm90_g<T, 112>(g, a);
    case 128: return launch_sm90_g<T, 128>(g, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The query heads a CTA takes: all G of its KV head up to 4 (every
// configuration served has G <= 4), else the largest of 4, 3, 2, 1 that
// divides G (each group then reads its KV head's pages again).
int sm90_group(int n_g) {
  if (n_g <= 4) return n_g;
  for (int g = 4; g > 1; --g)
    if (n_g % g == 0) return g;
  return 1;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t.
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* block_tables,
                                      const void* seq_lens, void* out, int r,
                                      int hq, int hkv, int d, int page,
                                      int m_slots, float scale,
                                      void* stream) {
  if (r <= 0 || hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  const int n_g = hq / hkv;
  const size_t smem =
      sizeof(float) * (2 * n_g * d + n_g * page + 3 * n_g + 2 * page * d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(d, q, k_pool, v_pool, block_tables, seq_lens,
                             out, r, hq, hkv, page, m_slots, scale, smem, s);
    case 1:
      return launch_d<__nv_bfloat16>(d, q, k_pool, v_pool, block_tables,
                                     seq_lens, out, r, hq, hkv, page, m_slots,
                                     scale, smem, s);
    case 2:
      return launch_d<__half>(d, q, k_pool, v_pool, block_tables, seq_lens,
                              out, r, hq, hkv, page, m_slots, scale, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16. The route sm90: with n_split
// > 1, part_acc (n_split, r, hq, d) and part_ml (n_split, r, hq, 2) are
// float32 scratch; the kernel and, with n_split > 1, its merge launch on
// the stream. Returns a cudaError_t.
extern "C" int paged_attention_sm90_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* seq_lens, void* out,
    void* part_acc, void* part_ml, int r, int hq, int hkv, int d, int page,
    int m_slots, int pps, int n_split, float scale, void* stream) {
  if (r <= 0 || hkv <= 0 || hq % hkv != 0 || page <= 0 || m_slots < 0
      || pps <= 0 || n_split <= 0 || (long long)n_split * pps < m_slots
      || (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Sm90Args a{q,  k_pool, v_pool, block_tables, seq_lens, out,
                   part_acc, part_ml, r,  hq,   hkv,  page,  m_slots,
                   pps, n_split, scale, static_cast<cudaStream_t>(stream)};
  const int g = sm90_group(hq / hkv);
  switch (dtype) {
    case 0: return launch_sm90_d<float>(d, g, a);
    case 1: return launch_sm90_d<__nv_bfloat16>(d, g, a);
    case 2: return launch_sm90_d<__half>(d, g, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
