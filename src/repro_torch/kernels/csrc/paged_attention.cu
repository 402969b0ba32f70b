// K4 on Hopper: paged decode attention, one query token per request
// against a block-pool KV cache, gathered through a block table.
//
// Replaces the Pallas kernel `paged_attention` (`_paged_kernel`) in
// src/repro/kernels/paged_attention.py. Inputs, as there:
//   q            (R, Hq, D)          one incoming token per request slot
//   k/v pool     (P, page, Hkv, D)   one layer's shared block pools
//   block_tables (R, M) int32        slot j of request r holds positions
//                                    [j*page, (j+1)*page)
//   seq_lens     (R,) int32          live cached tokens per request
//   out          (R, Hq, D)          in q's dtype; arithmetic in float32
// Head dims 32, 64, 112 (zamba2's shared block) and 128.
//
// Design. One CTA of 128 threads per (KV head, request). The G = Hq/Hkv
// query heads of that KV head are staged in shared memory in float32.
// The TPU grid visits all M table slots of every request; here the CTA
// loops only over the request's live blocks, ceil(seq_lens[r] / page),
// reading each block id from the table (the TPU's scalar prefetch
// becomes a per-CTA table load), so table entries past the live length
// are never read. For each block:
//   0. the block's live K and V rows are loaded by all threads together,
//      neighbouring threads on neighbouring elements, into shared memory
//      in float32 (tokens past seq_lens[r] are not loaded);
//   1. scores s[g][t] = q_g . k_t * scale: each warp takes tokens
//      t = warp, warp+4, ...; its lanes split D and reduce by shuffles.
//      Tokens past seq_lens[r] get NEG_INF = -2^30;
//   2. online softmax per query head (one warp per head): m_new, the
//      rescale alpha = exp(m - m_new), and p = exp(s - m_new) computed
//      under the mask (dead lanes give exactly 0), l = l*alpha + sum p;
//   3. acc[g][d] = acc*alpha + sum_t p[g][t] * v_t[d] over live tokens,
//      each thread owning (g, d) entries; acc lives in shared memory.
// The output is acc / max(l, 1e-30): a request with seq_lens == 0 visits
// no block and writes exact zeros. The (m, l, acc) sums stay in float32.
//
// Bound. Decode reads each live K and V row once: the bytes are
// 2 * sum(seq_lens) * Hkv * D * sizeof(T) plus q and out; about
// 4 * sum(seq_lens) * Hq * D flops, far below the float32 peak, so the
// kernel is bound by memory (3.35 TB/s on an H100 SXM). This first
// version is simple, not fast: scalar loads, four block-wide barriers
// per page and one CTA per (head, request). Split-K over long contexts,
// cp.async/TMA for the K/V blocks and tensor-core products are later
// work.
//
// The C interface takes every pointer and the stream as void*, launches
// once on that stream and returns cudaGetLastError(). The caller (the
// wrapper in kernels/paged_attention.py) checks shapes, dtypes,
// contiguity and devices before the call.

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

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
