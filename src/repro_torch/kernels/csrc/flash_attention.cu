// K2 on Hopper: blockwise (flash) attention, forward and the two backward
// kernels, with GQA, causal and sliding-window masks: the first version,
// the "simt" route. The wrapper (kernels/flash_attention.py: route) sends
// 16-bit calls at D 32 here; every other call takes
// flash_attention_sm90.cu (16 bits on the tensor cores, float32 K2f, K2q
// and K2kv redesigned for the CUDA cores), and these kernels, named by an
// explicit route="simt", are timed beside it.
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
//   K2f  _fwd_flat / _flash_kernel        (pallas_call at :171)
//   K2q  flash_attention_bwd, dq pass     (pallas_call at :342)
//   K2kv flash_attention_bwd, dk/dv pass  (pallas_call at :370)
// Inputs, as there (each contiguous):
//   q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) in float32, bfloat16 or
//   float16, D one of 32, 64, 112 (zamba2's shared block) and 128; query head h reads KV head h / (Hq / Hkv); the q tokens are
//   the last Sq of the Sk keys (seq_off = Sk - Sq).
//   K2f writes o_f32 (B*Hq, Sq, D) and lse (B*Hq, Sq), both float32.
//   K2q and K2kv read dO (B*Hq, Sq, D) in float32, lse and
//   delta = sum_d dO * o_f32 (B*Hq, Sq), and write dq, dk, dv in the
//   input dtype.
// Mask: key k is live for query q when k < Sk, q < Sq, (not causal or
// k <= q + seq_off) and (window == 0 or q + seq_off - k < window). The
// probabilities are set to 0 under the mask in all three kernels, so
// exp(NEG_INF - NEG_INF) = 1 never counts: a row with no live key gets
// l = 0, o = 0 and lse = NEG_INF, and adds nothing to dq, dk or dv.
//
// Design. The TPU kernels carry their sums in revisited output blocks
// across a sequential grid axis; blocks of a GPU grid run in no order, so
// each CTA here owns its output tile and loops inside over the tiles it
// needs, skipping those the mask leaves dead (past the causal diagonal,
// before the window). Tiles are 64 x 64, 256 threads as 16 x 16; each
// thread owns a 4 x 4 micro-tile of the scores (rows ty + 16i, columns
// tx + 16j) and a 4 x D/16 micro-tile of its output (rows ty + 16i,
// columns tx + 16j), so the row statistics a thread needs for its output
// rows are the ones it computed. Row reductions are shuffles within the
// 16 lanes of a row. Tiles are staged in shared memory in float32 with a
// row stride of D + 1, which keeps the 16 rows a warp reads on distinct
// banks; ragged rows are zero-filled on load and masked.
//   K2f, one CTA per (b*Hq + h, q-block): Q staged once; per k-tile the
//     scores, the online (m, l) update and acc = acc*alpha + P V.
//   K2q, one CTA per (b*Hq + h, q-block): Q and dO staged once; per
//     k-tile p = exp(s - lse) under the mask, ds = p (dO V^T - delta),
//     dq += ds K. dq is scaled once at the end.
//   K2kv, one CTA per (b*Hkv + kv, k-block): K and V staged once; the CTA
//     walks the g query heads of its KV head and the q-blocks that see
//     its keys, accumulating dv += P^T dO and dk += dS^T Q in registers:
//     no atomics, the sum over the group is deterministic.
//
// Bound. With the causal mask a call does ~2 Sq Sk D B Hq flops a matrix
// product (two in K2f, three in K2q, four in K2kv over the live half):
// the work is operations, not bytes. This first version computes on the
// CUDA cores in float32 (no tensor cores), so it cannot come near the
// bf16 tensor-core rate the bound is taken against; wgmma, TMA and a
// pipeline over k-tiles are later work.
//
// The C interface takes every pointer and the stream as void*, sets the
// dynamic shared-memory limit, launches once on that stream and returns
// the first CUDA error. The wrapper (kernels/flash_attention.py) checks
// shapes, dtypes, contiguity and devices before the call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // 16 x 16
constexpr int kBQ = 64;                     // q rows a tile
constexpr int kBK = 64;                     // k rows a tile
constexpr int kRM = kBQ / 16;               // q rows a thread
constexpr int kCN = kBK / 16;               // k rows a thread
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
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

struct Geometry {
  int hq, hkv, sq, sk, causal, window, seq_off;
  float scale;
};

__device__ __forceinline__ bool live(int qi, int ki, const Geometry& g) {
  if (qi >= g.sq || ki >= g.sk) return false;
  const int q_pos = qi + g.seq_off;
  if (g.causal && ki > q_pos) return false;
  if (g.window && q_pos - ki >= g.window) return false;
  return true;
}

// the keys [lo, hi) that rows [q0, q0 + kBQ) can see
__device__ __forceinline__ void k_range(int q0, const Geometry& g, int& lo,
                                        int& hi) {
  const int q_last = min(q0 + kBQ, g.sq) - 1;
  hi = g.causal ? min(g.sk, q_last + g.seq_off + 1) : g.sk;
  lo = g.window ? max(0, q0 + g.seq_off - g.window + 1) : 0;
}

// the queries [lo, hi) that see any of the keys [k0, k0 + kBK)
__device__ __forceinline__ void q_range(int k0, const Geometry& g, int& lo,
                                        int& hi) {
  const int k_last = min(k0 + kBK, g.sk) - 1;
  lo = g.causal ? max(0, k0 - g.seq_off) : 0;
  hi = g.window ? min(g.sq, k_last + g.window - g.seq_off) : g.sq;
}

// rows [row0, row0 + n) of a (rows, D) matrix into shared memory, float32,
// row stride D + 1, zeros past `rows`
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int n, int rows) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < rows ? to_f32(src[(size_t)row * D + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

// ------------------------------------------------------------------ K2f --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Geometry g) {
  constexpr int DS = D + 1, DN = D / 16, PS = kBK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][DS]
  float* k_s = q_s + kBQ * DS;        // [kBK][DS]
  float* v_s = k_s + kBK * DS;        // [kBK][DS]
  float* p_s = v_s + kBK * DS;        // [kBQ][PS]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, q0 = blockIdx.y * kBQ;
  const int b = bh / g.hq, h = bh % g.hq;
  const size_t kvh = (size_t)b * g.hkv + h / (g.hq / g.hkv);
  const T* k_bh = k + kvh * g.sk * D;
  const T* v_bh = v + kvh * g.sk * D;

  stage<T, D>(q_s, q + (size_t)bh * g.sq * D, q0, kBQ, g.sq);
  float m[kRM], l[kRM], acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  k_range(q0, g, lo, hi);
  for (int k0 = lo < hi ? lo / kBK * kBK : hi; k0 < hi; k0 += kBK) {
    __syncthreads();          // the previous tile's readers are done
    stage<T, D>(k_s, k_bh, k0, kBK, g.sk);
    stage<T, D>(v_s, v_bh, k0, kBK, g.sk);
    __syncthreads();

    float s[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[kRM], kb[kCN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qa[i] = q_s[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < kCN; ++j) kb[j] = k_s[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) s[i][j] += qa[i] * kb[j];
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty + 16 * i;
      bool ok[kCN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        ok[j] = live(q0 + r, k0 + tx + 16 * j, g);
        s[i][j] = ok[j] ? s[i][j] * g.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * PS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float vb[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) vb[j] = v_s[c * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float p = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] += p * vb[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.sq) continue;
    const size_t base = ((size_t)bh * g.sq + row) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j) o[base + tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0)
      lse[(size_t)bh * g.sq + row] =
          l[i] > 0.f ? m[i] + logf(denom) : kNegInf;
  }
}

// ------------------------------------------------------------------ K2q --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Geometry g) {
  constexpr int DS = D + 1, DN = D / 16, PS = kBK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][DS]
  float* do_s = q_s + kBQ * DS;       // [kBQ][DS]
  float* k_s = do_s + kBQ * DS;       // [kBK][DS]
  float* v_s = k_s + kBK * DS;        // [kBK][DS]
  float* ds_s = v_s + kBK * DS;       // [kBQ][PS]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, q0 = blockIdx.y * kBQ;
  const int b = bh / g.hq, h = bh % g.hq;
  const size_t kvh = (size_t)b * g.hkv + h / (g.hq / g.hkv);
  const T* k_bh = k + kvh * g.sk * D;
  const T* v_bh = v + kvh * g.sk * D;

  stage<T, D>(q_s, q + (size_t)bh * g.sq * D, q0, kBQ, g.sq);
  stage<float, D>(do_s, dout + (size_t)bh * g.sq * D, q0, kBQ, g.sq);
  float lse_r[kRM], delta_r[kRM], acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < g.sq;
    lse_r[i] = in ? lse[(size_t)bh * g.sq + row] : 0.f;
    delta_r[i] = in ? delta[(size_t)bh * g.sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  k_range(q0, g, lo, hi);
  for (int k0 = lo < hi ? lo / kBK * kBK : hi; k0 < hi; k0 += kBK) {
    __syncthreads();
    stage<T, D>(k_s, k_bh, k0, kBK, g.sk);
    stage<T, D>(v_s, v_bh, k0, kBK, g.sk);
    __syncthreads();

    float s[kRM][kCN], dp[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[kRM], da[kRM], kb[kCN], vb[kCN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        qa[i] = q_s[(ty + 16 * i) * DS + d];
        da[i] = do_s[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        kb[j] = k_s[(tx + 16 * j) * DS + d];
        vb[j] = v_s[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) {
          s[i][j] += qa[i] * kb[j];
          dp[i][j] += da[i] * vb[j];
        }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int c = tx + 16 * j;
        const float p = live(q0 + r, k0 + c, g)
                            ? expf(s[i][j] * g.scale - lse_r[i]) : 0.f;
        ds_s[r * PS + c] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float kb[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) kb[j] = k_s[c * DS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float ds = ds_s[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] += ds * kb[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.sq) continue;
    const size_t base = ((size_t)bh * g.sq + row) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      dq[base + tx + 16 * j] = from_f32<T>(acc[i][j] * g.scale);
  }
}

// ----------------------------------------------------------------- K2kv --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Geometry g) {
  constexpr int DS = D + 1, DN = D / 16, PS = kBQ + 1;
  constexpr int RM = kBK / 16, CN = kBQ / 16;   // k rows, q rows a thread
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kBK][DS]
  float* v_s = k_s + kBK * DS;        // [kBK][DS]
  float* q_s = v_s + kBK * DS;        // [kBQ][DS]
  float* do_s = q_s + kBQ * DS;       // [kBQ][DS]
  float* p_s = do_s + kBQ * DS;       // [kBK][PS], P transposed
  float* ds_s = p_s + kBK * PS;       // [kBK][PS], dS transposed
  float* lse_s = ds_s + kBK * PS;     // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkv = blockIdx.x, k0 = blockIdx.y * kBK;
  const int b = bkv / g.hkv, kv = bkv % g.hkv;
  const int n_g = g.hq / g.hkv;

  stage<T, D>(k_s, k + (size_t)bkv * g.sk * D, k0, kBK, g.sk);
  stage<T, D>(v_s, v + (size_t)bkv * g.sk * D, k0, kBK, g.sk);
  float dk_r[RM][DN], dv_r[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) dk_r[i][j] = dv_r[i][j] = 0.f;

  int lo, hi;
  q_range(k0, g, lo, hi);
  for (int hh = 0; hh < n_g && lo < hi; ++hh) {
    const size_t bh = (size_t)b * g.hq + (size_t)kv * n_g + hh;
    const T* q_bh = q + bh * g.sq * D;
    const float* do_bh = dout + bh * g.sq * D;
    for (int q0 = lo / kBQ * kBQ; q0 < hi; q0 += kBQ) {
      __syncthreads();
      stage<T, D>(q_s, q_bh, q0, kBQ, g.sq);
      stage<float, D>(do_s, do_bh, q0, kBQ, g.sq);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const bool in = q0 + r < g.sq;
        lse_s[r] = in ? lse[bh * g.sq + q0 + r] : 0.f;
        delta_s[r] = in ? delta[bh * g.sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float ka[RM], va[RM], qb[CN], db[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          ka[i] = k_s[(ty + 16 * i) * DS + d];
          va[i] = v_s[(ty + 16 * i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          qb[j] = q_s[(tx + 16 * j) * DS + d];
          db[j] = do_s[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] += ka[i] * qb[j];
            dp[i][j] += va[i] * db[j];
          }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int c = ty + 16 * i;             // key row in the tile
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int r = tx + 16 * j;           // query row in the tile
          const float p = live(q0 + r, k0 + c, g)
                              ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
          p_s[c * PS + r] = p;
          ds_s[c * PS + r] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();

      for (int r = 0; r < kBQ; ++r) {
        float qv[DN], dov[DN];
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          qv[j] = q_s[r * DS + tx + 16 * j];
          dov[j] = do_s[r * DS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = p_s[(ty + 16 * i) * PS + r];
          const float ds = ds_s[(ty + 16 * i) * PS + r];
#pragma unroll
          for (int j = 0; j < DN; ++j) {
            dv_r[i][j] += p * dov[j];
            dk_r[i][j] += ds * qv[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= g.sk) continue;
    const size_t base = ((size_t)bkv * g.sk + row) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      dk[base + tx + 16 * j] = from_f32<T>(dk_r[i][j] * g.scale);
      dv[base + tx + 16 * j] = from_f32<T>(dv_r[i][j]);
    }
  }
}

// ------------------------------------------------------------- launches --

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) +
                          2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o, *lse, *dq, *dk, *dv;
  int b;
  Geometry g;
  cudaStream_t stream;
};

template <typename T, int D>
int run(int which, const Args& a) {
  static_assert(D % 16 == 0, "a thread's columns are tx + 16 j, j < D / 16");
  const dim3 threads(kThreads);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  int err;
  if (which == 0) {
    if ((err = prepare(fwd_kernel<T, D>, fwd_smem<D>()))) return err;
    const dim3 grid(a.b * a.g.hq, (a.g.sq + kBQ - 1) / kBQ);
    fwd_kernel<T, D><<<grid, threads, fwd_smem<D>(), a.stream>>>(
        q, k, v, static_cast<float*>(a.o), static_cast<float*>(a.lse), a.g);
  } else if (which == 1) {
    if ((err = prepare(dq_kernel<T, D>, dq_smem<D>()))) return err;
    const dim3 grid(a.b * a.g.hq, (a.g.sq + kBQ - 1) / kBQ);
    dq_kernel<T, D><<<grid, threads, dq_smem<D>(), a.stream>>>(
        q, k, v, static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.g);
  } else {
    if ((err = prepare(dkv_kernel<T, D>, dkv_smem<D>()))) return err;
    const dim3 grid(a.b * a.g.hkv, (a.g.sk + kBK - 1) / kBK);
    dkv_kernel<T, D><<<grid, threads, dkv_smem<D>(), a.stream>>>(
        q, k, v, static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_d(int which, int d, const Args& a) {
  switch (d) {
    case 32: return run<T, 32>(which, a);
    case 64: return run<T, 64>(which, a);
    case 112: return run<T, 112>(which, a);
    case 128: return run<T, 128>(which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int dtype, int d, const Args& a) {
  if (a.b <= 0 || a.g.hkv <= 0 || a.g.hq % a.g.hkv != 0 || a.g.sq <= 0 ||
      a.g.sk <= 0 || a.g.window < 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return run_d<float>(which, d, a);
    case 1: return run_d<__nv_bfloat16>(which, d, a);
    case 2: return run_d<__half>(which, d, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

Geometry geometry(int hq, int hkv, int sq, int sk, int causal, int window,
                  float scale) {
  return Geometry{hq, hkv, sq, sk, causal, window, sk - sq, scale};
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Each returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int window, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse; a.b = b;
  a.g = geometry(hq, hkv, sq, sk, causal, window, scale);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(0, dtype, d, a);
}

extern "C" int flash_attention_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int sq, int sk, int d, int causal, int window, float scale,
    void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq = dq; a.b = b;
  a.g = geometry(hq, hkv, sq, sk, causal, window, scale);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, dtype, d, a);
}

extern "C" int flash_attention_bwd_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int sq, int sk, int d, int causal, int window, float scale,
    void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dk = dk; a.dv = dv; a.b = b;
  a.g = geometry(hq, hkv, sq, sk, causal, window, scale);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(2, dtype, d, a);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
