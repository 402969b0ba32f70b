// K3 on Hopper: the Mamba-2 SSD chunked scan, forward (K3f) and its
// reversed-recurrence backward (K3b).
//
// Replaces the Pallas kernels of src/repro/kernels/ssd_scan.py:
//   K3f  ssd_scan      / _ssd_kernel      (pallas_call at :143)
//   K3b  ssd_scan_bwd  / _ssd_bwd_kernel  (pallas_call at :278)
// Inputs, as there (each contiguous):
//   x (B, S, H, P) and b, c (B, S, G, N) in float32, bfloat16 or float16
//   (one type), dt (B, S, H) in float32 or x's type, a (H,) float32,
//   initial_state (B, H, P, N) float32. Head h reads group h * G / H; no
//   repeat of b or c is materialized.
//   K3f writes y (B, S, H, P) in x's type, the final state (B, H, P, N) and,
//   when asked, the state entering each chunk (B, H, nc, P, N), float32:
//   the backward's only residual.
//   K3b reads those chunk states, dy (B, S, H, P) and d(final state)
//   (B, H, P, N) in float32, and writes dx, ddt, per-head db and dc
//   (B, S, H, N), per-(b, h) partials of da (B, H) and d(initial_state),
//   all float32. The wrapper reduces db and dc over each group and da over
//   the batch.
// Within a chunk of cl positions, with cs the cumulative sum of dt * a:
//   y_l = sum_{s<=l} (c_l . b_s) e^{cs_l - cs_s} dt_s x_s + e^{cs_l} c_l . S
//   S  <- e^{cs_end} S + sum_l e^{cs_end - cs_l} dt_l x_l b_l^T
// The exponential is taken only under the causal mask (l >= s), where
// cs_l - cs_s <= 0, so no inf ever meets a 0. Positions past S (the ragged
// tail of the last chunk) are loaded as zeros in x, dt, b, c and dy: dt = 0
// keeps the log-decay flat and deposits nothing in the state, and they are
// never stored.
//
// Design. The TPU grid is (B, H, nc) with the chunk axis innermost and
// sequential, the state carried in a revisited output block. Here one CTA
// of 256 threads per (b, h) loops over the chunks (K3b last-first) and
// holds the (P, N) float32 state (K3b: the chunk's entering state and the
// dS carry) in shared memory. No atomics and no pass across CTAs: every
// sum has a fixed order, so the results are deterministic. A whole chunk
// does not fit in shared memory (at cl = 256, N = 128 its b alone is
// 128 KB, its (cl, cl) scores 256 KB), so the intra-chunk products are
// tiled, rows by columns, over the tiles on or below the diagonal only
// (64 x 64 in K3f, 32 x 32 in K3b); only the chunk's vectors (dt, cs and
// their running sums) are kept whole. K3b needs dcs complete over the
// chunk before its reverse cumsum, so it gathers the row sums and the
// column sums of dseg in two vectors and finishes the chunk's per-position
// terms (ddt, the da partial) in one pass at its end. dx, db and dc are
// summed over tile pairs in place in their float32 outputs, which each CTA
// owns for its (b, h); each element always by the same thread.
// Rows are padded to N + 1 and P + 1 floats so the rows a warp reads sit on
// distinct banks.
//
// Bound. Per chunk and head the work is ~cl^2 (N + P) / 2 + 2 cl P N
// multiply-adds forward (three times that backward): the operations bound
// it. This first version computes on the CUDA cores in float32, one output
// element per thread at a time, with B * H CTAs on 132 SMs (24 at a
// mamba2-130m prefill): latency-bound, far from the bound. wgmma, TMA and a
// chunk-parallel schedule are later work.
//
// The C interface takes every pointer and the stream as void*, sets the
// dynamic shared-memory limit, launches once and returns the first CUDA
// error. The wrapper (kernels/ssd_scan.py) checks shapes, dtypes,
// contiguity, devices and the shared memory before the call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFT = 64;        // K3f tile rows
constexpr int kBT = 32;        // K3b tile rows

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int B, S, H, P, G, N, cl, nc;
};

// rows [r0, r0 + rows) of the chunk at t0 into dst (row stride ld) as
// float32, zeros past the chunk's end or past S. src points at position 0
// of this (b, head or group); row_stride is the distance between positions.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          size_t row_stride, int width,
                                          int t0, int r0, int rows,
                                          const Dims& d) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, col = e - r * width;
    const int l = r0 + r, t = t0 + l;
    dst[r * ld + col] = (l < d.cl && t < d.S)
                            ? to_f32(src[(size_t)t * row_stride + col])
                            : 0.f;
  }
}

// the chunk's dt (zeros past S) and its cumulative log-decay
template <typename TD>
__device__ __forceinline__ void chunk_decay(float* dt_s, float* cs,
                                            const TD* __restrict__ dtb,
                                            float av, int t0, const Dims& d) {
  for (int l = threadIdx.x; l < d.cl; l += kThreads) {
    const int t = t0 + l;
    dt_s[l] = t < d.S ? to_f32(dtb[(size_t)t * d.H]) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int l = 0; l < d.cl; ++l) {
      acc += dt_s[l] * av;
      cs[l] = acc;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------ K3f --

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ final_state,
               float* __restrict__ chunk_states, Dims d) {
  const int bi = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int g = h * d.G / d.H;
  const int P = d.P, N = d.N, cl = d.cl;
  const int NS = N + 1, PS = P + 1, TS = kFT + 1;
  extern __shared__ float smem[];
  float* st = smem;                   // [P][NS] the carried state
  float* c_s = st + P * NS;           // [kFT][NS] C rows of a row tile
  float* b_s = c_s + kFT * NS;        // [kFT][NS] B rows of a column tile
  float* x_s = b_s + kFT * NS;        // [kFT][PS] x rows of a column tile
  float* att = x_s + kFT * PS;        // [kFT][TS] the tile's scores
  float* y_acc = att + kFT * TS;      // [kFT][P] the row tile's output
  float* dt_s = y_acc + kFT * P;      // [cl]
  float* cs = dt_s + cl;              // [cl]

  const float av = a[h];
  const size_t xrow = (size_t)d.H * P, brow = (size_t)d.G * N;
  const T* xb = x + (size_t)bi * d.S * xrow + (size_t)h * P;
  const TD* dtb = dt + (size_t)bi * d.S * d.H + h;
  const T* bb = b + (size_t)bi * d.S * brow + (size_t)g * N;
  const T* cb = c + (size_t)bi * d.S * brow + (size_t)g * N;
  T* yb = y + (size_t)bi * d.S * xrow + (size_t)h * P;
  const size_t bh = (size_t)bi * d.H + h;
  const int PN = P * N;

  for (int e = threadIdx.x; e < PN; e += kThreads)
    st[(e / N) * NS + e % N] = init[bh * PN + e];

  for (int ci = 0; ci < d.nc; ++ci) {
    const int t0 = ci * cl;
    __syncthreads();
    if (chunk_states != nullptr)      // the state entering this chunk
      for (int e = threadIdx.x; e < PN; e += kThreads)
        chunk_states[(bh * d.nc + ci) * PN + e] = st[(e / N) * NS + e % N];
    chunk_decay(dt_s, cs, dtb, av, t0, d);

    for (int l0 = 0; l0 < cl; l0 += kFT) {
      load_rows(c_s, NS, cb, brow, N, t0, l0, kFT, d);
      __syncthreads();
      // inter-chunk: y_l = e^{cs_l} c_l . S
      for (int e = threadIdx.x; e < kFT * P; e += kThreads) {
        const int l = e / P, p = e - l * P;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += c_s[l * NS + n] * st[p * NS + n];
        y_acc[e] = l0 + l < cl ? expf(cs[l0 + l]) * acc : 0.f;
      }
      // intra-chunk, over the column tiles on or below the diagonal
      for (int s0 = 0; s0 <= l0; s0 += kFT) {
        __syncthreads();
        load_rows(b_s, NS, bb, brow, N, t0, s0, kFT, d);
        load_rows(x_s, PS, xb, xrow, P, t0, s0, kFT, d);
        __syncthreads();
        for (int e = threadIdx.x; e < kFT * kFT; e += kThreads) {
          const int l = e / kFT, s = e - l * kFT;
          const int lg = l0 + l, sg = s0 + s;
          float v = 0.f;
          if (lg >= sg && lg < cl) {   // exp only under the mask
            float acc = 0.f;
            for (int n = 0; n < N; ++n) acc += c_s[l * NS + n] * b_s[s * NS + n];
            v = acc * expf(cs[lg] - cs[sg]) * dt_s[sg];
          }
          att[l * TS + s] = v;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kFT * P; e += kThreads) {
          const int l = e / P, p = e - l * P;
          float acc = 0.f;
          for (int s = 0; s < kFT; ++s) acc += att[l * TS + s] * x_s[s * PS + p];
          y_acc[e] += acc;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kFT * P; e += kThreads) {
        const int l = e / P, p = e - l * P;
        const int t = t0 + l0 + l;
        if (l0 + l < cl && t < d.S)
          yb[(size_t)t * xrow + p] = from_f32<T>(y_acc[e]);
      }
      __syncthreads();
    }

    // state update: S <- e^{cs_end} S + sum_l w_l x_l b_l^T,
    // w_l = dt_l e^{cs_end - cs_l}
    const float cs_end = cs[cl - 1];
    const float e_end = expf(cs_end);
    for (int e = threadIdx.x; e < PN; e += kThreads)
      st[(e / N) * NS + e % N] *= e_end;
    for (int l0 = 0; l0 < cl; l0 += kFT) {
      __syncthreads();
      load_rows(b_s, NS, bb, brow, N, t0, l0, kFT, d);
      load_rows(x_s, PS, xb, xrow, P, t0, l0, kFT, d);
      __syncthreads();
      for (int e = threadIdx.x; e < kFT * P; e += kThreads) {
        const int l = e / P, p = e - l * P;
        x_s[l * PS + p] *= l0 + l < cl
                               ? dt_s[l0 + l] * expf(cs_end - cs[l0 + l])
                               : 0.f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < PN; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float acc = 0.f;
        for (int l = 0; l < kFT; ++l) acc += x_s[l * PS + p] * b_s[l * NS + n];
        st[p * NS + n] += acc;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < PN; e += kThreads)
    final_state[bh * PN + e] = st[(e / N) * NS + e % N];
}

// ------------------------------------------------------------------ K3b --

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, const float* __restrict__ states,
               const float* __restrict__ dy, const float* __restrict__ dfinal,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dbh, float* __restrict__ dch,
               float* __restrict__ dap, float* __restrict__ dinit, Dims d) {
  const int bi = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int g = h * d.G / d.H;
  const int P = d.P, N = d.N, cl = d.cl;
  const int NS = N + 1, PS = P + 1, TS = kBT + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* s_in = smem;                 // [P][NS] the state entering the chunk
  float* ds = s_in + P * NS;          // [P][NS] the dS carry
  float* c_s = ds + P * NS;           // [kBT][NS] C rows of a row tile
  float* dy_s = c_s + kBT * NS;       // [kBT][PS] dy rows of a row tile
  float* b_s = dy_s + kBT * PS;       // [kBT][NS] B rows of a column tile
  float* x_s = b_s + kBT * NS;        // [kBT][PS] x rows of a column tile
  float* att = x_s + kBT * PS;        // [kBT][TS]
  float* dcb = att + kBT * TS;        // [kBT][TS]
  float* q = dcb + kBT * TS;          // [kBT][TS] datt * cb * decay
  float* red = q + kBT * TS;          // [kThreads]
  float* dt_s = red + kThreads;       // [cl] each
  float* cs = dt_s + cl;
  float* ecs = cs + cl;               // e^{cs_l}
  float* w = ecs + cl;                // dt_l e^{cs_end - cs_l}
  float* dcs_row = w + cl;            // row sums of dseg (+ the y_off term)
  float* dcs_col = dcs_row + cl;      // minus column sums of dseg
  float* ddt_col = dcs_col + cl;      // column sums of datt * cb * decay
  float* dw = ddt_col + cl;

  const float av = a[h];
  const size_t xrow = (size_t)d.H * P, brow = (size_t)d.G * N;
  const size_t hrow = (size_t)d.H * N;          // dbh / dch positions
  const size_t xoff = (size_t)bi * d.S * xrow + (size_t)h * P;
  const size_t hoff = (size_t)bi * d.S * hrow + (size_t)h * N;
  const T* xb = x + xoff;
  const TD* dtb = dt + (size_t)bi * d.S * d.H + h;
  const T* bb = b + (size_t)bi * d.S * brow + (size_t)g * N;
  const T* cb = c + (size_t)bi * d.S * brow + (size_t)g * N;
  const float* dyb = dy + xoff;
  float* dxb = dx + xoff;
  float* dbb = dbh + hoff;
  float* dcb_g = dch + hoff;
  const size_t bh = (size_t)bi * d.H + h;
  const int PN = P * N;

  for (int e = tid; e < PN; e += kThreads)
    ds[(e / N) * NS + e % N] = dfinal[bh * PN + e];
  float dap_acc = 0.f;                // thread 0's

  for (int rc = d.nc - 1; rc >= 0; --rc) {
    const int t0 = rc * cl;
    const int n_pos = min(cl, d.S - t0);      // positions stored
    __syncthreads();
    for (int e = tid; e < PN; e += kThreads)
      s_in[(e / N) * NS + e % N] = states[(bh * d.nc + rc) * PN + e];
    for (int l = tid; l < cl; l += kThreads)
      dcs_row[l] = dcs_col[l] = ddt_col[l] = dw[l] = 0.f;
    for (int e = tid; e < n_pos * P; e += kThreads)
      dxb[(size_t)(t0 + e / P) * xrow + e % P] = 0.f;
    for (int e = tid; e < n_pos * N; e += kThreads) {
      const size_t i = (size_t)(t0 + e / N) * hrow + e % N;
      dbb[i] = 0.f;
      dcb_g[i] = 0.f;
    }
    chunk_decay(dt_s, cs, dtb, av, t0, d);
    const float cs_end = cs[cl - 1];
    const float e_end = expf(cs_end);
    for (int l = tid; l < cl; l += kThreads) {
      ecs[l] = expf(cs[l]);
      w[l] = dt_s[l] * expf(cs_end - cs[l]);
    }
    __syncthreads();

    for (int l0 = 0; l0 < cl; l0 += kBT) {
      __syncthreads();
      load_rows(c_s, NS, cb, brow, N, t0, l0, kBT, d);
      load_rows(dy_s, PS, dyb, xrow, P, t0, l0, kBT, d);
      __syncthreads();
      // the inter-chunk term y_off_l = e^{cs_l} S_in c_l: its dcs, one
      // warp a row, and its dc
      for (int l = warp; l < kBT; l += kWarps) {
        const int lg = l0 + l;
        if (lg >= cl) continue;
        float acc = 0.f;
        for (int p = lane; p < P; p += 32) {
          float yo = 0.f;
          for (int n = 0; n < N; ++n) yo += c_s[l * NS + n] * s_in[p * NS + n];
          acc += dy_s[l * PS + p] * yo;
        }
        acc = warp_sum(acc);
        if (lane == 0) dcs_row[lg] += ecs[lg] * acc;
      }
      for (int e = tid; e < kBT * N; e += kThreads) {
        const int l = e / N, n = e - l * N;
        const int lg = l0 + l;
        if (lg >= n_pos) continue;
        float acc = 0.f;
        for (int p = 0; p < P; ++p) acc += dy_s[l * PS + p] * s_in[p * NS + n];
        dcb_g[(size_t)(t0 + lg) * hrow + n] += ecs[lg] * acc;
      }

      for (int s0 = 0; s0 <= l0; s0 += kBT) {
        __syncthreads();
        load_rows(b_s, NS, bb, brow, N, t0, s0, kBT, d);
        load_rows(x_s, PS, xb, xrow, P, t0, s0, kBT, d);
        __syncthreads();
        for (int e = tid; e < kBT * kBT; e += kThreads) {
          const int l = e / kBT, s = e - l * kBT;
          const int lg = l0 + l, sg = s0 + s;
          float v_att = 0.f, v_dcb = 0.f, v_q = 0.f;
          if (lg >= sg && lg < cl) {   // exp only under the mask
            float cbv = 0.f, datt = 0.f;
            for (int n = 0; n < N; ++n) cbv += c_s[l * NS + n] * b_s[s * NS + n];
            for (int p = 0; p < P; ++p) datt += dy_s[l * PS + p] * x_s[s * PS + p];
            const float dec = expf(cs[lg] - cs[sg]);
            v_att = cbv * dec * dt_s[sg];
            v_dcb = datt * dec * dt_s[sg];
            v_q = datt * cbv * dec;
          }
          att[l * TS + s] = v_att;
          dcb[l * TS + s] = v_dcb;
          q[l * TS + s] = v_q;
        }
        __syncthreads();
        if (tid < kBT) {                        // row sums of dseg
          const int lg = l0 + tid;
          if (lg < cl) {
            float acc = 0.f;
            for (int s = 0; s < kBT && s0 + s < cl; ++s)
              acc += q[tid * TS + s] * dt_s[s0 + s];
            dcs_row[lg] += acc;
          }
        } else if (tid < 2 * kBT) {             // column sums
          const int s = tid - kBT, sg = s0 + s;
          if (sg < cl) {
            float acc = 0.f;
            for (int l = 0; l < kBT; ++l) acc += q[l * TS + s];
            ddt_col[sg] += acc;
            dcs_col[sg] -= dt_s[sg] * acc;
          }
        }
        // dx_s += sum_l att[l, s] dy_l;  db_s += sum_l dcb[l, s] c_l
        for (int e = tid; e < kBT * P; e += kThreads) {
          const int s = e / P, p = e - s * P;
          if (s0 + s >= n_pos) continue;
          float acc = 0.f;
          for (int l = 0; l < kBT; ++l) acc += att[l * TS + s] * dy_s[l * PS + p];
          dxb[(size_t)(t0 + s0 + s) * xrow + p] += acc;
        }
        for (int e = tid; e < kBT * N; e += kThreads) {
          const int s = e / N, n = e - s * N;
          if (s0 + s >= n_pos) continue;
          float acc = 0.f;
          for (int l = 0; l < kBT; ++l) acc += dcb[l * TS + s] * c_s[l * NS + n];
          dbb[(size_t)(t0 + s0 + s) * hrow + n] += acc;
        }
        // dc_l += sum_s dcb[l, s] b_s
        for (int e = tid; e < kBT * N; e += kThreads) {
          const int l = e / N, n = e - l * N;
          if (l0 + l >= n_pos) continue;
          float acc = 0.f;
          for (int s = 0; s < kBT; ++s) acc += dcb[l * TS + s] * b_s[s * NS + n];
          dcb_g[(size_t)(t0 + l0 + l) * hrow + n] += acc;
        }
        if (s0 != l0) continue;
        // the state-update terms of the row tile (its b and x are loaded):
        // dx_l += w_l dS b_l;  db_l += w_l dS^T x_l;  dw_l = b_l . dS^T x_l
        for (int e = tid; e < kBT * P; e += kThreads) {
          const int l = e / P, p = e - l * P;
          if (l0 + l >= n_pos) continue;
          float acc = 0.f;
          for (int n = 0; n < N; ++n) acc += b_s[l * NS + n] * ds[p * NS + n];
          dxb[(size_t)(t0 + l0 + l) * xrow + p] += w[l0 + l] * acc;
        }
        for (int e = tid; e < kBT * N; e += kThreads) {
          const int l = e / N, n = e - l * N;
          if (l0 + l >= n_pos) continue;
          float acc = 0.f;
          for (int p = 0; p < P; ++p) acc += x_s[l * PS + p] * ds[p * NS + n];
          dbb[(size_t)(t0 + l0 + l) * hrow + n] += w[l0 + l] * acc;
        }
        for (int l = warp; l < kBT; l += kWarps) {
          const int lg = l0 + l;
          if (lg >= cl) continue;
          float acc = 0.f;
          for (int n = lane; n < N; n += 32) {
            float sx = 0.f;
            for (int p = 0; p < P; ++p) sx += x_s[l * PS + p] * ds[p * NS + n];
            acc += sx * b_s[l * NS + n];
          }
          acc = warp_sum(acc);
          if (lane == 0) dw[lg] = acc;
        }
      }
    }
    __syncthreads();

    // sum(dS_out * S_in), a fixed-order tree over the threads
    float part = 0.f;
    for (int e = tid; e < PN; e += kThreads) {
      const int i = (e / N) * NS + e % N;
      part += ds[i] * s_in[i];
    }
    red[tid] = part;
    __syncthreads();
    for (int o = kThreads / 2; o > 0; o >>= 1) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
    if (tid == 0) {
      // dcs = rows - columns of dseg + the y_off term - dw w, plus dcs_end
      // at the chunk's last position; dda is its reverse cumsum
      float dww = 0.f;
      for (int l = 0; l < cl; ++l) dww += dw[l] * w[l];
      const float dcs_end = dww + e_end * red[0];
      float dda = 0.f;
      for (int l = cl - 1; l >= 0; --l) {
        dda += dcs_row[l] + dcs_col[l] - dw[l] * w[l]
               + (l == cl - 1 ? dcs_end : 0.f);
        // ddt = ddt_att + ddt_w + dda a, kept in dcs_row
        dcs_row[l] = ddt_col[l] + dw[l] * expf(cs_end - cs[l]) + dda * av;
        dap_acc += dda * dt_s[l];
      }
    }
    for (int e = tid; e < PN; e += kThreads)
      ds[(e / N) * NS + e % N] *= e_end;
    __syncthreads();
    for (int l = tid; l < n_pos; l += kThreads)
      ddt[((size_t)bi * d.S + t0 + l) * d.H + h] = dcs_row[l];
    // the carry for the chunk before: dS <- e^{cs_end} dS + sum_l ecs_l dy_l c_l^T
    for (int l0 = 0; l0 < cl; l0 += kBT) {
      __syncthreads();
      load_rows(c_s, NS, cb, brow, N, t0, l0, kBT, d);
      load_rows(dy_s, PS, dyb, xrow, P, t0, l0, kBT, d);
      __syncthreads();
      for (int e = tid; e < PN; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float acc = 0.f;
        for (int l = 0; l < kBT && l0 + l < cl; ++l)
          acc += ecs[l0 + l] * dy_s[l * PS + p] * c_s[l * NS + n];
        ds[p * NS + n] += acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < PN; e += kThreads)
    dinit[bh * PN + e] = ds[(e / N) * NS + e % N];
  if (tid == 0) dap[bh] = dap_acc;
}

// ------------------------------------------------------------- launches --

// dynamic shared memory of one CTA (kernels/ssd_scan.py's smem_bytes
// mirrors these and checks them against the limit before a launch)
size_t fwd_smem(int P, int N, int cl) {
  return sizeof(float) * ((size_t)P * (N + 1) + 2 * kFT * (N + 1) +
                          kFT * (P + 1) + kFT * (kFT + 1) + kFT * P + 2 * cl);
}

size_t bwd_smem(int P, int N, int cl) {
  return sizeof(float) * (2 * (size_t)P * (N + 1) + 2 * kBT * (N + 1) +
                          2 * kBT * (P + 1) + 3 * kBT * (kBT + 1) + kThreads +
                          8 * cl);
}

struct Args {
  const void *x, *dt, *a, *b, *c, *init, *states, *dy, *dfinal;
  void *y, *final_state, *chunk_states, *dx, *ddt, *dbh, *dch, *dap, *dinit;
  Dims d;
  cudaStream_t stream;
};

template <typename T, typename TD>
int run(int which, const Args& a) {
  const dim3 grid(a.d.B * a.d.H), threads(kThreads);
  const T* x = static_cast<const T*>(a.x);
  const TD* dt = static_cast<const TD*>(a.dt);
  const float* av = static_cast<const float*>(a.a);
  const T* b = static_cast<const T*>(a.b);
  const T* c = static_cast<const T*>(a.c);
  int err;
  if (which == 0) {
    const size_t smem = fwd_smem(a.d.P, a.d.N, a.d.cl);
    if ((err = (int)cudaFuncSetAttribute(
             ssd_fwd_kernel<T, TD>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    ssd_fwd_kernel<T, TD><<<grid, threads, smem, a.stream>>>(
        x, dt, av, b, c, static_cast<const float*>(a.init),
        static_cast<T*>(a.y), static_cast<float*>(a.final_state),
        static_cast<float*>(a.chunk_states), a.d);
  } else {
    const size_t smem = bwd_smem(a.d.P, a.d.N, a.d.cl);
    if ((err = (int)cudaFuncSetAttribute(
             ssd_bwd_kernel<T, TD>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    ssd_bwd_kernel<T, TD><<<grid, threads, smem, a.stream>>>(
        x, dt, av, b, c, static_cast<const float*>(a.states),
        static_cast<const float*>(a.dy), static_cast<const float*>(a.dfinal),
        static_cast<float*>(a.dx), static_cast<float*>(a.ddt),
        static_cast<float*>(a.dbh), static_cast<float*>(a.dch),
        static_cast<float*>(a.dap), static_cast<float*>(a.dinit), a.d);
  }
  return (int)cudaGetLastError();
}

// dt is float32 (dt_dtype 0) or x's type (dt_dtype == dtype)
template <typename T>
int run_dt(int which, int dtype, int dt_dtype, const Args& a) {
  if (dt_dtype == 0) return run<T, float>(which, a);
  if (dt_dtype == dtype) return run<T, T>(which, a);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int which, int dtype, int dt_dtype, const Args& a) {
  const Dims& d = a.d;
  if (d.B <= 0 || d.S <= 0 || d.H <= 0 || d.P <= 0 || d.G <= 0 || d.N <= 0 ||
      d.H % d.G != 0 || d.cl <= 0 || d.nc != (d.S + d.cl - 1) / d.cl)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return run_dt<float>(which, dtype, dt_dtype, a);
    case 1: return run_dt<__nv_bfloat16>(which, dtype, dt_dtype, a);
    case 2: return run_dt<__half>(which, dtype, dt_dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

Dims dims(int B, int S, int H, int P, int G, int N, int cl) {
  return Dims{B, S, H, P, G, N, cl, cl > 0 ? (S + cl - 1) / cl : 0};
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x, b, c); dt_dtype 0 or dtype.
// chunk_states may be null. Each returns a cudaError_t.
extern "C" int ssd_scan_fwd_launch(int dtype, int dt_dtype, const void* x,
                                   const void* dt, const void* a,
                                   const void* b, const void* c,
                                   const void* init, void* y,
                                   void* final_state, void* chunk_states,
                                   int B, int S, int H, int P, int G, int N,
                                   int cl, void* stream) {
  Args a_{};
  a_.x = x; a_.dt = dt; a_.a = a; a_.b = b; a_.c = c; a_.init = init;
  a_.y = y; a_.final_state = final_state; a_.chunk_states = chunk_states;
  a_.d = dims(B, S, H, P, G, N, cl);
  a_.stream = static_cast<cudaStream_t>(stream);
  return dispatch(0, dtype, dt_dtype, a_);
}

extern "C" int ssd_scan_bwd_launch(int dtype, int dt_dtype, const void* x,
                                   const void* dt, const void* a,
                                   const void* b, const void* c,
                                   const void* chunk_states, const void* dy,
                                   const void* dfinal, void* dx, void* ddt,
                                   void* dbh, void* dch, void* dap,
                                   void* dinit, int B, int S, int H, int P,
                                   int G, int N, int cl, void* stream) {
  Args a_{};
  a_.x = x; a_.dt = dt; a_.a = a; a_.b = b; a_.c = c;
  a_.states = chunk_states; a_.dy = dy; a_.dfinal = dfinal;
  a_.dx = dx; a_.ddt = ddt; a_.dbh = dbh; a_.dch = dch; a_.dap = dap;
  a_.dinit = dinit;
  a_.d = dims(B, S, H, P, G, N, cl);
  a_.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, dtype, dt_dtype, a_);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
