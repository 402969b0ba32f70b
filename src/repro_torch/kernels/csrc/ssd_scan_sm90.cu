// K3f on Hopper's tensor cores: the Mamba-2 SSD chunked scan forward,
// chunk-parallel, for bfloat16 and float16 at head dim P 64 and state
// width N 64 or 128 (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py:
//   K3f  ssd_scan / _ssd_kernel (pallas_call at :143, kernel at :64).
// It computes what ssd_scan.cu's ssd_fwd_kernel computes, with the same
// contract: x (B, S, H, P) and b, c (B, S, G, N) contiguous in one 16-bit
// type, dt (B, S, H) in float32 or that type, a (H,) float32, an optional
// initial state (B, H, P, N) float32 (null: zeros); head h reads group
// h / (H / G). Within a chunk of cl positions, cs the cumulative sum of
// dt * a:
//   y_l = sum_{s<=l} (c_l . b_s) e^{cs_l - cs_s} dt_s x_s + e^{cs_l} c_l . S
//   S  <- e^{cs_end} S + sum_l e^{cs_end - cs_l} dt_l x_l b_l^T
// y is written in x's type, the final state and the state entering each
// chunk (B, H, nc, P, N) in float32 (the backward's only residual). Rows
// past S (the ragged tail of the last chunk, or a chunk clamped to S) read
// as zeros, dt = 0 there deposits nothing, and they are never stored; the
// exponential is taken only under the causal mask (l >= s). The wrapper
// (kernels/ssd_scan.py, fwd_route) sends float32 and every other P or N
// to ssd_scan.cu's first version, which a direct call may also name
// (route "simt") to time it beside this one.
//
// Design. The TPU walks the chunks in order with the state in VMEM; the
// first version here did the same in one CTA per (b, h), B * H CTAs (24 at
// one 4096-token sequence) each serial over its chunks on the CUDA cores.
// This route splits the work in three launches on one stream, of which
// only the middle one is sequential in the chunks, and it only moves
// state-sized float32 vectors:
//   A  ssd_sm90_chunk_state_kernel, one CTA per (chunk, head, batch): the
//      chunk's dt, cs (a warp scan, fixed order) and w_l = dt_l
//      e^{cs_end - cs_l}; it writes cs and e^{cs_end} to the wrapper's
//      scratch and the chunk's deposit X^T (w . B), a (P, N) product over
//      the chunk's rows, into the states buffer.
//   B  ssd_sm90_state_pass_kernel, one thread a float4 of (P, N) for each
//      (b, h): S_in[c] = S, S = e^{cs_end,c} S + deposit_c over the chunks
//      in order, in place (the deposit is read before its slot takes the
//      entering state), then the final state.
//   C  ssd_sm90_chunk_scan_kernel, one CTA per (b, h, chunk, 64-row
//      block), longest row blocks first: y_blk = e^{cs_l} (C_blk S_in^T)
//      + sum over the column tiles s0 <= l0 of att X_s, att = (C_blk
//      B_s^T) e^{cs_l - cs_s} dt_s under the mask, as K2f's forward does
//      QK^T and PV.
// Every product is on wgmma (sm90_common.cuh), float32 accumulators:
//   A  m64nNk16 SS with both operands MN-major (transposed): (w . X)^T
//      from the x rows as stored (P contiguous), B from the b rows (N
//      contiguous);
//   C  C_blk B_s^T and C_blk S_in^T: m64n64k16 SS, K-major (N contiguous);
//      att X_s: m64n64k16 RS, att packed from the accumulators, X_s
//      MN-major (transpose-B), exactly K2f's PV.
// The 16-bit roundings, which the plain version emulates
// (ssd_scan_fwd_chunked_plain(emulate=dtype)):
//   * w . X (the deposit's float32 operand) is split into hi = rn16(w x)
//     and lo = rn16(w x - hi), two wgmmas into one accumulator, so the
//     deposit keeps ~16 significant bits (one rounding of w . X would
//     move the states by ~4e-3 of their largest entry in bfloat16; the
//     states and final state are held to 1e-4); w . X, not w . B, is
//     split: at N 128 it is the smaller operand;
//   * att is rounded to 16 bits before att X_s, and S_in before C S_in^T
//     (y is stored in 16 bits, held to 1e-2 of its largest entry: each
//     rounding moves an entry by at most u sum|terms|, u = 2^-9 bf16,
//     2^-12 fp16).
// The state pass in B and every sum stay float32; no atomics, every sum
// in a fixed order, so two calls agree bit for bit.
// Tiles move by 16-byte cp.async (zero-filled past the valid rows) or, for
// the operands converted on the way (w . X, S_in), by loads and st.shared,
// into the 128-byte swizzled layout TMA would write (sw128); phase C keeps
// a two-stage ring of column tiles, the next tile's copies in flight under
// this tile's products. Not TMA: the tiles are rows of one head strided by
// H P or G N elements, and encoding tensor maps on the host each call was
// measured (K2's backward at S 256) to outlast kernels of this size.
//
// Bound on an H100 (989 TFLOP/s bf16/fp16, 3.35 TB/s): bytes, at every
// main-path shape (chip_smoke.py's k3_work): a chunk of 256 at P 64, N 128
// does ~2 (N + P) flops a live pair and 4 P N a position, ~1 flop a byte
// of x, b, c and the float32 states it must move, far under the ~295 where
// the tensor cores would be the limit. So the design aims at the bytes:
// every input read once per CTA that needs it, b and c shared by the heads
// of a group through L2 (the grid walks heads fastest), the float32 states
// written by A and rewritten in place by B, the only traffic beyond the
// inputs and y. Left for later: a persistent scheduler, fusing A to C,
// float32 on TF32, other P and N.
//
// The C entry checks the shapes, sets each kernel's dynamic shared-memory
// limit, launches A, B and C on the given stream and returns the first
// CUDA error.

#include "sm90_common.cuh"

namespace {

constexpr int kP = 64;                     // the head dim the route takes
constexpr int kThreads = 128;              // one warpgroup, every phase
constexpr int kRows = 64;                  // a tile's rows: wgmma's M
constexpr uint32_t kTile = kRows * 128;    // bytes of a (64, 64) tile
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int B, S, H, G, N, cl, nc;
};

__device__ __forceinline__ float to_f32(uint16_t v, Bf16) {
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float to_f32(uint16_t v, F16) {
  return __half2float(__ushort_as_half(v));
}
__device__ __forceinline__ float round16(float v, Bf16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round16(float v, F16) {
  return __half2float(__float2half(v));
}

// dt in float32 or in x's 16-bit type
template <typename Tag>
__device__ __forceinline__ float ld_dt(const float* p, size_t i) {
  return p[i];
}
template <typename Tag>
__device__ __forceinline__ float ld_dt(const uint16_t* p, size_t i) {
  return to_f32(p[i], Tag{});
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 8 16-bit values times w, split into hi = rn16(v) and lo = rn16(v - hi)
template <typename Tag>
__device__ __forceinline__ void split_scaled(const uint4 u, float w, uint4& hi,
                                             uint4& lo) {
  const uint32_t in[4] = {u.x, u.y, u.z, u.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v0 = to_f32((uint16_t)(in[k] & 0xffffu), Tag{}) * w;
    const float v1 = to_f32((uint16_t)(in[k] >> 16), Tag{}) * w;
    const float h0 = round16(v0, Tag{}), h1 = round16(v1, Tag{});
    h[k] = pack2(h0, h1, Tag{});
    l[k] = pack2(v0 - h0, v1 - h1, Tag{});
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// rows [r0, r0 + 64) of a chunk's (rows, 8 W) 16-bit operand into W / 8
// swizzled (64, 64) tiles at dst, by cp.async; rows at or past kv read as
// zeros. src points at the chunk's row 0, rows row_stride elements apart.
template <int W>
__device__ __forceinline__ void load_rows(uint32_t dst, const uint16_t* src,
                                          size_t row_stride, int r0, int kv) {
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W, j = e % W;
    const int l = r0 + r;
    const bool ok = l < kv;
    cp_async16(dst + (j / 8) * kTile + sw128(r, j % 8),
               src + (ok ? (size_t)l * row_stride + 8 * j : 0), ok);
  }
}

// --------------------------------------------------- A: chunk states --

template <typename Tag, int N, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_sm90_chunk_state_kernel(const uint16_t* __restrict__ x,
                            const TD* __restrict__ dt,
                            const float* __restrict__ a,
                            const uint16_t* __restrict__ b,
                            float* __restrict__ states,
                            float* __restrict__ cs_out,
                            float* __restrict__ decay, Dims d) {
  constexpr int NH = N / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t xh_s = base;                 // rn16(w x), rows l
  const uint32_t xl_s = xh_s + kTile;         // rn16(w x - hi)
  const uint32_t b_s = xl_s + kTile;          // [NH] tiles of b rows
  float* const dt_s =
      reinterpret_cast<float*>(smem_raw + (b_s + NH * kTile - raw));
  float* const cs_s = dt_s + d.cl;
  float* const w_s = cs_s + d.cl;

  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);          // the chunk's rows in S
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = (size_t)bi * d.H + h;
  const float av = a[h];

  for (int l = tid; l < d.cl; l += kThreads)
    dt_s[l] = l < kv ? ld_dt<Tag>(dt, ((size_t)bi * d.S + t0 + l) * d.H + h)
                     : 0.f;
  __syncthreads();
  if (warp == 0) {
    // cs, inclusive: each lane sums a run of consecutive positions, a
    // shuffle scan gives each run its offset, in a fixed order
    const int per = (d.cl + 31) / 32, l0 = lane * per;
    float run = 0.f;
    for (int k = 0; k < per && l0 + k < d.cl; ++k) run += dt_s[l0 + k] * av;
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    float acc = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) acc = 0.f;
    for (int k = 0; k < per && l0 + k < d.cl; ++k) {
      acc += dt_s[l0 + k] * av;
      cs_s[l0 + k] = acc;
    }
  }
  __syncthreads();
  const float cs_end = cs_s[d.cl - 1];
  float* const cs_g = cs_out + (bh * d.nc + c) * d.cl;
  for (int l = tid; l < d.cl; l += kThreads) {
    cs_g[l] = cs_s[l];
    w_s[l] = dt_s[l] * expf(cs_end - cs_s[l]);
  }
  if (tid == 0) decay[bh * d.nc + c] = expf(cs_end);
  __syncthreads();

  // the deposit X^T (w . B): (P, N), over the chunk's rows 64 at a time
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const uint16_t* const xb = x + ((size_t)bi * d.S + t0) * xrow +
                             (size_t)h * kP;
  const uint16_t* const bb = b + ((size_t)bi * d.S + t0) * brow +
                             (size_t)g * N;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < kv; r0 += kRows) {
    if (r0) __syncthreads();       // every warp is past the last products
    load_rows<8 * NH>(b_s, bb, brow, r0, kv);
    cp_async_commit();
    for (int e = tid; e < kRows * 8; e += kThreads) {
      const int r = e / 8, j = e % 8;
      const int l = r0 + r;
      uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
      if (l < kv)
        split_scaled<Tag>(
            *reinterpret_cast<const uint4*>(xb + (size_t)l * xrow + 8 * j),
            w_s[l], hi, lo);
      st_shared16(xh_s + sw128(r, j), hi);
      st_shared16(xl_s + sw128(r, j), lo);
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t bd = desc_sw128(b_s + kk * 16 * 128, kTile, 1024);
      wgmma_ss<1, 1>(acc, desc_sw128(xh_s + kk * 16 * 128, kTile, 1024), bd,
                     1, Tag{});
      wgmma_ss<1, 1>(acc, desc_sw128(xl_s + kk * 16 * 128, kTile, 1024), bd,
                     1, Tag{});
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  // acc[i] is row p = 16 warp + lane / 4 + 8 ((i / 2) % 2), column
  // n = 8 (i / 4) + 2 (lane % 4) + i % 2
  float* const dep = states + (bh * d.nc + c) * (size_t)(kP * N);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 16 * warp + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dep + (size_t)p * N + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ----------------------------------------------------- B: state pass --

__global__ void __launch_bounds__(kThreads)
ssd_sm90_state_pass_kernel(const float* __restrict__ init,
                           const float* __restrict__ decay, float* states,
                           float* __restrict__ final_state, int nc,
                           int pn4) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;   // a float4 of (P, N)
  if (e >= pn4) return;
  float4* const st = reinterpret_cast<float4*>(states) +
                     (size_t)bh * nc * pn4 + e;
  float4 s = init ? reinterpret_cast<const float4*>(init)[(size_t)bh * pn4 + e]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dep = st[0];
  for (int c = 0; c < nc; ++c) {
    const float4 next = c + 1 < nc ? st[(size_t)(c + 1) * pn4] : dep;
    const float k = decay[(size_t)bh * nc + c];
    st[(size_t)c * pn4] = s;                  // the state entering chunk c
    s = make_float4(fmaf(k, s.x, dep.x), fmaf(k, s.y, dep.y),
                    fmaf(k, s.z, dep.z), fmaf(k, s.w, dep.w));
    dep = next;
  }
  reinterpret_cast<float4*>(final_state)[(size_t)bh * pn4 + e] = s;
}

// ----------------------------------------------------- C: chunk scan --

template <typename Tag, int N, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_sm90_chunk_scan_kernel(const uint16_t* __restrict__ x,
                           const TD* __restrict__ dt,
                           const uint16_t* __restrict__ b,
                           const uint16_t* __restrict__ cm,
                           const float* __restrict__ states,
                           const float* __restrict__ cs_in,
                           uint16_t* __restrict__ y, int has_init, Dims d) {
  constexpr int NH = N / 64;
  constexpr uint32_t kStage = (NH + 1) * kTile;   // B_s tiles, then X_s
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t c_s = base;                  // [NH] C rows of the block
  const uint32_t si_s = c_s + NH * kTile;     // [NH] rn16(S_in), rows p
  const uint32_t ring = si_s + NH * kTile;    // [2] stages
  float* const cs_s =
      reinterpret_cast<float*>(smem_raw + (ring + 2 * kStage - raw));
  const int cl_pad = (d.cl + kRows - 1) / kRows * kRows;
  float* const dt_s = cs_s + cl_pad;

  const int bh = blockIdx.x, c = blockIdx.y;
  const int rb = gridDim.z - 1 - blockIdx.z;   // longest row blocks first
  const int l0 = rb * kRows, t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  if (l0 >= kv) return;                        // rows past S
  const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = l0 + 16 * warp + lane / 4;  // and row0 + 8
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const uint16_t* const xb = x + ((size_t)bi * d.S + t0) * xrow +
                             (size_t)h * kP;
  const uint16_t* const bb = b + ((size_t)bi * d.S + t0) * brow +
                             (size_t)g * N;
  const uint16_t* const cb = cm + ((size_t)bi * d.S + t0) * brow +
                             (size_t)g * N;
  const int n_tiles = rb + 1;                  // column tiles s0 <= l0

  load_rows<8 * NH>(c_s, cb, brow, l0, kv);
  load_rows<8 * NH>(ring, bb, brow, 0, kv);
  load_rows<8>(ring + NH * kTile, xb, xrow, 0, kv);
  cp_async_commit();
  const int nl = min(l0 + kRows, kv);          // positions the block reads
  for (int l = tid; l < nl; l += kThreads) {
    cs_s[l] = cs_in[((size_t)bh * d.nc + c) * d.cl + l];
    dt_s[l] = ld_dt<Tag>(dt, ((size_t)bi * d.S + t0 + l) * d.H + h);
  }
  const bool with_state = has_init || c > 0;
  if (with_state) {                  // S_in (P, N) float32 to 16 bits
    const float* const sin = states + ((size_t)bh * d.nc + c) * (kP * N);
    for (int e = tid; e < kP * 8 * NH; e += kThreads) {
      const int p = e / (8 * NH), j = e % (8 * NH);
      const float4 v0 = *reinterpret_cast<const float4*>(sin + p * N + 8 * j);
      const float4 v1 =
          *reinterpret_cast<const float4*>(sin + p * N + 8 * j + 4);
      st_shared16(si_s + (j / 8) * kTile + sw128(p, j % 8),
                  make_uint4(pack2(v0.x, v0.y, Tag{}), pack2(v0.z, v0.w, Tag{}),
                             pack2(v1.x, v1.y, Tag{}),
                             pack2(v1.z, v1.w, Tag{})));
    }
  }

  float yacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();              // tile t's copies (and C's) landed
    fence_proxy_async();
    __syncthreads();                 // and every warp is past tile t - 1
    if (t + 1 < n_tiles) {
      const uint32_t nxt = ring + ((t + 1) & 1) * kStage;
      load_rows<8 * NH>(nxt, bb, brow, (t + 1) * kRows, kv);
      load_rows<8>(nxt + NH * kTile, xb, xrow, (t + 1) * kRows, kv);
      cp_async_commit();
    }
    if (t == 0 && with_state) {
      // y = e^{cs_l} C_blk S_in^T
      fence_regs(yacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss(yacc,
                 desc_sw128(c_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
                 desc_sw128(si_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
                 kk > 0, Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(yacc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float e = row < kv ? expf(cs_s[row]) : 0.f;
#pragma unroll
        for (int i = 2 * r; i < 32; i += 4) {
          yacc[i] *= e;
          yacc[i + 1] *= e;
        }
      }
    }
    const int s0 = t * kRows;
    const uint32_t bt = ring + (t & 1) * kStage, xt = bt + NH * kTile;
    // scores C_blk B_s^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss(sc,
               desc_sw128(c_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               desc_sw128(bt + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               kk > 0, Tag{});
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    // att = scores e^{cs_l - cs_s} dt_s where s <= l < kv, else 0;
    // sc[i] is row row0 + 8 ((i / 2) % 2), column
    // s0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    uint32_t af[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + 8 * ((i / 2) % 2);
      const int col = s0 + 8 * (i / 4) + 2 * (lane % 4);
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        v[q] = row < kv && col + q <= row
                   ? sc[i + q] *
                         exp2f((cs_s[row] - cs_s[col + q]) * kLog2e) *
                         dt_s[col + q]
                   : 0.f;
      af[i / 8][(i % 8) / 2] = pack2(v[0], v[1], Tag{});
    }
    // y += att X_s
    fence_regs(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs(yacc, af[kk], desc_sw128(xt + kk * 16 * 128, kTile, 1024),
               Tag{});
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(yacc);
  }

  // y in x's type; rows at or past kv are never stored
  uint16_t* const yb = y + ((size_t)bi * d.S + t0) * xrow + (size_t)h * kP;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= kv) continue;
#pragma unroll
    for (int j = 0; j < kP / 8; ++j)
      *reinterpret_cast<uint32_t*>(yb + (size_t)row * xrow + 8 * j +
                                   2 * (lane % 4)) =
          pack2(yacc[4 * j + 2 * r], yacc[4 * j + 2 * r + 1], Tag{});
  }
}

// ------------------------------------------------------------- launches --

// each kernel's dynamic shared memory: the alignment slack, the tiles, the
// chunk's vectors (kernels/ssd_scan.py's smem_bytes mirrors these)
size_t state_smem(int n, int cl) {
  return 1024 + (size_t)(2 + n / 64) * kTile + 3 * sizeof(float) * cl;
}
size_t scan_smem(int n, int cl) {
  const int nh = n / 64;
  return 1024 + (size_t)(2 * nh + 2 * (nh + 1)) * kTile +
         2 * sizeof(float) * ((cl + kRows - 1) / kRows * kRows);
}

struct Args {
  const void *x, *dt, *a, *b, *c, *init;
  void *y, *final_state, *states, *cs, *decay;
  Dims d;
  cudaStream_t stream;
};

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Tag, int N, typename TD>
int run(const Args& a) {
  const Dims& d = a.d;
  const size_t sa = state_smem(N, d.cl), sc = scan_smem(N, d.cl);
  int err;
  if ((err = prepare(ssd_sm90_chunk_state_kernel<Tag, N, TD>, sa)) ||
      (err = prepare(ssd_sm90_chunk_scan_kernel<Tag, N, TD>, sc)))
    return err;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  const TD* dt = static_cast<const TD*>(a.dt);
  const uint16_t* b = static_cast<const uint16_t*>(a.b);
  float* states = static_cast<float*>(a.states);
  float* cs = static_cast<float*>(a.cs);
  float* decay = static_cast<float*>(a.decay);
  ssd_sm90_chunk_state_kernel<Tag, N, TD>
      <<<dim3(d.nc, d.H, d.B), kThreads, sa, a.stream>>>(
          x, dt, static_cast<const float*>(a.a), b, states, cs, decay, d);
  if ((err = (int)cudaGetLastError())) return err;
  const int pn4 = kP * N / 4;
  ssd_sm90_state_pass_kernel<<<dim3(d.B * d.H, (pn4 + kThreads - 1) /
                                                   kThreads),
                               kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.init), decay, states,
      static_cast<float*>(a.final_state), d.nc, pn4);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_sm90_chunk_scan_kernel<Tag, N, TD>
      <<<dim3(d.B * d.H, d.nc, (d.cl + kRows - 1) / kRows), kThreads, sc,
         a.stream>>>(x, dt, b, static_cast<const uint16_t*>(a.c), states, cs,
                     static_cast<uint16_t*>(a.y), a.init != nullptr, d);
  return (int)cudaGetLastError();
}

template <typename Tag, typename TD>
int run_n(const Args& a) {
  if (a.d.N == 64) return run<Tag, 64, TD>(a);
  if (a.d.N == 128) return run<Tag, 128, TD>(a);
  return (int)cudaErrorInvalidValue;
}

// dtype: 1 bfloat16, 2 float16 (float32, 0, is not taken); dt_dtype 0
// (float32) or dtype
int dispatch(int dtype, int dt_dtype, int P, const Args& a) {
  const Dims& d = a.d;
  if (d.B <= 0 || d.S <= 0 || d.H <= 0 || d.G <= 0 || d.H % d.G != 0 ||
      P != kP || d.cl <= 0 || d.nc != (d.S + d.cl - 1) / d.cl ||
      d.nc > 65535 || (dt_dtype != 0 && dt_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dt_dtype ? run_n<Bf16, uint16_t>(a) : run_n<Bf16, float>(a);
  if (dtype == 2)
    return dt_dtype ? run_n<F16, uint16_t>(a) : run_n<F16, float>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// init may be null (zeros). chunk_states (B, H, nc, P, N), cs (B, H, nc,
// cl) and decay (B, H, nc) are float32 buffers of the caller's; the chunk
// states come back as the states entering each chunk. Returns a
// cudaError_t.
extern "C" int ssd_scan_fwd_sm90_launch(int dtype, int dt_dtype,
                                        const void* x, const void* dt,
                                        const void* a, const void* b,
                                        const void* c, const void* init,
                                        void* y, void* final_state,
                                        void* chunk_states, void* cs,
                                        void* decay, int B, int S, int H,
                                        int P, int G, int N, int cl,
                                        void* stream) {
  Args a_{};
  a_.x = x; a_.dt = dt; a_.a = a; a_.b = b; a_.c = c; a_.init = init;
  a_.y = y; a_.final_state = final_state; a_.states = chunk_states;
  a_.cs = cs; a_.decay = decay;
  a_.d = Dims{B, S, H, G, N, cl, cl > 0 ? (S + cl - 1) / cl : 0};
  a_.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, dt_dtype, P, a_);
}
