// K3 on Hopper: the Mamba-2 SSD chunked scan, forward (K3f) and backward
// (K3b), chunk-parallel, at head dim P 64 and state width N 64 or 128
// (sm_90a): bfloat16 and float16 on the tensor cores, float32 on the CUDA
// cores (the float32 section below).
//
// Replaces the Pallas kernels of src/repro/kernels/ssd_scan.py:
//   K3f  ssd_scan / _ssd_kernel (pallas_call at :143, kernel at :64);
//   K3b  ssd_scan_bwd / _ssd_bwd_kernel (pallas_call at :278, kernel at
//        :168).
// They compute what ssd_scan.cu's ssd_fwd_kernel and ssd_bwd_kernel
// compute, with the same contract: x (B, S, H, P) and b, c (B, S, G, N)
// contiguous in one type, dt (B, S, H) in float32 or that type, a
// (H,) float32, an optional initial state (B, H, P, N) float32 (null:
// zeros); head h reads group h / (H / G). Within a chunk of cl positions,
// cs the cumulative sum of dt * a:
//   y_l = sum_{s<=l} (c_l . b_s) e^{cs_l - cs_s} dt_s x_s + e^{cs_l} c_l . S
//   S  <- e^{cs_end} S + sum_l e^{cs_end - cs_l} dt_l x_l b_l^T
// y is written in x's type, the final state and the state entering each
// chunk (B, H, nc, P, N) in float32 (the backward's only residual). K3b
// reads those states, dy (B, S, H, P) in float32 or x's type and d(final
// state), and writes dx, ddt, per-head db and dc, d(initial state) and
// per-(b, h, chunk) partials of da, all float32. Rows past S (the ragged
// tail of the last chunk, or a chunk clamped to S) read as zeros, dt = 0
// there deposits nothing, and they are never stored; the exponential is
// taken only under the causal mask (l >= s). The wrapper
// (kernels/ssd_scan.py, fwd_route and bwd_route: one rule for every dtype)
// sends every other P or N to ssd_scan.cu's first versions, which a direct
// call may also name (route "simt") to time them beside these.
//
// Design. The TPU walks the chunks in order (K3b last-first) with the
// state or its cotangent in VMEM; the first versions here did the same in
// one CTA per (b, h), B * H CTAs (24 at one 4096-token sequence) each
// serial over its chunks on the CUDA cores. These routes split the work in
// launches on one stream, of which only one is sequential in the chunks,
// and it only moves state-sized float32 vectors.
// K3f, three launches:
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
// K3b, five launches. The only cross-chunk coupling is the state
// cotangent dS, and it is linear: dS_out[nc-1] = d(final state),
// dS_out[c-1] = e^{cs_end,c} dS_out[c] + D_c with the deposit
// D_c = (ecs . dY_c)^T C_c (ecs = e^{cs}), d(initial state) =
// e^{cs_end,0} dS_out[0] + D_0; everything else is chunk-local given S_in
// and dS_out.
//   A' ssd_sm90_bwd_deposit_kernel, one CTA per (chunk, head, batch): A's
//      body with (ecs, dY, C) for (w, X, B); it also writes dt in float32
//      to the scratch, so the kernels after it read one type.
//   B' ssd_sm90_bwd_dstate_pass_kernel: B's loop walking the chunks
//      last-first from d(final state), in place over the deposits (each
//      D_c is read before its slot takes dS_out[c]); its last carry is
//      d(initial state).
//   C' ssd_sm90_bwd_column_kernel, one CTA per (b, h, chunk, 64-position
//      column block s0), longest first: over the row tiles l0 >= s0 the
//      transposed tiles B_s C_l^T and X_s dY_l^T give att^T, dcb^T and
//      (datt CB decay)^T in registers (K2kv works on transposed scores
//      the same way); dx_s += att^T dY_l, db_s += dcb^T C_l, and the
//      column sums ddt_att_s. Once a block: dx_s = w . (B_s dS_out^T),
//      db_s = w . (X_s dS_out), dw_s = sum_n (X_s dS_out) . b_s.
//      ssd_sm90_bwd_row_kernel, one CTA per (b, h, chunk, 64-row block
//      l0), longest first: over s0 <= l0, C_l B_s^T and dY_l X_s^T give
//      dcb in registers, dc_l += dcb B_s, and the row sums of dseg = datt
//      CB decay dt_s. Once a block: dc_l = ecs . (dY_l S_in) and
//      sum_p dy . y_off, y_off = ecs . (C_l S_in^T).
//      ssd_sm90_bwd_finish_kernel, one CTA per (b, h, chunk): dcs = rows -
//      dt ddt_att - dw w, dcs_end = sum dw w + e^{cs_end} sum(dS_out .
//      S_in) (reduced inside the CTA) at the chunk's last row, its reverse
//      cumsum dda (a warp scan), ddt = ddt_att + dw e^{cs_end - cs} +
//      dda a, and the chunk's da partial sum dda dt, which the wrapper
//      sums in a fixed order.
// In 16 bits every product is on wgmma (sm90_common.cuh), float32
// accumulators:
//   A, A'  m64nNk16 SS with both operands MN-major (transposed):
//      (w . X)^T or (ecs . dY)^T from the rows as stored (P contiguous),
//      B or C from their rows (N contiguous);
//   C  C_blk B_s^T and C_blk S_in^T: m64n64k16 SS, K-major (N contiguous);
//      att X_s: m64n64k16 RS, att packed from the accumulators, X_s
//      MN-major (transpose-B), exactly K2f's PV;
//   C' the score-like tiles (B_s C_l^T, X_s dY_l^T, C_l B_s^T, dY_l X_s^T,
//      B_s dS_out^T, C_l S_in^T) SS K-major; X_s dS_out and dY_l S_in SS
//      with the state MN-major; att^T dY_l, dcb^T C_l and dcb B_s RS with
//      the row tiles MN-major (m64n128k16 at N 128).
// The 16-bit roundings, which the plain versions emulate
// (ssd_scan_fwd_plain(emulate=dtype), ssd_scan_bwd_chunked_plain(emulate=
// dtype)):
//   * w . X and ecs . dY (the deposits' float32 operands) are split into
//     hi = rn16(v) and lo = rn16(v - hi), two wgmmas into one accumulator,
//     so a deposit keeps ~16 significant bits (one rounding of w . X would
//     move the states by ~4e-3 of their largest entry in bfloat16; the
//     states, the final state and d(initial state) are held to 1e-4); the
//     (P = 64)-wide operand, not the N-wide one, is split;
//   * att, dcb, S_in and dS_out are rounded to 16 bits before their
//     products (y is stored in 16 bits, held to 1e-2 of its largest entry;
//     so are K3b's dx, ddt, da, db and dc: each rounding moves a term by
//     at most u |term|, u = 2^-9 bf16, 2^-12 fp16);
//   * a float32 dy is read rounded to x's type (once, on its way into
//     shared memory), so it gives what dy in x's type gives.
// The passes B and B' and every sum stay float32; no atomics, every sum
// in a fixed order, so two calls agree bit for bit.
// Tiles move by 16-byte cp.async (zero-filled past the valid rows) or, for
// the operands converted on the way (w . X, ecs . dY, S_in, dS_out, a
// float32 dy), by loads and st.shared, into the 128-byte swizzled layout
// TMA would write (sw128); phases C and C' keep a two-stage ring of the
// walked tiles, the next tile's copies in flight under this tile's
// products. Not TMA: the tiles are rows of one head strided by H P or G N
// elements, and encoding tensor maps on the host each call was measured
// (K2's backward at S 256) to outlast kernels of this size.
//
// Bound on an H100 (989 TFLOP/s bf16/fp16, 3.35 TB/s): bytes, at every
// main-path shape (chip_smoke.py's k3_work): a chunk of 256 at P 64, N 128
// does ~2 (N + P) flops a live pair forward and 2 (3N + 2P) backward, 4 P N
// and 10 P N a position, ~1 and ~3 flops a byte of what it must move
// (x, b, c, dy and the float32 states and gradients), under the ~295 where
// the tensor cores would be the limit. So the design aims at the bytes:
// every input read once per CTA that needs it, b and c shared by the heads
// of a group through L2 (the grid walks heads fastest), the float32
// (dS) states written by A (A') and rewritten in place by B (B'), and K3b's
// per-head db and dc (the reference's contract: the wrapper sums them over
// each group) the traffic beyond the inputs and outputs. Left for later: a
// persistent scheduler, fusing A to C (A' to C'), a group reduction of db
// and dc inside the kernel, other P and N.
//
// The C entries check the shapes, set each kernel's dynamic shared-memory
// limit, launch the route's kernels on the given stream and return the
// first CUDA error.

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

// 8 consecutive values as floats: 16-bit ones as they are, float32 ones
// rounded to 16 bits (a float32 dy is read as if it were in x's type)
template <typename Tag>
__device__ __forceinline__ void load8(const uint16_t* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t in[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = to_f32((uint16_t)(in[k] & 0xffffu), Tag{});
    v[2 * k + 1] = to_f32((uint16_t)(in[k] >> 16), Tag{});
  }
}
template <typename Tag>
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = round16(f[k], Tag{});
}

// 8 values times w, split into hi = rn16(v) and lo = rn16(v - hi)
template <typename Tag, typename TV>
__device__ __forceinline__ void split_scaled(const TV* p, float w, uint4& hi,
                                             uint4& lo) {
  float v[8];
  load8<Tag>(p, v);
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v0 = v[2 * k] * w, v1 = v[2 * k + 1] * w;
    const float h0 = round16(v0, Tag{}), h1 = round16(v1, Tag{});
    h[k] = pack2(h0, h1, Tag{});
    l[k] = pack2(v0 - h0, v1 - h1, Tag{});
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// two 16-bit values at a shared-memory address, as floats
template <typename Tag>
__device__ __forceinline__ float2 ld_shared_pair(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return make_float2(to_f32((uint16_t)(v & 0xffffu), Tag{}),
                     to_f32((uint16_t)(v >> 16), Tag{}));
}

// the 16-bit value at (r, col) of a run of swizzled (64, 64) tiles
__device__ __forceinline__ uint32_t tile_at(uint32_t tiles, int r, int col) {
  return tiles + (col / 64) * kTile + sw128(r, (col % 64) / 8) + 2 * (col % 8);
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

// the same for 64 float32 values a row, rounded to 16 bits on the way
// (loads and st.shared: done when the call returns)
template <typename Tag>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src,
                                              size_t row_stride, int r0,
                                              int kv) {
  for (int e = threadIdx.x; e < kRows * 8; e += kThreads) {
    const int r = e / 8, j = e % 8;
    const int l = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (l < kv) {
      float f[8];
      load8<Tag>(src + (size_t)l * row_stride + 8 * j, f);
      v = make_uint4(pack2(f[0], f[1], Tag{}), pack2(f[2], f[3], Tag{}),
                     pack2(f[4], f[5], Tag{}), pack2(f[6], f[7], Tag{}));
    }
    st_shared16(dst + sw128(r, j), v);
  }
}

// 64 rows of dy (P = 64 wide) into one tile: by cp.async when dy is 16-bit,
// rounded from float32 otherwise
template <typename Tag>
__device__ __forceinline__ void load_dy(uint32_t dst, const uint16_t* src,
                                        size_t row_stride, int r0, int kv) {
  load_rows<8>(dst, src, row_stride, r0, kv);
}
template <typename Tag>
__device__ __forceinline__ void load_dy(uint32_t dst, const float* src,
                                        size_t row_stride, int r0, int kv) {
  load_rows_f32<Tag>(dst, src, row_stride, r0, kv);
}

// a (P, N) float32 state rounded to 16 bits into N / 64 tiles, rows p
template <typename Tag, int N>
__device__ __forceinline__ void state_to16(uint32_t dst, const float* src) {
  for (int e = threadIdx.x; e < kP * N / 8; e += kThreads) {
    const int p = e / (N / 8), j = e % (N / 8);
    const float4 v0 = *reinterpret_cast<const float4*>(src + p * N + 8 * j);
    const float4 v1 =
        *reinterpret_cast<const float4*>(src + p * N + 8 * j + 4);
    st_shared16(dst + (j / 8) * kTile + sw128(p, j % 8),
                make_uint4(pack2(v0.x, v0.y, Tag{}), pack2(v0.z, v0.w, Tag{}),
                           pack2(v1.x, v1.y, Tag{}),
                           pack2(v1.z, v1.w, Tag{})));
  }
}

// a chunk's dt into dt_s (zeros at and past kv) and the inclusive cumsum of
// dt * a into cs_s: warp 0, each lane a run of consecutive positions, a
// shuffle scan giving each run its offset, in a fixed order; kT threads
template <typename Tag, typename TD, int kT = kThreads>
__device__ __forceinline__ void chunk_cs(const TD* dt, size_t i0, int H,
                                         float av, int cl, int kv,
                                         float* dt_s, float* cs_s) {
  const int tid = threadIdx.x, lane = tid % 32;
  for (int l = tid; l < cl; l += kT)
    dt_s[l] = l < kv ? ld_dt<Tag>(dt, i0 + (size_t)l * H) : 0.f;
  __syncthreads();
  if (tid < 32) {
    const int per = (cl + 31) / 32, l0 = lane * per;
    float run = 0.f;
    for (int k = 0; k < per && l0 + k < cl; ++k) run += dt_s[l0 + k] * av;
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    float acc = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) acc = 0.f;
    for (int k = 0; k < per && l0 + k < cl; ++k) {
      acc += dt_s[l0 + k] * av;
      cs_s[l0 + k] = acc;
    }
  }
  __syncthreads();
}

// a chunk's deposit V^T (scale . W), (P, N), over its rows l < kv, 64 at a
// time: V (P = 64 wide, 16-bit or float32) times scale_l split into hi +
// lo, W (N wide, 16-bit) by cp.async, two m64nNk16 SS wgmmas with both
// operands MN-major into one accumulator. acc[i] is row p = 16 warp +
// lane / 4 + 8 ((i / 2) % 2), column n = 8 (i / 4) + 2 (lane % 4) + i % 2.
template <typename Tag, int N, typename TV>
__device__ __forceinline__ void deposit(float (&acc)[N / 2], uint32_t vh_s,
                                        uint32_t vl_s, uint32_t w_s,
                                        const TV* vb, size_t vrow,
                                        const uint16_t* wb, size_t wrow,
                                        const float* scale, int kv) {
  constexpr int NH = N / 64;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < kv; r0 += kRows) {
    if (r0) __syncthreads();       // every warp is past the last products
    load_rows<8 * NH>(w_s, wb, wrow, r0, kv);
    cp_async_commit();
    for (int e = tid; e < kRows * 8; e += kThreads) {
      const int r = e / 8, j = e % 8;
      const int l = r0 + r;
      uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
      if (l < kv)
        split_scaled<Tag>(vb + (size_t)l * vrow + 8 * j, scale[l], hi, lo);
      st_shared16(vh_s + sw128(r, j), hi);
      st_shared16(vl_s + sw128(r, j), lo);
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t bd = desc_sw128(w_s + kk * 16 * 128, kTile, 1024);
      wgmma_ss<1, 1>(acc, desc_sw128(vh_s + kk * 16 * 128, kTile, 1024), bd,
                     1, Tag{});
      wgmma_ss<1, 1>(acc, desc_sw128(vl_s + kk * 16 * 128, kTile, 1024), bd,
                     1, Tag{});
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
}

// the deposit's accumulator into a (P, N) float32 state
template <int N>
__device__ __forceinline__ void store_state(float* dst,
                                            const float (&acc)[N / 2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 16 * warp + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dst + (size_t)p * N + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// the chunks of one (b, h) in order (kRev: last-first), one thread a float4
// of (P, N), in place: each chunk's slot of `states` holds its deposit and
// takes the value carried into it, carry = decay_c carry + deposit_c; the
// carry starts from seed (null: zeros) and ends in last
template <bool kRev>
__device__ __forceinline__ void pass_chunks(const float* seed,
                                            const float* decay,
                                            float* states, float* last,
                                            int nc, int pn4) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;   // a float4 of (P, N)
  if (e >= pn4) return;
  float4* const st = reinterpret_cast<float4*>(states) +
                     (size_t)bh * nc * pn4 + e;
  float4 s = seed ? reinterpret_cast<const float4*>(seed)[(size_t)bh * pn4 + e]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  const int step = kRev ? -1 : 1;
  int c = kRev ? nc - 1 : 0;
  float4 dep = st[(size_t)c * pn4];
  for (int i = 0; i < nc; ++i, c += step) {
    const float4 next = i + 1 < nc ? st[(size_t)(c + step) * pn4] : dep;
    const float k = decay[(size_t)bh * nc + c];
    st[(size_t)c * pn4] = s;
    s = make_float4(fmaf(k, s.x, dep.x), fmaf(k, s.y, dep.y),
                    fmaf(k, s.z, dep.z), fmaf(k, s.w, dep.w));
    dep = next;
  }
  reinterpret_cast<float4*>(last)[(size_t)bh * pn4 + e] = s;
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
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bi * d.H + h;

  chunk_cs<Tag>(dt, ((size_t)bi * d.S + t0) * d.H + h, d.H, a[h], d.cl, kv,
                dt_s, cs_s);
  const float cs_end = cs_s[d.cl - 1];
  float* const cs_g = cs_out + (bh * d.nc + c) * d.cl;
  for (int l = tid; l < d.cl; l += kThreads) {
    cs_g[l] = cs_s[l];
    w_s[l] = dt_s[l] * expf(cs_end - cs_s[l]);
  }
  if (tid == 0) decay[bh * d.nc + c] = expf(cs_end);
  __syncthreads();

  // the deposit X^T (w . B)
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  float acc[N / 2];
  deposit<Tag, N>(acc, xh_s, xl_s, b_s,
                  x + ((size_t)bi * d.S + t0) * xrow + (size_t)h * kP, xrow,
                  b + ((size_t)bi * d.S + t0) * brow + (size_t)g * N, brow,
                  w_s, kv);
  store_state<N>(states + (bh * d.nc + c) * (size_t)(kP * N), acc);
}

// ----------------------------------------------------- B: state pass --

__global__ void __launch_bounds__(kThreads)
ssd_sm90_state_pass_kernel(const float* __restrict__ init,
                           const float* __restrict__ decay, float* states,
                           float* __restrict__ final_state, int nc,
                           int pn4) {
  pass_chunks<false>(init, decay, states, final_state, nc, pn4);
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
  if (with_state)                    // S_in (P, N) float32 to 16 bits
    state_to16<Tag, N>(si_s, states + ((size_t)bh * d.nc + c) * (kP * N));

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

// ================================================================= K3b ==

// ------------------------------------------------ A': the dS deposits --

template <typename Tag, int N, typename TD, typename TY>
__global__ void __launch_bounds__(kThreads)
ssd_sm90_bwd_deposit_kernel(const TY* __restrict__ dy,
                            const TD* __restrict__ dt,
                            const float* __restrict__ a,
                            const uint16_t* __restrict__ cm,
                            float* __restrict__ ds, float* __restrict__ cs_out,
                            float* __restrict__ dt_out,
                            float* __restrict__ decay, Dims d) {
  constexpr int NH = N / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t yh_s = base;                 // rn16(ecs dy), rows l
  const uint32_t yl_s = yh_s + kTile;         // rn16(ecs dy - hi)
  const uint32_t c_s = yl_s + kTile;          // [NH] tiles of c rows
  float* const dt_s =
      reinterpret_cast<float*>(smem_raw + (c_s + NH * kTile - raw));
  float* const cs_s = dt_s + d.cl;
  float* const ecs_s = cs_s + d.cl;

  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bi * d.H + h;

  chunk_cs<Tag>(dt, ((size_t)bi * d.S + t0) * d.H + h, d.H, a[h], d.cl, kv,
                dt_s, cs_s);
  const size_t v0 = (bh * d.nc + c) * d.cl;
  for (int l = tid; l < d.cl; l += kThreads) {
    cs_out[v0 + l] = cs_s[l];
    dt_out[v0 + l] = dt_s[l];
    ecs_s[l] = expf(cs_s[l]);
  }
  if (tid == 0) decay[bh * d.nc + c] = expf(cs_s[d.cl - 1]);
  __syncthreads();

  // D_c = (ecs . dY)^T C
  const size_t yrow = (size_t)d.H * kP, crow = (size_t)d.G * N;
  float acc[N / 2];
  deposit<Tag, N>(acc, yh_s, yl_s, c_s,
                  dy + ((size_t)bi * d.S + t0) * yrow + (size_t)h * kP, yrow,
                  cm + ((size_t)bi * d.S + t0) * crow + (size_t)g * N, crow,
                  ecs_s, kv);
  store_state<N>(ds + (bh * d.nc + c) * (size_t)(kP * N), acc);
}

// ------------------------------------------- B': the reverse dS pass --

__global__ void __launch_bounds__(kThreads)
ssd_sm90_bwd_dstate_pass_kernel(const float* __restrict__ dfinal,
                                const float* __restrict__ decay, float* ds,
                                float* __restrict__ dinit, int nc, int pn4) {
  pass_chunks<true>(dfinal, decay, ds, dinit, nc, pn4);
}

// --------------------------------------- C': the column-block kernel --

// per-row sums of a thread's two accumulator rows over the quad that
// shares them (lanes 4k..4k+3), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// One CTA per (b, h, chunk, 64-position column block s0), longest first:
// over the row tiles l0 >= s0, the transposed tiles B_s C_l^T and
// X_s dY_l^T give att^T, dcb^T and q^T = (datt CB decay)^T in registers;
// dx_s += att^T dY_l, db_s += dcb^T C_l (RS, the row tiles MN-major), the
// column sums of q (ddt_att) as per-row sums. Before the walk, the state
// terms: dx_s = w . (B_s dS_out^T), db_s = w . (X_s dS_out), dw_s =
// sum_n (X_s dS_out) . b_s.
template <typename Tag, int N, typename TY>
__global__ void __launch_bounds__(kThreads, 1)
ssd_sm90_bwd_column_kernel(const uint16_t* __restrict__ x,
                           const uint16_t* __restrict__ b,
                           const uint16_t* __restrict__ cm,
                           const TY* __restrict__ dy,
                           const float* __restrict__ ds,
                           const float* __restrict__ cs_in,
                           const float* __restrict__ dt_in,
                           float* __restrict__ dx, float* __restrict__ dbh,
                           float* __restrict__ ddt_att,
                           float* __restrict__ dw_out, Dims d) {
  constexpr int NH = N / 64;
  constexpr uint32_t kStage = (NH + 1) * kTile;   // C_l tiles, then dY_l
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t b_s = base;                  // [NH] B rows of the block
  const uint32_t x_s = b_s + NH * kTile;      // X rows of the block
  const uint32_t ds_s = x_s + kTile;          // [NH] rn16(dS_out), rows p
  const uint32_t ring = ds_s + NH * kTile;    // [2] stages
  float* const cs_s =
      reinterpret_cast<float*>(smem_raw + (ring + 2 * kStage - raw));
  const int cl_pad = (d.cl + kRows - 1) / kRows * kRows;
  float* const dt_s = cs_s + cl_pad;

  const int bh = blockIdx.x, c = blockIdx.y, sb = blockIdx.z;
  const int s0 = sb * kRows, t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  if (s0 >= kv) return;                        // columns past S
  const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lr0 = 16 * warp + lane / 4;        // local rows lr0, lr0 + 8
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const size_t tok = (size_t)bi * d.S + t0;
  const uint16_t* const xb = x + tok * xrow + (size_t)h * kP;
  const TY* const yb = dy + tok * xrow + (size_t)h * kP;
  const uint16_t* const bb = b + tok * brow + (size_t)g * N;
  const uint16_t* const cb = cm + tok * brow + (size_t)g * N;
  const int n_tiles = (kv + kRows - 1) / kRows - sb;   // row tiles l0 >= s0
  const size_t ch = (size_t)bh * d.nc + c;

  load_rows<8 * NH>(b_s, bb, brow, s0, kv);
  load_rows<8>(x_s, xb, xrow, s0, kv);
  load_rows<8 * NH>(ring, cb, brow, s0, kv);
  load_dy<Tag>(ring + NH * kTile, yb, xrow, s0, kv);
  cp_async_commit();
  for (int l = s0 + tid; l < kv; l += kThreads) {
    cs_s[l] = cs_in[ch * d.cl + l];
    dt_s[l] = dt_in[ch * d.cl + l];
  }
  state_to16<Tag, N>(ds_s, ds + ch * (kP * N));
  const float cs_end = cs_in[ch * d.cl + d.cl - 1];
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // dt_s and w_s of the thread's two rows (0 past kv)
  float dtr[2], wr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + lr0 + 8 * r;
    dtr[r] = s < kv ? dt_s[s] : 0.f;
    wr[r] = s < kv ? dtr[r] * expf(cs_end - cs_s[s]) : 0.f;
  }
  // the state terms: B_s dS_out^T (K-major both) into dx, X_s dS_out
  // (dS_out MN-major) into db
  float dxa[32], dba[N / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dba[i] = 0.f;
  fence_regs(dxa);
  fence_regs(dba);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss(dxa,
             desc_sw128(b_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
             desc_sw128(ds_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
             kk > 0, Tag{});
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk)
    wgmma_ss<0, 1>(dba, desc_sw128(x_s + kk * 32, 16, 1024),
                   desc_sw128(ds_s + kk * 16 * 128, kTile, 1024), kk > 0,
                   Tag{});
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(dxa);
  fence_regs(dba);
  // dw = sum_n (X_s dS_out) . b_s, then the w scaling; dba[i] is row
  // lr0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  float dwr[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i / 2) % 2;
    const float2 bv =
        ld_shared_pair<Tag>(tile_at(b_s, lr0 + 8 * r, 8 * (i / 4) +
                                                          2 * (lane % 4)));
    dwr[r] += dba[i] * bv.x + dba[i + 1] * bv.y;
    dba[i] *= wr[r];
    dba[i + 1] *= wr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dxa[i] *= wr[(i / 2) % 2];

  float qr[2] = {0.f, 0.f};                    // the column sums of q
  for (int t = 0; t < n_tiles; ++t) {
    if (t) {
      cp_async_wait<0>();            // tile t's copies landed
      fence_proxy_async();
      __syncthreads();               // and every warp is past tile t - 1
    }
    if (t + 1 < n_tiles) {
      const uint32_t nxt = ring + ((t + 1) & 1) * kStage;
      const int l1 = s0 + (t + 1) * kRows;
      load_rows<8 * NH>(nxt, cb, brow, l1, kv);
      load_dy<Tag>(nxt + NH * kTile, yb, xrow, l1, kv);
      cp_async_commit();
    }
    const int l0 = s0 + t * kRows;
    const uint32_t ct = ring + (t & 1) * kStage, yt = ct + NH * kTile;
    // B_s C_l^T and X_s dY_l^T
    float sc[32], da[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
    fence_regs(sc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss(sc,
               desc_sw128(b_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               desc_sw128(ct + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               kk > 0, Tag{});
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_ss(da, desc_sw128(x_s + kk * 32, 16, 1024),
               desc_sw128(yt + kk * 32, 16, 1024), kk > 0, Tag{});
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(da);
    // rows s, columns l: live where s <= l < kv; decay e^{cs_l - cs_s}
    uint32_t fa[4][4], fd[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      const int s = s0 + lr0 + 8 * r;
      const int l = l0 + 8 * (i / 4) + 2 * (lane % 4);
      float va[2], vd[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool live = s <= l + q && l + q < kv;
        const float e =
            live ? exp2f((cs_s[l + q] - cs_s[s]) * kLog2e) : 0.f;
        va[q] = sc[i + q] * e * dtr[r];
        vd[q] = da[i + q] * e * dtr[r];
        qr[r] += da[i + q] * sc[i + q] * e;
      }
      fa[i / 8][(i % 8) / 2] = pack2(va[0], va[1], Tag{});
      fd[i / 8][(i % 8) / 2] = pack2(vd[0], vd[1], Tag{});
    }
    // dx_s += att^T dY_l, db_s += dcb^T C_l
    fence_regs(dxa);
    fence_regs(dba);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(dxa, fa[kk], desc_sw128(yt + kk * 16 * 128, kTile, 1024),
               Tag{});
      wgmma_rs(dba, fd[kk], desc_sw128(ct + kk * 16 * 128, kTile, 1024),
               Tag{});
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dxa);
    fence_regs(dba);
  }

  // per-row sums, then the rows below kv
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qr[r] = quad_sum(qr[r]);
    dwr[r] = quad_sum(dwr[r]);
  }
  const size_t hrow = (size_t)d.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + lr0 + 8 * r;
    if (s >= kv) continue;
    if (lane % 4 == 0) {
      ddt_att[ch * d.cl + s] = qr[r];
      dw_out[ch * d.cl + s] = dwr[r];
    }
    float* const dxr = dx + ((tok + s) * hrow + h) * kP;
    float* const dbr = dbh + ((tok + s) * hrow + h) * N;
#pragma unroll
    for (int j = 0; j < kP / 8; ++j)
      *reinterpret_cast<float2*>(dxr + 8 * j + 2 * (lane % 4)) =
          make_float2(dxa[4 * j + 2 * r], dxa[4 * j + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dbr + 8 * j + 2 * (lane % 4)) =
          make_float2(dba[4 * j + 2 * r], dba[4 * j + 2 * r + 1]);
  }
}

// ------------------------------------------ C': the row-block kernel --

// One CTA per (b, h, chunk, 64-row block l0), longest first: over the
// column tiles s0 <= l0, C_l B_s^T and dY_l X_s^T give dcb in registers,
// dc_l += dcb B_s (RS, B_s MN-major), and the row sums of dseg = q dt_s.
// Before the walk, the y_off terms: dc_l = ecs . (dY_l S_in) and
// sum_p dy . y_off, y_off = ecs . (C_l S_in^T). It leaves each row's
// dseg row sum plus sum_p dy . y_off in rowv.
template <typename Tag, int N, typename TY>
__global__ void __launch_bounds__(kThreads, 1)
ssd_sm90_bwd_row_kernel(const uint16_t* __restrict__ x,
                        const uint16_t* __restrict__ b,
                        const uint16_t* __restrict__ cm,
                        const TY* __restrict__ dy,
                        const float* __restrict__ states,
                        const float* __restrict__ cs_in,
                        const float* __restrict__ dt_in,
                        float* __restrict__ dch, float* __restrict__ rowv,
                        Dims d) {
  constexpr int NH = N / 64;
  constexpr uint32_t kStage = (NH + 1) * kTile;   // B_s tiles, then X_s
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t c_s = base;                  // [NH] C rows of the block
  const uint32_t y_s = c_s + NH * kTile;      // dY rows of the block
  const uint32_t si_s = y_s + kTile;          // [NH] rn16(S_in), rows p
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
  const int lr0 = 16 * warp + lane / 4;        // local rows lr0, lr0 + 8
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const size_t tok = (size_t)bi * d.S + t0;
  const uint16_t* const xb = x + tok * xrow + (size_t)h * kP;
  const TY* const yb = dy + tok * xrow + (size_t)h * kP;
  const uint16_t* const bb = b + tok * brow + (size_t)g * N;
  const uint16_t* const cb = cm + tok * brow + (size_t)g * N;
  const int n_tiles = rb + 1;                  // column tiles s0 <= l0
  const size_t ch = (size_t)bh * d.nc + c;

  load_rows<8 * NH>(c_s, cb, brow, l0, kv);
  load_dy<Tag>(y_s, yb, xrow, l0, kv);
  load_rows<8 * NH>(ring, bb, brow, 0, kv);
  load_rows<8>(ring + NH * kTile, xb, xrow, 0, kv);
  cp_async_commit();
  const int nl = min(l0 + kRows, kv);          // positions the block reads
  for (int l = tid; l < nl; l += kThreads) {
    cs_s[l] = cs_in[ch * d.cl + l];
    dt_s[l] = dt_in[ch * d.cl + l];
  }
  state_to16<Tag, N>(si_s, states + ch * (kP * N));
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float er[2];                                 // ecs of the thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = l0 + lr0 + 8 * r;
    er[r] = l < kv ? expf(cs_s[l]) : 0.f;
  }
  // C_l S_in^T (K-major both) and dY_l S_in (S_in MN-major)
  float yo[32], dca[N / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) yo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dca[i] = 0.f;
  fence_regs(yo);
  fence_regs(dca);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss(yo,
             desc_sw128(c_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
             desc_sw128(si_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
             kk > 0, Tag{});
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk)
    wgmma_ss<0, 1>(dca, desc_sw128(y_s + kk * 32, 16, 1024),
                   desc_sw128(si_s + kk * 16 * 128, kTile, 1024), kk > 0,
                   Tag{});
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(yo);
  fence_regs(dca);
  // sum_p dy . y_off; yo[i] is row lr0 + 8 ((i / 2) % 2), column p =
  // 8 (i / 4) + 2 (lane % 4) + i % 2
  float rr[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i / 2) % 2;
    const float2 yv = ld_shared_pair<Tag>(
        tile_at(y_s, lr0 + 8 * r, 8 * (i / 4) + 2 * (lane % 4)));
    rr[r] += er[r] * (yo[i] * yv.x + yo[i + 1] * yv.y);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dca[i] *= er[(i / 2) % 2];

  for (int t = 0; t < n_tiles; ++t) {
    if (t) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    if (t + 1 < n_tiles) {
      const uint32_t nxt = ring + ((t + 1) & 1) * kStage;
      load_rows<8 * NH>(nxt, bb, brow, (t + 1) * kRows, kv);
      load_rows<8>(nxt + NH * kTile, xb, xrow, (t + 1) * kRows, kv);
      cp_async_commit();
    }
    const int s0 = t * kRows;
    const uint32_t bt = ring + (t & 1) * kStage, xt = bt + NH * kTile;
    // C_l B_s^T and dY_l X_s^T
    float sc[32], da[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
    fence_regs(sc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss(sc,
               desc_sw128(c_s + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               desc_sw128(bt + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               kk > 0, Tag{});
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_ss(da, desc_sw128(y_s + kk * 32, 16, 1024),
               desc_sw128(xt + kk * 32, 16, 1024), kk > 0, Tag{});
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(da);
    // rows l, columns s: live where s <= l < kv
    uint32_t fd[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      const int l = l0 + lr0 + 8 * r;
      const int s = s0 + 8 * (i / 4) + 2 * (lane % 4);
      float vd[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool live = s + q <= l && l < kv;
        const float e =
            live ? exp2f((cs_s[l] - cs_s[s + q]) * kLog2e) : 0.f;
        const float dts = live ? dt_s[s + q] : 0.f;
        vd[q] = da[i + q] * e * dts;
        rr[r] += vd[q] * sc[i + q];
      }
      fd[i / 8][(i % 8) / 2] = pack2(vd[0], vd[1], Tag{});
    }
    // dc_l += dcb B_s
    fence_regs(dca);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs(dca, fd[kk], desc_sw128(bt + kk * 16 * 128, kTile, 1024),
               Tag{});
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dca);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) rr[r] = quad_sum(rr[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = l0 + lr0 + 8 * r;
    if (l >= kv) continue;
    if (lane % 4 == 0) rowv[ch * d.cl + l] = rr[r];
    float* const dcr = dch + ((tok + l) * d.H + h) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dcr + 8 * j + 2 * (lane % 4)) =
          make_float2(dca[4 * j + 2 * r], dca[4 * j + 2 * r + 1]);
  }
}

// ------------------------------------------------ C': the finish --

// the sum of v over the CTA's 128 threads, in a fixed order; every thread
// gets it (red: 4 floats of shared memory)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// One CTA per (b, h, chunk): dcs_l = rowv_l - dt_l ddt_att_l - dw_l w_l,
// dcs_end = sum dw w + e^{cs_end} sum(dS_out . S_in) at the chunk's last
// row, dda its reverse cumsum (warp 0, runs and a shuffle scan, a fixed
// order), ddt = ddt_att + dw e^{cs_end - cs} + dda a, the da partial
// sum dda dt.
__global__ void __launch_bounds__(kThreads)
ssd_sm90_bwd_finish_kernel(const float* __restrict__ states,
                           const float* __restrict__ ds,
                           const float* __restrict__ cs_in,
                           const float* __restrict__ dt_in,
                           const float* __restrict__ ddt_att,
                           const float* __restrict__ dw_in,
                           const float* __restrict__ rowv,
                           const float* __restrict__ decay,
                           const float* __restrict__ a,
                           float* __restrict__ ddt, float* __restrict__ dap,
                           Dims d, int pn4) {
  extern __shared__ float fsm[];
  float* const dcs_s = fsm;                    // [cl] each
  float* const e_s = dcs_s + d.cl;
  __shared__ float red[4];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int bi = bh / d.H, h = bh % d.H;
  const int t0 = c * d.cl, kv = min(d.cl, d.S - t0);
  const int tid = threadIdx.x, lane = tid % 32;
  const size_t ch = (size_t)bh * d.nc + c, v0 = ch * d.cl;
  const float cs_end = cs_in[v0 + d.cl - 1];

  const float4* const s4 = reinterpret_cast<const float4*>(states) + ch * pn4;
  const float4* const g4 = reinterpret_cast<const float4*>(ds) + ch * pn4;
  float sg = 0.f;
  for (int e = tid; e < pn4; e += kThreads) {
    const float4 s = s4[e], g = g4[e];
    sg += s.x * g.x + s.y * g.y + s.z * g.z + s.w * g.w;
  }
  float dww = 0.f;
  for (int l = tid; l < kv; l += kThreads) {
    const float e = expf(cs_end - cs_in[v0 + l]);
    const float w = dt_in[v0 + l] * e, dw = dw_in[v0 + l];
    e_s[l] = e;
    dcs_s[l] = rowv[v0 + l] - dt_in[v0 + l] * ddt_att[v0 + l] - dw * w;
    dww += dw * w;
  }
  sg = block_sum(sg, red);
  dww = block_sum(dww, red);
  if (tid >= 32) return;
  const float dcs_end = dww + decay[ch] * sg;
  const float av = a[h];
  // warp 0: lane k takes the run of reversed positions m = k per .. ,
  // l = kv - 1 - m
  const int per = (kv + 31) / 32, m0 = lane * per;
  float run = 0.f;
  for (int k = 0; k < per && m0 + k < kv; ++k) run += dcs_s[kv - 1 - m0 - k];
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.f;
  acc += dcs_end;
  float pda = 0.f;
  for (int k = 0; k < per && m0 + k < kv; ++k) {
    const int l = kv - 1 - m0 - k;
    acc += dcs_s[l];                           // dda_l
    ddt[((size_t)bi * d.S + t0 + l) * d.H + h] =
        ddt_att[v0 + l] + dw_in[v0 + l] * e_s[l] + acc * av;
    pda += acc * dt_in[v0 + l];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pda += __shfl_xor_sync(0xffffffffu, pda, o);
  if (lane == 0) dap[ch] = pda;
}

// ============================================================= float32 ==
//
// K3f and K3b in float32 on the CUDA cores, exact in float32: no TF32 and no
// split-TF32 products (the float32 checks hold y, the states and the six
// gradients to 1e-4 of the plain versions). The same phases and launches as
// the 16-bit route: the state passes (B, B') and the finish only ever moved
// float32, so they are launched unchanged; A, C, A' and the column and row
// kernels have the float32 bodies below (named as the 16-bit ones with
// _f32 after them). Bound: FFMA at 67 TFLOP/s (k3_work's ~2 (N + P) flops a
// live pair forward and 2 (3N + 2P) backward are ~100 and ~60 flops a byte
// at mamba2-130m's train shape, over the ~20 where 67 TFLOP/s and 3.35 TB/s
// meet). The first versions (ssd_scan.cu) reached ~3% of it: one CTA per
// (b, h), serial over the chunks, a scalar shared-memory load per FFMA or
// two. Here, as in K2's float32 kernels (flash_attention_sm90.cu):
//   * 256 threads on 64 x 64 tiles; warp w owns 8 rows of the CTA's block,
//     the thread of lane tx (0..15) in half hf rows 8 w + hf + 2 i (i < 4)
//     at columns tx + 16 j (j < 4) of a score tile, and the same rows at
//     the W / 16 columns 64 (c / 4) + 4 tx + c % 4 of a W-wide accumulator;
//   * operands are staged row-major at a row stride of W + 4 floats (an
//     odd number of 16-byte units) by 16-byte cp.async, zeros past kv. A
//     score product (mm_nt32: C B^T, B C^T, X dY^T, dY X^T, with the state
//     C S_in^T and B dS_out^T) reads one 16-byte vector of each of the
//     thread's 4 rows (broadcasts) and of its 4 columns (16 rows on 8 bank
//     groups) a 4-deep step: 4 loads per 32 FFMAs. An accumulating product
//     (mm_nn32: att X, att^T dY, dcb^T C, dcb B, X dS_out, dY S_in) reads
//     one 16-byte vector of the 4 rows of its left operand per 4 steps and
//     the thread's columns of each step's row: 3 loads per 32 FFMAs at
//     N 128, 4 at 64;
//   * a score tile passes through shared memory (row stride 80) from the
//     registers of the thread that masked and scaled it to the product
//     that reads it; each warp reads back only its own 8 rows, so a
//     __syncwarp orders them. The decay e^{cs_l - cs_s} is taken only
//     under the mask, and the mask is evaluated only on the diagonal tile;
//   * A, A' and the column and row kernels walk their tiles through a
//     two-slot ring, the next tile's copies in flight under this tile's
//     products, one barrier a tile; the state a block reads once (dS_out,
//     S_in) is staged into the second slot and used before the walk, so it
//     takes no room of its own. The chunk scan keeps one slot each for B_s
//     and X_s, each loading under the other's product (two barriers a
//     tile), and S_in in B_s's slot after the walk, so that two of its
//     CTAs share an SM;
//   * the deposits (A, A'), outer products over the chunk's rows, give
//     each thread 4 rows p and N / 16 columns n of the (P, N) state: one
//     16-byte V vector and N / 64 W vectors a row.
// Shared memory at N 128 [64], cl 256: A and A' 105,472 [72,704] bytes
// (two CTAs an SM), the chunk scan 107,520 [74,752; two an SM], the column
// and row kernels 176,128 [126,976]. Every sum keeps a fixed order with no
// atomics, so two calls agree bit for bit.

constexpr int kT32 = 256;                  // threads of a float32 CTA
constexpr int kSP = kP + 4;                // row stride of a P-wide tile
constexpr int kS32 = 80;                   // row stride of a score tile

struct F32 {};                             // dt's tag: float32, as it is

__host__ __device__ constexpr int pad64(int n) {
  return (n + kRows - 1) / kRows * kRows;
}

// rows [r0, r0 + 64) of a chunk's (rows, W) float32 operand into shared
// memory at dst, row stride W + 4 floats, by 16-byte cp.async; rows at or
// past kv read as zeros. src points at the chunk's row 0, rows row_stride
// floats apart.
template <int W>
__device__ __forceinline__ void stage32(float* dst, const float* src,
                                        size_t row_stride, int r0, int kv) {
  constexpr int C = W / 4;                 // 16-byte pieces a row
  const uint32_t d0 = smem_u32(dst);
  for (int e = threadIdx.x; e < kRows * C; e += kT32) {
    const int r = e / C, j = e % C;
    const int l = r0 + r;
    const bool ok = l < kv;
    cp_async16(d0 + 4u * (uint32_t)(r * (W + 4) + 4 * j),
               src + (ok ? (size_t)l * row_stride + 4 * j : 0), ok);
  }
}

// out[i][j] = sum_k a[2 i][k] b[16 j][k], k < K: a points at the thread's
// first row, b at its first column's row, rows SA and SB floats apart
template <int K, int SA, int SB>
__device__ __forceinline__ void mm_nt32(const float* a, const float* b,
                                        float (&out)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + 2 * i * SA + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 16 * j * SB + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(x[i].x, y[j].x, out[i][j]);
        out[i][j] = fmaf(x[i].y, y[j].y, out[i][j]);
        out[i][j] = fmaf(x[i].z, y[j].z, out[i][j]);
        out[i][j] = fmaf(x[i].w, y[j].w, out[i][j]);
      }
  }
}

// the thread's W / 16 columns 64 (c / 4) + 4 tx + c % 4 of a row
template <int W>
__device__ __forceinline__ void load_cols32(const float* row, int tx,
                                            float (&v)[W / 16]) {
#pragma unroll
  for (int h = 0; h < W / 64; ++h) {
    const float4 q = *reinterpret_cast<const float4*>(row + 64 * h + 4 * tx);
    v[4 * h] = q.x; v[4 * h + 1] = q.y; v[4 * h + 2] = q.z;
    v[4 * h + 3] = q.w;
  }
}

// acc[i][c] += sum_r p[2 i][r] t[r][64 (c / 4) + 4 tx + c % 4], r < 64: p
// points at the thread's first row (rows SP floats apart), t at a staged
// W-wide tile (rows W + 4 apart)
template <int W, int SP>
__device__ __forceinline__ void mm_nn32(const float* p, const float* t,
                                        int tx, float (&acc)[4][W / 16]) {
  constexpr int C = W / 16;
#pragma unroll 2
  for (int r0 = 0; r0 < kRows; r0 += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(p + 2 * i * SP + r0);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float v[C];
      load_cols32<W>(t + (r0 + rr) * (W + 4), tx, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = rr == 0 ? pa[i].x : rr == 1 ? pa[i].y
                        : rr == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(w, v[c], acc[i][c]);
      }
    }
  }
}

// acc += the score-layout tile o (rows 2 i, columns tx + 16 j of the
// thread) times the rows' scales, in the accumulator layout (columns
// 4 tx + c), through the warp's own rows of buf (row stride kS32); buf is
// free again after
__device__ __forceinline__ void to_acc32(const float (&o)[4][4],
                                         const float (&scale)[4], float* buf,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      buf[2 * i * kS32 + tx + 16 * j] = o[i][j] * scale[i];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(buf + 2 * i * kS32 +
                                                      4 * tx);
    acc[i][0] += v.x; acc[i][1] += v.y; acc[i][2] += v.z; acc[i][3] += v.w;
  }
  __syncwarp();
}

// the sum of v over the 16 lanes of a half-warp (a row's tx), in a fixed
// order
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a chunk's deposit V^T (scale . W), (P, N), over its rows l < kv, 64 at a
// time through the two-slot ring (each slot V's rows, P wide, then W's, N
// wide). The thread (pg = tid % 16, ng = tid / 16) sums rows p = 4 pg + e
// (e < 4) at columns 64 (c / 4) + 4 ng + c % 4. scale is zero past kv and
// padded to whole tiles.
template <int N>
__device__ __forceinline__ void deposit32(float (&acc)[4][N / 16],
                                          float* ring, const float* vb,
                                          size_t vrow, const float* wb,
                                          size_t wrow, const float* scale,
                                          int kv) {
  constexpr int SN = N + 4, kSlot = kRows * (kSP + SN), C = N / 16;
  const int pg = threadIdx.x % 16, ng = threadIdx.x / 16;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[e][c] = 0.f;
  const int n_tiles = (kv + kRows - 1) / kRows;
  stage32<kP>(ring, vb, vrow, 0, kv);
  stage32<N>(ring + kRows * kSP, wb, wrow, 0, kv);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();              // tile t landed
    __syncthreads();                 // for every thread; tile t - 1 is done
    if (t + 1 < n_tiles) {
      float* const nxt = ring + ((t + 1) & 1) * kSlot;
      stage32<kP>(nxt, vb, vrow, (t + 1) * kRows, kv);
      stage32<N>(nxt + kRows * kSP, wb, wrow, (t + 1) * kRows, kv);
      cp_async_commit();
    }
    const float* const v_t = ring + (t & 1) * kSlot;
    const float* const w_t = v_t + kRows * kSP;
    const float* const sc = scale + t * kRows;
#pragma unroll 2
    for (int r0 = 0; r0 < kRows; r0 += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(sc + r0);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float s = rr == 0 ? s4.x : rr == 1 ? s4.y
                        : rr == 2 ? s4.z : s4.w;
        const float4 v = *reinterpret_cast<const float4*>(
            v_t + (r0 + rr) * kSP + 4 * pg);
        const float vs[4] = {v.x * s, v.y * s, v.z * s, v.w * s};
        float w[C];
        load_cols32<N>(w_t + (r0 + rr) * SN, ng, w);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[e][c] = fmaf(vs[e], w[c], acc[e][c]);
      }
    }
  }
}

// deposit32's accumulator into a (P, N) float32 state
template <int N>
__device__ __forceinline__ void store_state32(float* dst,
                                              const float (&acc)[4][N / 16]) {
  const int pg = threadIdx.x % 16, ng = threadIdx.x / 16;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int h = 0; h < N / 64; ++h)
      *reinterpret_cast<float4*>(dst + (size_t)(4 * pg + e) * N + 64 * h +
                                 4 * ng) =
          make_float4(acc[e][4 * h], acc[e][4 * h + 1], acc[e][4 * h + 2],
                      acc[e][4 * h + 3]);
}

// ------------------------------------------- A, float32: chunk states --

template <int N>
__global__ void __launch_bounds__(kT32, 2)
ssd_sm90_chunk_state_kernel_f32(const float* __restrict__ x,
                                const float* __restrict__ dt,
                                const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ states,
                                float* __restrict__ cs_out,
                                float* __restrict__ decay, Dims d) {
  extern __shared__ float4 smem32[];
  const int cl_pad = pad64(d.cl);
  float* const ring = reinterpret_cast<float*>(smem32);     // [2] slots
  float* const dt_s = ring + 2 * kRows * (kSP + N + 4);     // [cl_pad] each
  float* const cs_s = dt_s + cl_pad;
  float* const w_s = cs_s + cl_pad;

  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bi * d.H + h;

  chunk_cs<F32, float, kT32>(dt, ((size_t)bi * d.S + t0) * d.H + h, d.H,
                             a[h], d.cl, kv, dt_s, cs_s);
  const float cs_end = cs_s[d.cl - 1];
  float* const cs_g = cs_out + (bh * d.nc + c) * d.cl;
  for (int l = tid; l < cl_pad; l += kT32) {
    if (l < d.cl) cs_g[l] = cs_s[l];
    w_s[l] = l < kv ? dt_s[l] * expf(cs_end - cs_s[l]) : 0.f;
  }
  if (tid == 0) decay[bh * d.nc + c] = expf(cs_end);

  // the deposit X^T (w . B); deposit32's first barrier orders w_s
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  float acc[4][N / 16];
  deposit32<N>(acc, ring,
               x + ((size_t)bi * d.S + t0) * xrow + (size_t)h * kP, xrow,
               b + ((size_t)bi * d.S + t0) * brow + (size_t)g * N, brow, w_s,
               kv);
  store_state32<N>(states + (bh * d.nc + c) * (size_t)(kP * N), acc);
}

// -------------------------------------------- C, float32: chunk scan --

// One CTA per (b, h, chunk, 64-row block l0), longest first: over the
// column tiles s0 <= l0 the scores C_blk B_s^T, masked and scaled to att =
// scores e^{cs_l - cs_s} dt_s, and y_blk += att X_s; then y_blk +=
// e^{cs_l} C_blk S_in^T, S_in loaded into B's slot under the last tile's
// att X_s. One slot each for B_s and X_s: X_s loads under the scores,
// the next B_s under att X_s, two barriers a tile, so that two CTAs share
// an SM (107,520 bytes at N 128, cl 256).
template <int N>
__global__ void __launch_bounds__(kT32, 2)
ssd_sm90_chunk_scan_kernel_f32(const float* __restrict__ x,
                               const float* __restrict__ dt,
                               const float* __restrict__ b,
                               const float* __restrict__ cm,
                               const float* __restrict__ states,
                               const float* __restrict__ cs_in,
                               float* __restrict__ y, int has_init, Dims d) {
  constexpr int SN = N + 4;
  extern __shared__ float4 smem32[];
  float* const c_s = reinterpret_cast<float*>(smem32);   // [64][SN] C_blk
  float* const b_s = c_s + kRows * SN;      // [64][SN] B_s, then S_in
  float* const x_s = b_s + kRows * SN;      // [64][kSP] X_s
  float* const buf = x_s + kRows * kSP;     // [64][kS32] att
  float* const cs_s = buf + kRows * kS32;   // [cl_pad] each
  float* const dt_s = cs_s + pad64(d.cl);

  const int bh = blockIdx.x, c = blockIdx.y;
  const int rblk = gridDim.z - 1 - blockIdx.z;  // longest row blocks first
  const int l0 = rblk * kRows, t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  if (l0 >= kv) return;                         // rows past S
  const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int tid = threadIdx.x, tx = tid % 16;
  const int rb = 8 * (tid / 32) + (tid / 16) % 2;   // rows rb + 2 i
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const size_t tok = (size_t)bi * d.S + t0;
  const float* const xb = x + tok * xrow + (size_t)h * kP;
  const float* const bb = b + tok * brow + (size_t)g * N;
  const float* const cb = cm + tok * brow + (size_t)g * N;
  const size_t ch = (size_t)bh * d.nc + c;
  const int n_tiles = rblk + 1;                 // column tiles s0 <= l0
  const bool with_state = has_init || c > 0;

  stage32<N>(c_s, cb, brow, l0, kv);
  stage32<N>(b_s, bb, brow, 0, kv);
  cp_async_commit();
  // cs past the chunk's rows as at its last row (dt = 0 there); dt zero
  for (int l = tid; l < l0 + kRows; l += kT32) {
    cs_s[l] = cs_in[ch * d.cl + min(l, d.cl - 1)];
    dt_s[l] = l < kv ? dt[(tok + l) * d.H + h] : 0.f;
  }

  float yacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();           // B_t (and C_blk) landed
    __syncthreads();              // for every thread; att X_{t-1} is done
    const int s0 = t * kRows;
    stage32<kP>(x_s, xb, xrow, s0, kv);
    cp_async_commit();
    float sc[4][4];
    mm_nt32<N, SN, SN>(c_s + rb * SN, b_s + tx * SN, sc);
    const bool diag = t == rblk;
    float cj[4], dj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cj[j] = cs_s[s0 + tx + 16 * j];
      dj[j] = dt_s[s0 + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + rb + 2 * i;
      const float csl = cs_s[l];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        buf[(rb + 2 * i) * kS32 + tx + 16 * j] =
            !diag || s0 + tx + 16 * j <= l
                ? sc[i][j] * exp2f((csl - cj[j]) * kLog2e) * dj[j]
                : 0.f;
    }
    cp_async_wait<0>();           // X_t landed
    __syncthreads();              // for every thread; the scores are done
    if (t + 1 < n_tiles) {
      stage32<N>(b_s, bb, brow, s0 + kRows, kv);
      cp_async_commit();
    } else if (with_state) {      // S_in, rows p
      stage32<N>(b_s, states + ch * (kP * N), N, 0, kP);
      cp_async_commit();
    }
    mm_nn32<kP, kS32>(buf + rb * kS32, x_s, tx, yacc);
  }
  if (with_state) {
    cp_async_wait<0>();           // S_in landed
    __syncthreads();
    float o[4][4], e[4];
    mm_nt32<N, SN, SN>(c_s + rb * SN, b_s + tx * SN, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = expf(cs_s[l0 + rb + 2 * i]);
    to_acc32(o, e, buf + rb * kS32, tx, yacc);
  }

  // rows at or past kv are never stored
  float* const yb = y + tok * xrow + (size_t)h * kP;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + rb + 2 * i;
    if (l < kv)
      *reinterpret_cast<float4*>(yb + (size_t)l * xrow + 4 * tx) =
          make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
  }
}

// ---------------------------------------- A', float32: the dS deposits --

template <int N>
__global__ void __launch_bounds__(kT32, 2)
ssd_sm90_bwd_deposit_kernel_f32(const float* __restrict__ dy,
                                const float* __restrict__ dt,
                                const float* __restrict__ a,
                                const float* __restrict__ cm,
                                float* __restrict__ ds,
                                float* __restrict__ cs_out,
                                float* __restrict__ dt_out,
                                float* __restrict__ decay, Dims d) {
  extern __shared__ float4 smem32[];
  const int cl_pad = pad64(d.cl);
  float* const ring = reinterpret_cast<float*>(smem32);     // [2] slots
  float* const dt_s = ring + 2 * kRows * (kSP + N + 4);     // [cl_pad] each
  float* const cs_s = dt_s + cl_pad;
  float* const ecs_s = cs_s + cl_pad;

  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bi * d.H + h;

  chunk_cs<F32, float, kT32>(dt, ((size_t)bi * d.S + t0) * d.H + h, d.H,
                             a[h], d.cl, kv, dt_s, cs_s);
  const size_t v0 = (bh * d.nc + c) * d.cl;
  for (int l = tid; l < cl_pad; l += kT32) {
    if (l < d.cl) {
      cs_out[v0 + l] = cs_s[l];
      dt_out[v0 + l] = dt_s[l];
    }
    ecs_s[l] = l < kv ? expf(cs_s[l]) : 0.f;
  }
  if (tid == 0) decay[bh * d.nc + c] = expf(cs_s[d.cl - 1]);

  // D_c = (ecs . dY)^T C
  const size_t yrow = (size_t)d.H * kP, crow = (size_t)d.G * N;
  float acc[4][N / 16];
  deposit32<N>(acc, ring,
               dy + ((size_t)bi * d.S + t0) * yrow + (size_t)h * kP, yrow,
               cm + ((size_t)bi * d.S + t0) * crow + (size_t)g * N, crow,
               ecs_s, kv);
  store_state32<N>(ds + (bh * d.nc + c) * (size_t)(kP * N), acc);
}

// ------------------------------------ C', float32: the column kernel --

// One CTA per (b, h, chunk, 64-position column block s0), longest first:
// before the walk, dx_s = w . (B_s dS_out^T), X_s dS_out into db_s (times
// w) and dw_s = sum_n (X_s dS_out) . b_s; then over the row tiles l0 >= s0
// the transposed scores B_s C_l^T and X_s dY_l^T give att^T, dcb^T and q^T
// = (datt CB decay)^T, dx_s += att^T dY_l, db_s += dcb^T C_l and the
// column sums of q (ddt_att).
template <int N>
__global__ void __launch_bounds__(kT32, 1)
ssd_sm90_bwd_column_kernel_f32(const float* __restrict__ x,
                               const float* __restrict__ b,
                               const float* __restrict__ cm,
                               const float* __restrict__ dy,
                               const float* __restrict__ ds,
                               const float* __restrict__ cs_in,
                               const float* __restrict__ dt_in,
                               float* __restrict__ dx, float* __restrict__ dbh,
                               float* __restrict__ ddt_att,
                               float* __restrict__ dw_out, Dims d) {
  constexpr int SN = N + 4, kSlot = kRows * (SN + kSP), C = N / 16;
  extern __shared__ float4 smem32[];
  float* const b_s = reinterpret_cast<float*>(smem32);   // [64][SN] B_s
  float* const x_s = b_s + kRows * SN;      // [64][kSP] X_s
  float* const ring = x_s + kRows * kSP;    // [2] slots: C_l rows, dY_l rows
  float* const buf = ring + 2 * kSlot;      // [64][kS32] att^T, dcb^T
  float* const cs_s = buf + kRows * kS32;   // [cl_pad] each
  float* const dt_s = cs_s + pad64(d.cl);

  const int bh = blockIdx.x, c = blockIdx.y, sb = blockIdx.z;
  const int s0 = sb * kRows, t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  if (s0 >= kv) return;                         // columns past S
  const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int tid = threadIdx.x, tx = tid % 16;
  const int rb = 8 * (tid / 32) + (tid / 16) % 2;   // rows rb + 2 i
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const size_t tok = (size_t)bi * d.S + t0;
  const float* const xb = x + tok * xrow + (size_t)h * kP;
  const float* const yb = dy + tok * xrow + (size_t)h * kP;
  const float* const bb = b + tok * brow + (size_t)g * N;
  const float* const cb = cm + tok * brow + (size_t)g * N;
  const size_t ch = (size_t)bh * d.nc + c;
  const int n_tiles = (kv + kRows - 1) / kRows - sb;   // row tiles l0 >= s0

  stage32<N>(b_s, bb, brow, s0, kv);
  stage32<kP>(x_s, xb, xrow, s0, kv);
  stage32<N>(ring, cb, brow, s0, kv);
  stage32<kP>(ring + kRows * SN, yb, xrow, s0, kv);
  stage32<N>(ring + kSlot, ds + ch * (kP * N), N, 0, kP);  // dS_out, slot 1
  cp_async_commit();
  for (int l = s0 + tid; l < s0 + n_tiles * kRows; l += kT32) {
    cs_s[l] = cs_in[ch * d.cl + min(l, d.cl - 1)];
    dt_s[l] = l < d.cl ? dt_in[ch * d.cl + l] : 0.f;
  }
  const float cs_end = cs_in[ch * d.cl + d.cl - 1];
  cp_async_wait<0>();
  __syncthreads();

  // dt_s and w_s of the thread's rows (0 past kv, where dt is)
  float dtr[4], wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + rb + 2 * i;
    dtr[i] = dt_s[s];
    wr[i] = dtr[i] * expf(cs_end - cs_s[s]);
  }
  // the state terms
  const float* const ds_t = ring + kSlot;
  float dxa[4][4], dba[4][C], dwr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dxa[i][j] = 0.f;
  {
    float o[4][4];
    mm_nt32<N, SN, SN>(b_s + rb * SN, ds_t + tx * SN, o);   // B_s dS_out^T
    to_acc32(o, wr, buf + rb * kS32, tx, dxa);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) dba[i][k] = 0.f;
  mm_nn32<N, kSP>(x_s + rb * kSP, ds_t, tx, dba);           // X_s dS_out
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bv[C];
    load_cols32<N>(b_s + (rb + 2 * i) * SN, tx, bv);
    dwr[i] = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      dwr[i] = fmaf(dba[i][k], bv[k], dwr[i]);
      dba[i][k] *= wr[i];
    }
  }
  __syncthreads();                // every warp is past dS_out: slot 1 free

  float qr[4] = {0.f, 0.f, 0.f, 0.f};         // the column sums of q
  for (int t = 0; t < n_tiles; ++t) {
    if (t) {
      cp_async_wait<0>();         // tile t landed
      __syncthreads();            // for every thread; tile t - 1 is done
    }
    if (t + 1 < n_tiles) {
      float* const nxt = ring + ((t + 1) & 1) * kSlot;
      const int l1 = s0 + (t + 1) * kRows;
      stage32<N>(nxt, cb, brow, l1, kv);
      stage32<kP>(nxt + kRows * SN, yb, xrow, l1, kv);
      cp_async_commit();
    }
    const int l0 = s0 + t * kRows;
    const float* const ct = ring + (t & 1) * kSlot;
    const float* const yt = ct + kRows * SN;
    float sc[4][4], da[4][4];
    mm_nt32<N, SN, SN>(b_s + rb * SN, ct + tx * SN, sc);        // B_s C_l^T
    mm_nt32<kP, kSP, kSP>(x_s + rb * kSP, yt + tx * kSP, da);   // X_s dY_l^T
    const bool diag = t == 0;
    float cj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cj[j] = cs_s[l0 + tx + 16 * j];
    // rows s, columns l: live where s <= l (only the diagonal tile has
    // s > l); rows and columns past kv are zeros
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + rb + 2 * i;
      const float css = cs_s[s];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = !diag || s <= l0 + tx + 16 * j
                            ? exp2f((cj[j] - css) * kLog2e) : 0.f;
        qr[i] = fmaf(da[i][j] * sc[i][j], e, qr[i]);
        const float ed = e * dtr[i];
        buf[(rb + 2 * i) * kS32 + tx + 16 * j] = sc[i][j] * ed;  // att^T
        da[i][j] *= ed;                                          // dcb^T
      }
    }
    __syncwarp();
    mm_nn32<kP, kS32>(buf + rb * kS32, yt, tx, dxa);   // dx_s += att^T dY_l
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        buf[(rb + 2 * i) * kS32 + tx + 16 * j] = da[i][j];
    __syncwarp();
    mm_nn32<N, kS32>(buf + rb * kS32, ct, tx, dba);    // db_s += dcb^T C_l
  }

  // per-row sums, then the rows below kv
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qr[i] = half_sum(qr[i]);
    dwr[i] = half_sum(dwr[i]);
  }
  const size_t hrow = (size_t)d.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + rb + 2 * i;
    if (s >= kv) continue;
    if (tx == 0) {
      ddt_att[ch * d.cl + s] = qr[i];
      dw_out[ch * d.cl + s] = dwr[i];
    }
    *reinterpret_cast<float4*>(dx + ((tok + s) * hrow + h) * kP + 4 * tx) =
        make_float4(dxa[i][0], dxa[i][1], dxa[i][2], dxa[i][3]);
    float* const dbr = dbh + ((tok + s) * hrow + h) * N;
#pragma unroll
    for (int k = 0; k < N / 64; ++k)
      *reinterpret_cast<float4*>(dbr + 64 * k + 4 * tx) =
          make_float4(dba[i][4 * k], dba[i][4 * k + 1], dba[i][4 * k + 2],
                      dba[i][4 * k + 3]);
  }
}

// --------------------------------------- C', float32: the row kernel --

// One CTA per (b, h, chunk, 64-row block l0), longest first: before the
// walk, y_off = e^{cs_l} C_l S_in^T into the row term sum_p dy . y_off, and
// dc_l = e^{cs_l} dY_l S_in; then over the column tiles s0 <= l0, C_l B_s^T
// and dY_l X_s^T give dcb, dc_l += dcb B_s and the row sums of dseg = q
// dt_s. It leaves each row's dseg row sum plus sum_p dy . y_off in rowv.
template <int N>
__global__ void __launch_bounds__(kT32, 1)
ssd_sm90_bwd_row_kernel_f32(const float* __restrict__ x,
                            const float* __restrict__ b,
                            const float* __restrict__ cm,
                            const float* __restrict__ dy,
                            const float* __restrict__ states,
                            const float* __restrict__ cs_in,
                            const float* __restrict__ dt_in,
                            float* __restrict__ dch, float* __restrict__ rowv,
                            Dims d) {
  constexpr int SN = N + 4, kSlot = kRows * (SN + kSP), C = N / 16;
  extern __shared__ float4 smem32[];
  float* const c_s = reinterpret_cast<float*>(smem32);   // [64][SN] C_l
  float* const y_s = c_s + kRows * SN;      // [64][kSP] dY_l
  float* const ring = y_s + kRows * kSP;    // [2] slots: B_s rows, X_s rows
  float* const buf = ring + 2 * kSlot;      // [64][kS32] dcb
  float* const cs_s = buf + kRows * kS32;   // [cl_pad] each
  float* const dt_s = cs_s + pad64(d.cl);

  const int bh = blockIdx.x, c = blockIdx.y;
  const int rblk = gridDim.z - 1 - blockIdx.z;  // longest row blocks first
  const int l0 = rblk * kRows, t0 = c * d.cl;
  const int kv = min(d.cl, d.S - t0);
  if (l0 >= kv) return;                         // rows past S
  const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int tid = threadIdx.x, tx = tid % 16;
  const int rb = 8 * (tid / 32) + (tid / 16) % 2;   // rows rb + 2 i
  const size_t xrow = (size_t)d.H * kP, brow = (size_t)d.G * N;
  const size_t tok = (size_t)bi * d.S + t0;
  const float* const xb = x + tok * xrow + (size_t)h * kP;
  const float* const yb = dy + tok * xrow + (size_t)h * kP;
  const float* const bb = b + tok * brow + (size_t)g * N;
  const float* const cb = cm + tok * brow + (size_t)g * N;
  const size_t ch = (size_t)bh * d.nc + c;
  const int n_tiles = rblk + 1;                 // column tiles s0 <= l0

  stage32<N>(c_s, cb, brow, l0, kv);
  stage32<kP>(y_s, yb, xrow, l0, kv);
  stage32<N>(ring, bb, brow, 0, kv);
  stage32<kP>(ring + kRows * SN, xb, xrow, 0, kv);
  stage32<N>(ring + kSlot, states + ch * (kP * N), N, 0, kP);  // S_in
  cp_async_commit();
  for (int l = tid; l < l0 + kRows; l += kT32) {
    cs_s[l] = cs_in[ch * d.cl + min(l, d.cl - 1)];
    dt_s[l] = l < d.cl ? dt_in[ch * d.cl + l] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the y_off terms
  const float* const si = ring + kSlot;
  float er[4], rr[4], dca[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) er[i] = expf(cs_s[l0 + rb + 2 * i]);
  {
    float o[4][4];
    mm_nt32<N, SN, SN>(c_s + rb * SN, si + tx * SN, o);     // C_l S_in^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rr[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rr[i] = fmaf(o[i][j], y_s[(rb + 2 * i) * kSP + tx + 16 * j], rr[i]);
      rr[i] *= er[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) dca[i][k] = 0.f;
  mm_nn32<N, kSP>(y_s + rb * kSP, si, tx, dca);            // dY_l S_in
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k) dca[i][k] *= er[i];
  __syncthreads();                // every warp is past S_in: slot 1 free

  for (int t = 0; t < n_tiles; ++t) {
    if (t) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (t + 1 < n_tiles) {
      float* const nxt = ring + ((t + 1) & 1) * kSlot;
      stage32<N>(nxt, bb, brow, (t + 1) * kRows, kv);
      stage32<kP>(nxt + kRows * SN, xb, xrow, (t + 1) * kRows, kv);
      cp_async_commit();
    }
    const int s0 = t * kRows;
    const float* const bt = ring + (t & 1) * kSlot;
    float sc[4][4], da[4][4];
    mm_nt32<N, SN, SN>(c_s + rb * SN, bt + tx * SN, sc);              // C_l B_s^T
    mm_nt32<kP, kSP, kSP>(y_s + rb * kSP, bt + kRows * SN + tx * kSP, da);
    const bool diag = t == rblk;
    float cj[4], dj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cj[j] = cs_s[s0 + tx + 16 * j];
      dj[j] = dt_s[s0 + tx + 16 * j];
    }
    // rows l, columns s: live where s <= l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + rb + 2 * i;
      const float csl = cs_s[l];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dcb = !diag || s0 + tx + 16 * j <= l
                              ? da[i][j] * exp2f((csl - cj[j]) * kLog2e) *
                                    dj[j]
                              : 0.f;
        rr[i] = fmaf(dcb, sc[i][j], rr[i]);
        buf[(rb + 2 * i) * kS32 + tx + 16 * j] = dcb;
      }
    }
    __syncwarp();
    mm_nn32<N, kS32>(buf + rb * kS32, bt, tx, dca);   // dc_l += dcb B_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) rr[i] = half_sum(rr[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + rb + 2 * i;
    if (l >= kv) continue;
    if (tx == 0) rowv[ch * d.cl + l] = rr[i];
    float* const dcr = dch + ((tok + l) * d.H + h) * N;
#pragma unroll
    for (int k = 0; k < N / 64; ++k)
      *reinterpret_cast<float4*>(dcr + 64 * k + 4 * tx) =
          make_float4(dca[i][4 * k], dca[i][4 * k + 1], dca[i][4 * k + 2],
                      dca[i][4 * k + 3]);
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
// float32: A and A' (two ring slots of P- and N-wide rows, three vectors),
// the chunk scan (C_blk, B_s's and X_s's slots, the score tile, two
// vectors)
size_t state_smem32(int n, int cl) {
  return sizeof(float) * ((size_t)2 * kRows * (kSP + n + 4) + 3 * pad64(cl));
}
size_t scan_smem32(int n, int cl) {
  return sizeof(float) * ((size_t)kRows * (2 * (n + 4) + kSP) + kRows * kS32 +
                          2 * pad64(cl));
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

// B, the state pass, which every dtype shares
int state_pass(const Args& a) {
  const int pn4 = kP * a.d.N / 4;
  ssd_sm90_state_pass_kernel<<<dim3(a.d.B * a.d.H,
                                    (pn4 + kThreads - 1) / kThreads),
                               kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.init), static_cast<const float*>(a.decay),
      static_cast<float*>(a.states), static_cast<float*>(a.final_state),
      a.d.nc, pn4);
  return (int)cudaGetLastError();
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
  if ((err = (int)cudaGetLastError()) || (err = state_pass(a))) return err;
  ssd_sm90_chunk_scan_kernel<Tag, N, TD>
      <<<dim3(d.B * d.H, d.nc, (d.cl + kRows - 1) / kRows), kThreads, sc,
         a.stream>>>(x, dt, b, static_cast<const uint16_t*>(a.c), states, cs,
                     static_cast<uint16_t*>(a.y), a.init != nullptr, d);
  return (int)cudaGetLastError();
}

template <int N>
int run32(const Args& a) {
  const Dims& d = a.d;
  const size_t sa = state_smem32(N, d.cl), sc = scan_smem32(N, d.cl);
  int err;
  if ((err = prepare(ssd_sm90_chunk_state_kernel_f32<N>, sa)) ||
      (err = prepare(ssd_sm90_chunk_scan_kernel_f32<N>, sc)))
    return err;
  const float* x = static_cast<const float*>(a.x);
  const float* dt = static_cast<const float*>(a.dt);
  const float* b = static_cast<const float*>(a.b);
  float* states = static_cast<float*>(a.states);
  float* cs = static_cast<float*>(a.cs);
  ssd_sm90_chunk_state_kernel_f32<N>
      <<<dim3(d.nc, d.H, d.B), kT32, sa, a.stream>>>(
          x, dt, static_cast<const float*>(a.a), b, states, cs,
          static_cast<float*>(a.decay), d);
  if ((err = (int)cudaGetLastError()) || (err = state_pass(a))) return err;
  ssd_sm90_chunk_scan_kernel_f32<N>
      <<<dim3(d.B * d.H, d.nc, pad64(d.cl) / kRows), kT32, sc, a.stream>>>(
          x, dt, b, static_cast<const float*>(a.c), states, cs,
          static_cast<float*>(a.y), a.init != nullptr, d);
  return (int)cudaGetLastError();
}

template <typename Tag, typename TD>
int run_n(const Args& a) {
  if (a.d.N == 64) return run<Tag, 64, TD>(a);
  if (a.d.N == 128) return run<Tag, 128, TD>(a);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16, 2 float16; dt_dtype 0 (float32) or dtype
int dispatch(int dtype, int dt_dtype, int P, const Args& a) {
  const Dims& d = a.d;
  if (d.B <= 0 || d.S <= 0 || d.H <= 0 || d.G <= 0 || d.H % d.G != 0 ||
      P != kP || d.cl <= 0 || d.nc != (d.S + d.cl - 1) / d.cl ||
      d.nc > 65535 || (dt_dtype != 0 && dt_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d.N == 64) return run32<64>(a);
    if (d.N == 128) return run32<128>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return dt_dtype ? run_n<Bf16, uint16_t>(a) : run_n<Bf16, float>(a);
  if (dtype == 2)
    return dt_dtype ? run_n<F16, uint16_t>(a) : run_n<F16, float>(a);
  return (int)cudaErrorInvalidValue;
}


// ------------------------------------------------------- K3b launches --

// the column and row kernels' dynamic shared memory (kernels/ssd_scan.py's
// smem_bytes mirrors it); the deposit kernel takes state_smem's
size_t bwd_block_smem(int n, int cl) {
  return 1024 + (size_t)(4 * (n / 64) + 3) * kTile +
         2 * sizeof(float) * ((cl + kRows - 1) / kRows * kRows);
}
// float32: the block's two operands, the ring, the score tile, two vectors
size_t bwd_block_smem32(int n, int cl) {
  return sizeof(float) * ((size_t)3 * kRows * (n + 4 + kSP) + kRows * kS32 +
                          2 * pad64(cl));
}

struct BwdArgs {
  const void *x, *dt, *a, *b, *c, *states, *dy, *dfinal;
  void *dx, *ddt, *dbh, *dch, *dinit, *scratch;
  Dims d;
  cudaStream_t stream;
};

// the scratch: the dS buffer (B, H, nc, P, N), then cs, dt, ddt_att, dw and
// the row terms (B, H, nc, cl) each, the decays and the da partials (B, H,
// nc) each
struct Scratch {
  float *ds, *cs, *dtv, *ddt_att, *dw, *rowv, *decay, *dap;
  explicit Scratch(const BwdArgs& a) {
    const Dims& d = a.d;
    const size_t n_c = (size_t)d.B * d.H * d.nc, n_v = n_c * d.cl;
    ds = static_cast<float*>(a.scratch);
    cs = ds + n_c * kP * d.N;
    dtv = cs + n_v;
    ddt_att = dtv + n_v;
    dw = ddt_att + n_v;
    rowv = dw + n_v;
    decay = rowv + n_v;
    dap = decay + n_c;
  }
};

// B', the reverse dS pass, which every dtype shares
int dstate_pass(const BwdArgs& a, const Scratch& s) {
  const int pn4 = kP * a.d.N / 4;
  ssd_sm90_bwd_dstate_pass_kernel<<<dim3(a.d.B * a.d.H,
                                         (pn4 + kThreads - 1) / kThreads),
                                    kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.dfinal), s.decay, s.ds,
      static_cast<float*>(a.dinit), a.d.nc, pn4);
  return (int)cudaGetLastError();
}

// the finish, which every dtype shares
int finish(const BwdArgs& a, const Scratch& s) {
  const Dims& d = a.d;
  const size_t sf = 2 * sizeof(float) * d.cl;
  int err;
  if ((err = prepare(ssd_sm90_bwd_finish_kernel, sf))) return err;
  ssd_sm90_bwd_finish_kernel<<<dim3(d.B * d.H, d.nc), kThreads, sf,
                               a.stream>>>(
      static_cast<const float*>(a.states), s.ds, s.cs, s.dtv, s.ddt_att,
      s.dw, s.rowv, s.decay, static_cast<const float*>(a.a),
      static_cast<float*>(a.ddt), s.dap, d, kP * d.N / 4);
  return (int)cudaGetLastError();
}

template <typename Tag, int N, typename TD, typename TY>
int run_bwd(const BwdArgs& a) {
  const Dims& d = a.d;
  const size_t sa = state_smem(N, d.cl), sc = bwd_block_smem(N, d.cl);
  int err;
  if ((err = prepare(ssd_sm90_bwd_deposit_kernel<Tag, N, TD, TY>, sa)) ||
      (err = prepare(ssd_sm90_bwd_column_kernel<Tag, N, TY>, sc)) ||
      (err = prepare(ssd_sm90_bwd_row_kernel<Tag, N, TY>, sc)))
    return err;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  const uint16_t* b = static_cast<const uint16_t*>(a.b);
  const uint16_t* c = static_cast<const uint16_t*>(a.c);
  const TY* dy = static_cast<const TY*>(a.dy);
  const float* states = static_cast<const float*>(a.states);
  const Scratch s(a);
  const int nrb = (d.cl + kRows - 1) / kRows;
  ssd_sm90_bwd_deposit_kernel<Tag, N, TD, TY>
      <<<dim3(d.nc, d.H, d.B), kThreads, sa, a.stream>>>(
          dy, static_cast<const TD*>(a.dt), static_cast<const float*>(a.a),
          c, s.ds, s.cs, s.dtv, s.decay, d);
  if ((err = (int)cudaGetLastError()) || (err = dstate_pass(a, s)))
    return err;
  ssd_sm90_bwd_column_kernel<Tag, N, TY>
      <<<dim3(d.B * d.H, d.nc, nrb), kThreads, sc, a.stream>>>(
          x, b, c, dy, s.ds, s.cs, s.dtv, static_cast<float*>(a.dx),
          static_cast<float*>(a.dbh), s.ddt_att, s.dw, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_sm90_bwd_row_kernel<Tag, N, TY>
      <<<dim3(d.B * d.H, d.nc, nrb), kThreads, sc, a.stream>>>(
          x, b, c, dy, states, s.cs, s.dtv, static_cast<float*>(a.dch),
          s.rowv, d);
  if ((err = (int)cudaGetLastError())) return err;
  return finish(a, s);
}

template <int N>
int run_bwd32(const BwdArgs& a) {
  const Dims& d = a.d;
  const size_t sa = state_smem32(N, d.cl), sc = bwd_block_smem32(N, d.cl);
  int err;
  if ((err = prepare(ssd_sm90_bwd_deposit_kernel_f32<N>, sa)) ||
      (err = prepare(ssd_sm90_bwd_column_kernel_f32<N>, sc)) ||
      (err = prepare(ssd_sm90_bwd_row_kernel_f32<N>, sc)))
    return err;
  const float* x = static_cast<const float*>(a.x);
  const float* b = static_cast<const float*>(a.b);
  const float* c = static_cast<const float*>(a.c);
  const float* dy = static_cast<const float*>(a.dy);
  const Scratch s(a);
  const int nrb = pad64(d.cl) / kRows;
  ssd_sm90_bwd_deposit_kernel_f32<N>
      <<<dim3(d.nc, d.H, d.B), kT32, sa, a.stream>>>(
          dy, static_cast<const float*>(a.dt),
          static_cast<const float*>(a.a), c, s.ds, s.cs, s.dtv, s.decay, d);
  if ((err = (int)cudaGetLastError()) || (err = dstate_pass(a, s)))
    return err;
  ssd_sm90_bwd_column_kernel_f32<N>
      <<<dim3(d.B * d.H, d.nc, nrb), kT32, sc, a.stream>>>(
          x, b, c, dy, s.ds, s.cs, s.dtv, static_cast<float*>(a.dx),
          static_cast<float*>(a.dbh), s.ddt_att, s.dw, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_sm90_bwd_row_kernel_f32<N>
      <<<dim3(d.B * d.H, d.nc, nrb), kT32, sc, a.stream>>>(
          x, b, c, dy, static_cast<const float*>(a.states), s.cs, s.dtv,
          static_cast<float*>(a.dch), s.rowv, d);
  if ((err = (int)cudaGetLastError())) return err;
  return finish(a, s);
}

template <typename Tag, typename TD, typename TY>
int run_bwd_n(const BwdArgs& a) {
  if (a.d.N == 64) return run_bwd<Tag, 64, TD, TY>(a);
  if (a.d.N == 128) return run_bwd<Tag, 128, TD, TY>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename Tag>
int run_bwd_types(int dt_dtype, int dy_dtype, const BwdArgs& a) {
  if (dt_dtype)
    return dy_dtype ? run_bwd_n<Tag, uint16_t, uint16_t>(a)
                    : run_bwd_n<Tag, uint16_t, float>(a);
  return dy_dtype ? run_bwd_n<Tag, float, uint16_t>(a)
                  : run_bwd_n<Tag, float, float>(a);
}

// dtype: 0 float32, 1 bfloat16, 2 float16; dt_dtype and dy_dtype 0
// (float32) or dtype
int dispatch_bwd(int dtype, int dt_dtype, int dy_dtype, int P,
                 const BwdArgs& a) {
  const Dims& d = a.d;
  if (d.B <= 0 || d.S <= 0 || d.H <= 0 || d.G <= 0 || d.H % d.G != 0 ||
      P != kP || d.cl <= 0 || d.nc != (d.S + d.cl - 1) / d.cl ||
      d.nc > 65535 || (dt_dtype != 0 && dt_dtype != dtype) ||
      (dy_dtype != 0 && dy_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d.N == 64) return run_bwd32<64>(a);
    if (d.N == 128) return run_bwd32<128>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) return run_bwd_types<Bf16>(dt_dtype, dy_dtype, a);
  if (dtype == 2) return run_bwd_types<F16>(dt_dtype, dy_dtype, a);
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

// K3b: chunk_states (B, H, nc, P, N) are the forward's entering states,
// dy (B, S, H, P) in float32 or x's type, dfinal (B, H, P, N) float32;
// dx, ddt, per-head db and dc (dbh, dch (B, S, H, N)) and dinit come back
// float32, and the scratch (the wrapper's, float32, sized by shapes: see
// run_bwd) ends with the (B, H, nc) da partials. Returns a cudaError_t.
extern "C" int ssd_scan_bwd_sm90_launch(
    int dtype, int dt_dtype, int dy_dtype, const void* x, const void* dt,
    const void* a, const void* b, const void* c, const void* chunk_states,
    const void* dy, const void* dfinal, void* dx, void* ddt, void* dbh,
    void* dch, void* dinit, void* scratch, int B, int S, int H, int P, int G,
    int N, int cl, void* stream) {
  BwdArgs a_{};
  a_.x = x; a_.dt = dt; a_.a = a; a_.b = b; a_.c = c;
  a_.states = chunk_states; a_.dy = dy; a_.dfinal = dfinal;
  a_.dx = dx; a_.ddt = ddt; a_.dbh = dbh; a_.dch = dch; a_.dinit = dinit;
  a_.scratch = scratch;
  a_.d = Dims{B, S, H, G, N, cl, cl > 0 ? (S + cl - 1) / cl : 0};
  a_.stream = static_cast<cudaStream_t>(stream);
  return dispatch_bwd(dtype, dt_dtype, dy_dtype, P, a_);
}
