// K2 on Hopper: the flash-attention forward (K2f) and its two backward
// kernels (K2q, K2kv) for bfloat16 and float16 at head dims 64, 112
// (zamba2's shared block) and 128 on the tensor cores, with wgmma and TMA
// (sm_90a); and all three in float32 at head dims 32, 64, 112 and 128 on
// the CUDA cores (their own sections below).
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
//   K2f  _fwd_flat via flash_attention, body _flash_kernel (pallas_call at
//        :171, kernel at :88);
//   K2q  flash_attention_bwd's dq pass, _flash_bwd_dq_kernel (:342, :223);
//   K2kv its dk/dv pass, _flash_bwd_dkv_kernel (:370, :260).
// It computes exactly what flash_attention.cu's SIMT fwd_kernel, dq_kernel
// and dkv_kernel compute, with the same contract:
//   q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), contiguous, in bfloat16 or
//   float16 at D 64, 112 or 128, or float32 at D 32, 64, 112 or 128;
//   query head h reads KV head h / (Hq / Hkv); the q tokens are the last
//   Sq of the Sk keys
//   (seq_off = Sk - Sq); key k is live for query q when k < Sk, q < Sq,
//   (not causal or k <= q + seq_off) and (window == 0 or q + seq_off - k <
//   window).
//   K2f writes o_f32 (B*Hq, Sq, D) and lse (B*Hq, Sq), float32; a row with
//   no live key gives o = 0 and lse = NEG_INF = -2^30 exactly.
//   K2q and K2kv read dO (B*Hq, Sq, D) in the input's type (in 16 bits
//   because wgmma takes its operands there), lse and delta = sum_d dO *
//   o_f32 (B*Hq, Sq) in float32, recompute p = exp(s * scale - lse) under
//   the mask and
//   ds = p (dP - delta), and write dq = dS K scale, dk = dS^T Q scale and
//   dv = P^T dO in the input type. Nothing of size (Sq, Sk) reaches device
//   memory; K2kv sums each GQA group inside its CTA, without atomics, so
//   dk and dv are deterministic; a dead row adds nothing and gets dq = 0.
// The wrapper (kernels/flash_attention.py: route) sends every other call
// (16 bits at D 32) to flash_attention.cu.
//
// Bound on an H100 (989 TFLOP/s bf16/fp16, 3.35 TB/s): a causal call does
// 4 D flops a live (q, k) pair forward, 6 D in K2q and 8 D in K2kv, and
// moves q, k, v (and dO) once in 16 bits and the float32 rows once. At one
// 4096-token sequence (24/8 heads, D 128) that is 103, 155 and 206 GFLOP
// against ~100 MB: operations bound all three. At the LLM path's server
// and train shapes (S 256) and at D 64 the forward's float32 o_f32 write
// is over half of its bytes and bytes bound it; the backward stays near
// the balance. So the design keeps the tensor cores fed on long rows
// (every product on wgmma, tiles arriving by TMA while the previous tile
// computes) and reads each tile once per CTA.
//
// D 112 (zamba2-7b's 32 heads of 112) is stored and multiplied at the
// padded width 128 (Padded<D>): the tensor maps stay over the real 112
// columns (rows of 224 bytes, a multiple of 16), so the second 64-column
// box of a row covers columns 64-127 and TMA fills 112-127 with zeros,
// and the stage's transaction count is the whole box, those zeros
// included. The SS products that reduce over D (Q K^T in K2f, K Q^T and
// V dO^T in K2kv) take D/16 = 7 k16 steps and never read the padding; the
// RS products (P V in K2f, P^T dO and dS^T Q in K2kv) run at N = 128, and
// their last 16 accumulator columns come out zero and are never stored:
// every epilogue store stops at column D. The padding costs 128/112 =
// 1.14x of the RS products' work and nothing of the SS products'; the
// bound is counted at the real D. Tiles, threads and registers are D
// 128's (the accumulators are 128 columns wide), so its budgets hold:
// K2f 288 threads and ~99 KB of shared memory, K2q and K2kv 384 threads
// and ~132 KB. K2q's S = Q K^T and dP = dO V^T are SS products over D (7
// k16 steps), its dQ += dS K an RS product at N = 128 whose last 16
// columns come out zero and are never stored.
//
// The common shape. One producer warp (one thread issues the TMA loads:
// cp.async.bulk.tensor, 3-D maps (D, S, B*H), so a ragged tail past Sk or
// Sq reads zeros from its own head, never the next head's rows) feeds a
// two-stage ring with a full and an empty mbarrier per stage; two consumer
// warpgroups of 64 rows each run the products. One CTA an SM. K2f has 288
// threads. ptxas gives such a CTA, rounded up to whole warpgroups, 168
// registers a thread, where the backward's accumulators spilled (up to
// 920 bytes a thread in K2kv); so K2q and K2kv have 384 threads, a whole
// producer warpgroup of which one warp works, and setmaxnreg moves
// registers from it (down to 40) to the consumers (up to 232).
// With SWIZZLE_128B a box is at most 128 bytes wide, so a D-128 row is two
// 64-column boxes: every tile is stored as D/64 halves of (rows, 64), each
// in the 128-byte swizzled layout. Dead tiles (past the causal diagonal,
// before the window) are never loaded. Every product is one of two wgmma
// forms:
//   SS, m64nNk16, A and B both K-major in shared memory (QK^T and its
//     kin): D/16 instructions, the descriptor stepping 32 B per k16 inside
//     a swizzle atom and to the next half every 4 steps;
//   RS, m64nDk16, A from registers, B MN-major (transpose-B): B is a tile
//     stored row-major with D contiguous whose rows are the reduction axis
//     (V in PV); the descriptor's leading offset steps between the two
//     64-column halves and its stride offset between 8-row groups. A is an
//     accumulator of an SS product: the accumulator's (row, column pair)
//     layout is the A fragment's, so the repacking is a pairwise pack to
//     the input's 16-bit type.
// The mask is evaluated only on tiles that straddle the diagonal, the
// window's edge or a ragged end; a tile that holds a dead row (Sq > Sk,
// before the window) always straddles one of them. Under the mask p is set
// to 0 by a select, never by the arithmetic (exp(s - NEG_INF) overflows).
// A warpgroup whose 64 rows see none of a tile only releases it.
//
// K2f: one CTA per (b*Hq + h, 128-row q-block), longest q-blocks first
//   (blockIdx.y = 0 is the last q-block), so the causal triangle's long
//   rows do not form the tail wave. The producer loads Q once, then each
//   live k-tile's K and V. Per warpgroup and tile: S = Q K^T (SS); the
//   online softmax on the accumulator fragments in the log2 domain (a
//   row's values sit in the 4 threads of a quad: two __shfl_xor_sync; a
//   masked score is -inf and the running max starts at NEG_INF, so p = 0
//   there and exp(NEG_INF - NEG_INF) never counts; l sums the float32 p);
//   O = O * alpha + P V (RS, V as B). Epilogue: o = acc / max(l, 1e-30) as
//   float32, lse = m + log l where l > 0 and NEG_INF elsewhere. Rounding P
//   to 16 bits before PV moves each o entry by at most u max|v| (u = 2^-9
//   bf16, 2^-12 fp16); lse comes from float32 scores and a float32 l.
// K2q: the same grid, order and tiles. The producer loads Q and dO once,
//   then each live k-tile's K and V. Per warpgroup and tile: S = Q K^T and
//   dP = dO V^T (SS, issued together, one wait); p = exp2(S scale log2e -
//   lse log2e) under the mask and ds = p (dP - delta), lse and delta held
//   per row in registers, all in float32; dQ += dS K (RS, dS packed to 16
//   bits, K as B, exactly PV's descriptor with K in V's place). Epilogue:
//   dq = acc * scale in the input type; rows past Sq are never written, a
//   dead row stores 0.
// K2kv: one CTA per (b*Hkv + kv, 128-key block); each warpgroup owns 64
//   keys, the CTA loads K and V once. The producer walks the g query heads
//   of the KV head and, for each, the q-tiles (BQ rows) that see the CTA's
//   keys (q_range); it brings each tile's Q and dO by TMA, and its lse
//   (times log2e) and delta with plain loads by the warp's 32 lanes into
//   the stage's rows (the full barrier counts the 32 lanes and the TMA
//   bytes). Per warpgroup and tile, on the transposed scores, so that every
//   product is SS or RS with no transpose through shared memory: S^T = K
//   Q^T and dP^T = V dO^T (SS, K-major); P^T and dS^T in float32 registers,
//   lse and delta indexed by column; dV += P^T dO and dK += dS^T Q (RS, A
//   packed from the accumulators, B the dO or Q tile, which is MN-major
//   for these products: transpose-B). Epilogue: dk = acc * scale and dv in
//   the input type; keys past Sk are never written. Registers: the dK and
//   dV accumulators are D floats a thread, S^T and dP^T BQ; BQ is 64 at
//   D 128 and 128 at D 64, so the four come to 192 either way, inside the
//   consumers' 232.
// Rounding P and dS to 16 bits at the pack (as every tensor-core flash
// attention does) is the only rounding before the float32 accumulators.
//
// Left for later: ping-pong between the two consumer warpgroups,
// overlapping the softmax with wgmma inside a warpgroup, a persistent tile
// scheduler, clusters with TMA multicast, o in 16 bits, fp8, one launch
// for both backward kernels.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (cudaGetDriverEntryPoint
// or, from CUDA 12.5, its ByVersion form), so the library needs no -lcuda.
// Each C entry has the argument list of its flash_attention.cu namesake,
// sets the dynamic shared-memory limit, launches once on the given stream
// and returns the first CUDA error.

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;                    // q rows a CTA (K2f, K2q)
constexpr int kBKV = 128;                   // keys a CTA (K2kv)
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp (K2f)
// K2q and K2kv: a whole producer warpgroup, whose registers setmaxnreg
// moves to the consumers (168 each at entry; 128 x 128 freed, 256 x 64
// taken)
constexpr int kBwdThreads = kConsumers + 128;
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 2;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the width a tile is stored and multiplied at: D in whole 64-column
// (128-byte) halves, so 128 at D 112
template <int D> struct Padded {
  static constexpr int value = (D + 63) / 64 * 64;
};

// the k-tile: 128 keys at D 64, 64 at D 112 and 128 (the accumulators of S,
// P and O then fit the registers of 288 threads with one CTA an SM)
template <int D> struct TileK {
  static constexpr int value = D == 64 ? 128 : 64;
};

// K2kv's q-tile: 128 rows at D 64, 64 at D 112 and 128 (the dK and dV
// accumulators and S^T, dP^T then come to 192 floats a thread at any D)
template <int D> struct TileQ {
  static constexpr int value = D == 64 ? 128 : 64;
};


struct Geometry {
  int hq, hkv, sq, sk, causal, window, seq_off;
  float scale;        // the softmax scale
  float scale_log2;   // and times log2(e)
};

// a masked score: -inf, so that its p is 0 whatever the running max
__device__ __forceinline__ float masked_score() {
  return -__int_as_float(0x7f800000);
}

__device__ __forceinline__ bool live(int qi, int ki, const Geometry& g) {
  if (qi >= g.sq || ki >= g.sk) return false;
  const int q_pos = qi + g.seq_off;
  if (g.causal && ki > q_pos) return false;
  if (g.window && q_pos - ki >= g.window) return false;
  return true;
}

// the keys [lo, hi) that rows [q0, q0 + rows) can see
__device__ __forceinline__ void k_range(int q0, int rows, const Geometry& g,
                                        int& lo, int& hi) {
  const int q_last = min(q0 + rows, g.sq) - 1;
  hi = g.causal ? min(g.sk, q_last + g.seq_off + 1) : g.sk;
  lo = g.window ? max(0, q0 + g.seq_off - g.window + 1) : 0;
}

// the queries [lo, hi) that see any of the keys [k0, k0 + keys)
__device__ __forceinline__ void q_range(int k0, int keys, const Geometry& g,
                                        int& lo, int& hi) {
  const int k_last = min(k0 + keys, g.sk) - 1;
  lo = g.causal ? max(0, k0 - g.seq_off) : 0;
  hi = g.window ? min(g.sq, k_last + g.window - g.seq_off) : g.sq;
}

// every (q, k) of rows [q0, q0 + rows) and keys [k0, k0 + keys) is live:
// the tile straddles no edge of the mask
__device__ __forceinline__ bool tile_live(int q0, int rows, int k0, int keys,
                                          const Geometry& g) {
  return q0 + rows <= g.sq && k0 + keys <= g.sk &&
         !(g.causal && k0 + keys - 1 > q0 + g.seq_off) &&
         !(g.window && q0 + rows - 1 + g.seq_off - k0 >= g.window);
}


// ------------------------------------------------------------------ K2f --

template <typename Tag, int D>
__global__ void __launch_bounds__(kThreads, 1)
sm90_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                float* __restrict__ o, float* __restrict__ lse, Geometry g) {
  constexpr int BK = TileK<D>::value;
  constexpr int DP = Padded<D>::value;        // the stored width
  constexpr int NH = DP / 64;                 // 128-byte halves of a row
  constexpr uint32_t kQHalf = kBQ * 128;      // bytes of a (kBQ, 64) half
  constexpr uint32_t kKVHalf = BK * 128;      // bytes of a (BK, 64) half
  constexpr uint32_t kQBytes = NH * kQHalf;
  constexpr uint32_t kKVBytes = NH * kKVHalf;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                          // [NH][kBQ][64]
  const uint32_t k_s = q_s + kQBytes;                 // [kStages][NH][BK][64]
  const uint32_t v_s = k_s + kStages * kKVBytes;      // [kStages][NH][BK][64]
  const uint32_t q_full = v_s + kStages * kKVBytes;   // then full[], empty[]
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int b = bh / g.hq, h = bh % g.hq;
  const int kvh = b * g.hkv + h / (g.hq / g.hkv);
  int lo, hi;
  k_range(q0, kBQ, g, lo, hi);
  const int kt0 = lo < hi ? lo / BK * BK : hi;
  const int n_tiles = lo < hi ? (hi - kt0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {              // ---- the producer warp
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        tma_load(q_s + hh * kQHalf, &tm_q, q_full, 64 * hh, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const int k0 = kt0 + t * BK;
        mbar_expect_tx(bar, 2 * kKVBytes);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          tma_load(k_s + s * kKVBytes + hh * kKVHalf, &tm_k, bar, 64 * hh, k0,
                   kvh);
          tma_load(v_s + s * kKVBytes + hh * kKVHalf, &tm_v, bar, 64 * hh, k0,
                   kvh);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int qw0 = q0 + 64 * wg;                    // the warpgroup's rows
  const int row0 = qw0 + 16 * (tid / 32) + lane / 4;   // and row0 + 8
  int wlo, whi;
  k_range(qw0, 64, g, wlo, whi);
  const bool rows_in = qw0 < g.sq;
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = kt0 + t * BK;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    if (rows_in && k0 < whi && k0 + BK > wlo) {
      const uint32_t k_t = k_s + s * kKVBytes, v_t = v_s + s * kKVBytes;
      // S = Q K^T
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc,
                 desc_sw128(q_wg + (kk / 4) * kQHalf + (kk % 4) * 32, 16,
                            1024),
                 desc_sw128(k_t + (kk / 4) * kKVHalf + (kk % 4) * 32, 16,
                            1024),
                 kk > 0, Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the online softmax; sc[i] is row row0 + 8 ((i / 2) % 2), column
      // k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      const bool all_live =
          k0 + BK <= g.sk &&
          !(g.causal && k0 + BK - 1 > qw0 + g.seq_off) &&
          !(g.window && qw0 + 63 + g.seq_off - k0 >= g.window);
      float mx[2] = {m[0], m[1]};
      if (all_live) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          sc[i] *= g.scale_log2;
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = row0 + 8 * ((i / 2) % 2);
          const int c = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          sc[i] = live(r, c, g) ? sc[i] * g.scale_log2 : masked_score();
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      // P in the A-fragment layout: p[kk][j] packs sc[8 kk + 2 j], +1
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) % 2;
        const float p0 = exp2f(sc[i] - m[r]), p1 = exp2f(sc[i + 1] - m[r]);
        l[r] += p0 + p1;
        p[i / 8][(i % 8) / 2] = pack2(p0, p1, Tag{});
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P V
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, p[kk], desc_sw128(v_t + kk * 16 * 128, kKVHalf, 1024),
                 Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // o = acc / l, lse = m + log l (back from the log2 domain); columns
  // [0, D) only: at D 112 acc's last 16 columns are the padding's
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= g.sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* o_row = o + ((size_t)bh * g.sq + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o_row + 8 * j) =
          make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[(size_t)bh * g.sq + row] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNegInf;
  }
}

// ------------------------------------------------------------------ K2q --

template <typename Tag, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ lse,
               const float* __restrict__ delta, uint16_t* __restrict__ dq,
               Geometry g) {
  constexpr int BK = TileK<D>::value;
  constexpr int DP = Padded<D>::value;
  constexpr int NH = DP / 64;
  constexpr uint32_t kQHalf = kBQ * 128;
  constexpr uint32_t kKVHalf = BK * 128;
  constexpr uint32_t kQBytes = NH * kQHalf;
  constexpr uint32_t kKVBytes = NH * kKVHalf;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                          // [NH][kBQ][64]
  const uint32_t do_s = q_s + kQBytes;                // [NH][kBQ][64]
  const uint32_t k_s = do_s + kQBytes;                // [kStages][NH][BK][64]
  const uint32_t v_s = k_s + kStages * kKVBytes;      // [kStages][NH][BK][64]
  const uint32_t q_full = v_s + kStages * kKVBytes;   // then full[], empty[]
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int b = bh / g.hq, h = bh % g.hq;
  const int kvh = b * g.hkv + h / (g.hq / g.hkv);
  int lo, hi;
  k_range(q0, kBQ, g, lo, hi);
  const int kt0 = lo < hi ? lo / BK * BK : hi;
  const int n_tiles = lo < hi ? (hi - kt0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {         // ---- the producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * kQBytes);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        tma_load(q_s + hh * kQHalf, &tm_q, q_full, 64 * hh, q0, bh);
        tma_load(do_s + hh * kQHalf, &tm_do, q_full, 64 * hh, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const int k0 = kt0 + t * BK;
        mbar_expect_tx(bar, 2 * kKVBytes);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          tma_load(k_s + s * kKVBytes + hh * kKVHalf, &tm_k, bar, 64 * hh, k0,
                   kvh);
          tma_load(v_s + s * kKVBytes + hh * kKVHalf, &tm_v, bar, 64 * hh, k0,
                   kvh);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int qw0 = q0 + 64 * wg;                    // the warpgroup's rows
  const int row0 = qw0 + 16 * (tid / 32) + lane / 4;   // and row0 + 8
  int wlo, whi;
  k_range(qw0, 64, g, wlo, whi);
  const bool rows_in = qw0 < g.sq;
  const uint32_t q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;
  float lse2[2], dlt[2];   // lse log2(e) and delta of rows row0, row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < g.sq;
    lse2[r] = in ? lse[(size_t)bh * g.sq + row] * kLog2e : 0.f;
    dlt[r] = in ? delta[(size_t)bh * g.sq + row] : 0.f;
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = kt0 + t * BK;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    if (rows_in && k0 < whi && k0 + BK > wlo) {
      const uint32_t k_t = k_s + s * kKVBytes, v_t = v_s + s * kKVBytes;
      // S = Q K^T and dP = dO V^T
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc,
                 desc_sw128(q_wg + (kk / 4) * kQHalf + (kk % 4) * 32, 16,
                            1024),
                 desc_sw128(k_t + (kk / 4) * kKVHalf + (kk % 4) * 32, 16,
                            1024),
                 kk > 0, Tag{});
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp,
                 desc_sw128(do_wg + (kk / 4) * kQHalf + (kk % 4) * 32, 16,
                            1024),
                 desc_sw128(v_t + (kk / 4) * kKVHalf + (kk % 4) * 32, 16,
                            1024),
                 kk > 0, Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // p into sc; sc[i] is row row0 + 8 ((i / 2) % 2), column
      // k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      if (tile_live(qw0, 64, k0, BK, g)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          sc[i] = exp2f(fmaf(sc[i], g.scale_log2, -lse2[(i / 2) % 2]));
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i / 2) % 2;
          const int c = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          sc[i] = live(row0 + 8 * r, c, g)
                      ? exp2f(fmaf(sc[i], g.scale_log2, -lse2[r]))
                      : 0.f;
        }
      }
      // dS in the A-fragment layout: ds[kk][j] packs entries 8 kk + 2 j, +1
      uint32_t ds[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) % 2;
        ds[i / 8][(i % 8) / 2] = pack2(sc[i] * (dp[i] - dlt[r]),
                                       sc[i + 1] * (dp[i + 1] - dlt[r]),
                                       Tag{});
      }

      // dQ += dS K
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, ds[kk], desc_sw128(k_t + kk * 16 * 128, kKVHalf, 1024),
                 Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // dq = acc * scale; a row that saw no live key stores 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= g.sq) continue;
    uint16_t* dq_row = dq + ((size_t)bh * g.sq + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq_row + 8 * j) =
          pack2(acc[4 * j + 2 * r] * g.scale,
                acc[4 * j + 2 * r + 1] * g.scale, Tag{});
  }
}

// ----------------------------------------------------------------- K2kv --

template <typename Tag, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
sm90_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ lse,
                const float* __restrict__ delta, uint16_t* __restrict__ dk,
                uint16_t* __restrict__ dv, Geometry g) {
  constexpr int BQ = TileQ<D>::value;
  constexpr int DP = Padded<D>::value;
  constexpr int NH = DP / 64;
  constexpr uint32_t kKHalf = kBKV * 128;     // bytes of a (kBKV, 64) half
  constexpr uint32_t kQHalf = BQ * 128;       // bytes of a (BQ, 64) half
  constexpr uint32_t kKBytes = NH * kKHalf;
  constexpr uint32_t kQBytes = NH * kQHalf;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base;                          // [NH][kBKV][64]
  const uint32_t v_s = k_s + kKBytes;                 // [NH][kBKV][64]
  const uint32_t q_s = v_s + kKBytes;                 // [kStages][NH][BQ][64]
  const uint32_t do_s = q_s + kStages * kQBytes;      // [kStages][NH][BQ][64]
  const uint32_t row_s = do_s + kStages * kQBytes;    // [kStages][2][BQ] f32
  const uint32_t kv_full = row_s + kStages * 2 * BQ * 4;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;
  // the rows at their generic address: lse log2(e), then delta, a stage
  float* const rows_p = reinterpret_cast<float*>(smem_raw + (row_s - raw));

  const int bkv = blockIdx.x, k0 = blockIdx.y * kBKV;
  const int b = bkv / g.hkv, kv = bkv % g.hkv;
  const int n_g = g.hq / g.hkv;
  int lo, hi;
  q_range(k0, kBKV, g, lo, hi);
  const int qt0 = lo < hi ? lo / BQ * BQ : hi;
  const int n_qt = lo < hi ? (hi - qt0 + BQ - 1) / BQ : 0;
  const int n_tiles = n_g * n_qt;            // (query head, q-tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);             // the producer warp's lanes
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {         // ---- the producer warpgroup
    regs_dec<kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (lane >= 32) return;                     // its first warp works
    if (n_tiles > 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * kKBytes);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        tma_load(k_s + hh * kKHalf, &tm_k, kv_full, 64 * hh, k0, bkv);
        tma_load(v_s + hh * kKHalf, &tm_v, kv_full, 64 * hh, k0, bkv);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int qq0 = qt0 + (t % n_qt) * BQ;
      const int bh = b * g.hq + kv * n_g + t / n_qt;
      if (t >= kStages) mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
      float* rows = rows_p + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const int row = qq0 + r;
        const bool in = row < g.sq;
        rows[r] = in ? lse[(size_t)bh * g.sq + row] * kLog2e : 0.f;
        rows[BQ + r] = in ? delta[(size_t)bh * g.sq + row] : 0.f;
      }
      const uint32_t bar = full + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(bar, 2 * kQBytes);      // also lane 0's arrival
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          tma_load(q_s + s * kQBytes + hh * kQHalf, &tm_q, bar, 64 * hh, qq0,
                   bh);
          tma_load(do_s + s * kQBytes + hh * kQHalf, &tm_do, bar, 64 * hh,
                   qq0, bh);
        }
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // ---- the consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kw0 = k0 + 64 * wg;                    // the warpgroup's keys
  const int key0 = kw0 + 16 * (tid / 32) + lane / 4;   // and key0 + 8
  int wlo, whi;
  q_range(kw0, 64, g, wlo, whi);
  const bool keys_in = kw0 < g.sk;
  const uint32_t k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  if (n_tiles > 0) mbar_wait(kv_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int qq0 = qt0 + (t % n_qt) * BQ;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    if (keys_in && qq0 < whi && qq0 + BQ > wlo) {
      const uint32_t q_t = q_s + s * kQBytes, do_t = do_s + s * kQBytes;
      const float* rows = rows_p + s * 2 * BQ;
      // S^T = K Q^T and dP^T = V dO^T
      float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc,
                 desc_sw128(k_wg + (kk / 4) * kKHalf + (kk % 4) * 32, 16,
                            1024),
                 desc_sw128(q_t + (kk / 4) * kQHalf + (kk % 4) * 32, 16,
                            1024),
                 kk > 0, Tag{});
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp,
                 desc_sw128(v_wg + (kk / 4) * kKHalf + (kk % 4) * 32, 16,
                            1024),
                 desc_sw128(do_t + (kk / 4) * kQHalf + (kk % 4) * 32, 16,
                            1024),
                 kk > 0, Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P^T into sc; sc[i] is key key0 + 8 ((i / 2) % 2), query
      // qq0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      if (tile_live(qq0, BQ, kw0, 64, g)) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int c = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          sc[i] = exp2f(fmaf(sc[i], g.scale_log2, -rows[c]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int c = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          sc[i] = live(qq0 + c, key0 + 8 * ((i / 2) % 2), g)
                      ? exp2f(fmaf(sc[i], g.scale_log2, -rows[c]))
                      : 0.f;
        }
      }
      // P^T and dS^T in the A-fragment layout
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const int c = 8 * (i / 4) + 2 * (lane % 4);
        pf[i / 8][(i % 8) / 2] = pack2(sc[i], sc[i + 1], Tag{});
        dsf[i / 8][(i % 8) / 2] =
            pack2(sc[i] * (dp[i] - rows[BQ + c]),
                  sc[i + 1] * (dp[i + 1] - rows[BQ + c + 1]), Tag{});
      }

      // dV += P^T dO and dK += dS^T Q
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(dva, pf[kk], desc_sw128(do_t + kk * 16 * 128, kQHalf, 1024),
                 Tag{});
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(dka, dsf[kk], desc_sw128(q_t + kk * 16 * 128, kQHalf, 1024),
                 Tag{});
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dva);
      fence_regs(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // dk = acc * scale, dv = acc; keys past Sk and columns past D are
  // never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= g.sk) continue;
    const size_t off = ((size_t)bkv * g.sk + key) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack2(dka[4 * j + 2 * r] * g.scale,
                dka[4 * j + 2 * r + 1] * g.scale, Tag{});
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1], Tag{});
    }
  }
}

// ------------------------------------------------------ K2f, float32 --
//
// The float32 forward on the CUDA cores, exact in float32: no TF32 and no
// split-TF32 products (the float32 checks hold it to 1e-4, as they hold
// the simt kernel). Bound: FFMA at 67 TFLOP/s, 4 D flops a live (q, k)
// pair; the first version (flash_attention.cu's fwd_kernel) reached 23% of
// it at D 112, paced by scalar shared-memory loads (8 for 16 FFMAs in
// Q K^T) and by synchronous staging. Here:
//   * one CTA per (b*Hq + h, 128-row q-block), longest q-blocks first;
//     256 threads, each warp owning 16 consecutive rows: the thread of
//     lane tx (0..15) in half `half` of warp w holds rows 16 w + 2 i + half
//     (i < 8), keys tx + 16 j of a 64-key tile (j < 4) and D / 16
//     columns of its rows' o, all in registers: 4 tx + 64 h + e (e < 4)
//     at D 64 and 128, so that P V reads V in 16-byte vectors, 2 tx + e
//     at D 32, tx + 16 c at D 112;
//   * Q, K and V are staged row-major at a row stride of D + 4 floats by
//     16-byte cp.async, zero-filled past Sq or Sk. Four d steps of Q K^T
//     read one 16-byte vector of each of the thread's 8 rows (two
//     addresses a warp: broadcasts) and of its 4 keys (the odd stride in
//     16-byte units puts 8 neighbouring rows on 8 bank groups) for 128
//     FFMAs: 3 loads per 32 FFMAs, where the first version had 8 per 16;
//   * K and V tiles cycle through three slots in the order K0 V0 K1 V1 ...:
//     K_{t+1} loads while tile t's Q K^T, softmax and P V run, V_{t+1}
//     while its P V and the next Q K^T run; two barriers a tile;
//   * the online softmax works in the log2 domain (scale log2 e folded
//     into the scores, exp2f), evaluates the mask only on tiles that
//     straddle one of its edges for the warp's 16 rows, and a warp skips a
//     tile its rows see none of; P goes through shared memory (row stride
//     80: the two half-warps' rows on disjoint banks, 16-byte reads) to
//     P V, which reads one P vector a row per 4 keys and the thread's V
//     columns of each key.
// A row with no live key keeps m = NEG_INF and l = 0: o = 0 and lse =
// NEG_INF exactly, as in the other kernels.

constexpr int kF32Threads = 256;
constexpr int kF32BK = 64;                  // keys a tile
constexpr int kF32PS = kF32BK + 16;         // P's row stride, floats

template <int D> struct F32Tiles {
  static constexpr int kStride = D + 4;                 // Q, K, V rows
  static constexpr int kQ = kBQ * kStride;              // floats
  static constexpr int kSlot = kF32BK * kStride;        // floats
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)kQ + 3 * kSlot + kBQ * kF32PS);
};

// rows [row0, row0 + n) of a (rows, D) float32 matrix into shared memory
// at `dst`, row stride D + 4, by 16-byte cp.async; zeros past `rows`
template <int D>
__device__ __forceinline__ void f32_stage(uint32_t dst,
                                          const float* __restrict__ src,
                                          int row0, int n, int rows) {
  constexpr int C = D / 4;                  // 16-byte chunks a row
  for (int e = threadIdx.x; e < n * C; e += kF32Threads) {
    const int r = e / C, c = e % C;
    const bool in = row0 + r < rows;
    cp_async16(dst + 4u * (uint32_t)(r * F32Tiles<D>::kStride + 4 * c),
               src + (in ? (size_t)(row0 + r) * D + 4 * c : 0), in);
  }
}

// column c (< D / 16) of the thread of lane tx in the o tile: 16-byte
// groups at D 64 and 128, 8-byte pairs at D 32, strided at D 112
template <int D>
__device__ __forceinline__ int f32_col(int tx, int c) {
  constexpr int DN = D / 16;
  return DN % 4 == 0 ? 64 * (c / 4) + 4 * tx + c % 4
         : DN == 2   ? 2 * tx + c
                     : tx + 16 * c;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
sm90_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, Geometry g) {
  constexpr int S = F32Tiles<D>::kStride;
  constexpr int RM = 8, CN = kF32BK / 16, DN = D / 16;
  constexpr uint32_t kSlotBytes = 4u * F32Tiles<D>::kSlot;
  extern __shared__ float4 f32_smem[];
  float* const q_s = reinterpret_cast<float*>(f32_smem);   // [kBQ][S]
  float* const kv_s = q_s + F32Tiles<D>::kQ;               // [3][kF32BK][S]
  float* const p_s = kv_s + 3 * F32Tiles<D>::kSlot;        // [kBQ][kF32PS]
  const uint32_t kv_u = smem_u32(kv_s);

  const int warp = threadIdx.x / 32, tx = threadIdx.x % 16;
  const int rb = 16 * warp + (threadIdx.x / 16) % 2;   // rows rb + 2 i
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int b = bh / g.hq, h = bh % g.hq;
  const size_t kvh = (size_t)b * g.hkv + h / (g.hq / g.hkv);
  const float* k_bh = k + kvh * g.sk * D;
  const float* v_bh = v + kvh * g.sk * D;
  int lo, hi;
  k_range(q0, kBQ, g, lo, hi);
  const int kt0 = lo < hi ? lo / kF32BK * kF32BK : hi;
  const int n_tiles = lo < hi ? (hi - kt0 + kF32BK - 1) / kF32BK : 0;
  const int qw0 = q0 + 16 * warp;                      // the warp's rows
  int wlo, whi;
  k_range(qw0, 16, g, wlo, whi);
  const bool rows_in = qw0 < g.sq;

  float acc[RM][DN], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  if (n_tiles > 0) {                        // groups: Q, K_0, V_0
    f32_stage<D>(smem_u32(q_s), q + (size_t)bh * g.sq * D, q0, kBQ, g.sq);
    cp_async_commit();
    f32_stage<D>(kv_u, k_bh, kt0, kF32BK, g.sk);
    cp_async_commit();
    f32_stage<D>(kv_u + kSlotBytes, v_bh, kt0, kF32BK, g.sk);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kt0 + t * kF32BK;
    const bool active = rows_in && k0 < whi && k0 + kF32BK > wlo;
    cp_async_wait<1>();           // K_t has landed (V_t may be in flight)
    __syncthreads();              // for every thread; P V of t - 1 is done
    if (t + 1 < n_tiles)          // K_{t+1} into V_{t-1}'s slot
      f32_stage<D>(kv_u + ((2 * t + 2) % 3) * kSlotBytes, k_bh,
                   k0 + kF32BK, kF32BK, g.sk);
    cp_async_commit();
    if (active) {
      const float* k_t = kv_s + ((2 * t) % 3) * F32Tiles<D>::kSlot;
      float s[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qa[RM], kb[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          qa[i] = *reinterpret_cast<const float4*>(q_s + (rb + 2 * i) * S
                                                   + d);
#pragma unroll
        for (int j = 0; j < CN; ++j)
          kb[j] = *reinterpret_cast<const float4*>(k_t + (tx + 16 * j) * S
                                                   + d);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
          }
      }
      // the online softmax in the log2 domain; a row's 64 scores lie in
      // the 16 lanes of a half-warp, l[i] is this thread's share of its
      // row's sum (every share is rescaled by the same alpha)
      const bool all_live = tile_live(qw0, 16, k0, kF32BK, g);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rb + 2 * i;
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = all_live || live(q0 + r, k0 + tx + 16 * j, g)
                        ? s[i][j] * g.scale_log2 : masked_score();
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 16; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float alpha = exp2f(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float p = exp2f(s[i][j] - mx);
          p_s[r * kF32PS + tx + 16 * j] = p;
          sum += p;
        }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
      }
    }
    cp_async_wait<1>();           // V_t has landed (K_{t+1} may not have)
    __syncthreads();              // for every thread; every Q K^T is done
    if (t + 1 < n_tiles)          // V_{t+1} into K_t's slot
      f32_stage<D>(kv_u + ((2 * t + 3) % 3) * kSlotBytes, v_bh,
                   k0 + kF32BK, kF32BK, g.sk);
    cp_async_commit();
    if (active) {
      const float* v_t = kv_s + ((2 * t + 1) % 3) * F32Tiles<D>::kSlot;
#pragma unroll 2
      for (int c0 = 0; c0 < kF32BK; c0 += 4) {
        float4 pa[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          pa[i] = *reinterpret_cast<const float4*>(
              p_s + (rb + 2 * i) * kF32PS + c0);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float vb[DN];                 // V at the thread's columns
          const float* v_row = v_t + (c0 + cc) * S;
          if constexpr (DN % 4 == 0) {
#pragma unroll
            for (int hh = 0; hh < DN / 4; ++hh) {
              const float4 x = *reinterpret_cast<const float4*>(
                  v_row + 64 * hh + 4 * tx);
              vb[4 * hh] = x.x; vb[4 * hh + 1] = x.y;
              vb[4 * hh + 2] = x.z; vb[4 * hh + 3] = x.w;
            }
          } else if constexpr (DN == 2) {
            const float2 x = *reinterpret_cast<const float2*>(v_row + 2 * tx);
            vb[0] = x.x; vb[1] = x.y;
          } else {
#pragma unroll
            for (int c = 0; c < DN; ++c) vb[c] = v_row[f32_col<D>(tx, c)];
          }
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                            : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(p, vb[c],
                                                          acc[i][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // o = acc / l, lse = m + log l (back from the log2 domain)
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int off = 1; off < 16; off *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + rb + 2 * i;
    if (row >= g.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o_row = o + ((size_t)bh * g.sq + row) * D;
#pragma unroll
    for (int c = 0; c < DN; ++c) o_row[f32_col<D>(tx, c)] = acc[i][c] * inv;
    if (tx == 0)
      lse[(size_t)bh * g.sq + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : kNegInf;
  }
}

// ------------------------------------------------ K2q and K2kv, float32 --
//
// The float32 backward on the CUDA cores, exact in float32 as K2f's float32
// kernel above (no TF32, no split-TF32 products: the float32 checks hold it
// to 1e-4). Bound: FFMA at 67 TFLOP/s, 6 D flops a live (q, k) pair in K2q
// (S, dP, dQ) and 8 D in K2kv (S^T, dP^T, dV, dK). The first versions
// (flash_attention.cu's dq_kernel and dkv_kernel) reached 15-22% of it,
// paced by scalar shared-memory loads (16 a 32 FFMAs in S and dP),
// synchronous staging and expf. Both kernels here:
//   * 256 threads on 64 x 64 tiles. Warp w owns 8 rows of the CTA's block
//     (K2q: q rows; K2kv: keys); the thread of lane tx (0..15) in half h
//     holds rows 8 w + h + 2 i (i < 4) at columns tx + 16 j (j < 4) of the
//     tile's scores, and the same rows at D / 16 columns of each
//     accumulator (load_bcols: 16-byte groups at D 64 and 128; a 16-byte
//     group, a pair and one column at D 112; a pair at D 32);
//   * tiles are staged row-major at a row stride of D + 4 floats by 16-byte
//     cp.async (f32_stage), zero-filled past Sq or Sk. Four d steps of a
//     score product (f32_scores) read one 16-byte vector of each of the
//     thread's 4 rows (two addresses a warp: broadcasts) and of its 4
//     columns (16 rows on 8 bank groups) for 64 FFMAs: 4 loads per 32
//     FFMAs, where the first versions had 16. An accumulating product
//     (f32_accumulate: dQ += dS K, dV += P^T dO, dK += dS^T Q) reads one
//     16-byte P or dS vector a row per 4 tile rows and the thread's
//     columns of those 4 rows: 3 loads per 32 FFMAs at D 64 and 128, 4.6
//     at D 112, 6 at D 32;
//   * p = exp2(s scale log2 e - lse log2 e) where the mask is live (it is
//     evaluated only on tiles that straddle one of its edges for the
//     warp's 8 rows; p = 0 elsewhere by a select) and ds = p (dP - delta),
//     in registers. P and dS pass through shared memory (row stride 80:
//     the two halves' rows on disjoint banks, 16-byte reads); each warp
//     reads back only its own 8 rows, so a __syncwarp orders them;
//   * a warp skips a tile its rows see none of; a dead row adds nothing,
//     so dq = 0 there, and no row past Sq or key past Sk is written.
// Why 64 rows, where K2f's float32 kernel has 128: each kernel keeps five
// tiles (the three operands of its score products, a second slot of the
// ring, and the tile its other accumulating product reads) and P or dS.
// At D 128 that is 186 KB with 64-row tiles; 128-row q-blocks would need
// 277 KB, over the 227 KB a CTA may have. The thread's 4 x 4 score tile
// then costs 4 loads per 32 FFMAs, where K2f's 8 x 4 costs 3.
//
// K2q, sm90_dq_f32_kernel: one CTA per (b*Hq + h, 64-row q-block), the
//   last q-blocks (the most keys under the causal mask) first. Q and dO are
//   staged once. K goes through two slots and V through one, in the order
//   K0 V0 K1 V1 ...: K_{t+1} loads while all of tile t runs; V_{t+1} loads
//   into V_t's slot once every warp is past dP = dO V_t^T (the tile's
//   second barrier), while ds and dQ += dS K_t run. K_t must outlive dQ +=
//   dS K_t, which is why K, not V, has the second slot (K2f's ring, which
//   loads V_{t+1} into K_t's slot, would overwrite it). Two barriers a
//   tile; dq = acc scale once at the end.
// K2kv, sm90_dkv_f32_kernel: one CTA per (b*Hkv + kv, 64-key block), key
//   block 0 first (under the causal mask it sees the most q-tiles). K and
//   V are staged once. The CTA walks the g query heads of its KV head and,
//   for each, the 64-row q-tiles that see its keys; Q goes through two
//   slots with each tile's lse and delta (4-byte cp.async, zeros past Sq),
//   dO through one. Per tile: S^T = K Q^T, P^T to shared memory, dV += P^T
//   dO, dP^T = V dO^T; a barrier, then dO_{t+1} loads into dO_t's slot
//   while dS^T = P^T (dP^T - delta) and dK += dS^T Q run; Q is read first
//   and last, so it has the second slot. dK and dV stay in registers
//   across the group's heads: the GQA sum takes place inside the CTA in a
//   fixed order, with no atomics, and dk, dv are deterministic.
//   A key block's tiles may be shared by a cluster of `split` CTAs (2, 4
//   or 8; dkv_split): rank r takes its tiles r, r + split, ..., and the
//   ranks add their dK, dV partials in rank order through distributed
//   shared memory (one 64 KB read a rank at D 128, no pass through device
//   memory, still deterministic). dkv_split raises `split` while the grid
//   is under one wave: the key blocks of one KV head are few (Sk / 64)
//   and, under the causal mask, unequal.
// Shared memory: 5 tiles of 64 x (D + 4) floats, P/dS 64 x 80, 512 bytes
// of rows: 190,464 bytes at D 128, 169,984 at D 112, 108,544 at D 64
// (two CTAs an SM: __launch_bounds__(256, 2) caps the registers at 128),
// 67,584 at D 32.
// Waves and balance: at the server shape (4, 24/8, 256, D 128) K2q has
// 384 CTAs (2.9 waves, longest first). K2kv has 128 key blocks for 132
// SMs, whose tiles number 12, 9, 6 or 3 (3 heads x 4..1 q-tiles): one CTA
// each would leave the 12 to set the time, where an even spread is 7.3;
// clusters of 2 make 256 CTAs of at most 6. At d112 (2, 32/32, 512) both
// have 512 CTAs (3.9 waves; K2kv's do 8..1 q-tiles, K2q's 1..8 k-tiles),
// and K2kv takes no cluster. A ragged shape's K2kv (16 key blocks) takes
// clusters of 4 or 8.
// Registers and spills (ptxas -v, CUDA 12.8): K2q 168 registers at D 112
// and 128, K2kv 214-216, no spill. At D 32 and 64 (two CTAs an SM cap
// them at 128) both use 128 and spill 4-44 bytes (K2kv at D 64 spilled 8
// before the cluster's sum was added); one CTA an SM, without spills, ran
// 17-20% slower at d64.

constexpr int kF32B = 64;       // rows of a backward block and of a tile

template <int D> struct F32Bwd {
  static constexpr int kTile = kF32B * F32Tiles<D>::kStride;   // floats
  // five tiles, P/dS, and K2kv's lse and delta in two slots
  static constexpr size_t kBytes =
      sizeof(float) * (5 * (size_t)kTile + kF32B * kF32PS + 4 * kF32B);
  static constexpr int kBlocks = D <= 64 ? 2 : 1;              // CTAs an SM
};

// 4 bytes from global to shared memory, asynchronously; zero-filled
// (nothing read) when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// the cluster's barrier: every thread of every CTA of the cluster arrives,
// and shared-memory writes before it are visible to the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// this CTA's shared-memory pointer p mapped to the same place in the
// cluster's CTA `rank` (a generic address into distributed shared memory)
__device__ __forceinline__ const float* cluster_map(const float* p,
                                                    int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// x = lane tx's D / 16 columns of a D-wide row in the backward's
// accumulating products, by the widest loads they allow: 16-byte groups
// 64 hh + 4 tx at D 64 and 128; 4 tx, the pair 64 + 2 tx and 96 + tx at
// D 112; the pair 2 tx at D 32
template <int D>
__device__ __forceinline__ void load_bcols(const float* row, int tx,
                                           float (&x)[D / 16]) {
  constexpr int DN = D / 16;
  static_assert(DN == 2 || DN == 4 || DN == 7 || DN == 8, "D 32 to 128");
  if constexpr (DN % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < DN / 4; ++hh) {
      const float4 a = *reinterpret_cast<const float4*>(row + 64 * hh
                                                        + 4 * tx);
      x[4 * hh] = a.x; x[4 * hh + 1] = a.y;
      x[4 * hh + 2] = a.z; x[4 * hh + 3] = a.w;
    }
  } else if constexpr (DN == 2) {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * tx);
    x[0] = a.x; x[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * tx);
    const float2 b = *reinterpret_cast<const float2*>(row + 64 + 2 * tx);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = row[96 + tx];
  }
}

// lane tx's columns of a D-wide row (as load_bcols) = x * mul
template <int D>
__device__ __forceinline__ void store_bcols(float* row, int tx,
                                            const float (&x)[D / 16],
                                            float mul) {
  constexpr int DN = D / 16;
  if constexpr (DN % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < DN / 4; ++hh)
      *reinterpret_cast<float4*>(row + 64 * hh + 4 * tx) =
          make_float4(x[4 * hh] * mul, x[4 * hh + 1] * mul,
                      x[4 * hh + 2] * mul, x[4 * hh + 3] * mul);
  } else if constexpr (DN == 2) {
    *reinterpret_cast<float2*>(row + 2 * tx) =
        make_float2(x[0] * mul, x[1] * mul);
  } else {
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    *reinterpret_cast<float2*>(row + 64 + 2 * tx) =
        make_float2(x[4] * mul, x[5] * mul);
    row[96 + tx] = x[6] * mul;
  }
}

// out[i][j] = sum_d a[2 i][d] b[16 j][d]: a points at the thread's first
// row, b at its first column's row, both at row stride D + 4
template <int D>
__device__ __forceinline__ void f32_scores(const float* a, const float* b,
                                           float (&out)[4][4]) {
  constexpr int S = F32Tiles<D>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + 2 * i * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 16 * j * S + d);
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

// acc[i] += sum_r p[2 i][r] (lane tx's columns of tile row r), over 64 rows:
// p points at the thread's first row of P or dS (stride kF32PS), tile at a
// staged tile (stride D + 4)
template <int D>
__device__ __forceinline__ void f32_accumulate(const float* p,
                                               const float* tile, int tx,
                                               float (&acc)[4][D / 16]) {
  constexpr int S = F32Tiles<D>::kStride, DN = D / 16;
#pragma unroll 2
  for (int r0 = 0; r0 < kF32B; r0 += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(p + 2 * i * kF32PS + r0);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float x[DN];
      load_bcols<D>(tile + (r0 + rr) * S, tx, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = rr == 0 ? pa[i].x : rr == 1 ? pa[i].y
                        : rr == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(w, x[c], acc[i][c]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, F32Bwd<D>::kBlocks)
sm90_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   Geometry g) {
  constexpr int S = F32Tiles<D>::kStride, T = F32Bwd<D>::kTile;
  constexpr int DN = D / 16;
  constexpr uint32_t kTileBytes = 4u * T;
  extern __shared__ float4 f32_smem[];
  float* const q_s = reinterpret_cast<float*>(f32_smem);   // [64][S]
  float* const do_s = q_s + T;                             // [64][S]
  float* const k_s = do_s + T;                             // [2][64][S]
  float* const v_s = k_s + 2 * T;                          // [64][S]
  float* const ds_s = v_s + T;                             // [64][kF32PS]
  const uint32_t k_u = smem_u32(k_s), v_u = smem_u32(v_s);

  const int warp = threadIdx.x / 32, tx = threadIdx.x % 16;
  const int rb = 8 * warp + (threadIdx.x / 16) % 2;    // rows rb + 2 i
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32B;  // longest rows first
  const int b = bh / g.hq, h = bh % g.hq;
  const size_t kvh = (size_t)b * g.hkv + h / (g.hq / g.hkv);
  const float* k_bh = k + kvh * g.sk * D;
  const float* v_bh = v + kvh * g.sk * D;
  int lo, hi;
  k_range(q0, kF32B, g, lo, hi);
  const int kt0 = lo < hi ? lo / kF32B * kF32B : hi;
  const int n_tiles = lo < hi ? (hi - kt0 + kF32B - 1) / kF32B : 0;
  const int qw0 = q0 + 8 * warp;                        // the warp's rows
  int wlo, whi;
  k_range(qw0, 8, g, wlo, whi);
  const bool rows_in = qw0 < g.sq;

  // each row's lse log2 e and delta (zeros past Sq, where p is masked)
  float lse2[4], dlt[4], acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rb + 2 * i;
    const bool in = row < g.sq;
    lse2[i] = in ? lse[(size_t)bh * g.sq + row] * kLog2e : 0.f;
    dlt[i] = in ? delta[(size_t)bh * g.sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  if (n_tiles > 0) {                        // groups: Q and dO, K_0, V_0
    f32_stage<D>(smem_u32(q_s), q + (size_t)bh * g.sq * D, q0, kF32B, g.sq);
    f32_stage<D>(smem_u32(do_s), dout + (size_t)bh * g.sq * D, q0, kF32B,
                 g.sq);
    cp_async_commit();
    f32_stage<D>(k_u, k_bh, kt0, kF32B, g.sk);
    cp_async_commit();
    f32_stage<D>(v_u, v_bh, kt0, kF32B, g.sk);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kt0 + t * kF32B;
    const bool active = rows_in && k0 < whi && k0 + kF32B > wlo;
    const float* k_t = k_s + (t % 2) * T;
    cp_async_wait<0>();           // K_t and V_t have landed
    __syncthreads();              // for every thread; tile t - 1 is done
    if (t + 1 < n_tiles)          // K_{t+1} into K_{t-1}'s slot
      f32_stage<D>(k_u + ((t + 1) % 2) * kTileBytes, k_bh, k0 + kF32B,
                   kF32B, g.sk);
    cp_async_commit();
    float s[4][4], dp[4][4];
    if (active) {
      f32_scores<D>(q_s + rb * S, k_t + tx * S, s);     // S = Q K^T
      f32_scores<D>(do_s + rb * S, v_s + tx * S, dp);   // dP = dO V^T
    }
    __syncthreads();              // every warp is done with V_t
    if (t + 1 < n_tiles)          // V_{t+1} while dS K_t runs
      f32_stage<D>(v_u, v_bh, k0 + kF32B, kF32B, g.sk);
    cp_async_commit();
    if (active) {
      const bool all_live = tile_live(qw0, 8, k0, kF32B, g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + 2 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = all_live || live(q0 + r, k0 + c, g)
                              ? exp2f(fmaf(s[i][j], g.scale_log2, -lse2[i]))
                              : 0.f;
          ds_s[r * kF32PS + c] = p * (dp[i][j] - dlt[i]);
        }
      }
      __syncwarp();
      f32_accumulate<D>(ds_s + rb * kF32PS, k_t, tx, acc);  // dQ += dS K_t
    }
  }
  cp_async_wait<0>();

  // dq = acc * scale; rows past Sq are never written
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rb + 2 * i;
    if (row < g.sq)
      store_bcols<D>(dq + ((size_t)bh * g.sq + row) * D, tx, acc[i],
                     g.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, F32Bwd<D>::kBlocks)
sm90_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, Geometry g, int split) {
  constexpr int S = F32Tiles<D>::kStride, T = F32Bwd<D>::kTile;
  constexpr int DN = D / 16;
  constexpr uint32_t kTileBytes = 4u * T;
  extern __shared__ float4 f32_smem[];
  float* const k_s = reinterpret_cast<float*>(f32_smem);   // [64][S]
  float* const v_s = k_s + T;                              // [64][S]
  float* const q_s = v_s + T;                              // [2][64][S]
  float* const do_s = q_s + 2 * T;                         // [64][S]
  float* const pd_s = do_s + T;                            // [64][kF32PS]
  float* const rows_s = pd_s + kF32B * kF32PS;  // [2][lse, delta][64]
  const uint32_t q_u = smem_u32(q_s), do_u = smem_u32(do_s);
  const uint32_t rows_u = smem_u32(rows_s);

  const int warp = threadIdx.x / 32, tx = threadIdx.x % 16;
  const int kb = 8 * warp + (threadIdx.x / 16) % 2;    // keys kb + 2 i
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y / split * kF32B;            // most q-tiles first
  const int rank = blockIdx.y % split;                  // in the cluster
  const int b = bkv / g.hkv, kv = bkv % g.hkv;
  const int n_g = g.hq / g.hkv;
  int lo, hi;
  q_range(k0, kF32B, g, lo, hi);
  const int qt0 = lo < hi ? lo / kF32B * kF32B : hi;
  const int n_qt = lo < hi ? (hi - qt0 + kF32B - 1) / kF32B : 0;
  // the key block's (query head, q-tile) pairs are t = 0 .. n_g n_qt - 1;
  // this CTA takes t = rank + u split, u = 0 .. n_tiles - 1
  const int n_tiles = (n_g * n_qt - rank + split - 1) / split;
  const int kw0 = k0 + 8 * warp;                        // the warp's keys
  int wlo, whi;
  q_range(kw0, 8, g, wlo, whi);
  const bool keys_in = kw0 < g.sk;

  // the CTA's tile u: query head n_g kv + t / n_qt of the group, rows
  // from qt(u), where t = rank + u split
  const auto head = [&](int u) {
    return (size_t)b * g.hq + (size_t)kv * n_g + (rank + u * split) / n_qt;
  };
  const auto qt = [&](int u) {
    return qt0 + (rank + u * split) % n_qt * kF32B;
  };
  // Q of tile u, its lse and delta into Q slot `slot`
  const auto stage_q = [&](int u, int slot) {
    const size_t bh = head(u);
    const int r0 = qt(u);
    f32_stage<D>(q_u + slot * kTileBytes, q + bh * g.sq * D, r0, kF32B,
                 g.sq);
    if (threadIdx.x < 2 * kF32B) {
      const int r = threadIdx.x % kF32B;
      const bool in = r0 + r < g.sq;
      cp_async4(rows_u + 4u * (2 * kF32B * slot + threadIdx.x),
                (threadIdx.x < kF32B ? lse : delta)
                    + (in ? bh * g.sq + r0 + r : 0),
                in);
    }
  };
  const auto stage_do = [&](int u) {
    f32_stage<D>(do_u, dout + head(u) * g.sq * D, qt(u), kF32B, g.sq);
  };

  float dka[4][DN], dva[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dka[i][c] = dva[i][c] = 0.f;

  if (n_tiles > 0) {                        // groups: K and V, Q_0, dO_0
    f32_stage<D>(smem_u32(k_s), k + (size_t)bkv * g.sk * D, k0, kF32B,
                 g.sk);
    f32_stage<D>(smem_u32(v_s), v + (size_t)bkv * g.sk * D, k0, kF32B,
                 g.sk);
    cp_async_commit();
    stage_q(0, 0);
    cp_async_commit();
    stage_do(0);
    cp_async_commit();
  }
  for (int u = 0; u < n_tiles; ++u) {
    const int r0 = qt(u);
    const bool active = keys_in && r0 < whi && r0 + kF32B > wlo;
    const float* q_t = q_s + (u % 2) * T;
    const float* rows = rows_s + (u % 2) * 2 * kF32B;
    cp_async_wait<0>();           // Q_u, its rows and dO_u have landed
    __syncthreads();              // for every thread; tile u - 1 is done
    if (u + 1 < n_tiles)          // Q_{u+1} into Q_{u-1}'s slot
      stage_q(u + 1, (u + 1) % 2);
    cp_async_commit();
    float p[4][4], dp[4][4];
    if (active) {
      f32_scores<D>(k_s + kb * S, q_t + tx * S, p);     // S^T = K Q^T
      const bool all_live = tile_live(r0, kF32B, kw0, 8, g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + 2 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          p[i][j] = all_live || live(r0 + c, k0 + key, g)
                        ? exp2f(fmaf(p[i][j], g.scale_log2,
                                     -rows[c] * kLog2e))
                        : 0.f;
          pd_s[key * kF32PS + c] = p[i][j];
        }
      }
      __syncwarp();
      f32_accumulate<D>(pd_s + kb * kF32PS, do_s, tx, dva);  // dV += P^T dO
      f32_scores<D>(v_s + kb * S, do_s + tx * S, dp);  // dP^T = V dO^T
    }
    __syncthreads();              // every warp is done with dO_u
    if (u + 1 < n_tiles)          // dO_{u+1} while dS^T Q_u runs
      stage_do(u + 1);
    cp_async_commit();
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          pd_s[(kb + 2 * i) * kF32PS + c] =
              p[i][j] * (dp[i][j] - rows[kF32B + c]);
        }
      __syncwarp();
      f32_accumulate<D>(pd_s + kb * kF32PS, q_t, tx, dka);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();

  // dk = acc * scale, dv = acc; keys past Sk are never written
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + kb + 2 * i;
      if (key >= g.sk) continue;
      const size_t off = ((size_t)bkv * g.sk + key) * D;
      store_bcols<D>(dk + off, tx, dka[i], g.scale);
      store_bcols<D>(dv + off, tx, dva[i], 1.f);
    }
    return;
  }
  // a cluster of `split` CTAs shares the key block: each puts its partial
  // sums in its own shared memory, slot (r, c) of thread x at
  // (r DN + c) 256 + x for its rows r = 0..3 of dK and 4..7 of dV; then
  // rank q sums rows r = q, q + split, ... over the ranks in rank order
  // (fixed, so dk and dv stay deterministic), reading the others' through
  // distributed shared memory, and stores them
  float* const part = reinterpret_cast<float*>(f32_smem);
  __syncthreads();                // every warp is done with the tiles
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      part[(i * DN + c) * kF32Threads + threadIdx.x] = dka[i][c];
      part[((4 + i) * DN + c) * kF32Threads + threadIdx.x] = dva[i][c];
    }
  cluster_sync();                 // every rank's partials are in place
  for (int r = rank; r < 8; r += split) {
    float x[DN];
#pragma unroll
    for (int c = 0; c < DN; ++c) x[c] = 0.f;
    for (int src = 0; src < split; ++src) {
      const float* other = cluster_map(part, src);
#pragma unroll
      for (int c = 0; c < DN; ++c)
        x[c] += other[(r * DN + c) * kF32Threads + threadIdx.x];
    }
    const int key = k0 + kb + 2 * (r % 4);
    if (key < g.sk)
      store_bcols<D>((r < 4 ? dk : dv) + ((size_t)bkv * g.sk + key) * D, tx,
                     x, r < 4 ? g.scale : 1.f);
  }
  cluster_sync();                 // no rank leaves while its partials are read
}

// ------------------------------------------------------------- launches --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 3-D map over (D, rows, heads) of 16-bit values, boxes of (64, box_rows,
// 1), 128-byte swizzle, zeros outside (at D 112, columns 112-127 of a
// row's second box)
bool make_map(CUtensorMap* map, EncodeTiled enc, CUtensorMapDataType dt,
              const void* ptr, int d, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// each kernel's dynamic shared memory: the alignment slack, the tiles (at
// the padded width), K2kv's rows, the barriers
template <int D> constexpr size_t fwd_smem() {
  return 1024 + (size_t)kBQ * Padded<D>::value * 2 +
         2 * kStages * (size_t)TileK<D>::value * Padded<D>::value * 2 +
         8 * (1 + 2 * kStages);
}
template <int D> constexpr size_t dq_smem() {
  return fwd_smem<D>() + (size_t)kBQ * Padded<D>::value * 2;
}
template <int D> constexpr size_t dkv_smem() {
  return 1024 + 2 * (size_t)kBKV * Padded<D>::value * 2 +
         2 * kStages * (size_t)TileQ<D>::value * Padded<D>::value * 2 +
         kStages * 2 * (size_t)TileQ<D>::value * 4 + 8 * (1 + 2 * kStages);
}

constexpr CUtensorMapDataType map_dtype(Bf16) {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
constexpr CUtensorMapDataType map_dtype(F16) {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o, *lse, *dq, *dk, *dv;
  int b;
  Geometry g;
  cudaStream_t stream;
};

enum Which { kFwd, kDq, kDkv };

// the four maps over q, dO (box rows q_rows) and k, v (box rows k_rows);
// dO's is left out when a.dout is null (the forward)
template <typename Tag, int D>
bool make_maps(CUtensorMap (&m)[4], const Args& a, int q_rows, int k_rows) {
  const EncodeTiled enc = encode_tiled();
  const CUtensorMapDataType dt = map_dtype(Tag{});
  const int bq = a.b * a.g.hq, bkv = a.b * a.g.hkv;
  return enc && make_map(&m[0], enc, dt, a.q, D, a.g.sq, bq, q_rows) &&
         (!a.dout || make_map(&m[1], enc, dt, a.dout, D, a.g.sq, bq, q_rows)) &&
         make_map(&m[2], enc, dt, a.k, D, a.g.sk, bkv, k_rows) &&
         make_map(&m[3], enc, dt, a.v, D, a.g.sk, bkv, k_rows);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Tag, int D>
int run(Which which, const Args& a) {
  CUtensorMap m[4];
  const float* lse = static_cast<const float*>(a.lse_in);
  const float* delta = static_cast<const float*>(a.delta);
  const dim3 q_grid(a.b * a.g.hq, (a.g.sq + kBQ - 1) / kBQ);
  int err;
  if (which == kFwd) {
    if (!make_maps<Tag, D>(m, a, kBQ, TileK<D>::value))
      return (int)cudaErrorInvalidValue;
    if ((err = prepare(sm90_fwd_kernel<Tag, D>, fwd_smem<D>()))) return err;
    sm90_fwd_kernel<Tag, D><<<q_grid, kThreads, fwd_smem<D>(), a.stream>>>(
        m[0], m[2], m[3], static_cast<float*>(a.o),
        static_cast<float*>(a.lse), a.g);
  } else if (which == kDq) {
    if (!make_maps<Tag, D>(m, a, kBQ, TileK<D>::value))
      return (int)cudaErrorInvalidValue;
    if ((err = prepare(sm90_dq_kernel<Tag, D>, dq_smem<D>()))) return err;
    sm90_dq_kernel<Tag, D><<<q_grid, kBwdThreads, dq_smem<D>(), a.stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<uint16_t*>(a.dq),
        a.g);
  } else {
    if (!make_maps<Tag, D>(m, a, TileQ<D>::value, kBKV))
      return (int)cudaErrorInvalidValue;
    if ((err = prepare(sm90_dkv_kernel<Tag, D>, dkv_smem<D>()))) return err;
    const dim3 grid(a.b * a.g.hkv, (a.g.sk + kBKV - 1) / kBKV);
    sm90_dkv_kernel<Tag, D><<<grid, kBwdThreads, dkv_smem<D>(),
                                a.stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<uint16_t*>(a.dk),
        static_cast<uint16_t*>(a.dv), a.g);
  }
  return (int)cudaGetLastError();
}

// K2kv's float32 cluster size: the CTAs that share a key block, a power of
// two up to 8, doubled while the grid of `blocks` key blocks leaves some of
// the card's CTA slots (`per_sm` an SM) empty and the largest key block
// keeps two tiles for each CTA (its tiles: n_g times the q-tiles its keys'
// rows span, which a window bounds). A measured A/B chose one wave over
// two: clusters of 4 at the server shape (3 tiles a CTA) ran no faster than
// none, clusters of 2 ran 27% faster, and at the train and d64 shapes
// (already a wave or more) clusters of 2 ran 12-31% slower. Returns the
// first CUDA error of reading the card's SM count.
int dkv_split(int blocks, const Geometry& g, int per_sm, int& split) {
  int dev = 0, n_sm = 0, err;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(
           &n_sm, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const int span = g.window && g.window + kF32B - 1 < g.sq
                       ? g.window + kF32B - 1 : g.sq;
  const int tiles = g.hq / g.hkv * ((span + kF32B - 1) / kF32B + 1);
  split = 1;
  while (split < 8 && 4 * split <= tiles && blocks * split < n_sm * per_sm)
    split *= 2;
  return 0;
}

// float32: the forward on K2f's grid and order (128-row q-blocks), K2q on
// (b*Hq + h, 64-row q-block), K2kv on (b*Hkv + kv, 64-key block) with
// `split` CTAs (a cluster) to a key block
template <int D>
int run_f32(Which which, const Args& a) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse_in);
  const float* delta = static_cast<const float*>(a.delta);
  constexpr size_t bwd = F32Bwd<D>::kBytes;
  int err;
  if (which == kFwd) {
    if ((err = prepare(sm90_fwd_f32_kernel<D>, F32Tiles<D>::kBytes)))
      return err;
    const dim3 grid(a.b * a.g.hq, (a.g.sq + kBQ - 1) / kBQ);
    sm90_fwd_f32_kernel<D><<<grid, kF32Threads, F32Tiles<D>::kBytes,
                             a.stream>>>(q, k, v, static_cast<float*>(a.o),
                                         static_cast<float*>(a.lse), a.g);
  } else if (which == kDq) {
    if ((a.g.sq + kF32B - 1) / kF32B > 65535)
      return (int)cudaErrorInvalidValue;
    if ((err = prepare(sm90_dq_f32_kernel<D>, bwd))) return err;
    const dim3 grid(a.b * a.g.hq, (a.g.sq + kF32B - 1) / kF32B);
    sm90_dq_f32_kernel<D><<<grid, kF32Threads, bwd, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.g);
  } else {
    const int n_kb = (a.g.sk + kF32B - 1) / kF32B;
    int split;
    if ((err = dkv_split(a.b * a.g.hkv * n_kb, a.g, F32Bwd<D>::kBlocks,
                         split)))
      return err;
    if (n_kb * split > 65535) return (int)cudaErrorInvalidValue;
    if ((err = prepare(sm90_dkv_f32_kernel<D>, bwd))) return err;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = split;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.b * a.g.hkv, n_kb * split);
    cfg.blockDim = dim3(kF32Threads);
    cfg.dynamicSmemBytes = bwd;
    cfg.stream = a.stream;
    cfg.attrs = cluster;
    cfg.numAttrs = split > 1 ? 1 : 0;
    if ((err = (int)cudaLaunchKernelEx(
             &cfg, sm90_dkv_f32_kernel<D>, q, k, v, dout, lse, delta,
             static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.g,
             split)))
      return err;
  }
  return (int)cudaGetLastError();
}

// dtype: 1 bfloat16, 2 float16 at d 64, 112 or 128; 0 float32 at d 32, 64,
// 112 or 128
int dispatch(Which which, int dtype, int d, int hq, int hkv, int sq, int sk,
             int causal, int window, float scale, Args& a) {
  if (a.b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0 ||
      window < 0 || (sq + kBQ - 1) / kBQ > 65535 ||
      (sk + kBKV - 1) / kBKV > 65535)
    return (int)cudaErrorInvalidValue;
  a.g = Geometry{hq, hkv, sq, sk, causal, window, sk - sq, scale,
                 scale * kLog2e};
  if (dtype == 0) {
    switch (d) {
      case 32: return run_f32<32>(which, a);
      case 64: return run_f32<64>(which, a);
      case 112: return run_f32<112>(which, a);
      case 128: return run_f32<128>(which, a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && d == 64) return run<Bf16, 64>(which, a);
  if (dtype == 1 && d == 112) return run<Bf16, 112>(which, a);
  if (dtype == 1 && d == 128) return run<Bf16, 128>(which, a);
  if (dtype == 2 && d == 64) return run<F16, 64>(which, a);
  if (dtype == 2 && d == 112) return run<F16, 112>(which, a);
  if (dtype == 2 && d == 128) return run<F16, 128>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns a cudaError_t.
extern "C" int flash_attention_fwd_sm90_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int window, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse; a.b = b;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kFwd, dtype, d, hq, hkv, sq, sk, causal, window, scale, a);
}

extern "C" int flash_attention_sm90_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int sq, int sk, int d, int causal, int window, float scale,
    void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq = dq; a.b = b;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDq, dtype, d, hq, hkv, sq, sk, causal, window, scale, a);
}

extern "C" int flash_attention_sm90_bwd_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int sq, int sk, int d, int causal, int window, float scale,
    void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dk = dk; a.dv = dv; a.b = b;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDkv, dtype, d, hq, hkv, sq, sk, causal, window, scale, a);
}
