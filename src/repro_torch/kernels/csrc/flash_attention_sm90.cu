// K2f on Hopper's tensor cores: the flash-attention forward for bfloat16
// and float16 at head dims 64 and 128, with wgmma and TMA (sm_90a).
//
// Replaces the Pallas forward of src/repro/kernels/flash_attention.py:
// _fwd_flat via flash_attention (pallas_call at :171), whose body is
// _flash_kernel (:88). It computes exactly what flash_attention.cu's
// SIMT fwd_kernel computes, with the same contract:
//   q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), contiguous, in bfloat16 or
//   float16, D 64 or 128; query head h reads KV head h / (Hq / Hkv); the
//   q tokens are the last Sq of the Sk keys (seq_off = Sk - Sq); key k is
//   live for query q when k < Sk, q < Sq, (not causal or k <= q +
//   seq_off) and (window == 0 or q + seq_off - k < window).
//   Out: o_f32 (B*Hq, Sq, D) and lse (B*Hq, Sq), float32; a row with no
//   live key gives o = 0 and lse = NEG_INF = -2^30 exactly.
// The wrapper (kernels/flash_attention.py, fwd_route) sends every other
// dtype and head dim to fwd_kernel.
//
// Bound on an H100 (989 TFLOP/s bf16/fp16, 3.35 TB/s): a causal call does
// 4 D flops a live (q, k) pair and moves q, k, v once in 16 bits and
// o_f32 once in float32. At one 4096-token sequence (24/8 heads, D 128)
// that is 103 GFLOP against 92 MB: operations bound it. At the LLM path's
// server and train shapes (S 256) and at D 64 the float32 o_f32 write is
// over half of the bytes and bytes bound it. So the design does two
// things: it keeps the tensor cores fed on long rows (both products on
// wgmma, tiles arriving by TMA while the previous tile computes), and it
// reads each q, k and v byte once per CTA and writes o_f32 once, straight
// from the accumulator registers in full 32-byte sectors.
//
// Design. One CTA per (b*Hq + h, 128-row q-block), launched longest rows
// first (blockIdx.y = 0 is the last q-block), so the causal triangle's
// long rows do not form the tail wave. 288 threads: two consumer
// warpgroups of 64 q rows each and one producer warp.
//   Producer (one thread): Q once, then each live k-tile's K and V by TMA
//     (cp.async.bulk.tensor, 3-D maps (D, S, B*H), so a ragged tail past
//     Sk or Sq reads zeros from its own head, never the next head's rows)
//     into a two-stage ring with a full and an empty mbarrier per stage.
//     Dead tiles (past the causal diagonal, before the window) are never
//     loaded. With SWIZZLE_128B a box is at most 128 bytes wide, so a
//     D-128 row is two 64-column boxes: every tile is stored as D/64
//     halves of (rows, 64), each in the 128-byte swizzled layout.
//   Consumers (per warpgroup, per tile):
//     S = Q K^T with wgmma m64nBKk16, both operands K-major in shared
//       memory (SS): D/16 instructions, the descriptor stepping 32 B per
//       k16 inside a swizzle atom and to the next half every 4 steps;
//     the online softmax on the accumulator fragments in registers, in
//       the log2 domain: a row's values sit in the 4 threads of a quad
//       (two __shfl_xor_sync); the mask is evaluated only on tiles that
//       straddle the diagonal, the window's edge or the ragged end; a
//       masked score is -inf and the running max starts at NEG_INF, so
//       p = 0 there and exp(NEG_INF - NEG_INF) never counts; l sums the
//       float32 p;
//     O = O * alpha + P V with wgmma m64nDk16, A = P from registers (RS):
//       P is rounded to the input's 16-bit type and the accumulator's
//       (row, column pair) layout is the A fragment's, so the repacking
//       is a pairwise pack; B = V, stored key-major, which is MN-major for
//       this product: transpose-B is set, the descriptor's leading offset
//       steps between the two 64-column halves and its stride offset
//       between 8-key groups;
//     a warpgroup whose 64 rows see none of a tile only releases it.
//   Epilogue: o = acc / max(l, 1e-30) written as float32, lse = m + log l
//   where l > 0 and NEG_INF elsewhere; rows past Sq are never written.
// Rounding P to 16 bits before PV (as every tensor-core flash attention
// does) moves each o entry by at most u max|v| (u = 2^-9 bf16, 2^-12
// fp16); lse comes from float32 scores and a float32 l.
//
// Left for later: ping-pong between the two consumer warpgroups,
// overlapping softmax with wgmma inside a warpgroup, a persistent tile
// scheduler, clusters with TMA multicast, o in 16 bits, fp8.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (cudaGetDriverEntryPoint
// or, from CUDA 12.5, its ByVersion form), so the library needs no -lcuda.
// The C interface has flash_attention_fwd_launch's argument list, sets the
// dynamic shared-memory limit, launches once on the given stream and
// returns the first CUDA error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                    // q rows a CTA
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kStages = 2;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the k-tile: 128 keys at D 64, 64 at D 128 (the accumulators of S, P and
// O then fit the registers of 288 threads with one CTA an SM)
template <int D> struct TileK {
  static constexpr int value = D == 64 ? 128 : 64;
};

// dtype tags for the wgmma overloads
struct Bf16 {};
struct F16 {};

struct Geometry {
  int hq, hkv, sq, sk, causal, window, seq_off;
  float scale_log2;   // the softmax scale times log2(e)
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

// ------------------------------------------------------ PTX wrappers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a (64, rows, 1) box at (c0, c1, c2) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a shared-memory matrix descriptor in the 128-byte swizzled layout: start
// address, leading and stride byte offsets (16-byte units), layout type 1
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ uint32_t pack2(float a, float b, Bf16) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, F16) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma.mma_async m64nNk16 into float32 accumulators d[N / 2]: wgmma_ss
// reads A and B through descriptors, K-major (acc = 0 overwrites d);
// wgmma_rs reads A from registers and B MN-major (transpose-B) and
// accumulates.

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc, Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc, Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc, F16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         F16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc, F16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         F16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------------ K2f --

template <typename Tag, int D>
__global__ void __launch_bounds__(kThreads, 1)
sm90_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                float* __restrict__ o, float* __restrict__ lse, Geometry g) {
  constexpr int BK = TileK<D>::value;
  constexpr int NH = D / 64;                  // 128-byte halves of a row
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

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

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

  // o = acc / l, lse = m + log l (back from the log2 domain)
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
// 1), 128-byte swizzle, zeros outside
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

template <int D> constexpr size_t smem_bytes() {
  // alignment slack, Q, the K and V rings, the barriers
  return 1024 + (size_t)kBQ * D * 2 + 2 * kStages * (size_t)TileK<D>::value * D * 2
         + 8 * (1 + 2 * kStages);
}

template <typename Tag, int D>
int run(CUtensorMapDataType dt, const void* q, const void* k, const void* v,
        void* o, void* lse, int b, const Geometry& g, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, enc, dt, q, D, g.sq, b * g.hq, kBQ) ||
      !make_map(&tk, enc, dt, k, D, g.sk, b * g.hkv, TileK<D>::value) ||
      !make_map(&tv, enc, dt, v, D, g.sk, b * g.hkv, TileK<D>::value))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  int err = (int)cudaFuncSetAttribute(
      sm90_fwd_kernel<Tag, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  const dim3 grid(b * g.hq, (g.sq + kBQ - 1) / kBQ);
  sm90_fwd_kernel<Tag, D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 bfloat16, 2 float16 (0, float32, is not taken); d: 64 or 128.
// Returns a cudaError_t.
extern "C" int flash_attention_fwd_sm90_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int window, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0 ||
      window < 0 || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry g{hq, hkv, sq, sk, causal, window, sk - sq,
                   scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64)
    return run<Bf16, 64>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, o, lse, b,
                         g, st);
  if (dtype == 1 && d == 128)
    return run<Bf16, 128>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, o, lse,
                          b, g, st);
  if (dtype == 2 && d == 64)
    return run<F16, 64>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, o, lse, b,
                        g, st);
  if (dtype == 2 && d == 128)
    return run<F16, 128>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, o, lse, b,
                         g, st);
  return (int)cudaErrorInvalidValue;
}
