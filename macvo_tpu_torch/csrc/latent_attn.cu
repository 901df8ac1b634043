// Fused latent cross-attention of the FlowFormer cost perceiver, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel macvo_tpu/ops/latent_attn.py:_kernel (launched by
// latent_cross_attention). Per source pixel it reads T cost-patch tokens of 64 dims and
// writes the 8 latent outputs of 128 dims:
//
//     k = tok Wk' + bk,  v = tok Wv' + bv      (input_proj folded into Wk', Wv')
//     a = softmax_t((q d^-1/2) k^T),  out = (a v) Wp + bias
//
// Both the scores and the output are linear in the tokens, so the weights fold
// (macvo_tpu_torch/ops/latent_attn.py:fold_weights; CostPerceiverEncoder does it once,
// when its weights are loaded):
//
//     M   = Wk' (q d^-1/2)^T          (64 x 8)    score weights; bk . q cancels in the softmax
//     Wvp = Wv' Wp                    (64 x 128)
//     c   = bv Wp + bias              (8 x 128)   since sum_t a = 1
//
// and the kernel computes, per pixel, s = tok M (T x 8), a = softmax over T,
// y = a^T tok (8 x 64) and out = y Wvp + c: 0.34 MFLOP a pixel at T = 100.
//
// What bounds it on an H100: at 640x640 one call has N = 12,800 pixels and T = 100.
// In bf16 it reads 164 MB of tokens and writes 26 MB, 57 us at 3.35 TB/s; its 4.3 GFLOP
// take 4 us at the bf16 tensor-core rate. In fp32 the bytes double (113 us) and the same
// FLOPs take 64 us at the fp32 rate (67 TFLOP/s). Both are bound by the bytes, so the
// design is about reading each token byte from device memory once, with enough bytes in
// flight, while the math of earlier pixels runs.
//
// Design.
// * Copies. A pixel's tokens are one (T, 64) tile, moved by the Tensor Memory
//   Accelerator into a ring of S slots in shared memory (S = 1..6, as many as fit for
//   this T and type: 6 for bf16 and 5 for fp32 at T = 100), each slot completing on an
//   mbarrier. In bf16 a producer warp keeps the ring full and consumer warps (up to 4)
//   hand the slots back through a second mbarrier; in fp32 the group that has read a
//   slot's tile reloads that slot itself (no producer warp: its registers go to the 16
//   consumer warps). A per-slot record of the unit loaded makes every wait exact (a
//   phase parity cannot tell a round from the one two before). The copy is a 3-D (bf16:
//   64 x T x N) or 4-D (fp32: 32 x 2 x T x N) tiled TMA load with the 128-byte swizzle,
//   its tensor map built on the host through the driver's cuTensorMapEncodeTiled: a
//   linear tile would put the 8 rows of every 8x8 fragment load in the same shared-memory
//   banks (rows are 128 bytes apart), the swizzle spreads them. Token rows past T are
//   out of bounds of the map and arrive as zeros; a box is at most 256 rows, so T > 256
//   takes two boxes.
// * bf16: the three products run on the tensor cores (mma.sync.m16n8k16, bf16 inputs,
//   fp32 sums); a slot holds two pixels and a consumer warp takes both:
//     s = tok M        A = 16 tokens (ldmatrix from the swizzled tile), B = M, n = the 8
//                      queries; M is split into hi + lo bf16 parts (two mma), so the
//                      fp32 weights keep ~16 bits;
//     softmax          online over the 16-token tiles, per query column, with the
//                      running max and sum in registers (a C fragment's columns are the
//                      same two queries as the y fragment's, so the rescaling is local);
//     y^T = tok^T a    A = tok^T (ldmatrix.trans), B = a: the probabilities of a tile,
//                      split hi + lo, are exactly the B fragments once each 8x8 block
//                      is transposed with movmatrix, so a never leaves the registers;
//     out = y Wvp + c  the two pixels' 8 queries are the 16 rows; y (transposed back
//                      with movmatrix) and Wvp are both split, three mma per product
//                      (hi hi, lo hi, hi lo); Wvp's fragments sit in shared memory in
//                      fragment order, c initialises the sums.
//   The tokens themselves are bf16 already and need no split; every sum is fp32.
// * fp32 stays on the CUDA cores (Performant runs with TF32 off): a slot holds one pixel
//   and a group of 4 warps shares it; 4 groups (16 warps, 128 registers a thread) and 5
//   slots fit an SM at T = 100. Each warp owns a contiguous quarter of the tokens and
//   runs the attention over them on its own, flash-attention style (scores, its own max,
//   probabilities, their sum, a partial y), so the group meets at only three barriers a
//   pixel: to combine the 4 partials, each rescaled by 2^(m_w - m), before the output
//   projection, and after it (y shares its scratch with the next pixel's scores). Every
//   product is register-tiled, because with one FMA a shared load the shared-memory
//   pipe, not the FMA pipe, sets the pace: a lane scores 2 tokens x 4 queries (per 4
//   dims 6 loads feed 32 FMAs), sums y for 4 dims x 4 queries (2 loads feed 16 FMAs),
//   and projects 4 columns x 8 queries over a quarter of the dims (3 loads feed 32
//   FMAs), the quarters met by a reduce-scatter of shuffles. Swizzle offsets are set
//   outside the token loops.
// * A persistent grid of one block an SM walks the pixels (pairs in bf16) in a stride.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DIN = 64;    // token dim
constexpr int NQ = 8;      // latent queries
constexpr int DO = 128;    // latent dim
constexpr int MAX_TOKENS = 512;
constexpr int MAX_CONSUMERS = 4;   // bf16: consumer warps
constexpr int MAX_GROUPS = 4;      // fp32: consumer groups of 4 warps
constexpr int MAX_SLOTS = 6;
constexpr int BOX_ROWS_MAX = 256;                 // a TMA box is at most 256 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_LIMIT = 232448;              // an H100 block's dynamic shared memory

// Shared-memory regions after the ring (bytes).
constexpr int WFRAG_BYTES = 4 * 16 * 2 * 32 * 8;   // bf16 Wvp fragments: [ks][nt][hi,lo][lane] x 8 B
constexpr int C_BYTES = NQ * DO * 4;
constexpr int M_BYTES = DIN * NQ * 4;
constexpr int WVP_BYTES = DIN * DO * 4;

// ---------------------------------------------------------------- PTX wrappers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// Wait until slot s holds unit k (its round k / S). A phase parity alone cannot tell
// round r from round r - 2, and a consumer may reach round r of a slot while round r - 1,
// another consumer's, is still in flight; so each load also records in `unit` which
// unit it loaded last into each slot, and a wait counts only once that is k.
__device__ __forceinline__ void wait_slot(uint64_t* full, const volatile int* unit, int s, int k, int slots) {
  const uint32_t parity = (k / slots) & 1;
  do {
    mbar_wait(&full[s], parity);
  } while (unit[s] != k);
  mbar_wait(&full[s], parity);    // now round k / S - 1 is complete: the parity is exact
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t movm_t(uint32_t x) {   // transpose an 8x8 b16 fragment
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d += a b, m16n8k16, bf16 in, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) -> packed bf16 hi parts and the packed bf16 rests (x - hi), low half first.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float quad_max(float v) {     // over the 8 lanes of one column (lane % 4)
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
// ------------------------------------------------------------- launch geometry
struct Plan {
  int n_tok;        // T
  int box_rows;     // rows a TMA box (multiple of 16, <= 256)
  int boxes;        // boxes a pixel
  int pix_bytes;    // a pixel's tile in shared memory (multiple of 1024)
  int per_slot;     // pixels a slot: 2 (bf16) or 1 (fp32)
  int slots;        // S
  int consumers;    // a warp each in bf16, a group of 4 warps each in fp32 (<= S - 1)
  int threads;      // bf16: 32 x (1 producer + consumer warps); fp32: 32 x consumer warps
  int scratch;      // fp32 scratch floats a consumer group
  size_t smem;      // dynamic shared memory, 1024 bytes of alignment slack included
};

// ------------------------------------------------------------- bf16 consumer
// Byte offset of 16-byte chunk `chunk` of token row t in a swizzled bf16 tile.
__device__ __forceinline__ uint32_t swz_bf16(int t, int chunk) {
  return static_cast<uint32_t>(t * 128 + ((chunk ^ (t & 7)) << 4));
}

// One pixel's y^T (64 dims x 8 queries, as 4 C fragments), normalised.
__device__ __forceinline__ void pixel_y_bf16(const char* tile, int n_tok, const uint32_t (&mh)[4][2],
                                             const uint32_t (&ml)[4][2], float (&y)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, i = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) y[dt][r] = 0.f;
  float run_m0 = -INFINITY, run_m1 = -INFINITY, run_l0 = 0.f, run_l1 = 0.f;
  const int tiles = (n_tok + 15) / 16;
  for (int tt = 0; tt < tiles; ++tt) {
    const int t0 = tt * 16;
    // s = tok M for 16 tokens: rows t0+g (s[0], s[1]) and t0+8+g (s[2], s[3]), queries 2q, 2q+1.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, tile + swz_bf16(t0 + i + (mat & 1) * 8, 2 * ks + (mat >> 1)));
      mma(s, a, mh[ks][0], mh[ks][1]);
      mma(s, a, ml[ks][0], ml[ks][1]);
    }
    const bool v0 = t0 + g < n_tok, v1 = t0 + 8 + g < n_tok;
    const float s00 = v0 ? s[0] : -INFINITY, s01 = v0 ? s[1] : -INFINITY;
    const float s10 = v1 ? s[2] : -INFINITY, s11 = v1 ? s[3] : -INFINITY;
    const float new0 = fmaxf(run_m0, quad_max(fmaxf(s00, s10)));
    const float new1 = fmaxf(run_m1, quad_max(fmaxf(s01, s11)));
    const float alpha0 = exp2f(run_m0 - new0), alpha1 = exp2f(run_m1 - new1);
    run_m0 = new0;
    run_m1 = new1;
    const float p00 = exp2f(s00 - new0), p01 = exp2f(s01 - new1);
    const float p10 = exp2f(s10 - new0), p11 = exp2f(s11 - new1);
    run_l0 = run_l0 * alpha0 + p00 + p10;
    run_l1 = run_l1 * alpha1 + p01 + p11;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      y[dt][0] *= alpha0;
      y[dt][1] *= alpha1;
      y[dt][2] *= alpha0;
      y[dt][3] *= alpha1;
    }
    // The probabilities as B fragments (k = token, n = query): transpose each 8x8 block.
    uint32_t th, tl, bh, bl;
    split2(p00, p01, th, tl);
    split2(p10, p11, bh, bl);
    const uint32_t bh0 = movm_t(th), bh1 = movm_t(bh), bl0 = movm_t(tl), bl1 = movm_t(bl);
    // y^T += tok^T a, 16 dims at a time.
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      uint32_t a[4];
      ldsm_x4_t(a, tile + swz_bf16(t0 + i + (mat >> 1) * 8, 2 * dt + (mat & 1)));
      mma(y[dt], a, bh0, bh1);
      mma(y[dt], a, bl0, bl1);
    }
  }
  const float inv0 = 1.f / quad_sum(run_l0), inv1 = 1.f / quad_sum(run_l1);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    y[dt][0] *= inv0;
    y[dt][1] *= inv1;
    y[dt][2] *= inv0;
    y[dt][3] *= inv1;
  }
}

// out rows of a pixel pair: y (8 queries each, 16 rows) times Wvp, plus c; bf16 stores.
__device__ __forceinline__ void pair_out_bf16(const float (&y0)[4][4], const float (&y1)[4][4],
                                              const uint2* __restrict__ wfrag, const float* __restrict__ sc,
                                              __nv_bfloat16* __restrict__ out, long long p0, long long n_pix) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t h[4], l[4];
    split2(y0[ks][0], y0[ks][1], h[0], l[0]);      // pixel 0, dims 16ks + g
    split2(y1[ks][0], y1[ks][1], h[1], l[1]);      // pixel 1, dims 16ks + g
    split2(y0[ks][2], y0[ks][3], h[2], l[2]);      // pixel 0, dims 16ks + 8 + g
    split2(y1[ks][2], y1[ks][3], h[3], l[3]);      // pixel 1, dims 16ks + 8 + g
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ah[ks][r] = movm_t(h[r]);
      al[ks][r] = movm_t(l[r]);
    }
  }
  __nv_bfloat16* o0 = out + p0 * NQ * DO + g * DO + 2 * q;
  const bool has1 = p0 + 1 < n_pix;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 cv = *reinterpret_cast<const float2*>(sc + g * DO + 8 * (half * 8 + nt) + 2 * q);
      acc[nt][0] = cv.x;
      acc[nt][1] = cv.y;
      acc[nt][2] = cv.x;
      acc[nt][3] = cv.y;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = half * 8 + nt;
        const uint2 wh = wfrag[((ks * 16 + n) * 2 + 0) * 32 + lane];
        const uint2 wl = wfrag[((ks * 16 + n) * 2 + 1) * 32 + lane];
        mma(acc[nt], ah[ks], wh.x, wh.y);
        mma(acc[nt], al[ks], wh.x, wh.y);
        mma(acc[nt], ah[ks], wl.x, wl.y);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int e = 8 * (half * 8 + nt);
      *reinterpret_cast<__nv_bfloat162*>(o0 + e) = __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      if (has1) *reinterpret_cast<__nv_bfloat162*>(o0 + NQ * DO + e) = __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
}

// ------------------------------------------------------------- fp32 consumer
// fp32 tiles: a token is two 128-byte rows (dims 0-31, 32-63); the 128-byte TMA swizzle
// stores 16-byte chunk c of row r at chunk c ^ (r mod 8).

constexpr int GROUP = 4;                          // fp32: warps that share a pixel
constexpr int GT = GROUP * 32;                    // their threads
static_assert(GROUP * 8 * 4 == DO, "4 warps x 8 lanes x 4 columns cover the output columns");

__device__ __forceinline__ void group_sync(int group) {   // named barrier of one consumer group
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(GT) : "memory");
}

// One pixel by a group of 4 warps. Each warp owns a contiguous quarter of the tokens and
// runs the attention over them on its own, flash-attention style: scores, its own max,
// probabilities relative to it, their sums and a partial y (passes 1-3, no barrier).
// The group then meets once to combine the 4 partials, each rescaled by 2^(m_w - m)
// (m the pixel's max), once more before the output projection, and once after it: the
// projection reads y where the scores were, and without that last barrier a warp done
// with it could write the next pixel's scores while another warp of the group still
// reads y. (A region of its own for y instead of the barrier cost 16 more bytes of
// spills at 128 registers a thread and ran 5 % slower on an H100.) Scratch a group:
// part [4][64][8] partial y, red [2][4][8] warp max / sum, as [max(T, 64)][8] scores ->
// probabilities, then y. Each product is register-tiled so that a shared load feeds 4
// to 16 FMAs (with one FMA a load the shared-memory pipe, not the FMA pipe, would set
// the pace).
template <class Release>
__device__ __forceinline__ void pixel_fp32(const char* tile, int n_tok, const float* __restrict__ sM,
                                           const float* __restrict__ sW, const float* __restrict__ sc,
                                           float* __restrict__ scratch, float* __restrict__ out_pix,
                                           Release release, int group, int gw) {
  const int lane = threadIdx.x & 31, gl = gw * 32 + lane;
  float* part = scratch;                          // [GROUP][DIN][NQ]
  float* red = part + GROUP * DIN * NQ;           // [2][GROUP][NQ]
  float* as = red + 2 * GROUP * NQ;               // [max(T, 64)][NQ]
  const int quarter = (n_tok + GROUP - 1) / GROUP;
  const int tb = min(gw * quarter, n_tok), te = min(tb + quarter, n_tok);   // this warp's tokens
  // 1. scores: lane (token slot ts < 16, query half qh) computes a 2 tokens x 4 queries
  //    tile, tokens tb + ts + 32 k and tb + ts + 16 + 32 k: per 4 dims, two 16-byte token
  //    loads and four of M feed 32 FMAs. A quarter warp reads 4 consecutive tokens,
  //    whose rows' swizzles (2t mod 8) differ: no bank conflicts. The two tokens of a
  //    lane share one swizzle.
  const int qh = lane & 1, ts = lane >> 1;
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int t0 = tb + ts; t0 < te; t0 += 32) {
    const int t1 = min(t0 + 16, te - 1);          // past the quarter: a valid row, result dropped
    const int sw = (2 * t0) & 7;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int h = c >> 3, off = h * 128 + (((c & 7) ^ (sw | h)) << 4);
      const float4 x0 = *reinterpret_cast<const float4*>(tile + t0 * 256 + off);
      const float4 x1 = *reinterpret_cast<const float4*>(tile + t1 * 256 + off);
      const float xv[2][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 m = *reinterpret_cast<const float4*>(sM + (4 * c + e) * NQ + 4 * qh);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          acc[u][0] += xv[u][e] * m.x;
          acc[u][1] += xv[u][e] * m.y;
          acc[u][2] += xv[u][e] * m.z;
          acc[u][3] += xv[u][e] * m.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = t0 + 16 * u;
      if (t < te) {
        *reinterpret_cast<float4*>(as + t * NQ + 4 * qh) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[q] = fmaxf(mx[q], acc[u][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], o));
  if (lane < 2) *reinterpret_cast<float4*>(red + gw * NQ + 4 * lane) = make_float4(mx[0], mx[1], mx[2], mx[3]);
  __syncwarp();
  // 2. probabilities relative to this warp's max (scores are in log2 units: M carries
  //    log2 e) and their sums; a lane keeps one query j.
  const int j = lane & 7;
  {
    const float mw = red[gw * NQ + j];
    float sum = 0.f;
    for (int i = tb * NQ + lane; i < te * NQ; i += 32) {
      const float e = exp2f(as[i] - mw);
      as[i] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    if (lane < NQ) red[(GROUP + gw) * NQ + lane] = sum;
  }
  __syncwarp();
  // 3. partial y over this warp's tokens: lane (dims 4 dq .. 4 dq + 3, queries
  //    4 qq .. 4 qq + 3), one 16-byte load of each operand for 16 FMAs.
  {
    const int dq = lane & 15, qq = lane >> 4, half = dq >> 3;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
    // The swizzle of token t's row, (2t + half) mod 8, repeats every 4 tokens: four
    // offsets, one for each token of a step of 4.
    int off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) off[i] = half * 128 + (((dq & 7) ^ ((2 * (tb + i) + half) & 7)) << 4);
    auto step = [&](int t, int o) {
      const float4 x = *reinterpret_cast<const float4*>(tile + t * 256 + o);
      const float4 p = *reinterpret_cast<const float4*>(as + t * NQ + 4 * qq);
      const float xv[4] = {x.x, x.y, x.z, x.w}, pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += xv[a] * pv[b];
    };
    int t = tb;
    for (; t + 4 <= te; t += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) step(t + i, off[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (t + i < te) step(t + i, off[i]);
    float* pw = part + gw * DIN * NQ;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(pw + (4 * dq + a) * NQ + 4 * qq) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  group_sync(group);
  if (gl == 0) release();                          // the tile is read: the slot is free
  // 4. y = sum_w 2^(m_w - m) part_w / sum_w 2^(m_w - m) sum_w, in warp order; a thread keeps
  //    query gl mod 8. y goes where the probabilities were (all warps are past them).
  {
    const int jq = gl & 7;
    const float m = fmaxf(fmaxf(red[jq], red[NQ + jq]), fmaxf(red[2 * NQ + jq], red[3 * NQ + jq]));
    float f[GROUP], total = 0.f;
#pragma unroll
    for (int w4 = 0; w4 < GROUP; ++w4) {
      f[w4] = exp2f(red[w4 * NQ + jq] - m);        // a warp without tokens: 2^-inf = 0
      total += f[w4] * red[(GROUP + w4) * NQ + jq];
    }
    const float inv = 1.f / total;
#pragma unroll
    for (int w4 = 0; w4 < GROUP; ++w4) f[w4] *= inv;
    float* ys = as;
#pragma unroll
    for (int i = gl; i < DIN * NQ; i += GT)
      ys[i] = part[i] * f[0] + part[DIN * NQ + i] * f[1] + part[2 * DIN * NQ + i] * f[2] +
              part[3 * DIN * NQ + i] * f[3];
  }
  group_sync(group);
  float* ys = as;
  // 5. out = y Wvp + c: lane (columns 4 cq .. 4 cq + 3, all 8 queries) over a quarter of
  //    the dims (three 16-byte loads feed 32 FMAs), the quarters added by shuffles; each
  //    lane ends with and stores 2 queries.
  const int cq = gw * 8 + (lane & 7), dq4 = lane >> 3;
  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
#pragma unroll 4
  for (int d = 16 * dq4; d < 16 * dq4 + 16; ++d) {
    const float4 w = *reinterpret_cast<const float4*>(sW + d * DO + 4 * cq);
    const float4 y0 = *reinterpret_cast<const float4*>(ys + d * NQ);
    const float4 y1 = *reinterpret_cast<const float4*>(ys + d * NQ + 4);
    const float wv[4] = {w.x, w.y, w.z, w.w}, yv[NQ] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] += yv[q] * wv[c];
  }
  // Reduce-scatter over the 4 dim quarters (lane bits 3 and 4): each exchange sends only
  // the half the partner keeps, so that a lane ends with its 2 queries.
  const bool b4 = lane & 16, b3 = lane & 8;
  float r1[4][4], r2[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float send = b4 ? acc[q][c] : acc[q + 4][c];
      r1[q][c] = (b4 ? acc[q + 4][c] : acc[q][c]) + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float send = b3 ? r1[q][c] : r1[q + 2][c];
      r2[q][c] = (b3 ? r1[q + 2][c] : r1[q][c]) + __shfl_xor_sync(0xffffffffu, send, 8);
    }
#pragma unroll
  for (int q = 0; q < 2; ++q) {                    // queries 2 dq4 and 2 dq4 + 1
    const float4 cv = *reinterpret_cast<const float4*>(sc + (2 * dq4 + q) * DO + 4 * cq);
    *reinterpret_cast<float4*>(out_pix + (2 * dq4 + q) * DO + 4 * cq) =
        make_float4(r2[q][0] + cv.x, r2[q][1] + cv.y, r2[q][2] + cv.z, r2[q][3] + cv.w);
  }
  group_sync(group);                               // y is read: the next pixel may write as
}

// ------------------------------------------------------------------- kernel
// Shared memory: [ring: slots x per_slot x pix_bytes, 1024-aligned] [weights] [scratch]
// [2 x slots mbarriers] [slots unit records]. bf16: warp 0 produces, warps 1.. consume;
// fp32: every warp consumes (groups of 4) and the groups reload the slots they free.
template <bool BF16>
__global__ void __launch_bounds__(BF16 ? 32 * (1 + MAX_CONSUMERS) : 32 * MAX_GROUPS * GROUP, 1)
latent_attn_kernel(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ M,
                   const float* __restrict__ Wvp, const float* __restrict__ cvec, void* __restrict__ out,
                   long long n_pix, Plan plan) {
  extern __shared__ unsigned char smem_raw[];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slot_bytes = plan.per_slot * plan.pix_bytes;
  char* wbase = ring + static_cast<size_t>(plan.slots) * slot_bytes;
  float* sc = reinterpret_cast<float*>(wbase);                          // c, fp32 [8][128]
  uint2* wfrag = reinterpret_cast<uint2*>(wbase + C_BYTES);             // bf16: Wvp fragments
  float* sM = reinterpret_cast<float*>(wbase + C_BYTES);                // fp32: M * log2 e [64][8]
  float* sW = sM + DIN * NQ;                                            // fp32: Wvp [64][128]
  char* scratch = wbase + C_BYTES + (BF16 ? WFRAG_BYTES : M_BYTES + WVP_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      scratch + static_cast<size_t>(plan.consumers) * plan.scratch * sizeof(float));
  uint64_t* empty = full + plan.slots;
  volatile int* slot_unit = reinterpret_cast<volatile int*>(empty + plan.slots);   // unit loaded last a slot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < NQ * DO; i += blockDim.x) sc[i] = cvec[i];
  if constexpr (BF16) {
    for (int i = tid; i < 4 * 16 * 32; i += blockDim.x) {   // (ks, nt, lane) -> hi and lo fragments
      const int ks = i / (16 * 32), nt = (i / 32) % 16, ln = i % 32;
      const int e = 8 * nt + (ln >> 2), k0 = 16 * ks + 2 * (ln & 3);
      uint2 hi, lo;
      split2(Wvp[k0 * DO + e], Wvp[(k0 + 1) * DO + e], hi.x, lo.x);
      split2(Wvp[(k0 + 8) * DO + e], Wvp[(k0 + 9) * DO + e], hi.y, lo.y);
      wfrag[((ks * 16 + nt) * 2 + 0) * 32 + ln] = hi;
      wfrag[((ks * 16 + nt) * 2 + 1) * 32 + ln] = lo;
    }
  } else {
    for (int i = tid; i < DIN * NQ; i += blockDim.x) sM[i] = M[i] * LOG2E;
    for (int i = tid; i < DIN * DO; i += blockDim.x) sW[i] = Wvp[i];
  }
  if (tid == 0) {
    for (int s = 0; s < plan.slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
      slot_unit[s] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long units = (n_pix + plan.per_slot - 1) / plan.per_slot;   // pixel pairs (bf16) or pixels
  const int box_bytes = plan.box_rows * (BF16 ? 128 : 256);
  const uint32_t slot_tx = static_cast<uint32_t>(plan.per_slot * plan.boxes * box_bytes);   // zero fill counts
  auto issue = [&](int k) {                        // load unit k into slot k mod S
    const int s = k % plan.slots;
    const long long u = blockIdx.x + static_cast<long long>(k) * gridDim.x;
    slot_unit[s] = k;                                // released to the consumers by the arrive
    mbar_expect_tx(&full[s], slot_tx);
    for (int px = 0; px < plan.per_slot; ++px) {
      const int n = static_cast<int>(u * plan.per_slot + px);   // past N: out of bounds, zeros
      for (int b = 0; b < plan.boxes; ++b) {
        char* dst = ring + static_cast<size_t>(s) * slot_bytes + px * plan.pix_bytes + b * box_bytes;
        if constexpr (BF16) tma_load_3d(dst, &tmap, &full[s], 0, b * plan.box_rows, n);
        else tma_load_4d(dst, &tmap, &full[s], 0, 0, b * plan.box_rows, n);
      }
    }
  };
  const int n_units = static_cast<int>((units - blockIdx.x + gridDim.x - 1) / gridDim.x);   // this block's
  if constexpr (BF16) {
    if (warp == 0) {                                 // producer: one lane issues every copy
      if (lane != 0) return;
      for (int k = 0; k < n_units; ++k) {
        mbar_wait(&empty[k % plan.slots], ((k / plan.slots) & 1) ^ 1);
        issue(k);
      }
      return;
    }
    const int w = warp - 1;
    // M * log2 e as B fragments (k = dim, n = query), split hi + lo: 16 registers.
    uint32_t mh[4][2], ml[4][2];
    {
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k0 = 16 * ks + 2 * q;
        split2(M[k0 * NQ + g] * LOG2E, M[(k0 + 1) * NQ + g] * LOG2E, mh[ks][0], ml[ks][0]);
        split2(M[(k0 + 8) * NQ + g] * LOG2E, M[(k0 + 9) * NQ + g] * LOG2E, mh[ks][1], ml[ks][1]);
      }
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    int k = w;
    for (long long u = blockIdx.x + static_cast<long long>(w) * gridDim.x; u < units;
         u += static_cast<long long>(plan.consumers) * gridDim.x, k += plan.consumers) {
      const int s = k % plan.slots;
      wait_slot(full, slot_unit, s, k, plan.slots);
      const char* tiles = ring + static_cast<size_t>(s) * slot_bytes;
      float y0[4][4], y1[4][4];
      pixel_y_bf16(tiles, plan.n_tok, mh, ml, y0);
      pixel_y_bf16(tiles + plan.pix_bytes, plan.n_tok, mh, ml, y1);
      __syncwarp();                                   // the tiles are read: hand the slot back
      if (lane == 0) mbar_arrive(&empty[s]);
      pair_out_bf16(y0, y1, wfrag, sc, o, 2 * u, n_pix);
    }
  } else {
    // fp32: no producer warp (so that 16 consumer warps keep 128 registers a thread):
    // thread 0 fills the ring, and the group that has read a slot's tile reloads the
    // slot with the unit S further on.
    if (tid == 0)
      for (int k = 0; k < plan.slots && k < n_units; ++k) issue(k);
    const int group = warp / GROUP, gw = warp % GROUP;
    float* gs = reinterpret_cast<float*>(scratch) + static_cast<size_t>(group) * plan.scratch;
    float* o = static_cast<float*>(out);
    for (int k = group; k < n_units; k += plan.consumers) {
      const int s = k % plan.slots;
      const long long u = blockIdx.x + static_cast<long long>(k) * gridDim.x;
      wait_slot(full, slot_unit, s, k, plan.slots);
      auto refill = [&]() {
        if (k + plan.slots < n_units) issue(k + plan.slots);
      };
      pixel_fp32(ring + static_cast<size_t>(s) * slot_bytes, plan.n_tok, sM, sW, sc, gs, o + u * NQ * DO, refill,
                 group, gw);
    }
  }
}

// --------------------------------------------------------------------- host
// Slots beyond one a consumer, so that a tile load is in flight while every consumer
// works: with none, each consumer would wait a whole load after every pixel.
constexpr int SPARE_SLOTS = 1;

Plan make_plan(int n_tok, bool bf16) {
  Plan p{};
  p.n_tok = n_tok;
  // bf16 tiles go in 16-row mma tiles; an fp32 token is two 128-byte rows, and 4 tokens
  // fill the 1024-byte swizzle period.
  const int quantum = bf16 ? 16 : 4;
  const int rows = (n_tok + quantum - 1) / quantum * quantum;
  p.boxes = (rows + BOX_ROWS_MAX - 1) / BOX_ROWS_MAX;
  p.box_rows = ((rows + p.boxes - 1) / p.boxes + quantum - 1) / quantum * quantum;
  const int row_bytes = bf16 ? 128 : 256;
  p.pix_bytes = (p.boxes * p.box_rows * row_bytes + 1023) / 1024 * 1024;
  p.per_slot = bf16 ? 2 : 1;
  p.scratch = bf16 ? 0 : GROUP * DIN * NQ + 2 * GROUP * NQ + (n_tok > DIN ? n_tok : DIN) * NQ;   // as, then y
  const size_t fixed = 1024 + C_BYTES + (bf16 ? WFRAG_BYTES : M_BYTES + WVP_BYTES);
  const size_t slot = static_cast<size_t>(p.per_slot) * p.pix_bytes;
  // The most consumers that leave SPARE_SLOTS slots in flight, with as many
  // slots as fit; one consumer and one slot where a single tile barely fits (T near 512).
  for (int consumers = bf16 ? MAX_CONSUMERS : MAX_GROUPS; consumers >= 1; --consumers) {
    int s = MAX_SLOTS;
    auto total = [&](int n) { return fixed + n * slot + consumers * static_cast<size_t>(p.scratch) * 4 + 24 * n; };
    while (s >= 1 && total(s) > SMEM_LIMIT) --s;
    if (s >= consumers + SPARE_SLOTS || (consumers == 1 && s >= 1)) {
      p.slots = s;
      p.consumers = consumers;
      p.threads = bf16 ? 32 * (1 + consumers) : 32 * GROUP * consumers;   // fp32 has no producer warp
      p.smem = total(s);
      return p;
    }
  }
  return p;                                // slots = 0: the launcher refuses
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <bool BF16>
int launch(const void* tokens, const float* M, const float* Wvp, const float* cvec, void* out, long long n_pix,
           int n_tok, cudaStream_t stream) {
  const Plan plan = make_plan(n_tok, BF16);
  if (plan.slots < 1 || n_pix > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  CUresult res;
  if constexpr (BF16) {    // (64, T, N) bf16; box (64, box_rows, 1): 128-byte rows
    const cuuint64_t dims[3] = {DIN, static_cast<cuuint64_t>(n_tok), static_cast<cuuint64_t>(n_pix)};
    const cuuint64_t strides[2] = {DIN * 2, static_cast<cuuint64_t>(n_tok) * DIN * 2};
    const cuuint32_t box[3] = {DIN, static_cast<cuuint32_t>(plan.box_rows), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(tokens), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {                 // (32, 2, T, N) fp32; box (32, 2, box_rows, 1): a token is two 128-byte rows
    const cuuint64_t dims[4] = {32, 2, static_cast<cuuint64_t>(n_tok), static_cast<cuuint64_t>(n_pix)};
    const cuuint64_t strides[3] = {128, DIN * 4, static_cast<cuuint64_t>(n_tok) * DIN * 4};
    const cuuint32_t box[4] = {32, 2, static_cast<cuuint32_t>(plan.box_rows), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(tokens), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(latent_attn_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long units = (n_pix + plan.per_slot - 1) / plan.per_slot;
  const int grid = static_cast<int>(units < sms ? units : sms);
  latent_attn_kernel<BF16><<<grid, plan.threads, plan.smem, stream>>>(map, M, Wvp, cvec, out, n_pix,
                                                                                  plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tokens (N, T, 64) fp32 or bf16, 16-byte aligned; M (64, 8), Wvp (64, 128), c (8, 128)
// fp32; out (N, 8, 128) in the token type. dtype_code: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t value (0 = launched).
int latent_attn_launch(const void* tokens, const void* M, const void* Wvp, const void* cvec, void* out,
                       long long n_pix, int n_tok, int d_in, int n_q, int d_out, int dtype_code, void* stream) {
  if (d_in != DIN || n_q != NQ || d_out != DO || n_tok < 1 || n_tok > MAX_TOKENS || n_pix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(M);
  const float* w = static_cast<const float*>(Wvp);
  const float* c = static_cast<const float*>(cvec);
  if (dtype_code == 0) return launch<false>(tokens, m, w, c, out, n_pix, n_tok, s);
  if (dtype_code == 1) return launch<true>(tokens, m, w, c, out, n_pix, n_tok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
