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
// y = a^T tok (8 x 64) and out = y Wvp + c: about 0.34 MFLOP a pixel instead of the
// ~4 MFLOP of the unfolded form, so k and v never exist anywhere.
//
// What bounds it on an H100: at 640x640 one call has N = 12,800 pixels and T = 100.
// In bf16 it reads 164 MB of tokens and writes 26 MB, ~57 us at 3.35 TB/s; its
// 4.3 GFLOP take ~4 us at the bf16 tensor-core rate (989 TFLOP/s), so the bound is the
// bytes. In fp32 the bytes double (~113 us) and the same FLOPs take ~64 us at the fp32
// rate (67 TFLOP/s): bytes again. This simple kernel does its FMAs in fp32 on the CUDA
// cores, so in bf16 it cannot come below those ~64 us of FMAs: a tensor-core (mma) path
// is what would close the rest. It reads every token from device memory once (the
// second pass over a pixel's 12.8 KB bf16 tile, for y, follows right after the first so
// that L1 can serve it), keeps the folded weights in shared memory for the life of a
// persistent block, and accumulates in fp32.

// Layout: one warp per pixel at a time, WARPS warps per block, a grid of at most
// (SMs x resident blocks) that loops over the pixels. For a pixel, lane l scores the
// tokens t = l, l+32, ... (its own 64-dim rows, 16-byte loads), the warp reduces the
// softmax statistics with shuffles, then lane l accumulates y for dims 2l and 2l+1 over
// all t, and finally computes out columns l, l+32, l+64, l+96 for the 8 queries, so
// the output store is coalesced.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DIN = 64;    // token dim
constexpr int NQ = 8;      // latent queries
constexpr int DO = 128;    // latent dim
constexpr int WARPS = 8;   // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int SHARED_WEIGHTS = DIN * NQ + DIN * DO + NQ * DO;   // floats

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
latent_attn_kernel(const T* __restrict__ tokens, const float* __restrict__ M,
                   const float* __restrict__ Wvp, const float* __restrict__ cvec,
                   T* __restrict__ out, long long n_pix, int n_tok) {
  extern __shared__ __align__(16) float smem[];
  float* sM = smem;                  // [DIN][NQ]
  float* sW = sM + DIN * NQ;         // [DIN][DO]
  float* sC = sW + DIN * DO;         // [NQ][DO]
  float* sWarps = sC + NQ * DO;

  for (int i = threadIdx.x; i < DIN * NQ; i += THREADS) sM[i] = M[i];
  for (int i = threadIdx.x; i < DIN * DO; i += THREADS) sW[i] = Wvp[i];
  for (int i = threadIdx.x; i < NQ * DO; i += THREADS) sC[i] = cvec[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sA = sWarps + (size_t)warp * (n_tok * NQ + DIN * NQ);   // [T][NQ] scores -> weights
  float* sY = sA + n_tok * NQ;                                   // [DIN][NQ] y transposed

  for (long long p = (long long)blockIdx.x * WARPS + warp; p < n_pix;
       p += (long long)gridDim.x * WARPS) {
    const T* tok = tokens + p * n_tok * DIN;

    // 1. scores s[t][j] = tok[t] . M[:, j] for this lane's tokens.
    float mx[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) mx[j] = -INFINITY;
    for (int t = lane; t < n_tok; t += 32) {
      float s[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j] = 0.f;
      const T* row = tok + (size_t)t * DIN;
#pragma unroll 2
      for (int d = 0; d < DIN; d += 8) {
        float x[8];
        load8(row + d, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 m0 = *reinterpret_cast<const float4*>(sM + (d + e) * NQ);
          const float4 m1 = *reinterpret_cast<const float4*>(sM + (d + e) * NQ + 4);
          s[0] += x[e] * m0.x; s[1] += x[e] * m0.y; s[2] += x[e] * m0.z; s[3] += x[e] * m0.w;
          s[4] += x[e] * m1.x; s[5] += x[e] * m1.y; s[6] += x[e] * m1.z; s[7] += x[e] * m1.w;
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        sA[t * NQ + j] = s[j];
        mx[j] = fmaxf(mx[j], s[j]);
      }
    }

    // 2. softmax over the T tokens, per query.
    float inv[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) mx[j] = warp_max(mx[j]);
    float sum[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) sum[j] = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float e = expf(sA[t * NQ + j] - mx[j]);
        sA[t * NQ + j] = e;
        sum[j] += e;
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) inv[j] = 1.f / warp_sum(sum[j]);
    __syncwarp();

    // 3. y[j][d] = sum_t a[t][j] tok[t][d] for d = 2*lane, 2*lane + 1.
    float y0[NQ], y1[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) { y0[j] = 0.f; y1[j] = 0.f; }
    for (int t = 0; t < n_tok; ++t) {
      const float2 x = load2(tok + (size_t)t * DIN + 2 * lane);
      const float4 a0 = *reinterpret_cast<const float4*>(sA + t * NQ);
      const float4 a1 = *reinterpret_cast<const float4*>(sA + t * NQ + 4);
      const float a[NQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        y0[j] += a[j] * x.x;
        y1[j] += a[j] * x.y;
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      sY[(2 * lane) * NQ + j] = y0[j] * inv[j];
      sY[(2 * lane + 1) * NQ + j] = y1[j] * inv[j];
    }
    __syncwarp();

    // 4. out[j][e] = y[j] . Wvp[:, e] + c[j][e] for e = lane + 32k.
    float acc[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = sC[j * DO + lane + 32 * k];
#pragma unroll 4
    for (int d = 0; d < DIN; ++d) {
      const float4 ya = *reinterpret_cast<const float4*>(sY + d * NQ);
      const float4 yb = *reinterpret_cast<const float4*>(sY + d * NQ + 4);
      const float yv[NQ] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = sW[d * DO + lane + 32 * k];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] += yv[j] * w[k];
    }
    T* o = out + p * NQ * DO;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) store1(o + j * DO + lane + 32 * k, acc[j][k]);
    __syncwarp();   // sA / sY are rewritten for the next pixel
  }
}

size_t smem_bytes(int n_tok) {
  return sizeof(float) * (SHARED_WEIGHTS + (size_t)WARPS * (n_tok * NQ + DIN * NQ));
}

// Resident blocks per SM for this token count (0 if the launch cannot fit).
template <typename T>
int blocks_per_sm(int n_tok, int* per_sm) {
  const size_t smem = smem_bytes(n_tok);
  cudaError_t err = cudaFuncSetAttribute(latent_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, latent_attn_kernel<T>, THREADS, smem);
}

template <typename T>
int launch(const void* tokens, const float* M, const float* Wvp, const float* cvec, void* out,
           long long n_pix, int n_tok, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_tok);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int err = blocks_per_sm<T>(n_tok, &per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (n_pix + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(want < cap ? want : cap);
  latent_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(tokens), M, Wvp, cvec, static_cast<T*>(out), n_pix, n_tok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32 tokens/output, 1 = bfloat16 tokens/output.
// Returns a cudaError_t value (0 = launched).
int latent_attn_launch(const void* tokens, const void* M, const void* Wvp, const void* cvec,
                       void* out, long long n_pix, int n_tok, int d_in, int n_q, int d_out,
                       int dtype_code, void* stream) {
  if (d_in != DIN || n_q != NQ || d_out != DO || n_tok < 1 || n_pix < 0)
    return (int)cudaErrorInvalidValue;
  if (n_pix == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(M);
  const float* w = static_cast<const float*>(Wvp);
  const float* c = static_cast<const float*>(cvec);
  if (dtype_code == 0) return launch<float>(tokens, m, w, c, out, n_pix, n_tok, s);
  if (dtype_code == 1) return launch<__nv_bfloat16>(tokens, m, w, c, out, n_pix, n_tok, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
