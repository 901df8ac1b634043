// Local (windowed) correlation cost volume of the PWC flow net, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel macvo_tpu/ops/correlation.py:_corr_kernel (launched by
// local_correlation_pallas). For every pixel it correlates f1 with the (2r+1)^2 pixels of
// f2 around it, zero outside f2, averaged over the channels:
//
//     out[b, (dy+r)(2r+1) + (dx+r), y, x] = (1/C) sum_c f1[b,c,y,x] f2[b,c,y+dy,x+dx]
//
// Layout: NCHW for the inputs and the output (the layout of the port's PWC, whose
// convolutions run NCHW), fp32 throughout, r = 4 (81 displacement channels).
//
// What bounds it on an H100: at 640x640 the PWC calls it at 160x160x32 .. 10x10x196.
// At 160x160x32 it must read f1 and f2 once (6.6 MB) and write 81 channels (8.3 MB):
// 4.4 us at 3.35 TB/s, against 133 MFLOP, 2.0 us at the fp32 rate (67 TFLOP/s). So the
// bytes bound it, by little; at C = 196 the FLOPs do. Either way a call is a few
// microseconds, below the launch latency.
//
// Design (simple and right first): one block of TW x TH threads per (output tile, batch),
// one thread per output pixel. The block walks the channels in chunks of CC: it stages
// the chunk's f2 tile with its r-pixel halo in shared memory, zero-filled outside the
// image, and each thread reads its own pixel's f1 values straight into registers
// (coalesced along x). Each thread keeps its (2r+1)^2 sums in fp32 registers and divides
// by C at the end, as the JAX twin does. Neighbouring threads read neighbouring shared
// words, so the window reads have no bank conflicts. The TPU kernel's three row tiles of
// a padded f2 copy (a sequential grid with a VMEM halo) have no counterpart here: the
// halo is loaded per block, and f2 is never padded in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RADIUS = 4;
constexpr int TW = 32;   // tile width  (one warp per tile row)
constexpr int TH = 8;    // tile height
constexpr int CC = 8;    // channels staged per chunk

template <int R>
__global__ void __launch_bounds__(TW * TH)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int C, int H, int W) {
  constexpr int K = 2 * R + 1;
  constexpr int PH = TH + 2 * R;
  constexpr int PW = TW + 2 * R;
  __shared__ float s2[CC][PH][PW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const float* f2b = f2 + static_cast<size_t>(b) * C * plane;

  float acc[K * K];
#pragma unroll
  for (int d = 0; d < K * K; ++d) acc[d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    // Stage f2[c0:c0+CC, y0-R : y0+TH+R, x0-R : x0+TW+R], zero outside the image.
    for (int i = tid; i < CC * PH * PW; i += TW * TH) {
      const int cc = i / (PH * PW);
      const int rem = i - cc * PH * PW;
      const int yy = rem / PW, xx = rem - yy * PW;
      const int c = c0 + cc, gy = y0 - R + yy, gx = x0 - R + xx;
      float v = 0.f;
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) v = f2b[c * plane + static_cast<size_t>(gy) * W + gx];
      s2[cc][yy][xx] = v;
    }
    float a[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int c = c0 + cc;
      a[cc] = (inside && c < C) ? f1b[c * plane + static_cast<size_t>(y) * W + x] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc[dy * K + dx] = fmaf(a[cc], s2[cc][ty + dy][tx + dx], acc[dy * K + dx]);
      }
    }
    __syncthreads();
  }

  if (!inside) return;
  const float channels = static_cast<float>(C);
  float* ob = out + static_cast<size_t>(b) * K * K * plane + static_cast<size_t>(y) * W + x;
#pragma unroll
  for (int d = 0; d < K * K; ++d) ob[d * plane] = acc[d] / channels;
}

}  // namespace

// f1, f2: (B, C, H, W) fp32 contiguous; out: (B, (2r+1)^2, H, W) fp32 contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an unsupported
// radius or size).
extern "C" int correlation_launch(const float* f1, const float* f2, float* out, int B, int C, int H, int W,
                                  int radius, void* stream) {
  if (radius != RADIUS || B < 1 || C < 1 || H < 1 || W < 1 || B > 65535) return cudaErrorInvalidValue;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  correlation_kernel<RADIUS><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(f1, f2, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
