// Backward of the local (windowed) correlation cost volume, for Hopper (sm_90a).
//
// The forward (correlation.cu) computes, for r = 4 (81 displacements d = (dy, dx)),
//
//     out[b, d, y, x] = (1/C) sum_c f1[b,c,y,x] f2[b,c,y+dy,x+dx]      (f2 zero outside)
//
// Given g = dL/dout (B, 81, H, W), this kernel computes both input gradients:
//
//     grad_f1[b,c,y,x] = (1/C) sum_d g[b,d,y,x]       f2[b,c,y+dy,x+dx]
//     grad_f2[b,c,y,x] = (1/C) sum_d g[b,d,y-dy,x-dx] f1[b,c,y-dy,x-dx]
//
// with every term whose position falls outside the image taken as zero. It is not the
// port of a Pallas kernel: the JAX package differentiates its XLA twin
// (macvo_tpu/ops/correlation.py:_bwd, the VJP of local_correlation_xla), which stood in
// for the reference's hand-written CUDA backward kernels. Layout NCHW, fp32.
//
// Design: gather form, no atomics, so two runs are bit-identical. Both gradients are the
// same sum over a 9x9 window of one staged map, each output pixel with its own 81 weights:
//   grad_f1 at (y, x): weights w[dy][dx] = g[d, y, x],          window f2 around (y, x);
//   grad_f2 at (y, x): weights w[a][b]   = g[d(8-a, 8-b), y-4+a, x-4+b] (zero outside),
//                      window f1 around (y, x): f1[y-4+a, x-4+b].
// A thread owns one pixel and keeps its 81 weights in registers for all channels (they do
// not depend on c). A block is a TH x TW = 8 x 32 tile and a slice of the channels; per
// chunk of CC = 8 channels it stages the (TH+8) x (TW+8) window of the map in shared memory
// (zero outside the image), and each thread does 81 FMAs a channel against it. Blocks with
// an even z compute grad_f1 and blocks with an odd z grad_f2, so one launch produces both.
// A channel's gradient needs no other channel, so where the tiles alone give fewer than
// BLOCKS_PER_SM blocks an SM (the coarse PWC levels: a 5x7 map is one tile), the channels
// are split over more blocks (correlation_bwd_channel_groups), each loading the pixel's
// weights again. The sum over the 81 displacements runs in a fixed order, then is divided
// by C, as the plain version does.
//
// What bounds it: it must read f1, f2 and g once and write both gradients, (4C + 81) floats
// a pixel, against 4 * 81 * C FLOPs a pixel: 12.4 FLOP a byte at C = 32 and never above
// 20.25, so on an H100 (fp32 ridge 67 TFLOP/s / 3.35 TB/s = 20 FLOP a byte) the bytes bound
// it. This first version is far from that bound: it stages through shared memory without a
// copy ring and does one shared load a FMA; making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4;                      // radius (the launcher rejects others)
constexpr int K = 2 * R + 1;              // 9
constexpr int KK = K * K;                 // 81
constexpr int TH = 8;                     // tile rows
constexpr int TW = 32;                    // tile columns
constexpr int NT = TH * TW;               // 256 threads, one a pixel
constexpr int SH = TH + 2 * R;            // 16 staged rows
constexpr int SW = TW + 2 * R;            // 40 staged columns
constexpr int S_ELEMS = SH * SW;          // 640 floats a channel
constexpr int CC = 8;                     // channels a chunk
constexpr int BLOCKS_PER_SM = 4;          // below this many blocks an SM, split the channels

__global__ void __launch_bounds__(NT)
correlation_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2, const float* __restrict__ g,
                       float* __restrict__ grad_f1, float* __restrict__ grad_f2, int C, int H, int W,
                       int groups) {
  __shared__ float win[CC * S_ELEMS];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = (blockIdx.z >> 1) / groups, grp = (blockIdx.z >> 1) % groups;
  const bool second = blockIdx.z & 1;    // false: grad_f1 (window of f2); true: grad_f2 (window of f1)
  const int per = ((C + CC - 1) / CC + groups - 1) / groups * CC;   // channels a group, whole chunks
  const int c_first = grp * per, c_last = min(C, c_first + per);
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < H && x < W;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gb = g + static_cast<size_t>(b) * KK * plane;
  const float* src = (second ? f1 : f2) + static_cast<size_t>(b) * C * plane;
  float* dst = (second ? grad_f2 : grad_f1) + static_cast<size_t>(b) * C * plane;

  // This pixel's 81 weights, w[a * K + c] against the window element (y - R + a, x - R + c).
  float w[KK];
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float v = 0.f;
      if (!second) {
        if (inside) v = gb[static_cast<size_t>(a * K + c) * plane + static_cast<size_t>(y) * W + x];
      } else {
        const int yy = y - R + a, xx = x - R + c;
        if (inside && yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = gb[static_cast<size_t>((K - 1 - a) * K + (K - 1 - c)) * plane + static_cast<size_t>(yy) * W + xx];
      }
      w[a * K + c] = v;
    }
  }

  const float inv_c = 1.f / static_cast<float>(C);
  for (int c0 = c_first; c0 < c_last; c0 += CC) {
    const int n = min(CC, c_last - c0);
    __syncthreads();                     // the previous chunk's window is no longer read
    for (int e = tid; e < CC * S_ELEMS; e += NT) {
      const int cc = e / S_ELEMS, s = e % S_ELEMS;
      const int gy = y0 - R + s / SW, gx = x0 - R + s % SW;
      float v = 0.f;
      if (cc < n && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = src[static_cast<size_t>(c0 + cc) * plane + static_cast<size_t>(gy) * W + gx];
      win[e] = v;
    }
    __syncthreads();
    if (!inside) continue;
    for (int cc = 0; cc < n; ++cc) {
      const float* s = win + cc * S_ELEMS + ty * SW + tx;
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int c = 0; c < K; ++c) acc = fmaf(w[a * K + c], s[a * SW + c], acc);
      dst[static_cast<size_t>(c0 + cc) * plane + static_cast<size_t>(y) * W + x] = acc * inv_c;
    }
  }
}

}  // namespace

// The number of channel groups for a (B, C, H, W) call on a card of `sms` SMs: the least that
// gives BLOCKS_PER_SM blocks an SM, at most one a chunk of CC channels.
extern "C" int correlation_bwd_channel_groups(int B, int C, int H, int W, int sms) {
  const long long blocks = static_cast<long long>((W + TW - 1) / TW) * ((H + TH - 1) / TH) * 2 * B;
  const long long want = (static_cast<long long>(BLOCKS_PER_SM) * sms + blocks - 1) / blocks;
  const long long chunks = (C + CC - 1) / CC;
  return static_cast<int>(want < 1 ? 1 : (want < chunks ? want : chunks));
}

// f1, f2: (B, C, H, W); g: (B, 81, H, W); grad_f1, grad_f2: (B, C, H, W); all fp32 contiguous on
// the current device. One launch writes both gradients. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported radius or size).
extern "C" int correlation_bwd_launch(const float* f1, const float* f2, const float* g, float* grad_f1,
                                      float* grad_f2, int B, int C, int H, int W, int radius, void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  if (radius != R || B < 1 || C < 1 || H < 1 || W < 1 || tiles_y > 65535) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int groups = correlation_bwd_channel_groups(B, C, H, W, sms);
  if (static_cast<long long>(B) * groups * 2 > 65535) return cudaErrorInvalidValue;
  correlation_bwd_kernel<<<dim3(tiles_x, tiles_y, 2 * B * groups), dim3(TW, TH), 0,
                           static_cast<cudaStream_t>(stream)>>>(f1, f2, g, grad_f1, grad_f2, C, H, W, groups);
  return static_cast<int>(cudaGetLastError());
}
