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
// What bounds it on an H100: at 640x640 the PWC calls it at 160x160x32, 80x80x64,
// 40x40x96, 20x20x128 and 10x10x196. At 160x160x32 it must read f1 and f2 once (6.6 MB)
// and write 81 channels (8.3 MB): 4.4 us at 3.35 TB/s, against 133 MFLOP, 2.0 us at the
// fp32 rate (67 TFLOP/s), so the bytes bound it. The coarse levels are a few hundred
// pixels each: their bound is well under a microsecond, so there the floor is the
// launch and one round trip to device memory, and the enemy is a long serial chain.
//
// Design (the first version of this kernel, one 256-thread block per 32x8 tile walking all channels in a
// serial chain, ran 2 to 3 blocks at the coarse levels and took 0.54 ms for the five
// calls).
// * Work split. A block computes an output tile of TH x TW = 4 x 32 pixels for ND = 3 of
//   the 9 displacement rows dy, so each tile is three blocks. Where that leaves fewer
//   than 4 blocks an SM, the channels are split too: KS blocks of a thread-block cluster
//   (KS = 2, 4 or 8, chosen by correlation_cluster_size) each sum a slice of the
//   channels, and the slices meet through distributed shared memory: every block parks
//   its partial sums in its own shared memory, the cluster synchronises, and each block
//   adds up a 1/KS share of the outputs by reading the KS partials in rank order. The
//   result is deterministic, needs no atomics and no scratch in device memory, and is
//   one launch. KS doubles while the grid has fewer than 4 blocks an SM and each block
//   keeps at least CC = 8 channels; for the 640x640 PWC (B = 1, 132 SMs):
//       160x160x32: 600 blocks, KS 1          80x80x64: 720 blocks, KS 4 (16 channels)
//       40x40x96:   480 blocks, KS 8 (12)     20x20x128: 120 blocks, KS 8 (16)
//       10x10x196:   72 blocks, KS 8 (25, the last 21)
//   (The tile height and this rule came from timing tile heights 4 and 8 with every KS
//   at the five shapes on an H100.)
// * Register reuse. A thread owns one displacement row dy and a run of RUN = 4
//   x-adjacent pixels: 9 x 4 sums. Per channel it loads its 4 f1 values and one window
//   row of RUN + 8 = 12 f2 values as four 16-byte shared loads and does 36 FMAs with
//   them (the first version did one shared load per FMA). A quarter warp reads one
//   128-byte row, so the loads have no bank conflicts.
// * Overlapped copies. Channels arrive in chunks of CC = 8 through a two-stage ring in
//   shared memory filled with cp.async (4-byte copies, coalesced along x); the zero-fill
//   form (source size 0) writes the halo outside the image and the channels past the
//   block's slice, so f2 is never padded in device memory and no branch guards the math.
//   Each thread's copy addresses are the same for every channel but for the plane
//   offset, so they are computed once, before the channel loop.
// * Epilogue. With KS = 1 each thread stores its sums straight from registers (16-byte
//   stores where W allows); with a cluster they go through shared memory as above.
//   Either way the sum is divided by C at the end, as the JAX twin does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 4;                     // radius (the launcher rejects others)
constexpr int K = 2 * R + 1;             // 9 displacements a row
constexpr int RUN = 4;                   // x-adjacent pixels a thread
constexpr int RUNS = 8;                  // runs a tile row
constexpr int TW = RUN * RUNS;           // 32 tile columns
constexpr int TH = 4;                    // tile rows
constexpr int ND = 3;                    // displacement rows a block
constexpr int DY_GROUPS = K / ND;        // 3 blocks a tile
constexpr int NT = RUNS * TH * ND;       // 96 threads
constexpr int CC = 8;                    // channels a stage
constexpr int F2_ROWS = TH + ND - 1;     // f2 rows a block reads (its dy rows only)
constexpr int F2_COLS = TW + 2 * R;      // 40
constexpr int F2_ELEMS = F2_ROWS * F2_COLS;     // 240
constexpr int F1_ELEMS = TH * TW;               // 128
constexpr int CH_ELEMS = F2_ELEMS + F1_ELEMS;   // 368 floats staged a channel
constexpr int STAGE = CC * CH_ELEMS;            // 2944 floats a stage
constexpr int COPIES = (CH_ELEMS + NT - 1) / NT;  // 4 copies a thread a channel
constexpr int OUT_ELEMS = ND * K * TH * TW;     // 3456 partial sums a block
constexpr int MAX_CLUSTER = 8;
constexpr int BLOCKS_PER_SM = 4;                // below this many blocks an SM, split the channels
static_assert(OUT_ELEMS <= 2 * STAGE, "the partial sums reuse the ring");
static_assert(CH_ELEMS % 4 == 0 && F2_COLS % 4 == 0, "16-byte aligned shared rows");

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__global__ void __launch_bounds__(NT)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out,
                   int C, int H, int W) {
  __shared__ __align__(16) float smem[2 * STAGE];
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int run = threadIdx.x, ty = threadIdx.y, dyl = threadIdx.z;
  const int tid = (dyl * TH + ty) * RUNS + run;
  const int x0 = (blockIdx.x / ks) * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / DY_GROUPS, g = blockIdx.z % DY_GROUPS;
  const int dy0 = g * ND;                  // first displacement row of the block, 0-based
  const size_t plane = static_cast<size_t>(H) * W;
  const float* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const float* f2b = f2 + static_cast<size_t>(b) * C * plane;

  // This block's channel slice.
  const int per = (C + ks - 1) / ks;
  const int c_begin = min(C, rank * per), c_end = min(C, c_begin + per);
  const int n_chunks = (c_end - c_begin + CC - 1) / CC;

  // Copy addresses, channel-independent: element e of a staged channel is f2 row
  // e / F2_COLS (image row y0 - R + dy0 + e / F2_COLS) for e < F2_ELEMS, else f1.
  const float* src[COPIES];
  bool inside[COPIES];
#pragma unroll
  for (int k = 0; k < COPIES; ++k) {
    const int e = tid + k * NT;
    int gy, gx;
    const float* base;
    if (e < F2_ELEMS) {
      gy = y0 - R + dy0 + e / F2_COLS;
      gx = x0 - R + e % F2_COLS;
      base = f2b;
    } else {
      gy = y0 + (e - F2_ELEMS) / TW;
      gx = x0 + (e - F2_ELEMS) % TW;
      base = f1b;
    }
    inside[k] = e < CH_ELEMS && gy >= 0 && gy < H && gx >= 0 && gx < W;
    src[k] = inside[k] ? base + static_cast<size_t>(gy) * W + gx : f1b;
  }
  auto issue = [&](int chunk) {
    float* stage = smem + (chunk & 1) * STAGE;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const int c = c_begin + chunk * CC + cc;
      const bool c_ok = c < c_end;
      const size_t off = c_ok ? static_cast<size_t>(c) * plane : 0;
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        const int e = tid + k * NT;
        if (e < CH_ELEMS) cp_async4(stage + cc * CH_ELEMS + e, src[k] + (inside[k] ? off : 0),
                                    inside[k] && c_ok);
      }
    }
  };

  float acc[K][RUN];
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
#pragma unroll
    for (int p = 0; p < RUN; ++p) acc[dx][p] = 0.f;

  if (n_chunks > 0) issue(0);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) issue(chunk + 1);
    cp_async_commit();                     // an empty group on the last chunk keeps the count
    cp_async_wait_one();
    __syncthreads();
    const float* stage = smem + (chunk & 1) * STAGE;
    const float* s2 = stage + (ty + dyl) * F2_COLS + RUN * run;
    const float* s1 = stage + F2_ELEMS + ty * TW + RUN * run;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float4 a4 = *reinterpret_cast<const float4*>(s1 + cc * CH_ELEMS);
      const float4 w0 = *reinterpret_cast<const float4*>(s2 + cc * CH_ELEMS);
      const float4 w1 = *reinterpret_cast<const float4*>(s2 + cc * CH_ELEMS + 4);
      const float4 w2 = *reinterpret_cast<const float4*>(s2 + cc * CH_ELEMS + 8);
      const float a[RUN] = {a4.x, a4.y, a4.z, a4.w};
      const float w[RUN + 2 * R] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int p = 0; p < RUN; ++p) acc[dx][p] = fmaf(a[p], w[p + dx], acc[dx][p]);
    }
    __syncthreads();                       // the stage is refilled by the next issue
  }

  const float inv_c = 1.f / static_cast<float>(C);
  float* ob = out + (static_cast<size_t>(b) * K * K + static_cast<size_t>(dy0) * K) * plane;
  if (ks == 1) {                           // no partials to meet: store from registers
    const int y = y0 + ty, x = x0 + RUN * run;
    if (y >= H) return;
    float* o = ob + static_cast<size_t>(dyl) * K * plane + static_cast<size_t>(y) * W + x;
    const bool vec = (W % 4 == 0) && x + RUN <= W;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      if (vec) {
        *reinterpret_cast<float4*>(o + dx * plane) =
            make_float4(acc[dx][0] * inv_c, acc[dx][1] * inv_c, acc[dx][2] * inv_c, acc[dx][3] * inv_c);
      } else {
#pragma unroll
        for (int p = 0; p < RUN; ++p)
          if (x + p < W) o[dx * plane + p] = acc[dx][p] * inv_c;
      }
    }
    return;
  }

  // Partial sums into shared memory, [dyl*K + dx][ty][x]; the ring is free now.
  float* part = smem;
#pragma unroll
  for (int dx = 0; dx < K; ++dx)
    *reinterpret_cast<float4*>(part + ((dyl * K + dx) * TH + ty) * TW + RUN * run) =
        make_float4(acc[dx][0], acc[dx][1], acc[dx][2], acc[dx][3]);
  cluster.sync();                          // every partial of the cluster is written

  // Each block of the cluster reduces a 1/ks share, reading the ranks in order.
  for (int i = rank * NT + tid; i < OUT_ELEMS; i += ks * NT) {
    float s = 0.f;
    for (int r = 0; r < ks; ++r) s += cluster.map_shared_rank(part, r)[i];
    const int d = i / (TH * TW), y = y0 + (i / TW) % TH, x = x0 + i % TW;
    if (y < H && x < W) ob[d * plane + static_cast<size_t>(y) * W + x] = s * inv_c;
  }
  cluster.sync();                          // no block leaves while its partials are read
}

}  // namespace

// The channel split KS for a (B, C, H, W) call on a card of `sms` SMs: doubled while the
// grid has fewer than BLOCKS_PER_SM blocks an SM and every block keeps at least a chunk
// of channels.
extern "C" int correlation_cluster_size(int B, int C, int H, int W, int sms) {
  const long long blocks = static_cast<long long>((W + TW - 1) / TW) * ((H + TH - 1) / TH) * DY_GROUPS * B;
  int ks = 1;
  while (ks < MAX_CLUSTER && blocks * ks < static_cast<long long>(BLOCKS_PER_SM) * sms && C >= 2 * ks * CC) ks *= 2;
  return ks;
}

// f1, f2: (B, C, H, W) fp32 contiguous; out: (B, (2r+1)^2, H, W) fp32 contiguous, on the
// current device. Returns the launch's cudaError_t (cudaErrorInvalidValue for an
// unsupported radius or size).
extern "C" int correlation_launch(const float* f1, const float* f2, float* out, int B, int C, int H, int W,
                                  int radius, void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  if (radius != R || B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 / DY_GROUPS || tiles_y > 65535 ||
      tiles_x > 0x7fffffff / MAX_CLUSTER)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int cluster = correlation_cluster_size(B, C, H, W, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_x * cluster, tiles_y, B * DY_GROUPS);
  cfg.blockDim = dim3(RUNS, TH, ND);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, correlation_kernel, f1, f2, out, C, H, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
