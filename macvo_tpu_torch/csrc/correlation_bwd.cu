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
// Both gradients are one sum over a 9x9 window of a staged map, each output pixel with
// its own 81 weights (window row a = dy + 4, column e = dx + 4):
//   grad_f1 at (y, x): weight w[a][e] = g[a*9+e, y, x],                  map f2
//   grad_f2 at (y, x): weight w[a][e] = g[(8-a)*9+(8-e), y-4+a, x-4+e],  map f1
// (zero outside the image), against the map's element (y-4+a, x-4+e). Blocks with an even
// blockIdx.z compute grad_f1 and blocks with an odd one grad_f2, so one launch writes both.
//
// What bounds it on an H100. It must read f1, f2 and g once and write both gradients,
// (4C + 81) floats a pixel, against 4 * 81 * C FLOPs a pixel: 12.4 FLOP a byte at C = 32
// and never above 20.25, under the fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP a byte),
// so the bytes bound it (8.9 us at 4x32x80x112, a trainer batch's largest level). Inside
// the SM two walls come first. Shared memory serves 128 bytes a clock against 128 FMAs,
// so the first version, which read one staged float a FMA, could not pass a quarter of
// the FMA rate. Instruction issue is the other: in the SASS of an earlier draft of this
// design, branchy weight loads and per-copy address arithmetic outnumbered the FMAs. The
// coarse levels (a few hundred pixels) are bound by the launch and the chain of trips to
// memory.
//
// Design.
// * Work split. A block is a 4-row tile of one gradient and one group of channels; its
//   threads are the 9 window rows a x 4 tile rows x the tile's runs of RUN = 4 x-adjacent
//   pixels. A thread keeps the 9 x 4 weights of its row a and its run in registers for the
//   whole block (g does not depend on the channel): g is read once a block, straight into
//   registers, and never again per channel. Two tiles: 32 columns (288 threads), and 8
//   columns (72 threads) for maps at most 24 wide (10x14, 5x7, 10x10 and 20x20 of the PWC),
//   where a 32-column tile would leave most threads outside the image.
// * Register reuse. Per channel a thread reads one window row of RUN + 8 = 12 floats as
//   three 16-byte shared loads and does 36 FMAs with them: each loaded float feeds up to
//   9 FMAs. A quarter warp reads one 128-byte row (32-column tile) or four 32-byte rows
//   whose 24-float pitch puts them in four bank ranges (8-column tile): no bank conflicts.
// * Sums stay on chip, in a fixed order. A thread's 9-term sum over e for its row a is a
//   partial; the 9 partials of a (channel, pixel) meet in shared memory, and one thread
//   adds them in the order a = 0..8, scales by 1/C and stores 4 pixels. No atomics and no
//   partial sums in device memory, so two runs are bit-identical. (Three rows a thread
//   would cut the partials' traffic 3x, but needs 3 x 9 x 4 weight registers: that draft
//   spilled and ran slower.)
// * Overlapped copies. Channels arrive in chunks of CC = 8 through a two-stage ring in
//   shared memory filled with cp.async; the chunk after the one being summed is in flight
//   during the sums. Where W is a multiple of 4 and the maps are 16-byte aligned (VEC), a
//   copy moves 16 bytes, else 4. The zero-fill form (source size 0) writes the halo
//   outside the image, so f1 and f2 are never padded in device memory and no branch
//   guards the math; channels past C read channel C - 1, whose sums are never stored.
//   Each thread's copy addresses are computed once, before the channel loop.
// * Instruction diet. The weight loads branch once, on the gradient (uniform over the
//   block), then run under predicates; grad_f1's are float4 loads with VEC.
// * Coarse levels. A channel's gradient needs no other channel, so where the tiles alone
//   give fewer than the tile's resident blocks an SM (2 of 288 threads, or 6 of 72),
//   whole chunks of channels are split over more blocks (correlation_bwd_channel_groups);
//   each group reads its weights again, from L2. There a block's chain is one trip to
//   memory for its weights and first chunk, the sums, and the stores.
// * Shared memory, dynamic: the ring (2 x 8 x 12 rows x the staged pitch) and the partials
//   (9 x 8 x 4 x tile columns): 67,584 bytes for the 32-column tile, 27,648 for the 8.
// It stays fp32 on the CUDA cores: each pixel's product is with its own shifted window,
// so no operand is shared across pixels for the tensor cores, and TF32 would leave the
// 1e-5 agreement with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4;                          // radius (the launcher rejects others)
constexpr int K = 2 * R + 1;                  // 9
constexpr int KK = K * K;                     // 81
constexpr int RUN = 4;                        // x-adjacent pixels a thread
constexpr int TH = 4;                         // tile rows
constexpr int CC = 8;                         // channels a stage
constexpr int WIN_ROWS = TH + 2 * R;          // 12 staged rows
constexpr int MAX_DEVICES = 64;

// The two tiles: WIDE (8 runs, 32 columns) and NARROW (2 runs, 8 columns, for maps at most 24
// wide, where a wide tile would leave most threads outside the image).
template <int RUNS_>
struct Tile {
  static constexpr int RUNS = RUNS_;          // runs a tile row
  static constexpr int TW = RUN * RUNS;       // tile columns
  static constexpr int NT = K * TH * RUNS;    // threads: window row x tile row x run (288 or 72)
  static constexpr int COLS = TW + 2 * R;     // staged columns (40 or 16)
  // Row pitch of the staged window. A quarter warp reads one 128-byte row (WIDE) or four rows
  // of 32 bytes (NARROW); a pitch of 24 floats puts those four rows in four bank ranges.
  static constexpr int WIN_COLS = RUNS == 8 ? COLS : 24;
  static constexpr int WIN = WIN_ROWS * WIN_COLS;   // floats a staged channel
  static constexpr int STAGE = CC * WIN;            // floats a stage
  static constexpr int PART = K * CC * TH * TW;     // partial sums a chunk
  static constexpr int QUADS = CC * TH * RUNS;      // runs of 4 outputs a chunk
  static constexpr int SMEM_BYTES = (2 * STAGE + PART) * static_cast<int>(sizeof(float));
  static constexpr int BLOCKS_PER_SM = RUNS == 8 ? 2 : 6;   // resident blocks an SM (launch bound)
  static_assert(WIN_COLS % 4 == 0 && COLS % 4 == 0 && WIN % 4 == 0, "16-byte aligned shared rows");
  static_assert(QUADS <= NT, "one reduced run a thread");
};
using Wide = Tile<8>;
using Narrow = Tile<2>;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// VEC: W is a multiple of 4 and f1, f2 and g start on 16-byte boundaries, so staged rows are
// copied 16 bytes at a time and grad_f1's weights are read as float4.
template <class T, bool VEC>
__global__ void __launch_bounds__(T::NT, T::BLOCKS_PER_SM)
correlation_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2, const float* __restrict__ g,
                       float* __restrict__ grad_f1, float* __restrict__ grad_f2, int C, int H, int W,
                       int groups) {
  constexpr int RUNS = T::RUNS, TW = T::TW, NT = T::NT, WIN_COLS = T::WIN_COLS, WIN = T::WIN;
  extern __shared__ __align__(16) float smem[];
  float* part = smem + 2 * T::STAGE;

  const int run = threadIdx.x, ty = threadIdx.y, a = threadIdx.z;
  const int tid = (a * TH + ty) * RUNS + run;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = (blockIdx.z >> 1) / groups, grp = (blockIdx.z >> 1) % groups;
  const bool second = blockIdx.z & 1;          // false: grad_f1 (map f2); true: grad_f2 (map f1)
  const int chunks = (C + CC - 1) / CC;
  const int per = (chunks + groups - 1) / groups;   // chunks a group
  const int chunk0 = grp * per;
  const int n_chunks = min(chunks, chunk0 + per) - chunk0;
  if (n_chunks <= 0) return;                   // (the launcher leaves no group empty)
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gb = g + static_cast<size_t>(b) * KK * plane;
  const float* map = (second ? f1 : f2) + static_cast<size_t>(b) * C * plane;
  float* dst = (second ? grad_f2 : grad_f1) + static_cast<size_t>(b) * C * plane;

  // Copies. A unit is 4 floats with VEC (all inside or all outside the image), else 1. With
  // VEC a thread's copies are fixed (channel, unit) pairs of a chunk; without, the same units
  // of every channel. Either way their shared slots and image positions are computed once.
  // Channels past C (in the last chunk) read channel C - 1 instead: their sums are never
  // stored, so the channel needs no predicate.
  constexpr int UNIT = VEC ? 4 : 1;
  constexpr int UNITS_ROW = T::COLS / UNIT;
  constexpr int UNITS = WIN_ROWS * UNITS_ROW;  // units a staged channel
  constexpr int N_COPIES = VEC ? (CC * UNITS + NT - 1) / NT : (UNITS + NT - 1) / NT;
  const float* src[N_COPIES];
  int slot[N_COPIES], chan[N_COPIES], bytes[N_COPIES];
#pragma unroll
  for (int k = 0; k < N_COPIES; ++k) {
    const int i = tid + k * NT;
    const int u = VEC ? i % UNITS : i;
    const int row = u / UNITS_ROW, col = (u % UNITS_ROW) * UNIT;
    const int gy = y0 - R + row, gx = x0 - R + col;
    const bool live = VEC ? i < CC * UNITS : i < UNITS;
    const bool in = live && gy >= 0 && gy < H && gx >= 0 && gx < W;
    chan[k] = VEC ? i / UNITS : 0;
    slot[k] = live ? chan[k] * WIN + row * WIN_COLS + col : -1;
    bytes[k] = in ? 4 * UNIT : 0;              // 0: the zero-fill form
    src[k] = in ? map + static_cast<size_t>(gy) * W + gx : map;
  }
  auto issue = [&](int chunk) {
    float* stage = smem + (chunk & 1) * T::STAGE;
    const int c0 = (chunk0 + chunk) * CC;
    if (VEC) {
#pragma unroll
      for (int k = 0; k < N_COPIES; ++k)
        if (slot[k] >= 0)
          cp_async16(stage + slot[k], src[k] + static_cast<size_t>(min(c0 + chan[k], C - 1)) * plane, bytes[k]);
    } else {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const size_t off = static_cast<size_t>(min(c0 + cc, C - 1)) * plane;
#pragma unroll
        for (int k = 0; k < N_COPIES; ++k)
          if (slot[k] >= 0) cp_async4(stage + cc * WIN + slot[k], src[k] + off, bytes[k]);
      }
    }
  };

  issue(0);
  cp_async_commit();

  // This thread's weights, w[e][p] against map element (y - R + a, x + p - R + e), read
  // while the first chunk is in flight: one branch on the gradient (uniform over the
  // block), then loads under predicates.
  const int y = y0 + ty, xr = x0 + RUN * run;
  float w[K][RUN];
  if (!second) {                               // g[a*K + e, y, xr + p]
    const float* gp = gb + static_cast<size_t>(a * K) * plane + static_cast<size_t>(min(y, H - 1)) * W + xr;
    if (VEC) {                                 // xr < W: the whole run lies inside
      const bool ok = y < H && xr < W;
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const float4 q = ok ? __ldg(reinterpret_cast<const float4*>(gp + e * plane)) : make_float4(0.f, 0.f, 0.f, 0.f);
        w[e][0] = q.x; w[e][1] = q.y; w[e][2] = q.z; w[e][3] = q.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < RUN; ++p) {
        const bool ok = y < H && xr + p < W;
#pragma unroll
        for (int e = 0; e < K; ++e) w[e][p] = ok ? __ldg(gp + e * plane + p) : 0.f;
      }
    }
  } else {                                     // g[(K-1-a)*K + (K-1-e), y - R + a, xr + p - R + e]
    const int yy = y - R + a;
    const bool row_ok = yy >= 0 && yy < H;
    // element (e, p): plane (K-1-a)*K + K-1 - e, column xr - R + p + e
    const long long base = (static_cast<long long>((K - 1 - a) * K + K - 1) * H + (row_ok ? yy : 0)) * W + xr - R;
#pragma unroll
    for (int e = 0; e < K; ++e)
#pragma unroll
      for (int p = 0; p < RUN; ++p) {
        const int xx = xr - R + p + e;
        w[e][p] = row_ok && xx >= 0 && xx < W ? __ldg(gb + (base - static_cast<long long>(e) * plane + p + e)) : 0.f;
      }
  }

  const float inv_c = 1.f / static_cast<float>(C);
  // The run this thread reduces and stores: channel qc of the chunk, tile row qy, run qr.
  const int qc = tid / (TH * RUNS), qy = (tid / RUNS) % TH, qr = tid % RUNS;
  const int oy = y0 + qy, ox = x0 + RUN * qr;
  const bool vec_store = W % 4 == 0 && ox + RUN <= W;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) issue(chunk + 1);
    cp_async_commit();                         // an empty group on the last chunk keeps the count
    cp_async_wait_one();
    __syncthreads();                           // the chunk is staged; last chunk's partials are read
    const float* row = smem + (chunk & 1) * T::STAGE + (ty + a) * WIN_COLS + RUN * run;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float4 v0 = *reinterpret_cast<const float4*>(row + cc * WIN);
      const float4 v1 = *reinterpret_cast<const float4*>(row + cc * WIN + 4);
      const float4 v2 = *reinterpret_cast<const float4*>(row + cc * WIN + 8);
      const float v[RUN + 2 * R] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
      float s[RUN];
#pragma unroll
      for (int p = 0; p < RUN; ++p) {
        s[p] = 0.f;
#pragma unroll
        for (int e = 0; e < K; ++e) s[p] = fmaf(w[e][p], v[p + e], s[p]);
      }
      *reinterpret_cast<float4*>(part + ((a * CC + cc) * TH + ty) * TW + RUN * run) = make_float4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();                           // every partial of the chunk is written
    const int c = (chunk0 + chunk) * CC + qc;
    if (tid < T::QUADS && c < C && oy < H) {
      const float* q = part + (qc * TH + qy) * TW + RUN * qr;
      float4 t = *reinterpret_cast<const float4*>(q);
#pragma unroll
      for (int r = 1; r < K; ++r) {            // the window rows in order
        const float4 u = *reinterpret_cast<const float4*>(q + r * CC * TH * TW);
        t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
      }
      float* o = dst + static_cast<size_t>(c) * plane + static_cast<size_t>(oy) * W + ox;
      const float out[RUN] = {t.x * inv_c, t.y * inv_c, t.z * inv_c, t.w * inv_c};
      if (vec_store) {
        *reinterpret_cast<float4*>(o) = make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int p = 0; p < RUN; ++p)
          if (ox + p < W) o[p] = out[p];
      }
    }
  }
}

// The tile for a map W wide: NARROW at most 24 wide (it wastes fewer columns there).
bool narrow(int W) { return W <= 24; }

template <class T>
long long channel_groups(int B, int C, int H, int W, int sms) {
  const long long blocks = static_cast<long long>((W + T::TW - 1) / T::TW) * ((H + TH - 1) / TH) * 2 * B;
  const long long want = (static_cast<long long>(T::BLOCKS_PER_SM) * sms + blocks - 1) / blocks;
  const long long chunks = (C + CC - 1) / CC;
  const long long groups = want < 1 ? 1 : (want < chunks ? want : chunks);
  const long long per = (chunks + groups - 1) / groups;
  return (chunks + per - 1) / per;
}

template <class T, bool VEC>
cudaError_t launch(const float* f1, const float* f2, const float* g, float* grad_f1, float* grad_f2, int B, int C,
                   int H, int W, int sms, cudaStream_t stream) {
  const long long groups = channel_groups<T>(B, C, H, W, sms);
  const long long tiles_y = (H + TH - 1) / TH;
  if (tiles_y > 65535 || B * groups * 2 > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + T::TW - 1) / T::TW, static_cast<unsigned>(tiles_y), static_cast<unsigned>(2 * B * groups));
  correlation_bwd_kernel<T, VEC><<<grid, dim3(T::RUNS, TH, K), T::SMEM_BYTES, stream>>>(
      f1, f2, g, grad_f1, grad_f2, C, H, W, static_cast<int>(groups));
  return cudaGetLastError();
}

int sm_count[MAX_DEVICES];                      // per device, filled on its first launch

}  // namespace

// The number of channel groups for a (B, C, H, W) call on a card of `sms` SMs: the least that
// gives the tile's resident blocks an SM, at most one a chunk of CC channels, every group the
// same number of whole chunks but the last (so no group is empty).
extern "C" int correlation_bwd_channel_groups(int B, int C, int H, int W, int sms) {
  return static_cast<int>(narrow(W) ? channel_groups<Narrow>(B, C, H, W, sms)
                                    : channel_groups<Wide>(B, C, H, W, sms));
}

// The tile columns a block covers for a map W wide (32, or 8 for maps at most 24 wide).
extern "C" int correlation_bwd_tile_width(int W) { return narrow(W) ? Narrow::TW : Wide::TW; }

// A block's shared memory, in bytes, for a map W wide (dynamic: ptxas does not report it).
extern "C" int correlation_bwd_shared_bytes(int W) { return narrow(W) ? Narrow::SMEM_BYTES : Wide::SMEM_BYTES; }

// f1, f2: (B, C, H, W); g: (B, 81, H, W); grad_f1, grad_f2: (B, C, H, W); all fp32 contiguous on
// CUDA device `device`, `stream` one of its streams. One launch writes both gradients. The
// launcher makes `device` current for the launch and restores the caller's device; it reads the
// device's SM count and raises the wide kernels' shared-memory limit once a device. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unsupported radius or size).
extern "C" int correlation_bwd_launch(const float* f1, const float* f2, const float* g, float* grad_f1,
                                      float* grad_f2, int B, int C, int H, int W, int radius, int device,
                                      void* stream) {
  if (radius != R || B < 1 || C < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sm_count[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(correlation_bwd_kernel<Wide, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Wide::SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(correlation_bwd_kernel<Wide, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Wide::SMEM_BYTES);
    if (err == cudaSuccess) sm_count[device] = sms;
  }
  if (err == cudaSuccess) {
    const bool vec = W % 4 == 0 && ((reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2) |
                                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
    const int sms = sm_count[device];
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (narrow(W))
      err = vec ? launch<Narrow, true>(f1, f2, g, grad_f1, grad_f2, B, C, H, W, sms, s)
                : launch<Narrow, false>(f1, f2, g, grad_f1, grad_f2, B, C, H, W, sms, s);
    else
      err = vec ? launch<Wide, true>(f1, f2, g, grad_f1, grad_f2, B, C, H, W, sms, s)
                : launch<Wide, false>(f1, f2, g, grad_f1, grad_f2, B, C, H, W, sms, s);
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
