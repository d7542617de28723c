// Grouped 3x3 convolution, stride 1, SAME padding, NHWC, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `grouped_conv_pallas` (`_kernel`,
// benchmarks/grouped_conv_pallas.py:42). x [N, H, W, C] bf16 and grouped
// weights wg [3, 3, cg, C] bf16 (HWIO: output channel c reads the cg input
// channels of its group, (c / cg) * cg + i) -> y [N, H, W, C] bf16, with
//   y[n, oy, ox, c] = sum over ky, kx, i of
//       x[n, oy + ky - 1, ox + kx - 1, (c / cg) * cg + i] * wg[ky, kx, i, c]
// summed in f32 (cells outside the image are zeros).
//
// What bounds it on the H100: bytes. x is read once and y written once
// (205.5 MB at [128, 56, 56, 128]: 0.061 ms at 3.35 TB/s); the real work
// is 2 * 9 * cg FLOP an output (3.7 GFLOP at either SE-ResNeXt shape).
//
// What the design does about it. The TPU kernel expands the weights to
// block-diagonal 128 x 128 matrices and runs nine dense products per
// tile to fill its matrix unit: 9 * 128 multiplies an output where 9 * cg
// are needed. That is a property of that machine, not of the function.
// Here the kernel takes the grouped weights as they are and does the
// real work on the CUDA cores:
//   - a block owns a tile of 4 x 14 output pixels for a chunk of 64
//     channels and loads the tile with its one-pixel halo (6 x 16 pixels
//     x 64 channels, 12 KB of bf16) into shared memory with 16-byte
//     loads; cells outside the image are written as zeros, so the inner
//     loop has no bounds test;
//   - a thread owns one output channel and one output row of the tile:
//     its 9 * cg weights sit in registers for the whole row, and its 14
//     accumulators too; for each of the 3 x 16 input cells of its rows it
//     reads the cg inputs of its group as one vector (8 or 16 bytes) and
//     uses them for up to three outputs, so shared memory is read 3.4
//     times an output instead of 9;
//   - neighbouring threads take neighbouring channels, so the NHWC loads
//     and stores of a warp are contiguous, and the cg threads of a group
//     read the same shared-memory vector (a broadcast).
// Halo cells are re-read by neighbouring blocks (1.7x the tile), mostly
// from the L2 cache. Ragged edges (H, W not multiples of the tile, a
// last chunk of fewer than 64 channels) are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 4;    // output rows per block
constexpr int kTW = 14;   // output columns per block
constexpr int kCC = 64;   // channels per block
constexpr int kThreads = kTH * kCC;
constexpr int kIH = kTH + 2, kIW = kTW + 2;  // input tile with its halo

template <int kCG> struct GroupVec;
template <> struct GroupVec<4> { typedef uint2 type; };
template <> struct GroupVec<8> { typedef uint4 type; };

// The cg bf16 inputs of one group at one cell, widened to f32.
template <int kCG>
__device__ __forceinline__ void load_group(const bf16* p, float* v) {
  typename GroupVec<kCG>::type raw =
      *reinterpret_cast<const typename GroupVec<kCG>::type*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kCG / 2; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int kCG>
__global__ void __launch_bounds__(kThreads) grouped_conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wg,
    bf16* __restrict__ y, int H, int W, int C, int tiles_w) {
  __shared__ __align__(16) bf16 tile[kIH * kIW * kCC];

  const int tx = blockIdx.x % tiles_w, ty = blockIdx.x / tiles_w;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int c0 = blockIdx.y * kCC;
  const int n = blockIdx.z;
  const bf16* xb = x + (size_t)n * H * W * C;

  constexpr int kVec = kCC / 8;  // 16-byte vectors per cell
  for (int i = threadIdx.x; i < kIH * kIW * kVec; i += kThreads) {
    const int v = i % kVec, p = i / kVec;
    const int px = p % kIW, py = p / kIW;
    const int gy = y0 + py - 1, gx = x0 + px - 1, c = c0 + v * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
      val = *reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * C + c);
    *reinterpret_cast<uint4*>(tile + p * kCC + v * 8) = val;
  }

  const int cl = threadIdx.x % kCC, ry = threadIdx.x / kCC;
  const int c = c0 + cl;
  float wreg[9][kCG];
  if (c < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int i = 0; i < kCG; ++i)
        wreg[t][i] = __bfloat162float(wg[(size_t)(t * kCG + i) * C + c]);
  }
  __syncthreads();
  if (c >= C || y0 + ry >= H) return;

  float acc[kTW];
#pragma unroll
  for (int ox = 0; ox < kTW; ++ox) acc[ox] = 0.f;
  const int g0 = (cl / kCG) * kCG;  // the group's first channel in the chunk
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int ix = 0; ix < kIW; ++ix) {
      float v[kCG];
      load_group<kCG>(tile + ((ry + ky) * kIW + ix) * kCC + g0, v);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ox = ix - kx;  // the output column this cell feeds at tap kx
        if (ox >= 0 && ox < kTW) {
#pragma unroll
          for (int i = 0; i < kCG; ++i)
            acc[ox] = fmaf(v[i], wreg[ky * 3 + kx][i], acc[ox]);
        }
      }
    }
  }

  bf16* yb = y + (((size_t)n * H + y0 + ry) * W + x0) * C + c;
#pragma unroll
  for (int ox = 0; ox < kTW; ++ox)
    if (x0 + ox < W) yb[(size_t)ox * C] = __float2bfloat16(acc[ox]);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). x and y are contiguous
// [n, h, w, c] bf16, wg contiguous [3, 3, cg, c] bf16; cg is 4 or 8 and c
// a multiple of 8 and of cg. `stream` is a cudaStream_t.
int pt_grouped_conv(const void* x, const void* wg, void* y, int n, int h,
                    int w, int c, int cg, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || c < 8 || c % 8 ||
      (cg != 4 && cg != 8) || c % cg)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (w + kTW - 1) / kTW, tiles_h = (h + kTH - 1) / kTH;
  const int chunks = (c + kCC - 1) / kCC;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles_w * tiles_h, chunks, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wg);
  bf16* yp = static_cast<bf16*>(y);
  if (cg == 4)
    grouped_conv_kernel<4><<<grid, kThreads, 0, s>>>(xp, wp, yp, h, w, c,
                                                    tiles_w);
  else
    grouped_conv_kernel<8><<<grid, kThreads, 0, s>>>(xp, wp, yp, h, w, c,
                                                    tiles_w);
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
