// Backward of a 1x1 convolution in one pass over (x, dy), for Hopper
// (sm_90a): dx = dy . W^T and dW = x^T . dy.
//
// Replaces the TPU kernel `combined_conv1x1_bwd` (inline `kernel`,
// benchmarks/conv_bwd_pallas.py:80). x [n, ci] bf16, dy [n, co] bf16,
// W [ci, co] bf16 -> dx [n, ci] bf16, dW [ci, co] f32; products of bf16
// values summed in f32.
//
// What bounds it on the H100: bytes. x, dy and W are read once and dx, dW
// written once (308 MB at n = 401408, ci = 64, co = 256: 0.092 ms at 3.35
// TB/s) against 4*n*ci*co FLOP on the bf16 tensor cores (0.027 ms).
//
// What the design does about it. The TPU kernel leans on a sequential
// grid: dW lives in on-chip scratch across every n-tile and the last step
// writes it. Here blocks run in no order, so
//   - a block owns a contiguous range of n-tiles (a loop inside the block
//     takes the place of the sequential grid) and one slice of `cs` input
//     channels, chosen so that its partial dW[slice, :] (cs * co <= 16384
//     f32) stays in the accumulator registers of its 8 warps for the
//     whole range: 64 tensor-core tiles of 16 x 16, 8 a warp;
//   - per n-tile it loads the dy tile [tn, co] and its x slice [tn, cs]
//     into shared memory once and uses them for both products: the dx
//     tile [tn, cs] = dy . W[slice, :]^T (complete: the contraction runs
//     over all of co) and the dW partial += x^T . dy;
//   - W[slice, :] stays in shared memory for the block's lifetime;
//   - a second small kernel sums the partials of the n-ranges in a fixed
//     order, so dW is the same from run to run (atomics would not be).
// Reads from device memory: x once, W once per n-range, dy once per
// ci-slice (1, 4 and 16 slices at the three ResNet-50 shapes); the
// sibling slices of one n-range run side by side, so the re-reads of dy
// are served by the L2 cache and the pass over dy from device memory
// stays one. The partials cost parts * ci * co * 4 bytes written and read
// (about 17 MB at each shape). Products run on the tensor cores through
// `nvcuda::wmma` (mma.sync, 16 x 16 x 16 bf16 with f32 accumulators);
// loads are 16 bytes a thread. Tiles are single-buffered: wgmma, TMA and
// a multi-stage ring are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesPerWarp = 8;  // dW 16x16 tiles a warp keeps in registers
constexpr int kMaxSliceTiles = kWarps * kTilesPerWarp;
constexpr int kPad = 8;  // elements of padding per shared-memory row

struct Args {
  const bf16 *x, *dy, *w;
  bf16* dx;
  float* partial;  // [parts][ci][co]
  int n, ci, co;
  int cs;              // input channels per slice (multiple of 16)
  int tn;              // rows per n-tile (multiple of 16)
  int tiles_per_part;  // n-tiles per n-range
};

size_t smem_bytes(int cs, int tn, int co) {
  // Ws [cs][co+pad], Ds [tn][co+pad], Xs [tn][cs+pad] bf16; Ss [tn][cs+pad] f32
  return sizeof(bf16) * ((size_t)cs * (co + kPad) + (size_t)tn * (co + kPad) +
                         (size_t)tn * (cs + kPad)) +
         sizeof(float) * (size_t)tn * (cs + kPad);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void __launch_bounds__(kThreads, 2) conv1x1_bwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ci = a.ci, co = a.co, cs = a.cs, tn = a.tn;
  const int ldw = co + kPad, ldd = co + kPad, ldx = cs + kPad, lds = cs + kPad;
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);      // [cs][ldw]
  bf16* Ds = Ws + cs * ldw;                          // [tn][ldd]
  bf16* Xs = Ds + tn * ldd;                          // [tn][ldx]
  float* Ss = reinterpret_cast<float*>(Xs + tn * ldx);  // [tn][lds]

  const int tid = threadIdx.x, warp = tid / 32;
  const int c0 = blockIdx.x * cs;  // this block's input-channel slice
  const int part = blockIdx.y;     // this block's n-range

  // W[slice, :] -> shared, for the block's lifetime
  const int wvec = co / 8, xvec = cs / 8;
  for (int i = tid; i < cs * wvec; i += kThreads) {
    int r = i / wvec, v = i - r * wvec;
    *reinterpret_cast<uint4*>(Ws + r * ldw + v * 8) =
        *reinterpret_cast<const uint4*>(a.w + (size_t)(c0 + r) * co + v * 8);
  }

  const int nct = co / 16;           // 16-wide column tiles of dW
  const int ntile = (cs / 16) * nct; // dW tiles of the slice (<= 64)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTilesPerWarp];
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int ndx_c = cs / 16, ndx = (tn / 16) * ndx_c;  // dx tiles of an n-tile
  const int ntiles_total = (a.n + tn - 1) / tn;
  const int tile0 = part * a.tiles_per_part;
  const int tile1 = min(tile0 + a.tiles_per_part, ntiles_total);

  for (int t = tile0; t < tile1; ++t) {
    const int n0 = t * tn;
    __syncthreads();  // the previous tile's reads of Ds, Xs and Ss are done
    for (int i = tid; i < tn * wvec; i += kThreads) {
      int r = i / wvec, v = i - r * wvec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);  // rows past n read as zeros
      if (n0 + r < a.n)
        val = *reinterpret_cast<const uint4*>(a.dy + (size_t)(n0 + r) * co +
                                              v * 8);
      *reinterpret_cast<uint4*>(Ds + r * ldd + v * 8) = val;
    }
    for (int i = tid; i < tn * xvec; i += kThreads) {
      int r = i / xvec, v = i - r * xvec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < a.n)
        val = *reinterpret_cast<const uint4*>(a.x + (size_t)(n0 + r) * ci +
                                              c0 + v * 8);
      *reinterpret_cast<uint4*>(Xs + r * ldx + v * 8) = val;
    }
    __syncthreads();

    // dx tile = dy tile . W[slice, :]^T, contraction over all of co
    for (int dt = warp; dt < ndx; dt += kWarps) {
      const int rt = dt / ndx_c, ct = dt - rt * ndx_c;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> d;
      wmma::fill_fragment(d, 0.f);
      for (int k = 0; k < co; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Ds + rt * 16 * ldd + k, ldd);
        // B(k, c) = W[c0 + ct*16 + c][k]: W's rows are B's columns
        wmma::load_matrix_sync(fb, Ws + ct * 16 * ldw + k, ldw);
        wmma::mma_sync(d, fa, fb, d);
      }
      wmma::store_matrix_sync(Ss + rt * 16 * lds + ct * 16, d, lds,
                              wmma::mem_row_major);
    }

    // dW partial += x tile^T . dy tile, contraction over the tile's rows
    for (int kk = 0; kk < tn; kk += 16) {
      int last_rt = -1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const int tt = warp * kTilesPerWarp + j;
        if (tt < ntile) {
          const int rt = tt / nct, ct = tt - rt * nct;
          if (rt != last_rt) {
            // A(c, r) = x[n0 + kk + r][c0 + rt*16 + c]: x's rows are A's columns
            wmma::load_matrix_sync(fa, Xs + kk * ldx + rt * 16, ldx);
            last_rt = rt;
          }
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Ds + kk * ldd + ct * 16, ldd);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();  // the dx tile is whole in Ss

    for (int i = tid; i < tn * xvec; i += kThreads) {
      int r = i / xvec, v = i - r * xvec;
      if (n0 + r < a.n) {
        const float* s = Ss + r * lds + v * 8;
        uint4 pk;
        pk.x = pack2(s[0], s[1]);
        pk.y = pack2(s[2], s[3]);
        pk.z = pack2(s[4], s[5]);
        pk.w = pack2(s[6], s[7]);
        *reinterpret_cast<uint4*>(a.dx + (size_t)(n0 + r) * ci + c0 + v * 8) =
            pk;
      }
    }
  }

  float* pb = a.partial + ((size_t)part * ci + c0) * co;
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    const int tt = warp * kTilesPerWarp + j;
    if (tt < ntile) {
      const int rt = tt / nct, ct = tt - rt * nct;
      wmma::store_matrix_sync(pb + (size_t)rt * 16 * co + ct * 16, acc[j], co,
                              wmma::mem_row_major);
    }
  }
}

// dW[i] = sum over the n-ranges, in their order, of partial[p][i].
__global__ void conv1x1_bwd_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dw, int parts,
                                          long long count4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  const float4* p = reinterpret_cast<const float4*>(partial);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < parts; ++k) {
    float4 v = p[(long long)k * count4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  reinterpret_cast<float4*>(dw)[i] = s;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = both kernels launched). Pointers are device
// pointers to contiguous row-major arrays; `partial` is scratch of
// parts * ci * co floats. The caller plans the split: `cs` input channels
// a slice (a multiple of 16 that divides ci, with (cs/16)*(co/16) <= 64),
// `tn` rows an n-tile (a multiple of 16), and `parts` n-ranges of
// `tiles_per_part` n-tiles each that cover ceil(n / tn) tiles. Rows past
// n are masked. `stream` is a cudaStream_t.
int pt_conv1x1_bwd(const void* x, const void* dy, const void* w, void* dx,
                   void* dw, void* partial, int n, int ci, int co, int cs,
                   int tn, int parts, int tiles_per_part, void* stream) {
  if (n < 1 || ci < 16 || co < 16 || ci % 16 || co % 16 || cs < 16 ||
      cs % 16 || ci % cs || tn < 16 || tn % 16 || parts < 1 ||
      parts > 65535 || tiles_per_part < 1 ||
      (cs / 16) * (co / 16) > kMaxSliceTiles ||
      (long long)parts * tiles_per_part * tn < n)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.dy = static_cast<const bf16*>(dy);
  a.w = static_cast<const bf16*>(w);
  a.dx = static_cast<bf16*>(dx);
  a.partial = static_cast<float*>(partial);
  a.n = n;
  a.ci = ci;
  a.co = co;
  a.cs = cs;
  a.tn = tn;
  a.tiles_per_part = tiles_per_part;
  const size_t smem = smem_bytes(cs, tn, co);
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(ci / cs, parts);
  conv1x1_bwd_kernel<<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count4 = (long long)ci * co / 4;
  const int threads = 256;
  conv1x1_bwd_reduce_kernel<<<(unsigned int)((count4 + threads - 1) / threads),
                              threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), parts,
      count4);
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
