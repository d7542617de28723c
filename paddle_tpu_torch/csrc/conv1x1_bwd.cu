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
// TB/s) against 4*n*ci*co FLOP on the bf16 tensor cores (0.027 ms at
// (25088, 256, 1024), where the two bounds meet).
//
// What the design does about it. The TPU kernel leans on a sequential
// grid: dW lives in on-chip scratch across every n-tile and the last step
// writes it. Here blocks run in no order, and a whole dW (1 MB of f32 at
// ci = 256, co = 1024) fits no block, so
//   - a block owns a contiguous range of 128-row n-tiles (a loop inside
//     the block takes the place of the sequential grid) and one slice of
//     `cs` input channels (16, 32 or 64). It keeps the slice's partial
//     dW^T [co, cs] in the accumulator registers of its two warpgroups for
//     the whole range: cs * co <= 32768 f32, 128 registers a thread at
//     most. Computing dW^T rather than dW makes co the product's M (a
//     multiple of wgmma's 64 rows) and cs its N (16, 32 or 64);
//   - past co = 512 that budget would narrow the slices to 32 or 16
//     channels, so each slice's re-read of dy through L2 (411 MB at
//     (25088, 256, 1024) with 8 slices: the L2, not device memory, bound
//     it) and the narrow N would cost most. There a 2-CTA cluster splits
//     co instead: each CTA keeps dW^T of its 512 co and a 64- (or 32-)
//     channel slice, contracts dx over its half of co, and the pair
//     adds its halves of each dx tile through distributed shared memory
//     (kSplit; 4 slices re-read dy at that shape, 205 MB);
//   - dy streams through a ring of cp.async copies in chunks of [128
//     rows, 128 co] (32 KB): 4 to 6 chunks, as many as shared memory
//     holds beside W, so 3 to 5 are in flight while one feeds the tensor
//     cores (letting a chunk's products run on past the next barrier made
//     the co = 1024 instantiation spill and gained nothing at the others).
//     co is padded with zeros to 128, 256, 512 or 1024 (chunks past co add
//     nothing);
//   - each chunk feeds both products, on both warpgroups, by wgmma from
//     128-byte-swizzled shared memory (wgmma_common.cuh): warpgroup g
//     takes rows 64g .. 64g + 63 of the dx tile, dx += dy[64 rows, chunk]
//     . W[slice, chunk]^T (A K-major, B = W's rows K-major; the
//     contraction runs over all of co, chunk by chunk), and rows 64g ..
//     64g + 63 of the chunk's dW^T, dW^T[chunk] += dy[:, chunk]^T . x
//     tile (A read MN-major out of the same dy chunk, B the x tile stored
//     transposed, K-major). So every warp works on both products; the
//     PR 4 version ran dx on 2 of 8 warps at co = 1024;
//   - W[slice, :] stays in shared memory for the block's lifetime; the x
//     tile of the next n-tile is loaded into registers while the current
//     one runs and stored transposed into the second of two buffers;
//   - the blocks of one n-range (its ci slices) are neighbours in the
//     grid, so they run side by side and their reads of dy after the
//     first are served by the L2 cache: dy crosses device memory once.
//     Slices: 1, 2 and 8 at the three ResNet-50 shapes;
//   - a second small kernel sums the n-ranges' partial dW in a fixed
//     order, so dW is the same from run to run (atomics would not be).
// Shared memory: W slice (cs * co_pad * 2 bytes) + the ring + two x
// tiles (+ two receive buffers with the co split), 230,400 bytes at the
// study's shapes: one block an SM, 8 warps.
// Rows past n read as zeros and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

using namespace pt_wgmma;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTN = 128;       // rows of an n-tile (64 a warpgroup)
constexpr int kChunk = 128;    // co columns of a streamed dy chunk
constexpr int kSmemMax = 232448;  // shared memory a block may take
constexpr int kMaxAccum = 128; // dW^T accumulators a thread, at most

struct Args {
  const bf16 *x, *dy, *w;
  bf16* dx;
  float* partial;  // [parts][ci][co]
  int n, ci, co;
  int tiles_per_part;  // n-tiles per n-range
};

// Shared-memory shape of a (cs, chunks) instantiation; every part is a
// multiple of 1024 bytes, as the swizzled panels need. The ring takes
// what W and the x tiles leave, 4 to 6 chunks.
template <int kCs, int kChunks, int kSplit>
struct Smem {
  static constexpr int kW = kCs * kChunks * kChunk * 2;  // W slice
  static constexpr int kDy = kTN * kChunk * 2;           // a dy chunk
  static constexpr int kX = kCs * kTN * 2;               // an x^T tile
  // co split over a cluster pair: two buffers that receive the partner's
  // half of the dx tile, [kCs / 2 accumulators][128 threads] f32
  static constexpr int kRecv = kSplit == 2 ? 64 * kCs * 4 : 0;
  static constexpr int kFit =
      (kSmemMax - 1024 - kW - 2 * kX - 2 * kRecv) / kDy;
  static constexpr int kRing = kFit < 6 ? kFit : 6;
  static_assert(kRing >= 3, "the ring needs three chunks");
  static constexpr int kBytes =
      kW + kRing * kDy + 2 * kX + 2 * kRecv + 1024;
};

// the 2-CTA cluster of the co split: barrier of both CTAs (release /
// acquire: the partner's shared-memory writes before it are visible
// after it), and a local shared address as the partner's
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// kSplit = 2: the blocks of a 2-CTA cluster share a ci slice and n-range
// and split co: rank h takes co [h * 128 kChunks, (h + 1) * 128 kChunks),
// its own dW^T columns, and half of each dx tile's contraction; warpgroup
// 1 - h sends its rows' partial to the partner, whose warpgroup 1 - h adds
// them to its own (x + y == y + x: equal bits either way) and stores.
template <int kCs, int kChunks, int kSplit>
__global__ void __launch_bounds__(kThreads, 1) conv1x1_bwd_kernel(Args a) {
  static_assert(kChunks * kCs / 2 <= kMaxAccum, "dW^T exceeds registers");
  using S = Smem<kCs, kChunks, kSplit>;
  constexpr int kRing = S::kRing;
  constexpr int kAhead = kRing - 1;      // chunks loaded ahead of use
  constexpr int kAcc = kCs / 2;          // accumulators of one m64 tile
  constexpr int kXLoads = kCs / 16;      // 16-byte x loads a thread a tile
  extern __shared__ char smem_raw[];
  char* Ws = align1024(smem_raw);
  char* ring = Ws + S::kW;
  char* Xs = ring + kRing * S::kDy;
  char* Recv = Xs + 2 * S::kX;  // kSplit == 2: two receive buffers

  const int n = a.n, ci = a.ci, co = a.co;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int half = kSplit == 2 ? (int)cluster_rank() : 0;
  const int cbase = half * kChunks * kChunk;  // this block's first co
  const int c0 = blockIdx.x / kSplit * kCs;   // this block's ci slice
  const int part = blockIdx.y;      // this block's n-range
  const int ntiles = (n + kTN - 1) / kTN;
  const int tile0 = part * a.tiles_per_part;
  const int nt = max(0, min(tile0 + a.tiles_per_part, ntiles) - tile0);
  const int n_chunks = nt * kChunks;

  // W[slice, :] -> shared (columns past co as zeros): [cs][co_pad]
  {
    constexpr int kPerRow = kChunks * kChunk / 8;
    const uint32_t base = smem_addr(Ws);
#pragma unroll 1
    for (int i = tid; i < kCs * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = i - r * kPerRow;
      const bool ok = cbase + 8 * c < co;
      cp_async16(base + swz<kCs>(r, c),
                 a.w + (ok ? (size_t)(c0 + r) * co + cbase + 8 * c : 0),
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  // chunk g of the walk: n-tile g / kChunks, co columns 128 (g % kChunks) on
  auto load_chunk = [&](int g) {
    const int n0 = (tile0 + g / kChunks) * kTN;
    const int col0 = cbase + (g % kChunks) * kChunk;
    const uint32_t base = smem_addr(ring + (g % kRing) * S::kDy);
#pragma unroll 1
    for (int i = tid; i < kTN * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), c = i % (kChunk / 8);
      const bool ok = n0 + r < n && col0 + 8 * c < co;
      cp_async16(base + swz<kTN>(r, c),
                 a.dy + (ok ? (size_t)(n0 + r) * co + col0 + 8 * c : 0),
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_chunks) load_chunk(s);
    cp_async_commit();
  }

  // the x tile of n-tile t: 16-byte loads into registers (8 channels of a
  // row each), then stored transposed, x^T [cs][128 rows], K-major
  uint4 xr[kXLoads];
  auto load_x = [&](int t) {
    const int n0 = (tile0 + t) * kTN;
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (kCs / 8), c = i % (kCs / 8);
      xr[u] = n0 + r < n ? *reinterpret_cast<const uint4*>(
                               a.x + (size_t)(n0 + r) * ci + c0 + 8 * c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // Lanes of one x row hold channels 8c .. 8c + 7 for c = 0, 1, ...; at
  // step e lane c stores channel 8c + (e + c) % 8, so the lanes' x^T rows
  // differ mod 8 and the swizzle puts them in different banks.
  auto store_x = [&](int buf) {
    char* xt = Xs + buf * S::kX;
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / (kCs / 8), c = i % (kCs / 8);
      const uint4 v = xr[u];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ee = (e + c) & 7;
        const uint32_t w = ee < 4 ? (ee < 2 ? v.x : v.y)
                                  : (ee < 6 ? v.z : v.w);
        *reinterpret_cast<uint16_t*>(xt + swz<kCs>(8 * c + ee, r >> 3) +
                                     2 * (r & 7)) =
            (uint16_t)(ee & 1 ? w >> 16 : w & 0xffffu);
      }
    }
    fence_async_shared();  // visible to wgmma after the next barrier
  };
  if (nt > 0) {
    load_x(0);
    store_x(0);
    if (nt > 1) load_x(1);
  }

  const uint32_t w_addr = smem_addr(Ws);
  // the partner is running before its shared memory is written
  if (kSplit == 2) cluster_sync();
  float accw[kChunks][kAcc];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) accw[c][i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const uint32_t x_addr = smem_addr(Xs + (t & 1) * S::kX);
    float accx[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) accx[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int g = t * kChunks + c;
      // chunk g landed and is visible to wgmma; every thread's products of
      // chunk g - 1 are done, so its slot takes the load kAhead chunks on
      cp_async_wait<kAhead - 1>();
      fence_async_shared();
      __syncthreads();
      if (g + kAhead < n_chunks) load_chunk(g + kAhead);
      cp_async_commit();
      const uint32_t dy_addr = smem_addr(ring + (g % kRing) * S::kDy);
      wgmma_fence();
      // dx[64 rows of warpgroup wg, slice] += dy[rows, chunk] .
      // W[slice, chunk]^T
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_acc<0>(accx, desc_k<kTN>(dy_addr, 64 * wg, kk),
                     desc_k<kCs>(w_addr, 0, c * (kChunk / 16) + kk));
      // dW^T[64 co of warpgroup wg in the chunk, slice] += dy^T x
#pragma unroll
      for (int kk = 0; kk < kTN / 16; ++kk)
        wgmma_acc<1>(accw[c], desc_mn<kTN>(dy_addr + wg * kTN * 128, kk),
                     desc_k<kCs>(x_addr, 0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(accx);
      reg_fence(accw[c]);
    }
    if (kSplit == 2) {
      // warpgroup 1 - half sends its partial rows; after the barrier the
      // partner's are in this block's buffer t % 2, which the partner
      // writes again two tiles on, after the next barrier
      const uint32_t slot = smem_addr(Recv + (t & 1) * S::kRecv) +
                            4 * (tid % 128);
      if (wg != half) {
        const uint32_t peer = peer_addr(slot, half ^ 1);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) st_peer(peer + 4 * 128 * i, accx[i]);
      }
      cluster_sync();
      if (wg == half) {
        const float* got = reinterpret_cast<const float*>(
                               Recv + (t & 1) * S::kRecv) +
                           tid % 128;
#pragma unroll
        for (int i = 0; i < kAcc; ++i) accx[i] += got[128 * i];
      }
    }
    // dx rows of this warpgroup (with the co split, of the warpgroup that
    // summed them): element 4*n8 + 2*i + j is row 16*warp + lane/4 + 8i,
    // column 8*n8 + 2*(lane%4) + j
    const int n0 = (tile0 + t) * kTN + 64 * wg;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = n0 + 16 * warp + lane / 4 + 8 * i;
      if (r < n && (kSplit == 1 || wg == half)) {
        bf16* row = a.dx + (size_t)r * ci + c0;
#pragma unroll
        for (int n8 = 0; n8 < kCs / 8; ++n8)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * n8 + 2 * (lane % 4)) =
              __floats2bfloat162_rn(accx[4 * n8 + 2 * i],
                                    accx[4 * n8 + 2 * i + 1]);
      }
    }
    // the next tile's x: its buffer was last read in tile t - 1, finished
    // by every thread before this tile's first barrier
    if (t + 1 < nt) {
      store_x((t + 1) & 1);
      if (t + 2 < nt) load_x(t + 2);
    }
  }
  cp_async_wait<0>();

  // partial dW[slice, co] of this n-range, from dW^T rows 128c + 64wg + ...
  float* pb = a.partial + ((size_t)part * ci + c0) * co;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o =
          cbase + c * kChunk + 64 * wg + 16 * warp + lane / 4 + 8 * i;
      if (o < co) {
#pragma unroll
        for (int n8 = 0; n8 < kCs / 8; ++n8)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            pb[(size_t)(8 * n8 + 2 * (lane % 4) + j) * co + o] =
                accw[c][4 * n8 + 2 * i + j];
      }
    }
}

// dW[i] = sum over the n-ranges, in their order, of partial[p][i]. A
// thread keeps 16 loads in flight (with up to 131 n-ranges, one load at a
// time left the reduction latency-bound) and adds them in order.
__global__ void conv1x1_bwd_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dw, int parts,
                                          long long count4) {
  constexpr int kBatch = 16;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  const float4* p = reinterpret_cast<const float4*>(partial);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < parts; k0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k0 + k < parts) v[k] = __ldg(p + (long long)(k0 + k) * count4 + i);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k0 + k < parts) {
        s.x += v[k].x;
        s.y += v[k].y;
        s.z += v[k].z;
        s.w += v[k].w;
      }
  }
  reinterpret_cast<float4*>(dw)[i] = s;
}

template <int kCs, int kChunks, int kSplit>
cudaError_t run(const Args& a, int parts, cudaStream_t s) {
  const int smem = Smem<kCs, kChunks, kSplit>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_bwd_kernel<kCs, kChunks, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ci / kCs * kSplit, parts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;  // the co split's pair, or 1
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSplit == 2 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, conv1x1_bwd_kernel<kCs, kChunks, kSplit>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kCs>
cudaError_t run_cs(const Args& a, int chunks, int parts, cudaStream_t s) {
  switch (chunks) {
    case 1: return run<kCs, 1, 1>(a, parts, s);
    case 2: return run<kCs, 2, 1>(a, parts, s);
    case 4: return run<kCs, 4, 1>(a, parts, s);
    case 8:  // wider slices split co over a cluster pair
      if constexpr (kCs == 16) return run<16, 8, 1>(a, parts, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = both kernels launched). Pointers are device
// pointers to contiguous row-major arrays; `partial` is scratch of
// parts * ci * co floats. The caller plans the split (conv_bwd.plan):
// `cs` input channels a slice (16, 32 or 64, dividing ci), `chunks` 128-
// column dy chunks a block (1, 2, 4 or 8; 8 only with cs 16),
// `co_split` 1, or 2 for a cluster pair that splits co (cs 32 or 64,
// chunks 4),
// the blocks' chunks covering co, and `parts` n-ranges of
// `tiles_per_part` 128-row n-tiles each that cover ceil(n / 128) tiles.
// Rows past n are masked. `stream` is a cudaStream_t.
int pt_conv1x1_bwd(const void* x, const void* dy, const void* w, void* dx,
                   void* dw, void* partial, int n, int ci, int co, int cs,
                   int chunks, int co_split, int parts, int tiles_per_part,
                   void* stream) {
  if (n < 1 || ci < 16 || co < 16 || ci % 16 || co % 16 ||
      (cs != 16 && cs != 32 && cs != 64) || ci % cs || chunks < 1 ||
      chunks > 8 || (chunks & (chunks - 1)) ||
      (chunks == 8 && cs != 16) ||
      (co_split != 1 && (co_split != 2 || cs == 16 || chunks != 4)) ||
      co_split * chunks * kChunk < co ||
      (chunks / 2) * kChunk * co_split >= co ||
      chunks * cs / 2 > kMaxAccum || parts < 1 || parts > 65535 ||
      tiles_per_part < 1 || (long long)parts * tiles_per_part * kTN < n)
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
  a.tiles_per_part = tiles_per_part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = co_split == 2 ? (cs == 64 ? run<64, 4, 2>(a, parts, s)
                                                : run<32, 4, 2>(a, parts, s))
                    : cs == 16    ? run_cs<16>(a, chunks, parts, s)
                    : cs == 32    ? run_cs<32>(a, chunks, parts, s)
                                  : run_cs<64>(a, chunks, parts, s);
  if (err != cudaSuccess) return (int)err;
  const long long count4 = (long long)ci * co / 4;
  const int threads = 64;  // more blocks: dW is 16 K to 64 K float4s
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
