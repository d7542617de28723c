// Grouped 3x3 convolution, stride 1, SAME padding, NHWC, on Hopper's
// tensor cores (sm_90a, mma.sync).
//
// Replaces the TPU kernel `grouped_conv_pallas` (`_kernel`,
// benchmarks/grouped_conv_pallas.py:42). x [N, H, W, C] bf16 and grouped
// weights wg [3, 3, cg, C] bf16 (HWIO: output channel c reads the cg input
// channels of its group, (c / cg) * cg + i) -> y [N, H, W, C] bf16, with
//   y[n, oy, ox, c] = sum over ky, kx, i of
//       x[n, oy + ky - 1, ox + kx - 1, (c / cg) * cg + i] * wg[ky, kx, i, c]
// summed in f32 and rounded to bf16 once (cells outside the image are
// zeros). cg is any divisor of 128; C a multiple of 8 and of cg.
//
// What bounds it on the H100: bytes. x is read once and y written once
// (205.5 MB at [128, 56, 56, 128]: 0.061 ms at 3.35 TB/s); the real work
// is 2 * 9 * cg FLOP an output (3.7 GFLOP at each SE-ResNeXt-50 stage).
//
// What the design does about it. The TPU kernel expands the weights to
// block-diagonal 128 x 128 matrices to fill its matrix unit (128 / cg
// times the needed products). Here the products run on mma.sync (bf16 in,
// f32 sums) as an implicit GEMM per 16-channel output slice:
//   - M: 16 neighbouring pixels of an output row (a row's last segment of
//     16 is ragged at any W), or of two rows where W <= 8; N: the slice's
//     16 output channels (two n8 fragments); K: the 9 taps times the
//     slice's input window. For cg >= 16 the window is the group's cg
//     channels, dense (K = 9 cg, m16n8k16). For cg < 16 it is the slice's
//     own 16 channels, and each tap's B tile is block-diagonal; at cg <= 8
//     each 8-channel half feeds its own 8 outputs (2 or 1 times the
//     needed products instead of 16 / cg), with tap columns 0 and 1 as
//     one k16 product and column 2 as an m16n8k8 one.
//   - A block copies its chunk's weights once, as wg holds them ([tap,
//     i, c] rows of its output channels, by cp.async beside its first
//     input tile). At cg <= 16 each warp builds its slice's nine B
//     fragments from that copy into registers once (ldmatrix.trans,
//     masked to the block diagonal); wider groups read theirs a k-step
//     through ldmatrix.trans (their 72 registers of B spill at cg 32).
//   - A comes straight from the input tile in shared memory through
//     ldmatrix: one address per pixel row, so each tap's (ky, kx) shift
//     is an offset of the row addresses. A warp owns a strip of up to 4
//     output rows of one 16-column segment, and each A fragment of an
//     input row feeds the (up to) three output rows it serves through
//     taps ky = 0, 1, 2: (rows + 2) * 3 fragment loads for rows * 9 taps;
//     the next input row's fragments load while a row's products run.
//     Cells are padded by 16 bytes, so the eight 16-byte rows of an
//     ldmatrix (eight neighbouring pixels) fall in different banks; cells
//     outside the image are written as zeros, so the inner loop has no
//     bounds test.
//   - Persistent blocks walk (image, band) items of their channel chunk;
//     the next bands' tiles (with their one-cell halo) stream in by
//     16-byte cp.async while the current one computes (a ring of 2 to 4
//     tiles: deeper where tiles are small, so enough bytes are in
//     flight).
//   - Each warp writes its 16 x 16 output tiles through a small staging
//     buffer (stmatrix, then 16-byte loads), so a store fills whole
//     32-byte sectors of a pixel's channels instead of 2-byte scalars at
//     a stride of C.
// No atomics: two launches give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

using pt_wgmma::cp_async16;
using pt_wgmma::cp_async_commit;
using pt_wgmma::cp_async_wait;
using pt_wgmma::smem_addr;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRG = 4;                      // output rows of a warp's strip
constexpr int kStageLd = 48;                // staging bytes a pixel row
constexpr int kStageBytes = 16 * kStageLd;  // a warp's 16 x 16 staging
constexpr int kSmemMax = 232448;
constexpr int kMaxStages = 4;

// The geometry of one window width (grouped_conv.geometry in Python):
// kCWS input channels feed a 16-channel output slice; a block computes
// kCO output channels from a window of kCW channels.
template <int kCWS>
struct Geo {
  static constexpr int kCO = kCWS <= 32 ? 64 : 2048 / kCWS;
  static constexpr int kCW = kCO > kCWS ? kCO : kCWS;
  static constexpr int kSlices = kCO / 16;
  static constexpr int kKSteps = kCWS / 16;
  static constexpr int kChunks = kCW / 8;     // 16-byte chunks a cell
  static constexpr int kCell = kCW * 2 + 16;  // bytes a cell, padded
  // the chunk's weights: 9 cg rows (tap, i) of kCO channels, padded by 16
  // bytes so that the eight rows of an ldmatrix fall in different banks
  static constexpr int kBLd = kCO * 2 + 16;
  static constexpr bool kBReg = kCWS == 16;   // B fragments in registers
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// wait until at most n (0 .. kMaxStages - 1) copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void lds128(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: A 16 x 16 bf16 (row-major fragment), B 16 x 8 bf16, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: A 16 x 8 bf16, B 8 x 8 bf16, f32 sums
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// kK8 (cg <= 8): each 8-channel half of a slice's window feeds its own 8
// outputs (half the products of the 16 x 16 block-diagonal tile, none
// wasted at cg 8). kRPT image rows an m16 tile: 1, or 2 where a row is no
// wider than 8 (16 lanes, 2 W pixels).
template <int kCWS, bool kK8, int kRPT>
__global__ void __launch_bounds__(kThreads, 2) grouped_conv_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wg,
    bf16* __restrict__ y, int N, int H, int W, int C, int cg, int rows,
    int bands, int stages) {
  typedef Geo<kCWS> G;
  constexpr int kBRegs = kK8 ? 2 : 4;      // B registers a tap and k-step
  constexpr int kTR = kRG / kRPT;          // m16 tiles of a strip
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int wp = W + 2;
  const int tile_bytes = (rows + 2) * wp * G::kCell;
  const int b_bytes = 9 * cg * G::kBLd;     // the chunk's weights
  const uint32_t b_sa = smem_addr(smem);
  const uint32_t stage_sa = b_sa + b_bytes + wid * kStageBytes;
  const uint32_t tiles_sa = b_sa + b_bytes + kWarps * kStageBytes;
  const int nseg = kRPT == 1 ? (W + 15) / 16 : 1;  // segments of a row

  const int c0 = blockIdx.y * G::kCO;       // the chunk's first output
  const int w0 = c0 / G::kCW * G::kCW;      // its window's first input
  const int cvalid = min(G::kCW, C - w0);   // real channels of the window

  // the band of an item -> input tile `buf`: (rows + 2) x (W + 2) cells of
  // the window's channels, zeros outside the image and past C
  auto load = [&](int item, int buf) {
    const int nn = item / bands, y0 = (item - nn * bands) * rows;
    const bf16* xb = x + (size_t)nn * H * W * C + w0;
    const uint32_t base = tiles_sa + buf * tile_bytes;
    constexpr int kStep = kThreads / G::kChunks;  // cells a pass
    const int q = threadIdx.x % G::kChunks;
    const bool cok = q * 8 < cvalid;
    const int ncell = (rows + 2) * wp;
    const int dy = kStep / wp, dx = kStep - dy * wp;
    int cell = threadIdx.x / G::kChunks;
    int cy = cell / wp, cx = cell - cy * wp;
    for (; cell < ncell; cell += kStep) {
      const int gy = y0 + cy - 1, gx = cx - 1;
      const bool ok = cok && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(base + cell * G::kCell + q * 16,
                 ok ? xb + ((size_t)gy * W + gx) * C + q * 8 : x,
                 ok ? 16 : 0);
      cx += dx;
      cy += dy;
      if (cx >= wp) {
        cx -= wp;
        ++cy;
      }
    }
  };

  // the first tiles, and (with the first) the chunk's weights as wg holds
  // them: row (tap, i) of the copy is wg[tap, i, c0 .. c0 + kCO), zeros
  // past C
  const int items = N * bands;
  for (int st = 0; st < stages - 1; ++st) {
    const int item = blockIdx.x + st * gridDim.x;
    if (item < items) load(item, st);
    if (st == 0) {
      constexpr int kRowChunks = G::kCO / 8;
      for (int i = threadIdx.x; i < 9 * cg * kRowChunks; i += kThreads) {
        const int r = i / kRowChunks, q = i - r * kRowChunks;
        const bool ok = c0 + q * 8 < C;
        cp_async16(b_sa + r * G::kBLd + q * 16,
                   ok ? wg + (size_t)r * C + c0 + q * 8 : wg, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }

  // this warp's slice, and the strips it takes among the slice's warps
  constexpr int kWps = kWarps / G::kSlices;
  const int s = wid % G::kSlices, j = wid / G::kSlices;
  const bool live = 16 * s < C - c0;
  const int a_off =
      kCWS == 16 ? 16 * s : (c0 + 16 * s) / kCWS * kCWS - w0;
  // ldmatrix.trans rows of B (cg >= 32): k = lane % 16 of a k-step, the
  // slice's output columns 8 (lane / 16) .. + 7
  const uint32_t bt_sa =
      b_sa + (lane & 15) * G::kBLd + (16 * s + (lane >> 4) * 8) * 2;
  uint32_t breg[G::kBReg ? 9 : 1][kBRegs];

  int buf = 0;
  for (int item = blockIdx.x, it = 0; item < items;
       item += gridDim.x, ++it, buf = buf + 1 == stages ? 0 : buf + 1) {
    const int ahead = item + (stages - 1) * gridDim.x;
    if (ahead < items) load(ahead, buf == 0 ? stages - 1 : buf - 1);
    cp_async_commit();
    cp_async_wait_n(stages - 1);
    __syncthreads();  // tile `buf` (and, at first, the weights) in place

    if (G::kBReg && it == 0) {
      // the slice's B fragments, from the weights' copy by ldmatrix.trans
      // (row k of a matrix: the copy's row (tap, k % cg)): at cg 16 the
      // dense 16 x 16 tile, at cg <= 8 one 8 x 8 tile per channel half,
      // each value kept where input k and output n share a group (lane 4 g
      // + t holds k = 2 t, 2 t + 1 of column n = g)
      const int g = lane >> 2, t = lane & 3, lg = __ffs(cg) - 1;
      const uint32_t keep =
          (((2 * t) >> lg) == (g >> lg) ? 0xffffu : 0u) |
          (((2 * t + 1) >> lg) == (g >> lg) ? 0xffff0000u : 0u);
      const int krow = lane & (kK8 ? 7 : 15);
      const uint32_t brow =
          b_sa + (krow & (cg - 1)) * G::kBLd +
          (16 * s + (kK8 ? (lane >> 3) & 1 : lane >> 4) * 8) * 2;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t at = brow + tap * cg * G::kBLd;
        if (kK8) {
          ldmatrix_x2_trans(at, breg[tap][0], breg[tap][kBRegs - 1]);
          breg[tap][0] &= keep;
          breg[tap][kBRegs - 1] &= keep;
        } else {
          uint32_t b4[4];
          ldmatrix_x4_trans(at, b4);
#pragma unroll
          for (int i = 0; i < kBRegs; ++i) breg[tap][i] = b4[i];
        }
      }
    }

    const int nn = item / bands, y0 = (item - nn * bands) * rows;
    const int rh = min(rows, H - y0);            // output rows of the band
    const int units = nseg * ((rh + kRG - 1) / kRG);  // strips a slice
    // the slice's window in tile `buf`
    const uint32_t tbase = tiles_sa + buf * tile_bytes + a_off * 2;
    for (int u = j; live && u < units; u += kWps) {
      const int xs = u % nseg, r0 = u / nseg * kRG;
      const int nr = min(kRG, rh - r0);          // output rows of the strip
      // this lane's pixel of an m16 tile: column 16 xs + lane % 16 (past
      // W: the last column, not stored), or with two rows a tile, row
      // (lane % 16) / W, column (lane % 16) % W (past 2 W: the last pixel)
      int sub = 0, colx = min(xs * 16 + (lane & 15), W - 1);
      if (kRPT == 2) {
        sub = min((lane & 15) / W, 1);
        colx = (lane & 15) < 2 * W ? (lane & 15) - sub * W : W - 1;
      }
      const int lim = rows + 1 - r0;             // the tile's last row
      const uint32_t pix = tbase + (r0 * wp + colx) * G::kCell;
      // byte offsets of this lane's ldmatrix rows from its pixel: tap
      // column kx with channels 8 (lane / 16) .. + 7 of the k-step; for
      // cg <= 8, also the pair of tap columns 0 (lanes < 16) and 1 with
      // channels 8 h .. 8 h + 7
      const int hi = lane >> 4;
      float acc[kTR][2][4];
#pragma unroll
      for (int o = 0; o < kTR; ++o)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[o][f][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < G::kKSteps; ++kk) {
        // the nine taps' B fragments of this k-step
        uint32_t bq[9][kBRegs];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          if (G::kBReg) {
#pragma unroll
            for (int i = 0; i < kBRegs; ++i)
              bq[tap][i] = breg[G::kBReg ? tap : 0][i];
          } else {
            uint32_t b4[4];
            ldmatrix_x4_trans(bt_sa + (tap * kCWS + kk * 16) * G::kBLd, b4);
#pragma unroll
            for (int i = 0; i < kBRegs; ++i) bq[tap][i] = b4[i];
          }
        }
        // A of input row d of the strip (image row y0 + r0 + d - 1, plus
        // the lane's row of a two-row tile): f[kx] for tap columns kx =
        // 0, 1, 2; for cg <= 8, f[h] pairs tap columns 0 and 1 of channel
        // half h (one k16 product for both), f[2] is tap column 2
        auto load_a = [&](int d, uint32_t (&f)[3][4]) {
          const uint32_t row =
              pix + min(d + sub, lim) * wp * G::kCell + kk * 32;
          if (kK8) {
            ldmatrix_x4(row + hi * G::kCell, f[0]);
            ldmatrix_x4(row + hi * G::kCell + 16, f[1]);
          } else {
            ldmatrix_x4(row + hi * 16, f[0]);
            ldmatrix_x4(row + G::kCell + hi * 16, f[1]);
          }
          ldmatrix_x4(row + 2 * G::kCell + hi * 16, f[2]);
        };
        // input row d feeds the tile whose first row is d - ky through
        // taps (ky, 0..2): one A fragment serves up to three output rows;
        // row d + 1's fragments load while row d's products run. A strip
        // of fewer than 4 rows computes all 4 (rows past the band read
        // the tile's last row and are not stored): no run-time test splits
        // the products into small blocks the compiler cannot interleave
        uint32_t a[2][3][4];
        load_a(0, a[0]);
#pragma unroll
        for (int d = 0; d < kRG + 2; ++d) {
          if (d + 1 < kRG + 2) load_a(d + 1, a[(d + 1) & 1]);
          const uint32_t(&f)[3][4] = a[d & 1];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int o2 = d - ky;  // (constant)
            if (o2 >= 0 && o2 % kRPT == 0 && o2 < kRG) {
              const int o = o2 < 0 || o2 >= kRG ? 0 : o2 / kRPT;
              if (kK8) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  mma_bf16(acc[o][h], f[h], bq[ky * 3][h],
                           bq[ky * 3 + 1][h]);
                  mma_bf16_k8(acc[o][h], f[2][2 * h], f[2][2 * h + 1],
                              bq[ky * 3 + 2][h]);
                }
              } else {
#pragma unroll
                for (int kx = 0; kx < 3; ++kx) {
                  const uint32_t* bt = bq[ky * 3 + kx];
                  mma_bf16(acc[o][0], f[kx], bt[0], bt[1 % kBRegs]);
                  mma_bf16(acc[o][1], f[kx], bt[2 % kBRegs],
                           bt[3 % kBRegs]);
                }
              }
            }
          }
        }
      }
      // out: each 16 x 16 tile through the warp's staging, 16 bytes a lane
      const int ch = c0 + 16 * s + (lane & 1) * 8;
      const int px = lane >> 1;                  // the lane's pixel of a tile
      const int psub = kRPT == 1 ? 0 : px / W;
      const int ox = kRPT == 1 ? xs * 16 + px : px - psub * W;
#pragma unroll
      for (int o = 0; o < kTR; ++o) {
        if (o * kRPT >= nr) break;
        const uint32_t frag[4] = {pack_bf16(acc[o][0][0], acc[o][0][1]),
                                  pack_bf16(acc[o][0][2], acc[o][0][3]),
                                  pack_bf16(acc[o][1][0], acc[o][1][1]),
                                  pack_bf16(acc[o][1][2], acc[o][1][3])};
        stmatrix_x4(stage_sa + (lane & 15) * kStageLd + (lane >> 4) * 16,
                    frag);
        __syncwarp();
        uint32_t v[4];
        lds128(stage_sa + px * kStageLd + (lane & 1) * 16, v);
        const int orow = o * kRPT + psub;        // the pixel's strip row
        if (ox < W && psub < kRPT && orow < nr && ch < C)
          *reinterpret_cast<uint4*>(
              y + (((size_t)nn * H + y0 + r0 + orow) * W + ox) * C + ch) =
              make_uint4(v[0], v[1], v[2], v[3]);
        __syncwarp();
      }
    }
    __syncthreads();  // every read of tile `buf` done before it refills
  }
  cp_async_wait<0>();
}

template <int kCWS, bool kK8, int kRPT>
cudaError_t launch(const bf16* x, const bf16* wg, bf16* y, int n, int h,
                   int w, int c, int cg, int rows, int blocks, int stages,
                   cudaStream_t s) {
  typedef Geo<kCWS> G;
  const long long smem = 9LL * cg * G::kBLd + kWarps * kStageBytes +
                         (long long)stages * (rows + 2) * (w + 2) * G::kCell;
  const int chunks = (c + G::kCO - 1) / G::kCO;
  if (smem > kSmemMax || chunks > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_conv_mma_kernel<kCWS, kK8, kRPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bands = (h + rows - 1) / rows;
  grouped_conv_mma_kernel<kCWS, kK8, kRPT>
      <<<dim3(blocks, chunks), kThreads, (size_t)smem, s>>>(
          x, wg, y, n, h, w, c, cg, rows, bands, stages);
  return cudaGetLastError();
}

template <int kCWS, bool kK8>
cudaError_t launch_rows(const bf16* x, const bf16* wg, bf16* y, int n, int h,
                        int w, int c, int cg, int rows, int blocks,
                        int stages, cudaStream_t s) {
  return w <= 8 ? launch<kCWS, kK8, 2>(x, wg, y, n, h, w, c, cg, rows, blocks,
                                       stages, s)
                : launch<kCWS, kK8, 1>(x, wg, y, n, h, w, c, cg, rows, blocks,
                                       stages, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). x and y are contiguous
// [n, h, w, c] bf16, wg contiguous [3, 3, cg, c] bf16; cg divides 128, c
// is a multiple of 8 and of cg. `rows` image rows a band, `blocks`
// persistent blocks a channel chunk and `stages` input tiles in the ring
// come from grouped_conv.plan. `stream` is a cudaStream_t.
int pt_grouped_conv(const void* x, const void* wg, void* y, int n, int h,
                    int w, int c, int cg, int rows, int blocks, int stages,
                    void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 8 || c % 8 || cg < 1 || 128 % cg ||
      c % cg || rows < 1 || rows > h || blocks < 1 || stages < 2 ||
      stages > kMaxStages ||
      (long long)n * ((h + rows - 1) / rows) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wg);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cg <= 8)
    err = launch_rows<16, true>(xp, wp, yp, n, h, w, c, cg, rows, blocks,
                                stages, s);
  else if (cg == 16)
    err = launch_rows<16, false>(xp, wp, yp, n, h, w, c, cg, rows, blocks,
                                 stages, s);
  else if (cg == 32)
    err = launch_rows<32, false>(xp, wp, yp, n, h, w, c, cg, rows, blocks,
                                 stages, s);
  else if (cg == 64)
    err = launch_rows<64, false>(xp, wp, yp, n, h, w, c, cg, rows, blocks,
                                 stages, s);
  else
    err = launch_rows<128, false>(xp, wp, yp, n, h, w, c, cg, rows, blocks,
                                  stages, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
