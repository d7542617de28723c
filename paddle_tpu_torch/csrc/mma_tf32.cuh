// f32-accurate matrix products on Hopper's tensor cores (sm_80 and up),
// for the f32 attention backward (flash_attention_bthd_bwd.cu): 3xTF32
// through mma.sync.m16n8k8, with the fragments loaded from f32 tiles in
// shared memory and split in registers.
//
// 3xTF32. An f32 value x is split into big = tf32(x) (as cvt.rna rounds:
// 10 explicit mantissa bits, to nearest, ties away) and small = x - big
// (exact in f32, at most 2^-11 of x), of which the tensor cores read the
// top 19 bits (they drop the low 13 bits of a TF32 operand), so big +
// small carries 21 bits of x or more. A product a b is taken as small(a)
// big(b) + big(a) small(b) + big(a) big(b), three TF32 MMAs into one f32
// accumulator; small(a) small(b) (~2^-22 of a b) is dropped. One TF32
// product alone keeps ~11 bits and misses an f32 limit of 1e-5
// (tests/test_torch_attention_f32_bwd.py models this arithmetic).
//
// Fragments of mma.m16n8k8 (lane = 4 g + t): A (16 x 8, row-major) holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, k by n) holds
// (t, g), (t + 4, g); the accumulator C (16 x 8) holds (g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1). A product that reduces over the
// columns of an accumulator takes them in the order 2t, 2t + 1 for its k
// = t, t + 4 (acc_to_a), and its B rows in the same order (load_b_kn), so
// scores never leave registers.
//
// Tiles are row-major f32 with a row stride kLd = 4 (mod 32) floats: a
// fragment load of 8 rows at 4 columns (load_a, load_b_nk), or of 8 columns
// at rows 2t and 2t + 1 (load_b_kn), touches 32 different banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace pt_tf32 {

using pt_wgmma::cp_async16;
using pt_wgmma::cp_async4;
using pt_wgmma::smem_addr;

// The two TF32 terms of an A (4 values) or B (2 values) fragment
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// big = tf32(x), the bits cvt.rna.tf32.f32 gives, from two integer ops
// (half of the dropped range added to the magnitude bits, then masked: a
// conversion instruction issues at a quarter of the integer rate), and
// small = x - big, passed as it is
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
  }
}

// A of rows g, g + 8 and columns k0 + t, k0 + t + 4 of a tile whose row 0
// is `x` (the warp's 16 rows)
template <int kLd>
__device__ __forceinline__ void load_a(const float* x, int k0, int lane,
                                       FragA& f) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = x + g * kLd + k0 + t;
  const float v[4] = {p[0], p[8 * kLd], p[4], p[8 * kLd + 4]};
  split(v, f.big, f.small);
}

// B whose n runs along the tile's rows and k along its columns (the tile
// is the product's right side transposed, e.g. K in S = Q K^T): rows n0 +
// g, columns k0 + t, k0 + t + 4
template <int kLd>
__device__ __forceinline__ void load_b_nk(const float* y, int n0, int k0,
                                          int lane, FragB& f) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = y + (n0 + g) * kLd + k0 + t;
  const float v[2] = {p[0], p[4]};
  split(v, f.big, f.small);
}

// B whose k runs along the tile's rows and n along its columns (e.g. K in
// dQ = dS K), k in acc_to_a's order: rows k0 + 2t, k0 + 2t + 1, column
// n0 + g
template <int kLd>
__device__ __forceinline__ void load_b_kn(const float* y, int k0, int n0,
                                          int lane, FragB& f) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = y + (k0 + 2 * t) * kLd + n0 + g;
  const float v[2] = {p[0], p[kLd]};
  split(v, f.big, f.small);
}

// An accumulator block (16 rows x 8 columns) as the A fragment of a
// product that reduces over those 8 columns (k = t, t + 4 taking columns
// 2t, 2t + 1)
__device__ __forceinline__ void acc_to_a(const float (&c)[4], FragA& f) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  split(v, f.big, f.small);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// d += small(a) big(b) + big(a) small(b), and db += big(a) big(b): the
// small terms in an accumulator of their own, ~2^-11 of the big one, so
// that a long reduction's big chain takes one MMA a k8 step (the S and dP
// products over the head)
__device__ __forceinline__ void mma_3xtf32_apart(float (&db)[4],
                                                 float (&ds)[4],
                                                 const FragA& a,
                                                 const FragB& b) {
  mma_tf32(ds, a.small, b.big);
  mma_tf32(ds, a.big, b.small);
  mma_tf32(db, a.big, b.big);
}

// Short chains. The tensor cores round each MMA's f32 sum toward zero, so
// a long chain of MMAs into one accumulator drifts toward zero by about
// an ulp an MMA (1e-5 of the largest gradient after 384, a reduction over
// 1024 keys). The kernels run one streamed tile's k8 steps (at most 4, 12
// MMAs) into a fresh accumulator and add it to the running sum with f32
// adds, which round to nearest: the drift of each chain has the sign of
// its partial sum and no longer piles up.
__device__ __forceinline__ void add4(float (&d)[4], const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += x[e];
}

// Rows [row0, row0 + kRows) x columns [0, kCols) of a strided f32 source
// into a [kRows][kLd] tile; rows at or past `limit` and columns at or past
// dh become zeros (columns [kCols, kLd) are never read). `vec`: 16-byte
// cp.async (dh a multiple of 4, rows 16-byte aligned); else 4-byte ones.
// The loops stay rolled: unrolled, their addresses took the registers the
// backward passes need (ptxas spilled).
template <int kRows, int kCols, int kLd, int kThreads>
__device__ __forceinline__ void copy_tile_f32(float* dst, const float* src,
                                              long long rstride, int row0,
                                              int limit, int dh, bool vec) {
  const uint32_t base = smem_addr(dst);
  if (vec) {
    constexpr int kChunks = kCols / 4;
#pragma unroll 1
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = 4 * (i % kChunks);
      const bool ok = row0 + r < limit && c < dh;
      cp_async16(base + 4 * (r * kLd + c),
                 src + (ok ? (long long)(row0 + r) * rstride + c : 0),
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const bool ok = row0 + r < limit && c < dh;
      cp_async4(base + 4 * (r * kLd + c),
                src + (ok ? (long long)(row0 + r) * rstride + c : 0), ok);
    }
  }
}

// Columns c, c + 1 of an f32 output row
__device__ __forceinline__ void store_pair_f32(float* row, int c, int dh,
                                               float x0, float x1, bool vec) {
  if (vec) {
    if (c < dh) *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
  } else {
    if (c < dh) row[c] = x0;
    if (c + 1 < dh) row[c + 1] = x1;
  }
}

}  // namespace pt_tf32
