// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention_bthd_fwd.cu, flash_attention_bthd_bwd.cu,
// attn_ablate.cu) and the 1x1-conv backward (conv1x1_bwd.cu) on Hopper
// (sm_90a): 16- and 4-byte cp.async copies
// into shared memory, the wgmma.mma_async products (bf16 x bf16 -> f32)
// with their fences, and the 128-byte-swizzled bf16 tile layout those
// products read through shared-memory matrix descriptors.
//
// A tile of kRows rows is written by copy_tile (16-byte cp.async when the
// rows are 16-byte aligned, else element by element) and read as a
// K-major operand (desc_k: the reduction runs along the tile's columns)
// or an MN-major one (desc_mn: the reduction runs along its rows). A
// product's f32 accumulator becomes the register A operand of the next
// product through to_a_frags, so probabilities never go through shared
// memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt_wgmma {

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;  // ring stages of the streamed tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, asynchronously: the first `bytes` from
// src, zeros after them
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Orders every use of `d` after the preceding wgmma_wait: the compiler
// takes the asm outputs of wgmma as ready the moment wgmma starts.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Pins register A fragments before the wgmma_fence that precedes their
// products, so that no conversion lands between those wgmmas.
template <int kT, int kK>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[kT][kK][4]) {
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(a[t][k][r])::"memory");
}

// 2^x, one MUFU instruction (flushes subnormal results to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 tile of kRows rows x (64 * panels) columns in shared memory, the
// layout wgmma reads with 128-byte swizzling: panels of [kRows][64]
// (kRows * 128 bytes each, 1024-byte aligned), 16-byte chunk c of row r
// at byte ((c ^ r) % 8) * 16 of its 128-byte row. Byte offset of chunk c
// (columns 8c .. 8c + 7) of row r:
template <int kRows>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (kRows * 128) + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// K-major operand (the reduction runs along the tile's columns), rows
// [row0, row0 + 64 or N) of the tile, reduction step kk (columns 16kk ..
// 16kk + 15): 8-row groups 1024 bytes apart, panels kRows * 128 apart.
template <int kRows>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return gmma_desc(tile + (kk >> 2) * (kRows * 128) + row0 * 128 +
                       (kk & 3) * 32,
                   16, 1024);
}
// MN-major operand (the reduction runs along the tile's rows; its columns
// are the product's N), reduction step kk (rows 16kk .. 16kk + 15): the
// 64-column panels kRows * 128 bytes apart, 8-row groups 1024 apart.
template <int kRows>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 2048, kRows * 128, 1024);
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] B[16 x N] for N = 16, 32, 64 (d holds N / 2
// values), both from shared memory; B K-major, A K-major (kTransA = 0) or
// MN-major (kTransA = 1: the 64 rows of A are contiguous, as in a tile
// whose columns are A's rows)
template <int kTransA>
__device__ __forceinline__ void wgmma_acc(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA));
}
template <int kTransA>
__device__ __forceinline__ void wgmma_acc(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA));
}
template <int kTransA>
__device__ __forceinline__ void wgmma_acc(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs),
// B MN-major (its 64 columns contiguous) in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs),
// B MN-major (its 128 columns contiguous) in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator of a 64 x (2 kHalf) product as the register A operand
// of a product that reduces over its 2 kHalf columns: k-step kk takes
// columns 16kk .. 16kk + 15, as mma's A fragment. kT bf16 terms of each
// value: hi = bf16(x) alone, or hi and lo = bf16(x - hi) (16 bits).
template <int kT, int kHalf>
__device__ __forceinline__ void to_a_frags(
    const float (&d)[kHalf], uint32_t (&a)[kT][kHalf / 8][4]) {
  static_assert(kT == 1 || kT == 2, "one or two bf16 terms");
#pragma unroll
  for (int kk = 0; kk < kHalf / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      a[0][kk][r] = bits(hi);
      if constexpr (kT == 2)
        a[1][kk][r] = bits(__floats2bfloat162_rn(x0 - __low2float(hi),
                                                 x1 - __high2float(hi)));
    }
}

// Copies rows [row0, row0 + kRows) x [0, dh) of a strided bf16 source into
// a swizzled tile; rows at or past `limit` become zeros, columns past dh
// are left alone (the kernels zero them once). `vec`: 16-byte cp.async
// (rows 16-byte aligned, dh a multiple of 8); else element by element.
template <int kRows, int kThreads>
__device__ __forceinline__ void copy_tile(char* tile,
                                          const __nv_bfloat16* src,
                                          long long rstride, int row0,
                                          int limit, int dh, bool vec) {
  if (vec) {
    const int nch = dh >> 3;
    const uint32_t base = smem_addr(tile);
    for (int i = threadIdx.x; i < kRows * nch; i += kThreads) {
      const int r = i / nch, c = i - r * nch;
      const bool ok = row0 + r < limit;
      cp_async16(base + swz<kRows>(r, c),
                 src + (ok ? (long long)(row0 + r) * rstride + 8 * c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      __nv_bfloat16 x = __float2bfloat16(0.f);
      if (row0 + r < limit) x = src[(long long)(row0 + r) * rstride + c];
      *reinterpret_cast<__nv_bfloat16*>(tile + swz<kRows>(r, c >> 3) +
                                        2 * (c & 7)) = x;
    }
  }
}


// Rows [row0, row0 + kR) x columns [col0, col0 + kC) of the f32 bias (row
// stride sq) into shared memory at row stride kS (by default kC + 4: rows
// land 4 banks apart); elements past rlimit or climit become zeros (they
// are masked). `vec`: 16-byte copies (bias rows 16-byte aligned); else
// 4-byte ones.
template <int kR, int kC, int kThreads, int kS = kC + 4>
__device__ __forceinline__ void copy_bias_tile(float* dst, const float* src,
                                               long long sq, int row0,
                                               int rlimit, int col0,
                                               int climit, bool vec) {
  if (vec) {
    constexpr int kChunks = kC / 4;
    for (int i = threadIdx.x; i < kR * kChunks; i += kThreads) {
      const int r = i / kChunks, c = 4 * (i % kChunks), col = col0 + c;
      const int n = row0 + r < rlimit ? max(0, min(4, climit - col)) : 0;
      cp_async16(smem_addr(dst + r * kS + c),
                 src + (n > 0 ? (long long)(row0 + r) * sq + col : 0), 4 * n);
    }
  } else {
    for (int i = threadIdx.x; i < kR * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const bool ok = row0 + r < rlimit && col0 + c < climit;
      cp_async4(smem_addr(dst + r * kS + c),
                src + (ok ? (long long)(row0 + r) * sq + col0 + c : 0), ok);
    }
  }
}

template <int kThreads>
__device__ __forceinline__ void zero_shared(char* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Columns c, c + 1 of an output row, from f32 accumulators
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int c, int dh,
                                           float x0, float x1, bool vec) {
  if (vec) {
    if (c < dh)
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < dh) row[c] = __float2bfloat16(x0);
    if (c + 1 < dh) row[c + 1] = __float2bfloat16(x1);
  }
}

__device__ __forceinline__ char* align1024(char* p) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// 16-byte aligned base and (batch, time, head) strides in multiples of
// `per16` elements (the elements in 16 bytes: 8 bf16, 4 f32): every row of
// the tensor starts on 16 bytes
inline bool rows_aligned(const void* p, const long long* s, int per16 = 8) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % per16 == 0 &&
         s[1] % per16 == 0 && s[2] % per16 == 0;
}

}  // namespace pt_wgmma
