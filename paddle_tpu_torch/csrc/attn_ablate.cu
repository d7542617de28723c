// Attention-forward ablation kernel for Hopper (sm_90a): the attention
// forward without bias, mask or lse, in four variants that isolate the
// cost of each part of the softmax.
//
// Replaces the TPU kernel of `make_fwd` (inline `kernel`,
// benchmarks/attn_ablate.py:41). q, k, v [b, h, t, dh] bf16, contiguous
// (BHTD) -> out [b, h, t, dh] bf16. Keys are taken in blocks of `bk`; per
// block, with s = (q . k^T) * scale in f32 (products of bf16 values) and
// p rounded to bf16 before it multiplies v, as the TPU kernel casts it:
//   matmul-floor  acc += bf16(s) . v                      out = acc
//   full          m' = max(m, rowmax s); p = exp(s - m'); c = exp(m - m')
//                 l = l * c + rowsum p; acc = acc * c + bf16(p) . v
//                                                         out = acc / l
//   no-rowmax     p = exp(s); l += rowsum p; acc += bf16(p) . v
//                                                out = acc / max(l, 1e-9)
//   bf16-exp      as full, with the exponentials in bf16: p =
//                 bf16(exp(bf16(s - m'))), c = bf16(exp(bf16(m - m'))),
//                 l and acc in f32
// m starts at the lowest finite f32, l and acc at 0. The row max of a
// whole bk block is known before any of its exponentials, and p is
// rounded against it, as in the TPU kernel.
//
// What bounds it on the H100: operations, 4 * b * h * t^2 * dh FLOP (8.6
// GFLOP at b 64, h 8, t 256, dh 64: 0.0087 ms at the bf16 tensor-core
// peak) over 4 * b * h * t * dh * 2 bytes (0.020 ms), so at the
// benchmark's shapes the bytes are the larger bound by a small factor.
//
// What the design does about it: the tensor-core core of the bf16
// attention forward (flash_attention_bthd_fwd.cu, wgmma_common.cuh). A
// block is one warpgroup with 64 query rows, their Q tile in swizzled
// bf16 shared memory; K and V tiles of 64 keys stream through a two-stage
// ring of 16-byte cp.async copies; S = Q K^T and O += bf16(p) V are wgmma
// products with f32 sums, p going from the accumulator into registers as
// the A operand of the second, so no score reaches shared or device
// memory. The variants that need the block's row max (full, bf16-exp)
// sweep each bk block twice: first S alone for the max, then S again for
// the exponentials and P V (1.5x the products of one sweep). Staging the
// block's f32 scores in shared memory instead would take 64 * bk * 4
// bytes (64 KiB at bk 256, 128 KiB at bk 512) beside the tiles and leave
// one block on an SM; the second product costs less than that (PERF.md).
// The variant is a template parameter, so each compiles to the kernel
// without the others' arithmetic, which is what the ablation measures.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

using namespace pt_wgmma;
typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;  // query rows of a block (one warpgroup)
constexpr int kKeys = 64;  // keys of a streamed tile
constexpr int kMaxDh = 128;
constexpr int kMaxBk = 512;  // keys per softmax block

enum Variant { kFloor = 0, kFull = 1, kNoRowmax = 2, kBf16Exp = 3 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float exp_f32(float x) {
  return exp2_approx(x * kLog2e);
}

// Shape of the kernel's shared memory: dh padded to kDhPad.
template <int kDhPad>
struct Shape {
  static constexpr int kTileQ = kRows * kDhPad * 2;
  static constexpr int kTileK = kKeys * kDhPad * 2;
  static constexpr int kStage = 2 * kTileK;  // K, V
  static constexpr int kTiles = kTileQ + kStages * kStage;
  static constexpr int kSmem = kTiles + 1024;  // + alignment of the base
};

template <int kVariant, int kDhPad>
__global__ void __launch_bounds__(kWgThreads) attn_ablate_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int t, int dh,
    int bk, float scale, int vec_rows) {
  using S = Shape<kDhPad>;
  // the variants that round p against the max of a whole key block
  constexpr bool kMax = kVariant == kFull || kVariant == kBf16Exp;
  extern __shared__ char smem_raw[];
  char* Qs = align1024(smem_raw);
  char* ring = Qs + S::kTileQ;

  const int q0 = blockIdx.x * kRows;
  const long long base =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * (long long)t * dh;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = vec_rows != 0;

  // the walk: per key block, (kMax) its tiles with K alone for the max,
  // then its tiles with K and V for p and P V
  const int n_block = bk / kKeys;
  const int per_block = kMax ? 2 * n_block : n_block;
  const int n_stages = t / bk * per_block;
  auto second_of = [&](int it) {
    return !kMax || it % per_block >= n_block;
  };

  zero_shared<kWgThreads>(Qs, S::kTiles);  // columns past dh stay zero
  __syncthreads();
  copy_tile<kRows, kWgThreads>(Qs, qb, dh, q0, t, dh, vec);
  auto load_stage = [&](int it) {
    char* st = ring + (it % kStages) * S::kStage;
    const bool second = second_of(it);
    const int j = it % per_block;
    const int k0 =
        it / per_block * bk + (kMax && second ? j - n_block : j) * kKeys;
    copy_tile<kKeys, kWgThreads>(st, kb, dh, k0, t, dh, vec);
    if (second)
      copy_tile<kKeys, kWgThreads>(st + S::kTileK, vb, dh, k0, t, dh, vec);
  };
  load_stage(0);
  cp_async_commit();

  const int c0 = 2 * (lane & 3);
  const uint32_t q_addr = smem_addr(Qs);
  // per accumulator row (rows 16 * warp + lane / 4, + 8): the running max
  // (as one value of the 4 threads of a row), this thread's part of the
  // row sum, the max of the current block's scores
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  float bmax[2] = {-FLT_MAX, -FLT_MAX};
  float o[kDhPad / 2];
#pragma unroll
  for (int i = 0; i < kDhPad / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_stages; ++it) {
    if (it + 1 < n_stages) load_stage(it + 1);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const bool second = second_of(it);
    const int j = it % per_block;
    const uint32_t k_addr = smem_addr(ring + (it % kStages) * S::kStage);
    float s[32];
    wgmma_fence();
    // every k-step, the zero-padded columns too: a product skipped at run
    // time would make ptxas fence each wgmma of the chain
#pragma unroll
    for (int kk = 0; kk < kDhPad / 16; ++kk)
      wgmma_ss(s, desc_k<kRows>(q_addr, 0, kk),
               desc_k<kKeys>(k_addr, 0, kk), kk);
    wgmma_commit();
    if (kMax && j == n_block) {
      // the block's max is known: rescale the sum and the accumulator
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bmax[i] = fmaxf(bmax[i], __shfl_xor_sync(0xffffffffu, bmax[i], 1));
        bmax[i] = fmaxf(bmax[i], __shfl_xor_sync(0xffffffffu, bmax[i], 2));
        const float m_new = fmaxf(m[i], bmax[i]);
        const float c = kVariant == kBf16Exp
                            ? round_bf16(exp_f32(round_bf16(m[i] - m_new)))
                            : exp_f32(m[i] - m_new);
        l[i] *= c;
#pragma unroll
        for (int n8 = 0; n8 < kDhPad / 8; ++n8) {
          o[4 * n8 + 2 * i] *= c;
          o[4 * n8 + 2 * i + 1] *= c;
        }
        m[i] = m_new;
        bmax[i] = -FLT_MAX;
      }
    }
    wgmma_wait<0>();
    reg_fence(s);

    // element 4*n8 + 2*i + j2 is row q0 + 16 * warp + lane / 4 + 8 * i
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale;
    if (!second) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e / 2) % 2;
        bmax[i] = fmaxf(bmax[i], s[e]);
      }
    } else {
      if (kVariant != kFloor) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e / 2) % 2;
          float p;
          if (kVariant == kNoRowmax) {
            p = exp_f32(s[e]);
            l[i] += p;
          } else if (kVariant == kFull) {
            p = exp_f32(s[e] - m[i]);
            l[i] += p;  // l sums the f32 terms
          } else {
            p = round_bf16(exp_f32(round_bf16(s[e] - m[i])));
            l[i] += p;
          }
          s[e] = p;
        }
      }
      // bf16(p) (matmul-floor: bf16(s)) as the A operand of O += P V
      const uint32_t v_addr = k_addr + S::kTileK;
      uint32_t ap[1][4][4];
      to_a_frags(s, ap);
      reg_fence(ap);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, ap[0][kk], desc_mn<kKeys>(v_addr, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + 16 * warp + lane / 4 + 8 * i;
    if (r >= t) continue;
    float div = 1.f;
    if (kVariant == kFull || kVariant == kBf16Exp) div = l[i];
    if (kVariant == kNoRowmax) div = fmaxf(l[i], 1e-9f);
    bf16* orow = out + base + (long long)r * dh;
#pragma unroll
    for (int n8 = 0; n8 < kDhPad / 8; ++n8) {
      const int e = 4 * n8 + 2 * i;
      store_pair(orow, 8 * n8 + c0, dh, o[e] / div, o[e + 1] / div, vec);
    }
  }
}

template <int kVariant, int kDhPad>
cudaError_t launch_cfg(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                       int b, int h, int t, int dh, int bk, float scale,
                       int vec, cudaStream_t stream) {
  const int smem = Shape<kDhPad>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      attn_ablate_kernel<kVariant, kDhPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kRows - 1) / kRows, h, b);
  attn_ablate_kernel<kVariant, kDhPad><<<grid, kWgThreads, smem, stream>>>(
      q, k, v, out, t, dh, bk, scale, vec);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int b, int h, int t, int dh, int bk, float scale, int vec,
                   cudaStream_t stream) {
  return dh <= 64 ? launch_cfg<kVariant, 64>(q, k, v, out, b, h, t, dh, bk,
                                             scale, vec, stream)
                  : launch_cfg<kVariant, kMaxDh>(q, k, v, out, b, h, t, dh,
                                                 bk, scale, vec, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). q, k, v, out are device pointers
// to contiguous [b, h, t, dh] bf16. `variant`: 0 matmul-floor, 1 full, 2
// no-rowmax, 3 bf16-exp. `bk` (keys per softmax block) is a multiple of
// 64, at most 512, and divides t. `stream` is a cudaStream_t.
int pt_attn_ablate_fwd(const void* q, const void* k, const void* v, void* out,
                       int b, int h, int t, int dh, int bk, int variant,
                       float scale, void* stream) {
  if (b < 1 || h < 1 || t < 1 || dh < 1 || dh > kMaxDh || b > 65535 ||
      h > 65535 || bk < kKeys || bk > kMaxBk || bk % kKeys || t % bk ||
      variant < 0 || variant > 3)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  // 16-byte rows: 16-byte cp.async copies and paired stores
  const int vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kFloor:
      err = launch<kFloor>(qp, kp, vp, op, b, h, t, dh, bk, scale, vec, s);
      break;
    case kFull:
      err = launch<kFull>(qp, kp, vp, op, b, h, t, dh, bk, scale, vec, s);
      break;
    case kNoRowmax:
      err = launch<kNoRowmax>(qp, kp, vp, op, b, h, t, dh, bk, scale, vec, s);
      break;
    default:
      err = launch<kBf16Exp>(qp, kp, vp, op, b, h, t, dh, bk, scale, vec, s);
      break;
  }
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
