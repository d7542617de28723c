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
// m starts at the lowest finite f32, l and acc at 0.
//
// What bounds it on the H100: operations, 4 * b * h * t^2 * dh FLOP (8.6
// GFLOP at b 64, h 8, t 256, dh 64: 0.0087 ms at the bf16 tensor-core
// peak) over 4 * b * h * t * dh * 2 bytes (0.020 ms), so at the
// benchmark's shapes the bytes are the larger bound by a small factor and
// both are far below what this version reads.
//
// What the design does about it: the structure of
// flash_attention_bthd_fwd.cu. One block per (32-row query tile, head,
// batch), in place of the TPU kernel's sequential (batch, key block) grid
// with all heads and rows in one step; K and V stream through shared
// memory in 64-key tiles; the scores of one `bk` block ([32, bk] f32) stay
// in shared memory, so the row maximum of a whole block is known before
// any exponential, as in the TPU kernel, and no score reaches device
// memory; the running max, sum and the [32, dh] output tile stay in
// registers. The variant is a template parameter, so each compiles to
// the kernel without the others' arithmetic, which is what the ablation
// measures. Arithmetic runs in f32 on the CUDA cores from shared memory;
// tensor cores, TMA and warp specialisation are left to a later version.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;
typedef __nv_bfloat16 bf16;

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxDh = 128;
constexpr int kMaxBk = 512;    // keys per softmax block

enum Variant { kFloor = 0, kFull = 1, kNoRowmax = 2, kBf16Exp = 3 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

size_t smem_bytes(int dh, int bk) {
  // Qs [BQ][dh], Ks [BK][dh+1], Vs [BK][dh], Ss [BQ][bk+1], all f32
  return sizeof(float) *
         (size_t)(kBQ * dh + kBK * (dh + 1) + kBK * dh + kBQ * (bk + 1));
}

template <int kVariant, int kDhMax>
__global__ void __launch_bounds__(kThreads) attn_ablate_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int nh, int t, int dh,
    int bk, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][dh]
  float* Ks = Qs + kBQ * dh;        // [kBK][dh + 1]
  float* Vs = Ks + kBK * (dh + 1);  // [kBK][dh]
  float* Ss = Vs + kBK * dh;        // [kBQ][bk + 1]
  const int ks = dh + 1, ss = bk + 1;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const long long base =
      ((long long)blockIdx.z * nh + blockIdx.y) * (long long)t * dh;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  load_tile<kThreads>(Qs, dh, qb, dh, q0, kBQ, t, dh);

  // Score micro-tile: rows 4*rg .. 4*rg+3, keys 4*cg .. 4*cg+3.
  const int rg = tid / 16, cg = tid % 16;
  // Softmax / output mapping: row r, columns c + 4*j (4 threads a row, all
  // in one warp).
  const int r = tid / 4, c = tid % 4;
  constexpr int kDPerThread = kDhMax / 4;
  float acc[kDPerThread];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) acc[j] = 0.f;
  float m_run = -FLT_MAX, l_run = 0.f;

  for (int b0 = 0; b0 < t; b0 += bk) {
    // the scores of this key block -> Ss
    for (int k0 = 0; k0 < bk; k0 += kBK) {
      __syncthreads();  // earlier reads of Ks (and of Ss, Vs) are done
      load_tile<kThreads>(Ks, ks, kb, dh, b0 + k0, kBK, t, dh);
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      for (int d = 0; d < dh; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * dh + d];
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[e] = Ks[(cg * 4 + e) * ks + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = fmaf(qv[i], kv[e], s[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ss[(rg * 4 + i) * ss + k0 + cg * 4 + e] = s[i][e] * scale;
    }
    __syncthreads();

    // the variant's softmax arithmetic on row r; Ss holds bf16(p) after
    float alpha = 1.f;
    if (kVariant == kFloor) {
      for (int i = c; i < bk; i += 4) Ss[r * ss + i] = round_bf16(Ss[r * ss + i]);
    } else if (kVariant == kNoRowmax) {
      float psum = 0.f;
      for (int i = c; i < bk; i += 4) {
        float p = expf(Ss[r * ss + i]);
        psum += p;
        Ss[r * ss + i] = round_bf16(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run += psum;
    } else {
      float tmax = -FLT_MAX;
      for (int i = c; i < bk; i += 4) tmax = fmaxf(tmax, Ss[r * ss + i]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run, tmax);
      float psum = 0.f;
      for (int i = c; i < bk; i += 4) {
        float p;
        if (kVariant == kBf16Exp) {
          p = round_bf16(expf(round_bf16(Ss[r * ss + i] - m_new)));
          psum += p;
        } else {
          p = expf(Ss[r * ss + i] - m_new);
          psum += p;  // l sums the f32 terms
          p = round_bf16(p);
        }
        Ss[r * ss + i] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      alpha = kVariant == kBf16Exp
                  ? round_bf16(expf(round_bf16(m_run - m_new)))
                  : expf(m_run - m_new);
      l_run = l_run * alpha + psum;
      m_run = m_new;
    }
    if (kVariant == kFull || kVariant == kBf16Exp) {
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) acc[j] *= alpha;
    }

    // acc += bf16(p) . v over this key block
    for (int k0 = 0; k0 < bk; k0 += kBK) {
      __syncthreads();  // Ss is whole; earlier reads of Vs are done
      load_tile<kThreads>(Vs, dh, vb, dh, b0 + k0, kBK, t, dh);
      __syncthreads();
#pragma unroll 4
      for (int key = 0; key < kBK; ++key) {
        const float p = Ss[r * ss + k0 + key];
        const float* vrow = Vs + key * dh;
#pragma unroll
        for (int j = 0; j < kDPerThread; ++j) {
          int d = c + 4 * j;
          if (d < dh) acc[j] = fmaf(p, vrow[d], acc[j]);
        }
      }
    }
  }

  const int qr = q0 + r;
  if (qr < t) {
    float inv = 1.f;
    if (kVariant == kFull || kVariant == kBf16Exp) inv = 1.f / l_run;
    if (kVariant == kNoRowmax) inv = 1.f / fmaxf(l_run, 1e-9f);
    bf16* ob = out + base + (long long)qr * dh;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      int d = c + 4 * j;
      if (d < dh) ob[d] = __float2bfloat16(acc[j] * inv);
    }
  }
}

template <int kVariant, int kDhMax>
cudaError_t launch_cfg(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                       int b, int h, int t, int dh, int bk, float scale,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes(dh, bk);
  cudaError_t err = cudaFuncSetAttribute(
      attn_ablate_kernel<kVariant, kDhMax>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kBQ - 1) / kBQ, h, b);
  attn_ablate_kernel<kVariant, kDhMax><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, h, t, dh, bk, scale);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int b, int h, int t, int dh, int bk, float scale,
                   cudaStream_t stream) {
  return dh <= 64 ? launch_cfg<kVariant, 64>(q, k, v, out, b, h, t, dh, bk,
                                             scale, stream)
                  : launch_cfg<kVariant, kMaxDh>(q, k, v, out, b, h, t, dh,
                                                 bk, scale, stream);
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
      h > 65535 || bk < kBK || bk > kMaxBk || bk % kBK || t % bk ||
      variant < 0 || variant > 3)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kFloor:
      err = launch<kFloor>(qp, kp, vp, op, b, h, t, dh, bk, scale, s);
      break;
    case kFull:
      err = launch<kFull>(qp, kp, vp, op, b, h, t, dh, bk, scale, s);
      break;
    case kNoRowmax:
      err = launch<kNoRowmax>(qp, kp, vp, op, b, h, t, dh, bk, scale, s);
      break;
    default:
      err = launch<kBf16Exp>(qp, kp, vp, op, b, h, t, dh, bk, scale, s);
      break;
  }
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
