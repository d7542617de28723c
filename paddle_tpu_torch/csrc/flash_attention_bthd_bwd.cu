// Attention backward in the BTHD layout, for Hopper (sm_90a), with the
// forward's dropout mask regenerated in-kernel.
//
// Replaces the TPU kernel `_dqdkv_small_kernel`
// (paddle_tpu/parallel/flash_attention.py:861), reached from
// `flash_attention_bthd_bwd` for 8 <= tq, tk <= 512. From the forward's
// saved (out, lse) and delta = rowsum(dout * out) (f32, the wrapper's) it
// computes, per (batch, head):
//   s   = scale * q k^T + bias,   p = exp(s - lse)      (undropped)
//   dp  = (dout v^T) o M,         M = the forward's scaled keep mask
//   ds  = p o (dp - delta) * scale
//   dq  = ds k,   dk = ds^T q,   dv = (p o M)^T dout
// with dq, dk, dv written contiguous [b, t, h, dh] in q's dtype. q/k/v
// take the forward's strides (views of a fused QKV projection), dout is
// contiguous, lse and delta are contiguous [b, tq, h] f32, and the
// optional f32 bias is addressed through element strides as in the
// forward. Causal attention reaches the kernel folded into the bias.
//
// What bounds it on the H100: 10*b*h*tq*tk*dh FLOP (5 matrix products)
// over the bytes of q, k, v, dout, out, lse, delta, dq, dk, dv and the
// bias. At the training shape (b=64, t=256, h=8, dh=64, bf16) that is
// 21.5 GFLOP over ~62 MB: ~0.02 ms on the tensor cores, ~0.32 ms on the
// f32 CUDA cores, which is where this version computes.
//
// What the design does: the TPU kernel accumulates dk and dv in scratch
// across its sequential q-chunk grid steps; blocks on a GPU run in no
// order, so the work is split into two deterministic passes (no atomics,
// so a run's gradients are bit-reproducible):
//   pass A, one block per (64-key tile, head, batch): K and V of the tile
//     stay in shared memory while the block walks every 32-row query
//     tile, recomputing s and dp there; dk and dv accumulate in
//     registers and are written once;
//   pass B, one block per (32-row query tile, head, batch): Q and dout
//     stay in shared memory while the block walks every 64-key tile,
//     recomputing s and dp; dq accumulates in registers.
// Recomputing s and dp in pass B costs two matrix products more than the
// fused TPU kernel (7 instead of 5) and buys the absence of atomics.
// The keep mask is a hash of absolute (batch, head, row, column)
// (attention_common.cuh), so both passes regenerate exactly the
// forward's bits. All arithmetic is f32 on CUDA cores from shared
// memory; tensor cores (wgmma) and TMA are left to a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;

constexpr int kBQ = 32;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kThreadsA = 256;
constexpr int kThreadsB = 128;
constexpr int kMaxDh = 128;

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  void *dq, *dk, *dv;
  int tq, tk, nh, dh;
  long long qsb, qst, ksb, kst, vsb, vst;
  long long sb, sh, sq;
  float scale;
  Dropout drop;
};

size_t smem_a(int dh) {
  // Ks, Vs [BK][dh+1]; Qs, dOs [BQ][dh]; Ps, dSs [BQ][BK+1]; lse, delta
  return sizeof(float) * (size_t)(2 * kBK * (dh + 1) + 2 * kBQ * dh +
                                  2 * kBQ * (kBK + 1) + 2 * kBQ);
}

size_t smem_b(int dh) {
  // Qs, dOs [BQ][dh]; Ks, Vs [BK][dh+1]; dSs [BQ][BK+1]; lse, delta
  return sizeof(float) * (size_t)(2 * kBQ * dh + 2 * kBK * (dh + 1) +
                                  kBQ * (kBK + 1) + 2 * kBQ);
}

// Pass A: dk and dv of one 64-key tile.
template <typename T, int kDhMax, bool kDrop>
__global__ void __launch_bounds__(kThreadsA) bwd_dkdv_kernel(Args a) {
  extern __shared__ float smem[];
  const int dh = a.dh, ks = dh + 1, ss = kBK + 1;
  float* Ks = smem;                 // [kBK][dh + 1]
  float* Vs = Ks + kBK * ks;        // [kBK][dh + 1]
  float* Qs = Vs + kBK * ks;        // [kBQ][dh]
  float* dOs = Qs + kBQ * dh;       // [kBQ][dh]
  float* Ps = dOs + kBQ * dh;       // [kBQ][kBK + 1]  p o M
  float* dSs = Ps + kBQ * ss;       // [kBQ][kBK + 1]  ds
  float* Ls = dSs + kBQ * ss;       // [kBQ]
  float* Ds = Ls + kBQ;             // [kBQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int nh = a.nh, tq = a.tq, tk = a.tk;
  const long long row_stride = (long long)nh * dh;  // dout/dk/dv time stride
  const T* qb = static_cast<const T*>(a.q) + bb * a.qsb + (long long)hh * dh;
  const T* kb = static_cast<const T*>(a.k) + bb * a.ksb + (long long)hh * dh;
  const T* vb = static_cast<const T*>(a.v) + bb * a.vsb + (long long)hh * dh;
  const T* dob = static_cast<const T*>(a.dout) +
                 (long long)bb * tq * row_stride + (long long)hh * dh;
  const float* biasb = a.bias == nullptr
                           ? nullptr
                           : a.bias + bb * a.sb + (long long)hh * a.sh;
  const int bh = bb * nh + hh;

  load_tile<kThreadsA>(Ks, ks, kb, a.kst, k0, kBK, tk, dh);
  load_tile<kThreadsA>(Vs, ks, vb, a.vst, k0, kBK, tk, dh);

  // score micro-tile: rows 2*rg, 2*rg+1; keys 4*cg .. 4*cg+3
  const int rg = tid / 16, cg = tid % 16;
  // accumulator mapping: key row kr, columns c + 4*j
  const int kr = tid / 4, c = tid % 4;
  constexpr int kDPerThread = kDhMax / 4;
  float acc_k[kDPerThread], acc_v[kDPerThread];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int q0 = 0; q0 < tq; q0 += kBQ) {
    __syncthreads();  // previous tile's Qs/dOs/Ps/dSs reads are done
    load_tile<kThreadsA>(Qs, dh, qb, a.qst, q0, kBQ, tq, dh);
    load_tile<kThreadsA>(dOs, dh, dob, row_stride, q0, kBQ, tq, dh);
    if (tid < kBQ) {
      const int qr = q0 + tid;
      const long long i = ((long long)bb * tq + qr) * nh + hh;
      Ls[tid] = qr < tq ? a.lse[i] : 0.f;
      Ds[tid] = qr < tq ? a.delta[i] : 0.f;
    }
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[r][e] = dp[r][e] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[2], dov[2], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qv[r] = Qs[(rg * 2 + r) * dh + d];
        dov[r] = dOs[(rg * 2 + r) * dh + d];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kv[e] = Ks[(cg * 4 + e) * ks + d];
        vv[e] = Vs[(cg * 4 + e) * ks + d];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[r][e] = fmaf(qv[r], kv[e], s[r][e]);
          dp[r][e] = fmaf(dov[r], vv[e], dp[r][e]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 2 + r, qr = q0 + row;
      uint32_t hrow = 0;
      if (kDrop) hrow = drop_row_hash(a.drop.key, bh, qr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + e, key = k0 + col;
        float p = 0.f, pd = 0.f, ds = 0.f;
        if (qr < tq && key < tk) {
          float sv = s[r][e] * a.scale;
          if (biasb != nullptr) sv += biasb[(long long)qr * a.sq + key];
          p = expf(sv - Ls[row]);
          float dpv = dp[r][e];
          pd = p;
          if (kDrop) {
            const float m =
                drop_scale(hrow, key, a.drop.thresh, a.drop.keep_scale);
            pd = p * m;
            dpv *= m;
          }
          ds = p * (dpv - Ds[row]) * a.scale;
        }
        Ps[row * ss + col] = pd;
        dSs[row * ss + col] = ds;
      }
    }
    __syncthreads();

    for (int r = 0; r < kBQ; ++r) {
      const float pdv = Ps[r * ss + kr];
      const float dsv = dSs[r * ss + kr];
      const float* dorow = dOs + r * dh;
      const float* qrow = Qs + r * dh;
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) {
        const int d = c + 4 * j;
        if (d < dh) {
          acc_v[j] = fmaf(pdv, dorow[d], acc_v[j]);
          acc_k[j] = fmaf(dsv, qrow[d], acc_k[j]);
        }
      }
    }
  }

  const int key = k0 + kr;
  if (key < tk) {
    const long long o =
        ((long long)bb * tk + key) * row_stride + (long long)hh * dh;
    T* dkr = static_cast<T*>(a.dk) + o;
    T* dvr = static_cast<T*>(a.dv) + o;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int d = c + 4 * j;
      if (d < dh) {
        dkr[d] = from_f32<T>(acc_k[j]);
        dvr[d] = from_f32<T>(acc_v[j]);
      }
    }
  }
}

// Pass B: dq of one 32-row query tile.
template <typename T, int kDhMax, bool kDrop>
__global__ void __launch_bounds__(kThreadsB) bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int dh = a.dh, ks = dh + 1, ss = kBK + 1;
  float* Qs = smem;                 // [kBQ][dh]
  float* dOs = Qs + kBQ * dh;       // [kBQ][dh]
  float* Ks = dOs + kBQ * dh;       // [kBK][dh + 1]
  float* Vs = Ks + kBK * ks;        // [kBK][dh + 1]
  float* dSs = Vs + kBK * ks;       // [kBQ][kBK + 1]
  float* Ls = dSs + kBQ * ss;       // [kBQ]
  float* Ds = Ls + kBQ;             // [kBQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int nh = a.nh, tq = a.tq, tk = a.tk;
  const long long row_stride = (long long)nh * dh;
  const T* qb = static_cast<const T*>(a.q) + bb * a.qsb + (long long)hh * dh;
  const T* kb = static_cast<const T*>(a.k) + bb * a.ksb + (long long)hh * dh;
  const T* vb = static_cast<const T*>(a.v) + bb * a.vsb + (long long)hh * dh;
  const T* dob = static_cast<const T*>(a.dout) +
                 (long long)bb * tq * row_stride + (long long)hh * dh;
  const float* biasb = a.bias == nullptr
                           ? nullptr
                           : a.bias + bb * a.sb + (long long)hh * a.sh;

  load_tile<kThreadsB>(Qs, dh, qb, a.qst, q0, kBQ, tq, dh);
  load_tile<kThreadsB>(dOs, dh, dob, row_stride, q0, kBQ, tq, dh);
  if (tid < kBQ) {
    const int qr = q0 + tid;
    const long long i = ((long long)bb * tq + qr) * nh + hh;
    Ls[tid] = qr < tq ? a.lse[i] : 0.f;
    Ds[tid] = qr < tq ? a.delta[i] : 0.f;
  }

  // score micro-tile: rows 4*rg .. 4*rg+3, keys 4*cg .. 4*cg+3
  const int rg = tid / 16, cg = tid % 16;
  // accumulator mapping: query row r, columns c + 4*j
  const int r = tid / 4, c = tid % 4;
  constexpr int kDPerThread = kDhMax / 4;
  float acc[kDPerThread];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) acc[j] = 0.f;
  uint32_t hrow[4] = {0, 0, 0, 0};
  if (kDrop) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hrow[i] = drop_row_hash(a.drop.key, bb * nh + hh, q0 + rg * 4 + i);
  }

  for (int k0 = 0; k0 < tk; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/dSs reads are done
    load_tile<kThreadsB>(Ks, ks, kb, a.kst, k0, kBK, tk, dh);
    load_tile<kThreadsB>(Vs, ks, vb, a.vst, k0, kBK, tk, dh);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(rg * 4 + i) * dh + d];
        dov[i] = dOs[(rg * 4 + i) * dh + d];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kv[e] = Ks[(cg * 4 + e) * ks + d];
        vv[e] = Vs[(cg * 4 + e) * ks + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = fmaf(qv[i], kv[e], s[i][e]);
          dp[i][e] = fmaf(dov[i], vv[e], dp[i][e]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i, qr = q0 + row;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + e, key = k0 + col;
        float ds = 0.f;
        if (qr < tq && key < tk) {
          float sv = s[i][e] * a.scale;
          if (biasb != nullptr) sv += biasb[(long long)qr * a.sq + key];
          const float p = expf(sv - Ls[row]);
          float dpv = dp[i][e];
          if (kDrop)
            dpv *= drop_scale(hrow[i], key, a.drop.thresh,
                              a.drop.keep_scale);
          ds = p * (dpv - Ds[row]) * a.scale;
        }
        dSs[row * ss + col] = ds;
      }
    }
    __syncthreads();

    const int nkeys = min(kBK, tk - k0);
    for (int key = 0; key < nkeys; ++key) {
      const float dsv = dSs[r * ss + key];
      const float* krow = Ks + key * ks;
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) {
        const int d = c + 4 * j;
        if (d < dh) acc[j] = fmaf(dsv, krow[d], acc[j]);
      }
    }
  }

  const int qr = q0 + r;
  if (qr < tq) {
    T* dqr = static_cast<T*>(a.dq) +
             ((long long)bb * tq + qr) * row_stride + (long long)hh * dh;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int d = c + 4 * j;
      if (d < dh) dqr[d] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int kDhMax, bool kDrop>
cudaError_t launch_cfg(const Args& a, int b, cudaStream_t stream) {
  const size_t sa = smem_a(a.dh), sbytes = smem_b(a.dh);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, kDhMax, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, kDhMax, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sbytes);
  if (err != cudaSuccess) return err;
  dim3 grid_a((a.tk + kBK - 1) / kBK, a.nh, b);
  bwd_dkdv_kernel<T, kDhMax, kDrop><<<grid_a, kThreadsA, sa, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_b((a.tq + kBQ - 1) / kBQ, a.nh, b);
  bwd_dq_kernel<T, kDhMax, kDrop><<<grid_b, kThreadsB, sbytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kDrop>
cudaError_t launch_drop(const Args& a, int b, cudaStream_t stream) {
  return a.dh <= 64 ? launch_cfg<T, 64, kDrop>(a, b, stream)
                    : launch_cfg<T, kMaxDh, kDrop>(a, b, stream);
}

template <typename T>
cudaError_t launch(const Args& a, int b, bool use_drop, cudaStream_t stream) {
  return use_drop ? launch_drop<T, true>(a, b, stream)
                  : launch_drop<T, false>(a, b, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). Pointers are device pointers;
// `bias` may be null. `strides` (host memory) holds the element strides
// of q, k, v over (batch, time): {q_b, q_t, k_b, k_t, v_b, v_t}; dout,
// dq, dk, dv are contiguous [b, t, h, dh] in q's dtype, lse and delta
// contiguous [b, tq, h] f32. The dropout arguments are the forward's.
// `stream` is a cudaStream_t.
int pt_flash_attention_bthd_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, int b, int tq, int tk, int h, int dh, const long long* strides,
    long long sb, long long sh, long long sq, float scale, int is_bf16,
    int use_dropout, unsigned int drop_key, unsigned int drop_thresh,
    float keep_scale, void* stream) {
  if (dh < 1 || dh > kMaxDh || tq < 1 || tk < 1 || b < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.tq = tq;
  a.tk = tk;
  a.nh = h;
  a.dh = dh;
  a.qsb = strides[0];
  a.qst = strides[1];
  a.ksb = strides[2];
  a.kst = strides[3];
  a.vsb = strides[4];
  a.vst = strides[5];
  a.sb = sb;
  a.sh = sh;
  a.sq = sq;
  a.scale = scale;
  a.drop = pt_attn::Dropout{drop_key, drop_thresh, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, b, use_dropout != 0, s)
                            : launch<float>(a, b, use_dropout != 0, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
