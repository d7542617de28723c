// Attention backward for Hopper (sm_90a), with an optional in-kernel
// causal mask and the forward's dropout mask regenerated in-kernel.
//
// One kernel family replaces the TPU's backward kernels
// (paddle_tpu/parallel/flash_attention.py), one per route of
// `attention_route` in parallel/flash_attention.py:
//   small  `_dqdkv_small_kernel` (:861), 8 <= tq, tk <= 512: passes A, B;
//   kblock `_dqdkv_kb_kernel` (:1028), 512 < tk <= 1024: passes A, B;
//   bhtd   `_dkv_kernel` (:233): pass A, and `_dq_kernel` (:181): pass B.
// From the forward's saved (out, lse) it computes, per (batch, head):
//   delta = rowsum(dout o out) - g_lse                   (the pre-pass)
//   s   = scale * q k^T + bias (-inf where causal and key > row)
//   p   = exp(s - lse)                                   (undropped)
//   dp  = (dout v^T) o M,         M = the forward's scaled keep mask
//   ds  = p o (dp - delta) * scale
//   dq  = ds k,   dk = ds^T q,   dv = (p o M)^T dout
// g_lse, the cotangent of the lse output (BHTD `flash_attention_bwd`),
// is optional: d lse / d s = p, so it folds into delta. Every tensor
// (q, k, v, out, dout, lse, g_lse, dq, dk, dv) is addressed through
// (batch, time, head) element strides with a contiguous head dim, so BTHD
// and BHTD tensors run with no copy; delta is the wrapper's contiguous
// [b, tq, h] f32 scratch; the optional f32 bias is addressed through
// element strides as in the forward. On the small route the caller folds
// causal attention into the bias; on the other two the kernels mask it.
// tk has no bound, and every offset that can pass 2^31 is 64-bit.
//
// What bounds it on the H100: 10*b*h*tq*tk*dh FLOP (5 matrix products;
// under the causal mask only the live scores count) over the bytes of q,
// k, v, dout, out, lse, dq, dk, dv and the bias: operations at every
// shape of the repo's paths. This version runs them on the f32 CUDA
// cores from shared memory, not on the tensor cores.
//
// What the design does: the TPU kernels accumulate dk and dv in scratch
// across their sequential grid steps; blocks on a GPU run in no order, so
// the work is split into two deterministic passes (no atomics, so a run's
// gradients are bit-reproducible):
//   pass A, one block per (64-key tile, head, batch): K and V of the tile
//     stay in shared memory while the block walks every 32-row query
//     tile, recomputing s and dp there; dk and dv accumulate in
//     registers and are written once;
//   pass B, one block per (32-row query tile, head, batch): Q and dout
//     stay in shared memory while the block walks every 64-key tile,
//     recomputing s and dp; dq accumulates in registers.
// Under the causal mask both passes skip the (query tile, key tile) pairs
// with no live score through the forward's own test (causal_tile_live):
// pass B stops after its last live key tile, pass A starts at the first
// query tile that reaches its keys. Recomputing s and dp in pass B costs
// two matrix products more than a fused kernel (7 instead of 5) and buys
// the absence of atomics. The keep mask is a hash of absolute (batch,
// head, row, column) (attention_common.cuh), so both passes regenerate
// exactly the forward's bits. All arithmetic is f32 on CUDA cores from
// shared memory; tensor cores (wgmma) and TMA are left to a later version.

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
constexpr int kThreadsDelta = 256;
constexpr int kDeltaLanes = 8;  // threads that share one delta row
constexpr int kMaxDh = 128;

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float *bias, *lse, *g_lse;
  float* delta;
  void *dq, *dk, *dv;
  int tq, tk, nh, dh;
  // (batch, time, head) element strides
  long long qs[3], ks[3], vs[3], os[3], dos[3], ls[3], gls[3], dqs[3],
      dks[3], dvs[3];
  long long sb, sh, sq;  // bias strides over (batch, head, query row)
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

// The pre-pass: delta[b, t, h] = sum_d dout * out - g_lse, f32, with
// kDeltaLanes neighbouring threads on neighbouring elements of one row.
template <typename T>
__global__ void __launch_bounds__(kThreadsDelta) bwd_delta_kernel(Args a,
                                                                  int b) {
  const long long rows = (long long)b * a.tq * a.nh;
  const long long row =
      ((long long)blockIdx.x * kThreadsDelta + threadIdx.x) / kDeltaLanes;
  const int lane = threadIdx.x % kDeltaLanes;
  float acc = 0.f;
  int hh = 0, qr = 0, bb = 0;
  if (row < rows) {
    hh = (int)(row % a.nh);
    const long long bt = row / a.nh;
    qr = (int)(bt % a.tq);
    bb = (int)(bt / a.tq);
    const T* o = static_cast<const T*>(a.out) + bb * a.os[0] +
                 qr * a.os[1] + hh * a.os[2];
    const T* g = static_cast<const T*>(a.dout) + bb * a.dos[0] +
                 qr * a.dos[1] + hh * a.dos[2];
    for (int d = lane; d < a.dh; d += kDeltaLanes)
      acc = fmaf(to_f32(g[d]), to_f32(o[d]), acc);
  }
#pragma unroll
  for (int off = 1; off < kDeltaLanes; off *= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) {
    if (a.g_lse != nullptr)
      acc -= a.g_lse[bb * a.gls[0] + qr * a.gls[1] + hh * a.gls[2]];
    a.delta[row] = acc;  // contiguous [b, tq, h]
  }
}

// Pass A: dk and dv of one 64-key tile.
template <typename T, int kDhMax, bool kDrop, bool kCausal>
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
  const T* qb = static_cast<const T*>(a.q) + bb * a.qs[0] + hh * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + bb * a.ks[0] + hh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + bb * a.vs[0] + hh * a.vs[2];
  const T* dob =
      static_cast<const T*>(a.dout) + bb * a.dos[0] + hh * a.dos[2];
  const float* lsb = a.lse + bb * a.ls[0] + hh * a.ls[2];
  const float* dlb = a.delta + (long long)bb * tq * nh + hh;
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;
  const int bh = bb * nh + hh;

  load_tile<kThreadsA>(Ks, ks, kb, a.ks[1], k0, kBK, tk, dh);
  load_tile<kThreadsA>(Vs, ks, vb, a.vs[1], k0, kBK, tk, dh);

  // score micro-tile: rows 2*rg, 2*rg+1; keys 4*cg .. 4*cg+3
  const int rg = tid / 16, cg = tid % 16;
  // accumulator mapping: key row kr, columns c + 4*j
  const int kr = tid / 4, c = tid % 4;
  constexpr int kDPerThread = kDhMax / 4;
  float acc_k[kDPerThread], acc_v[kDPerThread];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int q0 = 0; q0 < tq; q0 += kBQ) {
    // causal: query tiles before the first that reaches k0 are dead
    if (kCausal && !causal_tile_live(q0, kBQ, tq, k0)) continue;
    __syncthreads();  // previous tile's Qs/dOs/Ps/dSs reads are done
    load_tile<kThreadsA>(Qs, dh, qb, a.qs[1], q0, kBQ, tq, dh);
    load_tile<kThreadsA>(dOs, dh, dob, a.dos[1], q0, kBQ, tq, dh);
    if (tid < kBQ) {
      const int qr = q0 + tid;
      Ls[tid] = qr < tq ? lsb[qr * a.ls[1]] : 0.f;
      Ds[tid] = qr < tq ? dlb[(long long)qr * nh] : 0.f;
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
        if (qr < tq && key < tk && (!kCausal || key <= qr)) {
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
    T* dkr = static_cast<T*>(a.dk) + bb * a.dks[0] + key * a.dks[1] +
             hh * a.dks[2];
    T* dvr = static_cast<T*>(a.dv) + bb * a.dvs[0] + key * a.dvs[1] +
             hh * a.dvs[2];
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
template <typename T, int kDhMax, bool kDrop, bool kCausal>
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
  const T* qb = static_cast<const T*>(a.q) + bb * a.qs[0] + hh * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + bb * a.ks[0] + hh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + bb * a.vs[0] + hh * a.vs[2];
  const T* dob =
      static_cast<const T*>(a.dout) + bb * a.dos[0] + hh * a.dos[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;

  load_tile<kThreadsB>(Qs, dh, qb, a.qs[1], q0, kBQ, tq, dh);
  load_tile<kThreadsB>(dOs, dh, dob, a.dos[1], q0, kBQ, tq, dh);
  if (tid < kBQ) {
    const int qr = q0 + tid;
    Ls[tid] = qr < tq ? a.lse[bb * a.ls[0] + qr * a.ls[1] + hh * a.ls[2]]
                      : 0.f;
    Ds[tid] = qr < tq ? a.delta[((long long)bb * tq + qr) * nh + hh] : 0.f;
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
    // causal: every later key tile is dead for this query tile
    if (kCausal && !causal_tile_live(q0, kBQ, tq, k0)) break;
    __syncthreads();  // previous tile's Ks/Vs/dSs reads are done
    load_tile<kThreadsB>(Ks, ks, kb, a.ks[1], k0, kBK, tk, dh);
    load_tile<kThreadsB>(Vs, ks, vb, a.vs[1], k0, kBK, tk, dh);
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
        if (qr < tq && key < tk && (!kCausal || key <= qr)) {
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
    T* dqr = static_cast<T*>(a.dq) + bb * a.dqs[0] + qr * a.dqs[1] +
             hh * a.dqs[2];
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int d = c + 4 * j;
      if (d < dh) dqr[d] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int kDhMax, bool kDrop, bool kCausal>
cudaError_t launch_cfg(const Args& a, int b, int passes,
                       cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    const size_t sa = smem_a(a.dh);
    err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, kDhMax, kDrop, kCausal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sa);
    if (err != cudaSuccess) return err;
    dim3 grid_a((a.tk + kBK - 1) / kBK, a.nh, b);
    bwd_dkdv_kernel<T, kDhMax, kDrop, kCausal>
        <<<grid_a, kThreadsA, sa, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    const size_t sbytes = smem_b(a.dh);
    err = cudaFuncSetAttribute(bwd_dq_kernel<T, kDhMax, kDrop, kCausal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sbytes);
    if (err != cudaSuccess) return err;
    dim3 grid_b((a.tq + kBQ - 1) / kBQ, a.nh, b);
    bwd_dq_kernel<T, kDhMax, kDrop, kCausal>
        <<<grid_b, kThreadsB, sbytes, stream>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T, int kDhMax, bool kDrop>
cudaError_t launch_causal(const Args& a, int b, bool causal, int passes,
                          cudaStream_t stream) {
  return causal ? launch_cfg<T, kDhMax, kDrop, true>(a, b, passes, stream)
                : launch_cfg<T, kDhMax, kDrop, false>(a, b, passes, stream);
}

template <typename T, int kDhMax>
cudaError_t launch_drop(const Args& a, int b, bool drop, bool causal,
                        int passes, cudaStream_t stream) {
  return drop ? launch_causal<T, kDhMax, true>(a, b, causal, passes, stream)
              : launch_causal<T, kDhMax, false>(a, b, causal, passes,
                                                stream);
}

template <typename T>
cudaError_t launch(const Args& a, int b, bool drop, bool causal, int passes,
                   cudaStream_t stream) {
  const long long lanes = (long long)b * a.tq * a.nh * kDeltaLanes;
  const long long blocks = (lanes + kThreadsDelta - 1) / kThreadsDelta;
  bwd_delta_kernel<T><<<(unsigned int)blocks, kThreadsDelta, 0, stream>>>(
      a, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return a.dh <= 64
             ? launch_drop<T, 64>(a, b, drop, causal, passes, stream)
             : launch_drop<T, kMaxDh>(a, b, drop, causal, passes, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). Pointers are device pointers;
// `bias` and `g_lse` may be null. `strides` (host memory) holds 30
// element strides: (batch, time, head) of q, k, v, out, dout, lse, g_lse,
// dq, dk, dv, in that order; the head dim of q, k, v, out, dout, dq, dk,
// dv is contiguous. `delta` is scratch for a contiguous [b, tq, h] f32
// array. With `causal`, keys past the query row are masked in-kernel.
// `passes`: bit 1 runs pass A (dk, dv), bit 2 pass B (dq); the delta
// pre-pass always runs. The dropout arguments are the forward's.
// `stream` is a cudaStream_t.
int pt_flash_attention_bthd_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, const void* g_lse,
    void* delta, void* dq, void* dk, void* dv, int b, int tq, int tk, int h,
    int dh, const long long* strides, long long sb, long long sh,
    long long sq, float scale, int is_bf16, int causal, int use_dropout,
    unsigned int drop_key, unsigned int drop_thresh, float keep_scale,
    int passes, void* stream) {
  if (dh < 1 || dh > kMaxDh || tq < 1 || tk < 1 || b < 1 || h < 1 ||
      b > 65535 || h > 65535 || passes < 0 || passes > 3)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.g_lse = static_cast<const float*>(g_lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.tq = tq;
  a.tk = tk;
  a.nh = h;
  a.dh = dh;
  long long* dst[10] = {a.qs,  a.ks,  a.vs,  a.os,  a.dos,
                        a.ls,  a.gls, a.dqs, a.dks, a.dvs};
  for (int t = 0; t < 10; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.sb = sb;
  a.sh = sh;
  a.sq = sq;
  a.scale = scale;
  a.drop = pt_attn::Dropout{drop_key, drop_thresh, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = use_dropout != 0, cz = causal != 0;
  cudaError_t err = is_bf16
                        ? launch<__nv_bfloat16>(a, b, drop, cz, passes, s)
                        : launch<float>(a, b, drop, cz, passes, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
