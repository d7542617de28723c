// Attention backward for Hopper (sm_90a), with an optional in-kernel
// causal mask and the forward's dropout mask regenerated in-kernel.
//
// Two kernel families replace the TPU's backward kernels
// (paddle_tpu/parallel/flash_attention.py), one pass A and one pass B for
// every route of `attention_route` in parallel/flash_attention.py:
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
// The work is split into two deterministic passes (the TPU kernels carry
// dk and dv in scratch across a sequential grid; blocks on a GPU run in no
// order, and there are no atomics, so a run's gradients are
// bit-reproducible): pass A owns a key tile and walks the query tiles
// (dk, dv); pass B owns a query tile and walks the key tiles (dq). Both
// recompute s and dp, 7 matrix products in all instead of a fused
// kernel's 5. Under the causal mask both skip the (query tile, key tile)
// pairs with no live score through the forward's own test
// (causal_tile_live). The keep mask is a hash of absolute (batch, head,
// row, column) (attention_common.cuh), so both passes regenerate exactly
// the forward's bits.
//
// What bounds it on the H100: pass A does 8 and pass B 6 b*h*dh FLOP per
// live score (4 and 3 products), against the bytes of q, k, v, dout, lse,
// delta, the bias and the outputs: operations at every shape the repo
// runs. (The bf16 kernels run the three products that take P o M or dS
// once per bf16 term: 10 on the tensor cores.)
//
// bf16 inputs (the main path: AMP training) run the tensor-core kernels
// bwd_dkdv_wgmma_kernel (pass A) and bwd_dq_wgmma_kernel (pass B):
//   - every product is a `wgmma.mma_async` (bf16 x bf16 -> f32) on bf16
//     tiles in shared memory, in the 128-byte-swizzled layout the wgmma
//     descriptors read; a head dim that is not a multiple of 64 is padded
//     with zeros there (dh <= 64 as 64, <= 128 as 128, else 256), which
//     adds nothing to any product;
//   - a block writes at most 128 columns of its gradients (the registers
//     of one warpgroup hold no more): at dh 256 each pass runs two blocks
//     per tile (blockIdx.y), which both compute S and dP over the whole
//     head and then take one half of the columns of dk, dv or dq;
//   - pass A: a block holds 64 keys per warpgroup (two warpgroups, 128
//     keys, at dh <= 64; one above) and their K and V for the whole
//     walk; query tiles (64 rows; 32 at dh > 64, for registers) of Q and
//     dout, with their lse and delta, stream through a two-stage ring of
//     16-byte cp.async copies, the next tile in flight while the current
//     one computes. It computes S^T = K Q^T and dP^T = V dout^T with the
//     keys in wgmma's M, so P^T o M and dS^T stay in registers: in bf16
//     they are the register A operand of dV += (P^T o M) dout and dK +=
//     dS^T Q, whose B (Q, dout) is read through transposed (MN-major)
//     descriptors;
//   - pass B: a block of one warpgroup holds 64 query rows with their Q,
//     dout, lse and delta (two blocks share an SM, so one block's
//     exponentials run under the other's products); K and V tiles of 64
//     keys stream through the same kind of ring. S = Q K^T and dP = dout
//     V^T, then dS in registers as the A operand of dQ += dS K, K read
//     through a transposed descriptor;
//   - P o M and dS enter the tensor cores as two bf16 terms each, hi =
//     bf16(x) and lo = bf16(x - hi), 16 bits in all (one bf16 rounding
//     left too little room under the bf16 gradient limit); every sum is
//     f32, and dq, dk, dv are rounded once when written;
//   - a bias that varies by query row (the small route's folded causal
//     mask) streams through the ring beside its tiles;
//   - causal blocks: the grid is one-dimensional with the tile index
//     varying slowest, counted from the heaviest end (pass A: key tile 0,
//     which every query tile reaches; pass B: the last query tile), so the
//     longest blocks start first across all heads and batches; only the
//     tiles that cross the diagonal or the ragged edge are masked;
//   - rows that are not 16-byte aligned (dh not a multiple of 8, or odd
//     strides) are copied element by element into the same ring.
// f32 inputs keep the CUDA-core kernels bwd_dkdv_kernel and bwd_dq_kernel
// (f32 FMAs from shared memory): TF32 products could not hold an f32
// training step to the f32 reference, so the kernel is chosen by dtype.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace pt_attn;
using namespace pt_wgmma;

// f32 (CUDA-core) kernels
constexpr int kBQ = 32;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kThreadsA = 256;
constexpr int kThreadsB = 128;
constexpr int kThreadsDelta = 256;
constexpr int kDeltaLanes = 8;  // threads that share one delta row
constexpr int kMaxDh = 256;

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
  // bf16: every row of q, k, v, dout, dq, dk, dv (of the bias) 16-byte
  // aligned
  int vec, bias_vec;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (wgmma, cp.async)

constexpr int kKeysB = 64;  // pass B: keys per tile

// P o M and dS enter their products as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), each the A operand of its own wgmma into the same f32
// accumulator: x to 16 bits instead of 8. A single bf16 rounding left the
// gradients within 7.4e-3 of the 8e-3 limit against the f32 version.
constexpr int kTerms = 2;

// n f32 values src[(row0 + i) * stride] into shared memory, zeros at or
// past `limit`
template <int kThreads>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int n, int limit) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = row0 + i < limit;
    cp_async4(smem_addr(dst + i),
              src + (ok ? (long long)(row0 + i) * stride : 0), ok);
  }
}

// Pass A shape: dh padded to kDhPad (64, 128 or 256).
template <int kDhPad>
struct PassA {
  static constexpr int kWG = kDhPad <= 64 ? 2 : 1;   // warpgroups
  static constexpr int kKeys = 64 * kWG;              // keys of a block
  static constexpr int kBq = kDhPad <= 64 ? 64 : 32;  // query rows a tile
  static constexpr int kThreads = kWgThreads * kWG;
  // dk and dv columns of a block (at most 128: registers); blockIdx.y
  // picks which of the kHalves
  static constexpr int kOut = kDhPad < 128 ? kDhPad : 128;
  static constexpr int kHalves = kDhPad / kOut;
  static constexpr int kTileKV = kKeys * kDhPad * 2;  // K (or V), bytes
  static constexpr int kTileQ = kBq * kDhPad * 2;     // Q (or dout), bytes
  // a ring stage: Q, dout, then lse and delta [kBq] f32 (1024 bytes)
  static constexpr int kStage = 2 * kTileQ + 1024;
  static constexpr int kTiles = 2 * kTileKV + kStages * kStage;
  // a bias that varies by query row: a [kBq][kKeys + 4] f32 tile a stage
  static constexpr int kBiasStage = kBq * (kKeys + 4) * 4;
  static constexpr int smem(bool bias_rows) {  // + alignment of the base
    return kTiles + (bias_rows ? kStages * kBiasStage : 0) + 1024;
  }
};

// Pass B shape: one warpgroup and 64 query rows a block, so that two
// blocks share an SM and one's exponentials run under the other's
// products (two warpgroups of one block meet at every tile's barriers).
template <int kDhPad>
struct PassB {
  static constexpr int kRows = 64;  // query rows of a block
  static constexpr int kThreads = kWgThreads;
  static constexpr int kOut = kDhPad < 128 ? kDhPad : 128;  // as in PassA
  static constexpr int kHalves = kDhPad / kOut;
  static constexpr int kTileQ = kRows * kDhPad * 2;
  static constexpr int kTileK = kKeysB * kDhPad * 2;
  static constexpr int kStage = 2 * kTileK;  // K, V
  static constexpr int kTiles = 2 * kTileQ + kStages * kStage;
  static constexpr int kBiasStage = kRows * (kKeysB + 4) * 4;
  static constexpr int smem(bool bias_rows) {
    return kTiles + (bias_rows ? kStages * kBiasStage : 0) + 1024;
  }
};


// Pass A on the tensor cores: dk and dv of one key tile.
template <int kDhPad, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(PassA<kDhPad>::kThreads, 1)
    bwd_dkdv_wgmma_kernel(Args a, int b) {
  using P = PassA<kDhPad>;
  constexpr int kBq = P::kBq;
  extern __shared__ char smem_raw[];
  char* Ks = align1024(smem_raw);
  char* Vs = Ks + P::kTileKV;
  char* ring = Vs + P::kTileKV;

  const int nh = a.nh, tq = a.tq, tk = a.tk, dh = a.dh;
  const int nbh = b * nh;
  // the key tile varies slowest: tile 0, the heaviest under the causal
  // mask, starts first in every (batch, head)
  const int tile = blockIdx.x / nbh;
  const int hh = (blockIdx.x - tile * nbh) % nh;
  const int bb = (blockIdx.x - tile * nbh) / nh;
  const int k0 = tile * P::kKeys;
  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
  const int col0 = blockIdx.y * P::kOut;  // first dk, dv column
  const bool vec = a.vec != 0;
  typedef __nv_bfloat16 bf;
  const bf* qb = static_cast<const bf*>(a.q) + bb * a.qs[0] + hh * a.qs[2];
  const bf* kb = static_cast<const bf*>(a.k) + bb * a.ks[0] + hh * a.ks[2];
  const bf* vb = static_cast<const bf*>(a.v) + bb * a.vs[0] + hh * a.vs[2];
  const bf* dob =
      static_cast<const bf*>(a.dout) + bb * a.dos[0] + hh * a.dos[2];
  const float* lsb = a.lse + bb * a.ls[0] + hh * a.ls[2];
  const float* dlb = a.delta + (long long)bb * tq * nh + hh;
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;
  const bool bias_rows = biasb != nullptr && a.sq != 0;
  float* bias_ring = reinterpret_cast<float*>(Ks + P::kTiles);
  const int bh = bb * nh + hh;

  // causal: the first query tile is the one that holds row k0
  const int q_first = kCausal ? (k0 / kBq) * kBq : 0;
  const int n_tiles = q_first < tq ? (tq - q_first + kBq - 1) / kBq : 0;

  zero_shared<P::kThreads>(Ks, P::kTiles);  // columns past dh stay zero
  __syncthreads();
  copy_tile<P::kKeys, P::kThreads>(Ks, kb, a.ks[1], k0, tk, dh, vec);
  copy_tile<P::kKeys, P::kThreads>(Vs, vb, a.vs[1], k0, tk, dh, vec);
  auto load_stage = [&](int it) {
    char* st = ring + (it % kStages) * P::kStage;
    const int q0 = q_first + it * kBq;
    copy_tile<kBq, P::kThreads>(st, qb, a.qs[1], q0, tq, dh, vec);
    copy_tile<kBq, P::kThreads>(st + P::kTileQ, dob, a.dos[1], q0, tq, dh,
                                vec);
    float* ld = reinterpret_cast<float*>(st + 2 * P::kTileQ);
    copy_rows_f32<P::kThreads>(ld, lsb, a.ls[1], q0, kBq, tq);
    copy_rows_f32<P::kThreads>(ld + kBq, dlb, nh, q0, kBq, tq);
    if (bias_rows)
      copy_bias_tile<kBq, P::kKeys, P::kThreads>(
          bias_ring + (it % kStages) * (P::kBiasStage / 4), biasb, a.sq, q0,
          tq, k0, tk, a.bias_vec != 0);
  };
  if (n_tiles > 0) load_stage(0);
  cp_async_commit();

  // accumulator rows (keys) of this thread, and their bias when the bias
  // does not vary by query row
  const int krow[2] = {kw0 + 16 * warp + lane / 4,
                       kw0 + 16 * warp + lane / 4 + 8};
  float bkey[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (biasb != nullptr && !bias_rows && krow[i] < tk)
      bkey[i] = biasb[krow[i]];
  const int c0 = 2 * (lane & 3);
  const float scale = a.scale;
  const uint32_t k_addr = smem_addr(Ks), v_addr = smem_addr(Vs);

  float dk[P::kOut / 2], dv[P::kOut / 2];
#pragma unroll
  for (int i = 0; i < P::kOut / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_stage(it + 1);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const int q0 = q_first + it * kBq;
    const bool live =
        kw0 < tk && (!kCausal || causal_tile_live(q0, kBq, tq, kw0));
    if (live) {
      char* st = ring + (it % kStages) * P::kStage;
      const uint32_t q_addr = smem_addr(st), do_addr = q_addr + P::kTileQ;
      const float* Ls = reinterpret_cast<const float*>(st + 2 * P::kTileQ);
      const float* Ds = Ls + kBq;
      // this stage's bias tile, [query][key - k0]
      const float* Bs = bias_ring + (it % kStages) * (P::kBiasStage / 4);
      float s[kBq / 2], dp[kBq / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDhPad / 16; ++kk)
        if (kk == 0 || 16 * kk < dh)
          wgmma_ss(s, desc_k<P::kKeys>(k_addr, 64 * wg, kk),
                   desc_k<kBq>(q_addr, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kDhPad / 16; ++kk)
        if (kk == 0 || 16 * kk < dh)
          wgmma_ss(dp, desc_k<P::kKeys>(v_addr, 64 * wg, kk),
                   desc_k<kBq>(do_addr, 0, kk), kk);
      wgmma_commit();

      // s^T holds (key, query) pairs: element 4*n8 + 2*i + j is key
      // krow[i], query column 8*n8 + c0 + j. Mask only edge tiles.
      const bool edge = q0 + kBq > tq || kw0 + 64 > tk ||
                        (kCausal && q0 < kw0 + 63);
      wgmma_wait<1>();
      reg_fence(s);
#pragma unroll
      for (int n8 = 0; n8 < kBq / 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n8 + c0 + j, qr = q0 + col;
          const float lq = Ls[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n8 + 2 * i + j, key = krow[i];
            float p = 0.f;
            if (!edge ||
                (qr < tq && key < tk && (!kCausal || key <= qr))) {
              const float bv =
                  bias_rows ? Bs[col * (P::kKeys + 4) + key - k0] : bkey[i];
              p = exp2_approx((fmaf(s[e], scale, bv) - lq) * kLog2e);
            }
            s[e] = p;
          }
        }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int n8 = 0; n8 < kBq / 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n8 + c0 + j;
          const float delta_q = Ds[col];
          uint32_t hrow = 0;
          if (kDrop) hrow = drop_row_hash(a.drop.key, bh, q0 + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n8 + 2 * i + j;
            const float m =
                kDrop ? drop_scale(hrow, krow[i], a.drop.thresh,
                                   a.drop.keep_scale)
                      : 1.f;
            const float p = s[e];
            dp[e] = p * (dp[e] * m - delta_q) * scale;  // ds
            s[e] = p * m;                              // p o M
          }
        }
      uint32_t ap[kTerms][kBq / 16][4], as[kTerms][kBq / 16][4];
      to_a_frags(s, ap);
      to_a_frags(dp, as);
      reg_fence(ap);
      reg_fence(as);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kBq / 16; ++kq)
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
          wgmma_rs(dv, ap[t][kq],
                   desc_mn<kBq>(do_addr + (col0 / 64) * kBq * 128, kq));
#pragma unroll
      for (int kq = 0; kq < kBq / 16; ++kq)
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
          wgmma_rs(dk, as[t][kq],
                   desc_mn<kBq>(q_addr + (col0 / 64) * kBq * 128, kq));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = krow[i];
    if (key >= tk) continue;
    bf* dkr = static_cast<bf*>(a.dk) + bb * a.dks[0] + key * a.dks[1] +
              hh * a.dks[2];
    bf* dvr = static_cast<bf*>(a.dv) + bb * a.dvs[0] + key * a.dvs[1] +
              hh * a.dvs[2];
#pragma unroll
    for (int n8 = 0; n8 < P::kOut / 8; ++n8) {
      const int e = 4 * n8 + 2 * i;
      store_pair(dkr, col0 + 8 * n8 + c0, dh, dk[e], dk[e + 1], vec);
      store_pair(dvr, col0 + 8 * n8 + c0, dh, dv[e], dv[e + 1], vec);
    }
  }
}

// Pass B on the tensor cores: dq of one query tile.
template <int kDhPad, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(PassB<kDhPad>::kThreads, 1)
    bwd_dq_wgmma_kernel(Args a, int b) {
  using P = PassB<kDhPad>;
  extern __shared__ char smem_raw[];
  char* Qs = align1024(smem_raw);
  char* dOs = Qs + P::kTileQ;
  char* ring = dOs + P::kTileQ;

  const int nh = a.nh, tq = a.tq, tk = a.tk, dh = a.dh;
  const int nbh = b * nh;
  const int n_qtiles = (tq + P::kRows - 1) / P::kRows;
  // the query tile varies slowest; under the causal mask the last (the
  // heaviest) starts first
  const int order = blockIdx.x / nbh;
  const int tile = kCausal ? n_qtiles - 1 - order : order;
  const int hh = (blockIdx.x - order * nbh) % nh;
  const int bb = (blockIdx.x - order * nbh) / nh;
  const int q0 = tile * P::kRows;
  const int col0 = blockIdx.y * P::kOut;  // first dq column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = a.vec != 0;
  typedef __nv_bfloat16 bf;
  const bf* qb = static_cast<const bf*>(a.q) + bb * a.qs[0] + hh * a.qs[2];
  const bf* kb = static_cast<const bf*>(a.k) + bb * a.ks[0] + hh * a.ks[2];
  const bf* vb = static_cast<const bf*>(a.v) + bb * a.vs[0] + hh * a.vs[2];
  const bf* dob =
      static_cast<const bf*>(a.dout) + bb * a.dos[0] + hh * a.dos[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;
  const bool bias_rows = biasb != nullptr && a.sq != 0;
  float* bias_ring = reinterpret_cast<float*>(Qs + P::kTiles);

  // causal: key tiles past the block's last row are dead
  int n_tiles = (tk + kKeysB - 1) / kKeysB;
  if (kCausal)
    n_tiles = min(n_tiles, (min(q0 + P::kRows, tq) - 1) / kKeysB + 1);

  zero_shared<P::kThreads>(Qs, P::kTiles);
  __syncthreads();
  copy_tile<P::kRows, P::kThreads>(Qs, qb, a.qs[1], q0, tq, dh, vec);
  copy_tile<P::kRows, P::kThreads>(dOs, dob, a.dos[1], q0, tq, dh, vec);
  auto load_stage = [&](int it) {
    char* st = ring + (it % kStages) * P::kStage;
    const int k0 = it * kKeysB;
    copy_tile<kKeysB, P::kThreads>(st, kb, a.ks[1], k0, tk, dh, vec);
    copy_tile<kKeysB, P::kThreads>(st + P::kTileK, vb, a.vs[1], k0, tk, dh,
                                   vec);
    if (bias_rows)
      copy_bias_tile<P::kRows, kKeysB, P::kThreads>(
          bias_ring + (it % kStages) * (P::kBiasStage / 4), biasb, a.sq, q0,
          tq, k0, tk, a.bias_vec != 0);
  };
  load_stage(0);
  cp_async_commit();

  // accumulator rows (query rows) of this thread
  const int rrow[2] = {q0 + 16 * warp + lane / 4,
                       q0 + 16 * warp + lane / 4 + 8};
  float lrow[2], drow[2];
  uint32_t hrow[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rrow[i];
    lrow[i] = r < tq ? a.lse[bb * a.ls[0] + r * a.ls[1] + hh * a.ls[2]] : 0.f;
    drow[i] = r < tq ? a.delta[((long long)bb * tq + r) * nh + hh] : 0.f;
    if (kDrop) hrow[i] = drop_row_hash(a.drop.key, bb * nh + hh, r);
  }
  const int c0 = 2 * (lane & 3);
  const float scale = a.scale;
  const uint32_t q_addr = smem_addr(Qs), do_addr = smem_addr(dOs);

  float dq[P::kOut / 2];
#pragma unroll
  for (int i = 0; i < P::kOut / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    // every tile of the walk holds a live score (n_tiles stops there)
    const int k0 = it * kKeysB;
    const uint32_t k_addr = smem_addr(ring + (it % kStages) * P::kStage);
    const uint32_t v_addr = k_addr + P::kTileK;
    // this stage's bias tile, [row - q0][key - k0]
    const float* Bs = bias_ring + (it % kStages) * (P::kBiasStage / 4);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDhPad / 16; ++kk)
      if (kk == 0 || 16 * kk < dh)
        wgmma_ss(s, desc_k<P::kRows>(q_addr, 0, kk),
                 desc_k<kKeysB>(k_addr, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kDhPad / 16; ++kk)
      if (kk == 0 || 16 * kk < dh)
        wgmma_ss(dp, desc_k<P::kRows>(do_addr, 0, kk),
                 desc_k<kKeysB>(v_addr, 0, kk), kk);
    wgmma_commit();

    // element 4*n8 + 2*i + j is row rrow[i], key k0 + 8*n8 + c0 + j
    const bool edge = q0 + P::kRows > tq || k0 + kKeysB > tk ||
                      (kCausal && k0 + kKeysB - 1 > q0);
    wgmma_wait<1>();
    reg_fence(s);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * n8 + c0 + j;
        const float bkey =
            biasb != nullptr && !bias_rows && key < tk ? biasb[key] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n8 + 2 * i + j, r = rrow[i];
          float p = 0.f;
          if (!edge || (r < tq && key < tk && (!kCausal || key <= r))) {
            const float bv =
                bias_rows ? Bs[(r - q0) * (kKeysB + 4) + key - k0] : bkey;
            p = exp2_approx((fmaf(s[e], scale, bv) - lrow[i]) * kLog2e);
          }
          s[e] = p;
        }
      }
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * n8 + c0 + j;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n8 + 2 * i + j;
          const float m =
              kDrop ? drop_scale(hrow[i], key, a.drop.thresh,
                                 a.drop.keep_scale)
                    : 1.f;
          dp[e] = s[e] * (dp[e] * m - drow[i]) * scale;  // ds
        }
      }
    uint32_t as[kTerms][4][4];
    to_a_frags(dp, as);
    reg_fence(as);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        wgmma_rs(dq, as[t][kq],
                 desc_mn<kKeysB>(k_addr + (col0 / 64) * kKeysB * 128, kq));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rrow[i];
    if (r >= tq) continue;
    bf* dqr = static_cast<bf*>(a.dq) + bb * a.dqs[0] + r * a.dqs[1] +
              hh * a.dqs[2];
#pragma unroll
    for (int n8 = 0; n8 < P::kOut / 8; ++n8) {
      const int e = 4 * n8 + 2 * i;
      store_pair(dqr, col0 + 8 * n8 + c0, dh, dq[e], dq[e + 1], vec);
    }
  }
}

// One launch configuration of each family, for the dispatch below.
template <int kDh, bool kDrop, bool kCausal>
struct CudaCoreF32 {
  static cudaError_t run(const Args& a, int b, int passes,
                         cudaStream_t stream) {
    cudaError_t err = cudaSuccess;
    if (passes & 1) {
      const size_t sa = smem_a(a.dh);
      err = cudaFuncSetAttribute(bwd_dkdv_kernel<float, kDh, kDrop, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sa);
      if (err != cudaSuccess) return err;
      dim3 grid_a((a.tk + kBK - 1) / kBK, a.nh, b);
      bwd_dkdv_kernel<float, kDh, kDrop, kCausal>
          <<<grid_a, kThreadsA, sa, stream>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (passes & 2) {
      const size_t sbytes = smem_b(a.dh);
      err = cudaFuncSetAttribute(bwd_dq_kernel<float, kDh, kDrop, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sbytes);
      if (err != cudaSuccess) return err;
      dim3 grid_b((a.tq + kBQ - 1) / kBQ, a.nh, b);
      bwd_dq_kernel<float, kDh, kDrop, kCausal>
          <<<grid_b, kThreadsB, sbytes, stream>>>(a);
      err = cudaGetLastError();
    }
    return err;
  }
};

template <int kDh, bool kDrop, bool kCausal>
struct TensorCoreBf16 {
  static cudaError_t run(const Args& a, int b, int passes,
                         cudaStream_t stream) {
    cudaError_t err = cudaSuccess;
    const long long nbh = (long long)b * a.nh;
    const bool bias_rows = a.bias != nullptr && a.sq != 0;
    if (passes & 1) {
      typedef PassA<kDh> P;
      const long long blocks = (a.tk + P::kKeys - 1) / P::kKeys * nbh;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      const int smem = P::smem(bias_rows);
      err = cudaFuncSetAttribute(
          bwd_dkdv_wgmma_kernel<kDh, kDrop, kCausal>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      bwd_dkdv_wgmma_kernel<kDh, kDrop, kCausal>
          <<<dim3((unsigned int)blocks, P::kHalves), P::kThreads, smem,
             stream>>>(a, b);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (passes & 2) {
      typedef PassB<kDh> P;
      const long long blocks = (a.tq + P::kRows - 1) / P::kRows * nbh;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      const int smem = P::smem(bias_rows);
      err = cudaFuncSetAttribute(
          bwd_dq_wgmma_kernel<kDh, kDrop, kCausal>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      bwd_dq_wgmma_kernel<kDh, kDrop, kCausal>
          <<<dim3((unsigned int)blocks, P::kHalves), P::kThreads, smem,
             stream>>>(a, b);
      err = cudaGetLastError();
    }
    return err;
  }
};

template <template <int, bool, bool> class L, int kDh>
cudaError_t dispatch(const Args& a, int b, bool drop, bool causal,
                     int passes, cudaStream_t s) {
  if (drop)
    return causal ? L<kDh, true, true>::run(a, b, passes, s)
                  : L<kDh, true, false>::run(a, b, passes, s);
  return causal ? L<kDh, false, true>::run(a, b, passes, s)
                : L<kDh, false, false>::run(a, b, passes, s);
}

template <typename T>
cudaError_t launch(const Args& a, int b, bool drop, bool causal, int passes,
                   cudaStream_t stream);

template <>
cudaError_t launch<float>(const Args& a, int b, bool drop, bool causal,
                          int passes, cudaStream_t s) {
  if (a.dh <= 64) return dispatch<CudaCoreF32, 64>(a, b, drop, causal, passes, s);
  if (a.dh <= 128)
    return dispatch<CudaCoreF32, 128>(a, b, drop, causal, passes, s);
  return dispatch<CudaCoreF32, kMaxDh>(a, b, drop, causal, passes, s);
}

template <>
cudaError_t launch<__nv_bfloat16>(const Args& a, int b, bool drop,
                                  bool causal, int passes, cudaStream_t s) {
  if (a.dh <= 64)
    return dispatch<TensorCoreBf16, 64>(a, b, drop, causal, passes, s);
  if (a.dh <= 128)
    return dispatch<TensorCoreBf16, 128>(a, b, drop, causal, passes, s);
  return dispatch<TensorCoreBf16, kMaxDh>(a, b, drop, causal, passes, s);
}

template <typename T>
cudaError_t launch_all(const Args& a, int b, bool drop, bool causal,
                       int passes, cudaStream_t stream) {
  const long long lanes = (long long)b * a.tq * a.nh * kDeltaLanes;
  const long long blocks = (lanes + kThreadsDelta - 1) / kThreadsDelta;
  bwd_delta_kernel<T><<<(unsigned int)blocks, kThreadsDelta, 0, stream>>>(
      a, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<T>(a, b, drop, causal, passes, stream);
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
// `stream` is a cudaStream_t. bf16 runs the tensor-core kernels, f32 the
// CUDA-core ones.
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
  a.vec = dh % 8 == 0 && rows_aligned(q, a.qs) && rows_aligned(k, a.ks) &&
          rows_aligned(v, a.vs) && rows_aligned(dout, a.dos) &&
          rows_aligned(dq, a.dqs) && rows_aligned(dk, a.dks) &&
          rows_aligned(dv, a.dvs);
  a.bias_vec = reinterpret_cast<uintptr_t>(bias) % 16 == 0 && sb % 4 == 0 &&
               sh % 4 == 0 && sq % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = use_dropout != 0, cz = causal != 0;
  cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(a, b, drop, cz, passes, s)
              : launch_all<float>(a, b, drop, cz, passes, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
