// Single-pass attention forward for Hopper (sm_90a), with an optional
// in-kernel causal mask and in-kernel dropout (csrc/dropout_mask.cu dumps
// its dropout mask).
//
// Two kernels, chosen by dtype, replace the TPU's forward kernels
// (paddle_tpu/parallel/flash_attention.py), one per route of
// `attention_route` in parallel/flash_attention.py:
//   small  `_fwd_small_kernel` (:808), 8 <= tq, tk <= 512;
//   kblock `_fwd_kb_kernel` (:964), 512 < tk <= 1024, causal in-kernel;
//   bhtd   `_fwd_kernel` (:126), the BHTD forward (t > 1024, and the
//          decode step over a cache longer than 512), causal in-kernel.
// Both compute, for every (batch, query row, head):
//   s_j  = scale * <q, k_j> + bias[b|1, h|1, q|1, j]     (f32)
//   s_j  = -inf where causal and j > q                   (kCausal)
//   p_j  = exp(s_j - lse),  lse = m + log(l),  m = max_j s_j,
//          l = sum_j exp(s_j - m)                        (f32)
//   out  = sum_j [p_j M_j] v_j                            (q's dtype)
// where M_j is the dropout keep mask scaled by 1/(1 - p_drop) in f32
// (attention_common.cuh), or 1 without dropout, and [x] is x rounded to
// v's dtype: bf16 for bf16 inputs, as every TPU forward casts p before
// its context product. As in the TPU kernels, l and lse are the undropped
// softmax's: the mask multiplies only the terms that feed the output.
// q, k, v, out ([b, t, h, dh] views) and lse ([b, tq, h]) are addressed
// through (batch, time, head) element strides with a contiguous head dim,
// so BTHD tensors, the q/k/v views of a fused QKV projection and BHTD
// tensors all run with no copy; the optional f32 additive bias is
// addressed through element strides too (0 on a broadcast dim). On the
// small route the caller folds causal attention into the bias; on the
// other two the kernels mask it and build no [tq, tk] tensor. tk has no
// bound: K and V stream through shared memory, and every offset that can
// pass 2^31 (t = 8192 and beyond) is computed in 64 bits. No atomics: two
// launches give equal bits.
//
// What bounds it on the H100: 4*b*h*tq*tk*dh FLOP (4*b*h*dh per live key
// under the causal mask) over the bytes of q, k, v, out and lse; at every
// training and prefill shape of the repo the operations dominate, at the
// decode step (tq = 1) the bytes of K and V.
//
// bf16 inputs (the main path: AMP training) run fwd_wgmma_kernel on the
// tensor cores:
//   - a block is one warpgroup with 64 query rows, their Q tile in
//     shared memory in the 128-byte-swizzled bf16 layout that wgmma reads
//     (wgmma_common.cuh); K and V tiles of 64 keys stream through a
//     two-stage ring of 16-byte cp.async copies (rows that are not 16-byte
//     aligned are copied element by element), and a head dim that is not
//     a multiple of 64 is padded with zeros there (dh <= 64 as 64, <= 128
//     as 128, else 256), which adds nothing to any product. At dh 256 the
//     Q tile and the two stages fill 161 KiB (one block an SM) and O takes
//     two n128 products, one on each half of V's columns;
//   - the block sweeps its keys twice. Sweep 1 computes S = Q K^T
//     (wgmma, f32), scale, bias and mask on the accumulator, and the row
//     max and row sum of the undropped exponentials online in registers
//     (4 threads share a row; exponentials through ex2 with log2(e)
//     folded into one FFMA): lse = m + log(l), written with logf. Sweep 2
//     recomputes S, forms p = exp(s - lse) times the keep mask, rounds it
//     to bf16 once, and takes it from registers as the A operand of
//     O += P V (wgmma, V read through a transposed descriptor, f32 sums);
//     out = O is rounded once. A one-sweep online softmax would round
//     exp(s - running max) instead, whose bf16 rounding differs from the
//     normalized p of the plain version and the TPU's reference by an
//     output ulp in about half the outputs, past the 8e-3 limit where
//     |out| >= 2 (tests/test_torch_attention_bf16_fwd.py); the second
//     sweep costs one product of three and gives their rounding;
//   - the work between two barriers is short (a wgmma chain, then the
//     softmax of one tile), so fixed costs a stage weigh: sweep 1, which
//     needs no V, puts a second K tile in the V slot and takes two tiles
//     a stage (PERF.md); a broadcast bias is read
//     into registers before the product and the dropout keep bits are
//     hashed while it runs, so neither waits on the other;
//   - a bias that varies by query row (the small route's folded causal
//     mask, kBiasRows) streams through the ring beside its K tile, one
//     key tile a stage in both sweeps (two would double the tile and
//     read slower);
//   - causal blocks: the grid is one-dimensional with the query tile
//     varying slowest, counted from the last (the heaviest), so the
//     longest blocks start first; tiles past the diagonal are never
//     loaded, and only the diagonal and ragged tiles are masked.
// f32 inputs (the serving prefill and decode step, the f32 training
// rows; their 2e-5 limit rules out TF32 products) stay f32 arithmetic on
// the CUDA cores, in two kernels and a merge, split as the caller plans
// (flash_attention.f32_fwd_plan, a pure function the CPU tests hold):
//   - tq <= 8 (the decode step, tq = 1) runs fwd_decode_kernel, split-KV
//     ("flash-decoding"). The step is bound by the bytes of K and V (16.8
//     MB at b4 h8 tk1024: 5 us), and one block a (batch, head) would leave
//     100 of 132 SMs idle. So the keys of each (batch, head) are split
//     into ranges of 32 or more keys, about four blocks an SM in all; a
//     block copies its whole range of K and V rows into shared memory with
//     16-byte cp.async (all of it in flight at once), walks the keys with
//     its warps (no 32-row query tile with 31 dead rows), and writes its
//     rows' max, sum and unnormalized output;
//   - tq > 8 runs fwd_kernel: a block of 64 query rows walks its keys in
//     tiles of 64 (32 for heads wider than 64) through a two-stage
//     cp.async ring with an online softmax. Both products are register
//     tiles fed by 16-byte shared-memory loads: S = Q K^T (8 rows x 4 keys
//     a thread, Q and K rows read along the head dim, rows padded so 8
//     rows read at one column hit 8 bank groups) and O += P V (P stored
//     transposed, 8 rows of a key a load; 8 rows x 4 columns of O a thread,
//     16 at dh 256 on 4 rows). Where the query tiles leave SMs idle (the
//     b1 t1024 prefill, dh 256 checks) and the mask is not causal, the
//     keys split too;
//   - with more than one split, fwd_merge_kernel combines the splits of
//     each row in their order (out = sum o_s e^(m_s - M) / sum l_s e^(m_s
//     - M), lse = M + log L): no atomics, equal bits from two launches.
// Under the causal mask tiles past the last live key are never loaded.
// The keep mask is a hash of absolute (batch, head, row, column), so the
// backward regenerates it whatever the forward's tiling and split.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace pt_attn;
using namespace pt_wgmma;

constexpr int kMaxDh = 256;

struct FwdArgs {
  const void *q, *k, *v;
  const float* bias;
  void* out;
  float* lse;
  int tq, tk, nh, dh;
  // (batch, time, head) element strides of q, k, v, out, lse
  long long qs[3], ks[3], vs[3], os[3], ls[3];
  long long sb, sh, sq;  // bias strides over (batch, head, query row)
  float scale;
  Dropout drop;
  // every row of q, k, v, out (of the bias) 16-byte aligned, dh a
  // multiple of 8 (bf16) or 4 (f32)
  int vec, bias_vec;
  // f32: keys split over `splits` blocks of `split_keys` keys each; with
  // more than one, the blocks write partials (unnormalized out rows, then
  // (max, sum) pairs) to `part` and fwd_merge_kernel combines them
  int splits, split_keys;
  float* part;
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels

// f32 rows in shared memory: the head dim padded to 4 floats, plus 4 when
// that leaves an even number of 16-byte chunks, so that 8 consecutive
// rows read at one column fall in 8 different bank groups
__host__ __device__ inline int f32_ld(int dh) {
  const int pad = (dh + 3) / 4 * 4;
  return (pad / 4) % 2 ? pad : pad + 4;
}

// Rows [row0, row0 + nrows) x [0, dh) of a strided f32 [t, dh] source into
// shared memory at row stride ld: 16-byte cp.async (vec) or 4-byte ones;
// rows at or past `limit` and columns in [dh, ld) become zeros.
template <int kThr>
__device__ __forceinline__ void copy_rows_f32(float* dst, int ld,
                                              const float* src,
                                              long long rstride, int row0,
                                              int nrows, int limit, int dh,
                                              bool vec) {
  const uint32_t base = smem_addr(dst);
  if (vec) {
    const int nch = ld / 4;
    for (int i = threadIdx.x; i < nrows * nch; i += kThr) {
      const int r = i / nch, c = i - r * nch;
      const bool ok = row0 + r < limit && 4 * c < dh;
      cp_async16(base + 4 * (r * ld + 4 * c),
                 src + (ok ? (long long)(row0 + r) * rstride + 4 * c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ld; i += kThr) {
      const int r = i / ld, c = i - r * ld;
      const bool ok = row0 + r < limit && c < dh;
      cp_async4(base + 4 * i,
                src + (ok ? (long long)(row0 + r) * rstride + c : 0), ok);
    }
  }
}

// The shape of the tiled kernel: 64 query rows a block, kTM a thread
// (rows rg*kTM .. + kTM-1 of row group rg = tid / 16), key tiles of kBK
// keys (keys cg + 16e of the tile for cg = tid % 16, e < kBK / 16), and
// output columns 4(cg + 16u) .. + 3 for u < kDh / 64.
template <int kDh>
struct TiledF32 {
  static constexpr int kBQ = 64;
  static constexpr int kBK = kDh <= 64 ? 64 : 32;
  static constexpr int kTM = kDh <= 128 ? 8 : 4;
  static constexpr int kTN = kBK / 16;
  static constexpr int kTD = kDh / 64;
  static constexpr int kThreads = kBQ / kTM * 16;
  static constexpr int kPt = kBQ + 4;  // row stride of P^T
  static int smem(int dh) {  // Q, two (K, V) stages, P^T
    const int ld = f32_ld(dh);
    return 4 * (kBQ * ld + 2 * 2 * kBK * ld + kBK * kPt);
  }
};

// The softmax statistics and output of rows whose keys were split: block
// `split` of `nbh * tq` rows writes its unnormalized out row and its
// (row max, row sum) pair; fwd_merge_kernel reads them back.
__device__ __forceinline__ float* part_out(const FwdArgs& a, int split,
                                           int bh, int row) {
  const long long nrows = (long long)gridDim.z * a.nh * a.tq;
  return a.part + ((long long)split * nrows + (long long)bh * a.tq + row) *
                      a.dh;
}
__device__ __forceinline__ float* part_ml(const FwdArgs& a, int split,
                                          int bh, int row, long long nrows) {
  return a.part + nrows * a.splits * a.dh +
         2 * ((long long)split * nrows + (long long)bh * a.tq + row);
}

// f32, tq > 8 (the prefills, the f32 training rows): one block per 64
// query rows (and key range, when split), an online softmax over key tiles
// that stream through a two-stage cp.async ring. Both products are
// register-tiled on the CUDA cores with 16-byte shared-memory loads: S =
// Q K^T reads Q and K rows along the head dim (4 dims a load), kTM x kTN
// scores a thread; O += P V reads P^T (kTM rows a load) and V rows.
template <int kDh, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(TiledF32<kDh>::kThreads,
                                  kDh <= 128 ? 2 : 1)
    fwd_kernel(FwdArgs a) {
  using P = TiledF32<kDh>;
  constexpr int kTM = P::kTM, kTN = P::kTN, kTD = P::kTD, kBK = P::kBK;
  constexpr int kBQ = P::kBQ, kThr = P::kThreads;
  extern __shared__ __align__(16) float smem_f[];
  const int tq = a.tq, tk = a.tk, dh = a.dh, nh = a.nh;
  const int ld = f32_ld(dh), dpad = (dh + 3) / 4 * 4;
  float* Qs = smem_f;                        // [kBQ][ld]
  float* ring = Qs + kBQ * ld;               // 2 x ([kBK][ld] K, V)
  float* Pt = ring + 2 * 2 * kBK * ld;       // [kBK][kPt]

  const int n_qt = (tq + kBQ - 1) / kBQ;
  const int xq = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int qt = kCausal ? n_qt - 1 - xq : xq;  // heaviest first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const bool vec = a.vec != 0;
  const float* qb = static_cast<const float*>(a.q) + bb * a.qs[0] +
                    hh * a.qs[2];
  const float* kb = static_cast<const float*>(a.k) + bb * a.ks[0] +
                    hh * a.ks[2];
  const float* vb = static_cast<const float*>(a.v) + bb * a.vs[0] +
                    hh * a.vs[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;

  // this block's keys: its split, cut under the causal mask after the
  // last key that any of its rows sees
  const int k_begin = split * a.split_keys;
  int k_end = min(tk, k_begin + a.split_keys);
  if (kCausal) k_end = min(k_end, min(q0 + kBQ, tq));
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  copy_rows_f32<kThr>(Qs, ld, qb, a.qs[1], q0, kBQ, tq, dh, vec);
  auto load_stage = [&](int it) {
    float* st = ring + (it & 1) * 2 * kBK * ld;
    const int k0 = k_begin + it * kBK;
    copy_rows_f32<kThr>(st, ld, kb, a.ks[1], k0, kBK, k_end, dh, vec);
    copy_rows_f32<kThr>(st + kBK * ld, ld, vb, a.vs[1], k0, kBK, k_end, dh,
                        vec);
  };
  if (n_tiles > 0) load_stage(0);
  cp_async_commit();

  float acc[kTM][kTD][4];
  float m[kTM], l[kTM];
  uint32_t hrow[kTM];
  const uint32_t dkey = kDrop ? pt_attn::stream_key(a.drop) : 0u;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    hrow[i] = kDrop ? drop_row_hash(dkey, bb * nh + hh,
                                    q0 + rg * kTM + i)
                    : 0u;
#pragma unroll
    for (int u = 0; u < kTD; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][u][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage it (and Q) landed for every thread
    const float* Ks = ring + (it & 1) * 2 * kBK * ld;
    const float* Vs = Ks + kBK * ld;
    const int k0 = k_begin + it * kBK;

    // the bias of this thread's scores, read before the product so that
    // the loads overlap it: one value a key (broadcast over rows) or, for
    // a bias that varies by row, one a score
    float bv[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int e = 0; e < kTN; ++e) {
        const int key = k0 + cg + 16 * e, row = q0 + rg * kTM + i;
        bv[i][e] = biasb != nullptr && key < k_end && (a.sq == 0 ? i == 0
                                                                 : row < tq)
                       ? __ldg(biasb + (long long)row * a.sq + key)
                       : 0.f;
      }

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int e = 0; e < kTN; ++e) s[i][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dpad; d += 4) {
      float4 qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg * kTM + i) * ld + d);
#pragma unroll
      for (int e = 0; e < kTN; ++e)
        kv[e] = *reinterpret_cast<const float4*>(Ks + (cg + 16 * e) * ld + d);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int e = 0; e < kTN; ++e) {
          s[i][e] = fmaf(qv[i].x, kv[e].x, s[i][e]);
          s[i][e] = fmaf(qv[i].y, kv[e].y, s[i][e]);
          s[i][e] = fmaf(qv[i].z, kv[e].z, s[i][e]);
          s[i][e] = fmaf(qv[i].w, kv[e].w, s[i][e]);
        }
    }

    // scale, bias, masks; the online softmax of each row over the tile
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + rg * kTM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < kTN; ++e) {
        const int key = k0 + cg + 16 * e;
        float v = -INFINITY;  // ragged tile or future key: zero weight
        if (key < k_end && (!kCausal || key <= row)) {
          v = fmaf(s[i][e], a.scale, a.sq == 0 ? bv[0][e] : bv[i][e]);
        }
        s[i][e] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no live key yet keeps weight 0 and no NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < kTN; ++e) {
        float p = expf(s[i][e] - m_use);
        psum += p;  // l sums the undropped terms
        if (kDrop)
          p *= drop_scale(hrow[i], k0 + cg + 16 * e, a.drop.thresh,
                          a.drop.keep_scale);
        s[i][e] = p;
      }
      l[i] = l[i] * alpha + psum;  // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < kTD; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][u][c] *= alpha;
    }
    // P^T [key][row]: kTM consecutive rows of a key, 16-byte stores
#pragma unroll
    for (int e = 0; e < kTN; ++e)
#pragma unroll
      for (int i4 = 0; i4 < kTM / 4; ++i4)
        *reinterpret_cast<float4*>(Pt + (cg + 16 * e) * P::kPt + rg * kTM +
                                   4 * i4) =
            make_float4(s[4 * i4][e], s[4 * i4 + 1][e], s[4 * i4 + 2][e],
                        s[4 * i4 + 3][e]);
    __syncthreads();

    const int nkeys = min(kBK, k_end - k0);
#pragma unroll 4
    for (int j = 0; j < nkeys; ++j) {
      float pv[kTM];
#pragma unroll
      for (int i4 = 0; i4 < kTM / 4; ++i4) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            Pt + j * P::kPt + rg * kTM + 4 * i4);
        pv[4 * i4] = p4.x;
        pv[4 * i4 + 1] = p4.y;
        pv[4 * i4 + 2] = p4.z;
        pv[4 * i4 + 3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < kTD; ++u) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(Vs + j * ld + 4 * (cg + 16 * u));
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          acc[i][u][0] = fmaf(pv[i], v4.x, acc[i][u][0]);
          acc[i][u][1] = fmaf(pv[i], v4.y, acc[i][u][1]);
          acc[i][u][2] = fmaf(pv[i], v4.z, acc[i][u][2]);
          acc[i][u][3] = fmaf(pv[i], v4.w, acc[i][u][3]);
        }
      }
    }
    __syncthreads();  // Pt and the stage are rewritten next iteration
  }
  cp_async_wait<0>();

  const long long nrows = (long long)gridDim.z * nh * tq;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + rg * kTM + i;
    if (row >= tq) continue;
    float* orow;
    float inv;
    if (a.splits == 1) {
      orow = static_cast<float*>(a.out) + bb * a.os[0] + row * a.os[1] +
             hh * a.os[2];
      inv = 1.f / l[i];
      if (cg == 0)
        a.lse[bb * a.ls[0] + row * a.ls[1] + hh * a.ls[2]] = m[i] + logf(l[i]);
    } else {
      orow = part_out(a, split, bb * nh + hh, row);
      inv = 1.f;
      if (cg == 0) {
        float* ml = part_ml(a, split, bb * nh + hh, row, nrows);
        ml[0] = m[i];
        ml[1] = l[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kTD; ++u) {
      const int d = 4 * (cg + 16 * u);
      if (vec && a.splits == 1 && d < dh) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][u][0] * inv, acc[i][u][1] * inv,
                        acc[i][u][2] * inv, acc[i][u][3] * inv);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (d + c < dh) orow[d + c] = acc[i][u][c] * inv;
      }
    }
  }
}

// The decode kernel's shape: up to 8 query rows (tq <= 8) a block, 128
// threads; a key row is read by kG lanes, kV 16-byte chunks each.
constexpr int kDecRows = 8;
constexpr int kDecThreads = 128;
template <int kDh>
struct DecodeF32 {
  static constexpr int kG = kDh / 4 < 32 ? kDh / 4 : 32;  // lanes a key
  static constexpr int kV = kDh / 4 / kG;                  // chunks a lane
  static int smem(int dh, int split_keys) {  // K, V, P, reduction, (m, l)
    const int ld = f32_ld(dh);
    const int nsub = kDecThreads / (ld / 4);
    return 4 * (2 * split_keys * ld + kDecRows * split_keys +
                nsub * kDecRows * ld + 2 * kDecRows);
  }
};

// f32, tq <= 8 (the serving decode step, tq = 1): split-KV. A block takes
// one (batch, head) and one range of split_keys keys for all its rows:
// its K and V rows go to shared memory in one burst of 16-byte cp.async
// copies (the whole range in flight at once: the step is bound by the
// bytes of K and V); warps walk the keys, kG lanes a key reading the row
// along the head dim, each lane holding its q chunks of every row in
// registers, a shuffle tree summing the dot; then the block's row max and
// sum, and P V with threads laid out over (head-dim chunk, key subset),
// the subsets summed in a fixed order. One split writes out and lse;
// several write partials for fwd_merge_kernel.
template <int kDh, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kDecThreads) fwd_decode_kernel(FwdArgs a) {
  using P = DecodeF32<kDh>;
  constexpr int kG = P::kG, kV = P::kV, kKP = 32 / kG;
  extern __shared__ __align__(16) float smem_f[];
  const int tq = a.tq, dh = a.dh, nh = a.nh, sk = a.split_keys;
  const int ld = f32_ld(dh);
  const int split = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tk_eff = kCausal ? min(a.tk, tq) : a.tk;  // live keys
  const int k_begin = split * sk;
  const int nk = min(sk, tk_eff - k_begin);
  const int nsub = kDecThreads / (ld / 4);
  float* Ks = smem_f;                    // [sk][ld]
  float* Vs = Ks + sk * ld;              // [sk][ld]
  float* Ss = Vs + sk * ld;              // [kDecRows][sk]
  float* Red = Ss + kDecRows * sk;       // [nsub][kDecRows][ld]
  float* ML = Red + nsub * kDecRows * ld;  // [kDecRows][2]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool vec = a.vec != 0;
  const float* qb = static_cast<const float*>(a.q) + bb * a.qs[0] +
                    hh * a.qs[2];
  const float* kb = static_cast<const float*>(a.k) + bb * a.ks[0] +
                    hh * a.ks[2];
  const float* vb = static_cast<const float*>(a.v) + bb * a.vs[0] +
                    hh * a.vs[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;

  copy_rows_f32<kDecThreads>(Ks, ld, kb, a.ks[1], k_begin, nk,
                             k_begin + nk, dh, vec);
  copy_rows_f32<kDecThreads>(Vs, ld, vb, a.vs[1], k_begin, nk,
                             k_begin + nk, dh, vec);
  cp_async_commit();

  // this lane's q chunks (columns 4ch .. 4ch + 3, ch = lane % kG + kG v)
  // of every row, read while the copies fly; zeros past dh and tq
  float4 qv[kDecRows][kV];
#pragma unroll
  for (int r = 0; r < kDecRows; ++r)
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int d = 4 * (lane % kG + kG * v);
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[c] = r < tq && d + c < dh ? qb[(long long)r * a.qs[1] + d + c]
                                    : 0.f;
      qv[r][v] = make_float4(x[0], x[1], x[2], x[3]);
    }
  cp_async_wait<0>();
  __syncthreads();

  // scores: warp w takes keys w*kKP + lane/kG, then every 4*kKP-th; the
  // loop bound is the warp's (its shuffles need every lane), a lane past
  // the last key computes zeros and writes nothing
  for (int j0 = warp * kKP; j0 < nk; j0 += 4 * kKP) {
    const int j = j0 + lane / kG;
    const bool live_key = j < nk;
    float s[kDecRows];
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) s[r] = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int d = 4 * (lane % kG + kG * v);
      const float4 k4 = live_key && d < ld
                            ? *reinterpret_cast<const float4*>(Ks + j * ld +
                                                               d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        s[r] = fmaf(qv[r][v].x, k4.x, s[r]);
        s[r] = fmaf(qv[r][v].y, k4.y, s[r]);
        s[r] = fmaf(qv[r][v].z, k4.z, s[r]);
        s[r] = fmaf(qv[r][v].w, k4.w, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      if (r >= tq) break;
#pragma unroll
      for (int off = kG / 2; off >= 1; off >>= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    }
    if (live_key && lane % kG == 0) {
      const int key = k_begin + j;
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {  // unrolled: s stays in registers
        if (r >= tq) break;
        float x = -INFINITY;  // a future key: zero weight
        if (!kCausal || key <= r) {
          x = s[r] * a.scale;
          if (biasb != nullptr) x += __ldg(biasb + (long long)r * a.sq + key);
        }
        Ss[r * sk + j] = x;
      }
    }
  }
  __syncthreads();

  // row max and sum of the block's keys (warp w: rows w, w + 4)
  const uint32_t dkey = kDrop ? pt_attn::stream_key(a.drop) : 0u;
  for (int r = warp; r < tq; r += 4) {
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, Ss[r * sk + j]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    const uint32_t hrow =
        kDrop ? drop_row_hash(dkey, bb * nh + hh, r) : 0u;
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      float p = expf(Ss[r * sk + j] - m_use);
      sum += p;  // l sums the undropped terms
      if (kDrop)
        p *= drop_scale(hrow, k_begin + j, a.drop.thresh, a.drop.keep_scale);
      Ss[r * sk + j] = p;
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ML[2 * r] = mx;
      ML[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // P V: thread (chunk ch, key subset sub) sums keys sub, sub + nsub, ...
  const int nch = ld / 4;
  const int ch = tid % nch, sub = tid / nch;
  if (sub < nsub) {
    float4 acc[kDecRows];
#pragma unroll
    for (int r = 0; r < kDecRows; ++r)
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = sub; j < nk; j += nsub) {
      const float4 v4 = *reinterpret_cast<const float4*>(Vs + j * ld + 4 * ch);
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        if (r >= tq) break;
        const float p = Ss[r * sk + j];
        acc[r].x = fmaf(p, v4.x, acc[r].x);
        acc[r].y = fmaf(p, v4.y, acc[r].y);
        acc[r].z = fmaf(p, v4.z, acc[r].z);
        acc[r].w = fmaf(p, v4.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < kDecRows; ++r)
      *reinterpret_cast<float4*>(Red + (sub * kDecRows + r) * ld + 4 * ch) =
          acc[r];
  }
  __syncthreads();

  const long long nrows = (long long)gridDim.z * nh * tq;
  for (int e = tid; e < tq * dh; e += kDecThreads) {
    const int r = e / dh, d = e - r * dh;
    float o = 0.f;
    for (int u = 0; u < nsub; ++u) o += Red[(u * kDecRows + r) * ld + d];
    const float m = ML[2 * r], l = ML[2 * r + 1];
    if (a.splits == 1) {
      static_cast<float*>(a.out)[bb * a.os[0] + r * a.os[1] + hh * a.os[2] +
                                 d] = o / l;
      if (d == 0)
        a.lse[bb * a.ls[0] + r * a.ls[1] + hh * a.ls[2]] = m + logf(l);
    } else {
      part_out(a, split, bb * nh + hh, r)[d] = o;
      if (d == 0) {
        float* ml = part_ml(a, split, bb * nh + hh, r, nrows);
        ml[0] = m;
        ml[1] = l;
      }
    }
  }
}

// Combines the partials of the splits of every (batch, head, row) in the
// splits' order: M = max m_s, L = sum l_s e^(m_s - M), out = sum o_s
// e^(m_s - M) / L, lse = M + log L. One warp a row, lanes over the head
// dim; a split with no live key (m_s = -inf) weighs 0.
__global__ void __launch_bounds__(128) fwd_merge_kernel(FwdArgs a, int b) {
  const long long nrows = (long long)b * a.nh * a.tq;
  const long long row_id = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row_id >= nrows) return;
  const int lane = threadIdx.x % 32;
  const int r = (int)(row_id % a.tq);
  const long long bh = row_id / a.tq;
  const int hh = (int)(bh % a.nh), bb = (int)(bh / a.nh);
  const float* ml0 = a.part + nrows * a.splits * a.dh;
  float mx = -INFINITY;
  for (int s = 0; s < a.splits; ++s)
    mx = fmaxf(mx, ml0[2 * (s * nrows + row_id)]);
  float lsum = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float ms = ml0[2 * (s * nrows + row_id)];
    if (ms != -INFINITY)
      lsum += ml0[2 * (s * nrows + row_id) + 1] * expf(ms - mx);
  }
  float* orow = static_cast<float*>(a.out) + bb * a.os[0] + r * a.os[1] +
                hh * a.os[2];
  for (int d = lane; d < a.dh; d += 32) {
    float o = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ms = ml0[2 * (s * nrows + row_id)];
      if (ms != -INFINITY)
        o += a.part[(s * nrows + row_id) * a.dh + d] * expf(ms - mx);
    }
    orow[d] = o / lsum;
  }
  if (lane == 0)
    a.lse[bb * a.ls[0] + r * a.ls[1] + hh * a.ls[2]] = mx + logf(lsum);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, cp.async)

constexpr int kRowsW = 64;  // query rows of a block (one warpgroup)
constexpr int kKeysW = 64;  // keys of a streamed tile

// Shape of fwd_wgmma_kernel's shared memory: dh padded to kDhPad, kU key
// tiles a stage of sweep 1.
template <int kDhPad, int kU>
struct FwdW {
  static constexpr int kThreads = kWgThreads;
  static constexpr int kTileQ = kRowsW * kDhPad * 2;
  static constexpr int kTileK = kKeysW * kDhPad * 2;
  static constexpr int kStage = 2 * kTileK;  // K, V; or kU K tiles
  static constexpr int kTiles = kTileQ + kStages * kStage;
  // a bias that varies by query row: a [kRowsW][kU kKeysW] f32 tile a
  // stage, rows kBiasRow floats apart (4 banks)
  static constexpr int kBiasRow = kU * kKeysW + 4;
  static constexpr int kBiasStage = kRowsW * kBiasRow * 4;
  static constexpr int smem(bool bias_rows) {  // + alignment of the base
    return kTiles + (bias_rows ? kStages * kBiasStage : 0) + 1024;
  }
};

// The forward of one 64-row query tile on the tensor cores: two sweeps
// over the key tiles, sweep 1 for lse, sweep 2 for out (see the top).
// kBiasRows: the bias varies by query row (a.sq != 0); it streams through
// the ring, and sweep 1 then takes one key tile a stage, not two.
template <int kDhPad, bool kDrop, bool kCausal, bool kBiasRows>
__global__ void __launch_bounds__(kWgThreads)
    fwd_wgmma_kernel(FwdArgs a, int b) {
  constexpr int kU = kBiasRows ? 1 : 2;  // key tiles a stage of sweep 1
  using P = FwdW<kDhPad, kU>;
  extern __shared__ char smem_raw[];
  char* Qs = align1024(smem_raw);
  char* ring = Qs + P::kTileQ;
  float* bias_ring = reinterpret_cast<float*>(Qs + P::kTiles);

  const int nh = a.nh, tq = a.tq, tk = a.tk, dh = a.dh;
  const int nbh = b * nh;
  const int n_qtiles = (tq + kRowsW - 1) / kRowsW;
  // the query tile varies slowest; under the causal mask the last (the
  // heaviest) starts first
  const int order = blockIdx.x / nbh;
  const int tile = kCausal ? n_qtiles - 1 - order : order;
  const int hh = (blockIdx.x - order * nbh) % nh;
  const int bb = (blockIdx.x - order * nbh) / nh;
  const int q0 = tile * kRowsW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = a.vec != 0;
  typedef __nv_bfloat16 bf;
  const bf* qb = static_cast<const bf*>(a.q) + bb * a.qs[0] + hh * a.qs[2];
  const bf* kb = static_cast<const bf*>(a.k) + bb * a.ks[0] + hh * a.ks[2];
  const bf* vb = static_cast<const bf*>(a.v) + bb * a.vs[0] + hh * a.vs[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;

  // causal: key tiles past the block's last row are dead
  int n_tiles = (tk + kKeysW - 1) / kKeysW;
  if (kCausal)
    n_tiles = min(n_tiles, (min(q0 + kRowsW, tq) - 1) / kKeysW + 1);
  // the walk: n1 stages of sweep 1, each kU K tiles (a second one in the
  // V slot; past the last tile its keys are masked), then n_tiles stages
  // of sweep 2, each one K and one V tile
  const int n1 = (n_tiles + kU - 1) / kU;
  const int n_walk = n1 + n_tiles;

  zero_shared<P::kThreads>(Qs, P::kTiles);  // columns past dh stay zero
  __syncthreads();
  copy_tile<kRowsW, P::kThreads>(Qs, qb, a.qs[1], q0, tq, dh, vec);
  auto load_stage = [&](int it) {
    char* st = ring + (it % kStages) * P::kStage;
    float* bs = bias_ring + (it % kStages) * (P::kBiasStage / 4);
    if (it < n1) {
      const int k0 = kU * it * kKeysW;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        copy_tile<kKeysW, P::kThreads>(st + u * P::kTileK, kb, a.ks[1],
                                       k0 + u * kKeysW, tk, dh, vec);
      if (kBiasRows)
        copy_bias_tile<kRowsW, kU * kKeysW, P::kThreads, P::kBiasRow>(
            bs, biasb, a.sq, q0, tq, k0, tk, a.bias_vec != 0);
    } else {
      const int k0 = (it - n1) * kKeysW;
      copy_tile<kKeysW, P::kThreads>(st, kb, a.ks[1], k0, tk, dh, vec);
      copy_tile<kKeysW, P::kThreads>(st + P::kTileK, vb, a.vs[1], k0, tk,
                                     dh, vec);
      if (kBiasRows)
        copy_bias_tile<kRowsW, kKeysW, P::kThreads, P::kBiasRow>(
            bs, biasb, a.sq, q0, tq, k0, tk, a.bias_vec != 0);
    }
  };
  load_stage(0);
  cp_async_commit();
  // the top of iteration `it`: stage it + 1 in flight, stage it landed
  // and visible to wgmma
  auto next_stage = [&](int it) {
    if (it + 1 < n_walk) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
  };

  // accumulator rows (query rows) of this thread
  const int rrow[2] = {q0 + 16 * warp + lane / 4,
                       q0 + 16 * warp + lane / 4 + 8};
  const int c0 = 2 * (lane & 3);
  const float scale = a.scale;
  const uint32_t q_addr = smem_addr(Qs);

  // a broadcast bias: this thread's 16 keys of the tile at k0, read
  // before the product so that the loads overlap it
  auto bias_keys = [&](float (&bk)[8][2], int k0) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * n8 + c0 + j;
        bk[n8][j] = !kBiasRows && biasb != nullptr && key < tk
                        ? __ldg(biasb + key)
                        : 0.f;
      }
  };
  // S of the tile at k0 -> the scaled score plus bias, -inf where masked
  // (only edge tiles mask). Element 4*n8 + 2*i + j is row rrow[i], key k0
  // + 8*n8 + c0 + j; Bs: the tile's bias rows, [row - q0][key - k0].
  auto scores = [&](float (&s)[32], int k0, const float* Bs,
                    const float (&bk)[8][2]) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n8 + 2 * i + j;
          const float bv =
              kBiasRows
                  ? Bs[(rrow[i] - q0) * P::kBiasRow + 8 * n8 + c0 + j]
                  : bk[n8][j];
          s[e] = fmaf(s[e], scale, bv);
        }
    if (k0 + kKeysW > tk || (kCausal && k0 + kKeysW - 1 > q0)) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + 8 * n8 + c0 + j;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (!(key < tk && (!kCausal || key <= rrow[i])))
              s[4 * n8 + 2 * i + j] = -INFINITY;
        }
    }
  };

  // sweep 1: per row the running max m and this thread's part of the sum
  // l of exp(s - m), kU key tiles a stage
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n1; ++it) {
    next_stage(it);
    const int k0 = kU * it * kKeysW;
    const uint32_t k_addr = smem_addr(ring + (it % kStages) * P::kStage);
    const float* Bs = bias_ring + (it % kStages) * (P::kBiasStage / 4);
    float bk[kU][8][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) bias_keys(bk[u], k0 + u * kKeysW);
    float s[kU][32];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int kk = 0; kk < kDhPad / 16; ++kk)
        wgmma_ss(s[u], desc_k<kRowsW>(q_addr, 0, kk),
                 desc_k<kKeysW>(k_addr + u * P::kTileK, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      reg_fence(s[u]);
      scores(s[u], k0 + u * kKeysW, Bs + u * kKeysW, bk[u]);
    }
    // the stage's row max over the 4 threads of a row, then the running
    // sum rescaled to it; the first stage holds key 0, live for every
    // row, so m is finite from it on
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
          tmax = fmaxf(tmax, fmaxf(s[u][4 * n8 + 2 * i],
                                   s[u][4 * n8 + 2 * i + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[i], tmax);
      const float mb = m_new * kLog2e;  // exp(t - m) = 2^(t log2e - mb)
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            sum += exp2_approx(fmaf(s[u][4 * n8 + 2 * i + j], kLog2e, -mb));
      l[i] = l[i] * exp2_approx((m[i] - m_new) * kLog2e) + sum;
      m[i] = m_new;
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  // lse of each row, from the sums of the 4 threads of the row
  float lse[2], lb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lse[i] = m[i] + logf(l[i]);
    lb[i] = lse[i] * kLog2e;
  }

  // sweep 2: O += (p o M) V, p = exp(s - lse) rounded to bf16 once
  uint32_t hrow[2] = {0u, 0u};
  if (kDrop) {
    const uint32_t dkey = pt_attn::stream_key(a.drop);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hrow[i] = drop_row_hash(dkey, bb * nh + hh, rrow[i]);
  }
  // O in kOH column halves of kON accumulators: one n64 or n128 product
  // each (dh 256 takes two n128 products, on V's columns 0..127, 128..255)
  constexpr int kOH = kDhPad > 128 ? 2 : 1;
  constexpr int kON = kDhPad / 2 / kOH;
  float o[kOH][kON];
#pragma unroll
  for (int hf = 0; hf < kOH; ++hf)
#pragma unroll
    for (int i = 0; i < kON; ++i) o[hf][i] = 0.f;
  for (int it = n1; it < n_walk; ++it) {
    next_stage(it);
    const int k0 = (it - n1) * kKeysW;
    const uint32_t k_addr = smem_addr(ring + (it % kStages) * P::kStage);
    const float* Bs = bias_ring + (it % kStages) * (P::kBiasStage / 4);
    float bk[8][2];
    bias_keys(bk, k0);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDhPad / 16; ++kk)
      wgmma_ss(s, desc_k<kRowsW>(q_addr, 0, kk),
               desc_k<kKeysW>(k_addr, 0, kk), kk);
    wgmma_commit();
    // the keep mask of this thread's 32 scores (bit e), hashed while the
    // product runs
    uint32_t keep = 0u;
    if (kDrop) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            keep |= (uint32_t)(fmix32(hrow[i] ^
                                      (uint32_t)(k0 + 8 * n8 + c0 + j)) <
                               a.drop.thresh)
                    << (4 * n8 + 2 * i + j);
    }
    wgmma_wait<0>();
    reg_fence(s);
    scores(s, k0, Bs, bk);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float p = exp2_approx(fmaf(s[e], kLog2e, -lb[(e >> 1) & 1]));
      if (kDrop) p = (keep >> e) & 1u ? p * a.drop.keep_scale : 0.f;
      s[e] = p;
    }
    const uint32_t v_addr = k_addr + P::kTileK;
    uint32_t ap[1][4][4];
    to_a_frags(s, ap);
    reg_fence(ap);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < kOH; ++hf)
        wgmma_rs(o[hf], ap[0][kk],
                 desc_mn<kKeysW>(v_addr + hf * 2 * kKeysW * 128, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < kOH; ++hf) reg_fence(o[hf]);
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rrow[i];
    if (r >= tq) continue;
    bf* orow = static_cast<bf*>(a.out) + bb * a.os[0] + r * a.os[1] +
               hh * a.os[2];
#pragma unroll
    for (int n8 = 0; n8 < kDhPad / 8; ++n8) {
      const int e = 4 * n8 + 2 * i;
      store_pair(orow, 8 * n8 + c0, dh, o[e / kON][e % kON],
                 o[e / kON][e % kON + 1], vec);
    }
    if ((lane & 3) == 0)
      a.lse[bb * a.ls[0] + r * a.ls[1] + hh * a.ls[2]] = lse[i];
  }
}

// One launch configuration of each kernel, for the dispatch below.
template <int kDh, bool kDrop, bool kCausal>
struct CudaCoreF32 {
  static cudaError_t run(const FwdArgs& a, int b, cudaStream_t stream) {
    cudaError_t err;
    if (a.tq <= kDecRows) {
      const int smem = DecodeF32<kDh>::smem(a.dh, a.split_keys);
      err = cudaFuncSetAttribute(fwd_decode_kernel<kDh, kDrop, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      fwd_decode_kernel<kDh, kDrop, kCausal>
          <<<dim3(a.splits, a.nh, b), kDecThreads, smem, stream>>>(a);
    } else {
      typedef TiledF32<kDh> P;
      if ((a.splits > 1 && a.split_keys % P::kBK) ||
          (kCausal && a.splits != 1))
        return cudaErrorInvalidValue;
      const long long blocks =
          (long long)(a.tq + P::kBQ - 1) / P::kBQ * a.splits;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      const int smem = P::smem(a.dh);
      err = cudaFuncSetAttribute(fwd_kernel<kDh, kDrop, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      fwd_kernel<kDh, kDrop, kCausal>
          <<<dim3((unsigned int)blocks, a.nh, b), P::kThreads, smem,
             stream>>>(a);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return err;
    const long long rows = (long long)b * a.nh * a.tq;
    if ((rows + 3) / 4 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    fwd_merge_kernel<<<(unsigned int)((rows + 3) / 4), 128, 0, stream>>>(a, b);
    return cudaGetLastError();
  }
};

template <int kDh, bool kDrop, bool kCausal>
struct TensorCoreBf16 {
  template <bool kBiasRows>
  static cudaError_t run_rows(const FwdArgs& a, int b, cudaStream_t stream) {
    typedef FwdW<kDh, kBiasRows ? 1 : 2> P;
    const long long blocks =
        (long long)(a.tq + kRowsW - 1) / kRowsW * b * a.nh;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const int smem = P::smem(kBiasRows);
    cudaError_t err = cudaFuncSetAttribute(
        fwd_wgmma_kernel<kDh, kDrop, kCausal, kBiasRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    fwd_wgmma_kernel<kDh, kDrop, kCausal, kBiasRows>
        <<<(unsigned int)blocks, P::kThreads, smem, stream>>>(a, b);
    return cudaGetLastError();
  }
  static cudaError_t run(const FwdArgs& a, int b, cudaStream_t stream) {
    return a.bias != nullptr && a.sq != 0 ? run_rows<true>(a, b, stream)
                                          : run_rows<false>(a, b, stream);
  }
};

template <template <int, bool, bool> class L, int kDh>
cudaError_t dispatch(const FwdArgs& a, int b, bool drop, bool causal,
                     cudaStream_t s) {
  if (drop)
    return causal ? L<kDh, true, true>::run(a, b, s)
                  : L<kDh, true, false>::run(a, b, s);
  return causal ? L<kDh, false, true>::run(a, b, s)
                : L<kDh, false, false>::run(a, b, s);
}

template <template <int, bool, bool> class L>
cudaError_t launch(const FwdArgs& a, int b, bool drop, bool causal,
                   cudaStream_t s) {
  if (a.dh <= 64) return dispatch<L, 64>(a, b, drop, causal, s);
  if (a.dh <= 128) return dispatch<L, 128>(a, b, drop, causal, s);
  return dispatch<L, kMaxDh>(a, b, drop, causal, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). Pointers are device pointers;
// `bias` may be null. `strides` (host memory) holds 15 element strides:
// (batch, time, head) of q, k, v, out and lse, in that order; the head
// dim of q, k, v and out is contiguous. With `causal`, keys past the
// query row are masked in-kernel. With `use_dropout`, the mask is keyed
// by the op seed that `drop_seed` (device memory) and `drop_op` give
// (attention_common.cuh) and keeps a score when its hash is below
// `drop_thresh`, scaling it by `keep_scale`. `stream` is a cudaStream_t.
// bf16 runs the tensor-core kernel, f32 the CUDA-core ones, which take the
// caller's key split (flash_attention.f32_fwd_plan): `splits` blocks of
// `split_keys` keys each covering the live keys (tk, or min(tk, tq) under
// the causal mask when tq <= 8), and with more than one split `part`,
// scratch of splits * b * h * tq * (dh + 2) floats; bf16 ignores the three.
int pt_flash_attention_bthd_fwd(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse, int b,
                                int tq, int tk, int h, int dh,
                                const long long* strides, long long sb,
                                long long sh, long long sq, float scale,
                                int is_bf16, int causal, int use_dropout,
                                const long long* drop_seed, int drop_op,
                                unsigned int drop_thresh, float keep_scale,
                                int splits, int split_keys, void* part,
                                void* stream) {
  if (dh < 1 || dh > kMaxDh || tq < 1 || tk < 1 || b < 1 || h < 1 ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.tq = tq;
  a.tk = tk;
  a.nh = h;
  a.dh = dh;
  long long* dst[5] = {a.qs, a.ks, a.vs, a.os, a.ls};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.sb = sb;
  a.sh = sh;
  a.sq = sq;
  a.scale = scale;
  a.drop =
      pt_attn::Dropout{drop_seed, drop_op, drop_thresh, keep_scale};
  // f32 rows are 16-byte aligned with strides in multiples of 4 elements
  auto rows4 = [](const void* p, const long long* st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 4 == 0 &&
           st[1] % 4 == 0 && st[2] % 4 == 0;
  };
  a.vec = is_bf16 ? dh % 8 == 0 && rows_aligned(q, a.qs) &&
                        rows_aligned(k, a.ks) && rows_aligned(v, a.vs) &&
                        rows_aligned(out, a.os)
                  : dh % 4 == 0 && rows4(q, a.qs) && rows4(k, a.ks) &&
                        rows4(v, a.vs) && rows4(out, a.os);
  a.bias_vec = reinterpret_cast<uintptr_t>(bias) % 16 == 0 && sb % 4 == 0 &&
               sh % 4 == 0 && sq % 4 == 0;
  a.splits = splits;
  a.split_keys = split_keys;
  a.part = static_cast<float*>(part);
  if (!is_bf16) {
    const int live = causal && tq <= kDecRows ? min(tk, tq) : tk;
    if (splits < 1 || split_keys < 1 || splits > 65535 ||
        (long long)(splits - 1) * split_keys >= live ||
        (long long)splits * split_keys < live ||
        (splits > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = use_dropout != 0, cz = causal != 0;
  cudaError_t err = is_bf16 ? launch<TensorCoreBf16>(a, b, drop, cz, s)
                            : launch<CudaCoreF32>(a, b, drop, cz, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
