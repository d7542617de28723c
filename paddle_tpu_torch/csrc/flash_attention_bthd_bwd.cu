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
// once per bf16 term: 10 on the tensor cores; the f32 kernels run every
// product three times, in TF32.)
//
// Both families run on the tensor cores, every tile streaming through a
// two-stage ring of 16-byte cp.async copies (the next tile in flight while
// the current one computes; rows that are not 16-byte aligned are copied
// element by element into the same ring), a head dim padded with zeros to
// 64, 128 or 256 in shared memory (which adds nothing to any product), a
// bias that varies by query row (the small route's folded causal mask)
// streamed beside its tile, and a one-dimensional grid with the tile
// index varying slowest, counted from the heaviest end under the causal
// mask (pass A: key tile 0, which every query tile reaches; pass B: the
// last query tile), so the longest blocks start first across all heads
// and batches; only the tiles that cross the diagonal or the ragged edge
// are masked. At dh above 64 (bf16: above 128) each pass runs several
// blocks per tile (blockIdx.y), which all compute S and dP over the whole
// head and then take their share of the columns of dk, dv or dq (the
// registers hold no more).
//
// bf16 inputs (the main path: AMP training) run bwd_dkdv_wgmma_kernel
// (pass A) and bwd_dq_wgmma_kernel (pass B):
//   - every product is a `wgmma.mma_async` (bf16 x bf16 -> f32) on bf16
//     tiles in shared memory, in the 128-byte-swizzled layout the wgmma
//     descriptors read; a block writes 128 gradient columns at most;
//   - pass A: a block holds 64 keys per warpgroup (two warpgroups, 128
//     keys, at dh <= 64; one above) and their K and V for the whole walk;
//     query tiles (64 rows; 32 at dh > 64, for registers) of Q and dout,
//     with their lse and delta, stream through the ring. It computes S^T
//     = K Q^T and dP^T = V dout^T with the keys in wgmma's M, so P^T o M
//     and dS^T stay in registers: in bf16 they are the register A operand
//     of dV += (P^T o M) dout and dK += dS^T Q, whose B (Q, dout) is read
//     through transposed (MN-major) descriptors;
//   - pass B: a block of one warpgroup holds 64 query rows with their Q,
//     dout, lse and delta (two blocks share an SM, so one block's
//     exponentials run under the other's products); K and V tiles of 64
//     keys stream through the ring. S = Q K^T and dP = dout V^T, then dS
//     in registers as the A operand of dQ += dS K, K read through a
//     transposed descriptor;
//   - P o M and dS enter the tensor cores as two bf16 terms each, hi =
//     bf16(x) and lo = bf16(x - hi), 16 bits in all (one bf16 rounding
//     left too little room under the bf16 gradient limit); every sum is
//     f32, and dq, dk, dv are rounded once when written.
// f32 inputs (the f32 training step) run bwd_dkdv_tf32_kernel (pass A) and
// bwd_dq_tf32_kernel (pass B) in 3xTF32 (mma_tf32.cuh):
//   - every product is three mma.sync.m16n8k8 TF32 MMAs into f32
//     accumulators, each operand split in registers into big = tf32(x)
//     and small = x - big (21 bits of x or more): one TF32 product misses
//     the f32 gradient limit (1e-5 of the largest) by about 100x. wgmma
//     takes TF32 operands K-major only, and three of the five products
//     read one MN-major (dV += (P o M)^T dout, dK += dS^T Q, dQ += dS K),
//     which would need transposed copies of Q, dout and K, and big and
//     small copies of each tile in shared memory; mma.sync splits its
//     fragments in registers from one f32 copy in any layout;
//   - tiles are row-major f32 in shared memory at a row stride of the
//     padded head plus 4 floats, so that every fragment load touches 32
//     banks; a block has four warps, each owning 16 rows of the block's
//     tile (pass A: 64 keys of K and V; pass B: 64 query rows of Q and
//     dout) for the whole walk, and streams tiles of 32 rows (16 at dh
//     256): pass A Q and dout with their lse and delta, pass B K and V;
//     at dh 64 two blocks share an SM;
//   - each warp computes its 16 rows of S and dP (pass A: S^T = K Q^T,
//     dP^T = V dout^T) over the head; P o M and dS stay in the
//     accumulator registers and enter dV += (P^T o M) dout, then dK +=
//     dS^T Q, or dQ += dS K as A fragments directly, the B rows taken in
//     the accumulator's column order; a block writes 64 gradient columns;
//   - the tensor cores round each MMA's f32 sum toward zero, so no chain
//     of MMAs into one accumulator runs long: each tile's contribution to
//     a gradient is a chain of its own, added in f32 (rounded to
//     nearest), and the small terms of S (and of dP in pass B) sum apart
//     from the big ones; dq, dk, dv are written as f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "mma_tf32.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace pt_attn;
using namespace pt_wgmma;

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
  // every row of q, k, v, dout, dq, dk, dv (of the bias) 16-byte aligned,
  // and dh a multiple of 16 bytes
  int vec, bias_vec;
};

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
  // drop_row_hash(key, bh, row) = fmix32(hbh ^ row)
  const uint32_t hbh =
      kDrop ? fmix32(pt_attn::stream_key(a.drop) ^ (uint32_t)bh) : 0u;

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
          if (kDrop) hrow = fmix32(hbh ^ (uint32_t)(q0 + col));
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
  const uint32_t dkey = kDrop ? pt_attn::stream_key(a.drop) : 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rrow[i];
    lrow[i] = r < tq ? a.lse[bb * a.ls[0] + r * a.ls[1] + hh * a.ls[2]] : 0.f;
    drow[i] = r < tq ? a.delta[((long long)bb * tq + r) * nh + hh] : 0.f;
    if (kDrop) hrow[i] = drop_row_hash(dkey, bb * nh + hh, r);
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

// ---------------------------------------------------------------------------
// f32: the tensor-core kernels in 3xTF32 (mma.sync, cp.async)

using pt_tf32::acc_to_a;
using pt_tf32::add4;
using pt_tf32::copy_tile_f32;
using pt_tf32::FragA;
using pt_tf32::FragB;
using pt_tf32::load_a;
using pt_tf32::load_b_kn;
using pt_tf32::load_b_nk;
using pt_tf32::mma_3xtf32;
using pt_tf32::mma_3xtf32_apart;
using pt_tf32::store_pair_f32;

// Rows of a streamed f32 tile: 32 (the ring stage ~17 KB a tensor at dh
// 64, so that two or three blocks share an SM), 16 at dh 256 (shared
// memory)
template <int kDhPad>
constexpr int stream_rows() {
  return kDhPad < 256 ? 32 : 16;
}

// Pass A shape, dh padded to kDhPad (64, 128 or 256): 64 keys a block, 16
// a warp; query tiles of kBq rows streamed.
template <int kDhPad>
struct PassA32 {
  static constexpr int kLd = kDhPad + 4;  // row stride of every tile, floats
  static constexpr int kKeys = 64;
  static constexpr int kBq = stream_rows<kDhPad>();
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = kDhPad == 64 ? 2 : 1;  // an SM
  // dk and dv columns of a block (64: the split fragments take the
  // registers 128 would need); blockIdx.y picks which of the kHalves
  static constexpr int kOut = 64;
  static constexpr int kHalves = kDhPad / kOut;
  static constexpr int kTileKV = kKeys * kLd;  // K (or V), floats
  static constexpr int kTileQ = kBq * kLd;     // Q (or dout), floats
  // a ring stage: Q, dout, then lse and delta [kBq]
  static constexpr int kStage = 2 * kTileQ + 2 * kBq;
  // a bias that varies by query row: a [kBq][kKeys + 4] tile a stage
  static constexpr int kBiasLd = kKeys + 4;
  static constexpr int kBiasStage = kBq * kBiasLd;
  static constexpr int smem(bool bias_rows) {
    return 4 * (2 * kTileKV + kStages * kStage +
                (bias_rows ? kStages * kBiasStage : 0));
  }
};

// Pass B shape: 64 query rows a block, 16 a warp; key tiles of kKeys
// streamed.
template <int kDhPad>
struct PassB32 {
  static constexpr int kLd = kDhPad + 4;
  static constexpr int kRows = 64;
  static constexpr int kKeys = stream_rows<kDhPad>();
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = kDhPad == 64 ? 2 : 1;
  static constexpr int kOut = 64;  // as in PassA32
  static constexpr int kHalves = kDhPad / kOut;
  static constexpr int kTileQ = kRows * kLd;
  static constexpr int kTileK = kKeys * kLd;
  static constexpr int kStage = 2 * kTileK;  // K, V
  // [kRows][kKeys + 8]: a row's two neighbouring keys read as one float2
  static constexpr int kBiasLd = kKeys + 8;
  static constexpr int kBiasStage = kRows * kBiasLd;
  static constexpr int smem(bool bias_rows) {
    return 4 * (2 * kTileQ + kStages * kStage +
                (bias_rows ? kStages * kBiasStage : 0));
  }
};

// S and dP of a warp's 16 rows (A: its rows of x1 and x2) against the kN
// * 8 rows of a streamed tile (B: y1, y2), over the padded head (its zero
// columns add nothing, and a head step taken at run time would split the
// unrolled product loop into one basic block per step): s = x1 y1^T, dp =
// x2 y2^T. The reduction runs in chains of 128 columns (dh 256 takes two),
// the big terms of s (kApart1) and of dp (kApart2) apart from their small
// ones (mma_3xtf32_apart): the rounding of a chain drifts with the size of
// its sum, which for scores grows with the head.
template <int kDhPad, int kLd, bool kApart1, bool kApart2, int kN>
__device__ __forceinline__ void scores_3xtf32(const float* x1,
                                              const float* x2,
                                              const float* y1,
                                              const float* y2, int lane,
                                              float (&s)[kN][4],
                                              float (&dp)[kN][4]) {
  constexpr int kSteps = kDhPad / 8, kPer = kSteps < 16 ? kSteps : 16;
#pragma unroll
  for (int c = 0; c < kSteps; c += kPer) {
    // big terms, small terms
    float ts[kN][4], td[kN][4], us[kN][4], ud[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ts[n][e] = td[n][e] = us[n][e] = ud[n][e] = 0.f;
#pragma unroll
    for (int kk = c; kk < c + kPer; ++kk) {
      FragA f1, f2;
      load_a<kLd>(x1, 8 * kk, lane, f1);
      load_a<kLd>(x2, 8 * kk, lane, f2);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        FragB g1, g2;
        load_b_nk<kLd>(y1, 8 * n, 8 * kk, lane, g1);
        mma_3xtf32_apart(ts[n], kApart1 ? us[n] : ts[n], f1, g1);
        load_b_nk<kLd>(y2, 8 * n, 8 * kk, lane, g2);
        mma_3xtf32_apart(td[n], kApart2 ? ud[n] : td[n], f2, g2);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xs = ts[n][e] + us[n][e], xd = td[n][e] + ud[n][e];
        s[n][e] = c == 0 ? xs : s[n][e] + xs;
        dp[n][e] = c == 0 ? xd : dp[n][e] + xd;
      }
  }
}

// acc[o] += A y[:, col0 + 8o .. + 7] for the kO output blocks: A the kN
// fragments of a warp's 16 rows over the tile's kN * 8 streamed rows (in
// acc_to_a's column order), y the streamed tile. Each block is one chain
// into a fresh accumulator, added to acc in f32 (mma_tf32.cuh).
template <int kLd, int kN, int kO>
__device__ __forceinline__ void product_rows(const FragA (&fa)[kN],
                                             const float* y, int col0,
                                             int lane, float (&acc)[kO][4]) {
#pragma unroll
  for (int o = 0; o < kO; ++o) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      FragB fb;
      load_b_kn<kLd>(y, 8 * u, col0 + 8 * o, lane, fb);
      mma_3xtf32(t, fa[u], fb);
    }
    add4(acc[o], t);
  }
}

// Pass A in 3xTF32: dk and dv of one 64-key tile.
template <int kDhPad, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(PassA32<kDhPad>::kThreads,
                                  PassA32<kDhPad>::kMinBlocks)
    bwd_dkdv_tf32_kernel(Args a, int b) {
  using P = PassA32<kDhPad>;
  constexpr int kBq = P::kBq, kLd = P::kLd;
  constexpr int kN = kBq / 8;      // query blocks of S^T
  constexpr int kO = P::kOut / 8;  // column blocks of dk, dv
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + P::kTileKV;
  float* ring = Vs + P::kTileKV;
  float* bias_ring = ring + kStages * P::kStage;

  const int nh = a.nh, tq = a.tq, tk = a.tk, dh = a.dh;
  const int nbh = b * nh;
  // the key tile varies slowest: tile 0, the heaviest under the causal
  // mask, starts first in every (batch, head)
  const int tile = blockIdx.x / nbh;
  const int hh = (blockIdx.x - tile * nbh) % nh;
  const int bb = (blockIdx.x - tile * nbh) / nh;
  const int k0 = tile * P::kKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 16 * warp;         // this warp's first key
  const int col0 = blockIdx.y * P::kOut;  // first dk, dv column
  const bool vec = a.vec != 0;
  const float* qb = static_cast<const float*>(a.q) + bb * a.qs[0] +
                    hh * a.qs[2];
  const float* kb = static_cast<const float*>(a.k) + bb * a.ks[0] +
                    hh * a.ks[2];
  const float* vb = static_cast<const float*>(a.v) + bb * a.vs[0] +
                    hh * a.vs[2];
  const float* dob = static_cast<const float*>(a.dout) + bb * a.dos[0] +
                     hh * a.dos[2];
  const float* lsb = a.lse + bb * a.ls[0] + hh * a.ls[2];
  const float* dlb = a.delta + (long long)bb * tq * nh + hh;
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;
  const bool bias_rows = biasb != nullptr && a.sq != 0;
  // drop_row_hash(key, bh, row) = fmix32(hbh ^ row)
  const uint32_t hbh =
      kDrop ? fmix32(pt_attn::stream_key(a.drop) ^ (uint32_t)(bb * nh + hh))
            : 0u;

  // causal: the first query tile is the one that holds row k0
  const int q_first = kCausal ? (k0 / kBq) * kBq : 0;
  const int n_tiles = q_first < tq ? (tq - q_first + kBq - 1) / kBq : 0;

  copy_tile_f32<P::kKeys, kDhPad, kLd, P::kThreads>(Ks, kb, a.ks[1], k0, tk,
                                                   dh, vec);
  copy_tile_f32<P::kKeys, kDhPad, kLd, P::kThreads>(Vs, vb, a.vs[1], k0, tk,
                                                   dh, vec);
  auto load_stage = [&](int it) {
    float* st = ring + (it % kStages) * P::kStage;
    const int q0 = q_first + it * kBq;
    copy_tile_f32<kBq, kDhPad, kLd, P::kThreads>(st, qb, a.qs[1], q0, tq, dh,
                                                vec);
    copy_tile_f32<kBq, kDhPad, kLd, P::kThreads>(st + P::kTileQ, dob,
                                                a.dos[1], q0, tq, dh, vec);
    float* ld = st + 2 * P::kTileQ;
    copy_rows_f32<P::kThreads>(ld, lsb, a.ls[1], q0, kBq, tq);
    copy_rows_f32<P::kThreads>(ld + kBq, dlb, nh, q0, kBq, tq);
    if (bias_rows)
      copy_bias_tile<kBq, P::kKeys, P::kThreads, P::kBiasLd>(
          bias_ring + (it % kStages) * P::kBiasStage, biasb, a.sq, q0, tq,
          k0, tk, a.bias_vec != 0);
  };
  if (n_tiles > 0) load_stage(0);
  cp_async_commit();

  // accumulator rows (keys) of this thread, and their bias when the bias
  // does not vary by query row
  const int krow[2] = {kw0 + g, kw0 + g + 8};
  float bkey[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (biasb != nullptr && !bias_rows && krow[i] < tk)
      bkey[i] = biasb[krow[i]];
  const float scale = a.scale, scale2 = a.scale * kLog2e;
  const float* kw = Ks + 16 * warp * kLd;  // this warp's rows of K and V
  const float* vw = Vs + 16 * warp * kLd;

  float dk[kO][4], dv[kO][4];
#pragma unroll
  for (int o = 0; o < kO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[o][e] = dv[o][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_stage(it + 1);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_first + it * kBq;
    const bool live =
        kw0 < tk && (!kCausal || causal_tile_live(q0, kBq, tq, kw0));
    if (live) {
      const float* Qs = ring + (it % kStages) * P::kStage;
      const float* dOs = Qs + P::kTileQ;
      const float* Ls = dOs + P::kTileQ;
      const float* Ds = Ls + kBq;
      // this stage's bias tile, [query][key - k0]
      const float* Bs = bias_ring + (it % kStages) * P::kBiasStage;
      float s[kN][4], dp[kN][4];
      // the small terms of S apart (those of dP as well would spill)
      scores_3xtf32<kDhPad, kLd, true, false>(kw, vw, Qs, dOs, lane, s, dp);

      // s^T holds (key, query) pairs: s[n][2i + j] is key krow[i], query
      // column 8n + 2t + j of the tile. Mask only edge tiles.
      const bool edge = q0 + kBq > tq || kw0 + 16 > tk ||
                        (kCausal && q0 < kw0 + 15);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n + 2 * t + j, qr = q0 + col;
          const float lq2 = Ls[col] * kLog2e, delta_q = Ds[col];
          const uint32_t hrow = kDrop ? fmix32(hbh ^ (uint32_t)qr) : 0u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + j, key = krow[i];
            float p = 0.f;
            if (!edge ||
                (qr < tq && key < tk && (!kCausal || key <= qr))) {
              const float bv =
                  bias_rows ? Bs[col * P::kBiasLd + key - k0] : bkey[i];
              // exp(s scale + bias - lse) as one MUFU 2^x
              p = exp2_approx(
                  fmaf(s[n][e], scale2, fmaf(bv, kLog2e, -lq2)));
            }
            const float m = kDrop ? drop_scale(hrow, key, a.drop.thresh,
                                               a.drop.keep_scale)
                                  : 1.f;
            dp[n][e] = p * (dp[n][e] * m - delta_q) * scale;  // ds
            s[n][e] = p * m;                                  // p o M
          }
        }

      // dV += (P o M)^T dout, then dK += dS^T Q, over the tile's
      // queries: each output block one chain of the tile's kN k8 steps
      // (padded columns add zeros), the A fragments split once
      FragA fa[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) acc_to_a(s[u], fa[u]);
      product_rows<kLd, kN, kO>(fa, dOs, col0, lane, dv);
#pragma unroll
      for (int u = 0; u < kN; ++u) acc_to_a(dp[u], fa[u]);
      product_rows<kLd, kN, kO>(fa, Qs, col0, lane, dk);
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = krow[i];
    if (key >= tk) continue;
    float* dkr = static_cast<float*>(a.dk) + bb * a.dks[0] + key * a.dks[1] +
                 hh * a.dks[2];
    float* dvr = static_cast<float*>(a.dv) + bb * a.dvs[0] + key * a.dvs[1] +
                 hh * a.dvs[2];
#pragma unroll
    for (int o = 0; o < kO; ++o) {
      const int c = col0 + 8 * o + 2 * t;
      store_pair_f32(dkr, c, dh, dk[o][2 * i], dk[o][2 * i + 1], vec);
      store_pair_f32(dvr, c, dh, dv[o][2 * i], dv[o][2 * i + 1], vec);
    }
  }
}

// Pass B in 3xTF32: dq of one 64-row query tile.
template <int kDhPad, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(PassB32<kDhPad>::kThreads,
                                  PassB32<kDhPad>::kMinBlocks)
    bwd_dq_tf32_kernel(Args a, int b) {
  using P = PassB32<kDhPad>;
  constexpr int kKeys = P::kKeys, kLd = P::kLd;
  constexpr int kN = kKeys / 8;    // key blocks of S
  constexpr int kO = P::kOut / 8;  // column blocks of dq
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + P::kTileQ;
  float* ring = dOs + P::kTileQ;
  float* bias_ring = ring + kStages * P::kStage;

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
  const int g = lane >> 2, t = lane & 3;
  const bool vec = a.vec != 0;
  const float* qb = static_cast<const float*>(a.q) + bb * a.qs[0] +
                    hh * a.qs[2];
  const float* kb = static_cast<const float*>(a.k) + bb * a.ks[0] +
                    hh * a.ks[2];
  const float* vb = static_cast<const float*>(a.v) + bb * a.vs[0] +
                    hh * a.vs[2];
  const float* dob = static_cast<const float*>(a.dout) + bb * a.dos[0] +
                     hh * a.dos[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;
  const bool bias_rows = biasb != nullptr && a.sq != 0;

  // causal: key tiles past the block's last row are dead
  int n_tiles = (tk + kKeys - 1) / kKeys;
  if (kCausal)
    n_tiles = min(n_tiles, (min(q0 + P::kRows, tq) - 1) / kKeys + 1);

  copy_tile_f32<P::kRows, kDhPad, kLd, P::kThreads>(Qs, qb, a.qs[1], q0, tq,
                                                   dh, vec);
  copy_tile_f32<P::kRows, kDhPad, kLd, P::kThreads>(dOs, dob, a.dos[1], q0,
                                                   tq, dh, vec);
  auto load_stage = [&](int it) {
    float* st = ring + (it % kStages) * P::kStage;
    const int k0 = it * kKeys;
    copy_tile_f32<kKeys, kDhPad, kLd, P::kThreads>(st, kb, a.ks[1], k0, tk,
                                                  dh, vec);
    copy_tile_f32<kKeys, kDhPad, kLd, P::kThreads>(st + P::kTileK, vb,
                                                  a.vs[1], k0, tk, dh, vec);
    if (bias_rows)
      copy_bias_tile<P::kRows, kKeys, P::kThreads, P::kBiasLd>(
          bias_ring + (it % kStages) * P::kBiasStage, biasb, a.sq, q0, tq,
          k0, tk, a.bias_vec != 0);
  };
  load_stage(0);
  cp_async_commit();

  // accumulator rows (query rows) of this thread
  const int rrow[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float l2row[2], drow[2];  // lse * log2(e), delta
  uint32_t hrow[2] = {0u, 0u};
  const uint32_t dkey = kDrop ? pt_attn::stream_key(a.drop) : 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rrow[i];
    l2row[i] = r < tq ? a.lse[bb * a.ls[0] + r * a.ls[1] + hh * a.ls[2]] *
                            kLog2e
                      : 0.f;
    drow[i] = r < tq ? a.delta[((long long)bb * tq + r) * nh + hh] : 0.f;
    if (kDrop) hrow[i] = drop_row_hash(dkey, bb * nh + hh, r);
  }
  const float scale = a.scale, scale2 = a.scale * kLog2e;
  const float* qw = Qs + 16 * warp * kLd;  // this warp's rows of Q, dout
  const float* dow = dOs + 16 * warp * kLd;

  float dq[kO][4];
#pragma unroll
  for (int o = 0; o < kO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[o][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // every tile of the walk holds a live score (n_tiles stops there)
    const int k0 = it * kKeys;
    const float* Ks = ring + (it % kStages) * P::kStage;
    const float* Vs = Ks + P::kTileK;
    // this stage's bias tile, [row - q0][key - k0]
    const float* Bs = bias_ring + (it % kStages) * P::kBiasStage;
    float s[kN][4], dp[kN][4];
    scores_3xtf32<kDhPad, kLd, true, true>(qw, dow, Ks, Vs, lane, s, dp);

    // s[n][2i + j] is row rrow[i], key k0 + 8n + 2t + j
    const bool edge = q0 + P::kRows > tq || k0 + kKeys > tk ||
                      (kCausal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int key0 = k0 + 8 * n + 2 * t;
      float bkey[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (biasb != nullptr && !bias_rows && key0 + j < tk)
          bkey[j] = biasb[key0 + j];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rrow[i];
        float2 brow = make_float2(bkey[0], bkey[1]);
        if (bias_rows)
          brow = *reinterpret_cast<const float2*>(
              Bs + (r - q0) * P::kBiasLd + key0 - k0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j, key = key0 + j;
          float p = 0.f;
          if (!edge || (r < tq && key < tk && (!kCausal || key <= r)))
            p = exp2_approx(fmaf(s[n][e], scale2,
                                 fmaf(j ? brow.y : brow.x, kLog2e,
                                      -l2row[i])));
          const float m = kDrop ? drop_scale(hrow[i], key, a.drop.thresh,
                                             a.drop.keep_scale)
                                : 1.f;
          dp[n][e] = p * (dp[n][e] * m - drow[i]) * scale;  // ds
        }
      }
    }

    // dQ += dS K over the tile's keys, each output block one chain
    FragA fa[kN];
#pragma unroll
    for (int u = 0; u < kN; ++u) acc_to_a(dp[u], fa[u]);
    product_rows<kLd, kN, kO>(fa, Ks, col0, lane, dq);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rrow[i];
    if (r >= tq) continue;
    float* dqr = static_cast<float*>(a.dq) + bb * a.dqs[0] + r * a.dqs[1] +
                 hh * a.dqs[2];
#pragma unroll
    for (int o = 0; o < kO; ++o)
      store_pair_f32(dqr, col0 + 8 * o + 2 * t, dh, dq[o][2 * i],
                     dq[o][2 * i + 1], vec);
  }
}

// One pass of a family: P::kHalves blocks for each of `tiles` tiles of
// every (batch, head), P's shared memory.
template <typename P>
cudaError_t launch_pass(void (*kernel)(Args, int), const Args& a, int b,
                        int tiles, cudaStream_t stream) {
  const long long blocks = (long long)tiles * b * a.nh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int smem = P::smem(a.bias != nullptr && a.sq != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned int)blocks, P::kHalves), P::kThreads, smem,
           stream>>>(a, b);
  return cudaGetLastError();
}

// One launch configuration of each family, for the dispatch below.
template <int kDh, bool kDrop, bool kCausal>
struct TensorCoreBf16 {
  static cudaError_t run(const Args& a, int b, int passes,
                         cudaStream_t stream) {
    typedef PassA<kDh> A;
    typedef PassB<kDh> B;
    cudaError_t err = cudaSuccess;
    if (passes & 1)
      err = launch_pass<A>(bwd_dkdv_wgmma_kernel<kDh, kDrop, kCausal>, a, b,
                           (a.tk + A::kKeys - 1) / A::kKeys, stream);
    if (err == cudaSuccess && (passes & 2))
      err = launch_pass<B>(bwd_dq_wgmma_kernel<kDh, kDrop, kCausal>, a, b,
                           (a.tq + B::kRows - 1) / B::kRows, stream);
    return err;
  }
};

template <int kDh, bool kDrop, bool kCausal>
struct TensorCoreTf32 {
  static cudaError_t run(const Args& a, int b, int passes,
                         cudaStream_t stream) {
    typedef PassA32<kDh> A;
    typedef PassB32<kDh> B;
    cudaError_t err = cudaSuccess;
    if (passes & 1)
      err = launch_pass<A>(bwd_dkdv_tf32_kernel<kDh, kDrop, kCausal>, a, b,
                           (a.tk + A::kKeys - 1) / A::kKeys, stream);
    if (err == cudaSuccess && (passes & 2))
      err = launch_pass<B>(bwd_dq_tf32_kernel<kDh, kDrop, kCausal>, a, b,
                           (a.tq + B::kRows - 1) / B::kRows, stream);
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

template <template <int, bool, bool> class L>
cudaError_t dispatch_dh(const Args& a, int b, bool drop, bool causal,
                        int passes, cudaStream_t s) {
  if (a.dh <= 64) return dispatch<L, 64>(a, b, drop, causal, passes, s);
  if (a.dh <= 128) return dispatch<L, 128>(a, b, drop, causal, passes, s);
  return dispatch<L, kMaxDh>(a, b, drop, causal, passes, s);
}

template <typename T, template <int, bool, bool> class L>
cudaError_t launch_all(const Args& a, int b, bool drop, bool causal,
                       int passes, cudaStream_t stream) {
  const long long lanes = (long long)b * a.tq * a.nh * kDeltaLanes;
  const long long blocks = (lanes + kThreadsDelta - 1) / kThreadsDelta;
  bwd_delta_kernel<T><<<(unsigned int)blocks, kThreadsDelta, 0, stream>>>(
      a, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dispatch_dh<L>(a, b, drop, causal, passes, stream);
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
// `stream` is a cudaStream_t. bf16 runs the wgmma kernels, f32 the 3xTF32
// ones.
int pt_flash_attention_bthd_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, const void* g_lse,
    void* delta, void* dq, void* dk, void* dv, int b, int tq, int tk, int h,
    int dh, const long long* strides, long long sb, long long sh,
    long long sq, float scale, int is_bf16, int causal, int use_dropout,
    const long long* drop_seed, int drop_op, unsigned int drop_thresh,
    float keep_scale,
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
  a.drop =
      pt_attn::Dropout{drop_seed, drop_op, drop_thresh, keep_scale};
  const int per16 = is_bf16 ? 8 : 4;  // elements in 16 bytes
  a.vec = dh % per16 == 0 && rows_aligned(q, a.qs, per16) &&
          rows_aligned(k, a.ks, per16) && rows_aligned(v, a.vs, per16) &&
          rows_aligned(dout, a.dos, per16) && rows_aligned(dq, a.dqs, per16) &&
          rows_aligned(dk, a.dks, per16) && rows_aligned(dv, a.dvs, per16);
  a.bias_vec = reinterpret_cast<uintptr_t>(bias) % 16 == 0 && sb % 4 == 0 &&
               sh % 4 == 0 && sq % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = use_dropout != 0, cz = causal != 0;
  cudaError_t err =
      is_bf16
          ? launch_all<__nv_bfloat16, TensorCoreBf16>(a, b, drop, cz, passes,
                                                      s)
          : launch_all<float, TensorCoreTf32>(a, b, drop, cz, passes, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
