// Single-pass attention forward for Hopper (sm_90a), with an optional
// in-kernel causal mask and in-kernel dropout; and the dump of its
// dropout mask.
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
// training shape of the repo the operations dominate.
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
// f32 inputs (the serving prefill, the decode step: tq = 1, bound by
// bytes; the f32 training step, whose 2e-5 limit TF32 products could not
// meet) keep fwd_kernel on the CUDA cores: one block per 32-row query
// tile, K and V in 64-key tiles of shared memory, an online softmax with
// the running max, sum and [32 x dh] output tile in registers, and under
// the causal mask a stop after the last live key tile (causal_tile_live).
// The keep mask is a hash of absolute (batch, head, row, column), so the
// backward regenerates it whatever its tiling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace pt_attn;
using namespace pt_wgmma;

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;  // 4 warps
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
  // bf16: every row of q, k, v, out (of the bias) 16-byte aligned
  int vec, bias_vec;
};

size_t smem_bytes(int dh) {
  // Qs [BQ][dh], Ks [BK][dh+1], Vs [BK][dh], Ss [BQ][BK+1], all f32
  return sizeof(float) *
         (size_t)(kBQ * dh + kBK * (dh + 1) + kBK * dh + kBQ * (kBK + 1));
}

template <typename T, int kDhMax, bool kDrop, bool kCausal>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int dh = a.dh, tq = a.tq, tk = a.tk;
  float* Qs = smem;                   // [kBQ][dh]
  float* Ks = Qs + kBQ * dh;          // [kBK][dh + 1]
  float* Vs = Ks + kBK * (dh + 1);    // [kBK][dh]
  float* Ss = Vs + kBK * dh;          // [kBQ][kBK + 1]
  const int ks = dh + 1, ss = kBK + 1;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const T* qb = static_cast<const T*>(a.q) + bb * a.qs[0] + hh * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + bb * a.ks[0] + hh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + bb * a.vs[0] + hh * a.vs[2];
  const float* biasb =
      a.bias == nullptr ? nullptr : a.bias + bb * a.sb + hh * a.sh;

  // Q tile -> shared (rows past tq read as zeros and are never stored)
  load_tile<kThreads>(Qs, dh, qb, a.qs[1], q0, kBQ, tq, dh);

  // Score micro-tile: rows 4*rg .. 4*rg+3, keys 4*cg .. 4*cg+3.
  const int rg = tid / 16, cg = tid % 16;
  // Softmax / output mapping: row r, column lane c + 4*j (4 threads a row,
  // all in one warp, so a row's statistics never leave its warp).
  const int r = tid / 4, c = tid % 4;
  constexpr int kDPerThread = kDhMax / 4;  // output columns a thread owns
  float acc[kDPerThread];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) acc[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  uint32_t hrow = 0;
  if (kDrop) hrow = drop_row_hash(a.drop.key, bb * a.nh + hh, q0 + r);

  for (int k0 = 0; k0 < tk; k0 += kBK) {
    // causal: every later key tile is dead for this query tile
    if (kCausal && !causal_tile_live(q0, kBQ, tq, k0)) break;
    __syncthreads();  // previous tile's Ks/Vs/Ss reads are done
    load_tile<kThreads>(Ks, ks, kb, a.ks[1], k0, kBK, tk, dh);
    load_tile<kThreads>(Vs, dh, vb, a.vs[1], k0, kBK, tk, dh);
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
    for (int i = 0; i < 4; ++i) {
      int row = rg * 4 + i;
      int qr = q0 + row;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = cg * 4 + e;
        int key = k0 + col;
        float val;
        if (key >= tk || (kCausal && key > qr)) {
          val = -INFINITY;  // ragged key tile or future key: zero weight
        } else {
          val = s[i][e] * a.scale;
          if (biasb != nullptr && qr < tq)
            val += biasb[(long long)qr * a.sq + key];
        }
        Ss[row * ss + col] = val;
      }
    }
    __syncthreads();

    // online softmax for row r over this tile
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) tmax = fmaxf(tmax, Ss[r * ss + c + 4 * i]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    // finite: the first tile holds key 0, live for every row (causal
    // too, ragged rows past tq included); a later tile whose keys are all
    // masked for this row leaves m_run as it was
    const float m_new = fmaxf(m_run, tmax);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      float p = expf(Ss[r * ss + c + 4 * i] - m_new);
      psum += p;  // l sums the undropped terms
      if (kDrop)
        p *= drop_scale(hrow, k0 + c + 4 * i, a.drop.thresh,
                        a.drop.keep_scale);
      Ss[r * ss + c + 4 * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // row r's probabilities were written by its own warp

    const int nkeys = min(kBK, tk - k0);
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) acc[j] *= alpha;
    // unrolled by hand: left to itself the compiler runs this loop one key
    // at a time and re-tests d < dh per key (2x the device time at tk=128)
#pragma unroll 4
    for (int key = 0; key < nkeys; ++key) {
      const float p = Ss[r * ss + key];
      const float* vrow = Vs + key * dh;
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) {
        int d = c + 4 * j;
        if (d < dh) acc[j] = fmaf(p, vrow[d], acc[j]);
      }
    }
  }

  const int qr = q0 + r;
  if (qr < tq) {
    const float inv = 1.f / l_run;
    T* ob = static_cast<T*>(a.out) + bb * a.os[0] + qr * a.os[1] +
            hh * a.os[2];
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      int d = c + 4 * j;
      if (d < dh) ob[d] = from_f32<T>(acc[j] * inv);
    }
    if (c == 0)
      a.lse[bb * a.ls[0] + qr * a.ls[1] + hh * a.ls[2]] =
          m_run + logf(l_run);
  }
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
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (kDrop) hrow[i] = drop_row_hash(a.drop.key, bb * nh + hh, rrow[i]);
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
    const size_t smem = smem_bytes(a.dh);
    cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<float, kDh, kDrop, kCausal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.tq + kBQ - 1) / kBQ, a.nh, b);
    fwd_kernel<float, kDh, kDrop, kCausal>
        <<<grid, kThreads, smem, stream>>>(a);
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

// The dropout mask as the attention kernels apply it: out[b, q, h, j] =
// keep_scale where kept, else 0 (f32, contiguous [b, tq, h, tk]).
__global__ void mask_kernel(float* __restrict__ out, int tq, int nh, int tk,
                            long long n, Dropout drop) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int col = (int)(i % tk);
  const long long rest = i / tk;
  const int hh = (int)(rest % nh);
  const long long bq = rest / nh;
  const int qr = (int)(bq % tq);
  const int bb = (int)(bq / tq);
  const uint32_t hrow = drop_row_hash(drop.key, bb * nh + hh, qr);
  out[i] = drop_scale(hrow, col, drop.thresh, drop.keep_scale);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). Pointers are device pointers;
// `bias` may be null. `strides` (host memory) holds 15 element strides:
// (batch, time, head) of q, k, v, out and lse, in that order; the head
// dim of q, k, v and out is contiguous. With `causal`, keys past the
// query row are masked in-kernel. With `use_dropout`, the mask is keyed
// by `drop_key` and keeps a score when its hash is below `drop_thresh`,
// scaling it by `keep_scale`. `stream` is a cudaStream_t. bf16 runs the
// tensor-core kernel, f32 the CUDA-core one.
int pt_flash_attention_bthd_fwd(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse, int b,
                                int tq, int tk, int h, int dh,
                                const long long* strides, long long sb,
                                long long sh, long long sq, float scale,
                                int is_bf16, int causal, int use_dropout,
                                unsigned int drop_key,
                                unsigned int drop_thresh, float keep_scale,
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
  a.drop = pt_attn::Dropout{drop_key, drop_thresh, keep_scale};
  a.vec = dh % 8 == 0 && rows_aligned(q, a.qs) && rows_aligned(k, a.ks) &&
          rows_aligned(v, a.vs) && rows_aligned(out, a.os);
  a.bias_vec = reinterpret_cast<uintptr_t>(bias) % 16 == 0 && sb % 4 == 0 &&
               sh % 4 == 0 && sq % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = use_dropout != 0, cz = causal != 0;
  cudaError_t err = is_bf16 ? launch<TensorCoreBf16>(a, b, drop, cz, s)
                            : launch<CudaCoreF32>(a, b, drop, cz, s);
  return (int)err;
}

// Writes the scaled keep mask of a [b, tq, h, tk] attention into `out`
// (f32, contiguous [b, tq, h, tk]).
int pt_dropout_keep_mask(void* out, int b, int tq, int h, int tk,
                         unsigned int drop_key, unsigned int drop_thresh,
                         float keep_scale, void* stream) {
  if (b < 1 || tq < 1 || h < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)b * tq * h * tk;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mask_kernel<<<(unsigned int)blocks, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), tq, h, tk, n,
      pt_attn::Dropout{drop_key, drop_thresh, keep_scale});
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
