// Single-pass attention forward for Hopper (sm_90a), with an optional
// in-kernel causal mask and in-kernel dropout; and the dump of its
// dropout mask.
//
// One kernel family replaces four TPU forward kernels
// (paddle_tpu/parallel/flash_attention.py), one per route of
// `attention_route` in parallel/flash_attention.py:
//   small  `_fwd_small_kernel` (:808), 8 <= tq, tk <= 512;
//   kblock `_fwd_kb_kernel` (:964), 512 < tk <= 1024, causal in-kernel;
//   bhtd   `_fwd_kernel` (:126), the BHTD forward (t > 1024, and the
//          decode step over a cache longer than 512), causal in-kernel.
// It computes, for every (batch, query row, head):
//   s_j  = scale * <q, k_j> + bias[b|1, h|1, q|1, j]     (f32)
//   s_j  = -inf where causal and j > q                   (kCausal)
//   p_j  = exp(s_j - m) / l,  m = max_j s_j, l = sum_j exp(s_j - m)
//   out  = sum_j p_j M_j v_j                              (q's dtype)
//   lse  = m + log(l)                                     (f32)
// where M_j is the dropout keep mask scaled by 1/(1 - p_drop) in f32
// (attention_common.cuh), or 1 without dropout. As in the TPU kernels,
// l and lse are the undropped softmax's: the mask multiplies only the
// exp(s - m) terms that feed the output accumulator. q, k, v, out
// ([b, t, h, dh] views) and lse ([b, tq, h]) are addressed through
// (batch, time, head) element strides with a contiguous head dim, so
// BTHD tensors, the q/k/v views of a fused QKV projection and BHTD
// tensors all run with no copy; the optional f32 additive bias is
// addressed through element strides too (0 on a broadcast dim). On the
// small route the caller folds causal attention into the bias; on the
// other two the kernel masks it and builds no [tq, tk] tensor. tk has no
// bound: K and V stream through shared memory, and every offset that
// can pass 2^31 (t = 8192 and beyond) is computed in 64 bits.
//
// What bounds it on the H100: 4*b*h*tq*tk*dh FLOP (2*b*h*sum(live keys)*
// dh*2 under the causal mask) over the bytes of q, k, v, out and lse; at
// every shape of the repo's paths the FLOP dominate. This version runs
// them on the f32 CUDA cores from shared memory (67 TFLOP/s peak), not
// on the tensor cores (989 TFLOP/s bf16), and reads ~8-9 TFLOP/s at the
// training shapes (PERF.md).
//
// What the design does about it: one thread block per (32-row query tile,
// head, batch) gives b*h*ceil(tq/32) independent blocks instead of the TPU
// kernel's sequential grid; K and V stream through shared memory in 64-key
// tiles (loaded once per block, reused by all 32 query rows), and an
// online softmax keeps the running max, sum and the [32 x dh] output
// tile in registers, so no score matrix ever reaches device memory. Under
// the causal mask a block stops after its last live key tile
// (causal_tile_live), which halves the work of a long self-attention.
// With few blocks per SM at serving shapes, global-load latency is
// exposed, so each thread issues its tile loads in batches before storing
// any to shared memory. The head width is a template bound (64 or 128) so
// the accumulator holds no dead columns at dh=64, and dropout and causal
// are template flags, so p_drop = 0 and causal = false compile to the
// kernel without them. The mask is a hash of absolute (batch, head, row,
// column), so the backward kernel regenerates it whatever its tiling. All
// arithmetic is f32; bf16 inputs are widened on load. Ragged edges (rows
// past tq, keys past tk) are masked. Tensor cores, TMA and warp
// specialisation are left to a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxDh = 128;

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

template <typename T, int kDhMax, bool kDrop, bool kCausal>
cudaError_t launch_cfg(const FwdArgs& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.dh);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, kDhMax, kDrop, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.tq + kBQ - 1) / kBQ, a.nh, b);
  fwd_kernel<T, kDhMax, kDrop, kCausal><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kDhMax, bool kDrop>
cudaError_t launch_causal(const FwdArgs& a, int b, bool causal,
                          cudaStream_t stream) {
  return causal ? launch_cfg<T, kDhMax, kDrop, true>(a, b, stream)
                : launch_cfg<T, kDhMax, kDrop, false>(a, b, stream);
}

template <typename T, int kDhMax>
cudaError_t launch_drop(const FwdArgs& a, int b, bool drop, bool causal,
                        cudaStream_t stream) {
  return drop ? launch_causal<T, kDhMax, true>(a, b, causal, stream)
              : launch_causal<T, kDhMax, false>(a, b, causal, stream);
}

template <typename T>
cudaError_t launch(const FwdArgs& a, int b, bool drop, bool causal,
                   cudaStream_t stream) {
  return a.dh <= 64 ? launch_drop<T, 64>(a, b, drop, causal, stream)
                    : launch_drop<T, kMaxDh>(a, b, drop, causal, stream);
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
// scaling it by `keep_scale`. `stream` is a cudaStream_t.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = use_dropout != 0, cz = causal != 0;
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, b, drop, cz, s)
                            : launch<float>(a, b, drop, cz, s);
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
