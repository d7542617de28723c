// Single-pass attention forward in the BTHD layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_small_kernel`
// (paddle_tpu/parallel/flash_attention.py:808), reached from
// `flash_attention_bthd_fwd` for 8 <= tq, tk <= 512. Computes, for every
// (batch, query row, head):
//   s_j  = scale * <q, k_j> + bias[b|1, h|1, q|1, j]     (f32)
//   out  = sum_j softmax(s)_j v_j                         (q's dtype)
//   lse  = m + log(l), m = max_j s_j, l = sum_j exp(s_j - m)   (f32)
// with q [b, tq, h, dh], k/v [b, tk, h, dh] in f32 or bf16, each with
// contiguous (h, dh) rows and any batch / time strides (so the q/k/v views
// of a fused QKV projection need no copy), out and lse contiguous, and an
// optional f32 additive bias addressed through element strides (0 on a
// broadcast dim). Causal attention reaches the kernel folded into the bias.
//
// What bounds it on the H100: at the serving prefill shape (b=1, t=128,
// h=8, dh=64) the work is 33.5 MFLOP over ~1 MB, so the card's limit is
// ~0.5 us of f32 arithmetic. This version takes ~28 us there (H100 SXM,
// 700 W): the grid is only 32 blocks of 4 warps, one per SM, so nothing
// hides global-load latency, and the O(tq*tk*dh) multiply-adds run on the
// f32 CUDA cores from shared memory, not on the tensor cores (wgmma).
//
// What the design does about it: one thread block per (32-row query tile,
// head, batch) gives b*h*ceil(tq/32) independent blocks instead of the TPU
// kernel's whole-tk-resident programs; K and V stream through shared memory
// in 64-key tiles (loaded once per block, reused by all 32 query rows), and
// an online softmax keeps the running max, sum and the [32 x dh] output
// tile in registers, so no score matrix ever reaches device memory. With
// few blocks per SM at serving shapes, global-load latency is exposed, so
// each thread issues its tile loads in batches of kLdBatch before storing
// any to shared memory. The head width is a template bound (64 or 128) so
// the accumulator holds no dead columns at dh=64. All arithmetic is f32;
// bf16 inputs are widened on load. Ragged edges (rows past tq, keys past
// tk) are masked. Tensor cores, TMA and warp specialisation are left to a
// later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxDh = 128;
constexpr int kLdBatch = 8;    // global loads a thread issues before storing

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int dh) {
  // Qs [BQ][dh], Ks [BK][dh+1], Vs [BK][dh], Ss [BQ][BK+1], all f32
  return sizeof(float) *
         (size_t)(kBQ * dh + kBK * (dh + 1) + kBK * dh + kBQ * (kBK + 1));
}

// Copies rows [row0, row0 + nrows) x [0, dh) of a strided [t, dh] source
// (rows past `limit` read as zeros) into shared memory at stride `sstride`.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int sstride,
                                          const T* __restrict__ src,
                                          long long rstride, int row0,
                                          int nrows, int limit, int dh) {
  const int n = nrows * dh;
  for (int base = 0; base < n; base += kThreads * kLdBatch) {
    float buf[kLdBatch];
#pragma unroll
    for (int u = 0; u < kLdBatch; ++u) {
      int i = base + u * kThreads + threadIdx.x;
      int r = i / dh, d = i - r * dh;
      bool ok = i < n && row0 + r < limit;
      buf[u] = ok ? to_f32(src[(long long)(row0 + r) * rstride + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLdBatch; ++u) {
      int i = base + u * kThreads + threadIdx.x;
      int r = i / dh, d = i - r * dh;
      if (i < n) dst[r * sstride + d] = buf[u];
    }
  }
}

template <typename T, int kDhMax>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           T* __restrict__ out, float* __restrict__ lse, int tq, int tk,
           int nh, int dh, long long qsb, long long qst, long long ksb,
           long long kst, long long vsb, long long vst, long long sb,
           long long sh, long long sq, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][dh]
  float* Ks = Qs + kBQ * dh;          // [kBK][dh + 1]
  float* Vs = Ks + kBK * (dh + 1);    // [kBK][dh]
  float* Ss = Vs + kBK * dh;          // [kBQ][kBK + 1]
  const int ks = dh + 1, ss = kBK + 1;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const long long row_stride = (long long)nh * dh;  // out's time stride
  const T* qb = q + (long long)bb * qsb + (long long)hh * dh;
  const T* kb = k + (long long)bb * ksb + (long long)hh * dh;
  const T* vb = v + (long long)bb * vsb + (long long)hh * dh;
  const float* biasb =
      bias == nullptr ? nullptr : bias + (long long)bb * sb + (long long)hh * sh;

  // Q tile -> shared (rows past tq read as zeros and are never stored)
  load_tile(Qs, dh, qb, qst, q0, kBQ, tq, dh);

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

  for (int k0 = 0; k0 < tk; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ss reads are done
    load_tile(Ks, ks, kb, kst, k0, kBK, tk, dh);
    load_tile(Vs, dh, vb, vst, k0, kBK, tk, dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[a][e] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qs[(rg * 4 + a) * dh + d];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = Ks[(cg * 4 + e) * ks + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[a][e] = fmaf(qv[a], kv[e], s[a][e]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      int row = rg * 4 + a;
      int qr = q0 + row;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = cg * 4 + e;
        int key = k0 + col;
        float val;
        if (key >= tk) {
          val = -INFINITY;  // ragged key tile: zero weight
        } else {
          val = s[a][e] * scale;
          if (biasb != nullptr && qr < tq)
            val += biasb[(long long)qr * sq + key];
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
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile has a key
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      float p = expf(Ss[r * ss + c + 4 * i] - m_new);
      Ss[r * ss + c + 4 * i] = p;
      psum += p;
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
    T* ob = out + ((long long)bb * tq * nh + hh) * dh + (long long)qr * row_stride;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      int d = c + 4 * j;
      if (d < dh) ob[d] = from_f32<T>(acc[j] * inv);
    }
    if (c == 0)
      lse[((long long)bb * tq + qr) * nh + hh] = m_run + logf(l_run);
  }
}

template <typename T, int kDhMax>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* lse, int b, int tq,
                   int tk, int h, int dh, const long long* st, long long sb,
                   long long sh, long long sq, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, kDhMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBQ - 1) / kBQ, h, b);
  fwd_kernel<T, kDhMax><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, tq, tk, h,
      dh, st[0], st[1], st[2], st[3], st[4], st[5], sb, sh, sq, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* lse, int b, int tq,
                   int tk, int h, int dh, const long long* st, long long sb,
                   long long sh, long long sq, float scale,
                   cudaStream_t stream) {
  return dh <= 64 ? launch_dh<T, 64>(q, k, v, bias, out, lse, b, tq, tk, h,
                                     dh, st, sb, sh, sq, scale, stream)
                  : launch_dh<T, kMaxDh>(q, k, v, bias, out, lse, b, tq, tk,
                                         h, dh, st, sb, sh, sq, scale,
                                         stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). Pointers are device pointers;
// `bias` may be null. `strides` (host memory) holds the element strides
// of q, k, v over (batch, time): {q_b, q_t, k_b, k_t, v_b, v_t}. `stream`
// is a cudaStream_t.
int pt_flash_attention_bthd_fwd(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse, int b,
                                int tq, int tk, int h, int dh,
                                const long long* strides, long long sb,
                                long long sh, long long sq, float scale,
                                int is_bf16, void* stream) {
  if (dh < 1 || dh > kMaxDh || tq < 1 || tk < 1 || b < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, bf, out, l, b, tq, tk, h, dh,
                                      strides, sb, sh, sq, scale, s)
              : launch<float>(q, k, v, bf, out, l, b, tq, tk, h, dh, strides,
                              sb, sh, sq, scale, s);
  return (int)err;
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
