// The attention kernels' scaled dropout keep mask, dumped to device
// memory, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dump_masks` (tests/test_flash_attention_tpu.py:
// 26): out[b, q, h, j] = keep_scale where the keep-mask hash of (batch,
// head, query row q, key column j) is below the threshold, else 0, f32,
// contiguous [b, tq, h, tk]. The hash is attention_common.cuh's, so the
// dump equals both the mask the attention kernels apply and
// dropout_keep_mask_plain, bit for bit.
//
// What bounds it on the H100: bytes. It reads nothing and writes 4 bytes
// an element (134 MB at [64, 256, 8, 256]: 0.040 ms at 3.35 TB/s); the
// hash is one fmix32 an element once the row prefix is known.
//
// What the design does about it: a block writes one (b, q) row of the
// output, h runs of tk contiguous floats, with a warp a run (a 2-D grid:
// no 64-bit division is left); the warp hashes the run's prefix
// drop_row_hash(b * h + head, q) once, then each lane writes four
// columns as one 16-byte streaming store (nothing re-reads the dump). A
// run that does not start 16-byte aligned, or whose length is no multiple
// of 4, writes its head and tail element by element (mask_run_split in
// parallel/flash_attention.py models the split).
//
// The `dropout` op's forward (dropout_apply_kernel; the JAX op draws its
// mask with jax.random, no Pallas kernel): one pass that reads x and
// writes Out and the uint8 Mask. Element i is kept iff
// drop_row_hash(key, hi32(i), lo32(i)) < thresh, with the key of the op
// seed read from device memory (attention_common.cuh), so a CUDA graph
// replays a new mask each step. Out = x * keep_scale (upscale_in_train,
// one f32 product rounded once to x's dtype) or x (downgrade_in_infer)
// where kept, else +0. dropout_plain in ops/nn_ops.py gives the same bits.
//
// What bounds it on the H100: bytes, 2 * sizeof(x) + 1 an element (42 MB
// for the t = 256 step's [64, 256, 512] bf16: 0.0125 ms at 3.35 TB/s);
// the hash is two fmix32 an element. Each thread moves 16 bytes of x and
// Out at a time (4 f32 or 8 bf16) and their 4 or 8 mask bytes in one
// store, in a grid-stride loop; the n % 4 or n % 8 tail goes element by
// element. Plain loads and stores: the next op reads Out, and x is often
// a residual that is read again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"

namespace {

using pt_attn::drop_row_hash;
using pt_attn::drop_scale;
using pt_attn::Dropout;

constexpr int kMaxWarps = 8;

// blockIdx.x = q, blockIdx.y = b; warp w writes heads w, w + nwarps, ...
__global__ void dropout_mask_kernel(float* __restrict__ out, int tq, int nh,
                                    int tk, Dropout drop) {
  const int qr = blockIdx.x, bb = blockIdx.y, lane = threadIdx.x;
  const size_t row = ((size_t)bb * tq + qr) * nh;  // the row's first run
  const uint32_t key = pt_attn::stream_key(drop);
  for (int hh = threadIdx.y; hh < nh; hh += blockDim.y) {
    const uint32_t hrow = drop_row_hash(key, bb * nh + hh, qr);
    const size_t start = (row + hh) * (size_t)tk;
    float* run = out + start;
    // head: columns before the first 16-byte boundary; then float4s; tail
    const int head = min(tk, (int)((4 - (start & 3)) & 3));
    const int nvec = (tk - head) >> 2;
    const int tail0 = head + 4 * nvec;
    if (lane < head)
      run[lane] = drop_scale(hrow, lane, drop.thresh, drop.keep_scale);
    for (int v = lane; v < nvec; v += 32) {
      const int col = head + 4 * v;
      float4 f;
      f.x = drop_scale(hrow, col, drop.thresh, drop.keep_scale);
      f.y = drop_scale(hrow, col + 1, drop.thresh, drop.keep_scale);
      f.z = drop_scale(hrow, col + 2, drop.thresh, drop.keep_scale);
      f.w = drop_scale(hrow, col + 3, drop.thresh, drop.keep_scale);
      __stcs(reinterpret_cast<float4*>(run + col), f);
    }
    if (tail0 + lane < tk)
      run[tail0 + lane] =
          drop_scale(hrow, tail0 + lane, drop.thresh, drop.keep_scale);
  }
}

template <typename T>
struct DropVec;  // 16 bytes of x or Out, and the mask bytes beside them
template <>
struct DropVec<float> {
  static constexpr int kN = 4;
  typedef uint32_t Mask;
};
template <>
struct DropVec<__nv_bfloat16> {
  static constexpr int kN = 8;
  typedef uint2 Mask;
};

__device__ __forceinline__ float drop_out(float x, bool keep, bool upscale,
                                          float keep_scale) {
  return keep ? (upscale ? __fmul_rn(x, keep_scale) : x) : 0.f;
}
__device__ __forceinline__ __nv_bfloat16 drop_out(__nv_bfloat16 x, bool keep,
                                                  bool upscale,
                                                  float keep_scale) {
  if (!keep) return __float2bfloat16_rn(0.f);
  return upscale ? __float2bfloat16_rn(
                       __fmul_rn(__bfloat162float(x), keep_scale))
                 : x;
}

template <typename T, bool kUpscale>
__global__ void __launch_bounds__(256)
    dropout_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                       uint8_t* __restrict__ mask, long long n,
                       Dropout drop) {
  constexpr int kN = DropVec<T>::kN;
  const uint32_t key = pt_attn::stream_key(drop);
  const long long nvec = n / kN;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = first; v < nvec; v += stride) {
    const long long i0 = v * kN;  // kN divides 2^32: one hi32 a vector
    const uint32_t hhi = pt_attn::fmix32(key ^ (uint32_t)(i0 >> 32));
    const uint4 raw = reinterpret_cast<const uint4*>(x)[v];
    T e[kN], r[kN];
    memcpy(e, &raw, sizeof(raw));
    uint8_t m[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const bool keep =
          pt_attn::fmix32(hhi ^ (uint32_t)(i0 + j)) < drop.thresh;
      m[j] = keep;
      r[j] = drop_out(e[j], keep, kUpscale, drop.keep_scale);
    }
    uint4 res;
    memcpy(&res, r, sizeof(res));
    reinterpret_cast<uint4*>(out)[v] = res;
    typename DropVec<T>::Mask mv;
    memcpy(&mv, m, sizeof(mv));
    reinterpret_cast<typename DropVec<T>::Mask*>(mask)[v] = mv;
  }
  const long long i = nvec * kN + first;  // the tail, element by element
  if (i < n) {
    const bool keep = drop_row_hash(key, (int)(uint32_t)(i >> 32),
                                    (int)(uint32_t)i) < drop.thresh;
    mask[i] = keep;
    out[i] = drop_out(x[i], keep, kUpscale, drop.keep_scale);
  }
}

template <typename T>
cudaError_t launch_dropout(const void* x, void* out, void* mask, long long n,
                           bool upscale, Dropout drop, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long nvec = n / DropVec<T>::kN;
  // at most 16 blocks an SM of the H100's 132; the loop strides over
  // the rest
  const long long want = (nvec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : want < 132 * 16 ? want : 132 * 16);
  auto kernel = upscale ? dropout_apply_kernel<T, true>
                        : dropout_apply_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<T*>(out),
                                          static_cast<uint8_t*>(mask), n,
                                          drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Writes the scaled keep mask of a [b, tq, h, tk] attention into `out`
// (f32, contiguous [b, tq, h, tk], 16-byte aligned), keyed by the op seed
// that `drop_seed` (device memory) and `drop_op` give
// (attention_common.cuh). Returns a cudaError_t (0 = launched); `stream`
// is a cudaStream_t.
int pt_dropout_keep_mask(void* out, int b, int tq, int h, int tk,
                         const long long* drop_seed, int drop_op,
                         unsigned int drop_thresh, float keep_scale,
                         void* stream) {
  if (b < 1 || tq < 1 || h < 1 || tk < 1 || b > 65535 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 threads(32, h < kMaxWarps ? h : kMaxWarps);
  dropout_mask_kernel<<<dim3(tq, b), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), tq, h, tk,
      Dropout{drop_seed, drop_op, drop_thresh, keep_scale});
  return (int)cudaGetLastError();
}

// The `dropout` op's training forward over `n` contiguous elements of x
// (f32, or bf16 with `is_bf16`; 16-byte aligned, as Out): Out and the
// uint8 Mask (aligned to 4 or 8 bytes) as the top of this file says.
// Returns a cudaError_t (0 = launched); `stream` is a cudaStream_t.
int pt_dropout_fwd(const void* x, void* out, void* mask, long long n,
                   int is_bf16, int upscale, const long long* drop_seed,
                   int drop_op, unsigned int drop_thresh, float keep_scale,
                   void* stream) {
  if (n < 1 || drop_seed == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 8)
    return (int)cudaErrorInvalidValue;
  const Dropout drop{drop_seed, drop_op, drop_thresh, keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_dropout<__nv_bfloat16>(x, out, mask, n,
                                                       upscale != 0, drop, s)
                       : launch_dropout<float>(x, out, mask, n, upscale != 0,
                                               drop, s));
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
