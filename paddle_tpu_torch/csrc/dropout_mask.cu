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

#include <cuda_runtime.h>
#include <stdint.h>

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
  for (int hh = threadIdx.y; hh < nh; hh += blockDim.y) {
    const uint32_t hrow = drop_row_hash(drop.key, bb * nh + hh, qr);
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

}  // namespace

extern "C" {

// Writes the scaled keep mask of a [b, tq, h, tk] attention into `out`
// (f32, contiguous [b, tq, h, tk], 16-byte aligned). Returns a
// cudaError_t (0 = launched); `stream` is a cudaStream_t.
int pt_dropout_keep_mask(void* out, int b, int tq, int h, int tk,
                         unsigned int drop_key, unsigned int drop_thresh,
                         float keep_scale, void* stream) {
  if (b < 1 || tq < 1 || h < 1 || tk < 1 || b > 65535 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 threads(32, h < kMaxWarps ? h : kMaxWarps);
  dropout_mask_kernel<<<dim3(tq, b), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), tq, h, tk,
      Dropout{drop_key, drop_thresh, keep_scale});
  return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
