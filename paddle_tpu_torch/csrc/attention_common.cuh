// Device helpers shared by the attention kernels
// (flash_attention_bthd_fwd.cu, flash_attention_bthd_bwd.cu): conversion
// to f32, the dropout keep mask and the causal tile test.
//
// Dropout keep mask. The TPU kernels draw their mask from the TPU's own
// generator, keyed by absolute 128-row blocks so forward and backward
// regenerate the same bits whatever their tiling. Here the mask is a
// stateless hash of absolute positions, never of tile sizes:
//   s     = the op seed: mix64(*seed, op_idx), or *seed itself when
//           op_idx < 0 (seed points to a 0-d int64 in device memory, so a
//           CUDA graph replays a new mask each step; core/rng.py)
//   key   = fmix32(fmix32(lo32(s) ^ 0x9E3779B9) ^ hi32(s))
//   hrow  = fmix32(fmix32(key ^ (batch * heads + head)) ^ query_row)
//   bits  = fmix32(hrow ^ key_column)
//   keep  = bits < thresh,  thresh = min(floor((1 - p) * 2^32), 2^32 - 1)
// and a kept probability is scaled by keep_scale = 1/(1 - p) in f32.
// fmix32 is MurmurHash3's 32-bit finalizer. The plain PyTorch version
// (dropout_keep_mask_plain in parallel/flash_attention.py) computes the
// same bits with integer tensor ops, so kernel and plain agree bit for
// bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt_attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The dropout arguments of a launch (see above).
struct Dropout {
  const long long* seed;  // the run's seed buffer, or the op seed
  int op_idx;             // the op's index; < 0: *seed is the op seed
  uint32_t thresh;
  float keep_scale;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// splitmix64 of base + (idx + 1) * golden, cut to 63 bits: the op seed
// of op idx of a step seed (core/rng.py mix64).
__device__ __forceinline__ uint64_t mix64(uint64_t base, int idx) {
  uint64_t z = base + (uint64_t)(idx + 1) * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (z ^ (z >> 31)) >> 1;
}

// The 32-bit stream key of a launch, read and mixed from device memory.
__device__ __forceinline__ uint32_t stream_key(const Dropout& d) {
  uint64_t s = (uint64_t)__ldg(d.seed);
  if (d.op_idx >= 0) s = mix64(s, d.op_idx);
  return fmix32(fmix32((uint32_t)s ^ 0x9E3779B9u) ^ (uint32_t)(s >> 32));
}

// Per-(batch*heads + head, query row) prefix of the keep-mask hash.
__device__ __forceinline__ uint32_t drop_row_hash(uint32_t key, int bh,
                                                  int row) {
  return fmix32(fmix32(key ^ (uint32_t)bh) ^ (uint32_t)row);
}

// Scale of one score: keep_scale where the mask keeps it, else 0.
__device__ __forceinline__ float drop_scale(uint32_t hrow, int col,
                                            uint32_t thresh,
                                            float keep_scale) {
  return fmix32(hrow ^ (uint32_t)col) < thresh ? keep_scale : 0.f;
}

// Causal attention (the TPU kernels' top-left mask: a score is live iff
// key <= query row). Does the tile of query rows [q0, q0 + nrows), cut at
// tq, and keys from k0 on hold any live score? The forward and both
// backward passes walk their tiles through this one test, so they skip
// exactly the same (query tile, key tile) pairs, as `_causal_live` does
// for the TPU kernels. Key 0 is live for every row, so the first key
// tile is never skipped and every row's softmax has a finite maximum.
__device__ __forceinline__ bool causal_tile_live(int q0, int nrows, int tq,
                                                 int k0) {
  return k0 <= min(q0 + nrows, tq) - 1;
}

}  // namespace pt_attn
