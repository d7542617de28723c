// The greedy NMS sweep of the detection ops, for Hopper (sm_90a): a
// packed bitmask of the pairwise tests, built across the whole card, and a
// warp scan over it.
//
// Replaces no Pallas kernel: the JAX package runs the sweep as one device
// loop, jax.lax.fori_loop over the candidates (paddle_tpu/ops/
// vision_ops.py:228-243 `_nms_keep`, the multiclass NMS; paddle_tpu/ops/
// detection_ops.py:455-469 `_nms_mask`, the RPN proposals). Its plain
// PyTorch version, nms_sweep_plain in ops/vision_ops.py, loops on the host
// over an [B, m, m] IoU matrix: about four small kernels a candidate, and
// at YOLOv3's evaluation (640 sets of 1000) a 2.56 GB matrix.
//
// What it computes: for each candidate set b, boxes already sorted by
// score, keep[i] = keep0[i] && !any_{j<i}(keep[j] && IoU(i, j) > thr), with
// vision_ops' IoU (_iou_matrix): inter / max(union, 1e-10), area =
// max(x2 - x1, 0) * max(y2 - y1, 0), inter the clamped overlap of the same
// form, union = (area_i + area_j) - inter. Each IoU is computed with
// __f*_rn / __d*_rn intrinsics in the plain version's order of operations
// (no contraction into FMAs), the later candidate the first operand as in
// the plain version's over[later, earlier], and max / min pass a NaN
// through as torch's maximum / minimum / clamp_min do, so every `>` test,
// and the mask, equals the plain version's bit for bit, NaN and infinite
// boxes included.
//
// One IoU serves both JAX loops. box_util.iou_xyxy (the RPN's) differs
// from this one only where union <= 0 or union is NaN, where it gives 0.
// Rounding is monotone, so inter <= min(area_i, area_j) and
// union = fl(fl(a_i + a_j) - inter) >= 0 unless a box holds a NaN (or an
// inf - inf); union == 0 needs a_i == a_j == inter == 0, and then this form
// gives 0 / 1e-10 = 0 too. A NaN IoU fails `> thr`, as 0 does, for every
// thr >= 0: the two give the same mask there. (Below 0 they differ where
// a NaN meets: detection_ops._nms_mask takes that case itself.)
//
// What bounds it on the H100: a sequential sweep needs up to m(m-1)/2 IoU
// tests a set (about 15 floating-point operations each) and reads 16m
// bytes, but the tests of row i depend on the decisions of rows j < i, so
// a set done in that order is a chain of m dependent steps. A block a set
// with a barrier a step (the first design) spent ~1.3 us a step and kept
// two SMs of 132 busy at two sets. Here the tests, all m(m-1)/2 of them,
// are operations spread over the card, and the chain is m / 64 chunk steps
// of one warp.
//
// What the design does about it: two kernels, launched by one entry.
// (1) nms_sweep_mask_kernel does every upper-triangle test, independent of
// the order, spread over the card: a block takes 64 rows (earlier
// candidates) against 64 columns (later ones) of one set, only blocks cb >=
// rb, both sets of boxes staged in shared memory. Each warp first runs a
// branch-free filter over all 64 columns (may_over: four compares and the
// boxes' own extents, a necessary condition of a hit at thr >= 0), then
// queues the surviving (row, column) pairs in shared memory and splits them
// evenly over its lanes for the exact test, ORing each hit into the row's
// word in shared memory (the OR's order changes no bit). The words go to
// the mask [sets, m, Wp] (W = ceil(m / 64), Wp = W rounded up to even; bit
// jj of word (i, cb): j = 64 cb + jj > i and IoU(j, i) > thr); words below
// the diagonal are never written, and never read. The diagonal blocks also
// write each candidate's column word (the earlier rows of its own chunk
// that it overlaps). (2) nms_sweep_scan_kernel walks the order, one warp a
// set (two sets a block where the sets fill the SMs), with no block barrier
// and no atomics, a chunk of 64 candidates at a time. A chunk keeps the
// fixpoint of K = live and not overlapped by an earlier row of K (its
// column words; a round is two ballots, t rounds fix its first t rows, and
// a round that changes nothing ends), live being keep0 less the bits of
// removed word c. The kept rows' later words are then ORed into the
// `removed` bitset, which the lanes hold in registers (lane l the words l,
// l + 32, ... of a window of 32 NW words), from a tile of the chunk's rows
// that 16-byte cp.async copies brought into shared memory two chunks ahead.
// A set wider than a window (W > 192, m > 12,288) is walked in windows:
// entering one, the warp ORs in, from global memory, the window's words of
// every row kept so far. A warp's shared memory is two tiles of a fixed
// size, whatever m; m is bounded only by the mask's m * Wp * 8 bytes a set
// of device memory, which the wrapper allocates (torch.empty; no cudaMalloc
// here).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  // a NaN operand gives NaN, as torch's maximum / minimum / clamp_min
  // (fmaxf / fminf would give the other one): one instruction each
  static __device__ __forceinline__ float max(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ float min(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ float eps() { return 1e-10f; }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  // a NaN operand gives NaN (no max.NaN in f64)
  static __device__ __forceinline__ double max(double a, double b) {
    return (a > b || a != a) ? a : b;
  }
  static __device__ __forceinline__ double min(double a, double b) {
    return (a < b || a != a) ? a : b;
  }
  static __device__ __forceinline__ double eps() { return 1e-10; }
};

typedef unsigned long long u64;

constexpr int kBits = 64;  // candidates a word, a row block, a chunk
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct alignas(4 * sizeof(T)) Box {
  T x1, y1, x2, y2;
};

// ---------------------------------------------------------------------------
// (1) the pairwise tests
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T area(const Box<T>& b) {
  using F = Ieee<T>;
  return F::mul(F::max(F::sub(b.x2, b.x1), T(0)),
                F::max(F::sub(b.y2, b.y1), T(0)));
}

// IoU(f, e) > thr, f the later candidate, exactly as the plain version
// computes over[f, e].
template <typename T>
__device__ __forceinline__ bool over(const Box<T>& f, T fa, const Box<T>& e,
                                     T ea, T thr) {
  using F = Ieee<T>;
  const T zero = T(0);
  const T ix1 = F::max(f.x1, e.x1), iy1 = F::max(f.y1, e.y1);
  const T ix2 = F::min(f.x2, e.x2), iy2 = F::min(f.y2, e.y2);
  const T inter = F::mul(F::max(F::sub(ix2, ix1), zero),
                         F::max(F::sub(iy2, iy1), zero));
  const T uni = F::sub(F::add(fa, ea), inter);
  return F::div(inter, F::max(uni, F::eps())) > thr;
}

// A cheap necessary condition of over() at thr >= 0. An IoU > thr >= 0
// needs inter > 0: no NaN coordinate, and both sides of the overlap > 0,
// min(f.x2, e.x2) - max(f.x1, e.x1) > 0 and the same in y; without NaN a
// rounded difference is > 0 exactly where its operands are ordered, so
// that is f.x2 > e.x1, e.x2 > f.x1 and each box's own x2 > x1 (and in y).
// The boxes' own orders are tested once a box (``extent``); a NaN fails
// every `>`. Where this says no, over() says no.
template <typename T>
__device__ __forceinline__ bool may_over(const Box<T>& f, const Box<T>& e) {
  return f.x2 > e.x1 && e.x2 > f.x1 && f.y2 > e.y1 && e.y2 > f.y1;
}

template <typename T>
__device__ __forceinline__ bool extent(const Box<T>& b) {
  return b.x2 > b.x1 && b.y2 > b.y1;
}

// The block's rows' tests against its 64 staged columns, for the row of
// this thread (row, of the warp's 32 at rows[warp * 32]): bit jj of the
// result where jj is in `valid` and over() holds, the column the later
// candidate (kColumnFirst) or the row (the column words). Two passes: (1)
// may_over() over all 64 columns, unrolled and branch-free; (2) the warp's
// surviving (row, column) pairs, queued in shared memory, split evenly over
// its lanes for over(), each hit ORed into the row's word in shared
// memory (the OR's order changes no bit). At thr < 0 every valid pair is
// queued.
template <typename T, bool kColumnFirst>
__device__ __forceinline__ u64 tests(const Box<T>* cols, const T* col_areas,
                                     const Box<T>* rows, const T* row_areas,
                                     uint16_t* queue, u64* hits, int lane,
                                     int warp, u64 valid, u64 col_extent,
                                     T thr) {
  const int row = warp * 32 + lane;
  u64 maybe = valid;
  if (thr >= T(0)) {
    const Box<T> own = rows[row];
    u64 may = 0;
#pragma unroll
    for (int jj = 0; jj < kBits; ++jj)
      if (may_over(cols[jj], own)) may |= 1ull << jj;
    maybe &= extent(own) ? may & col_extent : 0ull;
  }
  const int n = __popcll(maybe);
  int end = n;  // this lane's end in the warp's queue
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += y;
  }
  const int total = __shfl_sync(kFull, end, 31);
  for (int q = end - n; maybe; ++q) {
    queue[q] = (uint16_t)((lane << 6) | (__ffsll((long long)maybe) - 1));
    maybe &= maybe - 1;
  }
  hits[row] = 0;
  __syncwarp();
  for (int q = lane; q < total; q += 32) {
    const int e = queue[q], r = warp * 32 + (e >> 6), jj = e & 63;
    const bool hit =
        kColumnFirst
            ? over(cols[jj], col_areas[jj], rows[r], row_areas[r], thr)
            : over(rows[r], row_areas[r], cols[jj], col_areas[jj], thr);
    // a 32-bit OR into the word's half: one instruction (the 64-bit one
    // is a compare-and-swap loop)
    if (hit)
      atomicOr(reinterpret_cast<unsigned*>(&hits[r]) + (jj >> 5),
               1u << (jj & 31));
  }
  __syncwarp();
  return hits[row];
}

// The row and column block of upper-triangle block t (row-major over
// cb >= rb: row block r starts at r * W - r * (r - 1) / 2).
__device__ __forceinline__ void triangle_block(long long t, int W, int& rb,
                                               int& cb) {
  const float b = 2.0f * W + 1.0f;
  long long r = (long long)((b - sqrtf(b * b - 8.0f * (float)t)) * 0.5f);
  r = r < 0 ? 0 : (r > W - 1 ? W - 1 : r);
  while (r > 0 && r * W - r * (r - 1) / 2 > t) --r;
  while (r + 1 < W && (r + 1) * W - (r + 1) * r / 2 <= t) ++r;
  rb = (int)r;
  cb = (int)(r + t - (r * W - r * (r - 1) / 2));
}

// The bits jj in [lo, hi) of a word (0 <= lo, hi <= 64).
__device__ __forceinline__ u64 bit_range(int lo, int hi) {
  const u64 below_hi = hi >= kBits ? ~0ull : (1ull << hi) - 1;
  const u64 below_lo = lo >= kBits ? ~0ull : (1ull << lo) - 1;
  return lo >= hi ? 0ull : below_hi & ~below_lo;
}

// blockIdx.x = set * tri + the set's upper-triangle block; 64 threads, one
// row each. boxes [sets, m, 4]; mask [sets, m, Wp] words (row i, word cb <
// W: bit jj for j = 64 cb + jj > i; Wp = W rounded up to even, the last
// word unused); colw [sets, m] (candidate j: bit ii for i = 64 (j / 64) +
// ii < j, IoU(j, i) > thr), written by the diagonal blocks.
template <typename T>
__global__ void __launch_bounds__(kBits)
    nms_sweep_mask_kernel(const T* __restrict__ boxes, u64* __restrict__ mask,
                          u64* __restrict__ colw, int m, int W, int Wp,
                          unsigned tri, T thr) {
  __shared__ Box<T> cbox[kBits], rbox[kBits];
  __shared__ T carea[kBits], rarea[kBits];
  __shared__ u64 hits[kBits];
  __shared__ uint16_t queue[2][32 * kBits];
  __shared__ unsigned ext[2];
  const unsigned set32 = blockIdx.x / tri;  // 32-bit: the grid < 2^31
  const long long set = set32;
  int rb, cb;
  triangle_block(blockIdx.x - set32 * tri, W, rb, cb);
  const Box<T>* b = reinterpret_cast<const Box<T>*>(boxes) + set * m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = cb * kBits + tid, i = rb * kBits + tid;
  bool col_ok = false;
  if (j < m) {
    const Box<T> c = b[j];
    cbox[tid] = c;
    carea[tid] = area(c);
    col_ok = extent(c);
  }
  if (i < m) {
    const Box<T> r = b[i];
    rbox[tid] = r;
    rarea[tid] = area(r);
  }
  const unsigned ext_lo = __ballot_sync(kFull, col_ok);
  if (lane == 0) ext[warp] = ext_lo;
  __syncthreads();
  const u64 col_extent = (u64)ext[0] | ((u64)ext[1] << 32);
  // a warp whose rows are all past m has nothing to test
  if (rb * kBits + warp * 32 >= m) return;
  const int jn = min(kBits, m - cb * kBits);
  // only j > i (in the diagonal block the columns after this row's own),
  // j < m, and rows i < m
  const u64 valid = i < m ? bit_range(cb == rb ? tid + 1 : 0, jn) : 0;
  const u64 word = tests<T, true>(cbox, carea, rbox, rarea, queue[warp],
                                  hits, lane, warp, valid, col_extent, thr);
  if (i < m) mask[(set * m + i) * Wp + cb] = word;
  if (cb == rb) {
    const u64 cword =
        tests<T, false>(cbox, carea, rbox, rarea, queue[warp], hits, lane,
                        warp, i < m ? bit_range(0, tid) : 0, col_extent,
                        thr);
    if (i < m) colw[set * m + i] = cword;
  }
}

// ---------------------------------------------------------------------------
// (2) the greedy order
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread's copies but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The 64 bits of a chunk's flags, lane l holding those of rows l, l + 32.
__device__ __forceinline__ u64 ballot64(bool a, bool b) {
  return (u64)__ballot_sync(kFull, a) | ((u64)__ballot_sync(kFull, b) << 32);
}

// OR into the lanes' `removed` words (lane l: word wbase + l + 32 t) the
// words [lo, hi) of the rows of one chunk set in `bits`, read from global
// memory (rows: the chunk's first row), R rows' loads in flight together.
// Entering a window of the removed set only.
template <int NW, int R>
__device__ __forceinline__ void or_rows(u64 (&rem)[NW], const u64* rows,
                                        u64 bits, int Wp, int lo, int hi,
                                        int wbase, int lane) {
  while (bits) {
    int r[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      r[k] = bits ? __ffsll((long long)bits) - 1 : -1;
      bits &= bits - 1;
    }
    u64 v[R][NW];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int t = 0; t < NW; ++t) {
        const int cb = wbase + lane + 32 * t;
        v[k][t] = (r[k] >= 0 && cb >= lo && cb < hi)
                      ? __ldg(rows + (long long)r[k] * Wp + cb)
                      : 0ull;
      }
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int t = 0; t < NW; ++t) rem[t] |= v[k][t];
  }
}

// One warp a set (blockDim.x / 32 sets a block). mask [sets, m, Wp] (the
// upper triangle), colw [sets, m], keep0 / keep [sets, m] bytes. NW: the
// `removed` words a lane holds, a window of kWin = 32 NW words. Shared
// memory a warp: two tiles of 64 rows x kWin words, chunk c's rows' words
// from c + 1 on in the window holding word c + 1, brought by 16-byte
// cp.async two chunks ahead.
template <int NW>
__global__ void __launch_bounds__(64, 1)
    nms_sweep_scan_kernel(const u64* __restrict__ mask,
                          const u64* __restrict__ colw,
                          const uint8_t* __restrict__ keep0, uint8_t* keep,
                          int sets, int m, int W, int Wp) {
  extern __shared__ __align__(128) u64 smem[];
  constexpr int kWin = 32 * NW;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long set = (long long)blockIdx.x * warps + warp;
  if (set >= sets) return;  // uniform over the warp
  u64* tiles = smem + (long long)warp * 2 * kBits * kWin;
  const u64* rows = mask + set * (long long)m * Wp;
  const u64* cw = colw + set * m;
  const uint8_t* k0 = keep0 + set * m;
  uint8_t* out = keep + set * m;

  // chunk c's tile into buffer c & 1, one commit group (empty when the
  // chunk has no later words): its rows' words [c + 1, the end of the
  // window holding c + 1), from an even word on, 16 bytes a copy
  auto issue = [&](int c) {
    if (c + 1 < W) {
      const int wb = (c + 1) / kWin * kWin;
      const int s0 = (c + 1) & ~1, s1 = min(Wp, wb + kWin);
      const int pieces = (s1 - s0) / 2, nrows = min(kBits, m - c * kBits);
      u64* tile = tiles + (c & 1) * kBits * kWin + (s0 - wb);
      const u64* src = rows + (long long)c * kBits * Wp + s0;
      if (NW == 1) {  // <= 16 pieces a row: two rows a copy instruction
        const int k = lane & 15;
        for (int r = lane >> 4; r < nrows; r += 2)
          if (k < pieces)
            cp_async16(tile + r * kWin + 2 * k,
                       src + (long long)r * Wp + 2 * k);
      } else {
        for (int r = 0; r < nrows; ++r)
#pragma unroll
          for (int h = 0; h < (NW + 1) / 2; ++h) {
            const int k = lane + 32 * h;
            if (k < pieces)
              cp_async16(tile + r * kWin + 2 * k,
                         src + (long long)r * Wp + 2 * k);
          }
      }
    }
    cp_async_commit();
  };

  u64 rem[NW];
#pragma unroll
  for (int t = 0; t < NW; ++t) rem[t] = 0;
  issue(0);
  issue(1);
  uint8_t ka = lane < m ? k0[lane] : 0, kb = lane + 32 < m ? k0[lane + 32] : 0;
  u64 ca = lane < m ? cw[lane] : 0, cbw = lane + 32 < m ? cw[lane + 32] : 0;
  u64 cur = 0;  // removed word c
  int wbase = 0;
  for (int c = 0; c < W; ++c) {
    // the next chunk's keep0 and column words in flight
    const int i = (c + 1) * kBits + lane;
    const bool more = c + 1 < W;
    const uint8_t na = more && i < m ? k0[i] : 0,
                  nb = more && i + 32 < m ? k0[i + 32] : 0;
    const u64 nca = more && i < m ? cw[i] : 0,
              ncb = more && i + 32 < m ? cw[i + 32] : 0;

    // the chunk in order: the greedy keep is the fixpoint of K = live and
    // no earlier row of K in the chunk overlaps; K agrees with it on the
    // first t rows after t rounds, and a round that changes nothing ends
    const u64 live = ballot64(ka != 0, kb != 0) & ~cur;
    u64 kept = live;
    for (;;) {
      const u64 k = live & ~ballot64((ca & kept) != 0, (cbw & kept) != 0);
      if (k == kept) break;
      kept = k;
    }
    const int i0 = c * kBits + lane;
    if (i0 < m) out[i0] = (uint8_t)((kept >> lane) & 1);
    if (i0 + 32 < m) out[i0 + 32] = (uint8_t)((kept >> (lane + 32)) & 1);
    if (!more) break;

    if (c + 1 == wbase + kWin) {
      // a new window of the removed set: its words of every row kept
      // before this chunk, from global memory
      __syncwarp();  // the keep bytes above, for every lane
      wbase = c + 1;
      const int hi = min(W, wbase + kWin);
#pragma unroll
      for (int t = 0; t < NW; ++t) rem[t] = 0;
      for (int c2 = 0; c2 < c; ++c2) {
        const int r = c2 * kBits + lane;
        const u64 got = ballot64(r < m && out[r], r + 32 < m && out[r + 32]);
        or_rows<NW, 4>(rem, rows + (long long)c2 * kBits * Wp, got, Wp,
                       wbase, hi, wbase, lane);
      }
    }
    // this chunk's kept rows' words from c + 1 on (the tile's words below
    // c + 1 and past W are stale or unwritten: they land in words of
    // `removed` no later chunk reads)
    cp_async_wait_all_but_newest();
    __syncwarp();
    const u64* tile = tiles + (c & 1) * kBits * kWin + lane;
    const int t0 = (c + 1 - wbase) >> 5;
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      if (t < t0) continue;  // uniform: words below c + 1 only
      u64 acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < kBits; ++r)
        acc[r & 3] |= (kept >> r) & 1 ? tile[r * kWin + 32 * t] : 0ull;
      rem[t] |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
    }
    // removed word c + 1, from the lane that holds it
    const int off = c + 1 - wbase;
    u64 mine = 0;
#pragma unroll
    for (int t = 0; t < NW; ++t)
      if (t == off >> 5) mine = rem[t];
    cur = __shfl_sync(kFull, mine, off & 31);
    __syncwarp();  // every lane is done with this tile
    issue(c + 2);
    ka = na;
    kb = nb;
    ca = nca;
    cbw = ncb;
  }
}

template <typename T>
cudaError_t launch_mask(const void* boxes, u64* mask, u64* colw, int sets,
                        int m, int W, int Wp, double thr,
                        cudaStream_t stream) {
  const long long tri = (long long)W * (W + 1) / 2;
  const long long blocks = tri * sets;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  nms_sweep_mask_kernel<T><<<(unsigned)blocks, kBits, 0, stream>>>(
      static_cast<const T*>(boxes), mask, colw, m, W, Wp, (unsigned)tri,
      static_cast<T>(thr));
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_scan(const u64* mask, const u64* colw, const void* keep0,
                        void* keep, int sets, int m, int W, int Wp,
                        cudaStream_t stream) {
  // a set a warp; two a block where the sets fill the SMs and the tiles fit
  constexpr size_t kWarpSmem = 2 * kBits * 32 * NW * sizeof(u64);
  const int warps = NW == 1 && sets >= 2 * 132 ? 2 : 1;
  auto kernel = nms_sweep_scan_kernel<NW>;
  // the most any launch of this instantiation asks, set once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((NW == 1 ? 2 : 1) * kWarpSmem));
  if (opt_in != cudaSuccess) return opt_in;
  kernel<<<(sets + warps - 1) / warps, 32 * warps, warps * kWarpSmem,
           stream>>>(mask, colw, static_cast<const uint8_t*>(keep0),
                     static_cast<uint8_t*>(keep), sets, m, W, Wp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes [sets, m, 4] (f32, or f64 where is_double), keep0 / keep [sets, m]
// bool bytes, work sets * m * (Wp + 1) words of scratch (W = ceil(m / 64),
// Wp = W rounded up to even: the mask [sets, m, Wp], then the column words
// [sets, m]); thr is the threshold already rounded to the boxes' dtype.
// Launches the mask kernel and then the scan; with keep NULL the mask
// kernel alone (the mask is then the result).
int pt_nms_sweep(const void* boxes, const void* keep0, void* keep,
                 void* work, int sets, int m, int is_double, double thr,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = (m + kBits - 1) / kBits, Wp = W + (W & 1);
  u64* mask = static_cast<u64*>(work);
  u64* colw = mask + (long long)sets * m * Wp;
  cudaError_t e =
      is_double
          ? launch_mask<double>(boxes, mask, colw, sets, m, W, Wp, thr, s)
          : launch_mask<float>(boxes, mask, colw, sets, m, W, Wp, thr, s);
  if (e != cudaSuccess || keep == nullptr) return e;
  // one window of 32 words (m <= 2,048: small tiles, two sets a block)
  // or windows of 192 (a tile 64 x 192, one set a block)
  if (W <= 32)
    return launch_scan<1>(mask, colw, keep0, keep, sets, m, W, Wp, s);
  return launch_scan<6>(mask, colw, keep0, keep, sets, m, W, Wp, s);
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
