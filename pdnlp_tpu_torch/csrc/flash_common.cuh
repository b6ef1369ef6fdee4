// What the flash kernels share (flash_fwd.cu: K1; flash_bwd.cu: K2, K3):
// the tile and head sizes, the mask constants and the tile skip rule with
// the warp reduction of a tile's segment-ID range it reads (the tile
// loads and products are in flash_tiles.cuh).
// ops/cuda_lib.py hashes every header into every library's name, so an
// edit here rebuilds them all.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace flash {

constexpr int TILE_Q = 64;
constexpr int TILE_K = 64;
constexpr int HEAD_D = 64;
constexpr int THREADS = 256;                  // the fp32 kernels' 16 x 16 grid
constexpr float MASKED = -1e9f;
constexpr int NO_SEGMENT = 1 << 30;           // min over no nonzero segment ID

static_assert(TILE_Q == 64 && TILE_K == 64, "the range reductions span warps 0 and 1");
static_assert(TILE_Q == TILE_K, "the backward walks square tiles");

enum MaskKind { MASK_NONE = 0, MASK_BIAS = 1, MASK_SEGMENTS = 2 };

// Threads 0..63 (warps 0 and 1) hold one segment ID each: their nonzero
// min and overall max, per warp, into lo[]/hi[] (read after a barrier).
__device__ __forceinline__ void segment_range(int id, int tid, int* lo, int* hi) {
  const int wlo = __reduce_min_sync(0xffffffffu, id > 0 ? id : NO_SEGMENT);
  const int whi = __reduce_max_sync(0xffffffffu, id);
  if ((tid & 31) == 0) {
    lo[tid >> 5] = wlo;
    hi[tid >> 5] = whi;
  }
}

// The additive mask of one (query, key) pair in fp32: the key's own term
// (its bias, 0, or -inf past S), or, for segments, -1e9 unless query and
// key share a nonzero segment.
__device__ __forceinline__ float pair_mask(float key_term, int mask_kind, int qseg, int kseg) {
  if (mask_kind == MASK_SEGMENTS && key_term == 0.f)
    return (qseg > 0 && qseg == kseg) ? 0.f : MASKED;
  return key_term;
}

// Is the batch row's every key at the -1e9 floor (a filler row)?  Every
// thread of the block (`threads` of them) calls it; the answer is uniform.
__device__ __forceinline__ bool row_all_masked(const float* bias_row, int S, int tid,
                                               int threads = THREADS) {
  int any_live = 0;
  for (int s = tid; s < S; s += threads) any_live |= bias_row[s] > 0.5f * MASKED;
  return !__syncthreads_or(any_live);
}

// The skip rule, as each block applies it at TILE (ops/flash.py's
// segment_block_map / bias_block_map):
//   segments  a (q tile, k tile) pair is live iff the tiles' nonzero
//             segment-ID ranges intersect, or the q tile holds a padding
//             row (segment 0), which needs every key;
//   bias      a k tile is live iff one of its keys is above the -1e9 floor,
//             or the batch row masks every key (a filler row).
// A skipped tile's probabilities underflow to exactly 0 for every row of
// the q tile, so skipping changes no bit of any output.

// The q tile's side for segments: loads its IDs into qseg[] (-1 past S)
// and returns whether it holds a padding row, with its nonzero ID range in
// q_lo/q_hi.  Every thread calls it; the answers are uniform.
__device__ __forceinline__ bool query_tile_ids(const int* seg_row, int S, int q0, int tid,
                                               int* qseg, int* lo, int* hi, int& q_lo,
                                               int& q_hi) {
  int id = -1;
  if (tid < TILE_Q) {
    const int s = q0 + tid;
    id = s < S ? seg_row[s] : -1;
    qseg[tid] = id;
    segment_range(id, tid, lo, hi);
  }
  const bool pad = __syncthreads_or(tid < TILE_Q && id == 0);
  q_lo = min(lo[0], lo[1]);
  q_hi = max(hi[0], hi[1]);
  return pad;
}

// Loads the k tile at k0's mask terms into kmask[] (bias, 0, or -inf past
// S) and kseg[] (-1 past S) and returns whether it is live for a q tile
// whose side is (q_pad, q_lo, q_hi) (segments) or row_masked (bias).  For
// segments the k tile's own range is left in lo[]/hi[].  Every thread
// calls it; the answer is uniform.
__device__ __forceinline__ bool key_tile_live(const float* bias_row, const int* seg_row,
                                              int S, int k0, int tid, int mask_kind,
                                              float* kmask, int* kseg, int* lo, int* hi,
                                              bool q_pad, int q_lo, int q_hi,
                                              bool row_masked) {
  int key_live = 0;
  if (tid < TILE_K) {
    const int s = k0 + tid;
    float km = 0.f;
    int ks = -1;
    if (s >= S) {
      km = -INFINITY;
    } else if (mask_kind == MASK_BIAS) {
      km = bias_row[s];
      key_live = km > 0.5f * MASKED;
    } else if (mask_kind == MASK_SEGMENTS) {
      ks = seg_row[s];
    }
    kmask[tid] = km;
    kseg[tid] = ks;
    if (mask_kind == MASK_SEGMENTS) segment_range(ks, tid, lo, hi);
  }
  if (mask_kind == MASK_BIAS) return __syncthreads_or(key_live) || row_masked;
  __syncthreads();
  if (mask_kind == MASK_SEGMENTS)
    return q_pad || (q_lo <= max(hi[0], hi[1]) && min(lo[0], lo[1]) <= q_hi);
  return true;
}

}  // namespace flash
