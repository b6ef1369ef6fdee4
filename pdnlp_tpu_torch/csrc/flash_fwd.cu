// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces pdnlp_tpu/ops/flash.py:_fwd_kernel (the Pallas TPU kernel that
// `_fwd` launches through pl.pallas_call).  Same function: for every query
// row, softmax((q * D^-1/2) . k^T + mask) . v with the softmax computed
// online over key tiles (running max m, running sum l, fp32 accumulator),
// the additive mask applied in fp32 at -1e9 (never -inf), and whole key
// tiles skipped where no query of the tile can attend any of their keys.
//
// Mask forms (one kernel, as on the TPU):
//   MASK_NONE      no mask;
//   MASK_BIAS      a per-key additive bias [B, S] fp32 (padded buckets);
//   MASK_SEGMENTS  segment IDs [B, S] int32 (packed rows): query i attends
//                  key j iff seg[i] == seg[j] > 0, computed in-kernel, so
//                  no [B, 1, S, S] bias ever exists.
// A fully masked query row (padding rows, filler rows) gets the softmax of
// its raw scores at -1e9 over all S keys, exactly like the plain version.
// Keys past S (a ragged last tile) are excluded outright with -inf, so any
// S >= 1 runs here: they never join a fully masked row's average.
//
// Tile skip, decided in-kernel from the mask the block loads anyway (the
// rule of ops/flash.py's segment_block_map / bias_block_map at TILE):
//   segments  a (q tile, k tile) pair is live iff the tiles' nonzero
//             segment-ID ranges intersect, or the q tile holds a padding
//             row (segment 0), which needs every key;
//   bias      a k tile is live iff one of its keys is above the -1e9 floor,
//             or the batch row masks every key (a filler row).
// A skipped tile's probabilities would all underflow to exactly 0 for every
// row of the q tile, so skipping changes no bit of the output.  When
// `live_out` is given, the blocks of head 0 write their decisions there.
//
// Layout: q, k, v and o are [B, S, N, D] contiguous (the model's projection
// output viewed as heads), read and written in place: no head transposes.
//
// What bounds it on an H100: at the serving shapes (S <= 512, D = 64) the
// function moves 4 * B*S*N*D elements and does 4 * S * D flops per query
// row, about 32 flops per fp32 byte at S = 128 -- below the fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 flops/byte) only for short rows, so it is
// bound by bytes at S <= 64 and by fp32 arithmetic above.  This first
// version answers with the simple things: each q/k/v element is read from
// device memory once per (q tile, k tile) pair, on-chip work is fp32 FMA on
// the CUDA cores out of shared memory (no tensor cores, no mma/wgmma, no
// TMA, no pipelining -- later work), scores and probabilities never leave
// the SM, and dead tiles (the off-diagonal ones of packed rows) are skipped
// before their K/V are read.
//
// Block: one per (q tile of 64 rows, b * N + n), 256 threads as a 16 x 16
// grid; thread (ty, tx) owns query rows 4ty..4ty+3 and, in turn, key
// columns 4tx..4tx+3 of a score tile and head dims 4tx..4tx+3 of the output
// accumulator, so each row's m and l live in the 16 lanes of one half-warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_Q = 64;
constexpr int TILE_K = 64;
constexpr int HEAD_D = 64;
constexpr int THREADS = 256;
constexpr int ROW_PAD = 4;                    // keeps float4 alignment, spreads banks
constexpr int KT_STRIDE = TILE_K + ROW_PAD;   // row stride of the K^T / P buffer
constexpr float MASKED = -1e9f;
constexpr int NO_SEGMENT = 1 << 30;           // min over no nonzero segment ID

enum MaskKind { MASK_NONE = 0, MASK_BIAS = 1, MASK_SEGMENTS = 2 };
enum DType { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

struct __align__(16) Smem {
  float q[TILE_Q][HEAD_D];        // q tile, upcast and scaled
  float kt[HEAD_D][KT_STRIDE];    // k tile transposed; then P [TILE_Q][KT_STRIDE]
  float v[TILE_K][HEAD_D];
  float kmask[TILE_K];            // per-key additive term (bias, 0, or -inf past S)
  int qseg[TILE_Q];               // -1 past S
  int kseg[TILE_K];               // -1 past S
  int lo[2], hi[2];               // per-warp segment-ID range of a k tile
};
static_assert(TILE_Q * KT_STRIDE <= HEAD_D * KT_STRIDE, "P must fit the K^T buffer");
static_assert(TILE_Q == 64 && TILE_K == 64, "the range reductions span warps 0 and 1");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seg, T* __restrict__ o,
                 int* __restrict__ live_out, int S, int N, int n_tiles,
                 float scale, int mask_kind) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int qt = blockIdx.x;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = qt * TILE_Q;
  const long row_stride = (long)N * HEAD_D;             // s -> s + 1
  const long base = ((long)b * S * N + n) * HEAD_D;     // (b, 0, n, 0)
  int* live_row = (live_out != nullptr && n == 0 && tid == 0)
                      ? live_out + ((long)b * n_tiles + qt) * n_tiles : nullptr;

  for (int e = tid; e < TILE_Q * HEAD_D; e += THREADS) {
    const int r = e / HEAD_D, d = e % HEAD_D, s = q0 + r;
    sm.q[r][d] = s < S ? to_f32(q[base + s * row_stride + d]) * scale : 0.f;
  }

  // the q tile's side of the skip rule (uniform across the block)
  bool q_pad = false;           // segments: the tile holds a padding row
  int q_lo = NO_SEGMENT, q_hi = -1;
  bool row_masked = false;      // bias: the batch row masks every key
  if (mask_kind == MASK_SEGMENTS) {
    int id = -1;
    if (tid < TILE_Q) {
      const int s = q0 + tid;
      id = s < S ? seg[(long)b * S + s] : -1;
      sm.qseg[tid] = id;
      segment_range(id, tid, sm.lo, sm.hi);
    }
    q_pad = __syncthreads_or(tid < TILE_Q && id == 0);
    q_lo = min(sm.lo[0], sm.lo[1]);
    q_hi = max(sm.hi[0], sm.hi[1]);
  } else if (mask_kind == MASK_BIAS) {
    int any_live = 0;
    for (int s = tid; s < S; s += THREADS)
      any_live |= bias[(long)b * S + s] > 0.5f * MASKED;
    row_masked = !__syncthreads_or(any_live);
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;   // the TPU kernel's initial running max
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE_K;
    __syncthreads();                  // last tile's readers of smem are done
    int key_live = 0;
    if (tid < TILE_K) {
      const int s = k0 + tid;
      float km = 0.f;
      int ks = -1;
      if (s >= S) {
        km = -INFINITY;
      } else if (mask_kind == MASK_BIAS) {
        km = bias[(long)b * S + s];
        key_live = km > 0.5f * MASKED;
      } else if (mask_kind == MASK_SEGMENTS) {
        ks = seg[(long)b * S + s];
      }
      sm.kmask[tid] = km;
      sm.kseg[tid] = ks;
      if (mask_kind == MASK_SEGMENTS) segment_range(ks, tid, sm.lo, sm.hi);
    }
    bool live = true;
    if (mask_kind == MASK_BIAS) {
      live = __syncthreads_or(key_live) || row_masked;
    } else if (mask_kind == MASK_SEGMENTS) {
      __syncthreads();
      live = q_pad || (q_lo <= max(sm.hi[0], sm.hi[1]) &&
                       min(sm.lo[0], sm.lo[1]) <= q_hi);
    }
    if (live_row != nullptr) live_row[kt] = live;
    if (!live) continue;              // uniform across the block

    for (int e = tid; e < TILE_K * HEAD_D; e += THREADS) {
      const int r = e / HEAD_D, d = e % HEAD_D, s = k0 + r;
      const bool in = s < S;
      sm.kt[d][r] = in ? to_f32(k[base + s * row_stride + d]) : 0.f;
      sm.v[r][d] = in ? to_f32(v[base + s * row_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HEAD_D; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(&sm.kt[d][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sm.q[4 * ty + i][d];
        sc[i][0] = fmaf(qv, kv.x, sc[i][0]);
        sc[i][1] = fmaf(qv, kv.y, sc[i][1]);
        sc[i][2] = fmaf(qv, kv.z, sc[i][2]);
        sc[i][3] = fmaf(qv, kv.w, sc[i][3]);
      }
    }

    // mask in fp32, then the online-softmax update of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qs = mask_kind == MASK_SEGMENTS ? sm.qseg[4 * ty + i] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        float add = sm.kmask[c];
        if (mask_kind == MASK_SEGMENTS && add == 0.f)
          add = (qs > 0 && qs == sm.kseg[c]) ? 0.f : MASKED;
        sc[i][j] += add;
      }
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        ps += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();                  // every thread is done reading K^T
    float* P = &sm.kt[0][0];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&P[(4 * ty + i) * KT_STRIDE + 4 * tx]) =
          make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE_K; ++c) {
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[c][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = P[(4 * ty + i) * KT_STRIDE + c];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= S) continue;
    T* out = o + base + s * row_stride + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = from_f32<T>(acc[i][j] / l[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const int* seg, void* o, int* live_out, int B, int S, int N,
                   int n_tiles, float scale, int mask_kind, cudaStream_t stream) {
  // above the 48 KB static limit: opt in.  The attribute is per device, so
  // it is set on every launch (a cheap call) rather than once per process.
  const int smem = (int)sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, B * N);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, seg, static_cast<T*>(o), live_out, S, N, n_tiles, scale, mask_kind);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pdnlp_flash_tile(void) { return TILE_Q; }

int pdnlp_flash_head_dim(void) { return HEAD_D; }

int pdnlp_flash_smem_bytes(void) { return (int)sizeof(Smem); }

const char* pdnlp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// bias is read for MASK_BIAS only and seg for MASK_SEGMENTS only; either
// may be null otherwise.  live_out, when not null, is [B, n_tiles, n_tiles]
// int32 and receives the tile-skip decisions (1 = live).
int pdnlp_flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                    const int* seg, void* o, int* live_out, int B, int S, int N,
                    int D, int dtype, int mask_kind, int n_tiles, float scale,
                    void* stream) {
  if (D != HEAD_D || B < 1 || S < 1 || N < 1 || B * N > 65535 ||
      n_tiles != (S + TILE_Q - 1) / TILE_Q ||
      (mask_kind == MASK_BIAS && bias == nullptr) ||
      (mask_kind == MASK_SEGMENTS && seg == nullptr) ||
      mask_kind < MASK_NONE || mask_kind > MASK_SEGMENTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch<float>(q, k, v, bias, seg, o, live_out, B, S, N,
                                          n_tiles, scale, mask_kind, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, bias, seg, o, live_out, B,
                                                  S, N, n_tiles, scale, mask_kind, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
