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
// Tile skip, decided in-kernel from the mask the block loads anyway, by the
// rule stated in flash_common.cuh.  When `live_out` is given, the blocks of
// head 0 write their decisions there.
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
//
// Training (m_out/l_out given): each row's final m and l go out as well,
// [B, N, S] fp32, as the TPU kernel's m and l outputs do, for the backward
// kernels (flash_bwd.cu) to recompute p = exp(s - m) / l.  Serving passes
// null and pays one predicated-off branch per row.

#include "flash_common.cuh"

namespace {

using namespace flash;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seg, T* __restrict__ o,
                 int* __restrict__ live_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int S, int N, int n_tiles,
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
    q_pad = query_tile_ids(seg + (long)b * S, S, q0, tid, sm.qseg, sm.lo, sm.hi, q_lo,
                           q_hi);
  } else if (mask_kind == MASK_BIAS) {
    row_masked = row_all_masked(bias + (long)b * S, S, tid);
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
    const bool live = key_tile_live(bias + (long)b * S, seg + (long)b * S, S, k0, tid,
                                    mask_kind, sm.kmask, sm.kseg, sm.lo, sm.hi, q_pad,
                                    q_lo, q_hi, row_masked);
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
        sc[i][j] += pair_mask(sm.kmask[c], mask_kind, qs, sm.kseg[c]);
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
    // the backward's row statistics, kept apart: m + log(l) would lose l
    // to fp32 rounding on a fully masked row (m near -1e9)
    if (m_out != nullptr && tx == 0) {
      const long idx = ((long)b * N + n) * S + s;
      m_out[idx] = m[i];
      l_out[idx] = l[i];
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const int* seg, void* o, int* live_out, float* m_out, float* l_out,
                   int B, int S, int N, int n_tiles, float scale, int mask_kind,
                   cudaStream_t stream) {
  // above the 48 KB static limit: opt in.  The attribute is per device, so
  // it is set on every launch (a cheap call) rather than once per process.
  const int smem = (int)sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, B * N);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, seg, static_cast<T*>(o), live_out, m_out, l_out, S, N, n_tiles, scale,
      mask_kind);
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
// int32 and receives the tile-skip decisions (1 = live).  m_out and l_out,
// both null (serving) or both not, are [B, N, S] fp32 and receive each
// row's running max and sum (the backward's statistics).
int pdnlp_flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                    const int* seg, void* o, int* live_out, float* m_out, float* l_out,
                    int B, int S, int N, int D, int dtype, int mask_kind, int n_tiles,
                    float scale, void* stream) {
  if (D != HEAD_D || B < 1 || S < 1 || N < 1 || B * N > 65535 ||
      (m_out == nullptr) != (l_out == nullptr) ||
      n_tiles != (S + TILE_Q - 1) / TILE_Q ||
      (mask_kind == MASK_BIAS && bias == nullptr) ||
      (mask_kind == MASK_SEGMENTS && seg == nullptr) ||
      mask_kind < MASK_NONE || mask_kind > MASK_SEGMENTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch<float>(q, k, v, bias, seg, o, live_out, m_out, l_out,
                                          B, S, N, n_tiles, scale, mask_kind, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, bias, seg, o, live_out, m_out,
                                                  l_out, B, S, N, n_tiles, scale,
                                                  mask_kind, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
