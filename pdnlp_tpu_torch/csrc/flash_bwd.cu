// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// K2 (dQ) and K3 (dK, dV).
//
// Replace pdnlp_tpu/ops/flash.py:_dq_kernel and :_dkv_kernel (the two
// Pallas TPU kernels `_bwd_impl` launches through pl.pallas_call).  Same
// functions, same two-kernel split (the FlashAttention-2 one): both
// recompute the probabilities p = exp(s - m) / l of a (q tile, k tile)
// pair from the forward's saved row statistics m and l (flash_fwd.cu),
// where s = (q * D^-1/2) . k^T + mask in fp32, and with Di = rowsum(dO * O)
// (a PyTorch op outside, as JAX computes it outside Pallas):
//   dP = dO . V^T,  dS = p * (dP - Di),
//   K2  dQ = (sum over k tiles of dS . K) * D^-1/2;
//   K3  dV = sum over q tiles of p^T . dO,  dK = (sum of dS^T . Q) * D^-1/2.
// The masks, the -1e9 floor, the -inf past S and the tile skip are K1's
// (flash_common.cuh), so a fully masked row, a ragged last tile and packed
// rows are handled exactly as in the forward.
//
// The TPU kernels carried dQ (or dK/dV) in VMEM scratch across the
// innermost, sequential grid axis.  CUDA blocks run in no order, so here
// one block owns one 64-row q tile (K2) or k tile (K3), loops over the
// other axis itself and keeps its accumulators in registers: nothing
// crosses blocks, there are no atomics, and the results are deterministic.
//
// What bounds it on an H100: per needed (query, key) pair K2 does three
// products over D (6 * D flops) and K3 four (8 * D), against q, k, v, dO
// and one output read or written once -- about 48 flops per fp32 byte at
// S = 128, above the fp32 ridge (20 flops/byte), so fp32 arithmetic bounds
// both.  This first version answers with the simple things: fp32 FMA on
// the CUDA cores out of shared memory (no tensor cores, mma/wgmma, TMA or
// pipelining -- later work), scores, probabilities and dS never leave the
// SM, and dead tiles are skipped before their operands are read.
//
// Blocks: one per (tile of 64 rows, b * N + n), 256 threads as a 16 x 16
// grid.  K2: thread (ty, tx) owns query rows 4ty..4ty+3 and key columns
// 4tx..4tx+3 of a score tile, then head dims 4tx..4tx+3 of dQ.  K3 works
// on the transposed tile: key rows 4ty..4ty+3, query columns 4tx..4tx+3,
// then head dims 4tx..4tx+3 of dK and dV.  Shared memory is above the
// 48 KB static limit (102 KB for K2, 119 KB for K3), so each launch opts
// in with cudaFuncSetAttribute (a per-device attribute).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct __align__(16) DqSmem {
  float q[TILE_Q][HEAD_D];        // q tile, upcast and scaled
  float dout[TILE_Q][HEAD_D];     // dO tile
  float kt[HEAD_D][KT_STRIDE];    // k tile transposed (for s)
  float vt[HEAD_D][KT_STRIDE];    // v tile transposed (for dP)
  float k[TILE_K][HEAD_D];        // k tile (for dS . K)
  float ds[TILE_Q][KT_STRIDE];    // dS tile
  float kmask[TILE_K];
  int qseg[TILE_Q];
  int kseg[TILE_K];
  int lo[2], hi[2];
};

struct __align__(16) DkvSmem {
  float k[TILE_K][HEAD_D];        // this block's keys
  float v[TILE_K][HEAD_D];
  float qt[HEAD_D][KT_STRIDE];    // q tile transposed and scaled (for s^T)
  float q[TILE_Q][HEAD_D];        // q tile (for dS^T . Q)
  float doutt[HEAD_D][KT_STRIDE]; // dO tile transposed (for dP^T)
  float dout[TILE_Q][HEAD_D];     // dO tile (for p^T . dO)
  float pt[TILE_K][KT_STRIDE];    // p^T, then dS^T
  float qm[TILE_Q], ql[TILE_Q], qdi[TILE_Q];   // the q tile's m, l, Di
  float kmask[TILE_K];
  int qseg[TILE_Q];
  int kseg[TILE_K];
  int lo[2], hi[2];
};

// acc[i][j] += sum_d a[4ty + i][d] * bt[d][4tx + j]: a 64-deep product of a
// row-major tile and a transposed one into this thread's 4 x 4 block.
__device__ __forceinline__ void tile_product(float (*a)[HEAD_D], float (*bt)[KT_STRIDE],
                                             int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < HEAD_D; ++d) {
    const float4 bv = *reinterpret_cast<const float4*>(&bt[d][4 * tx]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = a[4 * ty + i][d];
      acc[i][0] = fmaf(av, bv.x, acc[i][0]);
      acc[i][1] = fmaf(av, bv.y, acc[i][1]);
      acc[i][2] = fmaf(av, bv.z, acc[i][2]);
      acc[i][3] = fmaf(av, bv.w, acc[i][3]);
    }
  }
}

// acc[i][j] += sum_c a[4ty + i][c] * b[c][4tx + j]: a 64-deep product of a
// score-shaped tile (row stride KT_STRIDE) and a row-major [64][HEAD_D] one.
__device__ __forceinline__ void score_product(float (*a)[KT_STRIDE], float (*b)[HEAD_D],
                                              int ty, int tx, float acc[4][4]) {
#pragma unroll 4
  for (int c = 0; c < TILE_K; ++c) {
    const float4 bv = *reinterpret_cast<const float4*>(&b[c][4 * tx]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = a[4 * ty + i][c];
      acc[i][0] = fmaf(av, bv.x, acc[i][0]);
      acc[i][1] = fmaf(av, bv.y, acc[i][1]);
      acc[i][2] = fmaf(av, bv.z, acc[i][2]);
      acc[i][3] = fmaf(av, bv.w, acc[i][3]);
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// K2: one block per (q tile, b * N + n); walks the k tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ di, const float* __restrict__ bias,
                    const int* __restrict__ seg, T* __restrict__ dq, int S, int N,
                    int n_tiles, float scale, int mask_kind) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);

  const int qt = blockIdx.x;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = qt * TILE_Q;
  const long row_stride = (long)N * HEAD_D;             // s -> s + 1
  const long base = ((long)b * S * N + n) * HEAD_D;     // (b, 0, n, 0)
  const long stat = ((long)b * N + n) * S;              // (b, n, 0) of m, l, Di
  const float* bias_row = bias + (long)b * S;
  const int* seg_row = seg + (long)b * S;

  for (int e = tid; e < TILE_Q * HEAD_D; e += THREADS) {
    const int r = e / HEAD_D, d = e % HEAD_D, s = q0 + r;
    const bool in = s < S;
    sm.q[r][d] = in ? to_f32(q[base + s * row_stride + d]) * scale : 0.f;
    sm.dout[r][d] = in ? to_f32(dout[base + s * row_stride + d]) : 0.f;
  }
  // the owned rows' statistics; rows past S get p = 0
  float rm[4], rl[4], rdi[4];
  bool rin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    rin[i] = s < S;
    rm[i] = rin[i] ? m[stat + s] : 0.f;
    rl[i] = rin[i] ? l[stat + s] : 1.f;
    rdi[i] = rin[i] ? di[stat + s] : 0.f;
  }

  bool q_pad = false;
  int q_lo = NO_SEGMENT, q_hi = -1;
  bool row_masked = false;
  if (mask_kind == MASK_SEGMENTS)
    q_pad = query_tile_ids(seg_row, S, q0, tid, sm.qseg, sm.lo, sm.hi, q_lo, q_hi);
  else if (mask_kind == MASK_BIAS)
    row_masked = row_all_masked(bias_row, S, tid);

  float acc[4][4];
  zero(acc);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE_K;
    __syncthreads();                  // last tile's readers of smem are done
    if (!key_tile_live(bias_row, seg_row, S, k0, tid, mask_kind, sm.kmask, sm.kseg, sm.lo,
                       sm.hi, q_pad, q_lo, q_hi, row_masked))
      continue;                       // uniform across the block

    for (int e = tid; e < TILE_K * HEAD_D; e += THREADS) {
      const int r = e / HEAD_D, d = e % HEAD_D, s = k0 + r;
      const bool in = s < S;
      const float kv = in ? to_f32(k[base + s * row_stride + d]) : 0.f;
      sm.kt[d][r] = kv;
      sm.k[r][d] = kv;
      sm.vt[d][r] = in ? to_f32(v[base + s * row_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    tile_product(sm.q, sm.kt, ty, tx, sc);
    tile_product(sm.dout, sm.vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qs = mask_kind == MASK_SEGMENTS ? sm.qseg[4 * ty + i] : 0;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        const float s = sc[i][j] + pair_mask(sm.kmask[c], mask_kind, qs, sm.kseg[c]);
        const float p = rin[i] ? expf(s - rm[i]) / rl[i] : 0.f;
        ds[j] = p * (dp[i][j] - rdi[i]);
      }
      *reinterpret_cast<float4*>(&sm.ds[4 * ty + i][4 * tx]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    score_product(sm.ds, sm.k, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rin[i]) continue;
    T* out = dq + base + (q0 + 4 * ty + i) * row_stride + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = from_f32<T>(acc[i][j] * scale);
  }
}

// K3: one block per (k tile, b * N + n); walks the q tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ di, const float* __restrict__ bias,
                     const int* __restrict__ seg, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int N, int n_tiles, float scale, int mask_kind) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);

  const int kt = blockIdx.x;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = kt * TILE_K;
  const long row_stride = (long)N * HEAD_D;
  const long base = ((long)b * S * N + n) * HEAD_D;
  const long stat = ((long)b * N + n) * S;
  const float* bias_row = bias + (long)b * S;
  const int* seg_row = seg + (long)b * S;

  for (int e = tid; e < TILE_K * HEAD_D; e += THREADS) {
    const int r = e / HEAD_D, d = e % HEAD_D, s = k0 + r;
    const bool in = s < S;
    sm.k[r][d] = in ? to_f32(k[base + s * row_stride + d]) : 0.f;
    sm.v[r][d] = in ? to_f32(v[base + s * row_stride + d]) : 0.f;
  }
  // this k tile's side of the skip rule: for bias it decides every pair
  // (row_masked and the keys do not depend on the q tile); for segments
  // the tile's own range, kept for the q tiles below
  const bool row_masked =
      mask_kind == MASK_BIAS ? row_all_masked(bias_row, S, tid) : false;
  const bool k_live = key_tile_live(bias_row, seg_row, S, k0, tid, mask_kind, sm.kmask,
                                    sm.kseg, sm.lo, sm.hi, true, 0, 0, row_masked);
  const int k_lo = min(sm.lo[0], sm.lo[1]);
  const int k_hi = max(sm.hi[0], sm.hi[1]);

  float adk[4][4], adv[4][4];
  zero(adk);
  zero(adv);
  for (int qt = 0; k_live && qt < n_tiles; ++qt) {
    const int q0 = qt * TILE_Q;
    __syncthreads();                  // last tile's readers of smem are done
    if (mask_kind == MASK_SEGMENTS) {
      int q_lo, q_hi;
      const bool q_pad = query_tile_ids(seg_row, S, q0, tid, sm.qseg, sm.lo, sm.hi, q_lo,
                                        q_hi);
      if (!(q_pad || (q_lo <= k_hi && k_lo <= q_hi))) continue;   // uniform
    }
    if (tid < TILE_Q) {
      const int s = q0 + tid;
      const bool in = s < S;
      sm.qm[tid] = in ? m[stat + s] : 0.f;
      sm.ql[tid] = in ? l[stat + s] : 1.f;
      sm.qdi[tid] = in ? di[stat + s] : 0.f;
    }
    for (int e = tid; e < TILE_Q * HEAD_D; e += THREADS) {
      const int r = e / HEAD_D, d = e % HEAD_D, s = q0 + r;
      const bool in = s < S;
      const float qv = in ? to_f32(q[base + s * row_stride + d]) : 0.f;
      const float ov = in ? to_f32(dout[base + s * row_stride + d]) : 0.f;
      sm.qt[d][r] = qv * scale;
      sm.q[r][d] = qv;
      sm.doutt[d][r] = ov;
      sm.dout[r][d] = ov;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    tile_product(sm.k, sm.qt, ty, tx, sc);      // s^T: key rows, query cols
    tile_product(sm.v, sm.doutt, ty, tx, dp);   // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * ty + i;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        const int qs = mask_kind == MASK_SEGMENTS ? sm.qseg[r] : 0;
        const float s = sc[i][j] + pair_mask(sm.kmask[c], mask_kind, qs, sm.kseg[c]);
        p[j] = q0 + r < S ? expf(s - sm.qm[r]) / sm.ql[r] : 0.f;
        dp[i][j] = p[j] * (dp[i][j] - sm.qdi[r]);      // dS^T
      }
      *reinterpret_cast<float4*>(&sm.pt[c][4 * tx]) = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    score_product(sm.pt, sm.dout, ty, tx, adv);  // dV += p^T . dO
    __syncthreads();                  // every thread is done reading p^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&sm.pt[4 * ty + i][4 * tx]) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    __syncthreads();
    score_product(sm.pt, sm.q, ty, tx, adk);     // dK += dS^T . Q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + 4 * ty + i;
    if (s >= S) continue;
    T* ok = dk + base + s * row_stride + 4 * tx;
    T* ov = dv + base + s * row_stride + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = from_f32<T>(adk[i][j] * scale);
      ov[j] = from_f32<T>(adv[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *di, *bias;
  const int* seg;
  void *dq, *dk, *dv;
  int B, S, N, n_tiles, mask_kind;
  float scale;
};

template <typename T>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const int smem = (int)sizeof(DqSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T><<<dim3(a.n_tiles, a.B * a.N), THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.m, a.l, a.di, a.bias, a.seg, static_cast<T*>(a.dq),
      a.S, a.N, a.n_tiles, a.scale, a.mask_kind);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const int smem = (int)sizeof(DkvSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T><<<dim3(a.n_tiles, a.B * a.N), THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.m, a.l, a.di, a.bias, a.seg, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.S, a.N, a.n_tiles, a.scale, a.mask_kind);
  return cudaGetLastError();
}

bool valid(const Args& a, int D) {
  return D == HEAD_D && a.B >= 1 && a.S >= 1 && a.N >= 1 && a.B * a.N <= 65535 &&
         a.n_tiles == (a.S + TILE_Q - 1) / TILE_Q && a.m != nullptr && a.l != nullptr &&
         a.di != nullptr && a.mask_kind >= MASK_NONE && a.mask_kind <= MASK_SEGMENTS &&
         (a.mask_kind != MASK_BIAS || a.bias != nullptr) &&
         (a.mask_kind != MASK_SEGMENTS || a.seg != nullptr);
}

}  // namespace

extern "C" {

int pdnlp_flash_bwd_tile(void) { return TILE_Q; }

int pdnlp_flash_bwd_head_dim(void) { return HEAD_D; }

int pdnlp_flash_bwd_dq_smem_bytes(void) { return (int)sizeof(DqSmem); }

int pdnlp_flash_bwd_dkv_smem_bytes(void) { return (int)sizeof(DkvSmem); }

const char* pdnlp_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2.  q, k, v, dout, dq: [B, S, N, D] contiguous in one dtype; m, l, di:
// [B, N, S] fp32; bias [B, S] fp32 (MASK_BIAS) or seg [B, S] int32
// (MASK_SEGMENTS), null otherwise.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int pdnlp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const float* m, const float* l, const float* di, const float* bias,
                       const int* seg, void* dq, int B, int S, int N, int D, int dtype,
                       int mask_kind, int n_tiles, float scale, void* stream) {
  const Args a{q, k, v, dout, m, l, di, bias, seg, dq, nullptr, nullptr,
               B, S, N, n_tiles, mask_kind, scale};
  if (!valid(a, D) || dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return static_cast<int>(launch_dq<float>(a, st));
  if (dtype == DTYPE_BF16) return static_cast<int>(launch_dq<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3.  As K2, writing dk and dv ([B, S, N, D], the input dtype).
int pdnlp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const float* m, const float* l, const float* di, const float* bias,
                        const int* seg, void* dk, void* dv, int B, int S, int N, int D,
                        int dtype, int mask_kind, int n_tiles, float scale, void* stream) {
  const Args a{q, k, v, dout, m, l, di, bias, seg, nullptr, dk, dv,
               B, S, N, n_tiles, mask_kind, scale};
  if (!valid(a, D) || dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return static_cast<int>(launch_dkv<float>(a, st));
  if (dtype == DTYPE_BF16) return static_cast<int>(launch_dkv<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
