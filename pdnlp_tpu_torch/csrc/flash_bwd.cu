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
// crosses blocks, there are no atomics, and the results are the same bits
// on every run.
//
// What bounds them on an H100.  Per needed (query, key) pair K2 does three
// products over D (6 * D flops) and K3 four (8 * D), against q, k, v, dO
// and the outputs read or written once.  In fp32 that is ~48 flops per
// byte at S = 128, above the CUDA cores' ridge (67 TFLOP/s / 3.35 TB/s =
// 20): fp32 arithmetic bounds them.  In bf16 the same work on the tensor
// cores (989 TFLOP/s, ridge ~295) is an order of magnitude under the time
// the bytes take: bytes bound them.  Two designs follow, one per dtype.
//
// bf16 (flash_bwd_*_kernel_bf16): the tensor cores.  4 warps own a 64-row
// tile, 16 rows each.  Every product is warp-level
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 fed by ldmatrix from tiles
// kept once, as bf16, in shared memory with rows padded to 72 elements
// (144 B: the 8 row addresses of an ldmatrix fall in 8 different 16 B bank
// groups).  A tile's rows serve as the B operand of s = Q . K^T as they are
// stored and, through ldmatrix.trans, of dQ += dS . K: no transposed
// copies.  The owned tile's A fragments (Q and dO in K2, K and V in K3)
// are read anew from shared memory for each product: kept in registers
// for the whole walk they cost 32 a thread and spill (measured no faster
// on the H100).  s and dP sit in fp32 accumulators;
// the mask, p and dS are formed there in fp32, and p and dS are repacked
// from the accumulator layout straight into bf16 A fragments (two n8
// accumulator tiles are one k16 fragment), never through shared memory.
// The walked tiles (K, V in K2; Q, dO and their m, l, Di in K3) arrive by
// cp.async, double-buffered: the next live tile loads while this one is
// multiplied.  The 64 walked columns go in two halves of 32, so the fp32
// score registers stay at 32 a thread; ~57 KB of shared memory and at most
// 168 registers give 3 blocks per SM.  mma.sync and not wgmma + TMA: at
// S = 128 the products fit well under the byte bound at mma.sync's rate.
// Numerics: s and dP are exact products of bf16 inputs summed in fp32; p
// and dS are rounded to bf16 once, before the three second-stage products
// (dQ, dV, dK), as FlashAttention-2 does; ops/flash.py's twin rounds at
// the same places.
//
// fp32 (flash_bwd_*_kernel_f32): FMA on the CUDA cores (no TF32).  256
// threads as a 16 x 16 grid, each owning a 4 x 4 block of every product.
// All five tiles of a block are stored once, row-major, rows padded to 68
// floats, and arrive by cp.async; each product reads 16 B vectors of both
// operands (8 loads per 64 FMA).  Row against row (s = Q . K^T) a thread
// takes columns tx + 16j, so the 8 rows a quarter-warp reads fall in 8
// different bank groups; row against column (dQ = dS . K) it takes
// columns 4tx..4tx+3.  ~87 KB of shared memory and at most 128 registers
// give 2 blocks per SM.
//
// Both: 1/sqrt(D) = 2^-3 (D = 64 only) is applied to the fp32 sums, which
// is exact, so Q is never rescaled in memory.  p = exp2((s - m) log2 e)
// times 1/l (exp2f and a reciprocal in place of expf and a division: the
// exponential and division were most of the elementwise work); p differs
// from the twin's expf()/l by a few fp32 ulps.  Dead tiles are skipped
// before their operands are read; a dead k tile in K3 writes zeros without
// reading Q.  Shared memory is above the 48 KB static limit, so each
// launch opts in with cudaFuncSetAttribute (a per-device attribute).

#include "flash_tiles.cuh"

namespace {

using namespace flash;

// What the C entry points pass every kernel, by value.
struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *di, *bias;
  const int* seg;
  void *dq, *dk, *dv;
  int B, S, N, n_tiles, mask_kind;
  float scale;
};

// ------------------------------------------------ fp32: CUDA-core kernels

struct __align__(16) DqSmemF32 {
  float q[TILE_Q][F32_LD];       // q tile (unscaled)
  float dout[TILE_Q][F32_LD];    // dO tile
  float k[TILE_K][F32_LD];       // walked k tile
  float v[TILE_K][F32_LD];       // walked v tile
  float ds[TILE_Q][F32_LD];      // dS tile
  float kmask[TILE_K];
  int qseg[TILE_Q];
  int kseg[TILE_K];
  int lo[2], hi[2];
};

struct __align__(16) DkvSmemF32 {
  float k[TILE_K][F32_LD];       // this block's keys
  float v[TILE_K][F32_LD];
  float q[TILE_Q][F32_LD];       // walked q tile (unscaled)
  float dout[TILE_Q][F32_LD];    // walked dO tile
  float pt[TILE_K][F32_LD];      // p^T, then dS^T
  float qm[TILE_Q], ql[TILE_Q], qdi[TILE_Q];   // the q tile's m, l, Di
  float kmask[TILE_K];
  int qseg[TILE_Q];
  int kseg[TILE_K];
  int lo[2], hi[2];
};

// K2, fp32: one block per (q tile, b * N + n); walks the k tiles.  Thread
// (ty, tx) owns query rows 4ty..4ty+3 against key columns tx + 16j, then
// head dims 4tx..4tx+3 of dQ.
__global__ void __launch_bounds__(THREADS, 2) flash_bwd_dq_kernel_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmemF32& sm = *reinterpret_cast<DqSmemF32*>(smem_raw);

  const int S = a.S, N = a.N, mask_kind = a.mask_kind;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * TILE_Q;
  const long row_stride = (long)N * HEAD_D;             // s -> s + 1
  const long base = ((long)b * S * N + n) * HEAD_D;     // (b, 0, n, 0)
  const long stat = ((long)b * N + n) * S;              // (b, n, 0) of m, l, Di
  const float* bias_row = a.bias + (long)b * S;
  const int* seg_row = a.seg + (long)b * S;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  load_tile_async<THREADS>(sm.q, q, row_stride, q0, S, tid);
  load_tile_async<THREADS>(sm.dout, dout, row_stride, q0, S, tid);
  cp_async_commit();
  // the owned rows' statistics; rows past S get p = 0
  float rm[4], rinv[4], rdi[4];
  bool rin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    rin[i] = s < S;
    rm[i] = rin[i] ? a.m[stat + s] : 0.f;
    rinv[i] = rin[i] ? 1.f / a.l[stat + s] : 1.f;
    rdi[i] = rin[i] ? a.di[stat + s] : 0.f;
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
  for (int kt = 0; kt < a.n_tiles; ++kt) {
    const int k0 = kt * TILE_K;
    __syncthreads();                  // last tile's readers of smem are done
    if (!key_tile_live(bias_row, seg_row, S, k0, tid, mask_kind, sm.kmask, sm.kseg, sm.lo,
                       sm.hi, q_pad, q_lo, q_hi, row_masked))
      continue;                       // uniform across the block
    load_tile_async<THREADS>(sm.k, k, row_stride, k0, S, tid);
    load_tile_async<THREADS>(sm.v, v, row_stride, k0, S, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    product_nt(sm.q, sm.k, ty, tx, sc);
    product_nt(sm.dout, sm.v, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qs = mask_kind == MASK_SEGMENTS ? sm.qseg[4 * ty + i] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float s =
            sc[i][j] * a.scale + pair_mask(sm.kmask[c], mask_kind, qs, sm.kseg[c]);
        const float p = rin[i] ? exp2f((s - rm[i]) * LOG2E) * rinv[i] : 0.f;
        sm.ds[4 * ty + i][c] = p * (dp[i][j] - rdi[i]);
      }
    }
    __syncthreads();
    product_nn(sm.ds, sm.k, ty, tx, acc);
  }
  cp_async_wait<0>();                 // no tile live: q and dO still land

  float* dq = static_cast<float*>(a.dq) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rin[i]) continue;
    *reinterpret_cast<float4*>(dq + (q0 + 4 * ty + i) * row_stride + 4 * tx) =
        make_float4(acc[i][0] * a.scale, acc[i][1] * a.scale, acc[i][2] * a.scale,
                    acc[i][3] * a.scale);
  }
}

// K3, fp32: one block per (k tile, b * N + n); walks the q tiles.  It works
// on the transposed tile: key rows 4ty..4ty+3 against query columns
// tx + 16j, then head dims 4tx..4tx+3 of dK and dV.
__global__ void __launch_bounds__(THREADS, 2) flash_bwd_dkv_kernel_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmemF32& sm = *reinterpret_cast<DkvSmemF32*>(smem_raw);

  const int S = a.S, N = a.N, mask_kind = a.mask_kind;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = blockIdx.x * TILE_K;
  const long row_stride = (long)N * HEAD_D;
  const long base = ((long)b * S * N + n) * HEAD_D;
  const long stat = ((long)b * N + n) * S;
  const float* bias_row = a.bias + (long)b * S;
  const int* seg_row = a.seg + (long)b * S;

  // this k tile's side of the skip rule: for bias it decides every pair
  // (row_masked and the keys do not depend on the q tile); for segments
  // the tile's own range, kept for the q tiles below
  const bool row_masked =
      mask_kind == MASK_BIAS ? row_all_masked(bias_row, S, tid) : false;
  const bool k_live = key_tile_live(bias_row, seg_row, S, k0, tid, mask_kind, sm.kmask,
                                    sm.kseg, sm.lo, sm.hi, true, 0, 0, row_masked);
  const int k_lo = min(sm.lo[0], sm.lo[1]);
  const int k_hi = max(sm.hi[0], sm.hi[1]);
  if (k_live) {
    load_tile_async<THREADS>(sm.k, static_cast<const float*>(a.k) + base, row_stride, k0, S,
                             tid);
    load_tile_async<THREADS>(sm.v, static_cast<const float*>(a.v) + base, row_stride, k0, S,
                             tid);
    cp_async_commit();
  }

  float adk[4][4], adv[4][4];
  zero(adk);
  zero(adv);
  for (int qt = 0; k_live && qt < a.n_tiles; ++qt) {
    const int q0 = qt * TILE_Q;
    __syncthreads();                  // last tile's readers of smem are done
    if (mask_kind == MASK_SEGMENTS) {
      int q_lo, q_hi;
      const bool q_pad = query_tile_ids(seg_row, S, q0, tid, sm.qseg, sm.lo, sm.hi, q_lo,
                                        q_hi);
      if (!(q_pad || (q_lo <= k_hi && k_lo <= q_hi))) continue;   // uniform
    }
    load_tile_async<THREADS>(sm.q, static_cast<const float*>(a.q) + base, row_stride, q0, S,
                             tid);
    load_tile_async<THREADS>(sm.dout, static_cast<const float*>(a.dout) + base, row_stride,
                             q0, S, tid);
    cp_async_commit();
    if (tid < TILE_Q) {
      const int s = q0 + tid;
      const bool in = s < S;
      sm.qm[tid] = in ? a.m[stat + s] : 0.f;
      sm.ql[tid] = in ? a.l[stat + s] : 1.f;
      sm.qdi[tid] = in ? a.di[stat + s] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    product_nt(sm.k, sm.q, ty, tx, sc);       // s^T: key rows, query cols
    product_nt(sm.v, sm.dout, ty, tx, dp);    // dP^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {     // query column r, key rows 4ty..4ty+3
      const int r = tx + 16 * j;
      const int qs = mask_kind == MASK_SEGMENTS ? sm.qseg[r] : 0;
      const bool in = q0 + r < S;
      const float qm = sm.qm[r], linv = __frcp_rn(sm.ql[r]), qdi = sm.qdi[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * ty + i;
        const float s = sc[i][j] * a.scale + pair_mask(sm.kmask[c], mask_kind, qs, sm.kseg[c]);
        const float p = in ? exp2f((s - qm) * LOG2E) * linv : 0.f;
        dp[i][j] = p * (dp[i][j] - qdi);    // dS^T
        sm.pt[c][r] = p;
      }
    }
    __syncthreads();
    product_nn(sm.pt, sm.dout, ty, tx, adv);  // dV += p^T . dO
    __syncthreads();                  // every thread is done reading p^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.pt[4 * ty + i][tx + 16 * j] = dp[i][j];
    __syncthreads();
    product_nn(sm.pt, sm.q, ty, tx, adk);     // dK += dS^T . Q
  }
  cp_async_wait<0>();                 // no q tile live: k and v still land

  float* dk = static_cast<float*>(a.dk) + base;
  float* dv = static_cast<float*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + 4 * ty + i;
    if (s >= S) continue;
    *reinterpret_cast<float4*>(dk + s * row_stride + 4 * tx) =
        make_float4(adk[i][0] * a.scale, adk[i][1] * a.scale, adk[i][2] * a.scale,
                    adk[i][3] * a.scale);
    *reinterpret_cast<float4*>(dv + s * row_stride + 4 * tx) =
        make_float4(adv[i][0], adv[i][1], adv[i][2], adv[i][3]);
  }
}

// ----------------------------------------------- bf16: tensor-core kernels

// 16 rows x 64 head dims of accumulators, rows row0 + g (+ 8), to bf16
// [B, S, N, D] rows below S, times `scale`.
__device__ __forceinline__ void store_rows_bf16(bf16* out, const float acc[8][4], int row0,
                                                int S, long row_stride, float scale,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = row0 + g + 8 * h;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<unsigned*>(out + s * row_stride + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

struct __align__(16) DqSmemBf16 {
  bf16 q[TILE_Q][BF16_LD];
  bf16 dout[TILE_Q][BF16_LD];
  bf16 k[2][TILE_K][BF16_LD];       // walked k and v tiles, double-buffered
  bf16 v[2][TILE_K][BF16_LD];
  float kmask[2][TILE_K];
  int kseg[2][TILE_K];
  int qseg[TILE_Q];
  int lo[2], hi[2];
};

struct __align__(16) DkvSmemBf16 {
  bf16 k[TILE_K][BF16_LD];
  bf16 v[TILE_K][BF16_LD];
  bf16 q[2][TILE_Q][BF16_LD];       // walked q and dO tiles, double-buffered
  bf16 dout[2][TILE_Q][BF16_LD];
  float qm[2][TILE_Q], ql[2][TILE_Q], qdi[2][TILE_Q];
  int qseg[2][TILE_Q];
  float kmask[TILE_K];
  int kseg[TILE_K];
  int lo[2], hi[2];
};

// K2, bf16: one block of 4 warps per (q tile, b * N + n); warp w owns query
// rows 16w..16w+15, walks the live k tiles with the next one in flight.
__global__ void __launch_bounds__(BF_THREADS, 3) flash_bwd_dq_kernel_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmemBf16& sm = *reinterpret_cast<DqSmemBf16*>(smem_raw);

  const int S = a.S, N = a.N, mask_kind = a.mask_kind, n_tiles = a.n_tiles;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TILE_Q;
  const int r0 = 16 * warp;                             // the warp's rows in the tile
  const long row_stride = (long)N * HEAD_D;
  const long base = ((long)b * S * N + n) * HEAD_D;
  const long stat = ((long)b * N + n) * S;
  const float* bias_row = a.bias + (long)b * S;
  const int* seg_row = a.seg + (long)b * S;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;

  load_tile_async<BF_THREADS>(sm.q, static_cast<const bf16*>(a.q) + base, row_stride, q0, S,
                              tid);
  load_tile_async<BF_THREADS>(sm.dout, static_cast<const bf16*>(a.dout) + base, row_stride,
                              q0, S, tid);
  cp_async_commit();
  // the thread's rows g and g + 8 of the warp: statistics (p = 0 past S)
  float rm[2], rinv[2], rdi[2];
  bool rin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = q0 + r0 + g + 8 * h;
    rin[h] = s < S;
    rm[h] = rin[h] ? a.m[stat + s] : 0.f;
    rinv[h] = rin[h] ? 1.f / a.l[stat + s] : 1.f;
    rdi[h] = rin[h] ? a.di[stat + s] : 0.f;
  }

  bool q_pad = false;
  int q_lo = NO_SEGMENT, q_hi = -1;
  bool row_masked = false;
  int rseg[2] = {0, 0};
  if (mask_kind == MASK_SEGMENTS) {
    q_pad = query_tile_ids(seg_row, S, q0, tid, sm.qseg, sm.lo, sm.hi, q_lo, q_hi);
    rseg[0] = sm.qseg[r0 + g];
    rseg[1] = sm.qseg[r0 + g + 8];
  } else if (mask_kind == MASK_BIAS) {
    row_masked = row_all_masked(bias_row, S, tid, BF_THREADS);
  }
  // the first live k tile at or after kt, its mask terms in buffer buf
  auto next_live = [&](int kt, int buf) {
    for (; kt < n_tiles; ++kt) {
      __syncthreads();                // lo/hi and kmask[buf] have no readers left
      if (key_tile_live(bias_row, seg_row, S, kt * TILE_K, tid, mask_kind, sm.kmask[buf],
                        sm.kseg[buf], sm.lo, sm.hi, q_pad, q_lo, q_hi, row_masked))
        break;
    }
    return kt;
  };
  auto load_kv = [&](int kt, int buf) {
    load_tile_async<BF_THREADS>(sm.k[buf], k, row_stride, kt * TILE_K, S, tid);
    load_tile_async<BF_THREADS>(sm.v[buf], v, row_stride, kt * TILE_K, S, tid);
  };

  int cur = next_live(0, 0);
  if (cur < n_tiles) load_kv(cur, 0);
  cp_async_commit();

  float acc[8][4];                    // dQ: the warp's 16 rows x 64 dims
  zero_frags<8, 4>(acc);
  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    const int nxt = next_live(cur + 1, buf ^ 1);
    if (nxt < n_tiles) load_kv(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile cur is in; nxt may still fly
    __syncthreads();
    const float* kmask = sm.kmask[buf];
    const int* kseg = sm.kseg[buf];
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // key columns 32 half + 0..31
      float sc[4][4], dp[4][4];
      zero_frags<4, 4>(sc);
      zero_frags<4, 4>(dp);
      mma_rows(sc, sm.q, r0, sm.k[buf], 32 * half, lane);
      mma_rows(dp, sm.dout, r0, sm.v[buf], 32 * half, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = 32 * half + 8 * j + 2 * t + (e & 1);
          const float s = sc[j][e] * a.scale + pair_mask(kmask[c], mask_kind, rseg[h], kseg[c]);
          const float p = rin[h] ? exp2f((s - rm[h]) * LOG2E) * rinv[h] : 0.f;
          dp[j][e] = p * (dp[j][e] - rdi[h]);      // dS
        }
      unsigned dsa[2][4];
      to_a_frags(dp, dsa);
      mma_cols(acc, dsa, sm.k[buf], 32 * half, lane);   // dQ += dS . K
    }
    __syncthreads();                  // buf is free for the tile after nxt
    cur = nxt;
  }
  cp_async_wait<0>();
  store_rows_bf16(static_cast<bf16*>(a.dq) + base, acc, q0 + r0, S, row_stride, a.scale, lane);
}

// K3, bf16: one block of 4 warps per (k tile, b * N + n); warp w owns key
// rows 16w..16w+15 and walks the live q tiles, the next one (q, dO and
// their m, l, Di) in flight.  It works on the transposed scores: key rows,
// query columns.
__global__ void __launch_bounds__(BF_THREADS, 3) flash_bwd_dkv_kernel_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmemBf16& sm = *reinterpret_cast<DkvSmemBf16*>(smem_raw);

  const int S = a.S, N = a.N, mask_kind = a.mask_kind, n_tiles = a.n_tiles;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TILE_K;
  const int r0 = 16 * warp;
  const long row_stride = (long)N * HEAD_D;
  const long base = ((long)b * S * N + n) * HEAD_D;
  const long stat = ((long)b * N + n) * S;
  const float* bias_row = a.bias + (long)b * S;
  const int* seg_row = a.seg + (long)b * S;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* dout = static_cast<const bf16*>(a.dout) + base;

  // the k tile's side of the skip rule, as in the fp32 kernel
  const bool row_masked =
      mask_kind == MASK_BIAS ? row_all_masked(bias_row, S, tid, BF_THREADS) : false;
  const bool k_live = key_tile_live(bias_row, seg_row, S, k0, tid, mask_kind, sm.kmask,
                                    sm.kseg, sm.lo, sm.hi, true, 0, 0, row_masked);
  const int k_lo = min(sm.lo[0], sm.lo[1]);
  const int k_hi = max(sm.hi[0], sm.hi[1]);
  // the thread's key rows g and g + 8 of the warp: their mask terms
  const float rkm[2] = {sm.kmask[r0 + g], sm.kmask[r0 + g + 8]};
  const int rks[2] = {sm.kseg[r0 + g], sm.kseg[r0 + g + 8]};
  if (k_live) {
    load_tile_async<BF_THREADS>(sm.k, static_cast<const bf16*>(a.k) + base, row_stride, k0,
                                S, tid);
    load_tile_async<BF_THREADS>(sm.v, static_cast<const bf16*>(a.v) + base, row_stride, k0,
                                S, tid);
  }
  cp_async_commit();

  // the first live q tile at or after qt, its segment IDs in buffer buf
  auto next_live = [&](int qt, int buf) {
    if (!k_live) return n_tiles;
    if (mask_kind != MASK_SEGMENTS) return qt;
    for (; qt < n_tiles; ++qt) {
      __syncthreads();                // lo/hi and qseg[buf] have no readers left
      int q_lo, q_hi;
      const bool q_pad = query_tile_ids(seg_row, S, qt * TILE_Q, tid, sm.qseg[buf], sm.lo,
                                        sm.hi, q_lo, q_hi);
      if (q_pad || (q_lo <= k_hi && k_lo <= q_hi)) break;
    }
    return qt;
  };
  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * TILE_Q;
    load_tile_async<BF_THREADS>(sm.q[buf], q, row_stride, q0, S, tid);
    load_tile_async<BF_THREADS>(sm.dout[buf], dout, row_stride, q0, S, tid);
    for (int i = tid; i < 3 * TILE_Q; i += BF_THREADS) {
      const int which = i / TILE_Q, r = i % TILE_Q, s = q0 + r;
      const bool in = s < S;
      const float* src = (which == 0 ? a.m : which == 1 ? a.l : a.di) + stat + (in ? s : 0);
      float* dst = which == 0 ? sm.qm[buf] : which == 1 ? sm.ql[buf] : sm.qdi[buf];
      cp_async4(&dst[r], src, in);
    }
  };

  int cur = next_live(0, 0);
  if (cur < n_tiles) load_q(cur, 0);
  cp_async_commit();

  float adk[8][4], adv[8][4];         // the warp's 16 key rows x 64 dims
  zero_frags<8, 4>(adk);
  zero_frags<8, 4>(adv);
  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    const int nxt = next_live(cur + 1, buf ^ 1);
    if (nxt < n_tiles) load_q(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile cur is in; nxt may still fly
    __syncthreads();
    const int q0 = cur * TILE_Q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // query columns 32 half + 0..31
      float sc[4][4], dp[4][4];
      zero_frags<4, 4>(sc);
      zero_frags<4, 4>(dp);
      mma_rows(sc, sm.k, r0, sm.q[buf], 32 * half, lane);      // s^T
      mma_rows(dp, sm.v, r0, sm.dout[buf], 32 * half, lane);   // dP^T
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {      // query column c, key rows g, g + 8
          const int c = 32 * half + 8 * j + 2 * t + cc;
          const int qs = mask_kind == MASK_SEGMENTS ? sm.qseg[buf][c] : 0;
          const bool in = q0 + c < S;
          const float qm = sm.qm[buf][c], linv = __frcp_rn(sm.ql[buf][c]);
          const float qdi = sm.qdi[buf][c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + cc;
            const float s = sc[j][e] * a.scale + pair_mask(rkm[h], mask_kind, qs, rks[h]);
            const float p = in ? exp2f((s - qm) * LOG2E) * linv : 0.f;
            dp[j][e] = p * (dp[j][e] - qdi);     // dS^T
            sc[j][e] = p;                        // p^T
          }
        }
      unsigned x[2][4];
      to_a_frags(sc, x);
      mma_cols(adv, x, sm.dout[buf], 32 * half, lane);   // dV += p^T . dO
      to_a_frags(dp, x);
      mma_cols(adk, x, sm.q[buf], 32 * half, lane);      // dK += dS^T . Q
    }
    __syncthreads();                  // buf is free for the tile after nxt
    cur = nxt;
  }
  cp_async_wait<0>();
  store_rows_bf16(static_cast<bf16*>(a.dk) + base, adk, k0 + r0, S, row_stride, a.scale,
                  lane);
  store_rows_bf16(static_cast<bf16*>(a.dv) + base, adv, k0 + r0, S, row_stride, 1.f, lane);
}

// ------------------------------------------------------------- launching

enum Kernel { KERNEL_DQ = 0, KERNEL_DKV = 1 };

struct Config {
  const void* fn;
  int threads, smem;
};

bool known(int kernel, int dtype) {
  return (kernel == KERNEL_DQ || kernel == KERNEL_DKV) &&
         (dtype == DTYPE_F32 || dtype == DTYPE_BF16);
}

Config config(int kernel, int dtype) {
  const bool bf = dtype == DTYPE_BF16;
  if (kernel == KERNEL_DQ)
    return bf ? Config{(const void*)flash_bwd_dq_kernel_bf16, BF_THREADS,
                       (int)sizeof(DqSmemBf16)}
              : Config{(const void*)flash_bwd_dq_kernel_f32, THREADS, (int)sizeof(DqSmemF32)};
  return bf ? Config{(const void*)flash_bwd_dkv_kernel_bf16, BF_THREADS,
                     (int)sizeof(DkvSmemBf16)}
            : Config{(const void*)flash_bwd_dkv_kernel_f32, THREADS, (int)sizeof(DkvSmemF32)};
}

// Opts the kernel in to its shared memory (a per-device attribute, so on
// every launch) and launches it on `stream`; returns cudaGetLastError().
cudaError_t launch(int kernel, int dtype, Args a, cudaStream_t stream) {
  const Config c = config(kernel, dtype);
  const cudaError_t err =
      cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  const cudaError_t launched = cudaLaunchKernel(c.fn, dim3(a.n_tiles, a.B * a.N),
                                                dim3(c.threads), params, c.smem, stream);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

bool valid(const Args& a, int D, int dtype) {
  return D == HEAD_D && a.B >= 1 && a.S >= 1 && a.N >= 1 && a.B * a.N <= 65535 &&
         a.n_tiles == (a.S + TILE_Q - 1) / TILE_Q && a.m != nullptr && a.l != nullptr &&
         a.di != nullptr && a.mask_kind >= MASK_NONE && a.mask_kind <= MASK_SEGMENTS &&
         (a.mask_kind != MASK_BIAS || a.bias != nullptr) &&
         (a.mask_kind != MASK_SEGMENTS || a.seg != nullptr) && known(KERNEL_DQ, dtype);
}

}  // namespace

extern "C" {

int pdnlp_flash_bwd_tile(void) { return TILE_Q; }

int pdnlp_flash_bwd_head_dim(void) { return HEAD_D; }

// Dynamic shared memory per block of K2 (kernel 0) or K3 (kernel 1) for a
// dtype code; -1 for an unknown pair.
int pdnlp_flash_bwd_smem_bytes(int kernel, int dtype) {
  return known(kernel, dtype) ? config(kernel, dtype).smem : -1;
}

// Blocks of K2 (kernel 0) or K3 (kernel 1) that fit one SM at once, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor after the shared-memory
// opt-in; -1 for an unknown pair or a failed query.
int pdnlp_flash_bwd_blocks_per_sm(int kernel, int dtype) {
  if (!known(kernel, dtype)) return -1;
  const Config c = config(kernel, dtype);
  int blocks = 0;
  if (cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn, c.threads, c.smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

const char* pdnlp_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2.  q, k, v, dout, dq: [B, S, N, D] contiguous in one dtype, 16-byte
// aligned; m, l, di: [B, N, S] fp32; bias [B, S] fp32 (MASK_BIAS) or seg
// [B, S] int32 (MASK_SEGMENTS), null otherwise.  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
int pdnlp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const float* m, const float* l, const float* di, const float* bias,
                       const int* seg, void* dq, int B, int S, int N, int D, int dtype,
                       int mask_kind, int n_tiles, float scale, void* stream) {
  const Args a{q, k, v, dout, m, l, di, bias, seg, dq, nullptr, nullptr,
               B, S, N, n_tiles, mask_kind, scale};
  if (!valid(a, D, dtype) || dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(KERNEL_DQ, dtype, a, static_cast<cudaStream_t>(stream)));
}

// K3.  As K2, writing dk and dv ([B, S, N, D], the input dtype).
int pdnlp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const float* m, const float* l, const float* di, const float* bias,
                        const int* seg, void* dk, void* dv, int B, int S, int N, int D,
                        int dtype, int mask_kind, int n_tiles, float scale, void* stream) {
  const Args a{q, k, v, dout, m, l, di, bias, seg, nullptr, dk, dv,
               B, S, N, n_tiles, mask_kind, scale};
  if (!valid(a, D, dtype) || dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(KERNEL_DKV, dtype, a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
