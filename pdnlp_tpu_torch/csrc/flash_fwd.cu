// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++: K1.
//
// Replaces pdnlp_tpu/ops/flash.py:_fwd_kernel (the Pallas TPU kernel that
// `_fwd` launches through pl.pallas_call).  Same function: for every query
// row, softmax((q * D^-1/2) . k^T + mask) . v with the softmax computed
// online over key tiles (running max m, running sum l, fp32 accumulator),
// the additive mask applied in fp32 at -1e9 (never -inf), and whole key
// tiles skipped where no query of the tile can attend any of their keys.
//
// Mask forms (one kernel per dtype, as on the TPU):
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
// rule stated in flash_common.cuh, before the tile's K and V are read.  When
// `live_out` is given, the blocks of head 0 write their decisions there.
//
// Layout: q, k, v and o are [B, S, N, D] contiguous (the model's projection
// output viewed as heads), read and written in place: no head transposes.
// Training (m_out/l_out given): each row's final m and l go out as well,
// [B, N, S] fp32, kept apart (m + log l would lose l to fp32 rounding on a
// fully masked row, m near -1e9), for the backward kernels (flash_bwd.cu)
// to recompute p = exp(s - m) / l.  Serving passes null.
//
// What bounds it on an H100.  Per needed (query, key) pair K1 does two
// products over D (4 * D flops) against q, k, v, o read or written once.
// In bf16 on the tensor cores (989 TFLOP/s) that work is an order of
// magnitude under the time the bytes take (3.35 TB/s): bytes bound it.  In
// fp32 on the CUDA cores (67 TFLOP/s, no TF32) it is ~32 flops per byte at
// S = 128, above the ridge of 20: arithmetic bounds it.  One design per
// dtype follows; both take one block per (64-row q tile, b * N + n), walk
// the live k tiles with the next one's K and V in flight (cp.async into a
// second buffer, its liveness and mask terms decided before the load), and
// form the mask, the online max and sum in fp32:
//
// bf16 (flash_fwd_kernel_bf16): 4 warps, warp w owns query rows
// 16w..16w+15.  The Q tile is loaded once and its A fragments held in
// registers for the whole walk; s = Q . K^T runs on mma.sync.m16n8k16
// (bf16 in, fp32 sums) with the K tile's rows as the B operand as stored
// (ldmatrix, rows padded to 144 B); each row's values live in one quad of
// lanes, so a row max or sum takes two shuffles.  p is repacked from the
// accumulators into bf16 A fragments (rounded once, as FlashAttention-2
// does; l sums the fp32 p) and O += P . V takes V through ldmatrix.trans:
// P never touches shared memory.  ~46 KB of shared memory and at most 168
// registers give 3 blocks per SM.
//
// fp32 (flash_fwd_kernel_f32): FMA on the CUDA cores, 256 threads as a
// 16 x 16 grid; thread (ty, tx) owns query rows 4ty..4ty+3 against key
// columns tx + 16j of s, then head dims 4tx..4tx+3 of O, so a row lives in
// the 16 lanes of one half-warp.  Tiles are stored once, row-major, rows
// padded to 68 floats, and read as 16 B vectors of both operands (the
// products of flash_tiles.cuh, as in K2/K3); p goes through one shared
// tile for P . V.  ~103 KB of shared memory and at most 128 registers give
// 2 blocks per SM.
//
// Numerics, both: 1/sqrt(D) = 2^-3 (D = 64 only) is applied to the fp32
// sums, which is exact; the mask is added to that fp32 score before any
// log2 e scaling and p = exp2((s - m) log2 e) with m in natural units (the
// ulp of fp32 at 1e9 is 64: folding log2 e into the scale first would
// change which raw scores survive on a fully masked row); m starts at the
// -1e9 floor; O is scaled by 1/l once at the end.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

// What the C entry point passes either kernel, by value.
struct Args {
  const void *q, *k, *v;
  const float* bias;
  const int* seg;
  void* o;
  int* live_out;
  float *m_out, *l_out;
  int S, N, n_tiles, mask_kind;
  float scale;
};

// A block's q tile as the skip rule sees it (flash_common.cuh).
struct QuerySide {
  bool pad = false;          // segments: the tile holds a padding row
  int lo = NO_SEGMENT, hi = -1;
  bool row_masked = false;   // bias: the batch row masks every key
};

// The walked k tiles' mask terms, double-buffered with the tiles, and the
// skip rule's scratch.
struct KeyTerms {
  float kmask[2][TILE_K];     // per-key additive term (bias, 0, or -inf past S)
  int kseg[2][TILE_K];        // -1 past S
  int qseg[TILE_Q];           // -1 past S
  int lo[2], hi[2];           // per-warp segment-ID range of a tile
};

// Every thread of the block (NT of them) calls it; the answer is uniform.
template <int NT>
__device__ __forceinline__ QuerySide query_side(const Args& a, const float* bias_row,
                                                const int* seg_row, int q0, int tid,
                                                KeyTerms& kt) {
  QuerySide qs;
  if (a.mask_kind == MASK_SEGMENTS)
    qs.pad = query_tile_ids(seg_row, a.S, q0, tid, kt.qseg, kt.lo, kt.hi, qs.lo, qs.hi);
  else if (a.mask_kind == MASK_BIAS)
    qs.row_masked = row_all_masked(bias_row, a.S, tid, NT);
  return qs;
}

// The first live k tile at or after kt, its mask terms in buffer buf; each
// decision goes to live_row when given.  Every thread calls it.
__device__ __forceinline__ int next_live(int kt, int buf, const Args& a,
                                         const float* bias_row, const int* seg_row, int tid,
                                         const QuerySide& qs, KeyTerms& terms, int* live_row) {
  for (; kt < a.n_tiles; ++kt) {
    __syncthreads();                  // lo/hi and kmask[buf] have no readers left
    const bool live = key_tile_live(bias_row, seg_row, a.S, kt * TILE_K, tid, a.mask_kind,
                                    terms.kmask[buf], terms.kseg[buf], terms.lo, terms.hi,
                                    qs.pad, qs.lo, qs.hi, qs.row_masked);
    if (live_row != nullptr) live_row[kt] = live;
    if (live) break;
  }
  return kt;
}

// Where head 0's blocks record their skip decisions (thread 0 only).
__device__ __forceinline__ int* live_row_of(const Args& a, int b, int n, int tid) {
  return (a.live_out != nullptr && n == 0 && tid == 0)
             ? a.live_out + ((long)b * a.n_tiles + blockIdx.x) * a.n_tiles
             : nullptr;
}

// ------------------------------------------------- bf16: the tensor cores

struct __align__(16) SmemBf16 {
  bf16 q[TILE_Q][BF16_LD];
  bf16 k[2][TILE_K][BF16_LD];       // walked k and v tiles, double-buffered
  bf16 v[2][TILE_K][BF16_LD];
  KeyTerms terms;
};

__global__ void __launch_bounds__(BF_THREADS, 3) flash_fwd_kernel_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_raw);

  const int S = a.S, N = a.N, mask_kind = a.mask_kind, n_tiles = a.n_tiles;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TILE_Q;
  const int r0 = 16 * warp;                             // the warp's rows in the tile
  const long row_stride = (long)N * HEAD_D;             // s -> s + 1
  const long base = ((long)b * S * N + n) * HEAD_D;     // (b, 0, n, 0)
  const float* bias_row = a.bias + (long)b * S;
  const int* seg_row = a.seg + (long)b * S;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  int* live_row = live_row_of(a, b, n, tid);

  load_tile_async<BF_THREADS>(sm.q, static_cast<const bf16*>(a.q) + base, row_stride, q0, S,
                              tid);
  cp_async_commit();
  const QuerySide qs = query_side<BF_THREADS>(a, bias_row, seg_row, q0, tid, sm.terms);
  // the thread's rows g and g + 8 of the warp: their segment IDs
  int rseg[2] = {0, 0};
  if (mask_kind == MASK_SEGMENTS) {
    rseg[0] = sm.terms.qseg[r0 + g];
    rseg[1] = sm.terms.qseg[r0 + g + 8];
  }
  auto load_kv = [&](int kt, int buf) {
    load_tile_async<BF_THREADS>(sm.k[buf], k, row_stride, kt * TILE_K, S, tid);
    load_tile_async<BF_THREADS>(sm.v[buf], v, row_stride, kt * TILE_K, S, tid);
  };

  int cur = next_live(0, 0, a, bias_row, seg_row, tid, qs, sm.terms, live_row);
  if (cur < n_tiles) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();                 // q is in; the first k/v tile may still fly
  __syncthreads();
  unsigned qa[4][4];                  // the warp's 16 rows of Q, 64 dims: held
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) lds_a(qa[kk], sm.q, r0, 16 * kk, lane);

  float acc[8][4];                    // O: the warp's 16 rows x 64 dims
  zero_frags<8, 4>(acc);
  float m[2] = {MASKED, MASKED};      // rows g, g + 8: running max (natural units)
  float l[2] = {0.f, 0.f};            // and this lane's share of the running sum
  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    const int nxt = next_live(cur + 1, buf ^ 1, a, bias_row, seg_row, tid, qs, sm.terms,
                              live_row);
    if (nxt < n_tiles) load_kv(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile cur is in; nxt may still fly
    __syncthreads();

    float s[8][4];                    // the warp's 16 rows x 64 keys
    zero_frags<8, 4>(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned kb[4];
        lds_b_rows(kb, sm.k[buf], 16 * jj, 16 * kk, lane);
        mma_bf16(s[2 * jj], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], kb[2], kb[3]);
      }

    // mask in fp32, then the online-softmax update of rows g and g + 8
    const float* kmask = sm.terms.kmask[buf];
    const int* kseg = sm.terms.kseg[buf];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * j + 2 * t + (e & 1);
        s[j][e] = s[j][e] * a.scale + pair_mask(kmask[c], mask_kind, rseg[h], kseg[c]);
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f((m[h] - mx[h]) * LOG2E);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = exp2f((s[j][e] - m[h]) * LOG2E);   // p, fp32
        l[h] += s[j][e];
      }
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    unsigned pa[2][4];                // p as bf16 A fragments, 32 keys at a time
    to_a_frags(s, pa);
    mma_cols(acc, pa, sm.v[buf], 0, lane);
    to_a_frags(s + 4, pa);
    mma_cols(acc, pa, sm.v[buf], 32, lane);
    cur = nxt;                        // buf is refilled only after next_live's barrier
  }
  cp_async_wait<0>();

  bf16* o = static_cast<bf16*>(a.o) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int s = q0 + r0 + g + 8 * h;
    if (s >= S) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<unsigned*>(o + s * row_stride + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    if (a.m_out != nullptr && t == 0) {
      const long idx = ((long)b * N + n) * S + s;
      a.m_out[idx] = m[h];
      a.l_out[idx] = l[h];
    }
  }
}

// ------------------------------------------------- fp32: the CUDA cores


struct __align__(16) SmemF32 {
  float q[TILE_Q][F32_LD];          // q tile (unscaled)
  float k[2][TILE_K][F32_LD];       // walked k and v tiles, double-buffered
  float v[2][TILE_K][F32_LD];
  float p[TILE_Q][F32_LD];          // p of the tile being walked
  KeyTerms terms;
};

__global__ void __launch_bounds__(THREADS, 2) flash_fwd_kernel_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemF32& sm = *reinterpret_cast<SmemF32*>(smem_raw);

  const int S = a.S, N = a.N, mask_kind = a.mask_kind, n_tiles = a.n_tiles;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * TILE_Q;
  const long row_stride = (long)N * HEAD_D;
  const long base = ((long)b * S * N + n) * HEAD_D;
  const float* bias_row = a.bias + (long)b * S;
  const int* seg_row = a.seg + (long)b * S;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  int* live_row = live_row_of(a, b, n, tid);

  load_tile_async<THREADS>(sm.q, static_cast<const float*>(a.q) + base, row_stride, q0, S,
                           tid);
  cp_async_commit();
  const QuerySide qs = query_side<THREADS>(a, bias_row, seg_row, q0, tid, sm.terms);
  int rseg[4] = {0, 0, 0, 0};
  if (mask_kind == MASK_SEGMENTS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rseg[i] = sm.terms.qseg[4 * ty + i];
  }
  auto load_kv = [&](int kt, int buf) {
    load_tile_async<THREADS>(sm.k[buf], k, row_stride, kt * TILE_K, S, tid);
    load_tile_async<THREADS>(sm.v[buf], v, row_stride, kt * TILE_K, S, tid);
  };

  int cur = next_live(0, 0, a, bias_row, seg_row, tid, qs, sm.terms, live_row);
  if (cur < n_tiles) load_kv(cur, 0);
  cp_async_commit();

  float acc[4][4];                    // O: rows 4ty + i, dims 4tx + j
  zero(acc);
  float m[4], l[4];                   // l: this lane's share of the running sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;                    // the TPU kernel's initial running max
    l[i] = 0.f;
  }
  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    const int nxt = next_live(cur + 1, buf ^ 1, a, bias_row, seg_row, tid, qs, sm.terms,
                              live_row);
    if (nxt < n_tiles) load_kv(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // q and tile cur are in; nxt may still fly
    __syncthreads();

    float sc[4][4];                   // rows 4ty + i, keys tx + 16j
    zero(sc);
    product_nt<HEAD_D / 4>(sm.q, sm.k[buf], ty, tx, sc);
    const float* kmask = sm.terms.kmask[buf];
    const int* kseg = sm.terms.kseg[buf];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        sc[i][j] = sc[i][j] * a.scale + pair_mask(kmask[c], mask_kind, rseg[i], kseg[c]);
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f((m[i] - mx) * LOG2E);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((sc[i][j] - mx) * LOG2E);
        l[i] += p;
        sm.p[4 * ty + i][tx + 16 * j] = p;
        acc[i][j] *= alpha;
      }
    }
    __syncwarp();                     // a warp reads back only the p rows it wrote
    product_nn<TILE_K / 4>(sm.p, sm.v[buf], ty, tx, acc);   // O += P . V
    cur = nxt;                        // buf is refilled only after next_live's barrier
  }
  cp_async_wait<0>();

  float* o = static_cast<float*>(a.o) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int s = q0 + 4 * ty + i;
    if (s >= S) continue;
    const float inv = 1.f / l[i];
    *reinterpret_cast<float4*>(o + s * row_stride + 4 * tx) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    if (a.m_out != nullptr && tx == 0) {
      const long idx = ((long)b * N + n) * S + s;
      a.m_out[idx] = m[i];
      a.l_out[idx] = l[i];
    }
  }
}

// ------------------------------------------------------------- launching

struct Config {
  const void* fn;
  int threads, smem;
};

bool known(int dtype) { return dtype == DTYPE_F32 || dtype == DTYPE_BF16; }

Config config(int dtype) {
  return dtype == DTYPE_BF16
             ? Config{(const void*)flash_fwd_kernel_bf16, BF_THREADS, (int)sizeof(SmemBf16)}
             : Config{(const void*)flash_fwd_kernel_f32, THREADS, (int)sizeof(SmemF32)};
}

// Opts the kernel in to its shared memory (a per-device attribute, so on
// every launch) and launches it on `stream`; returns cudaGetLastError().
cudaError_t launch(int dtype, int B, Args a, cudaStream_t stream) {
  const Config c = config(dtype);
  const cudaError_t err =
      cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  const cudaError_t launched = cudaLaunchKernel(c.fn, dim3(a.n_tiles, B * a.N),
                                                dim3(c.threads), params, c.smem, stream);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

extern "C" {

int pdnlp_flash_tile(void) { return TILE_Q; }

int pdnlp_flash_head_dim(void) { return HEAD_D; }

// Dynamic shared memory per block of K1 for a dtype code; -1 if unknown.
int pdnlp_flash_fwd_smem_bytes(int dtype) { return known(dtype) ? config(dtype).smem : -1; }

// Blocks of K1 that fit one SM at once, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor after the shared-memory
// opt-in; -1 for an unknown dtype or a failed query.
int pdnlp_flash_fwd_blocks_per_sm(int dtype) {
  if (!known(dtype)) return -1;
  const Config c = config(dtype);
  int blocks = 0;
  if (cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn, c.threads, c.smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

const char* pdnlp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, o: [B, S, N, D] contiguous in one dtype, 16-byte aligned.  bias
// is read for MASK_BIAS only and seg for MASK_SEGMENTS only; either may be
// null otherwise.  live_out, when not null, is [B, n_tiles, n_tiles] int32
// and receives the tile-skip decisions (1 = live).  m_out and l_out, both
// null (serving) or both not, are [B, N, S] fp32 and receive each row's
// running max and sum (the backward's statistics).
int pdnlp_flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                    const int* seg, void* o, int* live_out, float* m_out, float* l_out,
                    int B, int S, int N, int D, int dtype, int mask_kind, int n_tiles,
                    float scale, void* stream) {
  if (D != HEAD_D || B < 1 || S < 1 || N < 1 || B * N > 65535 || !known(dtype) ||
      (m_out == nullptr) != (l_out == nullptr) ||
      n_tiles != (S + TILE_Q - 1) / TILE_Q ||
      (mask_kind == MASK_BIAS && bias == nullptr) ||
      (mask_kind == MASK_SEGMENTS && seg == nullptr) ||
      mask_kind < MASK_NONE || mask_kind > MASK_SEGMENTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, seg, o, live_out, m_out, l_out, S, N, n_tiles, mask_kind, scale};
  return static_cast<int>(launch(dtype, B, a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
