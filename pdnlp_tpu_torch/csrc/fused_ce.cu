// Fused classifier projection + cross-entropy for Hopper (sm_90a),
// hand-written CUDA C++: K4 (forward) and K5 (backward).
//
// Replace pdnlp_tpu/ops/fused_ce.py:_fwd_kernel and :_bwd_kernel (the
// Pallas TPU kernels launched by `_rows_call` and `_fused_rows_bwd`).  Same
// functions.  Per row r of the pooled features f [T, H] and the classifier
// W [C, H] (nn.Linear's layout), b [C]:
//   K4  logits = f . W^T + b in fp32 (never written out); lse; and three
//       fp32 values: ce = lse - logit[label], lpu = lse - mean(logits) (the
//       label-smoothing term) and correct = (first-index argmax == label).
//   K5  p = softmax(logits) again, g = dce (p - onehot) + dlpu (p - 1/C);
//       df = g . W, dW = g^T . f and db = sum of g over rows.
// Rows with a zero cotangent (filler rows, padded slots) give g = 0, so
// they add nothing to dW or db.
//
// The TPU kernel summed dW and db across its sequential grid in place.
// CUDA blocks run in no order, so K5 splits the work by H columns instead
// of rows: each block recomputes g for every row (the softmax terms are
// small next to a round trip through device memory), then writes df, dW
// and db for its own columns only.  No block reads another's output: no
// fp32 atomics and no cross-block reduce, so dW and db are the same bits
// on every run, summed over the rows in row order.
//
// What bounds them on an H100: neither bytes nor operations.  At the train
// step's shapes (T = 32 rows, H = 768, C = 6) the pair moves about 0.2 MB
// and does a few MFLOP, tens of nanoseconds of either bound; what is left
// is latency: one launch, and each round of loads that has to come back
// before the next can start.  So both designs aim at one round of loads
// per block, spread over many SMs.
//   K4  One block of FWD_THREADS per row (32 SMs at T = 32), so a row's
//       H columns split over 128 threads: at H = 768 each thread holds at
//       most 8 columns (two 16-byte fp32 vectors, one bf16 vector) and
//       issues every load it needs -- its columns of f and of all C rows
//       of W, predicated, no branch between one load and the next -- before
//       its first FMA.  The C sums reduce in a fixed order, a butterfly
//       over each warp then the warps in order through shared memory, and
//       warp 0 forms the softmax terms with lane c holding class c, all by
//       shuffles: one block barrier, no loop over H at H <= 1024.
//   K5  spreads H over 12 blocks (BWD_COLS = 64 columns each at H = 768),
//       reads f and W in 16-byte vectors with every load of a stride in
//       flight (phase A), and holds W's block columns in shared memory for
//       df (phase B).
// The TPU layouts are not carried over: no class padding to 128 lanes, no
// lane-broadcast row operands, no padding of rows to a block.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int MAX_C = 16;            // classes held in registers
constexpr int FWD_THREADS = 128;     // K4: threads per row (one block each)
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_ELEMS = 8;         // K4: columns of H per thread per stride
constexpr int THREADS = 256;         // K5
constexpr int WARPS = THREADS / 32;  // K5
constexpr int BWD_COLS = 64;         // K5: H columns per block
constexpr int CHUNK_ROWS = 32;       // K5: rows whose g a block holds at once
constexpr int WARP_ROWS = CHUNK_ROWS / WARPS;         // K5: rows per warp in phase A
constexpr int CLASS_GROUPS = THREADS / BWD_COLS;      // K5: threads per dW column
static_assert(MAX_C % CLASS_GROUPS == 0, "whole classes per dW thread");
static_assert(MAX_C <= 32 && (MAX_C & (MAX_C - 1)) == 0,
              "K4's epilogue: one lane per class, a butterfly over MAX_C lanes");
static_assert(FWD_ELEMS % 8 == 0, "K4: whole 16-byte vectors of fp32 (4) and bf16 (8)");

__device__ __forceinline__ float row_max(const float logits[MAX_C], int C) {
  float mx = logits[0];
#pragma unroll
  for (int c = 1; c < MAX_C; ++c)
    if (c < C) mx = fmaxf(mx, logits[c]);
  return mx;
}

// 16 bytes of f or W, loaded as they are stored, as fp32.
__device__ __forceinline__ void unpack16(const uint4& v, float* x, float) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float* x, __nv_bfloat16) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);          // the low bf16: its fp32 bits
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// K4: one block per row r (grid = rows).  Each stride of the row covers
// FWD_THREADS * FWD_ELEMS columns (all of H = 768 in one stride): thread t
// takes 16-byte vectors t + j * FWD_THREADS, j < FWD_ELEMS / V, of the
// stride (fp32: two vectors of 4; bf16: one of 8), or, where H or a base
// address rules vectors out, the scalars t + j * FWD_THREADS, j <
// FWD_ELEMS.  A thread issues every load of the stride -- its columns of
// f, then the same columns of all C rows of W, each predicated and zero
// where it is off the row or the classes -- before its first FMA, so the
// loads are in flight together and the row costs one round of latency,
// not one per column.  The thread's C sums then reduce in a fixed order:
// a butterfly over each warp's lanes, then the warps' sums in warp order
// through shared memory, so a launch gives the same bits every time.
// Warp 0 finishes: lane c < C holds logit c (lanes past C carry -inf for
// the max and 0 for the sums), and the max, the sum of exp, the sum of
// the logits and the first index at the max are each a butterfly over
// MAX_C lanes.  A label outside [0, C) reads logit 0, as the JAX kernel's
// one-hot does, and is never correct.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
fused_ce_fwd_kernel(const T* __restrict__ f, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    float* __restrict__ ce, float* __restrict__ lpu,
                    float* __restrict__ correct, int H, int C) {
  __shared__ float part[FWD_WARPS][MAX_C];
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int NV = FWD_ELEMS / V;                // vectors per thread per stride
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long r = blockIdx.x;
  const T* fr = f + r * H;
  const bool vec = H % V == 0 && reinterpret_cast<size_t>(f) % 16 == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0;
  const int lab = labels[r];                       // in flight with the row
  const float bias = tid < C ? to_f32(b[tid]) : 0.f;   // warp 0's lanes
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;
  for (int h0 = 0; h0 < H; h0 += FWD_THREADS * FWD_ELEMS) {
    if (vec) {
      uint4 fraw[NV], wraw[NV][MAX_C];             // every load, then the FMAs
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int h = h0 + (j * FWD_THREADS + tid) * V;
        fraw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (h < H) fraw[j] = *reinterpret_cast<const uint4*>(fr + h);
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          wraw[j][c] = make_uint4(0u, 0u, 0u, 0u);
          if (h < H && c < C) wraw[j][c] = *reinterpret_cast<const uint4*>(w + (long)c * H + h);
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float fv[V];
        unpack16(fraw[j], fv, T());
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          if (c < C) {
            float wv[V];
            unpack16(wraw[j][c], wv, T());
#pragma unroll
            for (int e = 0; e < V; ++e) acc[c] = fmaf(fv[e], wv[e], acc[c]);
          }
        }
      }
    } else {
      T fs[FWD_ELEMS], ws[FWD_ELEMS][MAX_C];
#pragma unroll
      for (int j = 0; j < FWD_ELEMS; ++j) {
        const int h = h0 + j * FWD_THREADS + tid;
        fs[j] = from_f32<T>(0.f);
        if (h < H) fs[j] = fr[h];
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          ws[j][c] = from_f32<T>(0.f);
          if (h < H && c < C) ws[j][c] = w[(long)c * H + h];
        }
      }
#pragma unroll
      for (int j = 0; j < FWD_ELEMS; ++j) {
        const float x = to_f32(fs[j]);
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < C) acc[c] = fmaf(x, to_f32(ws[j][c]), acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
      if (lane == 0) part[warp][c] = acc[c];
    }
  }
  __syncthreads();
  if (warp != 0) return;
  const bool real = lane < C;
  float x = -INFINITY;                             // lane c: logit c
  if (real) {
    x = part[0][lane];
#pragma unroll
    for (int i = 1; i < FWD_WARPS; ++i) x += part[i][lane];
    x += bias;
  }
  float mx = x;
#pragma unroll
  for (int off = MAX_C / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = real ? expf(x - mx) : 0.f;
  float total = real ? x : 0.f;
#pragma unroll
  for (int off = MAX_C / 2; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    total += __shfl_xor_sync(0xffffffffu, total, off);
  }
  const int first = __reduce_min_sync(0xffffffffu, real && x == mx ? lane : MAX_C);
  const float x_lab = __shfl_sync(0xffffffffu, x, lab & 31);
  if (lane == 0) {
    const float lse = mx + logf(sum);
    ce[r] = lse - (lab >= 0 && lab < C ? x_lab : 0.f);
    lpu[r] = lse - total / C;
    correct[r] = first == lab ? 1.f : 0.f;
  }
}

// K5 phase A: g of the chunk's rows r0.. into g[][] (shared), WARP_ROWS
// rows per warp.  The lanes stride over H in 16 B vectors (scalars when H
// or a base address does not allow them) and keep one fp32 sum per (row,
// class).  Each stride issues all its loads (the warp's rows of f, then
// all C rows of W, predicated, with no branch between a load and the next)
// before its first FMA, so they are in flight together; the C sums reduce
// by shuffles, then lane i forms row i's softmax and
// g = dce (p - onehot) + dlpu (p - 1/C).
template <typename T>
__device__ __forceinline__ void chunk_terms(const T* __restrict__ f, const T* __restrict__ w,
                                            const T* __restrict__ b,
                                            const int* __restrict__ labels,
                                            const float* __restrict__ dce,
                                            const float* __restrict__ dlpu, int r0, int rows,
                                            int H, int C, bool vec, float (*g)[MAX_C],
                                            int warp, int lane) {
  constexpr int V = 16 / (int)sizeof(T);
  const int rw = r0 + warp * WARP_ROWS;            // the warp's first row
  if (rw >= rows) return;                          // the whole warp
  const T* fr[WARP_ROWS];
#pragma unroll
  for (int i = 0; i < WARP_ROWS; ++i)              // rows past the end: any row, unused
    fr[i] = f + (long)min(rw + i, rows - 1) * H;
  float acc[WARP_ROWS][MAX_C];
#pragma unroll
  for (int i = 0; i < WARP_ROWS; ++i)
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) acc[i][c] = 0.f;
  if (vec) {
#pragma unroll 2
    for (int h = lane * V; h < H; h += 32 * V) {
      uint4 fraw[WARP_ROWS], wraw[MAX_C];          // every load of the stride, then the FMAs
#pragma unroll
      for (int i = 0; i < WARP_ROWS; ++i) fraw[i] = *reinterpret_cast<const uint4*>(fr[i] + h);
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) wraw[c] = *reinterpret_cast<const uint4*>(w + (long)c * H + h);
      float fv[WARP_ROWS][V];
#pragma unroll
      for (int i = 0; i < WARP_ROWS; ++i) unpack16(fraw[i], fv[i], T());
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) {
          float wv[V];
          unpack16(wraw[c], wv, T());
#pragma unroll
          for (int i = 0; i < WARP_ROWS; ++i)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[i][c] = fmaf(fv[i][e], wv[e], acc[i][c]);
        }
      }
    }
  } else {
    for (int h = lane; h < H; h += 32) {
      float fv[WARP_ROWS];
#pragma unroll
      for (int i = 0; i < WARP_ROWS; ++i) fv[i] = to_f32(fr[i][h]);
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c >= C) break;
        const float wv = to_f32(w[(long)c * H + h]);
#pragma unroll
        for (int i = 0; i < WARP_ROWS; ++i) acc[i][c] = fmaf(fv[i], wv, acc[i][c]);
      }
    }
  }
  float lg[MAX_C];                                 // lane i < WARP_ROWS: row rw + i
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c >= C) break;
#pragma unroll
    for (int i = 0; i < WARP_ROWS; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
    lg[c] = acc[0][c];
#pragma unroll
    for (int i = 1; i < WARP_ROWS; ++i)
      if (lane == i) lg[c] = acc[i][c];
    lg[c] += to_f32(b[c]);
  }
  const int r = rw + lane;
  if (lane >= WARP_ROWS || r >= rows) return;
  const float mx = row_max(lg, C);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {   // static indices: lg stays in registers
    if (c >= C) break;
    lg[c] = expf(lg[c] - mx);
    sum += lg[c];
  }
  const int lab = labels[r];
  const float a = dce[r], s = dlpu[r];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c >= C) break;
    const float p = lg[c] / sum;
    g[warp * WARP_ROWS + lane][c] = a * (p - (c == lab ? 1.f : 0.f)) + s * (p - 1.f / C);
  }
}

// K5: one block per BWD_COLS columns of H.  Each block forms g for every
// row itself (phase A, CHUNK_ROWS rows at a time, so any row count fits
// its shared memory) and then, for its own columns only (phase B),
// df[:, cols] = g . W[:, cols] and dW[:, cols] = sum over rows, in row
// order, of g[r]^T f[r, cols]; block 0 also sums db.  No block reads
// another's output: no atomics, no partials, the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ce_bwd_kernel(const T* __restrict__ f, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ dce, const float* __restrict__ dlpu,
                    T* __restrict__ df, float* __restrict__ dw, float* __restrict__ db,
                    int rows, int H, int C) {
  __shared__ float g[CHUNK_ROWS][MAX_C];
  __shared__ float wc[MAX_C][BWD_COLS];            // W[:, cols] as fp32
  constexpr int V = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int h0 = blockIdx.x * BWD_COLS;
  const bool vec = H % V == 0 && reinterpret_cast<size_t>(f) % 16 == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0;
  for (int e = tid; e < MAX_C * BWD_COLS; e += THREADS) {
    const int c = e / BWD_COLS, h = h0 + e % BWD_COLS;
    wc[c][e % BWD_COLS] = (c < C && h < H) ? to_f32(w[(long)c * H + h]) : 0.f;
  }
  // this thread's dW entries: column h, classes cg + CLASS_GROUPS * u
  const int cg = tid / BWD_COLS;
  const int h = h0 + tid % BWD_COLS;
  float aw[MAX_C / CLASS_GROUPS];
#pragma unroll
  for (int u = 0; u < MAX_C / CLASS_GROUPS; ++u) aw[u] = 0.f;
  float ab = 0.f;                                  // db[tid], block 0
  for (int r0 = 0; r0 < rows; r0 += CHUNK_ROWS) {
    const int n = min(CHUNK_ROWS, rows - r0);
    __syncthreads();                               // wc is in; g has no readers left
    chunk_terms(f, w, b, labels, dce, dlpu, r0, rows, H, C, vec, g, warp, lane);
    __syncthreads();
    for (int e = tid; e < n * BWD_COLS; e += THREADS) {   // df = g . W
      const int i = e / BWD_COLS, hl = e % BWD_COLS;
      if (h0 + hl >= H) continue;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc = fmaf(g[i][c], wc[c][hl], acc);
      df[(long)(r0 + i) * H + h0 + hl] = from_f32<T>(acc);
    }
    if (h < H) {                                   // dW += g^T . f, row by row
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float x = to_f32(f[(long)(r0 + i) * H + h]);
#pragma unroll
        for (int u = 0; u < MAX_C / CLASS_GROUPS; ++u) {
          const int c = cg + CLASS_GROUPS * u;
          if (c < C) aw[u] = fmaf(g[i][c], x, aw[u]);
        }
      }
    }
    if (blockIdx.x == 0 && tid < C)
      for (int i = 0; i < n; ++i) ab += g[i][tid];
  }
  if (h < H) {
#pragma unroll
    for (int u = 0; u < MAX_C / CLASS_GROUPS; ++u) {
      const int c = cg + CLASS_GROUPS * u;
      if (c < C) dw[(long)c * H + h] = aw[u];
    }
  }
  if (blockIdx.x == 0 && tid < C) db[tid] = ab;
}

bool valid(int rows, int H, int C) { return rows >= 1 && H >= 1 && C >= 1 && C <= MAX_C; }

}  // namespace

extern "C" {

int pdnlp_fused_ce_bwd_columns(void) { return BWD_COLS; }

int pdnlp_fused_ce_max_classes(void) { return MAX_C; }

const char* pdnlp_fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4.  f [rows, H], w [C, H], b [C] contiguous in one dtype; labels
// [rows] int32; ce, lpu, correct [rows] fp32.  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
int pdnlp_fused_ce_fwd(const void* f, const void* w, const void* b, const int* labels,
                       float* ce, float* lpu, float* correct, int rows, int H, int C,
                       int dtype, void* stream) {
  if (!valid(rows, H, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    fused_ce_fwd_kernel<float><<<rows, FWD_THREADS, 0, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(w),
        static_cast<const float*>(b), labels, ce, lpu, correct, H, C);
  else if (dtype == DTYPE_BF16)
    fused_ce_fwd_kernel<__nv_bfloat16><<<rows, FWD_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), labels, ce, lpu, correct, H, C);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K5.  As K4's inputs plus dce, dlpu [rows] fp32; writes df [rows, H] (the
// input dtype), dw [C, H] and db [C] fp32, each element by one block.
int pdnlp_fused_ce_bwd(const void* f, const void* w, const void* b, const int* labels,
                       const float* dce, const float* dlpu, void* df, float* dw, float* db,
                       int rows, int H, int C, int dtype, void* stream) {
  if (!valid(rows, H, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (H + BWD_COLS - 1) / BWD_COLS;
  if (dtype == DTYPE_F32)
    fused_ce_bwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(w),
        static_cast<const float*>(b), labels, dce, dlpu, static_cast<float*>(df), dw, db,
        rows, H, C);
  else if (dtype == DTYPE_BF16)
    fused_ce_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), labels, dce, dlpu,
        static_cast<__nv_bfloat16*>(df), dw, db, rows, H, C);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
