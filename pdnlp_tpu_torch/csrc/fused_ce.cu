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
// CUDA blocks run in no order, so here every block writes its rows' partial
// dW/db to scratch, and the last block to finish (a ticket counter) adds
// the partials in block order: a fixed order, no fp32 atomics, so dW and
// db are the same bits on every run.
//
// What bounds it on an H100: nothing large.  At the train step's shapes
// (T = 32 rows, H = 768, C = 6) the pair moves about 0.2 MB and does a few
// MFLOP, well under a microsecond of either the memory or the arithmetic
// bound; each launch costs more than its work.  The design keeps the
// launch count at one per kernel (the partial reduce rides in K5's last
// block) and the logits on the SM; one warp owns one row, its lanes
// striding over H, C sums reduced by shuffles.  The TPU layouts are not
// carried over: no class padding to 128 lanes, no lane-broadcast row
// operands, no padding of rows to a block.

#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;   // one warp per row
constexpr int MAX_C = 16;            // classes held in registers

// Row r's fp32 logits, in every lane of the calling warp.
template <typename T>
__device__ __forceinline__ void row_logits(const T* __restrict__ f, const T* __restrict__ w,
                                           const T* __restrict__ b, int r, int H, int C,
                                           int lane, float logits[MAX_C]) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) logits[c] = 0.f;
  const T* fr = f + (long)r * H;
  for (int h = lane; h < H; h += 32) {
    const float x = to_f32(fr[h]);
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < C) logits[c] = fmaf(x, to_f32(w[(long)c * H + h]), logits[c]);
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c >= C) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      logits[c] += __shfl_xor_sync(0xffffffffu, logits[c], off);
    logits[c] += to_f32(b[c]);
  }
}

__device__ __forceinline__ float row_max(const float logits[MAX_C], int C) {
  float mx = logits[0];
#pragma unroll
  for (int c = 1; c < MAX_C; ++c)
    if (c < C) mx = fmaxf(mx, logits[c]);
  return mx;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_kernel(const T* __restrict__ f, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    float* __restrict__ ce, float* __restrict__ lpu,
                    float* __restrict__ correct, int rows, int H, int C) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * ROWS + threadIdx.x / 32;
  if (r >= rows) return;                       // a whole warp
  float logits[MAX_C];
  row_logits(f, w, b, r, H, C, lane, logits);
  if (lane != 0) return;
  const float mx = row_max(logits, C);
  float sum = 0.f, total = 0.f;
  int first = C;                               // first index at the max
  for (int c = 0; c < C; ++c) {
    sum += expf(logits[c] - mx);
    total += logits[c];
    if (first == C && logits[c] == mx) first = c;
  }
  const float lse = mx + logf(sum);
  const int lab = labels[r];
  const float logit_lab = (lab >= 0 && lab < C) ? logits[lab] : 0.f;
  ce[r] = lse - logit_lab;
  lpu[r] = lse - total / C;
  correct[r] = first == lab ? 1.f : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ce_bwd_kernel(const T* __restrict__ f, const T* __restrict__ w,
                    const T* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ dce, const float* __restrict__ dlpu,
                    T* __restrict__ df, float* __restrict__ dw, float* __restrict__ db,
                    float* __restrict__ part_w, float* __restrict__ part_b,
                    unsigned int* __restrict__ ticket, int rows, int H, int C) {
  __shared__ float g[ROWS][MAX_C];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int r0 = blockIdx.x * ROWS;
  const int r = r0 + warp;

  // g of the block's rows (0 for rows past the end)
  float logits[MAX_C];
  if (r < rows) row_logits(f, w, b, r, H, C, lane, logits);
  if (lane == 0) {
    if (r < rows) {
      const float mx = row_max(logits, C);
      float sum = 0.f;
      for (int c = 0; c < C; ++c) sum += expf(logits[c] - mx);
      const int lab = labels[r];
      const float a = dce[r], s = dlpu[r];
      for (int c = 0; c < C; ++c) {
        const float p = expf(logits[c] - mx) / sum;
        g[warp][c] = a * (p - (c == lab ? 1.f : 0.f)) + s * (p - 1.f / C);
      }
    } else {
      for (int c = 0; c < C; ++c) g[warp][c] = 0.f;
    }
  }
  __syncthreads();

  const int n_rows = min(ROWS, rows - r0);
  for (int e = tid; e < n_rows * H; e += THREADS) {       // df = g . W
    const int i = e / H, h = e % H;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(g[i][c], to_f32(w[(long)c * H + h]), acc);
    df[(long)(r0 + i) * H + h] = from_f32<T>(acc);
  }
  float* pw = part_w + (long)blockIdx.x * C * H;          // this block's g^T . f
  for (int e = tid; e < C * H; e += THREADS) {
    const int c = e / H, h = e % H;
    float acc = 0.f;
    for (int i = 0; i < n_rows; ++i)
      acc = fmaf(g[i][c], to_f32(f[(long)(r0 + i) * H + h]), acc);
    pw[e] = acc;
  }
  for (int c = tid; c < C; c += THREADS) {
    float acc = 0.f;
    for (int i = 0; i < n_rows; ++i) acc += g[i][c];
    part_b[(long)blockIdx.x * C + c] = acc;
  }

  // the last block to finish adds the partials in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = tid; e < C * H; e += THREADS) {
    float acc = 0.f;
    for (int blk = 0; blk < (int)gridDim.x; ++blk) acc += __ldcg(&part_w[(long)blk * C * H + e]);
    dw[e] = acc;
  }
  for (int c = tid; c < C; c += THREADS) {
    float acc = 0.f;
    for (int blk = 0; blk < (int)gridDim.x; ++blk) acc += __ldcg(&part_b[(long)blk * C + c]);
    db[c] = acc;
  }
}

bool valid(int rows, int H, int C) { return rows >= 1 && H >= 1 && C >= 1 && C <= MAX_C; }

int blocks(int rows) { return (rows + ROWS - 1) / ROWS; }

}  // namespace

extern "C" {

int pdnlp_fused_ce_rows_per_block(void) { return ROWS; }

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
    fused_ce_fwd_kernel<float><<<blocks(rows), THREADS, 0, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(w),
        static_cast<const float*>(b), labels, ce, lpu, correct, rows, H, C);
  else if (dtype == DTYPE_BF16)
    fused_ce_fwd_kernel<__nv_bfloat16><<<blocks(rows), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), labels, ce, lpu, correct, rows, H, C);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K5.  As K4's inputs plus dce, dlpu [rows] fp32; writes df [rows, H] (the
// input dtype), dw [C, H] and db [C] fp32.  part_w [blocks, C, H] and
// part_b [blocks, C] fp32 are scratch (blocks = ceil(rows / rows per
// block)); ticket is one uint32 that must be 0 at launch.
int pdnlp_fused_ce_bwd(const void* f, const void* w, const void* b, const int* labels,
                       const float* dce, const float* dlpu, void* df, float* dw, float* db,
                       float* part_w, float* part_b, unsigned int* ticket, int rows, int H,
                       int C, int dtype, void* stream) {
  if (!valid(rows, H, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    fused_ce_bwd_kernel<float><<<blocks(rows), THREADS, 0, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(w),
        static_cast<const float*>(b), labels, dce, dlpu, static_cast<float*>(df), dw, db,
        part_w, part_b, ticket, rows, H, C);
  else if (dtype == DTYPE_BF16)
    fused_ce_bwd_kernel<__nv_bfloat16><<<blocks(rows), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), labels, dce, dlpu,
        static_cast<__nv_bfloat16*>(df), dw, db, part_w, part_b, ticket, rows, H, C);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
