// The tile machinery the flash kernels share (flash_fwd.cu: K1;
// flash_bwd.cu: K2, K3): asynchronous tile loads, the fp32 CUDA-core
// products, and the bf16 tensor-core fragments (ldmatrix, mma.sync, the
// accumulator-to-A-fragment repack).
#pragma once

#include "flash_common.cuh"

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int F32_LD = HEAD_D + 4;    // fp32 tile row stride (floats)
constexpr int BF16_LD = HEAD_D + 8;   // bf16 tile row stride (elements)
constexpr int BF_THREADS = 128;       // 4 warps of the bf16 kernels
constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------- async copies

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without registers; zeros when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0..row0+63 of one head ([B, S, N, D] at g = (b, 0, n, 0)) into a
// padded shared tile; rows past S become zeros.  NT threads share it.
template <int NT, typename T, int LD>
__device__ __forceinline__ void load_tile_async(T (*dst)[LD], const T* g, long row_stride,
                                                int row0, int S, int tid) {
  constexpr int CH = HEAD_D * (int)sizeof(T) / 16;   // 16 B chunks per row
  constexpr int EL = 16 / (int)sizeof(T);
  static_assert(TILE_Q * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < TILE_Q * CH / NT; ++i) {
    const int e = tid + i * NT, r = e / CH, c = e % CH;
    const bool in = row0 + r < S;
    cp_async16(&dst[r][c * EL], g + (in ? row0 + r : 0) * row_stride + c * EL, in);
  }
}

// ------------------------------------------------ fp32: CUDA-core products

// acc[i][j] += sum_d a[4ty + i][d] * b[tx + 16j][d]: rows against rows,
// 4 head dims a step, U steps unrolled.
template <int U = 2>
__device__ __forceinline__ void product_nt(const float (*a)[F32_LD], const float (*b)[F32_LD],
                                           int ty, int tx, float acc[4][4]) {
#pragma unroll U
  for (int d = 0; d < HEAD_D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&a[4 * ty + i][d]);
      bv[i] = *reinterpret_cast<const float4*>(&b[tx + 16 * i][d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_c a[4ty + i][c] * b[c][4tx + j]: rows against columns,
// 4 columns a step, U steps unrolled.
template <int U = 2>
__device__ __forceinline__ void product_nn(const float (*a)[F32_LD], const float (*b)[F32_LD],
                                           int ty, int tx, float acc[4][4]) {
#pragma unroll U
  for (int c = 0; c < TILE_K; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&a[4 * ty + i][c]);
      bv[i] = *reinterpret_cast<const float4*>(&b[c + i][4 * tx]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ai[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[i][0] = fmaf(ai[cc], bv[cc].x, acc[i][0]);
        acc[i][1] = fmaf(ai[cc], bv[cc].y, acc[i][1]);
        acc[i][2] = fmaf(ai[cc], bv[cc].z, acc[i][2]);
        acc[i][3] = fmaf(ai[cc], bv[cc].w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ----------------------------------------------- bf16: tensor-core products
//
// Fragments of mma.m16n8k16 (lane = 4g + t): A (16 x 16, row-major) a0 =
// (row g, cols 2t, 2t+1), a1 = row g+8, a2 = cols +8, a3 = both; B (16 x 8,
// k x n) b0 = (k 2t, 2t+1; col g), b1 = k +8; C (16 x 8 fp32) c0, c1 = (row
// g, cols 2t, 2t+1), c2, c3 = row g+8.

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores: bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest bf16, the lower column in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// The A fragment of rows r0..r0+15, cols c0..c0+15 of a row-major tile.
__device__ __forceinline__ void lds_a(unsigned a[4], const bf16 (*t)[BF16_LD], int r0, int c0,
                                      int lane) {
  ldsm_x4(a, &t[r0 + (lane & 15)][c0 + (lane >> 4) * 8]);
}

// B fragments of X . T^T, T row-major with its rows as the n axis: rows
// n0..n0+7 in b[0], b[1] and rows n0+8..n0+15 in b[2], b[3], over the
// depth c0..c0+15.
__device__ __forceinline__ void lds_b_rows(unsigned b[4], const bf16 (*t)[BF16_LD], int n0,
                                           int c0, int lane) {
  ldsm_x4(b, &t[n0 + (lane & 7) + ((lane >> 4) << 3)][c0 + ((lane >> 3) & 1) * 8]);
}

// B fragments of X . T, T row-major with its rows as the depth: depth
// r0..r0+15, columns n0..n0+7 in b[0], b[1] and n0+8..n0+15 in b[2], b[3].
__device__ __forceinline__ void lds_b_cols(unsigned b[4], const bf16 (*t)[BF16_LD], int r0,
                                           int n0, int lane) {
  ldsm_x4_trans(b, &t[r0 + (lane & 7) + ((lane >> 3) & 1) * 8][n0 + (lane >> 4) * 8]);
}

// acc (16 rows x 32 columns, n8 tiles 0..3) += rows r0..r0+15 of x .
// rows n0..n0+31 of t ^T, over the 64 head dims.  x's fragments are read
// anew from shared memory each time: held in registers for the whole walk
// they would cost 32 a thread and spill.
__device__ __forceinline__ void mma_rows(float acc[4][4], const bf16 (*x)[BF16_LD], int r0,
                                         const bf16 (*t)[BF16_LD], int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    lds_a(a, x, r0, 16 * kk, lane);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      unsigned b[4];
      lds_b_rows(b, t, n0 + 16 * jj, 16 * kk, lane);
      mma_bf16(acc[2 * jj], a, b[0], b[1]);
      mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows x 64 head dims, n8 tiles 0..7) += x . rows r0..r0+31 of t,
// x being two k16 A fragments (32 walked columns).
__device__ __forceinline__ void mma_cols(float acc[8][4], const unsigned x[2][4],
                                         const bf16 (*t)[BF16_LD], int r0, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      unsigned b[4];
      lds_b_cols(b, t, r0 + 16 * u, 16 * jj, lane);
      mma_bf16(acc[2 * jj], x[u], b[0], b[1]);
      mma_bf16(acc[2 * jj + 1], x[u], b[2], b[3]);
    }
}

// Four n8 accumulator tiles (16 x 32) as two bf16 k16 A fragments.
__device__ __forceinline__ void to_a_frags(const float c[4][4], unsigned x[2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    x[u][0] = pack_bf16(c[2 * u][0], c[2 * u][1]);
    x[u][1] = pack_bf16(c[2 * u][2], c[2 * u][3]);
    x[u][2] = pack_bf16(c[2 * u + 1][0], c[2 * u + 1][1]);
    x[u][3] = pack_bf16(c[2 * u + 1][2], c[2 * u + 1][3]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero_frags(float acc[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

}  // namespace flash
