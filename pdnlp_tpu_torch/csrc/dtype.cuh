// The storage types every kernel library takes, with the codes the Python
// wrappers pass (ops/flash.py and ops/fused_ce.py _DTYPE_CODE), and the
// conversions they load and store through: arithmetic is fp32 whatever the
// storage type.
#pragma once

#include <cuda_bf16.h>

enum DType { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
