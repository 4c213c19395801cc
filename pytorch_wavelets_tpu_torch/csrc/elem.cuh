// The element types the kernels that take bf16 natively are instantiated
// for (K2 q2c_pack.cu, K3 c2q_unpack.cu, K17 banded_apply_tc.cu): a value
// is loaded to float, computed on in float, and stored from float, so a
// bf16 output is rounded once, where it is written (round to nearest
// even).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
