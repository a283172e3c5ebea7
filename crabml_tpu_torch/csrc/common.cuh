// Shared helpers for the port's hand-written Hopper kernels.
//
// Every source in this directory builds into its own shared library with a
// plain C interface (no PyTorch headers): pointers and the stream arrive as
// void*, and each entry returns cudaGetLastError() so the Python wrapper can
// raise on a launch that was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CRABML_NEG_INF (-1e30f)  // masking value of the JAX package (forward.py NEG_INF)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

static inline int crabml_launch_status() { return (int)cudaGetLastError(); }

extern "C" const char* crabml_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
