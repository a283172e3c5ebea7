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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Four consecutive elements: `load_raw4` is the bare load (16 bytes for f32,
// 8 for bf16, 4 for int8) and `to_float4` the conversion, kept apart so that a
// kernel can start many loads before it waits for the first; `load4` is both.
__device__ __forceinline__ float4 load_raw4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load_raw4(const bf16* p) {
    return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ char4 load_raw4(const int8_t* p) {
    return *reinterpret_cast<const char4*>(p);
}
__device__ __forceinline__ float4 to_float4(float4 v) { return v; }
__device__ __forceinline__ float4 to_float4(uint2 u) {
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
    float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ float4 to_float4(char4 c) {
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
template <typename T> __device__ __forceinline__ float4 load4(const T* p) {
    return to_float4(load_raw4(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

static inline int crabml_launch_status() { return (int)cudaGetLastError(); }

extern "C" const char* crabml_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
