// norm: RMSNorm, and phi2's LayerNorm, over the last axis; one block a row.
//
// Replaces no Pallas kernel: crabml_tpu/ops/norm.py::rms_norm (:27) and
// ::layer_norm (:8) are plain jnp, which XLA fuses into one pass on the TPU.
// It was added because the port's plain version (torch's float32 mean, then
// the add, root, divide and multiply, and the casts: 6 to 9 launches a norm)
// reduces a row in an order that depends on how many rows the call holds:
// a row's norm moved by an ulp between a batch of 1 and of 2, and a 7B decode
// step's float32 logits through the int8 activation codes by up to 7.3e-2
// (NVIDIA H100 80GB HBM3), enough to turn a greedy token of the 2-slot
// engine away from the Runner's. Here one block of NT threads sums a row in
// one fixed order that depends only on the row's length: thread i takes
// elements i, i + NT, ... in turn, the warps reduce by the same butterfly and
// the eight warp sums are added in warp order. A row gives the same bits
// alone, in a batch of any size or in a prefill chunk, and a norm is one
// launch. Up to 8,192 a row is loaded into registers once, with its weights
// (VPT values a thread, all loads issued together), so that a decode step's
// one-row norm waits for memory once.
//
// What it computes, as the plain version (ops/cuda/norm.py), in float32
// whatever x's type: mean = sum(x) / n (LayerNorm only, else 0), var =
// sum((x - mean)^2) / n, out = (x - mean) / sqrt(var + eps) * w (+ b),
// rounded once to x's type. Every step is an IEEE round-to-nearest
// intrinsic, so no contraction or fast-math changes it; the squares are
// summed with fma. The weight holds w_rows rows of n (a (D,) norm 1, qwen3's
// per-head q|k weights H + KV): row r of x takes weight row r % w_rows.
//
// Bound on the H100: bytes. x is read once (past 8,192 a row twice, the
// second time from L1) and written once; at a decode step's 1-8 rows of
// 4,096 the launch's own latency, a few microseconds, is the cost, and a
// 512-row prefill chunk moves 16 MB in float32.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads a row

// The sum of every thread's v, in every thread, in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
    v = warp_sum(v);  // a butterfly: every lane adds the same pairs
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) s = __fadd_rn(s, red[i]);
    __syncthreads();  // red is written again by the next sum
    return s;
}

// VPT > 0: a row of n <= NT * VPT; thread t loads elements t + k NT (k <
// VPT) of x, the weight row and the bias into registers at once, so a row
// costs one memory latency, and sums them in k order. VPT = 0: any n, each pass a loop over the row in global
// memory in the same order (t, t + NT, ...).
template <typename T, int VPT>
__global__ void __launch_bounds__(NT) norm_kernel(const T* __restrict__ x,
                                                  const float* __restrict__ w,
                                                  const float* __restrict__ b,
                                                  T* __restrict__ out, int n, int w_rows,
                                                  float eps, int center) {
    constexpr int REGS = VPT > 0 ? VPT : 1;
    __shared__ float red[NT / 32];
    const long row = blockIdx.x;
    const T* xr = x + row * n;
    T* yr = out + row * n;
    const float* wr = w + (row % w_rows) * n;
    const int t = threadIdx.x;
    float v[REGS], wv[REGS], bv[REGS];  // x, and the weight and bias loaded beside it
    if (VPT > 0) {
#pragma unroll
        for (int k = 0; k < REGS; ++k) {
            const int i = t + k * NT;
            v[k] = i < n ? to_f32(xr[i]) : 0.f;
            wv[k] = i < n ? wr[i] : 0.f;
            bv[k] = i < n && b ? b[i] : 0.f;
        }
    }
    auto at = [&](int k, int i) -> float {
        if constexpr (VPT > 0) return v[k];
        else return to_f32(xr[i]);
    };
    const int steps = VPT > 0 ? VPT : (n + NT - 1) / NT;
    float mean = 0.f;
    if (center) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < steps; ++k)
            if (t + k * NT < n) s = __fadd_rn(s, at(k, t + k * NT));
        mean = __fdiv_rn(block_sum(s, red), (float)n);
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < steps; ++k) {
        if (t + k * NT < n) {
            const float d = __fsub_rn(at(k, t + k * NT), mean);
            ss = __fmaf_rn(d, d, ss);
        }
    }
    const float root = __fsqrt_rn(__fadd_rn(__fdiv_rn(block_sum(ss, red), (float)n), eps));
#pragma unroll
    for (int k = 0; k < steps; ++k) {
        const int i = t + k * NT;
        if (i < n) {
            float o = __fmul_rn(__fdiv_rn(__fsub_rn(at(k, i), mean), root),
                                VPT > 0 ? wv[k] : wr[i]);
            if (b) o = __fadd_rn(o, VPT > 0 ? bv[k] : b[i]);
            yr[i] = from_f32<T>(o);
        }
    }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int rows, int n, int w_rows,
           float eps, int center, cudaStream_t s) {
    const T* xt = (const T*)x;
    const float *wt = (const float*)w, *bt = (const float*)b;
    T* ot = (T*)out;
#define NORM_CASE(V)                                                                      \
    if (n <= NT * V) {                                                                    \
        norm_kernel<T, V><<<rows, NT, 0, s>>>(xt, wt, bt, ot, n, w_rows, eps, center);    \
        return crabml_launch_status();                                                   \
    }
    NORM_CASE(1) NORM_CASE(2) NORM_CASE(4) NORM_CASE(8) NORM_CASE(16) NORM_CASE(32)
#undef NORM_CASE
    norm_kernel<T, 0><<<rows, NT, 0, s>>>(xt, wt, bt, ot, n, w_rows, eps, center);
    return crabml_launch_status();
}

}  // namespace

// x, out: rows x n, contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// w: w_rows x n float32; b: n float32 or null; center: 1 for LayerNorm.
extern "C" int row_norm(int bf16_x, const void* x, const void* w, const void* b, void* out,
                        int rows, int n, int w_rows, float eps, int center, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16_x ? launch<bf16>(x, w, b, out, rows, n, w_rows, eps, center, s)
                  : launch<float>(x, w, b, out, rows, n, w_rows, eps, center, s);
}
