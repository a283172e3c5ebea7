// qmm_f32: float32 activations x exactly dequantized float32 weights, the
// dense dequant matmul of every weight source (Q4_K, Q5_K, Q4_0, Q5_0, Q8_0,
// Q6_K, Q3_K, Q2_K; Q4_1, Q5_1 and Q8_1 run the Q4_K, Q5_K and Q8_0 forms on
// their planes) under float32 compute, dense and grouped.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel at out_dtype
// float32 (launcher _run, pallas_call at :680, reached through :974; and the
// grouped launcher _run_grouped, pallas_call at :836, reached through
// qmatmul_grouped :911): there the weight tile is dequantized in float32,
// val*dsub + msub (:155-166), and the product taken at Precision.HIGHEST, so
// every weight is exact float32 and so is every product. out[r, n] = sum_k
// x[r, k] * w[n, k], float32 sums; grouped, w is the plane of row r's segment.
//
// Bound on the H100: operations. A 512-row chunk does 2 * 512 flops for
// each weight it reads (0.6 bytes with float32 scales): far above the CUDA
// cores' float32 ridge, and Hopper has no exact float32 tensor-core product
// (TF32 keeps 10 bits of mantissa), so the rate is the CUDA cores' 67 TFLOP/s.
//
// Design: a classic register-tiled FFMA matmul. A block of 256 threads owns
// 64 rows of x and 128 weight columns; each 32-deep k step stages x's tile
// (64 x 32, copied as float4) and the weights' tile (128 columns x 32 k),
// each thread dequantizing 16 consecutive weights of one column from the
// scheme's planes with one 16-byte load of values (the scheme's bit orders,
// quant/qtensor.py) and its scales. Both tiles lie k-major in shared memory,
// and each thread sums a 4 x 8 block of outputs, 32 FFMA for three 16-byte
// shared loads a k. The dequant repeats the plain version's arithmetic
// operation by operation with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn), which nvcc does not contract into an FMA: the weights equal
// the plain version's bit for bit, and only the order of the float32 sums
// differs. One stage, no double buffering: the first kernel that is right.
// Rows past the real ones and columns past N are zero-filled and never
// stored; K % 256 == 0.
//
// Grouped (the float32 mixture of experts' prefill): rows sorted by expert,
// offsets (n_planes + 1) on the device. The 64-row tiles are numbered through
// the segments by qmm_pipe.cuh's find_tile, as the bfloat16 grouped entries
// number their 128-row ones, so a tile never straddles two experts, a ragged
// segment ends in a short tile and an empty one has none; the host reads no
// count, so a CUDA graph can capture the launch. A stack's planes are
// (n_planes, N, ...) and every plane is indexed by the weight row, so the
// tile's expert e reads its weights at rows e * N + n: the offset that the
// bfloat16 sources' select_plane adds to each plane pointer.
#include "common.cuh"
#include "qmm_pipe.cuh"

namespace {

constexpr int BM = 64;   // rows of x a block
constexpr int BN = 128;  // weight columns a block
constexpr int BK = 32;   // k depth of one step
constexpr int NT = 256;  // threads: 16 x 16, each 4 rows x 8 columns

struct Planes {
    const uint8_t* q0;  // the values: nibbles, Q8_0's int8, Q6_K's ql, Q3_K's / Q2_K's qs
    const uint8_t* q1;  // Q5_K's and Q5_0's qh, Q6_K's qh, Q3_K's hb, Q2_K's scm
    const float* dsub;  // per 32 (Q6_K: per 16) elements
    const float* msub;  // Q4_K and Q5_K
    const int8_t* sc;   // Q3_K: per 16 elements
    const float* d;     // Q3_K and Q2_K: per superblock
    const float* dmin;  // Q2_K
    int K;
};

__device__ __forceinline__ uint4 ld16(const uint8_t* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int i) {
    const uint32_t w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
    return (w >> (8 * (i & 3))) & 0xFFu;
}

// The 16 weights k0 .. k0 + 15 (k0 % 16 == 0) of column n, in float32, as the
// plain versions compute them (ops/cuda/gemm_quant.py::qmm_<form>_plain).

// 4-bit values in the per-64 nibble order (byte j of a 64-element chunk holds
// element j low and j + 32 high), a Q5_K-order fifth bit (bit b of byte l of
// a superblock's 32 bytes is element 32 b + l) where QH, a minimum plane where
// MIN (w = val*dsub + msub), else the offset OFF (w = (val - OFF)*dsub)
template <bool QH, bool MIN, int OFF>
struct Nib64 {
    static __device__ __forceinline__ void dequant16(const Planes& p, size_t n, int k0, float (&w)[16]) {
        const int K = p.K, e = k0 & 63;
        const uint4 v = ld16(p.q0 + n * (K / 2) + (k0 >> 6) * 32 + (e & 31));
        const int sh = e >= 32 ? 4 : 0;
        uint4 h = make_uint4(0, 0, 0, 0);
        if (QH) h = ld16(p.q1 + n * (K / 8) + (k0 >> 8) * 32 + (k0 & 31));
        const int hb = (k0 & 255) >> 5;
        const float ds = p.dsub[n * (K / 32) + (k0 >> 5)];
        const float ms = MIN ? p.msub[n * (K / 32) + (k0 >> 5)] : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            int val = (byte_of(v, i) >> sh) & 15;
            if (QH) val |= ((byte_of(h, i) >> hb) & 1) << 4;
            w[i] = MIN ? __fadd_rn(__fmul_rn((float)val, ds), ms) : __fmul_rn((float)(val - OFF), ds);
        }
    }
};
using Q4K = Nib64<false, true, 0>;
using Q5K = Nib64<true, true, 0>;
using Q40 = Nib64<false, false, 8>;
using Q50 = Nib64<true, false, 16>;

struct Q80 {  // int8 values, one dsub per 32: w = qs*dsub
    static __device__ __forceinline__ void dequant16(const Planes& p, size_t n, int k0, float (&w)[16]) {
        const uint4 v = ld16(p.q0 + n * p.K + k0);
        const float ds = p.dsub[n * (p.K / 32) + (k0 >> 5)];
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = __fmul_rn((float)(int8_t)byte_of(v, i), ds);
    }
};

// ggml's 2-bit order per 128-element half: byte l of the half's 32 bytes
// holds elements l, l + 32, l + 64, l + 96 at shifts 0, 2, 4, 6
__device__ __forceinline__ uint4 two_bit_bytes(const uint8_t* row, int k0, int& shift) {
    const int e = k0 & 127;
    shift = 2 * (e >> 5);
    return ld16(row + (k0 >> 7) * 32 + (e & 31));
}

struct Q6K {  // ql: per half byte j holds element j low, j + 64 high; qh: the 2-bit order
    static __device__ __forceinline__ void dequant16(const Planes& p, size_t n, int k0, float (&w)[16]) {
        const int K = p.K, e = k0 & 127;
        const uint4 lo = ld16(p.q0 + n * (K / 2) + (k0 >> 7) * 64 + (e & 63));
        const int lsh = e >= 64 ? 4 : 0;
        int hsh;
        const uint4 hi = two_bit_bytes(p.q1 + n * (K / 4), k0, hsh);
        const float ds = p.dsub[n * (K / 16) + (k0 >> 4)];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int val = ((byte_of(lo, i) >> lsh) & 15) | (((byte_of(hi, i) >> hsh) & 3) << 4);
            w[i] = __fmul_rn((float)(val - 32), ds);
        }
    }
};

struct Q3K {  // w = (val - 4) * (d*sc), val 0..7: qs in the 2-bit order, hb's third bit
    static __device__ __forceinline__ void dequant16(const Planes& p, size_t n, int k0, float (&w)[16]) {
        const int K = p.K;
        int sh;
        const uint4 q = two_bit_bytes(p.q0 + n * (K / 4), k0, sh);
        const uint4 h = ld16(p.q1 + n * (K / 8) + (k0 >> 8) * 32 + (k0 & 31));
        const int hb = (k0 & 255) >> 5;
        const float dl = __fmul_rn(p.d[n * (K / 256) + (k0 >> 8)], (float)p.sc[n * (K / 16) + (k0 >> 4)]);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int val = ((byte_of(q, i) >> sh) & 3) | (((byte_of(h, i) >> hb) & 1) << 2);
            w[i] = __fmul_rn((float)(val - 4), dl);
        }
    }
};

struct Q2K {  // w = val*(d*sc) + -(dmin*mn), val 0..3; scm holds sc low, mn high
    static __device__ __forceinline__ void dequant16(const Planes& p, size_t n, int k0, float (&w)[16]) {
        const int K = p.K;
        int sh;
        const uint4 q = two_bit_bytes(p.q0 + n * (K / 4), k0, sh);
        const uint32_t scm = p.q1[n * (K / 16) + (k0 >> 4)];
        const size_t sb = n * (K / 256) + (k0 >> 8);
        const float dl = __fmul_rn(p.d[sb], (float)(scm & 15u));
        const float ml = -__fmul_rn(p.dmin[sb], (float)(scm >> 4));
#pragma unroll
        for (int i = 0; i < 16; ++i)
            w[i] = __fadd_rn(__fmul_rn((float)((byte_of(q, i) >> sh) & 3), dl), ml);
    }
};

// offsets == nullptr: dense, tile t covers rows [64 t, M) of the one plane
template <class S>
__global__ void __launch_bounds__(NT)
qmm_f32_kernel(const float* __restrict__ x, const Planes p, float* __restrict__ out,
               const int* __restrict__ offsets, int n_planes, int M, int N) {
    __shared__ __align__(16) float xs[BK][BM + 4];  // x's tile, k-major
    __shared__ __align__(16) float ws[BK][BN + 4];  // the weights' tile, k-major
    qpipe::Tile tile;
    if (!qpipe::find_tile<BM>(offsets, n_planes, M, blockIdx.y, tile)) return;
    const int K = p.K;
    const int tid = threadIdx.x;
    const int row0 = tile.m0, row_end = min(tile.m0 + BM, tile.m_end), col0 = blockIdx.x * BN;
    const int tr = tid / 16, tc = tid % 16;  // rows 4 tr.., columns 4 tc.. and 64 + 4 tc..
    const int wn = tid >> 1, wh = tid & 1;   // the weights this thread dequantizes: column wn, k half wh
    const bool wok = col0 + wn < N;
    const size_t wrow = (size_t)tile.plane * N + col0 + wn;  // its row of the stack's planes
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kb = 0; kb < K; kb += BK) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // 64 rows x 8 float4: two a thread
            const int idx = tid + h * NT, r = idx / 8, c4 = idx % 8 * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (row0 + r < row_end)
                v = *reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * K + kb + c4);
            xs[c4][r] = v.x;
            xs[c4 + 1][r] = v.y;
            xs[c4 + 2][r] = v.z;
            xs[c4 + 3][r] = v.w;
        }
        float w[16];
        if (wok) {
            S::dequant16(p, wrow, kb + 16 * wh, w);
        } else {
#pragma unroll
            for (int i = 0; i < 16; ++i) w[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) ws[16 * wh + i][wn] = w[i];
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * tr]);
            const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][4 * tc]);
            const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + 4 * tc]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = row0 + 4 * tr + i;
        if (r >= row_end) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col0 + (j < 4 ? 4 * tc + j : 64 + 4 * tc + j - 4);
            if (c < N) out[(size_t)r * N + c] = acc[i][j];
        }
    }
}

// dense with offsets == nullptr, else grouped over n_planes segments
template <class S>
int run(const void* x, const Planes& p, void* out, int M, int N, void* stream,
        const void* offsets = nullptr, int n_planes = 1) {
    if (p.K % 256 != 0 || M <= 0 || N <= 0 || n_planes <= 0) return (int)cudaErrorInvalidValue;
    const int tiles = offsets == nullptr ? qpipe::dense_tiles(M, BM)
                                         : qpipe::grouped_tiles(M, n_planes, BM);
    const dim3 grid((N + BN - 1) / BN, tiles);
    qmm_f32_kernel<S><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const float*)x, p, (float*)out, (const int*)offsets, n_planes, M, N);
    return crabml_launch_status();
}

Planes planes(const void* q0, const void* q1, const void* dsub, const void* msub, const void* sc,
              const void* d, const void* dmin, int K) {
    return Planes{(const uint8_t*)q0, (const uint8_t*)q1, (const float*)dsub, (const float*)msub,
                  (const int8_t*)sc, (const float*)d, (const float*)dmin, K};
}

}  // namespace

// x (M, K) float32; the weight planes of the form (ops/cuda/gemm_quant.py's
// _KERNEL_PLANES order, every dsub / msub plane float32); out (M, N) float32.
// K % 256 == 0; x and the planes 16-byte aligned (checked by the wrapper).
extern "C" int qmm_q4k_f32(const void* x, const void* qs, const void* dsub, const void* msub,
                           void* out, int M, int N, int K, void* stream) {
    return run<Q4K>(x, planes(qs, nullptr, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N,
                    stream);
}
extern "C" int qmm_q5k_f32(const void* x, const void* qs, const void* qh, const void* dsub,
                           const void* msub, void* out, int M, int N, int K, void* stream) {
    return run<Q5K>(x, planes(qs, qh, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N, stream);
}
extern "C" int qmm_q4_0_f32(const void* x, const void* qs, const void* dsub, void* out, int M,
                            int N, int K, void* stream) {
    return run<Q40>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream);
}
extern "C" int qmm_q5_0_f32(const void* x, const void* qs, const void* qh, const void* dsub,
                            void* out, int M, int N, int K, void* stream) {
    return run<Q50>(x, planes(qs, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream);
}
extern "C" int qmm_q8_0_f32(const void* x, const void* qs, const void* dsub, void* out, int M,
                            int N, int K, void* stream) {
    return run<Q80>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream);
}
extern "C" int qmm_q6k_f32(const void* x, const void* ql, const void* qh, const void* dsub,
                           void* out, int M, int N, int K, void* stream) {
    return run<Q6K>(x, planes(ql, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream);
}
extern "C" int qmm_q3k_f32(const void* x, const void* qs, const void* hb, const void* sc,
                           const void* d, void* out, int M, int N, int K, void* stream) {
    return run<Q3K>(x, planes(qs, hb, nullptr, nullptr, sc, d, nullptr, K), out, M, N, stream);
}
extern "C" int qmm_q2k_f32(const void* x, const void* qs, const void* scm, const void* d,
                           const void* dmin, void* out, int M, int N, int K, void* stream) {
    return run<Q2K>(x, planes(qs, scm, nullptr, nullptr, nullptr, d, dmin, K), out, M, N, stream);
}

// The grouped entries: x (M, K) float32 rows sorted by plane, offsets
// (n_planes + 1) int32 on the device with each plane's first row
// (offsets[n_planes] == M), the planes of the form as stacks (n_planes, N,
// ...) in the same order as the dense entry's, every dsub / msub float32; out
// (M, N) float32. Every row of out is written: each lies in one segment.
extern "C" int qmm_q4k_grouped_f32(const void* x, const void* qs, const void* dsub,
                                   const void* msub, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, void* stream) {
    return run<Q4K>(x, planes(qs, nullptr, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N,
                    stream, offsets, n_planes);
}
extern "C" int qmm_q5k_grouped_f32(const void* x, const void* qs, const void* qh, const void* dsub,
                                   const void* msub, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, void* stream) {
    return run<Q5K>(x, planes(qs, qh, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N, stream,
                    offsets, n_planes);
}
extern "C" int qmm_q4_0_grouped_f32(const void* x, const void* qs, const void* dsub, void* out,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    return run<Q40>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream, offsets, n_planes);
}
extern "C" int qmm_q5_0_grouped_f32(const void* x, const void* qs, const void* qh,
                                    const void* dsub, void* out, const void* offsets, int n_planes,
                                    int M, int N, int K, void* stream) {
    return run<Q50>(x, planes(qs, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream, offsets, n_planes);
}
extern "C" int qmm_q8_0_grouped_f32(const void* x, const void* qs, const void* dsub, void* out,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    return run<Q80>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream, offsets, n_planes);
}
extern "C" int qmm_q6k_grouped_f32(const void* x, const void* ql, const void* qh, const void* dsub,
                                   void* out, const void* offsets, int n_planes, int M, int N,
                                   int K, void* stream) {
    return run<Q6K>(x, planes(ql, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    stream, offsets, n_planes);
}
extern "C" int qmm_q3k_grouped_f32(const void* x, const void* qs, const void* hb, const void* sc,
                                   const void* d, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, void* stream) {
    return run<Q3K>(x, planes(qs, hb, nullptr, nullptr, sc, d, nullptr, K), out, M, N, stream,
                    offsets, n_planes);
}
extern "C" int qmm_q2k_grouped_f32(const void* x, const void* qs, const void* scm, const void* d,
                                   const void* dmin, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, void* stream) {
    return run<Q2K>(x, planes(qs, scm, nullptr, nullptr, nullptr, d, dmin, K), out, M, N, stream,
                    offsets, n_planes);
}
