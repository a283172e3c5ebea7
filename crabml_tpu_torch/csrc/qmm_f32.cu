// qmm_f32: float32 activations x exactly dequantized float32 weights, the
// dense dequant matmul of every weight source (Q4_K, Q5_K, Q4_0, Q5_0, Q8_0,
// Q6_K, Q3_K, Q2_K; Q4_1, Q5_1 and Q8_1 run the Q4_K, Q5_K and Q8_0 forms on
// their planes) under float32 compute, dense and grouped.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel at out_dtype
// float32 (launcher _run, pallas_call at :680, reached through :974; and the
// grouped launcher _run_grouped, pallas_call at :836, reached through
// qmatmul_grouped :911): there the weight tile is dequantized in float32,
// val*dsub + msub (:155-166), and the product taken at Precision.HIGHEST, which
// the TPU's matrix unit reaches in several bfloat16 passes. out[r, n] = sum_k
// x[r, k] * w[n, k], float32 sums; grouped, w is the plane of row r's segment.
//
// Bound on the H100: operations. A 512-row chunk does 2 * 512 flops for each
// weight it reads (0.6 bytes with float32 scales). Hopper has no float32
// tensor-core product, and the CUDA cores' float32 rate is 67 TFLOP/s; TF32
// (10 mantissa bits) runs at 495. So each operand is split into two TF32
// parts, v = hi + lo (hi = v rounded to TF32, lo = the rest rounded to TF32:
// |v - hi - lo| <= 2^-22 |v|), and each product taken in three TF32 passes,
// w_lo * x_hi + w_hi * x_lo + w_hi * x_hi, into a float32 accumulator; the
// dropped w_lo * x_lo is ~2^-22 of |w * x|. Bound: 495 / 3 = 165 TFLOP/s,
// 2.5x the CUDA cores'. The tensor cores' float32 accumulation is not IEEE
// round-to-nearest: summed into one accumulator over all of k, the error grew
// with k (3e-5 of max|out| at k = 4,096, 1.1e-4 at 14,336, on the H100), so
// the accumulator restarts every 256 elements of k (CHUNK_STEPS steps) and
// the chunks' sums are added in float32 with __fadd_rn, in a shared tile.
//
// Design: qmm_pipe.cuh's structure. A block (two warpgroups) computes out^T =
// W . x^T for 128 weight rows (64 a warpgroup) and a tile of up to 128 rows of
// x. The weights are wgmma's register A operand, the x tile its B operand in
// shared memory (K-major, 128-byte swizzle; wgmma's N is the tile's row count
// rounded up to 16, 32, 64, 96 or 128). Per 32-deep k step:
//   - x: a ring of STAGES steps filled by cp.async, AHEAD steps ahead. When a
//     step has landed, each thread splits the 16-byte chunks it copied: hi in
//     place, lo into the slot's second tile; fence.proxy.async, then the
//     step's one __syncthreads.
//   - weights: thread t dequantizes 16 consecutive weights of weight row t / 2
//     with the scheme's trait (its planes' bit orders, quant/qtensor.py), by the
//     plain version's operations with round-to-nearest intrinsics (__fmul_rn,
//     __fadd_rn, which nvcc does not contract into an FMA): the weights equal
//     the plain version's bit for bit. Neither a value's float32 nor a TF32
//     rounding takes a conversion instruction (they issue at a fraction of
//     the integer and float32 rates): both are exact bit operations
//     (`exact_int`, wg::tf32_rna). A trait's global loads (`load`) are
//     issued two steps before its arithmetic (`convert`). The 16 weights go to
//     a small shared tile, laid out [row][k % 4][k / 4], from which each thread
//     reads its A fragments (two rows, two k a k8 step; no bank conflicts) and
//     splits them in registers.
//   - the products: twelve m64nNk8 TF32 wgmmas a warpgroup (four k8 steps, the
//     small terms first), started behind the previous step's, which are still
//     running, and only that previous group is waited for; the tensor cores
//     drain only at the end of a chunk, where each thread adds its
//     accumulators to its elements of the shared total.
// (Tried on the H100 and not kept: a producer warpgroup filling the ring for
// two consumer warpgroups through named barriers. One warpgroup then carried
// the whole step's conversion and splitting, and the loop ran 1.17-1.37x
// slower; PERF.md.)
// Epilogue: 16-byte stores along rows of out from the shared total. Rows past
// the real ones and columns past N are zero-filled and never stored; K % 256
// == 0.
//
// Tiles: blockIdx.x walks the row tiles, blockIdx.y the 128-row weight tiles.
// The rows a tile holds (`tile_rows`: 128, 96, 64, 32 or 16) come from the
// launch plan (ops/cuda/gemm_quant.py::qmm_f32_plan, a function of the
// shapes): the least waves of blocks times each block's k steps, a step's
// cost its wgmma width plus a fixed part as large as 125 rows (measured). So
// the 189-row chunk takes 96 blocks of 96 rows, not 144 of 64: one block
// fits an SM, and a 64-row block takes 0.75 of a 128-row one's time. Grouped (the float32
// mixture of experts' prefill): rows sorted by expert, offsets (n_planes + 1)
// on the device; qmm_pipe.cuh's find_tile numbers the tiles through the
// segments, so a tile never straddles two experts, a ragged segment ends in a
// short tile and an empty one has none; the host reads no count, so a CUDA
// graph can capture the launch. A stack's planes are (n_planes, N, ...) and every plane
// is indexed by the weight row, so the tile's expert e reads its weights at
// rows e * N + n: the offset that the bfloat16 sources' select_plane adds.
#include "common.cuh"
#include "qmm_pipe.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BW = qpipe::BW;  // weight rows (output columns) a block: 64 a warpgroup
constexpr int BX = 128;        // rows of x a tile, at most
constexpr int BK = 32;         // k a ring stage: one 128-byte row of float32 x
constexpr int NT = 256;        // two warpgroups
constexpr int STAGES = 3;
constexpr int AHEAD = STAGES - 1;  // a step's x tile is fetched this many steps ahead
constexpr int CHUNK_STEPS = 256 / BK;  // k steps a tensor-core accumulation runs before it is added
constexpr int X_BYTES = BX * BK * 4;  // one x tile (hi or lo) at the widest
constexpr int SLOT = 2 * X_BYTES;     // a ring slot: the hi tile, then the lo tile
constexpr int WLD = 36;               // a weight row of the exchange tile, in floats (32 + 4)
constexpr int W_BYTES = BW * WLD * 4;
constexpr int LDC = BW + 4;  // row of the shared total, in floats
constexpr int T_BYTES = BX * LDC * 4;
constexpr int SMEM_BYTES = STAGES * SLOT + 2 * W_BYTES + T_BYTES + 1024;  // + slack to align
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on the H100");

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

// The exact float32 of v - OFF for 0 <= v < 2^23: 2^23 + v as a bit pattern,
// less 2^23 + OFF (both exact; so is the difference). A logic operation and
// an add where (float)(v - OFF) takes a conversion instruction.
template <int OFF> __device__ __forceinline__ float exact_int(uint32_t v) {
    return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f + OFF);
}

// The 16 weights k0 .. k0 + 15 (k0 % 16 == 0) of weight row n, in float32, as
// the plain versions compute them (ops/cuda/gemm_quant.py::qmm_<form>_plain):
// `load` reads the bytes and scales they need, `convert` does the arithmetic.

// 4-bit values in the per-64 nibble order (byte j of a 64-element chunk holds
// element j low and j + 32 high), a Q5_K-order fifth bit (bit b of byte l of
// a superblock's 32 bytes is element 32 b + l) where QH, a minimum plane where
// MIN (w = val*dsub + msub), else the offset OFF (w = (val - OFF)*dsub)
template <bool QH, bool MIN, int OFF>
struct Nib64 {
    struct Raw {
        uint4 v, h;
        float ds, ms;
    };
    static __device__ __forceinline__ Raw load(const Planes& p, size_t n, int k0) {
        const int K = p.K, e = k0 & 63;
        Raw r;
        r.v = ld16(p.q0 + n * (K / 2) + (k0 >> 6) * 32 + (e & 31));
        r.h = QH ? ld16(p.q1 + n * (K / 8) + (k0 >> 8) * 32 + (k0 & 31)) : make_uint4(0, 0, 0, 0);
        r.ds = p.dsub[n * (K / 32) + (k0 >> 5)];
        r.ms = MIN ? p.msub[n * (K / 32) + (k0 >> 5)] : 0.f;
        return r;
    }
    static __device__ __forceinline__ void convert(const Raw& r, int k0, float (&w)[16]) {
        const int sh = (k0 & 63) >= 32 ? 4 : 0;
        const int hb = (k0 & 255) >> 5;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            uint32_t val = (byte_of(r.v, i) >> sh) & 15;
            if (QH) val |= ((byte_of(r.h, i) >> hb) & 1) << 4;
            w[i] = MIN ? __fadd_rn(__fmul_rn(exact_int<0>(val), r.ds), r.ms)
                       : __fmul_rn(exact_int<OFF>(val), r.ds);
        }
    }
};
using Q4K = Nib64<false, true, 0>;
using Q5K = Nib64<true, true, 0>;
using Q40 = Nib64<false, false, 8>;
using Q50 = Nib64<true, false, 16>;

struct Q80 {  // int8 values, one dsub per 32: w = qs*dsub
    struct Raw {
        uint4 v;
        float ds;
    };
    static __device__ __forceinline__ Raw load(const Planes& p, size_t n, int k0) {
        return Raw{ld16(p.q0 + n * p.K + k0), p.dsub[n * (p.K / 32) + (k0 >> 5)]};
    }
    static __device__ __forceinline__ void convert(const Raw& r, int, float (&w)[16]) {
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = __fmul_rn(exact_int<128>(byte_of(r.v, i) ^ 0x80u), r.ds);
    }
};

// ggml's 2-bit order per 128-element half: byte l of the half's 32 bytes
// holds elements l, l + 32, l + 64, l + 96 at shifts 0, 2, 4, 6
__device__ __forceinline__ uint4 two_bit_bytes(const uint8_t* row, int k0) {
    return ld16(row + (k0 >> 7) * 32 + (k0 & 31));
}
__device__ __forceinline__ int two_bit_shift(int k0) { return 2 * ((k0 & 127) >> 5); }

struct Q6K {  // ql: per half byte j holds element j low, j + 64 high; qh: the 2-bit order
    struct Raw {
        uint4 lo, hi;
        float ds;
    };
    static __device__ __forceinline__ Raw load(const Planes& p, size_t n, int k0) {
        const int K = p.K;
        Raw r;
        r.lo = ld16(p.q0 + n * (K / 2) + (k0 >> 7) * 64 + (k0 & 63));
        r.hi = two_bit_bytes(p.q1 + n * (K / 4), k0);
        r.ds = p.dsub[n * (K / 16) + (k0 >> 4)];
        return r;
    }
    static __device__ __forceinline__ void convert(const Raw& r, int k0, float (&w)[16]) {
        const int lsh = (k0 & 127) >= 64 ? 4 : 0, hsh = two_bit_shift(k0);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const uint32_t val =
                ((byte_of(r.lo, i) >> lsh) & 15) | (((byte_of(r.hi, i) >> hsh) & 3) << 4);
            w[i] = __fmul_rn(exact_int<32>(val), r.ds);
        }
    }
};

struct Q3K {  // w = (val - 4) * (d*sc), val 0..7: qs in the 2-bit order, hb's third bit
    struct Raw {
        uint4 q, h;
        float d;
        int sc;
    };
    static __device__ __forceinline__ Raw load(const Planes& p, size_t n, int k0) {
        const int K = p.K;
        Raw r;
        r.q = two_bit_bytes(p.q0 + n * (K / 4), k0);
        r.h = ld16(p.q1 + n * (K / 8) + (k0 >> 8) * 32 + (k0 & 31));
        r.d = p.d[n * (K / 256) + (k0 >> 8)];
        r.sc = p.sc[n * (K / 16) + (k0 >> 4)];
        return r;
    }
    static __device__ __forceinline__ void convert(const Raw& r, int k0, float (&w)[16]) {
        const int sh = two_bit_shift(k0), hb = (k0 & 255) >> 5;
        const float dl = __fmul_rn(r.d, (float)r.sc);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const uint32_t val = ((byte_of(r.q, i) >> sh) & 3) | (((byte_of(r.h, i) >> hb) & 1) << 2);
            w[i] = __fmul_rn(exact_int<4>(val), dl);
        }
    }
};

struct Q2K {  // w = val*(d*sc) + -(dmin*mn), val 0..3; scm holds sc low, mn high
    struct Raw {
        uint4 q;
        uint32_t scm;
        float d, dmin;
    };
    static __device__ __forceinline__ Raw load(const Planes& p, size_t n, int k0) {
        const int K = p.K;
        const size_t sb = n * (K / 256) + (k0 >> 8);
        return Raw{two_bit_bytes(p.q0 + n * (K / 4), k0), p.q1[n * (K / 16) + (k0 >> 4)], p.d[sb],
                   p.dmin[sb]};
    }
    static __device__ __forceinline__ void convert(const Raw& r, int k0, float (&w)[16]) {
        const int sh = two_bit_shift(k0);
        const float dl = __fmul_rn(r.d, (float)(r.scm & 15u));
        const float ml = -__fmul_rn(r.dmin, (float)(r.scm >> 4));
#pragma unroll
        for (int i = 0; i < 16; ++i)
            w[i] = __fadd_rn(__fmul_rn(exact_int<0>((byte_of(r.q, i) >> sh) & 3), dl), ml);
    }
};

// One tile with an NX-wide wgmma: rows tile.m0 .. tile.m_end (at most NX) of
// x against weight rows n0 .. n0 + 127 of plane tile.plane. `smem` / `smem_s`:
// the aligned ring as a generic pointer and as a shared-space address.
template <int NX, class S>
__device__ __forceinline__ void run_tile(const float* __restrict__ x, const Planes& p,
                                         float* __restrict__ out, const qpipe::Tile& tile, int n0,
                                         int N, uint8_t* smem, uint32_t smem_s) {
    constexpr int ND = NX / 2;  // accumulator registers a thread
    const int K = p.K, KT = K / BK;
    const int tid = threadIdx.x;
    const int wgi = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int qd = lane % 4;
    const int c_lo = wgi * 64 + 16 * warp + lane / 4;  // this thread's weight rows: c_lo, c_lo + 8

    // this thread's share of an x tile: 16-byte chunk xc (4 k) of rows xr + 32 i
    // (the swizzle depends on the row modulo 8 only, so the copies lie 4,096
    // bytes apart); it also splits those chunks
    constexpr int XPER = (NX * 8 + NT - 1) / NT;
    const int xr = tid / 8, xc = tid % 8;
    const float* xsrc[XPER];
    uint32_t xok = 0;
#pragma unroll
    for (int i = 0; i < XPER; ++i) {
        const int r = xr + 32 * i;
        const bool ok = r < NX && tile.m0 + r < tile.m_end;
        xsrc[i] = x + (size_t)(tile.m0 + (ok ? r : 0)) * K + xc * 4;
        xok |= (uint32_t)ok << i;
    }
    const uint32_t xdst = wg::swz128(xr, xc);
    auto mine = [&](int i) { return NX * 8 >= NT * (i + 1) || xr + 32 * i < NX; };

    auto fetch = [&](int it) {  // k step `it` of x into its ring slot
        const uint32_t slot = smem_s + (it % STAGES) * SLOT;
#pragma unroll
        for (int i = 0; i < XPER; ++i)
            if (mine(i)) wg::cp_async16(slot + xdst + i * 4096, xsrc[i] + it * BK, (xok >> i) & 1);
    };
    auto split = [&](int it) {  // this thread's chunks of step `it`: hi in place, lo beside
        uint8_t* slot = smem + (it % STAGES) * SLOT;
#pragma unroll
        for (int i = 0; i < XPER; ++i) {
            if (!mine(i)) continue;
            float4* hp = reinterpret_cast<float4*>(slot + xdst + i * 4096);
            const float4 v = *hp;
            uint4 hi, lo;
            wg::tf32_split(v.x, hi.x, lo.x);
            wg::tf32_split(v.y, hi.y, lo.y);
            wg::tf32_split(v.z, hi.z, lo.z);
            wg::tf32_split(v.w, hi.w, lo.w);
            *reinterpret_cast<uint4*>(hp) = hi;
            *reinterpret_cast<uint4*>(slot + X_BYTES + xdst + i * 4096) = lo;
        }
    };

    // the weights this thread dequantizes: row wn, k half wh of each step
    const int wn = tid >> 1, wh = tid & 1;
    const bool wok = n0 + wn < N;
    const size_t wrow = (size_t)tile.plane * N + n0 + (wok ? wn : 0);  // its row of the stack's planes
    float* wtile = reinterpret_cast<float*>(smem + STAGES * SLOT);     // two exchange tiles
    // the sums of the chunks so far: [x row][weight row]
    float* total = reinterpret_cast<float*>(smem + STAGES * SLOT + 2 * W_BYTES);
    auto stage_w = [&](const typename S::Raw& raw, int it) {  // step it's 16 weights, converted
        float w[16];
        S::convert(raw, it * BK + 16 * wh, w);
        float* dst = wtile + (it & 1) * (BW * WLD) + wn * WLD + 4 * wh;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float4*>(dst + 8 * q) =
                wok ? make_float4(w[q], w[q + 4], w[q + 8], w[q + 12]) : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // this thread's A fragments of step it's four k8 steps, split: element
    // [s][2 g + h] is weight row c_lo + 8 h at k 8 s + 4 g + qd
    auto fragments = [&](int it, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
        const float* src = wtile + (it & 1) * (BW * WLD) + qd * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float4 a = *reinterpret_cast<const float4*>(src + (c_lo + 8 * h) * WLD);
            const float4 b = *reinterpret_cast<const float4*>(src + (c_lo + 8 * h) * WLD + 4);
            const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
                for (int g = 0; g < 2; ++g) wg::tf32_split(v[2 * s + g], hi[s][2 * g + h], lo[s][2 * g + h]);
        }
    };

#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < KT) fetch(s);
        wg::cp_async_commit();
    }
    // a step's loads are issued two steps before its conversion
    typename S::Raw raw[2] = {S::load(p, wrow, 16 * wh), S::load(p, wrow, BK + 16 * wh)};
    uint32_t hi[2][4][4], lo[2][4][4];
    float acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    wg::cp_async_wait<STAGES - 2>();  // step 0 has landed (this thread's part)
    split(0);
    wg::fence_async_proxy();
    stage_w(raw[0], 0);
    __syncthreads();
    fragments(0, hi[0], lo[0]);

    // Software pipeline, two steps deep: a step's wgmmas are started behind
    // the previous step's, which are still running, and only that previous
    // group is waited for. Meanwhile the same threads issue the loads of step
    // it + 2's weights, convert step it + 1's into the exchange tile, split
    // step it + 1's x, refill the slot that step it - 1 left, and build step
    // it + 1's fragments in the registers that step it - 1 used.
    auto step = [&](int it, uint32_t (&uhi)[4][4], uint32_t (&ulo)[4][4], uint32_t (&fhi)[4][4],
                    uint32_t (&flo)[4][4], typename S::Raw& raw_next, typename S::Raw& raw_now) {
        const uint32_t xs = smem_s + (it % STAGES) * SLOT;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            wg::pin(uhi[s]);
            wg::pin(ulo[s]);
        }
        wg::pin(acc);
        wg::fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // the small terms first
            wg::Tf32<NX>::rs(acc, ulo[s], wg::desc128(xs + 32 * s),
                             !(it % CHUNK_STEPS == 0 && s == 0));
            wg::Tf32<NX>::rs(acc, uhi[s], wg::desc128(xs + X_BYTES + 32 * s), 1);
            wg::Tf32<NX>::rs(acc, uhi[s], wg::desc128(xs + 32 * s), 1);
        }
        wg::commit();
        if (it + 2 < KT) raw_next = S::load(p, wrow, (it + 2) * BK + 16 * wh);
        if (it + 1 < KT) stage_w(raw_now, it + 1);
        wg::wait<1>();  // step it - 1 is done: its slot and its fragments are free
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            wg::pin(fhi[s]);
            wg::pin(flo[s]);
        }
        if (it + 1 < KT) {
            wg::cp_async_wait<STAGES - 3>();  // step it + 1 has landed (this thread's part)
            split(it + 1);
            wg::fence_async_proxy();
        }
        __syncthreads();  // step it + 1's x split and weights staged; everyone past step it - 1
        if (it + AHEAD < KT) fetch(it + AHEAD);  // into the slot of step it - 1
        wg::cp_async_commit();
        if (it + 1 < KT) fragments(it + 1, fhi, flo);
        if (it % CHUNK_STEPS == CHUNK_STEPS - 1) {  // the chunk's sums into the total
            wg::wait<0>();
            wg::pin(acc);
#pragma unroll
            for (int i = 0; i < ND; ++i) {
                float* t = total + (8 * (i / 4) + 2 * qd + (i & 1)) * LDC + c_lo + 8 * ((i >> 1) & 1);
                *t = it < CHUNK_STEPS ? acc[i] : __fadd_rn(*t, acc[i]);
            }
        }
    };
    for (int it = 0; it < KT; it += 2) {  // K is a multiple of CHUNK_STEPS BK
        step(it, hi[0], lo[0], hi[1], lo[1], raw[0], raw[1]);
        step(it + 1, hi[1], lo[1], hi[0], lo[0], raw[1], raw[0]);
    }
    wg::wait<0>();
    wg::pin(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        wg::pin(hi[0][s]);
        wg::pin(lo[0][s]);
        wg::pin(hi[1][s]);
        wg::pin(lo[1][s]);
    }

    // epilogue: rows of out from the total (each thread added its own elements)
    __syncthreads();
    const int rows = tile.m_end - tile.m0;
    const bool vec = N % 8 == 0;
    for (int e = tid; e < rows * (BW / 8); e += NT) {
        const int n = e / (BW / 8), col = n0 + e % (BW / 8) * 8;
        if (col >= N) continue;
        const float* src = total + n * LDC + (col - n0);
        float* o = out + (size_t)(tile.m0 + n) * N + col;
        if (vec) {
            *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(src);
            *reinterpret_cast<float4*>(o + 4) = *reinterpret_cast<const float4*>(src + 4);
        } else {
            for (int j = 0; j < 8 && col + j < N; ++j) o[j] = src[j];
        }
    }
}

// offsets == nullptr: dense, tile t covers rows [tile_rows t, M) of the one
// plane (cut to tile_rows); else grouped over n_planes segments
template <class S>
__global__ void __launch_bounds__(NT, 1)
qmm_f32_kernel(const float* __restrict__ x, const Planes p, float* __restrict__ out,
               const int* __restrict__ offsets, int n_planes, int M, int N, int tile_rows) {
    extern __shared__ uint8_t smem_raw[];
    qpipe::Tile tile;
    if (!qpipe::find_tile(offsets, n_planes, M, blockIdx.x, tile, tile_rows)) return;
    const int rows = min(tile_rows, tile.m_end - tile.m0);
    tile.m_end = tile.m0 + rows;
    const uint32_t raw_s = wg::smem_u32(smem_raw);
    const uint32_t smem_s = (raw_s + 1023u) & ~1023u;
    uint8_t* smem = smem_raw + (smem_s - raw_s);
    const int n0 = blockIdx.y * BW;
    if (rows > 96) run_tile<128, S>(x, p, out, tile, n0, N, smem, smem_s);
    else if (rows > 64) run_tile<96, S>(x, p, out, tile, n0, N, smem, smem_s);
    else if (rows > 32) run_tile<64, S>(x, p, out, tile, n0, N, smem, smem_s);
    else if (rows > 16) run_tile<32, S>(x, p, out, tile, n0, N, smem, smem_s);
    else run_tile<16, S>(x, p, out, tile, n0, N, smem, smem_s);
}

// dense with offsets == nullptr, else grouped over n_planes segments
template <class S>
int run(const void* x, const Planes& p, void* out, int M, int N, int tile_rows, void* stream,
        const void* offsets = nullptr, int n_planes = 1) {
    if (p.K % 256 != 0 || M <= 0 || N <= 0 || n_planes <= 0 ||
        (tile_rows != 16 && tile_rows != 32 && tile_rows != 64 && tile_rows != 96 &&
         tile_rows != BX))
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_f32_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const int tiles = offsets == nullptr ? qpipe::dense_tiles(M, tile_rows)
                                         : qpipe::grouped_tiles(M, n_planes, tile_rows);
    const dim3 grid(tiles, (N + BW - 1) / BW);
    qmm_f32_kernel<S><<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)x, p, (float*)out, (const int*)offsets, n_planes, M, N, tile_rows);
    return crabml_launch_status();
}

Planes planes(const void* q0, const void* q1, const void* dsub, const void* msub, const void* sc,
              const void* d, const void* dmin, int K) {
    return Planes{(const uint8_t*)q0, (const uint8_t*)q1, (const float*)dsub, (const float*)msub,
                  (const int8_t*)sc, (const float*)d, (const float*)dmin, K};
}

}  // namespace

// x (M, K) float32; the weight planes of the form (ops/cuda/gemm_quant.py's
// _KERNEL_PLANES order, every dsub / msub plane float32); out (M, N) float32;
// tile_rows: rows of x a tile (qmm_f32_plan: 128, 96, 64, 32 or 16). K % 256 ==
// 0; x and the planes 16-byte aligned (checked by the wrapper).
extern "C" int qmm_q4k_f32(const void* x, const void* qs, const void* dsub, const void* msub,
                           void* out, int M, int N, int K, int tile_rows, void* stream) {
    return run<Q4K>(x, planes(qs, nullptr, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream);
}
extern "C" int qmm_q5k_f32(const void* x, const void* qs, const void* qh, const void* dsub,
                           const void* msub, void* out, int M, int N, int K, int tile_rows,
                           void* stream) {
    return run<Q5K>(x, planes(qs, qh, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream);
}
extern "C" int qmm_q4_0_f32(const void* x, const void* qs, const void* dsub, void* out, int M,
                            int N, int K, int tile_rows, void* stream) {
    return run<Q40>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream);
}
extern "C" int qmm_q5_0_f32(const void* x, const void* qs, const void* qh, const void* dsub,
                            void* out, int M, int N, int K, int tile_rows, void* stream) {
    return run<Q50>(x, planes(qs, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream);
}
extern "C" int qmm_q8_0_f32(const void* x, const void* qs, const void* dsub, void* out, int M,
                            int N, int K, int tile_rows, void* stream) {
    return run<Q80>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream);
}
extern "C" int qmm_q6k_f32(const void* x, const void* ql, const void* qh, const void* dsub,
                           void* out, int M, int N, int K, int tile_rows, void* stream) {
    return run<Q6K>(x, planes(ql, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream);
}
extern "C" int qmm_q3k_f32(const void* x, const void* qs, const void* hb, const void* sc,
                           const void* d, void* out, int M, int N, int K, int tile_rows,
                           void* stream) {
    return run<Q3K>(x, planes(qs, hb, nullptr, nullptr, sc, d, nullptr, K), out, M, N, tile_rows,
                    stream);
}
extern "C" int qmm_q2k_f32(const void* x, const void* qs, const void* scm, const void* d,
                           const void* dmin, void* out, int M, int N, int K, int tile_rows,
                           void* stream) {
    return run<Q2K>(x, planes(qs, scm, nullptr, nullptr, nullptr, d, dmin, K), out, M, N,
                    tile_rows, stream);
}

// The grouped entries: x (M, K) float32 rows sorted by plane, offsets
// (n_planes + 1) int32 on the device with each plane's first row
// (offsets[n_planes] == M), the planes of the form as stacks (n_planes, N,
// ...) in the same order as the dense entry's, every dsub / msub float32; out
// (M, N) float32; tile_rows as the dense entry's. Every row of out is
// written: each lies in one segment.
extern "C" int qmm_q4k_grouped_f32(const void* x, const void* qs, const void* dsub,
                                   const void* msub, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, int tile_rows, void* stream) {
    return run<Q4K>(x, planes(qs, nullptr, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
extern "C" int qmm_q5k_grouped_f32(const void* x, const void* qs, const void* qh, const void* dsub,
                                   const void* msub, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, int tile_rows, void* stream) {
    return run<Q5K>(x, planes(qs, qh, dsub, msub, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
extern "C" int qmm_q4_0_grouped_f32(const void* x, const void* qs, const void* dsub, void* out,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    int tile_rows, void* stream) {
    return run<Q40>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
extern "C" int qmm_q5_0_grouped_f32(const void* x, const void* qs, const void* qh,
                                    const void* dsub, void* out, const void* offsets, int n_planes,
                                    int M, int N, int K, int tile_rows, void* stream) {
    return run<Q50>(x, planes(qs, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
extern "C" int qmm_q8_0_grouped_f32(const void* x, const void* qs, const void* dsub, void* out,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    int tile_rows, void* stream) {
    return run<Q80>(x, planes(qs, nullptr, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
extern "C" int qmm_q6k_grouped_f32(const void* x, const void* ql, const void* qh, const void* dsub,
                                   void* out, const void* offsets, int n_planes, int M, int N,
                                   int K, int tile_rows, void* stream) {
    return run<Q6K>(x, planes(ql, qh, dsub, nullptr, nullptr, nullptr, nullptr, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
extern "C" int qmm_q3k_grouped_f32(const void* x, const void* qs, const void* hb, const void* sc,
                                   const void* d, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, int tile_rows, void* stream) {
    return run<Q3K>(x, planes(qs, hb, nullptr, nullptr, sc, d, nullptr, K), out, M, N, tile_rows,
                    stream, offsets, n_planes);
}
extern "C" int qmm_q2k_grouped_f32(const void* x, const void* qs, const void* scm, const void* d,
                                   const void* dmin, void* out, const void* offsets, int n_planes,
                                   int M, int N, int K, int tile_rows, void* stream) {
    return run<Q2K>(x, planes(qs, scm, nullptr, nullptr, nullptr, d, dmin, K), out, M, N,
                    tile_rows, stream, offsets, n_planes);
}
