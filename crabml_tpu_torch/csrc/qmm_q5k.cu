// qmm_q5k: fused Q5_K dequant + matmul for prefill rows (out = x @ W^T).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q5_K
// scheme: w = bf16(val * dsub + msub) per 32-element scale group, with val
// the 5-bit value 0..31, f32 accumulation. The dense entry qmm_q5k_bf16
// stands for the launcher _run (pallas_call at :680), the grouped entry
// qmm_q5k_grouped_bf16 for _run_grouped (:836),
// where rows sorted by expert multiply their own expert's plane.
//
// Bound on the H100: operations at the main path's 512-row prefill chunks
// (2 x 512 x 6144 x 4096 against 19 MB of planes for the fused q|k|v; the
// card's ridge is ~295 bf16 operations per byte). The tile loop is
// qmm_ws.cuh's (warp-specialized: a producer warpgroup's TMA copies into an
// mbarrier ring, two consumer warpgroups converting the weights into wgmma's
// register A operand, x tiles of up to 256 rows as its B operand; the launch
// is ops/cuda/gemm_quant.py::qmm_ws_plan's); this file is its Q5_K weight
// source. Q5_1 weights run it on planes converted at load (quant/qtensor.py).
//
// The planes: per 64-deep k step one 32-byte chunk of each weight row of
// nibbles, byte j holding element j low and element j + 32 high, and per 32
// elements a bf16 dsub and msub. The fifth bits keep ggml's order, which runs
// per superblock, not per step: bit b of byte l of a superblock's 32 qh bytes
// is the top bit of element 32 b + l. Step c (0..3) of a superblock therefore
// needs bits 2 c and 2 c + 1 of all 32 bytes, bit 2 c of byte j for element j
// and bit 2 c + 1 for element j + 32: the same byte index j as the nibble
// byte that holds the element. So the producer copies a superblock at a
// time, on its first step, into a superblock slot: its 128 nibble bytes of
// each weight row (a TMA box in the 128-byte swizzle: 16-byte chunk c of row
// r at c ^ (r & 7)), its 32 qh bytes (the 32-byte swizzle: chunk c at c ^ ((r
// >> 2) & 1)) and its eight dsub and eight msub (a 16-byte box row each). The
// swizzles put the eight rows a warp reads at once in distinct banks; the
// long nibble rows take a quarter of the TMA box rows that a box a step took.
// Every weight byte crosses from global memory once.
//
// Conversion, exactly the plain version's numbers: the thread's qh word, read
// at the same offset as its nibble word and shifted by the step's place in
// the superblock, holds the fifth bits of the word's four bytes; two masks and
// two shifts make the four 5-bit low values and the four high ones, a byte
// each, at once. PRMT puts a byte under 0x4B, the float 2^23 + val; FSUB of
// 2^23 leaves val exactly, and one FFMA, val * d + m, rounds where the plain
// version's multiply-then-add does: a 5-bit value times a bf16 scale has at
// most 13 significant bits, so the product is exact. cvt.rn.bf16x2.f32 then
// rounds two weights to a fragment register.
#include "qmm_ws.cuh"

namespace {

struct Q5KSource {
    static constexpr int STEP_BYTES = 0;  // the x ring alone holds each step
    // a superblock slot: nibbles (128 bytes a row) | qh (32) | dsub | msub (16 each)
    static constexpr int QS = 0, QH = 128 * 128, DSUB = QH + 128 * 32, MSUB = DSUB + 128 * 16;
    static constexpr int SB_BYTES = MSUB + 128 * 16;
    static constexpr int SB_STEPS = 4, SB_ARRIVALS = 1;
    static constexpr uint32_t STEP_TX = 0, SB_TX = (128 + 32 + 16 + 16) * qws::W_ROWS;

    CUtensorMap qs, qh, dsub, msub;

    // The planes of n_rows weight rows (a stack: n_planes * N), in boxes of a block's rows.
    int encode(const void* qs_, const void* qh_, const void* dsub_, const void* msub_, int n_rows,
               int K) {
        int e = qws::map_2d(&qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs_, K / 2, n_rows, 128,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_128B);
        if (!e)
            e = qws::map_2d(&qh, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qh_, K / 8, n_rows, 32,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_32B);
        if (!e)
            e = qws::map_2d(&dsub, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dsub_, K / 32, n_rows, 8,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
        if (!e)
            e = qws::map_2d(&msub, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, msub_, K / 32, n_rows, 8,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
        return e;
    }

    __device__ __forceinline__ void load_step(uint32_t, uint32_t, int, int) const {}
    __device__ __forceinline__ void load_superblock(uint32_t dst, uint32_t bar, int sb,
                                                    int wrow) const {
        wg::tma_load_2d(dst + QS, &qs, bar, sb * 128, wrow);
        wg::tma_load_2d(dst + QH, &qh, bar, sb * 32, wrow);
        wg::tma_load_2d(dst + DSUB, &dsub, bar, sb * 8, wrow);
        wg::tma_load_2d(dst + MSUB, &msub, bar, sb * 8, wrow);
    }
    __device__ __forceinline__ void copy_superblock(uint32_t, uint32_t, int, int, int, int) const {}

    // 16-byte chunk c (0, 1) of the 32-byte row r, as the 32-byte swizzle lays it
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
    }

    // the value under a float's bits (2^23 + v), minus 2^23, exactly
    static __device__ __forceinline__ float val_f32(uint32_t u) {
        return __fsub_rn(__uint_as_float(u), 8388608.0f);
    }

    // Weight rows c_lo and c_lo + 8 of the c-th step of the superblock; in
    // each 8-wide group of k the pair k = 2 qd, 2 qd + 1: bytes 2 (qd & 1), +1
    // of the group's word qd / 2, and the same bytes of the superblock's qh
    // row. Step c's nibbles are the 16-byte chunks 2 c, 2 c + 1 of its row.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t*,
                                              const uint8_t* slot, int c, int c_lo,
                                              int qd) const {
        // PRMT selectors: byte b of the word, two zero bytes, 0x4B
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel0 = 0x7440u | b, sel1 = 0x7440u | (b + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = c_lo + 8 * h;
            const uint32_t dp = *reinterpret_cast<const uint32_t*>(slot + DSUB + 16 * r + 4 * c);
            const uint32_t mp = *reinterpret_cast<const uint32_t*>(slot + MSUB + 16 * r + 4 * c);
            const float dl = __uint_as_float(dp << 16), dh = __uint_as_float(dp & 0xFFFF0000u);
            const float ml = __uint_as_float(mp << 16), mh = __uint_as_float(mp & 0xFFFF0000u);
#pragma unroll
            for (int m = 0; m < 4; ++m) {  // 8-byte group m: k16 step m / 2, its half m % 2
                const int in = (m & 1) * 8 + (qd >> 1) * 4;  // within the 16-byte chunk
                const uint32_t w = *reinterpret_cast<const uint32_t*>(
                    slot + QS + r * 128 + (((2 * c + (m >> 1)) ^ (r & 7)) << 4) + in);
                // the step's fifth bits at bit 0 (low nibbles) and 1 (high) of each byte
                const uint32_t t =
                    *reinterpret_cast<const uint32_t*>(slot + QH + chunk(r, m >> 1) + in) >>
                    (2 * c);
                // four 5-bit values a byte: the low nibbles', then the high nibbles'
                const uint32_t lo = (w & 0x0F0F0F0Fu) | ((t << 4) & 0x10101010u);
                const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) | ((t << 3) & 0x10101010u);
                a[m >> 1][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(val_f32(__byte_perm(lo, 0x4B000000u, sel0)), dl, ml),
                                  __fmaf_rn(val_f32(__byte_perm(lo, 0x4B000000u, sel1)), dl, ml));
                a[2 + (m >> 1)][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(val_f32(__byte_perm(hi, 0x4B000000u, sel0)), dh, mh),
                                  __fmaf_rn(val_f32(__byte_perm(hi, 0x4B000000u, sel1)), dh, mh));
            }
        }
    }
};

int run(const void* x, const void* qs, const void* qh, const void* dsub, const void* msub,
        void* out, int out_bf16, const int* offsets, int n_planes, int M, int N, int K,
        int tile_rows, void* stream) {
    Q5KSource w;
    const int e = w.encode(qs, qh, dsub, msub, n_planes * N, K);
    if (e) return e;
    return qws::launch(w, x, out, out_bf16, offsets, n_planes, M, N, K, tile_rows, stream);
}

}  // namespace

// x (M, K) bf16; qs (N, K/2) u8; qh (N, K/8) u8; dsub, msub (N, K/32) bf16;
// out (M, N) f32, or bf16 when out_bf16 != 0. K % 256 == 0 (Q5_K
// superblocks); tile_rows from qmm_ws_plan; the wrapper checks shapes and
// alignment.
extern "C" int qmm_q5k_bf16(const void* x, const void* qs, const void* qh, const void* dsub,
                            const void* msub, void* out, int out_bf16, int M, int N, int K,
                            int tile_rows, void* stream) {
    return run(x, qs, qh, dsub, msub, out, out_bf16, nullptr, 1, M, N, K, tile_rows, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/2), qh (n_planes, N, K/8), dsub, msub (n_planes, N, K/32).
extern "C" int qmm_q5k_grouped_bf16(const void* x, const void* qs, const void* qh,
                                    const void* dsub, const void* msub, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    int tile_rows, void* stream) {
    return run(x, qs, qh, dsub, msub, out, out_bf16, (const int*)offsets, n_planes, M, N, K,
               tile_rows, stream);
}

// The rings of a tile of tile_rows rows (qws::layout): stages, superblock
// slots, shared memory in use.
extern "C" int qmm_q5k_ws_layout(int tile_rows, int* out) {
    return qws::layout<Q5KSource>(tile_rows, out);
}
