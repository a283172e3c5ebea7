// qmm_q6k: fused Q6_K dequant + matmul for prefill rows (out = x @ W^T).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q6_K
// scheme: w = bf16((val - 32) * dsub) per 16-element scale group, with val
// the 6-bit value 0..63, f32 accumulation. The dense entry qmm_q6k_bf16
// stands for the launcher _run (pallas_call at :680), the grouped entry
// qmm_q6k_grouped_bf16 for _run_grouped (:836): rows sorted by expert, each
// segment against its own expert's plane.
//
// Bound on the H100: operations at the main path's 512-row prefill chunks
// (2 x 512 x 6144 x 4096 against 23 MB of planes for the fused q|k|v; the
// card's ridge is ~295 bf16 operations per byte). The tile loop is
// qmm_ws.cuh's (warp-specialized: a producer warpgroup's TMA copies into an
// mbarrier ring, two consumer warpgroups converting the weights into wgmma's
// register A operand, x tiles of up to 256 rows as its B operand; the launch
// is ops/cuda/gemm_quant.py::qmm_ws_plan's); this file is its Q6_K weight
// source.
//
// The planes keep ggml's Q6_K bit order, which runs per 128-element half of
// a superblock, not per 64-deep k step: byte j of the half's 64 ql bytes
// holds element j in its low nibble and element j + 64 in its high nibble,
// and bits 2s, 2s + 1 of byte j of its 32 qh bytes are the top two bits of
// element 32 s + j. A 64-deep step therefore needs all of its half's ql and
// qh bytes (the low nibbles and qh bits 0-3 for the half's first step, the
// high nibbles and bits 4-7 for its second). So the producer copies a half
// once, on its first step, for both of its steps (SB_STEPS = 2): per weight
// row its 64 ql bytes (a TMA box in the 64-byte swizzle: 16-byte chunk c of
// row r at c ^ ((r >> 1) & 3)), its 32 qh bytes (the 32-byte swizzle: chunk
// c at c ^ ((r >> 2) & 1)) and the 8 bf16 dsub of its 16-element groups (a
// 16-byte box row), 14,336 bytes a slot for the block's 128 rows. The
// swizzles put the eight rows a warp reads at once in distinct banks. Every
// weight byte crosses from global memory once. A half, not a 256-deep
// superblock, is the slot because a superblock's 28 KB would leave a 64-row
// tile 11 steps of ring where halves leave it 16 (qws::ring_shape).
//
// Conversion, exactly the plain version's numbers: the thread's 32-bit words
// of ql and qh give four 6-bit values at once (a shift and a mask each, an
// OR); PRMT puts two of them under 0x43, the bf16 128 + val, and one HSUB2 of
// 160 leaves val - 32 exactly; one HMUL2 by the bf16 scale pair rounds once:
// (val - 32) times a bf16 has at most 14 significant bits, so the product is
// exact before that rounding, which is the plain version's float32 product
// rounded once to bf16.
#include "qmm_ws.cuh"

namespace {

struct Q6KSource {
    static constexpr int STEP_BYTES = 0;  // the x ring alone holds each step
    // a half slot: ql (64 bytes a row) | qh (32) | dsub (8 x bf16)
    static constexpr int QL = 0, QH = 128 * 64, DS = QH + 128 * 32;
    static constexpr int SB_BYTES = DS + 128 * 16;
    static constexpr int SB_STEPS = 2, SB_ARRIVALS = 1;
    static constexpr uint32_t STEP_TX = 0, SB_TX = (64 + 32 + 16) * qws::W_ROWS;

    CUtensorMap ql, qh, dsub;

    // The planes of n_rows weight rows (a stack: n_planes * N), in boxes of a block's rows.
    int encode(const void* ql_, const void* qh_, const void* dsub_, int n_rows, int K) {
        int e = qws::map_2d(&ql, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ql_, K / 2, n_rows, 64,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_64B);
        if (!e)
            e = qws::map_2d(&qh, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qh_, K / 4, n_rows, 32,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_32B);
        if (!e)
            e = qws::map_2d(&dsub, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dsub_, K / 16, n_rows, 8,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
        return e;
    }

    __device__ __forceinline__ void load_step(uint32_t, uint32_t, int, int) const {}
    // half hf of the weight rows from wrow
    __device__ __forceinline__ void load_superblock(uint32_t dst, uint32_t bar, int hf,
                                                    int wrow) const {
        wg::tma_load_2d(dst + QL, &ql, bar, hf * 64, wrow);
        wg::tma_load_2d(dst + QH, &qh, bar, hf * 32, wrow);
        wg::tma_load_2d(dst + DS, &dsub, bar, hf * 8, wrow);
    }
    __device__ __forceinline__ void copy_superblock(uint32_t, uint32_t, int, int, int, int) const {}

    // Weight rows c_lo and c_lo + 8 of the c-th step of a superblock, the
    // (c & 1)-th of its half: low nibbles and qh bits 0-3, or high nibbles
    // and bits 4-7. In each 8-wide group of k the pair k = 2 qd, 2 qd + 1:
    // bytes 2 (qd & 1), +1 of the group's ql word and qh word.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t*,
                                              const uint8_t* slot, int c, int c_lo,
                                              int qd) const {
        const int p = c & 1;
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel = 0x4040u | b | ((b + 1) << 8);
        const uint32_t bias = 0x43204320u;  // bf16 160, 160
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = c_lo + 8 * h;
            // the step's four scales: groups 4 p .. 4 p + 3 of the half
            const uint2 ds = *reinterpret_cast<const uint2*>(slot + DS + 16 * r + 8 * p);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t dw = kk < 2 ? ds.x : ds.y;
                const uint32_t dd = __byte_perm(dw, 0, (kk & 1) ? 0x3232 : 0x1010);
                const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dd);
                const int hs = 2 * (2 * p + (kk >> 1));  // qh bits of these 32 elements
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {  // k = 0..7, 8..15 of the k16 step
                    const int off = 8 * hf + 4 * (qd >> 1);
                    // ql byte 16 kk + off (chunk kk), qh byte 16 (kk & 1) + off
                    const uint32_t lw = *reinterpret_cast<const uint32_t*>(
                        slot + QL + 64 * r + (((kk ^ (r >> 1)) & 3) << 4) + off);
                    const uint32_t hw = *reinterpret_cast<const uint32_t*>(
                        slot + QH + 32 * r + ((((kk & 1) ^ (r >> 2)) & 1) << 4) + off);
                    const uint32_t v = ((lw >> (4 * p)) & 0x0F0F0F0Fu) |
                                       (((hw >> hs) & 0x03030303u) << 4);
                    const uint32_t full = __byte_perm(v, 0x43434343u, sel);  // 128 + val
                    const __nv_bfloat162 w =
                        __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&full), b2), d2);
                    a[kk][2 * hf + h] = *reinterpret_cast<const uint32_t*>(&w);
                }
            }
        }
    }
};

int run(const void* x, const void* ql, const void* qh, const void* dsub, void* out, int out_bf16,
        const int* offsets, int n_planes, int M, int N, int K, int tile_rows, void* stream) {
    Q6KSource w;
    const int e = w.encode(ql, qh, dsub, n_planes * N, K);
    if (e) return e;
    return qws::launch(w, x, out, out_bf16, offsets, n_planes, M, N, K, tile_rows, stream);
}

}  // namespace

// x (M, K) bf16; ql (N, K/2) u8; qh (N, K/4) u8; dsub (N, K/16) bf16; out (M,
// N) f32, or bf16 when out_bf16 != 0. K % 256 == 0; tile_rows from
// qmm_ws_plan; the wrapper checks shapes and alignment.
extern "C" int qmm_q6k_bf16(const void* x, const void* ql, const void* qh, const void* dsub,
                            void* out, int out_bf16, int M, int N, int K, int tile_rows,
                            void* stream) {
    return run(x, ql, qh, dsub, out, out_bf16, nullptr, 1, M, N, K, tile_rows, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// ql (n_planes, N, K/2), qh (n_planes, N, K/4), dsub (n_planes, N, K/16).
extern "C" int qmm_q6k_grouped_bf16(const void* x, const void* ql, const void* qh,
                                    const void* dsub, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    int tile_rows, void* stream) {
    return run(x, ql, qh, dsub, out, out_bf16, (const int*)offsets, n_planes, M, N, K, tile_rows,
               stream);
}

// The rings of a tile of tile_rows rows (qws::layout): stages, superblock
// (half) slots, shared memory in use.
extern "C" int qmm_q6k_ws_layout(int tile_rows, int* out) {
    return qws::layout<Q6KSource>(tile_rows, out);
}
