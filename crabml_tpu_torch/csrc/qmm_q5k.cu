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
// qmm_pipe.cuh's (wgmma with the weights as the register A operand, the x
// tile as B in swizzled shared memory, a six-stage cp.async ring, two wgmma
// groups in flight); this file is its Q5_K weight source, qmm_q4k.cu's Q4_K
// source with a fifth bit.
//
// The nibbles and the folded scales are Q4_K's (see qmm_q4k.cu): per 64-deep
// k step one 32-byte chunk of each weight row, byte j holding element j low
// and element j + 32 high, and per 32 elements a bf16 dsub and msub. The
// fifth bits keep ggml's order, which runs per superblock, not per step: bit
// b of byte l of a superblock's 32 qh bytes is the top bit of element 32 b +
// l. Step c (0..3) of a superblock therefore needs bits 2 c and 2 c + 1 of
// all 32 bytes, bit 2 c of byte j for element j and bit 2 c + 1 for element
// j + 32: the same byte index j as the nibble byte that holds the element.
// So a superblock's qh bytes are staged once, on its first step, exactly as
// qmm_q4k.cu stages the scales of four steps: 32 bytes a row, one 16-byte
// cp.async a thread every fourth step, into a ring of their own beside the
// scale ring (`EXTRA_BYTES`, SC_SLOTS slots of 4,096 bytes each), with the
// same swap of 16-byte chunks in rows 4..7 of every 8. Every weight byte
// crosses from global memory once.
//
// Conversion, exactly the plain version's numbers: the thread's qh word,
// read at the same offset as its nibble word, gives the fifth bit of each of
// its bytes; OR-ed under 0x4B000000 with the nibble (at bit 4 for the low
// nibble, at bit 8 beside the high nibble kept times 16), subtracting 2^23
// leaves the value exactly, and one FFMA, val * d + m, rounds where the
// plain version's multiply-then-add does: a 5-bit value times a bf16 scale
// has at most 13 significant bits, so the product is exact. cvt.rn.bf16x2.f32
// then rounds two weights to a fragment register, as in qmm_q4k.cu.
#include "qmm_pipe.cuh"

namespace {

struct Q5KSource {
    static constexpr int KSC = 0;  // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = qpipe::BW * qpipe::BK / 2;  // 32 bytes of nibbles a row
    // a slot holds SC_STEPS steps' dsub and msub of the 128 rows, and beside
    // it the superblock's qh; both are filled by the fetch of the first step f
    // of the superblock, after the barrier of step f - AHEAD, and the last step
    // they held before, f - SC_STEPS * (SC_SLOTS - 1) - 1, was converted
    // before that barrier. So SC_STEPS * (SC_SLOTS - 1) + 1 >= AHEAD.
    static constexpr int SC_STEPS = 4;  // a superblock
    static constexpr int SC_SLOT_BYTES = qpipe::BW * 32;
    static constexpr int SC_SLOTS = (qpipe::AHEAD - 1 + SC_STEPS - 1) / SC_STEPS + 1;
    static constexpr int QH_RING = SC_SLOTS * SC_SLOT_BYTES;  // the qh ring follows the scales'
    static constexpr int EXTRA_BYTES = 2 * SC_SLOTS * SC_SLOT_BYTES;

    const uint8_t* qs;  // (N, K / 2)
    const uint8_t* qh;  // (N, K / 8)
    const bf16* dsub;   // (N, K / 32)
    const bf16* msub;

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        qs += (size_t)plane * N * (K / 2);
        qh += (size_t)plane * N * (K / 8);
        dsub += (size_t)plane * N * (K / 32);
        msub += (size_t)plane * N * (K / 32);
    }

    // 16-byte chunk c (0, 1) of the 32-byte row r
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
    }

    // A thread copies nibble chunk tid % 2 of row tid / 2 every step, and every
    // fourth step the row's dsub (tid % 2 == 0) or msub of four steps and
    // chunk tid % 2 of its qh bytes of the superblock.
    struct Stager {
        const uint8_t* nib;
        const uint8_t* qh;
        const bf16* sc;
        uint32_t nib_dst, sc_dst;
        bool ok;
        __device__ __forceinline__ void start(uint32_t tile, int k0) const {
            wg::cp_async16(tile + nib_dst, nib + k0 / 2, ok);
            const int step = k0 / qpipe::BK;
            if (step % SC_STEPS == 0) {
                const uint32_t slot = step / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES;
                wg::cp_async16(sc_dst + slot, sc + k0 / 32, ok);
                wg::cp_async16(sc_dst + QH_RING + slot, qh + k0 / 8, ok);
            }
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t extra) const {
        Stager s;
        const int r = tid / 2, c = tid % 2;
        s.ok = n0 + r < N;
        const size_t row = s.ok ? n0 + r : 0;
        s.nib = qs + row * (K / 2) + c * 16;
        s.qh = qh + row * (K / 8) + c * 16;
        s.sc = (c ? msub : dsub) + row * (K / 32);
        s.nib_dst = chunk(r, c);
        s.sc_dst = extra + chunk(r, c);
        return s;
    }

    // the value under a float's bits (2^23 + v), minus 2^23, exactly
    static __device__ __forceinline__ float val_f32(uint32_t u) {
        return __fsub_rn(__uint_as_float(u), 8388608.0f);
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair
    // k = 2 qd, 2 qd + 1: bytes 2 (qd & 1), +1 of the group's word qd / 2, and
    // the same bytes of the superblock's qh row.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t* tile,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        const uint8_t* scl = extra + it / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES + it % SC_STEPS * 4;
        const uint8_t* qhl = extra + QH_RING + it / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES;
        const int sl = 2 * (it % SC_STEPS);  // the qh bit of the step's low nibbles; +1 high
        // PRMT selectors: byte b of the word, two zero bytes, 0x4B
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel0 = 0x7440u | b, sel1 = 0x7440u | (b + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = c_lo + 8 * h;
            const uint32_t dp = *reinterpret_cast<const uint32_t*>(scl + chunk(r, 0));
            const uint32_t mp = *reinterpret_cast<const uint32_t*>(scl + chunk(r, 1));
            const float dl = __uint_as_float(dp << 16);
            const float dh = __fmul_rn(__uint_as_float(dp & 0xFFFF0000u), 0.0625f);
            const float ml = __uint_as_float(mp << 16);
            const float mh = __uint_as_float(mp & 0xFFFF0000u);
#pragma unroll
            for (int m = 0; m < 4; ++m) {  // 8-byte group m: k16 step m / 2, its half m % 2
                const int off = chunk(r, m >> 1) + (m & 1) * 8 + (qd >> 1) * 4;
                const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + off);
                const uint32_t hw = *reinterpret_cast<const uint32_t*>(qhl + off) >> (8 * b + sl);
                const uint32_t u0 = __byte_perm(w, 0x4B000000u, sel0);
                const uint32_t u1 = __byte_perm(w, 0x4B000000u, sel1);
                // fifth bits: byte b's at bits 0 (low) and 1 (high), byte b + 1's at 8, 9
                const uint32_t lo0 = (u0 & 0x4B00000Fu) | ((hw & 1u) << 4);
                const uint32_t lo1 = (u1 & 0x4B00000Fu) | (((hw >> 8) & 1u) << 4);
                const uint32_t hi0 = (u0 & 0x4B0000F0u) | (((hw >> 1) & 1u) << 8);
                const uint32_t hi1 = (u1 & 0x4B0000F0u) | (((hw >> 9) & 1u) << 8);
                a[m >> 1][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(val_f32(lo0), dl, ml), __fmaf_rn(val_f32(lo1), dl, ml));
                a[2 + (m >> 1)][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(val_f32(hi0), dh, mh), __fmaf_rn(val_f32(hi1), dh, mh));
            }
        }
    }
};

}  // namespace

// x (M, K) bf16; qs (N, K/2) u8; qh (N, K/8) u8; dsub, msub (N, K/32) bf16;
// out (M, N) f32, or bf16 when out_bf16 != 0. K % 256 == 0 (Q5_K
// superblocks); the wrapper checks shapes and alignment.
extern "C" int qmm_q5k_bf16(const void* x, const void* qs, const void* qh, const void* dsub,
                            const void* msub, void* out, int out_bf16, int M, int N, int K,
                            void* stream) {
    const Q5KSource w{(const uint8_t*)qs, (const uint8_t*)qh, (const bf16*)dsub,
                      (const bf16*)msub};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/2), qh (n_planes, N, K/8), dsub, msub (n_planes, N, K/32).
extern "C" int qmm_q5k_grouped_bf16(const void* x, const void* qs, const void* qh,
                                    const void* dsub, const void* msub, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    const Q5KSource w{(const uint8_t*)qs, (const uint8_t*)qh, (const bf16*)dsub,
                      (const bf16*)msub};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
