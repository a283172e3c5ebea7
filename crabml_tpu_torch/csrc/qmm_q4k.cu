// qmm_q4k: fused Q4_K dequant + matmul for prefill rows (out = x @ W^T), dense
// and grouped.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q4_K
// scheme: w = bf16(val * dsub + msub) per 32-element scale group, f32
// accumulation. The dense entry qmm_q4k_bf16 stands for the launcher _run
// (pallas_call at :680), the grouped entry qmm_q4k_grouped_bf16 for
// _run_grouped (:836), where rows sorted by expert multiply their own expert's
// plane: one kernel, which differs between the two only in where a row tile
// starts and which plane it reads (qmm_pipe.cuh::find_tile).
//
// Bound on the H100: operations at the main path's prefill chunks (2 x 512 x
// 6144 x 4096 against 16 MB of planes for the fused q|k|v; the card's ridge is
// ~295 bf16 operations per byte), and for the grouped MoE form too. The tile
// loop is qmm_pipe.cuh's (wgmma with the weights as the register A operand,
// the x tile as B in swizzled shared memory, a six-stage cp.async ring, two
// wgmma groups in flight; see there); this file is its Q4_K weight source:
// how a tile of the planes is staged and how a thread turns it into its A
// fragments. The staged planes are half the bytes of the W8 planes' int8, and
// the conversion happens in registers, so a 4-bit weight never exists as bf16
// in shared or global memory. Measured, no one piece bounds a step: without
// the tensor cores, the conversion or the x copies it takes a seventh to a
// quarter less (tools/qmm_ablation.py); they follow one another through the
// block's barrier more than they overlap.
//
// The planes keep ggml's per-row Q4_K nibble order: in each 64-element chunk
// of k, byte j holds element j in its low nibble and element j + 32 in its
// high nibble, and the superblock scales are folded on the host into bf16
// dsub = d*sc and msub = -dmin*mn, one per 32 elements. A 64-deep k step is
// therefore one 32-byte chunk of each weight row and two scale groups: the
// low nibbles are k16 steps 0 and 1 with group 2c, the high nibbles k16 steps
// 2 and 3 with group 2c + 1. A thread owns weight rows c and c + 8 and, in
// each 8-wide group of k, the pair k = 2 q, 2 q + 1 (q = lane % 4): per row it
// reads bytes 2 q, 2 q + 1 of each 8-byte group, four 32-bit words of which it
// uses half, and each byte gives one weight to a low-nibble fragment and one
// to a high-nibble fragment.
//
// Staging, per step and block: 128 rows x 32 bytes of nibbles, one 16-byte
// cp.async a thread, 4,096 bytes beside the 16,384 of the x tile. A step's
// scales are 4 bytes of dsub and 4 of msub a row, strided by the row's length
// in global memory. Copied a step at a time (one 4-byte cp.async a thread),
// every warp's copy touches 32 cache lines for 128 bytes, and the loop takes
// a quarter longer (tools/qmm_ablation.py, `scales_every_step`). So every
// fourth step a thread copies 16 bytes, a row's dsub or msub of four steps,
// into a ring of its own beside the x / nibble ring (`EXTRA_BYTES`, SC_SLOTS
// slots of 4,096 bytes), whose slots live as long as the steps that read
// them. Rows of 32 bytes (the nibbles of a step, or a row's [dsub x 8 | msub
// x 8]) have their two 16-byte chunks swapped in rows 4..7 of every 8: the
// eight rows a warp reads at once then fall into different banks
// (unswizzled, rows r and r + 4 share them).
//
// Conversion, exactly the plain version's numbers: a nibble times a bf16 dsub
// (8 significant bits) has at most 12 significant bits, so the float32 product
// is exact and one FFMA, nib * d + m, rounds where the plain version's
// multiply-then-add does; cvt.rn.bf16x2.f32 then rounds two such weights to
// the bf16 pair of a fragment register. The nibble becomes a float without a
// conversion instruction: PRMT puts the byte under the exponent byte 0x4B
// (2^23), a mask keeps the low nibble (2^23 + lo) or the high one (2^23 + 16
// hi), and subtracting 2^23 is exact. The high nibble stays times 16 and
// multiplies d / 16, which is exact too (bf16 shares float32's exponent range
// and has 16 fewer significant bits). That is two PRMT, four LOP3, four FADD,
// four FFMA and two F2FP for a word's two bytes.
#include "qmm_pipe.cuh"

namespace {

struct Q4KSource {
    static constexpr int KSC = 0;  // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = qpipe::BW * qpipe::BK / 2;  // 32 bytes of nibbles a row
    // the scale ring: a slot holds SC_STEPS steps' dsub and msub of the 128
    // rows. The fetch of its first step f fills it, after the barrier of step
    // f - AHEAD; the last step it held before, f - SC_STEPS * (SC_SLOTS - 1) - 1,
    // was converted before the barrier of that same step. So SC_STEPS *
    // (SC_SLOTS - 1) + 1 >= AHEAD.
    static constexpr int SC_STEPS = 4;
    static constexpr int SC_SLOT_BYTES = qpipe::BW * 32;
    static constexpr int SC_SLOTS = (qpipe::AHEAD - 1 + SC_STEPS - 1) / SC_STEPS + 1;
    static constexpr int EXTRA_BYTES = SC_SLOTS * SC_SLOT_BYTES;

    const uint8_t* qs;  // (planes, N, K / 2)
    const bf16* dsub;   // (planes, N, K / 32)
    const bf16* msub;

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        qs += (size_t)plane * N * (K / 2);
        dsub += (size_t)plane * N * (K / 32);
        msub += (size_t)plane * N * (K / 32);
    }

    // 16-byte chunk c (0, 1) of the 32-byte row r
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
    }

    // A thread copies nibble chunk tid % 2 of row tid / 2 every step, and the
    // row's dsub (tid % 2 == 0) or msub of four steps every fourth.
    struct Stager {
        const uint8_t* nib;
        const bf16* sc;
        uint32_t nib_dst, sc_dst;
        bool ok;
        __device__ __forceinline__ void start(uint32_t tile, int k0) const {
            wg::cp_async16(tile + nib_dst, nib + k0 / 2, ok);
            const int step = k0 / qpipe::BK;
            if (step % SC_STEPS == 0) {
                const uint32_t slot = step / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES;
                wg::cp_async16(sc_dst + slot, sc + k0 / 32, ok);
            }
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t extra) const {
        Stager s;
        const int r = tid / 2, c = tid % 2;
        s.ok = n0 + r < N;
        const size_t row = s.ok ? n0 + r : 0;
        s.nib = qs + row * (K / 2) + c * 16;
        s.sc = (c ? msub : dsub) + row * (K / 32);
        s.nib_dst = chunk(r, c);
        s.sc_dst = extra + chunk(r, c);
        return s;
    }

    // 2^23 + the nibble (or + 16 x the nibble) under a float's bits, as PRMT
    // and LOP3 leave it; minus 2^23, exactly
    static __device__ __forceinline__ float nib_f32(uint32_t u, uint32_t mask) {
        return __fsub_rn(__uint_as_float(u & mask), 8388608.0f);
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair
    // k = 2 qd, 2 qd + 1: bytes 2 (qd & 1), +1 of the group's word qd / 2.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t* tile,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        // this step's [lo, hi] groups in the rows of its scale slot
        const uint8_t* scl = extra + it / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES + it % SC_STEPS * 4;
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
                const uint32_t w = *reinterpret_cast<const uint32_t*>(
                    tile + chunk(r, m >> 1) + (m & 1) * 8 + (qd >> 1) * 4);
                const uint32_t u0 = __byte_perm(w, 0x4B000000u, sel0);
                const uint32_t u1 = __byte_perm(w, 0x4B000000u, sel1);
                a[m >> 1][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(nib_f32(u0, 0x4B00000Fu), dl, ml),
                                  __fmaf_rn(nib_f32(u1, 0x4B00000Fu), dl, ml));
                a[2 + (m >> 1)][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(nib_f32(u0, 0x4B0000F0u), dh, mh),
                                  __fmaf_rn(nib_f32(u1, 0x4B0000F0u), dh, mh));
            }
        }
    }
};

}  // namespace

// x (M, K) bf16; qs (N, K/2) u8; dsub, msub (N, K/32) bf16; out (M, N) f32,
// or bf16 when out_bf16 != 0. K % 256 == 0 (Q4_K superblocks); the wrapper
// checks shapes and alignment.
extern "C" int qmm_q4k_bf16(const void* x, const void* qs, const void* dsub,
                            const void* msub, void* out, int out_bf16, int M, int N,
                            int K, void* stream) {
    const Q4KSource w{(const uint8_t*)qs, (const bf16*)dsub, (const bf16*)msub};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/2), dsub, msub (n_planes, N, K/32). Every row of out is
// written: each lies in exactly one segment.
extern "C" int qmm_q4k_grouped_bf16(const void* x, const void* qs, const void* dsub,
                                    const void* msub, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    const Q4KSource w{(const uint8_t*)qs, (const bf16*)dsub, (const bf16*)msub};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
