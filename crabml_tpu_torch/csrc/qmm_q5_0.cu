// qmm_q5_0: fused Q5_0 dequant + matmul for prefill rows (out = x @ W^T).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q5_0
// scheme: w = bf16((val - 16) * dsub) per 32-element block, with val the
// 5-bit value 0..31, f32 accumulation. The dense entry qmm_q5_0_bf16 stands
// for the launcher _run (pallas_call at :680), the grouped entry
// qmm_q5_0_grouped_bf16 for _run_grouped (:836),
// where rows sorted by expert multiply their own expert's plane.
//
// Bound on the H100: operations at 512-row prefill chunks (2 x 512 x 6144 x
// 4096 against 17 MB of planes for the fused q|k|v; the card's ridge is ~295
// bf16 operations per byte). The tile loop is qmm_pipe.cuh's (wgmma with the
// weights as the register A operand, the x tile as B in swizzled shared
// memory, a six-stage cp.async ring, two wgmma groups in flight); this file
// is its Q5_0 weight source: qmm_q4_0.cu's nibbles and scale ring with
// qmm_q5k.cu's fifth bits, and no minimum plane.
//
// The port reorders ggml's per-32 nibbles at load into Q4_K's per-64 order
// and moves the fifth bits, which ggml keeps as one little-endian u32 a
// block, into Q5_K's per-superblock order (quant/qtensor.py::
// to_kernel_layout): bit b of byte l of a superblock's 32 qh bytes is the
// top bit of element 32 b + l. A 64-deep k step is then one 32-byte nibble
// chunk of each weight row, staged and read as qmm_q4k.cu does; step c (0..3)
// of a superblock needs bits 2 c (low nibbles) and 2 c + 1 (high nibbles) of
// all 32 qh bytes, at the same byte index as the nibble byte that holds the
// element, so a superblock's qh bytes are staged once, on its first step,
// two 16-byte copies a row into a ring of their own, as qmm_q5k.cu stages
// them. The one bf16 dsub a block (16 bytes a row for four steps) is copied
// every fourth step by the first 128 threads into the scale ring, as
// qmm_q4_0.cu does. Every weight byte crosses from global memory once.
//
// Conversion, exactly the plain version's numbers, Q4_0's with a fifth bit:
// PRMT puts the thread's two nibble bytes under 0x43 and a mask keeps their
// low (or shifted high) nibbles; a PRMT of the same two qh bytes, shifted by
// the step's bit, ORs the fifth bit into mantissa bit 4 of each half, so each
// half is the bf16 128 + val (exact up to 255). One HSUB2 of 144 leaves
// val - 16 exactly, and one HMUL2 by the bf16 scale pair rounds once: (val -
// 16) times a bf16 has at most 13 significant bits, so the product is exact
// before that rounding, which is the plain version's float32 product rounded
// once to bf16. (Q5_K's conversion, the value under 0x4B000000 and one FFMA
// val * d + (-16 d), is exact too; tools/qmm_ablation.py times both.)
#include "qmm_pipe.cuh"

namespace {

struct Q50Source {
    static constexpr int KSC = 0;  // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = qpipe::BW * qpipe::BK / 2;  // 32 bytes of nibbles a row
    // a scale slot holds SC_STEPS steps' dsub of the 128 rows (16 bytes a
    // row), a qh slot the superblock's qh bytes (32 a row); both are filled
    // by the fetch of the first step f of the superblock, after the barrier of
    // step f - AHEAD, and the last step they held before, f - SC_STEPS *
    // (SC_SLOTS - 1) - 1, was converted before that barrier. So SC_STEPS *
    // (SC_SLOTS - 1) + 1 >= AHEAD.
    static constexpr int SC_STEPS = 4;  // a superblock
    static constexpr int SC_SLOT_BYTES = qpipe::BW * 16;
    static constexpr int QH_SLOT_BYTES = qpipe::BW * 32;
    static constexpr int SC_SLOTS = (qpipe::AHEAD - 1 + SC_STEPS - 1) / SC_STEPS + 1;
    static constexpr int QH_RING = SC_SLOTS * SC_SLOT_BYTES;  // the qh ring follows the scales'
    static constexpr int EXTRA_BYTES = SC_SLOTS * (SC_SLOT_BYTES + QH_SLOT_BYTES);

    const uint8_t* qs;  // (N, K / 2), per-64 nibble order
    const uint8_t* qh;  // (N, K / 8), Q5_K's order
    const bf16* dsub;   // (N, K / 32)

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        qs += (size_t)plane * N * (K / 2);
        qh += (size_t)plane * N * (K / 8);
        dsub += (size_t)plane * N * (K / 32);
    }

    // 16-byte chunk c (0, 1) of the 32-byte row r (qmm_q4k.cu's swizzle)
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
    }

    // A thread copies nibble chunk tid % 2 of row tid / 2 every step, and
    // every fourth step chunk tid % 2 of the row's qh bytes of the
    // superblock; the first 128 threads then also copy row tid's dsub of
    // four steps.
    struct Stager {
        const uint8_t* nib;
        const uint8_t* qh;
        const bf16* sc;
        uint32_t nib_dst, qh_dst, sc_dst;
        bool ok, sc_ok, sc_copy;
        __device__ __forceinline__ void start(uint32_t tile, int k0) const {
            wg::cp_async16(tile + nib_dst, nib + k0 / 2, ok);
            const int step = k0 / qpipe::BK;
            if (step % SC_STEPS == 0) {
                const int slot = step / SC_STEPS % SC_SLOTS;
                wg::cp_async16(qh_dst + slot * QH_SLOT_BYTES, qh + k0 / 8, ok);
                if (sc_copy) wg::cp_async16(sc_dst + slot * SC_SLOT_BYTES, sc + k0 / 32, sc_ok);
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
        s.nib_dst = chunk(r, c);
        s.qh_dst = extra + QH_RING + chunk(r, c);
        s.sc_copy = tid < qpipe::BW;
        s.sc_ok = s.sc_copy && n0 + tid < N;
        s.sc = dsub + (size_t)(s.sc_ok ? n0 + tid : 0) * (K / 32);
        s.sc_dst = extra + (uint32_t)tid * 16;
        return s;
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair
    // k = 2 qd, 2 qd + 1: bytes 2 (qd & 1), +1 of the group's word qd / 2, and
    // the same bytes of the superblock's qh row.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t* tile,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        const uint8_t* scl = extra + it / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES + it % SC_STEPS * 4;
        const uint8_t* qhl = extra + QH_RING + it / SC_STEPS % SC_SLOTS * QH_SLOT_BYTES;
        const int sl = 2 * (it % SC_STEPS);  // the qh bit of the step's low nibbles; +1 high
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel = 0x4040u | b | ((b + 1) << 8);  // [byte b, 0x43, byte b + 1, 0x43]
        const uint32_t bias = 0x43104310u;                  // bf16 144, 144
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = c_lo + 8 * h;
            const uint32_t dp = *reinterpret_cast<const uint32_t*>(scl + r * 16);
            const uint32_t dlo = __byte_perm(dp, 0, 0x1010), dhi = __byte_perm(dp, 0, 0x3232);
            const __nv_bfloat162 dl = *reinterpret_cast<const __nv_bfloat162*>(&dlo);
            const __nv_bfloat162 dh = *reinterpret_cast<const __nv_bfloat162*>(&dhi);
#pragma unroll
            for (int m = 0; m < 4; ++m) {  // 8-byte group m: k16 step m / 2, its half m % 2
                const int off = chunk(r, m >> 1) + (m & 1) * 8 + (qd >> 1) * 4;
                const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + off);
                // fifth bits: byte b's at bits 0 (low) and 1 (high), byte b + 1's at 16, 17
                const uint32_t hp =
                    __byte_perm(*reinterpret_cast<const uint32_t*>(qhl + off), 0, sel) >> sl;
                const uint32_t full = __byte_perm(w, 0x43434343u, sel);
                const uint32_t lo = (full & 0xFF0FFF0Fu) | ((hp & 0x00010001u) << 4);
                const uint32_t hi =
                    ((full >> 4) & 0x000F000Fu) | 0x43004300u | ((hp & 0x00020002u) << 3);
                const __nv_bfloat162 wl =
                    __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), b2), dl);
                const __nv_bfloat162 wh =
                    __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi), b2), dh);
                a[m >> 1][2 * (m & 1) + h] = *reinterpret_cast<const uint32_t*>(&wl);
                a[2 + (m >> 1)][2 * (m & 1) + h] = *reinterpret_cast<const uint32_t*>(&wh);
            }
        }
    }
};

}  // namespace

// x (M, K) bf16; qs (N, K/2) u8 in the per-64 order; qh (N, K/8) u8 in Q5_K's
// order; dsub (N, K/32) bf16; out (M, N) f32, or bf16 when out_bf16 != 0.
// K % 256 == 0; the wrapper checks shapes and alignment.
extern "C" int qmm_q5_0_bf16(const void* x, const void* qs, const void* qh, const void* dsub,
                             void* out, int out_bf16, int M, int N, int K, void* stream) {
    const Q50Source w{(const uint8_t*)qs, (const uint8_t*)qh, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/2), qh (n_planes, N, K/8), dsub (n_planes, N, K/32).
extern "C" int qmm_q5_0_grouped_bf16(const void* x, const void* qs, const void* qh,
                                     const void* dsub, void* out, int out_bf16,
                                     const void* offsets, int n_planes, int M, int N, int K,
                                     void* stream) {
    const Q50Source w{(const uint8_t*)qs, (const uint8_t*)qh, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
