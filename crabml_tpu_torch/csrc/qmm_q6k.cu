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
// qmm_pipe.cuh's (wgmma with the weights as the register A operand, the x
// tile as B in swizzled shared memory, a six-stage cp.async ring, two wgmma
// groups in flight); this file is its Q6_K weight source.
//
// The planes keep ggml's Q6_K bit order, which runs per 128-element half of
// a superblock, not per 64-deep k step: byte j of the half's 64 ql bytes
// holds element j in its low nibble and element j + 64 in its high nibble,
// and bits 2s, 2s + 1 of byte j of its 32 qh bytes are the top two bits of
// element 32 s + j. A 64-deep step therefore needs all of its half's ql and
// qh bytes (the low nibbles and qh bits 0-3 for the half's first step, the
// high nibbles and bits 4-7 for its second). So a half is staged once, on
// its first step, for both of its steps: per row its 64 ql bytes, 32 qh bytes
// and the 8 bf16 dsub of its 16-element groups, 112 bytes, into a ring of its
// own beside the x ring (`EXTRA_BYTES`, SLOTS slots of 14,336 bytes; the x
// ring's weight tile is empty). Every weight byte then crosses from global
// memory once. The 896 16-byte copies of a half are spread over the 256
// threads (three or four each). A slot is filled by the fetch of its half's
// first step f, after the barrier of step f - AHEAD, when the steps f - 4 ..
// f - 1, two halves, may still be converted: so three slots.
//
// Rows of 112 bytes (28 words) put the eight rows a warp reads at once in
// eight different banks, with no swizzle.
//
// Conversion, exactly the plain version's numbers: the thread's 32-bit words
// of ql and qh give four 6-bit values at once (a shift and a mask each, an
// OR); PRMT puts two of them under 0x43, the bf16 128 + val, and one HSUB2 of
// 160 leaves val - 32 exactly; one HMUL2 by the bf16 scale pair rounds once:
// (val - 32) times a bf16 has at most 14 significant bits, so the product is
// exact before that rounding, which is the plain version's float32 product
// rounded once to bf16.
#include "qmm_pipe.cuh"

namespace {

struct Q6KSource {
    static constexpr int KSC = 0;  // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = 0;  // the weights live in the half ring below
    static constexpr int ROW = 112;       // a row's half: ql 64 | qh 32 | dsub 8 x bf16
    static constexpr int QH = 64, DS = 96;
    static constexpr int SLOT_BYTES = qpipe::BW * ROW;
    // a slot is filled by the fetch of its half's first step f, after the
    // barrier of step f - AHEAD; the last step it held before, f - 2 * (SLOTS
    // - 1) - 1, was converted before that barrier. So 2 (SLOTS - 1) + 1 >= AHEAD.
    static constexpr int SLOTS = (qpipe::AHEAD - 1 + 2 - 1) / 2 + 1;
    static constexpr int EXTRA_BYTES = SLOTS * SLOT_BYTES;
    static constexpr int COPIES = qpipe::BW * ROW / 16;  // 896 16-byte pieces a half
    static constexpr int PER = (COPIES + qpipe::NT - 1) / qpipe::NT;

    const uint8_t* ql;  // (N, K / 2)
    const uint8_t* qh;  // (N, K / 4)
    const bf16* dsub;   // (N, K / 16)

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        ql += (size_t)plane * N * (K / 2);
        qh += (size_t)plane * N * (K / 4);
        dsub += (size_t)plane * N * (K / 16);
    }

    // The thread's pieces: e = tid + 256 i, row e / 7, piece e % 7 of the row
    // (0-3 ql, 4-5 qh, 6 dsub). A half at depth k0 begins k0 / 2 bytes into a
    // row of ql, k0 / 4 into qh, k0 / 8 into dsub: the shift of each piece.
    struct Stager {
        const uint8_t* src[PER];
        uint32_t dst[PER];
        uint8_t shift[PER];
        bool ok[PER], live[PER];
        __device__ __forceinline__ void start(uint32_t, int k0) const {
            const int step = k0 / qpipe::BK;
            if (step % 2) return;  // the half was staged with its first step
            const uint32_t slot = step / 2 % SLOTS * SLOT_BYTES;
#pragma unroll
            for (int i = 0; i < PER; ++i)
                if (live[i]) wg::cp_async16(dst[i] + slot, src[i] + (k0 >> shift[i]), ok[i]);
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t extra) const {
        Stager s;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int e = tid + qpipe::NT * i;
            s.live[i] = e < COPIES;
            const int r = s.live[i] ? e / 7 : 0, p = e % 7;
            s.ok[i] = s.live[i] && n0 + r < N;
            const size_t row = s.ok[i] ? n0 + r : 0;
            if (p < 4) {
                s.src[i] = ql + row * (K / 2) + p * 16;
                s.shift[i] = 1;
            } else if (p < 6) {
                s.src[i] = qh + row * (K / 4) + (p - 4) * 16;
                s.shift[i] = 2;
            } else {
                s.src[i] = reinterpret_cast<const uint8_t*>(dsub + row * (K / 16));
                s.shift[i] = 3;
            }
            s.dst[i] = extra + (uint32_t)(r * ROW + p * 16);
        }
        return s;
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair k = 2 qd,
    // 2 qd + 1: bytes 2 (qd & 1), +1 of the group's ql word and qh word.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t*,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        const uint8_t* half = extra + it / 2 % SLOTS * SLOT_BYTES;
        const int p = it % 2;  // the step's place in its half: low or high nibbles
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel = 0x4040u | b | ((b + 1) << 8);
        const uint32_t bias = 0x43204320u;  // bf16 160, 160
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint8_t* row = half + (c_lo + 8 * h) * ROW;
            // the step's four scales: groups 4 p .. 4 p + 3 of the half
            const uint2 ds = *reinterpret_cast<const uint2*>(row + DS + 8 * p);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t dw = kk < 2 ? ds.x : ds.y;
                const uint32_t dd = __byte_perm(dw, 0, (kk & 1) ? 0x3232 : 0x1010);
                const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dd);
                const int hs = 2 * (2 * p + (kk >> 1));  // qh bits of these 32 elements
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {  // k = 0..7, 8..15 of the k16 step
                    const int off = 8 * hf + 4 * (qd >> 1);
                    const uint32_t lw = *reinterpret_cast<const uint32_t*>(row + 16 * kk + off);
                    const uint32_t hw =
                        *reinterpret_cast<const uint32_t*>(row + QH + 16 * (kk & 1) + off);
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

}  // namespace

// x (M, K) bf16; ql (N, K/2) u8; qh (N, K/4) u8; dsub (N, K/16) bf16; out (M,
// N) f32, or bf16 when out_bf16 != 0. K % 256 == 0; the wrapper checks shapes
// and alignment.
extern "C" int qmm_q6k_bf16(const void* x, const void* ql, const void* qh, const void* dsub,
                            void* out, int out_bf16, int M, int N, int K, void* stream) {
    const Q6KSource w{(const uint8_t*)ql, (const uint8_t*)qh, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// ql (n_planes, N, K/2), qh (n_planes, N, K/4), dsub (n_planes, N, K/16).
extern "C" int qmm_q6k_grouped_bf16(const void* x, const void* ql, const void* qh,
                                    const void* dsub, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    const Q6KSource w{(const uint8_t*)ql, (const uint8_t*)qh, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
