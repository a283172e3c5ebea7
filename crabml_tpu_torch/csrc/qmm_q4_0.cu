// qmm_q4_0: fused Q4_0 dequant + matmul for prefill rows (out = x @ W^T).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q4_0
// scheme: w = bf16((val - 8) * dsub) per 32-element block, with val the
// nibble 0..15, f32 accumulation. The dense entry qmm_q4_0_bf16 stands for
// the launcher _run (pallas_call at :680), the grouped entry
// qmm_q4_0_grouped_bf16 for _run_grouped (:836),
// where rows sorted by expert multiply their own expert's plane.
//
// Bound on the H100: operations at the main path's 512-row prefill chunks
// (2 x 512 x 6144 x 4096 against 14 MB of planes for the fused q|k|v; the
// card's ridge is ~295 bf16 operations per byte). The tile loop is
// qmm_pipe.cuh's (wgmma with the weights as the register A operand, the x
// tile as B in swizzled shared memory, a six-stage cp.async ring, two wgmma
// groups in flight); this file is its Q4_0 weight source.
//
// ggml's Q4_0 nibble order runs per 32-element block (byte j holds element j
// low and element j + 16 high). The port reorders the nibbles at load into
// Q4_K's per-64 order (quant/qtensor.py::to_kernel_layout: in each 64-element
// chunk byte j holds element j low and element j + 32 high), so a 64-deep k
// step is one 32-byte chunk of each weight row, staged and read exactly as
// qmm_q4k.cu stages and reads its nibbles: the low nibbles are k16 steps 0
// and 1 with the step's first block scale, the high nibbles k16 steps 2 and
// 3 with its second. The one bf16 dsub a block (16 bytes a row for four
// steps) is copied every fourth step by the first 128 threads into a ring of
// its own, as qmm_q8_0.cu does.
//
// Conversion, exactly the plain version's numbers: PRMT puts the thread's
// two bytes under 0x43 and a mask keeps their low (or shifted high) nibbles,
// the bf16 pair 128 + val; one HSUB2 of 136 leaves val - 8 exactly, and one
// HMUL2 by the bf16 scale pair rounds once: (val - 8) times a bf16 has at
// most 12 significant bits, so the product is exact before that rounding,
// which is the plain version's float32 product rounded once to bf16.
#include "qmm_pipe.cuh"

namespace {

struct Q40Source {
    static constexpr int KSC = 0;  // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = qpipe::BW * qpipe::BK / 2;  // 32 bytes of nibbles a row
    // the scale ring: a slot holds SC_STEPS steps' dsub of the 128 rows (16
    // bytes a row), filled by the fetch of its first step f after the barrier
    // of step f - AHEAD; the last step it held before, f - SC_STEPS *
    // (SC_SLOTS - 1) - 1, was converted before that barrier. So SC_STEPS *
    // (SC_SLOTS - 1) + 1 >= AHEAD.
    static constexpr int SC_STEPS = 4;
    static constexpr int SC_SLOT_BYTES = qpipe::BW * 16;
    static constexpr int SC_SLOTS = (qpipe::AHEAD - 1 + SC_STEPS - 1) / SC_STEPS + 1;
    static constexpr int EXTRA_BYTES = SC_SLOTS * SC_SLOT_BYTES;

    const uint8_t* qs;  // (N, K / 2), per-64 nibble order
    const bf16* dsub;   // (N, K / 32)

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        qs += (size_t)plane * N * (K / 2);
        dsub += (size_t)plane * N * (K / 32);
    }

    // 16-byte chunk c (0, 1) of the 32-byte row r (qmm_q4k.cu's swizzle)
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
    }

    // A thread copies nibble chunk tid % 2 of row tid / 2 every step; the
    // first 128 threads copy row tid's dsub of four steps every fourth.
    struct Stager {
        const uint8_t* nib;
        const bf16* sc;
        uint32_t nib_dst, sc_dst;
        bool ok, sc_ok, sc_copy;
        __device__ __forceinline__ void start(uint32_t tile, int k0) const {
            wg::cp_async16(tile + nib_dst, nib + k0 / 2, ok);
            const int step = k0 / qpipe::BK;
            if (sc_copy && step % SC_STEPS == 0) {
                const uint32_t slot = step / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES;
                wg::cp_async16(sc_dst + slot, sc + k0 / 32, sc_ok);
            }
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t extra) const {
        Stager s;
        const int r = tid / 2, c = tid % 2;
        s.ok = n0 + r < N;
        s.nib = qs + (size_t)(s.ok ? n0 + r : 0) * (K / 2) + c * 16;
        s.nib_dst = chunk(r, c);
        s.sc_copy = tid < qpipe::BW;
        s.sc_ok = s.sc_copy && n0 + tid < N;
        s.sc = dsub + (size_t)(s.sc_ok ? n0 + tid : 0) * (K / 32);
        s.sc_dst = extra + (uint32_t)tid * 16;
        return s;
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair
    // k = 2 qd, 2 qd + 1: bytes 2 (qd & 1), +1 of the group's word qd / 2.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t* tile,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        const uint8_t* scl = extra + it / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES + it % SC_STEPS * 4;
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel = 0x4040u | b | ((b + 1) << 8);  // [byte b, 0x43, byte b + 1, 0x43]
        const uint32_t bias = 0x43084308u;                  // bf16 136, 136
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
                const uint32_t w = *reinterpret_cast<const uint32_t*>(
                    tile + chunk(r, m >> 1) + (m & 1) * 8 + (qd >> 1) * 4);
                const uint32_t full = __byte_perm(w, 0x43434343u, sel);
                const uint32_t lo = full & 0xFF0FFF0Fu;
                const uint32_t hi = ((full >> 4) & 0x000F000Fu) | 0x43004300u;
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

// x (M, K) bf16; qs (N, K/2) u8 in the per-64 order; dsub (N, K/32) bf16; out
// (M, N) f32, or bf16 when out_bf16 != 0. K % 256 == 0; the wrapper checks
// shapes and alignment.
extern "C" int qmm_q4_0_bf16(const void* x, const void* qs, const void* dsub, void* out,
                             int out_bf16, int M, int N, int K, void* stream) {
    const Q40Source w{(const uint8_t*)qs, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/2) in the per-64 order, dsub (n_planes, N, K/32).
extern "C" int qmm_q4_0_grouped_bf16(const void* x, const void* qs, const void* dsub, void* out,
                                     int out_bf16, const void* offsets, int n_planes, int M,
                                     int N, int K, void* stream) {
    const Q40Source w{(const uint8_t*)qs, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
