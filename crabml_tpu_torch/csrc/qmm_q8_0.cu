// qmm_q8_0: fused Q8_0 dequant + matmul for prefill rows (out = x @ W^T).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q8_0
// scheme: w = bf16(qs * dsub) per 32-element scale group, f32 accumulation.
// The dense entry qmm_q8_0_bf16 stands for the launcher _run (pallas_call at
// :680), the grouped entry qmm_q8_0_grouped_bf16 for _run_grouped (:836),
// where rows sorted by expert multiply their own expert's plane (as
// qmm_q4k.cu's: the same tile loop, select_plane offsets every plane).
//
// Bound on the H100: operations at the main path's 512-row prefill chunks
// (2 x 512 x 6144 x 4096 against 26 MB of planes for the fused q|k|v; the
// card's ridge is ~295 bf16 operations per byte). The tile loop is
// qmm_pipe.cuh's (wgmma with the weights as the register A operand, the x
// tile as B in swizzled shared memory, a six-stage cp.async ring, two wgmma
// groups in flight); this file is its Q8_0 weight source: how a tile of the
// planes is staged and how a thread turns it into its A fragments. The int8
// tile is staged as qmm_w8.cu stages its W8 planes (one byte a weight, the
// same swizzle), but the scale applies to the weights, not to partial sums:
// one bf16 dsub per 32 weights, so a 64-deep k step has two per row.
//
// Staging, per step and block: 128 rows x 64 bytes of int8, two 16-byte
// cp.async a thread, 8,192 bytes beside the 16,384 of the x tile. The scales
// of four steps (8 bf16, 16 bytes a row) are copied every fourth step by the
// first 128 threads into a ring of their own beside the x / weight ring
// (`EXTRA_BYTES`, SC_SLOTS slots of 2,048 bytes), whose slots live as long as
// the steps that read them, as qmm_q4k.cu does with its scales.
//
// Conversion, exactly the plain version's numbers: an int8 becomes a bf16
// exactly (qmm_w8.cu's convert_pair: PRMT under 0x43, then one HSUB2), and
// one HMUL2 multiplies the pair by the bf16 scale pair: an int8 times a bf16
// has at most 15 significant bits, so the product is exact before the one
// rounding to bf16, which is the plain version's float32 product rounded
// once to bf16.
#include "qmm_pipe.cuh"

namespace {

struct Q80Source {
    static constexpr int KSC = 0;  // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = qpipe::BW * qpipe::BK;  // int8, 64 bytes a row
    // the scale ring: a slot holds SC_STEPS steps' dsub of the 128 rows (16
    // bytes a row), filled by the fetch of its first step f after the barrier
    // of step f - AHEAD; the last step it held before, f - SC_STEPS *
    // (SC_SLOTS - 1) - 1, was converted before that barrier. So SC_STEPS *
    // (SC_SLOTS - 1) + 1 >= AHEAD.
    static constexpr int SC_STEPS = 4;
    static constexpr int SC_SLOT_BYTES = qpipe::BW * 16;
    static constexpr int SC_SLOTS = (qpipe::AHEAD - 1 + SC_STEPS - 1) / SC_STEPS + 1;
    static constexpr int EXTRA_BYTES = SC_SLOTS * SC_SLOT_BYTES;

    const int8_t* qs;  // (N, K)
    const bf16* dsub;  // (N, K / 32)

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        qs += (size_t)plane * N * K;
        dsub += (size_t)plane * N * (K / 32);
    }

    // 16-byte chunk c (0..3) of tile row r: rows 2 apart in other banks
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * qpipe::BK + ((c ^ ((r >> 1) & 3)) << 4));
    }

    // A thread copies chunk tid % 4 of tile rows tid / 4 and tid / 4 + 64 every
    // step; the first 128 threads copy row tid's dsub of four steps every fourth.
    struct Stager {
        const int8_t* src[2];
        const bf16* sc;
        uint32_t dst, sc_dst;
        bool ok[2], sc_ok, sc_copy;
        __device__ __forceinline__ void start(uint32_t tile, int k0) const {
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wg::cp_async16(tile + dst + i * 64 * qpipe::BK, src[i] + k0, ok[i]);
            const int step = k0 / qpipe::BK;
            if (sc_copy && step % SC_STEPS == 0) {
                const uint32_t slot = step / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES;
                wg::cp_async16(sc_dst + slot, sc + k0 / 32, sc_ok);
            }
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t extra) const {
        Stager s;
        const int r = tid / 4, c = tid % 4;
        s.dst = chunk(r, c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            s.ok[i] = n0 + r + 64 * i < N;
            s.src[i] = qs + (size_t)(s.ok[i] ? n0 + r + 64 * i : 0) * K + c * 16;
        }
        s.sc_copy = tid < qpipe::BW;
        s.sc_ok = s.sc_copy && n0 + tid < N;
        s.sc = dsub + (size_t)(s.sc_ok ? n0 + tid : 0) * (K / 32);
        s.sc_dst = extra + (uint32_t)tid * 16;
        return s;
    }

    // bytes b0, b1 of w picked by `sel` (two int8) -> one exact bf16 pair:
    // 0x43xx with xx = b & 0x7f is 128 + (b & 0x7f); minus 128, or minus 256
    // where b is negative, is b
    static __device__ __forceinline__ __nv_bfloat162 convert_pair(uint32_t w, uint32_t sel) {
        const uint32_t full = __byte_perm(w, 0x43434343u, sel);  // [b0, 0x43, b1, 0x43]
        uint32_t p = full & 0xFF7FFF7Fu;
        uint32_t c = (full & 0x00800080u) | 0x43004300u;
        return __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p),
                       *reinterpret_cast<__nv_bfloat162*>(&c));
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair k = 2 qd,
    // 2 qd + 1, half of the group's 32-bit word qd / 2. k16 steps 0, 1 take the
    // step's first scale group, 2, 3 its second.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t* tile,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        const uint8_t* scl = extra + it / SC_STEPS % SC_SLOTS * SC_SLOT_BYTES + it % SC_STEPS * 4;
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel = 0x4040u | b | ((b + 1) << 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = c_lo + 8 * h;
            const uint32_t dp = *reinterpret_cast<const uint32_t*>(scl + r * 16);
            const uint32_t dlo = __byte_perm(dp, 0, 0x1010), dhi = __byte_perm(dp, 0, 0x3232);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t* w =
                    reinterpret_cast<const uint32_t*>(tile + chunk(r, kk)) + (qd >> 1);
                const uint32_t dd = kk < 2 ? dlo : dhi;
                const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dd);
                const __nv_bfloat162 lo = __hmul2(convert_pair(w[0], sel), d2);  // k = 0..7
                const __nv_bfloat162 hi = __hmul2(convert_pair(w[2], sel), d2);  // k = 8..15
                a[kk][h] = *reinterpret_cast<const uint32_t*>(&lo);
                a[kk][2 + h] = *reinterpret_cast<const uint32_t*>(&hi);
            }
        }
    }
};

}  // namespace

// x (M, K) bf16; qs (N, K) i8; dsub (N, K/32) bf16; out (M, N) f32, or bf16
// when out_bf16 != 0. K % 256 == 0; the wrapper checks shapes and alignment.
extern "C" int qmm_q8_0_bf16(const void* x, const void* qs, const void* dsub, void* out,
                             int out_bf16, int M, int N, int K, void* stream) {
    const Q80Source w{(const int8_t*)qs, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K) i8, dsub (n_planes, N, K/32) bf16.
extern "C" int qmm_q8_0_grouped_bf16(const void* x, const void* qs, const void* dsub, void* out,
                                     int out_bf16, const void* offsets, int n_planes, int M,
                                     int N, int K, void* stream) {
    const Q80Source w{(const int8_t*)qs, (const bf16*)dsub};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
