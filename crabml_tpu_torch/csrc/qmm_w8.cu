// qmm_w8: matmul on the W8 prefill planes (out = x @ W^T), dense and grouped.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_w8_kernel (:540). The
// dense entry qmm_w8_bf16 stands for the launcher _run_w8 (pallas_call at
// :600), the grouped entry qmm_w8_grouped_bf16 for _run_grouped_w8 (:870),
// where rows sorted by expert multiply their own expert's planes: one kernel,
// which differs between the two only in where a row tile starts and which
// plane it reads (qmm_pipe.cuh::find_tile).
//
// The planes hold the exact dequantized weights requantized to int8 with one
// float32 scale per (output column, 512-deep k chunk). Per chunk the kernel
// multiplies bf16 x by the int8 weights converted to bf16 (exact) with f32
// accumulation, then multiplies the chunk's partial sum by the column's scale
// in f32 and adds it to the f32 total, rounded once to the output type at the
// end. The scale belongs to the partial sum, not to the weights, so each
// thread keeps two sets of accumulators: the chunk's, which wgmma restarts
// every 512 elements of k, and the running total.
//
// Bound on the H100: operations at the main path's 512-row prefill chunks
// (2 x 512 x 6144 x 4096 against 25 MB of int8 for the fused q|k|v), bytes
// for the grouped MoE form, where 1,024 (row, slot) pairs read all eight
// experts' int8 planes. The design (qmm_pipe.cuh) goes for the tensor cores'
// rate: wgmma m64 x N x k16 on the output tile transposed, with the weights
// as the register A operand and the x tile as B in swizzled shared memory,
// fed by a six-stage cp.async ring that stages the *raw int8* weight tile
// (half the bytes of a bf16 one). Of the two ways to turn int8 into a wgmma
// operand, this one (convert in the consumer threads, straight into the
// A-fragment registers) was taken over dedicated converter warps writing a
// second bf16 buffer, because the converted weights then cost no
// shared-memory traffic and no extra synchronization, and the column scale
// becomes a row scale: two registers a thread instead of a broadcast tile.
//
// This file is the weight source of that loop: how an int8 tile is staged and
// how a thread builds its A fragments from it. A thread owns weight rows c and
// c + 8 and, in each 8-wide group of k, the pair k = 2 q, 2 q + 1 (q = lane %
// 4). It reads the 32-bit word that holds its pair (two lanes of a quad share
// a word: a broadcast) and converts the pair with four integer and bf16
// instructions, exactly: see convert_pair. The staged tile's 16-byte chunks
// are XOR-swizzled by row so that the eight rows a warp reads at once fall
// into different banks.
#include "qmm_pipe.cuh"

namespace {

struct W8Source {
    static constexpr int TILE_BYTES = qpipe::BW * qpipe::BK;  // int8
    static constexpr int EXTRA_BYTES = 0;
    static constexpr int KSC = 512;  // k elements per scale chunk (gemm_quant.py W8_KSC)

    const int8_t* w8;  // (planes, N, K)
    const float* dw;   // (planes, N, K / KSC)
    int S8;            // scale chunks per weight row

    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        S8 = K / KSC;
        w8 += (size_t)plane * N * K;
        dw += (size_t)plane * N * S8;
    }

    // 16-byte chunk c (0..3) of tile row r
    static __device__ __forceinline__ uint32_t chunk(int r, int c) {
        return (uint32_t)(r * qpipe::BK + ((c ^ ((r >> 1) & 3)) << 4));
    }

    // A thread copies chunk tid % 4 of tile rows tid / 4 and tid / 4 + 64.
    struct Stager {
        const int8_t* src[2];
        uint32_t dst;
        bool ok[2];
        __device__ __forceinline__ void start(uint32_t tile, int k0) const {
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wg::cp_async16(tile + dst + i * 64 * qpipe::BK, src[i] + k0, ok[i]);
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t) const {
        Stager s;
        const int r = tid / 4, c = tid % 4;
        s.dst = chunk(r, c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            s.ok[i] = n0 + r + 64 * i < N;
            s.src[i] = w8 + (size_t)(s.ok[i] ? n0 + r + 64 * i : 0) * K + c * 16;
        }
        return s;
    }

    // bytes b0, b1 of w picked by `sel` (two int8) -> one bf16 pair, exactly:
    // 0x43xx with xx = b & 0x7f is 128 + (b & 0x7f); minus 128, or minus 256
    // where b is negative, is b, and bf16 holds every integer up to 256.
    static __device__ __forceinline__ uint32_t convert_pair(uint32_t w, uint32_t sel) {
        const uint32_t full = __byte_perm(w, 0x43434343u, sel);  // [b0, 0x43, b1, 0x43]
        uint32_t p = full & 0xFF7FFF7Fu;
        uint32_t c = (full & 0x00800080u) | 0x43004300u;
        const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p),
                                         *reinterpret_cast<__nv_bfloat162*>(&c));
        return *reinterpret_cast<const uint32_t*>(&r);
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair k = 2 qd,
    // 2 qd + 1, which is half of the group's 32-bit word qd / 2.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t* tile,
                                              const uint8_t*, int, int c_lo, int qd) const {
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel = 0x4040u | b | ((b + 1) << 8);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t* w = reinterpret_cast<const uint32_t*>(
                    tile + chunk(c_lo + 8 * h, kk)) + (qd >> 1);
                a[kk][h] = convert_pair(w[0], sel);      // k = 0..7 of the step
                a[kk][2 + h] = convert_pair(w[2], sel);  // k = 8..15
            }
    }

    __device__ __forceinline__ void scales(float (&sc)[2], int row, int N, int chunk_i) const {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            sc[h] = row + 8 * h < N ? dw[(size_t)(row + 8 * h) * S8 + chunk_i] : 0.f;
    }
};

}  // namespace

// x (M, K) bf16; w8 (N, K) i8; dw (N, K/512) f32; out (M, N) f32, or bf16 when
// out_bf16 != 0. K % 512 == 0: the wrapper zero-pads x where the planes were
// padded, and checks shapes and alignment.
extern "C" int qmm_w8_bf16(const void* x, const void* w8, const void* dw, void* out,
                           int out_bf16, int M, int N, int K, void* stream) {
    const W8Source w{(const int8_t*)w8, (const float*)dw, 0};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// w8 (n_planes, N, K), dw (n_planes, N, K/512). Every row of out is written.
extern "C" int qmm_w8_grouped_bf16(const void* x, const void* w8, const void* dw, void* out,
                                   int out_bf16, const void* offsets, int n_planes, int M,
                                   int N, int K, void* stream) {
    const W8Source w{(const int8_t*)w8, (const float*)dw, 0};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
