// qmm_q4k: fused Q4_K dequant + matmul for prefill rows (out = x @ W^T), dense
// and grouped.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q4_K
// scheme: w = val * dsub + msub per 32-element scale group, f32 accumulation.
// The dense entry qmm_q4k_bf16 stands for the launcher _run (pallas_call at
// :680), the grouped entry qmm_q4k_grouped_bf16 for _run_grouped (:836), where
// rows sorted by expert multiply their own expert's plane: one kernel, which
// differs between the two only in where a row tile starts and which plane it
// reads (qmm_tile.cuh::find_tile).
//
// Bound on the H100: at the main path's 512-row prefill chunks the product is
// compute-bound (7.3 TFLOP per chunk at 7B against ~4.4 GB of weights; the
// card's ridge is ~295 bf16 operations per byte). The design therefore feeds
// the tensor cores: a block computes a 64-row x 128-column output tile with
// eight warps of bf16 WMMA (16x16x16, f32 accumulation) and sweeps k in steps
// of 64. Each step stages the x tile and the *dequantized* weight tile in
// shared memory once, so every weight nibble is unpacked once per block and
// read from shared memory by the 2 x 4 warp grid. Weights keep ggml's per-row
// Q4_K nibble order (byte j of a 64-element chunk holds element j in its low
// nibble and j+32 in its high nibble) with the superblock scales folded on the
// host into bf16 dsub = d*sc and msub = -dmin*mn, one per 32 elements. The
// epilogue writes float32 or the bf16 compute dtype, so the model's matmuls
// need no separate cast. No cp.async pipeline, wgmma or TMA yet: those are
// the next step for speed. The grouped form at the MoE prefill shape (1,024
// (row, slot) pairs over 8 experts) is bound by the same operations; each
// expert's planes are read once per 64-row tile of its segment, which L2
// absorbs only in part.
#include "qmm_tile.cuh"

using namespace qmm;

namespace {

template <typename OutT>
__global__ void __launch_bounds__(NT)
qmm_q4k_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ qs,
               const bf16* __restrict__ dsub, const bf16* __restrict__ msub,
               OutT* __restrict__ out, const int* __restrict__ offsets, int n_planes,
               int M, int N, int K) {
    __shared__ __align__(128) bf16 As[BM][LDS];
    __shared__ __align__(128) bf16 Bs[BN][LDS];
    __shared__ __align__(128) float Cs[NT / 32][16 * 16];

    Tile tile;
    if (!find_tile(offsets, n_planes, M, blockIdx.y, tile)) return;

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / 4, wn = warp % 4;
    const int n0 = blockIdx.x * BN;
    const int G = K / 32;  // scale groups per weight row
    qs += (size_t)tile.plane * N * (K / 2);
    dsub += (size_t)tile.plane * N * G;
    msub += (size_t)tile.plane * N * G;

    Acc acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // weight-tile role of this thread: column n, half h of the 32-byte chunk
    const int bn = tid / 2, bh = tid % 2;
    const int col = n0 + bn;

    for (int k0 = 0; k0 < K; k0 += BK) {
        load_x_tile(As, x, tile, K, k0, tid);
        // weight tile: 16 packed bytes -> 16 low-group and 16 high-group values
        {
            __align__(16) bf16 lo[16];
            __align__(16) bf16 hi[16];
            if (col < N) {
                const int c = k0 / 64;
                const uint4 w = *reinterpret_cast<const uint4*>(
                    qs + (size_t)col * (K / 2) + c * 32 + bh * 16);
                const size_t g = (size_t)col * G + 2 * c;
                const float dl = __bfloat162float(dsub[g]), ml = __bfloat162float(msub[g]);
                const float dh = __bfloat162float(dsub[g + 1]), mh = __bfloat162float(msub[g + 1]);
                const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int wi = 0; wi < 4; ++wi)
#pragma unroll
                    for (int bi = 0; bi < 4; ++bi) {
                        const uint32_t b = (words[wi] >> (8 * bi)) & 0xffu;
                        // mul then add, each rounded (no FMA): the plain version's numbers
                        lo[wi * 4 + bi] = __float2bfloat16_rn(__fadd_rn(__fmul_rn((float)(b & 15u), dl), ml));
                        hi[wi * 4 + bi] = __float2bfloat16_rn(__fadd_rn(__fmul_rn((float)(b >> 4), dh), mh));
                    }
            } else {
#pragma unroll
                for (int e = 0; e < 16; ++e) lo[e] = hi[e] = __float2bfloat16_rn(0.0f);
            }
            uint4* dst_lo = reinterpret_cast<uint4*>(&Bs[bn][bh * 16]);
            uint4* dst_hi = reinterpret_cast<uint4*>(&Bs[bn][32 + bh * 16]);
            dst_lo[0] = reinterpret_cast<uint4*>(lo)[0];
            dst_lo[1] = reinterpret_cast<uint4*>(lo)[1];
            dst_hi[0] = reinterpret_cast<uint4*>(hi)[0];
            dst_hi[1] = reinterpret_cast<uint4*>(hi)[1];
        }
        __syncthreads();
        mma_step(acc, As, Bs, wm, wn);
        __syncthreads();
    }
    store_tile<OutT>(acc, Cs[warp], out, tile, n0, N, wm, wn, lane);
}

int launch(const void* x, const void* qs, const void* dsub, const void* msub, void* out,
           int out_bf16, const int* offsets, int n_planes, int tiles, int M, int N, int K,
           void* stream) {
    dim3 grid((N + BN - 1) / BN, tiles);
    cudaStream_t s = (cudaStream_t)stream;
    const bf16 *xb = (const bf16*)x, *db = (const bf16*)dsub, *mb = (const bf16*)msub;
    if (out_bf16)
        qmm_q4k_kernel<bf16><<<grid, NT, 0, s>>>(xb, (const uint8_t*)qs, db, mb, (bf16*)out,
                                                  offsets, n_planes, M, N, K);
    else
        qmm_q4k_kernel<float><<<grid, NT, 0, s>>>(xb, (const uint8_t*)qs, db, mb, (float*)out,
                                                   offsets, n_planes, M, N, K);
    return crabml_launch_status();
}

}  // namespace

// x (M, K) bf16; qs (N, K/2) u8; dsub, msub (N, K/32) bf16; out (M, N) f32,
// or bf16 when out_bf16 != 0. K % 256 == 0 (Q4_K superblocks); the wrapper
// checks shapes and alignment.
extern "C" int qmm_q4k_bf16(const void* x, const void* qs, const void* dsub,
                            const void* msub, void* out, int out_bf16, int M, int N,
                            int K, void* stream) {
    return launch(x, qs, dsub, msub, out, out_bf16, nullptr, 1, (M + BM - 1) / BM, M, N, K,
                  stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/2), dsub, msub (n_planes, N, K/32). Every row of out is
// written: each lies in exactly one segment.
extern "C" int qmm_q4k_grouped_bf16(const void* x, const void* qs, const void* dsub,
                                    const void* msub, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    return launch(x, qs, dsub, msub, out, out_bf16, (const int*)offsets, n_planes,
                  grouped_tiles(M, n_planes), M, N, K, stream);
}
