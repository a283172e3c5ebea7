// qmm_w8: matmul on the W8 prefill planes (out = x @ W^T), dense and grouped.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_w8_kernel (:540). The
// dense entry qmm_w8_bf16 stands for the launcher _run_w8 (pallas_call at
// :600), the grouped entry qmm_w8_grouped_bf16 for _run_grouped_w8 (:870),
// where rows sorted by expert multiply their own expert's planes: one kernel,
// which differs between the two only in where a row tile starts and which
// plane it reads (qmm_tile.cuh::find_tile).
//
// The planes hold the exact dequantized weights requantized to int8 with one
// float32 scale per (output column, 512-deep k chunk). Per chunk the kernel
// multiplies bf16 x by the int8 weights converted to bf16 (exact) with f32
// accumulation, then multiplies the chunk's partial sum by the column's scale
// in f32 and adds it to the f32 total. The scale belongs to the partial sum,
// not to the weights, so each warp keeps two sets of accumulators: the
// chunk's, cleared every 512 elements of k, and the running total.
//
// Bound on the H100: operations at the main path's 512-row prefill chunks
// (2 x 512 x 6144 x 4096 against 25 MB of int8 for the fused q|k|v), bytes
// for the grouped MoE form, where 1,024 (row, slot) pairs read all eight
// experts' int8 planes. Against qmm_q4k the weight tile costs one convert per
// element instead of an unpack, a multiply and an add, for twice the bytes;
// the tile loop, its shared-memory staging and its bf16 WMMA are the same
// (qmm_tile.cuh), and so are the next steps for speed (cp.async or TMA
// pipeline, wgmma). The per-chunk scale rides in an accumulator fragment that
// is loaded from a 16x16 shared tile whose rows all hold the 16 columns'
// scales: fragments of one type share their element layout, so the update is
// elementwise in registers.
#include "qmm_tile.cuh"

using namespace qmm;

namespace {

constexpr int KSC = 512;  // k elements per scale chunk (gemm_quant.py W8_KSC)

template <typename OutT>
__global__ void __launch_bounds__(NT)
qmm_w8_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w8,
              const float* __restrict__ dw, OutT* __restrict__ out,
              const int* __restrict__ offsets, int n_planes, int M, int N, int K) {
    __shared__ __align__(128) bf16 As[BM][LDS];
    __shared__ __align__(128) bf16 Bs[BN][LDS];
    __shared__ __align__(128) float Cs[NT / 32][16 * 16];

    Tile tile;
    if (!find_tile(offsets, n_planes, M, blockIdx.y, tile)) return;

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / 4, wn = warp % 4;
    const int n0 = blockIdx.x * BN;
    const int S8 = K / KSC;  // scale chunks per weight row
    w8 += (size_t)tile.plane * N * K;
    dw += (size_t)tile.plane * N * S8;

    Acc total[2][2], acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(total[i][j], 0.0f);

    // weight-tile role of this thread: column n, half h of the 64 int8 of a step
    const int bn = tid / 2, bh = tid % 2;
    const int col = n0 + bn;

    for (int c = 0; c < S8; ++c) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

        for (int k0 = c * KSC; k0 < (c + 1) * KSC; k0 += BK) {
            load_x_tile(As, x, tile, K, k0, tid);
            // weight tile: 32 int8 -> 32 bf16 (every int8 is exact in bf16)
            {
                __align__(16) bf16 vals[32];
                if (col < N) {
                    const uint4* src = reinterpret_cast<const uint4*>(
                        w8 + (size_t)col * K + k0 + bh * 32);
                    const uint4 w0 = src[0], w1 = src[1];
                    const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                    for (int wi = 0; wi < 8; ++wi)
#pragma unroll
                        for (int bi = 0; bi < 4; ++bi)
                            vals[wi * 4 + bi] = __float2bfloat16_rn(
                                (float)(int8_t)((words[wi] >> (8 * bi)) & 0xffu));
                } else {
#pragma unroll
                    for (int e = 0; e < 32; ++e) vals[e] = __float2bfloat16_rn(0.0f);
                }
                uint4* dst = reinterpret_cast<uint4*>(&Bs[bn][bh * 32]);
#pragma unroll
                for (int v = 0; v < 4; ++v) dst[v] = reinterpret_cast<uint4*>(vals)[v];
            }
            __syncthreads();
            mma_step(acc, As, Bs, wm, wn);
            __syncthreads();
        }

        // total += acc * dw[column, c]: mul then add, each rounded, in f32
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            float* Cw = Cs[warp];
            for (int e = lane; e < 256; e += 32) {
                const int cc = n0 + wn * 32 + j * 16 + e % 16;
                Cw[e] = cc < N ? dw[(size_t)cc * S8 + c] : 0.0f;
            }
            __syncwarp();
            Acc scale;
            wmma::load_matrix_sync(scale, Cw, 16, wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int t = 0; t < scale.num_elements; ++t)
                    total[i][j].x[t] = __fadd_rn(total[i][j].x[t],
                                                 __fmul_rn(acc[i][j].x[t], scale.x[t]));
        }
    }
    store_tile<OutT>(total, Cs[warp], out, tile, n0, N, wm, wn, lane);
}

int launch(const void* x, const void* w8, const void* dw, void* out, int out_bf16,
           const int* offsets, int n_planes, int tiles, int M, int N, int K, void* stream) {
    dim3 grid((N + BN - 1) / BN, tiles);
    cudaStream_t s = (cudaStream_t)stream;
    if (out_bf16)
        qmm_w8_kernel<bf16><<<grid, NT, 0, s>>>((const bf16*)x, (const int8_t*)w8,
                                                 (const float*)dw, (bf16*)out, offsets,
                                                 n_planes, M, N, K);
    else
        qmm_w8_kernel<float><<<grid, NT, 0, s>>>((const bf16*)x, (const int8_t*)w8,
                                                  (const float*)dw, (float*)out, offsets,
                                                  n_planes, M, N, K);
    return crabml_launch_status();
}

}  // namespace

// x (M, K) bf16; w8 (N, K) i8; dw (N, K/512) f32; out (M, N) f32, or bf16 when
// out_bf16 != 0. K % 512 == 0: the wrapper zero-pads x where the planes were
// padded, and checks shapes and alignment.
extern "C" int qmm_w8_bf16(const void* x, const void* w8, const void* dw, void* out,
                           int out_bf16, int M, int N, int K, void* stream) {
    return launch(x, w8, dw, out, out_bf16, nullptr, 1, (M + BM - 1) / BM, M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// w8 (n_planes, N, K), dw (n_planes, N, K/512). Every row of out is written.
extern "C" int qmm_w8_grouped_bf16(const void* x, const void* w8, const void* dw, void* out,
                                   int out_bf16, const void* offsets, int n_planes, int M,
                                   int N, int K, void* stream) {
    return launch(x, w8, dw, out, out_bf16, (const int*)offsets, n_planes,
                  grouped_tiles(M, n_planes), M, N, K, stream);
}
