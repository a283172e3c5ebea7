// The WMMA tile loop of the Q4_K tensor-core matmul (qmm_q4k.cu, dense and
// grouped). The W8 matmul runs the wgmma loop of qmm_pipe.cuh instead.
//
// A block computes a 64-row x 128-column output tile with eight warps of
// bf16 WMMA (16x16x16, f32 accumulation), sweeping k in steps of 64 over an x
// tile and a weight tile staged in shared memory. The source fills the
// weight tile (Q4_K dequant); everything else is here, and so is the one
// thing in which a dense and a grouped matmul differ: which rows a block's
// tile covers and which weight plane they multiply.
//
// Dense (offsets == nullptr): tile t covers rows [64 t, M) of plane 0.
// Grouped: the rows are sorted by plane and offsets (n_planes + 1) holds each
// plane's first row; tiles are numbered through the planes' segments in turn,
// each segment cut into 64-row tiles of its own, so a tile never straddles
// two planes, a ragged segment ends in a short tile and an empty one has
// none. The TPU kernel (gemm_quant.py::_run_grouped) gets the same effect by
// padding every segment to a tile multiple on the host and prefetching one
// plane index per tile; here each block finds its segment by walking the
// offsets, so nothing is padded and the host never reads a count.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace qmm {

using namespace nvcuda;

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // k per step
constexpr int LDS = BK + 8;  // padded smem row (bf16): 144 bytes keeps 16-byte and 32-byte alignment
constexpr int NT = 256;      // 8 warps: 2 (rows) x 4 (columns) of 32x32 warp tiles

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

struct Tile {
    int m0;     // first row
    int m_end;  // one past the last row this tile may touch
    int plane;  // weight plane of these rows
};

// The t-th tile, or false when there are fewer tiles (the grouped grid is
// sized for the worst case). The whole block takes the same branch.
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets, int n_planes, int M,
                                          int t, Tile& tile) {
    if (offsets == nullptr) {
        tile.m0 = t * BM;
        tile.m_end = M;
        tile.plane = 0;
        return tile.m0 < M;
    }
    for (int e = 0; e < n_planes; ++e) {
        const int lo = offsets[e], hi = offsets[e + 1];
        const int nt = (hi - lo + BM - 1) / BM;
        if (t < nt) {
            tile.m0 = lo + t * BM;
            tile.m_end = hi;
            tile.plane = e;
            return true;
        }
        t -= nt;
    }
    return false;
}

// Tiles a grouped launch must provide for: every segment may end in a short one.
static inline int grouped_tiles(int M, int n_planes) { return (M + BM - 1) / BM + n_planes; }

// x tile: 64 rows x 64 bf16 = 512 16-byte vectors, two per thread; rows past
// the tile's end are zeros.
__device__ __forceinline__ void load_x_tile(bf16 (*As)[LDS], const bf16* __restrict__ x,
                                            const Tile& tile, int K, int k0, int tid) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        const int idx = tid + it * NT;
        const int r = idx / 8, c8 = idx % 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (tile.m0 + r < tile.m_end)
            v = *reinterpret_cast<const uint4*>(x + (size_t)(tile.m0 + r) * K + k0 + c8 * 8);
        *reinterpret_cast<uint4*>(&As[r][c8 * 8]) = v;
    }
}

// acc += As (64 x 64) @ Bs (128 x 64)^T for this warp's 32x32 part.
__device__ __forceinline__ void mma_step(Acc (&acc)[2][2], bf16 (*As)[LDS], bf16 (*Bs)[LDS],
                                         int wm, int wn) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
}

// Epilogue: stage each 16x16 fragment in this warp's smem (256 floats), write
// the part inside the tile's rows and the N columns.
template <typename OutT>
__device__ __forceinline__ void store_tile(Acc (&acc)[2][2], float* Cw, OutT* __restrict__ out,
                                           const Tile& tile, int n0, int N, int wm, int wn,
                                           int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(Cw, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int r = tile.m0 + wm * 32 + i * 16 + e / 16;
                const int cc = n0 + wn * 32 + j * 16 + e % 16;
                if (r < tile.m_end && cc < N) out[(size_t)r * N + cc] = from_f32<OutT>(Cw[e]);
            }
            __syncwarp();
        }
}

}  // namespace qmm
