// The row tiles of the quantized prefill matmuls, dense and grouped: the
// numbering that qmm_pipe.cuh's loop, csrc/qmm_f32.cu and qmm_ws.cuh's loop
// share (ops/cuda/gemm_quant.py::qmm_f32_tiles and qmm_ws_tiles mirror it).
//
// Dense (offsets == nullptr): tile t covers rows [rows t, M) of plane 0, cut
// to `rows` by the caller. Grouped: the rows are sorted by plane and offsets
// (n_planes + 1) holds each plane's first row; tiles are numbered through the
// planes' segments in turn, each segment cut into tiles of its own, so a tile
// never straddles two planes, a ragged segment ends in a short tile and an
// empty one has none. Each block finds its segment by walking the offsets on
// the device: nothing is padded and the host never reads a count.
#pragma once

namespace qtile {

struct Tile {
    int m0;     // first row
    int m_end;  // one past the last row this tile may touch
    int plane;  // weight plane of these rows
};

// The t-th tile of `rows` rows, or false when there are fewer tiles (the
// grouped grid is sized for the worst case). The whole block takes the same
// branch.
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets, int n_planes, int M,
                                          int t, Tile& tile, int rows) {
    if (offsets == nullptr) {
        tile.m0 = t * rows;
        tile.m_end = M;
        tile.plane = 0;
        return tile.m0 < M;
    }
    for (int e = 0; e < n_planes; ++e) {
        const int lo = offsets[e], hi = offsets[e + 1];
        const int nt = (hi - lo + rows - 1) / rows;
        if (t < nt) {
            tile.m0 = lo + t * rows;
            tile.m_end = hi;
            tile.plane = e;
            return true;
        }
        t -= nt;
    }
    return false;
}

static inline int dense_tiles(int M, int rows) { return (M + rows - 1) / rows; }
// Tiles a grouped launch must provide for: every segment may end in a short one.
static inline int grouped_tiles(int M, int n_planes, int rows) {
    return dense_tiles(M, rows) + n_planes;
}

}  // namespace qtile
