// qmm_q2k: fused Q2_K dequant + matmul for prefill rows (out = x @ W^T).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_kernel for the Q2_K
// scheme: w = bf16(val * dsub + msub) per 16-element scale group, dsub = d *
// sc and msub = -dmin * mn formed from the superblock's float32 d, dmin and
// the group's scale byte, with val the 2-bit value 0..3, f32 accumulation. The
// dense entry qmm_q2k_bf16 stands for the launcher _run (pallas_call at :680),
// the grouped entry qmm_q2k_grouped_bf16 for _run_grouped (:836), where rows
// sorted by expert multiply their own expert's plane.
//
// Bound on the H100: operations at the main path's 512-row prefill chunks (2 x
// 512 x 4096 x 4096 against 6 MB of planes for q; the card's ridge is ~295
// bf16 operations per byte). The tile loop is qmm_ws.cuh's (warp-specialized:
// a producer warpgroup's TMA copies into an mbarrier ring, two consumer
// warpgroups converting the weights into wgmma's register A operand, x tiles
// of up to 256 rows as its B operand); its Q2_K weight source, staged a
// superblock at a time (qs and scale bytes a TMA box each, d and dmin by the
// producer warp's lanes), is qmm_k16.cuh's `WsSource`, where the design is set
// out. The launch (tile height, weight rows a block) is
// ops/cuda/gemm_quant.py::qmm_ws_plan's.
#include "qmm_k16.cuh"

namespace {

int run(const void* x, const void* qs, const void* scm, const void* d, const void* dmin,
        void* out, int out_bf16, const int* offsets, int n_planes, int M, int N, int K,
        int tile_rows, void* stream) {
    qk16::WsSource<false> w;
    const int e = w.encode(qs, nullptr, scm, d, dmin, n_planes * N, K);
    if (e) return e;
    return qws::launch(w, x, out, out_bf16, offsets, n_planes, M, N, K, tile_rows, stream);
}

}  // namespace

// x (M, K) bf16; qs (N, K/4) u8; scm (N, K/16) u8; d, dmin (N, K/256) f32;
// out (M, N) f32, or bf16 when out_bf16 != 0. K % 256 == 0; tile_rows from
// qmm_ws_plan; the wrapper checks shapes and alignment.
extern "C" int qmm_q2k_bf16(const void* x, const void* qs, const void* scm, const void* d,
                            const void* dmin, void* out, int out_bf16, int M, int N, int K,
                            int tile_rows, void* stream) {
    return run(x, qs, scm, d, dmin, out, out_bf16, nullptr, 1, M, N, K, tile_rows, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/4), scm (n_planes, N, K/16), d, dmin (n_planes, N, K/256).
extern "C" int qmm_q2k_grouped_bf16(const void* x, const void* qs, const void* scm,
                                    const void* d, const void* dmin, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    int tile_rows, void* stream) {
    return run(x, qs, scm, d, dmin, out, out_bf16, (const int*)offsets, n_planes, M, N, K,
               tile_rows, stream);
}

// The rings of a tile of tile_rows rows (qws::layout): stages, superblock
// slots, shared memory in use.
extern "C" int qmm_q2k_ws_layout(int tile_rows, int* out) {
    return qws::layout<qk16::WsSource<false>>(tile_rows, out);
}
