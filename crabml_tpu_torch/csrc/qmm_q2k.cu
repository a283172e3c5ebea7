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
// bf16 operations per byte). The tile loop is qmm_pipe.cuh's (wgmma with the
// weights as the register A operand, the x tile as B in swizzled shared
// memory, a six-stage cp.async ring, two wgmma groups in flight); its Q2_K
// weight source, staged a superblock at a time, is qmm_k16.cuh's, where the
// design is set out.
#include "qmm_k16.cuh"

// x (M, K) bf16; qs (N, K/4) u8; scm (N, K/16) u8; d, dmin (N, K/256) f32;
// out (M, N) f32, or bf16 when out_bf16 != 0. K % 256 == 0; the wrapper
// checks shapes and alignment.
extern "C" int qmm_q2k_bf16(const void* x, const void* qs, const void* scm, const void* d,
                            const void* dmin, void* out, int out_bf16, int M, int N, int K,
                            void* stream) {
    const qk16::Source<false> w{(const uint8_t*)qs, nullptr, (const uint8_t*)scm,
                                (const float*)d, (const float*)dmin};
    return qpipe::launch(w, x, out, out_bf16, nullptr, 1, qpipe::dense_tiles(M), M, N, K, stream);
}

// The grouped form: x (M, K) rows sorted by plane, offsets (n_planes + 1) i32
// on the device with each plane's first row (offsets[n_planes] == M), planes
// qs (n_planes, N, K/4), scm (n_planes, N, K/16), d, dmin (n_planes, N, K/256).
extern "C" int qmm_q2k_grouped_bf16(const void* x, const void* qs, const void* scm,
                                    const void* d, const void* dmin, void* out, int out_bf16,
                                    const void* offsets, int n_planes, int M, int N, int K,
                                    void* stream) {
    const qk16::Source<false> w{(const uint8_t*)qs, nullptr, (const uint8_t*)scm,
                                (const float*)d, (const float*)dmin};
    return qpipe::launch(w, x, out, out_bf16, (const int*)offsets, n_planes,
                         qpipe::grouped_tiles(M, n_planes), M, N, K, stream);
}
