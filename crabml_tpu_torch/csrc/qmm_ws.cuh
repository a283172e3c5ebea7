// The warp-specialized tensor-core tile loop of the quantized prefill
// matmuls (out = x @ W^T), dense and grouped, written over a weight source
// `W`: qmm_q5k.cu (Q5_K, and Q5_1 on its planes), qmm_q6k.cu (Q6_K),
// qmm_q3k.cu and qmm_q2k.cu (Q3_K and Q2_K, qmm_k16.cuh's source) run on it;
// the other sources still run on qmm_pipe.cuh.
//
// A block computes a tile of the output *transposed*: out^T = W . x^T, for
// 128 weight rows (output columns) and a tile of up to 256 rows of x.
// wgmma has no int8 x bf16 form, so the quantized weights are its register A
// operand: each consumer thread converts its own weight bytes, staged in
// shared memory, to bf16 in the A-fragment layout (`W::fragments`). The x
// tile is the B operand, K-major in the 128-byte swizzle, so the rows of x
// are wgmma's N (a multiple of 8 up to 256): a ragged tile of 37 rows takes a
// 48-wide instruction. With 256 rows a tile, a weight is converted once for
// 256 rows of x, where qmm_pipe.cuh's 128-row tiles convert it twice.
//
// Three warpgroups, each with a role for the whole kernel:
//   - the producer (warpgroup 0; setmaxnreg lowers its registers to 40): one
//     thread of its first warp copies each 64-deep k step into a ring of
//     slots with the tensor memory accelerator (TMA): the x tile in boxes of
//     64 rows (of the tile's height where that is less), as many as the
//     tile's rows need, and the source's bytes of the step; and, on the
//     first step of each superblock (the source's unit of SB_STEPS steps: a
//     256-deep superblock, or Q6_K's 128-element half), the source's bytes
//     of that unit into a ring of their own, where the warp's 32 lanes add
//     what TMA cannot copy. The rings are as deep as shared memory allows
//     for the tile's height (`ring_shape`): 4-6 steps of a 256-row tile, up
//     to 16 of a tile of at most 64 rows, whose loads would otherwise wait on
//     memory's latency. Each slot has a "full" mbarrier, on which the copies
//     complete, and an "empty" one, on which the consumers release it; the
//     producer waits for a slot to be empty before it refills it.
//   - two consumers (warpgroups 1, 2; setmaxnreg raises theirs to 232: 256
//     x rows are 128 float32 accumulators a thread), each owning 64 weight
//     rows over every k step. A consumer waits on a slot's full barrier,
//     converts its weights into register A, and keeps two wgmma groups in
//     flight: a step's products start behind the previous step's, which are
//     still running, and only that previous group is waited for before its
//     slot is released and the next step's weights are converted. No barrier
//     spans the block in the k loop, which is unrolled by a superblock so
//     that each step's place in it (the source's shifts and offsets) is a
//     constant.
// The epilogue transposes the accumulators through the ring's shared memory
// (free once the consumers are past their loops) so that stores to out
// (rows, N) are 16-byte vectors along a row.
//
// Each output element is one wgmma chain over the whole of k, in order,
// whatever the tile: a row's sums do not depend on how many rows share its
// launch (a segment of a grouped launch equals the dense launch on its plane,
// bit for bit). Splitting a block's k steps between its consumers, which
// fills more of the card at a few rows, was measured and not kept for that
// reason (PERF.md).
//
// Tiles (qmm_tiles.cuh): blockIdx.x walks the row tiles of `tile_rows` rows
// (dense, or numbered through the segments of a grouped launch; the launch
// plan's height, ops/cuda/gemm_quant.py::qmm_ws_plan, a function of the
// shapes, so a CUDA graph can capture the launch) and blockIdx.y the weight
// tiles. A stack's planes are one 2-D array (n_planes * N rows), and a tile of
// plane e reads the weight rows e * N + n.
//
// A weight source provides
//   STEP_BYTES, SB_BYTES   shared memory a slot of the step ring holds beside
//                          the x tile (0 for none), and a superblock slot
//   SB_STEPS               k steps a superblock slot holds: 4 (256 deep), or
//                          2 (Q6_K's half, the unit of its bit order)
//   SB_ARRIVALS            arrivals that complete a superblock slot: 1 (the
//                          producer's, with its TMA bytes), 33 where the
//                          producer warp's lanes also copy with cp.async
//   STEP_TX, SB_TX         bytes the TMA copies of a step / superblock bring
//   load_step(dst, bar, it, wrow)        the TMA copies of k step it for the
//                          weight rows from wrow, into shared dst (one thread)
//   load_superblock(dst, bar, sb, wrow)  those of superblock sb (one thread)
//   copy_superblock(dst, bar, sb, wrow, valid, lane)   the rest of superblock
//                          sb, by the producer warp's 32 lanes, each then
//                          arriving on bar (`valid`: weight rows that exist)
//   fragments(a, step, sb, c, row, qd)   the thread's A fragments of the four
//                          k16 steps of the c-th step (0..3) of a 256-deep
//                          superblock (rows row, row + 8), from the step's
//                          slot and the superblock slot that holds the step
// and on the host the tensor maps of its planes (`encode`, qws::map_2d).
// The sources' scales apply to the weights while they convert: one set of
// accumulators sums the whole of k.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include <type_traits>

#include "common.cuh"
#include "qmm_tiles.cuh"
#include "wgmma.cuh"

namespace qws {

constexpr int BK = 64;           // k per step
constexpr int NT = 384;          // a producer and two consumer warpgroups
constexpr int W_ROWS = 128;      // weight rows a block: 64 a consumer
constexpr int X_BOX = 64;        // rows of x a TMA box, at most

// The rows of x a TMA box of a tile of tile_rows rows holds: the tile's own
// height up to 64 (a multiple of 8), so a short tile copies no rows past it.
__host__ __device__ __forceinline__ int x_box(int tile_rows) {
    return tile_rows < X_BOX ? tile_rows : X_BOX;
}
constexpr int SB_STEPS = 4;      // k steps a 256-deep superblock: the k loop's unrolling
constexpr int LDC = 128 + 4;     // row of the epilogue's staging tile, in floats
constexpr int SMEM_MAX = 232448; // the H100's shared memory a block
constexpr int BARRIER_BYTES = 512;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// The wgmma widths a tile takes: the least that holds its rows.
constexpr int WIDTHS[] = {8, 16, 24, 32, 48, 64, 96, 128, 192, 256};

constexpr int MAX_STAGES = 16, MAX_SB = 6;  // the barriers' room

// The rings for a tile of tile_rows rows: `stages` slots of the x tile's
// boxes and the source's step bytes, and `sb_slots` superblock slots (of
// sb_steps steps each), enough for the superblocks that `stages` steps span
// and one more on each side.
struct RingShape {
    int stage_bytes, stages, sb_slots;
};
__host__ __device__ __forceinline__ RingShape ring_shape(int tile_rows, int step_bytes,
                                                         int sb_bytes, int sb_steps) {
    RingShape r;
    const int box = x_box(tile_rows);
    r.stage_bytes = (tile_rows + box - 1) / box * box * BK * 2 + step_bytes;
    const int room = SMEM_MAX - 1024 - BARRIER_BYTES;
    for (r.stages = MAX_STAGES; r.stages > 2; --r.stages) {
        r.sb_slots = r.stages / sb_steps + 2 < MAX_SB ? r.stages / sb_steps + 2 : MAX_SB;
        if (r.stages * r.stage_bytes + r.sb_slots * sb_bytes <= room) break;
    }
    return r;
}
template <class W> __host__ __device__ __forceinline__ RingShape ring_shape(int tile_rows) {
    static_assert(SB_STEPS % W::SB_STEPS == 0, "a superblock slot holds 1, 2 or 4 steps");
    return ring_shape(tile_rows, W::STEP_BYTES, W::SB_BYTES, W::SB_STEPS);
}

template <class W> struct Params {
    CUtensorMap x;  // (M, K) bf16, boxes of 64 k x x_box(tile_rows) rows, 128-byte swizzle
    W w;
};

struct Ring {
    RingShape shape;
    uint32_t base;  // shared address of slot 0 (1,024-byte aligned)
    uint32_t sb;    // of superblock slot 0
    uint32_t bars;  // full[MAX_STAGES], empty[MAX_STAGES], sb_full[MAX_SB], sb_empty[MAX_SB]
    __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
    __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (MAX_STAGES + s); }
    __device__ __forceinline__ uint32_t sb_full(int t) const {
        return bars + 8 * (2 * MAX_STAGES + t);
    }
    __device__ __forceinline__ uint32_t sb_empty(int t) const {
        return bars + 8 * (2 * MAX_STAGES + MAX_SB + t);
    }
};

// The producer warp: every k step of the tile, in order; lane 0 issues the TMA
// copies. Slots and their phases advance by counting, with no division.
template <class W>
__device__ __forceinline__ void produce(const Params<W>& p, const Ring& ring, int KT, int m0,
                                        int rows, int box, int wrow, int valid, int lane) {
    const int S = ring.shape.stages, SBS = ring.shape.sb_slots;
    const int boxes = (rows + box - 1) / box;
    const uint32_t tx = boxes * box * BK * 2 + W::STEP_TX;
    // the step's slot and the parity of its use; the superblock's
    int s = 0, ph = 0, t = 0, tph = 0;
    for (int it = 0; it < KT; ++it) {
        if (it >= S) wg::mbar_wait(ring.empty(s), ph ^ 1);  // the slot's previous use is released
        if ((it & (W::SB_STEPS - 1)) == 0) {
            if (it >= W::SB_STEPS * SBS) wg::mbar_wait(ring.sb_empty(t), tph ^ 1);
            const uint32_t bar = ring.sb_full(t), dst = ring.sb + t * W::SB_BYTES;
            if (lane == 0) {
                wg::mbar_expect_tx(bar, W::SB_TX);
                p.w.load_superblock(dst, bar, it / W::SB_STEPS, wrow);
            }
            p.w.copy_superblock(dst, bar, it / W::SB_STEPS, wrow, valid, lane);
            if (++t == SBS) t = 0, tph ^= 1;
        }
        if (lane == 0) {
            const uint32_t dst = ring.base + s * ring.shape.stage_bytes, bar = ring.full(s);
            wg::mbar_expect_tx(bar, tx);
            for (int b = 0; b < boxes; ++b)
                wg::tma_load_2d(dst + b * box * BK * 2, &p.x, bar, it * BK, m0 + b * box);
            if constexpr (W::STEP_BYTES > 0)
                p.w.load_step(dst + ring.shape.stage_bytes - W::STEP_BYTES, bar, it, wrow);
        }
        if (++s == S) s = 0, ph ^= 1;
    }
}

// One consumer warpgroup (cw 0 or 1: weight rows 64 cw ..) over the tile with
// an NX-wide wgmma.
template <int NX, class W>
__device__ __forceinline__ void consume(const W& w, const Ring& ring, uint8_t* smem,
                                        void* __restrict__ out, int out_bf16, int m0, int rows,
                                        int n0, int N, int KT) {
    const int S = ring.shape.stages, SB = ring.shape.stage_bytes, SBS = ring.shape.sb_slots;
    constexpr int ND = NX / 2;  // accumulator registers a thread
    const int ct = threadIdx.x - 128;  // 0..255
    const int warp = ct / 32, lane = ct % 32, qd = lane % 4;
    const int c_lo = 16 * warp + lane / 4;  // this thread's weight rows: c_lo, c_lo + 8
    const uint8_t* sb_g = smem + (ring.sb - ring.base);

    float acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;

    // Waits for the next step's slots and converts its weights into `a`
    // (c: the step's place in its 256-deep superblock, a constant where the
    // loop below calls it); releases a superblock slot after its last step.
    int cs = 0, cph = 0, csb = 0, csph = 0;  // the next step's slot and parity; its superblock's
    auto convert = [&](int c, uint32_t (&a)[4][4]) {
        if constexpr (W::SB_BYTES > 0) {
            if (c % W::SB_STEPS == 0) wg::mbar_wait(ring.sb_full(csb), csph);
        }
        wg::mbar_wait(ring.full(cs), cph);
        w.fragments(a, smem + (cs + 1) * SB - W::STEP_BYTES, sb_g + csb * W::SB_BYTES, c, c_lo,
                    qd);
        if constexpr (W::SB_BYTES > 0) {
            if (c % W::SB_STEPS == W::SB_STEPS - 1) {
                __syncwarp();
                if (lane == 0) wg::mbar_arrive(ring.sb_empty(csb));
                if (++csb == SBS) csb = 0, csph ^= 1;
            }
        }
        if (++cs == S) cs = 0, cph ^= 1;
    };

    uint32_t a[2][4][4];
    convert(0, a[0]);
    int ms = 0, ps = 0;  // the slots of the step whose products start, and of the step before
    // step it, the J-th of its superblock (a compile-time constant: the
    // conversion of the next step then shifts and indexes by constants)
    auto step = [&](auto J, int it, uint32_t (&use)[4][4], uint32_t (&fill)[4][4]) {
        const uint32_t xs = ring.base + ms * SB;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::pin(use[kk]);
        wg::pin(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wg::Mma<NX>::template rs<0>(acc, use[kk], wg::desc128(xs + kk * 32),
                                        !(it == 0 && kk == 0));
        wg::commit();
        wg::wait<1>();  // the previous step's products are done: its slot and fragments are free
        if (it != 0 && lane == 0) wg::mbar_arrive(ring.empty(ps));
        ps = ms;
        if (++ms == S) ms = 0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::pin(fill[kk]);
        if (it + 1 < KT) convert((decltype(J)::value + 1) % SB_STEPS, fill);
    };
    for (int it = 0; it < KT; it += SB_STEPS) {  // K is a multiple of 256
        step(std::integral_constant<int, 0>{}, it, a[0], a[1]);
        step(std::integral_constant<int, 1>{}, it + 1, a[1], a[0]);
        step(std::integral_constant<int, 2>{}, it + 2, a[0], a[1]);
        step(std::integral_constant<int, 3>{}, it + 3, a[1], a[0]);
    }
    wg::wait<0>();
    wg::pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        wg::pin(a[0][kk]);
        wg::pin(a[1][kk]);
    }

    // epilogue: C[x row][weight row] through shared memory, then rows of out
    wg::bar_sync(1, 256);  // both consumers are past their loops: every copy has landed
    float* C = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < ND; ++i)
        C[(8 * (i / 4) + 2 * qd + (i & 1)) * LDC + c_lo + 8 * ((i >> 1) & 1)] = acc[i];
    wg::bar_sync(1, 256);
    const int nr = min(NX, rows);
    constexpr int vecs = W_ROWS / 8;
    const bool vec = N % 8 == 0;
    for (int e = ct; e < nr * vecs; e += 256) {
        const int n = e / vecs, col = n0 + e % vecs * 8;
        if (col >= N) continue;
        const float* src = C + n * LDC + (col - n0);
        const float4 v0 = *reinterpret_cast<const float4*>(src);
        const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
        const size_t at = (size_t)(m0 + n) * N + col;
        if (out_bf16) {
            bf16* o = reinterpret_cast<bf16*>(out) + at;
            if (vec) {
                *reinterpret_cast<uint4*>(o) =
                    make_uint4(wg::pack_bf16(v0.x, v0.y), wg::pack_bf16(v0.z, v0.w),
                               wg::pack_bf16(v1.x, v1.y), wg::pack_bf16(v1.z, v1.w));
            } else {
                for (int j = 0; j < 8 && col + j < N; ++j) o[j] = __float2bfloat16_rn(src[j]);
            }
        } else {
            float* o = reinterpret_cast<float*>(out) + at;
            if (vec) {
                *reinterpret_cast<float4*>(o) = v0;
                *reinterpret_cast<float4*>(o + 4) = v1;
            } else {
                for (int j = 0; j < 8 && col + j < N; ++j) o[j] = src[j];
            }
        }
    }
}

template <class W>
__global__ void __launch_bounds__(NT, 1)
kernel(const __grid_constant__ Params<W> p, void* __restrict__ out, int out_bf16,
       const int* __restrict__ offsets, int n_planes, int M, int N, int K, int tile_rows) {
    extern __shared__ uint8_t smem_raw[];
    qtile::Tile tile;
    if (!qtile::find_tile(offsets, n_planes, M, blockIdx.x, tile, tile_rows)) return;
    const int rows = min(tile_rows, tile.m_end - tile.m0);
    const uint32_t raw_s = wg::smem_u32(smem_raw);
    const uint32_t smem_s = (raw_s + 1023u) & ~1023u;
    uint8_t* smem = smem_raw + (smem_s - raw_s);
    Ring ring;
    ring.shape = ring_shape<W>(tile_rows);
    ring.base = smem_s;
    ring.sb = smem_s + ring.shape.stages * ring.shape.stage_bytes;
    ring.bars = smem_s + SMEM_MAX - 1024 - BARRIER_BYTES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < ring.shape.stages; ++s) {
            wg::mbar_init(ring.full(s), 1);
            wg::mbar_init(ring.empty(s), 8);  // the consumers' warps
        }
        for (int t = 0; t < ring.shape.sb_slots; ++t) {
            wg::mbar_init(ring.sb_full(t), W::SB_ARRIVALS);
            wg::mbar_init(ring.sb_empty(t), 8);
        }
        wg::mbar_fence_init();
    }
    __syncthreads();
    const int KT = K / BK;
    const int n0 = blockIdx.y * W_ROWS;
    if (threadIdx.x < 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x < 32)
            produce(p, ring, KT, tile.m0, rows, x_box(tile_rows), tile.plane * N + n0,
                    min(W_ROWS, N - n0), threadIdx.x);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
#define QWS_CONSUME(NX) consume<NX>(p.w, ring, smem, out, out_bf16, tile.m0, rows, n0, N, KT)
        if (rows > 192) QWS_CONSUME(256);
        else if (rows > 128) QWS_CONSUME(192);
        else if (rows > 96) QWS_CONSUME(128);
        else if (rows > 64) QWS_CONSUME(96);
        else if (rows > 48) QWS_CONSUME(64);
        else if (rows > 32) QWS_CONSUME(48);
        else if (rows > 24) QWS_CONSUME(32);
        else if (rows > 16) QWS_CONSUME(24);
        else if (rows > 8) QWS_CONSUME(16);
        else QWS_CONSUME(8);
#undef QWS_CONSUME
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: no link to libcuda.
static inline EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
    }
    return fn;
}

// A map of the row-major (rows, cols) array at `base` of `elem`-byte
// elements, in boxes of box_cols x box_rows; rows past the array read as
// zeros. Returns a CUDA error code, 0 on success.
static inline int map_2d(CUtensorMap* m, CUtensorMapDataType type, int elem, const void* base,
                         uint64_t cols, uint64_t rows, uint32_t box_cols, uint32_t box_rows,
                         CUtensorMapSwizzle swizzle) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * (uint64_t)elem};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t step[2] = {1, 1};
    const CUresult r = enc(m, type, 2, const_cast<void*>(base), dims, strides, box, step,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static inline bool valid_tile(int tile_rows) {
    for (int w : WIDTHS)
        if (w == tile_rows) return true;
    return false;
}

// The rings a tile of tile_rows rows gets, for the launch plan's mirror
// (gemm_quant.py::qmm_ws_ring) to be held to: out = {stages, superblock
// slots, shared memory in use}.
template <class W> int layout(int tile_rows, int* out) {
    if (!valid_tile(tile_rows)) return (int)cudaErrorInvalidValue;
    const RingShape r = ring_shape<W>(tile_rows);
    out[0] = r.stages;
    out[1] = r.sb_slots;
    out[2] = r.stages * r.stage_bytes + r.sb_slots * W::SB_BYTES + BARRIER_BYTES + 1024;
    return 0;
}

// x (M, K) bf16, K a multiple of 256; out (M, N) float32, or bfloat16 when
// out_bf16 != 0; `w` with its planes' maps encoded (W::encode). offsets ==
// nullptr: dense, tile t the rows [tile_rows t, M); else grouped over n_planes
// segments. tile_rows comes from the launch plan.
template <class W>
int launch(W& w, const void* x, void* out, int out_bf16, const int* offsets, int n_planes, int M,
           int N, int K, int tile_rows, void* stream) {
    if (!valid_tile(tile_rows) || K % 256 != 0) return (int)cudaErrorInvalidValue;
    Params<W> p;
    p.w = w;
    int e = map_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, BK, x_box(tile_rows),
                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
    e = (int)cudaFuncSetAttribute(kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_MAX);
    if (e) return e;
    const int tiles = offsets == nullptr ? qtile::dense_tiles(M, tile_rows)
                                         : qtile::grouped_tiles(M, n_planes, tile_rows);
    dim3 grid(tiles, (N + W_ROWS - 1) / W_ROWS);
    kernel<W><<<grid, NT, SMEM_MAX, (cudaStream_t)stream>>>(p, out, out_bf16, offsets, n_planes,
                                                            M, N, K, tile_rows);
    return crabml_launch_status();
}

}  // namespace qws
