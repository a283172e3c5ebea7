// The pipelined tensor-core tile loop of the quantized prefill matmuls
// (out = x @ W^T), dense and grouped, written over a weight source `W`:
// qmm_w8.cu (int8 planes with a scale per 512-deep chunk), qmm_q4k.cu (Q4_K
// nibbles with a scale and a minimum per 32 weights), qmm_q8_0.cu,
// qmm_q4_0.cu and qmm_q5_0.cu run on it; qmm_f32.cu takes its tile helpers.
// The Q5_K, Q6_K, Q3_K and Q2_K sources run qmm_ws.cuh's warp-specialized
// loop instead.
//
// A block computes a tile of the output *transposed*: out^T = W . x^T, 128
// weight rows (output columns; 64 per warpgroup, two warpgroups) by up to 128
// rows of x. wgmma takes only its B operand from shared memory and has no
// int8 x bf16 form, so the quantized weights are its *register* A operand:
// every thread reads its own weight bytes from the staged tile and converts
// them to bf16 in the A-fragment layout (`W::fragments`), and the converted
// weights never make a second trip through shared memory. The x tile is the
// B operand, K-major in the 128-byte swizzle. Then the x rows are wgmma's N,
// any multiple of 8: a ragged tail of 37 rows costs a 64-wide instruction, 5
// rows an 8-wide one (the tile loop is instantiated for N = 8, 16, 32, 64,
// 128 and a block picks by its row count); and a weight row's per-chunk scale
// (W8) is a row scale of the accumulator, two values a thread, read straight
// from global memory.
//
// Loads: a ring of STAGES k-steps (64 deep) of the x tile (bf16) and the raw
// weight tile, filled by cp.async by all threads, each copying the same
// chunks of every step from pointers it set up once; one __syncthreads a step.
// The loop is software-pipelined: a step's wgmmas are started behind the
// previous step's and left running while the same threads refill the ring and
// convert the next step's weights; the tensor cores drain only at the end of
// a scale chunk (KSC > 0) or of k. The epilogue transposes the accumulators
// through the ring's shared memory so that stores to out (rows, N) are 16-byte
// vectors along a row.
//
// Tiles: blockIdx.x walks the row tiles and blockIdx.y the 128-column weight
// tiles, so the blocks that run together are the row tiles of the same few
// weight tiles and find them in L2. Dense (offsets == nullptr): tile t covers
// rows [128 t, M) of plane 0. Grouped: rows are sorted by plane and offsets
// (n_planes + 1) holds each plane's first row; tiles are numbered through the
// planes' segments in turn, each segment cut into 128-row tiles of its own, so
// a tile never straddles two planes, a ragged segment ends in a short tile and
// an empty one has none. Each block finds its segment by walking the offsets
// on the device: nothing is padded and the host never reads a count.
//
// A weight source provides
//   TILE_BYTES           staged bytes of a 128-row x 64-deep weight tile
//   EXTRA_BYTES          shared memory beside the ring that the source keeps
//                        for data that outlives a ring slot (0 for none)
//   KSC                  k elements per scale chunk; 0 when the format has
//                        no scale that applies to partial sums
//   select_plane(p,N,K)  point at plane p of a stack
//   stager(n0,N,K,tid,extra)    this thread's part in staging tiles of rows
//                        n0.. (extra: the shared address of its region); its
//                        start(dst,k0) begins the copies of the step at depth
//                        k0, the weight tile to shared address dst
//   fragments(a,tile,extra,it,row,qd)   the thread's A fragments of the four
//                        k16 steps of step it, whose weight tile is at `tile`
//   scales(sc,row,N,chunk)      the chunk's scale of weight rows row, row + 8
//                               (only with KSC > 0)
// With KSC > 0 a thread keeps two accumulator sets: the chunk's partial sums,
// which wgmma restarts every KSC elements of k, and the float32 total, to
// which the partial sums times the row's scale are added (mul, then add, each
// rounded). With KSC == 0 the scales are the source's own business (Q4_K
// applies them while it converts) and one set sums the whole of k.
#pragma once

#include "common.cuh"
#include "qmm_tiles.cuh"
#include "wgmma.cuh"

namespace qpipe {

constexpr int BW = 128;     // weight rows (output columns) per block
constexpr int BX = 128;     // rows of x per tile, at most
constexpr int BK = 64;      // k per ring stage
constexpr int NT = 256;     // two warpgroups
constexpr int STAGES = 6;
constexpr int AHEAD = STAGES - 1;  // a step's tiles are fetched this many steps ahead
constexpr int X_BYTES = BX * BK * 2;
constexpr int LDC = BW + 4;  // row of the epilogue's staging tile, in floats

using qtile::Tile;
using qtile::find_tile;

static inline int dense_tiles(int M, int rows = BX) { return qtile::dense_tiles(M, rows); }
// Tiles a grouped launch must provide for: every segment may end in a short one.
static inline int grouped_tiles(int M, int n_planes, int rows = BX) {
    return qtile::grouped_tiles(M, n_planes, rows);
}

template <class W> __host__ __device__ constexpr int stage_bytes() { return X_BYTES + W::TILE_BYTES; }
template <class W> __host__ __device__ constexpr int smem_bytes() {
    constexpr int ring = STAGES * stage_bytes<W>() + W::EXTRA_BYTES, epi = BX * LDC * 4;
    return (ring > epi ? ring : epi) + 1024;  // slack to align the ring to 1,024 bytes
}

// One output tile with an NX-wide wgmma. `smem` / `smem_s`: the aligned ring
// as a generic pointer and as a shared-space address.
template <int NX, class W>
__device__ __forceinline__ void run(const W& w, const bf16* __restrict__ x, void* __restrict__ out,
                                    int out_bf16, const Tile& tile, int n0, int N, int K,
                                    uint8_t* smem, uint32_t smem_s) {
    static_assert(stage_bytes<W>() % 1024 == 0, "wgmma tiles need 1,024-byte alignment");
    constexpr int SB = stage_bytes<W>();
    constexpr int ND = NX / 2;  // accumulator registers a thread
    const int tid = threadIdx.x;
    const int wgi = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int qd = lane % 4;
    const int c_lo = wgi * 64 + 16 * warp + lane / 4;  // this thread's weight rows: c_lo, c_lo + 8
    const int KT = K / BK;

    // this thread's share of an x tile: chunk xc of rows xr + 32 i (the swizzle
    // depends on the row modulo 8 only, so the copies lie 4,096 bytes apart)
    constexpr int XPER = (NX * 8 + NT - 1) / NT;
    const int xr = tid / 8, xc = tid % 8;
    const bf16* xsrc[XPER];
    uint32_t xok = 0;
#pragma unroll
    for (int i = 0; i < XPER; ++i) {
        const int r = xr + 32 * i;
        const bool ok = r < NX && tile.m0 + r < tile.m_end;
        xsrc[i] = x + (size_t)(tile.m0 + (ok ? r : 0)) * K + xc * 8;
        xok |= (uint32_t)ok << i;
    }
    const uint32_t xdst = wg::swz128(xr, xc);
    const typename W::Stager stager = w.stager(n0, N, K, tid, smem_s + STAGES * SB);
    const uint8_t* extra = smem + STAGES * SB;

    auto fetch = [&](int it) {  // k step `it` into its ring slot
        const uint32_t xs = smem_s + (it % STAGES) * SB;
        const int k0 = it * BK;
#pragma unroll
        for (int i = 0; i < XPER; ++i)
            if (NX * 8 >= NT * (i + 1) || xr + 32 * i < NX)
                wg::cp_async16(xs + xdst + i * 4096, xsrc[i] + k0, (xok >> i) & 1);
        stager.start(xs + X_BYTES, k0);
    };
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (s < KT) fetch(s);
        wg::cp_async_commit();
    }

    float acc[ND], tot[ND], sc[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = tot[i] = 0.f;
    constexpr int CHUNK_STEPS = W::KSC > 0 ? W::KSC / BK : 1;

    // Software pipeline, two steps deep: a step's wgmmas are started behind the
    // previous step's, which are still running, and only that previous group
    // is waited for. Then the same threads wait for step it + 1's tiles,
    // refill the slot that step it - 1 left and build the A fragments of step
    // it + 1 in the registers that step it - 1 used. The tensor cores drain
    // only where a chunk's partial sums are read. (Tried on the H100 and not
    // kept: three groups in flight with a third set of fragments, and the
    // refill moved ahead of the wait; both made the Q4_K loop slower.)
    uint32_t a[2][4][4];
    wg::cp_async_wait<STAGES - 2>();  // step 0 has landed (this thread's part)
    wg::fence_async_proxy();
    __syncthreads();
    w.fragments(a[0], smem + X_BYTES, extra, 0, c_lo, qd);

    auto step = [&](int it, uint32_t (&use)[4][4], uint32_t (&fill)[4][4]) {
        const int slot = it % STAGES;
        const bool first = W::KSC > 0 ? it % CHUNK_STEPS == 0 : it == 0;
        if constexpr (W::KSC > 0) {
            if (first) w.scales(sc, n0 + c_lo, N, it / CHUNK_STEPS);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::pin(use[kk]);
        wg::pin(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wg::Mma<NX>::template rs<0>(acc, use[kk], wg::desc128(smem_s + slot * SB + kk * 32),
                                        !(first && kk == 0));
        wg::commit();
        wg::wait<1>();  // step it - 1 is done: its slot and its fragments are free
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::pin(fill[kk]);

        if (it + 1 < KT) {
            wg::cp_async_wait<STAGES - 3>();  // step it + 1 has landed (this thread's part)
            wg::fence_async_proxy();
            __syncthreads();  // everyone's part has, and everyone is past step it - 1
        }
        if (it + AHEAD < KT) fetch(it + AHEAD);  // into the slot of step it - 1
        wg::cp_async_commit();
        if (it + 1 < KT)
            w.fragments(fill, smem + (it + 1) % STAGES * SB + X_BYTES, extra, it + 1, c_lo, qd);

        if constexpr (W::KSC > 0) {
            if (it % CHUNK_STEPS == CHUNK_STEPS - 1) {
                wg::wait<0>();
                wg::pin(acc);
#pragma unroll
                for (int i = 0; i < ND; ++i)
                    tot[i] = __fadd_rn(tot[i], __fmul_rn(acc[i], sc[(i >> 1) & 1]));
            }
        }
    };
    for (int it = 0; it < KT; it += 2) {  // K is a multiple of 2 BK
        step(it, a[0], a[1]);
        step(it + 1, a[1], a[0]);
    }
    wg::wait<0>();
    wg::pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        wg::pin(a[0][kk]);
        wg::pin(a[1][kk]);
    }

    // epilogue: C[x row][weight row] through shared memory, then rows of out
    __syncthreads();
    float* C = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < ND; ++i) {
        const int n = 8 * (i / 4) + 2 * qd + (i & 1);
        const int c = c_lo + 8 * ((i >> 1) & 1);
        C[n * LDC + c] = W::KSC > 0 ? tot[i] : acc[i];
    }
    __syncthreads();
    const int rows = min(NX, tile.m_end - tile.m0);
    const bool vec = N % 8 == 0;
    for (int e = tid; e < rows * (BW / 8); e += NT) {
        const int n = e / (BW / 8), col = n0 + e % (BW / 8) * 8;
        if (col >= N) continue;
        const float* src = C + n * LDC + (col - n0);
        const float4 v0 = *reinterpret_cast<const float4*>(src);
        const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
        const size_t at = (size_t)(tile.m0 + n) * N + col;
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
kernel(const bf16* __restrict__ x, W w, void* __restrict__ out, int out_bf16,
       const int* __restrict__ offsets, int n_planes, int M, int N, int K) {
    extern __shared__ uint8_t smem_raw[];
    Tile tile;
    if (!find_tile(offsets, n_planes, M, blockIdx.x, tile, BX)) return;
    const uint32_t raw_s = wg::smem_u32(smem_raw);
    const uint32_t smem_s = (raw_s + 1023u) & ~1023u;
    uint8_t* smem = smem_raw + (smem_s - raw_s);
    w.select_plane(tile.plane, N, K);
    const int n0 = blockIdx.y * BW;
    const int rows = tile.m_end - tile.m0;
    if (rows > 64) run<128>(w, x, out, out_bf16, tile, n0, N, K, smem, smem_s);
    else if (rows > 32) run<64>(w, x, out, out_bf16, tile, n0, N, K, smem, smem_s);
    else if (rows > 16) run<32>(w, x, out, out_bf16, tile, n0, N, K, smem, smem_s);
    else if (rows > 8) run<16>(w, x, out, out_bf16, tile, n0, N, K, smem, smem_s);
    else run<8>(w, x, out, out_bf16, tile, n0, N, K, smem, smem_s);
}

// x (M, K) bf16, K a multiple of 128; out (M, N) float32, or bfloat16 when
// out_bf16 != 0. `tiles`: dense_tiles(M) with offsets == nullptr, else
// grouped_tiles(M, n_planes).
template <class W>
int launch(const W& w, const void* x, void* out, int out_bf16, const int* offsets, int n_planes,
           int tiles, int M, int N, int K, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<W>());
    if (e != cudaSuccess) return (int)e;
    dim3 grid(tiles, (N + BW - 1) / BW);
    kernel<W><<<grid, NT, smem_bytes<W>(), (cudaStream_t)stream>>>(
        (const bf16*)x, w, out, out_bf16, offsets, n_planes, M, N, K);
    return crabml_launch_status();
}

}  // namespace qpipe
