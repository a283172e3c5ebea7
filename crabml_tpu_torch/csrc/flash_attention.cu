// flash_attention: causal prefill attention over the KV cache.
//
// Replaces crabml_tpu/ops/pallas/flash_attention.py::_kernel (launcher _flash,
// pallas_call at :139). Each sequence's first new row sits at cache offset
// pos[b]; row (t, g) of kv group `kv` sees keys j <= pos[b] + t and, with a
// sliding window, j > pos[b] + t - window. The scores may be capped as
// cap * tanh(s / cap) before masking. The G q heads of a kv group are stacked
// as rows of one tile, so every K/V tile is read once per group, and a running
// max, denominator and output accumulator (online softmax) are carried across
// the key tiles. Key tiles wholly above the diagonal, or wholly outside the
// window of the block's first row, are not visited. A row that sees no key
// gives 0.
//
// Bound on the H100: at the main path's 512-token chunks a layer's attention
// moves 2-4 MB and does 1-2 GFLOP: microseconds of tensor-core or memory time,
// so the kernel is bound by how well one wave of blocks keeps the tensor cores
// fed, not by the card's peak.
//
// bfloat16 entry (flash_tc_kernel): both products run on the tensor cores with
// wgmma (bf16 in, f32 accumulators in registers). A block is two warpgroups;
// each owns 64 stacked rows (64 / G tokens x G heads, rounded down) and both
// walk the same 64-key tiles, so a tile is read once for 128 rows. Where G
// does not divide 64 (Qwen2-7B's 7 q heads a kv head: 9 tokens, 63 rows) the
// last 64 % G rows are padding: their queries load as zeros, so their scores
// are 0 and their softmax stays finite, and their output is never stored.
// K and V tiles stay bf16 in shared memory in the 128-byte-swizzled layout
// wgmma reads, in a ring of
// three stages filled by cp.async two tiles ahead (keys past the block's
// causal bound or before its first row's window are zero-filled, so a row no
// query sees never reaches the arithmetic); one __syncthreads a tile. At head dim 256 a tile is 32 KB and
// three stages beside the two Q tiles would pass the 227 KB a block may
// have, so the ring has two stages there, filled one tile ahead
// (stages_of). The split stays two warpgroups of 64 rows: a thread then holds
// 128 output accumulators (64 rows x 256 dims over 128 threads) beside the
// 32 scores and the 16 registers of P, within the 255 a thread of a
// one-block-per-SM launch may have. S = Q K^T reads Q (loaded once,
// unscaled) and K from shared memory; the f32 scores are scaled, capped,
// masked and exponentiated in registers (exp2 with log2 e folded into the
// scale), rounded to bf16 and fed to the second wgmma as its register A
// operand: P never touches shared memory. V, (keys, hd) row-major, is the
// MN-major B operand (transposed-B form of the descriptor), one 64-wide block
// of the head dimension per instruction. Only tiles that cross the diagonal
// or the window's edge pay for the mask.
//
// Every head dim that is a multiple of 8 up to 256 takes one of three tile
// widths (tile_width): HP = 64 up to 64, 128 up to 128 (phi2's 80, phi3's
// 96), 256 above (136-256: a 192-wide tile would save up to a quarter of the
// P V work at 136-192, but no model in the repo has such a head dim, and one
// width fewer keeps one set of swizzles and rings a width). The template
// takes the width and the head dim: a constant for the head dims of the
// repo's models before this form (16, 64, 80, 96, 128, 256: every count a
// constant, only the head dim's 16-byte chunks of a row copied, since a
// multiple of 16 never reads a lane past it), or 0, for every other multiple
// of 8 (stories260K's 8, stories15M's 48, ...), which is then a launch
// argument. (One runtime instance for all of them cost 8-18% at 16, 80 and
// 96 on an H100.) q, k, v and out keep their hd stride in global memory, and
// a tile row in shared memory is HP elements wide. In the runtime instance
// the hd / 8 live chunks of a row are copied and the rest zero-filled
// (cp.async of 0 bytes), so a lane past hd holds 0 in Q, K and V, never a
// stale value that 0 times would leave NaN. The score product takes
// ceil(hd / 16) k16 steps: where hd is an odd multiple of 8 (8, 24, 40, ...)
// the last step reads 8 zero lanes of Q and K, which add nothing. The P V
// product's output lanes past hd are never stored. The swizzles, the ring,
// the warpgroups and the accumulators are the width's; the product of P and
// V costs HP / hd of its own work (1.33x at 96, 1.6x at 80, 8x at 8), while
// the bytes read stay hd's. A native width (wgmma n96 and a 64-byte swizzle)
// would save that.
//
// float32 entry (flash_kernel): CUDA cores in float32, since tensor cores
// would round the inputs to TF32 or bf16 where the TPU kernel asks for full
// precision. A block owns 64 rows, padded as above; Q, K and V tiles are
// staged in shared memory as float32, HP = 16 * ceil(hd / 16) wide, the lanes
// past hd zero; each of the 256 threads computes a 4x4 block of scores and a
// 4x(HP/16) block of the output, and stores the lanes below hd.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BR = 64;  // rows (tokens x heads) per warpgroup (f32 kernel: per block)
constexpr int BC = 64;  // keys per tile
constexpr int NT = 256; // threads of a block, both kernels
constexpr float LOG2E = 1.4426950408889634f;

// The first key any row of a block sees (that of its first row's window),
// and the first key tile it visits: tiles whose last key lies before it are
// skipped, and keys before it in the first tile are zero-filled, not loaded
// (a probability of 0 times a NaN of a stale row would still be NaN).
__device__ __forceinline__ int first_seen(int first_row_pos, int window) {
    return window > 0 ? max(0, first_row_pos - window + 1) : 0;
}
__device__ __forceinline__ int first_tile(int first_row_pos, int window) {
    return first_seen(first_row_pos, window) / BC;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int NO>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ pos, T* __restrict__ out, int KV, int S, int T_, int G,
             int hd, float scale, float softcap, int window) {
    constexpr int HD = 16 * NO;  // a tile row: hd lanes, then zeros
    extern __shared__ float smem[];
    float* Qs = smem;                    // [BR][HD + 1]
    float* Ks = Qs + BR * (HD + 1);      // [BC][HD + 1]
    float* Vs = Ks + BC * (HD + 1);      // [BC][HD]
    float* Ps = Vs + BC * HD;            // [BR][BC + 1]

    const int bq = BR / G;  // tokens per block; rows from bq * G on are padding
    const int t0 = blockIdx.x * bq, kv = blockIdx.y, b = blockIdx.z;
    const int H = KV * G;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int p0 = pos[b];
    const size_t head = ((size_t)b * KV + kv) * S;

    // Q tile: row r = g * bq + (t - t0), pre-scaled; rows past T and padding are zero
    for (int i = tid; i < BR * HD; i += NT) {
        const int r = i / HD, d = i % HD;
        const int g = r / bq, t = t0 + r % bq;
        float val = 0.f;
        if (t < T_ && g < G && d < hd)
            val = to_f32(q[((size_t)(b * T_ + t) * H + kv * G + g) * hd + d]) * scale;
        Qs[r * (HD + 1) + d] = val;
    }

    float m[4], l[4], acc[4][NO];
    int rbound[4], rfirst[4];  // last and first visible key of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = CRABML_NEG_INF; l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
        const int r = ty + 16 * i;
        rbound[i] = p0 + t0 + r % bq;
        rfirst[i] = window > 0 ? rbound[i] - window + 1 : 0;
    }
    const int last_key = p0 + min(t0 + bq, T_) - 1;  // causal bound of the block
    const int first_key = first_seen(p0 + t0, window);
    const int n_tiles = last_key / BC + 1;

    for (int kt = first_tile(p0 + t0, window); kt < n_tiles; ++kt) {
        const int k0 = kt * BC;
        __syncthreads();  // previous tile's readers are done
        for (int i = tid; i < BC * HD; i += NT) {
            const int c = i / HD, d = i % HD;
            const int j = k0 + c;
            float kvv = 0.f, vvv = 0.f;
            if (j <= last_key && j >= first_key && d < hd) {
                kvv = to_f32(k[(head + j) * hd + d]);
                vvv = to_f32(v[(head + j) * hd + d]);
            }
            Ks[c * (HD + 1) + d] = kvv;
            Vs[c * HD + d] = vvv;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            float qv[4], kvr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kvr[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kvr[j];
        }
        if (softcap > 0.f) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = softcap * tanhf(s[i][j] / softcap);
        }

        // online softmax over this tile; a row's 16 owners share a half-warp
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = CRABML_NEG_INF;
            bool live[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                live[j] = col <= rbound[i] && col >= rfirst[i];
                if (!live[j]) s[i][j] = CRABML_NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = __expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = live[j] ? __expf(s[i][j] - m_new) : 0.f;
                Ps[(ty + 16 * i) * (BC + 1) + tx + 16 * j] = p;
                rs += p;
            }
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < NO; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BC; ++c) {
            float pv[4], vv[NO];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BC + 1) + c];
#pragma unroll
            for (int j = 0; j < NO; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NO; ++j) acc[i][j] += pv[i] * vv[j];
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int g = r / bq, t = t0 + r % bq;
        if (t >= T_ || g >= G) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        T* o = out + ((size_t)(b * T_ + t) * H + kv * G + g) * hd;
#pragma unroll
        for (int j = 0; j < NO; ++j)
            if (tx + 16 * j < hd) o[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
}

template <int NO>
int launch_f32(const void* q, const void* k, const void* v, const void* pos, void* out, int B,
               int KV, int S, int T_, int G, int hd, float scale, float softcap, int window,
               cudaStream_t stream) {
    using T = float;
    constexpr int HD = 16 * NO;
    constexpr size_t smem =
        sizeof(float) * (BR * (HD + 1) + BC * (HD + 1) + BC * HD + BR * (BC + 1));
    static_assert(smem <= 232448, "the float32 tiles must fit a block's shared memory");
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, NO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int bq = BR / G;
    dim3 grid((T_ + bq - 1) / bq, KV, B);
    flash_kernel<T, NO><<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                    (const int*)pos, (T*)out, KV, S, T_, G, hd,
                                                    scale, softcap, window);
    return crabml_launch_status();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, cp.async ring
// ---------------------------------------------------------------------------

constexpr int NWG = NT / 128;  // warpgroups of a block, 64 stacked rows each

// K/V tiles in the ring; loads run stages - 1 tiles ahead. Three up to head
// dim 128; two at 256, where three would not fit beside the Q tiles.
template <int HD> __host__ __device__ constexpr int stages_of() { return HD <= 128 ? 3 : 2; }
// A tile row's width in shared memory: 64 up to head dim 64, 128 up to 128,
// else 256 (whole 64-element swizzle blocks; no 192-wide tile is built).
__host__ __device__ constexpr int tile_width(int hd) {
    return hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// A tile of 64 rows x HD bf16 lies in shared memory as HD / 64 blocks of 64
// rows x 128 bytes, each block swizzled: the operand layout of wgmma, K-major
// when a row is a q row or a key of S = Q K^T, MN-major for V in O += P V.
template <int HD> struct Tile {
    static constexpr int BYTES = 64 * HD * 2;
    static constexpr int CHUNKS = HD / 8;  // 16-byte chunks a row
    static __device__ __forceinline__ uint32_t offset(int r, int c) {
        return (uint32_t)((c >> 3) * 8192) + wg::swz128(r, c & 7);
    }
};

// HP: the tile width; HD: the head dim, a multiple of 16 up to HP, or 0: hd
// is the launch argument `hd_arg`, a multiple of 8 below HP.
template <int HP, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ pos, bf16* __restrict__ out,
                int KV, int S, int T_, int G, int hd_arg, float scale, float softcap, int window) {
    using TL = Tile<HP>;
    const int hd = HD ? HD : hd_arg;
    const int live = hd / 8;  // 16-byte chunks of a row in global memory
    // the chunks a row's copy covers: the live ones, or the whole tile row,
    // those past hd zero-filled
    constexpr int NCH = HD ? HD / 8 : TL::CHUNKS;
    const int ksteps = (hd + 15) / 16;  // k16 steps of the score product
    constexpr int STAGES = stages_of<HP>(), AHEAD = STAGES - 1;
    extern __shared__ uint8_t smem_raw[];
    // 1,024-byte alignment of every tile: [NWG] Q tiles, then STAGES x (K, V)
    const uint32_t base = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_s = base;
    const uint32_t kv_s = base + NWG * TL::BYTES;

    const int tid = threadIdx.x;
    const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int qd = lane % 4, rw = lane / 4;
    const int bq = BR / G;  // tokens per warpgroup; rows from bq * G on are padding
    const int kv = blockIdx.y, b = blockIdx.z;
    const int H = KV * G;
    const int p0 = pos[b];
    const int t0_blk = blockIdx.x * NWG * bq;
    const int t0 = t0_blk + wgi * bq;  // this warpgroup's first token
    const size_t head = ((size_t)b * KV + kv) * S;

    const int last_key = p0 + min(t0_blk + NWG * bq, T_) - 1;  // causal bound of the block
    const int first_key = first_seen(p0 + t0_blk, window);
    const int kt_begin = first_tile(p0 + t0_blk, window);
    const int n_tiles = last_key / BC + 1 - kt_begin;

    // Q: row r = g * bq + (t - t0) of warpgroup w; rows past T, padding rows
    // and the lanes past hd are zeros
    for (int i = tid; i < NWG * 64 * NCH; i += NT) {
        const int w = i / (64 * NCH), r = i / NCH % 64, c = i % NCH;
        const int g = r / bq, t = t0_blk + w * bq + r % bq;
        const bool ok = t < T_ && g < G && c < live;
        const bf16* src = q + (ok ? ((size_t)(b * T_ + t) * H + kv * G + g) * hd + c * 8 : 0);
        wg::cp_async16(q_s + w * TL::BYTES + TL::offset(r, c), src, ok);
    }
    auto load_tile = [&](int i) {  // key tile kt_begin + i into stage i % STAGES
        const int k0 = (kt_begin + i) * BC;
        const uint32_t ks = kv_s + (i % STAGES) * 2 * TL::BYTES, vs = ks + TL::BYTES;
        for (int e = tid; e < 64 * NCH; e += NT) {
            const int r = e / NCH, c = e % NCH;
            const int j = k0 + r;
            const bool ok = j <= last_key && j >= first_key && c < live;
            const size_t at = ok ? (head + j) * hd + c * 8 : 0;
            wg::cp_async16(ks + TL::offset(r, c), k + at, ok);
            wg::cp_async16(vs + TL::offset(r, c), v + at, ok);
        }
    };
    for (int t = 0; t < AHEAD; ++t) {  // one commit group a tile, Q with the first
        if (t == 0 || t < n_tiles) load_tile(t);
        wg::cp_async_commit();
    }

    // this thread's two rows of the warpgroup's 64: r_lo = 16 warp + rw, r_lo + 8
    int row_pos[2], row_first[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + rw + 8 * h;
        row_pos[h] = p0 + t0 + r % bq;
        row_first[h] = window > 0 ? row_pos[h] - window + 1 : 0;
    }
    const bool wg_idle = t0 >= T_;
    const int wg_last = p0 + min(t0 + bq, T_) - 1;  // last key any row of the warpgroup sees
    const int wg_first_row = p0 + t0;
    const float sc2 = softcap > 0.f ? scale / softcap : scale * LOG2E;
    const float cap2 = softcap * LOG2E;

    float m[2] = {CRABML_NEG_INF, CRABML_NEG_INF}, l[2] = {0.f, 0.f};
    constexpr int NB = HP / 64;  // 64-wide blocks of the output
    float o[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;

    const uint64_t q_desc = wg::desc128(q_s + wgi * TL::BYTES);

    for (int i = 0; i < n_tiles; ++i) {
        wg::cp_async_wait<AHEAD - 1>();  // tile i has landed (this thread's part)
        wg::fence_async_proxy();
        __syncthreads();  // everyone's part has, and tile i - 1 is no longer read
        if (i + AHEAD < n_tiles) load_tile(i + AHEAD);  // into tile i - 1's stage
        wg::cp_async_commit();

        const int k0 = (kt_begin + i) * BC;
        // tiles above this warpgroup's diagonal or left of its window: nothing to add
        if (wg_idle || k0 > wg_last || (window > 0 && k0 + BC - 1 < wg_first_row - window + 1))
            continue;
        const uint32_t ks = kv_s + (i % STAGES) * 2 * TL::BYTES, vs = ks + TL::BYTES;

        float s[32];
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk) {
            if (kk >= ksteps) break;  // lanes past hd: zeros, nothing to add
            const uint32_t step = (kk / 4) * 8192 + (kk % 4) * 32;
            wg::Mma<64>::ss<0>(s, q_desc + (step >> 4), wg::desc128(ks + step), kk != 0);
        }
        wg::commit();
        wg::wait<0>();
        wg::pin(s);

        // scores in the log2 domain: scale, cap, mask
#pragma unroll
        for (int e = 0; e < 32; ++e) {
            float x = s[e] * sc2;
            if (softcap > 0.f) x = cap2 * tanhf(x);
            s[e] = x;
        }
        const bool masked = k0 + BC - 1 > wg_first_row ||
                            (window > 0 && k0 < wg_last - window + 1);
        if (masked) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int col = k0 + 8 * (e / 4) + 2 * qd + (e & 1), h = (e >> 1) & 1;
                if (col > row_pos[h] || col < row_first[h]) s[e] = CRABML_NEG_INF;
            }
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = CRABML_NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[h], mx);
            alpha[h] = fast_exp2(m[h] - m_new);
            m[h] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
            const int h = (e >> 1) & 1;
            float p = fast_exp2(s[e] - m[h]);
            if (masked && s[e] == CRABML_NEG_INF) p = 0.f;  // also where the whole row is dead
            s[e] = p;
            rs[h] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];  // summed over the quad at the end
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 32; ++e) o[nb][e] *= alpha[(e >> 1) & 1];

        // P as the register A operand: accumulator pairs, 16 keys per k step
        uint32_t p[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int a = 0; a < 4; ++a)
                p[kk][a] = wg::pack_bf16(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1]);

#pragma unroll
        for (int nb = 0; nb < NB; ++nb) wg::pin(o[nb]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::pin(p[kk]);
        wg::fence();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wg::Mma<64>::rs<1>(o[nb], p[kk], wg::desc128(vs + nb * 8192 + kk * 2048), 1);
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) wg::pin(o[nb]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wg::pin(p[kk]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int r = 16 * warp + rw + 8 * h;
        const int g = r / bq, t = t0 + r % bq;
        if (t >= T_ || g >= G) continue;
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        bf16* dst = out + ((size_t)(b * T_ + t) * H + kv * G + g) * hd + 2 * qd;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (nb * 64 + 8 * j < hd)  // lanes past hd: V's zero padding
                    *reinterpret_cast<uint32_t*>(dst + nb * 64 + 8 * j) = wg::pack_bf16(
                        o[nb][4 * j + 2 * h] * inv, o[nb][4 * j + 2 * h + 1] * inv);
    }
}

template <int HP, int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* pos, void* out, int B,
              int KV, int S, int T_, int G, int hd, float scale, float softcap, int window,
              cudaStream_t stream) {
    constexpr size_t smem = (NWG + 2 * stages_of<HP>()) * Tile<HP>::BYTES + 1024;
    static_assert(smem <= 232448, "the ring and the Q tiles must fit a block's shared memory");
    cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<HP, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int bq = NWG * (BR / G);  // tokens per block
    dim3 grid((T_ + bq - 1) / bq, KV, B);
    flash_tc_kernel<HP, HD><<<grid, NT, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)pos, (bf16*)out, KV, S, T_, G,
        hd, scale, softcap, window);
    return crabml_launch_status();
}

}  // namespace

// q, out (B, T, KV*G, hd); k, v one layer of the cache (B, KV, S, hd); pos (B,)
// i32 = cache offset of each sequence's first new token (pos + T <= S). G is 1
// to 64; hd is any multiple of 8 up to 256. dtype 0 = bfloat16, 1 = float32.
// softcap 0 = no cap; window 0 = every earlier key.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               const void* pos, void* out, int B, int KV, int S, int T,
                               int G, int hd, float scale, float softcap, int window,
                               void* stream) {
    if (hd <= 0 || hd % 8 || hd > 256) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define CRABML_FLASH(L, ...) \
    L<__VA_ARGS__>(q, k, v, pos, out, B, KV, S, T, G, hd, scale, softcap, window, s)
    if (dtype == 0) {
        switch (hd) {  // the head dims with instances of their own: every count a constant
            case 16: return CRABML_FLASH(launch_tc, 64, 16);
            case 64: return CRABML_FLASH(launch_tc, 64, 64);
            case 80: return CRABML_FLASH(launch_tc, 128, 80);
            case 96: return CRABML_FLASH(launch_tc, 128, 96);
            case 128: return CRABML_FLASH(launch_tc, 128, 128);
            case 256: return CRABML_FLASH(launch_tc, 256, 256);
        }
        switch (tile_width(hd)) {
            case 64: return CRABML_FLASH(launch_tc, 64, 0);
            case 128: return CRABML_FLASH(launch_tc, 128, 0);
            default: return CRABML_FLASH(launch_tc, 256, 0);
        }
    }
    switch ((hd + 15) / 16) {  // output columns a thread
        case 1: return CRABML_FLASH(launch_f32, 1);
        case 2: return CRABML_FLASH(launch_f32, 2);
        case 3: return CRABML_FLASH(launch_f32, 3);
        case 4: return CRABML_FLASH(launch_f32, 4);
        case 5: return CRABML_FLASH(launch_f32, 5);
        case 6: return CRABML_FLASH(launch_f32, 6);
        case 7: return CRABML_FLASH(launch_f32, 7);
        case 8: return CRABML_FLASH(launch_f32, 8);
        case 9: return CRABML_FLASH(launch_f32, 9);
        case 10: return CRABML_FLASH(launch_f32, 10);
        case 11: return CRABML_FLASH(launch_f32, 11);
        case 12: return CRABML_FLASH(launch_f32, 12);
        case 13: return CRABML_FLASH(launch_f32, 13);
        case 14: return CRABML_FLASH(launch_f32, 14);
        case 15: return CRABML_FLASH(launch_f32, 15);
        default: return CRABML_FLASH(launch_f32, 16);
    }
#undef CRABML_FLASH
}
