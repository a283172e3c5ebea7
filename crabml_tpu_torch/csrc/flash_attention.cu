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
// float32 entry (flash_f32_kernel, below the bfloat16 one): both products on
// the tensor cores too, in three TF32 passes each (the TPU kernel takes them
// at Precision.HIGHEST, which its matrix unit reaches in several bfloat16
// passes); the design and its shared-memory plan are noted there.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BR = 64;  // rows (tokens x heads) per warpgroup
constexpr int BC = 64;  // keys per tile of the bfloat16 kernel
constexpr int NT = 256; // threads of a block of the bfloat16 kernel
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

// ---------------------------------------------------------------------------
// float32: three TF32 passes on wgmma
// ---------------------------------------------------------------------------
//
// Bound on the H100: as the bfloat16 entry's, how well the blocks keep the
// tensor cores fed; the work is six times that entry's (3 passes at half the
// rate). Hopper has no float32 tensor-core product and the CUDA cores' float32
// rate is 67 TFLOP/s, so each operand is split into two TF32 parts, v = hi +
// lo (wg::tf32_split: |v - hi - lo| <= 2^-22 |v|), and each product is taken
// as A_lo B_hi + A_hi B_lo + A_hi B_hi, the small terms first, into float32
// accumulators (the dropped A_lo B_lo is ~2^-22 of a product): 495 / 3 =
// 165 TFLOP/s. qmm_f32.cu does the same for the float32 matmul. Measured on
// the H100 the kernel runs at about a quarter of that bound at the 7B's
// 512-token chunks: the phases of a tile (split, S, softmax, P V) follow one
// another between barriers, and removing any one of them saves 15-30%
// (PERF.md).
//
// The rows and the visited key tiles are the bfloat16 entry's: a warpgroup
// owns 64 stacked rows (64 / G tokens x G heads, padding rows where G does not
// divide 64), key tiles run from the block's first window to its causal
// bound, keys outside them are zero-filled, and only tiles that cross the
// diagonal or the window's edge pay for the mask. Per tile of BC keys:
//   - S = Q K^T: Q is the register A operand, read from a float32 Q tile that
//     is staged once, [row][k % 4][k / 4] (padded so that a thread's float4
//     of two k8 steps' fragments is read without bank conflicts), and split in
//     registers; the fragments of QG k8 steps are issued as one commit group,
//     double-buffered, so the splitting overlaps the previous group's wgmmas.
//     K is the B operand, K-major (a row a key, 32 floats of the head dim in
//     each 128-byte swizzled row), hi and lo tiles.
//   - The key permutation: key t + 4u of each group of 8 is staged at K row
//     2t + u (key_slot), so S's column 2t + u, which thread quad t holds in
//     its accumulator pair, is key t + 4u: exactly the keys k = t and t + 4
//     that a TF32 A fragment holds in each k8 step. The scores, once
//     exponentiated and split, are P's A fragments in registers, in key
//     order; P never goes to shared memory. The masks use the permuted keys.
//   - O += P V: TF32 operands are K-major only, so V is staged as V^T (a row a
//     head-dim lane, 32 keys in each 128-byte swizzled row), hi and lo.
//     cp.async lands V's 16-byte chunks (4 lanes of one key) in K lo's area as
//     a staging tile: chunk (key j, lanes 4c..4c+3) at slot (j % 32) ^ (c % 8)
//     of a 512-byte run per (j / 32, c), so neither the copies nor the reads
//     that follow conflict on a bank. Each thread then reads a chunk, splits
//     it and stores its 4 lanes as 4 words of V^T hi and lo (the 32 lanes of
//     a warp, 32 keys, fill one 128-byte row: no conflicts). After a barrier K
//     is split in place: hi over the landed K, lo over the staging tile.
//   - The online softmax in registers as the bfloat16 entry's: exp2, log2 e
//     in the scale, the softcap, the quad's max; O rescaled in registers.
// The products' float32 accumulation on the tensor cores is not IEEE
// round-to-nearest (qmm_f32.cu); O carries up to 3 * 4,096 / 8 additions on
// the paths' longest rows, and the kernel is held within 1e-4 of max|out| of
// the exact plain version at 4,096 keys (chip_smoke.py).
//
// Shared memory per tile width HP and warpgroup count (F32Plan;
// ops/cuda/flash_attention.py's flash_f32_plan mirrors it and picks the
// warpgroups): the Q tile, then STAGES stages of four parts (K hi, K lo / V
// staging, V^T hi, V^T lo), each BC x HP floats. BC is 64 keys up to HP 128,
// 32 at 256; two stages where they fit in the 227 KB a block may have, else
// one:
//   HP  64: Q 25,600 a warpgroup, 2 stages of 65,536 bytes
//   HP 128: Q 41,984 a warpgroup, 1 stage of 131,072
//   HP 256: Q 74,752 (one warpgroup), 1 stage of 131,072
// With two stages tile i + 1 is copied while tile i is split and multiplied;
// with one, tile i + 1 is copied once S of tile i has read K, under the
// softmax and P V. Two warpgroups share each tile below HP 256 unless one
// warpgroup a block fills the card in one wave and two would not (the
// 189-token chunk). A block is always two warpgroups: with one warpgroup of
// rows, the other only copies and splits the tiles (8-10% faster on the H100
// at HP 256, at the 189-token chunk and at head dim 48 than one warpgroup
// alone; PERF.md).
// Registers: a thread holds HP / 2 output accumulators, BC / 2 scores and 16
// QG fragment registers (128 + 16 + 32 at HP 256).
template <int HP, int WGS> struct F32Plan {
    static constexpr int NWG = WGS;  // warpgroups with rows, 64 rows each
    static constexpr int BC = HP <= 128 ? 64 : 32;  // keys a tile
    static constexpr int NT = 256;  // with one warpgroup of rows, the other only copies and splits
    static constexpr int QG = HP <= 128 ? 4 : 2;  // k8 steps of S a commit group
    static constexpr int GP = HP / 4 + 8;         // a Q row's run of one k % 4, in floats
    static constexpr int RP = 4 * GP + 4;         // a Q row, in floats
    static constexpr int Q_BYTES = NWG * 64 * RP * 4;
    static constexpr int PART = BC * HP * 4;  // K hi, K lo, V^T hi or V^T lo
    static constexpr int STAGE = 4 * PART;
    static constexpr int STAGES = Q_BYTES + 2 * STAGE + 1024 <= 232448 ? 2 : 1;
    static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 1024;  // + slack to align
    static constexpr int NPV = HP <= 128 ? HP : 128;  // wgmma width of P V
    static_assert(Q_BYTES % 1024 == 0 && SMEM <= 232448, "a block's shared memory on the H100");
};

// K row of key j of a tile: key t + 4u of each group of 8 at row 2t + u
__device__ __forceinline__ int key_slot(int j) {
    return (j & ~7) | ((j & 3) << 1) | ((j >> 2) & 1);
}

template <int HP, int WGS>
__global__ void __launch_bounds__(F32Plan<HP, WGS>::NT, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ pos, float* __restrict__ out,
                 int KV, int S, int T_, int G, int hd, float scale, float softcap, int window) {
    using P = F32Plan<HP, WGS>;
    constexpr int NWG = P::NWG, KB = P::BC, TH = P::NT, STAGES = P::STAGES, QG = P::QG;
    constexpr int NCH = HP / 4;  // 16-byte chunks of a tile row
    constexpr int NS = KB / 2;   // scores a thread
    constexpr int NPV = P::NPV, NB = HP / NPV;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw_s = wg::smem_u32(smem_raw);
    const uint32_t base_s = (raw_s + 1023u) & ~1023u;
    uint8_t* base = smem_raw + (base_s - raw_s);
    float* qs = reinterpret_cast<float*>(base);
    const uint32_t kv_s = base_s + P::Q_BYTES;  // stage i: K hi, K lo, V^T hi, V^T lo
    uint8_t* kv_g = base + P::Q_BYTES;

    const int tid = threadIdx.x;
    const int wgi = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
    const int qd = lane % 4, rw = lane / 4;
    const int bq = BR / G;  // tokens per warpgroup; rows from bq * G on are padding
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int H = KV * G;
    const int p0 = pos[b];
    const int t0_blk = blockIdx.x * NWG * bq;
    const int t0 = t0_blk + wgi * bq;  // this warpgroup's first token
    const size_t head = ((size_t)b * KV + kvh) * S;

    const int last_key = p0 + min(t0_blk + NWG * bq, T_) - 1;  // causal bound of the block
    const int first_key = first_seen(p0 + t0_blk, window);
    const int kt_begin = first_key / KB;
    const int n_tiles = last_key / KB + 1 - kt_begin;

    // Q: row r = g * bq + (t - t0) of warpgroup r / 64, element d at
    // [r][d % 4][d / 4]; rows past T, padding rows and lanes past hd are zeros
    for (int i = tid; i < NWG * 64 * NCH; i += TH) {
        const int r = i / NCH, c = i % NCH;
        const int g = r % 64 / bq, t = t0_blk + r / 64 * bq + r % 64 % bq;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < T_ && g < G && 4 * c < hd)
            x = *reinterpret_cast<const float4*>(
                q + ((size_t)(b * T_ + t) * H + kvh * G + g) * hd + 4 * c);
        float* dst = qs + r * P::RP + c;
        dst[0] = x.x;
        dst[P::GP] = x.y;
        dst[2 * P::GP] = x.z;
        dst[3 * P::GP] = x.w;
    }

    // byte offsets in a stage: K's chunk c of row `row`; V's staged chunk (key
    // j, lanes 4c..); word (lane n, key j) of V^T
    auto k_at = [](int row, int c) -> uint32_t {
        return (uint32_t)((c >> 3) * (KB * 128)) + wg::swz128(row, c & 7);
    };
    auto v_staged_at = [](int j, int c) -> uint32_t {
        return (uint32_t)((((j >> 5) * NCH + c) << 9) + (((j & 31) ^ (c & 7)) << 4));
    };
    auto vt_at = [](int n, int j) -> uint32_t {
        return (uint32_t)((j >> 5) * (HP * 128)) + wg::swz128(n, (j & 31) >> 2) + (j & 3) * 4;
    };
    auto load_tile = [&](int i) {  // key tile kt_begin + i into stage i % STAGES
        const int k0 = (kt_begin + i) * KB;
        const uint32_t st = kv_s + (i % STAGES) * P::STAGE;
        for (int e = tid; e < KB * NCH; e += TH) {
            const int j = e / NCH, c = e % NCH;
            const int key = k0 + j;
            const bool ok = key <= last_key && key >= first_key && 4 * c < hd;
            const size_t at = ok ? (head + key) * hd + 4 * c : 0;
            wg::cp_async16(st + k_at(key_slot(j), c), k + at, ok);
            wg::cp_async16(st + P::PART + v_staged_at(j, c), v + at, ok);
        }
    };
    auto split_tile = [&](int i) {  // tile i's stage: V^T hi / lo, then K hi / lo in place
        uint8_t* st = kv_g + (i % STAGES) * P::STAGE;
        for (int e = tid; e < KB * NCH; e += TH) {
            const int j = e % KB, c = e / KB;  // a warp's lanes: 32 keys of one chunk
            const float4 x = *reinterpret_cast<const float4*>(st + P::PART + v_staged_at(j, c));
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                uint32_t hi, lo;
                wg::tf32_split(xs[u], hi, lo);
                const uint32_t at = vt_at(4 * c + u, j);
                *reinterpret_cast<uint32_t*>(st + 2 * P::PART + at) = hi;
                *reinterpret_cast<uint32_t*>(st + 3 * P::PART + at) = lo;
            }
        }
        __syncthreads();  // every thread has read V from the staging tile
        for (int e = tid; e < KB * NCH; e += TH) {
            const int j = e / NCH, c = e % NCH;
            const uint32_t at = k_at(key_slot(j), c);
            const float4 x = *reinterpret_cast<const float4*>(st + at);
            uint4 hi, lo;
            wg::tf32_split(x.x, hi.x, lo.x);
            wg::tf32_split(x.y, hi.y, lo.y);
            wg::tf32_split(x.z, hi.z, lo.z);
            wg::tf32_split(x.w, hi.w, lo.w);
            *reinterpret_cast<uint4*>(st + at) = hi;
            *reinterpret_cast<uint4*>(st + P::PART + at) = lo;
        }
        wg::fence_async_proxy();
    };
    load_tile(0);
    wg::cp_async_commit();

    // this thread's two rows of the warpgroup's 64: r_lo = 16 warp + rw, r_lo + 8
    int row_pos[2], row_first[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + rw + 8 * h;
        row_pos[h] = p0 + t0 + r % bq;
        row_first[h] = window > 0 ? row_pos[h] - window + 1 : 0;
    }
    const bool rows = wgi < NWG;  // else this warpgroup only copies and splits
    const bool wg_idle = !rows || t0 >= T_;
    const int wg_last = p0 + min(t0 + bq, T_) - 1;  // last key any row of the warpgroup sees
    const int wg_first_row = p0 + t0;
    const float sc2 = softcap > 0.f ? scale / softcap : scale * LOG2E;
    const float cap2 = softcap * LOG2E;
    const int ksteps = hd / 8;  // k8 steps of the score product
    // this thread's Q runs: rows r_lo and r_lo + 8, k % 4 == qd
    const float* qrow0 = qs + (wgi * 64 + 16 * warp + rw) * P::RP + qd * P::GP;
    const float* qrow1 = qrow0 + 8 * P::RP;

    float m[2] = {CRABML_NEG_INF, CRABML_NEG_INF}, l[2] = {0.f, 0.f};
    float o[NB][NPV / 2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < NPV / 2; ++i) o[nb][i] = 0.f;

    for (int i = 0; i < n_tiles; ++i) {
        wg::cp_async_wait<0>();  // tile i has landed (this thread's part)
        __syncthreads();  // everyone's part has; every thread is past tile i - 1 (and Q is staged)
        if (STAGES == 2 && i + 1 < n_tiles) load_tile(i + 1);  // into tile i - 1's stage
        wg::cp_async_commit();
        split_tile(i);
        __syncthreads();  // tile i's hi and lo parts are written

        const int k0 = (kt_begin + i) * KB;
        const uint32_t st = kv_s + (i % STAGES) * P::STAGE;
        // tiles above this warpgroup's diagonal or left of its window: nothing to add
        const bool skip =
            wg_idle || k0 > wg_last || (window > 0 && k0 + KB - 1 < wg_first_row - window + 1);
        float s[NS];
        if (!skip) {
            // S = Q K^T: a commit group of QG k8 steps, its fragments split
            // while the previous group runs
            uint32_t fh[2][QG][4], fl[2][QG][4];
#pragma unroll
            for (int grp = 0; grp < HP / 8 / QG; ++grp) {
                if (grp * QG >= ksteps) break;  // lanes past hd: nothing to add
                uint32_t(&gh)[QG][4] = fh[grp & 1];
                uint32_t(&gl)[QG][4] = fl[grp & 1];
#pragma unroll
                for (int x = 0; x < QG; x += 2) {
                    // index 2 kk .. 2 kk + 3 of the run: steps kk and kk + 1, k = 4 g + qd
                    const int kk = grp * QG + x;
                    const float4 a = *reinterpret_cast<const float4*>(qrow0 + 2 * kk);
                    const float4 c = *reinterpret_cast<const float4*>(qrow1 + 2 * kk);
                    wg::tf32_split(a.x, gh[x][0], gl[x][0]);
                    wg::tf32_split(c.x, gh[x][1], gl[x][1]);
                    wg::tf32_split(a.y, gh[x][2], gl[x][2]);
                    wg::tf32_split(c.y, gh[x][3], gl[x][3]);
                    wg::tf32_split(a.z, gh[x + 1][0], gl[x + 1][0]);
                    wg::tf32_split(c.z, gh[x + 1][1], gl[x + 1][1]);
                    wg::tf32_split(a.w, gh[x + 1][2], gl[x + 1][2]);
                    wg::tf32_split(c.w, gh[x + 1][3], gl[x + 1][3]);
                }
                wg::fence();
#pragma unroll
                for (int x = 0; x < QG; ++x) {
                    const int kk = grp * QG + x;
                    if (kk >= ksteps) break;
                    const uint32_t kb = st + (kk >> 2) * (KB * 128) + (kk & 3) * 32;
                    wg::Tf32<KB>::rs(s, gl[x], wg::desc128(kb), kk != 0);
                    wg::Tf32<KB>::rs(s, gh[x], wg::desc128(kb + P::PART), 1);
                    wg::Tf32<KB>::rs(s, gh[x], wg::desc128(kb), 1);
                }
                wg::commit();
                wg::wait<1>();  // the previous group is done: its fragments are free
#pragma unroll
                for (int x = 0; x < QG; ++x) {
                    wg::pin(fh[(grp + 1) & 1][x]);
                    wg::pin(fl[(grp + 1) & 1][x]);
                }
            }
            wg::wait<0>();
            wg::pin(s);
#pragma unroll
            for (int x = 0; x < QG; ++x) {
                wg::pin(fh[0][x]);
                wg::pin(fl[0][x]);
                wg::pin(fh[1][x]);
                wg::pin(fl[1][x]);
            }
        }
        if (STAGES == 1) {
            __syncthreads();  // every S has read K: the stage takes tile i + 1's copies
            if (i + 1 < n_tiles) load_tile(i + 1);
            wg::cp_async_commit();
        }
        if (skip) continue;

        // scores in the log2 domain: scale, cap, mask (score e is key
        // k0 + 8 (e / 4) + qd + 4 (e % 2) of row h = (e / 2) % 2)
#pragma unroll
        for (int e = 0; e < NS; ++e) {
            float x = s[e] * sc2;
            if (softcap > 0.f) x = cap2 * tanhf(x);
            s[e] = x;
        }
        const bool masked = k0 + KB - 1 > wg_first_row ||
                            (window > 0 && k0 < wg_last - window + 1);
        if (masked) {
#pragma unroll
            for (int e = 0; e < NS; ++e) {
                const int col = k0 + 8 * (e / 4) + qd + 4 * (e & 1), h = (e >> 1) & 1;
                if (col > row_pos[h] || col < row_first[h]) s[e] = CRABML_NEG_INF;
            }
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = CRABML_NEG_INF;
#pragma unroll
            for (int j = 0; j < NS / 4; ++j)
                mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[h], mx);
            alpha[h] = fast_exp2(m[h] - m_new);
            m[h] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < NS; ++e) {
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
            for (int e = 0; e < NPV / 2; ++e) o[nb][e] *= alpha[(e >> 1) & 1];

        // P as the register A operand, split: k8 step j holds keys 8 j + qd
        // (scores 4 j, 4 j + 2) and 8 j + qd + 4 (scores 4 j + 1, 4 j + 3)
        uint32_t ph[KB / 8][4], pl[KB / 8][4];
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
            wg::tf32_split(s[4 * j], ph[j][0], pl[j][0]);
            wg::tf32_split(s[4 * j + 2], ph[j][1], pl[j][1]);
            wg::tf32_split(s[4 * j + 1], ph[j][2], pl[j][2]);
            wg::tf32_split(s[4 * j + 3], ph[j][3], pl[j][3]);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) wg::pin(o[nb]);
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
            wg::pin(ph[j]);
            wg::pin(pl[j]);
        }
        wg::fence();
        const uint32_t vt = st + 2 * P::PART;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < KB / 8; ++j) {
                const uint32_t vb = vt + (j >> 2) * (HP * 128) + nb * (128 * 128) + (j & 3) * 32;
                wg::Tf32<NPV>::rs(o[nb], pl[j], wg::desc128(vb), 1);
                wg::Tf32<NPV>::rs(o[nb], ph[j], wg::desc128(vb + P::PART), 1);
                wg::Tf32<NPV>::rs(o[nb], ph[j], wg::desc128(vb), 1);
            }
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) wg::pin(o[nb]);
#pragma unroll
        for (int j = 0; j < KB / 8; ++j) {
            wg::pin(ph[j]);
            wg::pin(pl[j]);
        }
    }

    if (!rows) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int r = 16 * warp + rw + 8 * h;
        const int g = r / bq, t = t0 + r % bq;
        if (t >= T_ || g >= G) continue;
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        float* dst = out + ((size_t)(b * T_ + t) * H + kvh * G + g) * hd + 2 * qd;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < NPV / 8; ++j)
                if (nb * NPV + 8 * j < hd)  // lanes past hd: V's zero padding
                    *reinterpret_cast<float2*>(dst + nb * NPV + 8 * j) = make_float2(
                        o[nb][4 * j + 2 * h] * inv, o[nb][4 * j + 2 * h + 1] * inv);
    }
}

template <int HP, int WGS>
int launch_f32(const void* q, const void* k, const void* v, const void* pos, void* out, int B,
               int KV, int S, int T_, int G, int hd, float scale, float softcap, int window,
               cudaStream_t stream) {
    using P = F32Plan<HP, WGS>;
    cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<HP, WGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int bq = P::NWG * (BR / G);  // tokens per block
    dim3 grid((T_ + bq - 1) / bq, KV, B);
    flash_f32_kernel<HP, WGS><<<grid, P::NT, P::SMEM, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)pos, (float*)out, KV, S,
        T_, G, hd, scale, softcap, window);
    return crabml_launch_status();
}

template <int HP, int WGS> void f32_layout(int* plan) {
    using P = F32Plan<HP, WGS>;
    const int vals[6] = {HP, P::BC, P::NWG, P::STAGES, P::SMEM, P::NWG * 64};
    for (int i = 0; i < 6; ++i) plan[i] = vals[i];
}

}  // namespace

// q, out (B, T, KV*G, hd); k, v one layer of the cache (B, KV, S, hd); pos (B,)
// i32 = cache offset of each sequence's first new token (pos + T <= S). G is 1
// to 64; hd is any multiple of 8 up to 256. dtype 0 = bfloat16, 1 = float32.
// softcap 0 = no cap; window 0 = every earlier key. warpgroups: of a float32
// block (flash_f32_plan: 1, or 2 up to head dim 128); the bfloat16 entry has
// two and ignores it.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               const void* pos, void* out, int B, int KV, int S, int T,
                               int G, int hd, float scale, float softcap, int window,
                               int warpgroups, void* stream) {
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
    if (warpgroups != 1 && (warpgroups != 2 || hd > 128)) return (int)cudaErrorInvalidValue;
    switch (tile_width(hd) + warpgroups) {
        case 64 + 1: return CRABML_FLASH(launch_f32, 64, 1);
        case 64 + 2: return CRABML_FLASH(launch_f32, 64, 2);
        case 128 + 1: return CRABML_FLASH(launch_f32, 128, 1);
        case 128 + 2: return CRABML_FLASH(launch_f32, 128, 2);
        default: return CRABML_FLASH(launch_f32, 256, 1);
    }
#undef CRABML_FLASH
}

// The float32 kernel's plan at head dim hd with `warpgroups` a block (1, or 2
// below head dim 129; F32Plan): plan[0..5] = tile width, keys a tile,
// warpgroups, stages, dynamic shared memory bytes, rows a block. Read by the
// card's tests against ops/cuda/flash_attention.py::flash_f32_plan.
extern "C" int flash_f32_layout(int hd, int warpgroups, int* plan) {
    if (hd <= 0 || hd % 8 || hd > 256) return (int)cudaErrorInvalidValue;
    if (warpgroups != 1 && (warpgroups != 2 || hd > 128)) return (int)cudaErrorInvalidValue;
    switch (tile_width(hd) + warpgroups) {
        case 64 + 1: f32_layout<64, 1>(plan); break;
        case 64 + 2: f32_layout<64, 2>(plan); break;
        case 128 + 1: f32_layout<128, 1>(plan); break;
        case 128 + 2: f32_layout<128, 2>(plan); break;
        default: f32_layout<256, 1>(plan); break;
    }
    return 0;
}
