// decode_core: the one loop of every decode-attention kernel of the port.
//
// GQA attention of T <= 8 new tokens of each sequence over its cached keys,
// at any number G of q heads per kv head (T*G query rows per kv head),
// with four variations that the callers pick:
//   - where key j of sequence b lives: a dense cache (B, KV, S, HD), or a
//     page pool (n_pages, KV, 128, HD) reached through a block table
//     (B, max_pages) of physical page numbers (DenseAddr / PagedAddr);
//   - the stored type: bfloat16, float32, or int8 with one float32 scale per
//     (token, kv head). The k scale multiplies the score and the v scale the
//     probability;
//   - softcap: s = cap * tanh(s / cap) before masking (0 = off);
//   - win: a row at position p sees keys p - win < j <= p (0 = off); keys
//     before the window of the earliest row of a block's row tile are never
//     read;
//   - an optional block of the step's own keys and values (B, KV, T, HD):
//     when given, the cache holds pos[b] keys and keys pos[b]..pos[b]+T-1 come
//     from the block; when null, the cache already holds them.
// Key j sits at absolute position j and row r = t*G + g (token t of the
// step, q head g of the kv group) at position pos[b] + t, so one test decides
// what a row sees: j <= pos[b] + t and j > pos[b] + t - win.
//
// Replaces crabml_tpu/ops/pallas/decode_attention.py::_kernel (dense and
// paged) and ::_kernel_fused (dense and paged).
//
// Bound: device memory bytes. Every live key and value is read once for ~2
// flops a byte, so the loop's job is to put enough bytes in flight and to
// keep the arithmetic of each key from bounding the loop.
//
// Design. The work unit is one CHUNK of 128 keys of one (kv head, sequence)
// for one ROW TILE of at most 16 query rows: in the paged form exactly one
// page, so a block reads one table entry. The T*G rows of a (kv head,
// sequence) split into RT = ceil(T*G / 16) tiles (one tile up to T*G = 16,
// four at the widest verify step, T = 8 at G = 7 or 8); tile i holds rows
// 16i .. 16i+15. The grid (KV*RT, B, n_chunks), x = kv*RT + tile, is planned
// on the host from the cache's capacity and the step's shape alone
// (ops/cuda/decode_attention.py::plan); a block whose chunk holds no key
// that a row of its tile sees exits after reading pos. So a long
// sequence is spread over as many blocks as it has pages, and every working
// block does the same <= 128 keys, whatever the batch's spread of lengths.
// Each tile is a block of its own and reads the chunk's K and V again: the
// tiles of one chunk are neighbours in x, so they run together and the
// second read mostly finds the chunk in L2. A block that holds every row
// (up to four m16 tiles) would read K and V once, but at head dim 256 a
// 16-row block already takes ~154 KB of shared memory (~218 KB with int8's
// staging area), of the 227 KB a block may have: the 16-row tile is kept
// for every head dim and dtype, and the partials and tickets are per
// (sequence, kv head, row tile).
// A block of NW warps:
//   1. copies its tile's query rows (zero rows up to 16), the chunk's K and V
//      into shared memory with 16-byte cp.async in two groups (K, then V, so
//      V is in flight while the scores are computed). Keys that no row sees,
//      before the window or past the live keys, are zero-filled, not loaded:
//      a probability of 0 times a NaN of a stale row would still be NaN. The
//      fused form takes the rows of the step's own keys from their block.
//      int8 is staged as is and converted exactly to the compute type in
//      shared memory;
//   2. scores S = Q K^T for the 16 rows and 128 keys. bfloat16: tensor cores,
//      mma.sync m16n8k16 (bf16 in, f32 out) with operands through ldmatrix,
//      16 keys a warp. float32: the same tile with FFMA, full precision;
//   3. softmax over the tile, a warp a row: scale, k scale, softcap, mask,
//      the row's max and sum in one reduction each; P = exp(s - max) with
//      the v scale folded in, rounded once to the compute type;
//   4. O = P V, tensor cores again (ldmatrix.trans for V) or FFMA, each warp
//      HD / NW output dims;
//   5. a sequence's only live chunk writes the output. Otherwise each chunk
//      writes (max, sum, O) to a partial slot and takes a ticket; the last
//      block of the (b, kv, tile) to arrive merges the chunks in chunk order and
//      resets the ticket. One launch, no atomics on values: deterministic.
// Tiles are rows of 16-byte chunks with chunk c of row r stored at c ^ (r % 8),
// so ldmatrix and the row-wise float4 reads are free of bank conflicts.
// Head dims 128 and 256: at 256 a bfloat16 block's tiles take ~154 KB (~218
// KB with int8's staging area), each warp holds 32 output dims, and a chunk's
// partial is twice as wide. Head dims 80
// and 96 (phi2, phi3; bfloat16 and float32) run on the 128 kernel's tiles:
// a tile row in shared memory is HP = 128 elements wide (Layout), while q,
// the cache, the step's block, int8's staging area, the output and the
// partials keep their HD stride. Only HD's chunks of a row are copied; the
// score product takes HD / 16 k steps (float32: HD / 4 four-wide steps), so
// it never reads a lane past HD, and the warps (float32: the threads) whose
// output dims lie past HD skip the second product. P, a row of 128 keys,
// fits the padded row as it does at 128. The bytes read are HD's; the
// arithmetic of the 128 kernel runs on 1 / (1.33 at 96, 1.6 at 80) live
// lanes.
// The compute type CT is float32 when q or the cache is float32, else
// bfloat16 (`compute_t`): q and a cache of different types, as the JAX
// kernel takes them (it computes in float32 whenever either is float32), are
// widened exactly as they are staged. A bfloat16 q under float32 is converted
// on its way into the Q tile; a cache of another type than CT (int8, or
// bfloat16 under float32) lands as stored in a staging area and is widened
// there. Where K and V tiles of their own would pass a block's shared memory
// (float32 at head dim 256: ~272 KB), one tile holds K and then V
// (Layout::ONE_TILE): V's copy starts once the scores have read K (for a
// staged cache, once K is widened, through the one staging area), so it
// overlaps the softmax rather than the score product, and O goes where the
// scores were. The chunk stays one page, so the grid, the partials and the
// block table's reads are those of every other form.
// Masked scores take -1e30 and weight 0, as in the JAX package; a row with
// no visible key gives 0.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"  // wg::smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace decode_core {

constexpr int PAGE = 128;   // rows of a page of the paged pool
constexpr int CHUNK = 128;  // keys a block takes: one page
constexpr int ROWS = 16;    // query rows of a row tile: rows 16i .. 16i+15 of T * G
constexpr int NW = 8;       // warps of a block: 16 keys each
constexpr int NT = NW * 32;
constexpr int KPL = CHUNK / 32;  // keys a lane in the softmax
static_assert(CHUNK == 16 * NW && PAGE % CHUNK == 0, "16 keys a warp; chunks tile a page");

// The row (in HD-element units) of the first key of chunk c of (b, kv).
struct DenseAddr {
    int S;
    __device__ __forceinline__ int cap() const { return S; }
    __device__ __forceinline__ size_t row0(int b, int kv, int KV, int c) const {
        return ((size_t)b * KV + kv) * S + (size_t)c * CHUNK;
    }
};
struct PagedAddr {
    const int* table;  // (B, max_pages) physical page of each logical chunk
    int max_pages;
    __device__ __forceinline__ int cap() const { return max_pages * PAGE; }
    __device__ __forceinline__ size_t row0(int b, int kv, int KV, int c) const {
        const int j0 = c * CHUNK;
        return ((size_t)table[(size_t)b * max_pages + j0 / PAGE] * KV + kv) * PAGE + j0 % PAGE;
    }
};

struct Params {
    const void* q;       // (B, T, KV*G, HD) in the q type
    const void* k;       // cache or pool, in the stored type
    const void* v;
    const float* ks;     // int8 only: one scale per stored row
    const float* vs;
    const void* k_new;   // (B, KV, T, HD) in the stored type, or null
    const void* v_new;
    const float* ks_new; // int8 with a new block: (B, KV, T)
    const float* vs_new;
    const int* pos;      // (B,) keys that precede the step's tokens, less pos_bias
    float* part_m;       // (B, KV*RT, n_chunks, TR) each chunk's row max
    float* part_l;       //                              and row sum
    float* part_acc;     // (B, KV*RT, n_chunks, TR, HD) and unnormalized output
    int* ticket;         // (B*KV*RT) zero between launches
    void* out;           // (B, T, KV*G, HD) in the q type
    int B, KV, T, G, n_chunks;  // RT = ceil(T*G / ROWS) row tiles, TR = min(T*G, ROWS)
    float scale, softcap;
    int win, pos_bias;   // pos_bias: -T when pos holds each sequence's length
};

// The keys of sequence b that the rows of a tile read, t0 the token of the
// tile's earliest row; host-side mirror: ops/cuda/decode_attention.py::block_keys.
//   cached keys: first <= j < n_cache, at the cache's rows
//   new keys:    max(first, n_cache) <= j < kend, at row j - n_cache of the block
//   live chunks: c0 <= c < c1
struct Keys {
    int p0, n_cache, kend, first, c0, c1;
};
__device__ __forceinline__ Keys keys_of(const Params& p, int b, int cap, int t0) {
    Keys r;
    r.p0 = p.pos[b] + p.pos_bias;
    const int n_keys = max(r.p0 + p.T, 0);
    const bool fused = p.k_new != nullptr;
    r.n_cache = min(fused ? min(max(r.p0, 0), n_keys) : n_keys, cap);
    r.kend = fused ? min(n_keys, r.n_cache + p.T) : r.n_cache;
    // the tile's earliest row sits at p0 + t0 and sees keys j > p0 + t0 - win
    r.first = p.win > 0 ? min(max(r.p0 + t0 + 1 - p.win, 0), r.kend) : 0;
    r.c0 = r.first / CHUNK;
    r.c1 = (r.kend + CHUNK - 1) / CHUNK;
    return r;
}

// A tile row's width in shared memory: HD rounded up to a multiple of 128
// (80 and 96 take 128), so that a row of P (128 keys) fits it and the
// 16-byte chunks of a row are a multiple of 8 for the swizzle.
template <int HD> __host__ __device__ constexpr int tile_width() { return (HD + 127) / 128 * 128; }

// The compute type: float32 when q or the cache is float32, else bfloat16
// (the tensor cores' type; an int8 cache under a bfloat16 q).
template <typename QT, typename KT>
using compute_t =
    std::conditional_t<std::is_same_v<QT, float> || std::is_same_v<KT, float>, float, bf16>;

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have (H100)

// Shared memory of one block, in bytes. A tile row is HP = tile_width<HD>()
// elements of the compute type CT.
template <typename CT, typename KT, int HD>
struct Layout {
    static constexpr int HP = tile_width<HD>();
    static constexpr int ROW = HP * (int)sizeof(CT);
    static constexpr int SP = HP + 8;                          // f32 pitch of S and O
    // a cache of another type than CT lands as stored and is widened in place
    static constexpr bool STAGED = sizeof(KT) != sizeof(CT);
    static constexpr int STAGE_BYTES = CHUNK * HD * (int)sizeof(KT);  // one tensor's chunk
    static constexpr int SMALL = ROWS * 4 * 2 + CHUNK * 4 * 2 + 16;   // M, L, KS, VS, FLAG
    static constexpr int TWO_TILES = ROWS * ROW + 2 * CHUNK * ROW + ROWS * SP * 4 + SMALL +
                                     (STAGED ? 2 * STAGE_BYTES : 0);
    // K and V in one tile, in turn, where tiles of their own do not fit
    static constexpr bool ONE_TILE = TWO_TILES > SMEM_LIMIT;
    static constexpr int Q = 0;                                // [ROWS][HD] CT; then P
    static constexpr int K = Q + ROWS * ROW;                   // [CHUNK][HD] CT; then O
    static constexpr int V = ONE_TILE ? K : K + CHUNK * ROW;   // [CHUNK][HD] CT
    static constexpr int S = V + CHUNK * ROW;                  // [ROWS][SP] f32 scores
    static constexpr int M = S + ROWS * SP * 4;                // [ROWS] row max
    static constexpr int L = M + ROWS * 4;                     // [ROWS] row sum
    static constexpr int KS = L + ROWS * 4;                    // [CHUNK] k scales (int8)
    static constexpr int VS = KS + CHUNK * 4;                  // [CHUNK] v scales (int8)
    static constexpr int FLAG = VS + CHUNK * 4;                // the merging block's flag
    static constexpr int STAGE = FLAG + 16;                    // [1 or 2][CHUNK][HD] as stored
    static constexpr int BYTES = STAGE + (STAGED ? (ONE_TILE ? 1 : 2) * STAGE_BYTES : 0);
    // O replaces K (dead after the scores), or S (dead after the softmax)
    static constexpr int O = ONE_TILE ? S : K;
    static_assert(ROWS * SP * 4 <= CHUNK * ROW, "O must fit in the K tile it replaces");
};

// byte offset of 16-byte chunk c of a tile row (row_bytes long)
__device__ __forceinline__ uint32_t at(int row, int c, int row_bytes) {
    return (uint32_t)(row * row_bytes + ((c ^ (row & 7)) << 4));
}
// byte offset of element e (of `size` bytes) of a tile row
__device__ __forceinline__ uint32_t elem(int row, int e, int row_bytes, int size) {
    return at(row, e * size / 16, row_bytes) + e * size % 16;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
// d += A (16x16, row) . B (16x8, col), bfloat16 in, float32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// *ticket += 1 at gpu scope, returning the old value; acq_rel orders the
// block's writes (made before a __syncthreads) before it and the merging
// block's reads after it
__device__ __forceinline__ int ticket_add(int* ticket) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
    return old;
}

// four float32 values stored as four consecutive values of the compute type
__device__ __forceinline__ void put4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(bf16* p, float a, float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
}

template <typename QT, typename KT, typename Addr, int HD>
__global__ void __launch_bounds__(NT)
chunk_kernel(Params p, Addr addr) {
    extern __shared__ __align__(128) uint8_t smem[];
    using CT = compute_t<QT, KT>;
    using LY = Layout<CT, KT, HD>;
    constexpr bool QUANT = sizeof(KT) == 1;
    constexpr bool STAGED = LY::STAGED, ONE_TILE = LY::ONE_TILE;
    constexpr bool TC = sizeof(CT) == 2;  // tensor cores for bfloat16, FFMA for float32
    constexpr int ROW = LY::ROW, SP = LY::SP;
    constexpr int HP = LY::HP;
    static_assert(HP % (16 * NW) == 0 || !TC, "HP / NW output dims a warp, in 16s");
    static_assert(HD % 16 == 0 && NT == 2 * CHUNK, "a thread a key and tensor");

    const int TG = p.T * p.G, RT = (TG + ROWS - 1) / ROWS, TR = min(TG, ROWS);
    const int kv = blockIdx.x / RT, tile = blockIdx.x % RT, b = blockIdx.y, c = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int KV = p.KV, T_ = p.T, G = p.G, H = KV * G;
    // the tile's rows: r0t + r for r < NR (every row index below is the tile's)
    const int r0t = tile * ROWS, NR = min(ROWS, TG - r0t);
    const Keys kr = keys_of(p, b, addr.cap(), r0t / G);
    const int n_live = max(kr.c1 - kr.c0, 0);
    QT* out = (QT*)p.out;

    if (c < kr.c0 || c >= kr.c1) {
        if (n_live == 0 && c == 0)  // no key at all: every row of the tile gives 0
            for (int i = tid; i < NR * HD / 4; i += NT) {
                const int r = r0t + i / (HD / 4), d = i % (HD / 4) * 4, t = r / G, g = r % G;
                put4(out + ((size_t)(b * T_ + t) * H + kv * G + g) * HD + d, 0.f, 0.f, 0.f, 0.f);
            }
        return;
    }

    uint8_t* sQ = smem + LY::Q;
    uint8_t* sK = smem + LY::K;
    uint8_t* sV = smem + LY::V;
    float* sS = reinterpret_cast<float*>(smem + LY::S);
    float* sM = reinterpret_cast<float*>(smem + LY::M);
    float* sL = reinterpret_cast<float*>(smem + LY::L);
    float* sKS = reinterpret_cast<float*>(smem + LY::KS);
    float* sVS = reinterpret_cast<float*>(smem + LY::VS);

    // ---- 1. stage Q, K, V -------------------------------------------------
    const int j0 = c * CHUNK;  // absolute position of the chunk's first key
    const size_t row0 = j0 < kr.n_cache ? addr.row0(b, kv, KV, c) : 0;  // one table entry
    const long long new0 = ((long long)b * KV + kv) * T_ - kr.n_cache;  // + j: row in the block
    // the row (in HD-element units) key i of the chunk is read from, or -1
    auto src_row = [&](int i, bool& cached) -> long long {
        const int j = j0 + i;
        cached = j < kr.n_cache;
        if (j < kr.first || j >= kr.kend) return -1;
        return cached ? (long long)(row0 + i) : (long long)(new0 + j);
    };
    const QT* q = (const QT*)p.q;
    if constexpr (std::is_same_v<QT, CT>) {
        constexpr int QC = HD * (int)sizeof(QT) / 16;  // 16-byte chunks of a q row (HD's)
        for (int i = tid; i < ROWS * QC; i += NT) {
            const int r = i / QC, cc = i % QC, t = (r0t + r) / G, g = (r0t + r) % G;
            const bool ok = r < NR;
            const QT* src =
                ok ? q + ((size_t)(b * T_ + t) * H + kv * G + g) * HD + cc * (16 / sizeof(QT)) : q;
            wg::cp_async16(wg::smem_u32(sQ + at(r, cc, ROW)), src, ok);
        }
    } else {  // a bfloat16 q under float32: widened on its way in, four values a step
        for (int i = tid; i < ROWS * HD / 4; i += NT) {
            const int r = i / (HD / 4), d = i % (HD / 4) * 4, t = (r0t + r) / G, g = (r0t + r) % G;
            float x4[4] = {0.f, 0.f, 0.f, 0.f};
            if (r < NR) {
                const QT* src = q + ((size_t)(b * T_ + t) * H + kv * G + g) * HD + d;
#pragma unroll
                for (int u = 0; u < 4; ++u) x4[u] = to_f32(src[u]);
            }
            put4(reinterpret_cast<CT*>(sQ + elem(r, d, ROW, sizeof(CT))), x4[0], x4[1], x4[2],
                 x4[3]);
        }
    }
    constexpr int KC = HD * (int)sizeof(KT) / 16;  // 16-byte chunks of a stored row
    auto stage = [&](const KT* cache, const KT* fresh, uint8_t* tile) {
        for (int i = tid; i < CHUNK * KC; i += NT) {
            const int r = i / KC, cc = i % KC;
            bool cached;
            const long long row = src_row(r, cached);
            const KT* src =
                row < 0 ? cache : (cached ? cache : fresh) + row * HD + cc * (16 / sizeof(KT));
            // a cache of another type lands unconverted in the staging area, row-major
            const uint32_t dst = STAGED ? wg::smem_u32(tile) + r * HD * (int)sizeof(KT) + cc * 16
                                        : wg::smem_u32(tile) + at(r, cc, ROW);
            wg::cp_async16(dst, src, row >= 0);
        }
    };
    uint8_t* k_raw = smem + LY::STAGE;
    uint8_t* v_raw = ONE_TILE ? k_raw : k_raw + LY::STAGE_BYTES;
    stage((const KT*)p.k, (const KT*)p.k_new, STAGED ? k_raw : sK);
    wg::cp_async_commit();
    if constexpr (!ONE_TILE) {
        stage((const KT*)p.v, (const KT*)p.v_new, STAGED ? v_raw : sV);
        wg::cp_async_commit();
    }
    if constexpr (QUANT) {  // one scale a key and tensor: plain loads, in flight beside the copies
        const int i = tid % CHUNK;
        const bool is_v = tid >= CHUNK;
        bool cached;
        const long long row = src_row(i, cached);
        const float* src = is_v ? (cached ? p.vs : p.vs_new) : (cached ? p.ks : p.ks_new);
        (is_v ? sVS : sKS)[i] = row < 0 ? 0.f : src[row];
    }
    // the stored type -> compute type, exactly: 16 bytes a step
    auto widen = [&](const uint8_t* raw, uint8_t* tile) {
        constexpr int VPC = 16 / (int)sizeof(KT);  // values of a 16-byte piece
        for (int i = tid; i < CHUNK * HD / VPC; i += NT) {
            const int r = i / (HD / VPC), e0 = i % (HD / VPC) * VPC;
            const int4 w = *reinterpret_cast<const int4*>(raw + (r * HD + e0) * (int)sizeof(KT));
            const KT* x = reinterpret_cast<const KT*>(&w);
#pragma unroll
            for (int u = 0; u < VPC; u += 4)
                put4(reinterpret_cast<CT*>(tile + elem(r, e0 + u, ROW, sizeof(CT))), to_f32(x[u]),
                     to_f32(x[u + 1]), to_f32(x[u + 2]), to_f32(x[u + 3]));
        }
    };

    if constexpr (ONE_TILE) {
        wg::cp_async_wait<0>();  // Q and K: V is not in flight yet
    } else {
        wg::cp_async_wait<1>();  // Q and K (this thread's copies)
    }
    __syncthreads();
    if constexpr (STAGED) {
        widen(k_raw, sK);
        __syncthreads();
    }
    if constexpr (ONE_TILE && STAGED) {  // K is widened: V's raw copy takes the staging area
        stage((const KT*)p.v, (const KT*)p.v_new, v_raw);
        wg::cp_async_commit();
    }

    // ---- 2. scores S = Q K^T ---------------------------------------------
    if constexpr (TC) {
        // warp w: keys 16w..16w+15 (two n8 tiles), all 16 rows, HD / 16 k steps
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4], bq[4];
            ldsm_x4(wg::smem_u32(sQ) + at(lane % 16, 2 * kk + lane / 16, ROW), a);
            ldsm_x4(wg::smem_u32(sK) + at(16 * warp + lane % 8 + (lane / 16) * 8,
                                      2 * kk + (lane / 8) % 2, ROW), bq);
            mma16816(acc[0], a, bq[0], bq[1]);
            mma16816(acc[1], a, bq[2], bq[3]);
        }
        const int g = lane / 4, col = 16 * warp + 2 * (lane % 4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            *reinterpret_cast<float2*>(sS + g * SP + col + 8 * nt) =
                make_float2(acc[nt][0], acc[nt][1]);
            *reinterpret_cast<float2*>(sS + (g + 8) * SP + col + 8 * nt) =
                make_float2(acc[nt][2], acc[nt][3]);
        }
    } else {
        // thread: key tid % 128 against 8 rows (rows 8..15 only when the tile has more than 8)
        const int j = tid % CHUNK, r0 = tid / CHUNK * 8;
        if (r0 < NR) {
            float s[8] = {};
            for (int cc = 0; cc < HD / 4; ++cc) {
                const float4 k4 = *reinterpret_cast<const float4*>(sK + at(j, cc, ROW));
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const float4 q4 = *reinterpret_cast<const float4*>(sQ + at(r0 + r, cc, ROW));
                    s[r] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
                }
            }
#pragma unroll
            for (int r = 0; r < 8; ++r) sS[(r0 + r) * SP + j] = s[r];
        }
    }
    __syncthreads();
    if constexpr (ONE_TILE && !STAGED) {  // the scores have read K: V takes its tile
        stage((const KT*)p.v, (const KT*)p.v_new, sV);
        wg::cp_async_commit();
    }

    // ---- 3. softmax over the tile, one warp a row --------------------------
    // P (in the compute type, the v scale folded in) replaces Q
    const int back = p.win > 0 ? p.win : 0x3fffffff;
    for (int r = warp; r < NR; r += NW) {
        const int rpos = kr.p0 + (r0t + r) / G;  // the row's position
        float s[KPL];
        bool live[KPL];
        float mx = CRABML_NEG_INF;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
            const int i = KPL * lane + e, j = j0 + i;
            float x = sS[r * SP + i] * p.scale;
            if constexpr (QUANT) x *= sKS[i];
            if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
            live[e] = j < kr.kend && j <= rpos && j > rpos - back;
            s[e] = live[e] ? x : CRABML_NEG_INF;
            mx = fmaxf(mx, s[e]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
            const int i = KPL * lane + e;
            float pr = live[e] ? __expf(s[e] - mx) : 0.f;
            sum += pr;
            if constexpr (QUANT) pr *= sVS[i];
            *reinterpret_cast<CT*>(sQ + elem(r, i, ROW, sizeof(CT))) = from_f32<CT>(pr);
        }
        sum = warp_sum(sum);
        if (lane == 0) { sM[r] = mx; sL[r] = sum; }
    }
    wg::cp_async_wait<0>();  // V
    __syncthreads();
    if constexpr (STAGED) {
        widen(v_raw, sV);
        __syncthreads();
    }

    // ---- 4. O = P V --------------------------------------------------------
    float* sO = reinterpret_cast<float*>(smem + LY::O);  // K or S is dead
    if constexpr (TC) {
        constexpr int DW = HP / NW;  // output dims of a warp, in 16s
        if (warp * DW < HD) {  // warps past HD: V's padding, never stored
            float acc[DW / 8][4] = {};
#pragma unroll
            for (int kk = 0; kk < CHUNK / 16; ++kk) {
                uint32_t a[4];
                ldsm_x4(wg::smem_u32(sQ) + at(lane % 16, 2 * kk + lane / 16, ROW), a);
#pragma unroll
                for (int dg = 0; dg < DW / 16; ++dg) {
                    uint32_t bv[4];
                    ldsm_x4_t(wg::smem_u32(sV) + at(16 * kk + lane % 16,
                                                     warp * DW / 8 + 2 * dg + lane / 16, ROW),
                              bv);
                    mma16816(acc[2 * dg], a, bv[0], bv[1]);
                    mma16816(acc[2 * dg + 1], a, bv[2], bv[3]);
                }
            }
            const int g = lane / 4, col = warp * DW + 2 * (lane % 4);
#pragma unroll
            for (int nt = 0; nt < DW / 8; ++nt) {
                *reinterpret_cast<float2*>(sO + g * SP + col + 8 * nt) =
                    make_float2(acc[nt][0], acc[nt][1]);
                *reinterpret_cast<float2*>(sO + (g + 8) * SP + col + 8 * nt) =
                    make_float2(acc[nt][2], acc[nt][3]);
            }
        }
    } else {
        // thread: dims 4 (tid % (HP/4)) .. +3 of rows r0, r0 + 1, ...
        constexpr int DC = HP / 4, RPT = ROWS * DC / NT;  // rows a thread
        const int cc = tid % DC, r0 = tid / DC * RPT;
        if (r0 < NR && 4 * cc < HD) {
            float acc[RPT][4] = {};
            for (int i = 0; i < CHUNK; ++i) {
                const float4 v4 = *reinterpret_cast<const float4*>(sV + at(i, cc, ROW));
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    const float pr = *reinterpret_cast<const float*>(sQ + elem(r0 + r, i, ROW, 4));
                    acc[r][0] += pr * v4.x; acc[r][1] += pr * v4.y;
                    acc[r][2] += pr * v4.z; acc[r][3] += pr * v4.w;
                }
            }
#pragma unroll
            for (int r = 0; r < RPT; ++r)
                *reinterpret_cast<float4*>(sO + (r0 + r) * SP + 4 * cc) =
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
    }
    __syncthreads();

    // ---- 5. write the output, or a partial and merge -----------------------
    auto out_at = [&](int r, int d) {  // r: a row of the tile
        return out + ((size_t)(b * T_ + (r0t + r) / G) * H + kv * G + (r0t + r) % G) * HD + d;
    };
    if (n_live == 1) {
        for (int i = tid; i < NR * HD / 4; i += NT) {
            const int r = i / (HD / 4), d = i % (HD / 4) * 4;
            const float4 o = *reinterpret_cast<const float4*>(sO + r * SP + d);
            const float inv = 1.f / fmaxf(sL[r], 1e-30f);
            put4(out_at(r, d), o.x * inv, o.y * inv, o.z * inv, o.w * inv);
        }
        return;
    }
    const size_t bk = ((size_t)b * KV + kv) * RT + tile;  // the (b, kv, tile)'s partials and ticket
    const size_t pbase = (bk * p.n_chunks + c) * TR;
    if (tid < NR) { p.part_m[pbase + tid] = sM[tid]; p.part_l[pbase + tid] = sL[tid]; }
    for (int i = tid; i < NR * HD / 4; i += NT) {
        const int r = i / (HD / 4), d = i % (HD / 4) * 4;
        *reinterpret_cast<float4*>(p.part_acc + (pbase + r) * HD + d) =
            *reinterpret_cast<const float4*>(sO + r * SP + d);
    }
    // the block's partial is written: the last of the (b, kv, tile)'s blocks to
    // take a ticket merges (acq_rel: it sees every earlier block's partial)
    __syncthreads();
    int* last = reinterpret_cast<int*>(smem + LY::FLAG);
    if (tid == 0) {
        *last = ticket_add(p.ticket + bk) == n_live - 1;
        if (*last) p.ticket[bk] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!*last) return;
    // Each thread merges its four output dims of one row over the live
    // chunks, in chunk order, MERGE chunks' loads in flight at a time, with
    // a running max (one pass).
    constexpr int MERGE = 8;
    const size_t cbase = bk * p.n_chunks;
    for (int i = tid; i < NR * HD / 4; i += NT) {
        const int r = i / (HD / 4), d = i % (HD / 4) * 4;
        float mx = CRABML_NEG_INF, sum = 0.f;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int cb = kr.c0; cb < kr.c1; cb += MERGE) {
            float mc[MERGE], lc[MERGE];
            float4 a[MERGE];
#pragma unroll
            for (int u = 0; u < MERGE; ++u) {  // past the last chunk: the last again, weight 0
                const size_t pr = (cbase + min(cb + u, kr.c1 - 1)) * TR + r;
                mc[u] = __ldcg(p.part_m + pr);
                lc[u] = __ldcg(p.part_l + pr);
                a[u] = __ldcg(reinterpret_cast<const float4*>(p.part_acc + pr * HD + d));
            }
            float m_new = mx;
#pragma unroll
            for (int u = 0; u < MERGE; ++u) m_new = fmaxf(m_new, mc[u]);
            const float alpha = __expf(mx - m_new);
            sum *= alpha; o.x *= alpha; o.y *= alpha; o.z *= alpha; o.w *= alpha;
#pragma unroll
            for (int u = 0; u < MERGE; ++u) {
                const float f = cb + u < kr.c1 ? __expf(mc[u] - m_new) : 0.f;
                sum += lc[u] * f;
                o.x += a[u].x * f; o.y += a[u].y * f; o.z += a[u].z * f; o.w += a[u].w * f;
            }
            mx = m_new;
        }
        const float inv = 1.f / fmaxf(sum, 1e-30f);
        put4(out_at(r, d), o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    }
}

template <typename QT, typename KT, typename Addr, int HD>
int launch(const Params& p, const Addr& addr, cudaStream_t stream) {
    constexpr int bytes = Layout<compute_t<QT, KT>, KT, HD>::BYTES;  // above 48 KB: opt in
    static_assert(bytes <= SMEM_LIMIT, "a block's tiles must fit its shared memory");
    const cudaError_t e = cudaFuncSetAttribute(chunk_kernel<QT, KT, Addr, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    const int RT = (p.T * p.G + ROWS - 1) / ROWS;
    chunk_kernel<QT, KT, Addr, HD><<<dim3(p.KV * RT, p.B, p.n_chunks), NT, bytes, stream>>>(p, addr);
    return crabml_launch_status();
}

template <typename Addr, typename QT, int HD>
int dispatch_k(const Params& p, const Addr& addr, int ktype, cudaStream_t s) {
    if (ktype == 0) return launch<QT, bf16, Addr, HD>(p, addr, s);
    if (ktype == 1) return launch<QT, float, Addr, HD>(p, addr, s);
    if (ktype == 2) return launch<QT, int8_t, Addr, HD>(p, addr, s);
    return (int)cudaErrorInvalidValue;
}

template <typename Addr, int HD>
int dispatch_hd(const Params& p, const Addr& addr, int qtype, int ktype, cudaStream_t s) {
    return qtype == 0 ? dispatch_k<Addr, bf16, HD>(p, addr, ktype, s)
                      : dispatch_k<Addr, float, HD>(p, addr, ktype, s);
}

// qtype 0 = bfloat16, 1 = float32; ktype (the stored type) 0 = bfloat16,
// 1 = float32, 2 = int8; hd 80, 96, 128 or 256: every pair at every head dim.
template <typename Addr>
int dispatch(const Params& p, const Addr& addr, int qtype, int ktype, int hd, cudaStream_t s) {
    if (qtype != 0 && qtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 80) return dispatch_hd<Addr, 80>(p, addr, qtype, ktype, s);
    if (hd == 96) return dispatch_hd<Addr, 96>(p, addr, qtype, ktype, s);
    if (hd == 128) return dispatch_hd<Addr, 128>(p, addr, qtype, ktype, s);
    if (hd == 256) return dispatch_hd<Addr, 256>(p, addr, qtype, ktype, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace decode_core
