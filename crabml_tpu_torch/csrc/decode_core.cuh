// decode_core: the one inner loop of every decode-attention kernel of the port.
//
// GQA attention of T <= 8 new tokens of each sequence over its cached keys,
// with four variations that the callers pick:
//   - where key j of sequence b lives: a dense cache (B, KV, S, 128), or a
//     page pool (n_pages, KV, 128, 128) reached through a block table
//     (B, max_pages) of physical page numbers (DenseAddr / PagedAddr);
//   - the stored type: bfloat16, float32, or int8 with one float32 scale per
//     (token, kv head). The k scale multiplies the score and the v scale the
//     probability, so the int8 payload is never turned into floats in memory;
//   - softcap: s = cap * tanh(s / cap) before masking (0 = off);
//   - win: a row at position p sees keys p - win < j <= p (0 = off), and the
//     key range starts at the earliest row's window start, so keys before the
//     window are never read;
//   - an optional block of the step's own keys and values (B, KV, T, 128):
//     when given, the cache holds pos[b] keys and keys pos[b]..pos[b]+T-1 come
//     from the block; when null, the cache already holds them.
// In every form key j sits at absolute position j and row r = t*G + g (token
// t of the step, q head g of the kv group) sits at position pos[b] + t, so one
// test decides what a row sees: j <= pos[b] + t, and j > pos[b] + t - win.
//
// Replaces crabml_tpu/ops/pallas/decode_attention.py::_kernel (dense and
// paged) and ::_kernel_fused (dense and paged). The work is bounded by device
// memory bytes: every live key and value is read once for ~2 flops an
// element. The TPU grid (B, KV) would give 64 blocks at 8 sequences x 8 kv
// heads and leave half of the H100's 132 SMs idle at short contexts, so the
// key range is also split across blocks (flash-decoding): grid (KV, B,
// nsplit), eight warps a block, each warp walking its keys with one coalesced
// row load per key (lane l holds head dims 4l..4l+3: 256 bytes a row in
// bfloat16, 128 in int8, always inside one page), up to eight keys' loads in
// flight at a time. Warps merge their (max, sum,
// acc) in shared memory in a fixed order, blocks write one partial each, and
// a second small kernel merges the splits, again in a fixed order: no
// atomics, so results are deterministic. Masked scores take -1e30 and weight
// 0, as in the JAX package; a row with no visible key gives 0.
#pragma once

#include "common.cuh"

namespace decode_core {

constexpr int HD = 128;   // head dim: 32 lanes x 4 elements
constexpr int NW = 8;     // warps per block
constexpr int PAGE = 128; // tokens per page of the paged pool

// Where key j of (b, kv) lives, in two steps so that a kernel can fetch many
// table entries before it needs the first: `page` (a load for the paged pool)
// and `row` (arithmetic): payload at row * 128, scale at row.
struct DenseAddr {
    int S;
    __device__ __forceinline__ int page(int b, int j) const { return b; }
    __device__ __forceinline__ size_t row(int page, int kv, int KV, int j) const {
        return ((size_t)page * KV + kv) * S + j;
    }
};
struct PagedAddr {
    const int* table;  // (B, max_pages) physical page of each logical chunk
    int max_pages;
    __device__ __forceinline__ int page(int b, int j) const {
        return table[(size_t)b * max_pages + j / PAGE];
    }
    __device__ __forceinline__ size_t row(int page, int kv, int KV, int j) const {
        return ((size_t)page * KV + kv) * PAGE + j % PAGE;
    }
};

struct Params {
    const void* q;       // (B, T, KV*G, 128) in the q type
    const void* k;       // cache or pool, in the stored type
    const void* v;
    const float* ks;     // int8 only: one scale per stored row
    const float* vs;
    const void* k_new;   // (B, KV, T, 128) in the stored type, or null
    const void* v_new;
    const float* ks_new; // int8 with a new block: (B, KV, T)
    const float* vs_new;
    const int* pos;      // (B,) keys that precede the step's tokens
    float* part_m;       // (B, KV, nsplit, R)
    float* part_l;
    float* part_acc;     // (B, KV, nsplit, R, 128)
    void* out;           // (B, T, KV*G, 128) in the q type
    int B, KV, T, G, nsplit;
    float scale, softcap;
    int win;
};

template <typename QT, typename KT, typename Addr, int R>
__global__ void __launch_bounds__(NW * 32)
split_kernel(Params p, Addr addr) {
    __shared__ float sm_m[NW][R];
    __shared__ float sm_l[NW][R];
    __shared__ float sm_acc[R][HD];
    __shared__ int sm_pos[R];

    constexpr bool QUANT = sizeof(KT) == 1;
    const int kv = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int KV = p.KV, T_ = p.T, G = p.G;
    const int TG = T_ * G;
    const int H = KV * G;
    const int p0 = p.pos[b];
    const int n_keys = max(p0 + T_, 0);
    const int n_cache = p.k_new ? min(max(p0, 0), n_keys) : n_keys;  // the rest is the new block
    // the earliest row sits at p0 and sees keys j > p0 - win
    const int first = p.win > 0 ? min(max(p0 + 1 - p.win, 0), n_keys) : 0;
    const int per = (n_keys - first + p.nsplit - 1) / p.nsplit;
    const int j0 = first + split * per;
    const int j1 = min(n_keys, j0 + per);

    const QT* q = (const QT*)p.q;
    const KT* k = (const KT*)p.k;
    const KT* v = (const KT*)p.v;
    const KT* k_new = (const KT*)p.k_new;
    const KT* v_new = (const KT*)p.v_new;

    // query rows, pre-scaled, four head dims per lane
    float qr[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < TG) {
            const int t = r / G, g = r % G;
            f = load4(q + ((size_t)(b * T_ + t) * H + kv * G + g) * HD + lane * 4);
        }
        qr[r][0] = f.x * p.scale; qr[r][1] = f.y * p.scale;
        qr[r][2] = f.z * p.scale; qr[r][3] = f.w * p.scale;
    }
    float m[R], l[R], acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = CRABML_NEG_INF; l[r] = 0.f;
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    }

    // row r sits at sm_pos[r] and sees keys sm_pos[r] - back <= j <= sm_pos[r];
    // a padding row (r >= TG) sits at -1 and sees none
    if (threadIdx.x < R) sm_pos[threadIdx.x] = threadIdx.x < TG ? p0 + threadIdx.x / G : -1;
    const int back = p.win > 0 ? p.win - 1 : 0x3fffffff;
    __syncthreads();

    // Each warp walks keys j0 + warp, + NW, ...; U of them at a time. At
    // decode sizes the walk is bound by the latency of two dependent loads a
    // key (the table entry, then the row), not by bytes, so the loads come
    // in batches: all U table entries, then all U rows and scales, and only
    // then the first use of a loaded value. A key past the range loads the
    // range's last key again and is skipped in the last loop.
    constexpr int U = R <= 4 ? 8 : (R <= 8 ? 4 : 2);
    for (int jb = j0 + warp; jb < j1; jb += NW * U) {
        decltype(load_raw4(k)) kraw[U], vraw[U];
        float ksj[U], vsj[U];
        int pg[U];
#pragma unroll
        for (int u = 0; u < U; ++u)  // a key of the new block reads an entry it does not use
            pg[u] = addr.page(b, max(min(min(jb + u * NW, j1 - 1), n_cache - 1), 0));
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = min(jb + u * NW, j1 - 1);
            const bool cached = j < n_cache;
            const size_t row = cached ? addr.row(pg[u], kv, KV, j)
                                      : ((size_t)b * KV + kv) * T_ + (j - n_cache);
            kraw[u] = load_raw4((cached ? k : k_new) + row * HD + lane * 4);
            vraw[u] = load_raw4((cached ? v : v_new) + row * HD + lane * 4);
            if (QUANT) {
                ksj[u] = (cached ? p.ks : p.ks_new)[row];
                vsj[u] = (cached ? p.vs : p.vs_new)[row];
            }
        }
        // No branch on a key or a row from here to the end of the batch:
        // masked scores are selected, not skipped, so the R rows' chains
        // (dot, five shuffle stages, exp, update) are independent
        // straight-line code that the compiler interleaves.
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = jb + u * NW;
            const float4 kj = to_float4(kraw[u]);
            float4 vj = to_float4(vraw[u]);
            if (QUANT) { vj.x *= vsj[u]; vj.y *= vsj[u]; vj.z *= vsj[u]; vj.w *= vsj[u]; }
            float s[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                s[r] = qr[r][0] * kj.x + qr[r][1] * kj.y + qr[r][2] * kj.z + qr[r][3] * kj.w;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
            if (p.softcap != 0.f) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (QUANT) s[r] *= ksj[u];
                    s[r] = p.softcap * tanhf(s[r] / p.softcap);
                }
            } else if (QUANT) {
#pragma unroll
                for (int r = 0; r < R; ++r) s[r] *= ksj[u];
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const bool live = j < j1 && j <= sm_pos[r] && j >= sm_pos[r] - back;
                const float sr = live ? s[r] : CRABML_NEG_INF;
                const float m_new = fmaxf(m[r], sr);
                const float alpha = __expf(m[r] - m_new);
                const float e = live ? __expf(sr - m_new) : 0.f;
                l[r] = l[r] * alpha + e;
                acc[r][0] = acc[r][0] * alpha + e * vj.x;
                acc[r][1] = acc[r][1] * alpha + e * vj.y;
                acc[r][2] = acc[r][2] * alpha + e * vj.z;
                acc[r][3] = acc[r][3] * alpha + e * vj.w;
                m[r] = m_new;
            }
        }
    }

    // merge the warps of this block in warp order
    if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) { sm_m[warp][r] = m[r]; sm_l[warp][r] = l[r]; }
    }
    for (int i = threadIdx.x; i < R * HD; i += NW * 32) (&sm_acc[0][0])[i] = 0.f;
    __syncthreads();
    float mb[R], fw[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        mb[r] = CRABML_NEG_INF;
        for (int w = 0; w < NW; ++w) mb[r] = fmaxf(mb[r], sm_m[w][r]);
        fw[r] = __expf(m[r] - mb[r]);
    }
    for (int w = 0; w < NW; ++w) {
        if (warp == w) {
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int e = 0; e < 4; ++e) sm_acc[r][lane * 4 + e] += acc[r][e] * fw[r];
        }
        __syncthreads();
    }
    const size_t pbase = (((size_t)b * KV + kv) * p.nsplit + split) * R;
    if (threadIdx.x < R) {
        const int r = threadIdx.x;
        float lb = 0.f;
        for (int w = 0; w < NW; ++w) lb += sm_l[w][r] * __expf(sm_m[w][r] - mb[r]);
        p.part_m[pbase + r] = mb[r];
        p.part_l[pbase + r] = lb;
    }
    for (int i = threadIdx.x; i < R * HD; i += NW * 32)
        p.part_acc[pbase * HD + i] = (&sm_acc[0][0])[i];
}

// merge the splits of one query row of one (kv, b): one thread per head dim
template <typename QT, int R>
__global__ void __launch_bounds__(HD)
combine_kernel(Params p) {
    const int kv = blockIdx.x, b = blockIdx.y, r = blockIdx.z, d = threadIdx.x;
    const int KV = p.KV, T_ = p.T, G = p.G, nsplit = p.nsplit;
    const int H = KV * G;
    const size_t base = ((size_t)b * KV + kv) * nsplit;
    float mx = CRABML_NEG_INF;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, p.part_m[(base + s) * R + r]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < nsplit; ++s) {
        const float f = __expf(p.part_m[(base + s) * R + r] - mx);
        lsum += p.part_l[(base + s) * R + r] * f;
        o += p.part_acc[((base + s) * R + r) * HD + d] * f;
    }
    const int t = r / G, g = r % G;
    ((QT*)p.out)[((size_t)(b * T_ + t) * H + kv * G + g) * HD + d] =
        from_f32<QT>(o / fmaxf(lsum, 1e-30f));
}

template <typename QT, typename KT, typename Addr, int R>
int launch(const Params& p, const Addr& addr, cudaStream_t stream) {
    split_kernel<QT, KT, Addr, R><<<dim3(p.KV, p.B, p.nsplit), NW * 32, 0, stream>>>(p, addr);
    int err = crabml_launch_status();
    if (err) return err;
    combine_kernel<QT, R><<<dim3(p.KV, p.B, p.T * p.G), HD, 0, stream>>>(p);
    return crabml_launch_status();
}

template <typename QT, typename KT, typename Addr>
int dispatch_rows(const Params& p, const Addr& addr, int R, cudaStream_t s) {
    if (R == 4) return launch<QT, KT, Addr, 4>(p, addr, s);
    if (R == 8) return launch<QT, KT, Addr, 8>(p, addr, s);
    if (R == 16) return launch<QT, KT, Addr, 16>(p, addr, s);
    return (int)cudaErrorInvalidValue;
}

// qtype 0 = bfloat16, 1 = float32; quant 0 = cache in the q type, 1 = int8
template <typename Addr>
int dispatch(const Params& p, const Addr& addr, int qtype, int quant, int R, cudaStream_t s) {
    if (qtype == 0)
        return quant ? dispatch_rows<bf16, int8_t, Addr>(p, addr, R, s)
                     : dispatch_rows<bf16, bf16, Addr>(p, addr, R, s);
    return quant ? dispatch_rows<float, int8_t, Addr>(p, addr, R, s)
                 : dispatch_rows<float, float, Addr>(p, addr, R, s);
}

}  // namespace decode_core
