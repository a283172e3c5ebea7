// The weight source of qmm_pipe.cuh's tile loop for the two schemes with
// 2-bit planes and a scale per 16 weights: Q2_K (qmm_q2k.cu) and Q3_K
// (qmm_q3k.cu).
//
//   Q2_K: w = val * (d * sc) - dmin * mn,  val 0..3, sc and mn the two
//         nibbles of ggml's scale byte (the `scm` plane), d and dmin float32
//         per superblock;
//   Q3_K: w = (val - 4) * (d * sc),        val 0..7, the third bit in the
//         `hb` plane, sc a signed 6-bit scale (the `sc` plane, -32 applied).
//
// The planes keep ggml's bit orders, which run per 128-element half (the 2-bit
// qs: bits 2 s, 2 s + 1 of byte j of the half's 32 bytes are element 32 s + j)
// and per superblock (Q3_K's hb: bit b of byte l of the superblock's 32 bytes
// is the third bit of element 32 b + l), and the scales stay as ggml stores
// them, a byte per 16 weights and a float32 d (and dmin) per 256: the kernel
// planes are 0.344 (Q2_K) and 0.453 (Q3_K) bytes a weight, where bf16 dsub
// and msub per 16 would be 0.5. A 64-deep k step needs all 32 qs bytes of its
// half, and the whole hb row of its superblock; so a superblock is staged
// once, on its first step, for its four steps: per row its 64 qs bytes (and
// 32 hb bytes), 16 scale bytes and d (and dmin), into a ring of its own beside
// the x ring (`EXTRA_BYTES`; the x ring's weight tile is empty). Every weight
// byte crosses from global memory once. A superblock is filled by the fetch of
// its first step f, after the barrier of step f - AHEAD, while steps up to f - 1
// may still be converted from the slot before: two slots (as qmm_q5k.cu's
// superblock-staged qh). The 16-byte copies of a superblock (640 for Q2_K, 896
// for Q3_K) are spread over the 256 threads, and its d (and dmin) are one
// 4-byte copy a row each.
//
// Rows of 112 (Q2_K) or 144 (Q3_K) bytes, 16 times an odd number, put the
// eight rows a warp reads at once in eight different banks, with no swizzle.
//
// Conversion, exactly the plain version's numbers: per row and k16 step (one
// scale group) the thread forms dl = d * sc and, for Q2_K, ml = -(dmin * mn)
// in float32, both exact (an f16 value times at most six bits). Its qs word
// (and hb word) give four values with a shift, a mask (and an OR); PRMT puts
// a byte under 0x4B, the float 2^23 + val, and one FSUB leaves val (Q3_K: val -
// 4) exactly. Q2_K: one FFMA val * dl + ml rounds where the plain version's
// product (exact) and sum do; Q3_K: one FMUL, exact (3 x 17 bits). Then
// cvt.rn.bf16x2.f32 rounds two weights to a fragment register.
#pragma once

#include "qmm_pipe.cuh"

namespace qk16 {

template <bool Q3> struct Source {
    static constexpr int KSC = 0;         // the scales apply to the weights, not to partial sums
    static constexpr int TILE_BYTES = 0;  // the weights live in the superblock ring below
    // a row's superblock: qs 64 | hb 32 (Q3_K) | scale bytes 16 | d (| dmin) f32
    static constexpr int HB = 64, SC = Q3 ? 96 : 64, D = SC + 16, DMIN = D + 4;
    static constexpr int ROW = Q3 ? 144 : 112;
    static constexpr int PIECES = Q3 ? 7 : 5;  // 16-byte copies a row: qs 4, hb 2, scales 1
    static constexpr int FLOATS = Q3 ? 1 : 2;  // 4-byte copies a row: d, dmin
    static constexpr int SB_STEPS = 4;         // k steps a superblock
    static constexpr int SLOTS = (qpipe::AHEAD - 1 + SB_STEPS - 1) / SB_STEPS + 1;
    static constexpr int SLOT_BYTES = qpipe::BW * ROW;
    static constexpr int EXTRA_BYTES = SLOTS * SLOT_BYTES;
    static constexpr int COPIES = qpipe::BW * PIECES;
    static constexpr int PER = (COPIES + qpipe::NT - 1) / qpipe::NT;
    static_assert(qpipe::BW * FLOATS <= qpipe::NT, "one 4-byte copy a thread at most");

    const uint8_t* qs;   // (N, K / 4)
    const uint8_t* hb;   // (N, K / 8), Q3_K
    const uint8_t* sc;   // (N, K / 16): Q2_K's scm, Q3_K's sc
    const float* d;      // (N, K / 256)
    const float* dmin;   // (N, K / 256), Q2_K

    // every plane of a stack: the values, the scale bytes and the per-superblock
    // floats (hb for Q3_K, dmin for Q2_K; the other is null and stays so)
    __device__ __forceinline__ void select_plane(int plane, int N, int K) {
        const size_t rows = (size_t)plane * N;
        qs += rows * (K / 4);
        if (Q3) hb += rows * (K / 8);
        sc += rows * (K / 16);
        d += rows * (K / 256);
        if (!Q3) dmin += rows * (K / 256);
    }

    // The thread's 16-byte pieces: e = tid + 256 i, row e / PIECES, piece e %
    // PIECES of the row (0-3 qs, then 4-5 hb for Q3_K, then the scale bytes).
    // A superblock at depth k0 begins k0 / 4 bytes into a row of qs, k0 / 8
    // into hb, k0 / 16 into the scales: the shift of each piece. Its 4-byte
    // copy: row tid / FLOATS, d or dmin.
    struct Stager {
        const uint8_t* src[PER];
        uint32_t dst[PER];
        uint8_t shift[PER];
        bool ok[PER], live[PER];
        const float* fsrc;
        uint32_t fdst;
        bool fok, flive;
        __device__ __forceinline__ void start(uint32_t, int k0) const {
            const int step = k0 / qpipe::BK;
            if (step % SB_STEPS) return;  // the superblock was staged with its first step
            const uint32_t slot = step / SB_STEPS % SLOTS * SLOT_BYTES;
#pragma unroll
            for (int i = 0; i < PER; ++i)
                if (live[i]) wg::cp_async16(dst[i] + slot, src[i] + (k0 >> shift[i]), ok[i]);
            if (flive) wg::cp_async4(fdst + slot, fsrc + k0 / 256, fok);
        }
    };
    __device__ __forceinline__ Stager stager(int n0, int N, int K, int tid, uint32_t extra) const {
        Stager s;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int e = tid + qpipe::NT * i;
            s.live[i] = e < COPIES;
            const int r = s.live[i] ? e / PIECES : 0, p = e % PIECES;
            s.ok[i] = s.live[i] && n0 + r < N;
            const size_t row = s.ok[i] ? n0 + r : 0;
            if (p < 4) {
                s.src[i] = qs + row * (K / 4) + p * 16;
                s.shift[i] = 2;
            } else if (Q3 && p < 6) {
                s.src[i] = hb + row * (K / 8) + (p - 4) * 16;
                s.shift[i] = 3;
            } else {
                s.src[i] = sc + row * (K / 16);
                s.shift[i] = 4;
            }
            s.dst[i] = extra + (uint32_t)(r * ROW + p * 16);
        }
        const int r = tid / FLOATS, f = tid % FLOATS;
        s.flive = r < qpipe::BW;
        s.fok = s.flive && n0 + r < N;
        s.fsrc = (f ? dmin : d) + (s.fok ? n0 + r : 0) * (size_t)(K / 256);
        s.fdst = extra + (uint32_t)(r * ROW + D + 4 * f);
        return s;
    }

    // the value under a float's bits (2^23 + v), less 2^23 + `off`, exactly
    static __device__ __forceinline__ float val_f32(uint32_t u, float base) {
        return __fsub_rn(__uint_as_float(u), base);
    }

    // Weight rows c_lo and c_lo + 8; in each 8-wide group of k the pair k = 2 qd,
    // 2 qd + 1: bytes 2 (qd & 1), +1 of the group's qs word (and hb word). k16
    // step kk of step c of the superblock is scale group 4 c + kk.
    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t*,
                                              const uint8_t* extra, int it, int c_lo,
                                              int qd) const {
        const uint8_t* slot = extra + it / SB_STEPS % SLOTS * SLOT_BYTES;
        const int c = it % SB_STEPS, hh = c >> 1, p = c & 1;  // the step's half, and its 64 there
        // PRMT selectors: byte b of the word, two zero bytes, 0x4B
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel0 = 0x7440u | b, sel1 = 0x7440u | (b + 1);
        const float base = Q3 ? 8388612.0f : 8388608.0f;  // 2^23 (+ Q3_K's offset 4)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint8_t* row = slot + (c_lo + 8 * h) * ROW;
            const float dd = *reinterpret_cast<const float*>(row + D);
            const float dm = Q3 ? 0.0f : *reinterpret_cast<const float*>(row + DMIN);
            const uint32_t scw = *reinterpret_cast<const uint32_t*>(row + SC + 4 * c);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t sb = (scw >> (8 * kk)) & 0xFFu;
                const float dl = Q3 ? __fmul_rn(dd, (float)(int8_t)sb) : __fmul_rn(dd, (float)(sb & 0xFu));
                const float ml = Q3 ? 0.0f : -__fmul_rn(dm, (float)(sb >> 4));
                const int shift = 2 * (2 * p + (kk >> 1));  // the 2-bit field of these 32 elements
                const int bit = 2 * c + (kk >> 1);          // Q3_K: their hb bit
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {  // k = 0..7, 8..15 of the k16 step
                    const int off = 16 * (kk & 1) + 8 * hf + 4 * (qd >> 1);
                    uint32_t v = (*reinterpret_cast<const uint32_t*>(row + 32 * hh + off) >> shift) &
                                 0x03030303u;
                    if (Q3)
                        v |= ((*reinterpret_cast<const uint32_t*>(row + HB + off) >> bit) &
                              0x01010101u) << 2;
                    const float v0 = val_f32(__byte_perm(v, 0x4B000000u, sel0), base);
                    const float v1 = val_f32(__byte_perm(v, 0x4B000000u, sel1), base);
                    a[kk][2 * hf + h] = Q3 ? wg::pack_bf16(__fmul_rn(v0, dl), __fmul_rn(v1, dl))
                                           : wg::pack_bf16(__fmaf_rn(v0, dl, ml),
                                                           __fmaf_rn(v1, dl, ml));
                }
            }
        }
    }
};

}  // namespace qk16
