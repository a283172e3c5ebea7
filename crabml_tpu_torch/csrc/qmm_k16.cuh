// The weight source of the two schemes with 2-bit planes and a scale per 16
// weights, Q2_K (qmm_q2k.cu) and Q3_K (qmm_q3k.cu), on qmm_ws.cuh's
// warp-specialized loop (`WsSource`), converting by `Conv`.
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
// half, and the whole hb row of its superblock; so the producer copies a
// superblock once, on its first step, for its four steps: per row its 64 qs
// bytes (and 32 hb bytes) and 16 scale bytes, a TMA box each, and d (and
// dmin) by the producer warp's lanes, into a superblock slot (11 KB for Q2_K,
// 15 KB for Q3_K). Every weight byte crosses from global memory once.
//
// Conversion (`Conv`), exactly the plain version's numbers: per row and k16
// step (one scale group) the thread forms dl = d * sc and, for Q2_K, ml =
// -(dmin * mn) in float32, both exact (an f16 value times at most six bits),
// the four scales of a step before its values. (The signed scale byte through
// the float bits 2^23 + 128 + sc, less 2^23 + 128, instead of I2F, which runs
// beside the float pipe, was 1-3% slower on the H100: tools/qmm_ablation.py
// ws.) Its qs word
// (and hb word) give four values with a shift, a mask (and an OR); PRMT puts
// a byte under 0x4B, the float 2^23 + val, and one FSUB leaves val (Q3_K: val -
// 4) exactly. Q2_K: one FFMA val * dl + ml rounds where the plain version's
// product (exact) and sum do; Q3_K: one FMUL, exact (3 x 17 bits). Then
// cvt.rn.bf16x2.f32 rounds two weights to a fragment register.
#pragma once

#include "qmm_ws.cuh"

namespace qk16 {

// The A fragments of step c (0..3) of a superblock, weight rows c_lo and
// c_lo + 8 (h = 0, 1): per row its d (and dmin) and the step's four scale
// bytes (`scw`), and the 4-byte words of its qs (and hb) bytes of the
// superblock at a byte offset (`qs_at(h, off)`, 0..63; `hb_at(h, off)`,
// 0..31). In each 8-wide group of k the thread takes the pair k = 2 qd, 2 qd +
// 1: bytes 2 (qd & 1), +1 of the group's words. k16 step kk of step c is
// scale group 4 c + kk.
template <bool Q3> struct Conv {
    // the value under a float's bits (2^23 + v), less `base`, exactly
    static __device__ __forceinline__ float val_f32(uint32_t u, float base) {
        return __fsub_rn(__uint_as_float(u), base);
    }

    template <class QsAt, class HbAt>
    static __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], int c, int qd,
                                                     const float (&dd)[2], const float (&dm)[2],
                                                     const uint32_t (&scw)[2], QsAt qs_at,
                                                     HbAt hb_at) {
        const int hh = c >> 1, p = c & 1;  // the step's half, and its 64 there
        // PRMT selectors: byte b of the word, two zero bytes, 0x4B
        const uint32_t b = 2u * (qd & 1);
        const uint32_t sel0 = 0x7440u | b, sel1 = 0x7440u | (b + 1);
        const float base = Q3 ? 8388612.0f : 8388608.0f;  // 2^23 (+ Q3_K's offset 4)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float dl[4], ml[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t sb = (scw[h] >> (8 * kk)) & 0xFFu;
                if (Q3) {
                    dl[kk] = __fmul_rn(dd[h], (float)(int8_t)sb);
                    ml[kk] = 0.0f;
                } else {
                    dl[kk] = __fmul_rn(dd[h], (float)(sb & 0xFu));
                    ml[kk] = -__fmul_rn(dm[h], (float)(sb >> 4));
                }
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const int shift = 2 * (2 * p + (kk >> 1));  // the 2-bit field of these 32 elements
                const int bit = 2 * c + (kk >> 1);          // Q3_K: their hb bit
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {  // k = 0..7, 8..15 of the k16 step
                    const int off = 16 * (kk & 1) + 8 * hf + 4 * (qd >> 1);
                    uint32_t v = (qs_at(h, 32 * hh + off) >> shift) & 0x03030303u;
                    if (Q3) {  // the third bit to bit 2 of each byte, in one shift
                        const uint32_t hw = hb_at(h, off);
                        v |= (bit >= 2 ? hw >> (bit - 2) : hw << (2 - bit)) & 0x04040404u;
                    }
                    const float v0 = val_f32(__byte_perm(v, 0x4B000000u, sel0), base);
                    const float v1 = val_f32(__byte_perm(v, 0x4B000000u, sel1), base);
                    a[kk][2 * hf + h] =
                        Q3 ? wg::pack_bf16(__fmul_rn(v0, dl[kk]), __fmul_rn(v1, dl[kk]))
                           : wg::pack_bf16(__fmaf_rn(v0, dl[kk], ml[kk]),
                                           __fmaf_rn(v1, dl[kk], ml[kk]));
                }
            }
        }
    }
};

// qmm_ws.cuh's source: a superblock staged by the producer, its qs, hb and
// scale bytes each a TMA box of their own plane (rows of 64, 32 and 16 bytes;
// the first two in the 64- and 32-byte swizzles, so that the eight rows a
// warp reads at once fall in distinct banks), d one float a row by cp.async
// (a row of d is K / 256 floats, which TMA takes only when its bytes are a
// multiple of 16). No step ring: the x ring alone holds each step.
template <bool Q3> struct WsSource {
    static constexpr int STEP_BYTES = 0;
    static constexpr int QS = 0, HB = QS + 128 * 64, SC = HB + (Q3 ? 128 * 32 : 0),
                         D = SC + 128 * 16, DMIN = D + 128 * 4;
    static constexpr int SB_BYTES = ((Q3 ? D : DMIN) + 128 * 4 + 1023) / 1024 * 1024;
    static constexpr int SB_STEPS = 4;
    // the TMA bytes, and each lane's cp.async of d (and dmin)
    static constexpr int SB_ARRIVALS = 33;
    static constexpr uint32_t STEP_TX = 0, SB_TX = (64 + (Q3 ? 32 : 0) + 16) * qws::W_ROWS;

    CUtensorMap qs, hb, sc;  // hb for Q3_K only
    const float* d;          // (rows, K / 256)
    const float* dmin;       // Q2_K
    int kd;                  // K / 256

    // The planes of n_rows weight rows (a stack: n_planes * N), in boxes of a block's rows.
    int encode(const void* qs_, const void* hb_, const void* sc_, const void* d_,
               const void* dmin_, int n_rows, int K) {
        d = (const float*)d_;
        dmin = (const float*)dmin_;
        kd = K / 256;
        int e = qws::map_2d(&qs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs_, K / 4, n_rows, 64,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_64B);
        if (!e && Q3)
            e = qws::map_2d(&hb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, hb_, K / 8, n_rows, 32,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_32B);
        if (!e)
            e = qws::map_2d(&sc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, sc_, K / 16, n_rows, 16,
                            qws::W_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
        return e;
    }

    __device__ __forceinline__ void load_step(uint32_t, uint32_t, int, int) const {}
    __device__ __forceinline__ void load_superblock(uint32_t dst, uint32_t bar, int sb,
                                                    int wrow) const {
        wg::tma_load_2d(dst + QS, &qs, bar, sb * 64, wrow);
        if (Q3) wg::tma_load_2d(dst + HB, &hb, bar, sb * 32, wrow);
        wg::tma_load_2d(dst + SC, &sc, bar, sb * 16, wrow);
    }
    // d (and dmin) of the `valid` rows that exist (the others are output
    // columns past N, never stored), a row every 32nd lane
    __device__ __forceinline__ void copy_superblock(uint32_t dst, uint32_t bar, int sb, int wrow,
                                                    int valid, int lane) const {
        for (int r = lane; r < valid; r += 32) {
            const size_t at = (size_t)(wrow + r) * kd + sb;
            wg::cp_async4(dst + D + 4 * r, d + at, true);
            if (!Q3) wg::cp_async4(dst + DMIN + 4 * r, dmin + at, true);
        }
        wg::cp_async_arrive(bar);
    }

    __device__ __forceinline__ void fragments(uint32_t (&a)[4][4], const uint8_t*,
                                              const uint8_t* slot, int c, int c_lo,
                                              int qd) const {
        const int r[2] = {c_lo, c_lo + 8};
        const float dd[2] = {*reinterpret_cast<const float*>(slot + D + 4 * r[0]),
                             *reinterpret_cast<const float*>(slot + D + 4 * r[1])};
        const float dm[2] = {Q3 ? 0.0f : *reinterpret_cast<const float*>(slot + DMIN + 4 * r[0]),
                             Q3 ? 0.0f : *reinterpret_cast<const float*>(slot + DMIN + 4 * r[1])};
        const uint32_t scw[2] = {*reinterpret_cast<const uint32_t*>(slot + SC + 16 * r[0] + 4 * c),
                                 *reinterpret_cast<const uint32_t*>(slot + SC + 16 * r[1] + 4 * c)};
        Conv<Q3>::fragments(
            a, c, qd, dd, dm, scw,
            [&](int h, int off) {  // 64-byte rows, 16-byte chunk j at j ^ ((row >> 1) & 3)
                const int row = r[h];
                return *reinterpret_cast<const uint32_t*>(
                    slot + QS + 64 * row + ((((off >> 4) ^ (row >> 1)) & 3) << 4) + (off & 15));
            },
            [&](int h, int off) {  // 32-byte rows, chunk j at j ^ ((row >> 2) & 1)
                const int row = r[h];
                return *reinterpret_cast<const uint32_t*>(
                    slot + HB + 32 * row + ((((off >> 4) ^ (row >> 2)) & 1) << 4) + (off & 15));
            });
    }
};

}  // namespace qk16
