// qmm_w4a8: int8 activations x integer weights for decode rows (<= 16): the
// Q4_K form (4-bit weights, the headline's kernel), and the Q8_0, Q6_K, Q5_K,
// Q4_0, Q5_0, Q3_K and Q2_K forms described at the end of this note.
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_w4a8_kernel (launcher
// _run_w4a8, pallas_call at :740) together with its jnp quantize_activation
// (:254). A first small kernel quantizes the bf16 (or float32) activations per (row,
// 32-group) to symmetric int8 xq with scale dx = amax/127 and bsum sx =
// dx*sum(xq), with the same IEEE operations and half-to-even rounding as the
// plain version (ops/cuda/gemm_quant.py::quantize_activation), so the int8
// values agree bit for bit. Per group g the matmul kernel then computes
//
//   x.w|g = dsub_g * dx_g * (xq_g . val_g)  +  msub_g * sx_g
//
// with val the unsigned nibble 0..15, a valid signed byte for the tensor
// cores; this is algebraically what the TPU kernel's -128 centring computes.
// The groups are summed in float32 and rounded once to the output dtype.
//
// Bound on the H100: device-memory bytes. Every weight byte is used once for
// 2 * rows integer operations, far below the ridge at 1-16 rows, so the
// kernel must stream the packed planes (0.625 bytes a weight with the bf16
// scales) at the card's 3.35 TB/s. The earlier design (a warp per output
// column with __dp4a) read x again for every column: at 8 rows ~40 L1 loads
// and 64 dp4a per 16 weight bytes, bound by the load and issue pipes, and 8
// rows took 3.2x the time of one.
//
// Design:
//  * A block owns 16 output columns (the M of one mma tile) for all its rows.
//    Rows are the mma's N: one n8 tile for 1-8 rows, two for 9-16. The grid
//    is ceil(m/16) blocks (x one block row per row for the plane form).
//  * Integer group dots on the tensor cores, mma.sync m16n8k32 s8 x s8 ->
//    s32: one mma is one 32-element scale group for 16 columns x 8 rows,
//    exact. The port's nibble order (byte j of a 64-element chunk holds
//    element j low and 32+j high) feeds A with no permute: one 64-bit
//    shared load per column and chunk gives a thread its 8 bytes, masked for
//    the chunk's first group and shifted for its second. The k order inside a
//    group is free, since the dot is exact: a thread's k slots tig*4..+3 and
//    16+tig*4..+3 are the chunk's bytes tig*8..tig*8+7, and B (xq, row gid)
//    takes the same 8 bytes, so both are one 64-bit load.
//  * The 4 warps of a block split K by Q4_K superblocks (256 deep: the scale
//    planes' 16-byte copies hold 8 groups), warp w taking superblocks w, w+4,
//    ... Each warp streams its own superblocks through its own cp.async ring
//    of STAGES stages in shared memory (no block barrier in the loop): per
//    stage the 16 columns' nibbles (2 KB) and scales (512 B), and XR rows of
//    xq, dx, sx (320 B a row; XR = 1, 8 or 16, the rows the block has; the
//    mma's other rows are zeros in registers). x is thus read once for 16
//    columns: rows/8 bytes of x for each weight byte (2*rows before). Four
//    stages (three at 16 rows, where four would leave one block an SM): on
//    the H100 deeper rings, up to a warp's whole k range, were no faster.
//    Columns past m and rows past the real ones are zero-filled (source
//    size 0), never read and never written. The shared layouts are
//    XOR-swizzled by 16-byte piece so that the fragment loads are free of
//    bank conflicts.
//  * The epilogue of each group is acc += float(c) * (dsub*dx) + msub*sx in
//    float32. The warps' partial sums are added through shared memory in
//    warp order: no atomics, the result is the same at every call.
//  * The quantizer is chained by programmatic dependent launch: it runs
//    griddepcontrol.launch_dependents first, the matmul is launched with
//    cudaLaunchAttributeProgrammaticStreamSerialization, and its warps issue
//    their first weight stages before griddepcontrol.wait, the first point
//    where they read xq / dx / sx. Both launches stay on the caller's stream,
//    so a CUDA graph captures them.
//  * Per-row planes (the MoE decode path), every scheme: with plane_idx
//    given, row b multiplies weight plane plane_idx[b] of a stack (n_planes,
//    N, K). This is the TPU launcher's scalar-prefetched `layer` fed an
//    expert id, one id per row here: the launch puts one row on each
//    blockIdx.y with that row's plane as its base (wrow0, the plane's first
//    weight row, offsets every plane the trait reads: the values, dsub and
//    msub, and K16's scale bytes, d and dmin), and the index is read on the
//    device. Rows that share an expert read its plane once each.
// The Q8_0 and Q6_K forms share the quantizer (at the scheme's group: 32, or
// 16 for Q6_K, as the JAX package's scheme.gr), the ring, the warp split by
// superblock and the epilogue; a scheme trait (Q4K, Q80, Q6K below) gives the
// stage's layout and the step's integer dots:
//  * Q8_0: a stage holds the 16 columns' int8 weights of the superblock (4 KB,
//    256 bytes a column, the nibbles' swizzle) and 8 bf16 dsub a column; A is
//    the weights as they are, one m16n8k32 a 32-group, and the epilogue is
//    acc += c * (dsub * dx): no minimum, so no sx is staged.
//  * Q6_K: a stage holds the superblock's ql (128 bytes a column) and qh (64)
//    and 16 bf16 dsub a column, 3.5 KB. A is the 6-bit value 0..63, a valid
//    signed byte: in ggml's order a thread's 32-bit ql word and qh word give
//    four values of a 16-group with a shift, a mask and an OR, in the k order
//    that B takes from the same 4 bytes of xq. A group is 16 deep, so one
//    m16n8k16 s8 mma a group, and acc += c * (dsub * dx) + (-32 dsub) * sx
//    (the offset as a minimum, exact in float32). ql rows are swizzled by the
//    column modulo 8, qh rows by its half modulo 4: the 32-bit loads of a
//    warp's eight columns fall in distinct banks.
//  * Q5_K and Q4_0 are instances of one trait of 4-bit values in the port's
//    per-64 nibble order (Nib64; Q4_0's nibbles are reordered into it at
//    load, quant/qtensor.py), so A is built as Q4_K builds it. Q5_K adds a
//    fifth bit: bit b of byte l of a superblock's 32 qh bytes is the top bit
//    of element 32 b + l, so for group g the thread's 8 bytes tig*8..+7 of
//    the nibbles take bit g of qh bytes tig*8..+7, one 64-bit load a column
//    and stage (qh rows of 32 bytes after the nibble rows, 2.5 KB of weights
//    a stage), and the values 0..31 are still valid signed bytes. Q4_0 has
//    no minimum plane: one bf16 dsub a group (256 B a stage) and the offset
//    as a minimum, acc += c * (dsub * dx) + (-8 dsub) * sx, exact in float32
//    as Q6_K's -32. Q5_0 is the third instance (Q50): Q5_K's qh plane with
//    Q4_0's one dsub a group and the offset 16, acc += c * (dsub * dx) +
//    (-16 dsub) * sx, as exact (its planes are reordered at load into these
//    orders). Q4_1 and Q5_1 need no instance: reordered so, their planes are
//    Q4_K's and Q5_K's (dsub = d, msub = m), and the Q4K and Q5K forms run
//    them as they are; Q8_1's are Q8_0's.
//  * Q3_K and Q2_K are instances of one trait of 2-bit values with the
//    superblock's scales as ggml keeps them (K16): per 16-group one m16n8k16
//    s8 mma, as Q6_K. Their 2-bit qs plane has the order of Q6_K's qh (a
//    thread's 32-bit word q % 2 of its column's half gives four values of
//    group q at shift 2 (q / 2), in the k order that B takes from the same 4
//    bytes of xq), 64 bytes a column and stage with Q6_K's qh swizzle. Q3_K's
//    third bits are Q5_K's qh order (bit 4 hh + q / 2 of the same bytes of
//    the superblock's 32 hb bytes), OR-ed in at bit 2: values 0..7. A stage
//    holds the 16 scale bytes of each column and its float32 d (and Q2_K's
//    dmin), 320 / 384 B, and the group's scale is formed in float32, exactly:
//    dsub = d * sc and, for Q2_K, msub = -dmin * mn; for Q3_K the offset is
//    the minimum -4 * dsub, exact. Then acc += c * (dsub * dx) + msub * sx.
// The float32 forms (`_f32` entries; under float32 compute): the quantizer
// reads float32 x by the same operations, so the int8 codes are those of the
// JAX package's quantize_activation on the same x, and each trait reads
// float32 dsub / msub planes (the stage's scales twice as wide, two 16-byte
// loads where bfloat16 takes one: Sc8), the plane-per-row forms with them;
// Q3_K's and Q2_K's planes are the same under either compute dtype, so only
// their quantizer differs. Float32 scale planes write float32 out.
// A ring as deep as two blocks an SM allow, up to four stages (stages_of):
// Q6_K at 16 rows has two.
// The grid and the rows of x a stage holds come from
// ops/cuda/gemm_quant.py::w4a8_plan, which also mirrors the ring's depth and
// each warp's superblocks; its w4a8_block_reads mirrors each block's copies
// and stores, and the tier-1 tests check their coverage.
// ptxas (sm_90a, CUDA 12.8): 96 registers at XR = 1, 140 at 8, 192 at 16,
// no spills; 2 or 4 KB of static shared memory (the partial
// sums) beside the rings' dynamic 45 KB (XR = 1), 80 KB (8) or 90 KB (16).
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"  // wg::smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int WARPS = 8;  // quantizer: one warp per 32 elements

// one warp per 32 elements, lane i holds element i; the scale group is GR
// lanes (32, or 16 for Q6_K)
template <int GR, typename XT>
__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ dx,
                float* __restrict__ sx, int K) {
    // the matmul may start now: it reads xq / dx / sx only after its
    // griddepcontrol.wait, which waits for this whole grid
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int W32 = K / 32, G = K / GR;
    const int w32 = blockIdx.x * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.y;
    if (w32 >= W32) return;
    const float v = to_f32(x[(size_t)b * K + w32 * 32 + lane]);
    float amax = fabsf(v);
#pragma unroll
    for (int o = GR / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float d = amax / 127.0f;
    const float inv = d > 0.0f ? 1.0f / fmaxf(d, 1e-30f) : 0.0f;
    const float qf = fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
    xq[(size_t)b * K + w32 * 32 + lane] = (int8_t)qf;
    float qsum = qf;  // integer-valued: exact in float32
#pragma unroll
    for (int o = GR / 2; o > 0; o >>= 1) qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
    if (lane % GR == 0) {
        const int g = (w32 * 32 + lane) / GR;
        dx[(size_t)b * G + g] = d;
        sx[(size_t)b * G + g] = d * qsum;
    }
}

constexpr int MM_WARPS = 4;  // K split four ways inside a block
constexpr int COLS = 16;     // output columns of a block: the mma's M
constexpr int SB = 256;      // k depth of one ring stage: one superblock
constexpr int SMEM_PER_SM = 228 * 1024;  // H100; 1 KB of it reserved a block

// The schemes: a stage holds the 16 columns' weights of a superblock
// (W_BYTES) and their scales (S_BYTES), then XR rows of x, each its 256 int8
// values and XS bytes of scales (dx, and sx where the scheme has a minimum).
// ROWB: bytes a column of the first weight plane per superblock; MSUB: a
// minimum plane beside dsub; HAS_QH: a Q5_K fifth-bit plane; OFF: the value
// offset of a scheme without a minimum plane.
template <typename SC = bf16> struct Q4K {
    using Sc = SC;
    static constexpr int GR = 32, W_BYTES = COLS * SB / 2, S_BYTES = 2 * COLS * 8 * (int)sizeof(SC);
    static constexpr int ROWB = SB / 2, OFF = 0;
    static constexpr bool SX = true, MSUB = true, HAS_QH = false;
    static __host__ __device__ size_t q0_row(int K) { return K / 2; }
    static __host__ __device__ size_t q1_row(int) { return 0; }
};
template <typename SC = bf16> struct Q80 {
    using Sc = SC;
    static constexpr int GR = 32, W_BYTES = COLS * SB, S_BYTES = COLS * 8 * (int)sizeof(SC);
    static constexpr int ROWB = SB, OFF = 0;
    static constexpr bool SX = false, MSUB = false, HAS_QH = false;
    static __host__ __device__ size_t q0_row(int K) { return K; }
    static __host__ __device__ size_t q1_row(int) { return 0; }
};
// 4-bit values in the per-64 nibble order, with a fifth-bit plane (QH_) and
// a minimum plane (MIN_) or the offset OFF_
template <bool QH_, bool MIN_, int OFF_, typename SC = bf16> struct Nib64 {
    using Sc = SC;
    static constexpr int GR = 32, ROWB = SB / 2, OFF = OFF_;
    static constexpr int QH_ROWS = COLS * SB / 2;  // the qh rows follow the nibble rows
    static constexpr int W_BYTES = COLS * SB / 2 + (QH_ ? COLS * SB / 8 : 0);
    static constexpr int S_BYTES = (MIN_ ? 2 : 1) * COLS * 8 * (int)sizeof(SC);
    static constexpr bool SX = true, MSUB = MIN_, HAS_QH = QH_;
    static __host__ __device__ size_t q0_row(int K) { return K / 2; }
    static __host__ __device__ size_t q1_row(int K) { return QH_ ? K / 8 : 0; }
};
template <typename SC = bf16> using Q5K = Nib64<true, true, 0, SC>;
template <typename SC = bf16> using Q40 = Nib64<false, false, 8, SC>;
template <typename SC = bf16> using Q50 = Nib64<true, false, 16, SC>;
template <typename SC = bf16> struct Q6K {
    using Sc = SC;
    static constexpr int GR = 16, W_BYTES = COLS * SB * 3 / 4;
    static constexpr int S_BYTES = COLS * 16 * (int)sizeof(SC);
    static constexpr int QH = COLS * SB / 2;  // the qh rows follow the ql rows
    static constexpr bool SX = true;
    static __host__ __device__ size_t q0_row(int K) { return K / 2; }
    static __host__ __device__ size_t q1_row(int K) { return K / 4; }
};

// 2-bit values in ggml's order with a scale byte per 16 elements and float32
// superblock scales: Q3_K (a third-bit plane, the signed sc, offset 4) and
// Q2_K (the scm byte of sc and mn, a dmin). The qs rows, then Q3_K's hb rows;
// the scales region holds the 16 columns' scale bytes, then d, then dmin.
template <bool Q3_> struct K16 {
    using Sc = float;  // d and dmin; the scale bytes are the same under either compute dtype
    static constexpr bool Q3 = Q3_;
    static constexpr int GR = 16, HB = COLS * SB / 4;
    static constexpr int W_BYTES = COLS * SB / 4 + (Q3_ ? COLS * SB / 8 : 0);
    static constexpr int S_BYTES = COLS * 16 + (Q3_ ? 1 : 2) * COLS * 4;
    static constexpr bool SX = true;
    static __host__ __device__ size_t q0_row(int K) { return K / 4; }
    static __host__ __device__ size_t q1_row(int K) { return Q3_ ? K / 8 : K / 16; }
};
using Q3K = K16<true>;
using Q2K = K16<false>;
template <class S> constexpr bool is_k16 = false;
template <bool Q3> constexpr bool is_k16<K16<Q3>> = true;

template <class S, int XR> struct Stage {
    static constexpr int NG = SB / S::GR;  // scale groups a superblock
    static constexpr int XS = NG * 4 * (S::SX ? 2 : 1);
    static constexpr int W = 0, DS = S::W_BYTES, MS = DS + S::S_BYTES / 2;
    static constexpr int XQ = S::W_BYTES + S::S_BYTES;
    static constexpr int DX = XQ + XR * SB, SX = DX + XR * NG * 4;  // int8 x; dx; sx
    static constexpr int BYTES = XQ + XR * (SB + XS);
};

// a warp's ring depth: as many stages, up to four, as leave room for two
// blocks an SM (their rings, partial sums and reserved kilobyte)
template <class S, int XR> __host__ __device__ constexpr int stages_of() {
    constexpr int red = MM_WARPS * 4 * ((XR + 7) / 8) * 32 * 4;
    constexpr int bytes = Stage<S, XR>::BYTES;
    return 2 * (MM_WARPS * 4 * bytes + red + 1024) <= SMEM_PER_SM   ? 4
           : 2 * (MM_WARPS * 3 * bytes + red + 1024) <= SMEM_PER_SM ? 3
                                                                     : 2;
}

// 16-byte piece p of row r of a 128- or 256-byte row, XOR-swizzled: the
// 64-bit fragment loads of 4 neighbouring rows then fall in distinct banks
__device__ __forceinline__ int swz(int r, int p) { return p ^ ((r & 3) << 1); }
// the 32-byte rows of dx / sx: rows r and r + 4 in other pieces
__device__ __forceinline__ int swz_s(int r, int p) { return p ^ ((r >> 2) & 1); }
// Q6_K's 32-bit loads: 128-byte ql rows by the column modulo 8, 64-byte qh
// rows by its half modulo 4
__device__ __forceinline__ int swz_l(int r, int p) { return p ^ (r & 7); }
__device__ __forceinline__ int swz_h(int r, int p) { return p ^ ((r >> 1) & 3); }

template <typename T> __device__ __forceinline__ T lds(const uint8_t* ring, int off) {
    return *reinterpret_cast<const T*>(ring + off);
}

// d (16x8 s32) = a (16x32 s8, row) * b (32x8 s8, col), starting from zero
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(0));
}

// d (16x8 s32) = a (16x16 s8, row) * b (16x8 s8, col), starting from zero
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

// byte g (0..15) of a uint4
__device__ __forceinline__ uint32_t byte_at(const uint4& v, int g) {
    const uint32_t w = g < 4 ? v.x : g < 8 ? v.y : g < 12 ? v.z : v.w;
    return (w >> (8 * (g & 3))) & 0xFFu;
}

// bf16 element g (0..7) of 8 packed in a uint4, as float
__device__ __forceinline__ float bf16_at(const uint4& v, int g) {
    const uint32_t w = g < 2 ? v.x : g < 4 ? v.y : g < 6 ? v.z : v.w;
    return __uint_as_float((g & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// eight scales of a column (8 * sizeof(SC) bytes of a stage) in registers:
// one 16-byte load of bfloat16 scales, two of float32 ones
template <typename SC> struct Sc8;
template <> struct Sc8<bf16> {
    uint4 v = make_uint4(0, 0, 0, 0);
    __device__ __forceinline__ void load(const uint8_t* ring, int off) {
        v = *reinterpret_cast<const uint4*>(ring + off);
    }
    __device__ __forceinline__ float operator[](int g) const { return bf16_at(v, g); }
};
template <> struct Sc8<float> {
    uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    __device__ __forceinline__ void load(const uint8_t* ring, int off) {
        v[0] = *reinterpret_cast<const uint4*>(ring + off);
        v[1] = *reinterpret_cast<const uint4*>(ring + off + 16);
    }
    __device__ __forceinline__ float operator[](int g) const {
        const uint4& h = v[g >> 2];
        const uint32_t w = (g & 3) == 0 ? h.x : (g & 3) == 1 ? h.y : (g & 3) == 2 ? h.z : h.w;
        return __uint_as_float(w);
    }
};

struct Args {
    const int8_t* xq;
    const float* dx;
    const float* sx;
    const uint8_t* q0;  // Q4_K, Q5_K, Q4_0 and Q5_0 nibbles, Q8_0 int8, Q6_K ql
    const uint8_t* q1;  // Q6_K, Q5_K and Q5_0 qh, Q3_K hb, Q2_K scm
    const void* dsub;   // bfloat16 or float32 (the trait's Sc)
    const void* msub;   // Q4_K and Q5_K only
    void* out;
    const int* plane_idx;
    int B, N, K;
    const int8_t* sc;   // Q3_K
    const float* d;     // Q3_K and Q2_K, per superblock
    const float* dmin;  // Q2_K
};

template <class S, int XR, typename OutT>
__global__ void __launch_bounds__(MM_WARPS * 32)
qmm_w4a8_kernel(const Args args) {
    constexpr int NT = (XR + 7) / 8;  // mma n8 tiles
    constexpr int STAGES = stages_of<S, XR>();
    using ST = Stage<S, XR>;
    constexpr int NG = ST::NG;
    extern __shared__ __align__(128) uint8_t ring[];
    __shared__ float red[MM_WARPS][NT * 4][32];

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int N = args.N, K = args.K, G = K / S::GR, nsb = K / SB;
    const int col0 = blockIdx.x * COLS;
    // the plane form: one row on each blockIdx.y, that row's plane as base
    const int row0 = blockIdx.y;
    const int B = args.plane_idx ? 1 : args.B;
    const size_t wrow0 = (size_t)(args.plane_idx ? args.plane_idx[row0] : 0) * N;
    const uint8_t* q0 = args.q0 + wrow0 * S::q0_row(K);
    const uint8_t* q1 = args.q1 + wrow0 * S::q1_row(K);
    using SC = typename S::Sc;
    constexpr int SCB = (int)sizeof(SC);  // bytes a scale
    const SC* dsub = (const SC*)args.dsub + wrow0 * G;
    const SC* msub = (const SC*)args.msub + wrow0 * G;
    const int8_t* xq = args.xq + (size_t)row0 * K;
    const float* dx = args.dx + (size_t)row0 * G;
    const float* sx = args.sx + (size_t)row0 * G;

    const int n_steps = warp < nsb ? (nsb - 1 - warp) / MM_WARPS + 1 : 0;
    const uint32_t ring_u32 = wg::smem_u32(ring);
    const int base = warp * STAGES * ST::BYTES;  // this warp's ring, in bytes from `ring`

    // the 16 columns' weights and scales of the warp's step j into ring slot j % STAGES
    auto load_w = [&](int j) {
        const int sb = warp + j * MM_WARPS;
        const uint32_t st = ring_u32 + base + (j % STAGES) * ST::BYTES;
        if constexpr (is_k16<S>) {  // Q3_K, Q2_K: qs (hb), 16 scale bytes, d (dmin) a column
#pragma unroll
            for (int i = 0; i < 2; ++i) {  // 16 columns x 4 pieces of qs
                const int idx = i * 32 + lane, r = idx >> 2, p = idx & 3;
                const bool ok = col0 + r < N;
                const uint8_t* src = q0 + (size_t)(ok ? col0 + r : 0) * (K / 4) + sb * (SB / 4) + p * 16;
                wg::cp_async16(st + ST::W + r * 64 + swz_h(r, p) * 16, src, ok);
            }
            const int r = lane & 15;
            const bool ok = col0 + r < N;
            const size_t col = ok ? col0 + r : 0;
            if constexpr (S::Q3) {  // 16 columns x 2 pieces of hb, one a lane
                const int rh = lane >> 1, p = lane & 1;
                const bool okh = col0 + rh < N;
                const uint8_t* src = q1 + (size_t)(okh ? col0 + rh : 0) * (K / 8) + sb * (SB / 8) + p * 16;
                wg::cp_async16(st + S::HB + rh * 32 + swz_s(rh, p) * 16, src, okh);
                if (lane < 16)
                    wg::cp_async16(st + ST::DS + r * 16,
                                   reinterpret_cast<const uint8_t*>(args.sc) + (wrow0 + col) * (K / 16) + sb * 16, ok);
                else
                    wg::cp_async4(st + ST::DS + COLS * 16 + r * 4, args.d + (wrow0 + col) * nsb + sb, ok);
            } else {
                if (lane < 16)
                    wg::cp_async16(st + ST::DS + r * 16, q1 + col * (K / 16) + sb * 16, ok);
                wg::cp_async4(st + ST::DS + COLS * 16 + (lane >> 4) * COLS * 4 + r * 4,
                              (lane < 16 ? args.d : args.dmin) + (wrow0 + col) * nsb + sb, ok);
            }
        } else if constexpr (S::GR == 16) {  // Q6_K: ql, qh, 16 dsub a column
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // 16 columns x 8 pieces of ql
                const int idx = i * 32 + lane, r = idx >> 3, p = idx & 7;
                const bool ok = col0 + r < N;
                const uint8_t* src = q0 + (size_t)(ok ? col0 + r : 0) * (K / 2) + sb * (SB / 2) + p * 16;
                wg::cp_async16(st + ST::W + r * 128 + swz_l(r, p) * 16, src, ok);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {  // 16 columns x 4 pieces of qh
                const int idx = i * 32 + lane, r = idx >> 2, p = idx & 3;
                const bool ok = col0 + r < N;
                const uint8_t* src = q1 + (size_t)(ok ? col0 + r : 0) * (K / 4) + sb * (SB / 4) + p * 16;
                wg::cp_async16(st + S::QH + r * 64 + swz_h(r, p) * 16, src, ok);
            }
            constexpr int PC = 16 * SCB / 16;  // 16-byte pieces of a column's 16 scales
#pragma unroll
            for (int i = 0; i < COLS * PC / 32; ++i) {
                const int idx = i * 32 + lane, r = idx / PC, p = idx % PC;
                const bool ok = col0 + r < N;
                const uint8_t* src = reinterpret_cast<const uint8_t*>(
                    dsub + (size_t)(ok ? col0 + r : 0) * G + sb * NG) + p * 16;
                wg::cp_async16(st + ST::DS + r * 16 * SCB + p * 16, src, ok);
            }
        } else {
            constexpr int ROWB = S::ROWB;  // 128 (nibbles) or 256 (Q8_0) bytes a column
            constexpr int PIECES = ROWB / 16;
#pragma unroll
            for (int i = 0; i < COLS * PIECES / 32; ++i) {  // 16 columns x PIECES pieces
                const int idx = i * 32 + lane, r = idx / PIECES, p = idx % PIECES;
                const bool ok = col0 + r < N;
                const uint8_t* src =
                    q0 + (size_t)(ok ? col0 + r : 0) * S::q0_row(K) + sb * ROWB + p * 16;
                wg::cp_async16(st + ST::W + r * ROWB + swz(r, p) * 16, src, ok);
            }
            if constexpr (S::HAS_QH) {  // Q5_K, Q5_0: 16 columns x 2 pieces of qh, one a lane
                const int r = lane >> 1, p = lane & 1;
                const bool ok = col0 + r < N;
                const uint8_t* src = q1 + (size_t)(ok ? col0 + r : 0) * (K / 8) + sb * (SB / 8) + p * 16;
                wg::cp_async16(st + S::QH_ROWS + r * 32 + swz_s(r, p) * 16, src, ok);
            }
            // dsub (and msub where the scheme has one): 8 a column, in PC pieces
            constexpr int PC = 8 * SCB / 16, NPL = S::MSUB ? 2 : 1;
#pragma unroll
            for (int i = 0; i < (NPL * COLS * PC + 31) / 32; ++i) {
                const int idx = i * 32 + lane, pl = idx / (COLS * PC), r = idx % (COLS * PC) / PC,
                          p = idx % PC;
                const bool ok = col0 + r < N;
                const uint8_t* src = reinterpret_cast<const uint8_t*>(
                    (pl ? msub : dsub) + (size_t)(ok ? col0 + r : 0) * G + sb * 8) + p * 16;
                if (idx < NPL * COLS * PC)
                    wg::cp_async16(st + (pl ? ST::MS : ST::DS) + r * 8 * SCB + p * 16, src, ok);
            }
        }
    };
    // the rows' xq, dx (and sx) of step j
    auto load_x = [&](int j) {
        const int sb = warp + j * MM_WARPS;
        const uint32_t st = ring_u32 + base + (j % STAGES) * ST::BYTES;
#pragma unroll
        for (int i = 0; i < (XR * 16 + 31) / 32; ++i) {  // XR rows x 16 pieces
            const int idx = i * 32 + lane, r = idx >> 4, p = idx & 15;
            const bool ok = r < B;
            const int8_t* src = xq + (size_t)(ok ? r : 0) * K + sb * SB + p * 16;
            if (idx < XR * 16) wg::cp_async16(st + ST::XQ + r * SB + swz(r, p) * 16, src, ok);
        }
        constexpr int PX = NG / 4;  // 16-byte pieces of a row's dx (and of its sx)
        constexpr int NA = S::SX ? 2 : 1;
#pragma unroll
        for (int i = 0; i < (XR * PX * NA + 31) / 32; ++i) {  // XR rows x PX pieces, dx then sx
            const int idx = i * 32 + lane, half = idx / (PX * XR), jj = idx % (PX * XR);
            const int r = jj / PX, p = jj % PX;
            const bool ok = r < B;
            const float* src = (half ? sx : dx) + (size_t)(ok ? r : 0) * G + sb * NG + p * 4;
            const int piece = PX == 2 ? swz_s(r, p) : p;
            if (idx < XR * PX * NA)
                wg::cp_async16(st + (half ? ST::SX : ST::DX) + r * NG * 4 + piece * 16, src, ok);
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

    // the weights do not depend on the quantizer: start them before waiting for it
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j)
        if (j < n_steps) load_w(j);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < n_steps) load_x(j);
        wg::cp_async_commit();  // group j (group 0 also holds the prologue's weights)
    }

    for (int s = 0; s < n_steps; ++s) {
        wg::cp_async_wait<STAGES - 2>();  // this lane's copies of step s have landed
        __syncwarp();                      // ... and every lane's; slot (s-1) is free
        const int nxt = s + STAGES - 1;
        if (nxt < n_steps) {
            load_w(nxt);
            load_x(nxt);
        }
        wg::cp_async_commit();
        const int st = base + (s % STAGES) * ST::BYTES;
        if constexpr (is_k16<S>) {
            // Q3_K, Q2_K: a 128-element half at a time; its 16-groups q = 0..7 take
            // the qs word q % 2 at shift 2 (q / 2) (and Q3_K's hb word q % 2 at bit
            // 4 hh + q / 2), the scale byte 8 hh + q
            const uint4 sA = lds<uint4>(ring, st + ST::DS + gid * 16);
            const uint4 sB = lds<uint4>(ring, st + ST::DS + (gid + 8) * 16);
            const float dA = lds<float>(ring, st + ST::DS + COLS * 16 + gid * 4);
            const float dB = lds<float>(ring, st + ST::DS + COLS * 16 + (gid + 8) * 4);
            float nA = 0.0f, nB = 0.0f;  // Q2_K's dmin
            uint32_t hw[2][2] = {{0u, 0u}, {0u, 0u}};
            if constexpr (S::Q3) {
#pragma unroll
                for (int c = 0; c < 2; ++c)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int r = gid + 8 * c;
                        hw[c][j] = lds<uint32_t>(ring, st + S::HB + r * 32 + swz_s(r, j) * 16 + tig * 4);
                    }
            } else {
                nA = lds<float>(ring, st + ST::DS + COLS * 20 + gid * 4);
                nB = lds<float>(ring, st + ST::DS + COLS * 20 + (gid + 8) * 4);
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                uint32_t qw[2][2];
#pragma unroll
                for (int c = 0; c < 2; ++c)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int r = gid + 8 * c;
                        qw[c][j] = lds<uint32_t>(ring, st + ST::W + r * 64 + swz_h(r, hh * 2 + j) * 16 + tig * 4);
                    }
#pragma unroll
                for (int qq = 0; qq < 2; ++qq) {  // groups 4 qq .. 4 qq + 3 of the half
                    float dxv[NT][2][4], sxv[NT][2][4];  // [tile][row tig*2 + i][group]
#pragma unroll
                    for (int t = 0; t < NT; ++t)
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            const int r = t * 8 + tig * 2 + i;
                            const int off = st + r * NG * 4 + (hh * 2 + qq) * 16;
                            const bool ok = r < XR && (XR > 1 || i == 0);
                            const uint4 d = ok ? lds<uint4>(ring, off + ST::DX) : make_uint4(0, 0, 0, 0);
                            const uint4 q = ok ? lds<uint4>(ring, off + ST::SX) : make_uint4(0, 0, 0, 0);
                            dxv[t][i][0] = __uint_as_float(d.x);
                            dxv[t][i][1] = __uint_as_float(d.y);
                            dxv[t][i][2] = __uint_as_float(d.z);
                            dxv[t][i][3] = __uint_as_float(d.w);
                            sxv[t][i][0] = __uint_as_float(q.x);
                            sxv[t][i][1] = __uint_as_float(q.y);
                            sxv[t][i][2] = __uint_as_float(q.z);
                            sxv[t][i][3] = __uint_as_float(q.w);
                        }
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int q = 4 * qq + j, g = 8 * hh + q, hs = 2 * (q >> 1);
                        uint32_t a0 = (qw[0][q & 1] >> hs) & 0x03030303u;
                        uint32_t a1 = (qw[1][q & 1] >> hs) & 0x03030303u;
                        const uint32_t cA = byte_at(sA, g), cB = byte_at(sB, g);
                        float da, db, ma, mb;
                        if constexpr (S::Q3) {
                            const int hbit = 4 * hh + (q >> 1);
                            a0 |= ((hw[0][q & 1] >> hbit) & 0x01010101u) << 2;
                            a1 |= ((hw[1][q & 1] >> hbit) & 0x01010101u) << 2;
                            da = dA * (float)(int8_t)cA;
                            db = dB * (float)(int8_t)cB;
                            ma = -4.0f * da;  // the offset as a minimum, exact
                            mb = -4.0f * db;
                        } else {
                            da = dA * (float)(cA & 0xFu);
                            db = dB * (float)(cB & 0xFu);
                            ma = -(nA * (float)(cA >> 4));
                            mb = -(nB * (float)(cB >> 4));
                        }
#pragma unroll
                        for (int t = 0; t < NT; ++t) {
                            const int r = t * 8 + gid;
                            const int xoff = hh * 128 + q * 16 + tig * 4;
                            const int xa = st + ST::XQ + r * SB + swz(r, xoff >> 4) * 16 + (xoff & 15);
                            const uint32_t xb = r < XR ? lds<uint32_t>(ring, xa) : 0u;
                            int d[4];
                            mma_s8_k16(d, a0, a1, xb);
                            acc[t][0] += (float)d[0] * (da * dxv[t][0][j]) + ma * sxv[t][0][j];
                            acc[t][2] += (float)d[2] * (db * dxv[t][0][j]) + mb * sxv[t][0][j];
                            if (XR > 1) {
                                acc[t][1] += (float)d[1] * (da * dxv[t][1][j]) + ma * sxv[t][1][j];
                                acc[t][3] += (float)d[3] * (db * dxv[t][1][j]) + mb * sxv[t][1][j];
                            }
                        }
                    }
                }
            }
        } else if constexpr (S::GR == 16) {
            // Q6_K: a 128-element half at a time; its 16-groups q = 0..7 take the
            // ql word q % 4 (nibble q / 4) and the qh word q % 2 (bits 2 (q / 2))
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                uint32_t lw[2][4], hw[2][2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int r = gid + 8 * c;
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        lw[c][j] = lds<uint32_t>(ring, st + ST::W + r * 128 +
                                                 swz_l(r, hh * 4 + j) * 16 + tig * 4);
#pragma unroll
                    for (int j = 0; j < 2; ++j)
                        hw[c][j] = lds<uint32_t>(ring, st + S::QH + r * 64 +
                                                 swz_h(r, hh * 2 + j) * 16 + tig * 4);
                }
                Sc8<SC> dA, dB;
                dA.load(ring, st + ST::DS + gid * 16 * SCB + hh * 8 * SCB);
                dB.load(ring, st + ST::DS + (gid + 8) * 16 * SCB + hh * 8 * SCB);
#pragma unroll
                for (int qq = 0; qq < 2; ++qq) {  // groups 4 qq .. 4 qq + 3 of the half
                    float dxv[NT][2][4], sxv[NT][2][4];  // [tile][row tig*2 + i][group]
#pragma unroll
                    for (int t = 0; t < NT; ++t)
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            const int r = t * 8 + tig * 2 + i;
                            const int off = st + r * NG * 4 + (hh * 2 + qq) * 16;
                            const bool ok = r < XR && (XR > 1 || i == 0);
                            const uint4 d = ok ? lds<uint4>(ring, off + ST::DX) : make_uint4(0, 0, 0, 0);
                            const uint4 q = ok ? lds<uint4>(ring, off + ST::SX) : make_uint4(0, 0, 0, 0);
                            dxv[t][i][0] = __uint_as_float(d.x);
                            dxv[t][i][1] = __uint_as_float(d.y);
                            dxv[t][i][2] = __uint_as_float(d.z);
                            dxv[t][i][3] = __uint_as_float(d.w);
                            sxv[t][i][0] = __uint_as_float(q.x);
                            sxv[t][i][1] = __uint_as_float(q.y);
                            sxv[t][i][2] = __uint_as_float(q.z);
                            sxv[t][i][3] = __uint_as_float(q.w);
                        }
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int q = 4 * qq + j, hs = 2 * (q >> 1);
                        const uint32_t a0 = ((lw[0][j] >> (4 * qq)) & 0x0F0F0F0Fu) |
                                            (((hw[0][j & 1] >> hs) & 0x03030303u) << 4);
                        const uint32_t a1 = ((lw[1][j] >> (4 * qq)) & 0x0F0F0F0Fu) |
                                            (((hw[1][j & 1] >> hs) & 0x03030303u) << 4);
                        const float da = dA[q], db = dB[q];
                        const float ma = -32.0f * da, mb = -32.0f * db;
#pragma unroll
                        for (int t = 0; t < NT; ++t) {
                            const int r = t * 8 + gid;
                            const int xoff = hh * 128 + q * 16 + tig * 4;
                            const int xa = st + ST::XQ + r * SB + swz(r, xoff >> 4) * 16 + (xoff & 15);
                            const uint32_t xb = r < XR ? lds<uint32_t>(ring, xa) : 0u;
                            int d[4];
                            mma_s8_k16(d, a0, a1, xb);
                            acc[t][0] += (float)d[0] * (da * dxv[t][0][j]) + ma * sxv[t][0][j];
                            acc[t][2] += (float)d[2] * (db * dxv[t][0][j]) + mb * sxv[t][0][j];
                            if (XR > 1) {
                                acc[t][1] += (float)d[1] * (da * dxv[t][1][j]) + ma * sxv[t][1][j];
                                acc[t][3] += (float)d[3] * (db * dxv[t][1][j]) + mb * sxv[t][1][j];
                            }
                        }
                    }
                }
            }
        } else {
            Sc8<SC> dA, dB, mA, mB;
            dA.load(ring, st + ST::DS + gid * 8 * SCB);
            dB.load(ring, st + ST::DS + (gid + 8) * 8 * SCB);
            if constexpr (S::MSUB) {
                mA.load(ring, st + ST::MS + gid * 8 * SCB);
                mB.load(ring, st + ST::MS + (gid + 8) * 8 * SCB);
            }
            uint2 hA = make_uint2(0, 0), hB = hA;
            if constexpr (S::HAS_QH) {  // Q5_K: qh bytes tig*8..+7 of columns gid and gid+8
                const int qo = swz_s(gid, tig >> 1) * 16 + (tig & 1) * 8;  // gid + 8 alike
                hA = lds<uint2>(ring, st + S::QH_ROWS + gid * 32 + qo);
                hB = lds<uint2>(ring, st + S::QH_ROWS + (gid + 8) * 32 + qo);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {  // 64-element chunks: groups 2c, 2c+1
                float dxv[NT][2][2], sxv[NT][2][2];  // [tile][row tig*2 + i][group of the chunk]
#pragma unroll
                for (int t = 0; t < NT; ++t)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int r = t * 8 + tig * 2 + i;
                        const int off = st + r * 32 + swz_s(r, c >> 1) * 16 + (c & 1) * 8;
                        const bool ok = r < XR && (XR > 1 || i == 0);
                        const uint2 d = ok ? lds<uint2>(ring, off + ST::DX) : make_uint2(0, 0);
                        uint2 q = make_uint2(0, 0);
                        if constexpr (S::SX) q = ok ? lds<uint2>(ring, off + ST::SX) : make_uint2(0, 0);
                        dxv[t][i][0] = __uint_as_float(d.x);
                        dxv[t][i][1] = __uint_as_float(d.y);
                        sxv[t][i][0] = __uint_as_float(q.x);
                        sxv[t][i][1] = __uint_as_float(q.y);
                    }
                uint2 wA, wB;
                if constexpr (S::GR == 32 && !S::SX) {  // Q8_0 reads per group below
                    wA = wB = make_uint2(0, 0);
                } else {
                    // Q4_K: bytes tig*8..+7 of the chunk for columns gid and gid+8
                    const int qoff = c * 32 + tig * 8;
                    const int qa = st + ST::W + swz(gid, qoff >> 4) * 16 + (qoff & 15);
                    wA = lds<uint2>(ring, qa + gid * 128);
                    wB = lds<uint2>(ring, qa + (gid + 8) * 128);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int g = 2 * c + h;
                    uint32_t a0, a1, a2, a3;
                    if constexpr (S::SX) {  // Q4_K: the chunk's low nibbles, then its high
                        const int sh = 4 * h;
                        a0 = (wA.x >> sh) & 0x0F0F0F0Fu;
                        a1 = (wB.x >> sh) & 0x0F0F0F0Fu;
                        a2 = (wA.y >> sh) & 0x0F0F0F0Fu;
                        a3 = (wB.y >> sh) & 0x0F0F0F0Fu;
                        if constexpr (S::HAS_QH) {  // Q5_K: bit g of the same bytes' qh, at bit 4
                            a0 |= ((hA.x >> g) & 0x01010101u) << 4;
                            a1 |= ((hB.x >> g) & 0x01010101u) << 4;
                            a2 |= ((hA.y >> g) & 0x01010101u) << 4;
                            a3 |= ((hB.y >> g) & 0x01010101u) << 4;
                        }
                    } else {  // Q8_0: bytes tig*8..+7 of group g for columns gid and gid+8
                        const int qoff = g * 32 + tig * 8;
                        const int qa = st + ST::W + swz(gid, qoff >> 4) * 16 + (qoff & 15);
                        const uint2 vA = lds<uint2>(ring, qa + gid * 256);
                        const uint2 vB = lds<uint2>(ring, qa + (gid + 8) * 256);
                        a0 = vA.x;
                        a1 = vB.x;
                        a2 = vA.y;
                        a3 = vB.y;
                    }
                    const float da = dA[g], db = dB[g];
                    // the minimum, or the offset as one (exact: a power of two times the scale)
                    const float ma = S::MSUB ? mA[g] : (float)-S::OFF * da;
                    const float mb = S::MSUB ? mB[g] : (float)-S::OFF * db;
#pragma unroll
                    for (int t = 0; t < NT; ++t) {
                        const int r = t * 8 + gid;
                        const int xoff = c * 64 + h * 32 + tig * 8;
                        const int xa = st + ST::XQ + r * SB + swz(r, xoff >> 4) * 16 + (xoff & 15);
                        const uint2 xb = r < XR ? lds<uint2>(ring, xa) : make_uint2(0, 0);
                        int d[4];
                        mma_s8(d, a0, a1, a2, a3, xb.x, xb.y);
                        // d: (column gid, rows tig*2, +1), (column gid+8, the same rows);
                        // a single row has no odd row to sum
                        if constexpr (S::SX) {
                            acc[t][0] += (float)d[0] * (da * dxv[t][0][h]) + ma * sxv[t][0][h];
                            acc[t][2] += (float)d[2] * (db * dxv[t][0][h]) + mb * sxv[t][0][h];
                            if (XR > 1) {
                                acc[t][1] += (float)d[1] * (da * dxv[t][1][h]) + ma * sxv[t][1][h];
                                acc[t][3] += (float)d[3] * (db * dxv[t][1][h]) + mb * sxv[t][1][h];
                            }
                        } else {
                            acc[t][0] += (float)d[0] * (da * dxv[t][0][h]);
                            acc[t][2] += (float)d[2] * (db * dxv[t][0][h]);
                            if (XR > 1) {
                                acc[t][1] += (float)d[1] * (da * dxv[t][1][h]);
                                acc[t][3] += (float)d[3] * (db * dxv[t][1][h]);
                            }
                        }
                    }
                }
            }
        }
    }
    wg::cp_async_wait<0>();

    // the warps' partial sums, added in warp order
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][t * 4 + e][lane] = acc[t][e];
    __syncthreads();
    if (warp != 0) return;
    OutT* out = (OutT*)args.out + (size_t)row0 * N;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v = red[0][t * 4 + e][lane];
#pragma unroll
            for (int w = 1; w < MM_WARPS; ++w) v += red[w][t * 4 + e][lane];
            const int row = t * 8 + tig * 2 + (e & 1), col = col0 + gid + (e >> 1) * 8;
            if (row < B && col < N) out[(size_t)row * N + col] = from_f32<OutT>(v);
        }
}

template <class S, int XR, typename OutT>
int launch(const Args& a, int grid_x, int grid_y, cudaStream_t stream) {
    auto kern = qmm_w4a8_kernel<S, XR, OutT>;
    constexpr int smem = MM_WARPS * stages_of<S, XR>() * Stage<S, XR>::BYTES;
    // opt in to the ring's shared memory once per instantiation and card (not
    // a stream operation; internal linkage, so no other library shares the flag)
    static bool sized[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !sized[dev]) {
        const cudaError_t e =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        if (dev < 64) sized[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid_x, grid_y);
    cfg.blockDim = dim3(MM_WARPS * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
    return e != cudaSuccess ? (int)e : crabml_launch_status();
}

template <class S, int XR>
int launch_out(const Args& a, int out_bf16, int gx, int gy, cudaStream_t s) {
    if constexpr (std::is_same_v<typename S::Sc, float> && !is_k16<S>) {
        // float32 scale planes come with float32 compute: float32 out only
        return out_bf16 ? (int)cudaErrorInvalidValue : launch<S, XR, float>(a, gx, gy, s);
    } else {
        return out_bf16 ? launch<S, XR, bf16>(a, gx, gy, s) : launch<S, XR, float>(a, gx, gy, s);
    }
}

// the quantizer at the scheme's group on x of type XT, chained to the scheme's matmul
template <class S, typename XT>
int run(const void* x, void* xq, void* dx, void* sx, const void* q0, const void* q1,
        const void* dsub, const void* msub, void* out, int out_bf16, const void* plane_idx,
        int B, int N, int K, int grid_x, int grid_y, int x_rows, void* stream,
        const void* sc = nullptr, const void* d = nullptr, const void* dmin = nullptr) {
    if (x_rows != 1 && x_rows != 8 && x_rows != 16) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    quantize_kernel<S::GR, XT><<<dim3((K / 32 + WARPS - 1) / WARPS, B), WARPS * 32, 0, s>>>(
        (const XT*)x, (int8_t*)xq, (float*)dx, (float*)sx, K);
    const int err = crabml_launch_status();
    if (err) return err;
    const Args a{(const int8_t*)xq, (const float*)dx, (const float*)sx, (const uint8_t*)q0,
                 (const uint8_t*)q1, dsub, msub, out,
                 (const int*)plane_idx, B, N, K, (const int8_t*)sc, (const float*)d,
                 (const float*)dmin};
    if (x_rows == 1) return launch_out<S, 1>(a, out_bf16, grid_x, grid_y, s);
    if (x_rows == 8) return launch_out<S, 8>(a, out_bf16, grid_x, grid_y, s);
    return launch_out<S, 16>(a, out_bf16, grid_x, grid_y, s);
}

}  // namespace

// x (B, K) bf16; scratch xq (B, K) i8 and dx, sx (B, K/32) f32; qs (N, K/2)
// u8; dsub, msub (N, K/32) bf16; out (B, N) f32, or bf16 when out_bf16 != 0.
// 1 <= B <= 16, K % 256 == 0, every pointer 16-byte aligned (checked by the
// wrapper). plane_idx: null, or (B,) i32 on the device, and then the weight
// planes are stacks (n_planes, N, ...) of which row b multiplies plane
// plane_idx[b]. The grid and the rows of x a stage holds (1, 8 or 16) are
// ops/cuda/gemm_quant.py::w4a8_plan's.
extern "C" int qmm_w4a8_bf16(const void* x, void* xq, void* dx, void* sx,
                             const void* qs, const void* dsub, const void* msub,
                             void* out, int out_bf16, const void* plane_idx, int B, int N,
                             int K, int grid_x, int grid_y, int x_rows, void* stream) {
    return run<Q4K<bf16>, bf16>(x, xq, dx, sx, qs, nullptr, dsub, msub, out, out_bf16, plane_idx, B,
                                N, K, grid_x, grid_y, x_rows, stream);
}

// The Q8_0 form: qs (N, K) i8, dsub (N, K/32) bf16; scratch dx, sx (B,
// K/32). Otherwise as qmm_w4a8_bf16, plane_idx and stacks (n_planes, N, ...)
// too.
extern "C" int qmm_w4a8_q8_0_bf16(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                  const void* dsub, void* out, int out_bf16,
                                  const void* plane_idx, int B, int N, int K, int grid_x,
                                  int grid_y, int x_rows, void* stream) {
    return run<Q80<bf16>, bf16>(x, xq, dx, sx, qs, nullptr, dsub, nullptr, out, out_bf16, plane_idx,
                                B, N, K, grid_x, grid_y, x_rows, stream);
}

// The Q6_K form: ql (N, K/2) u8, qh (N, K/4) u8, dsub (N, K/16) bf16; scratch
// dx, sx (B, K/16): the activations quantize per 16-group. Otherwise as
// qmm_w4a8_bf16, plane_idx and stacks too.
extern "C" int qmm_w4a8_q6k_bf16(const void* x, void* xq, void* dx, void* sx, const void* ql,
                                 const void* qh, const void* dsub, void* out, int out_bf16,
                                 const void* plane_idx, int B, int N, int K, int grid_x,
                                 int grid_y, int x_rows, void* stream) {
    return run<Q6K<bf16>, bf16>(x, xq, dx, sx, ql, qh, dsub, nullptr, out, out_bf16, plane_idx, B,
                                N, K, grid_x, grid_y, x_rows, stream);
}

// The Q5_K form: qs (N, K/2) u8 as Q4_K's, qh (N, K/8) u8 in ggml's order,
// dsub, msub (N, K/32) bf16. Otherwise as qmm_w4a8_bf16, plane_idx and stacks
// too.
extern "C" int qmm_w4a8_q5k_bf16(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                 const void* qh, const void* dsub, const void* msub, void* out,
                                 int out_bf16, const void* plane_idx, int B, int N, int K,
                                 int grid_x, int grid_y, int x_rows, void* stream) {
    return run<Q5K<bf16>, bf16>(x, xq, dx, sx, qs, qh, dsub, msub, out, out_bf16, plane_idx, B, N,
                                K, grid_x, grid_y, x_rows, stream);
}

// The Q4_0 form: qs (N, K/2) u8 in the per-64 order, dsub (N, K/32) bf16.
// Otherwise as qmm_w4a8_bf16, plane_idx and stacks too.
extern "C" int qmm_w4a8_q4_0_bf16(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                  const void* dsub, void* out, int out_bf16,
                                  const void* plane_idx, int B, int N, int K, int grid_x,
                                  int grid_y, int x_rows, void* stream) {
    return run<Q40<bf16>, bf16>(x, xq, dx, sx, qs, nullptr, dsub, nullptr, out, out_bf16, plane_idx,
                                B, N, K, grid_x, grid_y, x_rows, stream);
}

// The Q5_0 form: qs (N, K/2) u8 in the per-64 order, qh (N, K/8) u8 in Q5_K's
// order, dsub (N, K/32) bf16. Otherwise as qmm_w4a8_bf16, plane_idx and stacks
// too.
extern "C" int qmm_w4a8_q5_0_bf16(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                  const void* qh, const void* dsub, void* out, int out_bf16,
                                  const void* plane_idx, int B, int N, int K, int grid_x,
                                  int grid_y, int x_rows, void* stream) {
    return run<Q50<bf16>, bf16>(x, xq, dx, sx, qs, qh, dsub, nullptr, out, out_bf16, plane_idx, B,
                                N, K, grid_x, grid_y, x_rows, stream);
}

// The Q3_K form: qs (N, K/4) u8, hb (N, K/8) u8, sc (N, K/16) i8, d (N,
// K/256) f32; scratch dx, sx (B, K/16): the activations quantize per
// 16-group. Otherwise as qmm_w4a8_bf16, plane_idx and stacks too.
extern "C" int qmm_w4a8_q3k_bf16(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                 const void* hb, const void* sc, const void* d, void* out,
                                 int out_bf16, const void* plane_idx, int B, int N, int K,
                                 int grid_x, int grid_y, int x_rows, void* stream) {
    return run<Q3K, bf16>(x, xq, dx, sx, qs, hb, nullptr, nullptr, out, out_bf16, plane_idx, B, N,
                          K, grid_x, grid_y, x_rows, stream, sc, d, nullptr);
}

// The Q2_K form: qs (N, K/4) u8, scm (N, K/16) u8, d, dmin (N, K/256) f32;
// scratch dx, sx (B, K/16). Otherwise as qmm_w4a8_bf16, plane_idx and stacks
// too.
extern "C" int qmm_w4a8_q2k_bf16(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                 const void* scm, const void* d, const void* dmin, void* out,
                                 int out_bf16, const void* plane_idx, int B, int N, int K,
                                 int grid_x, int grid_y, int x_rows, void* stream) {
    return run<Q2K, bf16>(x, xq, dx, sx, qs, scm, nullptr, nullptr, out, out_bf16, plane_idx, B, N,
                          K, grid_x, grid_y, x_rows, stream, nullptr, d, dmin);
}

// The float32 forms, under float32 compute: x (B, K) float32, quantized by
// the same operations as the bfloat16 forms' x (the plain version's
// quantize_activation, bit for bit); every dsub / msub plane float32 (Q3_K's
// and Q2_K's planes as in the bfloat16 forms); out (B, N) float32 only
// (out_bf16 must be 0). Otherwise each as its bfloat16 form, plane_idx and
// stacks too.
extern "C" int qmm_w4a8_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                            const void* dsub, const void* msub, void* out, int out_bf16,
                            const void* plane_idx, int B, int N, int K, int grid_x, int grid_y,
                            int x_rows, void* stream) {
    return run<Q4K<float>, float>(x, xq, dx, sx, qs, nullptr, dsub, msub, out, out_bf16,
                                  plane_idx, B, N, K, grid_x, grid_y, x_rows, stream);
}
extern "C" int qmm_w4a8_q8_0_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                 const void* dsub, void* out, int out_bf16,
                                 const void* plane_idx, int B, int N, int K, int grid_x,
                                 int grid_y, int x_rows, void* stream) {
    return run<Q80<float>, float>(x, xq, dx, sx, qs, nullptr, dsub, nullptr, out, out_bf16,
                                  plane_idx, B, N, K, grid_x, grid_y, x_rows, stream);
}
extern "C" int qmm_w4a8_q6k_f32(const void* x, void* xq, void* dx, void* sx, const void* ql,
                                const void* qh, const void* dsub, void* out, int out_bf16,
                                const void* plane_idx, int B, int N, int K, int grid_x,
                                int grid_y, int x_rows, void* stream) {
    return run<Q6K<float>, float>(x, xq, dx, sx, ql, qh, dsub, nullptr, out, out_bf16,
                                  plane_idx, B, N, K, grid_x, grid_y, x_rows, stream);
}
extern "C" int qmm_w4a8_q5k_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                const void* qh, const void* dsub, const void* msub, void* out,
                                int out_bf16, const void* plane_idx, int B, int N, int K,
                                int grid_x, int grid_y, int x_rows, void* stream) {
    return run<Q5K<float>, float>(x, xq, dx, sx, qs, qh, dsub, msub, out, out_bf16, plane_idx,
                                  B, N, K, grid_x, grid_y, x_rows, stream);
}
extern "C" int qmm_w4a8_q4_0_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                 const void* dsub, void* out, int out_bf16,
                                 const void* plane_idx, int B, int N, int K, int grid_x,
                                 int grid_y, int x_rows, void* stream) {
    return run<Q40<float>, float>(x, xq, dx, sx, qs, nullptr, dsub, nullptr, out, out_bf16,
                                  plane_idx, B, N, K, grid_x, grid_y, x_rows, stream);
}
extern "C" int qmm_w4a8_q5_0_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                 const void* qh, const void* dsub, void* out, int out_bf16,
                                 const void* plane_idx, int B, int N, int K, int grid_x,
                                 int grid_y, int x_rows, void* stream) {
    return run<Q50<float>, float>(x, xq, dx, sx, qs, qh, dsub, nullptr, out, out_bf16,
                                  plane_idx, B, N, K, grid_x, grid_y, x_rows, stream);
}
extern "C" int qmm_w4a8_q3k_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                const void* hb, const void* sc, const void* d, void* out,
                                int out_bf16, const void* plane_idx, int B, int N, int K,
                                int grid_x, int grid_y, int x_rows, void* stream) {
    return out_bf16 ? (int)cudaErrorInvalidValue
                    : run<Q3K, float>(x, xq, dx, sx, qs, hb, nullptr, nullptr, out, 0, plane_idx,
                                      B, N, K, grid_x, grid_y, x_rows, stream, sc, d, nullptr);
}
extern "C" int qmm_w4a8_q2k_f32(const void* x, void* xq, void* dx, void* sx, const void* qs,
                                const void* scm, const void* d, const void* dmin, void* out,
                                int out_bf16, const void* plane_idx, int B, int N, int K,
                                int grid_x, int grid_y, int x_rows, void* stream) {
    return out_bf16 ? (int)cudaErrorInvalidValue
                    : run<Q2K, float>(x, xq, dx, sx, qs, scm, nullptr, nullptr, out, 0, plane_idx,
                                      B, N, K, grid_x, grid_y, x_rows, stream, nullptr, d, dmin);
}
