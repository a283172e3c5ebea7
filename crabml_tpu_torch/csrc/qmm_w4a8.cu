// qmm_w4a8: int8 activations x 4-bit Q4_K weights for decode rows (<= 16).
//
// Replaces crabml_tpu/ops/pallas/gemm_quant.py::_qmm_w4a8_kernel (launcher
// _run_w4a8, pallas_call at :740) together with its jnp quantize_activation.
// A first small kernel quantizes the bf16 activations per (row, 32-group) to
// symmetric int8 xq with scale dx = amax/127 and bsum sx = dx*sum(xq), with
// the same IEEE operations and half-to-even rounding as the plain version
// (ops/cuda/gemm_quant.py::quantize_activation), so the int8 values agree
// bit for bit. Per group g the matmul kernel then computes
//
//   x.w|g = dsub_g * dx_g * (xq_g . val_g)  +  msub_g * sx_g
//
// with val the unsigned nibble 0..15, which __dp4a takes directly as a signed
// byte; this is algebraically what the TPU kernel's -128 centring computes.
//
// Bound on the H100: device-memory bytes. At B=1 every weight byte is used
// once for two integer operations, far below the ridge, so the kernel must
// stream the packed planes at the card's 3.35 TB/s. Design: one warp per
// output column sweeps k; each lane loads 16 consecutive packed bytes per
// step (a warp reads 512 contiguous bytes), unpacks low and high nibbles with
// two masks and issues eight dp4a per row. The m=4096 projections launch 4096
// warps, enough to spread over all 132 SMs. The per-lane float sums reduce
// across the warp once at the end; no atomics, so results are deterministic.
// The result is written as float32 or as the bf16 compute dtype.
//
// Per-row planes (the MoE decode path): with plane_idx given, row b multiplies
// weight plane plane_idx[b] of a stack (n_planes, N, K). This is the TPU
// launcher's scalar-prefetched `layer` (gemm_quant.py:701-706) fed an expert
// id, one id per row here. The rows then share no weights, so the launch puts
// one row on each blockIdx.y and every warp streams its own row's plane; the
// index is read on the device and the host never sees a routing value. The
// bytes are the selected planes only: k/E of the experts at one row.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

// one warp per 32-element group, lane i holds element i of the group
__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ dx,
                float* __restrict__ sx, int K) {
    const int G = K / 32;
    const int g = blockIdx.x * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.y;
    if (g >= G) return;
    const float v = __bfloat162float(x[(size_t)b * K + g * 32 + lane]);
    float amax = fabsf(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float d = amax / 127.0f;
    const float inv = d > 0.0f ? 1.0f / fmaxf(d, 1e-30f) : 0.0f;
    const float qf = fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
    xq[(size_t)b * K + g * 32 + lane] = (int8_t)qf;
    const float qsum = warp_sum(qf);  // integer-valued: exact in float32
    if (lane == 0) {
        dx[(size_t)b * G + g] = d;
        sx[(size_t)b * G + g] = d * qsum;
    }
}

template <int NB, typename OutT>
__global__ void __launch_bounds__(WARPS * 32)
qmm_w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ dx,
                const float* __restrict__ sx, const uint8_t* __restrict__ qs,
                const bf16* __restrict__ dsub, const bf16* __restrict__ msub,
                OutT* __restrict__ out, const int* __restrict__ plane_idx, int B, int N,
                int K) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int col = blockIdx.x * WARPS + warp;
    if (col >= N) return;
    const int G = K / 32;
    const int nseg = K / 32;  // 16-byte segments of packed nibbles per weight row
    // blockIdx.y: the first of this block's B rows (0 unless rows have planes of their own)
    const int row0 = blockIdx.y;
    const size_t wr = (size_t)(plane_idx ? plane_idx[row0] : 0) * N + col;  // weight row
    xq += (size_t)row0 * K;
    dx += (size_t)row0 * G;
    sx += (size_t)row0 * G;
    out += (size_t)row0 * N;
    const uint8_t* wrow = qs + wr * (K / 2);
    const bf16* drow = dsub + wr * G;
    const bf16* mrow = msub + wr * G;

    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.0f;

#pragma unroll 4
    for (int s = lane; s < nseg; s += 32) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(wrow + s * 16));
        const int c = s >> 1, h = s & 1;  // 64-element chunk, half of its 32 bytes
        const int glo = 2 * c, ghi = 2 * c + 1;
        const float dlo = __bfloat162float(drow[glo]), dhi = __bfloat162float(drow[ghi]);
        const float mlo = __bfloat162float(mrow[glo]), mhi = __bfloat162float(mrow[ghi]);
        const int elo = c * 64 + h * 16;  // first element of the low-nibble run
        const int wl0 = (int)(w.x & 0x0F0F0F0Fu), wl1 = (int)(w.y & 0x0F0F0F0Fu);
        const int wl2 = (int)(w.z & 0x0F0F0F0Fu), wl3 = (int)(w.w & 0x0F0F0F0Fu);
        const int wh0 = (int)((w.x >> 4) & 0x0F0F0F0Fu), wh1 = (int)((w.y >> 4) & 0x0F0F0F0Fu);
        const int wh2 = (int)((w.z >> 4) & 0x0F0F0F0Fu), wh3 = (int)((w.w >> 4) & 0x0F0F0F0Fu);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            if (b < B) {
                const int8_t* xr = xq + (size_t)b * K;
                const int4 xl = *reinterpret_cast<const int4*>(xr + elo);
                const int4 xh = *reinterpret_cast<const int4*>(xr + elo + 32);
                int slo = __dp4a(wl0, xl.x, 0);
                slo = __dp4a(wl1, xl.y, slo);
                slo = __dp4a(wl2, xl.z, slo);
                slo = __dp4a(wl3, xl.w, slo);
                int shi = __dp4a(wh0, xh.x, 0);
                shi = __dp4a(wh1, xh.y, shi);
                shi = __dp4a(wh2, xh.z, shi);
                shi = __dp4a(wh3, xh.w, shi);
                const float* dxr = dx + (size_t)b * G;
                float a = (float)slo * (dxr[glo] * dlo) + (float)shi * (dxr[ghi] * dhi);
                if (h == 0) {  // the group's min term, once per 64-element chunk
                    const float* sxr = sx + (size_t)b * G;
                    a += sxr[glo] * mlo + sxr[ghi] * mhi;
                }
                acc[b] += a;
            }
        }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const float v = warp_sum(acc[b]);
        if (lane == 0 && b < B) out[(size_t)b * N + col] = from_f32<OutT>(v);
    }
}

template <int NB>
void launch(const void* xq, const void* dx, const void* sx, const void* qs,
            const void* dsub, const void* msub, void* out, int out_bf16,
            const int* plane_idx, int rows_y, int B, int N, int K, cudaStream_t stream) {
    const dim3 blocks((N + WARPS - 1) / WARPS, rows_y);
    const int8_t* xqi = (const int8_t*)xq;
    const float *dxf = (const float*)dx, *sxf = (const float*)sx;
    const bf16 *db = (const bf16*)dsub, *mb = (const bf16*)msub;
    if (out_bf16)
        qmm_w4a8_kernel<NB, bf16><<<blocks, WARPS * 32, 0, stream>>>(
            xqi, dxf, sxf, (const uint8_t*)qs, db, mb, (bf16*)out, plane_idx, B, N, K);
    else
        qmm_w4a8_kernel<NB, float><<<blocks, WARPS * 32, 0, stream>>>(
            xqi, dxf, sxf, (const uint8_t*)qs, db, mb, (float*)out, plane_idx, B, N, K);
}

}  // namespace

// x (B, K) bf16; scratch xq (B, K) i8 and dx, sx (B, K/32) f32; qs (N, K/2)
// u8; dsub, msub (N, K/32) bf16; out (B, N) f32, or bf16 when out_bf16 != 0.
// 1 <= B <= 16, K % 256 == 0 (checked by the wrapper). plane_idx: null, or (B,)
// i32 on the device, and then the weight planes are stacks (n_planes, N, ...)
// of which row b multiplies plane plane_idx[b].
extern "C" int qmm_w4a8_bf16(const void* x, void* xq, void* dx, void* sx,
                             const void* qs, const void* dsub, const void* msub,
                             void* out, int out_bf16, const void* plane_idx, int B, int N,
                             int K, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    quantize_kernel<<<dim3((K / 32 + WARPS - 1) / WARPS, B), WARPS * 32, 0, s>>>(
        (const bf16*)x, (int8_t*)xq, (float*)dx, (float*)sx, K);
    const int err = crabml_launch_status();
    if (err) return err;
    const int* pi = (const int*)plane_idx;
    if (pi) launch<1>(xq, dx, sx, qs, dsub, msub, out, out_bf16, pi, B, 1, N, K, s);
    else if (B <= 1) launch<1>(xq, dx, sx, qs, dsub, msub, out, out_bf16, pi, 1, B, N, K, s);
    else if (B <= 2) launch<2>(xq, dx, sx, qs, dsub, msub, out, out_bf16, pi, 1, B, N, K, s);
    else if (B <= 4) launch<4>(xq, dx, sx, qs, dsub, msub, out, out_bf16, pi, 1, B, N, K, s);
    else if (B <= 8) launch<8>(xq, dx, sx, qs, dsub, msub, out, out_bf16, pi, 1, B, N, K, s);
    else launch<16>(xq, dx, sx, qs, dsub, msub, out, out_bf16, pi, 1, B, N, K, s);
    return crabml_launch_status();
}
