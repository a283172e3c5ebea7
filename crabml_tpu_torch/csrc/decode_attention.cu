// decode_attention: GQA attention of T <= 8 new tokens, at any number of q
// heads per kv head, over a dense KV cache.
//
// The dense instantiations of decode_core.cuh (see its note for the bound and
// the design). Replaces crabml_tpu/ops/pallas/decode_attention.py::_kernel
// (launcher _run, pallas_call at :252): the cache already holds the step's
// keys, k_new is null; and ::_kernel_fused (launcher _run_fused, pallas_call
// at :556): the step's keys arrive as a separate block and the cache holds
// only the prefix. The TPU kernel takes the stacked cache and a layer scalar
// so that a scan never copies the cache; here the wrapper passes the layer's
// own base pointer, which is a view in PyTorch.
#include "decode_core.cuh"

// q, out (B, T, KV*G, hd) bfloat16 (qtype 0) or float32 (1); hd 80, 96, 128 or
// 256. k, v one layer of the cache (B, KV, S, hd) in bfloat16 (ktype 0), float32
// (1) or int8 (2, with ks, vs (B, KV, S) float32), whatever q's type. k_new, v_new (B, KV,
// T, hd) in the stored type and ks_new, vs_new (B, KV, T), or null when the
// cache holds the step's keys. pos (B,) i32 = keys that precede the step,
// less pos_bias (0, or -T when the caller holds each sequence's length with
// the step). With RT = ceil(T*G / 16) row tiles of TR = min(T*G, 16) rows:
// part_m, part_l (B, KV*RT, n_chunks, TR) and part_acc (B, KV*RT, n_chunks,
// TR, hd) float32 scratch; ticket (B*KV*RT) int32, zero before the launch and
// zero after it. The grid is (KV*RT, B, n_chunks) with n_chunks * 128 >= the
// most keys a sequence can have.
extern "C" int decode_attention(int qtype, int ktype, const void* q, const void* k,
                                const void* v, const void* ks, const void* vs,
                                const void* k_new, const void* v_new, const void* ks_new,
                                const void* vs_new, const void* pos, void* part_m,
                                void* part_l, void* part_acc, void* ticket, void* out, int B,
                                int KV, int S, int T, int G, int n_chunks, int hd, float scale,
                                float softcap, int win, int pos_bias, void* stream) {
    decode_core::Params p;
    p.q = q; p.k = k; p.v = v;
    p.ks = (const float*)ks; p.vs = (const float*)vs;
    p.k_new = k_new; p.v_new = v_new;
    p.ks_new = (const float*)ks_new; p.vs_new = (const float*)vs_new;
    p.pos = (const int*)pos;
    p.part_m = (float*)part_m; p.part_l = (float*)part_l; p.part_acc = (float*)part_acc;
    p.ticket = (int*)ticket;
    p.out = out;
    p.B = B; p.KV = KV; p.T = T; p.G = G; p.n_chunks = n_chunks;
    p.scale = scale; p.softcap = softcap; p.win = win; p.pos_bias = pos_bias;
    decode_core::DenseAddr addr{S};
    return decode_core::dispatch(p, addr, qtype, ktype, hd, (cudaStream_t)stream);
}
