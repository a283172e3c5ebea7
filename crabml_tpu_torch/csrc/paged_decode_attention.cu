// paged_decode_attention: GQA attention of T <= 8 new tokens, at any number of
// q heads per kv head, over a paged KV pool, through a block table.
//
// The paged instantiations of decode_core.cuh (see its note for the bound and
// the design). Replaces crabml_tpu/ops/pallas/decode_attention.py::_kernel
// with paged=True (launcher _run_paged, pallas_call at :305): the pool already
// holds the step's keys, k_new is null; and ::_kernel_fused with paged=True
// (launcher _run_fused_paged, pallas_call at :622): the step's keys arrive as
// a separate block and are written into the pool after attention. Key j of
// sequence b lives in page table[b, j / 128] at row j % 128. A page is 128
// rows of hd head dims for one kv head, contiguous: one block's chunk, one
// table entry, read only when the chunk holds a cached key. No page is read
// beyond the first ceil(keys / 128) entries of a table row: unused entries
// (0, the shared scratch page) are never followed.
#include "decode_core.cuh"

// As decode_attention (csrc/decode_attention.cu), with k, v one layer of the
// pool (n_pages, KV, 128, hd), ks, vs (n_pages, KV, 128) float32 for int8,
// and table (B, max_pages) i32.
extern "C" int paged_decode_attention(int qtype, int ktype, const void* q, const void* k,
                                      const void* v, const void* ks, const void* vs,
                                      const void* k_new, const void* v_new,
                                      const void* ks_new, const void* vs_new,
                                      const void* table, const void* pos, void* part_m,
                                      void* part_l, void* part_acc, void* ticket, void* out,
                                      int B, int KV, int max_pages, int T, int G,
                                      int n_chunks, int hd, float scale, float softcap,
                                      int win, int pos_bias, void* stream) {
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
    decode_core::PagedAddr addr{(const int*)table, max_pages};
    return decode_core::dispatch(p, addr, qtype, ktype, hd, (cudaStream_t)stream);
}
