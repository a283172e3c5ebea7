"""Paged KV cache: block-pool serving memory with a prefix cache.

Counterpart of crabml_tpu/serving/paged.py (PagedKVCache, paged_decode_step,
paged_prefill_chunk, paged_verify_step, _scatter_prefill,
PagedServingEngine). The slot-pool engine reserves seq_len cache rows per
slot; this one allocates KV memory in PAGE-token pages from a shared pool, so
memory scales with the tokens in flight:

- `PagedKVCache`: pools (L, n_pages, KV, PAGE, hd) x2 and a block table (B,
  max_pages) naming each sequence's pages. Page 0 is a scratch page that idle
  and mid-prefill slots write to; it is never allocated and never read.
- `paged_decode_step`: one decode tick, positions on the device, nothing read
  on the host. Per layer the step's k/v are attended from their own block
  through the block table (ops.cuda.paged_decode_attention_fused) and then
  written into each sequence's current page with one indexed write per
  tensor; at a head layout the decode kernels do not take (head dim 16)
  they are written first and each sequence's pages, gathered through the
  table, go to the flash kernel, as the JAX package's non-fused route does.
  The engine replays it as a CUDA graph (ServingEngine.step).
- `paged_prefill_chunk`: one prompt chunk written straight into pool pages.
  A chunk of a few tokens (the recomputed last token after a prefix hit, a
  ragged tail: ops.cuda.decode_attention.decode_eligible) attends through the
  block table (ops.cuda.paged_decode_attention); a longer one gathers the
  slot's live pages dense and takes the flash kernel.
- `paged_verify_step`: the speculative verify, K + 1 tokens a slot written
  through the block table and attended through it by the decode kernels
  (ops.cuda.paged_decode_attention), every row with its causal bound; the
  flash route at head dim 16. Positions on the device, nothing read on the
  host.
- `PagedServingEngine`: continuous batching over the pool: admission
  allocates the prompt's pages, each step allocates the pages its ticks
  reach before they run, finishing returns them; under pool pressure the youngest
  request is preempted and recomputed later instead of failing.
- Prefix cache (on by default): each full prompt page registers under a
  position-chained token digest; a later prompt that starts with the same
  tokens reuses those pages read-only (refcounted) and prefills only its
  tail. A shared page is final once written: decode writes only past the
  prompt, and the last prompt token is always recomputed so that sampling
  sees real logits. Finished requests' registered pages stay as evictable
  cache (LRU under pool pressure).
- Speculative serving is ServingEngine's (serving/engine.py's note), its
  verifies through `paged_verify_step`, the pages of a round's (or the
  fused rounds') every position allocated before it; a draft model keeps a
  dense slot cache beside the pool, and a prefix hit teacher-forces the
  reused prefix through it. The fused rounds are off by default
  (SPEC_FUSED_DEFAULT), as in the JAX package.

The JAX package keeps its pools out of a layer scan and writes them after it
so that a donated pool is updated in place, and pads chunks and page counts to
powers of two to bound recompiles; PyTorch writes the pool in place per layer
and forwards exact lengths.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..models.forward import (KVCache, dequantize_like, embed, final_logits, forward,
                              layer_body, layer_window, quantize_new, rope_tables)
from ..ops.cuda.decode_attention import decode_eligible
from ..ops.cuda.flash_attention import flash_attention
from ..ops.cuda.paged_decode_attention import (PAGE, gather_pages, paged_decode_attention,
                                               paged_decode_attention_fused)
from .engine import Request, ServingEngine


@dataclass
class PagedKVCache:
    """k, v: (L, n_pages, KV, PAGE, hd); table: (B, max_pages) int32 on the
    device (physical page of each sequence's logical chunk; unused entries 0).
    dtype int8 pools carry float32 scales per (page row, kv head) in
    k_scale / v_scale (L, n_pages, KV, PAGE, 1)."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(cfg, n_pages: int, n_slots: int, max_pages: int, dtype=torch.bfloat16,
               device="cpu") -> "PagedKVCache":
        dense = KVCache.create(cfg, n_pages, PAGE, dtype, device)  # same shapes, pages as batch
        table = torch.zeros(n_slots, max_pages, dtype=torch.int32, device=device)
        return PagedKVCache(dense.k, dense.v, table, dense.k_scale, dense.v_scale)

    @staticmethod
    def from_numpy(k, v, table, k_scale=None, v_scale=None, device="cpu") -> "PagedKVCache":
        """A pool from the arrays of a JAX-package pool (for the tests)."""
        t = [None if a is None else torch.tensor(a, device=device)
             for a in (k, v, table, k_scale, v_scale)]
        t[2] = t[2].to(torch.int32)
        return PagedKVCache(*t)


def paged_decode_step(weights, cache: PagedKVCache, tokens, pos, cfg,
                      compute_dtype) -> torch.Tensor:
    """One decode tick over the page pool. tokens (B,) and pos (B,) int32 on
    the device, pos[b] the tokens sequence b holds. Writes each sequence's new
    k/v into page table[b, pos // PAGE] in place -> logits (B, V). Like
    models.forward.decode_step it reads nothing on the host, so a CUDA graph
    captures it; the block table is updated in place between replays, and the
    caller allocates every page a replay can reach before it. Where the
    decode kernels do not take the heads (decode_eligible), the new k/v are
    written first and the flash kernel attends over every page of the
    table's row, masked by pos, as crabml_tpu/serving/paged.py's
    _paged_attention_fallback does."""
    B = tokens.shape[0]
    dev = tokens.device
    pos_dev = pos.to(device=dev, dtype=torch.int32)  # no copy for device int32
    cos, sin = rope_tables(weights, pos_dev[:, None], cfg)
    pos_l = pos_dev.long()
    page_of = cache.table[torch.arange(B, device=dev), pos_l // PAGE].long()  # (B,)
    off = pos_l % PAGE
    kv_dtype = cache.k.dtype
    fused = decode_eligible(1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)

    x = embed(weights, tokens[:, None], cfg, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        def write(kq, vq, ks, vs):
            cache.k[l][page_of, :, off] = kq[:, :, 0]  # (B, KV, hd) at (page, :, row)
            cache.v[l][page_of, :, off] = vq[:, :, 0]
            if ks is not None:
                cache.k_scale[l][page_of, :, off] = ks[:, :, 0]
                cache.v_scale[l][page_of, :, off] = vs[:, :, 0]

        def kv_io(q, k, v):
            kq, vq, ks, vs = quantize_new(k.transpose(1, 2), v.transpose(1, 2), kv_dtype)
            window = layer_window(cfg, l)
            if not fused:
                write(kq, vq, ks, vs)

                def gathered(pool, scale):  # this layer's pages of each sequence, dense
                    return dequantize_like(
                        gather_pages(pool[l], cache.table),
                        None if scale is None else gather_pages(scale[l], cache.table), q.dtype)

                return flash_attention(q, gathered(cache.k, cache.k_scale),
                                       gathered(cache.v, cache.v_scale), pos_dev,
                                       cfg.attn_scale, cfg.attn_logit_softcap, window)
            out = paged_decode_attention_fused(
                q, cache.k, cache.v, cache.table, l, pos_dev, cfg.attn_scale, kq, vq,
                cache.k_scale, cache.v_scale, ks, vs, cfg.attn_logit_softcap, window)
            write(kq, vq, ks, vs)
            return out

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)[:, 0]


def paged_prefill_chunk(weights, cache: PagedKVCache, tokens, filled: int, slot_pages, cfg,
                        compute_dtype) -> torch.Tensor:
    """One prompt chunk written straight into pool pages. tokens (1, T);
    `filled` tokens of this prompt are already in `slot_pages`, the slot's
    page list, which covers at least filled + T tokens. It travels out of
    band, not through cache.table, so that the decode ticks of a slot that is
    still mid-prefill keep writing to the scratch page -> logits (1, T, V)."""
    T = tokens.shape[1]
    dev = tokens.device
    n_ctx = -(-(filled + T) // PAGE)
    ctx = torch.tensor([slot_pages[:n_ctx]], dtype=torch.int32, device=dev)  # (1, n_ctx)
    at = torch.arange(filled, filled + T, device=dev)
    page_of, off = ctx[0].long()[at // PAGE], at % PAGE  # (T,) each
    cos, sin = rope_tables(weights, at[None].to(torch.int32), cfg)
    lengths = torch.tensor([filled + T], dtype=torch.int32, device=dev)
    pos_dev = lengths - T
    through_table = decode_eligible(T, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = cache.k.dtype

    x = embed(weights, tokens, cfg, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        k_l, v_l = cache.k[l], cache.v[l]
        window = layer_window(cfg, l)
        ks_l = vs_l = None
        if cache.quantized:
            ks_l, vs_l = cache.k_scale[l], cache.v_scale[l]

        def kv_io(q, k, v):
            kq, vq, ks, vs = quantize_new(k[0], v[0], kv_dtype)  # (T, KV, hd)
            k_l[page_of, :, off] = kq
            v_l[page_of, :, off] = vq
            if ks is not None:
                ks_l[page_of, :, off] = ks
                vs_l[page_of, :, off] = vs
            if through_table:
                return paged_decode_attention(
                    q, k_l, v_l, ctx, lengths, cfg.attn_scale, ks_l, vs_l,
                    cfg.attn_logit_softcap, window)
            # attend over this slot's live pages, the chunk's own included
            kd = dequantize_like(gather_pages(k_l, ctx),
                                 None if ks_l is None else gather_pages(ks_l, ctx), q.dtype)
            vd = dequantize_like(gather_pages(v_l, ctx),
                                 None if vs_l is None else gather_pages(vs_l, ctx), q.dtype)
            return flash_attention(q, kd, vd, pos_dev, cfg.attn_scale,
                                   cfg.attn_logit_softcap, window)

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)


def paged_verify_step(weights, cache: PagedKVCache, tokens, pos, cfg,
                      compute_dtype) -> torch.Tensor:
    """The speculative verify over the page pool: tokens (B, T <= 8) and pos
    (B,) int32 on the device, pos[b] the tokens sequence b holds. Writes the
    k/v of positions pos[b] .. pos[b] + T - 1 through the block table (the
    caller allocated their pages; idle rows reach the scratch page) and
    attends each row over its sequence's pages up to its own position ->
    logits (B, T, V). Counterpart of crabml_tpu/serving/paged.py's
    _paged_verify_fwd / paged_verify_step; nothing is read on the host."""
    T = tokens.shape[1]
    dev = tokens.device
    pos_dev = pos.to(device=dev, dtype=torch.int32)
    positions = pos_dev[:, None] + torch.arange(T, device=dev, dtype=torch.int32)[None]
    cos, sin = rope_tables(weights, positions, cfg)
    pl = positions.long()
    page_of, off = cache.table.gather(1, pl // PAGE).long(), pl % PAGE  # (B, T) each
    lengths = pos_dev + T
    through_table = decode_eligible(T, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = cache.k.dtype

    x = embed(weights, tokens, cfg, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        k_l, v_l = cache.k[l], cache.v[l]
        ks_l = vs_l = None
        if cache.quantized:
            ks_l, vs_l = cache.k_scale[l], cache.v_scale[l]
        window = layer_window(cfg, l)

        def kv_io(q, k, v):
            kq, vq, ks, vs = quantize_new(k, v, kv_dtype)  # (B, T, KV, hd)
            k_l[page_of, :, off] = kq
            v_l[page_of, :, off] = vq
            if ks is not None:
                ks_l[page_of, :, off] = ks
                vs_l[page_of, :, off] = vs
            if through_table:
                return paged_decode_attention(q, k_l, v_l, cache.table, lengths, cfg.attn_scale,
                                              ks_l, vs_l, cfg.attn_logit_softcap, window)

            def gathered(pool, scale):  # every page of each sequence's row, dense
                return dequantize_like(gather_pages(pool, cache.table),
                                       None if scale is None else gather_pages(scale, cache.table),
                                       q.dtype)

            return flash_attention(q, gathered(k_l, ks_l), gathered(v_l, vs_l), pos_dev,
                                   cfg.attn_scale, cfg.attn_logit_softcap, window)

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)


def _scatter_prefill(cache: PagedKVCache, dense: KVCache, pages: list[int]):
    """Copy a dense (L, 1, KV, n*PAGE, hd) prefill cache into the pool pages
    `pages`, scales alongside (synchronous admission)."""
    idx = torch.tensor(pages, dtype=torch.long, device=cache.k.device)
    for pool, src in ((cache.k, dense.k), (cache.v, dense.v),
                      (cache.k_scale, dense.k_scale), (cache.v_scale, dense.v_scale)):
        if pool is None:
            continue
        L, _, KV, _, d = src.shape
        # (L, KV, n, PAGE, d) -> (L, n, KV, PAGE, d)
        pool[:, idx] = src[:, 0].reshape(L, KV, len(pages), PAGE, d).transpose(1, 2)


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged KV pool.

    The request lifecycle is ServingEngine's; memory is allocated in PAGE
    blocks on demand (admission: ceil(prompt / PAGE) pages; decode: one page
    at each boundary crossing) and returned on completion. `n_pages` bounds
    the tokens in flight instead of slots x seq_len. The pool is stored in the
    compute dtype unless `kv_dtype` names another (float32, bfloat16 or int8).

    The block table's source of truth is the host mirror `self._table`
    (pages are only ever assigned host-side); it is pushed to the device when
    it changes. A freed slot's row resets to the scratch page, so an idle
    slot can never write into a page that gets reallocated.
    """

    # the JAX package measured its paged fused rounds slower than one verify
    # a step (the pool carried through its rounds' scan); kept as its default
    SPEC_FUSED_DEFAULT = False

    def __init__(self, runner=None, *, n_pages: int = 256, prefix_cache: bool = True, **kw):
        # 4 pages per chunk, written straight into the pool
        kw.setdefault("prefill_chunk", 4 * PAGE)
        self._n_pages_cfg = n_pages
        # prefix caching rides direct-to-page admission only: the synchronous
        # path prefills a dense scratch cache that cannot see reused pages
        chunked = kw["prefill_chunk"] is not None
        self._prefix_on = prefix_cache and chunked
        if prefix_cache and not chunked:
            logging.getLogger("crabml_tpu_torch").warning(
                "prefix caching disabled: it needs chunked admission (prefill_chunk=None given)")
        super().__init__(runner, **kw)

    def _make_cache(self):
        self.max_pages = -(-self.seq_len // PAGE)
        self.n_pages = self._n_pages_cfg
        # page 0 is the scratch page shared by empty slots; never allocated
        self._free = list(range(1, self.n_pages))
        self._owned: list[list[int]] = [[] for _ in range(self.n_slots)]
        # prefix cache: full prompt pages register under a position-chained
        # token digest; ref-0 registered pages are kept as evictable cache
        # until the allocator needs them back (LRU)
        self._ref: dict[int, int] = {}  # page -> live-slot refcount
        self._page_hash: dict[int, bytes] = {}  # registered page -> digest
        self._hash_page: dict[bytes, int] = {}  # digest -> page
        self._evictable: list[bytes] = []  # ref-0 registered digests, LRU
        self._slot_digests: dict[int, list[bytes]] = {}
        self._reuse: dict[int, int] = {}  # slot -> reused token count
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.prefix_evictions = 0  # cached ref-0 pages dropped on pressure
        self.preemptions = 0  # pool-pressure recompute preemptions
        self._table = np.zeros((self.n_slots, self.max_pages), np.int32)
        return PagedKVCache.create(self.cfg, self.n_pages, self.n_slots, self.max_pages,
                                   self.kv_dtype, self.device)

    def pages_free(self) -> int:
        return len(self._free) + len(self._evictable)

    def _evict_one(self) -> bool:
        """Drop the least-recently-used ref-0 cached page back to free."""
        while self._evictable:
            dig = self._evictable.pop(0)
            pg = self._hash_page.get(dig)
            if pg is None or self._ref.get(pg, 0) > 0:
                continue  # stale entry (page registered again or live again)
            del self._hash_page[dig]
            del self._page_hash[pg]
            self._free.append(pg)
            self.prefix_evictions += 1
            return True
        return False

    def _alloc(self, n: int) -> list[int] | None:
        """Pop n pages; cached ref-0 pages are evicted LRU on pressure.
        Every returned page starts at refcount 1."""
        while len(self._free) < n and self._evict_one():
            pass
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._ref[pg] = 1
        return pages

    @staticmethod
    def _chain_digests(toks: list[int], n_pages: int) -> list[bytes]:
        """Position-chained page digests: digest i commits to ALL tokens up
        to page i's end, so equal digests mean equal full prefixes."""
        out: list[bytes] = []
        h = b""
        for i in range(n_pages):
            page = np.asarray(toks[i * PAGE:(i + 1) * PAGE], np.int32)
            h = hashlib.sha1(h + page.tobytes()).digest()
            out.append(h)
        return out

    def _push_table(self):
        self.cache.table.copy_(torch.from_numpy(self._table))

    def _trim_prompt(self, req: Request) -> list[int]:
        toks = req.prompt_tokens
        limit = min(self.seq_len - 1, self.max_pages * PAGE - 1)
        if len(toks) > limit:
            toks = toks[-limit:]
        return toks

    def _claim_pages(self, slot: int, req: Request, toks: list[int]) -> bool:
        """Allocate the prompt's pages up front; False leaves it queued.
        With prefix caching, leading full pages whose chained digest is
        registered are REUSED (refcounted, read-only) and only the rest
        allocate; the reused token count lands in self._reuse[slot]."""
        n_prompt_pages = -(-len(toks) // PAGE)
        if n_prompt_pages > self.n_pages - 1:
            # can NEVER fit this pool: fail instead of requeueing forever
            self.slots[slot] = req
            self._finish(slot, "error")
            return False
        reused: list[int] = []
        digests: list[bytes] = []
        if self._prefix_on:
            digests = self._chain_digests(toks, len(toks) // PAGE)
            # the LAST prompt token always recomputes (its logits seed
            # sampling), so at most (len-1)//PAGE pages can be reused
            for i in range((len(toks) - 1) // PAGE):
                pg = self._hash_page.get(digests[i])
                if pg is None:
                    break
                reused.append(pg)
        # PIN the reused pages BEFORE allocating: _alloc evicts ref-0 cached
        # pages under pressure and could otherwise hand out the very pages
        # about to be reused
        for pg in reused:
            r = self._ref.get(pg, 0)
            self._ref[pg] = r + 1
            if r == 0 and self._page_hash.get(pg) in self._evictable:
                self._evictable.remove(self._page_hash[pg])
        pages = self._alloc(n_prompt_pages - len(reused))
        if pages is None:  # pool busy: leave queued for a later tick
            for pg in reused:  # unpin; keep as evictable cache again
                r = self._ref[pg] - 1
                self._ref[pg] = r
                dig = self._page_hash.get(pg)
                if r == 0 and dig is not None:
                    self._evictable.append(dig)
            self.pending.put(req)
            return False
        if reused:
            self.prefix_hits += 1
            self.prefix_tokens_reused += len(reused) * PAGE
        self._owned[slot] = reused + pages
        self._reuse[slot] = len(reused) * PAGE
        self._slot_digests[slot] = digests
        self.slots[slot] = req  # claimed before device work (crash recovery)
        return True

    def _claim_for_prefill(self, slot: int, req: Request):
        toks = self._trim_prompt(req)
        if not self._claim_pages(slot, req, toks):
            return
        # a prefix-cache hit starts the chunk loop at the first position that
        # was not reused: the reused pages' KV is already in the pool
        reuse = self._reuse.get(slot, 0)
        self._prefilling[slot] = (toks, reuse)
        if reuse:  # the draft model has no pages to reuse: it takes the prefix now
            self._draft_prefill(slot, toks[:reuse], 0)
        self.pos[slot] = 0  # the table row stays 0: the slot's decode-tick
        # writes land on the scratch page, never on owned pages

    def _prefill_chunk_device(self, slot: int, chunk: list[int], filled: int) -> torch.Tensor:
        tokens = torch.tensor([chunk], dtype=torch.long, device=self.device)
        self._draft_prefill(slot, chunk, filled)
        return paged_prefill_chunk(self.weights, self.cache, tokens, filled, self._owned[slot],
                                   self.cfg, self.compute_dtype)

    def _prefill_complete(self, slot: int):
        pages = self._owned[slot]
        self._table[slot, :] = 0
        self._table[slot, : len(pages)] = pages
        self._push_table()
        if self._prefix_on:
            # register this prompt's FULL pages (their KV is final: decode
            # writes start past them); the first registration of a digest wins
            for i, dig in enumerate(self._slot_digests.pop(slot, [])):
                pg = pages[i]
                if dig not in self._hash_page and pg not in self._page_hash:
                    self._hash_page[dig] = pg
                    self._page_hash[pg] = dig

    def _prefill_into(self, slot: int, req: Request):
        """Synchronous admission: prefill a dense scratch cache of whole
        pages, then scatter it into the pool."""
        toks = self._trim_prompt(req)
        if not self._claim_pages(slot, req, toks):
            return
        pages = self._owned[slot]
        dense = KVCache.create(self.cfg, 1, len(pages) * PAGE, self.kv_dtype, self.device)
        tokens = torch.tensor([toks], dtype=torch.long, device=self.device)
        logits = forward(self.weights, dense, tokens, torch.zeros(1, dtype=torch.int32),
                         self.cfg, self.compute_dtype)
        _scatter_prefill(self.cache, dense, pages)
        self._draft_prefill(slot, toks, 0)
        self.prefill_tokens += len(toks)
        self._prefill_complete(slot)
        self.pos[slot] = len(toks)
        self._start_decoding(slot, toks, logits[:, len(toks) - 1])

    def _ready(self, active: list[int], horizon: int) -> bool:
        """Pre-allocate every page the next `horizon` positions can touch for
        each active slot, preempting the youngest under pool pressure
        (recompute later; older requests keep making progress, so the
        cascade ends). Mutates `active` in place; False when no active slot
        survives."""
        dirty = False
        for i in list(active):  # copy: preemption below mutates membership
            if i not in active:
                continue  # preempted as a victim of an earlier slot's alloc
            # clamp at the table width: a slot at the seq_len edge finishes
            # via _deliver's length check before touching pages beyond it
            need = min((int(self.pos[i]) + horizon - 1) // PAGE + 1, self.max_pages)
            while len(self._owned[i]) < need:
                new = self._alloc(1)
                if new is None:
                    victim = max(active, key=lambda j: self.slots[j].request_id)
                    self._preempt(victim)
                    active.remove(victim)
                    dirty = True
                    if victim == i:
                        break
                    continue
                self._table[i, len(self._owned[i])] = new[0]
                self._owned[i].extend(new)
                dirty = True
        if dirty:
            self._push_table()
        return bool(active)

    def _step_logits(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return paged_decode_step(self.weights, self.cache, tok, pos, self.cfg,
                                 self.compute_dtype)

    def _verify_logits(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return paged_verify_step(self.weights, self.cache, tokens, pos, self.cfg,
                                 self.compute_dtype)

    def _release_pages(self, slot: int):
        for pg in self._owned[slot]:
            r = self._ref.get(pg, 1) - 1
            self._ref[pg] = r
            if r > 0:
                continue  # still shared with another live slot
            dig = self._page_hash.get(pg)
            if dig is not None:
                # registered prompt page: keep as evictable cache so a later
                # identical prefix still hits (freed under pressure)
                self._evictable.append(dig)
            else:
                self._free.append(pg)
        self._owned[slot] = []
        self._slot_digests.pop(slot, None)
        self._reuse.pop(slot, None)
        # reset the row to the scratch page: the idle slot keeps stepping and
        # must never write into a page that gets reallocated
        self._table[slot, :] = 0
        self._push_table()

    def _finish(self, slot: int, reason: str):
        self._release_pages(slot)
        super()._finish(slot, reason)

    def _preempt(self, slot: int):
        """Recompute-style preemption: under pool pressure a running request
        releases its pages and goes back to the pending queue with its
        generated tokens folded into the prompt, so a later admission
        prefills again (helped by the prefix cache when its registered pages
        survive) and decoding continues where it stopped."""
        req = self.slots[slot]
        self._release_pages(slot)
        self._clear_slot(slot)
        # idempotent across repeated preemptions: always rebuild from the
        # ORIGINAL prompt + everything generated so far
        orig = getattr(req, "_orig_prompt", None)
        if orig is None:
            orig = list(req.prompt_tokens)
            req._orig_prompt = orig
        req.prompt_tokens = orig + list(req.output_tokens)
        self.preemptions += 1
        self.pending.put(req)
