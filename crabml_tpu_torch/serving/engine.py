"""Continuous-batching serving engine over a pool of KV-cache slots.

Counterpart of crabml_tpu/serving/engine.py (Request, LatencyHistogram,
ServingEngine), speculative serving included. A fixed pool of slots is the
batch: requests are admitted into free slots as they open, prompts prefill in
bounded chunks between decode ticks, and one decode tick advances every slot.
Idle and mid-prefill slots still step; the host ignores their token.

Prompt chunks are forwarded at their exact length (no power-of-two padding).
`step(multi)` is the counterpart of the JAX package's fused `_decode_scan`:
the per-slot state is plain numpy on the host, copied into static device
buffers (`_TickState`) once per step; then `multi` ticks run on the device,
each sampling every slot, writing its tokens (and their logprobs) into an
output ring and feeding them back, the penalties' recent window shifted in
the tick; then the host reads the (B, multi) tokens once, the logprobs only
when a live request asked for them, and delivers them in order. On the card
the tick is one captured CUDA graph (runtime/generate.py::StepGraph), one per
set of sampling processors in use, captured when first needed; on the CPU
it runs eagerly.

Speculative serving (`speculative` = K > 0): a step verifies each slot's
current token and K drafts in one forward of K + 1 tokens a slot
(models.forward.verify_step, the decode kernels at T = K + 1; the paged
engine writes and reads through its block table). Drafts come from prompt
lookup over the request's tokens, or from a small draft model
(`draft_runner`, or the Runner's `draft_model`) whose dense slot cache
follows the target's positions: admission prefills it, a plain tick
teacher-forces its tokens into it. A slot whose tokens can be speculated
exactly (greedy, no penalty, bias or logprobs: `_spec_eligible`) takes the
longest drafted prefix the verify's argmax agrees with and the verify's own
next token; any other slot takes the sample of the verify's position 0,
drawn with its own sampling state, so mixed traffic still speculates. With
`spec_fused` and `step(multi)`, up to `multi` rounds run with the drafts
made on the device and the host reads the tokens once (`_spec_scan`; the
dense engine's default, as in the JAX package); otherwise one verify a step
with drafts made on the host. Rounds run eagerly: no CUDA graph is captured
for them yet. Speculation gives way to the plain tick when no active slot
can speculate or a round could pass the end of the cache. A greedy
request's tokens are plain greedy decode's wherever the verify's rows take
the tick's matmul route; where they do not (on the card a verify of more
than 16 rows takes the dequant kernel, the tick int8 activations), a near tie
between two logits may go the other way.

All device work happens on the thread that calls `step` (`run_forever` on the
daemon's engine thread); other threads only touch the queues.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from ..errors import ConfigError, UnsupportedError
from ..models.forward import KVCache, decode_step, forward, verify_step
from ..ops.cuda.flash_attention import check_card_model
from ..runtime.generate import RING, StepGraph
from ..runtime.sampler import LOGPROB_TOPK, sample_batch
from ..runtime.speculative import accept, draft_chain, draft_tokens, write_history
from ..tokenizer import Utf8Buf
from ..utils import resolve_device


def _prefill_slot(weights, cache: KVCache, tokens, slot: int, pos0: int, cfg, compute_dtype):
    """Forward `tokens` (1, T) through slot `slot` of the pooled cache,
    starting at `pos0`, writing that slot's cache in place -> logits (1, T, V)."""
    return forward(weights, cache.slot(slot), tokens, torch.tensor([pos0], dtype=torch.int32),
                   cfg, compute_dtype)


def _lookup_draft(ctx, K: int) -> list[int]:
    """Prompt-lookup drafting on the host (crabml_tpu/serving/engine.py's
    _lookup_draft): the K tokens that followed the most recent earlier
    occurrence of the context's last 2-gram, zero-padded; no match: K zeros
    (the verify still emits its own next token)."""
    c = np.asarray(ctx, np.int64)
    if c.size >= 3:
        hits = np.nonzero((c[:-2] == c[-2]) & (c[1:-1] == c[-1]))[0]
        if hits.size:
            i = int(hits[-1])
            d = c[i + 2: i + 2 + K].tolist()
            return d + [0] * (K - len(d))
    return [0] * K


def _accept_round(g, dr, nxt, token, active, eligible):
    """One round's acceptance over the pool (crabml_tpu/serving/engine.py's
    _accept_round): an eligible slot takes its longest drafted prefix that
    the argmax g (B, K+1) agrees with and g's next token, any other active
    slot the sample nxt of position 0; an inactive slot emits nothing and
    keeps its token. -> (out (B, K+1) tokens to emit, count (B,), token)."""
    n_acc = torch.where(eligible, accept(g, dr), 0)
    count = torch.where(active, n_acc + 1, 0)
    chosen = g.gather(1, n_acc[:, None])[:, 0]
    token = torch.where(active, torch.where(eligible, chosen, nxt), token)
    out = g.clone()
    out[:, 0] = torch.where(eligible, g[:, 0], nxt)
    return out, count, token


def _spec_scan(verify, hist, token, pos, active, eligible, sampling, recent, generator,
               chain, rounds: int, K: int, match_len: int = 2):
    """`rounds` draft + verify rounds over the slot pool, on the device with
    no host read (crabml_tpu/serving/engine.py::_spec_scan). verify(tokens
    (B, K+1), pos (B,)) -> logits (B, K+1, V) writes the slots' k/v; drafts
    come from `chain`(token, pos) -> (B, K) (the draft model) or, when it is
    None, from the 2-gram lookup over hist (B, S). sampling(recent) -> the
    sample_batch keywords of position 0, whose penalties read the `recent`
    window (B, W), shifted by each round's token. -> (outs (R, B, K+1),
    counts (R, B), (token logprobs (R, B), top logprobs, top ids))."""
    outs, counts, lps = [], [], []
    rec = recent
    for _ in range(rounds):
        if chain is not None:
            dr = chain(token, pos)
        else:
            dr, hist = draft_tokens(hist, token, pos, K, match_len)
        logits = verify(torch.cat([token[:, None], dr], dim=1), pos)
        g = logits.argmax(dim=-1)
        nxt, lp = sample_batch(logits[:, 0], generator, with_logprobs=True, **sampling(rec))
        out, count, token = _accept_round(g, dr, nxt, token, active, eligible)
        if chain is None:
            write_history(hist, out, pos)
        rec = torch.cat([rec[:, 1:], token[:, None]], dim=1)
        pos = pos + count.to(torch.int32)
        outs.append(out)
        counts.append(count)
        lps.append(lp)
    return (torch.stack(outs), torch.stack(counts),
            tuple(torch.stack(a) for a in zip(*lps)))


@dataclass(frozen=True)
class Processors:
    """Which sampling processors a tick runs: the key of its captured graph."""

    sampled: bool  # some slot samples at a temperature (else argmax only)
    minp: bool
    repetition: bool
    freq_pres: bool
    bias: bool


class _TickState:
    """The tick's static device buffers: the host copies the slots' state in
    before the ticks of a step, the ticks read and move them on, and write
    their tokens and logprobs at the ring's counter."""

    def __init__(self, n: int, window: int, device):
        def f32(*shape, fill=0.0):
            return torch.full(shape, fill, dtype=torch.float32, device=device)

        self.tok = torch.zeros(n, dtype=torch.long, device=device)
        self.pos = torch.zeros(n, dtype=torch.int32, device=device)
        self.temp, self.topp, self.minp = f32(n), f32(n, fill=1.0), f32(n)
        self.rep_pen, self.freq_pen, self.pres_pen = f32(n, fill=1.0), f32(n), f32(n)
        self.recent = torch.full((n, window), -1, dtype=torch.long, device=device)
        self.count = torch.zeros(1, dtype=torch.long, device=device)
        self.toks = torch.zeros(n, RING, dtype=torch.long, device=device)
        self.tok_lp = f32(n, RING)
        self.top_lp = f32(n, RING, LOGPROB_TOPK)
        self.top_id = torch.zeros(n, RING, LOGPROB_TOPK, dtype=torch.long, device=device)


def _sampling_kwargs(proc: Processors, p, bias) -> dict:
    """sample_batch's keyword arguments for the processors in use, from `p`'s
    device tensors temp, topp, minp, recent, rep_pen, freq_pen, pres_pen: a
    processor that is off is None, so an all-greedy pool pays for an argmax
    only."""
    kw = {"temperature": None, "topp": None}
    if proc.sampled:
        kw["temperature"], kw["topp"] = p.temp, p.topp
        if proc.minp:
            kw["minp"] = p.minp
    if proc.repetition or proc.freq_pres:
        kw["recent_tokens"] = p.recent
    if proc.repetition:
        kw["repetition_penalty"] = p.rep_pen
    if proc.freq_pres:
        kw["frequency_penalty"], kw["presence_penalty"] = p.freq_pen, p.pres_pen
    if proc.bias:
        kw["logit_bias"] = bias
    return kw


@dataclass
class Request:
    prompt: str
    max_tokens: int = 256
    temperature: float = 0.0
    topp: float = 0.9
    minp: float = 0.0  # min-p filter (0 = off)
    repetition_penalty: float = 1.0  # llama.cpp repeat penalty (1 = off)
    frequency_penalty: float = 0.0  # OpenAI-style, over the recent window
    presence_penalty: float = 0.0
    # OpenAI logit_bias: sparse (token_id, bias) pairs added to the logits
    logit_bias: tuple[tuple[int, float], ...] = ()
    stop_token_ids: tuple[int, ...] = ()
    stop: tuple[str, ...] = ()  # stop strings (merged across token pieces)
    # None = off; N >= 0 records each sampled token's logprob plus the top-N
    # alternatives (N <= sampler.LOGPROB_TOPK)
    logprobs: int | None = None
    request_id: int = field(default_factory=itertools.count().__next__)

    # filled by the engine
    prompt_tokens: list[int] = field(default_factory=list, repr=False)
    output_tokens: list[int] = field(default_factory=list, repr=False)
    output_logprobs: list[float] = field(default_factory=list, repr=False)
    output_top_logprobs: list[list[tuple[int, float]]] = field(default_factory=list, repr=False)
    finish_reason: str | None = None
    output_text: str | None = None  # decoded + stop-trimmed (when stop set)
    cancelled: bool = field(default=False, repr=False)  # set via engine.cancel
    _t_submit: float = field(default=0.0, repr=False)
    _t_first: float = field(default=0.0, repr=False)  # first delivered token
    _t_finish: float = field(default=0.0, repr=False)
    _stream: "queue.SimpleQueue[str | None] | None" = field(default=None, repr=False)
    _utf8: Utf8Buf = field(default_factory=Utf8Buf, repr=False)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


class LatencyHistogram:
    """Prometheus-style cumulative histogram (fixed buckets, host-side). It
    also keeps the last RECENT observations, so a run can report quantiles."""

    BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
    RECENT = 4096  # bounded: a daemon observes for as long as it runs

    def __init__(self):
        self.counts = [0] * (len(self.BUCKETS) + 1)
        self.sum = 0.0
        self.n = 0
        self.values: collections.deque[float] = collections.deque(maxlen=self.RECENT)

    def observe(self, v: float):
        self.sum += v
        self.n += 1
        self.values.append(v)
        for i, le in enumerate(self.BUCKETS):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """The q-quantile of the recent observations (nearest rank); 0 when empty."""
        if not self.values:
            return 0.0
        ordered = sorted(self.values)
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    def render(self, name: str) -> str:
        out = [f"# TYPE {name} histogram"]
        c = 0
        for le, k in zip(self.BUCKETS, self.counts):
            c += k
            out.append(f'{name}_bucket{{le="{le}"}} {c}')
        out.append(f'{name}_bucket{{le="+Inf"}} {self.n}')
        out.append(f"{name}_sum {round(self.sum, 6)}")
        out.append(f"{name}_count {self.n}")
        return "\n".join(out) + "\n"


class ServingEngine:
    """Slot-pool continuous batching on one device.

    Drive it either synchronously (`submit()` then `step()` until done, or
    `generate(prompts)`) or via `run_forever()` on a thread with
    `enqueue_streaming()` from request handlers (serving.http does this).
    It runs on `cuda` (the runner's device) unless the caller passes
    `device="cpu"`.

    Frequency/presence penalties count only the most recent REPEAT_WINDOW
    output tokens, not the whole context as OpenAI's semantics do.

    `speculative` = K > 0 turns on speculative serving (module note); a
    Runner built with a `draft_model` lends its draft model and, unless K
    is given, its K. `spec_fused` (default SPEC_FUSED_DEFAULT) lets
    `step(multi)` run `multi` rounds with the drafts made on the device.
    """

    REPEAT_WINDOW = 64
    SPEC_FUSED_DEFAULT = True  # the JAX package's dense default

    def __init__(self, runner=None, *, weights=None, cfg=None, tokenizer=None,
                 n_slots: int = 8, seq_len: int | None = None, compute_dtype=torch.float32,
                 kv_dtype=None, seed: int = 0, tick_tokens: int = 1,
                 prefill_chunk: int | None = 256, kv_lane_pad: bool = False,
                 repeat_window: int | None = None, device=None, speculative: int = 0,
                 draft_runner=None, spec_fused: bool | None = None):
        del kv_lane_pad  # the JAX engine's argument; changes nothing here (Runner's note)
        if repeat_window is not None:
            self.REPEAT_WINDOW = max(1, int(repeat_window))
        if runner is not None:
            weights, cfg, tokenizer = runner.weights, runner.cfg, runner.tokenizer
            compute_dtype = runner.compute_dtype
            device = runner.device if device is None else device
            if draft_runner is None:
                draft_runner = getattr(runner, "_draft", None)
                if draft_runner is not None and not speculative:
                    speculative = runner.speculative
        self.device = resolve_device(device)
        if weights is None or cfg is None:
            raise ConfigError("ServingEngine needs a runner, or weights and cfg")
        check_card_model(cfg, self.device, compute_dtype)
        self.weights = weights
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.seq_len = min(seq_len or cfg.seq_len, cfg.seq_len)
        self.compute_dtype = compute_dtype
        self.kv_dtype = kv_dtype or compute_dtype
        self._seed = seed

        self.slots: list[Request | None] = [None] * n_slots
        self.pending: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()  # handler threads submit concurrently
        self.steps = 0
        # >1: run_forever runs this many decode ticks per step while the
        # admission queue is empty
        self.tick_tokens = max(1, tick_tokens)
        # chunked-prefill admission: each step() forwards at most this many
        # prompt tokens of ONE admitting request before the decode tick, so
        # admission never stalls running requests for longer than a chunk.
        # None = synchronous (whole prompt at admit).
        self.prefill_chunk = prefill_chunk
        self.tokens_generated = 0
        self.prefill_tokens = 0  # prompt tokens forwarded (reused pages excluded)
        self.requests_submitted = 0
        self.requests_completed = 0
        self.ttft_hist = LatencyHistogram()  # submit -> first token
        self.e2e_hist = LatencyHistogram()  # submit -> finish
        self._started = None  # first-step timestamp (serving uptime)
        self.speculative = max(0, int(speculative))  # draft length K, 0 = off
        self.spec_fused = self.SPEC_FUSED_DEFAULT if spec_fused is None else spec_fused
        self.spec_ticks = 0  # speculative rounds run
        self.spec_tokens = 0  # tokens that greedy slots took from them
        self._draft = None
        if draft_runner is not None and self.speculative:
            if draft_runner.cfg.vocab_size != cfg.vocab_size:
                raise UnsupportedError(
                    f"draft model vocab {draft_runner.cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: speculative verify needs a shared tokenizer")
            self._draft = draft_runner
        self._reset_device_state()

    def _reset_device_state(self):
        """Build (or, after a failed step, rebuild) the cache and the
        per-slot host state. Subclasses that own other device state (page
        pools) rebuild it in _make_cache."""
        n = self.n_slots
        self.cache = self._make_cache()
        # the draft model's slot cache (dense in both engines), its positions
        # those of the target's slots
        self._draft_cache = None if self._draft is None else KVCache.create(
            self._draft.cfg, n, self.seq_len, self._draft.kv_dtype, self.device)
        self.pos = np.zeros(n, np.int32)
        self.cur_tok = np.zeros(n, np.int64)
        self.temp = np.zeros(n, np.float32)
        self.topp = np.ones(n, np.float32)
        self.minp = np.zeros(n, np.float32)
        self.rep_pen = np.ones(n, np.float32)
        self.freq_pen = np.zeros(n, np.float32)
        self.pres_pen = np.zeros(n, np.float32)
        # penalty window (last REPEAT_WINDOW context tokens, -1 padded)
        self.recent = np.full((n, self.REPEAT_WINDOW), -1, np.int64)
        # per-slot dense logit-bias rows on the device, made at the first
        # request that sets a bias and updated only on admit and finish
        self._bias_dev = None
        # slot -> (prompt tokens, n_filled) for mid-prefill requests; such
        # slots are claimed (self.slots[slot] set) but not yet decoded
        self._prefilling: dict[int, tuple[list[int], int]] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self._seed)
        self._ticks = _TickState(n, self.REPEAT_WINDOW, self.device)
        self._graphs: dict[Processors, StepGraph] = {}  # the captured ticks on the card

    def _bias(self) -> torch.Tensor:
        if self._bias_dev is None:
            self._bias_dev = torch.zeros(self.n_slots, self.cfg.vocab_size,
                                         dtype=torch.float32, device=self.device)
        return self._bias_dev

    def _set_slot_bias(self, slot: int, req: Request):
        if not req.logit_bias and self._bias_dev is None:
            return  # nothing set anywhere yet
        row = np.zeros(self.cfg.vocab_size, np.float32)
        for tid, val in req.logit_bias:
            if 0 <= int(tid) < self.cfg.vocab_size:
                row[int(tid)] = float(val)
        self._bias()[slot] = torch.from_numpy(row).to(self.device)

    def _make_cache(self):
        """Cache-construction hook (PagedServingEngine builds its pool here:
        the dense n_slots x seq_len allocation must never happen there)."""
        return KVCache.create(self.cfg, self.n_slots, self.seq_len, self.kv_dtype, self.device)

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Queue a request (thread-safe). It is admitted to a slot on the
        next step() with a free slot."""
        if not req.prompt_tokens:
            req.prompt_tokens = self.tokenizer.encode(req.prompt, bos=True)
        req.stop = tuple(s for s in req.stop if isinstance(s, str) and s)
        with self._submit_lock:
            self.requests_submitted += 1
        req._t_submit = time.monotonic()
        self.pending.put(req)
        return req

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _occupied(self) -> int:
        return sum(r is not None for r in self.slots)

    def cancel(self, req: Request):
        """Abort a request (e.g. the HTTP client disconnected): it finishes
        with reason "cancelled" at its next queue pop, prefill chunk or
        delivered token, freeing its slot (and pages)."""
        req.cancelled = True

    def _admit(self):
        free = self._free_slots()
        while free:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            if req.cancelled:  # never claimed a slot: close it directly
                req.finish_reason = "cancelled"
                self.requests_completed += 1
                if req._t_submit:
                    self.e2e_hist.observe(time.monotonic() - req._t_submit)
                if req._stream is not None:
                    req._stream.put(None)
                continue
            slot = free.pop(0)
            if self.prefill_chunk is None:
                self._prefill_into(slot, req)
            else:
                self._claim_for_prefill(slot, req)

    def _trim_prompt(self, req: Request) -> list[int]:
        toks = req.prompt_tokens
        limit = self.seq_len - 1
        if len(toks) > limit:
            toks = toks[-limit:]  # keep the tail, like a sliding window
        return toks

    def _claim_for_prefill(self, slot: int, req: Request):
        """Claim the slot host-side only; chunks run in later step()s. While
        mid-prefill, pos[slot] == n_filled: the decode tick still steps the
        slot and writes garbage KV at that position, which the next chunk
        (whose span starts there) or the first real decode token overwrites
        before any attention can read it."""
        self.slots[slot] = req
        self._prefilling[slot] = (self._trim_prompt(req), 0)
        self.pos[slot] = 0

    def _prefill_tick(self):
        """Forward ONE chunk of the oldest mid-prefill request."""
        if not self._prefilling:
            return
        slot = next(iter(self._prefilling))
        if self.slots[slot].cancelled:  # client gone mid-admission
            self._finish(slot, "cancelled")
            return
        toks, filled = self._prefilling[slot]
        chunk = toks[filled : filled + self.prefill_chunk]
        logits = self._prefill_chunk_device(slot, chunk, filled)
        self.prefill_tokens += len(chunk)
        filled += len(chunk)
        self.pos[slot] = filled
        if filled < len(toks):
            self._prefilling[slot] = (toks, filled)
            return
        del self._prefilling[slot]
        self._prefill_complete(slot)
        self._start_decoding(slot, toks, logits[:, len(chunk) - 1])

    def _start_decoding(self, slot: int, toks: list[int], last_logits: torch.Tensor):
        """The slot's whole prompt is in cache: set its sampling state and
        sample its first token from the last prompt token's logits (1, V)."""
        req = self.slots[slot]
        tail = toks[-self.REPEAT_WINDOW:]
        self.recent[slot] = -1
        self.recent[slot, -len(tail):] = tail
        self._set_slot_bias(slot, req)
        self.temp[slot] = req.temperature
        self.topp[slot] = req.topp
        self.minp[slot] = req.minp
        self.rep_pen[slot] = req.repetition_penalty
        self.freq_pen[slot] = req.frequency_penalty
        self.pres_pen[slot] = req.presence_penalty
        first, first_lp = sample_batch(last_logits, self._gen, with_logprobs=True,
                                       **self._sampling([slot]))
        self._deliver_first(slot, req, first, first_lp)

    def _processors(self, rows=None) -> Processors:
        """The processors that slots `rows` (default: the whole pool) use."""
        sel = slice(None) if rows is None else rows
        sampled = bool((self.temp[sel] > 0).any())
        return Processors(
            sampled=sampled, minp=sampled and bool((self.minp[sel] > 0).any()),
            repetition=bool((self.rep_pen[sel] != 1.0).any()),
            freq_pres=bool((self.freq_pen[sel] != 0).any() or (self.pres_pen[sel] != 0).any()),
            bias=self._bias_dev is not None)

    def _sampling(self, rows) -> dict:
        """sample_batch's keyword arguments for the slots `rows` alone (a
        first token sampled from prefill logits), uploaded from the host."""
        p = SimpleNamespace(**{
            n: torch.from_numpy(np.ascontiguousarray(getattr(self, n)[rows])).to(self.device)
            for n in ("temp", "topp", "minp", "recent", "rep_pen", "freq_pen", "pres_pen")})
        return _sampling_kwargs(self._processors(rows), p,
                                None if self._bias_dev is None else self._bias_dev[rows])

    def _prefill_chunk_device(self, slot: int, chunk: list[int], filled: int) -> torch.Tensor:
        """Forward `chunk` into the slot's cache at position `filled`;
        returns logits (1, len(chunk), V). Hook for PagedServingEngine."""
        tokens = torch.tensor([chunk], dtype=torch.long, device=self.device)
        self._draft_prefill(slot, chunk, filled)
        return _prefill_slot(self.weights, self.cache, tokens, slot, filled, self.cfg,
                             self.compute_dtype)

    def _draft_prefill(self, slot: int, chunk: list[int], filled: int):
        """Two-model speculation: `chunk` into the draft model's slot cache at
        `filled`, so that it holds the prompt as the target's does."""
        if self._draft_cache is None:
            return
        d = self._draft
        _prefill_slot(d.weights, self._draft_cache,
                      torch.tensor([chunk], dtype=torch.long, device=self.device), slot, filled,
                      d.cfg, d.compute_dtype)

    def _prefill_complete(self, slot: int):
        """Called once a slot's whole prompt is in cache (before its first
        sample). Hook for PagedServingEngine."""

    def _prefill_into(self, slot: int, req: Request):
        """Synchronous admission (prefill_chunk=None): the whole prompt now."""
        toks = self._trim_prompt(req)
        # claim the slot BEFORE device work: if prefill raises, run_forever's
        # recovery finds the request in self.slots and closes its stream
        self.slots[slot] = req
        logits = self._prefill_chunk_device(slot, toks, 0)  # the draft model's too
        self.prefill_tokens += len(toks)
        self.pos[slot] = len(toks)
        self._start_decoding(slot, toks, logits[:, len(toks) - 1])

    # -- the tick -----------------------------------------------------------

    def _active(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is not None and i not in self._prefilling]

    def _ready(self, active: list[int], multi: int) -> bool:
        """Hook run before the decode ticks of a step (paged: allocate the
        pages the next `multi` positions touch). May shrink `active` in
        place; False when no active slot is left."""
        return True

    def _step_logits(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One decode step of the slot pool from device tok (B,) and pos (B,)
        -> logits (B, V). PagedServingEngine reads its pool instead."""
        return decode_step(self.weights, self.cache, tok[:, None], pos, self.cfg,
                           self.compute_dtype)

    def _tick(self, proc: Processors, generator):
        """One tick on the static buffers: forward every slot, sample it with
        the processors `proc`, write the tokens and logprobs into the ring at
        the counter, shift the recent window, feed the tokens back."""
        s = self._ticks
        logits = self._step_logits(s.tok, s.pos)
        nxt, lps = sample_batch(logits, generator, with_logprobs=True,
                                **_sampling_kwargs(proc, s, self._bias_dev))
        for ring, a in zip((s.toks, s.tok_lp, s.top_lp, s.top_id), (nxt, *lps)):
            ring.index_copy_(1, s.count, a[:, None])
        if proc.repetition or proc.freq_pres:
            s.recent.copy_(torch.cat([s.recent[:, 1:], nxt[:, None]], dim=1))
        s.tok.copy_(nxt)
        s.pos.add_(1)
        s.count.add_(1)

    def _upload(self, proc: Processors):
        """Copy the host's slot state into the static buffers."""
        s = self._ticks
        pairs = [(s.tok, self.cur_tok), (s.pos, self.pos)]
        if proc.sampled:
            pairs += [(s.temp, self.temp), (s.topp, self.topp), (s.minp, self.minp)]
        if proc.repetition or proc.freq_pres:
            pairs += [(s.recent, self.recent), (s.rep_pen, self.rep_pen),
                      (s.freq_pen, self.freq_pen), (s.pres_pen, self.pres_pen)]
        for dev, host in pairs:
            dev.copy_(torch.from_numpy(host))

    def _run_ticks(self, multi: int, logprobs: bool):
        """`multi` ticks on the device, then one read: -> (tokens (B, multi),
        (token logprob, top logprobs, top ids) or None when `logprobs` is
        False) as numpy."""
        s = self._ticks
        proc = self._processors()
        self._upload(proc)
        graph = self._graphs.get(proc)
        if graph is None and self.device.type == "cuda":
            pool = next((g.pool() for g in self._graphs.values()), None)
            graph = self._graphs[proc] = StepGraph(
                lambda gen: self._tick(proc, gen), self.device, pool,
                self._gen if proc.sampled else None)
            self._upload(proc)  # the warm-up moved the buffers on
        s.count.zero_()
        if graph is not None:
            graph.replay(multi)
        else:  # the CPU: the same tick, eagerly
            for _ in range(multi):
                self._tick(proc, self._gen)
        toks = s.toks[:, :multi].cpu().numpy()
        if not logprobs:
            return toks, None
        return toks, tuple(a[:, :multi].cpu().numpy() for a in (s.tok_lp, s.top_lp, s.top_id))

    def step(self, multi: int = 1) -> int:
        """Admit pending requests, run one prefill chunk (if any request is
        mid-admission), run `multi` decode ticks on the device and deliver
        their tokens. Returns the number of occupied slots afterwards."""
        self._admit()
        self._prefill_tick()
        active = self._active()
        if not active:
            return self._occupied()
        # cap the ticks at the ring and so that no slot's writes pass
        # seq_len-1: over ALL slots, since a mid-prefill slot also gets a KV
        # write per tick at its filled offset
        pmax = int(self.pos.max())
        multi = max(1, min(multi, RING, self.seq_len - 1 - pmax))
        snapshot = list(self.slots)  # which request owned each slot at the start
        pos0 = self.pos.copy()
        if self.speculative:
            n = None
            if multi > 1 and self.spec_fused:  # rounds on the device, drafts there too
                n = self._spec_scan_tick(active, snapshot, pos0, pmax, multi)
            if n is None and active:
                n = self._spec_tick(active, snapshot, pos0, pmax)
            if n is not None or not active:  # not active: the page hook preempted them all
                return self._occupied()
        if not self._ready(active, multi):
            return self._occupied()
        snapshot, pos0 = list(self.slots), self.pos.copy()  # after any preemption
        if self._started is None:
            self._started = time.monotonic()
        cur = self.cur_tok.copy()
        toks, lp = self._run_ticks(multi, any(snapshot[i].logprobs is not None for i in active))
        self._draft_sync(cur, toks, pos0)
        self.pos[active] += multi
        self.steps += multi
        for j in range(multi):
            for i in active:
                if self.slots[i] is not snapshot[i]:
                    continue  # finished (or replaced) earlier in this step
                self.tokens_generated += 1
                self._deliver(i, int(toks[i, j]), pos_after=int(pos0[i]) + j + 1,
                              logprob=None if lp is None else float(lp[0][i, j]),
                              top=None if lp is None else (lp[2][i, j], lp[1][i, j]))
        return self._occupied()

    def _draft_sync(self, cur: np.ndarray, toks: np.ndarray, pos0: np.ndarray):
        """Two-model speculation after a plain tick: the tokens every slot
        consumed (cur, then the tick's tokens but the last) go through the
        draft model at the slots' positions, so that its cache has no gap
        where the target decoded without it."""
        if self._draft_cache is None:
            return
        d = self._draft
        inputs = np.concatenate([cur[:, None], toks[:, :-1]], axis=1)
        forward(d.weights, self._draft_cache, torch.from_numpy(inputs).to(self.device),
                torch.from_numpy(pos0), d.cfg, d.compute_dtype)

    # -- speculative ticks ------------------------------------------------------

    @staticmethod
    def _spec_eligible(r: Request) -> bool:
        """Whether a request's tokens can be speculated exactly: argmax
        decoding (temperature 0, no penalty or bias, which change the
        chosen token) and no logprobs (an accepted draft has no sampled
        logprob)."""
        return (r.temperature == 0.0 and not r.logit_bias and r.logprobs is None
                and r.repetition_penalty == 1.0 and not r.frequency_penalty
                and not r.presence_penalty)

    def _verify_logits(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The verify forward of the pool: tokens (B, K+1) and pos (B,) on the
        device -> logits (B, K+1, V), the slots' k/v written at pos ..
        pos + K. PagedServingEngine verifies through its block table."""
        return verify_step(self.weights, self.cache, tokens, pos, self.cfg, self.compute_dtype)

    def _spec_tick(self, active, snapshot, pos0, pmax) -> int | None:
        """One verify step with drafts made on the host (_make_drafts).
        Returns the occupied-slot count, or None to leave the step to the
        plain tick: no active slot can speculate, or the verify would pass
        the end of the cache (pmax: the highest position of any slot, since
        idle and mid-prefill slots write their K + 1 positions too)."""
        K = self.speculative
        if pmax + K + 1 > self.seq_len - 1:
            return None
        if not any(self._spec_eligible(snapshot[i]) for i in active):
            return None
        if not self._ready(active, K + 1):  # paged: every page the verify writes
            return None
        spec = [i for i in active if self._spec_eligible(snapshot[i])]
        tokens_in = np.zeros((self.n_slots, K + 1), np.int64)
        tokens_in[:, 0] = self.cur_tok
        drafts = self._make_drafts(spec, snapshot, K)
        tokens_in[spec, 1:] = drafts[spec]
        if self._started is None:
            self._started = time.monotonic()
        logits = self._verify_logits(torch.from_numpy(tokens_in).to(self.device),
                                     torch.from_numpy(self.pos).to(self.device))
        nxt, lp = sample_batch(logits[:, 0], self._gen, with_logprobs=True,
                               **self._sampling(np.arange(self.n_slots)))
        out = logits.argmax(dim=-1).cpu().numpy()
        nxt = nxt.cpu().numpy()
        spec_set = set(spec)
        acc = {}
        for i in active:
            m = 0
            if i in spec_set:
                while m < K and tokens_in[i, m + 1] == out[i, m]:
                    m += 1
            acc[i] = m
        tok_lp = top_lp = top_id = None
        if any(snapshot[i].logprobs is not None for i in active if i not in spec_set):
            tok_lp, top_lp, top_id = (a.cpu().numpy() for a in lp)
        for i in active:
            self.pos[i] += acc[i] + 1
        self.steps += 1
        self.spec_ticks += 1
        for j in range(K + 1):
            for i in active:
                if j > acc[i] or self.slots[i] is not snapshot[i]:
                    continue  # the rejected tail, or finished earlier in this step
                self.tokens_generated += 1
                if i in spec_set:
                    self.spec_tokens += 1
                    self._deliver(i, int(out[i, j]), pos_after=int(pos0[i]) + j + 1)
                else:  # j == 0: the sampled token
                    self._deliver(i, int(nxt[i]), pos_after=int(pos0[i]) + 1,
                                  logprob=None if tok_lp is None else float(tok_lp[i]),
                                  top=None if top_id is None else (top_id[i], top_lp[i]))
        return self._occupied()

    def _spec_scan_tick(self, active, snapshot, pos0, pmax, multi: int) -> int | None:
        """Up to `multi` rounds in one go with the drafts made on the device
        (_spec_scan); the host reads the tokens once. None when fewer than 2
        rounds fit before the end of the cache or the requests' budgets, or
        no active slot can speculate: the single verify step is tried next."""
        K = self.speculative
        rounds = min(multi, (self.seq_len - 1 - pmax) // (K + 1))
        # every round emits at least one token a slot: no more rounds than
        # the largest remaining budget
        rem = max(snapshot[i].max_tokens - len(snapshot[i].output_tokens) for i in active)
        rounds = min(rounds, max(rem, 1))
        if rounds < 2 or not any(self._spec_eligible(snapshot[i]) for i in active):
            return None
        if not self._ready(active, rounds * (K + 1)):
            return None
        spec = [i for i in active if self._spec_eligible(snapshot[i])]
        B = self.n_slots
        hist = np.zeros((B, self.seq_len), np.int64)
        for i in active:
            r = snapshot[i]
            consumed = (list(self._trim_prompt(r)) + r.output_tokens[:-1])[: int(pos0[i])]
            hist[i, : len(consumed)] = consumed
        eligible = np.zeros(B, bool)
        eligible[spec] = True
        active_m = np.zeros(B, bool)
        active_m[active] = True
        if self._started is None:
            self._started = time.monotonic()
        outs, counts, lp = self._run_spec_scan(hist, active_m, eligible, rounds, K)
        outs, counts = outs.cpu().numpy(), counts.cpu().numpy()
        spec_set = set(spec)
        tok_lp = top_lp = top_id = None
        if any(snapshot[i].logprobs is not None for i in active if i not in spec_set):
            tok_lp, top_lp, top_id = (a.cpu().numpy() for a in lp)
        self.pos += counts.sum(axis=0).astype(np.int32)
        self.steps += rounds
        self.spec_ticks += rounds
        off = dict.fromkeys(active, 0)
        for r in range(rounds):
            for i in active:
                c = int(counts[r, i])
                for j in range(c):
                    if self.slots[i] is not snapshot[i]:
                        break  # finished earlier in this step
                    self.tokens_generated += 1
                    at = int(pos0[i]) + off[i] + j + 1
                    if i in spec_set:
                        self.spec_tokens += 1
                        self._deliver(i, int(outs[r, i, j]), pos_after=at)
                    else:  # c == 1: the round's sampled token
                        self._deliver(i, int(outs[r, i, 0]), pos_after=at,
                                      logprob=None if tok_lp is None else float(tok_lp[r, i]),
                                      top=None if top_id is None else (top_id[r, i],
                                                                       top_lp[r, i]))
                off[i] += c
        return self._occupied()

    def _make_drafts(self, spec, snapshot, K: int) -> np.ndarray:
        """(n_slots, K) drafts: the draft model's greedy chain of K + 1 steps
        (the last one writes the last draft's k/v, so a full accept leaves
        no hole in its cache), else prompt lookup on the host for the
        slots in `spec` (the others stay 0)."""
        if self._draft_cache is not None:
            d = self._draft
            toks = draft_chain(d.weights, self._draft_cache,
                               torch.from_numpy(self.cur_tok).to(self.device),
                               torch.from_numpy(self.pos).to(self.device), K + 1, d.cfg,
                               d.compute_dtype)
            return toks[:, :K].cpu().numpy()
        drafts = np.zeros((self.n_slots, K), np.int64)
        for i in spec:
            r = snapshot[i]
            drafts[i] = _lookup_draft(list(r.prompt_tokens) + list(r.output_tokens), K)
        return drafts

    def _run_spec_scan(self, hist, active_m, eligible, rounds: int, K: int):
        """The device half of the rounds (_spec_scan) through `_verify_logits`,
        so that the paged engine's rounds go through its block table. ->
        (outs (R, B, K+1), counts (R, B), logprob arrays) on the device."""
        dev = self.device
        proc = self._processors()
        host = {n: torch.from_numpy(np.ascontiguousarray(getattr(self, n))).to(dev)
                for n in ("temp", "topp", "minp", "rep_pen", "freq_pen", "pres_pen")}

        def sampling(rec):
            return _sampling_kwargs(proc, SimpleNamespace(recent=rec, **host), self._bias_dev)

        chain = None
        if self._draft_cache is not None:
            d = self._draft

            def chain(t, p):
                return draft_chain(d.weights, self._draft_cache, t, p, K + 1, d.cfg,
                                   d.compute_dtype)[:, :K]

        return _spec_scan(self._verify_logits, torch.from_numpy(hist).to(dev),
                          torch.from_numpy(self.cur_tok).to(dev),
                          torch.from_numpy(self.pos).to(dev),
                          torch.from_numpy(active_m).to(dev), torch.from_numpy(eligible).to(dev),
                          sampling, torch.from_numpy(self.recent).to(dev), self._gen, chain,
                          rounds, K)

    def _deliver_first(self, slot: int, req: Request, first, first_lp):
        """Deliver a slot's first sampled token (from prefill logits),
        fetching its logprobs only when the request asked."""
        if req.logprobs is not None:
            tok_lp, top_lp, top_id = (a.cpu().numpy() for a in first_lp)
            self._deliver(slot, int(first[0]), logprob=float(tok_lp[0]),
                          top=(top_id[0], top_lp[0]))
        else:
            self._deliver(slot, int(first[0]))

    def _deliver(self, slot: int, token: int, pos_after: int | None = None,
                 logprob: float | None = None, top=None):
        """Record a sampled token for slot; finish and free on EOS, a stop
        string or a limit. `pos_after`: the slot's position once the token's
        step ran (default: self.pos[slot]). `logprob`/`top` ((ids, logprobs)
        arrays) are recorded aligned with output_tokens when the request
        asked."""
        req = self.slots[slot]
        if req.cancelled:
            self._finish(slot, "cancelled")
            return
        if not req.output_tokens and req._t_submit:
            # first token ever for this request (requeued requests keep
            # their output and do not observe again)
            req._t_first = time.monotonic()
            self.ttft_hist.observe(req._t_first - req._t_submit)
        eos = self.tokenizer.eos_token if self.tokenizer else -1
        if token == eos or token in req.stop_token_ids:
            self._finish(slot, "stop")
            return
        req.output_tokens.append(token)
        if req.logprobs is not None and logprob is not None:
            req.output_logprobs.append(logprob)
            if req.logprobs > 0 and top is not None:
                ids, lps = top
                req.output_top_logprobs.append(
                    [(int(t), float(l))
                     for t, l in zip(ids[: req.logprobs], lps[: req.logprobs])])
        if (req._stream is not None or req.stop) and self.tokenizer:
            piece = self.tokenizer.decode(token, req._utf8)
            if req.stop and piece:
                # stop strings may span token boundaries and sit mid-piece.
                # On a match output_text is trimmed AT the stop even though
                # output_tokens includes the matching token.
                req.output_text = (req.output_text or "") + piece
                hits = [h for h in (req.output_text.find(s) for s in req.stop) if h >= 0]
                if hits:
                    req.output_text = req.output_text[: min(hits)]
                    self._finish(slot, "stop")
                    return
            if req._stream is not None and piece:
                req._stream.put(piece)
        self.cur_tok[slot] = token
        self.recent[slot, :-1] = self.recent[slot, 1:]
        self.recent[slot, -1] = token
        at = self.pos[slot] if pos_after is None else pos_after
        if len(req.output_tokens) >= req.max_tokens or at >= self.seq_len - 1:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str):
        req = self.slots[slot]
        req.finish_reason = reason
        self.requests_completed += 1
        req._t_finish = time.monotonic()
        if req._t_submit:
            self.e2e_hist.observe(req._t_finish - req._t_submit)
        if req._stream is not None:
            req._stream.put(None)  # sentinel: stream closed
        self._clear_slot(slot)

    def _clear_slot(self, slot: int):
        """Reset a slot's host-side state without closing its request
        (shared by _finish and the paged engine's preemption)."""
        self._prefilling.pop(slot, None)
        self.slots[slot] = None
        self.pos[slot] = 0
        self.cur_tok[slot] = 0
        self.temp[slot] = 0.0
        self.topp[slot] = 1.0
        self.minp[slot] = 0.0
        self.rep_pen[slot] = 1.0
        self.freq_pen[slot] = 0.0
        self.pres_pen[slot] = 0.0
        self.recent[slot] = -1
        if self._bias_dev is not None:
            self._bias_dev[slot] = 0.0

    # -- convenience drivers --------------------------------------------------

    def drain(self, max_steps: int | None = None):
        """Step until every queued + active request is finished."""
        n = 0
        while (any(self.slots) or not self.pending.empty()) and (max_steps is None
                                                                 or n < max_steps):
            self.step()
            n += 1

    def generate(self, prompts: list[str], **kw) -> list[str]:
        """Batch API: submit all prompts, drain, return decoded outputs."""
        reqs = [self.submit(Request(prompt=p, **kw)) for p in prompts]
        self.drain()
        outs = []
        for r in reqs:
            if r.output_text is not None:
                outs.append(r.output_text)
                continue
            buf = Utf8Buf()
            outs.append("".join(self.tokenizer.decode(t, buf) for t in r.output_tokens))
        return outs

    def run_forever(self, idle_sleep: float = 0.005):
        """Engine loop for a serving thread; `enqueue_streaming` from other
        threads. A failing step must not kill the loop (handler threads
        would block on their stream queues forever): every in-flight request
        is failed with reason "error" and its stream closed, the device
        state is rebuilt, and the loop backs off before it goes on."""
        while not self._stop.is_set():
            try:
                idle_admission = self.pending.empty() and not self._prefilling
                busy = self.step(self.tick_tokens if idle_admission else 1)
            except Exception:
                traceback.print_exc()
                for i, r in enumerate(self.slots):
                    if r is not None:
                        self._finish(i, "error")
                self._reset_device_state()
                time.sleep(idle_sleep)
                continue
            if busy == 0 and self.pending.empty():
                time.sleep(idle_sleep)

    def enqueue_streaming(self, req: Request) -> "queue.SimpleQueue[str | None]":
        """Submit with a live text stream (None sentinel terminates)."""
        req._stream = queue.SimpleQueue()
        self.submit(req)
        return req._stream

    def shutdown(self):
        self._stop.set()
