"""Continuous-batching serving engine over a pool of KV-cache slots.

Counterpart of crabml_tpu/serving/engine.py (Request, LatencyHistogram,
ServingEngine) without speculative decoding. A fixed pool of slots is the
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

from ..errors import ConfigError
from ..models.forward import KVCache, decode_step, forward
from ..ops.cuda.flash_attention import check_card_model
from ..runtime.generate import RING, StepGraph
from ..runtime.sampler import LOGPROB_TOPK, sample_batch
from ..tokenizer import Utf8Buf
from ..utils import resolve_device


def _prefill_slot(weights, cache: KVCache, tokens, slot: int, pos0: int, cfg, compute_dtype):
    """Forward `tokens` (1, T) through slot `slot` of the pooled cache,
    starting at `pos0`, writing that slot's cache in place -> logits (1, T, V)."""
    return forward(weights, cache.slot(slot), tokens, torch.tensor([pos0], dtype=torch.int32),
                   cfg, compute_dtype)


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
    """

    REPEAT_WINDOW = 64

    def __init__(self, runner=None, *, weights=None, cfg=None, tokenizer=None,
                 n_slots: int = 8, seq_len: int | None = None, compute_dtype=torch.float32,
                 kv_dtype=None, seed: int = 0, tick_tokens: int = 1,
                 prefill_chunk: int | None = 256, kv_lane_pad: bool = False,
                 repeat_window: int | None = None, device=None):
        del kv_lane_pad  # the JAX engine's argument; changes nothing here (Runner's note)
        if repeat_window is not None:
            self.REPEAT_WINDOW = max(1, int(repeat_window))
        if runner is not None:
            weights, cfg, tokenizer = runner.weights, runner.cfg, runner.tokenizer
            compute_dtype = runner.compute_dtype
            device = runner.device if device is None else device
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
        self._reset_device_state()

    def _reset_device_state(self):
        """Build (or, after a failed step, rebuild) the cache and the
        per-slot host state. Subclasses that own other device state (page
        pools) rebuild it in _make_cache."""
        n = self.n_slots
        self.cache = self._make_cache()
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
        return _prefill_slot(self.weights, self.cache, tokens, slot, filled, self.cfg,
                             self.compute_dtype)

    def _prefill_complete(self, slot: int):
        """Called once a slot's whole prompt is in cache (before its first
        sample). Hook for PagedServingEngine."""

    def _prefill_into(self, slot: int, req: Request):
        """Synchronous admission (prefill_chunk=None): the whole prompt now."""
        toks = self._trim_prompt(req)
        # claim the slot BEFORE device work: if prefill raises, run_forever's
        # recovery finds the request in self.slots and closes its stream
        self.slots[slot] = req
        logits = self._prefill_chunk_device(slot, toks, 0)
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
        multi = max(1, min(multi, RING, self.seq_len - 1 - int(self.pos.max())))
        if not self._ready(active, multi):
            return self._occupied()
        snapshot = list(self.slots)  # which request owned each slot at the start
        pos0 = self.pos.copy()
        if self._started is None:
            self._started = time.monotonic()
        toks, lp = self._run_ticks(multi, any(snapshot[i].logprobs is not None for i in active))
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
