"""The model runner: chunked prefill and streaming decode on one device.

Counterpart of crabml_tpu/runtime/runner.py::Runner (prefill, generate,
prefill_and_generate, reset, kv_cache_len, save_session, load_session). The
JAX Runner pads prompts to power-of-two buckets to bound recompiles; the port
runs eagerly and prefills the exact prompt length, still in chunks of at
most MAX_PREFILL_CHUNK tokens so a long prompt never materializes a long
activation. Decode goes through
runtime/generate.py::decode_loop: on the card, one captured CUDA graph of the
step, replayed.

The Runner runs on `cuda` unless the caller passes `device="cpu"`; without a
card and without that request it raises.

`compute_dtype` is bfloat16 (the default on the card) or float32, and
`kv_dtype` the cache's: float32, bfloat16 or int8, under either compute
dtype (default: the compute dtype), as the JAX Runner takes them. The
default differs from the JAX package's, whose compute dtype is float32.

`speculative` = K > 0 decodes greedy runs K + 1 tokens a verify
(runtime/speculative.py): drafts from prompt lookup over the tokens the
cache holds, or, with `draft_model` (a GGUF of the same vocabulary), from
that model's own greedy chain; a draft model alone sets K = 4. The tokens
are plain greedy decode's (a verify of K + 1 <= 16 rows takes the decode
step's matmul route). Sampled runs decode plainly, and so does the end
of the cache, as crabml_tpu/runtime/runner.py's _generate_speculative does.

`prefill_w8` decides on the W8 prefill planes (int8 weights beside the
quantized planes, 8 more bits a weight of device memory; chunks of 249 rows
or more then take the W8 kernels): True attaches them all, False none, and None, the
default, attaches what fits the card's free memory (`_auto_w8_budget`), which
on the CPU is nothing.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..errors import CacheError, UnsupportedError
from ..gguf.reader import GGUFFile
from ..models.config import ModelConfig, config_from_gguf
from ..models.forward import KVCache, forward
from ..models.weights import augment_w8_weights, load_weights
from ..ops.cuda.flash_attention import check_card_model
from ..ops.cuda.gemm_quant import _KERNEL_PLANES
from ..quant.qtensor import FORM_KIND
from ..tokenizer import Tokenizer, Utf8Buf, tokenizer_from_gguf
from ..utils import resolve_device
from ..utils.metrics import Metrics
from .generate import decode_loop
from .sampler import Sampler
from .speculative import draft_model_loop, speculative_loop


log = logging.getLogger("crabml_tpu_torch")


def _f32_scale_bytes(gf: GGUFFile) -> int:
    """Device bytes that float32 compute adds to the loaded weights over the
    file's: every matrix (expert stacks included) loads its dsub / msub
    planes in float32 (models/weights.py::_scale_dtype), 2 bytes more a
    scale than in bfloat16. Q3_K's and Q2_K's scales stay as they are, and
    the embedding keeps its planar form."""
    extra = 0
    for ti in gf.tensor_infos:
        form = FORM_KIND.get(ti.typ)
        if form is None or len(ti.dimensions) < 2 or "token_embd" in ti.name:
            continue
        extra += sum(ti.n_elems // per * 2 for n, (per, _) in _KERNEL_PLANES[form].items()
                     if n in ("dsub", "msub"))
    return extra


def _auto_w8_budget(gf: GGUFFile, cfg: ModelConfig, seq_len: int, kv_itemsize: int,
                    device: torch.device, compute_dtype=torch.bfloat16) -> int | None:
    """Whether the W8 prefill planes fit the card, decided before loading from
    the GGUF's header: None (off), -1 (all of them fit) or a byte budget for
    the largest tensors (models.weights.augment_w8_weights).

    Only on a card, where prefill throughput matters, and only for files over
    1 GiB: on the CPU and for small test models prefill stays on the exact
    dequant path of the weights' scheme. The budget is the card's memory less 2 GiB of slack
    (activations, serving page pools), the file's bytes (under float32
    compute with the scale planes at float32's size, `_f32_scale_bytes`)
    and the Runner's KV cache. The planes' cost counts every matrix of the
    file but the embedding, the experts' 3-D tensors included: int8 values
    and float32 scales under either compute dtype."""
    if device.type != "cuda":
        return None
    wbytes = os.path.getsize(gf.path)
    if wbytes < (1 << 30):
        return None
    if compute_dtype == torch.float32:
        wbytes += _f32_scale_bytes(gf)
    full = sum(ti.n_elems for ti in gf.tensor_infos
               if len(ti.dimensions) >= 2 and "token_embd" not in ti.name)
    full = int(full * 1.008)  # one float32 scale per 512-chunk
    kv = 2 * cfg.n_layers * seq_len * cfg.n_kv_heads * cfg.head_dim * kv_itemsize
    budget = torch.cuda.get_device_properties(device).total_memory - (2 << 30) - wbytes - kv
    if budget <= 0:
        log.info("prefill W8 planes off: no device memory to spare (weights %.1f GiB)",
                 wbytes / 2**30)
        return None
    if budget >= full:
        log.info("prefill W8 planes on (+%.1f GiB of device memory); pass prefill_w8=False "
                 "to leave them out", full / 2**30)
        return -1
    log.info("prefill W8 planes in part: %.1f of %.1f GiB fit, largest tensors first",
             budget / 2**30, full / 2**30)
    return budget


class Runner:
    MAX_PREFILL_CHUNK = 512  # bounds activation memory per forward

    def __init__(self, model: str | GGUFFile, seq_len: int | None = None,
                 compute_dtype=torch.bfloat16, kv_dtype=None,
                 sampler: Sampler | None = None, seed: int = 0, device=None,
                 prefill_w8: bool | None = None, kv_lane_pad: bool = False,
                 speculative: int = 0, draft_model: "str | GGUFFile | None" = None):
        self.device = resolve_device(device)
        gf = GGUFFile(model) if not isinstance(model, GGUFFile) else model
        self.cfg: ModelConfig = config_from_gguf(gf.metadata)
        check_card_model(self.cfg, self.device, compute_dtype)
        self.seq_len = min(seq_len or self.cfg.seq_len, self.cfg.seq_len)
        self.compute_dtype = compute_dtype
        self.kv_dtype = kv_dtype or compute_dtype
        w8_budget = None  # None = off, -1 = every eligible tensor, > 0 = a byte budget
        if prefill_w8 is True:
            w8_budget = -1
        elif prefill_w8 is None:
            w8_budget = _auto_w8_budget(gf, self.cfg, self.seq_len,
                                        torch.empty(0, dtype=self.kv_dtype).element_size(),
                                        self.device, compute_dtype)
        self.prefill_w8 = w8_budget is not None
        self.tokenizer: Tokenizer = tokenizer_from_gguf(gf.metadata)
        self.sampler = sampler or Sampler()
        self.metrics = Metrics()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        with self.metrics.track("load"):
            self.weights = load_weights(gf, self.cfg, self.device, compute_dtype)
            self._sync()
            if self.prefill_w8:
                with self.metrics.track("load.w8_augment"):
                    self.weights = augment_w8_weights(
                        self.weights, None if w8_budget == -1 else w8_budget)
                    self._sync()
        # kv_lane_pad is the JAX Runner's argument and changes nothing here: the
        # attention kernels take head dims 80 and 96 as they are, and the cache
        # holds the model's head dim
        del kv_lane_pad
        self.cache = KVCache.create(self.cfg, 1, self.seq_len, self.kv_dtype, self.device)
        self.pos = 0
        self.generated: list[int] = []  # token ids of the current generation
        self._decode_buf = Utf8Buf()
        # the token consumed at each cache position, for the prompt-lookup
        # drafts: a list that lost its tokens (reset, load_session) lowers
        # acceptance, never correctness (runtime/speculative.py)
        self._consumed: list[int] = []
        self.speculative = speculative  # draft length K, 0 = off
        self._draft: Runner | None = None
        if draft_model is not None:
            self._draft = Runner(draft_model, seq_len=self.seq_len, compute_dtype=compute_dtype,
                                 kv_dtype=kv_dtype, device=self.device, prefill_w8=prefill_w8)
            if self._draft.cfg.vocab_size != self.cfg.vocab_size:
                raise UnsupportedError(
                    f"draft model vocab {self._draft.cfg.vocab_size} != target vocab "
                    f"{self.cfg.vocab_size}: speculative verify needs a shared tokenizer")
            if self.speculative == 0:
                self.speculative = 4

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset(self):
        self.cache.k.zero_()
        self.cache.v.zero_()
        self.pos = 0
        self.generated = []
        self._decode_buf = Utf8Buf()
        self._consumed = []
        if self._draft is not None:
            self._draft.reset()

    def kv_cache_len(self) -> int:
        """Tokens the cache holds."""
        return self.pos

    def save_session(self, path: str):
        """The KV cache and position to a .npz file in the JAX package's keys
        and layout (crabml_tpu/runtime/runner.py::save_session): k, v (L, 1,
        KV, S, hd), pos (1,) int32, model_name, and for an int8 cache its
        float32 k_scale, v_scale (L, 1, KV, S, 1). A float32 or int8 cache is
        written as it is; a bfloat16 one widened to float32 (exact; numpy has
        no bfloat16), which either package loads into a bfloat16 cache."""
        def host(t):
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

        extra = {}
        if self.cache.quantized:
            extra = {"k_scale": host(self.cache.k_scale), "v_scale": host(self.cache.v_scale)}
        np.savez(path, k=host(self.cache.k), v=host(self.cache.v),
                 pos=np.asarray([self.pos], np.int32), model_name=self.cfg.model_name, **extra)

    def load_session(self, path: str):
        """A session of either package into this Runner's cache, in place (the
        captured decode graphs stay valid). The cache's shape and whether it
        is int8 must match the file's; float values convert to the cache's
        dtype, and a JAX bfloat16 session, which numpy keeps as raw 2-byte
        values, is read as bfloat16."""
        data = np.load(path, allow_pickle=False)
        if data["k"].shape != tuple(self.cache.k.shape):
            raise CacheError(f"session cache shape {data['k'].shape} != runner "
                             f"{tuple(self.cache.k.shape)} (seq_len/batch/model mismatch)")
        if ("k_scale" in data) != self.cache.quantized:
            raise CacheError(f"session cache is {'int8' if 'k_scale' in data else 'float'}, "
                             f"the runner's {self.kv_dtype}: pass kv_dtype to match it")

        def into(dst, a):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
                if a.dtype.kind == "V" and a.dtype.itemsize == 2 else torch.from_numpy(a)
            dst.copy_(t.to(dst.dtype))

        into(self.cache.k, data["k"])
        into(self.cache.v, data["v"])
        if self.cache.quantized:
            into(self.cache.k_scale, data["k_scale"])
            into(self.cache.v_scale, data["v_scale"])
        self.pos = int(data["pos"][0])
        self.generated = []
        self._decode_buf = Utf8Buf()
        self._consumed = []  # the session file keeps no token history

    def _forward_tokens(self, token_ids: list[int]) -> torch.Tensor:
        """Forward `token_ids` at the current position in chunks; returns the
        last token's logits (1, V). A prompt longer than the free cache keeps
        its tail, as the JAX Runner does."""
        limit = self.seq_len - 1 - self.pos
        if limit <= 0:
            raise CacheError(f"KV cache full (pos={self.pos}, seq_len={self.seq_len}); "
                             "reset() or raise seq_len")
        token_ids = token_ids[-limit:]
        logits = None
        for i in range(0, len(token_ids), self.MAX_PREFILL_CHUNK):
            chunk = token_ids[i : i + self.MAX_PREFILL_CHUNK]
            tokens = torch.tensor([chunk], dtype=torch.long, device=self.device)
            logits = forward(self.weights, self.cache, tokens,
                             torch.tensor([self.pos], dtype=torch.int32), self.cfg,
                             self.compute_dtype)[:, -1]
            self.pos += len(chunk)
            self._consumed.extend(chunk)
        return logits

    def prefill(self, prompt: str, bos: bool = True) -> tuple[int, int, int]:
        """Tokenize and forward the prompt; returns (next_pos,
        last_prompt_token, first_generated_token)."""
        tokens = self.tokenizer.encode(prompt, bos=bos)
        if not tokens:
            raise ValueError("expected at least 1 prompt token")
        with self.metrics.track("prefill"):
            pos_before = self.pos
            logits = self._forward_tokens(tokens)
            if self._draft is not None:
                # the draft model consumes the prompt from the same position,
                # so that its cache holds what the target's does
                self._draft.pos = pos_before
                self._draft._forward_tokens(tokens)
            token = int(self.sampler.sample(logits, self.generator)[0])
        self.metrics.count("prefill_tokens", len(tokens))
        return self.pos, tokens[-1], token

    def generate(self, token: int, steps: int | None = None, tick: int | None = None):
        """Stream text pieces from `token` (sampled by prefill); stops at
        EOS, at `steps` tokens or at the end of the cache.

        Each tick decodes `tick` tokens on the device (decode_loop: on the
        card, one graph replay a token) and then checks them for EOS on the
        host, as crabml_tpu's Runner.generate(tick=) / _generate_ticked do;
        the text streams a tick at a time. On EOS at index j of a tick the
        position goes back to just after it and the tick's later tokens are
        dropped. Default: 1 (the JAX package takes 8 on a TPU only).

        With `speculative` > 0 a greedy run decodes by speculative rounds
        instead (_generate_speculative)."""
        tick = max(1, tick or 1)
        remaining = self.seq_len - self.pos - 1
        if steps is not None:
            remaining = min(remaining, steps - 1)
        self.generated = [token]
        yield self.tokenizer.decode(token, self._decode_buf)
        if self.speculative > 0 and self.sampler.temperature == 0.0:
            yield from self._generate_speculative(token, remaining, self.speculative, tick)
        else:
            yield from self._generate_ticked(token, remaining, tick)

    def _emit(self, toks: list[int], pos0: int, current: int):
        """Deliver the tokens one dispatch decoded from `current` at pos0: the
        position moves past each token as it is consumed, so on EOS it stays
        just after it and positions beyond hold dropped writes. Yields the
        text pieces; returns True at EOS."""
        for j, t in enumerate(toks):
            self.pos = pos0 + j + 1
            self._consumed.append(current if j == 0 else toks[j - 1])
            self.metrics.count("tokens")
            if t == self.tokenizer.eos_token:
                return True
            self.generated.append(t)
            yield self.tokenizer.decode(t, self._decode_buf)
        return False

    def _generate_ticked(self, current: int, remaining: int, tick: int):
        while remaining > 0:
            n = min(tick, remaining)
            pos0 = self.pos
            with self.metrics.track("decode"):
                toks = decode_loop(self.weights, self.cache, [current], [pos0], n, self.cfg,
                                   self.compute_dtype, self.sampler, self.generator)[0].tolist()
            if (yield from self._emit(toks, pos0, current)):
                return
            current = toks[-1]
            remaining -= n

    def _generate_speculative(self, current: int, remaining: int, draft: int, tick: int,
                              rounds: int = 4):
        """Greedy decode by speculative rounds: a dispatch runs `rounds`
        rounds on the device (runtime/speculative.py: prompt lookup over the
        consumed tokens, or the draft model's chain), each emitting 1 to
        draft + 1 tokens, and the host reads them once. Near the end of the
        cache, where a dispatch could pass it (S - 1 - pos < rounds *
        (draft + 1)), the rest decodes by ticks, as the JAX Runner's
        _generate_speculative does."""
        S = self.seq_len
        dev = self.device
        while remaining > 0:
            pos0 = self.pos
            if S - 1 - pos0 < rounds * (draft + 1):
                yield from self._generate_ticked(current, remaining, tick)
                return
            token = torch.tensor([current], dtype=torch.long, device=dev)
            pos = torch.tensor([pos0], dtype=torch.int32, device=dev)
            with self.metrics.track("decode"):
                if self._draft is not None:
                    d = self._draft
                    outs, counts, _, _ = draft_model_loop(
                        self.weights, self.cache, d.weights, d.cache, token, pos, rounds, draft,
                        self.cfg, d.cfg, self.compute_dtype)
                else:
                    hist = torch.zeros(1, S, dtype=torch.long)
                    n = min(len(self._consumed), pos0)
                    if n:
                        hist[0, pos0 - n:pos0] = torch.tensor(self._consumed[-n:])
                    outs, counts, _, _, _ = speculative_loop(
                        self.weights, self.cache, hist.to(dev), token, pos, rounds, draft,
                        self.cfg, self.compute_dtype)
                outs, counts = outs[:, 0].cpu().tolist(), counts[:, 0].cpu().tolist()
            toks = [t for r in range(rounds) for t in outs[r][: counts[r]]]
            self.metrics.count("spec_rounds", rounds)
            self.metrics.count("spec_tokens", len(toks))
            toks = toks[:remaining]  # at the steps cap the position stops after the last one
            if (yield from self._emit(toks, pos0, current)):
                return
            current = toks[-1]
            remaining -= len(toks)

    def prefill_and_generate(self, prompt: str, steps: int):
        _, _, token = self.prefill(prompt, bos=True)
        return self.generate(token, steps)
