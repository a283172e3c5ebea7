"""The model runner: chunked prefill and streaming decode on one device.

Counterpart of crabml_tpu/runtime/runner.py::Runner (prefill, generate,
prefill_and_generate, reset). The JAX Runner pads prompts to power-of-two
buckets to bound recompiles; the port runs eagerly and prefills the exact
prompt length, still in chunks of at most MAX_PREFILL_CHUNK tokens so a long
prompt never materializes a long activation.

The Runner runs on `cuda` unless the caller passes `device="cpu"`; without a
card and without that request it raises.

`prefill_w8` decides on the W8 prefill planes (int8 weights beside the Q4_K
planes, 8 more bits a weight of device memory; chunks of 249 rows or more then
take the W8 kernels): True attaches them all, False none, and None, the
default, attaches what fits the card's free memory (`_auto_w8_budget`), which
on the CPU is nothing.
"""

from __future__ import annotations

import logging
import os

import torch

from ..errors import CacheError
from ..gguf.reader import GGUFFile
from ..models.config import ModelConfig, config_from_gguf
from ..models.forward import KVCache, forward
from ..models.weights import augment_w8_weights, load_weights
from ..tokenizer import Tokenizer, Utf8Buf, tokenizer_from_gguf
from ..utils import resolve_device
from ..utils.metrics import Metrics
from .generate import decode_loop
from .sampler import Sampler


log = logging.getLogger("crabml_tpu_torch")


def _auto_w8_budget(gf: GGUFFile, cfg: ModelConfig, seq_len: int, kv_itemsize: int,
                    device: torch.device) -> int | None:
    """Whether the W8 prefill planes fit the card, decided before loading from
    the GGUF's header: None (off), -1 (all of them fit) or a byte budget for
    the largest tensors (models.weights.augment_w8_weights).

    Only on a card, where prefill throughput matters, and only for files over
    1 GiB: on the CPU and for small test models prefill stays on the exact
    Q4_K dequant path. The budget is the card's memory less 2 GiB of slack
    (activations, serving page pools), the file's bytes and the Runner's KV
    cache. The planes' cost counts every matrix of the file but the embedding,
    the experts' 3-D tensors included."""
    if device.type != "cuda":
        return None
    wbytes = os.path.getsize(gf.path)
    if wbytes < (1 << 30):
        return None
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
                 compute_dtype=torch.bfloat16,
                 sampler: Sampler | None = None, seed: int = 0, device=None,
                 prefill_w8: bool | None = None):
        self.device = resolve_device(device)
        gf = GGUFFile(model) if not isinstance(model, GGUFFile) else model
        self.cfg: ModelConfig = config_from_gguf(gf.metadata)
        self.seq_len = min(seq_len or self.cfg.seq_len, self.cfg.seq_len)
        self.compute_dtype = compute_dtype
        w8_budget = None  # None = off, -1 = every eligible tensor, > 0 = a byte budget
        if prefill_w8 is True:
            w8_budget = -1
        elif prefill_w8 is None:
            w8_budget = _auto_w8_budget(gf, self.cfg, self.seq_len,
                                        torch.empty(0, dtype=compute_dtype).element_size(),
                                        self.device)
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
        self.cache = KVCache.create(self.cfg, 1, self.seq_len, compute_dtype, self.device)
        self.pos = 0
        self.generated: list[int] = []  # token ids of the current generation
        self._decode_buf = Utf8Buf()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset(self):
        self.cache.k.zero_()
        self.cache.v.zero_()
        self.pos = 0
        self.generated = []
        self._decode_buf = Utf8Buf()

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
        return logits

    def prefill(self, prompt: str, bos: bool = True) -> tuple[int, int, int]:
        """Tokenize and forward the prompt; returns (next_pos,
        last_prompt_token, first_generated_token)."""
        tokens = self.tokenizer.encode(prompt, bos=bos)
        if not tokens:
            raise ValueError("expected at least 1 prompt token")
        with self.metrics.track("prefill"):
            logits = self._forward_tokens(tokens)
            token = int(self.sampler.sample(logits, self.generator)[0])
        self.metrics.count("prefill_tokens", len(tokens))
        return self.pos, tokens[-1], token

    def generate(self, token: int, steps: int | None = None):
        """Stream text pieces from `token` (sampled by prefill); stops at
        EOS, at `steps` tokens or at the end of the cache."""
        max_steps = self.seq_len - self.pos - 1
        if steps is not None:
            max_steps = min(max_steps, steps - 1)
        self.generated = [token]
        yield self.tokenizer.decode(token, self._decode_buf)
        loop = decode_loop(self.weights, self.cache, token, self.pos, max_steps, self.cfg,
                           self.compute_dtype, self.sampler, self.generator)
        while True:
            with self.metrics.track("decode"):
                new_token = next(loop, None)
            if new_token is None:
                return
            self.pos += 1
            self.metrics.count("tokens")
            if new_token == self.tokenizer.eos_token:
                return
            self.generated.append(new_token)
            yield self.tokenizer.decode(new_token, self._decode_buf)

    def prefill_and_generate(self, prompt: str, steps: int):
        _, _, token = self.prefill(prompt, bos=True)
        return self.generate(token, steps)
