"""Sampling: greedy argmax, or temperature softmax with top-p nucleus and
min-p, per sequence, with the serving engine's logit processors.

Counterpart of crabml_tpu/runtime/sampler.py (Sampler, nucleus_filter,
min_p_filter, apply_repetition_penalty, apply_frequency_presence,
sample_batch). The randomness comes from an explicit torch.Generator on the
logits' device; it gives other numbers than jax.random from the same seed, so
only greedy rows are comparable token for token between the two packages.

Every function here is safe to capture in a CUDA graph: no value goes to the
host and no Python number is copied to the device (a scalar parameter stays a
scalar), and the draw is written out (`_draw`) because torch.multinomial
checks its input on the host. A captured draw needs its generator
registered with the graph (runtime/generate.py::StepGraph does it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

LOGPROB_TOPK = 8  # top-k carried per sampled token when logprobs are requested


def _per_row(x, like: torch.Tensor):
    """A (B,) parameter as a float32 (B, 1) column on like's device; a Python
    number stays a number."""
    if not isinstance(x, torch.Tensor):
        return float(x)
    t = x.to(device=like.device, dtype=torch.float32)
    return (t if t.dim() else t[None])[:, None]


def _draw(probs: torch.Tensor, generator) -> torch.Tensor:
    """One token per row with probability probs (B, V) -> (B,) int64: the
    argmax of probs / q with q ~ Exp(1), which is torch.multinomial's own
    one-sample path (the same numbers from the same generator state) without
    its checks on the host."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def nucleus_filter(probs: torch.Tensor, topp) -> torch.Tensor:
    """Zero everything outside the smallest prefix of the descending sort
    whose cumulative mass exceeds topp (llama2.c semantics). `topp` is a
    scalar or (B,); rows with topp outside (0, 1) pass unfiltered."""
    t2 = _per_row(topp, probs)
    sorted_p, _ = torch.sort(probs, dim=-1, descending=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep = (csum - sorted_p) < t2
    cutoff = torch.where(keep, sorted_p, torch.ones_like(sorted_p)).amin(dim=-1, keepdim=True)
    off = (t2 <= 0.0) | (t2 >= 1.0)
    return torch.where(off | (probs >= cutoff), probs, torch.zeros_like(probs))


def min_p_filter(probs: torch.Tensor, minp) -> torch.Tensor:
    """llama.cpp-style min-p: drop tokens whose probability is below
    minp * max_prob. `minp` scalar or (B,); 0 disables."""
    m2 = _per_row(minp, probs)
    cutoff = probs.amax(dim=-1, keepdim=True) * m2
    return torch.where((m2 <= 0.0) | (probs >= cutoff), probs, torch.zeros_like(probs))


def _window_counts(logits: torch.Tensor, recent_tokens: torch.Tensor) -> torch.Tensor:
    """How often each token id occurs in `recent_tokens` (B, W), -1 padded."""
    valid = recent_tokens >= 0
    tok = torch.where(valid, recent_tokens, torch.zeros_like(recent_tokens)).long()
    return torch.zeros_like(logits).scatter_add_(1, tok, valid.to(logits.dtype))


def apply_repetition_penalty(logits, recent_tokens, penalty) -> torch.Tensor:
    """HF/llama.cpp repetition penalty over `recent_tokens` (B, W) int (pad
    with -1): seen-token logits divide by `penalty` when positive, multiply
    when negative. `penalty` scalar or (B,); 1.0 disables."""
    p2 = _per_row(penalty, logits)
    seen = _window_counts(logits, recent_tokens) > 0
    pen = torch.where(logits > 0, logits / p2, logits * p2)
    return torch.where(seen & (p2 != 1.0), pen, logits)


def apply_frequency_presence(logits, recent_tokens, freq_penalty, pres_penalty) -> torch.Tensor:
    """OpenAI-style penalties over the recent window: logits[t] -=
    freq * count(t) + pres * (count(t) > 0). Scalars or (B,); 0 disables."""
    counts = _window_counts(logits, recent_tokens)
    return (logits - _per_row(freq_penalty, logits) * counts
            - _per_row(pres_penalty, logits) * (counts > 0))


def sample_batch(logits, generator, temperature, topp, minp=None, logit_bias=None,
                 recent_tokens=None, repetition_penalty=None, frequency_penalty=None,
                 presence_penalty=None, with_logprobs: bool = False):
    """Per-sequence sampling for the serving engine.

    logits (B, V) float32; temperature, topp (and optional minp and
    penalties): (B,) on the logits' device. A row with temperature 0 is
    greedy, the others are temperature softmax + nucleus [+ min-p] drawn with
    `generator`. `temperature=None` says every row is greedy and skips the
    softmax, the sort and the draw. `logit_bias` (B, V) is added first;
    `recent_tokens` (B, W) int (-1 padded) is the window of the penalties.

    with_logprobs=True also returns (token_logprob (B,), top_logprobs
    (B, LOGPROB_TOPK), top_ids): the log_softmax of the processed logits
    (after bias and penalties, before temperature and top-p)."""
    logits = logits.float()
    if logit_bias is not None:
        logits = logits + logit_bias
    if recent_tokens is not None and repetition_penalty is not None:
        logits = apply_repetition_penalty(logits, recent_tokens, repetition_penalty)
    if recent_tokens is not None and (frequency_penalty is not None
                                      or presence_penalty is not None):
        logits = apply_frequency_presence(
            logits, recent_tokens,
            0.0 if frequency_penalty is None else frequency_penalty,
            0.0 if presence_penalty is None else presence_penalty)
    nxt = torch.argmax(logits, dim=-1)
    if temperature is not None:
        temperature = temperature.to(logits.device, torch.float32)
        probs = torch.softmax(logits / temperature.clamp_min(1e-6)[:, None], dim=-1)
        filtered = nucleus_filter(probs, topp)
        if minp is not None:
            filtered = min_p_filter(filtered, minp)
        sampled = _draw(filtered, generator)
        nxt = torch.where(temperature <= 0.0, nxt, sampled)
    if not with_logprobs:
        return nxt
    lsm = torch.log_softmax(logits, dim=-1)
    tok_lp = lsm.gather(1, nxt[:, None])[:, 0]
    top_lp, top_id = torch.topk(lsm, LOGPROB_TOPK, dim=-1)
    return nxt, (tok_lp, top_lp, top_id)


@dataclass(frozen=True)
class Sampler:
    temperature: float = 0.0
    topp: float = 0.9

    def sample(self, logits: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """logits (B, V) float32 -> (B,) int64 tokens."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return _draw(nucleus_filter(probs, self.topp), generator)
