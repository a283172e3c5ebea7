"""Speculative decoding on the device: prompt-lookup and draft-model drafts,
verified K + 1 tokens at a time.

Counterpart of crabml_tpu/runtime/speculative.py (speculative_loop,
draft_model_loop). A verify step over K + 1 tokens reads the weights once,
as a decode step does, so every accepted draft is nearly free. Acceptance
compares each draft with the verify pass's own argmax, so the tokens emitted
are greedy decode's, whatever the drafts were; sampled decoding takes the
plain path.

The JAX package runs `rounds` rounds inside one jit (lax.scan); here a
Python loop runs them, and each round reads nothing on the host: the tokens,
the positions and the history stay on the device, and the caller reads
`outs` / `counts` once, after the last round. The verify is
models.forward.verify_step (the decode kernels at T = K + 1), a draft step
models.forward.decode_step.

Cache and history hygiene needs no rollback (the JAX module's argument): a
verify writes K + 1 positions and the history K + 1 entries past pos; those
above the accepted frontier are masked by every later row's causal bound
and rewritten by the round whose accept passes them. The draft model's
cache works the same way: its chain of K + 1 steps (not K) writes the last
accepted draft's k/v too, so a full accept leaves no hole at the frontier.

The functions take B sequences (the serving engines batch them); the
Runner calls them with B = 1.
"""

from __future__ import annotations

import torch

from ..models.forward import KVCache, decode_step, verify_step


def draft_tokens(hist: torch.Tensor, token: torch.Tensor, pos: torch.Tensor, draft: int,
                 match_len: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Most-recent n-gram prompt lookup over each row's history, on the
    device. hist (B, S) int64, hist[b, i] the token consumed at position i
    (i < pos[b]); token (B,) the token to consume at pos[b]; pos (B,) in
    [0, S). The history with `token` written at pos is searched for the
    latest j < pos whose `match_len` tokens up to j equal the suffix ending
    with `token`; the drafts are the `draft` tokens after j (no match: those
    from pos on). -> (drafts (B, draft), the history with `token` set).

    Integer-exact counterpart of crabml_tpu/runtime/speculative.py's
    draft_tokens (vmapped in crabml_tpu/serving/engine.py::_draft_2gram_one):
    a suffix index below 0 wraps, as JAX's indexing does, and the slice's
    start is clamped to [0, S - draft], as lax.dynamic_slice clamps it."""
    S = hist.shape[1]
    dev = hist.device
    idx = torch.arange(S, device=dev)
    pos = pos.long()
    h = hist.scatter(1, pos[:, None], token.long()[:, None])
    match = idx[None] < pos[:, None]
    for off in range(match_len):
        suffix_tok = h.gather(1, ((pos - off) % S)[:, None])  # (B, 1)
        match = match & (torch.roll(h, off, dims=1) == suffix_tok) & (idx >= off)[None]
    j = torch.where(match, idx[None], -1).amax(dim=1)
    start = torch.where(j < 0, pos, j + 1).clamp(0, S - draft)
    return h.gather(1, start[:, None] + torch.arange(draft, device=dev)[None]), h


def write_history(hist: torch.Tensor, emitted: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The round's K + 1 verify tokens into each row's history from pos + 1
    on, in place (lax.dynamic_update_slice: the start clamped to S - (K+1))."""
    S, n = hist.shape[1], emitted.shape[1]
    start = (pos.long() + 1).clamp(max=S - n)
    return hist.scatter_(1, start[:, None] + torch.arange(n, device=hist.device)[None],
                         emitted.long())


def accept(greedy: torch.Tensor, drafts: torch.Tensor) -> torch.Tensor:
    """Drafts each row accepts: the length of the longest prefix of
    `drafts` (B, K) equal to the verify's argmax `greedy` (B, K + 1)."""
    ok = drafts == greedy[:, : drafts.shape[1]]
    miss = torch.cat([~ok, torch.ones_like(ok[:, :1])], dim=1)
    return miss.int().argmax(dim=1)  # the first mismatch; K when every draft holds


def draft_chain(dweights: dict, dcache: KVCache, token: torch.Tensor, pos: torch.Tensor,
                steps: int, dcfg, compute_dtype) -> torch.Tensor:
    """The draft model's greedy chain: `steps` decode steps from token (B,)
    at pos (B,) -> (B, steps) int64. The draft cache gains `steps` entries a
    row (inputs token, d1, .., d_{steps-1})."""
    out = []
    t, p = token.long(), pos.to(torch.int32)
    for _ in range(steps):
        t = decode_step(dweights, dcache, t[:, None], p, dcfg, compute_dtype).argmax(dim=-1)
        out.append(t)
        p = p + 1
    return torch.stack(out, dim=1)


def _rounds(weights, cache: KVCache, token, pos, rounds: int, draft: int, cfg, compute_dtype,
            make_drafts, hist=None):
    """The rounds of both loops: drafts, the verify, the accept rule. Returns
    (outs (rounds, B, K+1), counts (rounds, B), hist, token, pos), all on the
    device."""
    outs, counts = [], []
    token, pos = token.long(), pos.to(torch.int32)
    for _ in range(rounds):
        dr, hist = make_drafts(hist, token, pos)
        seq = torch.cat([token[:, None], dr], dim=1)  # (B, K+1)
        g = verify_step(weights, cache, seq, pos, cfg, compute_dtype).argmax(dim=-1)
        n_acc = accept(g, dr)
        if hist is not None:
            write_history(hist, g, pos)
        token = g.gather(1, n_acc[:, None])[:, 0]
        pos = pos + (n_acc + 1).to(torch.int32)
        outs.append(g)
        counts.append(n_acc + 1)
    return torch.stack(outs), torch.stack(counts), hist, token, pos


def speculative_loop(weights, cache: KVCache, hist: torch.Tensor, token, pos, rounds: int,
                     draft: int, cfg, compute_dtype=torch.float32, match_len: int = 2):
    """`rounds` prompt-lookup rounds, greedy. hist (B, S), token (B,), pos
    (B,) on the device (see draft_tokens). Round r emits outs[r, b,
    :counts[r, b]]: the accepted drafts and the verify's own next token.
    -> (outs (rounds, B, K+1), counts (rounds, B), hist, token, pos); the
    caller stops at EOS on the host and sets its position back, as the
    ticked loop does."""
    def lookup(h, t, p):
        return draft_tokens(h, t, p, draft, match_len)

    return _rounds(weights, cache, token, pos, rounds, draft, cfg, compute_dtype, lookup,
                   hist.long())


def draft_model_loop(weights, cache: KVCache, dweights, dcache: KVCache, token, pos,
                     rounds: int, draft: int, cfg, dcfg, compute_dtype=torch.float32):
    """`rounds` two-model rounds, greedy: the draft model's chain of
    draft + 1 steps proposes `draft` tokens, the target verifies them.
    Both caches hold the same positions. -> (outs (rounds, B, K+1), counts
    (rounds, B), token, pos)."""
    def chain(h, t, p):
        return draft_chain(dweights, dcache, t, p, draft + 1, dcfg, compute_dtype)[:, :draft], h

    outs, counts, _, token, pos = _rounds(weights, cache, token, pos, rounds, draft, cfg,
                                          compute_dtype, chain)
    return outs, counts, token, pos
