"""The decode loop on the device: forward, sample and feed back, with the host
touched once per call.

Counterpart of crabml_tpu/runtime/generate.py::decode_loop, which runs
`steps` tokens inside one jit (lax.scan). Its counterpart here is a CUDA
graph of one step, replayed: `StepGraph` runs a step once eagerly on a side
stream (kernel build, shared-memory attributes, the decode kernels' ticket
counters), captures it, and replays it back to back. The step reads its
inputs from static buffers and writes its token into an output ring at a
device counter, then moves the token, the position and the counter on, so
`steps` replays need no host work between them and the host reads the ring
once. On the CPU the same step runs eagerly.

A capture or a replay that fails raises: on the card the loop never falls
back to the eager step. The serving engines replay their tick the same way
(serving/engine.py).
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import torch

from ..errors import CacheError
from ..models.forward import KVCache, decode_step
from ..ops.cuda import _build
from .sampler import Sampler

RING = 64  # tokens the output ring holds: a call reads the ring after at most this many steps


class StepGraph:
    """`step(generator)` captured once in a CUDA graph and replayed.

    `step` runs one step on the current stream and takes the generator its
    sampling draws from. It runs once eagerly on a side stream first, with a
    generator of its own so that the caller's random numbers do not move;
    that warm-up writes the cache where the first replay writes it, with the
    same values, so the caller fills the step's inputs before and again after
    the capture. `generator` (None: greedy, or the card's default generator)
    is registered with the graph, so every replay draws fresh numbers from it.
    Graphs that share `pool` (another graph's `pool()`) share memory; they run
    one at a time on one stream. The kernel launches the capture counted are
    added to _build.launches at each replay.

    Python's cyclic collector is off during the capture: a graph that became
    garbage in a reference cycle (its step refers back to its owner) would,
    if collected then, free its memory pool, and that cudaFree invalidates
    the capture under way. It is collected later, outside any capture.

    A capture that fails raises, but first leaves the card's random numbers
    usable: torch puts the default CUDA generator and every generator
    registered with a graph into capture mode when the capture begins and
    takes them out of it only when the capture ends well, so a failed one
    would leave them refusing every later draw. `_release_generators` ends
    that mode and the failed graph is dropped."""

    def __init__(self, step, device: torch.device, pool=None,
                 generator: torch.Generator | None = None):
        self.step = step  # holds every tensor the graph reads
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step(None if generator is None else torch.Generator(device=device))
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.recording() as self.launches, \
                    torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                step(generator)
        except BaseException:
            del self.graph
            _release_generators(device, generator)
            raise
        finally:
            if collecting:
                gc.enable()

    def pool(self):
        return self.graph.pool()

    def replay(self, times: int = 1):
        for _ in range(times):
            self.graph.replay()
        _build.replayed(self.launches, times)


def _release_generators(device: torch.device, generator: torch.Generator | None):
    """Take the default CUDA generator of `device` and `generator` out of the
    capture mode a failed capture left them in. Only a capture that ends
    well does that in torch (CUDAGraph::capture_end), so one is made here:
    an empty graph with the same generators registered, captured on its own
    stream and dropped."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.device(device), torch.cuda.graph(graph):
        torch.zeros(1, device=device)  # a graph with no node draws a warning
    torch.cuda.synchronize(device)


@dataclass
class _LoopState:
    """The static buffers of the loop's step: its input token and position per
    sequence, the output ring and the ring's counter."""

    tok: torch.Tensor  # (B,) int64
    pos: torch.Tensor  # (B,) int32
    count: torch.Tensor  # (1,) int64
    ring: torch.Tensor  # (B, RING) int64

    @staticmethod
    def create(B: int, device) -> "_LoopState":
        return _LoopState(torch.zeros(B, dtype=torch.long, device=device),
                          torch.zeros(B, dtype=torch.int32, device=device),
                          torch.zeros(1, dtype=torch.long, device=device),
                          torch.zeros(B, RING, dtype=torch.long, device=device))

    def fill(self, token: torch.Tensor, pos: torch.Tensor):
        self.tok.copy_(token)
        self.pos.copy_(pos)


def _loop_step(weights, cache: KVCache, s: _LoopState, cfg, compute_dtype, sampler: Sampler,
               generator):
    """One step of the loop on the static buffers."""
    logits = decode_step(weights, cache, s.tok[:, None], s.pos, cfg, compute_dtype)
    nxt = sampler.sample(logits, generator)
    s.ring.index_copy_(1, s.count, nxt[:, None])
    s.tok.copy_(nxt)
    s.pos.add_(1)
    s.count.add_(1)


@dataclass
class _Captured:
    graph: StepGraph
    state: _LoopState
    weights: dict
    generator: torch.Generator | None


def _captured(weights, cache: KVCache, B: int, cfg, compute_dtype, sampler: Sampler,
              generator, token, pos) -> _Captured:
    """The graph of the loop's step on `cache`, one per (batch, sampler,
    compute dtype), captured again only when the weights or the generator
    change. All of a cache's graphs share one memory pool. Fills the step's
    inputs with token, pos."""
    key = (B, sampler, compute_dtype)
    got = cache.graphs.get(key)
    sampled = sampler.temperature != 0.0
    gen = generator if sampled else None
    if got is not None and got.weights is weights and got.generator is gen:
        got.state.fill(token, pos)
        return got
    cache.graphs.pop(key, None)
    pool = next((g.graph.pool() for g in cache.graphs.values()), None)
    s = _LoopState.create(B, cache.k.device)
    s.fill(token, pos)
    graph = StepGraph(
        lambda g: _loop_step(weights, cache, s, cfg, compute_dtype, sampler, g),
        cache.k.device, pool, gen)
    s.fill(token, pos)  # the warm-up moved them on
    got = cache.graphs[key] = _Captured(graph, s, weights, gen)
    return got


def decode_loop(weights: dict, cache: KVCache, token, pos, steps: int, cfg, compute_dtype,
                sampler: Sampler, generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy or sampled decode of `steps` tokens for B sequences.

    token (B,): each sequence's last token; pos (B,) on the host: the keys
    each holds. Step i forwards the current tokens at pos + i, writing their
    k/v into `cache`, and samples the next ones -> (B, steps) int64 on the
    CPU. EOS is not special: a caller that stops early at token j has
    consumed positions up to pos + j and sets its own position back.

    On `cuda` each step is a replay of one captured graph (StepGraph) and the
    host reads the tokens once per RING steps; on the CPU the step runs
    eagerly."""
    token = torch.as_tensor(token, dtype=torch.long).reshape(-1)
    pos = torch.as_tensor(pos, dtype=torch.int32).reshape(-1)
    B = token.shape[0]
    if pos.is_cuda or token.is_cuda:
        raise ValueError("decode_loop takes token and pos on the host")
    if steps <= 0:
        return torch.zeros(B, 0, dtype=torch.long)
    if int(pos.max()) + steps > cache.seq_len:
        raise CacheError(f"pos {int(pos.max())} + {steps} steps overruns the cache "
                         f"({cache.seq_len})")
    dev = cache.k.device
    if dev.type == "cuda":
        got = _captured(weights, cache, B, cfg, compute_dtype, sampler, generator, token, pos)
        s, run = got.state, got.graph.replay
    else:
        s = _LoopState.create(B, dev)
        s.fill(token, pos)

        def run(n):
            for _ in range(n):
                _loop_step(weights, cache, s, cfg, compute_dtype, sampler, generator)
    out = []
    for start in range(0, steps, RING):
        n = min(RING, steps - start)
        s.count.zero_()
        run(n)
        out.append(s.ring[:, :n].cpu())
    return torch.cat(out, dim=1)
