"""The decode loop on the device: `decode_loop`, `Runner.generate(tick=)` and
the engines' `step(multi)` against the JAX package's (Pallas in interpret
mode, backend `w4a8`, float32), on the tiny synthetic Q4_K model of
tests/test_torch_model.py; the step functions read nothing on the host; the
launch counts of a captured step's replays.

On the card each of these runs one captured CUDA graph of the step
(runtime/generate.py::StepGraph); here on the CPU the same step runs eagerly.
The graphs themselves are tested on the card (tests/test_torch_kernels_gpu.py).
"""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import make_weights, tiny_config, write_synthetic_gguf
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.generate import decode_loop as jdecode_loop
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu.serving.engine import Request as JRequest
from crabml_tpu.serving.engine import ServingEngine as JServingEngine
from crabml_tpu.serving.paged import PagedServingEngine as JPagedServingEngine
from crabml_tpu_torch.models.config import ModelConfig
from crabml_tpu_torch.models.forward import KVCache, decode_step
from crabml_tpu_torch.models.weights import from_jax_weights
from crabml_tpu_torch.ops.cuda import _build
from crabml_tpu_torch.ops.cuda.paged_decode_attention import PAGE
from crabml_tpu_torch.runtime.generate import decode_loop
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.runtime.sampler import Sampler, sample_batch
from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
from crabml_tpu_torch.serving.engine import Processors
from crabml_tpu_torch.serving.paged import PagedKVCache, paged_decode_step

# head dim 128 and a 128-aligned cache: the JAX fused decode path is taken
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PREFILL = 32
STEPS = 6
PROMPT = "tok7 tok99 tok3 tok250 tok17"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs in several worker
    processes at once, and torch's thread pool in each of them, spinning on
    small tensors, slows the Runner and engine tests here a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


@pytest.fixture(scope="module")
def tiny():
    """The JAX weights (kernel layout), the port's weights and both configs."""
    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType.Q4_K, seed=5)
    cfg = ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})
    return repack_weights(fuse_weights(jw, jcfg), jcfg), jcfg, from_jax_weights(jw, cfg), cfg


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    """The synthetic GGUF of tests/test_torch_serving.py's four-engine test:
    with weight seed 11 the JAX package's own dense and paged engines agree
    (with seed 3 they differ in a near-tie), and greedy decode does not
    repeat one token throughout."""
    path = str(tmp_path_factory.mktemp("gguf") / "tiny_q4k.gguf")
    write_synthetic_gguf(path, tiny_config(**CFG), JGGMLType.Q4_K, seed=11)
    return path


@pytest.mark.parametrize("pos", [(PREFILL,), (PREFILL, PREFILL - 9)], ids=["B1", "B2"])
def test_decode_loop_matches_jax(tiny, w4a8_backend, pos):
    """Greedy, 6 steps from a prefilled cache, B=1 and B=2 at unequal
    positions (row 1's keys past its position are stale, as after an EOS
    rollback): identical tokens, and the cache rows the loop wrote within
    1e-5 of max|k| (float32 on both sides, sums in another order). One
    exception is allowed per sequence and tensor: a row where one int8
    activation of the w4a8 matmuls rounded the other way in the two packages
    (x / scale within float32 noise of a .5), which moves the row by about
    one int8 step, within 2^-7 of max|k| (B=2 has one such row: layer 1,
    position 26, 4.6e-3)."""
    jk, jcfg, pw, cfg = tiny
    B = len(pos)
    rng = np.random.default_rng(7)
    prompt = rng.integers(3, jcfg.vocab_size, (B, PREFILL))
    token = rng.integers(3, jcfg.vocab_size, B)
    _, jcache = jforward(jk, JKVCache.create(jcfg, B, jcfg.seq_len), jnp.asarray(prompt, jnp.int32),
                         jnp.zeros(B, jnp.int32), jcfg, jnp.float32)
    cache = KVCache.from_numpy(np.asarray(jcache.k), np.asarray(jcache.v))
    want, jcache, _ = jdecode_loop(jk, jcache, jnp.asarray(token, jnp.int32),
                                   jnp.asarray(pos, jnp.int32), jax.random.PRNGKey(0), STEPS,
                                   jcfg, jnp.float32)
    got = decode_loop(pw, cache, token, pos, STEPS, cfg, torch.float32, Sampler())
    assert got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("k", "v"):
        jc, pc = np.asarray(getattr(jcache, name)), getattr(cache, name).numpy()
        for b, p in enumerate(pos):
            rows = slice(p, p + STEPS)
            scale = np.abs(jc[:, b, :, rows]).max()
            err = np.abs(pc[:, b, :, rows] - jc[:, b, :, rows]).max(axis=(1, 3))  # (L, STEPS)
            assert (err > 1e-5 * scale).sum() <= 1, (name, b, err / scale)
            assert err.max() <= 2.0 ** -7 * scale, (name, b)


def test_decode_loop_is_the_step_repeated(tiny):
    """decode_loop on the CPU is decode_step + argmax fed back, step by step."""
    _, _, pw, cfg = tiny
    pos, token = [40, 7], [11, 300]
    a, b = (KVCache.create(cfg, 2, 128) for _ in range(2))
    got = decode_loop(pw, a, token, pos, 4, cfg, torch.float32, Sampler())
    tok, p, want = torch.tensor(token), torch.tensor(pos, dtype=torch.int32), []
    for _ in range(4):
        tok = decode_step(pw, b, tok[:, None], p, cfg, torch.float32).argmax(-1)
        want.append(tok)
        p = p + 1
    assert torch.equal(got, torch.stack(want, dim=1))
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_ticked_generation_matches_single_and_jax(gguf, w4a8_backend):
    """Runner.generate(tick=4) gives the text of tick=1, and the JAX
    Runner.generate(tick=4)'s, with the same final position (mirrors
    tests/test_generate.py::test_runner_ticked_generation_matches_single on
    the synthetic model)."""
    outs = {}
    for name, tick in (("port 1", 1), ("port 4", 4)):
        r = Runner(gguf, compute_dtype=torch.float32, device="cpu", seq_len=96)
        pos0, _, tok = r.prefill(PROMPT)
        outs[name] = ("".join(r.generate(tok, steps=18, tick=tick)), r.pos)
    jr = JRunner(gguf, backend="w4a8", compute_dtype=jnp.float32, seq_len=96)
    _, _, tok = jr.prefill(PROMPT)
    outs["jax 4"] = ("".join(jr.generate(tok, steps=18, tick=4)), int(jr.pos[0]))
    assert outs["port 4"] == outs["port 1"] == outs["jax 4"]
    assert outs["port 4"][1] == pos0 + 17


def test_eos_inside_a_tick(gguf, w4a8_backend):
    """EOS patched to a token the greedy run emits at index j of the decode,
    in the middle of a 4-token tick: both packages stop there with the
    position at pos0 + j + 1 and the same text."""
    r = Runner(gguf, compute_dtype=torch.float32, device="cpu", seq_len=96)
    pos0, _, tok = r.prefill(PROMPT)
    list(r.generate(tok, steps=18, tick=4))
    decoded = r.generated[1:]
    j = next(i for i, t in enumerate(decoded) if i % 4 in (1, 2)
             and t not in decoded[:i] and t != r.generated[0])
    eos = decoded[j]
    out = {}
    r.tokenizer.eos_token = eos
    r.reset()
    _, _, tok = r.prefill(PROMPT)
    out["port"] = ("".join(r.generate(tok, steps=18, tick=4)), r.pos, len(r.generated))
    jr = JRunner(gguf, backend="w4a8", compute_dtype=jnp.float32, seq_len=96)
    jr.tokenizer.eos_token = eos
    _, _, tok = jr.prefill(PROMPT)
    out["jax"] = ("".join(jr.generate(tok, steps=18, tick=4)), int(jr.pos[0]))
    assert out["port"][1] == pos0 + j + 1
    assert out["port"][2] == j + 1  # the prefill's token and the j before EOS
    assert out["port"][:2] == out["jax"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_multi_step_with_penalty_matches_jax(gguf, w4a8_backend, paged):
    """step(multi=4) with a repetition penalty: the penalties' recent window
    shifts inside the step's ticks, as in the JAX package's _decode_scan /
    paged_decode_scan. Identical greedy tokens, and the penalty bites (the
    tokens differ from the run without it)."""
    prompts = ["tok5 tok5 tok81", "tok300 tok12 tok44 tok9"]
    kw = dict(max_tokens=10, repetition_penalty=2.0)

    def drain(eng, req_cls, **extra):
        reqs = [eng.submit(req_cls(prompt=p, **kw, **extra)) for p in prompts]
        while any(eng.slots) or not eng.pending.empty():
            eng.step(4)
        return [list(q.output_tokens) for q in reqs]

    jr = JRunner(gguf, backend="w4a8", compute_dtype=jnp.float32)
    r = Runner(gguf, compute_dtype=torch.float32, device="cpu")
    if paged:
        jeng = JPagedServingEngine(jr, n_slots=2, seq_len=256, n_pages=8, kv_dtype=jnp.float32)
        eng = PagedServingEngine(r, n_slots=2, seq_len=256, n_pages=8)
    else:
        jeng, eng = JServingEngine(jr, n_slots=2, seq_len=256), ServingEngine(r, n_slots=2,
                                                                              seq_len=256)
    want = drain(jeng, JRequest)
    got = drain(eng, Request)
    assert got == want
    kw["repetition_penalty"] = 1.0
    assert drain(eng, Request) != got


# -- nothing read on the host -------------------------------------------------

class _NoDataDependentOps(TorchDispatchMode):
    """Raises on any op that reads a value back to the host or whose output
    shape depends on the data (a boolean index among them)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.index.Tensor:
            bad = any(i is not None and i.dtype == torch.bool for i in args[1])
        else:
            bad = (torch.Tag.data_dependent_output in func.tags
                   or torch.Tag.dynamic_output_shape in func.tags)
        if bad:
            raise AssertionError(f"{func} reads the device on the host")
        return func(*args, **kwargs)


_TO_HOST = {torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.item,
            torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
            torch.Tensor.__index__}


class _NoHostCalls(TorchFunctionMode):
    """Raises on the tensor methods that hand a value to Python or the host,
    some of which (tolist on a CPU tensor) never reach the dispatcher."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _TO_HOST:
            raise AssertionError(f"{func.__name__} reads the device on the host")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_read():
    """Under CUDA graph capture a value read on the host fails or syncs, and
    a data-dependent shape cannot be captured: inside this block each raises."""
    with _NoHostCalls(), _NoDataDependentOps():
        yield


def test_the_dispatch_guard_catches_host_reads():
    x = torch.arange(6.0)
    for read in (lambda: x.sum().item(), lambda: x[x > 2], lambda: x.nonzero(),
                 lambda: x.tolist(), lambda: int(x.max()), lambda: bool(x[0] > 1),
                 lambda: x.cpu(), lambda: x.numpy()):
        with pytest.raises(AssertionError), _no_host_read():
            read()


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_decode_step_reads_nothing_on_the_host(tiny, kv):
    _, _, pw, cfg = tiny
    cache = KVCache.create(cfg, 2, 256, kv)
    tokens, pos = torch.tensor([[5], [9]]), torch.tensor([3, 130], dtype=torch.int32)
    with _no_host_read():
        out = decode_step(pw, cache, tokens, pos, cfg, torch.float32)
    assert out.shape == (2, cfg.vocab_size) and torch.isfinite(out).all()


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_paged_decode_step_reads_nothing_on_the_host(tiny, kv):
    _, _, pw, cfg = tiny
    cache = PagedKVCache.create(cfg, 8, 2, 2, kv)
    cache.table.copy_(torch.tensor([[3, 5], [1, 0]], dtype=torch.int32))
    tokens, pos = torch.tensor([5, 9]), torch.tensor([PAGE + 4, 17], dtype=torch.int32)
    with _no_host_read():
        out = paged_decode_step(pw, cache, tokens, pos, cfg, torch.float32)
    assert out.shape == (2, cfg.vocab_size) and torch.isfinite(out).all()


_PROCESSORS = [Processors(False, False, False, False, False),
               Processors(True, False, False, False, False),
               Processors(True, True, True, True, True),
               Processors(False, False, True, False, True),
               Processors(False, False, False, True, False)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("proc", _PROCESSORS, ids=lambda p: "-".join(
    k for k, v in vars(p).items() if v) or "greedy")
def test_engine_ticks_read_nothing_on_the_host(gguf, paged, proc):
    """The engine's tick, the function its CUDA graphs capture, for sets of
    sampling processors: forward, sample_batch with logprobs, the ring
    writes, the recent window's shift, the feedback."""
    r = Runner(gguf, compute_dtype=torch.float32, device="cpu")
    eng = (PagedServingEngine(r, n_slots=2, seq_len=256, n_pages=8) if paged
           else ServingEngine(r, n_slots=2, seq_len=256))
    eng.temp[:] = 0.7
    eng.minp[:] = 0.05
    eng.rep_pen[:] = 1.3
    eng.freq_pen[:] = 0.2
    eng.recent[:, -3:] = 7
    if proc.bias:
        eng._bias()[0, 3] = 2.0
    eng.pos[:] = [4, 9]
    eng._upload(proc)
    with _no_host_read():
        eng._tick(proc, eng._gen)
        eng._tick(proc, eng._gen)
    s = eng._ticks
    assert s.count.tolist() == [2] and s.pos.tolist() == [6, 11]
    assert torch.equal(s.tok, s.toks[:, 1])
    if proc.repetition or proc.freq_pres:
        assert torch.equal(s.recent[:, -2:], s.toks[:, :2])


def test_samplers_read_nothing_on_the_host():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 64, generator=g)
    with _no_host_read():
        Sampler().sample(logits, g)
        Sampler(temperature=0.8, topp=0.9).sample(logits, g)
        sample_batch(logits, g, torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.9, 1.0, 0.5]),
                     minp=torch.tensor([0.0, 0.1, 0.0]), logit_bias=torch.zeros(3, 64),
                     recent_tokens=torch.tensor([[1, 2], [-1, 3], [4, 4]]),
                     repetition_penalty=torch.tensor([1.2, 1.0, 1.5]),
                     frequency_penalty=torch.tensor([0.1, 0.0, 0.2]),
                     presence_penalty=torch.tensor([0.0, 0.3, 0.1]), with_logprobs=True)


def test_sampled_draw_equals_multinomial():
    """The written-out draw gives torch.multinomial's tokens from the same
    generator state, so seeds keep their meaning."""
    from crabml_tpu_torch.runtime.sampler import _draw

    probs = torch.softmax(torch.randn(5, 300, generator=torch.Generator().manual_seed(1)), -1)
    a = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(9))[:, 0]
    assert torch.equal(_draw(probs, torch.Generator().manual_seed(9)), a)


# -- launch counts under replay -----------------------------------------------

def test_replays_count_as_eager_steps(monkeypatch):
    """A step's wrappers count their launches while the step is captured;
    _build.recording() takes those counts out (a capture launches nothing)
    and keeps them, and each replay adds them back: one captured step
    replayed n times counts n eager steps. A fake counter stands in for
    _build.launches, and a fake step for the wrappers."""
    counter = collections.Counter(qmm_w4a8=5)
    monkeypatch.setattr(_build, "launches", counter)

    def step():
        _build.launches["qmm_w4a8"] += 129
        _build.launches["decode_attention_fused"] += 32

    step()
    eager = counter - collections.Counter(qmm_w4a8=5)
    with _build.recording() as record:
        step()
    assert counter == collections.Counter(qmm_w4a8=5) + eager  # the capture added nothing
    assert record == eager
    before = collections.Counter(counter)
    _build.replayed(record, 7)
    _build.replayed(record)
    assert counter - before == collections.Counter({k: 8 * n for k, n in eager.items()})


def test_a_failed_capture_leaves_the_counts_as_they_were(monkeypatch):
    counter = collections.Counter(flash_attention=2)
    monkeypatch.setattr(_build, "launches", counter)
    with pytest.raises(RuntimeError), _build.recording():
        _build.launches["qmm_w4a8"] += 1
        raise RuntimeError("capture failed")
    assert counter == collections.Counter(flash_attention=2)
