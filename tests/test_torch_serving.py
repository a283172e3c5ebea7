"""The port's serving engines: greedy tokens against the JAX package's two
engines on one synthetic GGUF, then the engines' own behaviour (pages, prefix
cache, preemption, cancel, stop strings, logprobs, multi-tick steps) on the
CPU in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu.serving.engine import Request as JRequest
from crabml_tpu.serving.engine import ServingEngine as JServingEngine
from crabml_tpu.serving.paged import PagedServingEngine as JPagedServingEngine
from crabml_tpu_torch.ops.cuda.paged_decode_attention import PAGE
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

# the configuration of tests/test_torch_model.py: head dim 128 and a
# 128-aligned cache, so the JAX engines take their fused decode paths
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PROMPTS = ["tok7 tok99 tok3 tok250 tok17", "tok5 tok5 tok81", "tok300 tok12 tok44 tok9"]


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


def test_four_engines_give_the_same_greedy_tokens(tmp_path, w4a8_backend):
    """One synthetic Q4_K GGUF, float32, JAX backend w4a8: the port's dense
    engine, the port's paged engine, JAX's ServingEngine and JAX's
    PagedServingEngine give the same greedy tokens for three prompts through
    two slots (tolerance 0: token identity). Random weights give nearly flat
    logits: with weight seed 3 the JAX package's own two engines differ in one
    token of a near-tie, so the seed is one on which they agree."""
    path = str(tmp_path / "tiny_q4k.gguf")
    write_synthetic_gguf(path, tiny_config(**CFG), JGGMLType.Q4_K, seed=11)
    n = 8
    jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
    outs = {}
    for name, eng in (
        ("jax dense", JServingEngine(jr, n_slots=2, seq_len=256)),
        ("jax paged", JPagedServingEngine(jr, n_slots=2, seq_len=256, n_pages=8,
                                          kv_dtype=jnp.float32)),
    ):
        reqs = [eng.submit(JRequest(prompt=p, max_tokens=n)) for p in PROMPTS]
        eng.drain()
        outs[name] = [r.output_tokens for r in reqs]
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    for name, eng in (
        ("port dense", ServingEngine(r, n_slots=2, seq_len=256)),
        ("port paged", PagedServingEngine(r, n_slots=2, seq_len=256, n_pages=8)),
    ):
        reqs = [eng.submit(Request(prompt=p, max_tokens=n)) for p in PROMPTS]
        eng.drain()
        assert all(q.finish_reason == "length" for q in reqs)
        outs[name] = [q.output_tokens for q in reqs]
    assert all(len(t) == n for t in outs["port dense"])
    assert outs["port dense"] == outs["jax dense"]
    assert outs["port paged"] == outs["jax paged"]
    assert outs["port dense"] == outs["port paged"]


# -- the port's own behaviour, on its tiny synthetic model -------------------

@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    path = build_synth_gguf(str(tmp_path_factory.mktemp("gguf") / "tiny.gguf"), "tiny", seed=1)
    return Runner(path, compute_dtype=torch.float32, device="cpu")


def _toks(seed: int, n: int) -> list[int]:
    return [1] + np.random.default_rng(seed).integers(259, 512, n - 1).tolist()


NO_EOS = ((2, -1e4),)  # random weights emit EOS now and then: rule it out


def _run(engine, prompts, **kw):
    kw.setdefault("logit_bias", NO_EOS)
    reqs = [engine.submit(Request(prompt="", prompt_tokens=list(p), **kw)) for p in prompts]
    engine.drain(max_steps=2000)
    assert all(r.done for r in reqs)
    return reqs


def _dense(runner, **kw):
    kw.setdefault("n_slots", 2)
    return ServingEngine(runner, seq_len=512, **kw)


def _paged(runner, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 16)
    return PagedServingEngine(runner, seq_len=512, **kw)


def _solo(runner, prompt, n, **kw):
    return _run(_dense(runner), [prompt], max_tokens=n, **kw)[0].output_tokens


def test_engine_matches_the_single_stream_runner(runner):
    runner.reset()
    want = "".join(runner.prefill_and_generate("hello world", 10))
    assert _dense(runner).generate(["hello world"], max_tokens=10) == [want]
    assert _paged(runner).generate(["hello world"], max_tokens=10) == [want]


def test_pages_recycle_through_a_small_pool(runner):
    """Six requests through two slots and a pool that holds three at most:
    every page comes back, and the outputs equal the dense engine's."""
    prompts = [_toks(s, 40 + 30 * s) for s in range(6)]
    eng = _paged(runner, n_pages=6, prefix_cache=False)
    start = eng.pages_free()
    got = [r.output_tokens for r in _run(eng, prompts, max_tokens=8)]
    assert eng.pages_free() == start == 5
    assert got == [r.output_tokens for r in _run(_dense(runner), prompts, max_tokens=8)]
    assert (eng._table == 0).all()


def test_decode_crosses_a_page_boundary(runner):
    p = _toks(1, 20)
    got = _run(_paged(runner), [p], max_tokens=PAGE + 20)[0]
    assert len(got.output_tokens) == PAGE + 20
    assert got.output_tokens == _solo(runner, p, PAGE + 20)


def test_pool_exhaustion_queues_requests(runner):
    """Three usable pages, prompts of two pages each: one request at a time
    fits; the others wait in the queue and all finish."""
    prompts = [_toks(s, 200) for s in range(3)]
    eng = _paged(runner, n_pages=4, prefix_cache=False)
    reqs = _run(eng, prompts, max_tokens=5)
    assert [r.finish_reason for r in reqs] == ["length"] * 3
    assert [r.output_tokens for r in reqs] == [_solo(runner, p, 5) for p in prompts]
    assert eng.pages_free() == 3


def test_freed_pages_never_corrupt_a_live_request(runner):
    """A long request keeps decoding while short ones come and go through the
    other slot and reuse its neighbours' pages."""
    long_p = _toks(9, 150)
    shorts = [_toks(20 + s, 30) for s in range(5)]
    eng = _paged(runner, n_pages=6, prefix_cache=False)
    reqs = [eng.submit(Request(prompt="", prompt_tokens=long_p, max_tokens=60,
                               logit_bias=NO_EOS))]
    reqs += [eng.submit(Request(prompt="", prompt_tokens=p, max_tokens=6, logit_bias=NO_EOS))
             for p in shorts]
    eng.drain(max_steps=2000)
    assert reqs[0].output_tokens == _solo(runner, long_p, 60)
    assert [r.output_tokens for r in reqs[1:]] == [_solo(runner, p, 6) for p in shorts]


def test_impossible_prompt_fails_and_does_not_hang(runner):
    eng = _paged(runner, n_pages=2)  # one usable page
    reqs = _run(eng, [_toks(0, 200), _toks(1, 50)], max_tokens=4)
    assert reqs[0].finish_reason == "error" and reqs[0].output_tokens == []
    assert reqs[1].finish_reason == "length"


def test_int8_pool_matches_dense_int8(runner):
    prompts = [_toks(3, 140), _toks(4, 20)]
    dense = _run(_dense(runner, kv_dtype=torch.int8), prompts, max_tokens=12)
    paged = _run(_paged(runner, kv_dtype=torch.int8), prompts, max_tokens=12)
    assert [r.output_tokens for r in paged] == [r.output_tokens for r in dense]
    assert paged[0].finish_reason == "length"


def test_synchronous_admission_matches_chunked(runner):
    prompts = [_toks(5, 150), _toks(6, 10)]
    want = [_solo(runner, p, 7) for p in prompts]
    for mk in (_dense, _paged):
        for kv in (None, torch.int8):
            eng = mk(runner, prefill_chunk=None, kv_dtype=kv)
            ref = mk(runner, kv_dtype=kv)
            got = [r.output_tokens for r in _run(eng, prompts, max_tokens=7)]
            assert got == [r.output_tokens for r in _run(ref, prompts, max_tokens=7)]
            if kv is None:
                assert got == want


def test_prefix_cache_hit_is_exact_and_accounted(runner):
    """A second prompt with the same first 256 tokens reuses two pages: it
    forwards only its tail, and gives the tokens a cold engine gives."""
    base = _toks(7, 256)
    a, b = base + _toks(8, 40)[1:], base + _toks(9, 3)[1:]
    eng = _paged(runner)
    _run(eng, [a], max_tokens=4)
    assert eng.prefix_hits == 0 and eng.prefill_tokens == len(a)
    got = _run(eng, [b], max_tokens=6)[0].output_tokens
    assert eng.prefix_hits == 1 and eng.prefix_tokens_reused == 256
    assert eng.prefill_tokens == len(a) + len(b) - 256  # a 2-token tail: the table kernel's path
    assert got == _solo(runner, b, 6)
    # an exact repeat still recomputes its last token
    c = base
    assert _run(eng, [c], max_tokens=3)[0].output_tokens == _solo(runner, c, 3)
    assert eng.prefix_tokens_reused == 256 + 128
    assert eng.pages_free() == 15


def test_concurrent_share_with_divergent_tails(runner):
    base = _toks(11, 128)
    prompts = [base + _toks(12 + s, 20 + s)[1:] for s in range(4)]
    eng = _paged(runner, n_slots=4)
    _run(eng, [base + [300]], max_tokens=2)  # registers the shared page
    got = [r.output_tokens for r in _run(eng, prompts, max_tokens=10)]
    assert eng.prefix_hits == 4
    assert got == [_solo(runner, p, 10) for p in prompts]
    assert eng.pages_free() == 15 and not any(eng._owned)


def test_eviction_under_pressure(runner):
    """Cached prefix pages give way when the allocator needs them."""
    eng = _paged(runner, n_pages=5)
    _run(eng, [_toks(30, 300)], max_tokens=2)  # registers 2 pages, kept as cache
    assert len(eng._evictable) == 2 and eng.pages_free() == 4
    p = _toks(31, 400)
    assert _run(eng, [p], max_tokens=3)[0].output_tokens == _solo(runner, p, 3)
    assert eng.prefix_evictions >= 1 and eng.pages_free() == 4


def test_preemption_and_readmission(runner):
    """Two requests that outgrow a five-page pool: the younger is preempted
    and recomputed later through the prefix cache, and both finish. The older
    one gives exactly what an unpressured engine gives. The preempted one
    does so up to and including the first token after its return; beyond
    that its recomputed KV (prefill order of sums, not decode order) may flip
    a near-tie of this random model, so only its length is held."""
    prompts = [_toks(40, 250), _toks(41, 250)]
    eng = _paged(runner, n_pages=6)
    at_preempt = []
    preempt = eng._preempt
    eng._preempt = lambda slot: (at_preempt.append(len(eng.slots[slot].output_tokens)),
                                 preempt(slot))
    reqs = _run(eng, prompts, max_tokens=140)
    assert eng.preemptions == len(at_preempt) >= 1 and eng.prefix_hits >= 1
    assert [r.finish_reason for r in reqs] == ["length", "length"]
    assert [len(r.output_tokens) for r in reqs] == [140, 140]
    want = [r.output_tokens for r in _run(_paged(runner, n_pages=16), prompts, max_tokens=140)]
    assert reqs[0].output_tokens == want[0]
    n = at_preempt[0] + 1
    assert n > 1 and reqs[1].output_tokens[:n] == want[1][:n]
    assert eng.pages_free() == 5


def test_cancel_frees_the_slot_and_pages(runner):
    eng = _paged(runner)
    a = eng.submit(Request(prompt="", prompt_tokens=_toks(50, 30), max_tokens=100))
    b = eng.submit(Request(prompt="", prompt_tokens=_toks(51, 30), max_tokens=5))
    queued = eng.submit(Request(prompt="", prompt_tokens=_toks(52, 30), max_tokens=5))
    eng.cancel(queued)
    for _ in range(4):
        eng.step()
    eng.cancel(a)
    eng.drain(max_steps=500)
    assert a.finish_reason == "cancelled" and 0 < len(a.output_tokens) < 100
    assert b.finish_reason == "length" and queued.finish_reason == "cancelled"
    assert eng.pages_free() == 15 and eng.requests_completed == 3


def test_stop_strings_and_stop_tokens(runner):
    p = _toks(60, 12)
    full = _run(_dense(runner), [p], max_tokens=12)[0]
    text = runner.tokenizer.decode_tokens(full.output_tokens)
    cut = text[len(text) // 2: len(text) // 2 + 3]
    r = _run(_dense(runner), [p], max_tokens=12, stop=(cut,))[0]
    assert r.finish_reason == "stop" and r.output_text == text[: text.find(cut)]
    out = full.output_tokens
    i = next(i for i in range(1, 12) if out[i] not in out[:i])  # first new token id
    r = _run(_paged(runner), [p], max_tokens=12, stop_token_ids=(out[i],))[0]
    assert r.finish_reason == "stop" and r.output_tokens == out[:i]


def test_logprobs_and_logit_bias(runner):
    """Sampled-token logprobs are log-probabilities of the processed logits:
    the greedy token's is the largest of the top-k, within 1e-6."""
    p = _toks(61, 9)
    for mk in (_dense, _paged):
        r = _run(mk(runner), [p], max_tokens=5, logprobs=3)[0]
        assert len(r.output_logprobs) == 5 and len(r.output_top_logprobs) == 5
        for tok, lp, top in zip(r.output_tokens, r.output_logprobs, r.output_top_logprobs):
            assert len(top) == 3 and top[0][0] == tok
            assert abs(top[0][1] - lp) <= 1e-6 and lp <= 0
        forced = _run(mk(runner), [p], max_tokens=4, logit_bias=((333, 1e5),))[0]
        assert forced.output_tokens == [333] * 4


@pytest.mark.parametrize("make", [_dense, _paged], ids=["dense", "paged"])
def test_multi_tick_steps_at_the_seq_len_edge(runner, make):
    """step(multi=4) gives the tokens of step(1), up to the last position of
    a 256-token cache, where both finish with `length`."""
    prompts = [_toks(70, 240), _toks(71, 100)]
    outs = []
    for multi in (1, 4):
        eng = make(runner)
        eng.seq_len = 256
        reqs = [eng.submit(Request(prompt="", prompt_tokens=p, max_tokens=40,
                                   logit_bias=NO_EOS)) for p in prompts]
        while any(eng.slots) or not eng.pending.empty():
            eng.step(multi)
        assert int(eng.pos.max()) == 0
        outs.append([(r.output_tokens, r.finish_reason) for r in reqs])
        assert len(reqs[0].output_tokens) == 256 - 1 - 240 + 1
    assert outs[0] == outs[1]


def test_sampled_requests_reproduce_from_the_seed(runner):
    prompts = [_toks(80, 15), _toks(81, 25)]
    kw = dict(max_tokens=12, temperature=0.9, topp=0.9, repetition_penalty=1.2)
    a = [r.output_tokens for r in _run(_paged(runner, seed=3), prompts, **kw)]
    b = [r.output_tokens for r in _run(_paged(runner, seed=3), prompts, **kw)]
    c = [r.output_tokens for r in _run(_paged(runner, seed=4), prompts, **kw)]
    assert a == b and a != c
    assert a[0] != _solo(runner, prompts[0], 12)


def test_latency_histograms_and_counters(runner):
    eng = _paged(runner)
    _run(eng, [_toks(90, 10), _toks(91, 10), _toks(92, 10)], max_tokens=4)
    assert eng.ttft_hist.n == eng.e2e_hist.n == 3
    assert 0 < eng.ttft_hist.quantile(0.5) <= eng.e2e_hist.quantile(0.99)
    assert eng.requests_submitted == eng.requests_completed == 3
    assert "crabml_ttft_seconds_count 3" in eng.ttft_hist.render("crabml_ttft_seconds")
    hist = type(eng.ttft_hist)()  # the kept observations are bounded, the counts are not
    for i in range(hist.RECENT + 10):
        hist.observe(0.001 * i)
    assert hist.n == hist.RECENT + 10 and len(hist.values) == hist.RECENT
