"""Speculative serving of the port's two engines (serving/engine.py,
serving/paged.py) and daemon on the CPU, float32: with `speculative=4` a
greedy request's tokens are those the engine gives without it, in the single
verify step and in the fused rounds of `step(multi)`, with prompt lookup and
with a draft model, under mixed greedy and sampled traffic, over an int8
cache or pool, with a stop string inside a round; and the paged engine's
speculative tokens against the JAX paged engine's (Pallas in interpret mode,
backend `w4a8`). Every comparison of tokens is exact; the seeds are named
where they are made.
"""

import http.client
import json
import threading

import jax.numpy as jnp
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu.serving.engine import Request as JRequest
from crabml_tpu.serving.paged import PagedServingEngine as JPagedServingEngine
from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
from crabml_tpu_torch.serving import http as serving_http
from crabml_tpu_torch.tokenizer import Utf8Buf
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

# tests/test_torch_serving.py's configuration: head dim 128, a 128-aligned
# cache; with weight seed 11 the JAX package's own engines agree, and its
# greedy runs fall into loops, so prompt lookup finds drafts
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PROMPTS = ["tok7 tok99 tok3 tok250 tok17 tok7 tok99 tok3", "tok5 tok5 tok81",
           "tok300 tok12 tok44 tok9 tok300 tok12"]
K = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX writer's tiny Q4_K file (seed 11), a draft of the same shape
    (seed 12), the port's `tiny-qwen2` (seed 7: 7 q heads a kv head) and a
    `tiny` of vocabulary 512 against a draft of 1024."""
    d = tmp_path_factory.mktemp("spec_serving")
    out = {n: str(d / f"{n}.gguf") for n in ("tiny", "draft", "vocab1024")}
    write_synthetic_gguf(out["tiny"], tiny_config(**CFG), JGGMLType.Q4_K, seed=11)
    write_synthetic_gguf(out["draft"], tiny_config(**CFG), JGGMLType.Q4_K, seed=12)
    write_synthetic_gguf(out["vocab1024"], tiny_config(n_layers=1, vocab_size=1024),
                         JGGMLType.Q4_K, seed=1)
    out["qwen2"] = build_synth_gguf(str(d / "qwen2.gguf"), "tiny-qwen2", seed=7)
    return out


@pytest.fixture(scope="module")
def runner(files):
    return Runner(files["tiny"], compute_dtype=torch.float32, device="cpu")


def _make(cls, r, n_slots=2, **kw):
    extra = dict(n_pages=12) if cls is PagedServingEngine else {}
    return cls(r, n_slots=n_slots, seq_len=256, **extra, **kw)


def _drain(eng, reqs, multi=1):
    """Submit `reqs` (Request keyword dicts), step(multi) until done -> each
    request's (tokens, text, finish reason)."""
    subs = [eng.submit(Request(**kw)) for kw in reqs]
    while any(eng.slots) or not eng.pending.empty():
        eng.step(multi)
    return [(list(q.output_tokens), q.output_text, q.finish_reason) for q in subs]


GREEDY = [dict(prompt=p, max_tokens=20) for p in PROMPTS]
ENGINES = [ServingEngine, PagedServingEngine]
IDS = ["dense", "paged"]


@pytest.mark.parametrize("fused", [False, True], ids=["single", "fused"])
@pytest.mark.parametrize("multi", [1, 4])
@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_speculative_greedy_tokens_are_plain(runner, cls, multi, fused):
    """Three greedy requests through two slots (the third waits for a slot):
    with speculative=4 each engine gives the tokens of its plain ticks, at
    step(1) and step(4), with the fused rounds off and on; speculation ran
    and accepted drafts (more tokens than rounds)."""
    want = _drain(_make(cls, runner), GREEDY, multi)
    eng = _make(cls, runner, speculative=K, spec_fused=fused)
    assert _drain(eng, GREEDY, multi) == want
    assert eng.spec_ticks > 0 and eng.spec_tokens > eng.spec_ticks


@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_spec_fused_defaults_follow_the_jax_package(runner, cls):
    """The dense engine fuses rounds by default, the paged one does not."""
    assert _make(cls, runner, speculative=K).spec_fused == (cls is ServingEngine)


@pytest.mark.parametrize("multi", [1, 4])
@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_mixed_greedy_and_sampled_traffic(runner, cls, multi):
    """A sampled request (temperature 0.8, seed 0 of the engine) and one with
    a repetition penalty beside a greedy one: the greedy request's tokens are
    the plain engine's, the penalized one (argmax with a penalty: not
    speculated) takes each verify's position-0 token and gives its plain
    tokens too, and the sampled one runs to its length."""
    reqs = [GREEDY[0], dict(prompt=PROMPTS[1], max_tokens=12, temperature=0.8),
            dict(prompt=PROMPTS[2], max_tokens=12, repetition_penalty=1.5)]
    want = _drain(_make(cls, runner, n_slots=3), reqs, multi)
    eng = _make(cls, runner, n_slots=3, speculative=K)
    got = _drain(eng, reqs, multi)
    assert got[0] == want[0] and got[2] == want[2]
    assert len(got[1][0]) == 12 and got[1][2] == "length"
    assert eng.spec_tokens > 0


@pytest.mark.parametrize("multi", [1, 4])
@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_two_model_speculation(files, runner, cls, multi):
    """A Runner with a draft model (a file of weight seed 12) lends it to the
    engine with its K = 4; the tokens are the plain engine's. The target as
    its own draft has every draft of a single verify step accepted until a
    request's budget ends the round."""
    want = _drain(_make(cls, runner), GREEDY, multi)
    rd = Runner(files["tiny"], compute_dtype=torch.float32, device="cpu",
                draft_model=files["draft"])
    eng = _make(cls, rd)
    assert eng.speculative == K and eng._draft is rd._draft
    assert _drain(eng, GREEDY, multi) == want
    oracle = _make(cls, runner, speculative=K, draft_runner=runner, spec_fused=False)
    assert _drain(oracle, GREEDY[:1], multi) == want[:1]
    assert oracle.spec_tokens >= 4 * oracle.spec_ticks  # 5 a step but at the end


@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_int8_cache_and_pool(runner, cls):
    """Over an int8 cache (dense) or pool (paged) the speculative tokens are
    those of the plain ticks over the same int8 storage."""
    want = _drain(_make(cls, runner, kv_dtype=torch.int8), GREEDY, 4)
    eng = _make(cls, runner, kv_dtype=torch.int8, speculative=K)
    assert _drain(eng, GREEDY, 4) == want and eng.spec_tokens > eng.spec_ticks


@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_stop_string_inside_a_round(runner, cls):
    """A stop string that the greedy text reaches at a token in the middle of
    a round: the request ends there with the plain engine's text, tokens and
    reason, and its slot goes to the waiting request."""
    plain = _drain(_make(cls, runner), [dict(prompt=PROMPTS[0], max_tokens=20)])[0][0]
    buf = Utf8Buf()
    pieces = [runner.tokenizer.decode(t, buf) for t in plain]
    j = next(i for i in range(6, len(pieces)) if pieces[i].strip()
             and "".join(pieces[:i]).find(pieces[i].strip()) < 0)
    reqs = [dict(prompt=PROMPTS[0], max_tokens=20, stop=(pieces[j].strip(),)), GREEDY[1],
            GREEDY[2]]
    want = _drain(_make(cls, runner), reqs)
    got = _drain(_make(cls, runner, speculative=K, spec_fused=False), reqs)
    assert got == want and got[0][2] == "stop" and len(got[0][0]) < 20


@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_qwen2_heads(files, cls):
    """tiny-qwen2 (7 q heads a kv head: a K = 4 verify is 35 query rows a
    kv head): speculative greedy tokens are the plain engine's."""
    r = Runner(files["qwen2"], compute_dtype=torch.float32, device="cpu")
    want = _drain(_make(cls, r), GREEDY[:2], 4)
    assert _drain(_make(cls, r, speculative=K), GREEDY[:2], 4) == want


def test_a_draft_of_another_vocabulary_is_refused(files, runner):
    d = Runner(files["vocab1024"], compute_dtype=torch.float32, device="cpu")
    with pytest.raises(UnsupportedError, match="vocab"):
        ServingEngine(runner, n_slots=2, speculative=K, draft_runner=d)


def test_paged_engine_matches_the_jax_paged_engine(files, runner):
    """The port's paged engine and the JAX PagedServingEngine, both with
    speculative=4 (single verify steps, the JAX default) over a float32
    pool: the same greedy tokens for three prompts through two slots."""
    jmm.set_backend("w4a8")
    try:
        jr = JRunner(files["tiny"], backend="w4a8", compute_dtype=jnp.float32)
        jeng = JPagedServingEngine(jr, n_slots=2, seq_len=256, n_pages=12,
                                   kv_dtype=jnp.float32, speculative=K)
        jreqs = [jeng.submit(JRequest(**kw)) for kw in GREEDY]
        while any(jeng.slots) or not jeng.pending.empty():
            jeng.step()
        want = [list(map(int, q.output_tokens)) for q in jreqs]
    finally:
        jmm.set_backend("xla")
    assert jeng.spec_ticks > 0
    got = _drain(_make(PagedServingEngine, runner, speculative=K), GREEDY)
    assert [t for t, _, _ in got] == want


# eight prompts of the vocabulary's pieces, for eight slots at once
PROMPTS8 = [" ".join(f"tok{(31 * i + 7 * j) % 500 + 3}" for j in range(3 + i % 4))
            for i in range(8)]


def test_paged_engine_matches_the_jax_paged_engine_at_eight_slots(files, runner):
    """Eight slots at once with speculative=4 (single verify steps, the JAX
    default) over a float32 pool: each verify is 8 x 5 = 40 rows, past
    W4A8_MAX_ROWS = 16, so both packages multiply it with the dequant matmul
    where the plain tick's 8 rows take int8 activations. The port's
    speculative tokens equal the JAX paged engine's for all eight requests
    (24 tokens each): where a request leaves its package's plain decode,
    the JAX package leaves it the same way."""
    greedy = [dict(prompt=p, max_tokens=24) for p in PROMPTS8]
    jmm.set_backend("w4a8")
    try:
        jr = JRunner(files["tiny"], backend="w4a8", compute_dtype=jnp.float32)
        jeng = JPagedServingEngine(jr, n_slots=8, seq_len=256, n_pages=24,
                                   kv_dtype=jnp.float32, speculative=K)
        jreqs = [jeng.submit(JRequest(**kw)) for kw in greedy]
        while any(jeng.slots) or not jeng.pending.empty():
            jeng.step()
        want = [list(map(int, q.output_tokens)) for q in jreqs]
    finally:
        jmm.set_backend("xla")
    assert jeng.spec_ticks > 0
    eng = PagedServingEngine(runner, n_slots=8, seq_len=256, n_pages=24, speculative=K)
    got = _drain(eng, greedy)
    assert eng.spec_ticks > 0
    assert [t for t, _, _ in got] == want


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_daemon_speculative_and_draft(files, paged):
    """`--speculative 4` and `--draft GGUF` on the daemon's command line
    (--device cpu): the engine speculates with the draft model, a completion
    gives the plain daemon's text, and /metrics counts the rounds."""
    base = [files["tiny"], "--device", "cpu", "--dtype", "f32", "--host", "127.0.0.1",
            "--port", "0", "--slots", "2", "--seq-len", "256"] + (["--paged", "--pages", "12"]
                                                                    if paged else [])
    plain, _ = serving_http.engine_from_args(base)
    want = plain.generate([PROMPTS[0]], max_tokens=16)
    lookup, _ = serving_http.engine_from_args(base + ["--speculative", "4"])
    assert lookup.speculative == K and lookup._draft is None
    engine, args = serving_http.engine_from_args(base + ["--draft", files["draft"]])
    assert engine.speculative == K and engine._draft is not None
    server = serving_http.make_server(engine, args.host, args.port)
    thread = threading.Thread(target=serving_http.serve, args=(engine,),
                              kwargs={"server": server}, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]

        def call(method, path, payload=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request(method, path, body=None if payload is None else json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read().decode()
            conn.close()
            return resp.status, data

        status, data = call("POST", "/v1/completions", {"prompt": PROMPTS[0], "max_tokens": 16})
        assert status == 200 and json.loads(data)["choices"][0]["text"] == want[0]
        status, metrics = call("GET", "/metrics")
        ticks = next(int(ln.split()[-1]) for ln in metrics.splitlines()
                     if ln.startswith("crabml_spec_ticks_total"))
        assert ticks > 0 and "crabml_spec_tokens_total" in metrics
    finally:
        server.shutdown()
        thread.join(timeout=30)


@pytest.mark.parametrize("cls", ENGINES, ids=IDS)
def test_spec_rounds_read_nothing_on_the_host(runner, cls):
    """Two of the engine's fused rounds (_run_spec_scan: the 2-gram drafts,
    the verify through the cache or the block table, the position-0 sample
    with a penalty, the accept rule) under tests/test_torch_decode_loop.py's
    guard: nothing is handed to the host, so a CUDA graph can capture a
    round."""
    import numpy as np
    from test_torch_decode_loop import _no_host_read

    eng = _make(cls, runner, speculative=K)
    if cls is PagedServingEngine:
        eng._table[:, :2] = [[3, 5], [1, 2]]
        eng._push_table()
    eng.pos[:] = [40, 9]
    eng.rep_pen[1] = 1.3
    hist = np.random.default_rng(12).integers(3, 20, (2, 256))
    with _no_host_read():
        outs, counts, _ = eng._run_spec_scan(hist, np.ones(2, bool), np.array([True, False]),
                                             2, K)
    assert outs.shape == (2, 2, K + 1) and counts[:, 1].tolist() == [1, 1]
