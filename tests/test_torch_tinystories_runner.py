"""The TinyStories models through the port's entry points on the CPU against
the JAX package's: the Runner's greedy tokens on "captain america"
(BASELINE.json's config #1 prompt), both engines against the Runner, the
paged engine against the JAX paged engine, an int8 cache at head dim 8, a
file with no output.weight (the lm_head tied to the embedding), the HTTP
daemon, and the CLI.

Files as tests/test_torch_tinystories.py writes them: stories15M at 2 of 6
layers and a vocabulary of 512 of 32,000 (widths as published) in F32, Q8_0
and Q4_0; stories260K whole in F32.

Where the two Runners' greedy tokens part, the first differing token is held
to a near tie: at that context the port's logits of the two tokens lie
within the largest difference between the port's and the JAX package's
logits (chip_smoke.py::_hold_to_tie's rule). They can part on the quantized
files: the JAX package multiplies stories15M's q|k|v (864 rows), wo and down
(288 rows each) on its XLA path in float32, since they are not whole 256-row
tiles of its kernels, where the port's decode step takes int8 activations
(ROADMAP Queue 3, "Known differences")."""

import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu.serving.engine import Request as JRequest
from crabml_tpu.serving.paged import PagedServingEngine as JPagedServingEngine
from crabml_tpu_torch import cli
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.quant.qtensor import dequantize
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
from crabml_tpu_torch.serving import http as serving_http
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

PROMPT = "captain america"
PROMPTS = [PROMPT, "once upon a time there was a cat", "x"]
FILES = [("stories15m", "f32"), ("stories15m", "q8_0"), ("stories15m", "q4_0"),
         ("stories260k", "f32")]
CUT = {"stories15m": dict(layers=2, vocab=512), "stories260k": {}}
STEPS = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread, with IEEE float32 products: the suite
    runs in several worker processes at once."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stories")
    return {(m, s): build_synth_gguf(str(d / f"{m}-{s}.gguf"), m, seed=1, scheme=s, **CUT[m])
            for m, s in FILES}


@pytest.fixture
def w4a8_backend():
    """The JAX Runner under backend w4a8 sets it for the package's matmuls:
    set back to the default after the test."""
    yield
    jmm.set_backend("xla")


def _jax_runner(path, **kw):
    return JRunner(path, backend="w4a8", compute_dtype=jnp.float32, **kw)


def _greedy(r, prompt, steps):
    """The tokens a Runner consumed (prompt, then the greedy tokens but the
    last) after `steps` tokens."""
    r.reset()
    list(r.prefill_and_generate(prompt, steps))
    return list(r._consumed)


def _near_tie(r, jr, ctx, a, b):
    """At context `ctx` (the last token through the decode step): the gap
    between the port's logits of tokens a and b, and the largest difference
    between the port's and the JAX package's logits."""
    r.reset()
    jr.reset()
    r._forward_tokens(ctx[:-1])
    jr._forward_tokens(ctx[:-1])
    got = r._forward_tokens(ctx[-1:]).reshape(-1).numpy()
    want = np.asarray(jr._forward_tokens(ctx[-1:]), np.float32).reshape(-1)
    return abs(got[a] - got[b]), np.abs(got - want).max()


@pytest.mark.parametrize("model,scheme", FILES)
def test_runner_greedy_tokens_match_jax(files, w4a8_backend, model, scheme):
    """32 greedy tokens of PROMPT from both packages' Runners in float32 (the
    JAX one under backend w4a8): equal, or equal up to a first difference
    held to a near tie (the module docstring). The F32 files must be equal."""
    path = files[model, scheme]
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    jr = _jax_runner(path)
    got, want = _greedy(r, PROMPT, STEPS), _greedy(jr, PROMPT, STEPS)
    assert len(got) == len(want) >= STEPS
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return
    assert scheme != "f32", f"F32 tokens part at {i}"
    gap, diff = _near_tie(r, jr, got[:i], got[i], want[i])
    assert gap <= diff, (i, gap, diff)


@pytest.mark.parametrize("model,scheme", FILES)
def test_engines_match_the_runner(files, model, scheme):
    """Both engines' greedy tokens for three prompts through two slots equal
    the Runner's (the paged tick through flash over gathered pages at head
    dims 48 and 8); the paged engine returns its pages."""
    r = Runner(files[model, scheme], compute_dtype=torch.float32, device="cpu")
    want = []
    for p in PROMPTS:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, 12)))
    assert ServingEngine(r, n_slots=2, seq_len=128).generate(PROMPTS, max_tokens=12) == want
    paged = PagedServingEngine(r, n_slots=2, n_pages=8, seq_len=128)
    free = paged.pages_free()
    assert paged.generate(PROMPTS, max_tokens=12) == want
    assert paged.pages_free() == free


def test_paged_engine_matches_the_jax_paged_engine(files):
    """stories260K (head dim 8, 2 q heads a kv head) in float32: the port's
    paged engine and the JAX paged engine (whose hd-8 pool takes its
    non-fused route) give the same greedy tokens for three prompts through
    two slots, and so does the Runner."""
    path = files["stories260k", "f32"]
    n = 12
    jr = JRunner(path, compute_dtype=jnp.float32)
    jeng = JPagedServingEngine(jr, n_slots=2, seq_len=128, n_pages=8, kv_dtype=jnp.float32)
    jreqs = [jeng.submit(JRequest(prompt=p, max_tokens=n)) for p in PROMPTS]
    jeng.drain()
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    eng = PagedServingEngine(r, n_slots=2, seq_len=128, n_pages=8)
    reqs = [eng.submit(Request(prompt=p, max_tokens=n)) for p in PROMPTS]
    eng.drain()
    got = [q.output_tokens for q in reqs]
    assert got == [q.output_tokens for q in jreqs]
    for p, toks in zip(PROMPTS, got):
        r.reset()
        _, _, first = r.prefill(p)
        list(r.generate(first, n))
        assert r.generated == toks


def test_int8_cache_at_head_dim_8_matches_jax(files, w4a8_backend):
    """stories260K over an int8 cache (head dim 8: one scale a row of 8
    values), float32 compute on both sides: the prompt's and one decode
    step's logits within 2e-4 of max|logit| (the same cache codes, sums in
    another order), then 16 greedy tokens equal."""
    path = files["stories260k", "f32"]
    r = Runner(path, compute_dtype=torch.float32, kv_dtype=torch.int8, device="cpu")
    jr = _jax_runner(path, kv_dtype=jnp.int8)
    assert r.cache.k.dtype == torch.int8 and r.cache.k.shape[-1] == 8
    ids = r.tokenizer.encode(PROMPT, bos=True)
    want = np.asarray(jr._forward_tokens(ids), np.float32).reshape(-1)
    got = r._forward_tokens(ids).reshape(-1).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    first = int(np.argmax(want))
    assert int(np.argmax(got)) == first
    want = np.asarray(jr._forward_tokens([first]), np.float32).reshape(-1)
    got = r._forward_tokens([first]).reshape(-1).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    second = int(np.argmax(want))
    assert "".join(r.generate(second, 16)) == "".join(jr.generate(second, 16))


def test_output_weight_is_read_where_present_and_tied_where_absent(files, w4a8_backend, tmp_path):
    """stories260K's file holds output.weight: the lm_head is that tensor, not
    the embedding. Without it (written again without that tensor) the
    lm_head is the embedding, and the logits equal the JAX package's on the
    same file (float32, 2e-4)."""
    path = files["stories260k", "f32"]
    gf = GGUFFile(path)
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    out = np.asarray(gf.get_tensor_info("output.weight").to_numpy()).view(np.float32)
    np.testing.assert_array_equal(dequantize(r.weights["output"]).numpy().reshape(-1), out)
    assert not torch.equal(dequantize(r.weights["output"]),
                           dequantize(r.weights["token_embed"]))
    tied = str(tmp_path / "tied.gguf")
    w = GGUFWriter()
    for k, v in gf.metadata.as_dict().items():
        w.add_metadata(k, v, gf.metadata.value_type(k))
    for ti in gf.tensor_infos:
        if ti.name != "output.weight":
            w.add_tensor(ti.name, ti.typ, ti.shape, ti.to_numpy())
    w.write(tied)
    rt = Runner(tied, compute_dtype=torch.float32, device="cpu")
    assert torch.equal(dequantize(rt.weights["output"]), dequantize(rt.weights["token_embed"]))
    jr = _jax_runner(tied)
    ids = rt.tokenizer.encode(PROMPT, bos=True)
    want = np.asarray(jr._forward_tokens(ids), np.float32).reshape(-1)
    got = rt._forward_tokens(ids).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cli_runs_stories15m_on_the_cpu(files, capsys):
    """The CLI on the stories15M F32 file (BASELINE.json's config #1: prompt
    'captain america'), greedy: the text equals the Runner's."""
    path = files["stories15m", "f32"]
    assert cli.main([path, "-p", PROMPT, "-n", "24", "-t", "0", "--device", "cpu",
                     "--dtype", "f32"]) == 0
    out = capsys.readouterr()[0]
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    assert out == PROMPT + "".join(r.prefill_and_generate(PROMPT, 24)) + "\n"


def test_daemon_answers_as_the_runner_on_stories260k(files):
    """The HTTP daemon (paged, float32, the CPU) on the stories260K file:
    the three prompts POSTed to /v1/completions, greedy, each text equal to
    the Runner's 12 tokens on the same prompt; then a clean shutdown."""
    path = files["stories260k", "f32"]
    n = 12
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    want = []
    for p in PROMPTS:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, n)))
    engine, args = serving_http.engine_from_args(
        [path, "--device", "cpu", "--dtype", "f32", "--host", "127.0.0.1", "--port", "0",
         "--slots", "2", "--seq-len", "128", "--paged", "--pages", "8"])
    server = serving_http.make_server(engine, args.host, args.port)
    thread = threading.Thread(target=serving_http.serve, args=(engine,),
                              kwargs={"server": server}, daemon=True)
    thread.start()
    try:
        for p, text in zip(PROMPTS, want):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
            conn.request("POST", "/v1/completions", body=json.dumps({"prompt": p, "max_tokens": n}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read().decode())
            conn.close()
            assert resp.status == 200 and out["choices"][0]["text"] == text
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
