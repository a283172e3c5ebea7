"""Speculative decoding of the port (runtime/speculative.py, the Runner, the
CLI) against the JAX package's (crabml_tpu/runtime/speculative.py, its
Runner; Pallas in interpret mode, backend `w4a8`, float32) and against the
port's own plain greedy decode, on the CPU.

The models are synthetic Q4_K files of tools/synth_gguf.py: `tiny` (2 q
heads a kv head, head dim 128: a K = 4 verify is 10 query rows) and
`tiny-qwen2` (7 a kv head: a K = 4 verify is 35 rows, three row tiles of the
decode kernels on the card). Every comparison of tokens is exact; the seeds
are named where they are made. The drafts never change the tokens, only how
many a round emits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.models.weights import fuse_weights, load_weights as jload_weights, repack_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime import speculative as jspec
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu.serving.engine import _draft_2gram_one, _lookup_draft as j_lookup_draft
from crabml_tpu_torch import cli
from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache
from crabml_tpu_torch.models.weights import load_weights
from crabml_tpu_torch.runtime import speculative
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving.engine import _lookup_draft
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

# a prompt whose 2-grams repeat, so that prompt lookup finds drafts
PROMPT = "tok7 tok99 tok3 tok250 tok17 tok7 tok99 tok3 tok250 tok17 tok7 tok99"
K = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test, as in tests/test_torch_decode_loop.py (the
    suite's worker processes run side by side)."""
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
def files(tmp_path_factory):
    """The target `tiny` (weight seed 5), a draft `tiny` of another seed (6),
    `tiny-qwen2` (seed 7) and a draft whose vocabulary differs (the JAX
    package's writer, vocab 1024)."""
    d = tmp_path_factory.mktemp("spec")
    out = {"tiny": build_synth_gguf(str(d / "tiny.gguf"), "tiny", seed=5),
           "draft": build_synth_gguf(str(d / "draft.gguf"), "tiny", seed=6),
           "qwen2": build_synth_gguf(str(d / "qwen2.gguf"), "tiny-qwen2", seed=7)}
    out["other_vocab"] = str(d / "vocab1024.gguf")
    write_synthetic_gguf(out["other_vocab"], tiny_config(n_layers=1, vocab_size=1024),
                         JGGMLType.Q4_K, seed=1)
    return out


# -- the drafts -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draft_tokens_match_jax_2gram(seed):
    """The device 2-gram lookup against the JAX engine's _draft_2gram_one
    (vmapped), bit for bit: 16 random histories over a 5-token alphabet (so
    2-grams repeat), positions 0 .. S-1 (the edges included), drafts of 4,
    and the history with the current token written."""
    rng = np.random.default_rng(seed)
    B, S = 16, 40
    hist = rng.integers(0, 5, (B, S))
    token = rng.integers(0, 5, B)
    pos = np.concatenate([[0, 1, 2, S - 1, S - 2], rng.integers(0, S, B - 5)])
    jd, jh = jax.vmap(lambda h, t, p: _draft_2gram_one(h, t, p, draft=K, match_len=2))(
        jnp.asarray(hist, jnp.int32), jnp.asarray(token, jnp.int32), jnp.asarray(pos, jnp.int32))
    d, h = speculative.draft_tokens(torch.from_numpy(hist), torch.from_numpy(token),
                                    torch.from_numpy(pos), K)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_host_lookup_draft_matches_jax():
    """The engines' host-side lookup: the same drafts as the JAX engine's
    _lookup_draft on random contexts (seed 3), short ones included."""
    rng = np.random.default_rng(3)
    for n in [0, 1, 2, 3, 4, 7, 20, 60]:
        for _ in range(5):
            ctx = rng.integers(0, 4, n).tolist()
            assert _lookup_draft(ctx, K) == j_lookup_draft(ctx, K), ctx


# -- the loops against JAX's, from one cache state -----------------------------

def _models(path: str):
    """The JAX weights (kernel layout, for the w4a8 backend) and the port's,
    both from the file."""
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    return jw, jcfg, load_weights(gf, cfg, "cpu", torch.float32), cfg


def _greedy_history(pw, cfg, seed: int, n_prompt: int = 8, n_gen: int = 24):
    """A random prompt of n_prompt tokens (seed `seed`) and the port's plain
    greedy continuation: -> (the n_prompt + n_gen tokens a cache then holds
    (1, P), the next token to consume). Greedy decode of these weights falls
    into loops, so its 2-grams repeat and prompt lookup finds drafts."""
    from crabml_tpu_torch.models.forward import forward
    from crabml_tpu_torch.runtime.generate import decode_loop
    from crabml_tpu_torch.runtime.sampler import Sampler

    prompt = np.random.default_rng(seed).integers(3, cfg.vocab_size, n_prompt)
    cache = KVCache.create(cfg, 1, 128)
    first = int(forward(pw, cache, torch.from_numpy(prompt)[None], torch.tensor([0]),
                        cfg)[0, -1].argmax())
    gen = decode_loop(pw, cache, [first], [n_prompt], n_gen, cfg, torch.float32,
                      Sampler())[0].tolist()
    return np.asarray([*prompt, first, *gen[:-1]])[None], gen[-1]


def _prefilled(jw, jcfg, prompt, S: int):
    """A JAX cache prefilled with `prompt` (1, P), and the port's copy of it."""
    _, jcache = jforward(jw, JKVCache.create(jcfg, 1, S), jnp.asarray(prompt, jnp.int32),
                         jnp.zeros(1, jnp.int32), jcfg, jnp.float32)
    return jcache, KVCache.from_numpy(np.asarray(jcache.k), np.asarray(jcache.v))


@pytest.mark.parametrize("model,seed", [("tiny", 8), ("qwen2", 25)])
def test_speculative_loop_matches_jax(files, w4a8_backend, model, seed):
    """Three prompt-lookup rounds from the same prefilled cache (8 random
    tokens of `seed` and the 24-token greedy run that follows them): the
    port's outs and counts are the JAX speculative_loop's, float32 on both
    sides, and so are the next token and position. The seeds are ones whose
    rounds accept a draft (tiny-qwen2's greedy runs seldom repeat a 2-gram),
    so that a partial accept is compared too."""
    jw, jcfg, pw, cfg = _models(files[model])
    S = 128
    prompt, token = _greedy_history(pw, cfg, seed)
    P = prompt.shape[1]
    jcache, cache = _prefilled(jw, jcfg, prompt, S)
    hist = np.zeros(S, np.int64)
    hist[:P] = prompt[0]
    want = jspec.speculative_loop(jw, jcache, jnp.asarray(hist, jnp.int32), jnp.int32(token),
                                  jnp.int32(P), 3, K, jcfg, jnp.float32)
    outs, counts, _, tok, pos = speculative.speculative_loop(
        pw, cache, torch.from_numpy(hist)[None], torch.tensor([token]),
        torch.tensor([P], dtype=torch.int32), 3, K, cfg, torch.float32)
    np.testing.assert_array_equal(outs[:, 0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(counts[:, 0].numpy(), np.asarray(want[1]))
    assert int(tok[0]) == int(want[4]) and int(pos[0]) == int(want[5])
    assert int(counts.sum()) > 3  # some draft was accepted


def test_draft_model_loop_matches_jax(files, w4a8_backend):
    """Three two-model rounds (the draft model a `tiny` file of another
    seed) from the same prefilled caches: the port's outs and counts are
    the JAX draft_model_loop's."""
    jw, jcfg, pw, cfg = _models(files["tiny"])
    jdw, jdcfg, pdw, dcfg = _models(files["draft"])
    S = 128
    prompt = np.random.default_rng(9).integers(3, cfg.vocab_size, (1, 20))
    jcache, cache = _prefilled(jw, jcfg, prompt, S)
    jdcache, dcache = _prefilled(jdw, jdcfg, prompt, S)
    token, P = int(prompt[0, -1]), prompt.shape[1]
    want = jspec.draft_model_loop(jw, jcache, jdw, jdcache, jnp.int32(token), jnp.int32(P), 3,
                                  K, jcfg, jdcfg, jnp.float32)
    outs, counts, tok, pos = speculative.draft_model_loop(
        pw, cache, pdw, dcache, torch.tensor([token]), torch.tensor([P], dtype=torch.int32), 3,
        K, cfg, dcfg, torch.float32)
    np.testing.assert_array_equal(outs[:, 0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(counts[:, 0].numpy(), np.asarray(want[1]))
    assert int(tok[0]) == int(want[4]) and int(pos[0]) == int(want[5])


def test_draft_model_loop_with_its_own_weights_accepts_everything(files):
    """The target as its own draft: every draft is the target's greedy
    token, so each round emits K + 1 (the chain's K + 1 steps leave no hole
    in the draft cache at a full accept)."""
    _, _, pw, cfg = _models(files["tiny"])
    caches = [KVCache.create(cfg, 1, 128) for _ in range(2)]
    prompt = torch.from_numpy(np.random.default_rng(10).integers(3, cfg.vocab_size, (1, 9)))
    from crabml_tpu_torch.models.forward import forward
    for c in caches:
        forward(pw, c, prompt, torch.tensor([0]), cfg)
    _, counts, _, pos = speculative.draft_model_loop(
        pw, caches[0], pw, caches[1], prompt[:, -1], torch.tensor([9], dtype=torch.int32), 4,
        K, cfg, cfg, torch.float32)
    assert counts[:, 0].tolist() == [K + 1] * 4 and int(pos[0]) == 9 + 4 * (K + 1)


# -- the Runner -------------------------------------------------------------------

def _port(path, steps=40, seq_len=256, **kw):
    r = Runner(path, compute_dtype=torch.float32, device="cpu", seq_len=seq_len, **kw)
    pos0, _, tok = r.prefill(PROMPT)
    text = "".join(r.generate(tok, steps=steps))
    return r, pos0, text


@pytest.mark.parametrize("model", ["tiny", "qwen2"])
def test_runner_speculative_tokens_are_greedy_and_jax(files, w4a8_backend, model):
    """Runner(speculative=4), Runner(draft_model=<tiny, seed 6>) and the
    target as its own draft emit the plain greedy Runner's tokens and text,
    end at its position, and the JAX Runner(speculative=4)'s text; each ran
    speculative rounds, and the target as its own draft has every draft
    accepted (K + 1 tokens a round until the steps cap)."""
    path = files[model]
    plain, _, want = _port(path)
    runs = {"lookup": _port(path, speculative=K), "oracle": _port(path, draft_model=path)}
    if model == "tiny":
        runs["draft"] = _port(path, draft_model=files["draft"])
    for name, (r, _, text) in runs.items():
        assert text == want and r.generated == plain.generated and r.pos == plain.pos, name
        assert r.metrics.counts["spec_rounds"] > 0 and r.speculative == K, name
    oracle = runs["oracle"][0].metrics.counts
    assert oracle["spec_tokens"] == oracle["spec_rounds"] * (K + 1)
    jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32, seq_len=256, speculative=K)
    _, _, tok = jr.prefill(PROMPT)
    assert "".join(jr.generate(tok, steps=40)) == want
    assert int(jr.pos[0]) == plain.pos


def test_runner_draft_model_matches_jax_runner(files, w4a8_backend):
    """The two-model Runner against the JAX Runner(draft_model=...): the
    same text and position (both the plain greedy run's)."""
    r, _, text = _port(files["tiny"], steps=24, draft_model=files["draft"])
    jr = JRunner(files["tiny"], backend="w4a8", compute_dtype=jnp.float32, seq_len=256,
                 draft_model=files["draft"])
    _, _, tok = jr.prefill(PROMPT)
    assert "".join(jr.generate(tok, steps=24)) == text
    assert int(jr.pos[0]) == r.pos


def _consistent(r: Runner, prompt_len: int):
    """The Runner's token history is the tokens its cache holds: the prompt,
    then the generated tokens, one a position."""
    assert len(r._consumed) == r.pos
    assert r._consumed[prompt_len:] == r.generated[: r.pos - prompt_len]


def test_runner_speculative_stops_at_eos_and_at_the_cap(files):
    """EOS patched to a token the greedy run emits in the middle of a round:
    the speculative Runner stops there with the plain run's position
    (pos0 + j + 1) and text; at the steps cap the position stops after the
    last token consumed. In both cases the history holds exactly the cached
    tokens, and a second generate() continues as plain decode does."""
    plain, pos0, _ = _port(files["tiny"])
    decoded = plain.generated[1:]
    j = next(i for i in range(3, len(decoded)) if decoded[i] not in decoded[:i]
             and decoded[i] != plain.generated[0])
    runs = []
    for kw in ({}, dict(speculative=K)):
        r = Runner(files["tiny"], compute_dtype=torch.float32, device="cpu", seq_len=256, **kw)
        r.tokenizer.eos_token = decoded[j]
        _, _, tok = r.prefill(PROMPT)
        runs.append(("".join(r.generate(tok, steps=40)), r.pos, list(r.generated)))
        if kw:
            _consistent(r, pos0)
    assert runs[0] == runs[1] and runs[1][1] == pos0 + j + 1
    caps = []
    for kw in ({}, dict(speculative=K)):
        r = Runner(files["tiny"], compute_dtype=torch.float32, device="cpu", seq_len=256, **kw)
        _, _, tok = r.prefill(PROMPT)
        first = "".join(r.generate(tok, steps=7))  # 6 decoded: inside the second round
        pos_cap = r.pos
        if kw:
            _consistent(r, pos0)
        more = "".join(r.generate(r.generated[-1], steps=15))
        caps.append((first, pos_cap, more, r.pos))
        assert len(r._consumed) == r.pos
    assert caps[0] == caps[1] and caps[1][1] == pos0 + 6


def test_runner_falls_back_near_the_cache_end(files):
    """A cache 40 positions longer than the prompt: speculation runs while a
    dispatch of 4 rounds of K + 1 fits (S - 1 - pos >= 20) and ticks take
    the rest, to the last position; the tokens are plain greedy decode's."""
    S = len(Runner(files["tiny"], device="cpu", seq_len=64).tokenizer.encode(PROMPT)) + 40
    plain, _, want = _port(files["tiny"], steps=100, seq_len=S)
    r, _, text = _port(files["tiny"], steps=100, seq_len=S, speculative=K)
    assert text == want and r.pos == plain.pos == S - 1
    assert r.metrics.counts["spec_rounds"] > 0
    assert r.metrics.counts["spec_tokens"] < r.metrics.counts["tokens"]  # ticks ended it


def test_runner_refuses_a_draft_of_another_vocabulary(files):
    with pytest.raises(UnsupportedError, match="vocab"):
        Runner(files["tiny"], device="cpu", draft_model=files["other_vocab"])


def test_sampled_runs_and_reset_decode_plainly(files):
    """A sampled Runner with speculative=4 takes the plain sampled path (its
    tokens those of the same seed without speculation); reset() clears the
    history and the draft model's cache position."""
    from crabml_tpu_torch.runtime.sampler import Sampler

    texts = []
    for kw in ({}, dict(speculative=K)):
        r, _, text = _port(files["tiny"], steps=12, sampler=Sampler(temperature=0.9), seed=3,
                           **kw)
        texts.append(text)
        assert "spec_rounds" not in r.metrics.counts
    assert texts[0] == texts[1]
    r, _, _ = _port(files["tiny"], steps=12, draft_model=files["draft"])
    r.reset()
    assert r._consumed == [] and r.pos == 0 and r._draft.pos == 0


# -- the CLI ----------------------------------------------------------------------

def test_cli_speculative_and_draft(files, capsys):
    """--speculative 4 and --draft GGUF print the plain run's text on the
    CPU, and the metrics table (-v) counts the rounds."""
    base = [files["tiny"], "-p", PROMPT, "-n", "24", "--device", "cpu", "--seq-len", "256"]
    outs = []
    for extra in ([], ["--speculative", "4"], ["--draft", files["draft"], "-v"]):
        assert cli.main(base + extra) == 0
        got = capsys.readouterr()
        outs.append(got.out)
        if "-v" in extra:
            assert "spec_rounds" in got.err
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) > len(PROMPT)


# -- nothing read on the host ------------------------------------------------------

@pytest.mark.parametrize("kind", ["lookup", "draft"])
def test_rounds_read_nothing_on_the_host(files, kind):
    """Three rounds of either loop under the guard of
    tests/test_torch_decode_loop.py (no value handed to the host, no
    data-dependent shape): the drafts, the verify (models.forward.
    verify_step at T = K + 1, B = 2 at unequal positions), the accept rule
    and the history stay on the device, so a CUDA graph can capture a
    round."""
    from test_torch_decode_loop import _no_host_read

    _, _, pw, cfg = _models(files["tiny"])
    cache, dcache = KVCache.create(cfg, 2, 128), KVCache.create(cfg, 2, 128)
    hist = torch.randint(3, 20, (2, 128), generator=torch.Generator().manual_seed(11))
    token, pos = torch.tensor([5, 9]), torch.tensor([30, 61], dtype=torch.int32)
    with _no_host_read():
        if kind == "lookup":
            outs, counts, _, _, end = speculative.speculative_loop(pw, cache, hist, token, pos,
                                                                   3, K, cfg)
        else:
            outs, counts, _, end = speculative.draft_model_loop(pw, cache, pw, dcache, token,
                                                                pos, 3, K, cfg, cfg)
    assert outs.shape == (3, 2, K + 1) and torch.equal(end, pos + counts.sum(0))
