"""Float32 compute and a KV cache of any dtype, end to end, against the JAX
package on the CPU:

- A gemma2 model at head dim 256 (float32 weights, so every matmul is the
  plain product on both sides and only attention differs) through the JAX
  decode kernel and the port's with a float32, bfloat16 or int8 cache.
- The Runner at every (compute dtype, KV dtype) against the JAX Runner.
- Sessions saved by one package and loaded by the other.
- The CLI's float32 and KV flags.
- What the card refuses in float32, before any weight is read.
The kernels' float32 plain forms: tests/test_torch_float32.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch import cli
from crabml_tpu_torch.errors import CacheError, UnsupportedError
from crabml_tpu_torch.runtime.runner import Runner

# tests/test_torch_model.py's widths: head dim 128 and a 128-aligned cache
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PROMPT = "tok7 tok99 tok3 tok250 tok17"
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


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


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# gemma2 at head dim 256 through the decode kernels, every KV dtype
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma2_hd256(tmp_path_factory):
    """A 2-layer gemma2 at head dim 256 in float32 weights (the softcap, a
    window of 8 keys on layer 0, 2 q heads over 1 kv head): every matmul is
    the plain float32 product on both sides, so only attention can differ."""
    from crabml_tpu.models.config import ARCH_FEATURES, ModelConfig

    cfg = ModelConfig(architecture="gemma2", model_name="syn-g2-hd256", embedding_dim=256,
                      hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=512,
                      seq_len=256, rms_norm_eps=1e-5, head_dim_override=256,
                      **{**ARCH_FEATURES["gemma2"], "attn_logit_softcap": 5.0,
                         "sliding_window": 8})
    path = str(tmp_path_factory.mktemp("gguf") / "g2-hd256.gguf")
    write_synthetic_gguf(path, cfg, JGGMLType.F32, seed=33)
    return path


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_gemma2_hd256_decode_matches_jax_kernel(gemma2_hd256, kv):
    """The JAX forward on its Pallas decode kernel (backend pallas,
    interpret mode) against the port's forward, float32 compute over a
    float32, bfloat16 or int8 cache: an 8-token prompt, then 12 decode
    steps past layer 0's window, each step's logits. Tolerance 2e-4 of
    max|logit| (float32 on both sides, sums in another order; the cache
    rounds to bfloat16 or quantizes to int8 by the same operations)."""
    from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
    from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
    from crabml_tpu.models.forward import KVCache as JKVCache
    from crabml_tpu.models.forward import forward as jforward
    from crabml_tpu.models.weights import load_weights as jload_weights
    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.forward import KVCache, forward
    from crabml_tpu_torch.models.weights import load_weights

    tdt, jdt = DTYPES[kv]
    jcfg = jconfig_from_gguf(JGGUFFile(gemma2_hd256).metadata)
    cfg = config_from_gguf(GGUFFile(gemma2_hd256).metadata)
    assert cfg.head_dim == 256
    prompt = [[1, 7, 42, 99, 5, 3, 8, 2]]
    steps = [(7 * i) % 512 for i in range(12)]
    jmm.set_backend("pallas")
    try:
        jw = jload_weights(JGGUFFile(gemma2_hd256), jcfg)
        jcache = JKVCache.create(jcfg, 1, 128, dtype=jdt)
        _, jcache = jforward(jw, jcache, jnp.asarray(prompt, jnp.int32), jnp.zeros(1, jnp.int32),
                             jcfg)
        want = []
        for i, t in enumerate(steps):
            logits, jcache = jforward(jw, jcache, jnp.asarray([[t]], jnp.int32),
                                      jnp.asarray([8 + i], jnp.int32), jcfg)
            want.append(np.asarray(logits[0, -1]))
    finally:
        jmm.set_backend("xla")
    w = load_weights(GGUFFile(gemma2_hd256), cfg, "cpu", torch.float32)
    cache = KVCache.create(cfg, 1, 128, tdt)
    forward(w, cache, torch.tensor(prompt), torch.tensor([0]), cfg, torch.float32)
    got = [forward(w, cache, torch.tensor([[t]]), torch.tensor([8 + i]), cfg,
                   torch.float32)[0, -1].numpy() for i, t in enumerate(steps)]
    assert cache.k.dtype == tdt
    assert _rel(np.stack(got), np.stack(want)) <= 2e-4


# ---------------------------------------------------------------------------
# the Runner at every (compute dtype, KV dtype), against the JAX Runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_q4k(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "tiny_q4k.gguf")
    write_synthetic_gguf(path, tiny_config(**CFG), JGGMLType.Q4_K, seed=3)
    return path



def _runner_tol(compute: str, kv: str) -> float:
    """The logits' tolerance of a (compute, KV) pair, of max|logit|. Float32
    compute over a float32 or int8 cache: 2e-4 (float32 on both sides, the
    same int8 activations and cache codes, sums in another order). A
    bfloat16 cache: 4e-2, since each package computes k and v in float32
    with sums in its own order and rounds them to bfloat16, so one key in
    some hundreds lands one bfloat16 unit (2^-8 of its value) away from the
    other package's; the two packages' logits then differ by 5e-3 to 7e-3
    after one such step on this model. Bfloat16 compute: 4e-2 as well (the
    activations round at other points in torch's and XLA's elementwise ops,
    each ~2^-9, through two layers and the lm_head)."""
    return 2e-4 if compute == "f32" and kv != "bf16" else 4e-2


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_runner_matches_jax_runner(tiny_q4k, w4a8_backend, compute, kv):
    """Runner(compute_dtype, kv_dtype) on the port and on the JAX package
    (backend w4a8) from one Q4_K GGUF: the prompt's logits, one decode step's
    (the fused decode form over the cache in `kv`), and 12 greedy tokens
    after it, equal. Logits within _runner_tol of max|logit|."""
    tdt, jdt = DTYPES[compute]
    kdt, jkdt = DTYPES[kv]
    jr = JRunner(tiny_q4k, backend="w4a8", compute_dtype=jdt, kv_dtype=jkdt)
    r = Runner(tiny_q4k, compute_dtype=tdt, kv_dtype=kdt, device="cpu")
    assert r.cache.k.dtype == kdt and r.kv_dtype == kdt
    ids = r.tokenizer.encode(PROMPT, bos=True)
    want = np.asarray(jr._forward_tokens(ids), np.float32).reshape(-1)
    got = r._forward_tokens(ids).reshape(-1).numpy()
    assert _rel(got, want) <= _runner_tol(compute, kv)
    first = int(np.argmax(want))
    assert int(np.argmax(got)) == first
    want2 = np.asarray(jr._forward_tokens([first]), np.float32).reshape(-1)
    got2 = r._forward_tokens([first]).reshape(-1).numpy()
    assert _rel(got2, want2) <= _runner_tol(compute, kv)
    assert r.kv_cache_len() == jr.kv_cache_len() == len(ids) + 1
    second = int(np.argmax(want2))
    want_text = "".join(jr.generate(second, 12))
    got_text = "".join(r.generate(second, 12))
    assert got_text == want_text


# ---------------------------------------------------------------------------
# sessions across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["f32", "int8", "bf16"])
def test_sessions_load_in_either_package(tiny_q4k, w4a8_backend, tmp_path, kv):
    """A session saved by the port (prompt prefilled) and loaded by the JAX
    Runner, and one saved by the JAX Runner and loaded by the port, go on
    to the greedy tokens of a Runner that never stopped; both files hold the
    same keys (k, v, pos, model_name, and an int8 cache's k_scale,
    v_scale). float32 compute. (A bfloat16 cache: the port writes it
    widened to float32, which both load; the JAX package's own bfloat16
    file holds raw 2-byte values, which the port reads as bfloat16.)"""
    kdt, jkdt = DTYPES[kv]
    r = Runner(tiny_q4k, compute_dtype=torch.float32, kv_dtype=kdt, device="cpu")
    jr = JRunner(tiny_q4k, backend="w4a8", compute_dtype=jnp.float32, kv_dtype=jkdt)
    _, _, first = r.prefill(PROMPT)
    want = "".join(r.generate(first, 10))
    r.reset()
    _, _, first2 = r.prefill(PROMPT)
    assert first2 == first
    port_file = str(tmp_path / "port.npz")
    r.save_session(port_file)
    jr.load_session(port_file)
    assert jr.kv_cache_len() == r.kv_cache_len()
    assert "".join(jr.generate(first, 10)) == want

    jr.reset()
    jr.prefill(PROMPT)
    jax_file = str(tmp_path / "jax.npz")
    jr.save_session(jax_file)
    r2 = Runner(tiny_q4k, compute_dtype=torch.float32, kv_dtype=kdt, device="cpu")
    r2.load_session(jax_file)
    assert r2.kv_cache_len() == jr.kv_cache_len()
    assert "".join(r2.generate(first, 10)) == want
    a, b = np.load(port_file), np.load(jax_file)
    assert set(a.files) == set(b.files)
    assert set(a.files) == {"k", "v", "pos", "model_name"} | (
        {"k_scale", "v_scale"} if kv == "int8" else set())


def test_session_refuses_another_cache(tiny_q4k, tmp_path):
    """An int8 session into a float cache, and a session of another cache
    length, are refused with the reason; nothing is loaded."""
    r = Runner(tiny_q4k, compute_dtype=torch.float32, kv_dtype=torch.int8, device="cpu")
    r.prefill(PROMPT)
    path = str(tmp_path / "s.npz")
    r.save_session(path)
    other = Runner(tiny_q4k, compute_dtype=torch.float32, device="cpu")
    with pytest.raises(CacheError, match="int8"):
        other.load_session(path)
    short = Runner(tiny_q4k, seq_len=128, compute_dtype=torch.float32, kv_dtype=torch.int8,
                   device="cpu")
    with pytest.raises(CacheError, match="shape"):
        short.load_session(path)
    assert other.kv_cache_len() == short.kv_cache_len() == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_takes_the_jax_cli_flags():
    """--dtype, --kv-dtype, --probability, -v, --seq-len, --seed and --mlock
    parse as crabml_tpu/cli.py's do, with its choices and defaults, but for
    --dtype's default: the card's bfloat16, decided at run time (None)."""
    from crabml_tpu.cli import build_parser as jax_parser

    argv = ["m.gguf", "--dtype", "f32", "--kv-dtype", "int8", "--probability", "0.5", "-v",
            "--seq-len", "64", "--seed", "3", "--mlock"]
    got, want = cli.build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for name in ("dtype", "kv_dtype", "probability", "verbose", "seq_len", "seed", "mlock"):
        assert getattr(got, name) == getattr(want, name), name
    defaults, jdefaults = cli.build_parser().parse_args(["m"]), jax_parser().parse_args(["m"])
    for name in ("kv_dtype", "probability", "verbose", "seq_len", "seed", "mlock"):
        assert getattr(defaults, name) == getattr(jdefaults, name), name
    assert defaults.dtype is None and jdefaults.dtype == "f32"
    for flag, bad in (("--dtype", "f16"), ("--kv-dtype", "f16")):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["m", flag, bad])


@pytest.mark.parametrize("dtype,kv", [("f32", "int8"), ("bf16", "f32"), ("f32", "bf16")])
def test_cli_runs_each_dtype_on_the_cpu(tiny_q4k, capsys, dtype, kv):
    """The CLI on the CPU with the dtype flags, -v (metadata before, the
    metrics table after), --seq-len, a seed and top-p sampling: the same
    seed gives the same text, and greedy output equals the Runner's."""
    argv = [tiny_q4k, "-p", PROMPT, "-n", "8", "--device", "cpu", "--dtype", dtype,
            "--kv-dtype", kv, "--seq-len", "64", "-v", "--mlock"]
    assert cli.main(argv + ["-t", "0.9", "--probability", "0.5", "--seed", "3"]) == 0
    out1, err = capsys.readouterr()
    assert "== metadata ==" in err and "general.architecture" in err
    assert "prefill_tokens" in err and "decode" in err and "7 tokens" in err
    assert cli.main(argv + ["-t", "0.9", "--probability", "0.5", "--seed", "3"]) == 0
    assert capsys.readouterr()[0] == out1
    assert cli.main(argv) == 0
    greedy = capsys.readouterr()[0]
    tdt, kdt = DTYPES[dtype][0], DTYPES[kv][0]
    r = Runner(tiny_q4k, seq_len=64, compute_dtype=tdt, kv_dtype=kdt, device="cpu")
    assert r.seq_len == 64 and r.cache.k.dtype == kdt
    assert greedy == PROMPT + "".join(r.prefill_and_generate(PROMPT, 8)) + "\n"


# ---------------------------------------------------------------------------
# what the card refuses in float32, before any weight is read
# ---------------------------------------------------------------------------

def _on_a_fake_card(monkeypatch):
    """The Runner and the engines resolve their device to cuda, and reading
    a weight or making a cache raises `Loaded`: an engine whose check
    passes reaches its cache."""
    from crabml_tpu_torch.runtime import runner as runner_mod
    from crabml_tpu_torch.serving import engine as engine_mod

    class Loaded(Exception):
        pass

    def loads(*a, **k):
        raise Loaded

    monkeypatch.setattr(runner_mod, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(runner_mod, "load_weights", loads)
    monkeypatch.setattr(engine_mod, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(engine_mod.ServingEngine, "_reset_device_state", loads)
    return runner_mod, engine_mod, Loaded


@pytest.mark.parametrize("model", ["tiny", "tiny-gemma2", "tiny-phi2", "tiny-moe"])
def test_card_takes_float32_dense_models(tmp_path, monkeypatch, model):
    """A model in float32 (head dim 128, 256 or 80; and since the grouped
    float32 forms, a mixture of experts: tiny-moe) passes the card's check,
    the one the Runner makes before anything else; both engines go on past
    it to make their caches. (The name is the test's from before the
    mixture of experts was taken.)"""
    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.ops.cuda.flash_attention import check_card_model
    from crabml_tpu_torch.serving.paged import PagedServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp_path / f"{model}.gguf"), model, seed=1)
    cfg = config_from_gguf(GGUFFile(path).metadata)
    check_card_model(cfg, "cuda", torch.float32)
    _, engine_mod, Loaded = _on_a_fake_card(monkeypatch)
    for cls in (engine_mod.ServingEngine, PagedServingEngine):
        with pytest.raises(Loaded):
            cls(weights={}, cfg=cfg, compute_dtype=torch.float32)


def test_card_refuses_a_float32_mixture_of_experts(tmp_path, monkeypatch):
    """A mixture of experts in float32 is taken on the card (its grouped
    matmuls have float32 forms since csrc/qmm_f32.cu's grouped entries): the
    Runner goes past the check to read its weights, and both engines to make
    their caches; bfloat16 and the CPU take it as before. (The name is the
    test's from when the card refused it.)"""
    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.ops.cuda.flash_attention import check_card_model
    from crabml_tpu_torch.serving.paged import PagedServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp_path / "moe.gguf"), "tiny-moe", seed=1)
    cfg = config_from_gguf(GGUFFile(path).metadata)
    assert cfg.n_experts == 4
    check_card_model(cfg, "cpu", torch.float32)
    check_card_model(cfg, "cuda", torch.bfloat16)
    check_card_model(cfg, "cuda", torch.float32)
    runner_mod, engine_mod, Loaded = _on_a_fake_card(monkeypatch)
    cpu_generator = torch.Generator  # the CPU build has no generator of a card
    monkeypatch.setattr(torch, "Generator", lambda device=None: cpu_generator())
    with pytest.raises(Loaded):
        runner_mod.Runner(path, compute_dtype=torch.float32)
    for cls in (engine_mod.ServingEngine, PagedServingEngine):
        with pytest.raises(Loaded):
            cls(weights={}, cfg=cfg, compute_dtype=torch.float32)
