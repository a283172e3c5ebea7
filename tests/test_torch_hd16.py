"""Head dim 16 (the four committed HF fixtures: 4 q heads over 2 kv heads of
a 64-wide embedding) against the JAX package on the CPU.

- The plain flash at hd 16 against the JAX flash kernel in interpret mode.
- The decode kernels do not take hd 16: the decode step and the paged tick
  attend through flash (the paged tick over the slot's pages, gathered
  through the block table, as the JAX paged engine's non-fused route does),
  and read nothing on the host.
- Each fixture through the Runner (the golden's prompt at once, and 15
  tokens then the last through the decode step) against transformers'
  logits at the JAX test's 5e-4, and the Runner's greedy tokens equal both
  engines'; qwen3's paged engine also equals the JAX paged engine.
On the card: `-k hd16` of tests/test_torch_kernels_gpu.py and chip_smoke.py's
`hf_goldens` phase."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu.serving.engine import Request as JRequest
from crabml_tpu.serving.paged import PagedServingEngine as JPagedServingEngine
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, decode_step
from crabml_tpu_torch.ops.cuda import flash_attention as fa
from crabml_tpu_torch.ops.cuda.decode_attention import decode_eligible
from crabml_tpu_torch.ops.cuda.paged_decode_attention import PAGE
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
from crabml_tpu_torch.serving.paged import PagedKVCache, paged_decode_step
from test_torch_decode_loop import _no_host_read

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
FAMILIES = ["gemma2", "qwen3", "phi3", "mixtral"]
PROMPTS = ["hello world", "a b c d e f g h i j k l m n o p q r s t", "x"]


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


def _fixture(family):
    return os.path.join(FIXDIR, f"{family}-tiny-f32.gguf")


@pytest.mark.parametrize("G,pos0,softcap,window", [(2, 0, 0.0, 0), (2, 15, 50.0, 8),
                                                   (1, 96, 0.0, 100), (4, 37, 30.0, 0)])
def test_flash_plain_matches_pallas_at_hd16(G, pos0, softcap, window):
    """Tolerance 2e-5 (float32 throughout): the fixtures' 2 q heads a kv
    head with gemma2's softcap 50 and window 8, ragged offsets, windows that
    drop whole key blocks. T is 128: the JAX kernel tiles T by 128 or 256."""
    B, T, S, KV, hd = 2, 128, 512, 2, 16
    rng = np.random.default_rng(16 + G + pos0)
    q = (rng.standard_normal((B, T, KV * G, hd)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    pos = np.asarray([pos0, pos0 // 2], np.int32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), 0.25,
                   force=True, softcap=softcap, local_window=jnp.int32(window) if window else None)
    assert want is not None  # the JAX kernel takes head dim 16
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos), 0.25, softcap, window)
    assert got.shape == (B, T, KV * G * hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_head_dim_16_takes_flash_for_every_attention():
    """The decode kernels take head dims 80 to 256 only, so at hd 16 every
    step, the decode step and the paged tick included, goes to flash, which
    takes 16 on the card in both dtypes."""
    assert not any(decode_eligible(T, 4, 2, 16) for T in range(1, 9))
    assert 16 in fa.HEAD_DIMS
    cfg = config_from_gguf(GGUFFile(_fixture("qwen3")).metadata)
    for dtype in (torch.bfloat16, torch.float32):
        fa.check_card_attention(cfg, "cuda", dtype)


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_paged_tick_flash_route_reads_nothing_on_the_host(kv):
    """The paged tick's flash route (the new k/v written, the table's pages
    gathered, flash masked by pos), the function the engine's CUDA graph
    captures, reads no value back to the host, and gives the dense decode
    step's logits on the same keys."""
    from crabml_tpu_torch.models.weights import load_weights

    gf = GGUFFile(_fixture("qwen3"))
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    cache = PagedKVCache.create(cfg, 6, 2, 2, kv)
    cache.table.copy_(torch.tensor([[3, 5], [1, 0]], dtype=torch.int32))
    g = torch.Generator().manual_seed(0)
    for l in range(cfg.n_layers):  # random keys in the pages the table names
        for pool in (cache.k, cache.v):
            pool[l].copy_(torch.randn(pool[l].shape, generator=g).to(kv) if kv != torch.int8
                          else torch.randint(-127, 128, pool[l].shape, generator=g,
                                             dtype=torch.int8))
    if kv == torch.int8:
        cache.k_scale.fill_(0.01)
        cache.v_scale.fill_(0.02)
    tokens, pos = torch.tensor([5, 9]), torch.tensor([PAGE + 4, 17], dtype=torch.int32)
    dense = KVCache.create(cfg, 2, 2 * PAGE, kv)
    for b in range(2):  # the same keys in a dense cache
        for name in ("k", "v", "k_scale", "v_scale"):
            pool = getattr(cache, name)
            if pool is None:
                continue
            pages = [int(p) for p in cache.table[b]]
            getattr(dense, name)[:, b] = torch.cat([pool[:, p] for p in pages], dim=2)
    with _no_host_read():
        out = paged_decode_step(w, cache, tokens, pos, cfg, torch.float32)
    want = decode_step(w, dense, tokens[:, None], pos, cfg, torch.float32)
    assert out.shape == (2, cfg.vocab_size) and torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_runner_matches_the_hf_golden_and_the_engines(family):
    """The Runner in float32 on the CPU: the golden's 16-token prompt at
    once, and its 15 tokens then the last through the decode step (flash
    over the cache at hd 16), against transformers' logits at the JAX
    test's 5e-4 (tests/test_family_goldens.py); then its greedy tokens on
    three prompts equal the dense and the paged engine's (two slots; the
    paged tick through flash over gathered pages), pages returned."""
    gold = np.load(os.path.join(FIXDIR, f"{family}-tiny-golden.npz"))
    tokens = gold["tokens"].tolist()
    r = Runner(_fixture(family), compute_dtype=torch.float32, device="cpu")
    assert r.cfg.head_dim == 16
    got = r._forward_tokens(tokens)[0]
    np.testing.assert_allclose(got.numpy(), gold["logits"][-1], rtol=5e-4, atol=5e-4)
    r.reset()
    r._forward_tokens(tokens[:-1])
    last = decode_step(r.weights, r.cache, torch.tensor([[tokens[-1]]]),
                       torch.tensor([len(tokens) - 1], dtype=torch.int32), r.cfg, torch.float32)
    np.testing.assert_allclose(last[0].numpy(), gold["logits"][-1], rtol=5e-4, atol=5e-4)
    want = []
    for p in PROMPTS:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, 8)))
    assert ServingEngine(r, n_slots=2, seq_len=128).generate(PROMPTS, max_tokens=8) == want
    paged = PagedServingEngine(r, n_slots=2, n_pages=8, seq_len=128)
    free = paged.pages_free()
    assert paged.generate(PROMPTS, max_tokens=8) == want
    assert paged.pages_free() == free


def test_paged_tick_at_hd16_matches_the_runner_and_the_jax_paged_engine():
    """qwen3's fixture in float32: the port's paged engine (its tick through
    flash over gathered pages), the Runner and the JAX paged engine (whose
    hd-16 pool takes its non-fused route, crabml_tpu/serving/paged.py:130)
    give the same greedy tokens for three prompts through two slots."""
    path = _fixture("qwen3")
    n = 8
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
