"""Port parity for the whole slice: the JAX forward under backend `w4a8`
(Pallas kernels in interpret mode) against the port's forward (plain
versions on the CPU), and greedy Runner tokens from one synthetic GGUF."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import make_weights, tiny_config, write_synthetic_gguf
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.models.config import ModelConfig
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import from_jax_weights
from crabml_tpu_torch.runtime.runner import Runner

# head dim 128 and a 128-aligned cache, so the JAX fused decode path is taken
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PREFILL = 32


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})


def test_forward_matches_jax_w4a8(w4a8_backend):
    """Tolerance 2e-4 (tests/test_model.py:41): float32 on both sides, the
    same Q4_K bytes and int8 activations, sums taken in another order.
    32 prefill rows take qmm_q4k and flash_attention; the decode step takes
    qmm_w4a8 and decode_attention."""
    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType.Q4_K, seed=5)
    jk = repack_weights(fuse_weights(jw, jcfg), jcfg)
    cfg = _port_cfg(jcfg)
    pw = from_jax_weights(jw, cfg)
    assert "wqkv" in pw["layers"][0] and "wgu" in pw["layers"][0]

    tokens = np.random.default_rng(0).integers(3, jcfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, jcfg.seq_len)
    cache = KVCache.create(cfg, 1, jcfg.seq_len)
    steps = [(tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)]
    for toks, p in steps:
        want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg,
                      torch.float32)
        assert got.shape == (1, toks.shape[1], jcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_runner_greedy_tokens_match_jax(tmp_path, w4a8_backend):
    """Greedy decoding of one synthetic GGUF: the same 16 tokens from both
    packages (float32 compute, backend w4a8 on the JAX side)."""
    jcfg = tiny_config(**CFG)
    path = str(tmp_path / "tiny_q4k.gguf")
    write_synthetic_gguf(path, jcfg, JGGMLType.Q4_K, seed=3)
    prompt = "tok7 tok99 tok3 tok250 tok17"

    jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
    want = "".join(jr.prefill_and_generate(prompt, 16))
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    got = "".join(r.prefill_and_generate(prompt, 16))
    assert r.metrics.counts["tokens"] == 15  # prefill samples the first
    assert got == want
    # a reset replays the same tokens
    r.reset()
    assert "".join(r.prefill_and_generate(prompt, 16)) == got
