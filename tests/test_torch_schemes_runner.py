"""Greedy Runner tokens of the Q8_0, Q6_K, Q5_K, Q4_0, Q3_K and Q2_K
weights: 16 tokens of one GGUF written by the JAX package, from both
packages (the rest of the schemes' parity is tests/test_torch_schemes.py;
this test alone takes most of that file's time, so it runs in a file of its
own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.runtime.runner import Runner

KINDS = (GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q3_K,
         GGMLType.Q2_K)
SCHEMES = pytest.mark.parametrize("kind", KINDS,
                                  ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k"])
# tests/test_torch_model.py's widths: head dim 128 and a 128-aligned cache
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PROMPT = "tok7 tok99 tok3 tok250 tok17"


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


@pytest.fixture
def fast_q6k(monkeypatch):
    """The JAX package's random models quantize each matrix with the
    codec, whose Q6_K, Q3_K and Q2_K encoders loop over blocks in Python
    (minutes for a tiny model) and whose Q5_K encoder takes seconds a matrix.
    Here their matrices in those kinds are random blocks instead (the port's
    synthetic writer, seeded from the values): valid bytes that both
    packages read alike."""
    import crabml_tpu.models.synthetic as jsynth

    from crabml_tpu_torch.tools.synth_gguf import q2k_blocks, q3k_blocks, q5k_blocks, q6k_blocks

    encode = jsynth.quantize
    fast = {JGGMLType.Q6_K: q6k_blocks, JGGMLType.Q5_K: q5k_blocks,
            JGGMLType.Q3_K: q3k_blocks, JGGMLType.Q2_K: q2k_blocks}

    def quantize(typ, x):
        if typ not in fast:
            return encode(typ, x)
        rng = np.random.default_rng(np.frombuffer(x.tobytes()[:32], np.uint32))
        return fast[typ](rng, x.size, float(x.std())).tobytes()

    monkeypatch.setattr(jsynth, "quantize", quantize)


def _tokens_match(path):
    jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
    want = "".join(jr.prefill_and_generate(PROMPT, 16))
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    got = "".join(r.prefill_and_generate(PROMPT, 16))
    assert r.metrics.counts["tokens"] == 15  # prefill samples the first
    assert got == want
    return r


@SCHEMES
def test_runner_greedy_tokens_match_jax(tmp_path, kind, w4a8_backend, fast_q6k):
    """16 greedy tokens of one GGUF written by the JAX package, identical
    from both packages (float32 compute, backend w4a8 on the JAX side)."""
    path = str(tmp_path / f"tiny_{kind.name}.gguf")
    write_synthetic_gguf(path, tiny_config(**CFG), JGGMLType(int(kind)), seed=3)
    r = _tokens_match(path)
    lw = r.weights["layers"][0]
    assert all(lw[n].kind == kind and lw[n].kernel_layout for n in ("wqkv", "wo", "wgu"))
