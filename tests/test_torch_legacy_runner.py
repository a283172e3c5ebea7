"""Greedy Runner tokens of the Q5_0 weights (the one legacy kind with forms
of its own): 16 tokens of one GGUF written by the JAX package, from both
packages. The rest of the legacy kinds' parity is
tests/test_torch_legacy_schemes.py and tests/test_torch_legacy_moe.py; an
op-by-op JAX Runner takes most of a minute, so this test runs in a file of
its own."""

import jax.numpy as jnp
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.runtime.runner import Runner

# tests/test_torch_model.py's widths: head dim 128 and a 128-aligned cache
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PROMPT = "tok7 tok99 tok3 tok250 tok17"


def test_q5_0_runner_greedy_tokens_match_jax(tmp_path):
    """16 greedy tokens of one Q5_0 GGUF written by the JAX package (its
    codec's encoder), identical from both packages (float32 compute, backend
    w4a8 on the JAX side): the prompt through qmm_q5_0's plain version, each
    decode step through qmm_w4a8's Q5_0 form."""
    path = str(tmp_path / "tiny_q5_0.gguf")
    write_synthetic_gguf(path, tiny_config(**CFG), JGGMLType.Q5_0, seed=3)
    jmm.set_backend("w4a8")
    try:
        jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
        want = "".join(jr.prefill_and_generate(PROMPT, 16))
    finally:
        jmm.set_backend("xla")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = Runner(path, compute_dtype=torch.float32, device="cpu")
        got = "".join(r.prefill_and_generate(PROMPT, 16))
    finally:
        torch.set_num_threads(n)
    assert r.metrics.counts["tokens"] == 15  # prefill samples the first
    assert got == want
    lw = r.weights["layers"][0]
    assert all(lw[n].kind == GGMLType.Q5_0 and lw[n].kernel_layout for n in ("wqkv", "wo", "wgu"))
