"""The llama.cpp k-quant lm_head end to end: 16 greedy Runner tokens of a
Q4_K file whose output matrix is Q6_K, from the port and from the JAX
package (its own file: the JAX side runs op by op, ~200 s on one core)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.tools.synth_gguf import q6k_blocks

# tests/test_torch_model.py's widths
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PROMPT = "tok7 tok99 tok3 tok250 tok17"


def _with_q6k_output(src: str, dst: str):
    """Copy a GGUF with random Q6_K blocks in place of its output matrix."""
    gf = GGUFFile(src)
    w = GGUFWriter()
    for k, v in gf.metadata.as_dict().items():
        w.add_metadata(k, v, gf.metadata.value_type(k))
    for ti in gf.tensor_infos:
        if ti.name == "output.weight":
            blocks = q6k_blocks(np.random.default_rng(8), int(np.prod(ti.shape)), 0.05)
            w.add_tensor(ti.name, GGMLType.Q6_K, ti.shape, blocks.tobytes())
        else:
            w.add_tensor(ti.name, ti.typ, ti.shape, ti.to_numpy())
    w.write(dst)


def test_runner_q4k_with_q6k_lm_head_matches_jax(tmp_path):
    """Q4_K layers and a Q6_K output matrix, loaded by both packages from
    one file: the same 16 greedy tokens (float32, backend w4a8 on the JAX
    side). The JAX Runner runs op by op (disable_jit): jitted, its 12th
    token differs from its own op-by-op run's on this file (as in
    tests/test_torch_schemes.py::test_forward_matches_jax_w4a8); the port
    gives the op-by-op tokens."""
    q4k = str(tmp_path / "tiny_q4k.gguf")
    write_synthetic_gguf(q4k, tiny_config(**CFG), JGGMLType.Q4_K, seed=4)
    path = str(tmp_path / "tiny_q4k_q6k_output.gguf")
    _with_q6k_output(q4k, path)
    jmm.set_backend("w4a8")
    try:
        jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
        with jax.disable_jit():
            want = "".join(jr.prefill_and_generate(PROMPT, 16))
    finally:
        jmm.set_backend("xla")
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    got = "".join(r.prefill_and_generate(PROMPT, 16))
    assert r.metrics.counts["tokens"] == 15  # prefill samples the first
    assert got == want
    assert r.weights["layers"][0]["wqkv"].kind == GGMLType.Q4_K
    assert r.weights["output"].kind == GGMLType.Q6_K and r.weights["output"].kernel_layout
