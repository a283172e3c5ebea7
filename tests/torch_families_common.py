"""The tiny files of the family parity tests (tests/test_torch_families.py,
tests/test_torch_families_q8_0.py): each variant written once per pytest
process by the JAX writer (crabml_tpu/models/synthetic.py::
write_synthetic_gguf), F32 at the settings of tests/test_model.py's
architecture sweep and Q8_0 at widths that are multiples of 256 (so the JAX
package's int8-activation kernels take every matrix, as the port's do); the
JAX package's weights of a file; the fixtures both files use; and what
tests/test_torch_phi.py and tests/test_torch_lane_pad.py share with them:
the int8 codes of a step on both sides (`jax_codes`, `jax_scan_codes`,
`port_step`) and a file's float32 twin (`f32_twin`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import ARCH_FEATURES, ModelConfig as JModelConfig
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import write_synthetic_gguf
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.models.forward import forward
from crabml_tpu_torch.ops.cuda import gemm_quant as pgq
from crabml_tpu_torch.quant import codecs

TOL = 2e-4  # tests/test_model.py:41: float32 on both sides, sums in another order

# the F32 files: tests/test_model.py's sweep settings (:184-195 and :678-720)
SWEEP = dict(embedding_dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=512, seq_len=64, rms_norm_eps=1e-5)
# the Q8_0 files: every fused matrix a multiple of 256 rows and columns
WIDE = dict(embedding_dim=256, hidden_dim=512, n_layers=2, vocab_size=512, seq_len=256,
            rms_norm_eps=1e-5)
# variant -> (architecture, F32 settings, Q8_0 settings)
VARIANTS = {
    "llama31": ("llama", dict(rope_scaling_type="rope_freqs"),
                dict(n_heads=2, n_kv_heads=1, rope_scaling_type="rope_freqs")),
    "linear": ("llama", dict(rope_scaling_type="linear", rope_scaling_factor=4.0),
               dict(n_heads=2, n_kv_heads=1, rope_scaling_type="linear",
                    rope_scaling_factor=4.0)),
    "yarn": ("llama", dict(seq_len=128, rope_scaling_type="yarn", rope_scaling_factor=4.0,
                           rope_scaling_orig_ctx=32),
             dict(n_heads=2, n_kv_heads=1, rope_scaling_type="yarn", rope_scaling_factor=4.0,
                  rope_scaling_orig_ctx=32)),
    # Qwen2-7B's 7 q heads a kv head at head dim 128
    "qwen2": ("qwen2", dict(n_heads=7, n_kv_heads=1, head_dim_override=128),
              dict(n_heads=14, n_kv_heads=2, head_dim_override=128)),
    "qwen3": ("qwen3", dict(head_dim_override=24),
              dict(n_heads=4, n_kv_heads=1, head_dim_override=128)),
    "gemma": ("gemma", {}, dict(n_heads=2, n_kv_heads=2, head_dim_override=256)),
}
KINDS = {"f32": JGGMLType.F32, "q8_0": JGGMLType.Q8_0}
CHUNKS = ((0, 20), (20, 23), (23, 24))  # the prompt (flash), a 3-token chunk, a decode step


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread and IEEE float32 products for each test: the suite
    runs in several worker processes, whose thread pools otherwise slow the
    Runner tests many times over."""
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


def variant_config(variant: str, kind: str) -> JModelConfig:
    arch, f32, q8 = VARIANTS[variant]
    base = dict(SWEEP if kind == "f32" else WIDE)
    base.update(f32 if kind == "f32" else q8)
    return JModelConfig(architecture=arch, model_name=f"syn-{variant}",
                        **ARCH_FEATURES[arch], **base)


_FILES: dict = {}


def family_file(tmp_path_factory, variant: str, kind: str) -> str:
    """The variant's tiny GGUF, written once per pytest process."""
    if (variant, kind) not in _FILES:
        path = str(tmp_path_factory.mktemp("fam") / f"{variant}-{kind}.gguf")
        write_synthetic_gguf(path, variant_config(variant, kind), KINDS[kind], seed=17)
        _FILES[variant, kind] = path
    return _FILES[variant, kind]


def jax_weights(path: str, kind: str):
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg)
    if kind == "q8_0":
        jw = repack_weights(fuse_weights(jw, jcfg), jcfg)
        if jw["output"] is None:  # tied: the port multiplies by a kernel-layout copy
            jw = dict(jw, output=jgemm.repack(jw["token_embed"]))
    return jw, jcfg


def jax_codes(jw, jcache, toks, lo, jcfg):
    """The int8 activation codes of each int8-activation matmul of a JAX
    step, in call order, from an op-by-op run (the jitted step's values
    cannot be read inside it), and that run's logits."""
    codes, plain = [], jgemm.qmatmul_pallas

    def logged(x, qt, *a, **kw):
        if kw.get("act_quant"):
            x2 = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
            if x2.shape[0] <= 16:  # the w4a8 route (<= W4A8_MAX_ROWS rows)
                codes.append(np.asarray(jgemm.quantize_activation(
                    jnp.asarray(x2), 32, x2.shape[1])[0]))
        return plain(x, qt, *a, **kw)

    jgemm.qmatmul_pallas = logged
    try:
        with jax.disable_jit():
            logits, _ = jforward(jw, jcache, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray([lo], jnp.int32), jcfg, jnp.float32)
    finally:
        jgemm.qmatmul_pallas = plain
    return codes, np.asarray(logits)


def jax_scan_codes(jw, jcache, toks, lo, jcfg):
    """As `jax_codes`, from the step as the test runs it (the layers'
    scan compiled), each int8-activation matmul sending its codes to the
    host through an ordered callback. -> (codes, that run's logits)."""
    codes, plain = [], jgemm.qmatmul_pallas

    def logged(x, qt, *a, **kw):
        if kw.get("act_quant"):
            k = x.shape[-1]
            x2 = x.reshape(-1, k)
            if x2.shape[0] <= 16:  # the w4a8 route (<= W4A8_MAX_ROWS rows)
                jax.debug.callback(lambda c: codes.append(np.asarray(c)),
                                   jgemm.quantize_activation(x2.astype(jnp.float32), 32, k)[0],
                                   ordered=True)
        return plain(x, qt, *a, **kw)

    jgemm.qmatmul_pallas = logged
    try:
        logits, _ = jforward(jw, jcache, jnp.asarray(toks, jnp.int32),
                             jnp.asarray([lo], jnp.int32), jcfg, jnp.float32)
        logits = np.asarray(logits)
        jax.effects_barrier()
    finally:
        jgemm.qmatmul_pallas = plain
    return codes, logits


def port_step(w, cfg, cache, toks, lo, codes=None):
    """The port's step; with `codes`, each int8-activation matmul takes the
    i-th array of codes in place of its own. -> (logits, per matmul: the
    positions where the codes differ, the port's x / dx there, the port's
    codes there, the codes taken)."""
    plain, seen = pgq.quantize_activation, []

    def quantize(x2, group=pgq.GROUP):
        xq, dx, sx = plain(x2, group)
        if codes is None:
            seen.append(None)
            return xq, dx, sx
        want = torch.from_numpy(np.array(codes[len(seen)]))
        at = (xq != want).nonzero(as_tuple=True)
        ratio = x2.float()[at].abs() / dx[at[0], at[1] // group]
        seen.append((at, ratio, xq[at], want[at]))
        return want, dx, dx * want.float().reshape(dx.shape + (group,)).sum(-1)

    pgq.quantize_activation = quantize
    try:
        logits = forward(w, cache, torch.from_numpy(toks), torch.tensor([lo]), cfg,
                         torch.float32)
    finally:
        pgq.quantize_activation = plain
    return logits.numpy(), seen


def f32_twin(src: str, dst: str) -> str:
    """Copy a GGUF with every tensor dequantized to F32 (the codec's values)."""
    gf = GGUFFile(src)
    w = GGUFWriter()
    for k, v in gf.metadata.as_dict().items():
        w.add_metadata(k, v, gf.metadata.value_type(k))
    for ti in gf.tensor_infos:
        vals = codecs.dequantize(ti.typ, ti.to_numpy(), ti.n_elems).astype(np.float32)
        w.add_tensor(ti.name, GGMLType.F32, ti.shape, vals)
    w.write(dst)
    return dst
