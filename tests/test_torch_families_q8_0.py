"""The Q8_0 family files against the JAX package on prompt seeds 1 to 5.

Every matmul of a step of up to 16 rows quantizes its input to int8 on both
sides (the JAX package on its w4a8 backend), and two implementations agree
there only up to a rounding edge: an input within a few ulps of n + 1/2
steps goes one way in one package and the other way in the other. Each step
is held to JAX's logits at 2e-4, or, where it misses, to the cause: rerun
with JAX's int8 codes in place of the port's, it matches."""

import jax.numpy as jnp
import numpy as np
import pytest

from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache
from crabml_tpu_torch.models.weights import load_weights
# one_torch_thread (autouse) and w4a8_backend are fixtures, used by import
from torch_families_common import (CHUNKS, TOL, VARIANTS, family_file, jax_codes, jax_weights,
                                   one_torch_thread, port_step, w4a8_backend)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_q8_0_steps_match_jax_or_differ_by_rounding_edges(tmp_path_factory, w4a8_backend,
                                                          variant, seed):
    """Every Q8_0 step on prompt seeds 1 to 5 matches JAX's at 2e-4, or is
    shown to differ only by int8 rounding: the step (at most 16 rows, int8
    activations on both sides) rerun with JAX's int8 codes in place of the
    port's matches JAX's at 2e-4, and each code it swapped differs by one and
    lies on a rounding edge in the port (x / dx within 1e-3 of n + 1/2, dx =
    max|x| of its 32-group / 127), where the few ulps by which the two
    packages' attention, norms or GELU differ round it the other way. The
    steps after it go on from the swapped run's cache, the history JAX's has."""
    path = family_file(tmp_path_factory, variant, "q8_0")
    jw, jcfg = jax_weights(path, "q8_0")
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    tokens = np.random.default_rng(seed).integers(3, cfg.vocab_size, (1, CHUNKS[-1][1]))
    jcache = JKVCache.create(jcfg, 1, cfg.seq_len)
    cache = KVCache.create(cfg, 1, cfg.seq_len)
    for lo, hi in CHUNKS:
        toks = tokens[:, lo:hi]
        before = KVCache(cache.k.clone(), cache.v.clone())
        got, quantized = port_step(w, cfg, cache, toks, lo)
        want, after = jforward(jw, jcache, jnp.asarray(toks, jnp.int32),
                               jnp.asarray([lo], jnp.int32), jcfg, jnp.float32)
        want = np.asarray(want)
        if np.abs(got - want).max() > TOL:
            assert hi - lo <= 16 and quantized, (lo, hi)  # an int8-activation step
            codes, op_by_op = jax_codes(jw, jcache, toks, lo, jcfg)
            np.testing.assert_allclose(op_by_op, want, rtol=0, atol=1e-5)
            assert len(codes) == len(quantized)
            cache = before
            got, swapped = port_step(w, cfg, cache, toks, lo, codes)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            assert sum(len(s[1]) for s in swapped) >= 1
            for at, ratio, mine, theirs in swapped:
                assert ((mine.int() - theirs.int()).abs() == 1).all()
                assert ((ratio - ratio.floor() - 0.5).abs() <= 1e-3).all(), ratio
        jcache = after
