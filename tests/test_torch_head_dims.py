"""Flash attention at every head dim that is a multiple of 8 up to 256 (the
reference's own TinyStories models: stories260K's 8 over G = 2, stories15M's
48 over G = 1) against the JAX package on the CPU.

- The plain flash against the JAX flash kernel in interpret mode at head
  dims 8, 24, 48, 72, 136 and 248 (one of each class of lanes a tile row of
  the CUDA kernel holds past the head dim: 64-wide tiles up to 64, 128 up to
  128, 256 above), at 1, 2 and 7 q heads a kv head, in float32 and
  bfloat16, with a window and a softcap.
- The rope at rope dims 8 and 48, the card's entry rule at the new head dims,
  and the decode step's and paged tick's route through flash at hd 8 and 48.
On the card: `-k "any_head_dim or padded"` of tests/test_torch_kernels_gpu.py
and chip_smoke.py's `stories` phase."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops import rope as jrope
from crabml_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from crabml_tpu_torch.models.config import ModelConfig
from crabml_tpu_torch.ops import rope
from crabml_tpu_torch.ops.cuda import flash_attention as fa
from crabml_tpu_torch.ops.cuda.decode_attention import decode_eligible

HEAD_DIMS = [8, 24, 48, 72, 136, 248]


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


def _case(hd, G, pos0, seed, B=2, T=128, S=256, KV=2):
    """q, k, v and pos in float32. T is 128: the JAX kernel tiles T by 128 or
    256 (flash_attention.py:184)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, KV * G, hd)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    return q, k, v, np.asarray([pos0, pos0 // 2], np.int32)


def _both(q, k, v, pos, scale, softcap=0.0, window=0, jdtype=jnp.float32, dtype=torch.float32):
    want = j_flash(*(jnp.asarray(a, jdtype) for a in (q, k, v)), jnp.asarray(pos), scale,
                   force=True, softcap=softcap,
                   local_window=jnp.int32(window) if window else None)
    assert want is not None  # the JAX kernel takes every hd % 8 == 0 up to 512
    got = fa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                             torch.from_numpy(pos), scale, softcap, window)
    B, T, H, hd = q.shape
    assert got.shape == (B, T, H * hd) and got.dtype == dtype
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_plain_matches_pallas_at_any_head_dim(hd, G):
    """Float32 throughout, tolerance 2e-5 (the same softmax in another order
    of float32 sums): 1, 2 and 7 q heads a kv head (7: 9 tokens and a padding
    row a warpgroup of the CUDA kernel), ragged offsets."""
    got, want = _both(*_case(hd, G, 37 + hd, hd + G), hd ** -0.5)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_plain_matches_pallas_in_bfloat16(hd):
    """bfloat16 q, k and v at G = 2: tolerance 2^-7 of max|out|. The port's
    plain version computes in float32 from the bfloat16 inputs and rounds
    the output once; the JAX kernel rounds its probabilities to bfloat16
    before the product with v, so the two differ by about one bfloat16 step
    of the output's scale."""
    got, want = _both(*_case(hd, 2, 96, hd), hd ** -0.5, jdtype=jnp.bfloat16,
                      dtype=torch.bfloat16)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("hd,G", [(8, 2), (48, 1)])
def test_flash_plain_matches_pallas_with_window_and_softcap(hd, G):
    """stories260K's and stories15M's heads with a 100-key window (which
    drops whole key blocks at these offsets) and a softcap of 30: float32,
    tolerance 2e-5."""
    got, want = _both(*_case(hd, G, 200, 3 * hd), hd ** -0.5, softcap=30.0, window=100)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rd", [8, 48])
@pytest.mark.parametrize("mode", ["llama", "neox"])
def test_rope_matches_jax_at_the_tinystories_rope_dims(rd, mode):
    """apply_rope at stories260K's rope dim 8 and stories15M's 48, positions
    up to 511 (the contexts): within 1e-6 of the JAX package's (XLA's and
    torch's cos and sin on the same float32 angles)."""
    rng = np.random.default_rng(rd)
    x = rng.standard_normal((2, 5, 3, rd)).astype(np.float32)
    pos = rng.integers(0, 512, (2, 5)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), rd, mode, 10000.0)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), rd, mode, 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hd", HEAD_DIMS + [16, 64, 80, 96, 128, 256])
def test_card_takes_every_head_dim_a_multiple_of_8(hd):
    """Every multiple of 8 up to 256 passes the card's check in both compute
    dtypes, the one the Runner and both engines make before they read a
    weight. No card is needed to decide."""
    cfg = ModelConfig("llama", embedding_dim=64, hidden_dim=172, n_layers=1, n_heads=8,
                      n_kv_heads=4, vocab_size=512, seq_len=512, head_dim_override=hd)
    for dtype in (torch.bfloat16, torch.float32):
        fa.check_card_attention(cfg, "cuda", dtype)


def test_the_tinystories_head_dims_take_flash_for_every_attention():
    """The decode kernels take head dims 80 to 256 only: at hd 8 and 48 the
    decode step, a chunk of a few tokens and the paged tick attend through
    flash (models/forward.py, serving/paged.py), as at hd 16."""
    for hd, H, KV in ((8, 8, 4), (48, 6, 6)):
        assert not any(decode_eligible(T, H, KV, hd) for T in range(1, 9))
        assert hd in fa.HEAD_DIMS
    assert [hd for hd in range(1, 300) if hd in fa.HEAD_DIMS] == list(range(8, 257, 8))
