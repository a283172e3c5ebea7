"""Port parity for the batched sampler: the same numpy logits through the JAX
package's sampler functions and the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.runtime import sampler as jsampler
from crabml_tpu_torch.runtime import sampler

B, V, W = 6, 97, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    recent = rng.integers(0, V, (B, W)).astype(np.int32)
    recent[:, :5] = -1  # padding
    recent[0, 5:] = 0  # token 0 seen for real beside the -1 padding
    bias = np.zeros((B, V), np.float32)
    bias[1, 7], bias[2, 3] = 8.0, -100.0
    rep = np.asarray([1.0, 1.3, 1.0, 1.1, 2.0, 1.0], np.float32)
    freq = np.asarray([0.0, 0.0, 0.5, 0.2, 0.0, 0.0], np.float32)
    pres = np.asarray([0.0, 0.0, 0.0, 0.4, 0.3, 0.0], np.float32)
    return logits, recent, bias, rep, freq, pres


def test_greedy_rows_with_penalties_and_bias_match_jax():
    """Temperature 0 everywhere: tokens identical to JAX (tolerance 0),
    sampled-token and top-k logprobs within 1e-5, top-k ids identical."""
    logits, recent, bias, rep, freq, pres = _inputs()
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    want, (w_lp, w_top, w_id) = jsampler.sample_batch(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.asarray(ones),
        minp=jnp.asarray(zeros), logit_bias=jnp.asarray(bias), recent_tokens=jnp.asarray(recent),
        repetition_penalty=jnp.asarray(rep), frequency_penalty=jnp.asarray(freq),
        presence_penalty=jnp.asarray(pres), with_logprobs=True)
    t = torch.tensor
    for temperature in (t(zeros), None):  # a zero vector, and the all-greedy shortcut
        got, (g_lp, g_top, g_id) = sampler.sample_batch(
            t(logits), None, temperature, t(ones), minp=t(zeros), logit_bias=t(bias),
            recent_tokens=t(recent), repetition_penalty=t(rep), frequency_penalty=t(freq),
            presence_penalty=t(pres), with_logprobs=True)
        assert got.tolist() == np.asarray(want).tolist()
        np.testing.assert_allclose(g_lp.numpy(), np.asarray(w_lp), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g_top.numpy(), np.asarray(w_top), rtol=0, atol=1e-5)
        assert g_id.tolist() == np.asarray(w_id).tolist()
        assert g_id.shape == (B, sampler.LOGPROB_TOPK)


def test_processors_match_jax_elementwise():
    """Repetition and frequency/presence penalties alone, scalar and per-row
    parameters: processed logits within 1e-6 of JAX."""
    logits, recent, _, rep, freq, pres = _inputs(1)
    t = torch.tensor
    for penalty in (rep, 1.25):
        want = jsampler.apply_repetition_penalty(
            jnp.asarray(logits), jnp.asarray(recent), jnp.asarray(penalty))
        got = sampler.apply_repetition_penalty(t(logits), t(recent), t(penalty))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    want = jsampler.apply_frequency_presence(jnp.asarray(logits), jnp.asarray(recent),
                                             jnp.asarray(freq), jnp.asarray(pres))
    got = sampler.apply_frequency_presence(t(logits), t(recent), t(freq), t(pres))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("topp,minp", [(0.9, 0.0), (0.5, 0.05), (1.0, 0.2), (0.0, 0.0)])
def test_nucleus_and_min_p_masks_match_jax(topp, minp):
    """The kept set (probability > 0 after filtering) is identical to JAX's
    for per-row and scalar parameters; kept values within 1e-7."""
    logits, *_ = _inputs(2)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    tp = np.full(B, topp, np.float32)
    tp[0] = 0.3  # rows differ
    mp = np.full(B, minp, np.float32)
    want = jsampler.min_p_filter(jsampler.nucleus_filter(jnp.asarray(probs), jnp.asarray(tp)),
                                 jnp.asarray(mp))
    got = sampler.min_p_filter(sampler.nucleus_filter(torch.tensor(probs), torch.tensor(tp)),
                               torch.tensor(mp))
    assert ((got.numpy() > 0) == (np.asarray(want) > 0)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    want = jsampler.nucleus_filter(jnp.asarray(probs), topp)
    got = sampler.nucleus_filter(torch.tensor(probs), topp)
    assert ((got.numpy() > 0) == (np.asarray(want) > 0)).all()


def test_sampled_rows_reproduce_from_the_seed_and_stay_in_the_nucleus():
    """Rows with temperature > 0 draw from the filtered distribution: the
    same generator seed gives the same tokens, every draw lies in the kept
    set, and greedy rows beside them stay argmax."""
    logits, *_ = _inputs(3)
    temp = torch.tensor([0.0, 0.8, 0.8, 1.5, 0.0, 0.7])
    topp = torch.tensor([0.9, 0.9, 0.5, 0.95, 0.9, 1.0])
    minp = torch.tensor([0.0, 0.0, 0.1, 0.0, 0.0, 0.3])

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sampler.sample_batch(torch.tensor(logits), g, temp, topp, minp=minp)
                            for _ in range(40)])

    a, b = draw(5), draw(5)
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(6))
    probs = torch.softmax(torch.tensor(logits) / temp.clamp_min(1e-6)[:, None], dim=-1)
    kept = sampler.min_p_filter(sampler.nucleus_filter(probs, topp), minp) > 0
    assert kept.gather(1, a.t()).all()
    greedy = torch.tensor(logits).argmax(-1)
    assert (a[:, [0, 4]] == greedy[[0, 4]]).all()
    assert len(set(a[:, 3].tolist())) > 1  # a hot row really samples
