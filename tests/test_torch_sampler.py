"""The port's sampler (`gemma_tpu_torch/runtime/sampler.py`) against the JAX
package's (`gemma_tpu/runtime/sampler.py`).

The two draw from different generators (`torch.Generator` against
`jax.random`), so streams cannot match; what must match is the distribution
each row is drawn from. The JAX sampler's filtered logits (temperature, then
top-k, then top-p) are taken where it hands them to
`jax.random.categorical`, and the port's inverse-CDF draw over many rows of
the same logits is held to their softmax within 5 binomial deviations a
token, with no draw of a token the filters removed. Then the draw's edges:
a uniform at 0, just below 1 or rounded up to 1, with filtered tokens
before, between and after the kept ones, and `rows`, which draws the whole batch's uniforms and
keeps its rows'.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu.runtime import sampler as jax_sampler
from gemma_tpu_torch.runtime import sampler

V = 16
DRAWS = 20000

# (temperature, top_k, top_p): temperature alone, each filter, both
PARAMS = [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8), (1.3, 8, 0.9)]


def jax_filtered_probs(logits: np.ndarray, temperature: float, top_k: int, top_p: float,
                       monkeypatch) -> np.ndarray:
    """The JAX sampler's filtered softmax of one row: the logits it hands
    to `jax.random.categorical`, softmaxed in f64."""
    seen = []

    def categorical(key, lg, axis=-1):
        seen.append(np.asarray(lg, np.float64))
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jax_sampler.sample(jnp.asarray(logits[None]), jax_sampler.SamplingParams(
        temperature=temperature, top_k=top_k, top_p=top_p), jax.random.PRNGKey(0))
    z = seen[0][0]
    p = np.exp(z - z.max())
    return p / p.sum()


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS)
def test_sample_frequencies_match_jax_filtered_softmax(temperature, top_k, top_p, monkeypatch):
    logits = (np.random.default_rng(7).normal(size=V) * 2).astype(np.float32)
    want = jax_filtered_probs(logits, temperature, top_k, top_p, monkeypatch)
    assert (want == 0).any() == (top_k > 0 or top_p < 1)  # the filters remove tokens
    gen = torch.Generator()
    gen.manual_seed(16)
    rows = torch.from_numpy(logits).expand(DRAWS, V)
    toks = sampler.sample(rows, sampler.SamplingParams(temperature, top_k, top_p), gen)
    assert toks.dtype == torch.int32 and toks.shape == (DRAWS,)
    freq = np.bincount(toks.numpy(), minlength=V) / DRAWS
    assert not freq[want == 0].any()
    assert np.all(np.abs(freq - want) <= 5 * np.sqrt(want * (1 - want) / DRAWS))


def _draw_at(u: float, logits: list[float], params, monkeypatch) -> int:
    """The token the sampler draws for one row at uniform `u`."""
    real_rand = torch.rand

    def rand(n, generator=None, device=None):
        assert n == 1 and generator is not None
        real_rand(n, generator=generator, device=device)
        return torch.tensor([u], dtype=torch.float32)

    monkeypatch.setattr(torch, "rand", rand)
    gen = torch.Generator()
    gen.manual_seed(0)
    return int(sampler.sample(torch.tensor([logits]), params, gen)[0])


U_MAX = float(np.nextafter(np.float32(1), np.float32(0)))  # torch.rand's largest


@pytest.mark.parametrize("u,logits,params,want", [
    # top-k keeps 1 and 3; everything after 3 filtered: u just below 1
    # lands past the total's rounding on the last kept token
    (U_MAX, [0.0, 3.0, -1.0, 2.5, 0.5, -2.0], sampler.SamplingParams(1.0, top_k=2), 3),
    # u * total rounded up to the total (a total just above 1 and u just
    # below it): still the last kept token, not the last of the row
    (1.0, [0.0, 3.0, -1.0, 2.5, 0.5, -2.0], sampler.SamplingParams(1.0, top_k=2), 3),
    # u = 0 with the leading tokens filtered: the first kept token
    (0.0, [-5.0, -4.0, 1.0, 2.0, -6.0], sampler.SamplingParams(1.0, top_k=2), 2),
    # u just past token 1's mass, token 2 filtered between 1 and 3: never 2
    (None, [-9.0, 1.0, -8.0, 1.0, -9.0], sampler.SamplingParams(1.0, top_p=0.99), 3),
])
def test_sample_edges_of_the_inverse_cdf(u, logits, params, want, monkeypatch):
    if u is None:  # tokens 1 and 3 each hold half the kept mass
        u = float(np.nextafter(np.float32(0.5), np.float32(1)))
    assert _draw_at(u, logits, params, monkeypatch) == want


@pytest.mark.parametrize("temperature,top_k,top_p", [PARAMS[0], PARAMS[3]])
def test_sample_rows_draws_the_whole_batch(temperature, top_k, top_p):
    """`rows` draws all B uniforms and keeps its rows': the same tokens as
    the full batch's rows, and the generator in the same state after."""
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(6, V)).astype(np.float32))
    params = sampler.SamplingParams(temperature, top_k, top_p)
    full_gen, part_gen = torch.Generator(), torch.Generator()
    full_gen.manual_seed(5)
    part_gen.manual_seed(5)
    full = sampler.sample(logits, params, full_gen)
    part = sampler.sample(logits, params, part_gen, slice(3, 6))
    assert torch.equal(part, full[3:6])
    assert torch.equal(full_gen.get_state(), part_gen.get_state())
