"""Port of ops/sampling.py: the deterministic parts against the JAX
package's to 1e-6, the Gumbel-top-k sampler by distribution (the two
frameworks' random streams differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import sampling as js
from pacednegatives_tpu_torch.ops import sampling as ts

TOL = 1e-6
# lgamma(n + 1) reaches ~360 at n = 99, where one fp32 ulp is 3e-5: the
# normalised log-probabilities carry that absolute error from either
# framework's lgamma, so the probabilities agree to that relative error
PROB_RTOL = 1e-4


@pytest.mark.parametrize("n_neg", [2, 9, 100])
def test_binomial_log_pmf_and_probs(n_neg):
    k = np.arange(n_neg)
    for p in (0.0, 1e-7, 0.3, 0.5, 0.999, 1.0):
        t = ts.binomial_log_pmf(torch.from_numpy(k), n_neg - 1, p)
        j = js.binomial_log_pmf(jnp.asarray(k), n_neg - 1, p)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(j).max()))
        np.testing.assert_allclose(
            ts.paced_binomial_probs(n_neg, p).numpy(),
            np.asarray(js.paced_binomial_probs(n_neg, p)), atol=TOL,
            rtol=PROB_RTOL)
    # a (B,) batch of difficulties gives one row per difficulty
    means = torch.tensor([0.1, 0.7])
    rows = ts.paced_binomial_log_probs(n_neg, means)
    assert rows.shape == (2, n_neg)
    np.testing.assert_allclose(
        rows[1].numpy(), np.asarray(js.paced_binomial_log_probs(n_neg, 0.7)),
        atol=PROB_RTOL, rtol=TOL)


@pytest.mark.parametrize("use_max", [False, True])
def test_difficulty_to_index(use_max):
    for n_neg in (1, 2, 32, 100):
        for w in (0.0, 0.1, 0.5, 1 - 1e-6, 1.0, 1.5, -0.2):
            assert int(ts.difficulty_to_index(w, n_neg, use_max)) == int(
                js.difficulty_to_index(w, n_neg, use_max)), (n_neg, w)


def test_gumbel_sampler_distribution():
    """The first of n draws is a draw from the paced PMF: its histogram
    over 20k rows matches paced_binomial_probs (binomial standard error
    at most 0.0035 per slot; 5 sigma), and every row's n slots are
    distinct."""
    n_neg, n, rows = 16, 4, 20_000
    g = torch.Generator().manual_seed(0)
    means = torch.full((rows,), 0.3)
    idx = ts.sample_pool_indices_batch(g, n_neg, means, n)
    assert idx.shape == (rows, n)
    assert (idx.sort(dim=1).values.diff(dim=1) > 0).all()
    hist = np.bincount(idx[:, 0].numpy(), minlength=n_neg) / rows
    want = np.asarray(js.paced_binomial_probs(n_neg, 0.3))
    assert np.abs(hist - want).max() < 5 * 0.0035
    one = ts.sample_pool_indices(g, n_neg, 0.3, n)
    assert one.shape == (n,) and len(set(one.tolist())) == n
