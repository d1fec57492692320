"""Paced negative sampling: the port of ops/sampling.py.

A binomial PMF over pool positions centred at the current difficulty
(index 0 the easiest negative, n_neg - 1 the hardest), sampled without
replacement with the Gumbel-top-k trick, all on the device so the
curriculum feedback never syncs with the host. Random numbers come from an
explicit ``torch.Generator``; its stream differs from ``jax.random``'s, so
the tests compare the sampler by distribution. The reference's ``var``
rescaling is a no-op and is not taken (pacednegatives_tpu/ops/sampling.py
module docstring).
"""

from __future__ import annotations

import torch

# fp32-safe probability clamp (see pacednegatives_tpu/ops/sampling.py:35-41)
_P_EPS = 1e-6


def binomial_log_pmf(k: torch.Tensor, n, p) -> torch.Tensor:
    """log Binomial(k; n, p) in fp32, broadcasting k against p. xlogy and
    xlog1py make the endpoints exact (0 * log 0 = 0) even if a caller
    bypasses the clamp."""
    k = k.float()
    n = torch.as_tensor(n, dtype=torch.float32, device=k.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=k.device)
    p = p.clamp(_P_EPS, 1.0 - _P_EPS)
    return (
        torch.lgamma(n + 1.0)
        - torch.lgamma(k + 1.0)
        - torch.lgamma(n - k + 1.0)
        + torch.xlogy(k, p)
        + torch.special.xlog1py(n - k, -p)
    )


def paced_binomial_log_probs(n_neg: int, mean, min_mean: float = _P_EPS,
                             max_mean: float = 1.0 - _P_EPS) -> torch.Tensor:
    """(..., n_neg) log-probabilities over pool indices for difficulty
    ``mean`` (a scalar or a (B,) tensor): the normalised PMF of
    Binomial(n_neg - 1, mean) at 0..n_neg-1."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    mean = mean.clamp(min_mean, max_mean)[..., None]
    idx = torch.arange(n_neg, dtype=torch.float32, device=mean.device)
    return torch.log_softmax(binomial_log_pmf(idx, n_neg - 1, mean), dim=-1)


def paced_binomial_probs(n_neg: int, mean, **kw) -> torch.Tensor:
    return torch.exp(paced_binomial_log_probs(n_neg, mean, **kw))


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    # -log(E) with E ~ Exp(1) is Gumbel(0, 1)
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=generator).log()


def sample_pool_indices(generator: torch.Generator, n_neg: int, mean,
                        n: int) -> torch.Tensor:
    """Draw ``n`` distinct pool indices ~ the paced binomial PMF."""
    logp = paced_binomial_log_probs(n_neg, mean)
    g = _gumbel(logp.shape, generator, logp.device)
    return torch.topk(logp + g, n).indices


def sample_pool_indices_batch(generator: torch.Generator, n_neg: int,
                              means: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) difficulties -> (B, n) distinct pool indices per row."""
    logp = paced_binomial_log_probs(n_neg, means)
    g = _gumbel(logp.shape, generator, logp.device)
    return torch.topk(logp + g, n, dim=-1).indices


def difficulty_to_index(weight, n_neg: int, use_max: bool = False) -> torch.Tensor:
    """Scalar difficulty -> single pool index: floor (or ceil) of
    weight * (n_neg - 1), clamped to the pool (dataloader.py:29-33)."""
    scaled = torch.as_tensor(weight, dtype=torch.float32) * (n_neg - 1)
    idx = torch.ceil(scaled) if use_max else torch.floor(scaled)
    return idx.to(torch.int32).clamp(0, n_neg - 1)
