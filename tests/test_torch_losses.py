"""Port of ops/losses.py: every loss against the JAX package's on the same
numpy inputs. fp32 on both sides, one reduction order apart: 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import losses as jl
from pacednegatives_tpu_torch.ops import losses as tl

TOL = 1e-6


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=TOL,
                               atol=TOL)


def _logits_labels(seed, B=6, L=3, V=11, ignore=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, L, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, size=(B, L)).astype(np.int64)
    if ignore:
        labels[0, -1] = labels[3, 0] = -100
        labels[5, :] = -100  # an all-ignored row: count clamps to 1
    return logits, labels


@pytest.mark.parametrize("ignore", [False, True])
def test_token_ce(ignore):
    logits, labels = _logits_labels(0, ignore=ignore)
    j = (jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)))
    t = (torch.from_numpy(logits), torch.from_numpy(labels))
    _close(tl.token_ce_per_token(*t), jl.token_ce_per_token(*j))
    _close(tl.token_ce(*t), jl.token_ce(*j))


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_lce_losses(n, use_mean):
    rng = np.random.default_rng(n)
    B, L = 4, 2
    pce, nce = (rng.random(B).astype(np.float32),
                rng.random(B * n).astype(np.float32))
    ptok, ntok = (rng.random((B, L)).astype(np.float32),
                  rng.random((B * n, L)).astype(np.float32))
    T = lambda *a: [torch.from_numpy(x) for x in a]
    J = lambda *a: [jnp.asarray(x) for x in a]
    _close(tl.lce_ce(*T(pce, nce), n, use_mean),
           jl.lce_ce(*J(pce, nce), n, use_mean))
    _close(tl.lce_ce_flat_tokens(*T(ptok, ntok), n, use_mean),
           jl.lce_ce_flat_tokens(*J(ptok, ntok), n, use_mean))
    _close(tl.pairwise_ce_loss(*T(pce, pce[::-1].copy())),
           jl.pairwise_ce_loss(*J(pce, pce[::-1].copy())))


@pytest.mark.parametrize("kind", ["eta", "lce"])
def test_eta_weight_and_objective(kind):
    rng = np.random.default_rng(4)
    ce = rng.random(16).astype(np.float32) * 2
    pce, nce = rng.random(16).astype(np.float32), rng.random(16).astype(np.float32)
    for eta in (0.3, 1.0, 2.5):
        v_t = tl.eta_weight(torch.from_numpy(ce), eta, kind)
        v_j = jl.eta_weight(jnp.asarray(ce), eta, kind)
        _close(v_t, v_j)
        _close(tl.self_paced_objective(torch.from_numpy(pce),
                                       torch.from_numpy(nce), v_t),
               jl.self_paced_objective(jnp.asarray(pce), jnp.asarray(nce),
                                       v_j))
    with pytest.raises(ValueError):
        tl.eta_weight(torch.from_numpy(ce), 0.5, "other")


def test_margin_mse():
    rng = np.random.default_rng(5)
    s = rng.normal(size=8).astype(np.float32)
    t = rng.normal(size=(8, 3)).astype(np.float32)
    _close(tl.margin_mse(torch.from_numpy(s), torch.from_numpy(t)),
           jl.margin_mse(jnp.asarray(s), jnp.asarray(t)))
