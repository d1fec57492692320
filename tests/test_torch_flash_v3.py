"""Port of the fused attention block (K3): the plain PyTorch version against
the JAX package's ``fused_self_attention`` / ``v3_forward`` in interpret
mode, on the same numpy inputs, at ragged and aligned lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import flash_v3 as jv3
from pacednegatives_tpu_torch.ops import flash_v3 as tv3
from pacednegatives_tpu_torch.ops.gemm import gemm

# fp32 on both sides; only summation order differs (three products of
# depth <= 384 between unit-scale activations): ~1e-6.
ATOL = 2e-5
RTOL = 1e-5


def _case(B, L, D, H, dk, seed=0):
    rng = np.random.default_rng(seed)
    inner = H * dk
    x = rng.normal(size=(B, L, D)).astype(np.float32) * 0.5
    wqkv = rng.normal(size=(D, 3 * inner)).astype(np.float32) * 0.05
    wo = rng.normal(size=(inner, D)).astype(np.float32) * 0.05
    pos3 = rng.normal(size=(H, L, L)).astype(np.float32) * 0.3
    lens = rng.integers(L // 2, L + 1, size=B)
    key_mask = np.where(np.arange(L)[None] < lens[:, None], 0.0,
                        tv3.NEG_INF).astype(np.float32)
    return x, wqkv, wo, pos3, key_mask


@pytest.mark.parametrize("L", [64, 72, 188])
@pytest.mark.parametrize("dk", [64, 128])
def test_plain_matches_jax(L, dk):
    args = _case(B=2, L=L, D=128, H=2, dk=dk, seed=L + dk)
    j = jv3.fused_self_attention(*map(jnp.asarray, args), interpret=True)
    t = tv3.fused_self_attention_plain(*map(torch.from_numpy, args))
    assert t.shape == (2, L, 128) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_statistics_match_jax():
    """(m, l) of v3_forward, at a 16-aligned length (the JAX v3_forward is
    called unpadded)."""
    args = _case(B=2, L=80, D=128, H=2, dk=64, seed=7)
    _, jm, jl = jv3.v3_forward(*map(jnp.asarray, args), interpret=True)
    _, tm, tl = tv3.v3_forward_plain(*map(torch.from_numpy, args))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)


def test_bf16_plain_matches_jax():
    """bf16 activations and weights: the same cast points on both sides
    (qkv, unnormalised p, per-head outputs, y rounded to bf16). Tolerance:
    a few bf16 ulps of the output's scale."""
    args = _case(B=2, L=72, D=128, H=2, dk=64, seed=11)
    x, wqkv, wo = (a.astype(jnp.bfloat16) for a in args[:3])
    j = jv3.fused_self_attention(jnp.asarray(x), jnp.asarray(wqkv),
                                 jnp.asarray(wo), jnp.asarray(args[3]),
                                 jnp.asarray(args[4]), interpret=True)
    tx, tw, to = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  for a in (x, wqkv, wo))
    t = tv3.fused_self_attention_plain(tx, tw, to,
                                       *map(torch.from_numpy, args[3:]))
    assert t.dtype == torch.bfloat16
    ref = np.asarray(j.astype(jnp.float32))
    err = np.abs(t.float().numpy() - ref).max()
    assert err <= 4 * 2.0**-8 * np.abs(ref).max(), err


def test_cpu_wrapper_is_plain_and_launches_nothing():
    args = [torch.from_numpy(a) for a in _case(2, 72, 128, 2, 64, seed=3)]
    before = (gemm.launches, tv3.flash_attention_forward.launches)
    y = tv3.fused_self_attention(*args)
    torch.testing.assert_close(y, tv3.fused_self_attention_plain(*args),
                               rtol=0, atol=0)
    assert (gemm.launches, tv3.flash_attention_forward.launches) == before


def test_eligibility_matches_jax_domain():
    """Same shape domain as the JAX gate in interpret mode."""
    for H in (2, 12, 16):
        for dk in (32, 64, 128):
            for L in (32, 63, 64, 188, 512, 513):
                for d_model in (128, 768, 4096):
                    assert tv3.flash_v3_eligible(H, L, L, dk, d_model) == \
                        jv3.flash_v3_eligible(H, L, L, dk, d_model,
                                              interpret=True)
    assert not tv3.flash_v3_eligible(12, 188, 1, 64, 768)
