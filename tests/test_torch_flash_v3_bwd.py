"""Port of the fused attention block's backward (K4): the plain PyTorch
version against the JAX package's ``v3_backward`` in interpret mode, and
the port's autograd gradients against ``jax.grad`` of
``fused_self_attention``, on the same numpy inputs, in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import flash_v3 as jv3
from pacednegatives_tpu_torch.ops import flash as tflash
from pacednegatives_tpu_torch.ops import flash_v3 as tv3
from pacednegatives_tpu_torch.ops.gemm import gemm

# torch.exp on the CPU hands contiguous fp32 to MKL's vector math, one
# chunk per OpenMP thread. In a fresh process under heavy CPU load, the
# first call sometimes computes one thread's chunk to ~1.5e-4 relative
# (seen in ~2% of fresh processes, the same inputs exact in the rest;
# later calls in the process exact): the rare failures of the fp32 parity
# tests here. One call over every thread at import, before any test,
# keeps that first call out of the comparisons.
torch.exp(torch.zeros(1 << 20))

# fp32 on both sides; the products differ only in summation order (depth
# <= 384 over unit-scale values): ~1e-6 absolute on O(1) results.
ATOL = 2e-5
RTOL = 1e-5
# gradients through the whole block (the JAX package's own A/B tolerance,
# tests/test_flash_v3.py:214-221)
GRAD_TOL = 3e-4


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
    d_attn = rng.normal(size=(B, L, inner)).astype(np.float32)
    cot = rng.normal(size=(B, L, D)).astype(np.float32)
    return x, wqkv, wo, pos3, key_mask, d_attn, cot


@pytest.mark.parametrize("L,dk", [(64, 64), (80, 128)])
def test_v3_backward_plain_matches_jax(L, dk):
    """(d_qkv, attn, dpos) from the same (m, l), at 16-aligned lengths
    (the JAX v3_backward is called unpadded)."""
    x, wqkv, wo, pos3, km, d_attn, _ = _case(2, L, 128, 2, dk, seed=L + dk)
    _, m, l = jv3.v3_forward(*map(jnp.asarray, (x, wqkv, wo, pos3, km)),
                             interpret=True)
    j = jv3.v3_backward(*map(jnp.asarray, (x, wqkv, pos3, km, m, l, d_attn)),
                        interpret=True)
    t = tv3.v3_backward_plain(*map(torch.from_numpy, (x, wqkv, pos3, km)),
                              torch.from_numpy(np.array(m)),
                              torch.from_numpy(np.array(l)),
                              torch.from_numpy(d_attn))
    for name, a, b in zip(("dqkv", "attn", "dpos"), t, j):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("L", [64, 90])
def test_grads_match_jax(L):
    """d(sum(y * cot)) / d(x, wqkv, wo, pos3): port autograd (the
    FusedSelfAttention function, plain versions on the CPU) against
    jax.grad of fused_self_attention in interpret mode. L 90 is padded to
    96 on the JAX side and masked in place on the port's."""
    x, wqkv, wo, pos3, km, _, cot = _case(2, L, 128, 2, 64, seed=L)

    def jloss(*a):
        y = jv3.fused_self_attention(*a, jnp.asarray(km), interpret=True)
        return jnp.sum(y * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, wqkv, wo, pos3)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, wqkv, wo, pos3)]
    y = tv3.fused_self_attention(*args, torch.from_numpy(km))
    (y * torch.from_numpy(cot)).sum().backward()
    for name, a, b in zip(("x", "wqkv", "wo", "pos3"), args, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_function_matches_plain_autograd():
    """The hand-written backward (K4 arithmetic) against autograd through
    the plain forward: the same gradients up to the recompute order."""
    x, wqkv, wo, pos3, km, _, cot = _case(3, 72, 128, 2, 64, seed=5)
    grads = []
    for fn in (tv3.fused_self_attention, tv3.fused_self_attention_plain):
        args = [torch.from_numpy(a).requires_grad_()
                for a in (x, wqkv, wo, pos3)]
        (fn(*args, torch.from_numpy(km)) * torch.from_numpy(cot)).sum() \
            .backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_bf16_backward_matches_jax():
    """bf16 x / weights / d_attn: the same cast points on both sides (qkv,
    normalised p, ds and the outputs rounded to bf16). Tolerance: a few
    bf16 ulps of each output's largest magnitude."""
    x, wqkv, wo, pos3, km, d_attn, _ = _case(2, 64, 128, 2, 64, seed=9)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    _, m, l = jv3.v3_forward(bf(x), bf(wqkv), bf(wo), jnp.asarray(pos3),
                             jnp.asarray(km), interpret=True)
    j = jv3.v3_backward(bf(x), bf(wqkv), jnp.asarray(pos3), jnp.asarray(km),
                        m, l, bf(d_attn), interpret=True)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    t = tv3.v3_backward_plain(tb(x), tb(wqkv), torch.from_numpy(pos3),
                              torch.from_numpy(km),
                              torch.from_numpy(np.array(m)),
                              torch.from_numpy(np.array(l)), tb(d_attn))
    for name, a, b in zip(("dqkv", "attn", "dpos"), t, j):
        ref = np.asarray(b.astype(jnp.float32))
        err = np.abs(a.float().numpy() - ref).max()
        assert err <= 4 * 2.0**-8 * np.abs(ref).max(), (name, err)


def test_cpu_backward_launches_nothing():
    x, wqkv, wo, pos3, km, _, cot = _case(2, 64, 128, 2, 64, seed=1)
    before = (gemm.launches, tflash.flash_attention_forward.launches,
              tflash.attention_backward.launches)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, wqkv, wo, pos3)]
    (tv3.fused_self_attention(*args, torch.from_numpy(km))
     * torch.from_numpy(cot)).sum().backward()
    assert (gemm.launches, tflash.flash_attention_forward.launches,
            tflash.attention_backward.launches) == before


def test_core_backward_writes_into_views():
    """attention_backward with dq/dk/dv/out given as strided views of one
    fused buffer writes there and returns the same values as without."""
    rng = np.random.default_rng(2)
    B, H, L, dk = 2, 2, 40, 64
    qkv = torch.from_numpy(rng.normal(size=(B, L, 3, H, dk)).astype(np.float32))
    q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    g = torch.from_numpy(rng.normal(size=(B, H, L, dk)).astype(np.float32))
    pos = torch.from_numpy(rng.normal(size=(H, L, L)).astype(np.float32))
    km = torch.zeros((B, L))
    km[1, L // 2:] = tflash.NEG_INF
    _, m, l = tflash.flash_attention_forward(q, k, v, pos, km)
    ref = tflash.attention_backward(q, k, v, g, pos, km, m, l)
    buf = torch.zeros((B, L, 3, H, dk))
    out = torch.zeros((B, L, H, dk))
    views = [buf[:, :, t].transpose(1, 2) for t in range(3)]
    got = tflash.attention_backward(q, k, v, g, pos, km, m, l, dq=views[0],
                                    dk=views[1], dv=views[2],
                                    out=out.transpose(1, 2))
    assert got[0].data_ptr() == views[0].data_ptr()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(buf[:, :, 2].transpose(1, 2), ref[2],
                               rtol=0, atol=0)
