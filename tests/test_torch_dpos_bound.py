"""The elementwise dpos bound (``ops.flash.dpos_error_bound``) that holds
the attention-backward kernels' dpos against their plain versions.

On the CPU: the plain versions' fp32 dpos against a float64 evaluation of
the same arithmetic must lie within the bound everywhere, and a dpos with
one batch row's ds left out must not.
"""

import numpy as np
import pytest
import torch

from pacednegatives_tpu_torch.ops import flash


def _inputs(seed, B, H, Lq, Lk, dk):
    """bf16 q/k/v, pos, a key mask with ragged lengths, the forward's
    (m, l) and out, and an fp32 cotangent g, from a numpy seed."""
    rng = np.random.default_rng(seed)
    bf = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    q, k, v = bf(B, H, Lq, dk), bf(B, H, Lk, dk), bf(B, H, Lk, dk)
    pos = torch.from_numpy(
        (0.5 * rng.standard_normal((H, Lq, Lk))).astype(np.float32))
    lens = rng.integers(1, Lk + 1, size=B)
    lens[0] = Lk
    km = torch.from_numpy(np.where(np.arange(Lk)[None] < lens[:, None], 0.0,
                                   flash.NEG_INF).astype(np.float32))
    out, m, l = flash.flash_attention_forward_plain(q, k, v, pos, km,
                                                    torch.float32)
    g = torch.from_numpy(rng.standard_normal((B, H, Lq, dk)).astype(np.float32))
    return q, k, v, pos, km, m, l, out, g


def _ds_float64(q, k, v, pos, km, m, l, g, dcap):
    """ds per batch row in float64: the plain arithmetic with exact sums
    (bf16 roundings of p for o, and of g, kept where the plain version
    has them)."""
    f64 = torch.float64
    s = torch.matmul(q.to(f64), k.to(f64).transpose(-1, -2))
    s = s + pos[None].to(f64) + km[:, None, None, :].to(f64)
    p = torch.exp(s - m.to(f64)[..., None]) / l.to(f64)[..., None]
    gc = g.to(torch.bfloat16).to(f64)
    if dcap is None:
        o = torch.matmul(p.to(torch.bfloat16).to(f64), v.to(f64))
        delta = (gc * o).sum(dim=-1)
    else:
        delta = dcap.to(f64)
    dp = torch.matmul(gc, v.to(f64).transpose(-1, -2))
    return p * (dp - delta[..., None])


# K4 (delta recomputed from o, bf16 g) and K2b (dcap given, fp32 g) at
# ragged shapes: lengths off the 64-row tiles, Lq != Lk, several dpos groups
@pytest.mark.parametrize("kernel,B,H,Lq,Lk,dk", [
    ("k4", 5, 2, 72, 72, 64), ("k4", 3, 3, 33, 33, 64),
    ("k2b", 5, 2, 72, 72, 64), ("k2b", 3, 2, 40, 100, 64),
])
def test_dpos_bound_holds_fp32_against_float64(kernel, B, H, Lq, Lk, dk):
    q, k, v, pos, km, m, l, out, g = _inputs(B * Lq + Lk, B, H, Lq, Lk, dk)
    if kernel == "k4":
        g = g.to(torch.bfloat16)
        dcap = None
        dpos = flash.attention_backward_plain(q, k, v, g, pos, km, m, l)[4]
    else:
        dcap = (g * out).sum(dim=-1)
        dpos = flash.flash_attention_backward_v2_plain(q, k, v, pos, km, m,
                                                       l, dcap, g)[3]
    exact = _ds_float64(q, k, v, pos, km, m, l, g, dcap).sum(dim=0)
    bound = flash.dpos_error_bound(q, k, v, g, pos, km, m, l, dcap)
    assert bound.shape == dpos.shape and bound.dtype == torch.float64
    err = (dpos.to(torch.float64) - exact).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    # and it is a bound, not a blanket: far below the values it bounds
    assert float(bound.max()) < 0.1 * float(exact.abs().max())


@pytest.mark.parametrize("kernel", ["k4", "k2b"])
def test_dpos_bound_fails_without_one_batch_row(kernel):
    """A dpos that lost one batch row's ds (a dropped group member) is
    outside the bound."""
    B, H, L, dk = 5, 2, 72, 64
    q, k, v, pos, km, m, l, out, g = _inputs(7, B, H, L, L, dk)
    dcap = None if kernel == "k4" else (g * out).sum(dim=-1)
    if kernel == "k4":
        g = g.to(torch.bfloat16)
    ds = _ds_float64(q, k, v, pos, km, m, l, g, dcap)
    bound = flash.dpos_error_bound(q, k, v, g, pos, km, m, l, dcap)
    for b in range(B):
        dropped = ds.sum(dim=0) - ds[b]
        assert bool(((dropped - ds.sum(dim=0)).abs() > bound).any()), b
