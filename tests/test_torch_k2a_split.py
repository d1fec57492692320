"""K2a's split arithmetic (csrc/t5_attention_bwd_fp32.cu): every fp32
operand (g, p, ds) as three bf16 terms, products as sums of bf16 products.

The kernel runs only on the card; here its split (``ops.flash.split_bf16``,
the plain version of the kernel's) is checked on its own, and the kernel's
products are emulated in float64 from the bf16 terms, with dV's dropped
cross terms left out, against exact products of the same fp32 operands and
against ``flash_attention_backward_plain``."""

import os
import sys

import numpy as np
import pytest
import torch

from pacednegatives_tpu_torch.ops import flash

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import k2a_exact_probe  # noqa: E402

# The source header's error for three terms, per output element, as a
# fraction of sum |a| |b| over the product's depth: dP, dQ, dK exact (the
# terms hold each fp32 operand exactly), dV at most 2^-23 (1 + 2^-8) from
# the dropped p1 g2 + p2 g1 + p2 g2. EMU_SLACK covers the float64
# emulation's own rounding.
DV_DROPPED = 2.0**-23 * (1 + 2.0**-8)
EMU_SLACK = 2.0**-40
# The kernel is held to 1e-4 of each output's largest magnitude; the split
# has to sit well inside that, here 64x inside, against the plain version
# (whose own fp32 sums differ from exact by ~4e-7 at this shape).
WELL_INSIDE = 1e-4 / 64


def _values(kind: str, n: int = 20_000) -> torch.Tensor:
    rng = np.random.default_rng(len(kind))
    sign = rng.choice([-1.0, 1.0], n)
    if kind == "normal":  # |x| in [2^-110, 2^120]: exponents over the range
        x = sign * 2.0 ** rng.uniform(-110, 120, n) * rng.uniform(1, 2, n)
    elif kind == "tiny":  # below 2^-110, fp32 subnormals included
        x = sign * 2.0 ** rng.uniform(-149, -110, n)
    else:
        x = sign * 0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "tiny", "zero"])
def test_three_terms_sum_back_to_x(kind):
    """Three bf16 terms hold an fp32 value of magnitude >= 2^-110 exactly
    (within 2^-24 relative is the claim; the sum is in fact x); below that,
    bf16's subnormal spacing leaves at most 2^-134 absolute (where the
    kernel's p sits, under 2^-126, ex2.approx.ftz has already flushed it to
    0). Zeros stay zero."""
    x = _values(kind)
    terms = flash.split_bf16(x, terms=3)
    assert len(terms) == 3 and all(t.dtype == torch.bfloat16 for t in terms)
    err = (sum(t.double() for t in terms) - x.double()).abs()
    if kind == "normal":
        assert bool((err <= 2.0**-24 * x.double().abs()).all())
        assert bool((err == 0).all())
    elif kind == "tiny":
        assert float(err.max()) <= 2.0**-134
    else:
        assert all(bool((t == 0).all()) for t in terms)
    # each term is the rounding of what the earlier ones leave
    assert torch.equal(terms[0], x.to(torch.bfloat16))


def test_two_terms_leave_a_residual():
    """Two terms leave x - x0 - x1, up to 2^-16 |x| (seen here: 2^-17),
    where three leave none: the third term is needed."""
    x = _values("normal")
    err = (sum(t.double() for t in flash.split_bf16(x, terms=2))
           - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0**-16
    assert float(err.max()) > 2.0**-20


def _inputs():
    """A ragged shape (Lq 70, Lk 90, three batch rows, keys masked past 61
    and 17 in two of them), bf16 q/k/v, fp32 g; (m, l) and dcap from the
    plain forward."""
    rng = np.random.default_rng(0)
    B, H, Lq, Lk, dk = 3, 2, 70, 90, 64
    bf = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
    q, k, v = bf(B, H, Lq, dk), bf(B, H, Lk, dk), bf(B, H, Lk, dk)
    pos = torch.from_numpy(
        (rng.standard_normal((H, Lq, Lk)) * 0.5).astype(np.float32))
    lens = np.array([Lk, 61, 17])
    key_mask = torch.from_numpy(np.where(
        np.arange(Lk)[None] < lens[:, None], 0.0, flash.NEG_INF
    ).astype(np.float32))
    out, m, l = flash.flash_attention_forward_plain(q, k, v, pos, key_mask,
                                                    torch.float32)
    g = torch.from_numpy(rng.standard_normal((B, H, Lq, dk)).astype(np.float32))
    dcap = (g * out).sum(dim=-1)
    return q, k, v, pos, key_mask, m, l, dcap, g


def _emulate(args, terms: int) -> dict:
    """K2a's products in float64 from ``terms`` bf16 terms of g, p and ds
    (dV over the pairs i + j < terms), each beside the exact float64
    product of the same fp32 operands and sum |a| |b| over its depth. p and
    ds are the fp32 values the kernel holds (ds from the split dP)."""
    q, k, v, pos, key_mask, m, l, dcap, g = args
    f64 = lambda t: t.double()
    tr = lambda t: t.transpose(-1, -2)
    split = lambda t: [f64(x) for x in flash.split_bf16(t, terms)]
    p = flash._probs(q, k, pos, key_mask, m, l)
    qd, kd, vd, gd, pd = f64(q), f64(k), f64(v), f64(g), f64(p)
    gs, ps = split(g), split(p)
    dp = sum(x @ tr(vd) for x in gs)
    ds = (pd * (dp - f64(dcap)[..., None])).float()
    dsd, dss = f64(ds), split(ds)
    return {
        "dp": (dp, gd @ tr(vd), gd.abs() @ tr(vd.abs())),
        "dq": (sum(x @ kd for x in dss), dsd @ kd, dsd.abs() @ kd.abs()),
        "dk": (sum(tr(x) @ qd for x in dss), tr(dsd) @ qd,
               tr(dsd.abs()) @ qd.abs()),
        "dv": (sum(tr(ps[i]) @ gs[j] for i in range(terms)
                   for j in range(terms - i)), tr(pd) @ gd, tr(pd) @ gd.abs()),
        "dpos": (dsd.sum(dim=0),),
    }


def _over_bound(emu: dict) -> dict:
    """max over elements of |split - exact| / (the stated bound)."""
    out = {}
    for name in ("dp", "dq", "dk", "dv"):
        got, exact, mass = emu[name]
        tol = (DV_DROPPED if name == "dv" else 0.0) + EMU_SLACK
        out[name] = float(((got - exact).abs()
                           / (tol * mass).clamp_min(1e-300)).max())
    return out


def _vs_plain(emu: dict, args) -> dict:
    """max |emulated - plain| / max |plain| for dq, dk, dv, dpos."""
    ref = flash.flash_attention_backward_plain(*args)
    return {name: float((emu[name][0] - r.double()).abs().max()
                        / r.double().abs().max())
            for name, r in zip(("dq", "dk", "dv", "dpos"), ref)}


def test_split_products_match_exact_and_plain():
    """Three terms: each product within the header's stated error of the
    exact product (dP, dQ, dK exact; dV within its dropped terms), and
    dq / dk / dv / dpos within 1e-4 / 64 of the plain version, at a ragged
    shape with masked keys."""
    args = _inputs()
    emu = _emulate(args, terms=3)
    assert max(_over_bound(emu).values()) <= 1.0
    assert max(_vs_plain(emu, args).values()) <= WELL_INSIDE


def test_two_term_split_fails_the_margin():
    """Two terms leave up to 2^-16 of every operand out: every product
    exceeds the three-term bound, and the outputs leave the 1e-4 / 64
    margin. So the test above can fail."""
    args = _inputs()
    emu = _emulate(args, terms=2)
    assert min(_over_bound(emu).values()) > 1.0
    assert max(_vs_plain(emu, args).values()) > WELL_INSIDE


@pytest.mark.parametrize("dk", [64, 128])
def test_exact_probe_separates_three_terms_from_two(dk):
    """chip_smoke.py's on-card probe (``k2a_exact_probe``) at its shape:
    the plain version, exact float64 products and the three-term emulation
    agree bit for bit (so the kernel is held to equality there), and the
    two-term emulation misses in every output (so that check can fail)."""
    args = k2a_exact_probe(5, 2, 70, 768, dk, "cpu",
                           torch.Generator().manual_seed(dk))
    plain = flash.flash_attention_backward_plain(*args)
    three, two = _emulate(args, terms=3), _emulate(args, terms=2)
    for name, r in zip(("dq", "dk", "dv", "dpos"), plain):
        assert float(r.abs().max()) > 1.0, name
        assert torch.equal(three[name][0], r.double()), name
        if name != "dpos":
            assert torch.equal(three[name][1], r.double()), name
        assert float((two[name][0] - r.double()).abs().max()) >= 2.0**-18, name
