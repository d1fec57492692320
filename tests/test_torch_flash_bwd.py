"""Port of the attention-core backward kernels (K2a ``flash_attention_backward``
and K2b ``flash_attention_backward_v2``, pacednegatives_tpu/ops/flash.py):
the plain PyTorch versions against the JAX kernels in interpret mode, on the
same numpy inputs and the same (m, l, dcap)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import flash as jflash
from pacednegatives_tpu_torch.ops import flash as tflash

# torch.exp on the CPU hands contiguous fp32 to MKL's vector math, one
# chunk per OpenMP thread. In a fresh process under heavy CPU load, the
# first call sometimes computes one thread's chunk to ~1.5e-4 relative
# (seen in ~2% of fresh processes, the same inputs exact in the rest;
# later calls in the process exact): the rare failures of the fp32 parity
# tests here. One call over every thread at import, before any test,
# keeps that first call out of the comparisons.
torch.exp(torch.zeros(1 << 20))

# fp32 on both sides; the products differ only in summation order (depth
# <= 256 over terms up to ~10): within 1e-5 of each output's largest
# magnitude.
FP32_TOL = 1e-5
# bf16 q/k/v: K2b rounds p, g and ds to bf16 on both sides, and a value
# whose fp32 sums differ in the last bit may round one bf16 ulp apart
# (2^-8 relative); such flips feed the sums of dq/dk/dv and dpos. Four bf16
# ulps of each output's largest magnitude.
BF16_TOL = 4 * 2.0**-8


def _close(a, b, tol, name):
    """max |a - b| <= tol * max |b|."""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape, name
    err = np.abs(a - b).max()
    assert err <= tol * np.abs(b).max(), (name, err, np.abs(b).max())


def _case(B, H, Lq, Lk, dk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, dk)).astype(np.float32)
    k = rng.standard_normal((B, H, Lk, dk)).astype(np.float32)
    v = rng.standard_normal((B, H, Lk, dk)).astype(np.float32)
    pos = (rng.standard_normal((H, Lq, Lk)) * 0.3).astype(np.float32)
    lens = rng.integers(Lk // 2, Lk + 1, size=B)
    lens[0] = Lk
    key_mask = np.where(np.arange(Lk)[None] < lens[:, None], 0.0,
                        tflash.NEG_INF).astype(np.float32)
    g = rng.standard_normal((B, H, Lq, dk)).astype(np.float32)
    return q, k, v, pos, key_mask, g


def _stats(q, k, v, pos, key_mask, g):
    """(m, l, dcap) of the forward, in fp32 numpy: inputs that both sides
    take alike (the forward kernel is held to JAX on its own below and in
    tests/test_torch_flash.py)."""
    q, k, v = (np.asarray(a, dtype=np.float32) for a in (q, k, v))
    s = q @ k.swapaxes(-1, -2) + pos[None] + key_mask[:, None, None, :]
    m = s.max(axis=-1)
    e = np.exp(s - m[..., None])
    l = e.sum(axis=-1)
    dcap = np.sum(g * ((e / l[..., None]) @ v), axis=-1)
    return m, l, dcap


def _both(jfn, tfn, dtype, B, H, Lq, Lk, dk, seed):
    q, k, v, pos, key_mask, g = _case(B, H, Lq, Lk, dk, seed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    m, l, dcap = _stats(jq, jk, jv, pos, key_mask, g)
    want = jfn(jq, jk, jv, jnp.asarray(pos), jnp.asarray(key_mask),
               jnp.asarray(m), jnp.asarray(l), jnp.asarray(dcap),
               jnp.asarray(g), interpret=True)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = tfn(tq, tk, tv, *(torch.from_numpy(np.array(a))
                            for a in (pos, key_mask, m, l, dcap, g)))
    return got, [np.asarray(w) for w in want]


# Each case runs a Pallas kernel in interpret mode (~1.3 s of CPU whatever
# the shape): one Lq != Lk case per numerics and dtype, dk 128 once.
@pytest.mark.parametrize("dtype,Lq,Lk", [("fp32", 256, 128),
                                         ("bf16", 128, 128)])
def test_k2a_plain_matches_jax(dtype, Lq, Lk):
    """K2a multiplies fp32 operands: with bf16 q/k/v only the inputs are
    bf16, so both sides agree to fp32 summation order either way."""
    got, want = _both(jflash.flash_attention_backward,
                      tflash.flash_attention_backward_plain, dtype,
                      2, 2, Lq, Lk, 64, seed=Lq + (dtype == "bf16"))
    for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, want):
        assert a.dtype == torch.float32, name
        _close(a, b, FP32_TOL, name)


@pytest.mark.parametrize("Lq,Lk,dk", [(128, 256, 128)])
def test_k2b_plain_matches_jax_fp32(Lq, Lk, dk):
    """At fp32 q/k/v the K2b casts are to fp32 (no rounding), so K2b is
    K2a's arithmetic in another order."""
    got, want = _both(jflash.flash_attention_backward_v2,
                      tflash.flash_attention_backward_v2_plain, "fp32",
                      2, 2, Lq, Lk, dk, seed=Lq + Lk + dk)
    for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, want):
        assert a.dtype == torch.float32, name
        _close(a, b, FP32_TOL, name)


@pytest.mark.parametrize("Lq,Lk,dk", [(256, 128, 64), (128, 128, 128)])
def test_k2b_plain_matches_jax_bf16(Lq, Lk, dk):
    """bf16 q/k/v: bf16(p), bf16(g) and bf16(ds) as operands on both
    sides, fp32 outputs."""
    got, want = _both(jflash.flash_attention_backward_v2,
                      tflash.flash_attention_backward_v2_plain, "bf16",
                      2, 2, Lq, Lk, dk, seed=7 + Lq + dk)
    for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, want):
        assert a.dtype == torch.float32, name
        _close(a, b, BF16_TOL, name)


def test_k2b_rounds_where_k2a_does_not():
    """On bf16 inputs the two numerics differ by bf16 rounding of the
    operands, and only by that: close, but not equal."""
    q, k, v, pos, key_mask, g = _case(2, 2, 128, 128, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    m, l, dcap = _stats(*(jnp.asarray(a).astype(jnp.bfloat16)
                          for a in (q, k, v)), pos, key_mask, g)
    args = (tq, tk, tv, *(torch.from_numpy(np.array(a))
                          for a in (pos, key_mask, m, l, dcap, g)))
    a = tflash.flash_attention_backward_plain(*args)
    b = tflash.flash_attention_backward_v2_plain(*args)
    for name, x, y in zip(("dq", "dk", "dv", "dpos"), a, b):
        scale = x.abs().max().item()
        err = (x - y).abs().max().item()
        assert 0 < err <= BF16_TOL * scale, (name, err)


@pytest.mark.parametrize("H,Lq,Lk,dk", [
    (12, 512, 512, 64), (12, 640, 640, 64), (12, 768, 768, 64),
    (16, 512, 512, 128), (4, 256, 128, 64), (4, 188, 188, 64),
    (4, 128, 128, 32),
])
def test_flash_v2_eligible_matches_jax(H, Lq, Lk, dk):
    """The K2b / K2a choice is the JAX package's: at t5-base K2b up to
    L 640, K2a from L 768 (the resident estimate passes 48 MiB)."""
    assert tflash.flash_v2_eligible(H, Lq, Lk, dk) == \
        jflash.flash_v2_eligible(H, Lq, Lk, dk)


def test_forward_v2_is_the_forward_kernel():
    """K1b has no separate CUDA kernel: the name is the same wrapper (one
    launch counter), and its plain version matches the JAX v2 forward."""
    assert tflash.flash_attention_forward_v2 is tflash.flash_attention_forward
    q, k, v, pos, key_mask, _ = _case(2, 2, 128, 128, 64, seed=11)
    jo, jm, jl = jflash.flash_attention_forward_v2(
        *map(jnp.asarray, (q, k, v, pos, key_mask)), interpret=True,
        out_dtype=jnp.float32)
    to, tm, tl = tflash.flash_attention_forward_v2(
        *map(torch.from_numpy, (q, k, v, pos, key_mask)), torch.float32)
    for name, a, b in zip(("out", "m", "l"), (to, tm, tl), (jo, jm, jl)):
        _close(a, b, FP32_TOL, name)


def test_cpu_wrappers_run_the_plain_versions():
    """CPU tensors: the wrappers return the plain versions' results and
    launch nothing."""
    q, k, v, pos, key_mask, g = _case(2, 2, 128, 128, 64, seed=5)
    m, l, dcap = _stats(q, k, v, pos, key_mask, g)
    args = tuple(torch.from_numpy(np.array(a))
                 for a in (q, k, v, pos, key_mask, m, l, dcap, g))
    before = (tflash.flash_attention_backward.launches,
              tflash.flash_attention_backward_v2.launches)
    for fn, plain in ((tflash.flash_attention_backward,
                       tflash.flash_attention_backward_plain),
                      (tflash.flash_attention_backward_v2,
                       tflash.flash_attention_backward_v2_plain)):
        for a, b in zip(fn(*args), plain(*args)):
            assert torch.equal(a, b)
    assert (tflash.flash_attention_backward.launches,
            tflash.flash_attention_backward_v2.launches) == before
