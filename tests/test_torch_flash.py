"""Port of the attention core (K1): the plain PyTorch version against the
JAX package's Pallas kernels in interpret mode (v1 and v2), on the same
numpy inputs. The CUDA kernel itself is checked against the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.ops import flash as jflash
from pacednegatives_tpu_torch.ops import flash as tflash

# fp32 on both sides: the two differ only in summation order (the v1
# kernel's online softmax rescales per kv block), ~1e-6 at unit scale.
ATOL = 2e-5
RTOL = 1e-5


def _inputs(B, H, Lq, Lk, dk, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, dk)).astype(np.float32) * 0.5
    k = rng.normal(size=(B, H, Lk, dk)).astype(np.float32) * 0.5
    v = rng.normal(size=(B, H, Lk, dk)).astype(np.float32)
    pos = rng.normal(size=(H, Lq, Lk)).astype(np.float32)
    lens = rng.integers(Lk // 2, Lk + 1, size=B)
    mask = np.where(np.arange(Lk)[None] < lens[:, None], 0.0,
                    tflash.NEG_INF).astype(np.float32)
    return q, k, v, pos, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [  # (B, H, Lq, Lk, dk, q_block, kv_block)
    (2, 4, 16, 24, 8, 8, 8),
    (2, 2, 64, 128, 64, 32, 64),
    (1, 2, 128, 128, 128, 64, 32),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_v1(case):
    B, H, Lq, Lk, dk, qb, kb = case
    arrays = _inputs(B, H, Lq, Lk, dk)
    j_out, j_m, j_l = jflash.flash_attention_forward(
        *map(jnp.asarray, arrays), q_block=qb, kv_block=kb, interpret=True
    )
    t_out, t_m, t_l = tflash.flash_attention_forward_plain(*_torch(*arrays))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_v2(case):
    B, H, Lq, Lk, dk, qb, _ = case
    arrays = _inputs(B, H, Lq, Lk, dk, seed=1)
    j_out, j_m, j_l = jflash.flash_attention_forward_v2(
        *map(jnp.asarray, arrays), q_block=qb, interpret=True,
        out_dtype=jnp.float32,
    )
    t_out, t_m, t_l = tflash.flash_attention_forward_plain(
        *_torch(*arrays), out_dtype=torch.float32
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=RTOL)


def test_plain_matches_jax_v2_bf16():
    """bf16 operands: both round the unnormalised p to bf16 before P.V.
    Tolerance: a few bf16 ulps of the unit-scale output (2^-8 = 3.9e-3)."""
    arrays = _inputs(2, 2, 64, 64, 64, seed=2)
    q, k, v = (a.astype(jnp.bfloat16) for a in arrays[:3])
    j_out, j_m, j_l = jflash.flash_attention_forward_v2(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(arrays[3]), jnp.asarray(arrays[4]), q_block=32,
        interpret=True, out_dtype=jnp.float32,
    )
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    t_out, t_m, t_l = tflash.flash_attention_forward_plain(
        tq, tk, tv, *_torch(arrays[3], arrays[4]), out_dtype=torch.float32
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-2)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=1e-4)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=1e-4)


def test_reference_matches_jax_reference():
    arrays = _inputs(2, 3, 16, 24, 8, seed=3)
    j = jflash.flash_attention_reference(*map(jnp.asarray, arrays))
    t = tflash.flash_attention_reference(*_torch(*arrays))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_cpu_wrapper_runs_plain_version_into_strided_out():
    """On CPU tensors the wrapper is the plain version, writes through a
    transposed ``out`` view (K3's (B, L, H, dk) buffer) and launches
    nothing."""
    arrays = _torch(*_inputs(2, 3, 20, 20, 16, seed=4))
    before = tflash.flash_attention_forward.launches
    buf = torch.empty((2, 20, 3, 16))
    out, m, l = tflash.flash_attention_forward(*arrays,
                                               out=buf.transpose(1, 2))
    ref, rm, rl = tflash.flash_attention_forward_plain(*arrays)
    assert out.data_ptr() == buf.data_ptr()
    torch.testing.assert_close(buf.transpose(1, 2), ref, rtol=0, atol=0)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    torch.testing.assert_close(l, rl, rtol=0, atol=0)
    assert tflash.flash_attention_forward.launches == before


def test_statistics_reproduce_softmax():
    """(m, l) are the row max and the sum of exp(s - m), from numpy."""
    q, k, v, pos, mask = _inputs(2, 2, 16, 24, 8, seed=5)
    _, m, l = tflash.flash_attention_forward_plain(*_torch(q, k, v, pos, mask))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) + pos[None] + mask[:, None, None]
    np.testing.assert_allclose(m.numpy(), s.max(-1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        l.numpy(), np.exp(s - s.max(-1, keepdims=True)).sum(-1), rtol=1e-5
    )
