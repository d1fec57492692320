"""The embedding lookup's backward (``ops/embedding.py``) on the CPU: the
plain route against autograd through ``table[ids]``, its double backward,
and ``t5.embed_tokens``' tensor-parallel branch. The kernel route runs on
the card (``tests/test_torch_cuda.py``)."""

import types

import numpy as np
import pytest
import torch

from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.ops.embedding import (
    embedding_grad,
    embedding_lookup,
)

V, D = 96, 8


def _ids(case: str, rng: np.random.Generator) -> torch.Tensor:
    """Ids in [0, V / 2): the upper half of the table is never touched.
    About half of each (B, L) row is pad id 0, as in the benchmark's
    traffic; "long_run" holds a run of over 20k equal ids."""
    shape = {"BL": (6, 40), "B1": (9, 1), "long_run": (128, 188)}[
        case.split("-")[0]]
    ids = rng.integers(1, V // 2, size=shape)
    pad = rng.random(shape) < (0.9 if case.startswith("long_run") else 0.5)
    ids[pad] = 0
    dtype = torch.int32 if case.endswith("int32") else torch.int64
    return torch.from_numpy(ids).to(dtype)


CASES = ["BL-int64", "BL-int32", "B1-int64", "B1-int32", "long_run-int64"]


def _grads(table: torch.Tensor, ids: torch.Tensor, cot: torch.Tensor):
    """(the op's gradient, autograd's through ``table[ids]``)."""
    t1 = table.clone().requires_grad_(True)
    (embedding_lookup(t1, ids) * cot).sum().backward()
    t2 = table.clone().requires_grad_(True)
    (t2[ids.long()] * cot).sum().backward()
    return t1.grad, t2.grad


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_indexing_fp32(case):
    rng = np.random.default_rng(0)
    ids = _ids(case, rng)
    table = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32))
    cot = torch.from_numpy(
        rng.standard_normal((*ids.shape, D), dtype=np.float32))
    got, ref = _grads(table, ids, cot)
    assert got.dtype == torch.float32
    if case.startswith("long_run"):
        assert (ids == 0).sum() >= 20_000
    # 1e-6 of the sum of |terms|, the scale of a sum's order error (aten
    # adds the long run in another order)
    abs_sum = torch.zeros((V, D)).index_add_(
        0, ids.reshape(-1).long(), cot.reshape(-1, D).abs())
    assert ((got - ref).abs() <= 1e-6 * abs_sum).all()
    assert (got[V // 2:] == 0).all() and (ref[V // 2:] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_plain_bf16_is_one_rounding_of_the_fp32_sum(case):
    """bf16: each element is the fp32 sum rounded once (within the fp32
    sum's own order error), where aten's bf16 path rounds at every add."""
    rng = np.random.default_rng(1)
    ids = _ids(case, rng)
    table = torch.from_numpy(
        rng.standard_normal((V, D), dtype=np.float32)).bfloat16()
    cot = torch.from_numpy(rng.standard_normal(
        (*ids.shape, D), dtype=np.float32)).bfloat16()
    got, _ = _grads(table, ids, cot)
    assert got.dtype == torch.bfloat16
    exact = torch.zeros((V, D), dtype=torch.float64).index_add_(
        0, ids.reshape(-1).long(), cot.reshape(-1, D).double())
    abs_sum = torch.zeros((V, D), dtype=torch.float64).index_add_(
        0, ids.reshape(-1).long(), cot.reshape(-1, D).double().abs())
    # half a bf16 ulp (2^-8 relative) plus the fp32 sum's worst error
    n = torch.bincount(ids.reshape(-1).long(), minlength=V).double()[:, None]
    tol = 2.0**-8 * exact.abs() + n * 2.0**-24 * abs_sum * (1 + 2.0**-8)
    assert ((got.double() - exact).abs() <= tol).all()
    assert (got[V // 2:] == 0).all()


def test_grad_function_matches_index_put():
    rng = np.random.default_rng(2)
    ids = _ids("BL-int32", rng)
    g = torch.from_numpy(
        rng.standard_normal((*ids.shape, D), dtype=np.float32))
    ref = torch.zeros((V, D)).index_put_((ids.long(),), g, accumulate=True)
    assert torch.equal(embedding_grad(g, ids, V), ref)
    assert embedding_grad(g, ids, V).shape == (V, D)


@pytest.mark.parametrize("case", ["BL-int64", "B1-int32"])
def test_double_backward_matches_indexing(case):
    """create_graph=True through the gradient (the meta step's use): the
    op's second derivatives equal autograd's through ``table[ids]``."""
    rng = np.random.default_rng(3)
    ids = _ids(case, rng)
    table = torch.from_numpy(rng.standard_normal((V, D)))
    w = torch.from_numpy(rng.standard_normal((*ids.shape, D)))
    u = torch.from_numpy(rng.standard_normal((V, D)))
    x0 = torch.from_numpy(rng.standard_normal((*ids.shape, D)))

    def second(lookup):
        t = table.clone().requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        rows = lookup(t, ids)
        loss = ((rows * x) ** 2 * w).sum()
        (gt,) = torch.autograd.grad(loss, t, create_graph=True)
        (gt * u).sum().backward()
        return gt.detach(), t.grad, x.grad

    got = second(embedding_lookup)
    ref = second(lambda t, i: t[i.long()])
    for a, b in zip(got, ref):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rank", [0, 1])
def test_tensor_parallel_branch_keeps_its_gradient(monkeypatch, rank):
    """A rank holding half the vocab: the rows in its range get their
    gradient, the others' ids reach nothing (row 0 of the shard only
    through zeroed cotangents), as the branch gave through indexing."""
    rng = np.random.default_rng(4)
    ids = _ids("BL-int64", rng) + torch.from_numpy(
        rng.integers(0, 2, (6, 40)) * (V // 2))
    half = V // 2
    shard = torch.from_numpy(rng.standard_normal((half, D),
                                                 dtype=np.float32))
    cot = torch.from_numpy(
        rng.standard_normal((*ids.shape, D), dtype=np.float32))
    fake = types.SimpleNamespace(model=1, model_rank=rank)
    monkeypatch.setattr(t5, "model_split", lambda local, full: fake)
    cfg = types.SimpleNamespace(vocab_size=V)
    t1 = shard.clone().requires_grad_(True)
    out = t5.embed_tokens(t1, ids, cfg)
    (out * cot).sum().backward()
    # the branch as it was, through indexing
    t2 = shard.clone().requires_grad_(True)
    local = ids.long() - rank * half
    inside = (local >= 0) & (local < half)
    rows = t2[torch.where(inside, local, 0)]
    ref_out = torch.where(inside[..., None], rows, torch.zeros(()))
    (ref_out * cot).sum().backward()
    assert torch.equal(out, ref_out)
    assert torch.equal(t1.grad, t2.grad)
    # and the slice of the whole table's gradient
    whole = torch.zeros((V, D)).index_add_(0, ids.reshape(-1),
                                           cot.reshape(-1, D))
    assert torch.allclose(t1.grad, whole[rank * half:(rank + 1) * half],
                          rtol=1e-6, atol=1e-6)
