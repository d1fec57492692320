"""The port's DenseIndex (pacednegatives_tpu_torch/index/dense.py) against
the JAX package's on one device, on the CPU: build, topk, mine_pools and
refreshed, fp32 and int8-quantised, with the exact and the blockwise
(Pallas in interpret mode on the JAX side, the plain version on the port's)
methods."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.index import DenseIndex as JDenseIndex
from pacednegatives_tpu_torch.index import DenseIndex
from pacednegatives_tpu_torch.parallel.mesh import Mesh

# blockwise tiling small enough for 2048 docs: 8 blocks, k' below k
KW = {"block_n": 256, "k_per_block": 8}


@functools.cache
def _data():
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(2048, 64)).astype(np.float32)
    queries = rng.normal(size=(8, 64)).astype(np.float32)
    return queries, docs


def _pair(method: str, quantize: bool, docs=None):
    q, d = _data()
    d = d if docs is None else docs
    kw = KW if method == "pallas" else {}
    jix = JDenseIndex.build(jnp.asarray(d), method=method, quantize=quantize,
                            **({**kw, "interpret": True} if kw else {}))
    tix = DenseIndex.build(torch.from_numpy(d), method=method,
                           quantize=quantize, device="cpu", **kw)
    return jix, tix, q


def _same(jout, tout, rtol=1e-5):
    (jv, ji), (tv, ti) = jout, tout
    assert ti.dtype == torch.int64
    jv = np.asarray(jv)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0,
                               atol=rtol * np.abs(jv).max())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# exact on fp32, the blockwise K5 route, the streaming route of a quantised
# index and K6's route (plain on the CPU)
@pytest.mark.parametrize("method,quantize", [
    ("exact", False), ("pallas", False), ("exact", True), ("pallas", True),
])
def test_build_and_topk_match_jax(method, quantize):
    jix, tix, q = _pair(method, quantize)
    assert tix.quantized == quantize and tix.num_docs == 2048
    if quantize:
        assert tix.embeddings.dtype == torch.int8
        np.testing.assert_array_equal(tix.embeddings.numpy(),
                                      np.asarray(jix.embeddings))
        np.testing.assert_array_equal(tix.scales.numpy(),
                                      np.asarray(jix.scales))
    _same(jix.topk(jnp.asarray(q), 10), tix.topk(torch.from_numpy(q), 10))


@pytest.mark.parametrize("quantize", [False, True])
def test_mine_pools_easiest_first_matches_jax(quantize):
    jix, tix, q = _pair("exact", quantize)
    pools = tix.mine_pools(torch.from_numpy(q), 20)
    np.testing.assert_array_equal(
        pools.numpy(), np.asarray(jix.mine_pools(jnp.asarray(q), 20)))
    _, top = tix.topk(torch.from_numpy(q), 20)
    assert torch.equal(pools, top.flip(1))  # pool[-1] is the hardest


@pytest.mark.parametrize("quantize", [False, True])
def test_refreshed_matches_jax(quantize):
    jix, tix, q = _pair("exact", quantize)
    d2 = np.roll(_data()[1], 1, axis=0)
    jix2 = jix.refreshed(jnp.asarray(d2))
    tix2 = tix.refreshed(torch.from_numpy(d2))
    assert tix2 is not tix and tix2.quantized == quantize
    _same(jix2.topk(jnp.asarray(q), 5), tix2.topk(torch.from_numpy(q), 5))
    # the old index stays valid, and the roll moves every hit by one row
    _, i1 = tix.topk(torch.from_numpy(q), 5)
    _, i2 = tix2.topk(torch.from_numpy(q), 5)
    assert torch.equal((i1 + 1) % 2048, i2)
    # one contract: the index's own row count (a rank's shard under a mesh)
    with pytest.raises(ValueError, match="refreshed takes"):
        tix.refreshed(torch.from_numpy(d2[:1024]))


def test_mesh_and_approx_are_not_ported():
    """The sharded index is ported (tests/test_torch_multiproc.py runs it
    across ranks): a shard count that does not divide the docs raises, a
    one-rank mesh holds every row. ``method="approx"`` is not carried
    over."""
    d = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="shard evenly"):
        DenseIndex.build(d, mesh=Mesh(3, 1, 1, torch.device("cpu")),
                         device="cpu")
    one = DenseIndex.build(d, mesh=Mesh(1, 1, 1, torch.device("cpu")),
                           device="cpu")
    assert one.num_docs == one.shard_docs == 16
    with pytest.raises(NotImplementedError, match="approx"):
        DenseIndex.build(d, method="approx", device="cpu").topk(d[:2], 3)


def test_build_defaults_to_cuda_without_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseIndex.build(torch.zeros((16, 8)))
