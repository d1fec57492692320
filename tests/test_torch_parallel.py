"""The port's multi-device layer in one process: ``parallel/mesh.py``'s
arithmetic and refusals against the JAX package's, the env contract of
``parallel/distributed.py``, and a gloo group of one rank on the CPU:
``merge_topk`` against ``lax.top_k`` on ties and signed zeros, the LCE step
and the sharded index under a ``data=1`` mesh bit for bit without one.
tests/test_torch_multiproc.py runs the same layer across ranks."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as W
from pacednegatives_tpu.parallel import MeshConfig as JMeshConfig
from pacednegatives_tpu_torch.distill.train import make_distill_step
from pacednegatives_tpu_torch.index import DenseIndex
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.parallel import (
    MeshConfig,
    batch_sharding,
    create_mesh,
    param_shardings,
    replicated,
    shard_batch,
)
from pacednegatives_tpu_torch.parallel import distributed
from pacednegatives_tpu_torch.parallel.collectives import (
    gather_batch,
    global_mean,
    merge_topk,
)
from pacednegatives_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    local_rows,
)
from pacednegatives_tpu_torch.train.step import make_meta_train_step


@pytest.mark.parametrize("config,n", [
    (dict(data=-1, model=2), 8), (dict(data=2, model=-1), 8),
    (dict(data=2, model=2, seq=2), 8), (dict(data=3, model=2), 8),
    (dict(data=-1, model=-1), 8), (dict(data=-1, seq=2), 4),
])
def test_mesh_resolution_matches_jax(config, n):
    """tests/test_mesh.py:19-27's cases (and a seq axis): the same shapes,
    the same errors."""
    try:
        want = JMeshConfig(**config).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            MeshConfig(**config).resolve(n)
    else:
        assert MeshConfig(**config).resolve(n) == want


def test_tensor_parallel_is_refused():
    """What stays refused under model > 1: DTensor placements
    (batch_sharding), the stacked layout's shardings, the meta and distill
    steps (no JAX entry point runs them under a mesh); flash_v3 refuses a
    mesh with a model axis as the JAX package does
    (tests/test_flash_v3.py:324); rows that do not split over data x seq
    raise."""
    with pytest.raises(NotImplementedError, match="plain tensors"):
        batch_sharding(Mesh(1, 1, 1, torch.device("cpu")), 3)
    tiny = t5.T5Config.tiny()
    tiny_params = t5.init_params(tiny, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="stacked"):
        param_shardings(Mesh(1, 1, 2, torch.device("cpu")),
                        t5.stack_params(tiny_params))
    with Mesh(1, 1, 2, torch.device("cpu")):
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            make_meta_train_step(tiny, None, None, lambda s: 0.0)
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            make_distill_step(tiny, None)
    cfg = t5.T5Config(vocab_size=256, d_model=64, d_kv=64, d_ff=128,
                      num_heads=2, num_layers=1, num_decoder_layers=1,
                      flash_v3=True, fused_qkv=True)
    params = t5.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.ones((4, 64), dtype=torch.int64)
    labels = torch.ones((4, 2), dtype=torch.int64)
    with Mesh(4, 1, 2, torch.device("cpu")):
        with pytest.raises(ValueError, match="tensor"):
            t5.forward_logits(params, cfg, ids, labels)
    with Mesh(2, 2, 1, torch.device("cpu"), row_rank=3) as mesh:
        assert current_mesh() is mesh
        assert torch.equal(local_rows(torch.arange(8)), torch.tensor([6, 7]))
        with pytest.raises(ValueError, match=r"rows \(6\) must divide the "
                           r"data\*seq shard count \(4\)"):
            local_rows(torch.arange(6))
    assert current_mesh() is None


def test_distributed_env_contract(monkeypatch):
    """Nothing named: no group (False). torchrun's variables: env://
    rendezvous, gloo on the CPU. A partial JAX-style contract and a missing
    NCCL raise; nothing switches backend on its own."""
    for key in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="together"):
        distributed.maybe_initialize_distributed("localhost:1234",
                                                 device="cpu")
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.maybe_initialize_distributed("localhost:1234", 2, 0,
                                                 backend="nccl",
                                                 device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert distributed.maybe_initialize_distributed(device="cpu")
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == "env://"
    assert (kw["world_size"], kw["rank"]) == (4, 3)
    assert kw["timeout"] == distributed.DEFAULT_TIMEOUT


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo group of one rank (file rendezvous) and its data=1 mesh."""
    path = tmp_path_factory.mktemp("rdv") / "rendezvous"
    assert distributed.maybe_initialize_distributed(f"file://{path}", 1, 0,
                                                     device="cpu")
    try:
        yield create_mesh(MeshConfig(data=1), "cpu")
    finally:
        dist.destroy_process_group()


def test_merge_topk_is_lax_top_k(one_rank):
    """Ties, signed zeros and -inf: merge_topk's order is lax.top_k's."""
    rng = np.random.default_rng(0)
    vals = rng.integers(-2, 3, size=(6, 40)).astype(np.float32)
    vals[vals == 0] = np.where(rng.random((vals == 0).sum()) < 0.5, -0.0, 0.0)
    vals[0, :5] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals), 17)
    with one_rank:
        v, i = merge_topk(torch.from_numpy(vals),
                          torch.arange(40).expand(6, 40), 17)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(np.signbit(v.numpy()),
                                  np.signbit(np.asarray(want_v)))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def test_collectives_and_placement_at_one_rank(one_rank):
    x = torch.arange(6.0).reshape(3, 2)
    with one_rank:
        assert torch.equal(gather_batch(x), x)
        assert global_mean(torch.tensor(2.5)).item() == 2.5
    put = shard_batch(one_rank, {"a": np.arange(4), "b": [np.ones((2, 3))]})
    assert torch.equal(put["a"], torch.arange(4))
    assert put["b"][0].shape == (2, 3)
    tree = replicated(one_rank, {"w": torch.ones(3)})
    assert torch.equal(tree["w"], torch.ones(3))


def test_step_and_index_at_data_1_bit_for_bit(one_rank):
    """Under a data=1 mesh the collectives are identities: an LCE step
    (negative parallel on) and the one-shard index give the bits of no
    mesh. One thread: the CPU's embedding backward sums its threads'
    parts in no fixed order, which moves the tied embedding's gradient by
    an ulp from run to run."""
    params = t5.init_params(W.CFG, torch.Generator().manual_seed(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = W.fused_steps(params)
        meshed = W.fused_steps(params, one_rank, negative_parallel=True)
    finally:
        torch.set_num_threads(threads)
    assert meshed["loss"] == plain["loss"] and meshed["eta"] == plain["eta"]
    for tree in ("params", "mu"):
        for name, val in plain[tree].items():
            assert torch.equal(meshed[tree][name], val), name
    rng = np.random.default_rng(1)
    docs = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    q = docs[:5] + 0.1
    for quantize in (False, True):
        a = DenseIndex.build(docs, quantize=quantize, device="cpu")
        b = DenseIndex.build(docs, quantize=quantize, mesh=one_rank,
                             device="cpu")
        for x, y in zip(a.topk(q, 7), b.topk(q, 7)):
            assert torch.equal(x, y)
        assert torch.equal(a.mine_pools(q, 7), b.mine_pools(q, 7))
