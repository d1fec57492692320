"""The port across processes: gloo ranks on the CPU, against one process
and against the JAX package's single device.

Four processes of ``tests/torch_parallel_worker.py`` form a group of 4
ranks, then two of them a group of 2, each through a ``file://``
rendezvous under the test's own directory (so that parallel test workers
never share a port), each rank with one thread. Meanwhile this process
computes the
references: the same cases in one process of the port (the same generator
draws, so the same batches) and JAX's single-device step on those batches
(test_sharding_equivalence.py's model, loss rtol 1e-5, parameters rtol
1e-4 / atol 1e-6), and JAX's sharded index on a data=2 mesh of the
virtual CPU devices. The ranks' collectives give up after the worker's
timeout, the processes are killed after ``SPAWN_TIMEOUT``.

Cases: dp2 and dp4 LCE steps, the dp2 x seq2 negative-parallel step and
scored-pool step, TrainLoop over 2 chunks with a checkpoint and a resume,
OnlineMiningLoop with a 2-shard index, the sharded DenseIndex (exact and
int8), merge_topk's ties across ranks, the refusal of rows that do not
split, and every rank's curriculum trajectory.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from pacednegatives_tpu.curriculum import EtaController as JEta
from pacednegatives_tpu.index import DenseIndex as JDenseIndex
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.parallel import MeshConfig as JMeshConfig
from pacednegatives_tpu.parallel import create_mesh as j_create_mesh
from pacednegatives_tpu.train import init_train_state as j_init_state
from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
from pacednegatives_tpu.train import make_train_step as j_make_train_step
from pacednegatives_tpu_torch.data import HashTokenizer
from pacednegatives_tpu_torch.models.convert import params_from_jax

# test_sharding_equivalence.py's tolerances against one device
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
SPAWN_TIMEOUT = 300  # seconds for a whole group, start-up included
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")


def _jax_cfg():
    return jt5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=256,
                        num_heads=4, num_layers=2, num_decoder_layers=2)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _spawn(work: str, *cases: str):
    """The 4 rank processes of the worker (``cases``: its case set)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(WORKER)),
         os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, WORKER, work, str(rank),
                              *cases],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for rank in range(4)]


def _wait(procs, work: str):
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=SPAWN_TIMEOUT)
            assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


_JAX_STEP = {}


def _jax_steps(jparams, batches):
    tok = HashTokenizer(vocab_size=512)
    ctrl = JEta(**W.CTRL)
    tx = j_make_optimizer(W.LR, total_steps=W.TOTAL, grad_clip=W.GRAD_CLIP)
    if not _JAX_STEP:  # one jitted step for every case: one compile
        _JAX_STEP["step"] = jax.jit(j_make_train_step(
            _jax_cfg(), ctrl, tx, loss="lce", n_neg_per_example=W.N_NEG,
            rel_id=tok.true_id, nrel_id=tok.false_id))
    step = _JAX_STEP["step"]
    state = j_init_state(jparams, tx, ctrl.init())
    losses = []
    for b in batches:
        jb = {k: jnp.asarray(v.numpy().astype(
            np.int32 if v.dtype == torch.int64 else v.numpy().dtype))
            for k, v in b.items()}
        state, m = step(state, jb)
        losses.append(float(m["loss"]))
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu"))
    flat = lambda t: {k: np.asarray(v) for k, v in
                      W.t5.flatten_params(jax.device_get(t)).items()}
    return losses, flat(state.params), flat(adam.mu)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jparams = jt5.init_params(jax.random.key(0), _jax_cfg())
    rng = np.random.default_rng(0)
    inputs = {"params": params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jparams)),
              "docs": torch.from_numpy(_unit(rng, 256, 32)),
              "queries": torch.from_numpy(_unit(rng, 8, 32))}
    work = str(tmp_path_factory.mktemp("ranks"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    procs = _spawn(work)
    threads = torch.get_num_threads()
    try:
        # the references, while the ranks run; one intra-op thread, as the
        # ranks have: the tiny model gains nothing from more
        torch.set_num_threads(1)
        params = inputs["params"]
        one, jax_ref = {}, {}
        for case, fn in (("dp", lambda b: W.fused_steps(params, batches=b)),
                         ("scored", lambda b: W.scored_steps(params,
                                                             batches=b))):
            batches = []
            one[case] = fn(batches)
            jax_ref[case] = _jax_steps(jparams, batches)
        one["loop"] = W.train_loop(
            params, str(tmp_path_factory.mktemp("loop_one")))
        one["online"] = W.online_loop(params)
        mesh = j_create_mesh(JMeshConfig(data=2, model=1),
                             jax.devices()[:2])
        jax_ref["index"] = {}
        for quantize in (False, True):
            index = JDenseIndex.build(jnp.asarray(inputs["docs"].numpy()),
                                      method="exact", mesh=mesh,
                                      quantize=quantize)
            jax_ref["index"]["int8" if quantize else "fp32"] = [
                np.asarray(x) for x in jax.jit(lambda q: index.topk(q, 10))(
                    jnp.asarray(inputs["queries"].numpy()))]
    finally:
        torch.set_num_threads(threads)
        outs = _wait(procs, work)
    return {4: outs, 2: outs[:2]}, one, jax_ref


def _close_params(got: dict, want: dict, msg: str):
    assert set(got) == set(want)
    for key, val in got.items():
        np.testing.assert_allclose(np.asarray(val), np.asarray(want[key]),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{msg} {key}")


def _same_on_every_rank(outs: list, keys=("loss", "eta", "difficulty")):
    for out in outs[1:]:
        for key in keys:
            assert out[key] == outs[0][key], key
        for tree in ("params", "mu"):
            for name, val in out[tree].items():
                assert torch.equal(val, outs[0][tree][name]), name


@pytest.mark.parametrize("world,case", [(2, "dp2"), (4, "dp4"), (4, "np")])
def test_dp_step_matches_one_process_and_jax(runs, world, case):
    """Plain dp over 2 and 4 ranks and dp2 x seq2 negative parallelism: the
    step equals one process's on the same draws, and JAX's single device on
    the same batch. The first moment ``mu`` is 0.1 x the unclipped global
    gradient, so a gradient off by any factor fails here."""
    ranks, one, jax_ref = runs
    outs = [r[case] for r in ranks[world]]
    _same_on_every_rank(outs)
    got = outs[0]
    jax_losses, jax_params, jax_mu = jax_ref["dp"]
    np.testing.assert_allclose(got["loss"], one["dp"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], jax_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eta"], one["dp"]["eta"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["neg_rank"], one["dp"]["neg_rank"],
                               rtol=1e-6)
    for tree, want in (("params", jax_params), ("mu", jax_mu)):
        _close_params(got[tree], one["dp"][tree], f"one process {tree}")
        _close_params(got[tree], want, f"jax {tree}")


def test_scored_pool_negative_parallel_dp2_seq2(runs):
    """The scored-pool step with its scoring rows and its batch over
    dp2 x seq2 (test_scored_pool.py:183 without tp): every rank selects the
    one process's negatives, and the step equals JAX's on that batch."""
    ranks, one, jax_ref = runs
    outs = [r["scored"] for r in ranks[4]]
    _same_on_every_rank(outs, keys=("loss", "eta", "neg_rank",
                                    "neg_rank_static"))
    got = outs[0]
    assert got["neg_rank"] == pytest.approx(one["scored"]["neg_rank"],
                                            rel=1e-6)
    assert got["neg_rank_static"] == pytest.approx(
        one["scored"]["neg_rank_static"], rel=1e-6)
    jax_losses, jax_params, jax_mu = jax_ref["scored"]
    np.testing.assert_allclose(got["loss"], one["scored"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], jax_losses, rtol=LOSS_RTOL)
    for tree, want in (("params", jax_params), ("mu", jax_mu)):
        _close_params(got[tree], one["scored"][tree], f"one process {tree}")
        _close_params(got[tree], want, f"jax {tree}")


def test_trainloop_dp2_rows_and_resume(runs):
    """TrainLoop at dp2 over 2 chunks logs (rank 0 only) the one process's
    rows, and a resume from the first chunk's checkpoint, read on every
    rank, ends on the uninterrupted run's weights bit for bit."""
    ranks, one, _ = runs
    outs = [r["loop"] for r in ranks[2]]
    assert [len(o["rows"]) for o in outs] == [2, 0]
    rows, ref = outs[0]["rows"], one["loop"]["rows"]
    assert [r["step"] for r in rows] == [r["step"] for r in ref]
    for key in ("loss", "eta", "difficulty", "neg_rank", "success_rate"):
        np.testing.assert_allclose([r[key] for r in rows],
                                   [r[key] for r in ref], rtol=LOSS_RTOL,
                                   err_msg=key)
    for out in outs:
        for name, val in out["params"].items():
            assert torch.equal(out["resumed"][name], val), name
            assert torch.equal(outs[0]["params"][name], val), name
    _close_params(outs[0]["params"], one["loop"]["params"], "one process")
    _close_params(outs[0]["mu"], one["loop"]["mu"], "one process mu")


def test_online_loop_two_shards(runs):
    """OnlineMiningLoop at dp2 with the index in two shards: each rank
    encodes its 32 docs (together the one process's index), and the steps,
    with a refresh after the first chunk, log the one process's losses."""
    ranks, one, _ = runs
    outs = [r["online"] for r in ranks[2]]
    torch.testing.assert_close(torch.cat([o["shard"] for o in outs]),
                               one["online"]["shard"], rtol=1e-5, atol=1e-6)
    assert len(outs[0]["rows"]) == W.ONLINE_STEPS and not outs[1]["rows"]
    assert len(outs[0]["refresh_rows"]) == 2
    np.testing.assert_allclose([r["loss"] for r in outs[0]["rows"]],
                               [r["loss"] for r in one["online"]["rows"]],
                               rtol=LOSS_RTOL)
    assert outs[0]["difficulty"] == outs[1]["difficulty"]
    for name, val in outs[1]["params"].items():
        assert torch.equal(outs[0]["params"][name], val), name
    # Adam steps: a gradient entry near zero normalises to an update
    # of up to the learning rate whose sign its rounding sets, so a few
    # weights may move apart by up to 2 x lr a step; the rest stay within
    # the one-step tolerances
    got = torch.cat([v.reshape(-1) for v in outs[0]["params"].values()])
    want = torch.cat([one["online"]["params"][k].reshape(-1)
                      for k in outs[0]["params"]])
    off = (got - want).abs() > PARAM_ATOL + PARAM_RTOL * want.abs()
    assert off.float().mean().item() < 1e-3
    assert (got - want).abs().max().item() <= 2 * W.LR * W.ONLINE_STEPS


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_sharded_index_matches_jax(runs, kind):
    """DenseIndex over 2 ranks (exact top-k; int8 through the streaming
    path) against JAX's index sharded over data=2 (test_index.py:75, 161):
    the same doc indices, the values at fp32 rounding, on both ranks."""
    ranks, _, jax_ref = runs
    want_v, want_i = jax_ref["index"][kind]
    for r in ranks[2]:
        v, i = r["index"][kind]
        np.testing.assert_array_equal(i.numpy(), want_i)
        np.testing.assert_allclose(v.numpy(), want_v, rtol=1e-5, atol=1e-6)


def test_merge_topk_ties_across_ranks(runs):
    """merge_topk over 2 ranks is lax.top_k on the shard-major
    concatenation: equal values to the lower global row, -0 below +0."""
    ranks, _, _ = runs
    vals = np.concatenate([np.asarray(W.MERGE_VALUES[r], np.float32)
                           for r in (0, 1)], axis=1)
    want_v, want_pos = jax.lax.top_k(jnp.asarray(vals), 4)
    for r in ranks[2]:
        v, i = r["merge_ties"]
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_pos))
        np.testing.assert_array_equal(np.signbit(v.numpy()),
                                      np.signbit(np.asarray(want_v)))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def test_rows_must_divide_the_row_group(runs):
    ranks, _, _ = runs
    for r in ranks[2]:
        assert "must divide the data*seq shard count (2)" in r["rows_error"]


def test_curricula_identical_on_every_rank(runs):
    """Every rank's eta and difficulty trajectories, in every case, equal
    rank 0's bit for bit: the curriculum state never drifts."""
    ranks, _, _ = runs
    for world, cases in ((2, ("dp2",)), (4, ("dp4", "np", "scored"))):
        outs = ranks[world]
        for case in cases:
            for o in outs[1:]:
                assert o[case]["eta"] == outs[0][case]["eta"], case
                assert o[case]["difficulty"] == outs[0][case]["difficulty"]
    loop = [r["loop"]["eta"] for r in ranks[2]]
    assert loop[0] == loop[1]
