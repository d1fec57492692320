"""The overlapped index refresh (train/overlap.py) in one process on the
CPU: the counterparts of the JAX package's tests/test_overlap.py:63-262.
The refresher's slices against the serial refresh bit for bit (fp32, and
int8 over several slices with a short last one), training with a refresh
in flight, the swap at the configured boundary, the start / collect /
discard protocol, ``split_devices``, and ``start()`` returning before the
refresh is done (its thread computes on the CPU). The same refresh on a
CUDA side stream is in tests/test_torch_cuda.py."""

import dataclasses
import time

import pytest
import torch

from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.train import (
    MetricWriter,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from pacednegatives_tpu_torch.train.online import (
    OnlineMiningConfig,
    OnlineMiningLoop,
    make_online_fused_step,
    make_refresh_fn,
)
from pacednegatives_tpu_torch.train.overlap import (
    OverlappedRefresher,
    split_devices,
)


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny model's ops gain nothing from intra-op threads, and their
    synchronisation dominates a step on a loaded machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(num_docs=48, quantize=False, rows_per_call=10**9):
    cfg = t5.T5Config.tiny(vocab_size=256)
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=num_docs, num_queries=12, seed=0)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=4, max_d_tokens=8)
    triples = TripletStore.synthetic(corpus, n_pairs=12, n_neg=4, seed=1)
    dc = DeviceCorpus.build(store, triples, device="cpu")
    params = t5.init_params(cfg, torch.Generator().manual_seed(0))
    mining = OnlineMiningConfig(pool_size=8, encode_batch=8,
                                quantize=quantize,
                                refresh_rows_per_call=rows_per_call)
    return cfg, tok, dc, params, mining


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantize,num_docs,rows_per_call", [
    (False, 48, 10**9), (True, 50, 16)])
def test_overlapped_refresh_matches_serial(quantize, num_docs, rows_per_call):
    """One slice in fp32, and int8 in four slices with a short last one:
    the same bits as make_refresh_fn (quantisation is per row)."""
    cfg, _, dc, params, mining = _setup(num_docs, quantize, rows_per_call)
    serial = make_refresh_fn(dc, cfg, mining)(params)
    ref = OverlappedRefresher(dc, cfg, mining)
    try:
        assert len(ref._slices) == (4 if quantize else 1)
        ref.start(params)
        _equal(ref.collect(), serial)
    finally:
        ref.close()


def _online(cfg, tok, dc, mining, steps):
    ctrl = EtaController(eta0=2.0, meta_lr=0.01, warmup_steps=1,
                         total_steps=steps)
    tx = make_optimizer(1e-3, total_steps=steps)
    step = make_train_step(cfg, ctrl, tx, loss="lce", n_neg_per_example=2,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    return ctrl, tx, make_online_fused_step(dc, step, ctrl, cfg, mining, 2)


def test_training_proceeds_with_refresh_in_flight():
    """A refresh started, two steps run and their losses read before
    collect(); the collected index is the refresh of the params it started
    with, not of the params the steps have since written."""
    cfg, tok, dc, params, mining = _setup()
    ctrl, tx, online = _online(cfg, tok, dc, mining, 8)
    state = init_train_state(t5.tree_map(torch.clone, params), tx,
                             ctrl.init())
    embeddings = make_refresh_fn(dc, cfg, mining)(params)
    ref = OverlappedRefresher(dc, cfg, mining)
    try:
        ref.start(state.params)
        assert ref.in_flight
        for _ in range(2):  # the first update runs at lr(0) = 0
            (state, embeddings), m = online((state, embeddings),
                                            torch.arange(6) % dc.num_pairs)
            assert torch.isfinite(m["loss"])
        assert ref.in_flight
        new = ref.collect()
        assert not ref.in_flight
        _equal(new, make_refresh_fn(dc, cfg, mining)(params))
        assert not torch.equal(
            new, make_refresh_fn(dc, cfg, mining)(state.params))
        (_, _), m2 = online((state, new), torch.arange(6) % dc.num_pairs)
        assert torch.isfinite(m2["loss"])
    finally:
        ref.close()


def _run_loop(cfg, tok, dc, params, mining, overlap=None, delay=1, steps=8):
    ctrl, tx, online = _online(cfg, tok, dc, mining, steps)

    def instrumented(carry, idx):
        carry, m = online(carry, idx)
        # a checksum of the index this step used: pins the swap's timing
        return carry, {**m, "index_sum": carry[1].sum()}

    loop = OnlineMiningLoop(
        fused_step=instrumented, refresh_fn=make_refresh_fn(dc, cfg, mining),
        num_pairs=dc.num_pairs, batch_size=4, chunk_size=2, refresh_every=4,
        log_mode="all", overlap=overlap, overlap_delay_chunks=delay)
    writer = MetricWriter(None)
    loop.run(init_train_state(t5.tree_map(torch.clone, params), tx,
                              ctrl.init()), steps, writer)
    return {r["step"]: r["index_sum"] for r in writer.history
            if "index_sum" in r}


def test_loop_swap_lands_at_configured_boundary():
    """refresh_every 4, chunks of 2, delay 1 chunk: the serial loop swaps at
    step 5, the overlapped one at step 7, to the same step-4 index."""
    cfg, tok, dc, params, mining = _setup(num_docs=32)
    s = _run_loop(cfg, tok, dc, params, mining)
    ref = OverlappedRefresher(dc, cfg, mining)
    try:
        o = _run_loop(cfg, tok, dc, params, mining, overlap=ref, delay=1)
        assert not ref.in_flight  # the last refresh was discarded
    finally:
        ref.close()
    for t in (1, 2, 3, 4):
        assert o[t] == s[t] == s[1]
    assert s[5] != s[4]
    assert o[5] == o[6] == o[1]
    assert o[7] == s[5]


def test_refresher_state_machine():
    """Double start and a bare collect raise; discard drops the work and a
    fresh start still collects the serial refresh."""
    cfg, _, dc, params, mining = _setup()
    serial = make_refresh_fn(dc, cfg, mining)(params)
    ref = OverlappedRefresher(dc, cfg, mining)
    try:
        with pytest.raises(RuntimeError):
            ref.collect()
        ref.start(params)
        assert ref.in_flight
        with pytest.raises(RuntimeError):
            ref.start(params)
        ref.discard()
        assert not ref.in_flight
        with pytest.raises(RuntimeError):
            ref.collect()
        ref.start(params)
        _equal(ref.collect(), serial)
        assert not ref.in_flight
    finally:
        ref.close()


def test_protocol_under_forced_thread_switches():
    """start / discard / start / collect, 12 rounds with the interpreter
    switching threads every microsecond: each collect is the serial refresh
    of the params its start was given (a stale or mixed buffer, or a
    discarded round's result, would not be)."""
    import sys

    cfg, _, dc, params, mining = _setup(num_docs=16)
    refresh = make_refresh_fn(dc, cfg, mining)
    ref = OverlappedRefresher(dc, cfg, mining)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(12):
            p = t5.tree_map(lambda x: x * (1.0 + 0.01 * i), params)
            ref.start(t5.tree_map(torch.neg, p))
            ref.discard()
            ref.start(p)
            _equal(ref.collect(), refresh(p))
    finally:
        sys.setswitchinterval(interval)
        ref.close()


def test_split_devices_validates():
    devices = [torch.device("cuda", i) for i in range(8)]
    with pytest.raises(ValueError):
        split_devices(devices[:4], 4)
    with pytest.raises(ValueError):
        split_devices(devices[:4], 0)
    tr, enc = split_devices(devices, 2)
    assert tr == devices[:6] and enc == devices[6:]


def test_start_returns_before_the_refresh_is_done():
    """start() snapshots the params and hands the encode to its thread: it
    returns in a small part of the refresh's own wall time (3,072 docs in
    192 batches of 16)."""
    cfg, _, dc, params, mining = _setup(num_docs=3072)
    mining = dataclasses.replace(mining, encode_batch=16)
    ref = OverlappedRefresher(dc, cfg, mining)
    try:
        t0 = time.perf_counter()
        ref.start(params)
        t_start = time.perf_counter() - t0
        ref.collect()
        t_refresh = time.perf_counter() - t0
    finally:
        ref.close()
    assert t_start < 0.5 * t_refresh, (t_start, t_refresh)
