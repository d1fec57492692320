"""The port's spans and counters (``utils/profiling.py``) on the CPU: off
without a profiler, on under ``torch.profiler`` (whose CPU recording sets
the same flag as on the card), the span tree of a tiny ``TrainLoop``, the
``pnt.*`` events in the exported Chrome trace, self times by hand, and the
host-sync and padding counts of ``Reranker`` and of a scored-pool step
against what their plans imply."""

import json

import numpy as np
import pytest
import torch

from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import (
    DeviceCorpus,
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
    TripletStore,
)
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.train import (
    TrainLoop,
    init_train_state,
    make_fused_step,
    make_optimizer,
    make_train_step,
)
from pacednegatives_tpu_torch.train.loop import MetricWriter
from pacednegatives_tpu_torch.train.scored_pool import make_scored_pool_step
from pacednegatives_tpu_torch.utils import profiling

# the encoder's self-attention through the fused block (its plain version
# on the CPU): prompts of L >= 64
CFG = tt5.T5Config(vocab_size=256, d_model=128, d_kv=64, d_ff=256,
                   num_heads=2, num_layers=1, num_decoder_layers=1,
                   flash_v3=True, fused_qkv=True)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def data():
    tok = HashTokenizer(vocab_size=256)
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(120)]
    docs = [" ".join(rng.choice(words, size=n))
            for n in rng.integers(4, 48, size=24)]
    queries = [" ".join(rng.choice(words, size=n))
               for n in rng.integers(2, 8, size=8)]
    corpus = TextCorpus([f"d{i}" for i in range(len(docs))], docs,
                        [f"q{i}" for i in range(len(queries))], queries)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8,
                                 max_d_tokens=60)
    triples = TripletStore.synthetic(corpus, n_pairs=8, n_neg=6, seed=1)
    return tok, corpus, store, triples


def _controller():
    return EtaController(eta0=2.0, meta_lr=0.05, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=3.0)


def _loop(data, scored=False):
    tok, _, store, triples = data
    ctrl = _controller()
    tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=1)
    params = tt5.init_params(CFG, torch.Generator().manual_seed(0))
    state = init_train_state(params, tx, ctrl.init(), seed=0)
    tc = DeviceCorpus.build(store, triples, device="cpu", packed=scored)
    step = make_train_step(CFG, ctrl, tx, loss="lce", n_neg_per_example=2,
                           rel_id=tok.true_id, nrel_id=tok.false_id)
    if scored:
        fused = make_scored_pool_step(
            tc, step, ctrl, CFG, n_neg_per_example=2, candidates=4,
            rel_id=tok.true_id, nrel_id=tok.false_id, score_chunk_rows=4,
            score_buckets=(32,))
    else:
        fused = make_fused_step(tc, step, ctrl, loss="lce",
                                n_neg_per_example=2)
    loop = TrainLoop(fused, num_pairs=len(triples), batch_size=2,
                     chunk_size=2, corpus=tc, log_mode="all")
    return state, loop, tc


def test_nothing_is_recorded_without_a_profiler(data):
    a, b = profiling.span("pnt.a", 1), profiling.span("pnt.b")
    assert a is b and profiling.host_sync("x") is a
    assert not profiling.recording()
    with a:
        profiling.count("c")
    state, loop, _ = _loop(data)
    loop.run(state, 2)
    assert profiling.recorded() == {"spans": [], "counts": {}}


def test_spans_are_off_while_the_profiler_warms_up():
    seen = []
    with torch.profiler.profile(
            activities=CPU,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) \
            as prof:
        seen.append(profiling.recording())
        with profiling.span("pnt.warm"):
            profiling.count("warm")
        prof.step()
        seen.append(profiling.recording())
        with profiling.span("pnt.active"):
            profiling.count("active")
        prof.step()
    assert seen == [False, True]
    rec = profiling.recorded()
    assert [s["name"] for s in rec["spans"]] == ["pnt.active"]
    assert rec["counts"] == {"active": 1}


def _syncs(rec):
    """{site: its pnt.sync spans}"""
    out = {}
    for s in rec["spans"]:
        if s["name"].startswith("pnt.sync."):
            site = s["name"][len("pnt.sync."):]
            out[site] = out.get(site, 0) + 1
    return out


def test_loop_records_the_span_tree(data, tmp_path):
    state, loop, _ = _loop(data)
    writer = MetricWriter(None)
    with torch.profiler.profile(activities=CPU) as prof:
        loop.run(state, 4, writer)
    rec = profiling.recorded()
    spans = rec["spans"]
    names = [s["name"] for s in spans]
    parent = lambda s: (None if s["parent"] is None
                        else spans[s["parent"]]["name"])
    (run,) = [s for s in spans if s["name"] == "pnt.loop.run"]
    assert parent(run) is None and run["id"] is None
    chunks = [s for s in spans if s["name"] == "pnt.loop.chunk"]
    assert [c["id"] for c in chunks] == [0, 2]
    assert all(parent(c) == "pnt.loop.run" for c in chunks)
    steps = [s for s in spans if s["name"] == "pnt.step"]
    assert [s["id"] for s in steps] == [0, 1, 2, 3]
    assert [spans[s["parent"]]["id"] for s in steps] == [0, 0, 2, 2]
    assert all(parent(s) == "pnt.loop.chunk" for s in steps)
    for part in ("sample", "prepare", "fwd_bwd", "optimizer", "curriculum"):
        got = [s for s in spans if s["name"] == f"pnt.step.{part}"]
        assert [s["id"] for s in got] == [0, 1, 2, 3], part
        assert all(parent(s) == "pnt.step" for s in got)
    # the encoder's fused attention block, one a layer a step
    assert all(parent(s) == "pnt.step.fwd_bwd"
               for s in spans if s["name"] == "pnt.attn")
    assert names.count("pnt.attn") == 4 * CFG.num_layers
    reads = [s for s in spans if s["name"] == "pnt.loop.read_metrics"]
    assert [parent(s) for s in reads] == ["pnt.loop.chunk"] * 2
    assert all(s["end_ns"] >= s["start_ns"] and 0 <= s["self_ns"]
               <= s["dur_ns"] for s in spans)
    # a chunk uploads its pair indices and reads each metric back; a step
    # uploads its two label rows, the draw's binomial n and the two
    # verbalizer columns of its curriculum signals
    keys = set(writer.history[0]) - {"step", "steps_per_sec"}
    assert _syncs(rec) == {"loop.pair_idx": 2, "loop.metrics": 2,
                           "corpus.labels": 8, "sampling.n": 4,
                           "monot5.pair": 8}
    assert rec["counts"] == {"host_syncs": 2 * (1 + len(keys)) + 4 * 5}
    # the Chrome trace holds the same spans as record_function scopes
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    traced = [e["name"] for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("pnt.")]
    assert sorted(traced) == sorted(names)


def test_self_time_by_hand(monkeypatch):
    ticks = iter([0, 10, 30, 40, 45, 100])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with torch.profiler.profile(activities=CPU):
        with profiling.span("pnt.a", 7):
            with profiling.span("pnt.b"):
                pass
            with profiling.span("pnt.c", 8):
                pass
    a, b, c = profiling.recorded()["spans"]
    assert (a["dur_ns"], a["self_ns"]) == (100, 100 - 20 - 5)
    assert (b["dur_ns"], b["self_ns"], b["id"], b["parent"]) == (20, 20, 7, 0)
    assert (c["dur_ns"], c["self_ns"], c["id"], c["parent"]) == (5, 5, 8, 0)
    assert a["parent"] is None


def test_step_timer_sections_are_spans():
    timer = profiling.StepTimer()
    with torch.profiler.profile(activities=CPU):
        with timer.section("pnt.timed"):
            pass
    assert [s["name"] for s in profiling.recorded()["spans"]] == ["pnt.timed"]
    assert timer.summary()["pnt.timed"]["count"] == 1


def test_reranker_counts_its_syncs_and_padding(data):
    tok, corpus, store, _ = data
    params = tt5.init_params(CFG, torch.Generator().manual_seed(1))
    r = Reranker(params, CFG, store, corpus, rel_id=tok.true_id,
                 nrel_id=tok.false_id, batch_size=8, packed=True,
                 bucket_lens=(24, 40, 56), device="cpu")
    runs = [{"q1": [f"d{i}" for i in range(3, 22)]},
            {"q5": [f"d{i}" for i in range(0, 24, 2)]}]
    r.rerank(runs[0])  # outside the recording
    with torch.profiler.profile(activities=CPU):
        for run in runs:
            r.rerank(run)
    rec = profiling.recorded()
    blocks = real = positions = 0
    for run in runs:
        ((qid, docs),) = run.items()
        q = np.full(len(docs), corpus.query_index[qid], np.int64)
        d = np.asarray([corpus.doc_index[x] for x in docs], np.int64)
        plan = r._bucket_plan(q, d)
        blocks += len(plan)
        real += int(store.pair_lengths(q, d).sum())
        positions += sum(8 * width for _, width in plan)
    # a block uploads ids and mask, the verbalizer columns, and reads its
    # scores back
    assert rec["counts"] == {"host_syncs": 4 * blocks,
                             "rerank.tokens_real": real,
                             "rerank.tokens_run": positions}
    assert _syncs(rec) == {"rerank.upload": blocks, "monot5.pair": blocks,
                           "rerank.scores": blocks}
    spans = rec["spans"]
    requests = [s for s in spans if s["name"] == "pnt.rerank.request"]
    assert [s["id"] for s in requests] == [1, 2]
    for s in spans:
        if s["name"] == "pnt.rerank.block":
            assert spans[s["parent"]]["name"] == "pnt.rerank.request"
        if s["name"] in ("pnt.rerank.assemble", "pnt.rerank.forward"):
            assert spans[s["parent"]]["name"] == "pnt.rerank.block"
    assert sum(s["name"] == "pnt.rerank.block" for s in spans) == blocks


def test_scored_pool_step_counts_its_syncs(data):
    state, loop, _ = _loop(data, scored=True)
    writer = MetricWriter(None)
    with torch.profiler.profile(activities=CPU):
        loop.run(state, 2, writer)
    rec = profiling.recorded()
    keys = set(writer.history[0]) - {"step", "steps_per_sec"}
    # 2 pairs x 4 candidates scored in 2 chunks of 4 rows: a step uploads
    # its candidate slots, reads the chunks' widths back, uploads its two
    # label rows, the draw's binomial n, the verbalizer columns of each
    # scoring chunk and of its curriculum signals, and its neg_scored
    assert _syncs(rec) == {"loop.pair_idx": 1, "loop.metrics": 1,
                           "scored.slots": 2, "scored.widths": 2,
                           "corpus.labels": 4, "sampling.n": 2,
                           "monot5.pair": 2 * (2 + 2),
                           "scored.neg_scored": 2}
    assert rec["counts"] == {"host_syncs": 1 + len(keys) + 2 * 10}
    spans = rec["spans"]
    for s in spans:
        if s["name"] in ("pnt.scored.score", "pnt.scored.draw"):
            assert spans[s["parent"]]["name"] == "pnt.step"
    assert sum(s["name"] == "pnt.scored.score" for s in spans) == 2


def test_threads_lose_no_count():
    import sys
    import threading

    workers, each = 16, 2000

    def work():
        for _ in range(each):
            profiling.count("hits")
            with profiling.host_sync("x"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = profiling.recorded()
    assert rec["counts"] == {"hits": workers * each,
                             "host_syncs": workers * each}
    assert len(rec["spans"]) == workers * each
    assert all(s["parent"] is None for s in rec["spans"])
