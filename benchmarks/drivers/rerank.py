"""Rerank driver: depth-k reranking requests through the port's
``Reranker.rerank`` (packed, length-bucketed blocks, bf16), one client in
a closed loop.

Set-up draws the corpus from the seed on the card, copies it to the host
as the store the Reranker serves from (as ``cli.evaluate`` builds one),
makes the weights, and warms every bucket width the requests use. Request
i is a query and ``depth`` distinct documents drawn from the seed. The
window sends requests one after another until ``--seconds`` have passed;
each request's latency is the host time of its ``rerank`` call, and the
rate is every document of the finished requests over the whole window.
After the window a sample of the finished requests, drawn from the seed
and holding the longest, is scored by the plain reference and compared
with the scores the program served and the order it returned.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.common import data, tracing
from benchmarks.common.cell import Cell, Outcome
from benchmarks.common.inputs import make_corpus
from benchmarks.common.weights import nest
from benchmarks.reference.lce import prompts


def requests(seed: int, nq: int, nd: int, depth: int):
    """Request i: (query row, (depth,) distinct doc rows), forever."""
    rng = np.random.default_rng(data.stream_seed(seed, "requests"))
    while True:
        yield int(rng.integers(nq)), rng.choice(nd, depth, replace=False)


def build(cell: Cell, corpus: dict, int8: bool = False):
    """(Reranker subclass instance that keeps each request's scores, host
    lengths of (queries, docs))."""
    from pacednegatives_tpu_torch.data.corpus import TextCorpus
    from pacednegatives_tpu_torch.data.pipeline import (
        PromptTemplate,
        TokenizedStore,
    )
    from pacednegatives_tpu_torch.eval.rerank import Reranker

    tok, tr = cell.config["tokens"], cell.traffic

    class Recording(Reranker):
        """``Reranker`` that keeps the scores behind its last ranking."""

        def score_pairs(self, q_rows, d_rows):
            self.last_scores = super().score_pairs(q_rows, d_rows)
            if cell.fault == "altered_answer":
                self.last_scores[len(self.last_scores) // 2] += 1.0
            return self.last_scores

        def _score(self, ids, mask):
            out = super()._score(ids, mask)
            if cell.fault == "half_batch":
                out[len(out) // 2:] = out[:len(out) - len(out) // 2]
            return out

    store = TokenizedStore(
        q_tokens=corpus["q_tokens"].cpu().numpy(), q_mask=None,
        d_tokens=corpus["d_tokens"].cpu().numpy(), d_mask=None,
        template=PromptTemplate(prefix=tuple(tok["prefix"]),
                                mid=tuple(tok["mid"]),
                                suffix=tuple(tok["suffix"])),
        pad_id=tok["pad"], true_id=tok["true"], false_id=tok["false"],
        eos_id=tok["eos"])
    text = TextCorpus([f"d{i}" for i in range(tr["docs"])], [""] * tr["docs"],
                      [f"q{i}" for i in range(tr["queries"])],
                      [""] * tr["queries"])
    params = nest(cell.arch.weights(cell.config, cell.seed, cell.device))
    reranker = Recording(
        params=params, cfg=cell.arch.port_config(cell.config, remat=False),
        store=store, corpus=text, rel_id=tok["true"], nrel_id=tok["false"],
        batch_size=tr["block"], packed=tr["packed"],
        bucket_lens=tuple(tr["buckets"]), int8=int8, device=cell.device)
    return reranker, store


def serve(reranker, q: int, docs: np.ndarray):
    """One request: (latency s, scores in doc order, returned doc rows)."""
    run = {f"q{q}": [f"d{d}" for d in docs]}
    t = time.perf_counter()
    ranked = reranker.rerank(run)[f"q{q}"]
    lat = time.perf_counter() - t
    return lat, reranker.last_scores.copy(), np.array(
        [int(d[1:]) for d in ranked])


def warm(reranker, stream, n: int) -> None:
    """Every bucket width of ``n`` requests, then those requests."""
    reqs = [next(stream) for _ in range(n)]
    q = np.concatenate([np.full(len(d), q) for q, d in reqs])
    d = np.concatenate([d for _, d in reqs])
    reranker.warm(q, d)
    for q, docs in reqs:
        serve(reranker, q, docs)


def run(cell: Cell) -> Outcome:
    tr = cell.traffic
    counters = tracing.Counters()
    undo = tracing.wrap_attention(counters) if cell.trace else None
    phases = tracing.Phases(cell.t_start, cell.device)
    phases.mark("imports")
    corpus = make_corpus(cell.config, tr, cell.seed, cell.device)
    phases.mark("inputs")
    reranker, store = build(cell, corpus, int8=tr.get("int8", False))
    phases.mark("store, weights, Reranker")
    stream = requests(cell.seed, tr["queries"], tr["docs"], tr["depth"])
    warm(reranker, stream, tr["warm_requests"])
    phases.mark("warm-up")
    done = []  # (q, docs, latency, scores, order)

    def one():
        q, docs = next(stream)
        lat, scores, order = serve(reranker, q, docs)
        done.append((q, docs, lat, scores, order))
        if counters.active:
            lens = store.pair_lengths(np.full(len(docs), q),
                                      docs).astype(np.float64)
            counters.add("rerank_rows", len(lens))
            counters.add("rerank_len", lens.sum())
            counters.add("rerank_len_sq", np.square(lens).sum())

    trace = None
    end_to_end = {}
    setup_s = float("nan")
    if cell.trace:
        def traced():
            for _ in range(tr["trace_requests"]):
                one()

        trace = tracing.profile(warm=one, active=traced, counters=counters,
                                out_dir=cell.out_dir, device=cell.device)
    else:
        tracing.sync(cell.device)
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        while time.perf_counter() - t0 < cell.seconds:
            one()
        elapsed = time.perf_counter() - t0
        lat = np.array([r[2] for r in done])
        end_to_end = {
            "rerank_docs_per_s": sum(len(r[1]) for r in done) / elapsed,
            "rerank_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        }
    peak = tracing.peak_bytes(cell.device)
    if undo:
        undo()
    del reranker
    tracing.free(cell.device)
    phases.mark("window")
    checks = check(cell, corpus, done)
    phases.mark("check")
    return Outcome(attempted=len(done), failed=0, end_to_end=end_to_end,
                   setup_s=setup_s, memory_peak_bytes=peak, checks=checks,
                   trace=trace, counters=counters,
                   extra={"phases": phases.seconds})


def sample(cell: Cell, done: list, corpus: dict) -> list:
    """Indices of the checked requests: the one with the most real
    tokens, and others drawn from the seed."""
    k = min(cell.traffic["check_requests"], len(done))
    d_len = (corpus["d_tokens"] != cell.config["tokens"]["pad"]).sum(1).cpu()
    longest = int(np.argmax([int(d_len[torch.from_numpy(r[1])].sum())
                             for r in done]))
    rng = np.random.default_rng(data.stream_seed(cell.seed, "check"))
    others = [i for i in rng.permutation(len(done)) if i != longest]
    return [longest, *others[:k - 1]]


def control(cell: Cell) -> dict:
    """The check's numbers with the reference computed in float8 (e4m3
    operands) serving the first requests in the program's place."""
    tok, tr = cell.config["tokens"], cell.traffic
    corpus = make_corpus(cell.config, tr, cell.seed, cell.device)
    model = cell.arch.reference(
        cell.config, cell.arch.weights(cell.config, cell.seed, cell.device),
        precision="fp8")
    stream = requests(cell.seed, tr["queries"], tr["docs"], tr["depth"])
    done = []
    for _ in range(tr["check_requests"]):
        q, docs = next(stream)
        s = reference_scores(model, tok, corpus, q, docs, tr["block"])
        done.append((q, docs, 0.0, s, docs[np.argsort(-s, kind="stable")]))
    del model
    tracing.free(cell.device)
    return check(cell, corpus, done)


def reference_scores(model, tok, corpus, q, docs, block) -> np.ndarray:
    d = torch.from_numpy(docs).to(corpus["d_tokens"].device)
    ids, mask = prompts(tok, corpus, torch.full_like(d, q), d, True)
    with torch.no_grad():
        return torch.cat([
            model.score(ids[j:j + block], mask[j:j + block], tok["true"],
                        tok["false"])
            for j in range(0, len(docs), block)]).double().cpu().numpy()


def check(cell: Cell, corpus: dict, done: list) -> dict:
    """The widest gap between a served score and the reference's, and the
    widest gap by which the reference score of the document the program
    put at a rank lies below the reference's own score at that rank, each
    in units of the request's standard deviation of reference scores (a
    random model's scores differ little from document to document)."""
    tok = cell.config["tokens"]
    dev = cell.device
    model = cell.arch.reference(cell.config,
                                cell.arch.weights(cell.config, cell.seed, dev))
    score_gap = order_gap = 0.0
    for i in sample(cell, done, corpus):
        q, docs, _, scores, order = done[i]
        ref = reference_scores(model, tok, corpus, q, docs,
                               cell.traffic["block"])
        sigma = ref.std()
        score_gap = max(score_gap, float(np.abs(scores - ref).max() / sigma))
        at = {int(r): j for j, r in enumerate(docs)}
        served = ref[[at[int(r)] for r in order]]
        order_gap = max(order_gap,
                        float(np.max(np.sort(ref)[::-1] - served) / sigma))
    return {"score_gap": score_gap, "order_gap": order_gap}
