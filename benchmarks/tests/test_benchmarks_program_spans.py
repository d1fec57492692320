"""The per-layer metrics read from the port's own spans and counters
(``utils.profiling.recorded()``): a training, a scored-pool and a rerank
cell at the tiny T5 on the CPU with ``--trace 1``, each metric where the
manifest lists it, with the counts the code fixes, and the manifest's
contract with the new entries.

Run: ``python -m pytest benchmarks/tests -q``.
"""

from __future__ import annotations

import json

import pytest

from benchmarks.tests.test_benchmarks_harness import run_cell
from benchmarks.tests.test_benchmarks_harness import \
    test_manifest_keeps_the_contract as manifest_contract
from benchmarks.tests.tiny import ROOT, TRAFFIC, make_tree
from pacednegatives_tpu_torch.utils import profiling

NEW = {
    "host_syncs_per_step.train": ("syncs/step", "program_counter"),
    "host_syncs_per_step.scored": ("syncs/step", "program_counter"),
    "host_ms_per_step.scored": ("ms", "program_span"),
    "host_syncs_per_request.rerank": ("syncs/request", "program_counter"),
    "rerank_host_ms.rerank": ("ms", "program_span"),
    "rerank_pad_share.rerank": ("%", "program_counter"),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("spans"))


def traced(tree, cell):
    profiling.reset()
    rc, out = run_cell(tree, cell, trace=1)
    assert rc == 0 and out["correct"] is True, out["checks"]
    return out["metrics"], profiling.recorded()


def test_training_cell_reads_its_syncs(tree):
    metrics, rec = traced(tree, "tiny.lce")
    steps = TRAFFIC["lce"]["chunk_size"] * TRAFFIC["lce"]["trace_chunks"]
    assert steps == 2
    assert sum(s["name"] == "pnt.step" for s in rec["spans"]) == steps
    # a chunk uploads its pair indices and reads its 8 metrics back; a step
    # uploads 2 label rows, the draw's binomial n and 2 verbalizer columns
    assert metrics["host_syncs_per_step.train"] == {
        "value": (1 + 8 + steps * 5) / steps, "unit": "syncs/step"}
    assert not set(metrics) & (set(NEW) - {"host_syncs_per_step.train"})


def test_scored_cell_reads_its_syncs_and_host_time(tree):
    metrics, rec = traced(tree, "tiny.scored")
    steps = sum(s["name"] == "pnt.step" for s in rec["spans"])
    assert steps == 2
    # 4 pairs x 8 candidates in 2 scoring chunks of 16 rows: a step adds
    # its slots, the chunks' widths, the verbalizer columns of 2 chunks
    # and its neg_scored to the static step's 5; the chunk reads 11
    # metrics back
    assert metrics["host_syncs_per_step.scored"] == {
        "value": (1 + 11 + steps * (5 + 3 + 2)) / steps,
        "unit": "syncs/step"}
    host = metrics["host_ms_per_step.scored"]
    assert host["unit"] == "ms" and host["value"] > 0
    step_ms = [s["dur_ns"] / 1e6 for s in rec["spans"]
               if s["name"] == "pnt.step"]
    assert host["value"] <= sum(step_ms) / steps
    assert "host_syncs_per_step.train" not in metrics


def test_rerank_cell_reads_its_syncs_host_time_and_padding(tree):
    metrics, rec = traced(tree, "tiny.rerank")
    mix = TRAFFIC["rerank"]
    requests = sum(s["name"] == "pnt.rerank.request" for s in rec["spans"])
    assert requests == mix["trace_requests"]
    blocks = -(-mix["depth"] // mix["block"])
    # a block uploads ids and mask, the verbalizer columns, and reads its
    # scores back
    assert metrics["host_syncs_per_request.rerank"] == {
        "value": 4.0 * blocks, "unit": "syncs/request"}
    counts = rec["counts"]
    pad = 100.0 * (1 - counts["rerank.tokens_real"]
                   / counts["rerank.tokens_run"])
    assert metrics["rerank_pad_share.rerank"] == {"value": pad, "unit": "%"}
    assert 0 < pad < 100
    assert counts["rerank.tokens_real"] > 0
    assert metrics["rerank_host_ms.rerank"]["value"] > 0


def test_manifest_keeps_the_contract_with_the_new_metrics():
    manifest_contract()
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {p["name"]: p for p in m["per_layer"]}
    for name, (unit, source) in NEW.items():
        p = entries[name]
        assert (p["unit"], p["source"], p["better"]) == (unit, source,
                                                         "lower")
    names = [p["name"] for p in m["per_layer"]]
    assert names[-len(NEW):] == list(NEW)  # appended at the end
