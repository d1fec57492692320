"""The evaluation slice against the JAX package, on the same TSVs and qrels,
on the CPU: metrics, paired experiments and TREC run I/O; the lexical
index; the CLIs ``bm25_grid``, ``build_pools --method bm25``,
``dataset_tools`` and ``train_tokenizer``; and ``cli.evaluate`` on one
tiny JAX-trained run converted to the port's checkpoint format.

Host code is held to exact equality (byte-identical files, equal floats).
The model rows of ``results.csv`` are held to 1e-6: both packages score in
fp32, and their scores differ by summation order only (~1e-7 at this
size), far below the score gaps that decide the rankings.
"""

import csv
import json
import os
import shutil

import jax
import numpy as np
import pytest

from pacednegatives_tpu.cli import bm25_grid as jgrid
from pacednegatives_tpu.cli import build_pools as jpools
from pacednegatives_tpu.cli import dataset_tools as jtools
from pacednegatives_tpu.cli import evaluate as jevaluate
from pacednegatives_tpu.cli import train as jtrain
from pacednegatives_tpu.cli import train_tokenizer as jtok
from pacednegatives_tpu.data import TextCorpus
from pacednegatives_tpu.eval.experiment import experiment as jexperiment
from pacednegatives_tpu.eval import metrics as jmetrics
from pacednegatives_tpu.eval import run_io as jrun_io
from pacednegatives_tpu.index import bm25 as jbm25
from pacednegatives_tpu.train import loop as jloop
from pacednegatives_tpu.train import runner as jrunner
from pacednegatives_tpu_torch.cli import bm25_grid as tgrid
from pacednegatives_tpu_torch.cli import build_pools as tpools
from pacednegatives_tpu_torch.cli import dataset_tools as ttools
from pacednegatives_tpu_torch.cli import evaluate as tevaluate
from pacednegatives_tpu_torch.cli import train_tokenizer as ttok
from pacednegatives_tpu_torch.eval.experiment import experiment as texperiment
from pacednegatives_tpu_torch.eval import metrics as tmetrics
from pacednegatives_tpu_torch.eval import run_io as trun_io
from pacednegatives_tpu_torch.index import bm25 as tbm25
from pacednegatives_tpu_torch.models.convert import train_state_from_jax
from pacednegatives_tpu_torch.train.loop import save_checkpoint

MODEL_METRIC_ATOL = 1e-6  # model rows of results.csv (module docstring)
METRICS = ("map", "ndcg_cut_10", "recip_rank", "recall_10", "P_5")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """docs / queries / pairs / qrels TSVs of tests/test_user_journey.py's
    corpus: 48 synthetic docs, 8 queries, doc d relevant to query d % 8."""
    d = tmp_path_factory.mktemp("eval")
    corpus = TextCorpus.synthetic(num_docs=48, num_queries=8, seed=7)
    paths = {k: str(d / f"{k}.tsv") for k in ("docs", "queries", "pairs",
                                              "qrels")}
    with open(paths["docs"], "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in zip(corpus.doc_ids,
                                                    corpus.doc_texts))
    with open(paths["queries"], "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in zip(corpus.query_ids,
                                                    corpus.query_texts))
    with open(paths["pairs"], "w") as f:
        f.writelines(f"q{q}\td{q}\n" for q in range(8))
    with open(paths["qrels"], "w") as f:
        # one query left unjudged; graded relevance on the rest
        f.writelines(f"q{q}\td{doc}\t{1 + (doc // 8) % 2}\n"
                     for q in range(7) for doc in range(q, 48, 8))
    return d, corpus, paths


def _runs(corpus, qrels):
    """A BM25 run and a shuffled copy of it, over the judged queries."""
    ix = jbm25.LexicalIndex.build(corpus.doc_texts)
    rng = np.random.default_rng(3)
    bm25, shuffled = {}, {}
    for qid in corpus.query_ids:
        if qid in qrels:
            ids, _ = ix.search(corpus.query_text(qid), k=20)
            bm25[qid] = [corpus.doc_ids[i] for i in ids]
            shuffled[qid] = list(rng.permutation(bm25[qid]))
    return {"bm25": bm25, "shuffled": shuffled}


def _same(a, b):
    """Equal, with NaN equal to NaN (an undefined p-value)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def test_metrics_experiment_and_run_io_match_jax(ws, tmp_path):
    d, corpus, paths = ws
    qrels = jevaluate.load_qrels(paths["qrels"])
    assert tevaluate.load_qrels(paths["qrels"]) == qrels
    runs = _runs(corpus, qrels)
    for run in runs.values():
        assert _same(tmetrics.evaluate_run(run, qrels, METRICS),
                     jmetrics.evaluate_run(run, qrels, METRICS))
    for baseline in ("bm25", "shuffled"):
        assert _same(
            texperiment(runs, qrels, metrics=METRICS,
                                   baseline=baseline),
            jexperiment(runs, qrels, metrics=METRICS,
                                   baseline=baseline))
    scores = {q: list(np.linspace(1.0, 0.0, len(docs)))
              for q, docs in runs["bm25"].items()}
    for name, kw in (("plain", {}), ("scored", {"scores": scores,
                                                "tag": "x"})):
        jrun_io.write_trec_run(str(tmp_path / f"j_{name}.run"),
                               runs["bm25"], **kw)
        trun_io.write_trec_run(str(tmp_path / f"t_{name}.run"),
                               runs["bm25"], **kw)
        t = (tmp_path / f"t_{name}.run").read_bytes()
        assert t == (tmp_path / f"j_{name}.run").read_bytes()
        assert trun_io.read_trec_run(str(tmp_path / f"t_{name}.run")) \
            == jrun_io.read_trec_run(str(tmp_path / f"j_{name}.run"))


@pytest.mark.parametrize("use_native", [None, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (0.6, 0.3)])
def test_lexical_index_matches_jax(ws, use_native, k1, b):
    _, corpus, _ = ws
    j = jbm25.LexicalIndex.build(corpus.doc_texts, use_native=use_native)
    t = tbm25.LexicalIndex.build(corpus.doc_texts, use_native=use_native)
    assert t.native == j.native
    for q in corpus.query_texts + ["no such words", ""]:
        ji, js = j.search(q, k=30, k1=k1, b=b)
        ti, ts = t.search(q, k=30, k1=k1, b=b)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


def test_bm25_grid_matches_jax(ws, tmp_path):
    _, _, paths = ws
    argv = ["--docs", paths["docs"], "--queries", paths["queries"],
            "--qrels", paths["qrels"], "--k", "20", "--bs", "0.3,0.75",
            "--k1s", "0.6,1.2"]
    j = jgrid.main(argv + ["--out", str(tmp_path / "j.json")])
    t = tgrid.main(argv + ["--out", str(tmp_path / "t.json")])
    assert t == j and len(t["grid"]) == 4
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


@pytest.mark.parametrize("extra", [[], ["--k1", "0.9", "--b", "0.4",
                                        "--cutoff", "40"]],
                         ids=["pairs_default", "k1_b_no_pairs"])
def test_build_pools_bm25_byte_identical(ws, tmp_path, extra):
    _, _, paths = ws
    argv = ["--docs", paths["docs"], "--queries", paths["queries"]]
    if not extra:
        argv += ["--pairs", paths["pairs"], "--cutoff", "8"]
    jpools.main(argv + extra + ["--out", str(tmp_path / "j.jsonl")])
    tpools.main(argv + extra + ["--method", "bm25",
                                "--out", str(tmp_path / "t.jsonl")])
    t = (tmp_path / "t.jsonl").read_bytes()
    assert t == (tmp_path / "j.jsonl").read_bytes()
    assert len(t.splitlines()) >= 1


@pytest.mark.parametrize("op", ["collate", "subset", "balanced", "sample"])
def test_dataset_tools_match_jax(ws, tmp_path, op):
    _, _, paths = ws
    pools = str(tmp_path / "pools.jsonl")
    jpools.main(["--docs", paths["docs"], "--queries", paths["queries"],
                 "--out", pools, "--cutoff", "12"])
    argv = {"collate": ["--pairs", paths["pairs"], "--pools", pools],
            "subset": ["--triples", pools, "--num_docs", "5"],
            "balanced": ["--triples", pools, "--num_docs", "4"],
            "sample": ["--triples", pools, "--n", "3", "--seed", "2"]}[op]
    jtools.main(["--op", op, "--out", str(tmp_path / "j.jsonl")] + argv)
    ttools.main(["--op", op, "--out", str(tmp_path / "t.jsonl")] + argv)
    t = (tmp_path / "t.jsonl").read_bytes()
    assert t == (tmp_path / "j.jsonl").read_bytes() and t


def test_train_tokenizer_matches_jax(ws, tmp_path, capsys):
    """HF tokenizers' Unigram trainer is not deterministic run to run, in
    either package: the order of near-tied pieces (hence their ids) and
    their scores' last digits vary. What is deterministic must match: the
    summary line, every section of the file but the model's vocab, and
    the set of pieces."""
    _, _, paths = ws
    argv = ["--docs", paths["docs"], "--queries", paths["queries"],
            "--vocab_size", "300"]
    jtok.main(argv + ["--out", str(tmp_path / "j.json")])
    ttok.main(argv + ["--out", str(tmp_path / "t.json")])
    jline, tline = capsys.readouterr().out.strip().splitlines()
    jsum, tsum = json.loads(jline), json.loads(tline)
    assert {**tsum, "out": None} == {**jsum, "out": None}
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    jvocab, tvocab = j["model"].pop("vocab"), t["model"].pop("vocab")
    assert t == j
    assert len(tvocab) == tsum["vocab_size"]
    assert {p for p, _ in tvocab} == {p for p, _ in jvocab}


@pytest.fixture(scope="module")
def runs(ws):
    """A tiny fp32 run trained by the JAX package, and the same run in the
    port's format: its final TrainState converted by
    ``train_state_from_jax`` and written by the port's ``save_checkpoint``
    beside a copy of its ``config.json``. Both directories are named
    ``run``, so both CLIs name the model row alike."""
    d, _, paths = ws
    pools = str(d / "pools.jsonl")
    jpools.main(["--docs", paths["docs"], "--queries", paths["queries"],
                 "--pairs", paths["pairs"], "--out", pools, "--cutoff", "8"])
    jax_dir, port_dir = str(d / "jax" / "run"), str(d / "port" / "run")
    jtrain.main(argv=[
        "--curriculum", "lce", "--n", "2", "--docs", paths["docs"],
        "--queries", paths["queries"], "--triples", pools,
        "--model", "tiny", "--vocab_size", "512", "--bf16", "false",
        "--remat", "false", "--max_q_tokens", "8", "--max_d_tokens", "24",
        "--total_steps", "24", "--warmup_steps", "2", "--batch_size", "4",
        "--lr", "3e-3", "--out_dir", jax_dir])
    restored = []
    real = jloop.restore_checkpoint
    jloop.restore_checkpoint = lambda p, t: restored.append(real(p, t)) \
        or restored[-1]
    try:
        jrunner.load_run(jax_dir)
    finally:
        jloop.restore_checkpoint = real
    state = jax.tree_util.tree_map(np.asarray, restored[0]._replace(key=None))
    with open(os.path.join(jax_dir, "config.json")) as f:
        seed = json.load(f)["seed"]
    save_checkpoint(os.path.join(port_dir, "final"),
                    train_state_from_jax(state, seed=seed))
    shutil.copy(os.path.join(jax_dir, "config.json"), port_dir)
    return jax_dir, port_dir


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("int8", ["false", "true"])
def test_evaluate_matches_jax(ws, runs, tmp_path, int8):
    _, _, paths = ws
    jax_dir, port_dir = runs
    argv = ["--docs", paths["docs"], "--queries", paths["queries"],
            "--qrels", paths["qrels"], "--depth", "10", "--bm25_k", "20",
            "--save_runs", "true", "--perquery", "true", "--int8", int8]
    jrows = jevaluate.main(argv + ["--model", jax_dir,
                                   "--out", str(tmp_path / "j")])
    trows = tevaluate.main(argv + ["--model", port_dir, "--device", "cpu",
                                   "--out", str(tmp_path / "t")])
    assert [r["name"] for r in trows] == [r["name"] for r in jrows] \
        == ["bm25", "run"]
    jcsv = _read_csv(tmp_path / "j" / "results.csv")
    tcsv = _read_csv(tmp_path / "t" / "results.csv")
    assert tcsv[0] == jcsv[0]  # bm25: host code, exact
    assert tcsv[1].keys() == jcsv[1].keys()
    for key, value in jcsv[1].items():
        if key == "name":
            assert tcsv[1][key] == value
        else:
            np.testing.assert_allclose(float(tcsv[1][key]), float(value),
                                       atol=MODEL_METRIC_ATOL, rtol=0,
                                       err_msg=key)
    for name in ("bm25.run", "run.run", "perqueryresults.csv"):
        assert (tmp_path / "t" / name).exists()
    assert (tmp_path / "t" / "bm25.run").read_bytes() == \
        (tmp_path / "j" / "bm25.run").read_bytes()
    tq = _read_csv(tmp_path / "t" / "perqueryresults.csv")
    jq = _read_csv(tmp_path / "j" / "perqueryresults.csv")
    assert [(r["name"], r["qid"], r["measure"]) for r in tq] == \
        [(r["name"], r["qid"], r["measure"]) for r in jq]
    np.testing.assert_allclose([float(r["value"]) for r in tq],
                               [float(r["value"]) for r in jq],
                               atol=MODEL_METRIC_ATOL, rtol=0)
