"""The user journey through the port's CLIs on the CPU, as
tests/test_user_journey.py runs the JAX package's: train a tokenizer,
build BM25 pools, train with the LCE curriculum, evaluate against the BM25
baseline, then distil (mine triples, score them under the lexical
teachers, train the tiny model with MarginMSE). Then the end-to-end quality check: each package
trains the tiny model from the same seeds on the same pools and reranks
the same held-out queries; the port's mean MRR@10 over the seeds must lie
within the JAX seeds' spread (their minimum to their maximum).

The corpus is ``TextCorpus.synthetic``'s planted topics: doc d is relevant
to query d % 32. Queries 0-23 give the training pairs and pools, queries
24-31 are held out and judged.
"""

import json
import os

import numpy as np
import pytest

from pacednegatives_tpu.cli import evaluate as jevaluate
from pacednegatives_tpu.cli import train as jtrain
from pacednegatives_tpu_torch.cli import build_pools as tpools
from pacednegatives_tpu_torch.cli import distill as tdistill
from pacednegatives_tpu_torch.cli import evaluate as tevaluate
from pacednegatives_tpu_torch.cli import mine_negatives as tmine
from pacednegatives_tpu_torch.cli import teacher_scores as tteach
from pacednegatives_tpu_torch.cli import train as ttrain
from pacednegatives_tpu_torch.cli import train_tokenizer as ttok
from pacednegatives_tpu_torch.data import TextCorpus
from pacednegatives_tpu_torch.eval import evaluate_run, read_trec_run

NUM_DOCS, NUM_QUERIES, TRAIN_QUERIES = 128, 32, 24
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_journey")
    corpus = TextCorpus.synthetic(num_docs=NUM_DOCS, num_queries=NUM_QUERIES,
                                  seed=7)
    paths = {k: str(d / f"{k}.tsv") for k in
             ("docs", "queries", "train_queries", "pairs", "qrels")}
    rows = list(zip(corpus.query_ids, corpus.query_texts))
    with open(paths["docs"], "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in zip(corpus.doc_ids,
                                                    corpus.doc_texts))
    with open(paths["queries"], "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in rows)
    with open(paths["train_queries"], "w") as f:
        f.writelines(f"{i}\t{t}\n" for i, t in rows[:TRAIN_QUERIES])
    with open(paths["pairs"], "w") as f:
        f.writelines(f"q{q}\td{q}\n" for q in range(TRAIN_QUERIES))
    with open(paths["qrels"], "w") as f:
        f.writelines(f"q{q}\td{doc}\t1\n"
                     for q in range(TRAIN_QUERIES, NUM_QUERIES)
                     for doc in range(q, NUM_DOCS, NUM_QUERIES))
    pools = str(d / "pools.jsonl")
    tpools.main(["--docs", paths["docs"], "--queries",
                 paths["train_queries"], "--pairs", paths["pairs"],
                 "--out", pools, "--cutoff", "16"])
    return d, paths, pools


def _train_argv(paths, pools, seed, out_dir, **extra):
    argv = ["--curriculum", "lce", "--n", "2", "--docs", paths["docs"],
            "--queries", paths["queries"], "--triples", pools,
            "--model", "tiny", "--bf16", "false", "--remat", "false",
            "--max_q_tokens", "8", "--max_d_tokens", "40",
            "--total_steps", "32", "--warmup_steps", "4", "--batch_size", "4",
            "--lr", "3e-3", "--seed", str(seed), "--out_dir", out_dir]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    return argv


def _eval_argv(paths, out):
    return ["--docs", paths["docs"], "--queries", paths["queries"],
            "--qrels", paths["qrels"], "--depth", "20", "--bm25_k", "20",
            "--save_runs", "true", "--out", out]


def test_full_journey(workspace):
    d, paths, pools = workspace

    # 1. train a tokenizer on the corpus
    tok_path = str(d / "tok.json")
    ttok.main(["--docs", paths["docs"], "--queries", paths["queries"],
               "--out", tok_path, "--vocab_size", "300"])

    # 2. BM25 pools (the fixture built them): one per training query,
    # each its 16 best docs, easiest first
    with open(pools) as f:
        assert len(f.read().splitlines()) == TRAIN_QUERIES

    # 3. train with the lce curriculum on those pools + tokenizer
    run_dir = str(d / "run")
    summary = ttrain.main(argv=_train_argv(
        paths, pools, 0, run_dir, tokenizer=tok_path, chunk_size=3,
        device="cpu"))
    assert summary["steps"] == 8 and np.isfinite(summary["final_loss"])

    # 4. evaluate vs the BM25 baseline (paired metrics)
    out = str(d / "eval")
    rows = tevaluate.main(_eval_argv(paths, out)
                          + ["--model", run_dir, "--perquery", "true",
                             "--device", "cpu"])
    assert [r["name"] for r in rows] == ["bm25", "run"]
    for name in ("results.csv", "perqueryresults.csv", "bm25.run",
                 "run.run"):
        assert os.path.exists(os.path.join(out, name)), name

    # 5. distillation chain: mine -> teacher scores -> distill
    triples_tsv = str(d / "triples.tsv")
    tmine.main(["--docs", paths["docs"], "--queries", paths["queries"],
                "--pairs", paths["pairs"], "--out", triples_tsv,
                "--budget", "16"])
    teacher = str(d / "teacher.json")
    tteach.main(["--docs", paths["docs"], "--queries", paths["queries"],
                 "--triples", triples_tsv, "--out", teacher])
    dsum = tdistill.main([
        "--docs", paths["docs"], "--queries", paths["queries"],
        "--triples", triples_tsv, "--teacher", teacher, "--model", "tiny",
        "--vocab_size", "300", "--tokenizer", tok_path,
        "--objective", "margin_mse", "--total_steps", "16",
        "--batch_size", "4", "--out_dir", str(d / "distill"),
        "--device", "cpu",
    ])
    assert dsum["steps"] == 4
    with open(str(d / "distill" / "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert any(np.isfinite(line.get("loss", np.nan)) for line in lines)
    assert os.path.exists(str(d / "distill" / "final" / "state.pt"))


def _mrr_at_10(run_file: str, qrels_path: str) -> float:
    run = {q: docs[:10] for q, docs in read_trec_run(run_file)[0].items()}
    per = evaluate_run(run, tevaluate.load_qrels(qrels_path), ["recip_rank"])
    return float(np.mean(list(per["recip_rank"].values())))


def test_heldout_mrr_within_jax_seed_spread(workspace):
    d, paths, pools = workspace
    mrr = {"jax": [], "port": []}
    for seed in SEEDS:
        jdir = str(d / f"jax{seed}" / "run")
        tdir = str(d / f"port{seed}" / "run")
        jtrain.main(argv=_train_argv(paths, pools, seed, jdir,
                                     vocab_size=512))
        ttrain.main(argv=_train_argv(paths, pools, seed, tdir,
                                     vocab_size=512, device="cpu"))
        jout, tout = str(d / f"jeval{seed}"), str(d / f"teval{seed}")
        jevaluate.main(_eval_argv(paths, jout) + ["--model", jdir])
        tevaluate.main(_eval_argv(paths, tout) + ["--model", tdir,
                                                  "--device", "cpu"])
        mrr["jax"].append(_mrr_at_10(os.path.join(jout, "run.run"),
                                     paths["qrels"]))
        mrr["port"].append(_mrr_at_10(os.path.join(tout, "run.run"),
                                      paths["qrels"]))
    port = float(np.mean(mrr["port"]))
    assert min(mrr["jax"]) <= port <= max(mrr["jax"]), mrr
