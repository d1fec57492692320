"""Evaluate trained rerankers: BM25 first stage -> monoT5 rerank -> paired
metrics vs a baseline run (reference eval.py parity); the port of
cli/evaluate.py.

Usage (``--device`` defaults to cuda; there is no fallback to the CPU):
  python -m pacednegatives_tpu_torch.cli.evaluate \\
      --docs docs.tsv --queries queries.tsv --qrels qrels.tsv \\
      --model_dir runs/ --baseline runs/baseline --out results/
``--model_dir`` evaluates every run subdirectory (eval.py:17-38); ``--model``
evaluates one. Runs are the port's (``train.runner.load_run``). qrels TSV:
qid<TAB>doc_id<TAB>rel (3-col) or TREC 4-col. ``--int8 true`` reranks with
the W8A8 forward (models/quant.py); ``--save_runs true`` writes each run in
TREC format, ``--perquery true`` the per-query metrics. The BM25 first
stage runs on the host, the rerank on ``--device``.
"""

from __future__ import annotations

import csv
import json
import os
from os.path import isdir, join

from pacednegatives_tpu_torch.utils.config import parse_cli

METRICS = ("map", "ndcg_cut_10", "recip_rank")  # eval.py:26


def _flag(args: dict, name: str) -> bool:
    return args.get(name, "false").lower() in ("1", "true", "yes")


def load_qrels(path: str) -> dict[str, dict[str, int]]:
    qrels: dict[str, dict[str, int]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:  # TREC: qid iter doc rel
                qid, _, did, rel = parts
            elif len(parts) == 3:
                qid, did, rel = parts
            else:
                continue
            qrels.setdefault(qid, {})[did] = int(rel)
    return qrels


def _write_rows(path: str, rows: list[dict]) -> None:
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> list[dict]:
    args = parse_cli(argv)
    out = args["out"]
    os.makedirs(out, exist_ok=True)
    qrels = load_qrels(args["qrels"])
    depth = int(args.get("depth", 100))
    bm25_k = int(args.get("bm25_k", 1000))
    device = args.get("device", "cuda")

    from pacednegatives_tpu_torch.data import TextCorpus, TokenizedStore
    from pacednegatives_tpu_torch.eval import Reranker, experiment
    from pacednegatives_tpu_torch.index.bm25 import LexicalIndex
    from pacednegatives_tpu_torch.train.runner import load_run

    corpus = TextCorpus.from_tsv(args["docs"], args["queries"])
    ix = LexicalIndex.build(corpus.doc_texts)

    # first stage over judged queries
    first: dict[str, list[str]] = {}
    for qid in corpus.query_ids:
        if qid not in qrels:
            continue
        ids, _ = ix.search(corpus.query_text(qid), k=bm25_k)
        first[qid] = [corpus.doc_ids[d] for d in ids]

    def rerank_with(run_dir: str):
        params, mcfg, tok, rc = load_run(run_dir, device=device)
        store = TokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                     max_d_tokens=rc.max_d_tokens)
        # serve with the layout the model was trained with; packed runs
        # also get length buckets (identical scores, fewer padded FLOPs)
        packed = getattr(rc, "packed_assembly", False)
        L = store.prompt_len
        rr = Reranker(
            params, mcfg, store, corpus,
            rel_id=tok.true_id, nrel_id=tok.false_id,
            packed=packed,
            bucket_lens=tuple(range(32, L, 32)) if packed else None,
            int8=_flag(args, "int8"),
            device=device,
        )
        return rr.rerank(first, depth=depth)

    runs: dict[str, dict] = {"bm25": first}
    baseline_name = "bm25"
    if args.get("baseline"):
        runs["baseline"] = rerank_with(args["baseline"])
        baseline_name = "baseline"

    if args.get("model"):
        runs[os.path.basename(args["model"].rstrip("/"))] = \
            rerank_with(args["model"])
    elif args.get("model_dir"):
        root = args["model_dir"]
        for name in sorted(os.listdir(root)):
            d = join(root, name)
            if isdir(d) and os.path.exists(join(d, "config.json")):
                try:
                    runs[name] = rerank_with(d)
                except Exception as e:  # eval.py:27-29 skip-on-error parity
                    print(f"Error in {name}: {type(e).__name__}: {e}")

    if _flag(args, "save_runs"):
        from pacednegatives_tpu_torch.eval import write_trec_run

        for name, r in runs.items():
            write_trec_run(join(out, f"{name}.run"), r, tag=name)

    rows = experiment(runs, qrels, metrics=METRICS, baseline=baseline_name)
    _write_rows(join(out, "results.csv"), rows)

    if _flag(args, "perquery"):
        # per-query long format (eval.py:45-46 perquery parity)
        from pacednegatives_tpu_torch.eval import evaluate_run

        pq_rows = []
        for name, r in runs.items():
            per = evaluate_run(r, qrels, METRICS)
            for m, by_q in per.items():
                for qid, val in by_q.items():
                    pq_rows.append(
                        {"name": name, "qid": qid, "measure": m, "value": val}
                    )
        _write_rows(join(out, "perqueryresults.csv"), pq_rows)

    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
