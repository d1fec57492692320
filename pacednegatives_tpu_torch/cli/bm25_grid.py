"""BM25 parameter grid search (reference notebooks/gridsearch.ipynb parity).

Sweeps (b, k1) over a grid, evaluates each configuration's retrieval run
against qrels, and reports the best configuration per metric — the offline
first-stage tuning the reference did in a notebook, as a reproducible CLI.

Usage:
  python -m pacednegatives_tpu.cli.bm25_grid --docs docs.tsv --queries q.tsv \\
      --qrels qrels.tsv --out grid.json [--k 1000] \\
      [--bs 0.3,0.5,0.7] [--k1s 0.3,0.6,0.9,1.2]
"""

from __future__ import annotations

import json

from pacednegatives_tpu_torch.utils.config import parse_cli


def main(argv=None) -> dict:
    args = parse_cli(argv)
    k = int(args.get("k", 1000))
    bs = [float(x) for x in args.get("bs", "0.3,0.45,0.6,0.75,0.9").split(",")]
    k1s = [float(x) for x in args.get("k1s", "0.3,0.6,0.9,1.2,1.5").split(",")]
    metrics = args.get("metrics", "map,ndcg_cut_10,recall_1000").split(",")

    from pacednegatives_tpu_torch.cli.evaluate import load_qrels
    from pacednegatives_tpu_torch.data import TextCorpus
    from pacednegatives_tpu_torch.eval import evaluate_run
    from pacednegatives_tpu_torch.index.bm25 import LexicalIndex

    corpus = TextCorpus.from_tsv(args["docs"], args["queries"])
    qrels = load_qrels(args["qrels"])
    ix = LexicalIndex.build(corpus.doc_texts)

    rows = []
    for b in bs:
        for k1 in k1s:
            run = {}
            for qid in corpus.query_ids:
                if qid not in qrels:
                    continue
                ids, _ = ix.search(corpus.query_text(qid), k=k, k1=k1, b=b)
                run[qid] = [corpus.doc_ids[d] for d in ids]
            per = evaluate_run(run, qrels, metrics)
            row = {"b": b, "k1": k1}
            for m in metrics:
                vals = list(per[m].values())
                row[m] = sum(vals) / len(vals) if vals else 0.0
            rows.append(row)

    best = {m: max(rows, key=lambda r: r[m]) for m in metrics}
    result = {"grid": rows, "best": best}
    if args.get("out"):
        with open(args["out"], "w") as f:
            json.dump(result, f, indent=2)
    for m in metrics:
        print(
            f"Best {m}: {best[m][m]:.6f} (b={best[m]['b']}, k1={best[m]['k1']})"
        )
    return result


if __name__ == "__main__":
    main()
