"""Mine one ensemble-fused negative per (query, positive) pair.

Reference distill/mine_negatives.py parity: 5-pipeline reciprocal-rank
fusion, 1 uniform sample from each query's top-1000. Output TSV:
qid, doc_id_a, doc_id_b.
"""

from __future__ import annotations

import json

from pacednegatives_tpu_torch.utils.config import parse_cli


def main(argv=None) -> str:
    args = parse_cli(argv)
    docs, queries, pairs_path, out = (
        args["docs"], args["queries"], args["pairs"], args["out"],
    )
    budget = int(args.get("budget", 1000))
    seed = int(args.get("seed", 0))

    from pacednegatives_tpu_torch.data import TextCorpus
    from pacednegatives_tpu_torch.distill import EnsembleMiner

    corpus = TextCorpus.from_tsv(docs, queries)
    miner = EnsembleMiner.build(corpus, budget=budget)

    pairs = []
    with open(pairs_path) as f:
        for line in f:
            qid, _, did = line.rstrip("\n").partition("\t")
            pairs.append((qid, did))

    triples = miner.mine_triples(corpus, pairs, seed=seed)
    with open(out, "w") as f:
        f.write("qid\tdoc_id_a\tdoc_id_b\n")
        for t in triples:
            f.write(f"{t['qid']}\t{t['doc_id_a']}\t{t['doc_id_b']}\n")
    print(json.dumps({"triples": len(triples), "out": out}))
    return out


if __name__ == "__main__":
    main()
