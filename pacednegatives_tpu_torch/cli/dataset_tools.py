"""Offline dataset manipulation CLI (reference utilities/* parity).

Subcommand via --op:
  collate   join a pairs TSV (qid<TAB>doc_id_a) with a pools JSON(L) on
            query_id (utilities/collate_dataset.py)
  subset    truncate every pool to --num_docs (util.py take_subset)
  balanced  evenly-spaced pool subsample keeping endpoints
            (util.py take_balanced_subset)
  sample    uniform record subsample to --n (utilities/dataset_subset.py)

Input/output are the canonical triples JSON(L) records.
"""

from __future__ import annotations

import json

from pacednegatives_tpu_torch.data.tools import (
    collate_pools,
    subsample,
    take_balanced_subset,
    take_subset,
)
from pacednegatives_tpu_torch.data.triples import load_triples
from pacednegatives_tpu_torch.utils.config import parse_cli


def _write(records, path):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def main(argv=None) -> str:
    args = parse_cli(argv)
    op = args["op"]
    out = args["out"]

    if op == "collate":
        pairs = []
        with open(args["pairs"]) as f:
            for line in f:
                qid, _, did = line.rstrip("\n").partition("\t")
                pairs.append({"query_id": qid, "doc_id_a": did})
        pools = load_triples(args["pools"])
        records = collate_pools(pairs, pools)
    else:
        records = load_triples(args["triples"])
        if op == "subset":
            records = take_subset(records, int(args.get("num_docs", 10)))
        elif op == "balanced":
            records = take_balanced_subset(records, int(args.get("num_docs", 10)))
        elif op == "sample":
            records = subsample(records, int(args["n"]), int(args.get("seed", 0)))
        else:
            raise SystemExit(f"unknown --op {op}")

    _write(records, out)
    print(json.dumps({"records": len(records), "out": out}))
    return out


if __name__ == "__main__":
    main()
