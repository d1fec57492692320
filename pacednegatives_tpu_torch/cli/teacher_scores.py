"""Score triples under the lexical teacher ensemble (get_teacher_scores parity)."""

from __future__ import annotations

import json

from pacednegatives_tpu_torch.utils.config import parse_cli


def main(argv=None) -> str:
    args = parse_cli(argv)
    docs, queries, triples_path, out = (
        args["docs"], args["queries"], args["triples"], args["out"],
    )

    from pacednegatives_tpu_torch.data import TextCorpus
    from pacednegatives_tpu_torch.distill import score_teachers
    from pacednegatives_tpu_torch.distill.loader import load_triples_tsv

    corpus = TextCorpus.from_tsv(docs, queries)
    triples = load_triples_tsv(triples_path)
    ts = score_teachers(corpus, triples)
    ts.save(out)
    print(json.dumps({"teachers": ts.num_teachers, "out": out}))
    return out


if __name__ == "__main__":
    main()
