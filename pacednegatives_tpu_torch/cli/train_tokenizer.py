"""Train the in-repo Unigram tokenizer on a corpus (replaces the reference's
downloaded sentencepiece model — no network in this stack).

Usage:
  python -m pacednegatives_tpu.cli.train_tokenizer \\
      --docs docs.tsv --queries queries.tsv --out tokenizer.json --vocab_size 32128
"""

from __future__ import annotations

import json

from pacednegatives_tpu_torch.utils.config import parse_cli


def main(argv=None) -> str:
    args = parse_cli(argv)
    out = args["out"]
    vocab = int(args.get("vocab_size", 32128))

    from pacednegatives_tpu_torch.data import TextCorpus
    from pacednegatives_tpu_torch.data.tokenizer import TrainedTokenizer

    corpus = TextCorpus.from_tsv(args["docs"], args["queries"])
    tok = TrainedTokenizer.train(
        corpus.doc_texts + corpus.query_texts, vocab_size=vocab
    )
    tok.save(out)
    print(json.dumps({"vocab_size": tok.vocab_size, "out": out,
                      "true_id": tok.true_id, "false_id": tok.false_id}))
    return out


if __name__ == "__main__":
    main()
