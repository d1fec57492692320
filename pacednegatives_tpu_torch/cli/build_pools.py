"""Build difficulty-ordered negative pools: the port of cli/build_pools.py
(compute_all_bm25 parity).

The top-``cutoff`` docs of every query (queries with a short pool are
dropped), reversed so that index 0 is the EASIEST negative. ``--method
bm25`` (the default) searches the native lexical index on the host
(index/bm25.py, ``--k1`` / ``--b``) and writes what the JAX CLI writes.
``--method dense``: a trained run's encoder embeds the corpus and the
queries, and a ``DenseIndex`` answers them in batches of 64 queries with
``--topk pallas`` (K5 on the card) or ``--topk exact``.

Usage (``--device``, read by ``--method dense`` and ``splade``, defaults
to cuda; there is no fallback to the CPU):
  python -m pacednegatives_tpu_torch.cli.build_pools \\
      --docs docs.tsv --queries queries.tsv --pairs pairs.tsv \\
      --out pools.jsonl --cutoff 1000
  python -m pacednegatives_tpu_torch.cli.build_pools --method dense \\
      --run runs/out --docs docs.tsv --queries queries.tsv \\
      --pairs pairs.tsv --out pools.jsonl --cutoff 1000 --topk pallas
  python -m pacednegatives_tpu_torch.cli.build_pools --method splade \\
      --run runs/out --docs docs.tsv --queries queries.tsv \\
      --out pools.jsonl --cutoff 1000 --splade_terms 128
``pairs.tsv``: qid<TAB>doc_id_a rows (one positive per query); without it,
doc_id_a is left empty for downstream joining (collate_dataset parity).
``--method splade`` (compute_all_splade.py:28-30 parity): the run's
encoder gives every doc and query its top ``--splade_terms`` vocab-space
activations (models/splade.py, on ``--device``, ``--encode_batch`` rows at
a time), and a quantized impact index on the host (index/sparse.py,
``--quantize``) answers each query.
"""

from __future__ import annotations

import json
import os

from pacednegatives_tpu_torch.utils.config import parse_cli

QUERY_BATCH = 64  # queries per top-k call (build_pools.py:113)


def main(argv=None) -> str:
    args = parse_cli(argv)
    docs, queries = args["docs"], args["queries"]
    out = args["out"]
    cutoff = int(args.get("cutoff", 1000))
    k1 = float(args.get("k1", 1.2))
    b = float(args.get("b", 0.75))
    pairs_path = args.get("pairs")
    method = args.get("method", "bm25")
    if method not in ("bm25", "dense", "splade"):
        raise SystemExit(f"unknown method {method}")

    from pacednegatives_tpu_torch.data import TextCorpus

    corpus = TextCorpus.from_tsv(docs, queries)
    pairs: dict[str, str] = {}
    if pairs_path:
        with open(pairs_path) as f:
            for line in f:
                qid, _, did = line.rstrip("\n").partition("\t")
                pairs[qid] = did

    if method == "bm25":
        from pacednegatives_tpu_torch.index.bm25 import LexicalIndex

        ix = LexicalIndex.build(corpus.doc_texts)
        pools_iter = (
            (qid, ix.search(qtext, k=cutoff, k1=k1, b=b)[0])
            for qid, qtext in zip(corpus.query_ids, corpus.query_texts)
        )
    elif method == "dense":
        pools_iter = _dense_pools(args, corpus, cutoff)
    else:
        pools_iter = _splade_pools(args, corpus, cutoff)

    n_written = n_skipped = 0
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        for qid, ids in pools_iter:
            if len(ids) < cutoff:
                # keep only full pools (compute_all_bm25.py:38-40)
                n_skipped += 1
                continue
            pool = [corpus.doc_ids[d] for d in ids[:cutoff]][::-1]  # easy first
            rec = {"query_id": qid, "doc_id_a": pairs.get(qid, ""),
                   "doc_id_b": pool}
            f.write(json.dumps(rec) + "\n")
            n_written += 1

    print(json.dumps({"written": n_written, "skipped_short": n_skipped,
                      "out": out}))
    return out


def _dense_pools(args: dict, corpus, cutoff: int):
    """Encode corpus and queries with a trained run's model, then MIPS
    top-k on ``--device``; yields (qid, doc rows hardest first)."""
    import torch

    from pacednegatives_tpu_torch.data import TokenizedStore
    from pacednegatives_tpu_torch.index import DenseIndex
    from pacednegatives_tpu_torch.models.dual_encoder import encode_corpus
    from pacednegatives_tpu_torch.train.runner import load_run

    run_dir = args.get("run")
    if not run_dir:
        raise SystemExit("--method dense needs --run <trained run dir>")
    device = torch.device(args.get("device", "cuda"))
    params, mcfg, tok, rc = load_run(run_dir, device=device)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                 max_d_tokens=rc.max_d_tokens)
    batch = int(args.get("encode_batch", 256))

    def encode(tokens, mask):
        return encode_corpus(params, mcfg,
                             torch.from_numpy(tokens).to(device),
                             torch.from_numpy(mask).to(device),
                             batch_size=batch)

    d_emb = encode(store.d_tokens, store.d_mask)
    q_emb = encode(store.q_tokens, store.q_mask)
    index = DenseIndex.build(d_emb, method=args.get("topk", "exact"),
                             device=device)
    k = min(cutoff, corpus.num_docs)
    for s in range(0, corpus.num_queries, QUERY_BATCH):
        e = min(s + QUERY_BATCH, corpus.num_queries)
        _, idx = index.topk(q_emb[s:e], k)
        idx = idx.cpu().numpy()
        for row, qid in enumerate(corpus.query_ids[s:e]):
            yield qid, idx[row]


def _splade_pools(args: dict, corpus, cutoff: int):
    """A trained run's SPLADE activations (models/splade.py) on
    ``--device`` feed a quantized impact index on the host
    (index/sparse.py); yields (qid, doc rows hardest first)."""
    import torch

    from pacednegatives_tpu_torch.data import TokenizedStore
    from pacednegatives_tpu_torch.index.sparse import SparseIndex
    from pacednegatives_tpu_torch.models.splade import encode_corpus_sparse
    from pacednegatives_tpu_torch.train.runner import load_run

    run_dir = args.get("run")
    if not run_dir:
        raise SystemExit("--method splade needs --run <trained run dir>")
    device = torch.device(args.get("device", "cuda"))
    params, mcfg, tok, rc = load_run(run_dir, device=device)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=rc.max_q_tokens,
                                 max_d_tokens=rc.max_d_tokens)
    topk_terms = int(args.get("splade_terms", 128))
    batch = int(args.get("encode_batch", 64))

    def encode(tokens, mask):
        w, t = encode_corpus_sparse(params, mcfg,
                                    torch.from_numpy(tokens).to(device),
                                    torch.from_numpy(mask).to(device),
                                    k=topk_terms, batch_size=batch)
        return w.cpu().numpy(), t.cpu().numpy()

    d_w, d_t = encode(store.d_tokens, store.d_mask)
    index = SparseIndex.build(
        d_t, d_w, num_terms=mcfg.vocab_size,
        quantize=args.get("quantize", "1") not in ("0", "false", "False"))
    q_w, q_t = encode(store.q_tokens, store.q_mask)
    for row, qid in enumerate(corpus.query_ids):
        ids, _ = index.search(q_t[row], q_w[row],
                              k=min(cutoff, corpus.num_docs))
        yield qid, ids


if __name__ == "__main__":
    main()
