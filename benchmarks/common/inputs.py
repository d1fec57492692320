"""A cell's inputs: the corpus and pairs drawn from the seed on the card,
from the configuration's ``vocab_size`` and prompt ``tokens``. The
program and the plain reference get the same inputs."""

from __future__ import annotations

import torch

from benchmarks.common import data


def make_corpus(config: dict, traffic: dict, seed: int, device) -> dict:
    """Queries, documents and pairs (a positive and a pool of doc rows
    each) drawn from the seed on ``device``."""
    tok = config["tokens"]
    V = config["vocab_size"]
    g = data.generator(seed, "corpus", device)
    nq, nd = traffic["queries"], traffic["docs"]
    q_len = data.lengths(g, nq, traffic["query_len"], device)
    d_len = data.lengths(g, nd, traffic["doc_len"], device)
    return {
        "q_tokens": data.token_matrix(g, q_len, traffic["max_q"],
                                      tok["first_word"], V, tok["pad"]),
        "d_tokens": data.token_matrix(g, d_len, traffic["max_d"],
                                      tok["first_word"], V, tok["pad"]),
        "query_rows": torch.arange(nq, device=device),
        "pos_rows": torch.randint(nd, (nq,), generator=g, device=device),
        "pools": torch.randint(nd, (nq, traffic["pool"]), generator=g,
                               device=device),
    }
