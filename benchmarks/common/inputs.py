"""A cell's inputs: the architecture's sizes, the port's model
configuration, and the corpus and pairs drawn from the seed on the
card. The program and the plain reference get the same inputs."""

from __future__ import annotations

import torch

from benchmarks.common import data


def model_dict(config: dict) -> dict:
    """The architecture's sizes under the reference's key names."""
    keys = ("vocab_size", "d_model", "d_kv", "d_ff", "num_heads",
            "num_layers", "num_decoder_layers",
            "relative_attention_num_buckets",
            "relative_attention_max_distance", "layer_norm_epsilon")
    return {k: config[k] for k in keys}


def port_model_config(config: dict, remat: bool):
    from pacednegatives_tpu_torch.models.t5 import T5Config

    run = config["run"]
    if config["feed_forward_proj"] != "relu":
        raise ValueError("only the T5 v1.0 ReLU FFN is benchmarked")
    return T5Config(
        **model_dict(config),
        gated_ffn=False,
        tie_word_embeddings=config["tie_word_embeddings"],
        pad_token_id=config["pad_token_id"],
        decoder_start_token_id=config["decoder_start_token_id"],
        dtype={"bfloat16": torch.bfloat16,
               "float32": torch.float32}[run["dtype"]],
        flash_v3=run["flash_v3"], fused_qkv=run["fused_qkv"],
        remat=remat)


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
