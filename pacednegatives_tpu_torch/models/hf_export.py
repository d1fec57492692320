"""Export the port's parameter tree as a HuggingFace T5 checkpoint
directory: the port of models/hf_export.py, the exact inverse of
models/hf_import.py.

A user of the reference evaluates saved models through
``pyterrier_t5.MonoT5ReRanker(model=dir)`` after ``model.save_pretrained``
(train/train_lce.py:103); the directory written here loads in
``transformers.T5ForConditionalGeneration.from_pretrained``. It is written
without ``transformers`` or ``safetensors``: ``config.json`` with the keys
``transformers.T5Config`` writes, and ``model.safetensors`` (fp32, the
tied embedding stored once as ``shared.weight``, as transformers stores
it).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import torch

from pacednegatives_tpu_torch.models.t5 import T5Config, unstack_params

_SAFETENSORS_NAMES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}


def hf_config_from(cfg: T5Config) -> dict:
    """The ``config.json`` of ``cfg``: the keys and values that
    ``transformers.T5Config(...).to_dict()`` writes for it."""
    gated = cfg.gated_ffn
    return {
        "architectures": ["T5ForConditionalGeneration"],
        "classifier_dropout": 0.0,
        "d_ff": cfg.d_ff,
        "d_kv": cfg.d_kv,
        "d_model": cfg.d_model,
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "dense_act_fn": "gelu_new" if gated else "relu",
        "dropout_rate": cfg.dropout_rate,
        "dtype": "float32",
        "eos_token_id": 1,
        "feed_forward_proj": "gated-gelu" if gated else "relu",
        "initializer_factor": 1.0,
        "is_encoder_decoder": True,
        "is_gated_act": gated,
        "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "model_type": "t5",
        "num_decoder_layers": cfg.num_decoder_layers,
        "num_heads": cfg.num_heads,
        "num_layers": cfg.num_layers,
        "pad_token_id": cfg.pad_token_id,
        "relative_attention_max_distance":
            cfg.relative_attention_max_distance,
        "relative_attention_num_buckets": cfg.relative_attention_num_buckets,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "use_cache": True,
        "vocab_size": cfg.vocab_size,
    }


def state_dict_from_params(params: Any, cfg: T5Config) -> dict:
    """The port's tree (``block_i`` or stacked ``blocks``) -> a
    T5ForConditionalGeneration state dict of fp32 host tensors; with tied
    embeddings ``lm_head`` and both ``embed_tokens`` alias
    ``shared.weight``."""
    if "blocks" in params["encoder"]:
        params = unstack_params(params)

    t = lambda x: x.detach().to("cpu", torch.float32)
    sd: dict = {"shared.weight": t(params["shared"]["embedding"])}

    def attn(prefix, p, rel):
        for k in ("q", "k", "v", "o"):
            sd[f"{prefix}.{k}.weight"] = t(p[k]).t().contiguous()
        if rel:
            sd[f"{prefix}.relative_attention_bias.weight"] = t(p["rel_bias"])

    def mlp(prefix, p):
        keys = ("wi_0", "wi_1", "wo") if cfg.gated_ffn else ("wi", "wo")
        for k in keys:
            sd[f"{prefix}.{k}.weight"] = t(p[k]).t().contiguous()

    for i in range(cfg.num_layers):
        blk = params["encoder"][f"block_{i}"]
        b = f"encoder.block.{i}.layer"
        attn(f"{b}.0.SelfAttention", blk["self_attn"], rel=(i == 0))
        sd[f"{b}.0.layer_norm.weight"] = t(blk["ln_self"]["scale"])
        mlp(f"{b}.1.DenseReluDense", blk["mlp"])
        sd[f"{b}.1.layer_norm.weight"] = t(blk["ln_mlp"]["scale"])
    sd["encoder.final_layer_norm.weight"] = t(
        params["encoder"]["final_ln"]["scale"]
    )

    for i in range(cfg.num_decoder_layers):
        blk = params["decoder"][f"block_{i}"]
        b = f"decoder.block.{i}.layer"
        attn(f"{b}.0.SelfAttention", blk["self_attn"], rel=(i == 0))
        sd[f"{b}.0.layer_norm.weight"] = t(blk["ln_self"]["scale"])
        attn(f"{b}.1.EncDecAttention", blk["cross_attn"], rel=False)
        sd[f"{b}.1.layer_norm.weight"] = t(blk["ln_cross"]["scale"])
        mlp(f"{b}.2.DenseReluDense", blk["mlp"])
        sd[f"{b}.2.layer_norm.weight"] = t(blk["ln_mlp"]["scale"])
    sd["decoder.final_layer_norm.weight"] = t(
        params["decoder"]["final_ln"]["scale"]
    )

    if cfg.tie_word_embeddings:
        sd["lm_head.weight"] = sd["shared.weight"]
        sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
        sd["decoder.embed_tokens.weight"] = sd["shared.weight"]
    else:
        sd["lm_head.weight"] = t(params["lm_head"]["embedding"])
    return sd


def write_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """{name: tensor} -> a ``.safetensors`` file: the header length
    (8 bytes, little-endian), the JSON header (with the ``{"format":
    "pt"}`` metadata transformers checks) padded with spaces to a multiple
    of 8 bytes, then each tensor's bytes in name order."""
    header: dict = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for name in sorted(tensors):
        x = tensors[name].detach().to("cpu").contiguous()
        blob = x.view(-1).view(torch.uint8).numpy().tobytes() \
            if x.numel() else b""
        header[name] = {"dtype": _SAFETENSORS_NAMES[x.dtype],
                        "shape": list(x.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def save_pretrained(params: Any, cfg: T5Config, path: str) -> None:
    """Write a transformers-loadable T5ForConditionalGeneration directory:
    ``config.json`` and ``model.safetensors`` (aliases of a tied embedding
    dropped, as transformers drops them). It takes whole leaves: under a
    tensor-parallel mesh the caller gathers them first (``gather_params``
    or ``gather_train_state``, a collective on every rank) and calls this
    on rank 0 only."""
    sd = state_dict_from_params(params, cfg)
    if cfg.tie_word_embeddings:
        for alias in ("lm_head.weight", "encoder.embed_tokens.weight",
                      "decoder.embed_tokens.weight"):
            del sd[alias]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_from(cfg), f, indent=2, sort_keys=True)
    write_safetensors(sd, os.path.join(path, "model.safetensors"))
