"""Import HuggingFace T5 checkpoints into the port's parameter tree: the
port of models/hf_import.py.

A checkpoint directory is read without ``transformers`` or ``safetensors``:
``config.json`` as a plain dict (the keys ``transformers.T5Config``
writes, its defaults for any that are absent), the weights from
``model.safetensors`` (a small reader of the format: an 8-byte
little-endian header length, a JSON header, then the raw tensors) or
``pytorch_model.bin`` through ``torch.load(weights_only=True)``. HF linear weights are (out, in);
the port's tree is (in, out), with the JAX package's paths, so every
projection is transposed. With tied embeddings a checkpoint need not hold
``lm_head.weight`` (transformers writes ``shared.weight`` alone); the
forward then scales the decoder output by d_model**-0.5 before the tied
head (``t5.decode``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import torch

from pacednegatives_tpu_torch.models.t5 import T5Config, tree_map

# transformers.T5Config's defaults for the keys the port reads
_HF_DEFAULTS = {
    "vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048,
    "num_layers": 6, "num_decoder_layers": None, "num_heads": 8,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "dropout_rate": 0.1,
    "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu",
    "tie_word_embeddings": True, "pad_token_id": 0,
    "decoder_start_token_id": None,
}

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def config_from_hf(hf_config: Any) -> T5Config:
    """A ``T5Config`` from a ``config.json`` dict or a ``transformers``
    config object."""
    if isinstance(hf_config, Mapping):
        get = lambda k: hf_config.get(k, _HF_DEFAULTS[k])
    else:
        get = lambda k: getattr(hf_config, k, _HF_DEFAULTS[k])
    num_decoder_layers = get("num_decoder_layers")
    return T5Config(
        vocab_size=get("vocab_size"),
        d_model=get("d_model"),
        d_kv=get("d_kv"),
        d_ff=get("d_ff"),
        num_heads=get("num_heads"),
        num_layers=get("num_layers"),
        num_decoder_layers=(get("num_layers") if num_decoder_layers is None
                            else num_decoder_layers),
        relative_attention_num_buckets=get("relative_attention_num_buckets"),
        relative_attention_max_distance=get(
            "relative_attention_max_distance"),
        dropout_rate=get("dropout_rate"),
        layer_norm_epsilon=get("layer_norm_epsilon"),
        tie_word_embeddings=get("tie_word_embeddings"),
        gated_ffn=get("feed_forward_proj").startswith("gated"),
        pad_token_id=get("pad_token_id"),
        decoder_start_token_id=get("decoder_start_token_id"),
    )


def _t(x) -> torch.Tensor:
    # an fp32 copy on the host that owns its storage, never a view of the
    # state dict's tensor
    return x.detach().to("cpu", torch.float32).clone()


def params_from_hf_state_dict(sd: Mapping[str, Any], cfg: T5Config) -> dict:
    """Map a T5ForConditionalGeneration state dict to the port's tree of
    fp32 host tensors (every projection transposed to (in, out); the
    relative-attention tables are (num_buckets, heads) in both)."""

    def lin(key: str) -> torch.Tensor:
        return _t(sd[key]).t().contiguous()

    def attn(prefix: str, rel: bool) -> dict:
        p = {k: lin(f"{prefix}.{k}.weight") for k in ("q", "k", "v", "o")}
        if rel:
            p["rel_bias"] = _t(sd[f"{prefix}.relative_attention_bias.weight"])
        return p

    def mlp_params(prefix: str) -> dict:
        keys = ("wi_0", "wi_1", "wo") if cfg.gated_ffn else ("wi", "wo")
        return {k: lin(f"{prefix}.{k}.weight") for k in keys}

    encoder: dict = {}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        encoder[f"block_{i}"] = {
            "self_attn": attn(f"{b}.0.SelfAttention", rel=(i == 0)),
            "ln_self": {"scale": _t(sd[f"{b}.0.layer_norm.weight"])},
            "mlp": mlp_params(f"{b}.1.DenseReluDense"),
            "ln_mlp": {"scale": _t(sd[f"{b}.1.layer_norm.weight"])},
        }
    encoder["final_ln"] = {"scale": _t(sd["encoder.final_layer_norm.weight"])}

    decoder: dict = {}
    for i in range(cfg.num_decoder_layers):
        b = f"decoder.block.{i}.layer"
        decoder[f"block_{i}"] = {
            "self_attn": attn(f"{b}.0.SelfAttention", rel=(i == 0)),
            "ln_self": {"scale": _t(sd[f"{b}.0.layer_norm.weight"])},
            "cross_attn": attn(f"{b}.1.EncDecAttention", rel=False),
            "ln_cross": {"scale": _t(sd[f"{b}.1.layer_norm.weight"])},
            "mlp": mlp_params(f"{b}.2.DenseReluDense"),
            "ln_mlp": {"scale": _t(sd[f"{b}.2.layer_norm.weight"])},
        }
    decoder["final_ln"] = {"scale": _t(sd["decoder.final_layer_norm.weight"])}

    params = {
        "shared": {"embedding": _t(sd["shared.weight"])},
        "encoder": encoder,
        "decoder": decoder,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"embedding": _t(sd["lm_head.weight"])}
    return params


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: host tensor}: the 8-byte
    little-endian header length, the JSON header ({name: {dtype, shape,
    data_offsets}}, and ``__metadata__``), then the tensors' bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        t = torch.frombuffer(data, dtype=dtype, count=(end - begin)
                             // dtype.itemsize, offset=begin) \
            if end > begin else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The weights of an HF checkpoint directory: ``model.safetensors`` or
    ``pytorch_model.bin``."""
    single = os.path.join(path, "model.safetensors")
    binary = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"{path}: no model.safetensors or pytorch_model.bin")


def load_hf_checkpoint(path: str, device: torch.device | str = "cuda"):
    """Load a local HF T5 checkpoint directory -> (params on ``device``,
    T5Config)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    params = params_from_hf_state_dict(read_state_dict(path), cfg)
    return tree_map(lambda t: t.to(device), params), cfg
