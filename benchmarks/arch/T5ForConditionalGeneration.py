"""The hooks of ``T5ForConditionalGeneration``: T5 v1.0 as monoT5 runs it.

An architecture's hooks live in ``benchmarks/arch/<architectures[0]>.py``,
named by the first entry of the configuration file's published
``architectures``. The harness reaches the architecture only through
these five functions:

- ``sizes(config)``: the dict the per-layer readers get as ``ctx.model``;
- ``port_config(config, remat)``: the port's model configuration (the
  only place a hook module imports the port);
- ``weights(config, seed, device)``: flat {path: fp32 tensor} from the
  seed, under the port's leaf names;
- ``reference(config, weights, precision)``: the plain reference model
  (``benchmarks/reference/``), with ``score(ids, mask, true_id,
  false_id)`` and ``loss(ids, mask, label_ids)``, the per-row training
  loss of each row's verbalizer id;
- ``forward_flops(sizes, rows, sum_len, sum_len_sq, trained)``: the model
  FLOPs of one forward of ``rows`` prompts at their real lengths.

Weights: one draw made on the device, the tree in the port's leaf names
and (in, out) orientation, with T5's initialisation scales (q: (d_model *
d_kv)^-0.5, k / v: d_model^-0.5, o: inner^-0.5, rel_bias: d_model^-0.5,
FFN in: d_model^-0.5, out: d_ff^-0.5, the shared embedding 1.0, norm
scales 1). All normal draws come from one ``torch.randn`` over the whole
parameter count; each leaf is a view of it, scaled in place.
"""

from __future__ import annotations

import torch

from benchmarks.common.data import generator
from benchmarks.common.flops import t5_forward_flops
from benchmarks.reference.t5 import Model

SIZE_KEYS = ("vocab_size", "d_model", "d_kv", "d_ff", "num_heads",
             "num_layers", "num_decoder_layers",
             "relative_attention_num_buckets",
             "relative_attention_max_distance", "layer_norm_epsilon")


def sizes(config: dict) -> dict:
    """The architecture's sizes under the reference's key names."""
    return {k: config[k] for k in SIZE_KEYS}


def port_config(config: dict, remat: bool):
    from pacednegatives_tpu_torch.models.t5 import T5Config

    run = config["run"]
    if config["feed_forward_proj"] != "relu":
        raise ValueError("only the T5 v1.0 ReLU FFN is benchmarked")
    return T5Config(
        **sizes(config),
        gated_ffn=False,
        tie_word_embeddings=config["tie_word_embeddings"],
        pad_token_id=config["pad_token_id"],
        decoder_start_token_id=config["decoder_start_token_id"],
        dtype={"bfloat16": torch.bfloat16,
               "float32": torch.float32}[run["dtype"]],
        flash_v3=run["flash_v3"], fused_qkv=run["fused_qkv"],
        remat=remat)


def leaves(cfg: dict) -> list:
    """[(path, shape, std)] of ``sizes`` in a fixed order; std None for a
    norm scale."""
    d, dk, H, ff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    inner = H * dk
    nb = cfg["relative_attention_num_buckets"]

    def attn(prefix, rel_bias):
        out = [(f"{prefix}.q", (d, inner), (d * dk) ** -0.5),
               (f"{prefix}.k", (d, inner), d ** -0.5),
               (f"{prefix}.v", (d, inner), d ** -0.5),
               (f"{prefix}.o", (inner, d), inner ** -0.5)]
        if rel_bias:
            out.append((f"{prefix}.rel_bias", (nb, H), d ** -0.5))
        return out

    def mlp(prefix):
        return [(f"{prefix}.wi", (d, ff), d ** -0.5),
                (f"{prefix}.wo", (ff, d), ff ** -0.5)]

    out = [("shared.embedding", (cfg["vocab_size"], d), 1.0)]
    for i in range(cfg["num_layers"]):
        p = f"encoder.block_{i}"
        out += attn(f"{p}.self_attn", i == 0)
        out += [(f"{p}.ln_self.scale", (d,), None)]
        out += mlp(f"{p}.mlp")
        out += [(f"{p}.ln_mlp.scale", (d,), None)]
    out.append(("encoder.final_ln.scale", (d,), None))
    for i in range(cfg["num_decoder_layers"]):
        p = f"decoder.block_{i}"
        out += attn(f"{p}.self_attn", i == 0)
        out += [(f"{p}.ln_self.scale", (d,), None)]
        out += attn(f"{p}.cross_attn", False)
        out += [(f"{p}.ln_cross.scale", (d,), None)]
        out += mlp(f"{p}.mlp")
        out += [(f"{p}.ln_mlp.scale", (d,), None)]
    out.append(("decoder.final_ln.scale", (d,), None))
    return out


def weights(config: dict, seed: int, device) -> dict:
    """Flat {path: fp32 tensor} of the weights for ``seed``."""
    tree = leaves(sizes(config))
    drawn = [(k, s, std) for k, s, std in tree if std is not None]
    total = sum(torch.Size(s).numel() for _, s, _ in drawn)
    buf = torch.randn(total, generator=generator(seed, "weights", device),
                      device=device, dtype=torch.float32)
    flat, at = {}, 0
    for key, shape, std in tree:
        if std is None:
            flat[key] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = torch.Size(shape).numel()
        flat[key] = buf[at:at + n].view(shape).mul_(std)
        at += n
    return flat


def reference(config: dict, weights: dict, precision: str = "fp32") -> Model:
    """The plain T5 over ``weights``; its loss teacher-forces the labels
    [verbalizer, eos]."""
    return Model(sizes(config), weights, precision,
                 eos_id=config["tokens"]["eos"])


def forward_flops(sizes: dict, rows: float, sum_len: float,
                  sum_len_sq: float, trained: bool) -> float:
    """``t5_forward_flops`` with 2 decoder positions for a trained row (the
    verbalizer and eos) and 1 for a scored row."""
    return t5_forward_flops(sizes, rows, sum_len, sum_len_sq,
                            2 if trained else 1)
