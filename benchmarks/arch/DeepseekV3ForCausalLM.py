"""The hooks of ``DeepseekV3ForCausalLM``: DeepSeek-V3's layers (MLA, a
dense SwiGLU, then sigmoid-routed expert layers with shared experts) as a
pointwise reranker, on one rank's share of an expert-parallel deployment
(see ``T5ForConditionalGeneration.py`` for what each hook returns).

The configuration file keeps the published keys, but for the cut it
names in ``reduced``: ``n_routed_experts`` is the count held here, and
``deployment`` gives the router's width (``router_experts``, the
published count) and the experts held (``experts_held``, first and
count). ``sizes`` returns ``n_routed_experts`` as the router's width.

Weights: one draw made on the device, the tree in the port's leaf names
and (in, out) orientation: an (in, out) matrix N(0, in^-0.5), the
embedding N(0, 1), the head N(0, D^-0.5), the router's correction bias
N(0, BIAS_STD), norm scales 1. All normal draws come from one
``torch.randn`` over the whole count; each leaf is a view of it, scaled in
place.
"""

from __future__ import annotations

import torch

from benchmarks.common.data import generator
from benchmarks.common.moe_flops import deepseek_v3_forward_flops
from benchmarks.reference.deepseek_v3 import Model

SIZE_KEYS = ("vocab_size", "hidden_size", "intermediate_size",
             "moe_intermediate_size", "num_hidden_layers",
             "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok",
             "n_shared_experts", "first_k_dense_replace",
             "routed_scaling_factor", "norm_topk_prob", "rms_norm_eps",
             "rope_theta")
BIAS_STD = 0.05


def sizes(config: dict) -> dict:
    """The sizes under HF's names; ``n_routed_experts`` the router's width,
    ``experts_held`` (first, count)."""
    if config.get("q_lora_rank") is not None:
        raise ValueError("only MLA without a q LoRA is benchmarked")
    dep = config["deployment"]
    first, held = dep["experts_held"]
    if held != config["n_routed_experts"]:
        raise ValueError("n_routed_experts counts the experts held here")
    return {**{k: config[k] for k in SIZE_KEYS},
            "n_routed_experts": dep["router_experts"],
            "experts_held": (first, held)}


def port_config(config: dict, remat: bool):
    from pacednegatives_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    if remat:
        raise ValueError("the DeepSeek-V3 step runs without remat")
    s = sizes(config)
    return DeepseekV3Config(
        **s, pad_token_id=config["pad_token_id"],
        dtype={"bfloat16": torch.bfloat16,
               "float32": torch.float32}[config["run"]["dtype"]])


def leaves(s: dict) -> list:
    """[(path, shape, std)] in a fixed order; std None for a norm scale,
    "bias" for the correction bias."""
    D, H = s["hidden_size"], s["num_attention_heads"]
    r, dn, dr, dv = (s["kv_lora_rank"], s["qk_nope_head_dim"],
                     s["qk_rope_head_dim"], s["v_head_dim"])
    held = s["experts_held"][1]
    Fe = s["moe_intermediate_size"]
    Fs = Fe * s["n_shared_experts"]
    out = [("embed.embedding", (s["vocab_size"], D), 1.0)]
    for i in range(s["num_hidden_layers"]):
        p = f"layers.layer_{i}"
        out += [(f"{p}.attn_norm.scale", (D,), None),
                (f"{p}.attn.q", (D, H * (dn + dr)), D ** -0.5),
                (f"{p}.attn.kv_a", (D, r + dr), D ** -0.5),
                (f"{p}.attn.kv_norm.scale", (r,), None),
                (f"{p}.attn.kv_b", (r, H * (dn + dv)), r ** -0.5),
                (f"{p}.attn.o", (H * dv, D), (H * dv) ** -0.5),
                (f"{p}.mlp_norm.scale", (D,), None)]
        if i < s["first_k_dense_replace"]:
            F = s["intermediate_size"]
            out += [(f"{p}.mlp.gate", (D, F), D ** -0.5),
                    (f"{p}.mlp.up", (D, F), D ** -0.5),
                    (f"{p}.mlp.down", (F, D), F ** -0.5)]
            continue
        out += [(f"{p}.router.weight", (D, s["n_routed_experts"]),
                 D ** -0.5),
                (f"{p}.router.bias", (s["n_routed_experts"],), BIAS_STD),
                (f"{p}.experts.gate", (held, D, Fe), D ** -0.5),
                (f"{p}.experts.up", (held, D, Fe), D ** -0.5),
                (f"{p}.experts.down", (held, Fe, D), Fe ** -0.5),
                (f"{p}.shared.gate", (D, Fs), D ** -0.5),
                (f"{p}.shared.up", (D, Fs), D ** -0.5),
                (f"{p}.shared.down", (Fs, D), Fs ** -0.5)]
    out += [("norm.scale", (D,), None),
            ("head.weight", (D, s["vocab_size"]), D ** -0.5)]
    return out


def weights(config: dict, seed: int, device) -> dict:
    """Flat {path: fp32 tensor} of the weights for ``seed``."""
    tree = leaves(sizes(config))
    total = sum(torch.Size(shape).numel() for _, shape, std in tree
                if std is not None)
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
    """The plain model over ``weights``; its loss is the CE of each row's
    verbalizer id at the last real position."""
    return Model(sizes(config), weights, precision)


def forward_flops(sizes: dict, rows: float, sum_len: float,
                  sum_len_sq: float, trained: bool) -> float:
    """``deepseek_v3_forward_flops``: real tokens, the held experts at
    their expected share; the head once a row, trained or scored."""
    del trained
    return deepseek_v3_forward_flops(sizes, rows, sum_len, sum_len_sq)
