"""The yardstick's arithmetic for DeepSeek-V3's layers: model FLOPs of a
forward, and the operations and bytes of the grouped expert GEMMs (M1)
that the roofline shares divide by the device time under the port's
``pnt.moe.experts`` (forward) and ``pnt.moe.experts.bwd`` (backward)
spans.

Counted once each: every input byte read, every output byte written, in
bf16 (2 bytes); the slots are the token-expert pairs the held experts
computed (the port's ``moe.slots`` counter), not the rows padded to the
kernel's 128-row tiles.
"""

from __future__ import annotations

from benchmarks.common.flops import bound_s


def deepseek_v3_forward_flops(s: dict, rows: float, sum_len: float,
                              sum_len_sq: float) -> float:
    """Matmul FLOPs of one forward of ``rows`` prompts whose real lengths
    sum to ``sum_len`` (their squares to ``sum_len_sq``), pads not
    counted. Per real token and layer: MLA's q, kv_a, kv_b and o
    projections; causal attention over the real keys at and before it
    ((sum_len_sq + sum_len) / 2 pairs, q.k at dk = nope + rope and p.v at
    dv); a dense layer's SwiGLU, or the router, the shared experts and the
    held experts at their expected share of the k slots (k x held /
    router width). The head once a row (its last real position)."""
    D, H = s["hidden_size"], s["num_attention_heads"]
    r, dn, dr, dv = (s["kv_lora_rank"], s["qk_nope_head_dim"],
                     s["qk_rope_head_dim"], s["v_head_dim"])
    held = s["experts_held"][1]
    E, k = s["n_routed_experts"], s["num_experts_per_tok"]
    Fe = s["moe_intermediate_size"]
    Fs = Fe * s["n_shared_experts"]
    mla = 2.0 * (D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv)
                 + H * dv * D)
    pairs = (sum_len_sq + sum_len) / 2.0
    attn = 2.0 * H * (dn + dr + dv) * pairs
    dense = 6.0 * D * s["intermediate_size"]
    moe = 2.0 * D * E + 6.0 * D * Fs + k * held / E * 6.0 * D * Fe
    L = s["num_hidden_layers"]
    n_dense = min(s["first_k_dense_replace"], L)
    per_token = L * mla + n_dense * dense + (L - n_dense) * moe
    return float(per_token * sum_len + L * attn
                 + rows * 2.0 * D * s["vocab_size"])


def expert_gemms(s: dict, slots: float, calls: int) -> list:
    """[(operations, bytes)] of the forward's two grouped GEMMs (gate|up,
    down) over ``calls`` expert layers that computed ``slots`` pairs in
    all: each product once, the held experts' weights read once a call."""
    D, Fe = s["hidden_size"], s["moe_intermediate_size"]
    held = s["experts_held"][1]
    gate_up = (2.0 * slots * D * 2 * Fe,
               2.0 * (slots * D + calls * held * D * 2 * Fe
                      + slots * 2 * Fe))
    down = (2.0 * slots * Fe * D,
            2.0 * (slots * Fe + calls * held * Fe * D + slots * D))
    return [gate_up, down]


def expert_gemms_bwd(s: dict, slots: float, calls: int) -> list:
    """[(operations, bytes)] of their backward: for each, dX (dY and the
    weights in, dX out) and dW (X and dY in, dW out)."""
    D, Fe = s["hidden_size"], s["moe_intermediate_size"]
    held = s["experts_held"][1]
    out = []
    for k_in, n_out in ((D, 2 * Fe), (Fe, D)):
        w = calls * held * k_in * n_out
        out.append((2 * 2.0 * slots * k_in * n_out,
                    2.0 * (slots * n_out + w + slots * k_in  # dX
                           + slots * k_in + slots * n_out + w)))  # dW
    return out


def least_s(work: list, peak: float) -> float:
    """The least time of a list of (operations, bytes)."""
    return sum(bound_s(b, f, peak) for f, b in work)
