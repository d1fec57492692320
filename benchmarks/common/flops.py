"""The yardstick's arithmetic: model FLOPs of T5 rows, the work of the
encoder's self-attention block, and one H100's peaks.

Frozen copies, so that a later change to the program cannot move the
yardstick: ``t5_forward_flops`` follows ``utils/profiling.py``'s
``t5_forward_flops`` but counts each row at its own real length (the
original takes one encoder length for every row); ``bound_s`` is
``chip_smoke.py``'s ``bound``; ``PEAK_BF16_FLOPS`` is
``utils/profiling.py``'s table.
"""

from __future__ import annotations

# dense bf16 tensor-core peak per card, FLOP/s (NVIDIA's data sheets,
# without sparsity), keyed on a substring of torch.cuda.get_device_name
PEAK_BF16_FLOPS = {
    "h100 80gb hbm3": 989.4e12,  # H100 SXM5, 700 W
    "h100 pcie": 756e12,  # H100 PCIe, 350 W
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3


def peak_flops(device_name: str) -> float | None:
    name = device_name.lower()
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in name:
            return peak
    return None


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time of a piece of work: the larger of its bytes over the
    memory rate and its operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def t5_forward_flops(cfg: dict, n_rows: int, sum_len: float,
                     sum_len_sq: float, l_dec: int) -> float:
    """Matmul FLOPs of one forward of ``n_rows`` monoT5 prompts whose real
    encoder lengths sum to ``sum_len`` (their squares to ``sum_len_sq``),
    each decoding ``l_dec`` positions. Per encoder layer: the Q/K/V/O
    projections, scores and values, the FFN; per decoder layer: self
    attention on ``l_dec`` positions, cross attention (K/V projected from
    the encoder's real tokens), the FFN; then the tied LM head. Pads are
    not counted, and neither is recompute."""
    h, dk, dm, dff = (cfg["num_heads"], cfg["d_kv"], cfg["d_model"],
                      cfg["d_ff"])
    inner = h * dk
    mats = 3 if cfg.get("gated_ffn", False) else 2
    enc = cfg["num_layers"] * (
        2.0 * dm * inner * 4 * sum_len
        + 4.0 * h * dk * sum_len_sq
        + 2.0 * dm * dff * mats * sum_len)
    per_row_dec = (
        2.0 * l_dec * dm * inner * 4  # self q, k, v, o
        + 4.0 * l_dec * l_dec * h * dk  # self scores + values
        + 2.0 * l_dec * dm * inner * 2  # cross q, o
        + 2.0 * l_dec * dm * dff * mats)
    cross_kv = 2.0 * dm * inner * 2 * sum_len + 4.0 * l_dec * h * dk * sum_len
    dec = cfg["num_decoder_layers"] * (n_rows * per_row_dec + cross_kv)
    lm_head = n_rows * 2.0 * l_dec * dm * cfg["vocab_size"]
    return float(enc + dec + lm_head)


def attn_block_fwd(B: int, L: int, d: int, H: int, dk: int) -> tuple:
    """(operations, bytes) of y = attn(x . Wqkv) . Wo at its call's shapes
    (bf16 activations and weights, fp32 position bias (H, L, L) and key
    mask (B, L)): the QKV projection, scores and values, the output
    projection; each input read once and the output written once."""
    inner = H * dk
    T = B * L
    flops = (2.0 * T * d * 3 * inner + 4.0 * B * H * L * L * dk
             + 2.0 * T * inner * d)
    nbytes = (T * d * 2 + d * 3 * inner * 2 + inner * d * 2
              + H * L * L * 4 + B * L * 4 + T * d * 2)
    return flops, float(nbytes)


def attn_block_bwd(B: int, L: int, d: int, H: int, dk: int) -> tuple:
    """(operations, bytes) of the block's backward: the two products of
    each projection's gradient (input and weight) and the core's five
    L x L x dk products (s recomputed, dp, dv, dq, dk), each once; in
    x, the weights, the bias, the mask, the softmax's (m, l) and dy, out
    dx, dWqkv, dWo (bf16) and dpos (fp32)."""
    inner = H * dk
    T = B * L
    flops = (2 * 2.0 * T * d * 3 * inner + 10.0 * B * H * L * L * dk
             + 2 * 2.0 * T * inner * d)
    nbytes = (2 * (T * d * 2 + d * 3 * inner * 2 + inner * d * 2)
              + 2 * H * L * L * 4 + B * L * 4 + 2 * B * H * L * 4
              + T * d * 2)
    return flops, float(nbytes)
