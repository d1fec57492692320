"""int8 (W8A8 dynamic) monoT5 scoring forward: the port of models/quant.py.

The no-grad scoring pass needs rank fidelity, not gradients, so its
projections and FFN run as int8 x int8 -> int32 products. The JAX package
computes them with ``lax.dot_general`` outside any kernel; the port with
``torch._int_mm`` (cuBLASLt on the card, a library product, not a hand
kernel) and plain PyTorch around it.

Scheme, as in the JAX package:
- weights: per-OUTPUT-channel symmetric int8 (scale = max|W[:, o]| / 127),
  quantized once per parameter snapshot (``quantize_scoring_params``);
- activations: per-token symmetric int8, quantized at each linear's input
  (scale = max|x| over the feature axis / 127), ``x / s`` as a division and
  ``torch.round``, which rounds half to even as ``jnp.round`` does;
- the int32 accumulator is dequantized in fp32 as ``(acc * sx) * sw``;
- embeddings, RMS-norm (fp32 variance), softmax (fp32), the position-bias
  tables and the 2-row verbalizer head stay exact; the QK^T / PV products
  take bf16 operands with fp32 accumulation (``preferred_element_type=
  float32``), here as fp32 products of bf16-rounded operands, which are
  exact in fp32 (and in TF32).

The decoder runs one step (monoT5 scores the first decode position), where
self-attention over a single position is the value projection followed by
the output projection, and the LM head needs only the two verbalizer rows
of the (tied) embedding. Nothing here is used for training.

Under tensor parallelism (a rank's slices of the weights, parallel/mesh.py)
the forward runs split as models/t5.py's does: q/k/v and wi* on the rank's
heads and d_ff columns, their scales per output channel as they are; o and
wo on the rank's input rows, where a per-output-channel weight scale and a
per-token activation scale are maxima over a split axis, so both are
reduced (max) over the model group, and the ranks' exact int32 partial
products are summed over it before the one dequantisation (GSPMD sums the
int32 product of a split contraction the same way). The embedding rows
and the two verbalizer rows come from the ranks that own them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.models.monot5 import (
    VERBALIZER_FALSE,
    VERBALIZER_TRUE,
)
from pacednegatives_tpu_torch.parallel.collectives import model_max, model_sum
from pacednegatives_tpu_torch.parallel.mesh import model_split

_EPS = 1e-8
# torch._int_mm on CUDA (cuBLASLt) takes more than 16 rows, a multiple of
# 8; other counts (the decoder's one-position rows at a small batch) are
# padded with zero rows and the result sliced back
_INT_MM_MIN_ROWS, _INT_MM_ROW_MULTIPLE = 32, 8


def _quantize_weight(w: torch.Tensor, mesh=None) -> dict:
    """(d, o) float weight -> int8 + per-output-channel fp32 scale. The
    codes are stored K-major (a (d, o) view of an (o, d) tensor), the
    layout cuBLASLt's int8 tensor-core products take; a column slice of
    it (a fused layout's q, k or v) stays K-major without a copy. With a
    ``mesh`` the rank holds a slice of the input rows (row-parallel), and
    each channel's max is the model group's."""
    w = w.float()
    amax = w.abs().amax(dim=0, keepdim=True)
    if mesh is not None:
        amax = model_max(amax, mesh)
    s = torch.clamp_min(amax, _EPS) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"w": q.t().contiguous().t(), "s": s}


def _quantize_tokens(x: torch.Tensor,
                     mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., d) float -> int8 codes and per-token fp32 scales (..., 1);
    with a ``mesh`` x holds a slice of the features, and each token's max
    is the model group's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if mesh is not None:
        amax = model_max(amax, mesh)
    sx = torch.clamp_min(amax, _EPS) / 127.0
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def _int8_matmul(xq: torch.Tensor, sx: torch.Tensor, qw: dict,
                 out_dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """int8 codes (..., d) with their per-token scales, times an int8
    weight: the exact int32 product, dequantized as ``(acc * sx) * sw``;
    with a ``mesh`` (a row-parallel slice) the int32 partial products are
    summed over the model group first."""
    rows = xq.reshape(-1, xq.shape[-1])
    m = rows.shape[0]
    padded = max(_INT_MM_MIN_ROWS, -(-m // _INT_MM_ROW_MULTIPLE)
                 * _INT_MM_ROW_MULTIPLE)
    if padded != m:
        rows = F.pad(rows, (0, 0, 0, padded - m))
    acc = torch._int_mm(rows.contiguous(), qw["w"])[:m]
    if mesh is not None:
        acc = model_sum(acc, mesh)
    acc = acc.reshape(*xq.shape[:-1], acc.shape[-1])
    # int32 * fp32 converts in the kernel: (float(acc) * sx) * sw
    return (acc * sx * qw["s"]).to(out_dtype)


def int8_linear(x: torch.Tensor, qw: dict,
                out_dtype: torch.dtype = torch.float32,
                mesh=None) -> torch.Tensor:
    """Dynamic per-token activation quant + int8 x int8 -> int32 product.

    x (..., d) any float; qw from ``_quantize_weight``. The int32
    accumulator is exact; the only rounding is the two int8 quantizations
    (plus the out_dtype cast; the scale multiply is fp32 either way).
    ``mesh``: x and qw are a row-parallel layer's slices (module
    docstring).
    """
    return _int8_matmul(*_quantize_tokens(x, mesh), qw, out_dtype, mesh)


def _row_split(qw: dict, full: int):
    """The mesh of a row-parallel slice of ``full`` input rows, or None."""
    return model_split(qw["w"].shape[0], full)


def _quantize_attn(p: dict, cfg: t5.T5Config) -> dict:
    # three layouts (t5.fuse_attention_params): separate q/k/v, fused
    # self-attn "qkv", fused cross-attn q + "kv"
    src = {k: p[k] for k in ("q", "k", "v", "qkv", "kv") if k in p}
    out = {k: _quantize_weight(v) for k, v in src.items()}
    out["o"] = _quantize_weight(
        p["o"], model_split(p["o"].shape[0], cfg.num_heads * cfg.d_kv))
    return out


def _quantize_mlp(p: dict, cfg: t5.T5Config) -> dict:
    return {k: _quantize_weight(
        v, model_split(v.shape[0], cfg.d_ff) if k == "wo" else None)
        for k, v in p.items()}


def quantize_scoring_params(params: dict, cfg: t5.T5Config) -> dict:
    """Quantize every matmul weight of the scoring forward, on the weights'
    device; keep embeddings, norms and rel-bias tables exact. Reads the
    ``block_i`` and the stacked ``blocks`` layouts."""
    enc_blocks = [t5._block(params["encoder"], i)
                  for i in range(cfg.num_layers)]
    dec_blocks = [t5._block(params["decoder"], i)
                  for i in range(cfg.num_decoder_layers)]

    def enc_block(b):
        return {
            "self_attn": _quantize_attn(b["self_attn"], cfg),
            "mlp": _quantize_mlp(b["mlp"], cfg),
            "ln_self": b["ln_self"],
            "ln_mlp": b["ln_mlp"],
        }

    def dec_block(b):
        return {
            "self_attn": _quantize_attn(b["self_attn"], cfg),
            "cross_attn": _quantize_attn(b["cross_attn"], cfg),
            "mlp": _quantize_mlp(b["mlp"], cfg),
            "ln_self": b["ln_self"],
            "ln_cross": b["ln_cross"],
            "ln_mlp": b["ln_mlp"],
        }

    q = {
        "shared": params["shared"],
        "enc_blocks": [enc_block(b) for b in enc_blocks],
        "dec_blocks": [dec_block(b) for b in dec_blocks],
        "enc_rel_bias": t5._rel_bias(params["encoder"]),
        "dec_rel_bias": t5._rel_bias(params["decoder"]),
        "enc_final_ln": params["encoder"]["final_ln"],
        "dec_final_ln": params["decoder"]["final_ln"],
    }
    if not cfg.tie_word_embeddings:
        q["lm_head"] = params["lm_head"]
    return q


def _cols(qw: dict, lo: int, hi: int) -> dict:
    return {"w": qw["w"][:, lo:hi], "s": qw["s"][:, lo:hi]}


def _proj_qkv(qp: dict, x_q, x_kv, H: int, dk: int, sd=torch.float32,
              kv_codes: dict | None = None):
    """int8 q/k/v projections -> (B, L, H, dk) in stream dtype sd each.

    Each input is quantized once: q, k and v of one input share its codes,
    and a fused layout's columns run as one product (per-column scales and
    an exact int32 accumulator make that the same numbers as a product per
    projection). ``kv_codes`` caches x_kv's codes across calls (the
    decoder's cross-attention reads the same encoder output every layer).
    """
    inner = H * dk
    cq = _quantize_tokens(x_q)
    if x_kv is x_q:
        ckv = cq
    elif kv_codes is not None:
        if "codes" not in kv_codes:
            kv_codes["codes"] = _quantize_tokens(x_kv)
        ckv = kv_codes["codes"]
    else:
        ckv = _quantize_tokens(x_kv)
    if "qkv" in qp and ckv is cq:
        # fused self-attn layout (t5.fuse_attention_params): [q | k | v]
        yq, yk, yv = _int8_matmul(*cq, qp["qkv"], sd).split(inner, dim=-1)
    elif "qkv" in qp:
        yq = _int8_matmul(*cq, _cols(qp["qkv"], 0, inner), sd)
        yk, yv = _int8_matmul(*ckv, _cols(qp["qkv"], inner, 3 * inner),
                              sd).split(inner, dim=-1)
    elif "kv" in qp:
        # fused cross-attn layout: separate q, [k | v]
        yq = _int8_matmul(*cq, qp["q"], sd)
        yk, yv = _int8_matmul(*ckv, qp["kv"], sd).split(inner, dim=-1)
    else:
        yq = _int8_matmul(*cq, qp["q"], sd)
        yk = _int8_matmul(*ckv, qp["k"], sd)
        yv = _int8_matmul(*ckv, qp["v"], sd)
    return tuple(y.reshape(y.shape[0], y.shape[1], H, dk)
                 for y in (yq, yk, yv))


def _bf16_operand(t: torch.Tensor) -> torch.Tensor:
    # a bf16 operand of an fp32-accumulated product: rounded to bf16, then
    # multiplied in fp32, where its products are exact
    return t.to(torch.bfloat16).float()


def _attention_int8(qp, x_q, x_kv, bias, cfg: t5.T5Config, sd=torch.float32,
                    kv_codes: dict | None = None):
    """T5 attention (unscaled scores + additive bias) with int8
    projections; the score / AV products on bf16 operands. A rank's
    heads only, with its slice of o, under tensor parallelism."""
    dk = cfg.d_kv
    H = qp["o"]["w"].shape[0] // dk
    q, k, v = _proj_qkv(qp, x_q, x_kv, H, dk, sd, kv_codes)
    s = torch.einsum("bqhd,bkhd->bhqk", _bf16_operand(q), _bf16_operand(k))
    p = torch.softmax(s + bias, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", _bf16_operand(p), _bf16_operand(v))
    return int8_linear(o.reshape(o.shape[0], o.shape[1], H * dk), qp["o"], sd,
                       _row_split(qp["o"], cfg.num_heads * dk))


def _mlp_int8(qp, cfg: t5.T5Config, x, sd=torch.float32):
    if cfg.gated_ffn:
        cx = _quantize_tokens(x)
        h = F.gelu(_int8_matmul(*cx, qp["wi_0"], sd), approximate="tanh") \
            * _int8_matmul(*cx, qp["wi_1"], sd)
    else:
        h = torch.relu(int8_linear(x, qp["wi"], sd))
    return int8_linear(h, qp["wo"], sd, _row_split(qp["wo"], cfg.d_ff))


def score_batch_int8(
    qparams: dict,
    cfg: t5.T5Config,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    rel_id: int = VERBALIZER_TRUE,
    nrel_id: int = VERBALIZER_FALSE,
    # dtype of the inter-layer residual stream / activations: fp32 or bf16
    # (quantization scales and norms stay fp32 either way)
    stream_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, L) prompts -> (B,) log P(true | {true, false}); int8 compute.

    Same contract as ``monot5.score_batch`` (one teacher-forced decode
    step), with qparams from ``quantize_scoring_params``.
    """
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    B, L = input_ids.shape
    eps = cfg.layer_norm_epsilon
    f32 = torch.float32
    sd = stream_dtype
    dev = input_ids.device

    emb = qparams["shared"]["embedding"].float()
    x = t5.embed_tokens(emb, input_ids, cfg).to(sd)

    pos = t5.compute_position_bias(
        qparams["enc_rel_bias"], L, L, True,
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    bias = pos + t5._padding_bias(attention_mask)

    for blk in qparams["enc_blocks"]:
        h = t5.rms_norm(x, blk["ln_self"]["scale"], eps, sd)
        x = x + _attention_int8(blk["self_attn"], h, h, bias, cfg, sd)
        h = t5.rms_norm(x, blk["ln_mlp"]["scale"], eps, sd)
        x = x + _mlp_int8(blk["mlp"], cfg, h, sd)
    enc_h = t5.rms_norm(x, qparams["enc_final_ln"]["scale"], eps, sd)

    # --- one decoder step at position 0 -----------------------------------
    start = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long,
                       device=dev)
    d = t5.embed_tokens(emb, start, cfg).to(sd)
    cross_bias = t5._padding_bias(attention_mask)
    enc_codes: dict = {}  # enc_h quantized once, at its first use
    for blk in qparams["dec_blocks"]:
        # self-attention over a single position: softmax over one key is 1
        # regardless of bias, so attn(x) == o_proj(v_proj(x)) exactly
        h = t5.rms_norm(d, blk["ln_self"]["scale"], eps, sd)
        sa = blk["self_attn"]
        inner = sa["o"]["w"].shape[0]  # a rank's heads' under a split
        if "qkv" in sa:
            v = int8_linear(h, _cols(sa["qkv"], 2 * inner, 3 * inner), sd)
        else:
            v = int8_linear(h, sa["v"], sd)
        d = d + int8_linear(v, sa["o"], sd,
                            _row_split(sa["o"], cfg.num_heads * cfg.d_kv))
        h = t5.rms_norm(d, blk["ln_cross"]["scale"], eps, sd)
        d = d + _attention_int8(blk["cross_attn"], h, enc_h, cross_bias, cfg,
                                sd, enc_codes)
        h = t5.rms_norm(d, blk["ln_mlp"]["scale"], eps, sd)
        d = d + _mlp_int8(blk["mlp"], cfg, h, sd)
    d = t5.rms_norm(d, qparams["dec_final_ln"]["scale"], eps, f32)

    # 2-row verbalizer head: log-softmax is over the {true, false} pair
    # only, so the full (V, D) product is never needed; exact fp32
    rows = torch.tensor([rel_id, nrel_id], device=dev)
    if cfg.tie_word_embeddings:
        head = t5.embed_tokens(emb, rows, cfg)  # (2, D)
        d = d * (cfg.d_model**-0.5)
    else:
        head = t5.embed_tokens(qparams["lm_head"]["embedding"].float(), rows,
                               cfg)
    pair = torch.einsum("bld,vd->blv", d, head)[:, 0, :]
    return torch.log_softmax(pair, dim=-1)[:, 0]
