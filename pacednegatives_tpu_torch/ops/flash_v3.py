"""Fused self-attention block, forward (K3) and backward (K4): the port of
ops/flash_v3.py.

y = attn(x . Wqkv) . Wo for encoder-shaped self-attention, as
``v3_forward`` / ``_v3_fwd_kernel`` (pacednegatives_tpu/ops/flash_v3.py:94,
138) computes it on the TPU in one kernel per batch row, with qkv, every
head and both weights resident in one core's 128 MB of VMEM.

No Hopper SM holds that (one row's qkv at L = 192, t5-base is ~0.9 MB
against 227 KB of shared memory), so the Hopper form is three launches:
GEMM (``ops/gemm.py``) -> attention core (``ops/flash.py``) reading q/k/v
as strided views of the fused qkv buffer and writing heads straight into
the (B, L, H*dk) layout -> GEMM. Fusing the projections into the core is
later work.

Casts follow the TPU kernel (flash_v3.py:105-135): qkv rounded to the
compute dtype after an fp32-accumulated GEMM; scores in fp32; the
unnormalised p rounded before P . V and divided by l after; per-head
outputs stored in the compute dtype in (L, H*dk) layout; y in x's dtype.
The TPU wrapper pads L to 16 (flash_v3.py:391-398, a tiling artifact); the
CUDA kernel masks ragged tiles instead, and the plain version needs no pad.

Backward (K4, ``v3_backward``; flash_v3.py:196-323): the TPU kernel
recomputes qkv = x . Wqkv and the normalised probabilities from (m, l) in
VMEM and emits d_qkv in the fused layout, the recomputed attention outputs
and dpos summed over the batch. On Hopper it is GEMM (the same hand GEMM as
the forward, so qkv is bit-identical to the forward's) -> the attention
backward core (``ops/flash.py`` ``attention_backward``,
``csrc/t5_attention_bwd.cu``) reading q/k/v/g as strided views and writing
dq/dk/dv straight into the (B, L, 3*H*dk) d_qkv buffer. Its numerics are the
TPU backward kernel's, not the forward's: p is normalised before it is
rounded, so the recomputed attention output may differ from the forward's
by about one bf16 ulp (flash_v3.py:345-353). ``FusedSelfAttention`` is the
``torch.autograd.Function`` of ``_v3_core`` (flash_v3.py:331-374): it saves
(x, wqkv, wo, pos3, key_mask, m, l) and its backward runs d_attn = dy . Wo^T,
K4, then the dWo, dWqkv and dx products, which the JAX package leaves to XLA
outside the kernel and the port leaves to ``torch.matmul``.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch.ops.flash import (
    NEG_INF,
    attention_backward,
    attention_backward_plain,
    flash_attention_forward,
    flash_attention_forward_plain,
)
from pacednegatives_tpu_torch.ops.gemm import gemm, gemm_plain

__all__ = [
    "NEG_INF",
    "FusedSelfAttention",
    "flash_v3_eligible",
    "fused_self_attention",
    "fused_self_attention_plain",
    "v3_backward",
    "v3_backward_plain",
    "v3_forward",
    "v3_forward_plain",
]


def flash_v3_eligible(H: int, Lq: int, Lk: int, dk: int, d_model: int) -> bool:
    """The JAX gate's shape domain (flash_v3.py:58-82): self-attention with
    Lq == Lk in [64, 512], dk 64 or 128, and the TPU kernel's resident
    estimate within 64 MB. The JAX gate also requires a TPU (or interpret
    mode); here the kernel runs on CUDA and the plain version on the CPU,
    so the port routes exactly as the JAX package does in interpret mode."""
    if Lq != Lk or dk not in (64, 128) or Lq < 64 or Lq > 512:
        return False
    Lp = (Lq + 15) // 16 * 16
    inner = H * dk
    resident = (
        4 * inner * d_model * 2
        + 2 * H * Lp * Lp * 4
        + 4 * Lp * inner * 4
        + Lp * inner * 2
    )
    return resident <= 64 * 1024 * 1024


def _v3(x, wqkv, wo, pos3, key_mask, gemm_fn, attn_fn):
    B, L, D = x.shape
    inner = wo.shape[0]
    H = pos3.shape[0]
    dk = inner // H
    qkv = gemm_fn(x.reshape(B * L, D), wqkv).view(B, L, 3, H, dk)
    # (B, H, L, dk) strided views into the fused buffer: no transpose copy
    q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    attn = torch.empty((B, L, H, dk), dtype=x.dtype, device=x.device)
    _, m, l = attn_fn(q, k, v, pos3, key_mask, out=attn.transpose(1, 2))
    y = gemm_fn(attn.view(B * L, inner), wo).view(B, L, D)
    return y.to(x.dtype), m, l


def v3_forward(x, wqkv, wo, pos3, key_mask):
    """x (B, L, D); wqkv (D, 3*H*dk); wo (H*dk, D); pos3 (H, L, L) fp32;
    key_mask (B, L) fp32 additive -> (y (B, L, D), m, l (B, H, L) fp32).
    CUDA tensors go through the kernels (or raise); CPU tensors through
    the plain versions."""
    return _v3(x, wqkv, wo, pos3, key_mask, gemm, flash_attention_forward)


def v3_forward_plain(x, wqkv, wo, pos3, key_mask):
    """Plain PyTorch version of ``v3_forward`` on any device."""
    return _v3(x, wqkv, wo, pos3, key_mask, gemm_plain,
               flash_attention_forward_plain)


def _v3_bwd(x, wqkv, pos3, key_mask, m, l, d_attn, gemm_fn, core_fn):
    B, L, D = x.shape
    H = pos3.shape[0]
    inner = d_attn.shape[-1]
    dk = inner // H
    qkv = gemm_fn(x.reshape(B * L, D), wqkv).view(B, L, 3, H, dk)
    q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    g = d_attn.reshape(B, L, H, dk).transpose(1, 2)
    dqkv = torch.empty((B, L, 3, H, dk), dtype=x.dtype, device=x.device)
    attn = torch.empty((B, L, H, dk), dtype=x.dtype, device=x.device)
    dq, dkk, dv = (dqkv[:, :, t].transpose(1, 2) for t in range(3))
    *_, dpos = core_fn(q, k, v, g, pos3, key_mask, m, l, dq=dq, dk=dkk,
                       dv=dv, out=attn.transpose(1, 2))
    return dqkv.view(B, L, 3 * inner), attn.view(B, L, inner), dpos


def v3_backward(x, wqkv, pos3, key_mask, m, l, d_attn):
    """x (B, L, D); wqkv (D, 3*H*dk); pos3 (H, L, L) and key_mask (B, L)
    fp32; m, l (B, H, L) from the forward; d_attn (B, L, H*dk) the cotangent
    of the attention heads -> (d_qkv (B, L, 3*H*dk), attn (B, L, H*dk)
    recomputed, dpos (H, L, L) fp32). CUDA tensors go through the kernels
    (or raise); CPU tensors through the plain versions."""
    return _v3_bwd(x, wqkv, pos3, key_mask, m, l, d_attn, gemm,
                   attention_backward)


def v3_backward_plain(x, wqkv, pos3, key_mask, m, l, d_attn):
    """Plain PyTorch version of ``v3_backward`` on any device."""
    return _v3_bwd(x, wqkv, pos3, key_mask, m, l, d_attn, gemm_plain,
                   attention_backward_plain)


class FusedSelfAttention(torch.autograd.Function):
    """y = attn(x . Wqkv) . Wo with K3 forward and K4 backward. Once
    differentiable: its backward raises under ``create_graph=True``."""

    @staticmethod
    def forward(ctx, x, wqkv, wo, pos3, key_mask):
        y, m, l = v3_forward(x, wqkv, wo, pos3, key_mask)
        ctx.save_for_backward(x, wqkv, wo, pos3, key_mask, m, l)
        return y

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():
            # create_graph=True: K4's outputs carry no autograd history, so
            # a gradient through this gradient would silently lose every
            # path through d_qkv (and the CPU route writes into out=
            # buffers); the JAX package fails in pallas_call's JVP rule
            raise NotImplementedError(
                "FusedSelfAttention (K3 / K4) has no double backward: a "
                "gradient through its gradient (create_graph=True) is not "
                "supported; use the dense route (flash_v3=False)")
        x, wqkv, wo, pos3, key_mask, m, l = ctx.saved_tensors
        B, L, D = x.shape
        inner = wo.shape[0]
        dy2 = dy.to(x.dtype).reshape(B * L, D)
        # Each product accumulates in fp32 and rounds once to the operands'
        # dtype, as the einsums with preferred_element_type=float32 and
        # astype do (flash_v3.py:354-368). d_attn = dy . Wo^T; dWo from the
        # RECOMPUTED attention outputs, so the forward never keeps them.
        d_attn = torch.matmul(dy2, wo.t()).view(B, L, inner)
        dqkv, attn, dpos = v3_backward(x, wqkv, pos3, key_mask, m, l, d_attn)
        dqkv2 = dqkv.view(B * L, 3 * inner)
        dwo = torch.matmul(attn.view(B * L, inner).t(), dy2).to(wo.dtype)
        dwqkv = torch.matmul(x.reshape(B * L, D).t(), dqkv2).to(wqkv.dtype)
        dx = torch.matmul(dqkv2, wqkv.t()).view(B, L, D)
        # the additive key mask comes from integer attention masks, so it
        # gets no gradient (flash_v3.py:369-371)
        return dx, dwqkv, dwo, dpos.to(pos3.dtype), None


def fused_self_attention(x, wqkv, wo, pos3, key_mask):
    """y = attn(x Wqkv) Wo, differentiable (flash_v3.py:377): the forward is
    ``v3_forward`` and the backward ``v3_backward`` (CUDA kernels for CUDA
    tensors, plain versions for CPU tensors)."""
    return FusedSelfAttention.apply(x, wqkv, wo, pos3, key_mask)


def fused_self_attention_plain(x, wqkv, wo, pos3, key_mask):
    """Plain PyTorch version of ``fused_self_attention``; differentiable by
    autograd through the plain forward."""
    return v3_forward_plain(x, wqkv, wo, pos3, key_mask)[0]
