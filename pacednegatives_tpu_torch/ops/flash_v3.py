"""Fused self-attention block, forward (K3): the port of ops/flash_v3.py.

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
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch.ops.flash import (
    NEG_INF,
    flash_attention_forward,
    flash_attention_forward_plain,
)
from pacednegatives_tpu_torch.ops.gemm import gemm, gemm_plain

__all__ = [
    "NEG_INF",
    "flash_v3_eligible",
    "fused_self_attention",
    "fused_self_attention_plain",
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


def fused_self_attention(x, wqkv, wo, pos3, key_mask):
    """y = attn(x Wqkv) Wo; the forward of flash_v3.py:377 (no VJP)."""
    return v3_forward(x, wqkv, wo, pos3, key_mask)[0]


def fused_self_attention_plain(x, wqkv, wo, pos3, key_mask):
    """Plain PyTorch version of ``fused_self_attention``."""
    return v3_forward_plain(x, wqkv, wo, pos3, key_mask)[0]
