"""bf16 GEMM: the projections of the fused attention block (K3).

``gemm(a, b)`` is C = A . B for row-major (M, K) and (K, N) operands. On a
CUDA tensor it launches the hand-written kernel in ``csrc/gemm_bf16.cu``
(a persistent TMA + wgmma pipeline; bf16 in, fp32 accumulation, bf16 out)
or raises; on a CPU tensor it runs ``gemm_plain``, the plain PyTorch
version with the same signature.

The TPU kernel it stands in for computes both projections inside
``_v3_fwd_kernel`` (pacednegatives_tpu/ops/flash_v3.py:105-108 and
:131-135): a dot with ``preferred_element_type=float32`` rounded once to the
compute dtype. ``torch.matmul`` in bf16 accumulates in fp32 as well (with
``allow_bf16_reduced_precision_reduction`` off), so the plain version is the
same arithmetic.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch import kernels


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C = A . B (fp32 accumulation, result in A's dtype)."""
    return torch.matmul(a, b)


def _check_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"gemm: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) % 8:
        raise ValueError(
            f"gemm: {name} must be a row-major 2-D tensor whose row stride is "
            f"a multiple of 8 (shape {tuple(t.shape)}, strides {t.stride()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"gemm: {name} must be 16-byte aligned")


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) . (K, N) -> (M, N). CPU: ``gemm_plain``. CUDA: the kernel.

    The kernel takes bf16, a contiguous last dimension, row strides and K
    and N that are multiples of 8 (TMA's 16-byte strides); anything else
    raises."""
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"gemm: operands on {a.device} and {b.device}; the kernel needs "
            "both on one CUDA device"
        )
    _check_operand(a, "a")
    _check_operand(b, "b")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"gemm: inner dimensions differ ({K} vs {K2})")
    if M == 0 or K % 8 or N % 8:
        raise ValueError(
            f"gemm: needs M > 0 and K, N multiples of 8 (M={M} K={K} N={N})"
        )
    c = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    rc = kernels.library().pnt_gemm_bf16(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
        a.stride(0), b.stride(0), c.stride(0),
        a.device.index if a.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    kernels.check(rc, "gemm_bf16")
    gemm.launches += 1
    return c


gemm.launches = 0  # kernel launches; the plain CPU route does not count
