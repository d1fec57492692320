"""T5 attention core, forward (K1): the port of ops/flash.py's kernels.

Per head: out = softmax(q . k^T + pos[h] + key_mask[b]) . v, with no
1/sqrt(dk) scaling, and the softmax statistics (m, l). It replaces
``flash_attention_forward`` (pacednegatives_tpu/ops/flash.py:94) and
``flash_attention_forward_v2`` (ops/flash.py:480) with one CUDA kernel,
``csrc/t5_attention_fwd.cu``, and is the core of the fused block (K3,
ops/flash_v3.py).

``flash_attention_forward`` launches the kernel for CUDA tensors (or
raises) and runs ``flash_attention_forward_plain`` for CPU tensors. Unlike
the TPU kernels it takes any lengths: the CUDA kernel masks ragged tiles
itself, so there are no block-size arguments.

Numerics of both versions follow the TPU kernels: scores in fp32, the
UNNORMALISED probabilities rounded to v's dtype before P . V (fp32
accumulation), division by l = max(sum, 1e-30) afterwards.
"""

from __future__ import annotations

import torch

from pacednegatives_tpu_torch import kernels

NEG_INF = -1e9  # additive mask value (pacednegatives_tpu/ops/flash.py:40)


def flash_attention_reference(q, k, v, pos_bias, key_mask):
    """Dense reference with the same inputs and layout (ops/flash.py:167):
    normalised softmax weights rounded to v's dtype, then P . V."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + pos_bias[None].float() + key_mask[:, None, None, :].float()
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w.to(v.dtype), v)


def flash_attention_forward_plain(q, k, v, pos, key_mask, out_dtype=None,
                                  *, out=None):
    """Plain PyTorch version of ``flash_attention_forward``.

    q (B, H, Lq, dk), k/v (B, H, Lk, dk), pos (H, Lq, Lk), key_mask (B, Lk)
    additive. Returns (out (B, H, Lq, dk) in ``out_dtype`` (default q's),
    m (B, H, Lq) fp32, l (B, H, Lq) fp32). With ``out`` given, the result is
    written into it (any strides) and ``out`` is returned."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + pos[None].float() + key_mask[:, None, None, :].float()
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l[..., None]
    if out is None:
        return o.to(out_dtype or q.dtype), m, l
    out.copy_(o)
    return out, m, l


def _check_qkv(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention kernel: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(
            f"attention kernel: {name} must be 4-D with a contiguous head "
            f"dimension and other strides multiples of 8 (strides "
            f"{t.stride()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"attention kernel: {name} must be 16-byte aligned")


def flash_attention_forward(q, k, v, pos, key_mask, out_dtype=None, *,
                            out=None):
    """-> (out (B, H, Lq, dk), m (B, H, Lq), l (B, H, Lq)).

    CPU tensors: ``flash_attention_forward_plain``. CUDA tensors: the kernel,
    which takes bf16 q/k/v of dk 64 or 128 with a contiguous head dimension
    and any other strides that are multiples of 8 (so views into a fused
    qkv buffer work without a copy); k and v must share strides; pos
    (H, Lq, Lk) and key_mask (B, Lk) fp32 contiguous; out bf16 or fp32. With
    ``out`` given (shape (B, H, Lq, dk), head dimension contiguous, e.g. a
    transposed view of a (B, Lq, H, dk) buffer) the kernel writes into it."""
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, pos, key_mask,
                                             out_dtype, out=out)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, pos, key_mask)):
        raise ValueError("attention kernel: all inputs must be on one CUDA device")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_qkv(t, name)
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, dk) or v.shape != k.shape:
        raise ValueError(
            f"attention kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not match"
        )
    if k.stride() != v.stride():
        raise ValueError("attention kernel: k and v must share strides")
    if dk not in (64, 128):
        raise ValueError(f"attention kernel: dk must be 64 or 128, got {dk}")
    if (pos.dtype != torch.float32 or tuple(pos.shape) != (H, Lq, Lk)
            or not pos.is_contiguous()):
        raise ValueError(
            f"attention kernel: pos must be contiguous fp32 {(H, Lq, Lk)}, "
            f"got {pos.dtype} {tuple(pos.shape)}"
        )
    if (key_mask.dtype != torch.float32 or tuple(key_mask.shape) != (B, Lk)
            or not key_mask.is_contiguous()):
        raise ValueError(
            f"attention kernel: key_mask must be contiguous fp32 {(B, Lk)}, "
            f"got {key_mask.dtype} {tuple(key_mask.shape)}"
        )
    if out is None:
        out = torch.empty((B, H, Lq, dk), dtype=out_dtype or q.dtype, device=dev)
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel: out must be bf16 or fp32, got {out.dtype}")
    if (tuple(out.shape) != (B, H, Lq, dk) or out.device != dev
            or out.stride(3) != 1 or any(s % 2 for s in out.stride()[:3])
            or out.data_ptr() % 8):
        raise ValueError(
            f"attention kernel: out must be {(B, H, Lq, dk)} on {dev} with a "
            f"contiguous head dimension and even strides, got "
            f"{tuple(out.shape)} strides {out.stride()}"
        )
    m = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    rc = kernels.library().pnt_t5_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3],
        pos.data_ptr(), key_mask.data_ptr(),
        out.data_ptr(), *out.stride()[:3], int(out.dtype == torch.float32),
        m.data_ptr(), l.data_ptr(), B, H, Lq, Lk, dk,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "t5_attention_fwd")
    flash_attention_forward.launches += 1
    return out, m, l


flash_attention_forward.launches = 0  # kernel launches; CPU route not counted
