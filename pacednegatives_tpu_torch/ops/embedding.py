"""The embedding lookup, with a hand-written backward on the card.

``embedding_lookup(table, ids)`` is ``table[ids]``: the rows of a (V, D)
table at integer ids of any shape, an autograd Function. Its forward is
the library gather of ``table[ids]``. Its backward is the (V, D) gradient in
the table's dtype: for each row, the sum of the cotangent over the
positions of its id, summed in fp32 and rounded once; zero where no id is
the row. ``embedding_grad`` computes it: on a CPU tensor the plain version
(``embedding_grad_plain``, an fp32 ``index_add_``), on a CUDA tensor the
kernels in ``csrc/embed_grad.cu`` (a stable radix sort of the ids, then a
segmented sum over fixed tiles of the sorted list; no float atomics, so
the result is the same bits from call to call, and no host sync) or it
raises.

The JAX package's lookup is an XLA gather (``emb[input_ids]``,
pacednegatives_tpu/models/t5.py:1368); no TPU kernel stands behind it.
Autograd through ``table[ids]`` was aten's ``index_put_`` with
accumulate: one warp adding a run of equal ids one row after another,
rounding to bf16 at every add. The gradient of the backward is the gather
again, so the lookup can be differentiated through its gradient
(``create_graph=True``, the meta step).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pacednegatives_tpu_torch import kernels
from pacednegatives_tpu_torch.utils import profiling

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def embedding_grad_plain(g: torch.Tensor, ids: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """The plain version: (num_rows, D) in g's dtype, the fp32 (or wider)
    sum of g's rows into the rows of their ids."""
    acc = torch.promote_types(g.dtype, torch.float32)
    d = g.shape[-1]
    out = torch.zeros((num_rows, d), dtype=acc, device=g.device)
    out.index_add_(0, ids.reshape(-1), g.reshape(-1, d).to(acc))
    return out.to(g.dtype)


@functools.lru_cache(maxsize=64)
def _scratch_bytes(n: int, d: int, num_rows: int) -> int:
    nbytes = ctypes.c_longlong()
    kernels.check(kernels.library().pnt_embed_grad_scratch(
        n, d, num_rows, ctypes.byref(nbytes)), "embed_grad_scratch")
    return nbytes.value


def embedding_grad(g: torch.Tensor, ids: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """The gradient of ``table[ids]`` for a table of ``num_rows`` rows:
    g is the cotangent, of shape (*ids.shape, D). CPU: the plain version.
    CUDA: the kernels, which take a contiguous bf16 or fp32 g; anything
    else raises."""
    if g.device.type == "cpu":
        return embedding_grad_plain(g, ids, num_rows)
    if g.device.type != "cuda" or ids.device != g.device:
        raise ValueError(f"embedding_grad: g on {g.device} and ids on "
                         f"{ids.device}; the kernel needs one CUDA device")
    if g.dtype not in _DTYPES:
        raise TypeError(f"embedding_grad: g must be bf16 or fp32, got "
                        f"{g.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"embedding_grad: ids must be int32 or int64, got "
                        f"{ids.dtype}")
    if not g.is_contiguous():
        raise ValueError("embedding_grad: g must be contiguous")
    d = g.shape[-1]
    n = ids.numel()
    if g.shape != (*ids.shape, d):
        raise ValueError(f"embedding_grad: g {tuple(g.shape)} is not ids "
                         f"{tuple(ids.shape)} by D")
    if n >= 2**31 or num_rows >= 2**31 or d == 0:
        raise ValueError(f"embedding_grad: {n} ids, {num_rows} rows of "
                         f"{d}: the kernel takes fewer than 2^31, D > 0")
    ids = ids.contiguous()
    out = torch.empty((num_rows, d), dtype=g.dtype, device=g.device)
    scratch = torch.empty(_scratch_bytes(n, d, num_rows),
                          dtype=torch.uint8, device=g.device)
    vec = d * g.element_size() % 16 == 0 and g.data_ptr() % 16 == 0
    dev = g.device.index if g.device.index is not None else \
        torch.cuda.current_device()
    rc = kernels.library().pnt_embed_grad(
        g.data_ptr(), ids.data_ptr(), ids.element_size(), out.data_ptr(),
        scratch.data_ptr(), n, d, num_rows, _DTYPES[g.dtype], int(vec), dev,
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(rc, "embed_grad")
    embedding_lookup.launches += 1
    profiling.count("embed.grad")
    return out


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _Scatter.apply(g, ids, ctx.num_rows), None


class _Scatter(torch.autograd.Function):
    """``embedding_grad`` as a function of g: its gradient is the lookup
    of the incoming (V, D) cotangent at ids."""

    @staticmethod
    def forward(ctx, g, ids, num_rows):
        ctx.save_for_backward(ids)
        return embedding_grad(g.contiguous(), ids, num_rows)

    @staticmethod
    def backward(ctx, gg):
        (ids,) = ctx.saved_tensors
        return _Lookup.apply(gg, ids), None, None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for int32 or int64 ids of any shape: (*ids.shape, D),
    with the backward above. Without a gradient to take (serving, scoring),
    the plain indexing alone, which skips the Function's host cost."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, ids)
    return table[ids.long()]


embedding_lookup.launches = 0  # backward kernel launches; the CPU not counted
