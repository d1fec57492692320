"""Collectives over a mesh's groups: the port of parallel/collectives.py.

The JAX package needs explicit collectives only inside shard_map bodies;
GSPMD inserts the rest. Here every cross-rank exchange is explicit. The
data-parallel ones run over the row group of parallel/mesh.py (the ranks
of the combined (data, seq) axes), in row order: what rank ``i``
contributes is block ``i`` of the result. The tensor-parallel ones run over
the model group (the ranks of one row), for the split layers of
models/t5.py: the two conjugate autograd Functions of a Megatron layer
(``copy_to_model`` at a column-parallel layer's input, ``reduce_from_model``
at a row-parallel layer's output), a max and an all-gather. Each is the
identity, with no collective, at ``model == 1``. A bf16 partial sum is
summed in fp32 and cast back once, on either backend, so that gloo and
NCCL give the same numbers.

Transport: NCCL takes CUDA tensors for every op here. Gloo works in host
memory: its CUDA allreduce and allgather stage through host buffers, and it
has no all_gather_into_tensor or reduce_scatter at all. So on a gloo group
every op here copies a CUDA tensor to the host, runs the collective there
and copies the result back, explicitly (``_host_staged``). Only the
transport and the collective's own sums leave the card; every caller's
computation stays on it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pacednegatives_tpu_torch.ops.mips import _merge_keys, pack_keys
from pacednegatives_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    local_rows,
)


def _mesh(mesh: Mesh | None) -> Mesh:
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("a collective outside a mesh: pass mesh= or call "
                         "it inside a `with mesh:` block")
    return mesh


def _host_staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _gather(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    stage = _host_staged(x, group)
    src = (x.detach().cpu() if stage else x.detach()).contiguous()
    if src.dtype == torch.bfloat16:  # moved as its bytes, on any backend
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).view(x.dtype)
    return out.to(x.device) if stage else out


def _all_reduce(x: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the group's ``x`` (a new tensor; ``x`` is untouched)."""
    stage = _host_staged(x, group)
    # a contiguous copy: the backends reduce a tensor's storage in order
    y = (x.detach().cpu() if stage else x.detach()).clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device) if stage else y


def gather_batch(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """(local_B, ...) -> (row_size * local_B, ...): every rank's block,
    concatenated in row order (the same shape on every rank)."""
    mesh = _mesh(mesh)
    return _gather(x, mesh.row_group, mesh.row_size)


def global_sum(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor; ``x`` is untouched)."""
    mesh = _mesh(mesh)
    return _all_reduce(x, mesh.row_group)


def global_mean(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Mean over the ranks' values (per-step metric aggregation)."""
    mesh = _mesh(mesh)
    return global_sum(x, mesh) / mesh.row_size


def broadcast(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Row rank 0's ``x`` on every rank (a new tensor)."""
    mesh = _mesh(mesh)
    stage = _host_staged(x, mesh.row_group)
    y = x.detach().cpu() if stage else x.detach().clone()
    dist.broadcast(y, src=dist.get_global_rank(mesh.row_group, 0),
                   group=mesh.row_group)
    return y.to(x.device) if stage else y


def mean_over_ranks(tensors: list[torch.Tensor],
                    mesh: Mesh | None = None) -> list[torch.Tensor]:
    """Each tensor's mean over the ranks, in one all-reduce of one flat
    fp32 buffer (the data-parallel gradient reduction): a bf16 tensor is
    summed in fp32 and cast back once."""
    mesh = _mesh(mesh)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = global_sum(flat, mesh) / mesh.row_size
    return [part.view(t.shape).to(t.dtype) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _GatherRows(torch.autograd.Function):
    """``gather_batch`` with a gradient: the backward is the gather's
    adjoint, the sum over ranks of the incoming gradient, of which each
    rank keeps its block. A loss that every rank computes on the gathered
    rows therefore gives each rank world-size times its rows' share of the
    gradient; ``mean_over_ranks`` of the parameters' gradients divides it
    out again."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_batch(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return local_rows(global_sum(g, ctx.mesh), ctx.mesh), None


def gather_batch_with_grad(x: torch.Tensor,
                           mesh: Mesh | None = None) -> torch.Tensor:
    """``gather_batch`` that autograd differentiates (see ``_GatherRows``)."""
    return _GatherRows.apply(x, _mesh(mesh))


def merge_topk(local_scores: torch.Tensor, local_idx: torch.Tensor, k: int,
               mesh: Mesh | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (B, k_local) top-k candidates -> the global (B, k)
    top-k on every rank, in ``lax.top_k``'s order on the shard-major
    concatenation: descending, -0 below +0, ties to the lower position.
    Each candidate travels as one packed int64 key (ops/mips.pack_keys:
    value, then the lower global index), so one all-gather carries both
    and the keys are unique; with contiguous shards the lower index is the
    lower position."""
    keys = pack_keys(local_scores, local_idx)
    every = gather_batch(keys[None], mesh)  # (row_size, B, k_local)
    B = keys.shape[0]
    return _merge_keys(every.transpose(0, 1).reshape(B, -1), k)


# -- the model group (tensor parallelism) -----------------------------------


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the model group's ``x`` (a new tensor): a bf16 / fp16
    ``x`` summed in fp32 and cast back once; integers summed exactly."""
    if mesh.model == 1:
        return x.detach().clone()
    if x.dtype in (torch.bfloat16, torch.float16):
        return _all_reduce(x.float(), mesh.model_group).to(x.dtype)
    return _all_reduce(x, mesh.model_group)


def model_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of the model group's ``x`` (no gradient)."""
    if mesh.model == 1:
        return x.detach()
    return _all_reduce(x, mesh.model_group, dist.ReduceOp.MAX)


def gather_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's ``x`` concatenated along ``dim`` in model-rank
    order (no gradient): a split leaf made whole."""
    if mesh.model == 1:
        return x.detach()
    return _gather(x, mesh.model_group, mesh.model, dim)


class _CopyToModel(torch.autograd.Function):
    """A column-parallel layer's input: the identity forward; the backward
    sums the ranks' input gradients (each rank's is its slice's share)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """A row-parallel layer's output: the forward sums the ranks' partial
    outputs; the backward is the identity (every rank's output, and so its
    incoming gradient, is the same)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return model_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``_CopyToModel``; ``x`` itself without a split (``mesh`` None or
    ``model == 1``)."""
    if mesh is None or mesh.model == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``_ReduceFromModel``; ``x`` itself without a split."""
    if mesh is None or mesh.model == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)
