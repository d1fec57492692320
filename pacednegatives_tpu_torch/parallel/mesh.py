"""Device mesh over ``torch.distributed``: the port of parallel/mesh.py.

One process per rank. The mesh keeps the JAX package's three axes:

- ``data``  - batch (data parallelism);
- ``seq``   - negative parallelism: the assembled LCE rows (B positives and
  B*n negatives) split over the combined (data, seq) axes. Each rank here
  holds the positives of its block of pairs and their negatives, as it
  does under ``data`` alone, so in the port the seq axis is plain data
  parallelism over data x seq ranks;
- ``model`` - tensor parallelism, not ported yet: ``model > 1`` raises
  (ROADMAP.md slice R4).

Where the JAX package shards arrays and lets GSPMD partition one global
program, each rank here runs the program on its own block of rows and the
steps reduce explicitly over the mesh's *row group* (the ranks of the
combined (data, seq) axes; parallel/collectives.py). Row block ``i`` of a
leading axis belongs to the rank at row index ``i``, ``seq`` varying
fastest: the order of JAX's ``P(("data", "seq"))``.

The ambient-mesh convention is JAX's: ``with mesh:`` makes it the mesh that
models/t5.py, train/step.py, train/scored_pool.py and the loops read
through ``current_mesh()`` (a ``contextvars.ContextVar``, so a thread
started inside the block does not see it).
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

TENSOR_PARALLEL_ITEM = "ROADMAP.md slice R4, tensor parallelism"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "pacednegatives_tpu_torch_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` means "all remaining devices".

    ``seq`` is the negative-parallel axis (in the port it splits rows as
    ``data`` does; see the module docstring);
    default 1 (the reference caps n at 7, where plain dp suffices)."""

    data: int = -1
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        data, model, seq = self.data, self.model, self.seq
        if sum(x == -1 for x in (data, model, seq)) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if model == -1:
            model = n_devices // (max(data, 1) * max(seq, 1))
        if seq == -1:
            seq = n_devices // (max(data, 1) * max(model, 1))
        if data == -1:
            data = n_devices // (max(model, 1) * max(seq, 1))
        if data * model * seq != n_devices:
            raise ValueError(
                f"mesh {data}x{seq}x{model} does not cover {n_devices} devices"
            )
        return data, model, seq


def _refuse_tensor_parallel(model: int) -> None:
    if model > 1:
        raise NotImplementedError(
            f"a mesh with model={model}: tensor parallelism (split layers, "
            f"a vocab-sharded embedding) is not ported yet "
            f"({TENSOR_PARALLEL_ITEM}); use model=1")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, seq, model) mesh of ranks, this process's view of it.

    ``rank`` is this process's rank in the default group, ``row_rank`` its
    row index (data-major, seq fastest) and ``row_group`` the process group
    of the ranks that share its model index; ``device`` is where this rank
    computes. No DeviceMesh is built: nothing here places DTensors yet
    (tensor parallelism, ROADMAP.md slice R4, is where one is needed)."""

    data: int
    seq: int
    model: int
    device: torch.device
    rank: int = 0
    row_rank: int = 0
    row_group: Any = None
    _tokens: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def row_size(self) -> int:
        """Ranks the rows split over: data x seq."""
        return self.data * self.seq

    def __enter__(self) -> "Mesh":
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._tokens.pop())

    def barrier(self) -> None:
        """Wait for every rank of the default group (checkpoint writes)."""
        if dist.is_initialized():
            dist.barrier()


def create_mesh(config: MeshConfig | None = None,
                device_type: str = "cuda") -> Mesh:
    """Build a (data, seq, model) mesh over the ranks of the initialised
    default process group (``parallel/distributed.py``), one device per
    rank: the current CUDA device, or the CPU with ``device_type="cpu"``.
    Every rank calls it, in the same order as its other group calls. The
    rows need only the row group (``dist.new_group``); a
    ``torch.distributed`` DeviceMesh comes with tensor parallelism
    (ROADMAP.md slice R4)."""
    config = config or MeshConfig()
    _refuse_tensor_parallel(config.model)
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs torch.distributed initialised: call "
            "parallel.distributed.maybe_initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model, seq = config.resolve(world)
    _refuse_tensor_parallel(model)
    if device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device_type)
    # one row group per model index (rank = row * model + model index);
    # every rank creates every group, in the same order
    row_group = None
    for m in range(model):
        group = dist.new_group(list(range(m, world, model)))
        if rank % model == m:
            row_group = group
    return Mesh(data, seq, model, device, rank, rank // model, row_group)


def current_mesh() -> Mesh | None:
    """The ambient mesh from a ``with mesh:`` block, or None outside one."""
    return _CURRENT.get()


def _block(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    n = x.shape[0]
    if n % count:
        raise ValueError(
            f"batch rows ({n}) must divide the data*seq shard count "
            f"({count})")
    per = n // count
    return x[index * per:(index + 1) * per]


def shard_range(n: int, mesh: Mesh | None) -> tuple[int, int]:
    """[lo, hi): this rank's contiguous shard of ``n`` rows (an index's
    docs) over the mesh's rows; all of them without a mesh."""
    if mesh is None:
        return 0, n
    if n % mesh.row_size:
        raise ValueError(f"{n} rows do not shard evenly over "
                         f"{mesh.row_size} ranks")
    per = n // mesh.row_size
    return mesh.row_rank * per, (mesh.row_rank + 1) * per


def local_rows(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis over the
    combined (data, seq) axes (JAX's ``constrain_rows``); ``x`` itself
    outside a mesh. Raises ValueError when the rows do not split evenly,
    as the JAX package's shard_map does."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return x
    return _block(x, mesh.row_rank, mesh.row_size)


def batch_sharding(mesh: Mesh, ndim: int = 2) -> Any:
    """JAX's NamedSharding of a batch: the port places no DTensors, each
    rank holds its rows (``shard_batch``, ``local_rows``); not ported."""
    raise NotImplementedError(
        f"batch_sharding (DTensor placements) is not ported: a rank holds "
        f"its rows as plain tensors (shard_batch, local_rows); DTensors "
        f"come with {TENSOR_PARALLEL_ITEM}")


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """A host batch (a dict / list / tuple of arrays) as tensors on
    ``mesh.device``, each holding this rank's block of the leading axis
    over ``data`` (the seq ranks of one data index hold the same block)."""
    index = mesh.row_rank // mesh.seq

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return _block(torch.as_tensor(x), index, mesh.data).to(mesh.device)

    return put(batch)


def replicated(mesh: Mesh, tree: Any) -> Any:
    """``tree`` (a dict / list / tuple of tensors) on ``mesh.device`` with
    row rank 0's values on every rank: one broadcast a tensor over the row
    group, so that the ranks start from the same weights."""
    from pacednegatives_tpu_torch.parallel.collectives import broadcast

    if isinstance(tree, dict):
        return {k: replicated(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicated(mesh, v) for v in tree)
    return broadcast(tree.to(mesh.device), mesh)


def param_shardings(mesh: Mesh, params: Any) -> Any:
    """JAX's per-leaf tensor-parallel specs: not ported yet."""
    raise NotImplementedError(
        f"param_shardings (tensor-parallel weights) is not ported yet "
        f"({TENSOR_PARALLEL_ITEM})")
