"""Device mesh over ``torch.distributed``: the port of parallel/mesh.py.

One process per rank. The mesh keeps the JAX package's three axes:

- ``data``  - batch (data parallelism);
- ``seq``   - negative parallelism: the assembled LCE rows (B positives and
  B*n negatives) split over the combined (data, seq) axes. Each rank here
  holds the positives of its block of pairs and their negatives, as it
  does under ``data`` alone, so in the port the seq axis is plain data
  parallelism over data x seq ranks;
- ``model`` - tensor parallelism: the ranks of one row hold the same rows
  and split the weights (heads, d_ff and vocab) Megatron-style, each rank
  keeping its slice of a split leaf as a plain tensor (``shard_params``).

Where the JAX package shards arrays and lets GSPMD partition one global
program, each rank here runs the program on its own block of rows and the
steps reduce explicitly over the mesh's *row group* (the ranks of the
combined (data, seq) axes; parallel/collectives.py). Row block ``i`` of a
leading axis belongs to the rank at row index ``i``, ``seq`` varying
fastest: the order of JAX's ``P(("data", "seq"))``. The split layers of
models/t5.py exchange over the *model group* (the ranks of one row), with
explicit collectives too. Rank = row index x model + model index.

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


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, seq, model) mesh of ranks, this process's view of it.

    ``rank`` is this process's rank in the default group, ``row_rank`` its
    row index (data-major, seq fastest) and ``row_group`` the process group
    of the ranks that share its model index; ``model_rank`` is its model
    index and ``model_group`` the process group of the ranks of its row
    (None at ``model == 1``); ``device`` is where this rank computes. No
    DeviceMesh is built: every tensor is a plain one and every exchange an
    explicit collective over one of the two groups, so nothing would read
    it."""

    data: int
    seq: int
    model: int
    device: torch.device
    rank: int = 0
    row_rank: int = 0
    row_group: Any = None
    model_rank: int = 0
    model_group: Any = None
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
    Every rank calls it, in the same order as its other group calls. It
    creates the row groups (one per model index) and, with ``model > 1``,
    the model groups (one per row index), each with ``dist.new_group``."""
    config = config or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs torch.distributed initialised: call "
            "parallel.distributed.maybe_initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model, seq = config.resolve(world)
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
    # one model group per row index: the ranks row * model + (0 .. model-1)
    model_group = None
    if model > 1:
        for row in range(world // model):
            group = dist.new_group(list(range(row * model,
                                              (row + 1) * model)))
            if rank // model == row:
                model_group = group
    return Mesh(data, seq, model, device, rank, rank // model, row_group,
                rank % model, model_group)


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
        "batch_sharding (DTensor placements) is not ported: a rank holds "
        "its rows as plain tensors (shard_batch, local_rows) and its slices "
        "of the split weights as plain tensors (shard_params)")


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


# The JAX package's per-leaf rules (parallel/mesh.py:141-188): the model-
# axis dim of each leaf name. (in, out) projections: q/k/v and wi* split
# their outputs (column-parallel), o and wo their inputs (row-parallel);
# the embeddings split the vocab, rel_bias the heads; norm scales and
# every other leaf stay whole.
_RULES = {"embedding": 0, "rel_bias": 1, "wi_0": 1, "wi_1": 1, "wi": 1,
          "wo": 0, "q": 1, "k": 1, "v": 1, "o": 0}
_ATTENTION = ("self_attn", "cross_attn")


def _num_heads(params: dict) -> int:
    for stack in ("encoder", "decoder"):
        node = params.get(stack, {})
        table = node.get("rel_bias", node.get("block_0", {}).get(
            "self_attn", {}).get("rel_bias"))
        if table is not None:
            return table.shape[1]
    raise ValueError("param_shardings: no rel_bias table to read the head "
                     "count from")


def param_shardings(mesh: Mesh, params: Any) -> Any:
    """The model-axis split of every leaf of a whole T5 parameter tree: a
    tree of the same structure holding the dim that splits over
    ``mesh.model`` ranks, or None for a leaf every rank holds whole.

    It follows the JAX package's rules and their divisibility fallback (a
    dim that does not divide by ``model`` leaves the leaf whole), with one
    deliberate difference: an attention layer's q/k/v/o and rel_bias split
    only when ``num_heads % model == 0``, so that a rank holds whole heads,
    and otherwise the whole layer stays whole on every rank (JAX would
    split q mid-head where H * d_kv divides and H does not, e.g. t5-base
    at model=8). A layer with fused q|k|v or k|v leaves stays whole too:
    the port fuses each rank's slices inside the step. The numbers are the
    same either way; only the layout differs. The head count is read from
    the rel_bias tables. Stacked (``blocks``) trees raise, as
    ``stacked_layers`` does."""
    model = mesh.model
    heads = _num_heads(params) if model > 1 else 1

    def walk(node, whole=False):
        if "blocks" in node:
            raise NotImplementedError(
                "param_shardings of the stacked (blocks) layout: "
                "stacked_layers is not carried over; use block_i")
        out = {}
        for name, v in node.items():
            if isinstance(v, dict):
                out[name] = walk(v, whole or (
                    name in _ATTENTION
                    and (heads % model != 0 or "qkv" in v or "kv" in v)))
                continue
            dim = _RULES.get(name)
            if (v is None or whole or dim is None or model == 1
                    or dim >= v.dim()
                    or v.shape[dim] % model
                    or (name == "rel_bias" and heads % model)):
                dim = None
            out[name] = dim
        return out

    return walk(params)


def map_dims(fn, tree: Any, dims: Any) -> Any:
    """``fn(tensor, dim)`` on every tensor of ``tree`` (nested dicts and
    NamedTuples; ints and None pass through), ``dims`` a tree of the same
    structure whose leaves are dims or None."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_dims(fn, t, d) for t, d in zip(tree, dims)))
    if isinstance(tree, dict):
        return {k: map_dims(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree, dims)
    return tree


def shard_params(mesh: Mesh, params: Any, dims: Any = None) -> Any:
    """This rank's slices of a whole parameter tree (or of any tree of
    ``dims``' structure, an optimizer's moments say): slice
    ``mesh.model_rank`` of ``model`` equal slices along each leaf's dim,
    as a tensor of its own; a leaf with no dim is the same tensor.
    ``dims`` defaults to ``param_shardings(mesh, params)``."""
    dims = param_shardings(mesh, params) if dims is None else dims

    def cut(x, dim):
        if dim is None:
            return x
        return x.chunk(mesh.model, dim=dim)[mesh.model_rank].contiguous()

    return map_dims(cut, params, dims)


def gather_params(mesh: Mesh, shards: Any, dims: Any) -> Any:
    """The inverse of ``shard_params``: every split leaf all-gathered over
    the model group and concatenated along its dim (a collective: every
    rank of the row calls it, in the same order); whole leaves as they
    are."""
    from pacednegatives_tpu_torch.parallel.collectives import gather_model

    def whole(x, dim):
        return x if dim is None else gather_model(x, dim, mesh)

    return map_dims(whole, shards, dims)


def model_split(local: int, full: int) -> Mesh | None:
    """The ambient mesh when a rank holds ``local`` of an axis of ``full``
    (heads, d_ff or vocab split over its model group), None when it holds
    the whole axis. The split layers of models/t5.py read it from their
    weights' shapes, so whole weights run with no collective under any
    mesh. A shape that no model group explains raises."""
    if local == full:
        return None
    mesh = current_mesh()
    if mesh is None or mesh.model * local != full:
        raise ValueError(
            f"a weight holds {local} of an axis of {full}, which the mesh "
            f"({'none' if mesh is None else f'model={mesh.model}'}) does "
            f"not split so")
    return mesh


def refuse_tensor_parallel(what: str) -> None:
    """Raise under a mesh with ``model > 1``: for the entry points that no
    JAX entry point or test runs under a mesh (ROADMAP.md, "Not carried
    over")."""
    mesh = current_mesh()
    if mesh is not None and mesh.model > 1:
        raise NotImplementedError(
            f"{what} under tensor parallelism (a mesh with model="
            f"{mesh.model}): the JAX package runs it under no mesh, so the "
            f"port does not carry it over; use model=1")
