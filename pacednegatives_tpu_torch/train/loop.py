"""Training loop, metrics and checkpoints: the port of train/loop.py.

A plain host loop over steps. ``chunk_size`` keeps its logging meaning:
the loop runs ``chunk_size`` steps, gathers their metrics from the device
once, and writes them as the JAX loop writes one scanned chunk. The
checkpoint holds everything resume needs (params, the optimizer's state,
curriculum state, step, the sampling and dropout generators' states), written
with ``torch.save`` (there is no orbax), so resume is exact. Under tensor
parallelism the file holds whole leaves (gathered over the model group
first), so that one process reads it, and restoring into a rank's state
shards it again.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from pacednegatives_tpu_torch.models.t5 import flatten_params, unflatten_params
from pacednegatives_tpu_torch.parallel.mesh import current_mesh
from pacednegatives_tpu_torch.train.state import (
    TrainState,
    gather_train_state,
    shard_train_state,
)
from pacednegatives_tpu_torch.utils.profiling import host_sync, span


class MetricWriter:
    """JSONL metric stream (one line per logged step), with optional wandb
    mirroring when the package exists and a project is named."""

    def __init__(self, path: str | None, wandb_project: str | None = None,
                 wandb_config: dict | None = None):
        self._f = open(path, "a") if path else None
        self.history: list[dict] = []
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_project, config=wandb_config or {}
                )
            except Exception:
                self._wandb = None

    def write(self, record: dict[str, Any]) -> None:
        rec = {
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in record.items()
        }
        self.history.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec)

    def flush(self) -> None:
        if self._f:
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


# -- checkpointing -----------------------------------------------------------

CHECKPOINT_FILE = "state.pt"


def _plain(node):
    """NamedTuples and dicts of tensors/ints -> nested dicts (what
    ``torch.load(weights_only=True)`` reads back)."""
    if hasattr(node, "_asdict"):
        return {k: _plain(v) for k, v in node._asdict().items()}
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return node


def _restore(saved, template):
    """Rebuild ``saved`` in the structure, types, devices and dtypes of
    ``template``, refusing a checkpoint whose structure differs."""
    if hasattr(template, "_asdict"):
        fields = template._asdict()
        if set(saved) != set(fields):
            raise ValueError(f"checkpoint fields {sorted(saved)} != "
                             f"{sorted(fields)}")
        return type(template)(**{k: _restore(saved[k], v)
                                 for k, v in fields.items()})
    if isinstance(template, dict):
        if set(saved) != set(template):
            raise ValueError(
                f"checkpoint keys differ: {sorted(set(saved) ^ set(template))}")
        return {k: _restore(saved[k], v) for k, v in template.items()}
    if template is None:  # a factored state's nu_col of a 1-D leaf
        if saved is not None:
            raise ValueError(f"checkpoint holds {type(saved)} where the "
                             "state has None")
        return None
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} != "
                             f"{tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    return type(template)(saved)


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write ``path/state.pt`` (atomically: a temp file, then a rename)."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": flatten_params(state.params),
        "opt_state": _plain(state.opt_state),
        "curriculum": _plain(state.curriculum),
        "step": state.step,
        "generator": state.generator.get_state(),
        "dropout_generator": state.dropout_generator.get_state(),
    }
    tmp = os.path.join(path, f".{CHECKPOINT_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def checkpoint(mesh, path: str, state: TrainState) -> None:
    """``save_checkpoint`` by rank 0 of a mesh (every rank of a row holds
    the same state, and under tensor parallelism the whole leaves are
    gathered over the model group first), between two barriers: no rank
    goes on, or reads it, before it is written."""
    if mesh is None:
        save_checkpoint(path, state)
        return
    state = gather_train_state(mesh, state)
    mesh.barrier()
    if mesh.rank == 0:
        save_checkpoint(path, state)
    mesh.barrier()


def writer_of(mesh, writer: "MetricWriter | None") -> "MetricWriter":
    """The loop's metric writer: ``writer`` (or a null one) on rank 0 of a
    mesh and without a mesh, a null one on the other ranks."""
    if writer is None or (mesh is not None and mesh.rank != 0):
        return MetricWriter(None)
    return writer


def latest_checkpoint(out_dir: str) -> str | None:
    """Newest step_N checkpoint under ``out_dir`` (else 'final' if present)."""
    if not os.path.isdir(out_dir):
        return None
    steps = []
    for name in os.listdir(out_dir):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append((int(name[5:]), name))
    if steps:
        return os.path.join(out_dir, max(steps)[1])
    final = os.path.join(out_dir, "final")
    return final if os.path.exists(final) else None


def restore_checkpoint(path: str, template: TrainState,
                       generators: bool = True) -> TrainState:
    """Restore into the structure of ``template`` (an initialized state).
    ``generators=False`` keeps the template's generators: a run trained on
    the card saved a CUDA generator's state, which no CPU generator takes,
    and reloading weights to score needs none. A rank's template (with
    ``param_dims``, under the tensor-parallel mesh it was sharded on)
    reads the whole leaves and keeps its slices: every rank calls it."""
    if template.param_dims is not None:
        mesh = current_mesh()
        whole = restore_checkpoint(path, gather_train_state(mesh, template),
                                   generators)
        return shard_train_state(mesh, whole, template.param_dims)
    saved = torch.load(os.path.join(path, CHECKPOINT_FILE),
                       map_location="cpu", weights_only=True)
    params = unflatten_params(_restore(
        saved["params"], flatten_params(template.params)))
    generator, dropout_generator = (template.generator,
                                    template.dropout_generator)
    if generators:
        generator = torch.Generator(device=template.generator.device)
        generator.set_state(saved["generator"])
        dropout_generator = torch.Generator()
        dropout_generator.set_state(saved["dropout_generator"])
    return TrainState(
        params=params,
        opt_state=_restore(saved["opt_state"], template.opt_state),
        curriculum=_restore(saved["curriculum"], template.curriculum),
        step=int(saved["step"]),
        generator=generator,
        dropout_generator=dropout_generator,
    )


# -- index stream ------------------------------------------------------------


def pair_index_stream(
    num_pairs: int,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    exclude=None,
) -> Iterator[np.ndarray]:
    """Deterministic epoch-permuted (B,) pair-index batches, forever.

    ``exclude``: pair rows withheld from training (the held-out eval set)."""
    pool = np.arange(num_pairs)
    if exclude is not None and len(exclude) > 0:
        pool = np.setdiff1d(pool, np.asarray(exclude))
    if len(pool) < batch_size:
        raise ValueError(
            f"{len(pool)} trainable pairs < batch_size={batch_size}: no full "
            "batch can be formed (the stream would spin forever)"
        )
    rng = np.random.default_rng(seed)
    n = len(pool)
    while True:
        order = rng.permutation(pool) if shuffle else pool
        for i in range(n // batch_size):
            yield order[i * batch_size : (i + 1) * batch_size].astype(np.int32)


# -- loop ---------------------------------------------------------------------


@dataclasses.dataclass
class TrainLoop:
    fused_step: Callable  # (state, (B,) pair_idx) -> (state, metrics)
    num_pairs: int
    batch_size: int
    chunk_size: int = 16  # steps between metric reads
    seed: int = 0
    shuffle: bool = True
    log_every_chunks: int = 1
    # "last": chunk-final step only; "mean": per-chunk aggregates;
    # "all": one row per step
    log_mode: str = "last"
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 0
    # eval_fn(state) -> {metric: float}, every eval_every_steps, logged
    # with an "eval/" prefix
    eval_fn: Callable | None = None
    eval_every_steps: int = 0
    exclude_pairs: tuple = ()  # held-out rows never fed to training
    # when set, passed to fused_step as its third argument; the pair
    # indices go to its device
    corpus: object | None = None

    def _step(self, state, idx):
        if self.corpus is not None:
            return self.fused_step(state, idx, self.corpus)
        return self.fused_step(state, idx)

    def run(self, state: TrainState, total_steps: int,
            writer: MetricWriter | None = None) -> TrainState:
        """Train to ``total_steps``. Under a mesh, run it inside ``with
        mesh:`` on every rank: the same pair stream feeds every rank, and
        rank 0 writes the metrics and checkpoints."""
        with span("pnt.loop.run"):
            return self._run(state, total_steps, writer)

    def _run(self, state, total_steps, writer):
        mesh = current_mesh()
        writer = writer_of(mesh, writer)
        stream = pair_index_stream(
            self.num_pairs, self.batch_size, self.seed, self.shuffle,
            exclude=self.exclude_pairs,
        )
        device = self.corpus.device if self.corpus is not None else "cpu"
        start_step = int(state.step)
        for _ in range(start_step):  # skip consumed batches: exact resume
            next(stream)

        t0 = time.perf_counter()
        done = start_step
        chunk_i = 0
        last_ckpt = done
        last_eval = done
        while done < total_steps:
            with span("pnt.loop.chunk", done):
                n = min(self.chunk_size, total_steps - done)
                idx = torch.from_numpy(
                    np.stack([next(stream) for _ in range(n)]).astype(np.int64)
                )
                with host_sync("loop.pair_idx"):
                    idx = idx.to(device)
                rows = []
                for t in range(n):
                    state, m = self._step(state, idx[t])
                    rows.append(m)
                done += n
                chunk_i += 1

                if chunk_i % self.log_every_chunks == 0:
                    write_chunk_metrics(writer, rows, done,
                                        done_per_sec(done - start_step, t0),
                                        self.log_mode)

                if (
                    self.checkpoint_dir
                    and self.checkpoint_every_steps
                    and done - last_ckpt >= self.checkpoint_every_steps
                ):
                    last_ckpt = done
                    checkpoint(mesh, os.path.join(self.checkpoint_dir,
                                                  f"step_{done}"), state)

                if (
                    self.eval_fn is not None
                    and self.eval_every_steps
                    and done - last_eval >= self.eval_every_steps
                ):
                    last_eval = done
                    ev = self.eval_fn(state)
                    writer.write(
                        {"step": done,
                         **{f"eval/{k}": v for k, v in ev.items()}}
                    )
                    writer.flush()

        writer.write({"step": done, "time": time.perf_counter() - t0})
        writer.flush()
        return state


def done_per_sec(steps: int, t0: float) -> float:
    """Steps a second since ``t0`` (``time.perf_counter``)."""
    dt = time.perf_counter() - t0
    return steps / dt if dt > 0 else 0.0


def write_chunk_metrics(writer: MetricWriter, rows: list[dict], done: int,
                        sps: float, log_mode: str) -> None:
    """Write one chunk's per-step metric dicts (read from the device once)
    ending at step ``done``: every step ("all"), their mean ("mean") or
    the last ("last"); ``steps_per_sec`` goes on the chunk's last row."""
    with span("pnt.loop.read_metrics"):
        n = len(rows)
        with host_sync("loop.metrics", len(rows[0])):
            host = {k: torch.stack([r[k] for r in rows]).float().cpu()
                    .numpy() for k in rows[0]}
        if log_mode == "all":
            for t in range(n):
                row = {k: v[t] for k, v in host.items()}
                if t == n - 1:
                    row["steps_per_sec"] = sps
                writer.write({"step": done - n + 1 + t, **row})
        elif log_mode == "mean":
            writer.write({"step": done,
                          **{k: v.mean() for k, v in host.items()},
                          "steps_per_sec": sps})
        else:
            writer.write({"step": done,
                          **{k: v[-1] for k, v in host.items()},
                          "steps_per_sec": sps})
        writer.flush()
