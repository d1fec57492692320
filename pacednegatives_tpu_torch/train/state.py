"""Training state and optimizer: the port of train/state.py.

AdamW + the HF linear warmup-decay schedule, with optional global-norm
clipping (optax's arithmetic, see optim.py), and the JAX package's moment
variants: fp32, a bf16 first moment, or the factored second moment with a
bf16 first moment; ``grad_accum_steps > 1`` wraps it in MultiSteps.
Defaults match the legacy transformers.AdamW every reference trainer
imports: eps 1e-6, weight decay 0.0.

Under tensor parallelism a ``TrainState`` holds this rank's slices of the
split leaves and of their optimizer moments, and ``param_dims``, the split
dim of every parameter (``shard_train_state``; ``gather_train_state`` is
the inverse); the step, the checkpoints and the refresh read it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pacednegatives_tpu_torch.curriculum.eta import linear_warmup_decay
from pacednegatives_tpu_torch.optim import (
    Adam,
    FactoredAdam,
    MultiSteps,
    state_dims,
    tree_leaves,
)
from pacednegatives_tpu_torch.parallel.mesh import (
    Mesh,
    gather_params,
    param_shardings,
    shard_params,
)


class TrainState(NamedTuple):
    params: Any            # nested dict of fp32 master weights
    opt_state: Any         # the optimizer's (optim.py) state
    curriculum: Any        # the controller's state
    step: int
    generator: torch.Generator  # negative sampling, on the params' device
    # the dropout masks' seeds, one a microbatch, drawn on the host
    dropout_generator: torch.Generator
    # under tensor parallelism, each parameter's split dim (None: whole),
    # the tree of parallel.mesh.param_shardings; None without a split
    param_dims: Any = None


def make_optimizer(
    lr: float,
    total_steps: int,
    warmup_steps: int | None = None,
    weight_decay: float = 0.0,
    eps: float = 1e-6,
    grad_clip: float | None = 1.0,
    grad_accum_steps: int = 1,
    moments: str = "fp32",
):
    """AdamW + linear warmup-decay (+ global-norm clipping), as the JAX
    package's ``make_optimizer`` builds it in optax: ``moments`` "fp32"
    (exact AdamW), "bf16_mu" (AdamW with a bf16 first moment) or
    "factored" (``FactoredAdam``); ``grad_accum_steps = k > 1`` wraps it in
    ``MultiSteps``, whose schedule counts applied updates (total and warmup
    divided by k)."""
    if warmup_steps is None:
        warmup_steps = max(total_steps // 100, 1)
    if grad_accum_steps > 1:
        total_steps = max(total_steps // grad_accum_steps, 1)
        warmup_steps = max(warmup_steps // grad_accum_steps, 1)
    if moments not in ("fp32", "bf16_mu", "factored"):
        raise ValueError(
            f"moments must be 'fp32', 'bf16_mu', or 'factored', got {moments!r}"
        )
    schedule = linear_warmup_decay(lr, warmup_steps, total_steps)
    if moments == "factored":
        tx = FactoredAdam(schedule, eps=eps, weight_decay=weight_decay,
                          clip_norm=grad_clip)
    else:
        tx = Adam(schedule, eps=eps, weight_decay=weight_decay,
                  clip_norm=grad_clip,
                  mu_dtype=(torch.bfloat16 if moments == "bf16_mu"
                            else torch.float32))
    if grad_accum_steps > 1:
        tx = MultiSteps(tx, grad_accum_steps)
    return tx


def init_train_state(params: Any, tx, curriculum_state: Any,
                     seed: int = 42) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        curriculum=curriculum_state,
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed),
        dropout_generator=torch.Generator().manual_seed(seed),
    )


def shard_train_state(mesh: Mesh, state: TrainState,
                      dims: Any = None) -> TrainState:
    """A whole state -> this rank's: its slices of the split parameters
    and of their optimizer moments (``optim.state_dims``), with
    ``param_dims`` set. ``dims`` defaults to
    ``param_shardings(mesh, state.params)``."""
    dims = param_shardings(mesh, state.params) if dims is None else dims
    return state._replace(
        params=shard_params(mesh, state.params, dims),
        opt_state=shard_params(mesh, state.opt_state,
                               state_dims(state.opt_state, dims)),
        param_dims=dims)


def gather_train_state(mesh: Mesh, state: TrainState) -> TrainState:
    """The inverse of ``shard_train_state``: whole parameters and moments
    on every rank of the row, ``param_dims`` None (a collective over the
    model group); a state without ``param_dims`` as it is."""
    if state.param_dims is None:
        return state
    dims = state.param_dims
    return state._replace(
        params=gather_params(mesh, state.params, dims),
        opt_state=gather_params(mesh, state.opt_state,
                                state_dims(state.opt_state, dims)),
        param_dims=None)


def encoder_weights(state: TrainState, mesh: Mesh | None) -> dict:
    """The shared embedding and the encoder stack, whole: what an index
    refresh encodes with. Under tensor parallelism they are gathered over
    the model group, on the calling thread, so that the encode itself runs
    no collective (an overlapped refresh runs it on a thread of its own)."""
    params = {k: state.params[k] for k in ("shared", "encoder")}
    if state.param_dims is None or mesh is None:
        return params
    return gather_params(mesh, params,
                         {k: state.param_dims[k] for k in params})
