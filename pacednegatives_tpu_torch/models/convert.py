"""Parameters and configs from the JAX package into the port.

A JAX parameter tree (nested dicts of arrays) maps onto the port's tree
one to one: same paths, same (in, out) orientation. Conversion is therefore
a flatten to "."-joined keys, ``torch.from_numpy`` on each leaf, and an
unflatten. All three layouts the JAX package writes come through as they
are, and the port's ``encode`` / ``decode`` read each of them:

- per-layer ``block_i`` (t5.init_params);
- stacked ``blocks`` with a leading layer axis (t5.stack_params,
  t5.py:1176-1220);
- fused ``qkv`` / ``kv`` attention leaves (t5.fuse_attention_params,
  t5.py:1223-1257).

``train_state_from_jax`` carries a whole JAX ``TrainState`` over: params,
the optimizer's state (optax's AdamW moments ``mu`` / ``nu`` and ``count``,
mu in fp32 or bf16; the JAX package's ``FactoredAdamState``; either inside
``optax.MultiStepsState`` with its counters and accumulated gradients), and
the curriculum's state, whichever controller made it (``EtaState`` with
its own optimizer state, ``InterpState``, ``LevelState``, ``ContrastState``
or the meta table's ``MetaState``), so a run the JAX package started can
continue in the port, and tests can start both packages from one state.

Nothing here imports JAX: trees come in as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side).
"""

from __future__ import annotations

import numpy as np
import torch

from pacednegatives_tpu_torch.curriculum import (
    ContrastState,
    EtaState,
    InterpState,
    LevelState,
    MetaState,
)
from pacednegatives_tpu_torch.models.t5 import (
    T5Config,
    flatten_params,
    unflatten_params,
)
from pacednegatives_tpu_torch.optim import (
    AdamState,
    FactoredAdamState,
    MultiStepsState,
)

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes; torch cannot read it directly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(tree: dict, device: torch.device | str = "cpu") -> dict:
    """Nested dict of numpy arrays -> the port's nested dict of tensors
    (None leaves, as a factored state's ``nu_col`` has, stay None)."""
    flat = flatten_params(tree)
    return unflatten_params(
        {k: None if v is None else _to_tensor(v).to(device)
         for k, v in flat.items()}
    )


def config_from_jax(cfg) -> T5Config:
    """A port ``T5Config`` with the fields of a JAX ``T5Config`` that the
    port has (read by attribute, so no JAX import is needed): among them
    ``attention_impl``, ``attention_chunk``, ``flash_kernel``,
    ``attn_residual_dtype``, ``flash_v3``, ``remat_policy`` and
    ``ffn_custom_vjp``. The TPU-only knobs
    (``scan_layers``, ``packed_heads``, ``packed_lanes``, ``flash_q_block``,
    ``flash_v3_interpret``) do not carry over."""
    kwargs = {f: getattr(cfg, f) for f in T5Config.__dataclass_fields__
              if f != "dtype"}
    kwargs["dtype"] = _TORCH_DTYPES[np.dtype(cfg.dtype).name]
    return T5Config(**kwargs)


def _opt_state(opt_state, device):
    """An optax state of the JAX package's ``make_optimizer`` -> the port's:
    ``MultiStepsState`` around the inner chain's; the (clip ->) adamw /
    adam chain -> ``AdamState`` (the ScaleByAdamState's mu, nu and count);
    the factored chain -> ``FactoredAdamState``. Adam's count is checked
    against the schedule's (both advance once per update)."""

    def tree(t):
        if isinstance(t, dict):
            return params_from_jax(t, device)
        return _to_tensor(t).to(device)

    if "mini_step" in getattr(opt_state, "_fields", ()):
        return MultiStepsState(
            mini_step=int(np.asarray(opt_state.mini_step)),
            gradient_step=int(np.asarray(opt_state.gradient_step)),
            inner_state=_opt_state(opt_state.inner_opt_state, device),
            acc_grads=tree(opt_state.acc_grads))
    found = []

    def walk(node):  # optax states are NamedTuples, chains plain tuples
        fields = getattr(node, "_fields", ())
        if "mu" in fields and ("nu" in fields or "nu_row" in fields):
            found.append(("adam", node))
        elif "count" in fields:
            found.append(("count", node))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    adams = [n for kind, n in found if kind == "adam"]
    if len(adams) != 1:
        raise ValueError(f"expected one Adam state in {opt_state!r}")
    adam = adams[0]
    count = int(np.asarray(adam.count))
    for kind, node in found:
        if kind == "count" and int(np.asarray(node.count)) != count:
            raise ValueError("optax schedule count differs from Adam's count")
    if "nu_row" in adam._fields:
        return FactoredAdamState(count=count, mu=tree(adam.mu),
                                 nu_row=tree(adam.nu_row),
                                 nu_col=tree(adam.nu_col))
    return AdamState(count=count, mu=tree(adam.mu), nu=tree(adam.nu))


def _scalar(a, device, dtype) -> torch.Tensor:
    return _to_tensor(a).to(device=device, dtype=dtype)


def curriculum_from_jax(cur, device: torch.device | str = "cpu"):
    """A JAX curriculum state (numpy leaves) -> the port's, told apart by
    its fields: ``EtaState`` (eta, its optimizer state; the port counts
    steps in a Python int), ``InterpState`` and ``LevelState`` (fp32 and
    int32 scalars), ``ContrastState`` (an eta and a level state) and
    ``MetaState`` (the fp32 weight table)."""
    fields = tuple(getattr(cur, "_fields", ()))
    if fields == ("eta", "opt_state", "step"):
        return EtaState(eta=_scalar(cur.eta, device, torch.float32),
                        opt_state=_opt_state(cur.opt_state, device),
                        step=int(np.asarray(cur.step)))
    if fields == ("step",):
        return InterpState(step=_scalar(cur.step, device, torch.int32))
    if fields == LevelState._fields:
        return LevelState(
            difficulty=_scalar(cur.difficulty, device, torch.float32),
            success_sum=_scalar(cur.success_sum, device, torch.float32),
            success_count=_scalar(cur.success_count, device, torch.int32),
            step=_scalar(cur.step, device, torch.int32))
    if fields == ContrastState._fields:
        return ContrastState(eta=curriculum_from_jax(cur.eta, device),
                             level=curriculum_from_jax(cur.level, device))
    if fields == MetaState._fields:
        return MetaState(table=_scalar(cur.table, device, torch.float32))
    raise ValueError(f"unknown curriculum state {type(cur).__name__} with "
                     f"fields {fields}")


def train_state_from_jax(state, *, seed: int = 42,
                         device: torch.device | str = "cpu"):
    """A JAX ``TrainState`` with numpy leaves (its ``key`` may be anything:
    the port's negatives and dropout seeds come from ``torch.Generator``s
    seeded with ``seed``) -> the port's ``TrainState`` on ``device``, its
    curriculum state by ``curriculum_from_jax``."""
    from pacednegatives_tpu_torch.train.state import TrainState

    return TrainState(
        params=params_from_jax(state.params, device),
        opt_state=_opt_state(state.opt_state, device),
        curriculum=curriculum_from_jax(state.curriculum, device),
        step=int(np.asarray(state.step)),
        generator=torch.Generator(device=device).manual_seed(seed),
        dropout_generator=torch.Generator().manual_seed(seed),
    )
