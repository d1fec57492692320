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
the optax AdamW moments ``mu`` / ``nu`` and ``count``, and the curriculum's
``EtaState`` with its own optimizer state, so a run the JAX package started
can continue in the port, and tests can start both packages from one state.

Nothing here imports JAX: trees come in as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side).
"""

from __future__ import annotations

import numpy as np
import torch

from pacednegatives_tpu_torch.curriculum.eta import EtaState
from pacednegatives_tpu_torch.models.t5 import (
    T5Config,
    flatten_params,
    unflatten_params,
)
from pacednegatives_tpu_torch.optim import AdamState

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
    """Nested dict of numpy arrays -> the port's nested dict of tensors."""
    flat = flatten_params(tree)
    return unflatten_params(
        {k: _to_tensor(v).to(device) for k, v in flat.items()}
    )


def config_from_jax(cfg) -> T5Config:
    """A port ``T5Config`` with the forward-relevant fields of a JAX
    ``T5Config`` (read by attribute, so no JAX import is needed).
    ``flash_v3`` carries over; the TPU-only knobs do not."""
    kwargs = {f: getattr(cfg, f) for f in T5Config.__dataclass_fields__
              if f != "dtype"}
    kwargs["dtype"] = _TORCH_DTYPES[np.dtype(cfg.dtype).name]
    return T5Config(**kwargs)


def _adam_state(opt_state, device) -> AdamState:
    """The optax (clip ->) adamw / adam chain state -> AdamState: the
    ScaleByAdamState's mu, nu and count, checked against the schedule's
    count (both advance once per update)."""
    found = []

    def walk(node):  # optax states are NamedTuples, chains plain tuples
        fields = getattr(node, "_fields", ())
        if "mu" in fields and "nu" in fields:
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

    def tree(t):
        if isinstance(t, dict):
            return params_from_jax(t, device)
        return _to_tensor(t).to(device)

    return AdamState(count=count, mu=tree(adam.mu), nu=tree(adam.nu))


def train_state_from_jax(state, *, seed: int = 42,
                         device: torch.device | str = "cpu"):
    """A JAX ``TrainState`` with numpy leaves (its ``key`` may be anything:
    the port's negatives come from a ``torch.Generator`` seeded with
    ``seed``) -> the port's ``TrainState`` on ``device``. The curriculum
    must be an ``EtaState``."""
    from pacednegatives_tpu_torch.train.state import TrainState

    cur = state.curriculum
    curriculum = EtaState(
        eta=_to_tensor(cur.eta).to(device),
        opt_state=_adam_state(cur.opt_state, device),
        step=int(np.asarray(cur.step)),
    )
    return TrainState(
        params=params_from_jax(state.params, device),
        opt_state=_adam_state(state.opt_state, device),
        curriculum=curriculum,
        step=int(np.asarray(state.step)),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
