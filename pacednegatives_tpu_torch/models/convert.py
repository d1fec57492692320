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

Nothing here imports JAX: the tree comes in as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side).
"""

from __future__ import annotations

import numpy as np
import torch

from pacednegatives_tpu_torch.models.t5 import (
    T5Config,
    flatten_params,
    unflatten_params,
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
