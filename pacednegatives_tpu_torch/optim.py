"""The part of optax that the JAX package's training uses, in optax's
arithmetic, on trees (nested dicts) of tensors or on a bare tensor.

``Adam`` is ``optax.adam`` (``weight_decay=None``) or ``optax.adamw``
(``weight_decay`` a float; optax adds ``weight_decay * p`` even at 0.0),
optionally behind ``optax.clip_by_global_norm``:

- clip: g_norm = the global L2 norm over every leaf; when g_norm >=
  max_norm every leaf is scaled by max_norm / g_norm, and otherwise left
  exactly as it is. This is not ``torch.nn.utils.clip_grad_norm_``, which
  adds 1e-6 to the norm and always rescales.
- moments: mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu, in fp32.
- bias correction at the incremented count: mu / (1 - b1^count),
  nu / (1 - b2^count); update = mu_hat / (sqrt(nu_hat) + eps).
- learning rate: the schedule is read at the count BEFORE the increment
  (so a warmup schedule's first update uses lr(0) = 0) and the update is
  scaled by -lr; ``apply_updates`` adds it to the parameters.

The update stays on the device and syncs nothing with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from pacednegatives_tpu_torch.models.t5 import tree_map


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the order jax.tree_util uses for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """Put ``leaves`` (in ``tree_leaves`` order) into ``tree``'s structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: Any     # first moment, fp32, the tree's structure
    nu: Any     # second moment, fp32


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: Callable[[int], float]  # schedule over the update count
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float | None = None  # None: optax.adam; float: optax.adamw
    clip_norm: float | None = None     # clip_by_global_norm in front

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamState(count=0, mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(self, grads, state: AdamState, params):
        """-> (updates, new state), as ``tx.update(grads, state, params)``.

        Each step is one multi-tensor (``torch._foreach_*``) op over every
        leaf, with the same per-element arithmetic as a per-leaf loop; the
        constants are Python floats, which PyTorch applies in fp32 to fp32
        tensors as JAX applies weak-typed constants."""
        g = tree_leaves(grads)
        if self.clip_norm is not None:
            g_norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
            # (g / g_norm) * max_norm only when g_norm >= max_norm; scaling
            # by max_norm / g_norm rounds once where optax rounds twice
            scale = torch.where(g_norm < self.clip_norm,
                                torch.ones_like(g_norm),
                                self.clip_norm / g_norm)
            g = torch._foreach_mul(g, scale)
        mu = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(tree_leaves(state.mu),
                                                   self.b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(tree_leaves(state.nu),
                                                   self.b2))
        count = state.count + 1
        # bias corrections at the incremented count, in fp32
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(count))
        bc2 = float(f(1) - f(self.b2) ** f(count))
        updates = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(updates, denom)
        if self.weight_decay is not None:
            torch._foreach_add_(updates, torch._foreach_mul(
                tree_leaves(params), self.weight_decay))
        torch._foreach_mul_(updates, -float(self.learning_rate(state.count)))
        return (tree_unflatten(grads, updates),
                AdamState(count=count, mu=tree_unflatten(grads, mu),
                          nu=tree_unflatten(grads, nu)))


def apply_updates(params, updates):
    """p + u (optax.apply_updates), for fp32 params and updates."""
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))
