"""The part of optax that the JAX package's training uses, in optax's
arithmetic, on trees (nested dicts) of tensors or on a bare tensor.

``Adam`` is ``optax.adam`` (``weight_decay=None``) or ``optax.adamw``
(``weight_decay`` a float; optax adds ``weight_decay * p`` even at 0.0),
optionally behind ``optax.clip_by_global_norm``, with an fp32 or a bf16
first moment (``mu_dtype``):

- clip: g_norm = the global L2 norm over every leaf; when g_norm >=
  max_norm every leaf is scaled by max_norm / g_norm, and otherwise left
  exactly as it is. This is not ``torch.nn.utils.clip_grad_norm_``, which
  adds 1e-6 to the norm and always rescales.
- moments: mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu, in fp32.
  A bf16 mu is read in fp32 and its decay b1 rounded to bf16 (optax's
  weak-typed constant takes mu's dtype); the update uses the fp32 mu and
  only the stored one is rounded to bf16 (optax 0.2.6 ``scale_by_adam``).
- bias correction at the incremented count: mu / (1 - b1^count),
  nu / (1 - b2^count); update = mu_hat / (sqrt(nu_hat) + eps).
- learning rate: the schedule is read at the count BEFORE the increment
  (so a warmup schedule's first update uses lr(0) = 0) and the update is
  scaled by -lr; ``apply_updates`` adds it to the parameters.

``FactoredAdam`` is the JAX package's ``scale_by_adam_factored`` chain
(train/state.py:35-128, 160-166): a bf16 mu and Adafactor-style fp32 row
and column EMAs of g^2 for leaves of two or more dims. ``MultiSteps`` is
``optax.MultiSteps``: the gradients' running mean over k mini-steps, the
inner optimizer applied to it on the k-th, zero updates on the others.

The update stays on the device and syncs nothing with the host.

Under tensor parallelism (parallel/mesh.py) each rank holds its slices of
the split leaves and ``update`` takes ``model_dims``, the split dim of
each leaf (None for a whole one): the clip's global norm counts every
logical element once (a split leaf's squared norm summed over the model
group, a whole leaf's counted once), and the factored moments' means over
a split axis are taken over the model group. Everything else is
elementwise and runs on the slices as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from pacednegatives_tpu_torch.models.t5 import tree_map
from pacednegatives_tpu_torch.parallel.collectives import model_sum
from pacednegatives_tpu_torch.parallel.mesh import current_mesh


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


def _zeros(p: torch.Tensor, dtype=torch.float32, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                       device=p.device)


def _split_leaves(model_dims, n: int) -> list:
    """Each leaf's split dim (``tree_leaves`` order), None for all-whole
    or without a model group."""
    mesh = current_mesh()
    if model_dims is None or mesh is None or mesh.model == 1:
        return [None] * n
    return tree_leaves(model_dims)


def _clip(g: list, clip_norm: float | None, split: list) -> list:
    """optax.clip_by_global_norm on a list of leaves; ``split`` (each
    leaf's split dim or None) sums the split leaves' squares over the
    model group."""
    if clip_norm is None:
        return g
    sq = torch.stack(torch._foreach_norm(g)).square()
    if any(d is not None for d in split):
        is_split = torch.tensor([d is not None for d in split],
                                device=sq.device)
        g_norm = (model_sum(torch.where(is_split, sq, 0.0).sum(),
                            current_mesh())
                  + torch.where(is_split, 0.0, sq).sum()).sqrt()
    else:
        g_norm = sq.sum().sqrt()
    # (g / g_norm) * max_norm only when g_norm >= max_norm; scaling by
    # max_norm / g_norm rounds once where optax rounds twice
    scale = torch.where(g_norm < clip_norm, torch.ones_like(g_norm),
                        clip_norm / g_norm)
    return torch._foreach_mul(g, scale)


def _bias_correction(b: float, count: int) -> float:
    """1 - b^count in fp32, as optax and the factored chain compute it."""
    f = np.float32
    return float(f(1) - f(b) ** f(count))


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: Any     # first moment (fp32, or bf16), the tree's structure
    nu: Any     # second moment, fp32


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: Callable[[int], float]  # schedule over the update count
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float | None = None  # None: optax.adam; float: optax.adamw
    clip_norm: float | None = None     # clip_by_global_norm in front
    mu_dtype: torch.dtype = torch.float32  # the stored first moment's

    def init(self, params) -> AdamState:
        return AdamState(count=0,
                         mu=tree_map(lambda p: _zeros(p, self.mu_dtype),
                                     params),
                         nu=tree_map(_zeros, params))

    def update(self, grads, state: AdamState, params, model_dims=None):
        """-> (updates, new state), as ``tx.update(grads, state, params)``.

        Each step is one multi-tensor (``torch._foreach_*``) op over every
        leaf, with the same per-element arithmetic as a per-leaf loop; the
        constants are Python floats, which PyTorch applies in fp32 to fp32
        tensors as JAX applies weak-typed constants. ``model_dims``: see
        the module docstring."""
        g = tree_leaves(grads)
        g = _clip(g, self.clip_norm, _split_leaves(model_dims, len(g)))
        mu = torch._foreach_mul(g, 1 - self.b1)
        mu_prev = tree_leaves(state.mu)
        b1 = self.b1
        if self.mu_dtype != torch.float32:
            # b1 * mu with mu in bf16: the weak-typed b1 rounds to bf16,
            # the product is taken in fp32 (XLA keeps the excess precision)
            b1 = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu_prev = [m.float() for m in mu_prev]
        torch._foreach_add_(mu, torch._foreach_mul(mu_prev, b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(tree_leaves(state.nu),
                                                   self.b2))
        count = state.count + 1
        # bias corrections at the incremented count, in fp32
        updates = torch._foreach_div(mu, _bias_correction(self.b1, count))
        denom = torch._foreach_div(nu, _bias_correction(self.b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(updates, denom)
        if self.weight_decay is not None:
            torch._foreach_add_(updates, torch._foreach_mul(
                tree_leaves(params), self.weight_decay))
        torch._foreach_mul_(updates, -float(self.learning_rate(state.count)))
        if self.mu_dtype != torch.float32:
            mu = [m.to(self.mu_dtype) for m in mu]
        return (tree_unflatten(grads, updates),
                AdamState(count=count, mu=tree_unflatten(grads, mu),
                          nu=tree_unflatten(grads, nu)))


class FactoredAdamState(NamedTuple):
    count: int   # updates applied so far
    mu: Any      # bf16 first moment, full shape
    nu_row: Any  # fp32 row EMA of g^2 (last axis reduced); full nu below 2-D
    nu_col: Any  # fp32 column EMA of g^2 (second-to-last axis reduced);
    #              None below 2-D


@dataclasses.dataclass(frozen=True)
class FactoredAdam:
    """clip_by_global_norm -> scale_by_adam_factored ->
    add_decayed_weights (when weight_decay is nonzero) ->
    scale_by_learning_rate, as ``make_optimizer(moments="factored")``
    chains them in the JAX package. v is approximated as
    (r / max(mean(r), 1e-30)) outer c, over the bias correction."""

    learning_rate: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0
    clip_norm: float | None = None

    def init(self, params) -> FactoredAdamState:
        def row(p):
            return _zeros(p, shape=p.shape[:-1]) if p.dim() >= 2 else _zeros(p)

        def col(p):
            if p.dim() < 2:
                return None
            return _zeros(p, shape=p.shape[:-2] + p.shape[-1:])

        return FactoredAdamState(
            count=0, mu=tree_map(lambda p: _zeros(p, torch.bfloat16), params),
            nu_row=tree_map(row, params), nu_col=tree_map(col, params))

    def update(self, grads, state: FactoredAdamState, params,
               model_dims=None):
        """-> (updates, new state); the arithmetic of
        ``scale_by_adam_factored`` (train/state.py:80-128), leaf by leaf.
        A mean over an axis that a rank holds a slice of (the last for a
        column-parallel leaf, the second-to-last for a row-parallel one)
        is the model group's sum over the whole axis's length."""
        b1, b2 = self.b1, self.b2
        g = tree_leaves(grads)
        split = _split_leaves(model_dims, len(g))
        g = _clip(g, self.clip_norm, split)
        mesh = current_mesh()

        def mean(x, dim, d, keepdim=False):
            if d is None or d != x.dim() + dim:
                return x.mean(dim=dim, keepdim=keepdim)
            return (model_sum(x.sum(dim=dim, keepdim=keepdim), mesh)
                    / (x.shape[dim] * mesh.model))
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        lr = -float(self.learning_rate(state.count))
        mus, rows, cols, updates = [], [], [], []
        for g_, m, r, c, p, d in zip(g, tree_leaves(state.mu),
                                     tree_leaves(state.nu_row),
                                     tree_leaves(state.nu_col),
                                     tree_leaves(params), split):
            m = (b1 * m.float() + (1 - b1) * g_).to(torch.bfloat16)
            g2 = g_.square()
            if c is None:
                r = b2 * r + (1 - b2) * g2
                v_hat = r / c2
            else:
                r = b2 * r + (1 - b2) * mean(g2, -1, d)
                c = b2 * c + (1 - b2) * mean(g2, -2, d)
                # v_ij ~= R_i * C_j / mean_i(R): exact for rank-1 g^2; R
                # holds the leaf's rows, split where its rows are
                d_r = None if d is None or d == g_.dim() - 1 else d
                denom = mean(r, -1, d_r, keepdim=True).clamp_min(1e-30)
                v_hat = ((r / denom)[..., :, None] * c[..., None, :]) / c2
            u = (m.float() / c1) / (v_hat.sqrt() + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            mus.append(m)
            rows.append(r)
            cols.append(c)
            updates.append(u * lr)
        return (tree_unflatten(grads, updates),
                FactoredAdamState(count=count, mu=tree_unflatten(grads, mus),
                                  nu_row=tree_unflatten(grads, rows),
                                  nu_col=tree_unflatten(grads, cols)))


class MultiStepsState(NamedTuple):
    mini_step: int       # gradients accumulated since the last update
    gradient_step: int   # updates applied so far
    inner_state: Any     # the inner optimizer's state
    acc_grads: Any       # running mean of this round's gradients, fp32


@dataclasses.dataclass(frozen=True)
class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with the gradient
    mean: each mini-step folds its gradient into the running mean
    acc + (g - acc) / (mini_step + 1); the k-th runs ``inner`` on the mean
    and returns its updates, the others return zeros."""

    inner: Any
    every_k: int

    def init(self, params) -> MultiStepsState:
        return MultiStepsState(mini_step=0, gradient_step=0,
                               inner_state=self.inner.init(params),
                               acc_grads=tree_map(_zeros, params))

    def update(self, grads, state: MultiStepsState, params,
               model_dims=None):
        acc = tree_leaves(state.acc_grads)
        step = torch._foreach_sub(tree_leaves(grads), acc)
        torch._foreach_div_(step, float(state.mini_step + 1))
        acc = torch._foreach_add(acc, step)
        if state.mini_step == self.every_k - 1:
            updates, inner = self.inner.update(tree_unflatten(grads, acc),
                                               state.inner_state, params,
                                               model_dims=model_dims)
            return updates, MultiStepsState(
                mini_step=0, gradient_step=state.gradient_step + 1,
                inner_state=inner, acc_grads=tree_map(_zeros, grads))
        return tree_map(_zeros, grads), state._replace(
            mini_step=state.mini_step + 1,
            acc_grads=tree_unflatten(grads, acc))


def state_dims(state, dims):
    """The split dim of every tensor of an optimizer state (the tree of
    ``dims``, a parameter tree's split dims, in each moment's place): the
    moments and accumulated gradients split as their leaf; a factored
    row EMA (the last axis reduced) splits where its leaf's rows do, a
    column EMA where its columns do."""
    if isinstance(state, AdamState):
        return AdamState(count=None, mu=dims, nu=dims)
    if isinstance(state, MultiStepsState):
        return MultiStepsState(mini_step=None, gradient_step=None,
                               inner_state=state_dims(state.inner_state,
                                                      dims),
                               acc_grads=dims)
    if isinstance(state, FactoredAdamState):
        def row(d, m):
            if d is None or m.dim() < 2:
                return d
            return None if d == m.dim() - 1 else d

        def col(d, m):
            if d is None or m.dim() < 2 or d == m.dim() - 2:
                return None
            return m.dim() - 2 if d == m.dim() - 1 else d

        def both(fn):
            return tree_unflatten(dims, [fn(d, m) for d, m in zip(
                tree_leaves(dims), tree_leaves(state.mu))])

        return FactoredAdamState(count=None, mu=dims, nu_row=both(row),
                                 nu_col=both(col))
    raise TypeError(f"state_dims: unknown optimizer state "
                    f"{type(state).__name__}")


def apply_updates(params, updates):
    """p + u (optax.apply_updates), for fp32 params and updates."""
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))
