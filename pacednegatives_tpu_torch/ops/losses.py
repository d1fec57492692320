"""Training losses: the port of ops/losses.py (pairwise CE, LCE, self-paced
eta-weighting, MarginMSE).

Same functions, same arguments, same reductions; CE reductions are
per-example (mean over non-ignored label tokens) so curriculum weights apply
per example. The reference-parity notes of the JAX module
(pacednegatives_tpu/ops/losses.py:1-20) hold here unchanged.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def token_ce_per_token(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """(B, L, V) logits, (B, L) labels -> (B, L) CE, ignored positions 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    tok = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, tok, 0.0)


def token_ce(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """(B,) mean CE over each example's non-ignored tokens."""
    valid = labels != ignore_index
    tok = token_ce_per_token(logits, labels, ignore_index)
    count = valid.sum(dim=-1).clamp_min(1)
    return tok.sum(dim=-1) / count


def pairwise_ce_loss(pce: torch.Tensor, nce: torch.Tensor) -> torch.Tensor:
    """mean(pce) + mean(nce) — the plain main loss of every wrapper."""
    return pce.mean() + nce.mean()


def lce_ce(pce: torch.Tensor, nce: torch.Tensor, n: int,
           use_mean: bool = True) -> torch.Tensor:
    """LCE per-example CE: pce (B,) + mean or sum over each example's n
    negatives of nce (B*n,) -> (B,)."""
    grouped = nce.reshape(-1, n)
    agg = grouped.mean(dim=1) if use_mean else grouped.sum(dim=1)
    return pce + agg


def lce_ce_flat_tokens(pce_tok: torch.Tensor, nce_tok: torch.Tensor, n: int,
                       use_mean: bool = True) -> torch.Tensor:
    """LCE CE with the reference's verbatim flat-token regrouping
    (``nce.view(-1, n)``): pce_tok (B, L), nce_tok (B*n, L) -> (B*L,). See
    pacednegatives_tpu/ops/losses.py:76-99 for why the quirk is kept."""
    grouped = nce_tok.reshape(-1, n)
    agg = grouped.mean(dim=1) if use_mean else grouped.sum(dim=1)
    return pce_tok.reshape(-1) + agg


def eta_weight(ce: torch.Tensor, eta, kind: str = "eta") -> torch.Tensor:
    """Self-paced weight v(ce; eta): where ce <= eta, 1 - ce/eta (kind
    'eta') or ce/eta (kind 'lce'); else 0. The gradient wrt eta flows only
    through the active branch."""
    eta = torch.as_tensor(eta, dtype=ce.dtype, device=ce.device)
    below = ce <= eta
    if kind == "eta":
        active = 1.0 - ce / eta
    elif kind == "lce":
        active = ce / eta
    else:
        raise ValueError(f"unknown eta weight kind: {kind}")
    return torch.where(below, active, 0.0)


def self_paced_objective(pce: torch.Tensor, nce: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """mean(pce*v) + mean(nce*v) - sum(v); minimized wrt eta (through v)."""
    return (pce * v).mean() + (nce * v).mean() - v.sum()


def margin_mse(student: torch.Tensor, teachers: torch.Tensor) -> torch.Tensor:
    """Multi-teacher MarginMSE: student (2B,) and teachers (2B, T) in
    interleaved (pos, neg) order; mean over teachers of the MSE between the
    student margin and each teacher's."""
    s_margin = student[::2] - student[1::2]
    t_margin = teachers[::2, :] - teachers[1::2, :]
    per_teacher = ((s_margin[:, None] - t_margin) ** 2).mean(dim=0)
    return per_teacher.mean()
