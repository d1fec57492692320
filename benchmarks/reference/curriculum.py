"""Plain reference of the LCE curriculum's choice of negatives.

The difficulty is a learnable threshold eta (LCE's weighted-CE objective:
eta minimises mean(v * ce / s) with v = (ce / s) / eta where ce / s <=
eta, else 0; ``s`` the CE scale), moved by AdamW (eps 1e-6, no weight
decay) on a linear warmup-decay schedule, and capped at 1 - 1e-6 when
read. Each example draws n distinct pool positions from Binomial(P - 1,
difficulty) by the Gumbel-top-k trick, the Gumbel noise -log(E) with E ~
Exp(1) from the sampling generator, one (B, P) draw a step. All of it
in float32.
"""

from __future__ import annotations

import torch


def linear_warmup_decay(peak: float, warmup: int, total: int, step: int):
    """The HF linear schedule: 0 -> peak over ``warmup`` steps, then down
    to 0 at ``total``."""
    warmup = max(warmup, 1)
    if step < warmup:
        return peak * step / warmup
    return peak * max(0.0, (total - step) / max(total - warmup, 1))


class EtaCurriculum:
    def __init__(self, eta0: float, meta_lr: float, warmup: int, total: int,
                 ce_scale: float, device):
        self.eta = torch.tensor(eta0, dtype=torch.float32, device=device)
        self.lr_at = lambda c: linear_warmup_decay(meta_lr, warmup, total, c)
        self.scale = ce_scale
        self.count = 0
        self.mu = 0.0
        self.nu = 0.0

    def difficulty(self) -> torch.Tensor:
        return self.eta.clamp(0.0, 1.0 - 1e-6)

    def update(self, ce: torch.Tensor) -> None:
        """One AdamW step of eta on the step's (B,) per-example CE."""
        x = ce.float() / self.scale
        below = x <= self.eta
        grad = torch.where(below, -x * x / (self.eta * self.eta),
                           torch.zeros_like(x)).mean()
        lr = self.lr_at(self.count)
        self.count += 1
        self.mu = 0.9 * self.mu + 0.1 * grad
        self.nu = 0.999 * self.nu + 0.001 * grad * grad
        upd = (self.mu / (1 - 0.9 ** self.count)) / (
            torch.sqrt(self.nu / (1 - 0.999 ** self.count)) + 1e-6)
        self.eta = self.eta - lr * upd


def binomial_log_probs(P: int, mean: torch.Tensor) -> torch.Tensor:
    """(B, P) normalised log Binomial(k; P - 1, mean) at k = 0..P-1, in
    float32."""
    p = mean.float().clamp(1e-6, 1 - 1e-6)[:, None]
    k = torch.arange(P, dtype=torch.float32, device=mean.device)[None, :]
    n = torch.tensor(float(P - 1), device=mean.device)
    logpmf = (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
              - torch.lgamma(n - k + 1.0) + torch.xlogy(k, p)
              + torch.special.xlog1py(n - k, -p))
    return torch.log_softmax(logpmf, dim=-1)


def draw_positions(gen: torch.Generator, P: int, mean: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(B, n) distinct positions of pools of P, the paced binomial's
    Gumbel-top-k draw."""
    B = mean.shape[0]
    e = torch.empty((B, P), dtype=torch.float32, device=mean.device)
    gumbel = -e.exponential_(generator=gen).log()
    return torch.topk(binomial_log_probs(P, mean) + gumbel, n,
                      dim=-1).indices
