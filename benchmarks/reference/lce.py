"""The plain reference of the first training steps of an LCE run, from the
benchmark's inputs: the pair stream, the curriculum's choice of negatives
(or, with model-scored pools, the reference's scores of the candidates and
the choice drawn from the program's order of them), the prompts, the
forward, the LCE loss, its gradient and AdamW.

The model is the architecture's plain reference (its hook's
``reference``), used only through ``score`` and ``loss``. The step's
gradient is summed over blocks of examples, so that float32 activations
of a whole batch never live at once.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference.curriculum import (
    EtaCurriculum,
    draw_positions,
    linear_warmup_decay,
)


def prompts(tokens: dict, corpus: dict, q_rows: torch.Tensor,
            d_rows: torch.Tensor, packed: bool):
    """(B, L) ids and mask of "Query: q Document: d Relevant:" prompts:
    the fixed segments [prefix | query | mid | document | suffix + eos]
    with each segment's pads in place, or (``packed``) the real tokens
    moved to the front in order."""
    dev = q_rows.device
    B = q_rows.shape[0]
    seg = lambda key: torch.tensor(tokens[key], device=dev).expand(B, -1)
    ids = torch.cat([seg("prefix"), corpus["q_tokens"][q_rows].long(),
                     seg("mid"), corpus["d_tokens"][d_rows].long(),
                     seg("suffix")], dim=1)
    mask = (ids != tokens["pad"]).long()
    if packed:
        order = torch.argsort(1 - mask, dim=1, stable=True)
        ids, mask = ids.gather(1, order), mask.gather(1, order)
    return ids, mask


def pair_batches(num_pairs: int, batch: int, seed: int, steps: int):
    """The first ``steps`` batches of the epoch-shuffled pair stream: one
    permutation of the pairs by numpy's default generator of ``seed``, cut
    into consecutive batches."""
    order = np.random.default_rng(seed).permutation(np.arange(num_pairs))
    return [order[i * batch:(i + 1) * batch] for i in range(steps)]


def balanced_slots(pool: int, c: int) -> np.ndarray:
    """C evenly spaced pool positions (rounded, duplicates dropped)."""
    return np.unique(np.round(np.linspace(0, pool - 1, c)).astype(np.int64))


def score_rows(model, ids, mask, tokens, block: int) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([
            model.score(ids[i:i + block], mask[i:i + block], tokens["true"],
                        tokens["false"])
            for i in range(0, ids.shape[0], block)])


def run_steps(reference, weights: dict, tokens: dict, corpus: dict,
              plan: dict, program_scores=None, precision: str = "fp32"):
    """Run ``plan["steps"]`` LCE steps of the reference.

    ``reference(weights, precision)``: the architecture's plain model over
    flat {path: tensor} weights.
    ``plan``: batch, n, pool, num_pairs, pair_seed, sampling_seed, lr,
    warmup, total, clip, eta0, ce_scale, packed, block_examples, steps;
    with model-scored pools also candidates and score_block.
    ``program_scores``: the program's (B * C,) candidate scores of each
    step, whose order the negatives are drawn from (the reference judges
    it by its own scores); None draws from the reference's own order.

    Returns {"loss": [...], "grad_norms": {leaf: norm of the clipped first
    gradient}, "change_norms": {leaf: norm of the change over the steps},
    "negatives": [(B * n, L) ids], and with scored pools "scores" (its
    own, each step's (B * C,)), "score_gap" and
    "order_gap", each in units of the query's standard deviation of
    reference scores over its candidates}."""
    dev = corpus["q_tokens"].device
    B, n, P = plan["batch"], plan["n"], plan["pool"]
    params = {k: w.detach().clone() for k, w in weights.items()}
    start = {k: w.detach().clone() for k, w in weights.items()}
    opt = AdamW(lambda c: linear_warmup_decay(plan["lr"], plan["warmup"],
                                              plan["total"], c),
                clip=plan["clip"])
    eta = EtaCurriculum(plan["eta0"], plan["lr"], plan["warmup"],
                        plan["total"], plan["ce_scale"], dev)
    gen = torch.Generator(device=dev).manual_seed(plan["sampling_seed"])
    batches = pair_batches(plan["num_pairs"], B, plan["pair_seed"],
                           plan["steps"])
    out = {"loss": [], "negatives": []}
    score_gap = order_gap = 0.0
    slots = None
    if plan.get("candidates"):
        slots = torch.from_numpy(balanced_slots(P, plan["candidates"])).to(dev)
    packed = plan["packed"]
    verbalizer = lambda rows, tok: torch.full((rows,), tok, device=dev)
    for t, pairs in enumerate(batches):
        pairs = torch.from_numpy(pairs).to(dev)
        q = corpus["query_rows"][pairs]
        pos_d = corpus["pos_rows"][pairs]
        pool = corpus["pools"][pairs]
        mean = eta.difficulty().expand(B)
        model = reference(params, precision)
        if slots is None:
            neg_d = pool.gather(1, draw_positions(gen, P, mean, n))
        else:
            C = slots.shape[0]
            cand = pool[:, slots]
            ids, mask = prompts(tokens, corpus, q.repeat_interleave(C),
                                cand.reshape(-1), packed)
            ref = score_rows(model, ids, mask, tokens,
                             plan["score_block"]).view(B, C)
            out.setdefault("scores", []).append(ref.reshape(-1))
            prog = (ref if program_scores is None
                    else program_scores[t].to(dev).float().view(B, C))
            # gaps in units of each query's spread of reference scores
            sigma = ref.std(dim=1, keepdim=True)
            score_gap = max(score_gap,
                            float(((prog - ref).abs() / sigma).max()))
            order = torch.argsort(prog, dim=1, stable=True)
            sel = draw_positions(gen, C, mean, n)
            picked = order.gather(1, sel)
            best = torch.sort(ref, dim=1).values.gather(1, sel)
            order_gap = max(order_gap, float(
                ((best - ref.gather(1, picked)).abs() / sigma).max()))
            neg_d = cand.gather(1, picked)
        pos_ids, pos_mask = prompts(tokens, corpus, q, pos_d, packed)
        neg_ids, neg_mask = prompts(tokens, corpus, q.repeat_interleave(n),
                                    neg_d.reshape(-1), packed)
        out["negatives"].append(neg_ids)
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        model = reference(leaves, precision)
        per_example = []
        e = plan["block_examples"]
        for i in range(0, B, e):
            j = min(i + e, B)
            with torch.enable_grad():
                ce = model.loss(
                    torch.cat([pos_ids[i:j], neg_ids[i * n:j * n]]),
                    torch.cat([pos_mask[i:j], neg_mask[i * n:j * n]]),
                    torch.cat([verbalizer(j - i, tokens["true"]),
                               verbalizer((j - i) * n, tokens["false"])]))
                ex = lce_example_loss(ce[:j - i], ce[j - i:], n)
                (ex.sum() / B).backward()
            per_example.append(ex.detach())
        per_example = torch.cat(per_example)
        out["loss"].append(float(per_example.double().mean()))
        grads = {k: p.grad for k, p in leaves.items()}
        if t == 0:
            clipped = opt.clip_grads(grads)
            out["grad_norms"] = {k: float(g.norm()) for k, g in
                                 clipped.items()}
        eta.update(per_example)
        with torch.no_grad():
            params = opt.step({k: p.detach() for k, p in leaves.items()},
                              grads)
        del leaves, grads
    with torch.no_grad():
        out["change_norms"] = {k: float((params[k] - start[k]).norm())
                               for k in params}
    if slots is not None:
        out["score_gap"] = score_gap
        out["order_gap"] = order_gap
    return out


def leaf_gap(program: dict, reference: dict, counted) -> tuple:
    """The worst leaf's gap between two per-leaf norms, over the larger of
    the reference leaf's norm and the median counted leaf's: (gap, leaf)."""
    med = float(np.median([reference[k] for k in counted]))
    worst, at = 0.0, None
    for k in counted:
        gap = abs(program[k] - reference[k]) / max(reference[k], med)
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def counted_leaves(grad_norms: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is not nought to rounding: its norm
    at least ``share`` of the median leaf's."""
    med = float(np.median(list(grad_norms.values())))
    return sorted(k for k, v in grad_norms.items() if v >= share * med)


def lce_example_loss(pce: torch.Tensor, nce: torch.Tensor,
                     n: int) -> torch.Tensor:
    """LCE per example: its positive's CE plus the sum of its n
    negatives' (``nce`` example-major)."""
    return pce + nce.view(-1, n).sum(dim=1)


class AdamW:
    """Global-norm clipping (scaled by clip / norm when the norm reaches
    clip), then AdamW (decoupled weight decay) with bias correction, the
    learning rate read at the count before the update."""

    def __init__(self, lr_at, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
                 clip=1.0):
        self.lr_at, self.b1, self.b2, self.eps = lr_at, b1, b2, eps
        self.wd, self.clip = weight_decay, clip
        self.count = 0
        self.mu: dict = {}
        self.nu: dict = {}

    def clip_grads(self, grads: dict) -> dict:
        if self.clip is None:
            return grads
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values())).float()
        scale = 1.0 if norm < self.clip else self.clip / norm
        return {k: g * scale for k, g in grads.items()}

    def step(self, params: dict, grads: dict) -> dict:
        grads = self.clip_grads(grads)
        lr = self.lr_at(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu.get(k, 0.0) + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu.get(k, 0.0) + (1 - self.b2) * g * g
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            out[k] = p - lr * (upd + self.wd * p)
        return out
