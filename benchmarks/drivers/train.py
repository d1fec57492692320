"""Training driver: LCE with paced negatives through the port's
``make_train_step`` / ``make_fused_step`` (or ``make_scored_pool_step``)
and ``TrainLoop``, on static pools over a synthetic corpus on the card.

Set-up draws the corpus and the weights from the seed, builds the loop,
and drives it through the first ``checked_steps`` steps with the window's
own call (``TrainLoop.run``), keeping what the check compares: each step's
loss, the first gradient as the optimizer holds it (its first moment over
1 - b1), the parameters' change over the checked steps, and each step's
negative prompts (and, with scored pools, the candidates' scores). The
window then runs whole chunks of ``chunk_size`` steps, one metric read a
chunk, until the first chunk boundary past ``--seconds``; the rate (named
by the mix's ``rate_metric``) is every trained negative of those steps
over the time from the window's start to the final synchronise. After
the window the program's state is freed and the plain reference runs the
checked steps on the same inputs.
"""

from __future__ import annotations

import functools
import math
import sys
import time

import torch

from benchmarks.common import data, tracing
from benchmarks.common.cell import Cell, Outcome
from benchmarks.common.inputs import make_corpus
from benchmarks.common.weights import flatten, nest
from benchmarks.reference import lce as ref


def plan_of(cell: Cell) -> dict:
    tr = cell.traffic
    B, n = tr["batch_queries"], tr["n"]
    steps = max(tr["total_examples"] // B, 1)
    scored = tr.get("scored") or {}
    return {
        "batch": B, "n": n, "pool": tr["pool"], "num_pairs": tr["queries"],
        "pair_seed": data.stream_seed(cell.seed, "pairs"),
        "sampling_seed": data.stream_seed(cell.seed, "sampling"),
        "lr": tr["lr"], "warmup": max(tr["warmup_examples"] // B, 1),
        "total": steps, "clip": tr["grad_clip"], "eta0": tr["eta0"],
        # the random-init CE scale of an LCE run: (1 + n) log V
        "ce_scale": (1 + n) * math.log(cell.config["vocab_size"]),
        "packed": tr["packed"], "steps": tr["checked_steps"],
        "block_examples": tr["reference_block_examples"],
        "candidates": scored.get("candidates"),
        "score_block": scored.get("chunk_rows", 256),
    }


class _Program:
    """The port's objects for one cell, and what set-up records of them."""

    def __init__(self, cell: Cell, corpus: dict, counters):
        from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
        from pacednegatives_tpu_torch.train import scored_pool
        from pacednegatives_tpu_torch.train.loop import MetricWriter, TrainLoop
        from pacednegatives_tpu_torch.train.runner import (
            RunConfig,
            _build_controller,
        )
        from pacednegatives_tpu_torch.train.state import (
            init_train_state,
            make_optimizer,
        )
        from pacednegatives_tpu_torch.train.step import (
            make_fused_step,
            make_train_step,
        )

        tr, tok, plan = cell.traffic, cell.config["tokens"], plan_of(cell)
        if tr["curriculum"] != "lce":
            raise ValueError("the reference follows the lce curriculum only")
        self.plan = plan
        dev = cell.device
        t = lambda ids: torch.tensor(ids, dtype=torch.int64, device=dev)
        self.corpus = DeviceCorpus(
            q_tokens=corpus["q_tokens"], q_mask=None,
            d_tokens=corpus["d_tokens"], d_mask=None,
            query_rows=corpus["query_rows"], pos_rows=corpus["pos_rows"],
            pools=corpus["pools"], prefix=t(tok["prefix"]), mid=t(tok["mid"]),
            suffix=t(tok["suffix"]), pad_id=tok["pad"], true_id=tok["true"],
            false_id=tok["false"], eos_id=tok["eos"], packed=tr["packed"])
        mcfg = cell.arch.port_config(cell.config, tr["remat"])
        run_cfg = RunConfig(
            curriculum=tr["curriculum"], batch_size=plan["batch"], n=plan["n"],
            lr=plan["lr"], warmup_steps=tr["warmup_examples"],
            total_steps=tr["total_examples"], grad_clip=plan["clip"],
            eta0=plan["eta0"], ce_scale=plan["ce_scale"], use_mean=False,
            remat=tr["remat"], microbatches=tr["microbatches"],
            vocab_size=cell.config["vocab_size"], chunk_size=tr["chunk_size"])
        controller = _build_controller(run_cfg, None, run_cfg.vocab_size)
        tx = make_optimizer(plan["lr"], plan["total"], plan["warmup"],
                            grad_clip=plan["clip"])
        step = make_train_step(
            mcfg, controller, tx, loss="lce", n_neg_per_example=plan["n"],
            use_mean=False, rel_id=tok["true"], nrel_id=tok["false"],
            microbatches=tr["microbatches"])
        self.batches: list = []
        self.scores: list = []
        self.undo = lambda: None
        self.record = True
        fault = cell.fault

        def recorded_step(state, batch):
            if fault == "half_batch":
                h = batch["pos_ids"].shape[0] // 2
                rows = {"pos": h, "neg": h * plan["n"]}
                batch = {k: v[:rows[k[:3]]] if k[:3] in rows else v
                         for k, v in batch.items()}
            if self.record:
                self.batches.append(batch["neg_ids"])
            if counters.active:
                # trained rows: 3x the forward's FLOPs, on real tokens
                for side in ("pos", "neg"):
                    lens = batch[f"{side}_mask"].sum(dim=1).double()
                    counters.add("train_rows", lens.shape[0])
                    counters.add_device("train_len", lens.sum())
                    counters.add_device("train_len_sq", lens.square().sum())
            new, metrics = step(state, batch)
            if fault == "unchanged":
                return state, metrics
            return new, metrics

        scored = tr.get("scored")
        if scored:
            orig = scored_pool.score_candidates

            def score_candidates(score_fn, ids, mask, **kw):
                with tracing.span("bench.score_candidates", counters):
                    raw = orig(score_fn, ids, mask, **kw)
                if self.record:
                    self.scores.append(raw)
                if counters.active:
                    lens = mask.sum(dim=1).double()
                    counters.add("score_rows", lens.shape[0])
                    counters.add_device("score_len", lens.sum())
                    counters.add_device("score_len_sq", lens.square().sum())
                return raw

            scored_pool.score_candidates = score_candidates
            self.undo = lambda: setattr(scored_pool, "score_candidates", orig)
            fused = scored_pool.make_scored_pool_step(
                self.corpus, recorded_step, controller, mcfg,
                n_neg_per_example=plan["n"], candidates=scored["candidates"],
                rel_id=tok["true"], nrel_id=tok["false"],
                score_dtype=scored["dtype"],
                score_chunk_rows=scored["chunk_rows"],
                score_buckets=tuple(scored["buckets"]))
        else:
            fused = make_fused_step(self.corpus, recorded_step, controller,
                                    loss="lce", n_neg_per_example=plan["n"])
        params = nest(cell.arch.weights(cell.config, cell.seed, dev))
        self.state = init_train_state(params, tx, controller.init(dev),
                                      seed=plan["sampling_seed"])
        self.loop = TrainLoop(
            fused_step=fused, num_pairs=plan["num_pairs"],
            batch_size=plan["batch"], chunk_size=tr["chunk_size"],
            seed=plan["pair_seed"], shuffle=True, log_mode="all",
            corpus=self.corpus)
        self.writer = MetricWriter(None)

    def run(self, steps: int) -> None:
        self.state = self.loop.run(self.state, int(self.state.step) + steps,
                                   self.writer)

    def losses(self) -> list:
        return [h["loss"] for h in self.writer.history if "loss" in h]


def _norms(flat: dict) -> dict:
    keys = list(flat)
    vals = torch.stack(torch._foreach_norm([flat[k].float() for k in keys]))
    return dict(zip(keys, vals.double().cpu().tolist()))


def run(cell: Cell) -> Outcome:
    tr = cell.traffic
    dev = cell.device
    counters = tracing.Counters()
    undo = tracing.wrap_attention(counters) if cell.trace else None
    phases = tracing.Phases(cell.t_start, dev)
    phases.mark("imports")
    corpus = make_corpus(cell.config, tr, cell.seed, dev)
    phases.mark("inputs")
    prog = _Program(cell, corpus, counters)
    phases.mark("weights and loop")
    plan = prog.plan
    B, n = plan["batch"], plan["n"]

    # the checked steps, through the window's own call
    prog.run(1)
    g1 = {k: v / 0.1 for k, v in
          _norms(flatten(prog.state.opt_state.mu)).items()}
    prog.run(plan["steps"] - 1)
    start = cell.arch.weights(cell.config, cell.seed, dev)
    now = flatten(prog.state.params)
    change = _norms({k: now[k] - start[k] for k in start})
    del start, now
    phases.mark("checked steps")
    checked_losses = prog.losses()[:plan["steps"]]
    negatives = [t.cpu() for t in prog.batches]
    scores = [t.float().cpu() for t in prog.scores]
    prog.record = False
    prog.batches.clear()
    prog.scores.clear()

    chunk = tr["chunk_size"]
    trace = None
    if cell.trace:
        trace = tracing.profile(
            warm=lambda: prog.run(chunk),
            active=lambda: prog.run(chunk * tr["trace_chunks"]),
            counters=counters, out_dir=cell.out_dir,
            device=dev)
        setup_s = float("nan")
        steps = chunk * tr["trace_chunks"]
        end_to_end = {}
        first = len(prog.losses()) - steps
    else:
        tracing.sync(dev)
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        first = len(prog.losses())
        while True:
            prog.run(chunk)
            if time.perf_counter() - t0 >= cell.seconds:
                break
        tracing.sync(dev)
        elapsed = time.perf_counter() - t0
        steps = len(prog.losses()) - first
        end_to_end = {tr["rate_metric"]: steps * B * n / elapsed}
    window_losses = prog.losses()[first:]
    failed = int(sum(not math.isfinite(x) for x in window_losses))
    peak = tracing.peak_bytes(dev)
    if undo:
        undo()
    counters.resolve()

    # the program's state goes before the reference runs
    prog.undo()
    del prog
    tracing.free(cell.device)
    phases.mark("window")
    checks = check(cell, corpus, checked_losses, g1, change, negatives,
                   scores)
    phases.mark("check")
    return Outcome(attempted=steps, failed=failed, end_to_end=end_to_end,
                   setup_s=setup_s, memory_peak_bytes=peak, checks=checks,
                   trace=trace, counters=counters,
                   extra={"phases": phases.seconds})


def reference(cell: Cell):
    """(weights, precision) -> the architecture's plain model."""
    return functools.partial(cell.arch.reference, cell.config)


def control(cell: Cell) -> dict:
    """The check's numbers with the reference computed in float8 (e4m3
    operands) put in the program's place: the control that one of the
    limits has to catch."""
    corpus = make_corpus(cell.config, cell.traffic, cell.seed, cell.device)
    weights = cell.arch.weights(cell.config, cell.seed, cell.device)
    r = ref.run_steps(reference(cell), weights, cell.config["tokens"],
                      corpus, plan_of(cell), precision="fp8",
                      program_scores=None)
    del weights
    tracing.free(cell.device)
    return check(cell, corpus, r["loss"], r["grad_norms"],
                 r["change_norms"], r["negatives"], r.get("scores", []))


def check(cell: Cell, corpus: dict, losses, g1, change, negatives,
          scores) -> dict:
    """The check's numbers (the limits file names those compared): the
    worst step's loss gap (relative), the worst counted leaf's gap of the
    first gradient's norm and of the change's norm, the negatives'
    prompts that differ from the reference's choice, and with scored
    pools the widest score gap and order gap."""
    plan = plan_of(cell)
    weights = cell.arch.weights(cell.config, cell.seed, cell.device)
    r = ref.run_steps(reference(cell), weights, cell.config["tokens"],
                      corpus, plan, program_scores=scores or None)
    counted = ref.counted_leaves(r["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r["loss"]))
    grad_gap, grad_leaf = ref.leaf_gap(g1, r["grad_norms"], counted)
    change_gap, change_leaf = ref.leaf_gap(change, r["change_norms"], counted)
    print(f"worst leaf: grad {grad_leaf}, change {change_leaf}",
          file=sys.stderr)
    differ = sum(int((a.to(b.device) != b).any(dim=1).sum())
                 if a.shape == b.shape else b.shape[0]
                 for a, b in zip(negatives, r["negatives"]))
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap,
           "change_gap": change_gap, "negatives_differ": float(differ),
           "leaves_counted": float(len(counted)),
           "leaves": float(len(r["grad_norms"]))}
    if "score_gap" in r:
        out["score_gap"] = r["score_gap"]
        out["order_gap"] = r["order_gap"]
    return out
