"""One config -> one training run: the port of train/runner.py.

``RunConfig`` has the JAX package's fields and defaults, and ``run`` runs
them as the JAX runner does, for every curriculum: ``interp``, ``level``,
``eta`` and ``contrast`` (the pair loss, one negative an example: the pool
slot the difficulty names, or one binomial draw with online mining),
``lce`` (n sampled negatives) and the bilevel meta-weights ``meta-cheap``
and ``meta-std`` (their own loop over the weight table's rows). With
AdamW, ``grad_accum_steps`` optimizer steps accumulated by MultiSteps, on
static pools or with online negative mining from a dense index
(``mining="online"``: train/online.py, K6 over an int8 index with
``quantize_index``); dense attention with the fused self-attention kernels
(``flash_v3``), or chunked attention with the attention-core kernels
(``flash_kernel``) and either residual dtype; an fp32 or bf16
gradient-accumulation carry; ``remat`` with each of its policies,
``dropout`` and ``ffn_custom_vjp``. The fields of ``_UNPORTED`` raise
``NotImplementedError`` naming their ROADMAP item at any other value, and
the settings the meta loop does not read raise ``ValueError`` there
(``_META_UNREAD``): nothing is silently ignored. ``microbatch_unroll``
unrolls the JAX package's lax.scan and changes no result; the port's
microbatch loop is a Python loop, so both values run the same code.
``run`` takes an explicit device and never falls back from CUDA to the
CPU. ``load_run`` reloads a run directory written by ``run``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # data
    triples: str = "synthetic"  # path to triples JSON/JSONL, or "synthetic"
    docs: Optional[str] = None  # TSV id<TAB>text (None -> synthetic corpus)
    queries: Optional[str] = None
    pool_order: str = "easy_first"  # "hard_first" flips legacy files
    n_neg_pool: Optional[int] = None  # pool size cap (None = min length)
    synthetic_docs: int = 256
    synthetic_queries: int = 32
    synthetic_pairs: int = 128
    synthetic_pool: int = 32
    # tokenizer: "hash", a trained tokenizer .json, or an HF dir
    tokenizer: str = "hash"
    vocab_size: int = 8192
    max_q_tokens: int = 32
    max_d_tokens: int = 180
    # model: "tiny" | "small" | "base" | HF checkpoint dir
    model: str = "small"
    bf16: bool = True
    remat: bool = True
    remat_policy: str = "dots_nobatch"
    # lax.scan over layers: ~2x faster compile, ~9% slower steps (measured
    # t5-base on v5e) — use for iteration, not long runs
    scan_layers: bool = False
    # native (L, ...) stacked parameter layout (implies scan_layers): fast
    # compile WITHOUT the in-trace restacking tax — see models/t5.stack_params
    stacked_layers: bool = False
    # "chunked" = exact online-softmax attention (long-sequence memory)
    attention_impl: str = "dense"
    attention_chunk: int = 128
    # fused Mosaic attention forward+backward for eligible shapes
    # (chunked impl, 128-aligned lengths; see models/t5.T5Config)
    flash_kernel: bool = False
    # fused projection+attention+output-projection Mosaic kernel for
    # encoder self-attention (see models/t5.T5Config.flash_v3); pair with
    # fused_qkv so the QKV weight concat is hoisted once per step
    flash_v3: bool = False
    fused_qkv: bool = False
    # "bf16" halves the chunked-attention VJP residual's HBM staging
    # (see models/t5.T5Config.attn_residual_dtype)
    attn_residual_dtype: str = "fp32"
    # custom ReLU-FFN VJP saving only the post-ReLU hidden
    # (see models/t5.T5Config.ffn_custom_vjp)
    ffn_custom_vjp: bool = False
    dropout: bool = False
    # curriculum: interp | level | eta | contrast | lce | meta-cheap | meta-std
    curriculum: str = "lce"
    # shared hparams (reference defaults: train/*.py)
    total_steps: int = 100_000
    warmup_steps: Optional[int] = 10_000
    batch_size: int = 16
    lr: float = 1e-3
    meta_lr: Optional[float] = None
    grad_clip: Optional[float] = 1.0
    # lce (train_lce.py defaults)
    n: int = 2
    var: float = 0.01  # accepted for parity; a normalization no-op (see ops/sampling.py)
    use_mean: bool = False
    use_max: bool = False
    # packed prompt assembly: compact real tokens to the front of every
    # prompt (pads only at the tail) — the reference's contiguous positional
    # geometry (lceT5.py:40-53). REQUIRED when fine-tuning an imported
    # pretrained checkpoint; the segment layout (default) is static-shape-
    # native and self-consistent for from-scratch runs. Train and serve
    # must match (data/device_corpus.py).
    packed_assembly: bool = False
    # "per_example" | "flat_tokens" — the latter reproduces the reference's
    # verbatim nce.view(-1, n) token regrouping (lceT5.py:119), which mixes
    # tokens across negatives for 2-token labels (ops/losses.lce_ce_flat_tokens)
    label_grouping: str = "per_example"
    # eta (train/eta.py defaults)
    eta0: float = 0.5
    eta_min: float = 1e-10
    eta_max: float = 1.0
    # CE normalization for the eta feedback (curriculum/eta.py docstring):
    # None = auto — 1.0 for pretrained checkpoints (reference-exact scale),
    # log(vocab) x loss-aggregation width for random init so eta/difficulty
    # actually traverse (0,1) instead of saturating. Explicit float overrides.
    ce_scale: Optional[float] = None
    # x0.1 meta-LR at 1/4 and 1/2 of training (HF-fork parity,
    # utilities/trainer.py:528)
    meta_lr_milestone_decay: bool = False
    # level (train/level.py defaults)
    success_threshold: float = 0.5
    heuristic_step_check: int = 1000
    # interp (train/interpolate.py defaults)
    start_difficulty: float = 0.0
    max_difficulty: float = 1.0
    frac_interpolate: float = 0.1
    # contrast (train/meta.py -> MetaContrastWrapper defaults)
    rate_check: int = 1000
    # mining: "static" (precomputed pools) | "online" (dense index, north star)
    mining: str = "static"
    # >0: model-in-the-loop negative selection (train/scored_pool.py) —
    # every step cross-encoder-scores this many pool candidates per query
    # (no-grad) and curriculum-samples the n trained negatives from the
    # MODEL-judged order instead of the static retrieval order (the
    # reference's offline adhocRestructure, util.py:9-18, made online).
    # Requires curriculum family lce + static pools.
    scored_pool: int = 0
    # "compute" (bf16) | "int8" (W8A8 dynamic, models/quant.py — 2x MXU
    # peak for the scoring pass; rank fidelity tested)
    scored_pool_dtype: str = "compute"
    # rows per scored-pool scoring forward (chunked under lax.map so a big
    # B*C never outgrows HBM in one call; 1024 L=188 rows fits a 16GB v5e)
    scored_pool_chunk: int = 1024
    pool_size: int = 64
    refresh_every: int = 200
    encode_batch: int = 128
    quantize_index: bool = False  # int8 online-mining index
    grad_accum_steps: int = 1
    # >1: split each batch into k microbatches inside ONE optimizer step
    # (grad accumulation via lax.scan) — activation memory / k with zero
    # recompute; the TPU-native alternative to remat at long seq lengths
    microbatches: int = 1
    microbatch_unroll: bool = False
    # "bf16" halves the grad-accumulation carry's HBM traffic (see
    # train/step.py make_train_step); exact-default "fp32"
    grad_accum_dtype: str = "fp32"
    # loop
    out_dir: str = "runs/out"
    chunk_size: int = 16
    log_every_chunks: int = 1
    # "all" = one JSONL row per step (reference logs every step,
    # old/eta_bound.py:142-150); "mean" = per-chunk aggregates; "last"
    log_mode: str = "all"
    checkpoint_every_steps: int = 0
    # online mining: also snapshot the mined index beside each checkpoint
    # for bit-exact resume (costs index-size disk; train/online.py note)
    checkpoint_index: bool = False
    resume_from: Optional[str] = None
    seed: int = 42
    shuffle: bool = False
    wandb_project: Optional[str] = None
    export_hf: bool = False  # also write a transformers-loadable dir
    # held-out eval during training: MRR of the positive vs the hardest pool
    # negatives, logged as eval/mrr_hard every eval_every_steps
    eval_every_steps: int = 0
    eval_pairs: int = 64


# (field, value that runs here, ROADMAP item) for every field whose other
# values this slice does not port
_UNPORTED = (
    ("scored_pool", 0, "slice P (model-in-the-loop negative selection)"),
    ("scan_layers", False, "'Not carried over' (lax.scan over layers)"),
    ("stacked_layers", False, "'Not carried over' (lax.scan over layers)"),
    ("export_hf", False, "slice R (models/hf_export.py)"),
)


def _check_ported(cfg: RunConfig) -> None:
    """Raise NotImplementedError for any setting this slice does not run."""
    for name, ok, item in _UNPORTED:
        if getattr(cfg, name) != ok:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported to the PyTorch "
                f"package yet (ROADMAP.md {item}); this slice runs "
                f"{name}={ok!r}"
            )
    if cfg.model not in ("tiny", "small", "base"):
        raise NotImplementedError(
            f"model={cfg.model!r}: loading an HF checkpoint is not ported "
            "yet (ROADMAP.md slice R, models/hf_import.py); use tiny, small "
            "or base"
        )


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda': torch.cuda.is_available() is false; pass "
            "device='cpu' to run on the CPU (there is no silent fallback)"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


def _build_tokenizer(cfg: RunConfig):
    from pacednegatives_tpu_torch.data.tokenizer import (
        HashTokenizer,
        TrainedTokenizer,
        load_hf_tokenizer,
    )

    if cfg.tokenizer == "hash":
        return HashTokenizer(vocab_size=cfg.vocab_size)
    if cfg.tokenizer.endswith(".json"):
        return TrainedTokenizer.load(cfg.tokenizer)
    return load_hf_tokenizer(cfg.tokenizer)


def _build_model(cfg: RunConfig, tok, device: torch.device):
    from pacednegatives_tpu_torch.models.t5 import T5Config, init_params

    mk = {
        "tiny": lambda: T5Config.tiny(vocab_size=max(tok.vocab_size, 16)),
        "small": T5Config.small,
        "base": T5Config.base,
    }[cfg.model]
    mcfg = dataclasses.replace(
        mk(), vocab_size=max(tok.vocab_size, 16),
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
        remat=cfg.remat, remat_policy=cfg.remat_policy,
        attention_impl=cfg.attention_impl,
        attention_chunk=cfg.attention_chunk, flash_kernel=cfg.flash_kernel,
        flash_v3=cfg.flash_v3, fused_qkv=cfg.fused_qkv,
        attn_residual_dtype=cfg.attn_residual_dtype,
        ffn_custom_vjp=cfg.ffn_custom_vjp,
    )
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    return init_params(mcfg, gen, device), mcfg


def _build_corpus(cfg: RunConfig):
    """(TextCorpus, TripletStore) of the config: TSVs and a triples file,
    or the synthetic corpus."""
    from pacednegatives_tpu_torch.data import TextCorpus
    from pacednegatives_tpu_torch.data.triples import (
        TripletStore,
        load_triples,
    )

    if bool(cfg.docs) != bool(cfg.queries):
        raise ValueError(
            "--docs and --queries must be given together (got only one; "
            "refusing to silently fall back to the synthetic corpus)"
        )
    if cfg.docs and cfg.queries:
        corpus = TextCorpus.from_tsv(cfg.docs, cfg.queries)
    else:
        corpus = TextCorpus.synthetic(
            num_docs=cfg.synthetic_docs, num_queries=cfg.synthetic_queries,
            seed=cfg.seed,
        )
    if cfg.triples == "synthetic":
        triples = TripletStore.synthetic(
            corpus, n_pairs=cfg.synthetic_pairs, n_neg=cfg.synthetic_pool,
            seed=cfg.seed,
        )
    else:
        triples = TripletStore.from_records(
            load_triples(cfg.triples), corpus,
            n_neg=cfg.n_neg_pool, order=cfg.pool_order,
        )
    return corpus, triples


def _build_data(cfg: RunConfig, tok, device: torch.device):
    from pacednegatives_tpu_torch.data import TokenizedStore
    from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus

    corpus, triples = _build_corpus(cfg)
    store = TokenizedStore.build(
        corpus, tok, max_q_tokens=cfg.max_q_tokens,
        max_d_tokens=cfg.max_d_tokens,
    )
    return corpus, store, triples, DeviceCorpus.build(
        store, triples, device=device, use_max=cfg.use_max,
        packed=cfg.packed_assembly,
    )


def _opt_steps(cfg: RunConfig) -> tuple[int, int]:
    """total_steps / warmup_steps count EXAMPLES (the reference's unit);
    the optimizer schedule counts optimizer steps."""
    steps = max(cfg.total_steps // cfg.batch_size, 1)
    if cfg.warmup_steps is not None:
        warmup = max(cfg.warmup_steps // cfg.batch_size, 1)
    else:
        warmup = max(steps // 100, 1)
    return steps, warmup


def _resolve_ce_scale(cfg: RunConfig, vocab_size: int) -> float:
    """Auto ce_scale (None): 1.0 for pretrained checkpoints; for random
    init, the CE plateau of a uniform softmax, log(V), times the width of
    the loss the weights act on: (pce + nce) / 2 for the pair curricula
    (~log V), pce + mean/sum(nce over n) for LCE (~2 / ~(1+n) log V)."""
    if cfg.ce_scale is not None:
        return float(cfg.ce_scale)
    if cfg.model not in ("tiny", "small", "base"):
        return 1.0
    logv = float(np.log(max(vocab_size, 2)))
    if cfg.curriculum == "lce":
        return (2.0 if cfg.use_mean else 1.0 + cfg.n) * logv
    return logv


def _build_controller(cfg: RunConfig, triples, vocab_size: int = 0):
    from pacednegatives_tpu_torch.curriculum import (
        ContrastController,
        EtaController,
        InterpController,
        LevelController,
    )

    meta_lr = cfg.meta_lr if cfg.meta_lr is not None else cfg.lr
    opt_steps, warmup = _opt_steps(cfg)
    ce_scale = _resolve_ce_scale(cfg, vocab_size)
    milestones = (
        ((opt_steps // 4, 0.1), (opt_steps // 2, 0.1))
        if cfg.meta_lr_milestone_decay
        else ()
    )
    if cfg.curriculum == "interp":
        return InterpController(
            start=cfg.start_difficulty, end=cfg.max_difficulty,
            num_steps=int(cfg.frac_interpolate * cfg.total_steps),
            batch_size=cfg.batch_size,
        )
    if cfg.curriculum == "level":
        # the reference bumps by 1/n_neg with n_neg = len(pool) - 1
        # (dataloader.py:18, old/levels.py:77)
        return LevelController(
            n_neg=max(triples.n_neg - 1, 1), threshold=cfg.success_threshold,
            check_every=cfg.heuristic_step_check,
        )
    if cfg.curriculum == "eta":
        return EtaController(
            eta0=cfg.eta0, meta_lr=meta_lr,
            warmup_steps=warmup, total_steps=opt_steps,
            kind="eta", objective="self_paced",
            eta_min=cfg.eta_min, eta_max=cfg.eta_max,
            ce_scale=ce_scale, milestones=milestones,
        )
    if cfg.curriculum == "lce":
        return EtaController(
            eta0=cfg.eta0, meta_lr=meta_lr,
            warmup_steps=warmup, total_steps=opt_steps,
            kind="lce", objective="weighted_ce", optimizer="adamw",
            clamp=False, ce_scale=ce_scale, milestones=milestones,
        )
    if cfg.curriculum == "contrast":
        return ContrastController(
            eta0=cfg.eta0, meta_lr=meta_lr,
            warmup_steps=warmup, total_steps=opt_steps,
            eta_min=cfg.eta_min, eta_max=cfg.eta_max,
            n_neg=max(triples.n_neg - 1, 1), threshold=cfg.success_threshold,
            rate_check=cfg.rate_check,
            ce_scale=ce_scale, milestones=milestones,
        )
    raise ValueError(f"unknown curriculum {cfg.curriculum}")


def _meta_table(cfg: RunConfig, triples):
    from pacednegatives_tpu_torch.curriculum import MetaWeightTable

    return MetaWeightTable(
        num_batches=max(len(triples) // cfg.batch_size, 1),
        batch_size=cfg.batch_size,
    )


def _eval_selection(cfg: RunConfig, triples) -> np.ndarray:
    """Deterministic held-out pair rows (withheld from the training
    stream); capped so at least one full training batch remains."""
    rng = np.random.default_rng(12345)
    n = min(cfg.eval_pairs, len(triples) - cfg.batch_size)
    if n < 1:
        raise ValueError(
            f"cannot hold out eval pairs: {len(triples)} pairs leave no full "
            f"batch of {cfg.batch_size} after a holdout; add data or disable "
            "eval_every_steps"
        )
    return rng.choice(len(triples), size=n, replace=False)


def _make_eval_fn(cfg: RunConfig, store, triples, mcfg, tok, device):
    """Held-out probe: MRR of each held-out pair's positive against its 9
    hardest pool negatives, with prompts in the layout the model trains
    with."""
    from pacednegatives_tpu_torch.models.monot5 import score_batch

    sel = _eval_selection(cfg, triples)
    n_cand = min(10, triples.n_neg + 1)
    cand = np.stack([
        np.concatenate([[triples.pos_rows[i]], triples.pools[i][-(n_cand - 1):]])
        for i in sel
    ])  # (P, n_cand), positive in column 0
    q_rows = np.repeat(triples.query_rows[sel], n_cand)
    if cfg.packed_assembly:
        ids, mask = store.assemble_host_packed(q_rows, cand.reshape(-1))
    else:
        ids, mask = store.assemble_host(q_rows, cand.reshape(-1))
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    mask_t = torch.from_numpy(np.asarray(mask, np.int32)).to(device)

    def eval_fn(state):
        with torch.no_grad():
            s = score_batch(state.params, mcfg, ids_t, mask_t,
                            tok.true_id, tok.false_id)
        s = s.float().cpu().numpy().reshape(-1, n_cand)
        ranks = (s > s[:, :1]).sum(axis=1) + 1
        return {"mrr_hard": float(np.mean(1.0 / ranks))}

    return eval_fn


def load_run(run_dir: str, checkpoint: str = "final",
             device: torch.device | str = "cuda"):
    """Reload a run directory written by ``run`` (its ``config.json`` and
    ``torch.save`` checkpoint) -> (params, model_cfg, tokenizer,
    RunConfig), the weights on ``device`` (the card unless asked for the
    CPU), whichever device trained them. Strict: a checkpoint that does
    not fit the config raises."""
    from pacednegatives_tpu_torch.train.loop import restore_checkpoint
    from pacednegatives_tpu_torch.train.state import (
        init_train_state,
        make_optimizer,
    )

    device = _device(device)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = RunConfig(**json.load(f))
    tok = _build_tokenizer(cfg)
    params, mcfg = _build_model(cfg, tok, device)
    opt_steps, warmup = _opt_steps(cfg)
    tx = make_optimizer(cfg.lr, opt_steps, warmup, grad_clip=cfg.grad_clip,
                        grad_accum_steps=cfg.grad_accum_steps)
    _, triples = _build_corpus(cfg)
    if cfg.curriculum.startswith("meta"):
        curriculum = _meta_table(cfg, triples).init(device)
    else:
        curriculum = _build_controller(cfg, triples,
                                       tok.vocab_size).init(device)
    template = init_train_state(params, tx, curriculum, seed=cfg.seed)
    state = restore_checkpoint(os.path.join(run_dir, checkpoint), template,
                               generators=False)
    return state.params, mcfg, tok, cfg


def _maybe_resume(cfg: RunConfig, state):
    """resume_from: a checkpoint path, or "auto" for the newest one in
    out_dir (crash restart)."""
    from pacednegatives_tpu_torch.train.loop import (
        latest_checkpoint,
        restore_checkpoint,
    )

    path = cfg.resume_from
    if path == "auto":
        path = latest_checkpoint(cfg.out_dir)
    if path:
        return restore_checkpoint(path, state)
    return state


# (field, default) of the settings the JAX runner's meta branch never
# reads (train/runner.py:488-534): the port refuses any other value there
_META_UNREAD = (
    ("mining", "static"),
    ("microbatches", 1),
    ("dropout", False),
    ("grad_accum_dtype", "fp32"),
    ("eval_every_steps", 0),
    ("checkpoint_every_steps", 0),
    ("shuffle", False),
    ("log_every_chunks", 1),
)


def _check_meta(cfg: RunConfig) -> str:
    """The meta variant ("cheap" or "std"); ValueError for a setting the
    meta loop would not read."""
    variant = cfg.curriculum.partition("-")[2]
    if variant not in ("cheap", "std"):
        raise ValueError(f"unknown curriculum {cfg.curriculum}")
    for name, default in _META_UNREAD:
        if getattr(cfg, name) != default:
            raise ValueError(
                f"{name}={getattr(cfg, name)!r} with curriculum="
                f"{cfg.curriculum!r}: the meta loop does not read it (the "
                f"JAX runner ignores it there); use {name}={default!r}"
            )
    return variant


def _run_meta(cfg: RunConfig, variant: str, tok, triples, dc, mcfg, params,
              tx, writer, steps: int, warmup: int, device: torch.device):
    """The meta-weight loop (train/runner.py:488-534): batch j's pairs are
    rows (j * B + arange(B)) % num_pairs, each drawn at its own table
    weight; one metrics row a chunk with the chunk's last values, then
    {"step", "time"}."""
    from pacednegatives_tpu_torch.curriculum import linear_warmup_decay
    from pacednegatives_tpu_torch.train.state import init_train_state
    from pacednegatives_tpu_torch.train.step import make_meta_train_step

    meta_lr = cfg.meta_lr if cfg.meta_lr is not None else cfg.lr
    table = _meta_table(cfg, triples)
    step = make_meta_train_step(
        mcfg, table, tx, linear_warmup_decay(meta_lr, warmup, steps),
        variant=variant, rel_id=tok.true_id, nrel_id=tok.false_id,
    )
    state = init_train_state(params, tx, table.init(device), seed=cfg.seed)
    state = _maybe_resume(cfg, state)
    offsets = torch.arange(cfg.batch_size, device=device)
    t0 = time.time()
    done = int(state.step)
    while done < steps:
        k = min(cfg.chunk_size, steps - done)
        for t in range(k):
            j = (done + t) % table.num_batches
            pair_idx = (j * cfg.batch_size + offsets) % dc.num_pairs
            batch = dc.pair_batch(pair_idx, table.lookup(state.curriculum, j))
            state, metrics = step(state, batch, j)
        done += k
        writer.write({"step": done, **metrics})
        writer.flush()
    writer.write({"step": steps, "time": time.time() - t0})
    return state


def run(cfg: RunConfig, device: torch.device | str = "cuda") -> dict:
    """Execute a training run on ``device``; returns the summary dict
    {"steps", "final_loss", "out_dir"}."""
    from pacednegatives_tpu_torch.train.loop import (
        MetricWriter,
        save_checkpoint,
    )
    from pacednegatives_tpu_torch.train.state import make_optimizer

    if cfg.scored_pool > 0 and cfg.mining == "online":
        raise ValueError(
            "scored_pool only applies to static pools (mining='static'); "
            "online mining already builds fresh per-step pools"
        )
    if cfg.scored_pool_dtype not in ("compute", "int8", "int8_bf16"):
        raise ValueError(
            f"scored_pool_dtype must be 'compute', 'int8' or 'int8_bf16', "
            f"got {cfg.scored_pool_dtype!r}"
        )
    _check_ported(cfg)
    meta = cfg.curriculum.startswith("meta")
    variant = _check_meta(cfg) if meta else None
    device = _device(device)

    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)

    tok = _build_tokenizer(cfg)
    _, store, triples, dc = _build_data(cfg, tok, device)
    params, mcfg = _build_model(cfg, tok, device)
    opt_steps, warmup_opt = _opt_steps(cfg)
    tx = make_optimizer(
        cfg.lr, opt_steps, warmup_opt,
        grad_clip=cfg.grad_clip, grad_accum_steps=cfg.grad_accum_steps,
    )
    writer = MetricWriter(
        os.path.join(cfg.out_dir, "metrics.jsonl"),
        wandb_project=cfg.wandb_project,
        wandb_config=dataclasses.asdict(cfg),
    )
    if meta:
        state = _run_meta(cfg, variant, tok, triples, dc, mcfg, params, tx,
                          writer, opt_steps, warmup_opt, device)
    else:
        state = _run_paced(cfg, tok, store, triples, dc, mcfg, params, tx,
                           writer, opt_steps, device)
    save_checkpoint(os.path.join(cfg.out_dir, "final"), state)
    writer.close()
    last = [h for h in writer.history if "loss" in h]
    return {
        "steps": int(state.step),
        "final_loss": float(last[-1]["loss"]) if last else None,
        "out_dir": cfg.out_dir,
    }


def _run_paced(cfg: RunConfig, tok, store, triples, dc, mcfg, params, tx,
               writer, steps: int, device: torch.device):
    """Every curriculum but meta: the controller, the pair (or LCE) step
    and the training loop, on static pools or with online mining."""
    from pacednegatives_tpu_torch.train.loop import TrainLoop
    from pacednegatives_tpu_torch.train.state import init_train_state
    from pacednegatives_tpu_torch.train.step import (
        make_fused_step,
        make_train_step,
    )

    controller = _build_controller(cfg, triples, tok.vocab_size)
    if hasattr(controller, "ce_scale"):
        # the resolved normalization, so that curves are interpretable
        writer.write({"step": 0, "ce_scale": float(controller.ce_scale)})
    loss_kind = "lce" if cfg.curriculum == "lce" else "pair"
    n = cfg.n if loss_kind == "lce" else 1
    step = make_train_step(
        mcfg, controller, tx, loss=loss_kind, n_neg_per_example=n,
        use_mean=cfg.use_mean, rel_id=tok.true_id, nrel_id=tok.false_id,
        label_grouping=cfg.label_grouping, dropout=cfg.dropout,
        microbatches=cfg.microbatches,
        grad_accum_dtype=cfg.grad_accum_dtype,
    )
    state = init_train_state(params, tx, controller.init(device),
                             seed=cfg.seed)
    state = _maybe_resume(cfg, state)
    held_out = cfg.eval_every_steps > 0
    common = dict(
        corpus=dc,
        num_pairs=len(triples),
        batch_size=cfg.batch_size,
        chunk_size=cfg.chunk_size,
        seed=cfg.seed,
        log_mode=cfg.log_mode,
        checkpoint_dir=cfg.out_dir,
        checkpoint_every_steps=cfg.checkpoint_every_steps,
        eval_fn=(_make_eval_fn(cfg, store, triples, mcfg, tok, device)
                 if held_out else None),
        eval_every_steps=cfg.eval_every_steps,
        exclude_pairs=(tuple(_eval_selection(cfg, triples))
                       if held_out else ()),
    )
    if cfg.mining == "online":
        from pacednegatives_tpu_torch.train.online import (
            OnlineMiningConfig,
            OnlineMiningLoop,
            make_online_fused_step,
            make_refresh_fn,
        )

        mining = OnlineMiningConfig(pool_size=cfg.pool_size,
                                    encode_batch=cfg.encode_batch,
                                    quantize=cfg.quantize_index)
        loop = OnlineMiningLoop(
            fused_step=make_online_fused_step(dc, step, controller, mcfg,
                                              mining, n_neg_per_example=n),
            refresh_fn=make_refresh_fn(dc, mcfg, mining),
            refresh_every=cfg.refresh_every,
            checkpoint_index=cfg.checkpoint_index,
            **common,
        )
    elif cfg.mining == "static":
        if cfg.scored_pool > 0 and loss_kind != "lce":
            raise ValueError(
                "scored_pool requires an lce-family curriculum "
                f"(n sampled negatives); got {cfg.curriculum!r}"
            )
        loop = TrainLoop(
            fused_step=make_fused_step(dc, step, controller, loss=loss_kind,
                                       n_neg_per_example=n),
            shuffle=cfg.shuffle,
            log_every_chunks=cfg.log_every_chunks,
            **common,
        )
    else:
        raise ValueError(f"mining must be 'static' or 'online', "
                         f"got {cfg.mining!r}")
    return loop.run(state, steps, writer)
