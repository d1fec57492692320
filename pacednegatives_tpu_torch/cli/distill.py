"""MarginMSE / CE distillation CLI (reference distill/train_t5.py and
train_baseline.py parity): the port of cli/distill.py.

Usage:
  python -m pacednegatives_tpu_torch.cli.distill --docs docs.tsv \\
      --queries q.tsv --triples triples.tsv --teacher teacher.json \\
      --out_dir runs/distill --objective margin_mse --total_steps 100000 \\
      --batch_size 16

The flags are the JAX CLI's, plus ``--device`` (default cuda; there is no
fallback to the CPU). The model config is forced as there: bf16, remat with
``remat_policy="dots"``, dense attention.
"""

from __future__ import annotations

import json
import os
import time

import torch

from pacednegatives_tpu_torch.utils.config import parse_cli


def main(argv=None) -> dict:
    args = parse_cli(argv)
    out_dir = args.get("out_dir", "runs/distill")
    objective = args.get("objective", "margin_mse")
    total_steps = int(args.get("total_steps", 100_000))
    batch_size = int(args.get("batch_size", 16))
    lr = float(args.get("lr", 5e-5))
    model = args.get("model", "small")
    vocab = int(args.get("vocab_size", 8192))

    from pacednegatives_tpu_torch.train.runner import _device

    device = _device(args.get("device", "cuda"))
    os.makedirs(out_dir, exist_ok=True)

    from pacednegatives_tpu_torch.data import HashTokenizer, TextCorpus, TokenizedStore
    from pacednegatives_tpu_torch.data.tokenizer import TrainedTokenizer
    from pacednegatives_tpu_torch.distill import TeacherBatcher, TeacherScores, make_distill_step
    from pacednegatives_tpu_torch.distill.loader import load_triples_tsv
    from pacednegatives_tpu_torch.distill.train import init_distill_state
    from pacednegatives_tpu_torch.models.t5 import T5Config, init_params
    from pacednegatives_tpu_torch.train import MetricWriter, make_optimizer

    corpus = TextCorpus.from_tsv(args["docs"], args["queries"])
    tok_arg = args.get("tokenizer", "hash")
    tok = (
        TrainedTokenizer.load(tok_arg)
        if tok_arg.endswith(".json")
        else HashTokenizer(vocab_size=vocab)
    )
    store = TokenizedStore.build(corpus, tok)
    triples = load_triples_tsv(args["triples"])
    teacher = TeacherScores.load(args["teacher"])
    batcher = TeacherBatcher(triples, corpus, store, teacher, batch_size)

    import dataclasses

    mk = {"tiny": lambda: T5Config.tiny(tok.vocab_size), "small": T5Config.small,
          "base": T5Config.base}[model]
    mcfg = dataclasses.replace(
        mk(), vocab_size=max(tok.vocab_size, 16),
        dtype=torch.bfloat16, remat=True, remat_policy="dots",
    )
    params = init_params(mcfg, torch.Generator(device=device).manual_seed(0),
                         device)
    steps = total_steps // batch_size
    tx = make_optimizer(lr, steps)
    step = make_distill_step(mcfg, tx, objective, rel_id=tok.true_id,
                             nrel_id=tok.false_id)
    state = init_distill_state(params, tx)
    writer = MetricWriter(os.path.join(out_dir, "metrics.jsonl"))

    t0 = time.time()
    for i in range(steps):
        batch = batcher.get_batch(i % max(batcher.num_batches, 1))
        state, m = step(state, batch)  # it moves the batch to the device
        if i % 50 == 0:
            writer.write({"step": i, "loss": float(m["loss"])})
    writer.write({"step": steps, "time": time.time() - t0})
    writer.close()

    from pacednegatives_tpu_torch.train.loop import save_checkpoint
    from pacednegatives_tpu_torch.train.state import TrainState

    save_checkpoint(
        os.path.join(out_dir, "final"),
        TrainState(state.params, state.opt_state, {}, state.step,
                   torch.Generator(device=device).manual_seed(0),
                   torch.Generator().manual_seed(0)),
    )
    summary = {"steps": steps, "out_dir": out_dir}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
