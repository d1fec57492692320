"""The runner, the CLIs and resume under every curriculum (slice C), on the
CPU at the tiny model: ``run`` writes the rows the JAX runner writes (the
same keys, the same resolved ``ce_scale``), the meta loop refuses the
settings it does not read, level and meta resume exactly, ``load_run``
reloads a meta run, the presets run as ``__main__``, and ``cli.sweep``
writes ``sweep.json`` with the JAX package's grids."""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from pacednegatives_tpu.cli import sweep as jsweep
from pacednegatives_tpu.train import runner as jrunner
from pacednegatives_tpu_torch.cli import sweep as tsweep
from pacednegatives_tpu_torch.curriculum import MetaWeightTable
from pacednegatives_tpu_torch.data import (
    HashTokenizer,
    TextCorpus,
    TokenizedStore,
)
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_meta_train_step,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
)
from pacednegatives_tpu_torch.train.runner import RunConfig, load_run, run

# a tiny run: 2 optimizer steps of 4 pairs, one row a step
TINY = dict(model="tiny", remat=False, total_steps=8, batch_size=4,
            chunk_size=1, synthetic_docs=24, synthetic_queries=8,
            synthetic_pairs=12, synthetic_pool=8, max_q_tokens=8,
            max_d_tokens=24, warmup_steps=4)
CURRICULA = ["interp", "level", "eta", "contrast", "lce", "meta-cheap",
             "meta-std"]


def _rows(path):
    with open(path / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _keys(rows, mining):
    """The keys of each step row and, on static pools, of the run's first
    and last rows (the port's online loop also logs each refresh's
    seconds and the run's time)."""
    steps = [tuple(sorted(r)) for r in rows
             if "loss" in r or "avg_weight" in r]
    if mining == "online":
        return steps
    return sorted(rows[0]), steps, sorted(rows[-1])


@pytest.mark.parametrize("curriculum,mining", [
    *((c, "static") for c in CURRICULA), ("eta", "online")])
def test_run_writes_the_jax_runners_rows(tmp_path, curriculum, mining):
    extra = dict(curriculum=curriculum, mining=mining)
    if mining == "online":
        extra.update(pool_size=8, refresh_every=2, encode_batch=8)
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jsum = jrunner.run(jrunner.RunConfig(**TINY, **extra,
                                         out_dir=str(jout)))
    tsum = run(RunConfig(**TINY, **extra, out_dir=str(tout)), device="cpu")
    assert tsum["steps"] == jsum["steps"] == 2
    assert np.isfinite(tsum["final_loss"])
    jrows, trows = _rows(jout), _rows(tout)
    assert _keys(trows, mining) == _keys(jrows, mining)
    jscale = [r["ce_scale"] for r in jrows if "ce_scale" in r]
    tscale = [r["ce_scale"] for r in trows if "ce_scale" in r]
    assert tscale == jscale
    if curriculum not in ("interp", "level") and not curriculum.startswith(
            "meta"):
        # the resolved normalization (pair curricula: log V; LCE: its
        # width times log V), as the JAX runner resolves it
        cfg = jrunner.RunConfig(**TINY, **extra)
        assert tscale == [jrunner._resolve_ce_scale(cfg, 8192)]
    assert (tout / "final" / "state.pt").exists()


@pytest.mark.parametrize("field,value", [
    ("mining", "online"), ("microbatches", 2), ("dropout", True),
    ("grad_accum_dtype", "bf16"), ("eval_every_steps", 2),
    ("checkpoint_every_steps", 2), ("shuffle", True),
    ("log_every_chunks", 2),
])
def test_meta_refuses_settings_it_does_not_read(tmp_path, field, value):
    cfg = RunConfig(**TINY, curriculum="meta-cheap", out_dir=str(tmp_path),
                    **{field: value})
    with pytest.raises(ValueError, match=field):
        run(cfg, device="cpu")


def test_unknown_curricula_raise(tmp_path):
    for name in ("meta-newer", "pacing"):
        with pytest.raises(ValueError, match="unknown curriculum"):
            run(RunConfig(**TINY, curriculum=name, out_dir=str(tmp_path)),
                device="cpu")


def test_level_run_resumes_exactly(tmp_path):
    """A level run checkpointed at step 2 and resumed from there ends where
    the uninterrupted run ends: params, the level state's four scalars."""
    base = dict(TINY, curriculum="level", total_steps=16,
                heuristic_step_check=1, success_threshold=0.0,
                checkpoint_every_steps=2)
    straight = tmp_path / "straight"
    run(RunConfig(**base, out_dir=str(straight)), device="cpu")
    resumed = tmp_path / "resumed"
    run(RunConfig(**base, out_dir=str(resumed),
                  resume_from=str(straight / "step_2")), device="cpu")
    a, b = (torch.load(p / "final" / "state.pt", weights_only=True)
            for p in (straight, resumed))
    assert a["step"] == b["step"] == 4
    for key in ("difficulty", "success_sum", "success_count", "step"):
        assert torch.equal(a["curriculum"][key], b["curriculum"][key]), key
    assert a["curriculum"]["difficulty"].item() > 0.0
    for key, val in a["params"].items():
        assert torch.equal(val, b["params"][key]), key


def _meta_env(seed=0):
    tok = HashTokenizer(vocab_size=256)
    corpus = TextCorpus.synthetic(num_docs=16, num_queries=8, seed=0,
                                  doc_len=30, query_len=6)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8,
                                 max_d_tokens=16)
    triples = TripletStore.synthetic(corpus, n_pairs=12, n_neg=5, seed=1)
    dc = DeviceCorpus.build(store, triples, device="cpu")
    cfg = tt5.T5Config.tiny(vocab_size=256)
    table = MetaWeightTable(num_batches=3, batch_size=4)
    tx = make_optimizer(lr=1e-2, total_steps=8, warmup_steps=1)
    step = make_meta_train_step(cfg, table, tx, lambda s: 0.05,
                                variant="cheap", rel_id=tok.true_id,
                                nrel_id=tok.false_id)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(seed))
    return dc, table, step, init_train_state(params, tx, table.init(),
                                             seed=seed)


def _meta_steps(dc, table, step, state, start, stop):
    for i in range(start, stop):
        j = i % table.num_batches
        pair_idx = (j * 4 + torch.arange(4)) % dc.num_pairs
        batch = dc.pair_batch(pair_idx, table.lookup(state.curriculum, j))
        state, _ = step(state, batch, j)
    return state


def test_meta_state_resumes_exactly(tmp_path):
    """The meta table through save_checkpoint / restore_checkpoint: two
    steps, a checkpoint, two more from a template of other weights, equal
    to four uninterrupted steps."""
    dc, table, step, state = _meta_env()
    straight = _meta_steps(dc, table, step, state, 0, 4)
    dc, table, step, state = _meta_env()
    save_checkpoint(str(tmp_path / "step_2"),
                    _meta_steps(dc, table, step, state, 0, 2))
    _, _, _, template = _meta_env(seed=7)
    resumed = restore_checkpoint(str(tmp_path / "step_2"), template)
    assert resumed.step == 2
    resumed = _meta_steps(dc, table, step, resumed, 2, 4)
    assert torch.equal(resumed.curriculum.table, straight.curriculum.table)
    assert not torch.equal(straight.curriculum.table,
                           torch.ones_like(straight.curriculum.table))
    for a, b in zip(tt5.flatten_params(straight.params).values(),
                    tt5.flatten_params(resumed.params).values()):
        assert torch.equal(a, b)


def test_load_run_reloads_a_meta_run(tmp_path):
    out = tmp_path / "meta"
    run(RunConfig(**TINY, curriculum="meta-std", out_dir=str(out)),
        device="cpu")
    params, mcfg, tok, cfg = load_run(str(out), device="cpu")
    assert cfg.curriculum == "meta-std" and mcfg.d_model == 64
    saved = torch.load(out / "final" / "state.pt", weights_only=True)
    assert saved["curriculum"]["table"].shape == (3, 4)
    for key, val in tt5.flatten_params(params).items():
        assert torch.equal(val, saved["params"][key]), key


@pytest.mark.parametrize("preset,curriculum", [
    ("train_interp", "interp"), ("train_level", "level"),
    ("train_eta", "eta"), ("train_std", "meta-std")])
def test_presets_run_as_main(tmp_path, monkeypatch, capsys, preset,
                             curriculum):
    out = tmp_path / preset
    argv = ["--model", "tiny", "--device", "cpu", "--out_dir", str(out)]
    for key, val in TINY.items():
        if key != "model":
            argv += [f"--{key}", str(val)]
    monkeypatch.setattr(sys, "argv", [preset, *argv])
    runpy.run_module(f"pacednegatives_tpu_torch.cli.{preset}",
                     run_name="__main__")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert json.loads((out / "config.json").read_text())["curriculum"] \
        == curriculum


def test_sweep_on_cpu_writes_sweep_json(tmp_path):
    assert tsweep.GRIDS == jsweep.GRIDS
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"curriculum": ["interp", "level"]}))
    argv = ["--grid_file", str(grid), "--device", "cpu", "--out_dir",
            str(tmp_path / "sweep")]
    for key, val in TINY.items():
        argv += [f"--{key}", str(val)]
    results = tsweep.main(argv)
    assert [r["config"] for r in results] == [{"curriculum": "interp"},
                                              {"curriculum": "level"}]
    assert all("error" not in r and r["steps"] == 2 for r in results)
    saved = json.loads((tmp_path / "sweep" / "sweep.json").read_text())
    assert saved == json.loads(json.dumps(results))


def test_sweep_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep.main(["--grid", "eta", "--out_dir", str(tmp_path)])
