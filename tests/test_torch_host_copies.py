"""The port's copies of the JAX package's numpy-only host modules.

``pacednegatives_tpu_torch/data/{tokenizer,corpus,pipeline,spm_export,
triples,tools,streaming}.py``, ``utils/config.py``,
``eval/{metrics,run_io,experiment}.py``, ``index/{porter,bm25,sparse}.py`` and
``cli/{dataset_tools,train_tokenizer,bm25_grid}.py``, the training
presets ``cli/train_{interp,level,eta,std}.py``, distillation's host side
``distill/{teacher,miner,loader,__init__}.py`` with
``cli/{teacher_scores,mine_negatives}.py``, and
``data/ir_datasets_adapter.py`` are copies, kept
because the JAX package's ``__init__`` modules import JAX eagerly and the
port imports nothing of the JAX package. Each copy must equal its original
except for import lines, and produce the same ids, masks and lengths. The
port package as a whole must import with ``jax`` unavailable, as on the
machine with the card."""

import difflib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pacednegatives_tpu.data import corpus as jcorpus
from pacednegatives_tpu.data import pipeline as jpipeline
from pacednegatives_tpu.data import tokenizer as jtokenizer
from pacednegatives_tpu_torch.data import corpus as tcorpus
from pacednegatives_tpu_torch.data import pipeline as tpipeline
from pacednegatives_tpu_torch.data import tokenizer as ttokenizer

ROOT = Path(__file__).resolve().parent.parent


COPIES = {"tokenizer.py": "data", "corpus.py": "data", "pipeline.py": "data",
          "spm_export.py": "data", "triples.py": "data", "config.py": "utils",
          "tools.py": "data", "streaming.py": "data", "metrics.py": "eval",
          "run_io.py": "eval", "experiment.py": "eval", "porter.py": "index",
          "bm25.py": "index", "sparse.py": "index",
          "dataset_tools.py": "cli",
          "train_tokenizer.py": "cli", "bm25_grid.py": "cli",
          "train_interp.py": "cli", "train_level.py": "cli",
          "train_eta.py": "cli", "train_std.py": "cli",
          "teacher.py": "distill", "miner.py": "distill",
          "loader.py": "distill", "__init__.py": "distill",
          "teacher_scores.py": "cli", "mine_negatives.py": "cli",
          "ir_datasets_adapter.py": "data"}


@pytest.mark.parametrize("name", list(COPIES))
def test_copy_differs_only_in_import_lines(name):
    orig = (ROOT / "pacednegatives_tpu" / COPIES[name] / name).read_text()
    copy = (ROOT / "pacednegatives_tpu_torch" / COPIES[name] / name).read_text()
    changed = [
        line[1:] for line in difflib.ndiff(orig.splitlines(), copy.splitlines())
        if line[:1] in "+-" and line[1:].strip()
    ]
    for line in changed:
        assert line.lstrip().startswith(("from ", "import ")), line
    assert copy.replace("pacednegatives_tpu_torch.", "pacednegatives_tpu.") \
        == orig


def _corpora():
    j = jcorpus.TextCorpus.synthetic(num_docs=40, num_queries=6, seed=3,
                                     doc_len=30, query_len=4)
    t = tcorpus.TextCorpus.synthetic(num_docs=40, num_queries=6, seed=3,
                                     doc_len=30, query_len=4)
    return j, t


def test_corpus_and_tokenizer_match():
    j, t = _corpora()
    assert (j.doc_ids, j.doc_texts, j.query_ids, j.query_texts) == \
        (t.doc_ids, t.doc_texts, t.query_ids, t.query_texts)
    assert j.doc_index == t.doc_index and j.query_index == t.query_index
    jt, tt = jtokenizer.HashTokenizer(512), ttokenizer.HashTokenizer(512)
    for text in j.doc_texts[:5] + ["true false Query: Relevant:"]:
        assert jt.encode(text, add_eos=True) == tt.encode(text, add_eos=True)
    ids, mask = ttokenizer.pad_batch([[5, 6, 7], [8]], 4, 0)
    jids, jmask = jtokenizer.pad_batch([[5, 6, 7], [8]], 4, 0)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


def test_store_assembly_and_lengths_match():
    j, t = _corpora()
    js = jpipeline.TokenizedStore.build(j, jtokenizer.HashTokenizer(512),
                                        max_q_tokens=8, max_d_tokens=40)
    ts = tpipeline.TokenizedStore.build(t, ttokenizer.HashTokenizer(512),
                                        max_q_tokens=8, max_d_tokens=40)
    assert ts.prompt_len == js.prompt_len
    rng = np.random.default_rng(0)
    q_rows = rng.integers(0, 6, size=16)
    d_rows = rng.integers(0, 40, size=16)
    for a, b in zip(js.assemble_host(q_rows, d_rows),
                    ts.assemble_host(q_rows, d_rows)):
        np.testing.assert_array_equal(a, b)
    lens = ts.pair_lengths(q_rows, d_rows)
    np.testing.assert_array_equal(lens, js.pair_lengths(q_rows, d_rows))
    out_len = int(lens.max())
    for a, b in zip(js.assemble_host_packed(q_rows, d_rows, out_len),
                    ts.assemble_host_packed(q_rows, d_rows, out_len)):
        np.testing.assert_array_equal(a, b)
    ids, mask = ts.assemble_host(q_rows, d_rows)
    for a, b in zip(jpipeline.pack_rows(ids, mask, 0),
                    tpipeline.pack_rows(ids, mask, 0)):
        np.testing.assert_array_equal(a, b)


def _port_modules() -> list[str]:
    pkg = ROOT / "pacednegatives_tpu_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts[:-1]
                 if p.name == "__init__.py"
                 else p.relative_to(ROOT).with_suffix("").parts)
        for p in pkg.rglob("*.py"))


def test_port_imports_without_jax():
    """Every module of the port imports in a process where ``import jax``
    fails, and none of them pulls in the JAX package."""
    modules = _port_modules()
    assert "pacednegatives_tpu_torch.cli.evaluate" in modules
    assert "pacednegatives_tpu_torch.index.dense" in modules
    assert {f"pacednegatives_tpu_torch.{m}" for m in (
        "curriculum.interp", "curriculum.level", "curriculum.contrast",
        "curriculum.meta", "cli.sweep", "cli.train_interp",
        "cli.train_level", "cli.train_eta", "cli.train_std", "distill",
        "distill.train", "cli.distill", "cli.teacher_scores",
        "cli.mine_negatives", "utils.profiling",
        "data.ir_datasets_adapter")} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'pacednegatives_tpu'\n"
        "       or m.startswith('pacednegatives_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
