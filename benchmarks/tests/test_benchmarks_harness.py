"""The harness on the CPU: every driver at a tiny T5 through the port's
plain routes, the planted faults, cells, architectures and metrics found
by name, the manifest's names, the FLOP and byte counts by hand, the
trace's reduction, and the modules a run loads.

Run: ``python -m pytest benchmarks/tests -q``.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from benchmarks import run as harness
from benchmarks.common import flops, tracing
from benchmarks.tests.tiny import BENCH, ROOT, make_tree

SEED = 2**33 + 12345  # above 32 bits, as the benchmark's seeds may be


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("cells"))


def run_cell(root, workload, trace=0, fault=None, seconds=1.0):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.main(["--workload", workload, "--seed", str(SEED),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          root=root, device="cpu", fault=fault)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny.lce", "tiny.scored", "tiny.rerank"])
def test_cell_runs_and_is_correct(tree, cell, trace):
    rc, out = run_cell(tree, cell, trace)
    assert rc == 0
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    names = set(out["metrics"])
    mix = cell.split(".")[1]
    if trace:
        idle = {"lce": "device_idle.train", "scored": "device_idle.scored",
                "rerank": "device_idle.rerank"}[mix]
        assert idle in names  # the CPU ran no kernel: all idle
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in names
        e2e = {"lce": "train_negatives_per_s",
               "scored": "scored_negatives_per_s",
               "rerank": "rerank_docs_per_s"}[mix]
        assert out["metrics"][e2e]["value"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny.lce", "half_batch"),
    ("tiny.lce", "unchanged"),
    ("tiny.scored", "half_batch"),
    ("tiny.rerank", "half_batch"),
    ("tiny.rerank", "altered_answer"),
])
def test_planted_fault_is_not_correct(tree, cell, fault):
    rc, out = run_cell(tree, cell, fault=fault)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_config_mix_and_metric_are_found_by_name(tree, tmp_path):
    root = make_tree(tmp_path / "grown")
    before = _digest(root)
    b = root / "benchmarks"
    cfg = json.loads((b / "configs" / "tiny.json").read_text())
    cfg["d_ff"] = 384
    (b / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "lce.json").read_text())
    mix["batch_queries"] = 2
    (b / "traffic" / "lce-b2.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny-wide.lce-b2.json").write_text(
        (b / "limits" / "tiny.lce.json").read_text())
    (b / "metrics" / "rows_traced.train.py").write_text(
        "def read(ctx):\n"
        "    return ctx.outcome.counters.values.get('train_rows')\n")
    # the manifest gains entries; no file that was there changes but it
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-wide", "source": "tiny",
                                "file": "benchmarks/configs/tiny-wide.json",
                                "reduced": [], "why": "grown"})
    manifest["workloads"].append({"name": "tiny-wide.lce-b2",
                                  "config": "tiny-wide", "traffic": "lce-b2",
                                  "chips": 1, "why": "grown"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_negatives_per_s":
            m["workloads"].append("tiny-wide.lce-b2")
    manifest["per_layer"].append({
        "name": "rows_traced.train", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "model step",
        "moves": "train_negatives_per_s", "workloads": ["tiny-wide.lce-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digest(root)
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"BENCHMARK.json"}
    rc, out = run_cell(root, "tiny-wide.lce-b2", trace=1)
    assert rc == 0 and out["correct"] is True
    # 2 chunk steps of 2 queries x (1 + 2) rows
    assert out["metrics"]["rows_traced.train"]["value"] == 2 * 2 * 3


# A second architecture, in its own key names, mapped onto the tiny T5 so
# that the port's path runs it. The harness may read none of T5's keys.
OTHER_ARCH = '''"""Hooks of a test architecture: its own key names over the
tiny T5."""

from benchmarks.arch import T5ForConditionalGeneration as t5

SIZES = ("vocab_size", "hidden_size", "head_dim", "intermediate_size",
         "num_attention_heads", "num_hidden_layers")


def _t5_sizes(s):
    return {"vocab_size": s["vocab_size"], "d_model": s["hidden_size"],
            "d_kv": s["head_dim"], "d_ff": s["intermediate_size"],
            "num_heads": s["num_attention_heads"],
            "num_layers": s["num_hidden_layers"],
            "num_decoder_layers": s["num_hidden_layers"]}


def _t5(config):
    return dict(_t5_sizes(config), relative_attention_num_buckets=32,
                relative_attention_max_distance=128,
                layer_norm_epsilon=config["rms_norm_eps"],
                feed_forward_proj="relu", tie_word_embeddings=True,
                pad_token_id=config["tokens"]["pad"],
                decoder_start_token_id=0, run=config["run"],
                tokens=config["tokens"])


def sizes(config):
    return {k: config[k] for k in SIZES}


def port_config(config, remat):
    return t5.port_config(_t5(config), remat)


def weights(config, seed, device):
    return t5.weights(_t5(config), seed, device)


def reference(config, weights, precision="fp32"):
    return t5.reference(_t5(config), weights, precision)


def forward_flops(sizes, rows, sum_len, sum_len_sq, trained):
    return t5.forward_flops(_t5_sizes(sizes), rows, sum_len, sum_len_sq,
                            trained)
'''
OTHER_CONFIG = {
    "source": "test", "architectures": ["TinyTestForCausalLM"],
    "vocab_size": 512, "hidden_size": 128, "head_dim": 64,
    "intermediate_size": 256, "num_attention_heads": 2,
    "num_hidden_layers": 2, "rms_norm_eps": 1e-6,
}
# the port's device time under pnt.step, a step and a layer
PNT_METRIC = (
    "def read(ctx):\n"
    "    t = ctx.outcome.trace\n"
    "    if t is None or 'pnt.step' not in t['span_device_s']:\n"
    "        return None\n"
    "    ms = 1e3 * t['span_device_s']['pnt.step'] / ctx.outcome.attempted\n"
    "    return ms / ctx.model['num_hidden_layers']\n")


def test_another_architecture_is_found_by_name(tree, tmp_path):
    from benchmarks.tests.tiny import CONFIG

    root = make_tree(tmp_path / "grown")
    before = _digest(root)
    b = root / "benchmarks"
    assert not set(OTHER_CONFIG) & (set(CONFIG) - {"source", "vocab_size",
                                                   "architectures"})
    (b / "arch" / "TinyTestForCausalLM.py").write_text(OTHER_ARCH)
    (b / "configs" / "tiny-other.json").write_text(json.dumps(dict(
        OTHER_CONFIG, run=CONFIG["run"], tokens=CONFIG["tokens"])))
    (b / "limits" / "tiny-other.lce.json").write_text(
        (b / "limits" / "tiny.lce.json").read_text())
    (b / "metrics" / "pnt_step_ms_per_layer.train.py").write_text(PNT_METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-other", "source": "test",
                                "file": "benchmarks/configs/tiny-other.json",
                                "reduced": [], "why": "another architecture"})
    manifest["workloads"].append({"name": "tiny-other.lce",
                                  "config": "tiny-other", "traffic": "lce",
                                  "chips": 1, "why": "another architecture"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("train_negatives_per_s", "train_mfu"):
            m["workloads"].append("tiny-other.lce")
    manifest["per_layer"].append({
        "name": "pnt_step_ms_per_layer.train", "unit": "ms",
        "better": "lower", "source": "device_trace", "layer": "model step",
        "moves": "train_negatives_per_s", "workloads": ["tiny-other.lce"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digest(root)
    assert {k for k in before if before[k] != after[k]} == {"BENCHMARK.json"}

    rc, out = run_cell(root, "tiny-other.lce")
    assert rc == 0 and out["correct"] is True, out["checks"]
    assert out["metrics"]["train_negatives_per_s"]["value"] > 0
    rc, out = run_cell(root, "tiny-other.lce", trace=1)
    assert rc == 0 and out["correct"] is True, out["checks"]
    # the span is there; the CPU ran no kernel under it
    assert out["metrics"]["pnt_step_ms_per_layer.train"] == {
        "value": 0.0, "unit": "ms"}
    # the same model under T5's own names reads the same checks (to the
    # CPU's run-to-run rounding: its embedding backward sums threads'
    # parts in no fixed order)
    rc, t5_out = run_cell(root, "tiny.lce", trace=1)
    assert {k: pytest.approx(c["value"], rel=0.01, abs=1e-9)
            for k, c in t5_out["checks"].items()} == {
        k: c["value"] for k, c in out["checks"].items()}


def test_a_fifth_cell_in_the_manifest_leaves_the_tiny_tree_whole(tmp_path):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = "moonlight-16b-a3b.lce-b32"
    manifest["workloads"].append({"name": new, "config": "monot5-large",
                                  "traffic": "lce-b32", "chips": 1,
                                  "why": "a cell the tiny tree does not know"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("train_negatives_per_s", "train_mfu"):
            m["workloads"].append(new)
    root = make_tree(tmp_path / "five", manifest)
    built = json.loads((root / "BENCHMARK.json").read_text())
    listed = {w for m in built["end_to_end"] + built["per_layer"]
              for w in m.get("workloads", [])}
    assert listed == {"tiny.lce", "tiny.scored", "tiny.rerank"}
    rc, out = run_cell(root, "tiny.lce")
    assert rc == 0 and out["correct"] is True, out["checks"]


def test_t5_hooks_equal_what_they_replace():
    """The T5 hooks read what ``model_dict``, ``make_t5_weights`` and
    ``t5_forward_flops`` gave before the hooks existed, bit for bit."""
    import torch

    from benchmarks.arch import T5ForConditionalGeneration as t5_arch
    from benchmarks.tests.tiny import CONFIG

    sizes = t5_arch.sizes(CONFIG)
    assert sizes == {
        "vocab_size": 512, "d_model": 128, "d_kv": 64, "d_ff": 256,
        "num_heads": 2, "num_layers": 2, "num_decoder_layers": 2,
        "relative_attention_num_buckets": 32,
        "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6}
    w = t5_arch.weights(CONFIG, SEED, "cpu")
    h = hashlib.sha256()
    for k, v in w.items():
        assert v.dtype == torch.float32
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    # make_t5_weights(CONFIG, SEED, "cpu"), 47 leaves in its order
    assert len(w) == 47
    assert h.hexdigest() == ("7be69eca5f674a6680854c09380ec8d6"
                             "9822039267a515836d3bedda489a3d14")
    for trained, l_dec, old in ((True, 2, 222720000.0),
                                (False, 1, 214517760.0)):
        got = t5_arch.forward_flops(sizes, 10, 300.0, 9500.0, trained)
        assert got == old == flops.t5_forward_flops(sizes, 10, 300.0,
                                                    9500.0, l_dec)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_the_contract():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][1] == "benchmarks/run.py"
    assert m["paths"] == ["benchmarks"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in m["workloads"]}
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
        assert set(e.get("workloads", cells)) <= cells
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(p["unit"]) and p["moves"] in e2e
        assert set(p["workloads"]) <= e2e[p["moves"]]
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
    for cell in cells:  # every cell: setup_s, another e2e, a per-layer
        assert sum(cell in v for v in e2e.values()) >= 2
        assert any(cell in p["workloads"] for p in m["per_layer"])


def test_flops_by_hand():
    cfg = {"num_heads": 2, "d_kv": 4, "d_model": 8, "d_ff": 16,
           "num_layers": 1, "num_decoder_layers": 1, "vocab_size": 10}
    # two rows of 3 and 5 real tokens, one decoder position
    got = flops.t5_forward_flops(cfg, 2, 3 + 5, 9 + 25, 1)
    inner = 8
    enc = sum(2 * L * 8 * inner * 4 + 4 * 2 * 4 * L * L + 2 * L * 8 * 16 * 2
              for L in (3, 5))
    dec = sum(2 * 1 * 8 * inner * 4 + 4 * 1 * 2 * 4 + 2 * 1 * 8 * inner * 2
              + 2 * L * 8 * inner * 2 + 4 * 1 * 2 * 4 * L
              + 2 * 1 * 8 * 16 * 2 for L in (3, 5))
    head = 2 * 2 * 1 * 8 * 10
    assert got == enc + dec + head
    f, b = flops.attn_block_fwd(B=2, L=3, d=8, H=2, dk=4)
    assert f == 2 * 6 * 8 * 24 + 4 * 2 * 2 * 9 * 4 + 2 * 6 * 8 * 8
    assert b == 6 * 8 * 2 + 8 * 24 * 2 + 8 * 8 * 2 + 2 * 9 * 4 + 2 * 3 * 4 \
        + 6 * 8 * 2
    f, b = flops.attn_block_bwd(B=2, L=3, d=8, H=2, dk=4)
    assert f == 2 * (2 * 6 * 8 * 24) + 10 * 2 * 2 * 9 * 4 + 2 * (2 * 6 * 8 * 8)
    assert b == 2 * (6 * 8 * 2 + 8 * 24 * 2 + 8 * 8 * 2) + 2 * 2 * 9 * 4 \
        + 2 * 3 * 4 + 2 * 2 * 2 * 3 * 4 + 6 * 8 * 2
    assert flops.bound_s(3.35e12, 1.0, 1e12) == pytest.approx(1.0)
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.attn_fwd",
         "ts": 10, "dur": 10, "tid": 1, "args": {"External id": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 30, "dur": 40,
         "tid": 1, "args": {"External id": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 31, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_attn", "ts": 20, "dur": 20,
         "tid": 9, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_mm", "ts": 35, "dur": 15,
         "tid": 9, "args": {"correlation": 8}},
        # launched from no known host call, outside every span
        {"ph": "X", "cat": "kernel", "name": "k_other", "ts": 80, "dur": 10,
         "tid": 9, "args": {"External id": 6}},
    ]
    r = tracing.reduce(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)  # [20, 50] and [80, 90]
    assert r["span_device_s"]["bench.attn_fwd"] == pytest.approx(20e-6)
    assert r["unattributed_kernels"] == 0
    gaps = dict(r["breakdown"]["idle_gaps"])
    # [0, 20] under the span's launch-free part, [50, 80] in aten::mm,
    # [90, 100] with nothing on the host
    assert gaps["aten::mm"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    assert dict(r["breakdown"]["device_ops"])["k_attn"] == pytest.approx(
        20e-6)


def test_trace_reduction_of_the_ports_spans():
    """pnt.* spans collect device time: nested spans inclusively, a name
    nested in itself once, and a span opened on another thread (the
    autograd engine's, inside a backward) what that thread launches."""
    launch = lambda ts, tid, corr: {
        "ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
        "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}
    kernel = lambda ts, dur, corr: {
        "ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
        "dur": dur, "tid": 9, "args": {"correlation": corr}}
    span = lambda name, ts, dur, tid: {
        "ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
        "dur": dur, "tid": tid}
    ev = [
        span("bench.window", 0, 200, 1),
        span("pnt.step", 10, 150, 1),
        span("pnt.step.fwd_bwd", 20, 40, 1),
        span("pnt.step.optimizer", 100, 40, 1),
        span("pnt.loop.read_metrics", 170, 20, 1),
        span("pnt.loop.read_metrics", 175, 5, 1),  # nested in itself
        # the backward's thread: the engine's scope and a span inside it
        span(tracing.ATTN_BWD_SCOPE, 60, 30, 2),
        span("pnt.attn.bwd", 65, 10, 2),
        launch(25, 1, 1), kernel(30, 10, 1),  # fwd_bwd, step
        launch(70, 2, 2), kernel(72, 6, 2),  # attn.bwd, the engine's scope
        launch(85, 2, 3), kernel(86, 3, 3),  # the engine's scope alone
        launch(110, 1, 4), kernel(112, 20, 4),  # optimizer, step
        launch(176, 1, 5), kernel(181, 2, 5),  # read_metrics, once
        launch(195, 1, 6), kernel(196, 2, 6),  # the window alone
    ]
    r = tracing.reduce(ev)
    dev = {k: v * 1e6 for k, v in r["span_device_s"].items()}
    assert dev == pytest.approx({
        "bench.window": 10 + 20 + 2 + 2, "pnt.step": 10 + 20,
        "pnt.step.fwd_bwd": 10, "pnt.step.optimizer": 20,
        "pnt.loop.read_metrics": 2, tracing.ATTN_BWD_SCOPE: 6 + 3,
        "pnt.attn.bwd": 6})
    assert r["unattributed_kernels"] == 0
    assert r["busy_s"] == pytest.approx(43e-6)


FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "pacednegatives_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN_TOP), path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "pacednegatives_tpu_torch" not in _imports(path), path


def test_a_cell_loads_no_jax_module(tree):
    code = (
        "import sys, io, contextlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmarks import run\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    rc = run.main(['--workload', 'tiny.scored', '--seed', '5',"
        f" '--seconds', '0.5'], root={str(tree)!r}, device='cpu')\n"
        "print(rc, sorted({m.split('.')[0] for m in sys.modules}"
        f" & set({sorted(FORBIDDEN_TOP)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 []"


def test_no_card_exits_without_a_result(tree, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would use it")
    rc = harness.main(["--workload", "tiny.lce", "--seed", "1",
                       "--seconds", "1"], root=tree)
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["tiny.lce", "tiny.scored", "tiny.rerank"])
def test_control_is_not_correct(tree, cell):
    """The reference in float8 put in the program's place fails a limit."""
    import time

    import torch

    from benchmarks.common.cell import Cell

    spec = harness.resolve(tree, cell)
    driver = harness.load_module(spec.driver, spec.traffic["driver"])
    checks = driver.control(Cell(
        workload=cell, config=spec.config,
        arch=harness.load_module(spec.arch, spec.arch.stem),
        traffic=spec.traffic,
        limits=spec.limits, seed=SEED, seconds=0.0, trace=False,
        device=torch.device("cpu"), t_start=time.perf_counter(),
        out_dir=str(tree / "out")))
    assert set(spec.limits) <= set(checks)
    assert any(v > spec.limits[k] for k, v in checks.items()), checks
