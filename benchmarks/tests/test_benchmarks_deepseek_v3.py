"""The harness with a second architecture, ``DeepseekV3ForCausalLM``, on
the CPU: a tiny configuration written into a grown tree of cells runs
through ``run.py`` traced and untraced with ``correct`` true and the new
per-layer metrics read; the planted fault and the float8 control fail a
limit; the hook's weights are the port's tree, its FLOPs are counted by
hand, and the expert GEMMs' roofline readers divide what they should.

Run: ``python -m pytest benchmarks/tests -q``.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmarks.tests.test_benchmarks_harness import SEED, run_cell
from benchmarks.tests.tiny import BENCH, CONFIG, LIMITS, ROOT, make_tree

ARCH = "DeepseekV3ForCausalLM"
TINY = {
    "source": "tiny", "architectures": [ARCH], "vocab_size": 512,
    "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_hidden_layers": 3, "num_attention_heads": 4, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 6, "num_experts_per_tok": 3,
    "n_shared_experts": 2, "first_k_dense_replace": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True,
    "rms_norm_eps": 1e-5, "rope_theta": 50000, "pad_token_id": 0,
    "reduced": ["n_routed_experts"],
    "deployment": {"experts_held": [1, 6], "router_experts": 8},
    "run": {"dtype": "float32"}, "tokens": CONFIG["tokens"],
}
NEW = ("moe_gemm_fwd_roofline.train", "moe_gemm_bwd_roofline.train",
       "moe_dispatch_ms_per_step.train")


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """The tiny tree with the configuration ``tiny-ds`` and its cell
    ``tiny-ds.lce``, listed where the manifest lists the new cell."""
    root = make_tree(tmp_path_factory.mktemp("ds"))
    b = root / "benchmarks"
    (b / "configs" / "tiny-ds.json").write_text(json.dumps(TINY))
    (b / "limits" / "tiny-ds.lce.json").write_text(json.dumps(LIMITS["lce"]))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    repo = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-ds", "source": "tiny",
                                "file": "benchmarks/configs/tiny-ds.json",
                                "reduced": ["n_routed_experts"],
                                "why": "CPU tests"})
    manifest["workloads"].append({"name": "tiny-ds.lce", "config": "tiny-ds",
                                  "traffic": "lce", "chips": 1,
                                  "why": "CPU tests"})
    new = "moonlight-16b-a3b.lce-b32"
    listed = {m["name"] for m in repo["end_to_end"] + repo["per_layer"]
              if new in m.get("workloads", [])}
    assert set(NEW) <= listed
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append("tiny-ds.lce")
    for m in repo["per_layer"]:
        if m["name"] in NEW:
            manifest["per_layer"].append(dict(m, workloads=["tiny-ds.lce"]))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct(grown, trace):
    rc, out = run_cell(grown, "tiny-ds.lce", trace)
    assert rc == 0 and out["correct"] is True, out["checks"]
    if not trace:
        assert out["metrics"]["train_negatives_per_s"]["value"] > 0
        return
    metrics = out["metrics"]
    assert metrics["host_syncs_per_step.train"]["value"] > 0
    # the spans are there; the CPU ran no kernel under them
    assert metrics["moe_dispatch_ms_per_step.train"] == {"value": 0.0,
                                                         "unit": "ms"}
    # a roofline share has no device time to divide by on the CPU
    assert "moe_gemm_fwd_roofline.train" not in metrics


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_planted_fault_is_not_correct(grown, fault):
    rc, out = run_cell(grown, "tiny-ds.lce", fault=fault)
    assert rc == 0 and out["correct"] is False, out["checks"]


def test_control_is_not_correct(grown):
    from benchmarks import run as harness
    from benchmarks.common.cell import Cell

    spec = harness.resolve(grown, "tiny-ds.lce")
    driver = harness.load_module(spec.driver, "train")
    arch = harness.load_module(spec.arch, ARCH)
    cell = Cell(workload="tiny-ds.lce", config=spec.config, arch=arch,
                traffic=spec.traffic, limits=spec.limits, seed=SEED,
                seconds=0.0, trace=False, device=torch.device("cpu"),
                t_start=time.perf_counter(), out_dir=str(grown / "out"))
    checks = driver.control(cell)
    assert any(checks[k] > v for k, v in spec.limits.items()), checks


def _arch():
    from benchmarks.arch import DeepseekV3ForCausalLM as arch

    return arch


def test_weights_have_the_ports_tree_and_config():
    from pacednegatives_tpu_torch.models import deepseek_v3 as ds

    arch = _arch()
    cfg = arch.port_config(TINY, remat=False)
    assert cfg.experts_held == (1, 6) and cfg.n_routed_experts == 8
    ours = {k: s for k, s, _ in arch.leaves(arch.sizes(TINY))}
    assert ours == {k: s for k, s, _ in ds.leaves(cfg)}
    a = arch.weights(TINY, 2**40 + 1, "cpu")
    b = arch.weights(TINY, 2**40 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        arch.port_config(TINY, remat=True)


def test_the_moonlight_file_keeps_the_published_widths():
    cfg = json.loads((ROOT / "benchmarks" / "configs"
                      / "moonlight-16b-a3b.json").read_text())
    s = _arch().sizes(cfg)
    assert (s["hidden_size"], s["num_attention_heads"], s["kv_lora_rank"],
            s["qk_nope_head_dim"], s["qk_rope_head_dim"], s["v_head_dim"],
            s["intermediate_size"], s["moe_intermediate_size"],
            s["n_routed_experts"], s["num_experts_per_tok"],
            s["n_shared_experts"], s["rope_theta"]) == (
        2048, 16, 512, 128, 64, 128, 11264, 1408, 64, 6, 2, 50000)
    assert s["experts_held"] == (0, 8) and s["vocab_size"] == 20480
    assert s["num_hidden_layers"] == 9
    assert cfg["reduced"] == ["n_routed_experts", "vocab_size",
                              "num_hidden_layers"]


def test_forward_flops_by_hand():
    s = _arch().sizes(TINY)
    # two rows of 3 and 5 real tokens
    got = _arch().forward_flops(s, 2, 8, 34, trained=True)
    D, H = 64, 4
    mla = 2 * (D * H * 24 + D * 40 + 32 * H * 32 + H * 16 * D)
    attn = 2 * H * (24 + 16) * (3 * 4 / 2 + 5 * 6 / 2)
    dense = 6 * D * 96
    moe = 2 * D * 8 + 6 * D * 64 + 3 * 6 / 8 * 6 * D * 32
    head = 2 * 2 * D * 512
    assert got == pytest.approx(3 * 8 * mla + 3 * attn + 8 * dense
                                + 2 * 8 * moe + head)


def test_roofline_readers_divide_the_least_time_by_the_span():
    from benchmarks.common import moe_flops
    from benchmarks.run import load_module
    from pacednegatives_tpu_torch.utils import profiling

    s = _arch().sizes(TINY)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("pnt.step", 0):
            for _ in range(2):
                with profiling.span("pnt.moe.route"):
                    pass
                with profiling.span("pnt.moe.experts"):
                    profiling.count_device("moe.slots", torch.tensor(300.0))
    peak = 989.4e12
    trace = {"span_device_s": {"pnt.moe.experts": 2e-6,
                               "pnt.moe.experts.bwd": 4e-6,
                               "pnt.moe.route": 1e-6,
                               "pnt.moe.dispatch": 2e-6,
                               "pnt.moe.combine": 3e-6}}
    ctx = SimpleNamespace(outcome=SimpleNamespace(trace=trace), model=s,
                          peak_flops=peak)
    read = lambda name: load_module(BENCH / "metrics" / f"{name}.py",
                                    name).read(ctx)
    fwd = moe_flops.least_s(moe_flops.expert_gemms(s, 600, 2), peak)
    bwd = moe_flops.least_s(moe_flops.expert_gemms_bwd(s, 600, 2), peak)
    assert read("moe_gemm_fwd_roofline.train") == pytest.approx(
        100 * fwd / 2e-6)
    assert read("moe_gemm_bwd_roofline.train") == pytest.approx(
        100 * bwd / 4e-6)
    assert read("moe_dispatch_ms_per_step.train") == pytest.approx(6e-3)
    # the backward does twice the forward's products
    f = moe_flops.expert_gemms(s, 600, 2)
    b = moe_flops.expert_gemms_bwd(s, 600, 2)
    assert sum(x[0] for x in b) == pytest.approx(2 * sum(x[0] for x in f))
    profiling.reset()
