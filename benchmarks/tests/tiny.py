"""A tree of tiny cells for the harness's CPU tests: the real drivers,
architecture hooks and metric readers, a T5 of two layers a stack, and
traffic scaled down."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

CONFIG = {
    "source": "tiny", "architectures": ["T5ForConditionalGeneration"],
    "vocab_size": 512, "d_model": 128, "d_kv": 64, "d_ff": 256,
    "num_heads": 2, "num_layers": 2, "num_decoder_layers": 2,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "relu", "tie_word_embeddings": True,
    "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0,
    "reduced": [],
    "run": {"dtype": "float32", "flash_v3": True, "fused_qkv": True},
    "tokens": {"pad": 0, "eos": 1, "true": 3, "false": 4, "first_word": 5,
               "prefix": [7], "mid": [8], "suffix": [9, 1]},
}
COMMON = {"queries": 64, "docs": 512, "pool": 32, "max_q": 8, "max_d": 56,
          "query_len": {"kind": "uniform", "min": 2, "max": 8},
          "doc_len": {"kind": "lognormal", "mu": 3.0, "sigma": 0.45,
                      "min": 4, "max": 50}}
TRAIN = dict(driver="train", **COMMON, n=2, curriculum="lce", lr=1e-3,
             grad_clip=1.0, eta0=0.5, warmup_examples=8,
             total_examples=400, remat=False, chunk_size=2, microbatches=1,
             checked_steps=3, trace_chunks=1, reference_block_examples=2,
             batch_queries=4, packed=False, scored=None,
             rate_metric="train_negatives_per_s")
TRAFFIC = {
    "lce": TRAIN,
    "scored": dict(TRAIN, packed=True, scored={
        "candidates": 8, "chunk_rows": 16, "buckets": [64],
        "dtype": "compute"}, rate_metric="scored_negatives_per_s"),
    "rerank": dict(driver="rerank", **COMMON, depth=20, block=8,
                   packed=True, buckets=[64], warm_requests=1,
                   trace_requests=2, check_requests=2),
}
# loose: a tiny fp32 run on the CPU agrees far closer than this
LIMITS = {
    "lce": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
            "negatives_differ": 0.0},
    "rerank": {"score_gap": 1e-4, "order_gap": 1e-4},
}
LIMITS["scored"] = dict(LIMITS["lce"], score_gap=1e-4, order_gap=1e-4)


def make_tree(dest: Path, manifest: dict | None = None) -> Path:
    """A root with BENCHMARK.json and benchmarks/{drivers,arch,metrics,
    configs,traffic,limits} for the cells tiny.lce, tiny.scored,
    tiny.rerank. The metrics and their bounds are ``manifest``'s (the
    repo's ``BENCHMARK.json`` by default); each metric's ``workloads``
    lists the tiny cells that stand for its cells, and a cell with no
    tiny stand-in is dropped."""
    b = dest / "benchmarks"
    for sub in ("drivers", "arch", "metrics"):
        shutil.copytree(BENCH / sub, b / sub)
    for sub in ("configs", "traffic", "limits"):
        (b / sub).mkdir(parents=True)
    (b / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    manifest = copy.deepcopy(
        manifest or json.loads((ROOT / "BENCHMARK.json").read_text()))
    manifest["configs"] = [{"name": "tiny", "source": "tiny",
                            "file": "benchmarks/configs/tiny.json",
                            "reduced": [], "why": "CPU tests"}]
    manifest["workloads"] = []
    for mix, traffic in TRAFFIC.items():
        (b / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        (b / "limits" / f"tiny.{mix}.json").write_text(
            json.dumps(LIMITS[mix]))
        manifest["workloads"].append({"name": f"tiny.{mix}", "config": "tiny",
                                      "traffic": mix, "chips": 1,
                                      "why": "CPU tests"})
    alias = {"monot5-base.lce-b64": "tiny.lce",
             "monot5-base.lce-scored-c64": "tiny.scored",
             "monot5-large.lce-b32": "tiny.lce",
             "monot5-base.rerank-d1000": "tiny.rerank"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({alias[w] for w in m["workloads"]
                                     if w in alias})
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


def traffic(name: str) -> dict:
    return copy.deepcopy(TRAFFIC[name])
