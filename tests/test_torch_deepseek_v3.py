"""The port's DeepSeek-V3 reranker (``models/deepseek_v3.py``,
``ops/moe.py``) against the plain fp32 reference (``plain_deepseek_v3.py``,
beside this file) at a tiny size on the CPU: the last-position logits and
scores, the LCE loss, every leaf's gradient and the parameters after one
``make_train_step`` step; the layouts with pads between segments and at
the end; the expert-parallel share of a layer; the router's correction
bias; the grouped GEMM's plain route; dispatch and combine; the device
counters; the reranker; and the two reference copies.

Tolerances: both sides compute in fp32 on the CPU, the port over the real
tokens alone and in another order of sums (fused q|k, SDPA, per-expert
segments), so values agree to ~1e-6 of their scale; each bound below is
about ten times the largest gap seen, and far below what a wrong term
moves (a dropped expert, a position off by one, a missing scale: 1e-2 and
more).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import torch

from pacednegatives_tpu_torch.models import deepseek_v3 as ds
from pacednegatives_tpu_torch.ops import moe
from pacednegatives_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


plain = _load(HERE / "plain_deepseek_v3.py", "plain_deepseek_v3")
CFG = ds.DeepseekV3Config.tiny()
TRUE, FALSE = 3, 4


def _ref_cfg(cfg: ds.DeepseekV3Config) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _params(cfg=CFG, seed=0):
    return ds.init_params(cfg, torch.Generator().manual_seed(seed))


def _prompts(B=6, seed=1, V=512):
    """(B, L) prompts with pads between their segments, as lce-b32 lays
    them out: [prefix | query (4, padded) | mid | doc (10, padded) |
    suffix + eos], and the same prompts packed to the front."""
    g = torch.Generator().manual_seed(seed)
    segs = []
    for width, lo in ((1, 1), (4, 1), (1, 1), (10, 3), (2, 2)):
        n = torch.randint(lo, width + 1, (B,), generator=g)
        ids = torch.randint(5, V, (B, width), generator=g)
        mask = (torch.arange(width)[None] < n[:, None]).long()
        segs.append((ids * mask, mask))
    ids = torch.cat([s[0] for s in segs], dim=1)
    mask = torch.cat([s[1] for s in segs], dim=1)
    order = torch.argsort(1 - mask, dim=1, stable=True)
    return ids, mask, ids.gather(1, order), mask.gather(1, order)


def _compute(params, cfg=CFG):
    return ds.unflatten_params(ds.compute_leaves(params, cfg))


def test_logits_and_scores_match_plain():
    params = _params()
    ids, mask, _, _ = _prompts()
    ref = plain.Model(_ref_cfg(CFG), ds.flatten_params(params))
    got = ds.last_logits(_compute(params), CFG, ids, mask)
    want = ref.last_logits(ids, mask)
    # fp32 both sides, other orders of summation: ~1e-6 of the logits' scale
    assert (got - want).abs().max() < 2e-5 * want.abs().max()
    s = ds.score_batch(_compute(params), CFG, ids, mask, TRUE, FALSE)
    assert torch.allclose(s, ref.score(ids, mask, TRUE, FALSE), atol=2e-5)


def test_pads_between_segments_and_at_the_end_score_the_same():
    params = _compute(_params(seed=3))
    ids, mask, pids, pmask = _prompts(seed=4)
    a = ds.last_logits(params, CFG, ids, mask)
    b = ds.last_logits(params, CFG, pids, pmask)
    # the same real tokens at the same positions: the same computation
    assert torch.equal(a, b)


def _lce_batch(n=2, B=2, seed=5):
    ids, mask, _, _ = _prompts(B * (1 + n), seed=seed)
    lab = lambda rows, tok: torch.tensor([tok, 1]).expand(rows, 2)
    return {"pos_ids": ids[:B], "pos_mask": mask[:B].int(),
            "pos_labels": lab(B, TRUE), "neg_ids": ids[B:],
            "neg_mask": mask[B:].int(), "neg_labels": lab(B * n, FALSE)}


def test_train_step_matches_plain():
    """One ``make_train_step`` step (LCE, 2 x (1 + 2)): the loss, every
    leaf's gradient (AdamW's first moment over 1 - b1, no clipping) and
    the parameters after it, against autograd through the plain
    reference and the AdamW update written out."""
    from pacednegatives_tpu_torch.optim import Adam
    from pacednegatives_tpu_torch.train.runner import RunConfig, _build_controller
    from pacednegatives_tpu_torch.train.state import init_train_state
    from pacednegatives_tpu_torch.train.step import make_train_step

    n, B, lr = 2, 2, 1e-3
    params = _params(seed=6)
    start = {k: v.clone() for k, v in ds.flatten_params(params).items()}
    run = RunConfig(curriculum="lce", batch_size=B, n=n, lr=lr,
                    total_steps=64, use_mean=False, vocab_size=CFG.vocab_size)
    controller = _build_controller(run, None, CFG.vocab_size)
    tx = Adam(lambda step: np.float32(lr))
    step = make_train_step(CFG, controller, tx, loss="lce",
                           n_neg_per_example=n, use_mean=False,
                           rel_id=TRUE, nrel_id=FALSE)
    state = init_train_state(params, tx, controller.init("cpu"))
    batch = _lce_batch(n, B)
    new, metrics = step(state, batch)

    leaves = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    ref = plain.Model(_ref_cfg(CFG), leaves)
    ids = torch.cat([batch["pos_ids"], batch["neg_ids"]])
    mask = torch.cat([batch["pos_mask"], batch["neg_mask"]])
    labels = torch.tensor([TRUE] * B + [FALSE] * (B * n))
    ce = ref.loss(ids, mask, labels)
    ex = ce[:B] + ce[B:].view(B, n).sum(1)
    ex.mean().backward()
    want_loss = float(ex.detach().mean())
    assert abs(float(metrics["loss"]) - want_loss) < 1e-5 * want_loss
    mu = ds.flatten_params(new.opt_state.mu)
    after = ds.flatten_params(new.params)
    scale = max(float(g.grad.abs().max()) for g in leaves.values()
                if g.grad is not None)
    for k, p in leaves.items():
        want = torch.zeros_like(p) if p.grad is None else p.grad
        got = mu[k] / 0.1
        # the gradient to 1e-5 of the largest leaf's
        assert (got - want).abs().max() <= 1e-5 * scale, k
        # AdamW's first step: lr * g / (|g| + eps), each coordinate; a
        # gradient's gap moves it by lr * gap / (|g| + eps)
        upd = lr * want / (want.abs() + 1e-6)
        room = lr * 1e-5 * scale / (want.abs() + 1e-6) + 1e-7
        assert ((after[k] - (start[k] - upd)).abs() <= room).all(), k
    # the correction bias gets no gradient and does not move
    for i in range(CFG.first_k_dense_replace, CFG.num_hidden_layers):
        key = f"layers.layer_{i}.router.bias"
        assert torch.equal(after[key], start[key]) and not mu[key].any()


def test_expert_parallel_shares_sum_to_the_uncut_layer():
    """The held experts' outputs of every share (one expert each), with
    the shared experts counted once, add up to the uncut reference
    layer."""
    E = CFG.n_routed_experts
    whole = dataclasses.replace(CFG, experts_held=(0, E))
    p = ds.flatten_params(_params(whole, seed=7))
    x = torch.randn(40, CFG.hidden_size, generator=torch.Generator()
                    .manual_seed(8))
    pre = "layers.layer_1"
    ref = plain.Model(_ref_cfg(whole), p).moe(pre, x[None])[0]
    shared = plain.Model(_ref_cfg(whole), p).swiglu(f"{pre}.shared", x)
    total = -(E - 1) * shared
    for e in range(E):
        cfg = dataclasses.replace(CFG, experts_held=(e, 1))
        sub = {k: v for k, v in p.items() if k.startswith(pre)}
        for name in ("gate", "up", "down"):
            sub[f"{pre}.experts.{name}"] = p[f"{pre}.experts.{name}"][e:e + 1]
        tree = ds.unflatten_params(sub)["layers"]["layer_1"]
        total = total + ds.moe_layer(tree, cfg, x)
    assert (total - ref).abs().max() < 1e-5 * ref.abs().max()


def test_correction_bias_changes_the_choice_not_the_weights():
    g = torch.Generator().manual_seed(9)
    x = torch.randn(200, 16, generator=g)
    w = torch.randn(16, 8, generator=g) * 0.25
    bias = torch.randn(8, generator=g) * 0.05
    w0, i0 = moe.route(x, w, torch.zeros(8), 3, 2.5, True)
    w1, i1 = moe.route(x, w, bias, 3, 2.5, True)
    assert (torch.sort(i0, 1).values != torch.sort(i1, 1).values).any()
    scores = torch.sigmoid(x @ w).gather(1, i1)
    assert torch.allclose(w1, 2.5 * scores / scores.sum(1, keepdim=True))
    # the weights sum to the scaling factor; the bias enters no weight
    assert torch.allclose(w1.sum(1), torch.full((200,), 2.5))


def _plan(T=50, k=3, E=8, held=6, first=1, empty=3, seed=10):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(T, E, generator=g)
    logits[:, empty] = -1e9  # an expert no token picks
    idx = torch.topk(logits, k, dim=-1).indices
    return idx, moe.dispatch_plan(idx, first, held)


def test_dispatch_plan_offsets_and_rows():
    idx, plan = _plan()
    T, k = idx.shape
    offs, counts = plan["offs"].tolist(), plan["counts"].tolist()
    assert counts[3 - 1] == 0 and offs[3] == offs[2]
    assert all(o % moe.BLOCK == 0 for o in offs)
    # the buffer ends with the last segment: sized by the pairs, not the
    # worst case
    assert plan["rows"] == offs[-1] == plan["row_pair"].shape[0]
    for e in range(6):
        rows = range(offs[e], offs[e] + counts[e])
        pairs = plan["row_pair"][list(rows)]
        assert ((idx.reshape(-1)[pairs] - 1) == e).all()
        assert (torch.diff(pairs) > 0).all()  # token order kept
    held = ((idx >= 1) & (idx < 7))
    assert int(held.sum()) == sum(counts)
    assert (plan["pair_row"][~held] == plan["rows"]).all()


def test_grouped_gemm_plain_route_and_backward():
    """The CPU route of M1 against per-expert matmuls (an expert with no
    tokens included), and its Function's gradients against autograd
    through the same loop."""
    idx, plan = _plan()
    offs = plan["offs"]
    g = torch.Generator().manual_seed(11)
    x = torch.randn(idx.shape[0], 16, generator=g)
    xs = moe.dispatch(x, plan, idx.shape[1])
    w = torch.randn(6, 16, 24, generator=g, requires_grad=True)
    xs = xs.detach().requires_grad_(True)
    y = moe.GroupedGemm.apply(xs, w, offs)
    o = offs.tolist()
    want = torch.zeros_like(y)
    for e in range(6):
        want[o[e]:o[e + 1]] = xs[o[e]:o[e + 1]] @ w[e]
    assert torch.allclose(y, want, atol=1e-6)
    assert y.shape[0] == o[-1]  # no rows past the last segment
    gy = torch.randn(y.shape, generator=g)
    gx, gw = torch.autograd.grad((y * gy).sum(), (xs, w))
    wx, ww = torch.autograd.grad((want * gy).sum(), (xs, w))
    assert torch.allclose(gx, wx, atol=1e-5)
    assert torch.allclose(gw, ww, atol=1e-5)
    assert not gw[2].any()  # the expert with no tokens


def test_a_layer_with_no_pair_on_a_held_expert():
    """Every token routed to experts held elsewhere (as a collapsed router
    does): the buffer is empty, the layer gives the shared experts alone,
    and the held experts' weights get a zero gradient."""
    cfg = dataclasses.replace(CFG, experts_held=(1, 4))  # 4 held elsewhere
    p = _params(cfg, seed=15)["layers"]["layer_1"]
    p = {k: {n: t.requires_grad_(True) for n, t in p[k].items()}
         for k in ("router", "experts", "shared")}
    first, held = cfg.experts_held
    bias = torch.zeros(cfg.n_routed_experts)
    bias[first:first + held] = -1e3  # no token picks a held expert
    p["router"]["bias"] = bias
    x = torch.randn(20, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(16))
    idx = moe.route(x, p["router"]["weight"], bias, cfg.num_experts_per_tok,
                    1.0, True)[1]
    assert moe.dispatch_plan(idx, first, held)["rows"] == 0
    y = ds.moe_layer(p, cfg, x)
    s = p["shared"]
    assert torch.equal(y, ds.swiglu(x, s["gate"], s["up"], s["down"]))
    y.square().sum().backward()
    for name in ("gate", "up", "down"):
        g = p["experts"][name].grad
        assert g is not None and not g.any()


def test_dispatch_and_combine_match_a_dense_loop():
    idx, plan = _plan()
    T, k = idx.shape
    g = torch.Generator().manual_seed(12)
    x = torch.randn(T, 8, generator=g, requires_grad=True)
    w = torch.rand(T, k, generator=g, requires_grad=True)
    E = torch.randn(6, 8, 8, generator=g)
    xs = moe.dispatch(x, plan, k)
    ys = torch.zeros_like(xs)
    o = plan["offs"].tolist()
    for e in range(6):
        ys[o[e]:o[e + 1]] = xs[o[e]:o[e + 1]] @ E[e]
    y = moe.combine(ys, w, plan)
    want = torch.zeros(T, 8)
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j]) - 1
            if 0 <= e < 6:
                want[t] += w[t, j] * (x[t] @ E[e])
    assert torch.allclose(y, want, atol=1e-5)
    gy = torch.randn(T, 8, generator=g)
    got = torch.autograd.grad((y * gy).sum(), (x, w))
    ref = torch.autograd.grad((want * gy).sum(), (x, w))
    for a, b in zip(got, ref):
        assert torch.allclose(a, b, atol=1e-5)


def test_counters_live_on_the_device_and_sync_once_a_forward():
    params = _compute(_params(seed=13))
    ids, mask, _, _ = _prompts(seed=14)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        ds.last_logits(params, CFG, ids, mask)
    rec = profiling.recorded()
    profiling.reset()
    T = int(mask.sum())
    layers = CFG.num_hidden_layers - CFG.first_k_dense_replace
    assert rec["counts"]["moe.tokens"] == layers * T
    # one read back a forward (the real-token count) and one an expert
    # layer (its dispatch buffer's size)
    assert rec["counts"]["host_syncs"] == 1 + layers
    names = [s["name"] for s in rec["spans"]]
    assert names.count("pnt.sync.deepseek.tokens") == 1
    assert names.count("pnt.sync.moe.sizes") == layers
    assert {"pnt.mla", "pnt.moe", "pnt.moe.route", "pnt.moe.dispatch",
            "pnt.moe.experts", "pnt.moe.combine",
            "pnt.moe.shared"} <= set(names)
    # the pairs routed to held experts, summed on the device
    assert 0 < rec["counts"]["moe.slots"] <= layers * T * CFG.num_experts_per_tok


def test_reranker_scores_the_model_on_the_cpu():
    from pacednegatives_tpu_torch.data import HashTokenizer, TextCorpus
    from pacednegatives_tpu_torch.data.pipeline import TokenizedStore
    from pacednegatives_tpu_torch.eval.rerank import Reranker

    corpus = TextCorpus.synthetic(num_docs=24, num_queries=3, seed=7)
    store = TokenizedStore.build(corpus, HashTokenizer(CFG.vocab_size),
                                 max_q_tokens=6, max_d_tokens=20)
    params = _params(seed=15)
    rr = Reranker(params, CFG, store, corpus, rel_id=TRUE, nrel_id=FALSE,
                  batch_size=8, device="cpu")
    qid = corpus.query_ids[0]
    docs = corpus.doc_ids[:10]
    ranked = rr.rerank({qid: docs})[qid]
    q = np.full(10, corpus.query_index[qid])
    d = np.array([corpus.doc_index[x] for x in docs])
    ids, mask = store.assemble_host(q, d)
    ref = plain.Model(_ref_cfg(CFG), ds.flatten_params(params)).score(
        torch.from_numpy(ids).long(), torch.from_numpy(mask).long(), TRUE,
        FALSE)
    order = [docs[i] for i in np.argsort(-ref.numpy(), kind="stable")]
    assert sorted(ranked) == sorted(docs)
    assert torch.allclose(torch.from_numpy(rr.score_pairs(q, d)), ref,
                          atol=2e-5)
    assert ranked == order


def test_the_benchmarks_reference_copy_agrees_bitwise():
    root = HERE.parent
    bench = _load(root / "benchmarks" / "reference" / "deepseek_v3.py",
                  "bench_deepseek_v3")
    params = ds.flatten_params(_params(seed=16))
    ids, mask, _, _ = _prompts(seed=17)
    labels = torch.full((ids.shape[0],), TRUE)
    for precision in ("fp32", "fp8"):
        a = plain.Model(_ref_cfg(CFG), params, precision)
        b = bench.Model(_ref_cfg(CFG), params, precision)
        assert torch.equal(a.loss(ids, mask, labels),
                           b.loss(ids, mask, labels))
        assert torch.equal(a.score(ids, mask, TRUE, FALSE),
                           b.score(ids, mask, TRUE, FALSE))
