"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (Hopper, sm_90a) and skip elsewhere. The
machine with the card has no JAX, so run them without the repo's conftest
(which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are small and ragged on purpose (lengths that are not multiples of
the kernels' 64-row tiles); chip_smoke.py checks the serving shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pacednegatives_tpu_torch.curriculum import EtaController
from pacednegatives_tpu_torch.data import HashTokenizer, TextCorpus, TokenizedStore
from pacednegatives_tpu_torch.data.device_corpus import DeviceCorpus
from pacednegatives_tpu_torch.data.triples import TripletStore
from pacednegatives_tpu_torch.eval.rerank import Reranker
from pacednegatives_tpu_torch.models import t5
from pacednegatives_tpu_torch.ops import flash, flash_v3, gemm
from pacednegatives_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(300, 136, 200), (128, 768, 2304), (7, 8, 8)])
def test_gemm_matches_plain(cuda, M, K, N):
    a, b = _randn(cuda, M, K), _randn(cuda, K, N, scale=K**-0.5)
    before = gemm.gemm.launches
    c = gemm.gemm(a, b)
    ref = gemm.gemm_plain(a, b)
    torch.cuda.synchronize()
    assert gemm.gemm.launches == before + 1
    # one bf16 ulp of the largest value: both round an fp32 sum once
    tol = 2.0**-7 * ref.float().abs().max().item()
    assert (c.float() - ref.float()).abs().max().item() <= tol


def test_gemm_raises_on_what_it_cannot_take(cuda):
    a = _randn(cuda, 16, 16)
    with pytest.raises(TypeError):
        gemm.gemm(a.float(), a.float())
    with pytest.raises(ValueError):
        gemm.gemm(a[:, :12], _randn(cuda, 12, 16))  # row stride 16, K = 12
    with pytest.raises(ValueError):
        gemm.gemm(a, a.cpu())


@pytest.mark.parametrize("Lq,Lk,dk", [(72, 72, 64), (130, 130, 128),
                                      (33, 33, 64), (40, 100, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_attention_matches_plain(cuda, Lq, Lk, dk, out_dtype):
    B, H = 3, 2
    q = _randn(cuda, B, H, Lq, dk)
    k, v = (_randn(cuda, B, H, Lk, dk) for _ in range(2))
    pos = torch.randn((H, Lq, Lk), generator=cuda, device="cuda") * 0.5
    lens = torch.tensor([Lk, Lk // 2, 1], device="cuda")
    km = torch.where(torch.arange(Lk, device="cuda")[None] < lens[:, None],
                     0.0, flash.NEG_INF).float()
    out, m, l = flash.flash_attention_forward(q, k, v, pos, km, out_dtype)
    ref, rm, rl = flash.flash_attention_forward_plain(q, k, v, pos, km,
                                                      out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == out_dtype
    # bf16 rounding of p (+ one bf16 rounding of out when it is bf16)
    tol = 2e-2 + (2.0**-8 * ref.float().abs().max().item()
                  if out_dtype == torch.bfloat16 else 0.0)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() / rl).max().item() <= 1e-3


def test_attention_raises_on_what_it_cannot_take(cuda):
    q = _randn(cuda, 1, 1, 64, 32)
    pos = torch.zeros((1, 64, 64), device="cuda")
    km = torch.zeros((1, 64), device="cuda")
    with pytest.raises(ValueError, match="dk"):
        flash.flash_attention_forward(q, q, q, pos, km)
    q = _randn(cuda, 1, 1, 64, 64)
    with pytest.raises(TypeError):
        flash.flash_attention_forward(q.float(), q.float(), q.float(), pos, km)
    with pytest.raises(ValueError, match="pos"):
        flash.flash_attention_forward(q, q, q, pos.double(), km)


@pytest.mark.parametrize("L", [64, 100])
def test_fused_self_attention_matches_plain(cuda, L):
    B, D, H, dk = 2, 256, 4, 64
    inner = H * dk
    x = _randn(cuda, B, L, D)
    wqkv = _randn(cuda, D, 3 * inner, scale=D**-0.5)
    wo = _randn(cuda, inner, D, scale=inner**-0.5)
    pos3 = torch.randn((H, L, L), generator=cuda, device="cuda") * 0.3
    km = torch.zeros((B, L), device="cuda")
    km[1, L // 2:] = flash.NEG_INF
    before = (gemm.gemm.launches, flash.flash_attention_forward.launches)
    y = flash_v3.fused_self_attention(x, wqkv, wo, pos3, km)
    ref = flash_v3.fused_self_attention_plain(x, wqkv, wo, pos3, km)
    torch.cuda.synchronize()
    assert (gemm.gemm.launches, flash.flash_attention_forward.launches) == \
        (before[0] + 2, before[1] + 1)
    tol = 2.0**-5 * ref.float().abs().max().item()
    assert (y.float() - ref.float()).abs().max().item() <= tol


def test_small_rerank_matches_cpu(cuda):
    """The whole slice at a small width: GPU kernels vs CPU plain versions,
    bf16 on both, within bf16 noise; packed + bucketed, so both the dense
    path (bucket 32) and the kernels run."""
    cfg = t5.T5Config(vocab_size=512, d_model=128, d_kv=64, d_ff=256,
                      num_heads=2, num_layers=2, num_decoder_layers=2,
                      dtype=torch.bfloat16, flash_v3=True)
    params = t5.init_params(cfg, torch.Generator().manual_seed(0))
    tok = HashTokenizer(512)
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(200)]
    lens = np.clip(rng.lognormal(3.4, 0.6, size=48).astype(int), 5, 70)
    corpus = TextCorpus([f"d{i}" for i in range(48)],
                        [" ".join(rng.choice(words, size=n)) for n in lens],
                        ["q0", "q1"], ["w1 w2 w3", "w4 w5"])
    store = TokenizedStore.build(corpus, tok, max_q_tokens=8, max_d_tokens=72)
    kw = dict(rel_id=3, nrel_id=4, batch_size=16, packed=True,
              bucket_lens=tuple(range(32, store.prompt_len, 32)))
    q_rows = np.repeat([0, 1], 24)
    d_rows = np.arange(48)
    gpu = Reranker(params, cfg, store, corpus, device="cuda", **kw)
    cpu = Reranker(params, cfg, store, corpus, device="cpu", **kw)
    before = flash.flash_attention_forward.launches
    s_gpu = gpu.score_pairs(q_rows, d_rows)
    n_kernel = sum(b >= 64 for _, b in gpu._bucket_plan(q_rows, d_rows))
    assert flash.flash_attention_forward.launches - before == \
        cfg.num_layers * n_kernel > 0
    s_cpu = cpu.score_pairs(q_rows, d_rows)
    assert np.isfinite(s_gpu).all()
    assert np.abs(s_gpu - s_cpu).max() <= 5e-2


def _bwd_inputs(g, B, H, L, dk):
    qkv = _randn(g, B, L, 3, H, dk)
    q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    dout = _randn(g, B, L, H, dk).transpose(1, 2)
    pos = torch.randn((H, L, L), generator=g, device="cuda") * 0.5
    lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lens[0] = L
    km = torch.where(torch.arange(L, device="cuda")[None] < lens[:, None],
                     0.0, flash.NEG_INF).float()
    _, m, l = flash.flash_attention_forward(q, k, v, pos, km)
    return q, k, v, dout, pos, km, m, l


@pytest.mark.parametrize("B,H,L,dk", [(5, 2, 72, 64), (2, 3, 130, 128),
                                      (1, 1, 33, 64)])
def test_attention_backward_matches_plain(cuda, B, H, L, dk):
    """The backward core against its plain version at ragged lengths and
    batch sizes that leave a partial dpos group (4 rows per group).
    Tolerance: 2 bf16 ulps of each output's largest magnitude (both round
    fp32 sums once, in another order); dpos 1e-3 of its largest."""
    args = _bwd_inputs(cuda, B, H, L, dk)
    before = flash.attention_backward.launches
    got = flash.attention_backward(*args)
    ref = flash.attention_backward_plain(*args)
    torch.cuda.synchronize()
    assert flash.attention_backward.launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv", "out"), got[:4], ref[:4]):
        assert a.dtype == torch.bfloat16, name
        tol = 2 * 2.0**-7 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol, name
    scale = ref[4].abs().max().item()
    assert (got[4] - ref[4]).abs().max().item() <= 1e-3 * scale


def test_attention_backward_dpos_is_deterministic(cuda):
    args = _bwd_inputs(cuda, 9, 2, 100, 64)
    first = flash.attention_backward(*args)
    second = flash.attention_backward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_backward_raises_on_what_it_cannot_take(cuda):
    q, k, v, dout, pos, km, m, l = _bwd_inputs(cuda, 1, 1, 64, 64)
    with pytest.raises(ValueError, match="m must"):
        flash.attention_backward(q, k, v, dout, pos, km, m.double(), l)
    with pytest.raises(TypeError):
        flash.attention_backward(q, k, v, dout, pos, km, m, l,
                                 out=torch.empty_like(q, dtype=torch.float32))


@pytest.mark.parametrize("L", [64, 100])
def test_v3_backward_and_autograd_match_plain(cuda, L):
    """K4 (GEMM + backward core) against its plain version, and the
    autograd Function's gradients through both kernels against autograd
    through the plain forward."""
    B, D, H, dk = 3, 256, 4, 64
    inner = H * dk
    x = _randn(cuda, B, L, D)
    wqkv = _randn(cuda, D, 3 * inner, scale=D**-0.5)
    wo = _randn(cuda, inner, D, scale=inner**-0.5)
    pos3 = torch.randn((H, L, L), generator=cuda, device="cuda") * 0.3
    km = torch.zeros((B, L), device="cuda")
    km[1, L // 2:] = flash.NEG_INF
    _, m, l = flash_v3.v3_forward(x, wqkv, wo, pos3, km)
    d_attn = _randn(cuda, B, L, inner)
    got = flash_v3.v3_backward(x, wqkv, pos3, km, m, l, d_attn)
    ref = flash_v3.v3_backward_plain(x, wqkv, pos3, km, m, l, d_attn)
    for a, b in zip(got[:2], ref[:2]):
        tol = 2 * 2.0**-7 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol
    assert (got[2] - ref[2]).abs().max().item() <= \
        1e-3 * ref[2].abs().max().item()
    cot = _randn(cuda, B, L, D)
    grads = []
    for fn in (flash_v3.fused_self_attention,
               flash_v3.fused_self_attention_plain):
        leaves = [t.detach().float().requires_grad_() for t in (x, wqkv, wo)]
        p = pos3.clone().requires_grad_()
        y = fn(*(t.to(torch.bfloat16) for t in leaves), p, km)
        (y.float() * cot.float()).sum().backward()
        grads.append([t.grad for t in leaves] + [p.grad])
    # bf16 products on both routes, rounded at different points: a few
    # percent of each gradient's norm
    for a, b in zip(*grads):
        assert ((a - b).norm() / b.norm()).item() <= 5e-2


def test_train_step_kernels_match_dense(cuda):
    """One LCE step at a small width: flash_v3 (K3 + K4 kernels) against
    the dense route on the same weights and batch, both bf16."""
    tok = HashTokenizer(vocab_size=512)
    corpus = TextCorpus.synthetic(num_docs=32, num_queries=8, seed=0,
                                  doc_len=60, query_len=8)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=12,
                                 max_d_tokens=60)
    dc = DeviceCorpus.build(store, TripletStore.synthetic(corpus, 16, 10),
                            device="cuda")
    cfg0 = t5.T5Config(vocab_size=512, d_model=128, d_kv=64, d_ff=256,
                       num_heads=2, num_layers=2, num_decoder_layers=2,
                       dtype=torch.bfloat16, fused_qkv=True)
    params = t5.init_params(cfg0, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    ctrl = EtaController(eta0=2.0, meta_lr=0.01, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=18.7)
    batch = dc.lce_batch(torch.Generator(device="cuda").manual_seed(1),
                         torch.arange(4, device="cuda"), 0.5, 3)
    out = []
    for v3 in (True, False):
        tx = make_optimizer(1e-2, total_steps=8, warmup_steps=1)
        step = make_train_step(dataclasses.replace(cfg0, flash_v3=v3), ctrl,
                               tx, loss="lce", n_neg_per_example=3,
                               rel_id=tok.true_id, nrel_id=tok.false_id)
        before = flash.attention_backward.launches
        state, metrics = step(init_train_state(params, tx, ctrl.init("cuda")),
                              batch)
        torch.cuda.synchronize()
        assert flash.attention_backward.launches - before == (2 if v3 else 0)
        out.append((metrics["loss"].item(), t5.flatten_params(
            state.opt_state.mu)))
    (l_on, mu_on), (l_off, mu_off) = out
    # bf16 rounding noise between the routes (chip_smoke.py's tolerances)
    assert np.isfinite(l_on) and abs(l_on - l_off) <= 1e-2 * abs(l_off)
    rel = [((mu_on[k] - b).norm() / b.norm()).item()
           for k, b in mu_off.items() if b.norm() > 0]
    assert max(rel) <= 0.15 and float(np.median(rel)) <= 0.05
