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
from pacednegatives_tpu_torch.models import quant
from pacednegatives_tpu_torch.ops import flash, flash_v3, gemm, mips
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


def _own_generator(seed: int) -> torch.Generator:
    """A generator of the test's own: the tests added after the others draw
    from it, so the earlier tests keep the inputs the shared one gives
    them."""
    return torch.Generator(device="cuda").manual_seed(seed)


def _attention_inputs(g, B, H, Lq, Lk, dk, fused=False):
    """bf16 q/k/v (as views of one fused (B, L, 3, H, dk) buffer when
    ``fused``), pos and a key mask with lengths Lk, Lk // 2 and 1."""
    if fused:
        assert Lq == Lk
        qkv = _randn(g, B, Lq, 3, H, dk)
        q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    else:
        q = _randn(g, B, H, Lq, dk)
        k, v = (_randn(g, B, H, Lk, dk) for _ in range(2))
    pos = torch.randn((H, Lq, Lk), generator=g, device="cuda") * 0.5
    lens = torch.tensor([Lk, max(Lk // 2, 1), 1][:B], device="cuda")
    km = torch.where(torch.arange(Lk, device="cuda")[None] < lens[:, None],
                     0.0, flash.NEG_INF).float()
    return q, k, v, pos, km


def _assert_attention_close(got, ref):
    """The tolerances of test_attention_matches_plain."""
    (out, m, l), (rout, rm, rl) = got, ref
    tol = 2e-2 + (2.0**-8 * rout.float().abs().max().item()
                  if out.dtype == torch.bfloat16 else 0.0)
    assert (out.float() - rout.float()).abs().max().item() <= tol
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() / rl).max().item() <= 1e-3


# one key tile and a partial one, a full 64-row tile plus one row, the
# refresh and serving lengths (ragged query tiles), the chunked length
@pytest.mark.parametrize("L", [1, 60, 65, 160, 188, 200, 512])
def test_attention_lengths(cuda, L):
    args = _attention_inputs(_own_generator(L), 3, 2, L, L, 64)
    before = flash.flash_attention_forward.launches
    got = flash.flash_attention_forward(*args, torch.float32)
    ref = flash.flash_attention_forward_plain(*args, torch.float32)
    torch.cuda.synchronize()
    assert flash.flash_attention_forward.launches == before + 1
    _assert_attention_close(got, ref)


# Lk 33: pos rows of 132 bytes, not 16-byte aligned (read a float at a
# time); Lq != Lk both ways
@pytest.mark.parametrize("Lq,Lk", [(33, 33), (100, 33), (20, 33), (200, 70)])
def test_attention_unaligned_pos_and_unequal_lengths(cuda, Lq, Lk):
    args = _attention_inputs(_own_generator(Lq + Lk), 3, 2, Lq, Lk, 64)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = flash.flash_attention_forward(*args, out_dtype)
        ref = flash.flash_attention_forward_plain(*args, out_dtype)
        torch.cuda.synchronize()
        _assert_attention_close(got, ref)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,L", [(128, 130), (64, 188)])
def test_attention_fused_views_transposed_out_and_repeats(cuda, out_dtype,
                                                          dk, L):
    """q/k/v as views into one fused (B, L, 3, H, dk) buffer (K3's layout),
    the output written into a transposed view of a (B, L, H, dk) buffer,
    dk 64 and 128; two runs give the same bits, and nothing outside the
    view is written."""
    B, H = 3, 3
    q, k, v, pos, km = _attention_inputs(_own_generator(dk + L), B, H, L, L,
                                         dk, fused=True)
    runs = []
    for _ in range(2):
        buf = torch.full((B, L, H + 1, dk), 7.0, dtype=out_dtype,
                         device="cuda")
        view = buf[:, :, :H].transpose(1, 2)
        out, m, l = flash.flash_attention_forward(q, k, v, pos, km, out=view)
        assert out.data_ptr() == view.data_ptr()
        runs.append((buf, m, l))
    ref = flash.flash_attention_forward_plain(q, k, v, pos, km, out_dtype)
    torch.cuda.synchronize()
    (buf, m, l), (buf2, m2, l2) = runs
    assert torch.equal(buf, buf2) and torch.equal(m, m2) and \
        torch.equal(l, l2)
    assert bool((buf[:, :, H] == 7.0).all())
    _assert_attention_close((buf[:, :, :H].transpose(1, 2), m, l), ref)


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


@pytest.mark.parametrize("shape,N", [((8, 1, 768), 2304),
                                     ((12, 768), 768),
                                     ((4, 45, 64), 96),
                                     ((2, 188, 768), 3072)])
def test_int8_linear_on_card_matches_cpu(cuda, shape, N):
    """``torch._int_mm`` on the card (cuBLASLt) against the CPU: the same
    int8 codes, an exact int32 accumulator and the same fp32 scale
    multiplies, so the outputs agree to fp32 rounding. (8, 1, 768) and
    (12, 768) have fewer rows than cuBLASLt takes (the decoder's
    one-position rows at a small batch): ``int8_linear`` pads them."""
    x = torch.randn(shape, generator=cuda, device="cuda") * 2.0
    w = torch.randn((shape[-1], N), generator=cuda, device="cuda") * 0.05
    qw = quant._quantize_weight(w)
    got = quant.int8_linear(x, qw)
    ref = quant.int8_linear(x.cpu(), {k: v.cpu() for k, v in qw.items()})
    assert torch.equal(quant._quantize_tokens(x)[0].cpu(),
                       quant._quantize_tokens(x.cpu())[0])
    assert got.shape == shape[:-1] + (N,) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=0)


def test_int8_rerank_matches_cpu(cuda):
    """``Reranker(int8=True)`` on the card against the CPU at a small
    width, batch 8 (the decoder's int8 products then have 8 rows, padded
    for cuBLASLt), packed with length buckets. Tolerance 2e-2 on
    log-probs: the int32 products are exact on both, but the fp32
    attention products and softmax sum in another order, which can move a
    bf16-rounded operand by an ulp and flip int8 codes downstream."""
    cfg = t5.T5Config(vocab_size=512, d_model=128, d_kv=64, d_ff=256,
                      num_heads=2, num_layers=2, num_decoder_layers=2,
                      dtype=torch.bfloat16, flash_v3=True)
    params = t5.init_params(cfg, torch.Generator().manual_seed(0))
    corpus = TextCorpus.synthetic(num_docs=48, num_queries=2, seed=0,
                                  doc_len=40, query_len=4)
    store = TokenizedStore.build(corpus, HashTokenizer(512), max_q_tokens=8,
                                 max_d_tokens=72)
    kw = dict(rel_id=3, nrel_id=4, batch_size=8, int8=True, packed=True,
              bucket_lens=tuple(range(32, store.prompt_len, 32)))
    q_rows = np.repeat([0, 1], 24)
    d_rows = np.arange(48)
    gpu = Reranker(params, cfg, store, corpus, device="cuda", **kw)
    cpu = Reranker(params, cfg, store, corpus, device="cpu", **kw)
    before = (flash.flash_attention_forward.launches, gemm.gemm.launches)
    s_gpu = gpu.score_pairs(q_rows, d_rows)
    assert (flash.flash_attention_forward.launches,
            gemm.gemm.launches) == before  # no hand kernel on this path
    s_cpu = cpu.score_pairs(q_rows, d_rows)
    assert np.isfinite(s_gpu).all()
    assert np.abs(s_gpu - s_cpu).max() <= 2e-2


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
    fp32 sums once, in another order); dpos within the elementwise bound
    of ``flash.dpos_error_bound``."""
    args = _bwd_inputs(cuda, B, H, L, dk)
    before = flash.attention_backward.launches
    got = flash.attention_backward(*args)
    ref = flash.attention_backward_plain(*args)
    torch.cuda.synchronize()
    assert flash.attention_backward.launches == before + 1
    _assert_k4_close(got, ref, args)


def _assert_k4_close(got, ref, args):
    """K4 core's tolerances: dq, dk, dv, out within 2 bf16 ulps of each
    output's largest magnitude; dpos within the elementwise bound."""
    for name, a, b in zip(("dq", "dk", "dv", "out"), got[:4], ref[:4]):
        assert a.dtype == torch.bfloat16, name
        tol = 2 * 2.0**-7 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol, name
    _assert_dpos_within_bound(got[4], ref[4], args)


def _assert_dpos_within_bound(dpos, ref, args, dcap=None):
    """|dpos - ref| <= flash.dpos_error_bound elementwise; args are K4's
    (q, k, v, g, pos, key_mask, m, l)."""
    bound = flash.dpos_error_bound(*args, dcap)
    err = (dpos.double() - ref.double()).abs()
    worst = float((err / bound.clamp_min(1e-300)).max())
    assert bool((err <= bound).all()), f"dpos error / bound {worst}"


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
    # dpos against the plain core on the kernel GEMM's q/k/v (the plain
    # GEMM may round them one bf16 ulp apart), within the elementwise bound
    qkv = gemm.gemm(x.reshape(B * L, D), wqkv).view(B, L, 3, H, dk)
    q, k, v = (qkv[:, :, t].transpose(1, 2) for t in range(3))
    core = (q, k, v, d_attn.view(B, L, H, dk).transpose(1, 2), pos3, km, m, l)
    _assert_dpos_within_bound(got[2], flash.attention_backward_plain(*core)[4],
                              core)
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


def _core_bwd_inputs(g, B, H, Lq, Lk, dk):
    q = _randn(g, B, H, Lq, dk)
    k, v = (_randn(g, B, H, Lk, dk) for _ in range(2))
    pos = torch.randn((H, Lq, Lk), generator=g, device="cuda") * 0.5
    lens = torch.randint(1, Lk + 1, (B,), generator=g, device="cuda")
    lens[0] = Lk
    km = torch.where(torch.arange(Lk, device="cuda")[None] < lens[:, None],
                     0.0, flash.NEG_INF).float()
    out, m, l = flash.flash_attention_forward(q, k, v, pos, km, torch.float32)
    gout = torch.randn((B, H, Lq, dk), generator=g, device="cuda")
    dcap = (gout * out).sum(dim=-1)
    return q, k, v, pos, km, m, l, dcap, gout


_CORE_SHAPES = [(5, 2, 128, 128, 64), (2, 3, 256, 128, 128),
                (3, 2, 72, 100, 64)]
# K2a's split-bf16 kernels: the L 768 path's shape (two key chunks in the
# dq pass), dk 128 (four chunks of 192 keys; 64-column halves in the dk/dv
# pass), Lq != Lk with ragged chunks, pos rows that TMA cannot take (Lk
# 130), and batches of 1, 5 and 9 (one, two and three dpos groups of 4, the
# last partial)
_K2A_SHAPES = [(8, 12, 768, 768, 64), (2, 3, 768, 768, 128),
               (3, 2, 300, 520, 64), (1, 2, 130, 200, 128),
               (5, 2, 200, 130, 64), (9, 2, 128, 600, 64)]


@pytest.mark.parametrize(
    "kernel,B,H,Lq,Lk,dk",
    [(kernel, *shape) for kernel in ("k2b", "k2a") for shape in _CORE_SHAPES]
    + [("k2a", *shape) for shape in _K2A_SHAPES])
def test_core_backward_matches_plain(cuda, kernel, B, H, Lq, Lk, dk):
    """K2b / K2a against their plain versions, at aligned, Lq != Lk and
    ragged shapes, with batch sizes that leave a partial dpos group.
    Tolerances (fp32 outputs): K2b one bf16 ulp of each output's largest
    magnitude (its operands round to bf16 on both sides and may round one
    ulp apart), K2a 1e-4 of it (fp32 operands: three bf16 terms each on the
    card, which hold them exactly but for dV's dropped cross terms, 2^-23
    of sum p|g|; so summation order and the MUFU's exp and 1 / l); dpos
    within the elementwise bound (K2b) or 1e-4 of its largest (K2a). Two
    runs give the same bits. The K2a shapes draw from a generator of their
    own, so the tests after them keep their inputs."""
    fn, plain, tol = {
        "k2b": (flash.flash_attention_backward_v2,
                flash.flash_attention_backward_v2_plain, 2.0**-7),
        "k2a": (flash.flash_attention_backward,
                flash.flash_attention_backward_plain, 1e-4),
    }[kernel]
    g = cuda
    if (B, H, Lq, Lk, dk) in _K2A_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B * 10_000 + Lk)
    args = _core_bwd_inputs(g, B, H, Lq, Lk, dk)
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), name
    if kernel == "k2b":
        _assert_k2b_dpos(got[3], ref[3], args)
    else:
        assert (got[3] - ref[3]).abs().max().item() <= \
            1e-4 * ref[3].abs().max().item()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _assert_k2b_dpos(dpos, ref, args):
    q, k, v, pos, km, m, l, dcap, gout = args
    _assert_dpos_within_bound(dpos, ref, (q, k, v, gout, pos, km, m, l),
                              dcap)


def test_core_backward_raises_on_what_it_cannot_take(cuda):
    q, k, v, pos, km, m, l, dcap, gout = _core_bwd_inputs(cuda, 1, 1, 64, 64,
                                                          64)
    with pytest.raises(TypeError, match="g must be float32"):
        flash.flash_attention_backward_v2(q, k, v, pos, km, m, l, dcap,
                                          gout.to(torch.bfloat16))
    with pytest.raises(TypeError):
        flash.flash_attention_backward(q.float(), k.float(), v.float(), pos,
                                       km, m, l, dcap, gout)
    with pytest.raises(ValueError, match="dcap"):
        flash.flash_attention_backward(q, k, v, pos, km, m, l, dcap[:, :, :8],
                                       gout)


# ---------------------------------------------------------------------------
# K4's core and K2b on the TMA + wgmma kernels: lengths, dk 128, dpos
# groups, fused-qkv views, repeats (own generators: the tests above keep
# the inputs the shared one gives them)
# ---------------------------------------------------------------------------


def _k4_views(B, H, L, dk):
    """Fresh fused output buffers, d_qkv (B, L, 3, H, dk) and attn
    (B, L, H, dk), filled with 7, and the views K4's core writes into, as
    the fused block passes them."""
    dqkv = torch.full((B, L, 3, H, dk), 7.0, dtype=torch.bfloat16,
                      device="cuda")
    attn = torch.full((B, L, H, dk), 7.0, dtype=torch.bfloat16, device="cuda")
    views = dict(zip(("dq", "dk", "dv"),
                     (dqkv[:, :, t].transpose(1, 2) for t in range(3))))
    return dict(views, out=attn.transpose(1, 2)), (dqkv, attn)


def _check_k4_case(g, B, H, L, dk):
    """K4's core (q/k/v/g as fused views, outputs into fused views) twice
    against its plain version: tolerances, launches, and the same bits."""
    args = _bwd_inputs(g, B, H, L, dk)
    before = flash.attention_backward.launches
    runs = []
    for _ in range(2):
        outs, bufs = _k4_views(B, H, L, dk)
        runs.append((flash.attention_backward(*args, **outs), bufs))
    ref = flash.attention_backward_plain(*args)
    torch.cuda.synchronize()
    assert flash.attention_backward.launches == before + 2
    (got, bufs), (again, bufs2) = runs
    assert got[0].data_ptr() == bufs[0].data_ptr()
    # dq and dk: 2 bf16 ulps of the largest, plus ds's own fp32 noise
    # carried through the product (at L 1 a row's only p is 1 and
    # ds = p (dp - delta) is a cancellation to noise)
    ds_bound = flash.ds_error_bound(*args)[0]
    q, k = (t.double().abs() for t in args[:2])
    floors = {"dq": torch.matmul(ds_bound, k).max().item(),
              "dk": torch.matmul(ds_bound.transpose(-1, -2), q).max().item()}
    for name, a, b in zip(("dq", "dk", "dv", "out"), got[:4], ref[:4]):
        tol = 2 * 2.0**-7 * b.float().abs().max().item() + floors.get(name, 0)
        assert (a.float() - b.float()).abs().max().item() <= tol, name
    _assert_dpos_within_bound(got[4], ref[4], args)
    for a, b in zip(bufs + (got[4],), bufs2 + (again[4],)):
        assert torch.equal(a, b)


# one key tile, Lk 33 and 130 (pos rows that are not 16-byte multiples),
# a 64-row tile plus one, the training length, 200, and 512; B 5 leaves a
# partial dpos group (4 + 1 rows)
@pytest.mark.parametrize("L", [1, 33, 65, 130, 188, 200, 512])
def test_attention_backward_lengths_fused_views(cuda, L):
    _check_k4_case(_own_generator(1000 + L), 5, 2, L, 64)


# dk 128 (two 64-column boxes a tile; at L 512 the dpos band does not fit
# shared memory and lives in the partial slab), and batch sizes of one
# group (written straight to dpos), a full group, and 2-3 groups
@pytest.mark.parametrize("B,H,L,dk", [(3, 2, 130, 128), (2, 2, 512, 128),
                                      (1, 3, 100, 64), (4, 2, 188, 64),
                                      (9, 2, 72, 64), (10, 1, 512, 64)])
def test_attention_backward_dk128_and_groups(cuda, B, H, L, dk):
    _check_k4_case(_own_generator(2000 + B * L + dk), B, H, L, dk)


def test_attention_backward_dpos_bound_random_draws(cuda):
    """60 random draws of the (5, 2, 72, 64) case: dpos within the
    elementwise bound on every one (the old 1e-3-of-max tolerance failed
    on about one draw in four)."""
    gen = _own_generator(3000)
    for _ in range(60):
        args = _bwd_inputs(gen, 5, 2, 72, 64)
        got = flash.attention_backward(*args)
        ref = flash.attention_backward_plain(*args)
        torch.cuda.synchronize()
        _assert_k4_close(got, ref, args)


# K2b: the same lengths, Lq != Lk both ways (and an unaligned pos row),
# dk 128 (global dpos band at 512), one group and several
@pytest.mark.parametrize("B,H,Lq,Lk,dk", [
    (5, 2, 1, 1, 64), (5, 2, 33, 33, 64), (5, 2, 65, 65, 64),
    (5, 2, 130, 130, 64), (5, 2, 188, 188, 64), (5, 2, 200, 200, 64),
    (5, 2, 512, 512, 64), (3, 2, 72, 100, 64), (3, 2, 200, 70, 64),
    (3, 2, 40, 130, 64), (2, 2, 512, 512, 128), (1, 2, 256, 128, 128),
    (9, 2, 128, 128, 64),
])
def test_core_backward_v2_shapes(cuda, B, H, Lq, Lk, dk):
    fn = flash.flash_attention_backward_v2
    args = _core_bwd_inputs(_own_generator(4000 + B + Lq + 7 * Lk + dk), B,
                            H, Lq, Lk, dk)
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    ref = flash.flash_attention_backward_v2_plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert (a - b).abs().max().item() <= \
            2.0**-7 * b.abs().max().item(), name
    _assert_k2b_dpos(got[3], ref[3], args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_chunked_step_kernels_match_plain(cuda):
    """One LCE step with chunked attention at a small width and L 128:
    the kernel route (K1 + K2b, bf16 residual and carry, 2 microbatches)
    against the plain chunked route on the same weights and batch."""
    tok = HashTokenizer(vocab_size=512)
    corpus = TextCorpus.synthetic(num_docs=32, num_queries=8, seed=0,
                                  doc_len=100, query_len=8)
    store = TokenizedStore.build(corpus, tok, max_q_tokens=12,
                                 max_d_tokens=112)
    assert store.prompt_len == 128
    dc = DeviceCorpus.build(store, TripletStore.synthetic(corpus, 16, 10),
                            device="cuda")
    cfg0 = t5.T5Config(vocab_size=512, d_model=128, d_kv=64, d_ff=256,
                       num_heads=2, num_layers=2, num_decoder_layers=2,
                       dtype=torch.bfloat16, fused_qkv=True,
                       attention_impl="chunked", attention_chunk=128,
                       attn_residual_dtype="bf16")
    params = t5.init_params(cfg0, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    ctrl = EtaController(eta0=2.0, meta_lr=0.01, warmup_steps=1,
                         total_steps=8, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=18.7)
    batch = dc.lce_batch(torch.Generator(device="cuda").manual_seed(1),
                         torch.arange(4, device="cuda"), 0.5, 3)
    counters = (flash.flash_attention_forward,
                flash.flash_attention_backward_v2,
                flash.flash_attention_backward)
    out = []
    for kernel in (True, False):
        tx = make_optimizer(1e-2, total_steps=8, warmup_steps=1)
        step = make_train_step(dataclasses.replace(cfg0, flash_kernel=kernel),
                               ctrl, tx, loss="lce", n_neg_per_example=3,
                               rel_id=tok.true_id, nrel_id=tok.false_id,
                               microbatches=2, grad_accum_dtype="bf16")
        before = [c.launches for c in counters]
        state, metrics = step(init_train_state(params, tx, ctrl.init("cuda")),
                              batch)
        torch.cuda.synchronize()
        used = [c.launches - b for c, b in zip(counters, before)]
        # K1 and K2b once per encoder layer and microbatch, K2a never
        assert used == ([4, 4, 0] if kernel else [0, 0, 0])
        out.append((metrics["loss"].item(), t5.flatten_params(
            state.opt_state.mu)))
    (l_on, mu_on), (l_off, mu_off) = out
    # bf16 rounding noise between the routes (chip_smoke.py's tolerances)
    assert np.isfinite(l_on) and abs(l_on - l_off) <= 1e-2 * abs(l_off)
    rel = [((mu_on[k] - b).norm() / b.norm()).item()
           for k, b in mu_off.items() if b.norm() > 0]
    assert max(rel) <= 0.15 and float(np.median(rel)) <= 0.05


# ---------------------------------------------------------------------------
# K5 / K6: blockwise MIPS top-k (csrc/mips_topk.cu)
# ---------------------------------------------------------------------------


def _mips_inputs(g, B, N, D, dtype):
    q = torch.randn((B, D), generator=g, device="cuda")
    docs = torch.randn((N, D), generator=g, device="cuda")
    if dtype == "int8":
        vals, scales = mips.quantize_embeddings(docs)
        return q, (vals, scales)
    return q, (docs.to(torch.bfloat16) if dtype == "bf16" else docs,)


def _mips_pair(dtype):
    if dtype == "int8":
        return (mips.mips_topk_pallas_quantized,
                mips.mips_topk_pallas_quantized_plain)
    return mips.mips_topk_pallas, mips.mips_topk_pallas_plain


# ragged query tiles (B 20 = 16 + 4), a block that is not a multiple of the
# kernel's 128-doc chunk (384), k' < k and k' = k, and the 1024-long list
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("B,N,D,k,block_n,kpb", [
    (20, 1536, 64, 16, 384, 5), (3, 1024, 96, 40, 256, None),
    (16, 2048, 768, 129, 1024, 32), (5, 2048, 64, 1000, 1024, None),
])
def test_mips_topk_matches_plain(cuda, dtype, B, N, D, k, block_n, kpb):
    q, docs = _mips_inputs(cuda, B, N, D, dtype)
    fn, plain = _mips_pair(dtype)
    before = fn.launches
    v, i = fn(q, *docs, k, block_n=block_n, k_per_block=kpb)
    again = fn(q, *docs, k, block_n=block_n, k_per_block=kpb)
    rv, ri = plain(q, *docs, k, block_n=block_n, k_per_block=kpb)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(v, again[0]) and torch.equal(i, again[1])  # bitwise
    # fp32 sums in another order: D terms, |q| ~ |d| ~ sqrt(D)
    tol = D * 2.0**-23 * D
    assert (v - rv).abs().max().item() <= tol
    assert i.dtype == torch.int64
    # indices equal, except near-ties: where they differ, the kernel's doc
    # scores (plain arithmetic) within tol of the plain version's there
    rows, cols = (i != ri).nonzero(as_tuple=True)
    if len(rows):
        s = mips.block_scores(q, *(t[i[rows, cols]] for t in docs))
        s = s[rows, torch.arange(len(rows), device=s.device)]
        assert (s - rv[rows, cols]).abs().max().item() <= tol
    assert len(rows) <= 0.01 * i.numel()


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_mips_topk_ties_lower_index_first(cuda, dtype):
    """Duplicated rows inside one block and across blocks tie exactly; the
    kernel lists them in ascending index order, as the plain version."""
    B, N, D = 4, 1024, 64
    q = torch.randn((B, D), generator=cuda, device="cuda")
    docs = torch.randn((N, D), generator=cuda, device="cuda")
    dup = (37, 306, 313, 868)  # blocks 0, 1, 1, 3 of 256
    docs[list(dup)] = q[0]  # query 0's best match by far
    args = {"fp32": lambda: (docs,),
            "bf16": lambda: (docs.to(torch.bfloat16),),
            "int8": lambda: mips.quantize_embeddings(docs)}[dtype]()
    fn, plain = _mips_pair(dtype)
    v, i = fn(q, *args, 16, block_n=256, k_per_block=5)
    rv, ri = plain(q, *args, 16, block_n=256, k_per_block=5)
    assert tuple(i[0, :4].tolist()) == dup == tuple(ri[0, :4].tolist())
    assert torch.equal(i, ri)


def test_mips_topk_rejects_what_the_kernel_cannot_take(cuda):
    q = torch.zeros((2, 24), device="cuda")
    with pytest.raises(ValueError, match="D % 16"):
        mips.mips_topk_pallas(q, torch.zeros((256, 24), device="cuda"), 4,
                              block_n=256)
    q = torch.zeros((2, 32), device="cuda")
    with pytest.raises(ValueError, match="k'"):
        mips.mips_topk_pallas(q, torch.zeros((4096, 32), device="cuda"),
                              2000, block_n=4096)
    with pytest.raises(ValueError, match="multiple of block_n"):
        mips.mips_topk_pallas(q, torch.zeros((1000, 32), device="cuda"), 4,
                              block_n=256)


def test_k6_at_the_online_shape(cuda):
    """K6 at the online step's call (16 queries, 16,384 int8 rows of 768,
    k 65, block 4096, k' 32; unit rows as the encoder makes them) against
    its plain version: values within the fp32 summation bound, indices
    equal but for near-tie swaps, two runs bitwise equal, one launch."""
    B, N, D, k = 16, 16384, 768, 65
    g = _own_generator(1)
    q = torch.nn.functional.normalize(
        torch.randn((B, D), generator=g, device="cuda"), dim=1)
    index = mips.quantize_embeddings(torch.nn.functional.normalize(
        torch.randn((N, D), generator=g, device="cuda"), dim=1))
    fn = mips.mips_topk_pallas_quantized
    before = fn.launches
    v, i = fn(q, *index, k, block_n=4096, k_per_block=32)
    again = fn(q, *index, k, block_n=4096, k_per_block=32)
    rv, ri = mips.mips_topk_pallas_quantized_plain(q, *index, k,
                                                   block_n=4096,
                                                   k_per_block=32)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(v, again[0]) and torch.equal(i, again[1])
    tol = D * 2.0**-23 * 1.01  # unit rows: chip_smoke.py's mips_tol
    assert (v - rv).abs().max().item() <= tol
    rows, cols = (i != ri).nonzero(as_tuple=True)
    if len(rows):
        s = mips.block_scores(q, *(t[i[rows, cols]] for t in index))
        s = s[rows, torch.arange(len(rows), device=s.device)]
        assert (s - rv[rows, cols]).abs().max().item() <= tol
    assert len(rows) <= 0.01 * i.numel()


def test_k6_tied_zero_rows_lowest_index_first(cuda):
    """300 all-zero int8 rows inside one 4096-row block score exactly 0,
    more than its k' = 32 places; with every other score negative, the
    block's candidates are its 32 lowest zero rows, as the plain version
    takes them."""
    B, N, D, k = 4, 8192, 128, 40
    # positive queries and negative docs: every nonzero row scores below 0
    g = _own_generator(2)
    q = torch.rand((B, D), generator=g, device="cuda") + 0.1
    docs = -torch.rand((N, D), generator=g, device="cuda") - 0.1
    docs[1000:1300] = 0.0
    index = mips.quantize_embeddings(docs)
    v, i = mips.mips_topk_pallas_quantized(q, *index, k, block_n=4096,
                                           k_per_block=32)
    rv, ri = mips.mips_topk_pallas_quantized_plain(q, *index, k,
                                                   block_n=4096,
                                                   k_per_block=32)
    torch.cuda.synchronize()
    assert torch.equal(i, ri)
    assert i[:, :32].tolist() == [list(range(1000, 1032))] * B
    assert bool((v[:, :32] == 0).all())


@pytest.mark.parametrize("rows,k6", [(4096, True), (3000, False)])
def test_online_mining_dispatch(cuda, rows, k6):
    """The online step's dispatch (online.py:119-145): K6 on the card for a
    block-aligned int8 index, the exact streaming path for any other row
    count; the pools agree with the plain version of what ran."""
    from pacednegatives_tpu_torch.train import online

    mining = online.OnlineMiningConfig(pool_size=64, quantize=True)
    q = torch.randn((16, 64), generator=cuda, device="cuda")
    index = mips.quantize_embeddings(
        torch.randn((rows, 64), generator=cuda, device="cuda"))
    before = mips.mips_topk_pallas_quantized.launches
    idx = online.mine_top(q, index, 65, mining)
    assert mips.mips_topk_pallas_quantized.launches - before == int(k6)
    if k6:  # block 4096, k' 32, as the JAX step tiles it
        _, ref = mips.mips_topk_pallas_quantized_plain(
            q, *index, 65, block_n=4096, k_per_block=32)
    else:
        _, ref = mips.mips_topk_quantized_streaming(q, *index, 65)
    assert idx.shape == (16, 65) and torch.equal(idx, ref)


@pytest.mark.parametrize("B", [64, 100])
def test_mips_topk_fp32_exact_keep(cuda, B):
    """K5 fp32 at the build_pools setting (k' = k = 1000, block 1024): one
    m64 query tile (B 64) and two (B 100). The segments are long runs of
    rows; forcing them to the blocks gives the same result bitwise."""
    N, D, k = 8 * 1024, 768, 1000
    q = torch.nn.functional.normalize(
        torch.randn((B, D), generator=cuda, device="cuda"), dim=1)
    docs = torch.nn.functional.normalize(
        torch.randn((N, D), generator=cuda, device="cuda"), dim=1)
    v, i = mips.mips_topk_pallas(q, docs, k, block_n=1024)
    rv, ri = mips.mips_topk_pallas_plain(q, docs, k, block_n=1024)
    per_block = mips._merge_keys(mips._kernel_candidates(
        q, docs, None, k, 1024, None, "k5", fold=False), k)
    torch.cuda.synchronize()
    assert torch.equal(v, per_block[0]) and torch.equal(i, per_block[1])
    tol = D * 2.0**-23 * 1.01  # unit rows: chip_smoke.py's mips_tol
    assert (v - rv).abs().max().item() <= tol
    rows, cols = (i != ri).nonzero(as_tuple=True)
    if len(rows):
        s = mips.block_scores(q, docs[i[rows, cols]])
        s = s[rows, torch.arange(len(rows), device=s.device)]
        assert (s - rv[rows, cols]).abs().max().item() <= tol
    assert len(rows) <= 0.01 * i.numel()


def test_mips_topk_fp32_zero_rows_tie(cuda):
    """15,000 zero rows (the padding build_pools adds) all score exactly 0
    and straddle the k-th place, in one segment (B 264 keeps the k' = k
    route to a single run of rows) and in each 4096-row block (k' < k):
    more tied keys than the selection sorts in shared memory, so it takes
    the lowest indices by an ordered count. The indices equal the plain
    version's (ties to the lower index)."""
    B, N, D, k = 264, 16384, 64, 1000
    docs = torch.randn((N, D), generator=cuda, device="cuda")
    docs[500:15500] = 0.0
    q = torch.randn((B, D), generator=cuda, device="cuda")
    for kpb in (None, 100):
        v, i = mips.mips_topk_pallas(q, docs, k, block_n=4096,
                                     k_per_block=kpb)
        rv, ri = mips.mips_topk_pallas_plain(q, docs, k, block_n=4096,
                                             k_per_block=kpb)
        torch.cuda.synchronize()
        zero = rv == 0
        assert zero.any() and torch.equal(i[zero], ri[zero])
        assert (v - rv).abs().max().item() <= D * 2.0**-23 * D


# many persistent 128 x 256 tiles with ragged M (48128 + 37), N 8 (one
# column box, the rest of the tile zero-filled), K 8 (one k-box, mostly
# out of bounds), and A as a view whose row stride exceeds K
@pytest.mark.parametrize("M,K,N,pad", [(48165, 136, 2304, 0),
                                       (48165, 768, 8, 0), (1000, 8, 2304, 0),
                                       (2000, 136, 264, 24)])
def test_gemm_tiles_edges_strides_and_repeats(cuda, M, K, N, pad):
    a = _randn(cuda, M, K + pad)[:, :K]
    b = _randn(cuda, K, N, scale=K**-0.5)
    c = gemm.gemm(a, b)
    again = gemm.gemm(a, b)
    ref = gemm.gemm_plain(a, b)
    torch.cuda.synchronize()
    assert a.stride(0) == K + pad and torch.equal(c, again)
    tol = 2.0**-7 * ref.float().abs().max().item()
    assert (c.float() - ref.float()).abs().max().item() <= tol


def test_double_backward_through_k4_raises(cuda):
    """FusedSelfAttention (K3 / K4) is once differentiable: a gradient
    taken with create_graph=True raises before K4 launches, where the
    kernel's outputs, which carry no autograd history, would drop terms."""
    B, L, D, H, dk = 2, 64, 256, 4, 64
    x = _randn(cuda, B, L, D).float().requires_grad_()
    wqkv = _randn(cuda, D, 3 * H * dk, scale=D**-0.5)
    wo = _randn(cuda, H * dk, D, scale=(H * dk)**-0.5)
    pos3 = torch.randn((H, L, L), generator=cuda, device="cuda") * 0.3
    km = torch.zeros((B, L), device="cuda")
    y = flash_v3.fused_self_attention(x.to(torch.bfloat16), wqkv, wo, pos3,
                                      km)
    before = flash.attention_backward.launches
    with pytest.raises(NotImplementedError, match="double backward"):
        torch.autograd.grad(y.float().sum(), x, create_graph=True)
    assert flash.attention_backward.launches == before
    (g,) = torch.autograd.grad(y.float().sum(), x)  # first order: K4
    assert flash.attention_backward.launches == before + 1
    assert torch.isfinite(g).all()


def test_double_backward_through_k2b_raises(cuda):
    """_FlashCore's kernel route (K1 / K2b) raises under create_graph=True;
    its plain route, torch ops, differentiates twice on the card too."""
    B, H, L, dk = 2, 2, 128, 64
    q, k, v = (torch.randn((B, H, L, dk), generator=cuda, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    shared = torch.randn((1, H, L, L), generator=cuda, device="cuda") * 0.3
    per_batch = torch.zeros((B, 1, 1, L), device="cuda")
    assert flash.flash_v2_eligible(H, L, L, dk)
    out = t5.flash_core(L, "kernel", "fp32", q, k, v, shared, per_batch)
    before = flash.flash_attention_backward_v2.launches
    with pytest.raises(NotImplementedError, match="double backward"):
        torch.autograd.grad(out.square().sum(), q, create_graph=True)
    assert flash.flash_attention_backward_v2.launches == before
    out = t5.flash_core(L, "plain", "fp32", q, k, v, shared, per_batch)
    (gq,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    (gk,) = torch.autograd.grad(gq.float().square().sum(), k)
    assert torch.isfinite(gk).all() and gk.abs().max() > 0
