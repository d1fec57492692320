"""The plain reference against the port at a tiny T5 on the CPU, in fp32:
the forward's scores and CE, the position buckets, AdamW, the curriculum's
draws, and the float8 control's distance. The reference imports nothing
of the port; the tests do, to hold one against the other."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmarks.arch import T5ForConditionalGeneration as t5_arch
from benchmarks.common.weights import nest
from benchmarks.reference import curriculum as ref_cur
from benchmarks.reference.curriculum import linear_warmup_decay
from benchmarks.reference.lce import AdamW
from benchmarks.reference.t5 import Model
from benchmarks.tests.tiny import CONFIG


def _port_cfg():
    from pacednegatives_tpu_torch.models.t5 import T5Config

    keys = ("vocab_size", "d_model", "d_kv", "d_ff", "num_heads",
            "num_layers", "num_decoder_layers")
    return T5Config(**{k: CONFIG[k] for k in keys}, flash_v3=True,
                    fused_qkv=True)


def _prompts(B=6, L=68, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, CONFIG["vocab_size"], (B, L), generator=g)
    lens = torch.randint(20, L + 1, (B,), generator=g)
    mask = (torch.arange(L)[None] < lens[:, None]).long()
    return ids * mask, mask


def test_weights_have_the_ports_tree():
    from pacednegatives_tpu_torch.models.t5 import flatten_params, init_params

    port = flatten_params(init_params(_port_cfg(),
                                      torch.Generator().manual_seed(0)))
    ours = {k: s for k, s, _ in t5_arch.leaves(t5_arch.sizes(CONFIG))}
    assert ours == {k: tuple(v.shape) for k, v in port.items()}
    a = t5_arch.weights(CONFIG, 2**40 + 1, "cpu")
    b = t5_arch.weights(CONFIG, 2**40 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_scores_and_ce_match_the_port():
    from pacednegatives_tpu_torch.models import t5
    from pacednegatives_tpu_torch.models.monot5 import score_batch

    w = t5_arch.weights(CONFIG, 7, "cpu")
    ids, mask = _prompts()
    ref = t5_arch.reference(CONFIG, w)
    got = score_batch(nest(w), _port_cfg(), ids, mask.int(), 3, 4)
    want = ref.score(ids, mask, 3, 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    labels = torch.tensor([[4, 1]]).expand(ids.shape[0], 2)
    logits = t5.forward_logits(nest(w), _port_cfg(), ids, labels, mask.int())
    port_ce = -torch.log_softmax(logits, -1).gather(
        -1, labels[..., None])[..., 0].mean(-1)
    torch.testing.assert_close(ref.row_ce(ids, mask, labels), port_ce,
                               rtol=1e-5, atol=1e-5)
    # the per-row loss of the verbalizer id forms the same labels
    verbalizer = torch.full((ids.shape[0],), 4)
    assert torch.equal(ref.loss(ids, mask, verbalizer),
                       ref.row_ce(ids, mask, labels))


def test_position_buckets_match_the_port():
    from pacednegatives_tpu_torch.models.t5 import relative_position_bucket

    ref = Model(CONFIG, {})
    rel = torch.arange(512)[None, :] - torch.arange(512)[:, None]
    for bidir in (True, False):
        want = relative_position_bucket(rel, bidir, 32, 128).long()
        assert torch.equal(ref.bucket(rel, bidir), want)


def test_adamw_matches_the_ports_optimizer():
    from pacednegatives_tpu_torch.optim import Adam, apply_updates

    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(5, 3, generator=g),
              "b": torch.randn(7, generator=g)}
    sched = lambda c: float(np.float32(linear_warmup_decay(1e-2, 2, 10, c)))
    port = Adam(sched, eps=1e-6, weight_decay=0.0, clip_norm=1.0)
    ours = AdamW(sched, clip=1.0)
    state = port.init(params)
    p_port, p_ref = params, dict(params)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in
                 params.items()}
        upd, state = port.update(grads, state, p_port)
        p_port = apply_updates(p_port, upd)
        p_ref = ours.step(p_ref, grads)
    for k in params:
        torch.testing.assert_close(p_ref[k], p_port[k], rtol=1e-5, atol=1e-7)


def test_curriculum_draws_match_the_port():
    from pacednegatives_tpu_torch.ops.sampling import (
        sample_pool_indices_batch,
    )

    mean = torch.full((16,), 0.37)
    a = sample_pool_indices_batch(torch.Generator().manual_seed(9), 1000,
                                  mean, 7)
    b = ref_cur.draw_positions(torch.Generator().manual_seed(9), 1000, mean,
                               7)
    assert torch.equal(a, b)


def test_eta_update_matches_the_port():
    from pacednegatives_tpu_torch.curriculum.base import StepSignals
    from pacednegatives_tpu_torch.curriculum.eta import EtaController

    scale = 3 * math.log(512)
    port = EtaController(eta0=0.5, meta_lr=1e-2, warmup_steps=2,
                         total_steps=10, kind="lce", objective="weighted_ce",
                         optimizer="adamw", clamp=False, ce_scale=scale)
    state = port.init()
    ours = ref_cur.EtaCurriculum(0.5, 1e-2, 2, 10, scale, "cpu")
    g = torch.Generator().manual_seed(3)
    for _ in range(4):
        ce = torch.rand(8, generator=g) * scale
        z = torch.zeros(8)
        state = port.update(state, StepSignals(z, z, ce, z))
        ours.update(ce)
        torch.testing.assert_close(ours.difficulty(),
                                   port.difficulty(state), rtol=1e-6,
                                   atol=1e-7)
    assert float(ours.difficulty()) != 0.5  # it moved


def test_fp8_control_is_far_from_fp32():
    w = t5_arch.weights(CONFIG, 11, "cpu")
    ids, mask = _prompts(B=16)
    a = Model(CONFIG, w).score(ids, mask, 3, 4)
    b = Model(CONFIG, w, precision="fp8").score(ids, mask, 3, 4)
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    w = t5_arch.weights(CONFIG, 13, "cpu")
    ids, mask = _prompts()
    cpu = Model(CONFIG, w).score(ids, mask, 3, 4)
    gpu = Model(CONFIG, {k: v.cuda() for k, v in w.items()}).score(
        ids.cuda(), mask.cuda(), 3, 4)
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-5, atol=1e-5)
