"""The W8A8 scoring forward: the port's ``models/quant.py`` against the JAX
package's on the same numpy weights and inputs, on the CPU.

Quantization is exact arithmetic on both sides (an fp32 max, an fp32
division, round half to even, an exact int32 accumulator, then
``(acc * sx) * sw`` in fp32), so weight codes, scales and activation
codes must agree exactly, and ``int8_linear`` to fp32 rounding.

The whole scoring forward is held to 1e-3 absolute on log-probs, pair by
pair, wherever no int8 code flipped. The forward is not continuous: the
attention products take bf16-rounded operands, and the packages' fp32
softmax and sums differ in the last bit, which now and then moves a
probability across a bf16 rounding boundary; that moves the next
projection's input by ~1e-4, flips int8 codes there and the difference
grows through the later layers. A probe records every ``int8_linear``
input on both sides and counts, per pair, the codes that differ. Pairs
with no flipped code agree to ~1e-7; the pairs with flips are counted and
held to the int8 scorer's own noise (0.03, the JAX package's bound of the
int8 against the bf16 scorer in tests/test_quant.py). The port quantizes
each input once (the JAX package once per projection that reads it, to
the same codes), so the probe records each distinct input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.data import corpus as jcorpus
from pacednegatives_tpu.data import pipeline as jpipeline
from pacednegatives_tpu.data.tokenizer import HashTokenizer
from pacednegatives_tpu.models import quant as jquant
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu_torch.models import quant as tquant
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)

SCORE_ATOL = 1e-3  # log-probs of pairs with no flipped code (docstring)
INT8_NOISE = 0.03  # log-probs of every pair (docstring)
LINEAR_RTOL = 1e-6  # int8_linear: the same fp32 operations in the same order


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=256),
                              dtype=jnp.bfloat16)
    corpus = jcorpus.TextCorpus.synthetic(num_docs=32, num_queries=4, seed=0)
    store = jpipeline.TokenizedStore.build(corpus, HashTokenizer(256),
                                           max_q_tokens=6, max_d_tokens=24)
    params = jax.tree_util.tree_map(
        np.asarray, jt5.init_params(jax.random.key(0), cfg))
    ids, mask = store.assemble_host(np.repeat(np.arange(4), 8),
                                    np.arange(32))
    return cfg, params, ids, mask


def _jax_codes(x: np.ndarray) -> np.ndarray:
    """Per-token int8 codes as the JAX package's ``int8_linear`` computes
    them (models/quant.py:67-71)."""
    xf = jnp.asarray(x, jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                     1e-8) / 127.0
    return np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127)
                      .astype(jnp.int8))


def test_quantize_weight_matches_jax():
    w = np.random.default_rng(0).normal(0, 0.1, (64, 96)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the eps scale
    j = jquant._quantize_weight(jnp.asarray(w))
    t = tquant._quantize_weight(_t(w))
    assert t["w"].dtype == torch.int8 and t["s"].dtype == torch.float32
    np.testing.assert_array_equal(t["w"].numpy(), np.asarray(j["w"]))
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))


@pytest.mark.parametrize("shape", [(4, 10, 64), (8, 1, 64), (40, 64)],
                         ids=["tokens", "decoder_rows_8", "rows_40"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(shape, out_dtype):
    """Per-token activation codes equal (no flipped code), and the output
    to fp32 rounding; (8, 1, 64) is the decoder's one-position case, fewer
    rows than cuBLASLt takes, which ``int8_linear`` pads."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    w = rng.normal(0, 0.1, (64, 96)).astype(np.float32)
    jw = jquant._quantize_weight(jnp.asarray(w))
    tw = tquant._quantize_weight(_t(w))
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    j = np.asarray(jquant.int8_linear(jnp.asarray(x), jw, jdt)
                   .astype(jnp.float32))
    t = tquant.int8_linear(_t(x), tw, tdt)
    assert t.dtype == tdt and t.shape == shape[:-1] + (96,)
    # probe: activation codes that round differently in the two packages
    flipped = int((tquant._quantize_tokens(_t(x))[0].numpy()
                   != _jax_codes(x)).sum())
    assert flipped == 0
    np.testing.assert_allclose(t.float().numpy(), j, rtol=LINEAR_RTOL,
                               atol=0)
    # and within quantization error of the fp32 product (two int8
    # roundings, ~1/127 relative each)
    ref = x @ w
    assert np.abs(t.float().numpy() - ref).max() / np.abs(ref).max() < 0.03


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
def test_quantize_scoring_params_matches_jax(setup, fused):
    cfg, params, _, _ = setup
    jp = jt5.fuse_attention_params(params) if fused else params
    tp = params_from_jax(params)
    if fused:
        tp = tt5.fuse_attention_params(tp)
    j = jax.tree_util.tree_map(np.asarray,
                               jquant.quantize_scoring_params(jp, cfg))
    t = tquant.quantize_scoring_params(tp, config_from_jax(cfg))
    assert len(t["enc_blocks"]) == cfg.num_layers
    assert len(t["dec_blocks"]) == cfg.num_decoder_layers
    jflat = tt5.flatten_params({
        **{k: v for k, v in j.items() if k not in ("enc_blocks",
                                                    "dec_blocks")},
        **{f"enc_{i}": b for i, b in enumerate(j["enc_blocks"])},
        **{f"dec_{i}": b for i, b in enumerate(j["dec_blocks"])}})
    tflat = tt5.flatten_params({
        **{k: v for k, v in t.items() if k not in ("enc_blocks",
                                                    "dec_blocks")},
        **{f"enc_{i}": b for i, b in enumerate(t["enc_blocks"])},
        **{f"dec_{i}": b for i, b in enumerate(t["dec_blocks"])}})
    assert set(tflat) == set(jflat)
    for key, v in tflat.items():
        np.testing.assert_array_equal(v.numpy(), jflat[key], err_msg=key)


def _recording(monkeypatch, module, name, to_numpy):
    """Record each distinct input that ``module.<name>`` quantizes: the
    JAX package quantizes one input again for each projection that reads
    it (q, k and v; the encoder output in every decoder layer), the port
    once. Inputs are told apart by identity, in order of first use."""
    seen, objects = [], []
    real = getattr(module, name)

    def rec(x, *args):
        if not any(x is o for o in objects):
            objects.append(x)
            seen.append(to_numpy(x))
        return real(x, *args)

    monkeypatch.setattr(module, name, rec)
    return seen


def _flipped_per_pair(jax_inputs, port_inputs, n) -> np.ndarray:
    """Per pair, the int8 activation codes that differ between the
    packages, over every quantized input of the forward."""
    flips = np.zeros(n, np.int64)
    for a, b in zip(jax_inputs, port_inputs):
        ca = _jax_codes(a)
        cb = tquant._quantize_tokens(torch.from_numpy(b))[0].numpy()
        flips += (ca != cb).reshape(n, -1).sum(1)
    return flips


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_score_batch_int8_matches_jax(setup, fused, stream, monkeypatch):
    cfg, params, ids, mask = setup
    jp = jt5.fuse_attention_params(params) if fused else params
    tp = params_from_jax(params)
    if fused:
        tp = tt5.fuse_attention_params(tp)
    tcfg = config_from_jax(cfg)
    jq = jquant.quantize_scoring_params(jp, cfg)
    tq = tquant.quantize_scoring_params(tp, tcfg)
    j_in = _recording(monkeypatch, jquant, "int8_linear",
                      lambda x: np.asarray(x.astype(jnp.float32)))
    t_in = _recording(monkeypatch, tquant, "_quantize_tokens",
                      lambda x: x.float().numpy())
    j = np.asarray(jquant.score_batch_int8(
        jq, cfg, jnp.asarray(ids), jnp.asarray(mask), rel_id=3, nrel_id=4,
        stream_dtype=getattr(jnp, stream)))
    with torch.inference_mode():
        t = tquant.score_batch_int8(
            tq, tcfg, _t(ids), _t(mask), rel_id=3, nrel_id=4,
            stream_dtype=getattr(torch, stream)).numpy()
    assert t.dtype == np.float32 and t.shape == (len(ids),)
    assert np.isfinite(t).all() and (t <= 0).all()
    # inputs quantized: an encoder layer's h, attention output, FFN input
    # and hidden; a decoder layer's the same plus the self-attention's
    # value and output; the encoder output once
    assert len(t_in) == len(j_in) \
        == 4 * cfg.num_layers + 6 * cfg.num_decoder_layers + 1
    flips = _flipped_per_pair(j_in, t_in, len(ids))
    clean = flips == 0
    diff = np.abs(t - j)
    assert clean.sum() >= len(ids) * 3 // 4, (flips, diff)
    np.testing.assert_allclose(t[clean], j[clean], atol=SCORE_ATOL, rtol=0)
    assert diff.max() <= INT8_NOISE, (flips, diff)
