"""Port of models/t5.py: buckets, norms, position bias, encode/decode and
the parameter converter against the JAX package, at fp32 on the CPU.

The config is small but keeps dk = 64 so that encoder self-attention at
L >= 64 routes through flash_v3 (the JAX side in interpret mode, the port
through its plain versions), as the serving slice does at t5-base."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import (
    config_from_jax,
    params_from_jax,
)

# fp32 through 2 + 2 layers; the packages differ only in summation order.
ATOL = 2e-5
RTOL = 1e-5

JCFG = jt5.T5Config(
    vocab_size=512, d_model=128, d_kv=64, d_ff=256, num_heads=2,
    num_layers=2, num_decoder_layers=2, flash_v3=True,
    flash_v3_interpret=True,
)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return _np_tree(jt5.init_params(jax.random.key(0), JCFG))


def _batch(B=2, L=72, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, JCFG.vocab_size, size=(B, L)).astype(np.int32)
    lens = np.array([L, L - 17])[:B]
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 0).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_exact(bidirectional):
    rel = np.arange(-512, 513, dtype=np.int32)
    j = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128)
    t = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                     32, 128)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_rms_norm_and_position_bias(jparams):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32) * 3
    scale = rng.normal(size=(128,)).astype(np.float32)
    j = jt5.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6, jnp.float32)
    t = tt5.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6,
                     torch.float32)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
    rb = jparams["encoder"]["block_0"]["self_attn"]["rel_bias"]
    for bidir, (lq, lk) in ((True, (72, 72)), (False, (3, 3))):
        jb = jt5.compute_position_bias(jnp.asarray(rb), lq, lk, bidir, 32, 128)
        tb = tt5.compute_position_bias(torch.from_numpy(np.array(rb)), lq,
                                       lk, bidir, 32, 128)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("flash_v3", [True, False])
@pytest.mark.parametrize("L", [48, 72])
def test_encode_decode_match_jax(jparams, flash_v3, L):
    jcfg = dataclasses.replace(JCFG, flash_v3=flash_v3)
    cfg = config_from_jax(jcfg)
    assert cfg.flash_v3 == flash_v3 and cfg.dtype == torch.float32
    ids, mask = _batch(L=L)
    params = params_from_jax(jparams)
    jenc = jt5.encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    tenc = tt5.encode(params, cfg, torch.from_numpy(ids),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=ATOL,
                               rtol=RTOL)
    dec_in = np.array([[0, 7, 9], [0, 3, 1]], np.int32)
    jlog = jt5.decode(jparams, jcfg, jnp.asarray(dec_in), jenc,
                      jnp.asarray(mask))
    tlog = tt5.decode(params, cfg, torch.from_numpy(dec_in), tenc,
                      torch.from_numpy(mask))
    assert tlog.shape == (2, 3, 512) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)


def test_gated_ffn_matches_jax():
    jcfg = dataclasses.replace(JCFG, gated_ffn=True)
    jp = _np_tree(jt5.init_params(jax.random.key(1), jcfg))
    mlp = jp["encoder"]["block_0"]["mlp"]
    x = np.random.default_rng(2).normal(size=(2, 4, 128)).astype(np.float32)
    j = jt5.mlp(jax.tree_util.tree_map(jnp.asarray, mlp), jcfg, jnp.asarray(x))
    t = tt5.mlp(params_from_jax(mlp), config_from_jax(jcfg),
                torch.from_numpy(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("layout", ["stacked", "fused", "stacked_fused"])
def test_converter_layouts(jparams, layout):
    """Every layout the JAX package writes converts leaf for leaf (keys are
    the tree paths joined with '.') and encodes/decodes the same."""
    tree = jparams
    if "stacked" in layout:
        tree = _np_tree(jt5.stack_params(tree))
    if "fused" in layout:
        tree = _np_tree(jt5.fuse_attention_params(tree))
    params = params_from_jax(tree)
    flat = tt5.flatten_params(params)
    jflat = {
        ".".join(k.key for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    assert set(flat) == set(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k].numpy(), v)

    cfg = config_from_jax(JCFG)
    ids, mask = _batch()
    ref = tt5.encode(params_from_jax(jparams), cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask))
    enc = tt5.encode(params, cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask))
    np.testing.assert_allclose(enc.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    dec_in = torch.zeros((2, 1), dtype=torch.long)
    np.testing.assert_allclose(
        tt5.decode(params, cfg, dec_in, enc, torch.from_numpy(mask)).numpy(),
        tt5.decode(params_from_jax(jparams), cfg, dec_in, ref,
                   torch.from_numpy(mask)).numpy(),
        atol=ATOL, rtol=RTOL,
    )


def test_stack_unstack_fuse_match_jax(jparams):
    params = params_from_jax(jparams)
    for jfn, tfn in ((jt5.stack_params, tt5.stack_params),
                     (jt5.fuse_attention_params, tt5.fuse_attention_params)):
        want = {".".join(k.key for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(_np_tree(jfn(jparams)))[0]}
        got = tt5.flatten_params(tfn(params))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    back = tt5.flatten_params(tt5.unstack_params(tt5.stack_params(params)))
    assert set(back) == set(tt5.flatten_params(params))
    for k, v in tt5.flatten_params(params).items():
        assert torch.equal(back[k], v)


def test_init_params_names_and_shapes(jparams):
    g = torch.Generator().manual_seed(0)
    got = tt5.flatten_params(tt5.init_params(config_from_jax(JCFG), g))
    want = {".".join(k.key for k in p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    again = tt5.flatten_params(tt5.init_params(
        config_from_jax(JCFG), torch.Generator().manual_seed(0)))
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_flash_v3_routing(jparams, monkeypatch):
    """Only encoder self-attention at an eligible length takes the fused
    block: not L < 64, not the decoder's self- or cross-attention."""
    calls = []
    real = tt5.fused_self_attention
    monkeypatch.setattr(tt5, "fused_self_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = config_from_jax(JCFG)
    params = params_from_jax(jparams)
    for L, want in ((48, 0), (64, 2), (72, 2)):
        calls.clear()
        ids, mask = _batch(L=L)
        enc = tt5.encode(params, cfg, torch.from_numpy(ids),
                         torch.from_numpy(mask))
        tt5.decode(params, cfg, torch.zeros((2, 1), dtype=torch.long), enc,
                   torch.from_numpy(mask))
        assert len(calls) == want and all(s == (2, L, 128) for s in calls)


def test_chunked_attention_not_ported(jparams):
    """Chunked attention (72 keys in chunks of 32, so the last chunk is
    padded) through encode and decode, against the JAX package's chunked
    route on the same weights."""
    jcfg = dataclasses.replace(JCFG, flash_v3=False, attention_impl="chunked",
                               attention_chunk=32)
    ids, mask = _batch()
    jenc = jt5.encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    jdec = jt5.decode(jparams, jcfg, jnp.zeros((2, 3), jnp.int32), jenc,
                      jnp.asarray(mask))
    params, cfg = params_from_jax(jparams), config_from_jax(jcfg)
    assert (cfg.attention_impl, cfg.attention_chunk) == ("chunked", 32)
    enc = tt5.encode(params, cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask))
    dec = tt5.decode(params, cfg, torch.zeros((2, 3), dtype=torch.long), enc,
                     torch.from_numpy(mask))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=ATOL,
                               rtol=RTOL)
