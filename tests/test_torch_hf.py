"""Port of the HF checkpoint I/O (slice R): ``models/hf_import.py`` and
``models/hf_export.py`` against the JAX package's and against
``transformers`` itself, on checkpoints built here from a small local
``T5Config`` (nothing is downloaded), on the CPU.

The port reads and writes the directory without ``transformers`` or
``safetensors`` (the machine with the card has neither): its safetensors
reader and writer are held to ``safetensors.torch``, and load and save run
with both packages blocked in ``sys.modules``. The port's export must load
in ``transformers`` with logits within 3e-5 of the port's forward (the
JAX package's own export tolerance, tests/test_hf_export.py)."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

from pacednegatives_tpu.models import hf_export as jexport
from pacednegatives_tpu.models import hf_import as jimport
from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu_torch.models import hf_export as texport
from pacednegatives_tpu_torch.models import hf_import as timport
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.models.convert import params_from_jax
from pacednegatives_tpu_torch.train.runner import RunConfig, load_run, run

LOGITS_TOL = 3e-5  # tests/test_hf_export.py
SMALL = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_heads=4,
             num_layers=2, num_decoder_layers=2,
             relative_attention_num_buckets=8,
             relative_attention_max_distance=20, dropout_rate=0.0,
             decoder_start_token_id=0)
VARIANTS = {
    "tied_relu": dict(feed_forward_proj="relu"),
    "untied_gated": dict(feed_forward_proj="gated-gelu",
                         tie_word_embeddings=False, num_decoder_layers=3),
}


def _hf_dir(tmp_path, variant, **save_kw):
    torch.manual_seed(0)
    model = transformers.T5ForConditionalGeneration(
        transformers.T5Config(**{**SMALL, **VARIANTS[variant]})).eval()
    path = tmp_path / f"hf_{variant}"
    model.save_pretrained(path, **save_kw)
    return model, str(path)


def _flat_np(params):
    return {k: v.numpy() for k, v in tt5.flatten_params(params).items()}


def _block_hf(monkeypatch):
    for name in ("transformers", "safetensors", "safetensors.torch"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_transformers_checkpoint_loads_as_jax_loads_it(tmp_path, monkeypatch,
                                                       variant, fmt):
    """A checkpoint that ``transformers`` wrote (safetensors, or
    ``pytorch_model.bin``) loads in the port, with transformers and
    safetensors blocked, to the JAX ``load_hf_checkpoint``'s tree and
    config bit for bit; the tied variant's file holds no lm_head."""
    _, path = _hf_dir(tmp_path, variant,
                      safe_serialization=(fmt == "safetensors"))
    jparams, jcfg = jimport.load_hf_checkpoint(path)
    _block_hf(monkeypatch)
    tparams, tcfg = timport.load_hf_checkpoint(path, device="cpu")
    for field in ("vocab_size", "d_model", "d_kv", "d_ff", "num_heads",
                  "num_layers", "num_decoder_layers",
                  "relative_attention_num_buckets",
                  "relative_attention_max_distance", "dropout_rate",
                  "layer_norm_epsilon", "tie_word_embeddings", "gated_ffn",
                  "pad_token_id", "decoder_start_token_id"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    want = tt5.flatten_params(jparams)
    got = _flat_np(tparams)
    assert set(got) == set(want)
    for key, val in got.items():
        assert val.dtype == np.float32
        np.testing.assert_array_equal(val, want[key], err_msg=key)
    assert ("lm_head.embedding" in got) == (variant == "untied_gated")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_loads_in_transformers_and_jax(tmp_path, monkeypatch,
                                              variant):
    """The port's ``save_pretrained`` (transformers and safetensors
    blocked) of JAX-initialised weights: ``transformers`` loads it with
    logits within 3e-5 of the port's forward, its config equals the one
    the JAX ``hf_config_from`` builds, and the JAX package reloads the
    directory to the same tree."""
    base = jt5.T5Config(**SMALL, tie_word_embeddings=variant == "tied_relu",
                        gated_ffn=variant == "untied_gated")
    jparams = jax.tree_util.tree_map(
        np.asarray, jt5.init_params(jax.random.key(0), base))
    tparams = params_from_jax(jparams)
    tcfg = timport.config_from_hf(texport.hf_config_from(
        timport.config_from_hf(
            {**SMALL, **VARIANTS[variant], "num_decoder_layers": 2})))
    out = str(tmp_path / "export")
    with monkeypatch.context() as m:
        _block_hf(m)
        texport.save_pretrained(tparams, tcfg, out)
    hf = transformers.T5ForConditionalGeneration.from_pretrained(out).eval()
    jhf = jimport.config_from_hf(hf.config)
    for field in ("vocab_size", "d_model", "num_layers", "tie_word_embeddings",
                  "gated_ffn", "relative_attention_max_distance"):
        assert getattr(jhf, field) == getattr(tcfg, field), field
    with open(f"{out}/config.json") as f:
        written = json.load(f)
    # what the JAX package's config holds (save_pretrained adds the model
    # class's name under "architectures")
    jdict = jexport.hf_config_from(base).to_dict()
    for key, val in written.items():
        if key not in ("architectures", "transformers_version", "dtype"):
            assert jdict[key] == val, key
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 512, size=(2, 9))
    labels = rng.integers(2, 512, size=(2, 2))
    ours = tt5.forward_logits(tparams, tcfg, torch.from_numpy(ids),
                              torch.from_numpy(labels)).numpy()
    with torch.no_grad():
        theirs = hf(input_ids=torch.from_numpy(ids),
                    labels=torch.from_numpy(labels)).logits.numpy()
    np.testing.assert_allclose(theirs, ours, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    back, _ = jimport.load_hf_checkpoint(out)
    want = tt5.flatten_params(back)
    for key, val in _flat_np(tparams).items():
        np.testing.assert_array_equal(val, want[key], err_msg=key)
    logits = jt5.forward_logits(back, jimport.config_from_hf(hf.config),
                                jnp.asarray(ids), jnp.asarray(labels))
    np.testing.assert_allclose(np.asarray(logits), ours, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


def test_safetensors_reader_and_writer_match_the_library(tmp_path):
    tensors = {
        "a.f32": torch.randn(3, 5),
        "b.bf16": torch.randn(7).to(torch.bfloat16),
        "c.i64": torch.arange(6).reshape(2, 3),
        "d.f16": torch.randn(2, 2, 2).half(),
        "e.u8": torch.arange(9, dtype=torch.uint8),
        "f.scalar": torch.tensor(2.5),
    }
    lib = str(tmp_path / "lib.safetensors")
    ours = str(tmp_path / "ours.safetensors")
    safetensors.torch.save_file(tensors, lib, metadata={"format": "pt"})
    texport.write_safetensors(tensors, ours)
    for path in (lib, ours):
        got = timport.read_safetensors(path)
        want = safetensors.torch.load_file(path)
        assert set(got) == set(want) == set(tensors)
        for key in tensors:
            assert got[key].dtype == want[key].dtype == tensors[key].dtype
            assert torch.equal(got[key], want[key]), key
            assert torch.equal(got[key], tensors[key]), key


def test_run_from_an_hf_dir_and_export(tmp_path):
    """``run(model=<HF dir>)`` trains from the checkpoint's weights, with
    ce_scale 1.0 (a pretrained checkpoint's reference scale, as the JAX
    runner resolves it); ``export_hf`` writes ``out_dir/model``, which
    reloads to the final weights; ``load_run`` reloads such a run."""
    _, path = _hf_dir(tmp_path, "tied_relu")
    tiny = dict(total_steps=8, batch_size=4, chunk_size=1, synthetic_docs=24,
                synthetic_queries=8, synthetic_pairs=12, synthetic_pool=8,
                max_q_tokens=8, max_d_tokens=24, warmup_steps=4,
                vocab_size=512, remat=False, bf16=False)
    out = tmp_path / "run"
    summary = run(RunConfig(**tiny, model=path, export_hf=True,
                            out_dir=str(out)), device="cpu")
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["ce_scale"] for r in rows if "ce_scale" in r] == [1.0]
    params, mcfg, _, rc = load_run(str(out), device="cpu")
    assert rc.model == path and mcfg.d_model == SMALL["d_model"]
    exported, _ = timport.load_hf_checkpoint(str(out / "model"),
                                             device="cpu")
    start, _ = timport.load_hf_checkpoint(path, device="cpu")
    final, first = tt5.flatten_params(params), tt5.flatten_params(start)
    for key, val in tt5.flatten_params(exported).items():
        assert torch.equal(val, final[key]), key
    assert any(not torch.equal(final[k], first[k]) for k in final)
