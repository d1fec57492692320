"""What the training step and the reranker ask of a model.

``for_config(cfg)`` gives the model of a configuration (``T5Config``:
monoT5; ``DeepseekV3Config``: the decoder-only reranker), with:

- ``prepare(params, ids_len, labels_len, mesh, dims)`` -> ``Prepared``:
  a step's compute-dtype leaves, made once a step from the fp32 masters;
  ``leaves`` is every tensor the step differentiates against, in order;
- ``logits(prep, ids, mask, labels, seed, deterministic)`` -> (logits
  (B, Lt, V) fp32, labels (B, Lt)): the forward to the positions whose
  CE trains it; position 0's logits are the relevance score's;
- ``fold(prep, grads)`` -> the gradient tree of ``params``, from the
  gradients of ``prep.leaves`` (fp32);
- ``serving_params(params, device)`` and ``score_batch(params, ids, mask,
  rel_id, nrel_id)`` -> (B,) log P(true | {true, false}): scoring.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pacednegatives_tpu_torch.models import deepseek_v3, t5
from pacednegatives_tpu_torch.models.monot5 import score_batch as t5_score
from pacednegatives_tpu_torch.models.monot5 import serving_params as t5_serving


@dataclasses.dataclass
class Prepared:
    params: dict  # the compute tree the forward reads
    leaves: list  # what the step differentiates against
    aux: Any = None


class T5Model:
    """monoT5: the position biases once a step from the two rel_bias
    tables, q|k|v fused once (``fused_qkv``), the big weights cast once;
    teacher-forced logits of the labels [verbalizer, eos]; the biases'
    cotangent folded back into the tables through the gather's backward
    (step.py:165-198, 288-305)."""

    bias_keys = ("enc", "dec_self")

    def __init__(self, cfg: t5.T5Config):
        self.cfg = cfg

    def _pre(self, p: torch.Tensor, width: int) -> torch.Tensor:
        # the big matmul weights in the compute dtype, once per step
        # (step.py:186-198), by the whole leaf's last dim ``width``; 1-D
        # scales and the (buckets, H) rel_bias stay
        if p.dim() >= 2 and width >= 128 and p.dtype == torch.float32:
            p = p.to(self.cfg.dtype)
        return p.detach().requires_grad_(True)

    @staticmethod
    def _widths(src: dict, mesh, dims) -> dict:
        """Each leaf's whole last dim: a slice's times ``model`` where
        the leaf splits its last dim (a fused q|k|v or k|v as its q or k
        does)."""
        flat = t5.flatten_params(src)
        if dims is None:
            return {k: p.shape[-1] for k, p in flat.items()}
        dims = t5.flatten_params(dims)
        out = {}
        for key, p in flat.items():
            base = (key[:-3] + "q" if key.endswith(".qkv") else
                    key[:-2] + "k" if key.endswith(".kv") else key)
            split_last = dims.get(base) == p.dim() - 1
            out[key] = p.shape[-1] * (mesh.model if split_last else 1)
        return out

    def prepare(self, params, ids_len, labels_len, mesh, dims) -> Prepared:
        cfg = self.cfg
        # Position biases once per step, not per microbatch (step.py:
        # 165-178): the microbatches differentiate against the bias
        # tensors, whose summed cotangent goes through the bucket
        # gather's backward once, in ``fold``.
        tables = [t5._rel_bias(params[s]).detach().requires_grad_(True)
                  for s in ("encoder", "decoder")]
        with torch.enable_grad():
            full = t5.position_bias_from_tables(*tables, cfg, ids_len,
                                                labels_len)
        biases = {key: full[key].detach().requires_grad_(True)
                  for key in self.bias_keys}
        with torch.no_grad():
            src = (t5.fuse_attention_params(params) if cfg.fused_qkv
                   else params)
        widths = self._widths(src, mesh, dims)
        flat = {k: self._pre(p, widths[k])
                for k, p in t5.flatten_params(src).items()}
        leaves = [*flat.values(), *(biases[key] for key in self.bias_keys)]
        return Prepared(t5.unflatten_params(flat), leaves,
                        (list(flat), tables, full, biases))

    def logits(self, prep, ids, mask, labels, seed, deterministic):
        return t5.forward_logits(prep.params, self.cfg, ids, labels, mask,
                                 deterministic=deterministic,
                                 dropout_seed=seed,
                                 pos_biases=prep.aux[3]), labels

    def fold(self, prep, grads: list) -> dict:
        keys, tables, full, _ = prep.aux
        gbias = grads[len(keys):]
        tree = t5.unflatten_params(dict(zip(keys, grads[:len(keys)])))
        if self.cfg.fused_qkv:
            tree = t5.split_attention_grads(tree)
        g_enc, g_dec = torch.autograd.grad(
            [full[key] for key in self.bias_keys], tables, grad_outputs=gbias)
        _fold_rel_bias_grad(tree, "encoder", g_enc)
        _fold_rel_bias_grad(tree, "decoder", g_dec)
        return tree

    def serving_params(self, params: dict, device) -> dict:
        return t5_serving(params, self.cfg, device)

    def score_batch(self, params, ids, mask, rel_id, nrel_id):
        return t5_score(params, self.cfg, ids, mask, rel_id=rel_id,
                        nrel_id=nrel_id)


def _fold_rel_bias_grad(grads: dict, stack_key: str, g: torch.Tensor) -> None:
    """Add ``g`` into the rel_bias leaf of ``grads[stack_key]`` (the stacked
    layout's top-level ``rel_bias`` or ``block_0.self_attn.rel_bias``), in
    place (step.py:41-54)."""
    stack = grads[stack_key]
    if "rel_bias" in stack:
        stack["rel_bias"] = stack["rel_bias"] + g
    else:
        sa = stack["block_0"]["self_attn"]
        sa["rel_bias"] = sa["rel_bias"] + g


class DeepseekV3Model:
    """The decoder-only reranker: ``deepseek_v3.compute_leaves`` once a
    step; the logits of the last real position, trained on the CE of the
    labels' first column (the verbalizer); the router's correction bias is
    no leaf (its gradient is zero)."""

    def __init__(self, cfg: deepseek_v3.DeepseekV3Config):
        self.cfg = cfg

    @staticmethod
    def _constant(key: str) -> bool:
        return key.endswith("router.bias")

    def prepare(self, params, ids_len, labels_len, mesh, dims) -> Prepared:
        if dims is not None:
            raise NotImplementedError(
                "DeepSeek-V3 under tensor parallelism: the expert layer is "
                "split by experts_held, not by a mesh's model axis")
        flat = deepseek_v3.compute_leaves(params, self.cfg)
        keys = [k for k in flat if not self._constant(k)]
        for k in keys:
            flat[k].requires_grad_(True)
        return Prepared(deepseek_v3.unflatten_params(flat),
                        [flat[k] for k in keys], (keys, flat))

    def logits(self, prep, ids, mask, labels, seed, deterministic):
        if not deterministic:
            raise NotImplementedError("DeepSeek-V3 trains without dropout")
        out = deepseek_v3.last_logits(prep.params, self.cfg, ids, mask)
        return out[:, None, :], labels[:, :1]

    def fold(self, prep, grads: list) -> dict:
        keys, flat = prep.aux
        got = dict(zip(keys, grads))
        return deepseek_v3.unflatten_params({
            k: got[k] if k in got else torch.zeros_like(v, dtype=torch.float32)
            for k, v in flat.items()})

    def serving_params(self, params: dict, device) -> dict:
        return deepseek_v3.unflatten_params({
            k: v.to(device) for k, v in deepseek_v3.compute_leaves(
                params, self.cfg).items()})

    def score_batch(self, params, ids, mask, rel_id, nrel_id):
        return deepseek_v3.score_batch(params, self.cfg, ids, mask,
                                       rel_id=rel_id, nrel_id=nrel_id)


def for_config(cfg):
    """The model of ``cfg``."""
    if isinstance(cfg, deepseek_v3.DeepseekV3Config):
        return DeepseekV3Model(cfg)
    return T5Model(cfg)
