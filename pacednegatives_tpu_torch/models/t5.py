"""T5 encoder-decoder forward in PyTorch: the port of models/t5.py.

Parameters are a nested dict of tensors with the JAX package's tree paths
and orientation: every projection is (in, out) and is applied as ``x @ w``.
Its flat form (``flatten_params``) is a state dict whose keys are those
paths joined with ".", e.g. ``encoder.block_0.self_attn.q``, so converting
a JAX checkpoint is a flatten plus ``torch.from_numpy`` (models/convert.py).

The forward, for serving and for training by autograd: ``encode`` and
``decode`` over the ``block_i`` or stacked ``blocks`` layout, with plain or
fused (``qkv`` / ``kv``) attention leaves, and the teacher-forced
``forward_logits``; with ``deterministic=False``, dropout where the JAX
package places it (t5.py:325-329, 614-617, 1381-1446, 1480-1551), its
masks drawn from per-use seeds so that a recomputed block draws the same
ones. ``remat`` runs each block under ``torch.utils.checkpoint`` with the
JAX package's policies (t5.py:261-270): "full" recomputes the whole block,
"dots" saves every matmul output (``aten.mm`` and ``aten.bmm``),
"dots_nobatch" the unbatched ones (``aten.mm``: projections and FFN) and
recomputes the attention products. The hand kernels are ``ctypes`` calls
that the dispatcher does not see, so every policy recomputes them, as JAX
recomputes a ``pallas_call``. Numerics follow the JAX
package: activations in ``cfg.dtype``, RMSNorm and softmax in fp32, scores
accumulated in fp32, ``NEG_INF`` added (not -inf) for masks. Attention is
routed exactly as ``attention`` in the JAX package routes it
(t5.py:400-625): encoder self-attention through the fused-block kernels
(forward K3, backward K4) when ``cfg.flash_v3`` is set and the shape is
eligible; otherwise dense, or ``attention_impl="chunked"``: online softmax
over key chunks with a flash-style backward (``_FlashCore``, the
``custom_vjp`` of t5.py:929-1121), whose 128-aligned shapes on CUDA take
the attention-core kernels with ``flash_kernel`` (forward K1, backward K2b
or K2a, chosen by ``flash_v2_eligible``).

Gradients reach ``rel_bias`` through ``compute_position_bias`` (a gather,
so autograd scatters the bias cotangent back into the table) and, on the
kernel paths, through the kernels' dpos. The train step computes the
biases once per step (``position_bias_from_tables``), passes them in
through ``pos_biases`` and folds their accumulated cotangent back into the
tables, as the JAX step does (train/step.py:165-178, 301-305).

Tensor parallelism (a mesh with ``model > 1``, parallel/mesh.py): a rank
may hold its slice of a split weight (``shard_params``), and each layer
reads from its weights' shapes whether it runs split (``model_split``):
attention on ``H / model`` whole heads (q/k/v column-parallel, o
row-parallel, the rank's rel_bias columns), the FFN on ``d_ff / model``
(wi* column-, wo row-parallel), the embedding lookup over the rank's vocab
rows (masked, then summed over the model group) and the LM head giving
the rank's vocab columns of the logits. Each split layer is entered
through ``copy_to_model`` and left through ``reduce_from_model``
(parallel/collectives.py); whole weights run as one process runs them,
with no collective. The chunked kernel route picks its backward kernel on
the global head count, as one process does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pacednegatives_tpu_torch.ops.embedding import embedding_lookup
from pacednegatives_tpu_torch.ops.flash import (
    flash_attention_backward,
    flash_attention_backward_v2,
    flash_attention_forward,
    flash_v2_eligible,
)
from pacednegatives_tpu_torch.ops.flash_v3 import (
    flash_v3_eligible,
    fused_self_attention,
)
from pacednegatives_tpu_torch.parallel.collectives import (
    copy_to_model,
    reduce_from_model,
)
from pacednegatives_tpu_torch.parallel.mesh import current_mesh, model_split

NEG_INF = -1e9  # additive mask value, applied in fp32 (t5.py:33)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The fields of the JAX ``T5Config`` that the port reads. The
    TPU-only knobs (scan, packed heads/lanes, ``flash_q_block``, interpret
    mode) are not carried over; see ROADMAP.md."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_heads: int = 8
    num_layers: int = 6
    num_decoder_layers: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dropout_rate: float = 0.1  # read only with deterministic=False
    tie_word_embeddings: bool = True
    gated_ffn: bool = False  # False = T5 v1.0 ReLU FFN, True = v1.1 gated-GELU
    pad_token_id: int = 0
    decoder_start_token_id: int = 0
    dtype: torch.dtype = torch.float32  # compute dtype for activations
    # run each block under torch.utils.checkpoint (recompute in backward):
    # "full" recomputes everything; "dots" saves every matmul output,
    # (B, H, L, L) scores included; "dots_nobatch" saves the projections'
    # and FFN's and recomputes the attention products
    remat: bool = False
    remat_policy: str = "full"
    # "dense" materialises (B, H, Lq, Lk) scores; "chunked" is exact online
    # softmax over key chunks of attention_chunk with a flash-style
    # backward that recomputes the probabilities from (m, l)
    attention_impl: str = "dense"
    attention_chunk: int = 128
    # with "chunked": 128-aligned shapes of dk 64 / 128 on CUDA run the
    # attention-core kernels (K1 forward, K2b or K2a backward)
    flash_kernel: bool = False
    # train/step.py concatenates q|k|v (self) and k|v (cross) once per step
    # (fuse_attention_params) and splits the gradients back
    fused_qkv: bool = False
    # route eligible encoder self-attention through the fused block
    # (ops/flash_v3.py): CUDA kernels on the card, plain versions on the CPU
    flash_v3: bool = False
    # dtype of the chunked backward's saved attention output: it feeds only
    # delta = sum(g * out), so "bf16" halves it at the cost of one rounding
    attn_residual_dtype: str = "fp32"
    # ReLU FFN through an autograd Function that saves the post-ReLU hidden
    # and takes the ReLU mask as h > 0 (t5.py:1124-1147); the gated FFN
    # ignores it
    ffn_custom_vjp: bool = False

    @staticmethod
    def small() -> "T5Config":
        return T5Config()

    @staticmethod
    def base() -> "T5Config":
        return T5Config(
            d_model=768, d_ff=3072, num_heads=12,
            num_layers=12, num_decoder_layers=12,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "T5Config":
        return T5Config(
            vocab_size=vocab_size, d_model=64, d_kv=16, d_ff=128,
            num_heads=4, num_layers=2, num_decoder_layers=2,
        )

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


# ---------------------------------------------------------------------------
# Init and parameter trees
# ---------------------------------------------------------------------------


def _normal(g: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32) * std


def _init_attention(g, cfg: T5Config, has_rel_bias: bool, device) -> dict:
    d, inner = cfg.d_model, cfg.inner_dim
    # T5 init (t5.py:178-195): q std (d * d_kv)^-0.5 carries the missing
    # 1/sqrt(d_k); k/v d^-0.5; o inner^-0.5
    p = {
        "q": _normal(g, (d, inner), (d * cfg.d_kv) ** -0.5, device),
        "k": _normal(g, (d, inner), d**-0.5, device),
        "v": _normal(g, (d, inner), d**-0.5, device),
        "o": _normal(g, (inner, d), inner**-0.5, device),
    }
    if has_rel_bias:
        p["rel_bias"] = _normal(
            g, (cfg.relative_attention_num_buckets, cfg.num_heads),
            d**-0.5, device,
        )
    return p


def _init_mlp(g, cfg: T5Config, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.gated_ffn:
        return {
            "wi_0": _normal(g, (d, ff), d**-0.5, device),
            "wi_1": _normal(g, (d, ff), d**-0.5, device),
            "wo": _normal(g, (ff, d), ff**-0.5, device),
        }
    return {
        "wi": _normal(g, (d, ff), d**-0.5, device),
        "wo": _normal(g, (ff, d), ff**-0.5, device),
    }


def init_params(cfg: T5Config, generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict:
    """Random fp32 parameters with the JAX package's names and shapes
    (t5.py:213-253), drawn from ``generator`` (which must live on
    ``device``). The draws differ from ``jax.random``'s; tests that compare
    the two packages convert one set of weights (models/convert.py)."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    encoder = {}
    for i in range(cfg.num_layers):
        encoder[f"block_{i}"] = {
            "self_attn": _init_attention(generator, cfg, i == 0, device),
            "ln_self": {"scale": ones()},
            "mlp": _init_mlp(generator, cfg, device),
            "ln_mlp": {"scale": ones()},
        }
    encoder["final_ln"] = {"scale": ones()}
    decoder = {}
    for i in range(cfg.num_decoder_layers):
        decoder[f"block_{i}"] = {
            "self_attn": _init_attention(generator, cfg, i == 0, device),
            "ln_self": {"scale": ones()},
            "cross_attn": _init_attention(generator, cfg, False, device),
            "ln_cross": {"scale": ones()},
            "mlp": _init_mlp(generator, cfg, device),
            "ln_mlp": {"scale": ones()},
        }
    decoder["final_ln"] = {"scale": ones()}
    params = {
        "shared": {"embedding": _normal(
            generator, (cfg.vocab_size, cfg.d_model), 1.0, device)},
        "encoder": encoder,
        "decoder": decoder,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"embedding": _normal(
            generator, (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5,
            device)}
    return params


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict (or to a bare
    tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten_params(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dict -> flat state dict keyed by the ".".joined tree path."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_params(v, key + "."))
        else:
            flat[key] = v
    return flat


def unflatten_params(flat: dict) -> dict:
    """Inverse of ``flatten_params``."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def stack_params(params: dict) -> dict:
    """``block_i`` layout -> stacked ``{"blocks", "rel_bias", "final_ln"}``
    per stack (t5.py:1164-1196): block 0's rel_bias moves out, every other
    leaf gains a leading layer axis."""

    def stack_blocks(blocks):
        cleaned = []
        for b in blocks:
            sa = {k: v for k, v in b["self_attn"].items() if k != "rel_bias"}
            cleaned.append({**b, "self_attn": sa})

        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            return torch.stack(nodes)

        return stack(cleaned)

    def one(stack: dict) -> dict:
        n = sum(k.startswith("block_") for k in stack)
        blocks = [stack[f"block_{i}"] for i in range(n)]
        return {
            "blocks": stack_blocks(blocks),
            "rel_bias": blocks[0]["self_attn"]["rel_bias"],
            "final_ln": stack["final_ln"],
        }

    return {**params, "encoder": one(params["encoder"]),
            "decoder": one(params["decoder"])}


def _num_blocks(stack: dict) -> int:
    if "blocks" in stack:
        return next(iter(flatten_params(stack["blocks"]).values())).shape[0]
    return sum(k.startswith("block_") for k in stack)


def _block(stack: dict, i: int) -> dict:
    """Layer i of a stack in either layout (no rel_bias in stacked blocks)."""
    if "blocks" in stack:
        return tree_map(lambda a: a[i], stack["blocks"])
    return stack[f"block_{i}"]


def unstack_params(params: dict) -> dict:
    """Inverse of ``stack_params`` (t5.py:1199-1220)."""

    def one(stack: dict) -> dict:
        out = {}
        for i in range(_num_blocks(stack)):
            blk = _block(stack, i)
            if i == 0:
                blk = {**blk, "self_attn": {**blk["self_attn"],
                                            "rel_bias": stack["rel_bias"]}}
            out[f"block_{i}"] = blk
        out["final_ln"] = stack["final_ln"]
        return out

    return {**params, "encoder": one(params["encoder"]),
            "decoder": one(params["decoder"])}


def fuse_attention_params(params: dict) -> dict:
    """Self-attention q|k|v -> "qkv" (d, 3*inner) and cross-attention k|v ->
    "kv" (d, 2*inner), originals dropped (t5.py:1223-1257). Serving calls
    it once, since its weights are frozen."""

    def walk(d):
        if not isinstance(d, dict):
            return d
        out = {}
        for name, v in d.items():
            if name == "self_attn" and isinstance(v, dict) and "q" in v:
                v = {**{k: x for k, x in v.items() if k not in ("q", "k", "v")},
                     "qkv": torch.cat([v["q"], v["k"], v["v"]], dim=-1)}
            elif name == "cross_attn" and isinstance(v, dict) and "k" in v:
                v = {**{k: x for k, x in v.items() if k not in ("k", "v")},
                     "kv": torch.cat([v["k"], v["v"]], dim=-1)}
            else:
                v = walk(v)
            out[name] = v
        return out

    return walk(params)


def split_attention_grads(grads: dict) -> dict:
    """Inverse of ``fuse_attention_params`` for gradient trees: split "qkv"
    / "kv" cotangents back into per-projection leaves (t5.py:1260-1288)."""

    def walk(d):
        if not isinstance(d, dict):
            return d
        out = {}
        for name, v in d.items():
            if isinstance(v, dict) and "qkv" in v:
                a, b, c = v["qkv"].chunk(3, dim=-1)
                v = {**{k: x for k, x in v.items() if k != "qkv"},
                     "q": a, "k": b, "v": c}
            elif isinstance(v, dict) and "kv" in v:
                a, b = v["kv"].chunk(2, dim=-1)
                v = {**{k: x for k, x in v.items() if k != "kv"},
                     "k": a, "v": b}
            else:
                v = walk(v)
            out[name] = v
        return out

    return walk(grads)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dtype: torch.dtype) -> torch.Tensor:
    """T5 layer norm: no mean subtraction, no bias; variance in fp32."""
    h = x.float()
    var = h.square().mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * scale).to(dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's log-spaced buckets, as t5.py:281-304 computes them: an fp32 log
    of n / max_exact + 1e-6 and an int32 truncation, so every bucket
    matches the JAX package's exactly."""
    ret = torch.zeros_like(relative_position, dtype=torch.int32)
    n = -relative_position.to(torch.int32)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(rel_bias: torch.Tensor, q_len: int, k_len: int,
                          bidirectional: bool, num_buckets: int,
                          max_distance: int) -> torch.Tensor:
    """(1, heads, q_len, k_len) additive attention bias, fp32."""
    dev = rel_bias.device
    ctx = torch.arange(q_len, device=dev)[:, None]
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional, num_buckets,
                                       max_distance)
    bias = rel_bias.float()[buckets.long()]  # (q, k, heads)
    return bias.permute(2, 0, 1)[None]


def _dropout_seeds(seed: int | None, n: int) -> list:
    """``n`` independent 64-bit seeds from ``seed``, on the host (the
    counterpart of ``jax.random.split``); ``[None] * n`` for no seed."""
    if seed is None:
        return [None] * n
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n, np.uint64)]


def _dropout(x: torch.Tensor, rate: float, seed: int | None,
             deterministic: bool, heads: tuple | None = None) -> torch.Tensor:
    """t5.py:325-329: keep each element with probability 1 - rate and scale
    it by 1 / (1 - rate), in x's dtype; x itself at rate 0. The mask comes
    from a generator seeded with ``seed`` on x's device, so a recomputed
    block draws the same mask as its forward. ``heads`` = (H, first): x
    holds heads first .. first + x.shape[1] - 1 of H (a tensor-parallel
    rank's), and its mask is those heads' of the H-head mask one process
    draws."""
    if deterministic or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("deterministic=False needs a dropout seed")
    g = torch.Generator(device=x.device).manual_seed(seed)
    shape = x.shape if heads is None else (x.shape[0], heads[0],
                                           *x.shape[2:])
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - rate
    if heads is not None:
        keep = keep[:, heads[1]:heads[1] + x.shape[1]]
    # JAX divides by the weak-typed 1 - rate, which takes x's dtype
    scale = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / scale, 0.0).to(x.dtype)


def _combine_bias(bias):
    """A combined fp32 bias, or a lazy (shared, per_batch) tuple of additive
    components (either may be None), summed as t5.py:332-342 sums them."""
    if isinstance(bias, tuple):
        a, b = bias
        if a is None:
            return b
        if b is None:
            return a
        return a + b
    return bias


def attention(p: dict, cfg: T5Config, x: torch.Tensor, kv: torch.Tensor,
              bias, *, dropout_seed: int | None = None,
              deterministic: bool = True) -> torch.Tensor:
    """Multi-head attention, T5-style (no 1/sqrt(d_k) scaling).

    x (B, Lq, D) queries source; kv (B, Lk, D); bias fp32 additive
    (1|B, H, Lq, Lk), either combined or a lazy (shared (1, H, Lq, Lk),
    per-batch (B, 1, 1, Lk)) tuple. With ``deterministic=False`` the dense
    path drops attention weights (t5.py:614-617); flash_v3 and chunked
    attention refuse it (``_check_training_knobs``)."""
    B, Lq, d_in = x.shape
    Lk = kv.shape[1]
    H, dk = cfg.num_heads, cfg.d_kv
    dt = cfg.dtype
    # this rank's heads: all H, or H / model of a split layer
    w_in = p["qkv"].shape[-1] // 3 if "qkv" in p else p["q"].shape[-1]
    H_l = w_in // dk
    tp = model_split(H_l, H)

    # flash_v3 routing, as t5.py:400-533: deterministic (the stacks refuse
    # flash_v3 with dropout), self-attention (x is kv), a lazy tuple bias,
    # an eligible shape and a shared bias of batch 1. Decoder self-attention (Lt = 1), cross-
    # attention and packed buckets shorter than 64 stay on the dense path.
    if cfg.flash_v3 and x is kv and isinstance(bias, tuple):
        # under a mesh the rows here are this rank's block, which
        # parallel/mesh.local_rows split off (and refused to split
        # unevenly, as the JAX shard_map wrapper refuses, t5.py:490-496);
        # the fused block keeps the full attention weights on each rank, so
        # it refuses tensor parallelism (t5.py:437-443)
        mesh = current_mesh()
        if mesh is not None and mesh.model > 1:
            raise ValueError(
                "flash_v3 does not compose with tensor (model-axis) "
                "parallelism: the fused block kernel keeps the full "
                "attention weights per device; set model=1 or disable "
                "flash_v3.")
        shared, per_batch = bias
        shared_ok = shared is None or shared.shape[0] == 1
        if flash_v3_eligible(H, Lq, Lk, dk, d_in) and shared_ok:
            # serving hands in the pre-fused "qkv" leaf (Reranker); the
            # use-site concat matches the JAX fallback (t5.py:476-479)
            w3 = p["qkv"] if "qkv" in p else torch.cat(
                [p["q"], p["k"], p["v"]], dim=-1)
            pos3 = (shared[0].expand(H, Lq, Lk).float().contiguous()
                    if shared is not None
                    else torch.zeros((H, Lq, Lk), device=x.device))
            key_mask = (per_batch.reshape(B, Lk).float().contiguous()
                        if per_batch is not None
                        else torch.zeros((B, Lk), device=x.device))
            return fused_self_attention(
                x, w3.to(dt), p["o"].to(dt), pos3, key_mask)
        if Lq == Lk and Lq >= 64:
            # an encoder-sized shape the kernel cannot take: say so rather
            # than let a flash_v3 run measure the dense path (t5.py:517-533)
            warnings.warn(
                f"flash_v3 requested but ineligible for self-attention shape "
                f"H={H} Lq={Lq} Lk={Lk} dk={dk} d_model={d_in} "
                f"(shared_bias_batch_ok={shared_ok}); using the dense path",
                stacklevel=2,
            )

    if tp is not None:
        self_attn = x is kv
        x = copy_to_model(x, tp)
        kv = x if self_attn else copy_to_model(kv, tp)

    def heads(t, L):  # (B, L, H_l*dk) -> (B, H_l, L, dk)
        return t.view(B, L, H_l, dk).transpose(1, 2)

    if "qkv" in p:
        q, k, v = (heads(t, Lq) for t in
                   torch.matmul(x, p["qkv"].to(dt)).chunk(3, dim=-1))
    else:
        q = heads(torch.matmul(x, p["q"].to(dt)), Lq)
        if "kv" in p:
            k, v = (heads(t, Lk) for t in
                    torch.matmul(kv, p["kv"].to(dt)).chunk(2, dim=-1))
        else:
            k = heads(torch.matmul(kv, p["k"].to(dt)), Lk)
            v = heads(torch.matmul(kv, p["v"].to(dt)), Lk)

    if cfg.attn_residual_dtype != "fp32" and cfg.attention_impl != "chunked":
        # the residual lives in the chunked backward (t5.py:591-597)
        raise ValueError(
            "attn_residual_dtype='bf16' requires attention_impl='chunked' "
            "(dense attention has no flash-style residual to reduce)"
        )
    if cfg.attention_impl == "chunked":
        out = _chunked_attention(cfg, q, k, v, bias)
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores + _combine_bias(bias)
        # a split layer's mask: its heads' of the H-head mask
        heads_of = () if tp is None else ((H, tp.model_rank * H_l),)
        weights = _dropout(torch.softmax(scores, dim=-1).to(dt),
                           cfg.dropout_rate, dropout_seed, deterministic,
                           *heads_of)
        out = torch.matmul(weights, v)  # (B, H_l, Lq, dk)
    return reduce_from_model(torch.matmul(
        out.transpose(1, 2).reshape(B, Lq, H_l * dk), p["o"].to(dt)), tp)


# ---------------------------------------------------------------------------
# Chunked attention (t5.py:732-1121)
# ---------------------------------------------------------------------------


def _chunked_attention(cfg: T5Config, q, k, v, bias) -> torch.Tensor:
    """Online-softmax attention over key chunks with a flash-style
    backward. q/k/v (B, H, L, dk) head-major; returns (B, H, Lq, dk) in the
    compute dtype. Keys are padded to a multiple of the chunk with NEG_INF
    bias (t5.py:748-768)."""
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    C = min(cfg.attention_chunk, Lk)
    shared, per_batch = bias if isinstance(bias, tuple) else (bias, None)
    dev = q.device

    pad = (-Lk) % C
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        if shared is not None:
            shared = F.pad(shared, (0, pad), value=NEG_INF)
        if per_batch is not None:
            per_batch = F.pad(per_batch, (0, pad), value=NEG_INF)
        elif shared is None:
            # no masks at all: mask the padded keys explicitly
            per_batch = torch.where(
                torch.arange(Lk + pad, device=dev) < Lk, 0.0, NEG_INF
            ).float()[None, None, None, :]
    if shared is None:
        shared = torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=dev)
    if per_batch is None:
        per_batch = torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=dev)

    impl = ("kernel" if cfg.flash_kernel
            and pallas_flash_eligible(Lq, k.shape[2], dk, dev) else "plain")
    if cfg.attn_residual_dtype not in ("fp32", "bf16"):
        raise ValueError(
            f"attn_residual_dtype must be 'fp32' or 'bf16', "
            f"got {cfg.attn_residual_dtype!r}"
        )
    # the backward kernel is chosen on the model's head count, so that a
    # tensor-parallel rank runs the kernel (and numerics) one process runs
    out = flash_core(C, impl, cfg.attn_residual_dtype, q, k, v, shared,
                     per_batch, route_heads=cfg.num_heads)
    return out.to(cfg.dtype)


def _unbroadcast(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum-reduce x back to a broadcastable input shape."""
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape))
                 if b == 1 and a != 1)
    return x.sum(dim=axes, keepdim=True) if axes else x


def _bias_chunk(src: torch.Tensor, j: int, C: int) -> torch.Tensor:
    """Chunk j along the key axis; a size-1 (broadcast) axis passes
    through."""
    if src.shape[3] == 1:
        return src
    return src[..., j * C:(j + 1) * C]


def _flash_forward(C, q, k, v, shared, per_batch):
    """The plain route's forward: (out (B, H, Lq, dk) fp32, (m, l, out)).
    One softmax when the keys are one chunk, else the online-softmax loop
    over chunks (t5.py:798-845)."""
    B, H, Lq, dk = q.shape
    n_chunks = k.shape[2] // C
    qf = q.float()

    if n_chunks == 1:
        s = torch.matmul(qf, k.float().transpose(-1, -2))
        s = s + shared + per_batch  # dummies are zeros (1, 1, 1, 1)
        m = s.amax(dim=-1)
        p_ = torch.exp(s - m[..., None])
        l = p_.sum(dim=-1).clamp_min(1e-30)
        out = torch.matmul(p_.to(v.dtype).float(), v.float()) / l[..., None]
        return out, (m, l, out)

    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, dk), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        k_j = k[:, :, j * C:(j + 1) * C]
        v_j = v[:, :, j * C:(j + 1) * C]
        s = torch.matmul(qf, k_j.float().transpose(-1, -2))
        s = s + _bias_chunk(shared, j, C) + _bias_chunk(per_batch, j, C)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new[..., None])
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p_.to(v_j.dtype).float(),
                                                   v_j.float())
        m = m_new
    l = l.clamp_min(1e-30)
    out = acc / l[..., None]
    return out, (m, l, out)


def _flash_backward(C, res, g, need_shared, need_per_batch):
    """The plain route's backward (t5.py:991-1118): probabilities recomputed
    per chunk from (m, l); products take compute-dtype operands with fp32
    accumulation, the softmax algebra stays fp32. Bias gradients only where
    asked for."""
    q, k, v, shared, per_batch, m, l, out_res = res
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    n_chunks = Lk // C
    cdt = q.dtype
    g32 = g.float()
    # delta from the (possibly bf16) residual, accumulated in fp32
    D = (g32 * out_res.float()).sum(dim=-1)
    g_c = g32.to(cdt).float()
    qf, kf, vf = q.float(), k.float(), v.float()

    def zeros_like_bias(src):
        return torch.zeros(src.shape, dtype=torch.float32, device=q.device)

    dq = torch.zeros((B, H, Lq, dk), dtype=torch.float32, device=q.device)
    dk_ = torch.empty((B, H, Lk, dk), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, H, Lk, dk), dtype=torch.float32, device=q.device)
    dshared = zeros_like_bias(shared) if need_shared else None
    dper = zeros_like_bias(per_batch) if need_per_batch else None
    for j in range(n_chunks):
        cols = slice(j * C, (j + 1) * C)
        s = torch.matmul(qf, kf[:, :, cols].transpose(-1, -2))
        s = s + _bias_chunk(shared, j, C) + _bias_chunk(per_batch, j, C)
        p_ = torch.exp(s - m[..., None]) / l[..., None]  # (B, H, Lq, C)
        dv[:, :, cols] = torch.matmul(p_.to(cdt).float().transpose(-1, -2),
                                      g_c)
        dp = torch.matmul(g_c, vf[:, :, cols].transpose(-1, -2))
        ds = p_ * (dp - D[..., None])
        ds_c = ds.to(cdt).float()
        dq += torch.matmul(ds_c, kf[:, :, cols])
        dk_[:, :, cols] = torch.matmul(ds_c.transpose(-1, -2), qf)
        for acc, src in ((dshared, shared), (dper, per_batch)):
            if acc is None:
                continue
            if src.shape[3] == 1:
                acc += _unbroadcast(ds, src.shape)
            else:
                acc[..., cols] += _unbroadcast(ds, src.shape[:3] + (C,))
    return (dq.to(q.dtype), dk_.to(k.dtype), dv.to(v.dtype),
            None if dshared is None else dshared.to(shared.dtype),
            None if dper is None else dper.to(per_batch.dtype))


def pallas_flash_eligible(Lq: int, Lk_padded: int, dk: int, device) -> bool:
    """Shape gate of the kernel route, the TPU's kept (t5.py:896-905):
    128-aligned query and padded key lengths and dk 64 or 128. Where the
    JAX gate asks for a TPU backend, this one asks for CUDA tensors (the
    CUDA kernels would take any length; the gate stays the JAX package's so
    that both run the same numerics on the same shapes)."""
    return (Lq % 128 == 0 and Lk_padded % 128 == 0 and dk in (64, 128)
            and torch.device(device).type == "cuda")


def _kernel_biases(shared, per_batch, B, H, Lq, Lk):
    """(pos (H, Lq, Lk), key_mask (B, Lk)), contiguous fp32, from the lazy
    pair; zeros for a dummy (t5.py:866-875)."""
    dev = shared.device
    if shared.shape[3] == 1:
        pos3 = torch.zeros((H, Lq, Lk), dtype=torch.float32, device=dev)
    else:
        pos3 = shared[0].expand(H, Lq, Lk).float().contiguous()
    if per_batch.shape[3] == 1:
        key_mask = torch.zeros((B, Lk), dtype=torch.float32, device=dev)
    else:
        key_mask = per_batch[:, 0, 0, :].expand(B, Lk).float().contiguous()
    return pos3, key_mask


def _pallas_forward(q, k, v, shared, per_batch):
    """The kernel route's forward (t5.py:851-893): K1 with fp32 output, the
    same contract as ``_flash_forward``. The JAX route picks K1b where
    ``flash_v2_eligible`` and K1a elsewhere; both are one CUDA kernel."""
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    pos3, key_mask = _kernel_biases(shared, per_batch, B, H, Lq, Lk)
    out, m, l = flash_attention_forward(q, k, v, pos3, key_mask,
                                        torch.float32)
    return out, (m, l, out)


def backward_route(route_heads: int, Lq: int, Lk: int, dk: int) -> str:
    """"k2b" or "k2a": the kernel route's backward for a model of
    ``route_heads`` heads (``flash_v2_eligible`` on the whole model's H,
    whatever share of the heads a rank holds)."""
    return "k2b" if flash_v2_eligible(route_heads, Lq, Lk, dk) else "k2a"


def _pallas_backward(res, g, need_shared, route_heads=None):
    """The kernel route's backward (t5.py:946-988): K2b where
    ``flash_v2_eligible`` on ``route_heads`` (default: q's heads), else
    K2a. The per-batch key mask gets no gradient: it comes from integer
    attention masks and never requires one."""
    q, k, v, shared, per_batch, m, l, out_res = res
    B, H, Lq, dk = q.shape
    Lk = k.shape[2]
    pos3, key_mask = _kernel_biases(shared, per_batch, B, H, Lq, Lk)
    g32 = g.float().contiguous()
    D = (g32 * out_res.float()).sum(dim=-1)  # (B, H, Lq)
    bwd = (flash_attention_backward_v2
           if backward_route(route_heads or H, Lq, Lk, dk) == "k2b"
           else flash_attention_backward)
    dq, dk_, dv, dpos = bwd(q, k, v, pos3, key_mask, m, l, D, g32)
    dshared = None
    if need_shared and shared.shape[3] != 1:
        dshared = _unbroadcast(dpos[None], shared.shape).to(shared.dtype)
    return dq.to(q.dtype), dk_.to(k.dtype), dv.to(v.dtype), dshared, None


class _FlashCore(torch.autograd.Function):
    """The chunked core with its flash-style backward: the port of the
    ``custom_vjp`` ``_flash_core`` (t5.py:929-988, 1121). ``impl`` is
    "plain" (t5.py's XLA route) or "kernel" (K1 forward, K2b / K2a
    backward). Saves (q, k, v, biases, m, l, out), with out in
    ``res_dtype``; returns out (B, H, Lq, dk) fp32. The plain route is
    twice differentiable; the kernel route's backward raises under
    ``create_graph=True``. ``route_heads`` picks the kernel route's
    backward (``backward_route``)."""

    @staticmethod
    def forward(ctx, C, impl, res_dtype, q, k, v, shared, per_batch,
                route_heads=None):
        if impl == "kernel":
            out, (m, l, _) = _pallas_forward(q, k, v, shared, per_batch)
        else:
            out, (m, l, _) = _flash_forward(C, q, k, v, shared, per_batch)
        # the residual feeds only delta = sum(g * out); (m, l) stay fp32
        res = out.to(torch.bfloat16) if res_dtype == "bf16" else out
        ctx.save_for_backward(q, k, v, shared, per_batch, m, l, res)
        ctx.C, ctx.impl, ctx.route_heads = C, impl, route_heads
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.impl == "kernel" and torch.is_grad_enabled():
            # create_graph=True: the kernels' outputs carry no autograd
            # history, so a gradient through this gradient would silently
            # drop terms; the plain route's backward is torch ops and
            # differentiates again
            raise NotImplementedError(
                "the attention-core kernels (K1 / K2b / K2a) have no double "
                "backward: a gradient through their gradient "
                "(create_graph=True) is not supported; use flash_kernel=False")
        res = ctx.saved_tensors
        need_shared, need_per_batch = ctx.needs_input_grad[6:8]
        if ctx.impl == "kernel":
            grads = _pallas_backward(res, g, need_shared, ctx.route_heads)
        else:
            grads = _flash_backward(ctx.C, res, g, need_shared,
                                    need_per_batch)
        return (None, None, None, *grads, None)


def flash_core(C: int, impl: str, res_dtype: str, q, k, v, shared,
               per_batch, route_heads: int | None = None) -> torch.Tensor:
    """``_FlashCore`` as a function: out (B, H, Lq, dk) fp32 of q/k/v
    (B, H, L, dk) with keys a multiple of C long and the additive biases
    ``shared`` and ``per_batch`` (4-D, broadcastable; (1, 1, 1, 1) zeros
    for none)."""
    return _FlashCore.apply(C, impl, res_dtype, q, k, v, shared, per_batch,
                            route_heads)


class _ReluFFN(torch.autograd.Function):
    """relu(x . wi) . wo saving (x, wi, wo, h) with h after the ReLU; the
    backward takes the ReLU's mask as h > 0 (``_relu_ffn``,
    t5.py:1124-1147: exact wherever the pre-activation is not 0, and both
    derivatives are 0 where it is)."""

    @staticmethod
    def forward(ctx, x, wi, wo):
        h = torch.relu(torch.matmul(x, wi))
        ctx.save_for_backward(x, wi, wo, h)
        return torch.matmul(h, wo)

    @staticmethod
    def backward(ctx, g):
        x, wi, wo, h = ctx.saved_tensors
        dh = torch.matmul(g, wo.t())
        ds = torch.where(h > 0, dh, torch.zeros((), dtype=dh.dtype,
                                                device=dh.device))
        dx = torch.matmul(ds, wi.t())
        dwi = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                           ds.reshape(-1, ds.shape[-1]))
        dwo = torch.matmul(h.reshape(-1, h.shape[-1]).t(),
                           g.reshape(-1, g.shape[-1]))
        return dx, dwi, dwo


def mlp(p: dict, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    """The FFN; split over the model group when this rank holds d_ff /
    model of it (wi* column-parallel, wo row-parallel)."""
    dt = cfg.dtype
    tp = model_split(p["wo"].shape[0], cfg.d_ff)
    x = copy_to_model(x, tp)
    if cfg.gated_ffn:
        # tanh GELU == HF NewGELUActivation, as jax.nn.gelu(approximate=True)
        h = torch.nn.functional.gelu(
            torch.matmul(x, p["wi_0"].to(dt)), approximate="tanh"
        ) * torch.matmul(x, p["wi_1"].to(dt))
    elif cfg.ffn_custom_vjp:
        return reduce_from_model(
            _ReluFFN.apply(x, p["wi"].to(dt), p["wo"].to(dt)), tp)
    else:
        h = torch.relu(torch.matmul(x, p["wi"].to(dt)))
    return reduce_from_model(torch.matmul(h, p["wo"].to(dt)), tp)


def embed_tokens(table: torch.Tensor, ids: torch.Tensor,
                 cfg: T5Config) -> torch.Tensor:
    """``table[ids]``: the rows of a (vocab, D) embedding table, through
    ``ops.embedding.embedding_lookup`` (its backward a segmented sum). A
    rank holding vocab / model rows of it looks up the ids in its range,
    zeroes the others' rows and sums over the model group (one nonzero
    term: the exact row); the gradient reaches only its own rows."""
    tp = model_split(table.shape[0], cfg.vocab_size)
    if tp is None:
        return embedding_lookup(table, ids)
    local = ids.long() - tp.model_rank * table.shape[0]
    inside = (local >= 0) & (local < table.shape[0])
    rows = embedding_lookup(table, torch.where(inside, local, 0))
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return reduce_from_model(torch.where(inside[..., None], rows, zero), tp)


def _rel_bias(stack: dict) -> torch.Tensor:
    if "rel_bias" in stack:
        return stack["rel_bias"]
    return stack["block_0"]["self_attn"]["rel_bias"]


def _padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} mask -> (B, 1, 1, L) fp32 additive bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, neg)


def _causal_bias(L: int, device) -> torch.Tensor:
    causal = torch.ones((L, L), dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(causal, zero, neg)[None, None]


def position_bias_from_tables(enc_rel_bias: torch.Tensor,
                              dec_rel_bias: torch.Tensor, cfg: T5Config,
                              l_enc: int, l_dec: int) -> dict:
    """The (1, H, L, L) position biases of one step from the two (buckets,
    H) tables (t5.py:1326-1346): {"enc", "dec_self"}, the decoder's with
    the causal mask added. The train step computes them once and passes
    them to every microbatch's ``forward_logits``."""
    nb, md = cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance
    enc = compute_position_bias(enc_rel_bias, l_enc, l_enc, True, nb, md)
    dec = compute_position_bias(dec_rel_bias, l_dec, l_dec, False, nb, md)
    return {"enc": enc,
            "dec_self": dec + _causal_bias(l_dec, dec_rel_bias.device)}


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _check_training_knobs(cfg: T5Config, deterministic: bool) -> None:
    if not deterministic and cfg.flash_v3:
        # as t5.py:400-407: a silent fallback to the dense path would
        # mislabel a flash_v3 run as measuring the kernels
        raise ValueError(
            "flash_v3 does not support attention-weight dropout (training "
            "with dropout=True); disable dropout or flash_v3."
        )
    if not deterministic and cfg.attention_impl == "chunked":
        # as t5.py:584-590: a dense fallback would materialise the scores
        # chunking exists to avoid
        raise ValueError(
            "attention_impl='chunked' does not support attention-weight "
            "dropout (training with dropout=True); use dense attention or "
            "disable dropout."
        )
    if cfg.remat and cfg.remat_policy not in REMAT_SAVED_OPS:
        raise ValueError(
            f"remat_policy must be one of {sorted(REMAT_SAVED_OPS)}, got "
            f"{cfg.remat_policy!r}"
        )


_aten = torch.ops.aten
# the ops whose outputs each policy saves (t5.py:261-270): "dots" is
# jax.checkpoint_policies.dots_saveable, "dots_nobatch"
# dots_with_no_batch_dims_saveable. The port's projections and FFN
# (torch.matmul of a 3-D activation by a 2-D weight) dispatch to aten.mm,
# its attention products to aten.bmm.
REMAT_SAVED_OPS = {
    "full": (),
    "dots": (_aten.mm.default, _aten.bmm.default),
    "dots_nobatch": (_aten.mm.default,),
}


def remat_policy_fn(saved_ops):
    """The selective-checkpoint policy that saves the outputs of
    ``saved_ops`` and recomputes every other op."""

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _remat_contexts(policy: str):
    return create_selective_checkpoint_contexts(
        remat_policy_fn(REMAT_SAVED_OPS[policy]))


def _run_block(cfg: T5Config, fn, *args):
    """One block, under torch.utils.checkpoint when cfg.remat (the
    counterpart of jax.checkpoint with ``cfg.remat_policy``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(_remat_contexts,
                                                   cfg.remat_policy))


def encode(params: dict, cfg: T5Config, input_ids: torch.Tensor,
           attention_mask: torch.Tensor | None = None, *,
           deterministic: bool = True, dropout_seed: int | None = None,
           pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder stack: (B, L) token ids -> (B, L, D) hidden states. With
    ``deterministic=False``, dropout with masks from ``dropout_seed``."""
    _check_training_knobs(cfg, deterministic)
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    enc = params["encoder"]
    dt = cfg.dtype
    L = input_ids.shape[1]
    n_blocks = _num_blocks(enc)
    # one seed per dropout site: three a block (attention weights, the
    # attention residual, the FFN residual), the final norm, the embedding
    seeds = _dropout_seeds(dropout_seed, 3 * n_blocks + 2)
    x = _dropout(embed_tokens(params["shared"]["embedding"].to(dt),
                              input_ids, cfg),
                 cfg.dropout_rate, seeds[-1], deterministic)
    if pos_bias is None:
        pos_bias = compute_position_bias(
            _rel_bias(enc), L, L, True,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        )
    # the lazy (shared, per-batch) pair: the dense path sums them; the
    # fused block takes them apart
    bias = (pos_bias, _padding_bias(attention_mask))
    eps = cfg.layer_norm_epsilon

    def drop(t, seed):
        return _dropout(t, cfg.dropout_rate, seed, deterministic)

    def block(x, blk, bias, s_attn, s_res, s_ffn):
        h = rms_norm(x, blk["ln_self"]["scale"], eps, dt)
        a = attention(blk["self_attn"], cfg, h, h, bias,
                      dropout_seed=s_attn, deterministic=deterministic)
        x = x + drop(a, s_res)
        h = rms_norm(x, blk["ln_mlp"]["scale"], eps, dt)
        return x + drop(mlp(blk["mlp"], cfg, h), s_ffn)

    for i in range(n_blocks):
        x = _run_block(cfg, block, x, _block(enc, i), bias,
                       *seeds[3 * i:3 * i + 3])
    return drop(rms_norm(x, enc["final_ln"]["scale"], eps, dt), seeds[-2])


def decode(params: dict, cfg: T5Config, decoder_input_ids: torch.Tensor,
           encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor, *,
           deterministic: bool = True, dropout_seed: int | None = None,
           self_pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder stack with teacher forcing -> (B, Lt, vocab) fp32 logits
    (a tensor-parallel rank's: (B, Lt, vocab / model), its vocab columns).
    With ``deterministic=False``, dropout with masks from
    ``dropout_seed``."""
    _check_training_knobs(cfg, deterministic)
    dec = params["decoder"]
    dt = cfg.dtype
    Lt = decoder_input_ids.shape[1]
    emb = params["shared"]["embedding"].to(dt)
    n_blocks = _num_blocks(dec)
    # five seeds a block (self-attention weights and residual,
    # cross-attention weights and residual, the FFN residual), the final
    # norm, the embedding
    seeds = _dropout_seeds(dropout_seed, 5 * n_blocks + 2)
    x = _dropout(embed_tokens(emb, decoder_input_ids, cfg),
                 cfg.dropout_rate, seeds[-1], deterministic)
    if self_pos_bias is None:
        self_pos_bias = compute_position_bias(
            _rel_bias(dec), Lt, Lt, False,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        ) + _causal_bias(Lt, x.device)
    self_bias = (self_pos_bias, None)
    cross_bias = (None, _padding_bias(encoder_mask))
    eps = cfg.layer_norm_epsilon

    def drop(t, seed):
        return _dropout(t, cfg.dropout_rate, seed, deterministic)

    def block(x, blk, self_bias, cross_bias, enc_h, s_self, s_self_res,
              s_cross, s_cross_res, s_ffn):
        h = rms_norm(x, blk["ln_self"]["scale"], eps, dt)
        a = attention(blk["self_attn"], cfg, h, h, self_bias,
                      dropout_seed=s_self, deterministic=deterministic)
        x = x + drop(a, s_self_res)
        h = rms_norm(x, blk["ln_cross"]["scale"], eps, dt)
        a = attention(blk["cross_attn"], cfg, h, enc_h, cross_bias,
                      dropout_seed=s_cross, deterministic=deterministic)
        x = x + drop(a, s_cross_res)
        h = rms_norm(x, blk["ln_mlp"]["scale"], eps, dt)
        return x + drop(mlp(blk["mlp"], cfg, h), s_ffn)

    for i in range(n_blocks):
        x = _run_block(cfg, block, x, _block(dec, i), self_bias, cross_bias,
                       encoder_hidden, *seeds[5 * i:5 * i + 5])
    x = drop(rms_norm(x, dec["final_ln"]["scale"], eps, dt), seeds[-2])
    # fp32-accumulated LM head (t5.py:1553-1565); the full-vocab product is
    # a plain matmul outside any kernel. A rank holding vocab / model rows
    # of the head gives those columns; the fp32 input's gradient is summed
    # over the model group in fp32, then cast once
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model**-0.5)
        head = emb
    else:
        head = params["lm_head"]["embedding"].to(dt)
    tp = model_split(head.shape[0], cfg.vocab_size)
    return torch.matmul(copy_to_model(x.float(), tp), head.float().t())


def shift_right(labels: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """Teacher-forcing decoder inputs from labels (-100 treated as pad)."""
    labels = torch.where(labels == -100, cfg.pad_token_id, labels)
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    return torch.cat([start, labels[:, :-1]], dim=1)


def forward_logits(params: dict, cfg: T5Config, input_ids: torch.Tensor,
                   labels: torch.Tensor,
                   attention_mask: torch.Tensor | None = None, *,
                   deterministic: bool = True,
                   dropout_seed: int | None = None,
                   pos_biases: dict | None = None) -> torch.Tensor:
    """Full seq2seq forward (t5.py:1580-1609): one teacher-forced pass,
    (B, L) prompts and (B, Lt) labels -> (B, Lt, vocab) fp32 logits.
    ``pos_biases``: precomputed {"enc", "dec_self"} from
    ``position_bias_from_tables``; ``dropout_seed``: the masks' seed with
    ``deterministic=False``."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    s_enc, s_dec = _dropout_seeds(dropout_seed, 2)
    enc = encode(params, cfg, input_ids, attention_mask,
                 deterministic=deterministic, dropout_seed=s_enc,
                 pos_bias=pos_biases["enc"] if pos_biases else None)
    return decode(params, cfg, shift_right(labels, cfg), enc, attention_mask,
                  deterministic=deterministic, dropout_seed=s_dec,
                  self_pos_bias=pos_biases["dec_self"] if pos_biases else None)
