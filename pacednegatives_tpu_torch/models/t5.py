"""T5 encoder-decoder forward in PyTorch: the port of models/t5.py.

Parameters are a nested dict of tensors with the JAX package's tree paths
and orientation: every projection is (in, out) and is applied as ``x @ w``.
Its flat form (``flatten_params``) is a state dict whose keys are those
paths joined with ".", e.g. ``encoder.block_0.self_attn.q``, so converting
a JAX checkpoint is a flatten plus ``torch.from_numpy`` (models/convert.py).

The slice ported here is the deterministic forward, for serving and for
training by autograd: ``encode`` and ``decode`` over the ``block_i`` or
stacked ``blocks`` layout, with plain or fused (``qkv`` / ``kv``) attention
leaves, and the teacher-forced ``forward_logits``. Numerics follow the JAX
package: activations in ``cfg.dtype``, RMSNorm and softmax in fp32, scores
accumulated in fp32, ``NEG_INF`` added (not -inf) for masks. Encoder
self-attention goes through the fused-block kernels (forward K3, backward
K4) when ``cfg.flash_v3`` is set and the shape is eligible, routed exactly
as ``attention`` in the JAX package routes it (t5.py:400-533).

Gradients reach ``rel_bias`` through ``compute_position_bias`` (a gather,
so autograd scatters the bias cotangent back into the table) and, on the
fused path, through the kernel's dpos. The JAX step gets the same gradient
by precomputing the biases once per step and folding their vjp back into
the table (train/step.py:165-178, 301-305); autograd needs no such step.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch
import torch.utils.checkpoint

from pacednegatives_tpu_torch.ops.flash_v3 import (
    flash_v3_eligible,
    fused_self_attention,
)

NEG_INF = -1e9  # additive mask value, applied in fp32 (t5.py:33)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The fields of the JAX ``T5Config`` that the port reads. Dropout
    (``dropout_rate`` with ``deterministic=False``), the chunked attention
    path and ``flash_kernel`` are carried so that a config can be converted
    and checked, and raise ``NotImplementedError`` where they would act
    (ROADMAP.md, the next training slice). The TPU-only knobs (scan, packed
    heads/lanes, interpret mode) are not carried over; see ROADMAP.md."""

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
    dropout_rate: float = 0.1  # read only by deterministic=False (not ported)
    tie_word_embeddings: bool = True
    gated_ffn: bool = False  # False = T5 v1.0 ReLU FFN, True = v1.1 gated-GELU
    pad_token_id: int = 0
    decoder_start_token_id: int = 0
    dtype: torch.dtype = torch.float32  # compute dtype for activations
    # run each block under torch.utils.checkpoint (recompute in backward);
    # only the "full" policy is ported (the dots policies: ROADMAP.md)
    remat: bool = False
    remat_policy: str = "full"
    # "dense" only; "chunked" is not ported yet (ROADMAP.md, queue 1)
    attention_impl: str = "dense"
    # the Mosaic attention-core kernels of the chunked path: not ported yet
    flash_kernel: bool = False
    # train/step.py concatenates q|k|v (self) and k|v (cross) once per step
    # (fuse_attention_params) and splits the gradients back
    fused_qkv: bool = False
    # route eligible encoder self-attention through the fused block
    # (ops/flash_v3.py): CUDA kernels on the card, plain versions on the CPU
    flash_v3: bool = False

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
              bias) -> torch.Tensor:
    """Multi-head attention, T5-style (no 1/sqrt(d_k) scaling).

    x (B, Lq, D) queries source; kv (B, Lk, D); bias fp32 additive
    (1|B, H, Lq, Lk), either combined or a lazy (shared (1, H, Lq, Lk),
    per-batch (B, 1, 1, Lk)) tuple. Deterministic only (no dropout)."""
    B, Lq, d_in = x.shape
    Lk = kv.shape[1]
    H, dk = cfg.num_heads, cfg.d_kv
    dt = cfg.dtype

    if cfg.attention_impl != "dense" or cfg.flash_kernel:
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r}, flash_kernel="
            f"{cfg.flash_kernel} is not ported yet (ROADMAP.md slice T2: the "
            "chunked path with its custom VJP and the K2a/K2b kernels); use "
            "'dense', optionally with flash_v3=True"
        )

    # flash_v3 routing, as t5.py:400-533: deterministic (always, here),
    # self-attention (x is kv), a lazy tuple bias, an eligible shape and a
    # shared bias of batch 1. Decoder self-attention (Lt = 1), cross-
    # attention and packed buckets shorter than 64 stay on the dense path.
    if cfg.flash_v3 and x is kv and isinstance(bias, tuple):
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

    def heads(t, L):  # (B, L, H*dk) -> (B, H, L, dk)
        return t.view(B, L, H, dk).transpose(1, 2)

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

    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores + _combine_bias(bias)
    weights = torch.softmax(scores, dim=-1).to(dt)
    out = torch.matmul(weights, v)  # (B, H, Lq, dk)
    return torch.matmul(out.transpose(1, 2).reshape(B, Lq, H * dk),
                        p["o"].to(dt))


def mlp(p: dict, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    if cfg.gated_ffn:
        # tanh GELU == HF NewGELUActivation, as jax.nn.gelu(approximate=True)
        h = torch.nn.functional.gelu(
            torch.matmul(x, p["wi_0"].to(dt)), approximate="tanh"
        ) * torch.matmul(x, p["wi_1"].to(dt))
    else:
        h = torch.relu(torch.matmul(x, p["wi"].to(dt)))
    return torch.matmul(h, p["wo"].to(dt))


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


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _check_training_knobs(cfg: T5Config, deterministic: bool) -> None:
    if not deterministic:
        raise NotImplementedError(
            "deterministic=False (dropout) is not ported yet (ROADMAP.md "
            "slice T2); train with dropout off"
        )
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported (ROADMAP.md "
            "slice T2); the port recomputes whole blocks: use "
            "remat_policy='full' or remat=False"
        )


def _run_block(cfg: T5Config, fn, *args):
    """One block, under torch.utils.checkpoint when cfg.remat (the
    counterpart of jax.checkpoint with the default full-recompute
    policy)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params: dict, cfg: T5Config, input_ids: torch.Tensor,
           attention_mask: torch.Tensor | None = None, *,
           deterministic: bool = True,
           pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder stack: (B, L) token ids -> (B, L, D) hidden states."""
    _check_training_knobs(cfg, deterministic)
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    enc = params["encoder"]
    dt = cfg.dtype
    L = input_ids.shape[1]
    x = params["shared"]["embedding"].to(dt)[input_ids.long()]
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

    def block(x, blk, bias):
        h = rms_norm(x, blk["ln_self"]["scale"], eps, dt)
        x = x + attention(blk["self_attn"], cfg, h, h, bias)
        h = rms_norm(x, blk["ln_mlp"]["scale"], eps, dt)
        return x + mlp(blk["mlp"], cfg, h)

    for i in range(_num_blocks(enc)):
        x = _run_block(cfg, block, x, _block(enc, i), bias)
    return rms_norm(x, enc["final_ln"]["scale"], eps, dt)


def decode(params: dict, cfg: T5Config, decoder_input_ids: torch.Tensor,
           encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor, *,
           deterministic: bool = True,
           self_pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder stack with teacher forcing -> (B, Lt, vocab) fp32 logits."""
    _check_training_knobs(cfg, deterministic)
    dec = params["decoder"]
    dt = cfg.dtype
    Lt = decoder_input_ids.shape[1]
    emb = params["shared"]["embedding"].to(dt)
    x = emb[decoder_input_ids.long()]
    if self_pos_bias is None:
        self_pos_bias = compute_position_bias(
            _rel_bias(dec), Lt, Lt, False,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        ) + _causal_bias(Lt, x.device)
    self_bias = (self_pos_bias, None)
    cross_bias = (None, _padding_bias(encoder_mask))
    eps = cfg.layer_norm_epsilon

    def block(x, blk, self_bias, cross_bias, enc_h):
        h = rms_norm(x, blk["ln_self"]["scale"], eps, dt)
        x = x + attention(blk["self_attn"], cfg, h, h, self_bias)
        h = rms_norm(x, blk["ln_cross"]["scale"], eps, dt)
        x = x + attention(blk["cross_attn"], cfg, h, enc_h, cross_bias)
        h = rms_norm(x, blk["ln_mlp"]["scale"], eps, dt)
        return x + mlp(blk["mlp"], cfg, h)

    for i in range(_num_blocks(dec)):
        x = _run_block(cfg, block, x, _block(dec, i), self_bias, cross_bias,
                       encoder_hidden)
    x = rms_norm(x, dec["final_ln"]["scale"], eps, dt)
    # fp32-accumulated LM head (t5.py:1553-1565); the full-vocab product is
    # a plain matmul outside any kernel
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model**-0.5)
        head = emb
    else:
        head = params["lm_head"]["embedding"].to(dt)
    return torch.matmul(x.float(), head.float().t())


def shift_right(labels: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """Teacher-forcing decoder inputs from labels (-100 treated as pad)."""
    labels = torch.where(labels == -100, cfg.pad_token_id, labels)
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    return torch.cat([start, labels[:, :-1]], dim=1)


def forward_logits(params: dict, cfg: T5Config, input_ids: torch.Tensor,
                   labels: torch.Tensor,
                   attention_mask: torch.Tensor | None = None, *,
                   deterministic: bool = True) -> torch.Tensor:
    """Full seq2seq forward (t5.py:1580-1609): one teacher-forced pass,
    (B, L) prompts and (B, Lt) labels -> (B, Lt, vocab) fp32 logits."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    enc = encode(params, cfg, input_ids, attention_mask,
                 deterministic=deterministic)
    return decode(params, cfg, shift_right(labels, cfg), enc, attention_mask,
                  deterministic=deterministic)
