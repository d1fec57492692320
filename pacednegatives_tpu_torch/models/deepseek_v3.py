"""DeepSeek-V3 (``DeepseekV3ForCausalLM``) as a pointwise LLM reranker.

The layer equations are HF ``modeling_deepseek``'s: multi-head latent
attention (MLA) without a q LoRA, decoupled RoPE, RMSNorm, a dense SwiGLU
FFN in the first ``first_k_dense_replace`` layers, then mixture-of-experts
layers of routed SwiGLU experts under a sigmoid router (``noaux_tc``, one
group) beside shared experts. A prompt "Query: q Document: d Relevant:"
is scored by log P(true | {true, false}) from the head's logits at its
last real position; training takes the CE of its verbalizer id there.

Departures from the published model, each a cut of the deployment this
rank stands for, or of fine-tuning as usual:

- the expert layers hold ``experts_held`` = (first, count) of the
  ``n_routed_experts`` (expert parallelism): the router scores every
  expert and picks its top k, and the layer computes the held experts'
  part alone; what the others would add is left out;
- ``vocab_size`` may be a slice of the published vocabulary (the
  embedding and the untied head alike);
- the correction bias ``router.bias`` is a constant of the forward: it
  steers the choice of experts, never the weights, and gets no gradient;
  the sequence-wise auxiliary loss is off;
- no dropout, no BOS.

The forward runs the real tokens alone. One read back a forward
(``host_sync("deepseek.tokens")``) learns how many there are; the
positions are ``cumsum(mask) - 1``, so pads take none and a prompt reads
the same whether its pads sit between its segments or at its end.
Attention regathers each row's real tokens at their positions (pads at
the end) and runs ``F.scaled_dot_product_attention`` with ``is_causal``:
every real query sees exactly the real keys before it. Each expert
layer reads back one number more, its dispatch buffer's size
(``host_sync("moe.sizes")``, ``ops/moe.py``).

Weights are (in, out), as the port's T5 keeps them. Leaves:
``embed.embedding`` (V, D); ``layers.layer_<i>.``: ``attn_norm.scale``,
``attn.q`` (D, H (dn + dr)), ``attn.kv_a`` (D, r + dr),
``attn.kv_norm.scale`` (r), ``attn.kv_b`` (r, H (dn + dv)), ``attn.o``
(H dv, D), ``mlp_norm.scale``; a dense layer's ``mlp.gate``, ``mlp.up``
(D, F), ``mlp.down`` (F, D); an expert layer's ``router.weight`` (D,
n_routed) fp32, ``router.bias`` (n_routed,), ``experts.gate``,
``experts.up`` (held, D, Fe), ``experts.down`` (held, Fe, D),
``shared.gate``, ``shared.up`` (D, Fs), ``shared.down`` (Fs, D);
``norm.scale``; ``head.weight`` (D, V).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pacednegatives_tpu_torch.models.monot5 import relevance_log_probs
from pacednegatives_tpu_torch.models.t5 import flatten_params, unflatten_params
from pacednegatives_tpu_torch.ops import moe
from pacednegatives_tpu_torch.ops.embedding import embedding_lookup
from pacednegatives_tpu_torch.utils.profiling import (
    count,
    count_device,
    host_sync,
    recording,
    span,
)

# HF's kv_a_layernorm takes DeepseekV3RMSNorm's default eps, not the config's
KV_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    # (first, count) of the routed experts this rank holds
    experts_held: tuple = (0, 64)
    pad_token_id: int = 0
    dtype: torch.dtype = torch.bfloat16

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

    @classmethod
    def tiny(cls, **kw) -> "DeepseekV3Config":
        """A CPU-test size with every mechanism: 1 dense + 2 expert layers,
        8 experts (6 held from 1), 3 a token."""
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, num_hidden_layers=3,
                    num_attention_heads=4, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    n_routed_experts=8, num_experts_per_tok=3,
                    n_shared_experts=2, experts_held=(1, 6),
                    dtype=torch.float32)
        base.update(kw)
        return cls(**base)


def leaves(cfg: DeepseekV3Config) -> list:
    """[(path, shape, std)] in a fixed order: std None for a norm scale
    (ones), "bias" for the router's correction bias. The scales: an (in,
    out) weight in^-0.5, the embedding 1, the head D^-0.5."""
    D, H = cfg.hidden_size, cfg.num_attention_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    first, held = cfg.experts_held
    Fe = cfg.moe_intermediate_size
    Fs = Fe * cfg.n_shared_experts
    out = [("embed.embedding", (cfg.vocab_size, D), 1.0)]
    for i in range(cfg.num_hidden_layers):
        p = f"layers.layer_{i}"
        out += [(f"{p}.attn_norm.scale", (D,), None),
                (f"{p}.attn.q", (D, H * (dn + dr)), D ** -0.5),
                (f"{p}.attn.kv_a", (D, r + dr), D ** -0.5),
                (f"{p}.attn.kv_norm.scale", (r,), None),
                (f"{p}.attn.kv_b", (r, H * (dn + dv)), r ** -0.5),
                (f"{p}.attn.o", (H * dv, D), (H * dv) ** -0.5),
                (f"{p}.mlp_norm.scale", (D,), None)]
        if not cfg.is_moe(i):
            F_ = cfg.intermediate_size
            out += [(f"{p}.mlp.gate", (D, F_), D ** -0.5),
                    (f"{p}.mlp.up", (D, F_), D ** -0.5),
                    (f"{p}.mlp.down", (F_, D), F_ ** -0.5)]
            continue
        out += [(f"{p}.router.weight", (D, cfg.n_routed_experts), D ** -0.5),
                (f"{p}.router.bias", (cfg.n_routed_experts,), "bias"),
                (f"{p}.experts.gate", (held, D, Fe), D ** -0.5),
                (f"{p}.experts.up", (held, D, Fe), D ** -0.5),
                (f"{p}.experts.down", (held, Fe, D), Fe ** -0.5),
                (f"{p}.shared.gate", (D, Fs), D ** -0.5),
                (f"{p}.shared.up", (D, Fs), D ** -0.5),
                (f"{p}.shared.down", (Fs, D), Fs ** -0.5)]
    out += [("norm.scale", (D,), None),
            ("head.weight", (D, cfg.vocab_size), D ** -0.5)]
    return out


# the correction bias's draw: N(0, BIAS_STD), against sigmoid scores that
# spread by ~0.2 at these scales, so it moves some of the top-k choices
BIAS_STD = 0.05


def init_params(cfg: DeepseekV3Config, generator: torch.Generator,
                device="cpu") -> dict:
    """Random fp32 weights in the nested tree (``leaves``' scales)."""
    flat = {}
    for key, shape, std in leaves(cfg):
        if std is None:
            flat[key] = torch.ones(shape, device=device)
            continue
        scale = BIAS_STD if std == "bias" else std
        flat[key] = torch.randn(shape, generator=generator,
                                device=device) * scale
    return unflatten_params(flat)


def compute_leaves(params: dict, cfg: DeepseekV3Config) -> dict:
    """Flat {path: tensor} of ``params`` as the forward takes them: every
    weight of two or more dims in ``cfg.dtype``, but the router's (fp32,
    its logits are fp32); norm scales and the correction bias as they
    are. Each a fresh leaf (detached)."""
    out = {}
    for key, p in flatten_params(params).items():
        if p.dim() >= 2 and not key.endswith("router.weight"):
            p = p.to(cfg.dtype)
        out[key] = p.detach()
    return out


# -- pieces ------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dtype: torch.dtype) -> torch.Tensor:
    """HF DeepseekV3RMSNorm: the mean square in fp32, the normalised
    value rounded to ``dtype``, then times the scale."""
    h = x.float()
    h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + eps)
    return h.to(dtype) * scale.to(dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """HF's decoupled RoPE on (T, ..., d): the pairs de-interleaved to
    halves, then x cos + rotate_half(x) sin at ``pos`` (T,), in fp32."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    freqs = pos.float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    h = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = h[..., :d // 2], h[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    return (h * cos + rot * sin).to(x.dtype)


def swiglu(x: torch.Tensor, gate, up, down) -> torch.Tensor:
    return (F.silu(x @ gate) * (x @ up)) @ down


class Tokens:
    """The real tokens of a (B, L) batch: ``flat`` their (T,) indices into
    B * L, ``pos`` their positions, ``slot`` their (row, position) index
    into B * L of the packed layout, ``last`` each row's last token's
    index in the T."""

    def __init__(self, mask: torch.Tensor):
        B, L = mask.shape
        m = mask.reshape(-1) != 0
        with host_sync("deepseek.tokens"):
            self.flat = m.nonzero().squeeze(1)
        pos = (mask != 0).long().cumsum(1) - 1
        self.pos = pos.reshape(-1)[self.flat]
        self.slot = (torch.div(self.flat, L, rounding_mode="floor") * L
                     + self.pos)
        self.last = (mask != 0).long().sum(1).cumsum(0) - 1
        self.B, self.L = B, L


def attention(p: dict, cfg: DeepseekV3Config, x: torch.Tensor,
              tok: Tokens) -> torch.Tensor:
    """MLA without a q LoRA over the real tokens (T, D) -> (T, D)."""
    T = x.shape[0]
    H = cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (x @ p["q"]).view(T, H, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    kv_lat, k_pe = (x @ p["kv_a"]).split([cfg.kv_lora_rank, dr], dim=-1)
    kv = (rms_norm(kv_lat, p["kv_norm"]["scale"], KV_NORM_EPS, x.dtype)
          @ p["kv_b"]).view(T, H, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = rope(q_pe, tok.pos, cfg.rope_theta)
    k_pe = rope(k_pe, tok.pos, cfg.rope_theta)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, None].expand(T, H, dr)], dim=-1)

    def packed(t):  # (T, H, d) -> (B, H, L, d), each row's tokens first
        out = t.new_zeros(tok.B * tok.L, H, t.shape[-1])
        out = out.index_put((tok.slot,), t)
        return out.view(tok.B, tok.L, H, -1).transpose(1, 2)

    o = F.scaled_dot_product_attention(packed(q), packed(k), packed(v),
                                       is_causal=True,
                                       scale=(dn + dr) ** -0.5)
    o = o.transpose(1, 2).reshape(tok.B * tok.L, H * dv)[tok.slot]
    return o @ p["o"]


def moe_layer(p: dict, cfg: DeepseekV3Config, x: torch.Tensor) -> torch.Tensor:
    """The held experts' part of the routed experts, plus the shared
    experts, over (T, D)."""
    first, held = cfg.experts_held
    k = cfg.num_experts_per_tok
    with span("pnt.moe.route"):
        w, idx = moe.route(x, p["router"]["weight"], p["router"]["bias"], k,
                           cfg.routed_scaling_factor, cfg.norm_topk_prob)
    with span("pnt.moe.dispatch"):
        plan = moe.dispatch_plan(idx, first, held)
        xs = moe.dispatch(x, plan, k)
        if recording():
            count("moe.tokens", x.shape[0])
            count_device("moe.slots", plan["counts"].sum())
    with span("pnt.moe.experts"):
        e = p["experts"]
        gate_up = torch.cat([e["gate"], e["up"]], dim=2)
        ys = moe.experts(xs, gate_up, e["down"], plan["offs"])
    with span("pnt.moe.combine"):
        y = moe.combine(ys, w, plan)
    with span("pnt.moe.shared"):
        s = p["shared"]
        return y + swiglu(x, s["gate"], s["up"], s["down"])


def hidden_last(params: dict, cfg: DeepseekV3Config, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """(B, L) prompts -> (B, D) final-normed hidden states at each row's
    last real position. ``params``: the tree of ``compute_leaves``."""
    tok = Tokens(mask)
    x = embedding_lookup(params["embed"]["embedding"],
                         ids.reshape(-1)[tok.flat])
    eps, dt = cfg.rms_norm_eps, x.dtype
    for i in range(cfg.num_hidden_layers):
        p = params["layers"][f"layer_{i}"]
        with span("pnt.mla"):
            h = x + attention(p["attn"], cfg,
                              rms_norm(x, p["attn_norm"]["scale"], eps, dt),
                              tok)
        y = rms_norm(h, p["mlp_norm"]["scale"], eps, dt)
        if cfg.is_moe(i):
            with span("pnt.moe"):
                x = h + moe_layer(p, cfg, y)
        else:
            m = p["mlp"]
            x = h + swiglu(y, m["gate"], m["up"], m["down"])
    return rms_norm(x[tok.last], params["norm"]["scale"], eps, dt)


def last_logits(params: dict, cfg: DeepseekV3Config, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """(B, L) prompts -> (B, V) fp32 logits of the head at each row's last
    real position (the head runs on those B rows alone)."""
    return (hidden_last(params, cfg, ids, mask)
            @ params["head"]["weight"]).float()


def score_batch(params: dict, cfg: DeepseekV3Config, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None, rel_id: int = 3,
                nrel_id: int = 4) -> torch.Tensor:
    """(B, L) prompts -> (B,) log P(true | {true, false}) at the last real
    position. ``params``: the tree of ``compute_leaves``."""
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).to(torch.int32)
    return relevance_log_probs(last_logits(params, cfg, input_ids,
                                           attention_mask),
                               rel_id, nrel_id, cfg.vocab_size)

