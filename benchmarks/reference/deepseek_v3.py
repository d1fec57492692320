"""Plain PyTorch reference of ``DeepseekV3ForCausalLM`` as a pointwise
reranker: the layer equations of HF ``modeling_deepseek`` in float32 with
TF32 off, scored by log P(true | {true, false}) at each prompt's last real
position, trained on the CE of its verbalizer id there.

It imports nothing of the program: it takes token ids, masks and flat
{path: tensor} weights under the program's leaf names ((in, out) matrices)
and works everything else out again, on the padded (B, L) layout as it
comes (pads may sit between a prompt's segments): positions are
cumsum(mask) - 1, attention is causal over real keys, and pads run
through every layer without touching a real token.

Departures from the published model, each the same in the program:

- the expert layers hold the experts ``experts_held`` = (first, count) of
  ``n_routed_experts`` names (the rank's share under expert
  parallelism): the router scores all of them and picks its top k, the
  layer adds the held experts' part alone;
- the vocabulary is ``vocab_size`` rows (a slice of the published one);
- ``router.bias`` (``e_score_correction_bias``) steers the choice and is
  held fixed (no gradient reaches it); no auxiliary loss; no dropout;
- the kv latent's RMSNorm takes eps 1e-6, as HF's ``kv_a_layernorm``
  (DeepseekV3RMSNorm's default), the others the config's ``rms_norm_eps``.

``precision="fp8"`` is the control: every matmul operand rounded to
float8 e4m3 with a per-tensor scale (its amax to 448), products in
float32.
"""

from __future__ import annotations

import torch

KV_NORM_EPS = 1e-6


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())  # the rounded value; gradient of identity


class Model:
    """DeepSeek-V3 of ``cfg`` (HF config names, with ``experts_held``)
    over float32 ``weights``."""

    def __init__(self, cfg: dict, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.cfg = cfg
        self.w = weights
        self.fp8 = precision == "fp8"

    def mm(self, a, b):
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def norm(self, x, key, eps=None):
        eps = self.cfg["rms_norm_eps"] if eps is None else eps
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * self.w[key]

    def rope(self, x, pos):
        """(B, L, ..., d) at positions (B, L): HF's layout, the pairs
        de-interleaved to halves, then x cos + rotate_half(x) sin."""
        d = x.shape[-1]
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
        ang = pos.float()[..., None] * inv
        emb = torch.cat([ang, ang], dim=-1)
        while emb.dim() < x.dim():
            emb = emb.unsqueeze(-2)
        x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
        rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
        return x * emb.cos() + rot * emb.sin()

    def attention(self, p, x, mask, pos):
        c = self.cfg
        B, L, _ = x.shape
        H = c["num_attention_heads"]
        dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
        q = self.mm(x, self.w[f"{p}.q"]).view(B, L, H, dn + dr)
        kv_a = self.mm(x, self.w[f"{p}.kv_a"])
        lat, k_pe = kv_a[..., :c["kv_lora_rank"]], kv_a[..., c["kv_lora_rank"]:]
        kv = self.mm(self.norm(lat, f"{p}.kv_norm.scale", KV_NORM_EPS),
                     self.w[f"{p}.kv_b"]).view(B, L, H, dn + dv)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], pos)], dim=-1)
        k_pe = self.rope(k_pe, pos)[:, :, None].expand(B, L, H, dr)
        k = torch.cat([kv[..., :dn], k_pe], dim=-1)
        v = kv[..., dn:]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        s = self.mm(q, k.transpose(-1, -2)) * (dn + dr) ** -0.5
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        allowed = causal[None, None] & (mask[:, None, None, :] > 0)
        s = s.masked_fill(~allowed, float("-inf"))
        o = self.mm(torch.softmax(s, dim=-1), v).transpose(1, 2)
        return self.mm(o.reshape(B, L, H * dv), self.w[f"{p}.o"])

    def swiglu(self, p, x):
        g = self.mm(x, self.w[f"{p}.gate"])
        u = self.mm(x, self.w[f"{p}.up"])
        return self.mm(torch.nn.functional.silu(g) * u, self.w[f"{p}.down"])

    def routed(self, p, x):
        """(N, D) -> (N, D): the held experts' part of the routed experts,
        each token's chosen experts' outputs times their weights."""
        c = self.cfg
        k = c["num_experts_per_tok"]
        scores = torch.sigmoid(self.mm(x, self.w[f"{p}.router.weight"]))
        choice = torch.topk(scores.detach() + self.w[f"{p}.router.bias"],
                            k, dim=-1).indices
        w = scores.gather(1, choice)
        if c["norm_topk_prob"] and k > 1:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        w = w * c["routed_scaling_factor"]
        first, held = c["experts_held"]
        # the bias enters the graph times 0, so that it gets an exact zero
        # gradient (the LCE reference reads every leaf's)
        out = torch.zeros_like(x) + 0.0 * self.w[f"{p}.router.bias"].sum()
        for e in range(held):
            tok, slot = (choice == first + e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            h = (torch.nn.functional.silu(self.mm(xe, self.w[f"{p}.experts.gate"][e]))
                 * self.mm(xe, self.w[f"{p}.experts.up"][e]))
            ye = self.mm(h, self.w[f"{p}.experts.down"][e])
            out = out.index_add(0, tok, ye * w[tok, slot][:, None])
        return out

    def moe(self, p, x):
        B, L, D = x.shape
        flat = x.reshape(B * L, D)
        return (self.routed(p, flat).view(B, L, D)
                + self.swiglu(f"{p}.shared", x))

    def hidden(self, ids, mask):
        """(B, L) -> (B, L, D) final-normed hidden states."""
        c = self.cfg
        pos = (mask > 0).long().cumsum(1) - 1
        x = self.w["embed.embedding"][ids]
        for i in range(c["num_hidden_layers"]):
            p = f"layers.layer_{i}"
            x = x + self.attention(f"{p}.attn",
                                   self.norm(x, f"{p}.attn_norm.scale"),
                                   mask, pos)
            h = self.norm(x, f"{p}.mlp_norm.scale")
            if i >= c["first_k_dense_replace"]:
                x = x + self.moe(p, h)
            else:
                x = x + self.swiglu(f"{p}.mlp", h)
        return self.norm(x, "norm.scale")

    def last_logits(self, ids, mask):
        """(B, V) logits at each row's last real position."""
        h = self.hidden(ids, mask)
        last = (mask > 0).long().sum(1) - 1
        # the last real token is the one at position count - 1
        pos = (mask > 0).long().cumsum(1) - 1
        at = ((pos == last[:, None]) & (mask > 0)).float().argmax(dim=1)
        h = h[torch.arange(ids.shape[0], device=ids.device), at]
        return self.mm(h, self.w["head.weight"])

    def score(self, ids, mask, true_id: int, false_id: int):
        """(B, L) prompts -> (B,) log P(true | {true, false})."""
        pair = self.last_logits(ids, mask)[:, [true_id, false_id]]
        return torch.log_softmax(pair, dim=-1)[:, 0]

    def loss(self, ids, mask, label_ids):
        """(B,) CE of each row's verbalizer id (B,) at its last real
        position, over the whole (sliced) vocabulary."""
        logp = torch.log_softmax(self.last_logits(ids, mask), dim=-1)
        return -logp.gather(1, label_ids[:, None].long())[:, 0]
