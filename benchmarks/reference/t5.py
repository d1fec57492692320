"""Plain PyTorch reference of the T5 cells' model: a T5 v1.0
encoder-decoder (relative position bias, RMS norm without bias, ReLU FFN,
no 1/sqrt(d_k) in attention, the LM head tied to the embedding with the
d_model^-0.5 rescale), monoT5's relevance score and its training CE.

It follows the published T5 description, in float32 with TF32 off, and
imports nothing of the program: it takes the benchmark's inputs (token
ids, prompts' real lengths, weights made from the seed) and works
everything else out again. Departures, each for agreement at the
program's documented numerics, not for speed:

- the relative-position buckets are computed in float64, which gives the
  exact bucket where n / max_exact is a power of two (a float32 log can
  truncate 2.0 to 1);
- masked attention logits get -1e9 added (a padded key's weight is an
  exact 0 either way).

``precision="fp8"`` is the control: every matmul operand rounded to
float8 e4m3 with a per-tensor scale (its amax to 448), the products in
float32.
"""

from __future__ import annotations

import math

import torch

NEG = -1e9


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())  # the rounded value; gradient of identity


class Model:
    """T5 v1.0 of ``cfg`` (the architecture's sizes) over a flat {path:
    tensor} of float32 weights; ``eos_id`` ends the training labels."""

    def __init__(self, cfg: dict, weights: dict, precision: str = "fp32",
                 eos_id: int | None = None):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.cfg = cfg
        self.w = weights
        self.fp8 = precision == "fp8"
        self.eos_id = eos_id

    # -- pieces ------------------------------------------------------------

    def mm(self, a, b):
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def norm(self, x, key):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg["layer_norm_epsilon"]) \
            * self.w[key]

    def bucket(self, rel: torch.Tensor, bidirectional: bool) -> torch.Tensor:
        nb = self.cfg["relative_attention_num_buckets"]
        md = self.cfg["relative_attention_max_distance"]
        n = -rel.long()
        out = torch.zeros_like(n)
        if bidirectional:
            nb //= 2
            out = out + (n < 0).long() * nb
            n = n.abs()
        else:
            n = n.clamp_min(0)
        exact = nb // 2
        large = exact + (torch.log(n.double().clamp_min(1) / exact)
                         / math.log(md / exact) * (nb - exact)).long()
        large = large.clamp_max(nb - 1)
        return out + torch.where(n < exact, n, large)

    def pos_bias(self, key, lq, lk, bidirectional):
        dev = self.w[key].device
        rel = (torch.arange(lk, device=dev)[None, :]
               - torch.arange(lq, device=dev)[:, None])
        return self.w[key][self.bucket(rel, bidirectional)].permute(2, 0, 1)

    def attention(self, prefix, x, kv, bias):
        B, Lq, _ = x.shape
        H, dk = self.cfg["num_heads"], self.cfg["d_kv"]
        heads = lambda t: t.view(B, -1, H, dk).transpose(1, 2)
        q = heads(self.mm(x, self.w[f"{prefix}.q"]))
        k = heads(self.mm(kv, self.w[f"{prefix}.k"]))
        v = heads(self.mm(kv, self.w[f"{prefix}.v"]))
        p = torch.softmax(self.mm(q, k.transpose(-1, -2)) + bias, dim=-1)
        out = self.mm(p, v).transpose(1, 2).reshape(B, Lq, H * dk)
        return self.mm(out, self.w[f"{prefix}.o"])

    def ffn(self, prefix, x):
        return self.mm(torch.relu(self.mm(x, self.w[f"{prefix}.wi"])),
                       self.w[f"{prefix}.wo"])

    # -- stacks --------------------------------------------------------------

    def encode(self, ids, mask):
        L = ids.shape[1]
        x = self.w["shared.embedding"][ids]
        key_bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG)
        bias = self.pos_bias("encoder.block_0.self_attn.rel_bias", L, L,
                             True)[None] + key_bias
        for i in range(self.cfg["num_layers"]):
            p = f"encoder.block_{i}"
            h = self.norm(x, f"{p}.ln_self.scale")
            x = x + self.attention(f"{p}.self_attn", h, h, bias)
            x = x + self.ffn(f"{p}.mlp", self.norm(x, f"{p}.ln_mlp.scale"))
        return self.norm(x, "encoder.final_ln.scale")

    def decode(self, dec_ids, enc, mask):
        Lt = dec_ids.shape[1]
        x = self.w["shared.embedding"][dec_ids]
        causal = torch.ones(Lt, Lt, dtype=torch.bool,
                            device=x.device).tril()
        self_bias = (self.pos_bias("decoder.block_0.self_attn.rel_bias", Lt,
                                   Lt, False)
                     + torch.where(causal, 0.0, NEG))[None]
        cross_bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG)
        for i in range(self.cfg["num_decoder_layers"]):
            p = f"decoder.block_{i}"
            h = self.norm(x, f"{p}.ln_self.scale")
            x = x + self.attention(f"{p}.self_attn", h, h, self_bias)
            h = self.norm(x, f"{p}.ln_cross.scale")
            x = x + self.attention(f"{p}.cross_attn", h, enc, cross_bias)
            x = x + self.ffn(f"{p}.mlp", self.norm(x, f"{p}.ln_mlp.scale"))
        x = self.norm(x, "decoder.final_ln.scale")
        x = x * self.cfg["d_model"] ** -0.5
        return self.mm(x, self.w["shared.embedding"].t())

    # -- monoT5 --------------------------------------------------------------

    def score(self, ids, mask, true_id: int, false_id: int):
        """(B, L) prompts -> (B,) log P(true | {true, false}) at the first
        decoder position (decoder input: the start token 0)."""
        enc = self.encode(ids, mask)
        start = torch.zeros((ids.shape[0], 1), dtype=torch.long,
                            device=ids.device)
        logits = self.decode(start, enc, mask)[:, 0]
        pair = logits[:, [true_id, false_id]]
        return torch.log_softmax(pair, dim=-1)[:, 0]

    def row_ce(self, ids, mask, labels):
        """(B,) teacher-forced CE of (B, Lt) labels, the mean over the
        label tokens; decoder inputs are the labels shifted right after
        the start token 0."""
        start = torch.zeros_like(labels[:, :1])
        dec_in = torch.cat([start, labels[:, :-1]], dim=1)
        logits = self.decode(dec_in, self.encode(ids, mask), mask)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0].mean(-1)

    def loss(self, ids, mask, label_ids):
        """(B,) training CE of each row's verbalizer id (B,): the labels
        [verbalizer, eos], teacher-forced."""
        eos = torch.full_like(label_ids, self.eos_id)
        return self.row_ce(ids, mask, torch.stack([label_ids, eos], dim=1))

