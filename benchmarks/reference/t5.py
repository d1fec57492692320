"""Plain PyTorch reference of what the benchmark's cells compute: a T5 v1.0
encoder-decoder (relative position bias, RMS norm without bias, ReLU FFN,
no 1/sqrt(d_k) in attention, the LM head tied to the embedding with the
d_model^-0.5 rescale), monoT5's relevance score, the LCE loss and AdamW.

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
    """T5 v1.0 of ``cfg`` (the configuration file's ``model`` dict) over a
    flat {path: tensor} of float32 weights."""

    def __init__(self, cfg: dict, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.cfg = cfg
        self.w = weights
        self.fp8 = precision == "fp8"

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


def lce_example_loss(pce: torch.Tensor, nce: torch.Tensor,
                     n: int) -> torch.Tensor:
    """LCE per example: its positive's CE plus the sum of its n
    negatives' (``nce`` example-major)."""
    return pce + nce.view(-1, n).sum(dim=1)


def linear_warmup_decay(peak: float, warmup: int, total: int, step: int):
    """The HF linear schedule: 0 -> peak over ``warmup`` steps, then down
    to 0 at ``total``."""
    warmup = max(warmup, 1)
    if step < warmup:
        return peak * step / warmup
    return peak * max(0.0, (total - step) / max(total - warmup, 1))


class AdamW:
    """Global-norm clipping (scaled by clip / norm when the norm reaches
    clip), then AdamW (decoupled weight decay) with bias correction, the
    learning rate read at the count before the update."""

    def __init__(self, lr_at, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
                 clip=1.0):
        self.lr_at, self.b1, self.b2, self.eps = lr_at, b1, b2, eps
        self.wd, self.clip = weight_decay, clip
        self.count = 0
        self.mu: dict = {}
        self.nu: dict = {}

    def clip_grads(self, grads: dict) -> dict:
        if self.clip is None:
            return grads
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values())).float()
        scale = 1.0 if norm < self.clip else self.clip / norm
        return {k: g * scale for k, g in grads.items()}

    def step(self, params: dict, grads: dict) -> dict:
        grads = self.clip_grads(grads)
        lr = self.lr_at(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu.get(k, 0.0) + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu.get(k, 0.0) + (1 - self.b2) * g * g
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            out[k] = p - lr * (upd + self.wd * p)
        return out
