"""T5 v1.0 weights made from a seed on the device, in one draw.

The tree has the port's leaf names and (in, out) orientation, and T5's
initialisation scales (q: (d_model * d_kv)^-0.5, k / v: d_model^-0.5, o:
inner^-0.5, rel_bias: d_model^-0.5, FFN in: d_model^-0.5, out: d_ff^-0.5,
the shared embedding 1.0, norm scales 1). All normal draws come from one
``torch.randn`` over the whole parameter count; each leaf is a view of it,
scaled in place. The program and the plain reference both get these
weights from the benchmark.
"""

from __future__ import annotations

import torch

from benchmarks.common.data import generator


def t5_leaves(cfg: dict) -> list:
    """[(path, shape, std)] in a fixed order; std None for a norm scale."""
    d, dk, H, ff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    inner = H * dk
    nb = cfg["relative_attention_num_buckets"]

    def attn(prefix, rel_bias):
        out = [(f"{prefix}.q", (d, inner), (d * dk) ** -0.5),
               (f"{prefix}.k", (d, inner), d ** -0.5),
               (f"{prefix}.v", (d, inner), d ** -0.5),
               (f"{prefix}.o", (inner, d), inner ** -0.5)]
        if rel_bias:
            out.append((f"{prefix}.rel_bias", (nb, H), d ** -0.5))
        return out

    def mlp(prefix):
        return [(f"{prefix}.wi", (d, ff), d ** -0.5),
                (f"{prefix}.wo", (ff, d), ff ** -0.5)]

    leaves = [("shared.embedding", (cfg["vocab_size"], d), 1.0)]
    for i in range(cfg["num_layers"]):
        p = f"encoder.block_{i}"
        leaves += attn(f"{p}.self_attn", i == 0)
        leaves += [(f"{p}.ln_self.scale", (d,), None)]
        leaves += mlp(f"{p}.mlp")
        leaves += [(f"{p}.ln_mlp.scale", (d,), None)]
    leaves.append(("encoder.final_ln.scale", (d,), None))
    for i in range(cfg["num_decoder_layers"]):
        p = f"decoder.block_{i}"
        leaves += attn(f"{p}.self_attn", i == 0)
        leaves += [(f"{p}.ln_self.scale", (d,), None)]
        leaves += attn(f"{p}.cross_attn", False)
        leaves += [(f"{p}.ln_cross.scale", (d,), None)]
        leaves += mlp(f"{p}.mlp")
        leaves += [(f"{p}.ln_mlp.scale", (d,), None)]
    leaves.append(("decoder.final_ln.scale", (d,), None))
    return leaves


def nest(flat: dict) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def make_t5_weights(cfg: dict, seed: int, device) -> dict:
    """Flat {path: fp32 tensor} of the weights for ``seed``."""
    leaves = t5_leaves(cfg)
    drawn = [(k, s, std) for k, s, std in leaves if std is not None]
    total = sum(torch.Size(s).numel() for _, s, _ in drawn)
    buf = torch.randn(total, generator=generator(seed, "weights", device),
                      device=device, dtype=torch.float32)
    flat, at = {}, 0
    for key, shape, std in leaves:
        if std is None:
            flat[key] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = torch.Size(shape).numel()
        flat[key] = buf[at:at + n].view(shape).mul_(std)
        at += n
    return flat
