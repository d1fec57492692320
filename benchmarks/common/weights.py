"""Flat {path: tensor} weights and the port's nested trees of them.

The weights themselves are the architecture's (its hook's ``weights``):
made from the seed on the device, the program and the plain reference
both get them from the benchmark.
"""

from __future__ import annotations


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


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of ``nest``."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat
