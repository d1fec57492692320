"""Flat CLI parsing onto dataclass configs.

Replaces python-fire (reference train/*.py use ``fire.Fire(main)``; fire is
not in this environment): ``--key value`` / ``--key=value`` pairs are coerced
to the dataclass field's type. Booleans accept true/false/1/0; None-able
fields accept "none".
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, get_args, get_origin


def _coerce(raw: str, typ: Any) -> Any:
    if get_origin(typ) is not None and type(None) in get_args(typ):
        if raw.lower() in ("none", "null"):
            return None
        inner = [a for a in get_args(typ) if a is not type(None)]
        typ = inner[0] if inner else str
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "y")
    if typ in (int, float, str):
        return typ(raw)
    return raw


def parse_cli(argv: list[str] | None = None) -> dict[str, str]:
    argv = list(sys.argv[1:] if argv is None else argv)
    out: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"unexpected argument {a!r} (use --key value)")
        a = a[2:]
        if "=" in a:
            k, v = a.split("=", 1)
            out[k.replace("-", "_")] = v
            i += 1
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"missing value for --{a}")
            out[a.replace("-", "_")] = argv[i + 1]
            i += 2
    return out


def apply_overrides(config, overrides: dict[str, str]):
    """Return a dataclass copy with string overrides coerced per-field."""
    import typing

    hints = typing.get_type_hints(type(config))
    fields = {f.name for f in dataclasses.fields(config)}
    updates = {}
    for k, v in overrides.items():
        if k not in fields:
            raise SystemExit(
                f"unknown option --{k}; valid: {', '.join(sorted(fields))}"
            )
        updates[k] = _coerce(v, hints.get(k, str))
    return dataclasses.replace(config, **updates)
