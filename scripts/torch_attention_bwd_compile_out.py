#!/usr/bin/env python3
"""Copies of this checkout with parts of the attention-backward passes
(``pacednegatives_tpu_torch/csrc/t5_attention_bwd.cuh``) compiled out or
swapped, for timing only.

    python3 scripts/torch_attention_bwd_compile_out.py DEST [VARIANT ...]
    python3 scripts/torch_attention_bwd_bench.py . DEST/noband DEST/noexp \\
        --rounds 1 --cases k4_core,k2b

Each VARIANT becomes DEST/<variant>, a copy of the files git tracks (or
would track) with one edit:

- ``noband``: the dq pass skips the dpos band (no shared-memory sums, no
  partial-slab stores); outputs wrong;
- ``noexp``: p = (s - m) / l without the exponential, in both passes;
  outputs wrong;
- ``slabband``: K2a keeps all keys in one chunk and its dpos band in the
  partial slab in global memory where the band does not fit in shared
  memory, as K4 and K2b do; outputs right (the design K2a's key chunks
  replace).

The time a part takes is the full kernel's time less the variant's, from
the bench script's per-kernel device times.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "pacednegatives_tpu_torch/csrc/t5_attention_bwd.cuh"


def noband(s: str) -> str:
    start = "        // the band, under the dQ product"
    end = "        if (++stage == STAGES) { stage = 0; phase ^= 1; }\n      }\n"
    i = s.index(start)
    return s[:i] + s[s.index(end, i):]


def noexp(s: str) -> str:
    for a, b in (("ex2((s - m_c) * LOG2E) * rl_c", "(s - m_c) * rl_c"),
                 ("ex2((s - m_i[hh]) * LOG2E) * rl[hh]", "(s - m_i[hh]) * rl[hh]")):
        assert a in s, a
        s = s.replace(a, b)
    return s


def slabband(s: str) -> str:
    a = "    if (MODE != kK2a) return {0, nkt * BKV, 1, base};"
    assert a in s, a
    return s.replace(a, "    return {0, nkt * BKV, 1, base};")


VARIANTS = {"noband": noband, "noexp": noexp, "slabband": slabband}


def main(dest: str, names: list[str]) -> None:
    files = subprocess.run(
        ["git", "ls-files", "-co", "--exclude-standard"], cwd=ROOT,
        capture_output=True, text=True, check=True).stdout.split()
    for name in names or list(VARIANTS):
        out = os.path.join(os.path.abspath(dest), name)
        shutil.rmtree(out, ignore_errors=True)
        for f in files:
            if os.path.exists(os.path.join(ROOT, f)):
                os.makedirs(os.path.dirname(os.path.join(out, f)),
                            exist_ok=True)
                shutil.copy2(os.path.join(ROOT, f), os.path.join(out, f))
        path = os.path.join(out, SRC)
        with open(path) as fh:
            src = fh.read()
        edited = VARIANTS[name](src)
        assert edited != src, name
        with open(path, "w") as fh:
            fh.write(edited)
        print(name, out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
