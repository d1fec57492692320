"""Synthetic inputs drawn from a run's seed: seeds of independent streams,
token matrices and MS MARCO passage-like document lengths.

Document lengths follow ``bench.py``'s clipped lognormal (mu 4.0, sigma
0.45, truncated to an integer, clipped to 12-150: a median of about 55
tokens); queries take 4-24 tokens. Tokens are uniform over the ids above
the specials, so no prompt holds a pad inside its real tokens. Everything
is drawn on the given device with a ``torch.Generator`` in a few large
calls.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of a run's ``seed`` (any whole
    number >= 0, also above 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32,
             *(ord(c) for c in stream)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def lognormal_lengths(gen: torch.Generator, n: int, spec: dict,
                      device) -> torch.Tensor:
    """(n,) int64 lengths: int(lognormal(mu, sigma)) clipped to [lo, hi]."""
    x = torch.empty(n, dtype=torch.float64, device=device)
    x.log_normal_(spec["mu"], spec["sigma"], generator=gen)
    return x.long().clamp(spec["min"], spec["max"])


def uniform_lengths(gen: torch.Generator, n: int, spec: dict,
                    device) -> torch.Tensor:
    """(n,) int64 lengths uniform on [min, max]."""
    return torch.randint(spec["min"], spec["max"] + 1, (n,), generator=gen,
                         device=device)


def lengths(gen, n: int, spec: dict, device) -> torch.Tensor:
    draw = {"lognormal": lognormal_lengths, "uniform": uniform_lengths}
    return draw[spec["kind"]](gen, n, spec, device)


def token_matrix(gen: torch.Generator, lens: torch.Tensor, width: int,
                 first_id: int, vocab_size: int, pad_id: int) -> torch.Tensor:
    """(n, width) int16 token ids: row i holds ``lens[i]`` ids uniform on
    [first_id, vocab_size), then pads."""
    n = lens.shape[0]
    tok = torch.randint(first_id, vocab_size, (n, width), generator=gen,
                        device=lens.device, dtype=torch.int32)
    inside = torch.arange(width, device=lens.device)[None, :] < lens[:, None]
    return torch.where(inside, tok, pad_id).to(torch.int16)
