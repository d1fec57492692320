"""Host utilities: ``config`` is a copy of the JAX package's
``utils/config.py`` (flat CLI parsing onto dataclass configs), held to it
by tests/test_torch_host_copies.py; ``profiling`` is the port of
``utils/profiling.py`` (torch.profiler traces, dispatched-op cost counts,
NaN checking, analytic T5 FLOPs and the card's peak)."""
