"""Host utilities: ``config`` is a copy of the JAX package's
``utils/config.py`` (flat CLI parsing onto dataclass configs), held to it
by tests/test_torch_host_copies.py."""
