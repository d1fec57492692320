"""PyTorch + CUDA port of pacednegatives_tpu for NVIDIA H100s.

The JAX package beside it is the reference: module paths mirror it, and
tests hold each ported module to its JAX counterpart. This package imports
``torch`` and never ``jax``. It serves (``eval.rerank.Reranker``), trains
(``cli.train`` -> ``train.runner.run`` -> ``train.step``: the pacing
curricula, the scored pool, online mining from ``index.dense``), evaluates,
builds pools and distils, on one card or over ranks (``parallel``: data
parallelism over the data and seq axes, the sharded index,
``train.overlap``'s refresh beside training), with the Pallas kernels'
counterparts written by hand in CUDA C++ (``csrc/``). ROADMAP.md lists what is still to port.
"""
