"""PyTorch + CUDA port of pacednegatives_tpu for one NVIDIA H100.

The JAX package beside it is the reference: module paths mirror it, and
tests hold each ported module to its JAX counterpart. This package imports
``torch`` and never ``jax``. The slice ported so far is monoT5 rerank
serving (``eval.rerank.Reranker``) with the fused attention block (K3) and
its attention core (K1) as hand-written CUDA kernels (``csrc/``).
"""
