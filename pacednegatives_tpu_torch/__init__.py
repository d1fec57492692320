"""PyTorch + CUDA port of pacednegatives_tpu for one NVIDIA H100.

The JAX package beside it is the reference: module paths mirror it, and
tests hold each ported module to its JAX counterpart. This package imports
``torch`` and never ``jax``. Ported so far: monoT5 rerank serving
(``eval.rerank.Reranker``) and the LCE training step (``cli.train`` ->
``train.runner.run`` -> ``train.step.make_train_step``), with the fused
attention block's forward (K3), its attention core (K1) and its backward
(K4) as hand-written CUDA kernels (``csrc/``).
"""
