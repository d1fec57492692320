"""Kernel wrappers and their plain PyTorch versions.

- ``flash``: the T5 attention core forward (K1), ``csrc/t5_attention_fwd.cu``;
- ``gemm``: the bf16 projection GEMM, ``csrc/gemm_bf16.cu``;
- ``flash_v3``: the fused self-attention block forward (K3) built from both.
"""
