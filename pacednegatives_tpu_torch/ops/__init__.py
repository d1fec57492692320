"""Kernel wrappers with their plain PyTorch versions, and the training ops.

- ``flash``: the T5 attention core, forward (K1, ``csrc/t5_attention_fwd.cu``)
  and backward (K4's core and the chunked path's K2a / K2b, both in
  ``csrc/t5_attention_bwd.cu``);
- ``gemm``: the bf16 projection GEMM, ``csrc/gemm_bf16.cu``;
- ``flash_v3``: the fused self-attention block, forward (K3) and backward
  (K4), built from both, with its autograd Function;
- ``mips``: blockwise MIPS top-k over fp32 / bf16 docs (K5) and an int8
  index (K6), ``csrc/mips_topk.cu``, and the exact and streaming paths;
- ``embedding``: the embedding lookup, its backward a segmented sum on the
  card (E1, ``csrc/embed_grad.cu``);
- ``losses`` and ``sampling``: the training losses and the paced negative
  sampler (plain PyTorch, as the JAX package leaves them to XLA).
"""
