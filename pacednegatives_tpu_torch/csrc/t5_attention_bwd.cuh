// What the attention-backward sources share: the arguments of one call of
// pnt_t5_attention_bwd / pnt_t5_attention_core_bwd, and the fp32-operand
// kernels' launcher (K2a, t5_attention_bwd_fp32.cu).

#pragma once

#include <cuda_runtime.h>

// Strides in elements, (batch, head, row); the head dimension contiguous.
// q (B, H, Lq, dk), k and v (B, H, Lk, dk) bf16 sharing strides, g
// (B, H, Lq, dk); pos (H, Lq, Lk), key_mask (B, Lk), m and l (B, H, Lq)
// fp32 contiguous.
struct T5BwdArgs {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_sl, kv_sb, kv_sh, kv_sl, g_sb, g_sh, g_sl;
  const void *pos, *key_mask, *m, *l;
  int B, H, Lq, Lk, dk, rows_per_group;
};

int t5_bwd_fp32_launch(const T5BwdArgs& a, const float* g, const float* dcap,
                       float* dq, float* dk, float* dv, float* part,
                       cudaStream_t stream);
