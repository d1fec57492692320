// T5 attention core, backward, for Hopper (sm_90a): the fused block's
// backward core (K4) and the chunked path's kernel backward (K2b), and the
// entry point of K2a (t5_attention_bwd_fp32.cu).
//
// Per (batch b, head h), with s = q . k^T + pos[h] + key_mask[b] and the
// forward's softmax statistics (m, l):
//   p     = exp(s - m) / l                 (fp32, normalised BEFORE rounding)
//   dv    = bf16(p)^T . g
//   ds    = p * (g . v^T - delta)          (fp32)
//   dq    = bf16(ds) . k,  dk = bf16(ds)^T . q
//   dpos[h] = sum_b ds                     (fp32, deterministic)
// with bf16 product operands and fp32 accumulation:
//   K4  (pnt_t5_attention_bwd) replaces the per-head core of v3_backward
//       (pacednegatives_tpu/ops/flash_v3.py:196-268, pallas_call at :279):
//       g is bf16 and delta is not given, so the dq pass first recomputes
//       o = bf16(p) . v and delta = sum_c g . o (fp32, from the fp32 o);
//       dq / dk / dv and o are stored in bf16 through strides (views into
//       the fused (B, L, 3*H*dk) d_qkv and (B, L, H*dk) buffers).
//   K2b (pnt_t5_attention_core_bwd, fp32_operands = 0) replaces
//       flash_attention_backward_v2 (pacednegatives_tpu/ops/flash.py:599,
//       pallas_call at :614): delta (dcap) and an fp32 g are given; a
//       pre-pass rounds g to bf16 (flash.py:555) into the caller's scratch;
//       dq / dk / dv leave in fp32, contiguous.
//
// What bounds it: K4 at its training shape (B 128, H 12, L 188, dk 64)
// moves ~300 MB (0.09 ms at 3.35 TB/s) for ~9 L x L x dk products per
// (b, h) as computed here, ~62 GFLOP (0.06 ms at the bf16 peak); K2b at
// (16, 12, 512, 64) ~164 MB (0.05 ms) for 7 products, ~34 GFLOP. Both are
// near the line, so the design keeps every operand on the tensor cores
// (wgmma), every tile arriving by TMA under the products, and the scores,
// probabilities and ds in registers: nothing L x L but dpos leaves the SM.
//
// The two passes (a persistent TMA + wgmma dq pass and dk/dv pass with p
// and ds in registers, dpos summed over the batch in a fixed order) are
// t5_attention_bwd.cuh's, shared with K2a (t5_attention_bwd_fp32.cu); this
// file instantiates them for bf16 operands and holds the C entry points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "t5_attention_bwd.cuh"

// C entry points, bound with ctypes. Strides are in elements; the head
// dimension is contiguous everywhere, the other strides of q/k/v/g
// multiples of 8 (bf16) or 4 (fp32) and their bases 16-byte aligned (TMA).
// Each launches its kernels on `stream` and returns 0 or a cudaError_t
// (the tensor maps' encoding, cudaGetLastError() after each launch);
// neither allocates. dpos_part is fp32 scratch of ceil(B / rows_per_group)
// * H * Lq * Lk (unused when that is one group).

// K4's core: q (B, H, Lq, dk); k, v (B, H, Lk, dk) sharing strides; g
// (B, H, Lq, dk); all bf16. pos (H, Lq, Lk) and key_mask (B, Lk) fp32
// contiguous; m, l (B, H, Lq) fp32. Outputs: dq, dk/dv (sharing strides)
// and out in bf16 (even strides); delta (B, H, Lq) fp32; dpos (H, Lq, Lk)
// fp32.
extern "C" int pnt_t5_attention_bwd(
    const void* q, const void* k, const void* v, long long q_sb,
    long long q_sh, long long q_sl, long long kv_sb, long long kv_sh,
    long long kv_sl, const void* g, long long g_sb, long long g_sh,
    long long g_sl, const void* pos, const void* key_mask, const void* m,
    const void* l, void* dq, long long dq_sb, long long dq_sh,
    long long dq_sl, void* dk, void* dv, long long dkv_sb, long long dkv_sh,
    long long dkv_sl, void* out, long long o_sb, long long o_sh,
    long long o_sl, void* delta, void* dpos_part, void* dpos, int B, int H,
    int Lq, int Lk, int dk_dim, int rows_per_group, int device,
    void* stream) {
  const int rc = check_args(device, B, H, Lq, Lk, rows_per_group);
  if (rc) return rc;
  const T5BwdArgs a{q,     k,     v,     q_sb, q_sh, q_sl,   kv_sb,
                    kv_sh, kv_sl, g_sb,  g_sh, g_sl, pos,    key_mask,
                    m,     l,     B,     H,    Lq,   Lk,     dk_dim,
                    rows_per_group};
  const Outs<bf16> o{static_cast<bf16*>(dq),  static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv),  dq_sb,
                     dq_sh,                   dq_sl,
                     dkv_sb,                  dkv_sh,
                     dkv_sl,                  static_cast<bf16*>(out),
                     o_sb,                    o_sh,
                     o_sl,                    static_cast<float*>(delta)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dpos_part);
  float* dp = static_cast<float*>(dpos);
  if (dk_dim == 64)
    return launch_passes<64, kK4>(a, g, g_sb, g_sh, g_sl, o, nullptr, part, dp,
                                  device, s);
  if (dk_dim == 128)
    return launch_passes<128, kK4>(a, g, g_sb, g_sh, g_sl, o, nullptr, part,
                                   dp, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2a / K2b: q (B, H, Lq, dk); k, v (B, H, Lk, dk) bf16 sharing strides; g
// (B, H, Lq, dk) fp32; pos (H, Lq, Lk), key_mask (B, Lk), m, l, dcap
// (B, H, Lq) fp32 contiguous. Outputs, fp32 contiguous: dq (B, H, Lq, dk),
// dk and dv (B, H, Lk, dk), dpos (H, Lq, Lk). fp32_operands = 1 runs K2a's
// numerics (t5_attention_bwd_fp32.cu), 0 K2b's. `scratch` holds
// pnt_t5_attention_core_bwd_scratch's bytes: K2b's g rounded to bf16 (read
// by TMA), K2a's g split into three bf16 planes and its dq partials.
extern "C" int pnt_t5_attention_core_bwd(
    const void* q, const void* k, const void* v, long long q_sb,
    long long q_sh, long long q_sl, long long kv_sb, long long kv_sh,
    long long kv_sl, const void* g, long long g_sb, long long g_sh,
    long long g_sl, const void* pos, const void* key_mask, const void* m,
    const void* l, const void* dcap, void* scratch, void* dq, void* dk,
    void* dv, void* dpos_part, void* dpos, int B, int H, int Lq, int Lk,
    int dk_dim, int rows_per_group, int fp32_operands, int device,
    void* stream) {
  int rc = check_args(device, B, H, Lq, Lk, rows_per_group);
  if (rc) return rc;
  if (dk_dim != 64 && dk_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const T5BwdArgs a{q,     k,     v,     q_sb, q_sh, q_sl,   kv_sb,
                    kv_sh, kv_sl, g_sb,  g_sh, g_sl, pos,    key_mask,
                    m,     l,     B,     H,    Lq,   Lk,     dk_dim,
                    rows_per_group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g32 = static_cast<const float*>(g);
  float* part = static_cast<float*>(dpos_part);
  float* dp = static_cast<float*>(dpos);
  if (fp32_operands)
    return t5_bwd_fp32_launch(a, g32, static_cast<const float*>(dcap),
                              static_cast<float*>(dq), static_cast<float*>(dk),
                              static_cast<float*>(dv), scratch, part, dp,
                              device, s);
  rc = launch_split_g<1>(g32, g_sb, g_sh, g_sl, static_cast<bf16*>(scratch),
                         H, Lq, dk_dim,
                         static_cast<long long>(B) * H * Lq * dk_dim, s);
  if (rc) return rc;
  const long long sl = dk_dim, sh = sl * Lq, sb = sh * H;  // g16, dq
  const long long kl = dk_dim, kh = kl * Lk, kb = kh * H;  // dk, dv
  const Outs<float> o{static_cast<float*>(dq),
                      static_cast<float*>(dk),
                      static_cast<float*>(dv),
                      sb,
                      sh,
                      sl,
                      kb,
                      kh,
                      kl,
                      nullptr,
                      0,
                      0,
                      0,
                      const_cast<float*>(static_cast<const float*>(dcap))};
  if (dk_dim == 64)
    return launch_passes<64, kK2b>(a, scratch, sb, sh, sl, o, nullptr, part,
                                   dp, device, s);
  return launch_passes<128, kK2b>(a, scratch, sb, sh, sl, o, nullptr, part,
                                  dp, device, s);
}

// The bytes of `scratch` pnt_t5_attention_core_bwd needs for these shapes,
// into *bytes. Returns 0 or a cudaError_t.
extern "C" int pnt_t5_attention_core_bwd_scratch(int B, int H, int Lq, int Lk,
                                                 int dk_dim,
                                                 int fp32_operands,
                                                 int device,
                                                 long long* bytes) {
  const int rc = check_args(device, B, H, Lq, Lk, 1);
  if (rc) return rc;
  if (dk_dim != 64 && dk_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  *bytes = fp32_operands ? t5_bwd_fp32_scratch(B, H, Lq, Lk, dk_dim)
                         : static_cast<long long>(B) * H * Lq * dk_dim * 2;
  return 0;
}
