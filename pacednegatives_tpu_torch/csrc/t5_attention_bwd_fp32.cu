// T5 attention core, backward, with fp32 operands (K2a), for Hopper
// (sm_90a): the passes of t5_attention_bwd.cuh with every fp32 operand
// split into three bf16 terms on the tensor cores.
//
// Replaces flash_attention_backward (pacednegatives_tpu/ops/flash.py:316,
// pallas_calls at :353 and :384, _bwd_dq_kernel and _bwd_dkv_kernel): every
// product takes fp32 operands (flash.py:215-232, 277-298). Per (batch b,
// head h), with s = q . k^T + pos[h] + key_mask[b] and the forward's
// softmax statistics (m, l), delta (dcap) and the fp32 cotangent g given:
//   p  = exp(s - m) / l,  dv = p^T . g,  ds = p * (g . v^T - delta)
//   dq = ds . k,  dk = ds^T . q,  dpos[h] = sum_b ds   (deterministic)
// It is reached through pnt_t5_attention_core_bwd (t5_attention_bwd.cu)
// with fp32_operands = 1.
//
// The split. q, k and v are bf16 in memory, so one bf16 term each. Each
// fp32 operand x (g, p, ds) becomes x0 + x1 + x2 with x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), rounded to nearest. The
// residuals are exact in fp32: x - x0 has at most 15 significant bits and
// x - x0 - x1 at most 7, which x2 holds exactly. So for |x| >= 2^-110 the
// three terms sum to x exactly; below that bf16's subnormal spacing leaves
// at most 2^-134 (and p under 2^-126 is already 0: ex2.approx.ftz). A
// product of two bf16 terms is exact in the fp32 accumulator. g is split
// once by a pre-pass (split_g_kernel<3>; K2b's rounding is <1>) into
// three planes that TMA loads like K2b's rounded g; p and ds are split in
// registers into three sets of A fragments.
//
// Products, in bf16 wgmma passes over a 64 x 64 tile (m64nNk16 over the
// tile's depth), smallest terms first:
//   S  = q . k^T               1  exact products (as K2b)
//   dP = sum_j g_j . v^T       3  exact
//   dQ = sum_i ds_i . k        3  exact
//   dK = sum_i ds_i^T . q      3  exact
//   dV = sum p_i^T . g_j       6  the pairs i + j <= 2; dropped: p1 g2,
//                                 p2 g1, p2 g2, |p1| <= 2^-8 |p| and
//                                 |g2| <= 2^-16 |g|, so at most
//                                 2^-23 (1 + 2^-8) |p| |g| a term
// 7 in the dq pass and 13 in the dk/dv pass (K2b: 3 and 4); at dk 128 the
// dk/dv pass runs S^T and dP^T once for each 64-column half of dK / dV,
// 17. The error against exact arithmetic on the same fp32 operands is then
// dV's dropped terms, at most 2^-23 sum_q p |g| (1.2e-7 of that sum), and
// what the plain version has too: fp32 sums in another order (the tensor
// cores truncate theirs), ~n 2^-23 sum |a||b| at depth n, and p's exp and
// 1 / l from the MUFU (~2^-22 relative). Against the tolerance, 1e-4 of
// each output's largest magnitude (dpos included), the split costs
// nothing. Two terms would leave x - x0 - x1 (up to 2^-16 |x|) in every
// product: tests/test_torch_k2a_split.py emulates both in float64.
//
// What bounds it: at the L 768 training shape (8, 12, 768, 64) the call
// moves ~160 MB (0.05 ms at 3.35 TB/s), and the function needs 16 bf16
// passes of 7.25 GFLOP, 116 GFLOP (0.117 ms at the bf16 peak): the tensor
// cores. The kernel runs 20 (24 at dk 128): both passes recompute S and
// dP. The same five products as fp32 FMAs would take 0.54 ms at 67
// TFLOP/s.
// So the design is K2b's (p, ds and every product on the tensor cores,
// tiles by TMA under the products), with three times the passes.
//
// dpos. The dq pass keeps the group's 64 x keys band in shared memory;
// with three g planes beside the tiles a 768-key band (196 KB) does not
// fit, so the keys are cut into the fewest chunks whose band does (at Lk
// 768, dk 64: two of 384 keys, 100 KB of band, 197 KB a CTA), rather than
// K4's and K2b's fallback of the band in the partial slab, whose
// read-modify-writes in global memory sit on each tile's path. Each
// chunk's item stores its own dq: chunk 0 into dq, the others as partials
// that the slab sum adds in chunk order. No atomics anywhere: two runs
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "t5_attention_bwd.cuh"

namespace {

template <int DK>
long long scratch_bytes(int B, int H, int Lq, int Lk) {
  const long long n = static_cast<long long>(B) * H * Lq * DK;
  return 3 * n * 2 + (band_plan<DK, kK2a>(Lk).chunks - 1) * n * 4;
}

}  // namespace

// g's three planes (bf16) and the dq partials of the key chunks but the
// first (fp32), in that order.
long long t5_bwd_fp32_scratch(int B, int H, int Lq, int Lk, int dk) {
  return dk == 64 ? scratch_bytes<64>(B, H, Lq, Lk)
                  : scratch_bytes<128>(B, H, Lq, Lk);
}

int t5_bwd_fp32_launch(const T5BwdArgs& a, const float* g, const float* dcap,
                       float* dq, float* dk, float* dv, void* scratch,
                       float* dpos_part, float* dpos, int device,
                       cudaStream_t stream) {
  const long long n = static_cast<long long>(a.B) * a.H * a.Lq * a.dk;
  bf16* planes = static_cast<bf16*>(scratch);
  const int rc = launch_split_g<3>(g, a.g_sb, a.g_sh, a.g_sl, planes, a.H,
                                   a.Lq, a.dk, n, stream);
  if (rc) return rc;
  float* dq_part = reinterpret_cast<float*>(planes + 3 * n);
  const long long sl = a.dk, sh = sl * a.Lq, sb = sh * a.H;  // planes, dq
  const long long kl = a.dk, kh = kl * a.Lk, kb = kh * a.H;  // dk, dv
  const Outs<float> o{dq, dk, dv, sb, sh, sl, kb, kh, kl, nullptr, 0, 0, 0,
                      const_cast<float*>(dcap)};
  if (a.dk == 64)
    return launch_passes<64, kK2a>(a, planes, sb, sh, sl, o, dq_part,
                                   dpos_part, dpos, device, stream);
  if (a.dk == 128)
    return launch_passes<128, kK2a>(a, planes, sb, sh, sl, o, dq_part,
                                    dpos_part, dpos, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
