// T5 attention core, forward, for Hopper (sm_90a).
//
// Per (batch b, head h):  out = softmax(q . k^T + pos[h] + key_mask[b]) . v
// with no 1/sqrt(dk) scaling (T5 folds it into the init), plus the softmax
// statistics m (row max) and l (row sum of exp(s - m)), in natural-log units.
//
// Replaces: _flash_fwd_kernel / flash_attention_forward
// (pacednegatives_tpu/ops/flash.py:43,94), _fwd_v2_kernel /
// flash_attention_forward_v2 (ops/flash.py:451,480), and the per-head
// softmax core of _v3_fwd_kernel (ops/flash_v3.py:94-129). One kernel covers
// all three: v1's kv-block sweep becomes a loop inside the block, and v2's
// "all keys resident" is a block size that does not fit an SM's shared
// memory at L = 512, so it is not kept.
//
// What bounds it: at the serving shape (B = 256, H = 12, L = 188, dk = 64)
// the two products are ~28 GFLOP per call (28 us at the bf16 peak) against
// ~300 MB of q/k/v/out (~90 us at 3.35 TB/s): device memory, if the scores
// never leave the SM, the products run on wgmma and the softmax's exp and
// max work stays off the critical path. At that length a (b, h) has only
// three 64-key tiles, so what a CTA pays to start (barriers, the first
// loads) weighs as much as its products.
//
// Design (hopper_pipeline.cuh): a persistent grid, as many CTAs as fit the
// card (three an SM for dk 64), walks work items of (64-row query tile, b,
// h), query tile fastest, then b, then h, so the items in flight at once
// share a head's pos slice (H * L * L fp32 in all) and a (b, h)'s keys in
// L2. A producer warp TMA-loads each item's Q tile (into one slot, refilled
// as soon as the item's last S is done, under the item's last softmax and
// stores) and its K and V tiles of 64 keys, with the tile's pos (64 x 64
// fp32, two 32-column boxes) when pos rows are 16-byte multiples, into a
// ring of stages (two, three for dk 64 without pos), each guarded by a
// "full" mbarrier (armed with its bytes) and an "empty" one (one arrival
// per consumer warp). One consumer warpgroup owns the item's 64 query rows:
//   S = Q . K^T by m64n64k16 bf16 wgmmas, both operands K-major from the
//     swizzled tiles (128-byte rows of 64 dk values; dk 128 is two boxes),
//     issued while the last tile's P . V still runs;
//   meanwhile the tile's key mask is loaded into the accumulator layout
//     (pos too where it is not staged: a quad of lanes reads 8 consecutive
//     columns of one row, 32-byte pieces, every byte used);
//   the online softmax runs on the accumulator registers: s = (acc + pos)
//     + mask in that order, keys past Lk set to -inf by index (only on a
//     tile that runs past Lk), the running max started at -1e9 as the TPU
//     kernels start it, a row's max and sum over its quad by two shuffles,
//     exp as ex2 of (s - m) * log2(e);
//   the UNNORMALISED p is rounded to bf16 straight into wgmma A fragments
//     (the accumulator layout is the A fragment layout), l is summed from
//     the unrounded p, O (registers) is rescaled by exp(m_old - m_new), and
//     O += P . V by m64n{64,128}k16 wgmmas with A from registers and V as an
//     N-major B from its tile (no transpose copy), left running;
//   at the end O * (1 / max(l, 1e-30)) is stored from registers in the
//     caller's strides, with m and l (natural-log units).
//
// Ragged lengths: q/k/v are 4-D tensor maps (dk, rows, heads, batch; the
// rows and heads dimensions in whichever order their strides ascend), each
// dimension bounded on its own, so rows past Lq / Lk load as zeros rather
// than the next head's or batch row's; keys past Lk are then masked by
// index. q/k/v are read through (batch, head, row) strides with a
// contiguous head dimension, so the same kernel reads K1's (B, H, L, dk)
// layout and K3's fused (B, L, 3*H*dk) qkv buffer, and writes K3's
// (B, L, H*dk) layout. pos rows that are not 16-byte multiples (Lk 33, Lk
// 190) cannot be TMA boxes: they are read from global memory, 8 bytes a
// lane where Lk is even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_pipeline.cuh"

namespace {

constexpr int BQ = 64;    // query rows per CTA: one m64 wgmma tile
constexpr int BKV = 64;   // keys per tile
constexpr int CONSUMERS = 128;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr float NEG_INF = -1e9f;  // the repo's additive mask value (t5.py:33)
constexpr float LOG2E = 1.4426950408889634f;

constexpr int POS_BYTES = 64 * 64 * 4;  // a 64 x 64 fp32 tile of pos

// POS_TMA: the pos tile rides in each stage (two 32-column boxes).
template <int DK, bool POS_TMA>
struct Cfg {
  static constexpr int TILE = 64 * DK * 2;  // one 64-row bf16 tile, bytes
  static constexpr int STAGE = 2 * TILE + (POS_TMA ? POS_BYTES : 0);
  static constexpr int STAGES = POS_TMA || DK == 128 ? 2 : 3;
  static constexpr int SMEM = TILE + STAGES * STAGE + (2 + 2 * STAGES) * 8 +
                              1024;
  // dk 64 with pos staged: three CTAs an SM (72 KB each, <= 136 registers)
  static constexpr int MIN_BLOCKS = DK == 64 && POS_TMA ? 3 : 2;
};

template <int DK>
__device__ __forceinline__ void pv_wgmma(float (&o)[DK / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (DK == 64)
    hopper::wgmma_m64n64k16_bf16_ra<1>(o, a, desc_v);
  else
    hopper::wgmma_m64n128k16_bf16_ra<1>(o, a, desc_v);
}

// One work item: a 64-row query tile of one (b, h). Items run query tile
// fastest, then b, then h.
struct Item {
  int q0, b, h;
};

__device__ __forceinline__ Item item_of(long long it, int nqt, int B) {
  const long long bh = it / nqt;
  return {static_cast<int>(it % nqt) * BQ, static_cast<int>(bh % B),
          static_cast<int>(bh / B)};
}

// 2^x (MUFU; relative error ~2^-22, far below the bf16 rounding of p)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = (S + pos) + mask over a 64-key tile, in place, and each row half's
// max; EDGE: the tile runs past Lk, and columns 8j + e >= lim are -inf.
template <bool EDGE>
__device__ __forceinline__ void bias_and_max(float (&sacc)[32],
                                             const float (&pb)[32],
                                             const float (&mk)[16], int lim,
                                             float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int xi = 4 * j + 2 * hh + e;
        float s = (sacc[xi] + pb[xi]) + mk[2 * j + e];
        if (EDGE && 8 * j + e >= lim) s = -INFINITY;
        sacc[xi] = s;
        mx[hh] = fmaxf(mx[hh], s);
      }
}

template <int DK, bool OUT_F32, bool POS_TMA>
__global__ void __launch_bounds__(THREADS, (Cfg<DK, POS_TMA>::MIN_BLOCKS))
    t5_attention_fwd_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_pos, int q_rows_inner,
    int kv_rows_inner, const float* __restrict__ pos,
    const float* __restrict__ key_mask, void* __restrict__ out,
    long long o_sb, long long o_sh, long long o_sl, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int H, int Lq, int Lk) {
  using C = Cfg<DK, POS_TMA>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start aligned (an
  // offset from the shared array, so that its reads stay shared loads)
  unsigned char* smem =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + C::TILE;  // stage s: K, V (, pos)
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sKV + C::STAGES * C::STAGE);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qfull + 2;
  uint64_t* empty = full + C::STAGES;

  const int nqt = (Lq + BQ - 1) / BQ;
  const long long items = static_cast<long long>(nqt) * B * H;
  const int ntiles = (Lk + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qempty, 4);  // one arrive per consumer warp
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive + bytes
      hopper::mbar_init(&empty[s], 4);  // one arrive per consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp; one thread issues
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const Item x = item_of(it, nqt, B);
        // the next item's Q as soon as the last one's final S is done
        hopper::mbar_wait(qempty, qphase ^ 1);
        hopper::mbar_expect_tx(qfull, C::TILE);
        hopper::load_rows<DK>(sQ, &map_q, q_rows_inner, qfull, x.q0, x.h,
                              x.b);
        qphase ^= 1;
        for (int i = 0; i < ntiles; ++i) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = sKV + stage * C::STAGE;
          hopper::mbar_expect_tx(&full[stage], C::STAGE);
          hopper::load_rows<DK>(st, &map_k, kv_rows_inner, &full[stage],
                                i * BKV, x.h, x.b);
          hopper::load_rows<DK>(st + C::TILE, &map_v, kv_rows_inner,
                                &full[stage], i * BKV, x.h, x.b);
          if (POS_TMA) {
            for (int c = 0; c < 2; ++c)
              hopper::tma_load_4d(st + 2 * C::TILE + c * 8192, &map_pos,
                                  &full[stage], i * BKV + 32 * c, x.q0, x.h,
                                  0);
          }
          if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool pairs = (Lk & 1) == 0;  // 8-byte aligned column pairs
  int stage = 0;
  uint32_t phase = 0, qphase = 0;
  float sacc[32], o[DK / 2];
  uint32_t pa[4][4];  // P as four k16 A fragments, bf16

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const Item x = item_of(it, nqt, B);
    // this thread's rows: r0 (accumulator half 0) and r0 + 8 (half 1);
    // rows past Lq read row Lq - 1's bias (finite), results dropped
    const int r0 = x.q0 + warp * 16 + g;
    const float* prow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      prow[hh] = pos + (static_cast<long long>(x.h) * Lq +
                        min(r0 + 8 * hh, Lq - 1)) * Lk;
    const float* mrow = key_mask + static_cast<long long>(x.b) * Lk;
    float m_i[2] = {NEG_INF, NEG_INF};  // as the TPU kernels start it
    float l_i[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < DK / 2; ++j) o[j] = 0.0f;

    hopper::mbar_wait(qfull, qphase);
    qphase ^= 1;
    int prev = -1;  // the stage whose P . V may still be running
    for (int i = 0; i < ntiles; ++i) {
      const int k0 = i * BKV;
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* sK = sKV + stage * C::STAGE;
      const unsigned char* sV = sK + C::TILE;
      const unsigned char* sP = sV + C::TILE;

      // S = Q . K^T (64 x 64), fp32 accumulation, issued while the last
      // tile's P . V still runs. A descriptor's low bits are the address
      // / 16, so a k-step adds its byte offset / 16 to the tile's.
      const uint64_t dq = hopper::make_desc(sQ, 16, 1024);
      const uint64_t dk = hopper::make_desc(sK, 16, 1024);
#pragma unroll
      for (int j = 0; j < 32; ++j) sacc[j] = 0.0f;
      hopper::fence_regs(sacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int off = ((kk / 4) * 8192 + (kk % 4) * 32) >> 4;
        hopper::wgmma_m64n64k16_bf16(sacc, dq + off, dk + off);
      }
      hopper::wgmma_commit();

      // this tile's key mask (and pos, unless staged), in the accumulator
      // layout, while the products run: column 8j + 2t + e of rows r0
      // (hh 0) and r0 + 8 (hh 1)
      float pb[32], mk[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + 8 * j + 2 * t;
        if (POS_TMA) {  // pos from the stage below; Lk % 4 == 0 here
          float2 mv = make_float2(0.0f, 0.0f);
          if (c < Lk) mv = __ldg(reinterpret_cast<const float2*>(mrow + c));
          mk[2 * j] = mv.x;
          mk[2 * j + 1] = mv.y;
        } else if (pairs) {
          float2 mv = make_float2(0.0f, 0.0f);
          float2 pv[2] = {mv, mv};
          if (c < Lk) {
            mv = __ldg(reinterpret_cast<const float2*>(mrow + c));
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              pv[hh] = __ldg(reinterpret_cast<const float2*>(prow[hh] + c));
          }
          mk[2 * j] = mv.x;
          mk[2 * j + 1] = mv.y;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            pb[4 * j + 2 * hh] = pv[hh].x;
            pb[4 * j + 2 * hh + 1] = pv[hh].y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = c + e < Lk;
            mk[2 * j + e] = ok ? __ldg(mrow + c + e) : 0.0f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              pb[4 * j + 2 * hh + e] = ok ? __ldg(prow[hh] + c + e) : 0.0f;
          }
        }
      }
      hopper::wgmma_wait<0>();  // this S and the last tile's P . V
      hopper::fence_regs(sacc);
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::keep_regs(pa[kk]);
      __syncwarp();
      if (lane == 0) {
        if (prev >= 0) hopper::mbar_arrive(&empty[prev]);
        if (i == ntiles - 1) hopper::mbar_arrive(qempty);  // Q is free
      }
      prev = stage;
      if (POS_TMA) {
        // pos (row 16 warp + g + 8 hh of the tile, column 8j + 2t) from
        // its 32-column box (128-byte rows, 16-byte chunks xor-ed with
        // row % 8)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int cc = 8 * (j % 4) + 2 * t;
            const float2 pv = *reinterpret_cast<const float2*>(
                sP + (j / 4) * 8192 + (warp * 16 + g + 8 * hh) * 128 +
                ((((cc >> 2) ^ g) << 4) | ((cc & 3) << 2)));
            pb[4 * j + 2 * hh] = pv.x;
            pb[4 * j + 2 * hh + 1] = pv.y;
          }
      }

      // online softmax on the accumulators (flash.py:73-89)
      float mx[2] = {-INFINITY, -INFINITY};
      if (k0 + BKV <= Lk)
        bias_and_max<false>(sacc, pb, mk, 0, mx);
      else
        bias_and_max<true>(sacc, pb, mk, Lk - k0 - 2 * t, mx);
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_i[hh], mx[hh]);
        corr[hh] = ex2((m_i[hh] - m_new) * LOG2E);
        m_i[hh] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int xi = 4 * (2 * kk + half) + 2 * hh;
            const float p0 = ex2((sacc[xi] - m_i[hh]) * LOG2E);
            const float p1 = ex2((sacc[xi + 1] - m_i[hh]) * LOG2E);
            psum[hh] += p0 + p1;
            const __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
            pa[kk][2 * half + hh] = *reinterpret_cast<const uint32_t*>(&pp);
          }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
        psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
        l_i[hh] = l_i[hh] * corr[hh] + psum[hh];
      }
#pragma unroll
      for (int j = 0; j < DK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) o[4 * j + 2 * hh + e] *= corr[hh];

      // O += P . V, left running under the next tile's S: V's tile is
      // N-major for B (dk contiguous), 64-column boxes 8 KB apart, 8-key
      // groups 1 KB apart, 16 keys (2 KB) a k-step
      const uint64_t dv = hopper::make_desc(sV, 8192, 1024);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pv_wgmma<DK>(o, pa[kk], dv + ((kk * 2048) >> 4));
      hopper::wgmma_commit();
      if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::keep_regs(pa[kk]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // normalise and store this thread's rows from registers
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= Lq) continue;
      const float l_fin = fmaxf(l_i[hh], 1e-30f);  // the TPU kernels' clamp
      const float inv = 1.0f / l_fin;
      if (t == 0) {
        const long long idx =
            (static_cast<long long>(x.b) * H + x.h) * Lq + row;
        m_out[idx] = m_i[hh];
        l_out[idx] = l_fin;
      }
      const long long base = x.b * o_sb + x.h * o_sh + row * o_sl;
#pragma unroll
      for (int j = 0; j < DK / 8; ++j) {
        const float x0 = o[4 * j + 2 * hh] * inv;
        const float x1 = o[4 * j + 2 * hh + 1] * inv;
        const long long off = base + 8 * j + 2 * t;
        if (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
              make_float2(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  }
}

template <int DK, bool OUT_F32, bool POS_TMA>
int launch_as(const CUtensorMap& map_q, const CUtensorMap& map_k,
              const CUtensorMap& map_v, const CUtensorMap& map_pos, int q_ri,
              int kv_ri, const void* pos, const void* key_mask, void* out,
              long long o_sb, long long o_sh, long long o_sl, void* m, void* l,
              int B, int H, int Lq, int Lk, int device,
              cudaStream_t stream) {
  auto kernel = t5_attention_fwd_kernel<DK, OUT_F32, POS_TMA>;
  constexpr int bytes = Cfg<DK, POS_TMA>::SMEM;  // above 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many CTAs as fit the card at once, each walking items
  static int fit = 0;  // CTAs an SM holds (the same on every H100)
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, THREADS,
                                                        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long items = static_cast<long long>((Lq + BQ - 1) / BQ) * B * H;
  const long long cap = static_cast<long long>(fit) * hopper::sm_count(device);
  const int grid = static_cast<int>(items < cap ? items : cap);
  kernel<<<grid, THREADS, bytes, stream>>>(
      map_q, map_k, map_v, map_pos, q_ri, kv_ri,
      static_cast<const float*>(pos), static_cast<const float*>(key_mask),
      out, o_sb, o_sh, o_sl, static_cast<float*>(m), static_cast<float*>(l),
      B, H, Lq, Lk);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, bool OUT_F32>
int launch(const void* q, const void* k, const void* v, long long q_sb,
           long long q_sh, long long q_sl, long long kv_sb, long long kv_sh,
           long long kv_sl, const void* pos, const void* key_mask, void* out,
           long long o_sb, long long o_sh, long long o_sl, void* m, void* l,
           int B, int H, int Lq, int Lk, int device, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int q_ri = 1, kv_ri = 1;
  int rc = hopper::qkv_map(&map_q, q, DK, Lq, H, B, q_sb, q_sh, q_sl, &q_ri);
  if (!rc)
    rc = hopper::qkv_map(&map_k, k, DK, Lk, H, B, kv_sb, kv_sh, kv_sl, &kv_ri);
  if (!rc)
    rc = hopper::qkv_map(&map_v, v, DK, Lk, H, B, kv_sb, kv_sh, kv_sl, &kv_ri);
  if (rc) return rc;
  // pos as 32 x 64 boxes where its rows are 16-byte multiples (TMA); other
  // lengths read pos from global memory
  CUtensorMap map_pos;
  rc = hopper::pos_map(&map_pos, pos, H, Lq, Lk);
  if (rc > 0) return rc;
  if (rc == 0)
    return launch_as<DK, OUT_F32, true>(map_q, map_k, map_v, map_pos, q_ri,
                                        kv_ri, pos, key_mask, out, o_sb, o_sh,
                                        o_sl, m, l, B, H, Lq, Lk, device,
                                        stream);
  return launch_as<DK, OUT_F32, false>(map_q, map_k, map_v, map_q, q_ri, kv_ri,
                                       pos, key_mask, out, o_sb, o_sh, o_sl,
                                       m, l, B, H, Lq, Lk, device, stream);
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements; the head
// dimension is contiguous, the other q/k/v strides multiples of 8 and the
// bases 16-byte aligned (TMA). pos is (H, Lq, Lk) fp32 and key_mask (B, Lk)
// fp32, both contiguous; m and l are (B, H, Lq) fp32. Returns 0 or a
// cudaError_t (the tensor maps' encoding, the launch's cudaGetLastError()).
// Launches on `stream`; allocates nothing.
extern "C" int pnt_t5_attention_fwd(
    const void* q, const void* k, const void* v, long long q_sb,
    long long q_sh, long long q_sl, long long kv_sb, long long kv_sh,
    long long kv_sl, const void* pos, const void* key_mask, void* out,
    long long o_sb, long long o_sh, long long o_sl, int out_f32, void* m,
    void* l, int B, int H, int Lq, int Lk, int dk, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PNT_ARGS                                                            \
  q, k, v, q_sb, q_sh, q_sl, kv_sb, kv_sh, kv_sl, pos, key_mask, out, o_sb, \
      o_sh, o_sl, m, l, B, H, Lq, Lk, device, s
  if (dk == 64) return out_f32 ? launch<64, true>(PNT_ARGS)
                               : launch<64, false>(PNT_ARGS);
  if (dk == 128) return out_f32 ? launch<128, true>(PNT_ARGS)
                                : launch<128, false>(PNT_ARGS);
#undef PNT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
