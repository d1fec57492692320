// The attention-backward passes shared by K4's core and K2b
// (t5_attention_bwd.cu) and K2a (t5_attention_bwd_fp32.cu), templated on
// the precision of the products' operands, and the arguments of one call.
//
// Per (batch b, head h), with s = q . k^T + pos[h] + key_mask[b] and the
// forward's softmax statistics (m, l): p = exp(s - m) / l, dv = p^T . g,
// ds = p * (g . v^T - delta), dq = ds . k, dk = ds^T . q and dpos[h] =
// sum_b ds (fp32, deterministic). The Mode says what the products take:
//   kK4, kK2b: bf16 operands. g is one bf16 plane, p and ds are rounded to
//     bf16 as A fragments (K4 also recomputes o and delta in the dq pass).
//   kK2a: fp32 operands. g arrives as three bf16 planes g0 + g1 + g2 (a
//     pre-pass splits it), p and ds are split the same way into three sets
//     of A fragments, and every product is a sum of bf16 products on the
//     tensor cores (which terms, and the error: t5_attention_bwd_fp32.cu).
//
// Design (hopper_pipeline.cuh, as the forward t5_attention_fwd.cu): two
// persistent kernels, each with a producer warp that TMA-loads 64-row bf16
// tiles through 4-D maps (dk, rows, heads, batch; the caller's strides)
// into a two-stage mbarrier ring, and one consumer warpgroup:
//   dq pass, work items (64-query tile, key chunk, head, group of batch
//     rows): for each row b of the group, Q and G's planes once (one slot,
//     refilled when the row's last S is done), then K, V and the pos tile
//     per 64-key tile of the chunk. S = Q . K^T and dP = G . V^T on
//     m64n64k16 wgmmas (both operands K-major from the swizzled tiles), p
//     and ds on the accumulator registers, dQ += ds . K on wgmmas with ds as
//     register A fragments (the accumulator layout is the A-fragment
//     layout) and K as an N-major B. K4 first sweeps the keys once for
//     O += bf16(p) . V the same way (p is normalised, so no rescaling),
//     stores o and keeps delta in registers. ds is added into the group's
//     (64 x chunk) dpos band in shared memory, row by row in batch order;
//     the group's last row writes the band to its partial slab. The keys
//     are one chunk where the band fits beside the tiles; K2a cuts them
//     into the fewest chunks whose band fits (two at Lk 768, dk 64) and
//     stores each chunk's dq as a partial that the slab sum adds in chunk
//     order; K4 and K2b keep one chunk and, where the band does not fit (dk
//     128 with Lk 512), keep it in the slab itself.
//   dk/dv pass, work items (64-key tile, b, h): K and V once (one slot),
//     then Q, G's planes, the pos tile and the m / l / delta rows per
//     64-query tile. S^T = K . Q^T and dP^T = V . G^T, p^T and ds^T in
//     registers, dV += p^T . G and dK += ds^T . Q (G, Q as N-major B),
//     stored from registers through the caller's strides. K2a at dk 128
//     accumulates 64 of the columns an item (two items a key tile): its
//     two sets of three fragments leave no registers for 128 columns.
//   dpos = sum of the group partials in group order (no atomics: two runs
//     give the same bits); with one group the dq pass writes dpos itself.
// The pos tile (queries x keys, fp32) comes as two 32-column boxes with
// the 128-byte swizzle, which keeps the dk/dv pass's transposed reads free
// of bank conflicts; where pos rows are not 16-byte multiples (Lk 33, 130)
// the producer warp copies the tile into the same layout from global
// memory, and the producer warp also stages the m / l / delta rows.
// Ragged lengths: the maps are bounded per dimension, so rows past Lq / Lk
// load as zeros; p is set to 0 by index for keys past Lk and queries past
// Lq, and nothing is stored for them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_pipeline.cuh"

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

// K2a (t5_attention_bwd_fp32.cu): the bytes of scratch one call needs (g's
// three bf16 planes and the dq partials of its key chunks), and the call
// (dq, dk, dv contiguous fp32; dpos summed from the group partials).
long long t5_bwd_fp32_scratch(int B, int H, int Lq, int Lk, int dk);
int t5_bwd_fp32_launch(const T5BwdArgs& a, const float* g, const float* dcap,
                       float* dq, float* dk, float* dv, void* scratch,
                       float* dpos_part, float* dpos, int device,
                       cudaStream_t stream);

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { kK4, kK2b, kK2a };

// bf16 terms of each fp32 operand (g, p, ds): one, or three for K2a
template <int MODE>
__host__ __device__ constexpr int terms() {
  return MODE == kK2a ? 3 : 1;
}

// dq / dk / dv: bf16 for K4, fp32 for K2b and K2a
template <int MODE>
using OutT = typename std::conditional<MODE == kK4, bf16, float>::type;

constexpr int BQ = 64;   // query rows per tile: one m64 wgmma tile
constexpr int BKV = 64;  // keys per tile
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int POS_BYTES = 64 * 64 * 4;   // a 64 x 64 fp32 tile of pos
constexpr int STATS_BYTES = 1024;        // m, l, delta of 64 queries
constexpr int STAGES = 2;

constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// 2^x and 1/x (MUFU; relative errors ~2^-22 and ~2^-23). The kernels use
// no IEEE division or 64-bit integer division: those compile to calls,
// and a call anywhere in a kernel makes ptxas serialise its wgmmas.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The dq pass: Q, G's T planes (one slot), the ring of K, V, pos; then the
// barriers and, where it fits, the dpos band (64 x band_ld fp32).
template <int DK, int T>
struct CfgA {
  static constexpr int TILE = 64 * DK * 2;  // one 64-row bf16 tile, bytes
  static constexpr int STAGE = 2 * TILE + POS_BYTES;
  static constexpr int RING = (1 + T) * TILE;  // offset of the ring
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BAND = BARS + 128;
  static constexpr int SMEM = BAND + 1024;  // + the band; + alignment slack
};

// The dk/dv pass: K, V (one slot), the ring of Q, G's T planes, pos, stats.
template <int DK, int T>
struct CfgB {
  static constexpr int TILE = 64 * DK * 2;
  static constexpr int STAGE = (1 + T) * TILE + POS_BYTES + STATS_BYTES;
  static constexpr int RING = 2 * TILE;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int SMEM = BARS + 128 + 1024;
  // bf16 operands at dk 64: two CTAs an SM (85 KB each, <= 204 registers a
  // thread); K2a's three g planes take 115 KB, one CTA
  static constexpr int MIN_BLOCKS = DK == 64 && T == 1 ? 2 : 1;
  // dK / dV columns an item accumulates (K2a: 64, a half of dk 128)
  static constexpr int DN = T == 1 ? DK : 64;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  // the 128-byte swizzle repeats every 1024 bytes: tiles start aligned (an
  // offset from the shared array, so that its reads stay shared loads)
  return raw + ((1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u);
}

// acc (64 x 64, zeroed) += A . B^T over DK: A and B 64-row tiles, K-major
// (dk contiguous, 64-column boxes 8 KB apart), from shared memory. A
// descriptor's low bits are the address / 16, so a k-step adds its byte
// offset / 16.
template <int DK>
__device__ __forceinline__ void product_ss(float (&acc)[32],
                                           const unsigned char* a,
                                           const unsigned char* b) {
  const uint64_t da = hopper::make_desc(a, 16, 1024);
  const uint64_t db = hopper::make_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int off = ((kk / 4) * 8192 + (kk % 4) * 32) >> 4;
    hopper::wgmma_m64n64k16_bf16(acc, da + off, db + off);
  }
}

// acc (64 x N) += A . B: A (64 x 64) as four k16 bf16 register fragments,
// B N columns of a 64-row tile read N-major (its rows are the k index, dk
// contiguous): 64-column boxes 8 KB apart, 8-row groups 1 KB apart, 16 rows
// a k-step.
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&a)[4][4],
                                           const unsigned char* b) {
  const uint64_t db = hopper::make_desc(b, 8192, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 64)
      hopper::wgmma_m64n64k16_bf16_ra<1>(acc, a[kk], db + ((kk * 2048) >> 4));
    else
      hopper::wgmma_m64n128k16_bf16_ra<1>(acc, a[kk],
                                          db + ((kk * 2048) >> 4));
  }
}

// (a, b) rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 pp = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&pp);
}

// A 64 x 64 fp32 accumulator as T sets of bf16 A fragments (k16 slice kk:
// columns 16 kk ..; a[i][kk] = pairs of term i of x[8kk + 0..7],
// hopper_pipeline.cuh): term 0 is x rounded to bf16, each further term
// the rounding of what the earlier ones leave (exact in fp32).
template <int T>
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[T][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo = x[8 * kk + 2 * i], hi = x[8 * kk + 2 * i + 1];
#pragma unroll
      for (int term = 0; term < T; ++term) {
        const uint32_t h = bf16_pair(lo, hi);
        a[term][kk][i] = h;
        if (term + 1 < T) {
          lo -= __uint_as_float(h << 16);
          hi -= __uint_as_float(h & 0xffff0000u);
        }
      }
    }
}

template <int T>
__device__ __forceinline__ void keep_frags(uint32_t (&a)[T][4][4]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::keep_regs(a[i][kk]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

__device__ __forceinline__ void store_pair(bf16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}

// Rows row(hh) of a 64 x N accumulator (columns 8j + 2t + e) through a
// row stride, skipping rows at or past `rows`.
template <int N, typename OT>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], OT* dst,
                                           long long ld, const int (&row)[2],
                                           int rows, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= rows) continue;
    OT* d = dst + row[hh] * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      store_pair(d + 8 * j, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// The 64 x 64 tile of pos at (q0, k0) of head h into `dst` in the layout
// TMA gives it (two 32-column boxes of 128-byte rows, 16-byte chunks xor-ed
// with row % 8), zeros outside [Lq, Lk): the producer warp, one column a
// lane in each box, for pos rows that TMA cannot take.
__device__ __forceinline__ void fill_pos(unsigned char* dst,
                                         const float* __restrict__ pos, int h,
                                         int q0, int k0, int Lq, int Lk,
                                         int lane) {
  const float* base = pos + (static_cast<long long>(h) * Lq + q0) * Lk + k0;
  const int rows = min(BQ, Lq - q0), cols = min(BKV, Lk - k0);
  for (int i = 0; i < 64; ++i) {
    const int sw = (((lane >> 2) ^ (i & 7)) << 4) | ((lane & 3) << 2);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 32 * c + lane;
      const float val = i < rows && j < cols
                            ? __ldg(base + static_cast<long long>(i) * Lk + j)
                            : 0.0f;
      *reinterpret_cast<float*>(dst + c * 8192 + i * 128 + sw) = val;
    }
  }
}

// The pos tile at (q0, k0) of head h by TMA: two 32-column boxes.
__device__ __forceinline__ void load_pos(unsigned char* dst,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int q0, int k0, int h) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
    hopper::tma_load_4d(dst + c * 8192, map, bar, k0 + 32 * c, q0, h, 0);
}

// The item's key mask for the accumulator columns 8j + 2t + e of a 64-key
// tile at k0 (8-byte loads where Lk is even; 0 past Lk).
__device__ __forceinline__ void load_mask(const float* __restrict__ mrow,
                                          int k0, int Lk, int t,
                                          float (&mk)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = k0 + 8 * j + 2 * t;
    if ((Lk & 1) == 0) {
      float2 mv = make_float2(0.0f, 0.0f);
      if (c < Lk) mv = __ldg(reinterpret_cast<const float2*>(mrow + c));
      mk[2 * j] = mv.x;
      mk[2 * j + 1] = mv.y;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mk[2 * j + e] = c + e < Lk ? __ldg(mrow + c + e) : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------------

// Work items: (64-key tile, column half, b, h), the half fastest, then the
// key tile, then b, then h, so the items in flight share a head's pos slice
// in L2 (and the two halves of a tile its loads).
struct ItemB {
  int k0, half, b, h;
};

__device__ __forceinline__ ItemB item_b(int it, int nkt, int halves, int B) {
  const int kt = it % (nkt * halves), bh = it / (nkt * halves);
  return {(kt / halves) * BKV, kt % halves, bh % B, bh / B};
}

// g's T bf16 planes: plane j of row b is row b + j * B of map_g; delta per
// query row given (K4: from the dq pass).
template <int DK, int MODE>
__global__ void __launch_bounds__(THREADS,
                                  (CfgB<DK, terms<MODE>()>::MIN_BLOCKS))
    dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_pos, int q_ri,
                int kv_ri, int g_ri, int pos_tma,
                const float* __restrict__ pos,
                const float* __restrict__ key_mask,
                const float* __restrict__ m_in,
                const float* __restrict__ l_in,
                const float* __restrict__ delta, OutT<MODE>* __restrict__ dk,
                OutT<MODE>* __restrict__ dv, long long dkv_sb,
                long long dkv_sh, long long dkv_sl, int B, int H, int Lq,
                int Lk) {
  constexpr int T = terms<MODE>();
  using C = CfgB<DK, T>;
  constexpr int DN = C::DN, HALVES = DK / DN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::TILE;
  unsigned char* ring = smem + C::RING;  // stage s: Q, G planes, pos, stats
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvfull + 2;
  uint64_t* empty = full + STAGES;

  const int nkt = cdiv(Lk, BKV);
  const int items = nkt * HALVES * B * H;  // < 2^31: the launcher checks

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvfull, 1);
    hopper::mbar_init(kvempty, 4);  // one arrive per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      // the producer's first lane with the bytes, then every producer lane
      // once its stats (and pos) stores are done
      hopper::mbar_init(&full[s], 33);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    const int lane = threadIdx.x - CONSUMERS;
    int stage = 0;
    uint32_t phase = 0, kvphase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const ItemB x = item_b(it, nkt, HALVES, B);
      // the next item's K and V once the last one's final S^T / dP^T ran
      hopper::mbar_wait(kvempty, kvphase ^ 1);
      kvphase ^= 1;
      if (lane == 0) {
        hopper::mbar_expect_tx(kvfull, 2 * C::TILE);
        hopper::load_rows<DK>(sK, &map_k, kv_ri, kvfull, x.k0, x.h, x.b);
        hopper::load_rows<DK>(sV, &map_v, kv_ri, kvfull, x.k0, x.h, x.b);
      }
      const long long st0 = (static_cast<long long>(x.b) * H + x.h) * Lq;
      for (int q0 = 0; q0 < Lq; q0 += BQ) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * C::STAGE;
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[stage],
                                 (1 + T) * C::TILE + (pos_tma ? POS_BYTES : 0));
          hopper::load_rows<DK>(st, &map_q, q_ri, &full[stage], q0, x.h, x.b);
#pragma unroll
          for (int j = 0; j < T; ++j)
            hopper::load_rows<DK>(st + (1 + j) * C::TILE, &map_g, g_ri,
                                  &full[stage], q0, x.h, x.b + j * B);
          if (pos_tma)
            load_pos(st + (1 + T) * C::TILE, &map_pos, &full[stage], q0, x.k0,
                     x.h);
        }
        if (!pos_tma)
          fill_pos(st + (1 + T) * C::TILE, pos, x.h, q0, x.k0, Lq, Lk, lane);
        // m, 1 / l, delta of the tile's queries (0, 1, 0 past Lq: finite)
        float* stats =
            reinterpret_cast<float*>(st + (1 + T) * C::TILE + POS_BYTES);
        for (int i = lane; i < BQ; i += 32) {
          const bool ok = q0 + i < Lq;
          stats[i] = ok ? __ldg(m_in + st0 + q0 + i) : 0.0f;
          stats[BQ + i] = ok ? rcp(__ldg(l_in + st0 + q0 + i)) : 1.0f;
          stats[2 * BQ + i] = ok ? __ldg(delta + st0 + q0 + i) : 0.0f;
        }
        hopper::mbar_arrive(&full[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int stage = 0;
  uint32_t phase = 0, kvphase = 0;
  float sacc[32], dpa[32], dv_acc[DN / 2], dk_acc[DN / 2];
  uint32_t pa[T][4][4], da[T][4][4];  // p^T, ds^T as A fragments

  // This thread's accumulator rows are keys 16 warp + g + 8 hh of the tile;
  // its columns, queries 8j + 2t + e. The pos tile is (query, key): the
  // element (c, kr) sits at box kr / 32, row c, chunk ((kr % 32) / 4) ^
  // (c % 8), and c % 8 = 2t + e, so the offsets are fixed per (hh, e).
  int pofs[2][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kr = 16 * warp + g + 8 * hh;
      const int c = 2 * t + e;
      pofs[hh][e] = (kr >> 5) * 8192 + c * 128 +
                    ((((kr & 31) >> 2) ^ c) << 4) + ((kr & 3) << 2);
    }

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const ItemB x = item_b(it, nkt, HALVES, B);
    int key[2];
    bool kok[2];
    float mk[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      key[hh] = x.k0 + 16 * warp + g + 8 * hh;
      kok[hh] = key[hh] < Lk;
      mk[hh] = kok[hh]
                   ? __ldg(key_mask + static_cast<long long>(x.b) * Lk + key[hh])
                   : 0.0f;
    }
    zero(dv_acc);
    zero(dk_acc);
    hopper::mbar_wait(kvfull, kvphase);
    kvphase ^= 1;
    int prev = -1;  // the stage whose dV / dK products may still run
    for (int q0 = 0; q0 < Lq; q0 += BQ) {
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* sQ = ring + stage * C::STAGE;
      const unsigned char* sG = sQ + C::TILE;
      const unsigned char* sP = sG + T * C::TILE;
      const float* stats = reinterpret_cast<const float*>(sP + POS_BYTES);

      // S^T = K . Q^T and dP^T = V . G^T (64 keys x 64 queries), g's
      // smallest plane first
      zero(sacc);
      zero(dpa);
      hopper::fence_regs(sacc);
      hopper::fence_regs(dpa);
      hopper::wgmma_fence();
      product_ss<DK>(sacc, sK, sQ);
#pragma unroll
      for (int j = T - 1; j >= 0; --j)
        product_ss<DK>(dpa, sV, sG + j * C::TILE);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();  // these and the last tile's dV / dK
      hopper::fence_regs(sacc);
      hopper::fence_regs(dpa);
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      keep_frags<T>(pa);
      keep_frags<T>(da);
      __syncwarp();
      if (lane == 0) {
        if (prev >= 0) hopper::mbar_arrive(&empty[prev]);
        if (q0 + BQ >= Lq) hopper::mbar_arrive(kvempty);  // K, V are free
      }
      prev = stage;

      // p^T = exp((s + pos) + mask - m) / l and ds^T = p^T (dp^T - delta),
      // 0 for keys past Lk and queries past Lq
      const int qlim = Lq - q0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float m_c = stats[c], rl_c = stats[BQ + c];
          const float d_c = stats[2 * BQ + c];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int xi = 4 * j + 2 * hh + e;
            const float pb =
                *reinterpret_cast<const float*>(sP + pofs[hh][e] + j * 1024);
            const float s = (sacc[xi] + pb) + mk[hh];
            float p = ex2((s - m_c) * LOG2E) * rl_c;
            if (!kok[hh] || c >= qlim) p = 0.0f;
            sacc[xi] = p;
            dpa[xi] = p * (dpa[xi] - d_c);
          }
        }
      to_frags<T>(sacc, pa);
      to_frags<T>(dpa, da);

      // dV += p^T . G over the term pairs (i, j) with i + j < T, and dK +=
      // ds^T . Q, smallest terms first, on the item's columns; left running
      // under the next tile's S^T
      const int cofs = x.half * 8192;  // the half's 64-column box
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int s = T - 1; s >= 0; --s)
#pragma unroll
        for (int i = s; i >= 0; --i)
          product_rs<DN>(dv_acc, pa[i], sG + (s - i) * C::TILE + cofs);
#pragma unroll
      for (int i = T - 1; i >= 0; --i)
        product_rs<DN>(dk_acc, da[i], sQ + cofs);
      hopper::wgmma_commit();
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    keep_frags<T>(pa);
    keep_frags<T>(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    const long long base = x.b * dkv_sb + x.h * dkv_sh + x.half * DN;
    store_rows<DN>(dv_acc, dv + base, dkv_sl, key, Lk, t);
    store_rows<DN>(dk_acc, dk + base, dkv_sl, key, Lk, t);
  }
}

// ---------------------------------------------------------------------------
// dq pass (and, for K4, o and delta)
// ---------------------------------------------------------------------------

// Work items: (64-query tile, key chunk, group of batch rows, h), query
// tile fastest. Keys [kb, ke) of chunk c; without CHUNKED (K4, K2b) one
// chunk of all keys, known at compile time.
struct ItemA {
  int q0, chunk, kb, ke, grp, h;
};

template <bool CHUNKED>
__device__ __forceinline__ ItemA item_a(int it, int nqt, int chunks,
                                        int chunk_keys, int groups, int Lk) {
  if constexpr (!CHUNKED) {
    const int gh = it / nqt;
    return {(it % nqt) * BQ, 0, 0, Lk, gh % groups, gh / groups};
  } else {
    const int r = it / nqt, c = r % chunks, gh = r / chunks;
    const int kb = c * chunk_keys;
    return {(it % nqt) * BQ, c, kb, min(Lk, kb + chunk_keys), gh % groups,
            gh / groups};
  }
}

// p = exp((s + pos) + mask - m) / l in place on a 64 x 64 S accumulator
// (rows row(hh), columns k0 + 8j + 2t + e), 0 past Lk and for rows past Lq;
// rl = 1 / l.
__device__ __forceinline__ void probs(float (&sacc)[32], const float (&pb)[32],
                                      const float (&mk)[16],
                                      const float (&m_i)[2],
                                      const float (&rl)[2],
                                      const bool (&rok)[2], int klim, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int xi = 4 * j + 2 * hh + e;
        const float s = (sacc[xi] + pb[xi]) + mk[2 * j + e];
        float p = ex2((s - m_i[hh]) * LOG2E) * rl[hh];
        if (!rok[hh] || 8 * j + 2 * t + e >= klim) p = 0.0f;
        sacc[xi] = p;
      }
}

// The pos tile's values in the accumulator layout: row 16 warp + g + 8 hh,
// column 8j + 2t (+1), from its 32-column box (128-byte rows, 16-byte
// chunks xor-ed with row % 8 = g).
__device__ __forceinline__ void pos_values(const unsigned char* sP, int warp,
                                           int g, int t, float (&pb)[32]) {
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

// K4: bf16 g, o and delta recomputed (written out), bf16 dq through
// strides. K2b / K2a: delta (dcap) given, fp32 dq (strides of a contiguous
// buffer); chunk c >= 1 of K2a's keys stores its dq at dq_part + (c - 1) *
// part_stride, with dq's strides. dpos partials: `part` (H, Lq, Lk) a
// group; band_ld > 0: the band lives in shared memory with that row
// stride, else (one chunk) in `part`.
template <int DK, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_g,
              const __grid_constant__ CUtensorMap map_pos, int q_ri, int kv_ri,
              int g_ri, int pos_tma, const float* __restrict__ pos,
              const float* __restrict__ key_mask,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              float* __restrict__ delta, OutT<MODE>* __restrict__ dq,
              long long dq_sb, long long dq_sh, long long dq_sl,
              OutT<MODE>* __restrict__ dq_part, long long part_stride,
              bf16* __restrict__ out, long long o_sb, long long o_sh,
              long long o_sl, float* __restrict__ part, int band_ld,
              int chunk_keys, int B, int H, int Lq, int Lk,
              int rows_per_group) {
  constexpr bool K4 = MODE == kK4;
  constexpr bool CHUNKED = MODE == kK2a;
  constexpr int T = terms<MODE>();
  using C = CfgA<DK, T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sG = smem + C::TILE;    // T planes
  unsigned char* ring = smem + C::RING;  // stage s: K, V, pos
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qfull + 2;
  uint64_t* empty = full + STAGES;
  float* band = reinterpret_cast<float*>(smem + C::BAND);

  const int nqt = cdiv(Lq, BQ);
  const int chunks = CHUNKED ? cdiv(Lk, chunk_keys) : 1;
  const int groups = cdiv(B, rows_per_group);
  const int items = nqt * chunks * groups * H;  // < 2^31: the launcher checks
  constexpr int SWEEPS = K4 ? 2 : 1;  // K4: o, then dq

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qempty, 4);  // one arrive per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      // the producer's first lane with the bytes (+ every producer lane
      // once its pos stores are done, where pos is not a TMA box)
      hopper::mbar_init(&full[s], pos_tma ? 1 : 33);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    const int lane = threadIdx.x - CONSUMERS;
    int stage = 0;
    uint32_t phase = 0, qphase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const ItemA x =
          item_a<CHUNKED>(it, nqt, chunks, chunk_keys, groups, Lk);
      const int b_end = min(B, (x.grp + 1) * rows_per_group);
      for (int b = x.grp * rows_per_group; b < b_end; ++b) {
        // the row's Q and G once the last row's final S / dP ran
        hopper::mbar_wait(qempty, qphase ^ 1);
        qphase ^= 1;
        if (lane == 0) {
          hopper::mbar_expect_tx(qfull, (1 + T) * C::TILE);
          hopper::load_rows<DK>(sQ, &map_q, q_ri, qfull, x.q0, x.h, b);
#pragma unroll
          for (int j = 0; j < T; ++j)
            hopper::load_rows<DK>(sG + j * C::TILE, &map_g, g_ri, qfull, x.q0,
                                  x.h, b + j * B);
        }
        for (int sweep = 0; sweep < SWEEPS; ++sweep)
          for (int k0 = x.kb; k0 < x.ke; k0 += BKV) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = ring + stage * C::STAGE;
            if (lane == 0) {
              hopper::mbar_expect_tx(&full[stage],
                                     2 * C::TILE + (pos_tma ? POS_BYTES : 0));
              hopper::load_rows<DK>(st, &map_k, kv_ri, &full[stage], k0, x.h,
                                    b);
              hopper::load_rows<DK>(st + C::TILE, &map_v, kv_ri, &full[stage],
                                    k0, x.h, b);
              if (pos_tma)
                load_pos(st + 2 * C::TILE, &map_pos, &full[stage], x.q0, k0,
                         x.h);
            }
            if (!pos_tma) {
              fill_pos(st + 2 * C::TILE, pos, x.h, x.q0, k0, Lq, Lk, lane);
              hopper::mbar_arrive(&full[stage]);
            }
            if (++stage == STAGES) { stage = 0; phase ^= 1; }
          }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int stage = 0;
  uint32_t phase = 0, qphase = 0;
  float sacc[32], dpa[32], acc[DK / 2];  // acc: o (K4's first sweep), dq
  uint32_t fa[T][4][4];  // p (K4's o sweep) or ds as A fragments
  float pb[32], mk[16];
  const bool even_lk = (Lk & 1) == 0;  // 8-byte stores into the slab
  // this thread's band elements: rows 16 warp + g + 8 hh, columns
  // k0 - kb + 8j + 2t (+1), 8-byte aligned (band_ld is even); an offset,
  // not a pointer kept in registers, so that the accesses stay shared loads
  const int bofs = (16 * warp + g) * band_ld + 2 * t;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const ItemA x = item_a<CHUNKED>(it, nqt, chunks, chunk_keys, groups, Lk);
    int row[2];
    bool rok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row[hh] = x.q0 + 16 * warp + g + 8 * hh;
      rok[hh] = row[hh] < Lq;
    }
    float* part_h =
        part + (static_cast<long long>(x.grp) * H + x.h) * Lq * Lk;
    OutT<MODE>* dq_c =
        x.chunk == 0 ? dq : dq_part + (x.chunk - 1) * part_stride;
    const int b_begin = x.grp * rows_per_group;
    const int b_end = min(B, b_begin + rows_per_group);
    for (int b = b_begin; b < b_end; ++b) {
      const bool first = b == b_begin, last = b == b_end - 1;
      const float* mrow = key_mask + static_cast<long long>(b) * Lk;
      long long st[2];
      float m_i[2], rl_i[2], d_i[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // rows past Lq read row Lq - 1's statistics (finite); p = 0 there
        st[hh] = (static_cast<long long>(b) * H + x.h) * Lq +
                 min(row[hh], Lq - 1);
        m_i[hh] = __ldg(m_in + st[hh]);
        rl_i[hh] = rcp(__ldg(l_in + st[hh]));
        if (!K4) d_i[hh] = __ldg(delta + st[hh]);
      }
      hopper::mbar_wait(qfull, qphase);
      qphase ^= 1;

      if constexpr (K4) {
        // o = bf16(p) . V over the key tiles, then delta = sum g * o
        zero(acc);
        int prev = -1;
        for (int k0 = 0; k0 < Lk; k0 += BKV) {
          hopper::mbar_wait(&full[stage], phase);
          const unsigned char* sK = ring + stage * C::STAGE;
          const unsigned char* sV = sK + C::TILE;
          zero(sacc);
          hopper::fence_regs(sacc);
          hopper::wgmma_fence();
          product_ss<DK>(sacc, sQ, sK);
          hopper::wgmma_commit();
          load_mask(mrow, k0, Lk, t, mk);
          pos_values(sV + C::TILE, warp, g, t, pb);
          hopper::wgmma_wait<0>();  // this S and the last tile's P . V
          hopper::fence_regs(sacc);
          hopper::fence_regs(acc);
          keep_frags<T>(fa);
          __syncwarp();
          if (lane == 0 && prev >= 0) hopper::mbar_arrive(&empty[prev]);
          prev = stage;
          probs(sacc, pb, mk, m_i, rl_i, rok, Lk - k0, t);
          to_frags<T>(sacc, fa);
          hopper::fence_regs(acc);
          hopper::wgmma_fence();
          product_rs<DK>(acc, fa[0], sV);
          hopper::wgmma_commit();
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        keep_frags<T>(fa);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
        // o in bf16; delta from the fp32 o and g (G's tile: row r, column
        // 8j + 2t in box j / 8, chunk (j % 8) ^ (r % 8), r % 8 = g)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + g + 8 * hh;
          float d = 0.0f;
#pragma unroll
          for (int j = 0; j < DK / 8; ++j) {
            const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(
                sG + (j / 8) * 8192 + r * 128 + (((j % 8) ^ g) << 4) + 4 * t);
            d = fmaf(__low2float(gv), acc[4 * j + 2 * hh], d);
            d = fmaf(__high2float(gv), acc[4 * j + 2 * hh + 1], d);
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          d_i[hh] = d;
          if (t == 0 && rok[hh]) delta[st[hh]] = d;
        }
        store_rows<DK>(acc, out + b * o_sb + x.h * o_sh, o_sl, row, Lq, t);
      }

      // ds = p (dp - delta), dpos band += ds, dQ += ds . K
      zero(acc);
      int prev = -1;
      for (int k0 = x.kb; k0 < x.ke; k0 += BKV) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* sK = ring + stage * C::STAGE;
        const unsigned char* sV = sK + C::TILE;
        zero(sacc);
        zero(dpa);
        hopper::fence_regs(sacc);
        hopper::fence_regs(dpa);
        hopper::wgmma_fence();
        product_ss<DK>(sacc, sQ, sK);
#pragma unroll
        for (int j = T - 1; j >= 0; --j)  // g's smallest plane first
          product_ss<DK>(dpa, sG + j * C::TILE, sV);
        hopper::wgmma_commit();
        load_mask(mrow, k0, Lk, t, mk);
        pos_values(sV + C::TILE, warp, g, t, pb);
        hopper::wgmma_wait<0>();  // these and the last tile's dQ
        hopper::fence_regs(sacc);
        hopper::fence_regs(dpa);
        hopper::fence_regs(acc);
        keep_frags<T>(fa);
        __syncwarp();
        if (lane == 0) {
          if (prev >= 0) hopper::mbar_arrive(&empty[prev]);
          if (k0 + BKV >= x.ke) hopper::mbar_arrive(qempty);  // Q, G are free
        }
        prev = stage;
        probs(sacc, pb, mk, m_i, rl_i, rok, Lk - k0, t);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dpa[i] = sacc[i] * (dpa[i] - d_i[(i >> 1) & 1]);

        to_frags<T>(dpa, fa);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int i = T - 1; i >= 0; --i) product_rs<DK>(acc, fa[i], sK);
        hopper::wgmma_commit();

        // the band, under the dQ product, in batch order: the group's
        // first row writes, the others add; its last row leaves the sums
        // in the partial slab (rows past Lq and keys past Lk stay out)
        const int bk = k0 - x.kb;
        if (band_ld > 0 && !last) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float2* sp = reinterpret_cast<float2*>(
                  band + bofs + 8 * hh * band_ld + bk + 8 * j);
              float2 v = make_float2(dpa[4 * j + 2 * hh],
                                     dpa[4 * j + 2 * hh + 1]);
              if (!first) {
                const float2 o = *sp;
                v.x = o.x + v.x;  // earlier rows first, as the plain sum
                v.y = o.y + v.y;
              }
              *sp = v;
            }
        } else {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (!rok[hh]) continue;
            float* grow = part_h + static_cast<long long>(row[hh]) * Lk;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int kc = k0 + 8 * j + 2 * t;
              if (kc >= Lk) continue;
              float2 v = make_float2(dpa[4 * j + 2 * hh],
                                     dpa[4 * j + 2 * hh + 1]);
              if (band_ld > 0) {
                if (!first) {
                  const float2 o = *reinterpret_cast<const float2*>(
                      band + bofs + 8 * hh * band_ld + bk + 8 * j);
                  v.x = o.x + v.x;
                  v.y = o.y + v.y;
                }
              } else if (!first) {  // the band lives in the slab
                v.x = grow[kc] + v.x;
                if (kc + 1 < Lk) v.y = grow[kc + 1] + v.y;
              }
              if (even_lk) {  // kc is even: both columns lie inside
                *reinterpret_cast<float2*>(grow + kc) = v;
              } else {
                grow[kc] = v.x;
                if (kc + 1 < Lk) grow[kc + 1] = v.y;
              }
            }
          }
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      keep_frags<T>(fa);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      store_rows<DK>(acc, dq_c + b * dq_sb + x.h * dq_sh, dq_sl, row, Lq, t);
    }
  }
}

// ---------------------------------------------------------------------------
// g's bf16 planes (the pre-pass)
// ---------------------------------------------------------------------------

// g (fp32, (batch, head, row) strides that are multiples of 4) as T bf16
// planes, each a contiguous (B, H, Lq, dk) buffer, `plane` elements apart:
// plane 0 is g rounded to bf16 (K2b's one), each further plane the
// rounding of what the earlier ones leave (K2a's three). 8 values a thread.
template <int T>
__global__ void split_g_kernel(const float* __restrict__ g, long long sb,
                               long long sh, long long sl,
                               bf16* __restrict__ out, int H, int Lq, int dk,
                               long long n8, long long plane) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = i * 8;
    const int d = static_cast<int>(e % dk);
    const long long rows = e / dk;
    const int r = static_cast<int>(rows % Lq);
    const int h = static_cast<int>((rows / Lq) % H);
    const long long b = rows / Lq / H;
    const float4* src =
        reinterpret_cast<const float4*>(g + b * sb + h * sh + r * sl + d);
    const float4 x = src[0], y = src[1];
    float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int term = 0; term < T; ++term) {
      uint32_t w[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        w[p] = bf16_pair(v[2 * p], v[2 * p + 1]);
        v[2 * p] -= __uint_as_float(w[p] << 16);
        v[2 * p + 1] -= __uint_as_float(w[p] & 0xffff0000u);
      }
      *reinterpret_cast<uint4*>(out + term * plane + e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// g's T planes into `out` (n = B * H * Lq * dk elements a plane)
template <int T>
int launch_split_g(const float* g, long long sb, long long sh, long long sl,
                   bf16* out, int H, int Lq, int dk, long long n,
                   cudaStream_t stream) {
  const long long want = (n / 8 + 255) / 256;
  split_g_kernel<T><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                      stream>>>(g, sb, sh, sl, out, H, Lq, dk, n / 8, n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Slab sums, host side
// ---------------------------------------------------------------------------

// dst = first + rest[0] + rest[1] + ... (count slabs of n), in that order:
// the dpos group partials, and K2a's dq chunk partials (dst = first)
__global__ void sum_slabs_kernel(const float* first,
                                 const float* __restrict__ rest, float* dst,
                                 long long n, int count) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = first[i];
    for (int c = 0; c < count; ++c) acc += rest[c * n + i];
    dst[i] = acc;
  }
}

int launch_sum_slabs(const float* first, const float* rest, float* dst,
                     long long n, int count, cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_slabs_kernel<<<blocks, 256, 0, stream>>>(first, rest, dst, n, count);
  return static_cast<int>(cudaGetLastError());
}

// The most dynamic shared memory a block may have on this card.
int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = 232448;  // an H100's
  }
  return bytes;
}

// A persistent grid for `kernel` with `bytes` of dynamic shared memory: as
// many CTAs as the card holds at once, at most `items`. The kernel's
// shared-memory opt-in and its CTAs an SM are asked once per (kernel,
// bytes) and kept: the answers do not change on one card.
int persistent_grid(const void* kernel, int bytes, long long items,
                    int device, int* grid) {
  struct Seen {
    const void* fn;
    int bytes, fit;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int fit = 0;
  bool opted = false;
  for (int i = 0; i < n_seen && !fit; ++i) {
    opted |= seen[i].fn == kernel;
    if (seen[i].fn == kernel && seen[i].bytes == bytes) fit = seen[i].fit;
  }
  if (!fit) {
    cudaError_t err = cudaSuccess;
    if (!opted)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                          THREADS, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (n_seen < 64) seen[n_seen++] = {kernel, bytes, fit};
  }
  const long long cap = static_cast<long long>(fit) * hopper::sm_count(device);
  *grid = static_cast<int>(items < cap ? items : cap);
  return 0;
}

// The dq pass's dpos band: its row stride (0: in the slab), the keys of a
// chunk, the chunks, and the pass's dynamic shared memory. The keys are one
// chunk where the band fits; K2a cuts them into the fewest chunks whose
// band does (rows 8 floats past a multiple of 64 apart: rows 8 apart fall
// on other banks), K4 and K2b keep one and move the band to the slab.
struct BandPlan {
  int band_ld, chunk_keys, chunks, smem;
};

template <int DK, int MODE>
BandPlan band_plan(int Lk) {
  const int base = CfgA<DK, terms<MODE>()>::SMEM;
  const int avail = smem_optin() - base;
  const int nkt = cdiv(Lk, BKV);
  int tiles = nkt;
  if (64 * (tiles * BKV + 8) * 4 > avail) {
    if (MODE != kK2a) return {0, nkt * BKV, 1, base};
    const int fit = (avail / 256 - 8) / BKV;  // >= 3 tiles at dk 128
    tiles = cdiv(nkt, cdiv(nkt, fit > 0 ? fit : 1));
  }
  const int ld = tiles * BKV + 8;
  return {ld, tiles * BKV, cdiv(nkt, tiles), base + 64 * ld * 4};
}

// Outputs of one call: dq (OT, strides), dk / dv (OT, shared strides); K4
// also o (bf16, strides) and delta; K2b's and K2a's delta is dcap.
template <typename OT>
struct Outs {
  OT *dq, *dk, *dv;
  long long dq_sb, dq_sh, dq_sl, dkv_sb, dkv_sh, dkv_sl;
  bf16* out;
  long long o_sb, o_sh, o_sl;
  float* delta;
};

// The dq pass, the dk/dv pass, then (K2a with several key chunks) the dq
// chunk sum and (with several groups) the dpos sum. g16: g's terms<MODE>()
// bf16 planes, each (B, H, Lq, dk) with (batch, head, row) strides, plane
// j at batch B * j; dq_part: K2a's chunk partials (dq's layout, contiguous).
template <int DK, int MODE>
int launch_passes(const T5BwdArgs& a, const void* g16, long long g_sb,
                  long long g_sh, long long g_sl, const Outs<OutT<MODE>>& o,
                  OutT<MODE>* dq_part, float* dpos_part, float* dpos,
                  int device, cudaStream_t stream) {
  constexpr int T = terms<MODE>();
  CUtensorMap map_q, map_k, map_v, map_g, map_pos;
  int q_ri = 1, kv_ri = 1, g_ri = 1;
  int rc = hopper::qkv_map(&map_q, a.q, DK, a.Lq, a.H, a.B, a.q_sb, a.q_sh,
                           a.q_sl, &q_ri);
  if (!rc)
    rc = hopper::qkv_map(&map_k, a.k, DK, a.Lk, a.H, a.B, a.kv_sb, a.kv_sh,
                         a.kv_sl, &kv_ri);
  if (!rc)
    rc = hopper::qkv_map(&map_v, a.v, DK, a.Lk, a.H, a.B, a.kv_sb, a.kv_sh,
                         a.kv_sl, &kv_ri);
  if (!rc)
    rc = hopper::qkv_map(&map_g, g16, DK, a.Lq, a.H, T * a.B, g_sb, g_sh,
                         g_sl, &g_ri);
  if (rc) return rc;
  rc = hopper::pos_map(&map_pos, a.pos, a.H, a.Lq, a.Lk);
  if (rc > 0) return rc;
  const int pos_tma = rc == 0;
  if (!pos_tma) map_pos = map_q;  // unused
  const float* pos = static_cast<const float*>(a.pos);
  const float* mask = static_cast<const float*>(a.key_mask);
  const float* m = static_cast<const float*>(a.m);
  const float* l = static_cast<const float*>(a.l);

  // the kernels count work items in 32 bits
  const BandPlan plan = band_plan<DK, MODE>(a.Lk);
  const int groups = cdiv(a.B, a.rows_per_group);
  const long long items_a = static_cast<long long>(cdiv(a.Lq, BQ)) *
                            plan.chunks * groups * a.H;
  const long long items_b = static_cast<long long>(cdiv(a.Lk, BKV)) *
                            (DK / CfgB<DK, T>::DN) * a.B * a.H;
  if (items_a > INT32_MAX || items_b > INT32_MAX || plan.smem > smem_optin() ||
      (T > 1 && a.B > INT32_MAX / T))
    return static_cast<int>(cudaErrorInvalidValue);

  float* part = groups == 1 ? dpos : dpos_part;
  const long long nq = static_cast<long long>(a.B) * a.H * a.Lq * DK;
  auto ka = dq_kernel<DK, MODE>;
  int grid = 0;
  rc = persistent_grid(reinterpret_cast<const void*>(ka), plan.smem, items_a,
                       device, &grid);
  if (rc) return rc;
  ka<<<grid, THREADS, plan.smem, stream>>>(
      map_q, map_k, map_v, map_g, map_pos, q_ri, kv_ri, g_ri, pos_tma, pos,
      mask, m, l, o.delta, o.dq, o.dq_sb, o.dq_sh, o.dq_sl, dq_part, nq,
      o.out, o.o_sb, o.o_sh, o.o_sl, part, plan.band_ld, plan.chunk_keys,
      a.B, a.H, a.Lq, a.Lk, a.rows_per_group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // dk/dv pass (reads K4's delta from the dq pass)
  auto kb = dkdv_kernel<DK, MODE>;
  constexpr int bytes_b = CfgB<DK, T>::SMEM;
  rc = persistent_grid(reinterpret_cast<const void*>(kb), bytes_b, items_b,
                       device, &grid);
  if (rc) return rc;
  kb<<<grid, THREADS, bytes_b, stream>>>(
      map_q, map_k, map_v, map_g, map_pos, q_ri, kv_ri, g_ri, pos_tma, pos,
      mask, m, l, o.delta, o.dk, o.dv, o.dkv_sb, o.dkv_sh, o.dkv_sl, a.B, a.H,
      a.Lq, a.Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (MODE == kK2a) {
    if (plan.chunks > 1) {
      rc = launch_sum_slabs(o.dq, dq_part, o.dq, nq, plan.chunks - 1, stream);
      if (rc) return rc;
    }
  }
  if (groups == 1) return 0;
  const long long n = static_cast<long long>(a.H) * a.Lq * a.Lk;
  return launch_sum_slabs(dpos_part, dpos_part + n, dpos, n, groups - 1,
                          stream);
}

int check_args(int device, int B, int H, int Lq, int Lk, int rows_per_group) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535 ||
      rows_per_group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
