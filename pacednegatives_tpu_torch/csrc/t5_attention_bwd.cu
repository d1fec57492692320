// T5 attention core, backward, for Hopper (sm_90a).
//
// Per (batch b, head h), with s = q . k^T + pos[h] + key_mask[b] and the
// forward's softmax statistics (m, l):
//   p     = exp(s - m) / l                 (normalised BEFORE rounding)
//   o     = bf16(p) . v                    (the recomputed attention output)
//   delta = sum_c g . o                    (fp32, from the fp32 o)
//   dv    = bf16(p)^T . g
//   ds    = p * (g . v^T - delta)
//   dq    = bf16(ds) . k,  dk = bf16(ds)^T . q
//   dpos[h] = sum_b ds                     (fp32, deterministic)
// Products take bf16 operands and accumulate in fp32; dq/dk/dv and o are
// stored in bf16. This is the arithmetic of _v3_bwd_kernel, the per-head
// core of v3_backward (pacednegatives_tpu/ops/flash_v3.py:196-271), which
// this file replaces together with ops/gemm.py (the qkv recompute).
//
// What bounds it: at the training shape (B = 128, H = 12, L = 188, dk = 64)
// the nine L x L x dk products below are ~63 GFLOP per call and the
// exp / divide work runs on 3 * B*H*L*L scores; scores never leave the SM.
// The TPU kernel holds one batch row's whole qkv and every head in VMEM and
// carries dpos across its sequential batch grid. Hopper blocks run in
// parallel and in no order, so the work is split three ways, none of which
// uses atomics:
//
//   A. dq pass, one block per (64-query tile, head, group of batch rows):
//      for each row b of its group it sweeps the key tiles twice, first to
//      recompute o and delta (written out: kernel B reads delta), then for
//      ds and dq. It owns the (64 x Lk) band of its group's dpos partial
//      and adds ds into it in a fixed order (the band stays hot in L2).
//   B. dk/dv pass, one block per (64-key tile, head, b): sweeps the query
//      tiles, with each warp owning 16 keys, and computes S^T and dP^T
//      directly so dk and dv accumulate in registers without crossing
//      warps.
//   C. dpos[h, i, j] = sum over groups of the partials, in group order.
//
// So dpos is bitwise reproducible run to run, and dq (over key tiles) and
// dk/dv (over query tiles) are each summed inside one block.
//
// Ragged lengths: rows past Lq and keys past Lk are zero-filled and get
// p = 0, so they contribute nothing and nothing is stored for them (the TPU
// wrapper pads L to 16 and masks instead). q/k/v/g/dq/dk/dv/o are addressed
// through (batch, head, row) strides with a contiguous head dimension, so
// the fused block reads q/k/v as views of its (B, L, 3*H*dk) qkv buffer and
// writes dq/dk/dv straight into the (B, L, 3*H*dk) dqkv layout.
// Layout inside a warp follows t5_attention_fwd.cu: lanes 2r and 2r+1 own
// row r of the warp's 16 and take its interleaved columns; WMMA bf16
// 16x16x16 fragments for the products. Not yet done (later work):
// mma.sync/wgmma register tiles, cp.async/TMA prefetch, one sweep instead
// of three recomputations of s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;   // query rows per tile (16 per warp)
constexpr int BKV = 64;  // keys per tile (16 per warp in kernel B)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LDPOS = BKV + 1;  // fp32 pos tile rows in kernel B

template <int DK>
struct Smem {
  static constexpr int LDQ = DK + 8;     // bf16 rows of q/k/v/g tiles
  static constexpr int LDP = BKV + 8;    // bf16 64-wide probability rows
  static constexpr int LDS = (DK > BKV ? DK : BKV) + 4;  // fp32 scratch
  static constexpr int TILE = 64 * LDQ;  // elements
  static constexpr int P_ELEMS = 64 * LDP;
  static constexpr int S_ELEMS = 64 * LDS;
  // A: Q, G, K, V tiles, P (or dS), fp32 scratch
  static constexpr int BYTES_A = (4 * TILE + P_ELEMS) * 2 + S_ELEMS * 4;
  // B: K, V, Q, G tiles, P^T, dS^T, fp32 scratch, pos tile, m / l / delta
  static constexpr int BYTES_B = (4 * TILE + 2 * P_ELEMS) * 2 +
                                 (S_ELEMS + BQ * LDPOS + 3 * BQ) * 4;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;

// Copy `rows_valid` rows of a 64 x DK bf16 tile (row stride `ld` elements)
// into shared memory, 16 bytes a thread; rows past rows_valid become zero.
template <int DK>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int rows_valid) {
  constexpr int CPR = DK / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + r * ld + col);
    *reinterpret_cast<uint4*>(dst + r * Smem<DK>::LDQ + col) = val;
  }
}

// out (16 x 64, fp32, this warp's rows of the scratch) = A_w . B^T, where
// A_w is the warp's 16 rows of a 64 x DK tile and B a 64 x DK tile, both
// row-major in shared memory (B row-major is B^T column-major).
template <int DK>
__device__ __forceinline__ void product_nt(const bf16* a_w, const bf16* b,
                                           float* out_w) {
  constexpr int LDQ = Smem<DK>::LDQ;
  Acc acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DK; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, a_w + kk, LDQ);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBT bt;
      wmma::load_matrix_sync(bt, b + n * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc[n], a, bt, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out_w + n * 16, acc[n], Smem<DK>::LDS,
                            wmma::mem_row_major);
}

// acc[n] (16 x DK) += P_w . B, P_w the warp's 16 rows of a 64-wide bf16
// tile (row stride LDP), B a 64 x DK row-major bf16 tile.
template <int DK>
__device__ __forceinline__ void product_nn(const bf16* p_w, const bf16* b,
                                           Acc* acc) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, p_w + kk, Smem<DK>::LDP);
#pragma unroll
    for (int n = 0; n < DK / 16; ++n) {
      FragB bb;
      wmma::load_matrix_sync(bb, b + kk * Smem<DK>::LDQ + n * 16,
                             Smem<DK>::LDQ);
      wmma::mma_sync(acc[n], a, bb, acc[n]);
    }
  }
}

// Store the warp's 16 x DK accumulator as bf16 rows `row0 + rr` of a
// strided (row stride ld) destination, skipping rows at or past `rows`.
// Staged through the warp's rows of the fp32 scratch.
template <int DK>
__device__ __forceinline__ void store_rows(const Acc* acc, float* scratch_w,
                                           bf16* dst, long long ld, int row0,
                                           int rows) {
  const int lane = threadIdx.x % 32;
  __syncwarp();  // every lane is done reading the scratch
#pragma unroll
  for (int n = 0; n < DK / 16; ++n)
    wmma::store_matrix_sync(scratch_w + n * 16, acc[n], Smem<DK>::LDS,
                            wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 16 * (DK / 2); idx += 32) {
    const int rr = idx / (DK / 2), c = (idx % (DK / 2)) * 2;
    if (row0 + rr >= rows) continue;
    const float* s = scratch_w + rr * Smem<DK>::LDS + c;
    *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + rr) * ld + c) =
        __floats2bfloat162_rn(s[0], s[1]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// A: o, delta, dq and the dpos partials
// ---------------------------------------------------------------------------

template <int DK>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long q_sb, long long q_sh,
    long long q_sl, long long kv_sb, long long kv_sh, long long kv_sl,
    const bf16* __restrict__ g, long long g_sb, long long g_sh,
    long long g_sl, const float* __restrict__ pos,
    const float* __restrict__ key_mask, const float* __restrict__ m_in,
    const float* __restrict__ l_in, bf16* __restrict__ dq, long long dq_sb,
    long long dq_sh, long long dq_sl, bf16* __restrict__ out, long long o_sb,
    long long o_sh, long long o_sl, float* __restrict__ delta_out,
    float* __restrict__ dpos_part, int B, int H, int Lq, int Lk,
    int rows_per_group) {
  using S = Smem<DK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + S::TILE;
  bf16* sK = sG + S::TILE;
  bf16* sV = sK + S::TILE;
  bf16* sP = sV + S::TILE;
  float* sS = reinterpret_cast<float*>(sP + S::P_ELEMS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, grp = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Lq - q0);
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qi = q0 + row;
  const bool row_ok = qi < Lq;
  // rows past Lq read row 0's bias: finite, and p = 0 for them anyway
  const float* pos_row = pos + ((long long)h * Lq + (row_ok ? qi : 0)) * Lk;
  float* s_row = sS + row * S::LDS;
  float* s_w = sS + warp * 16 * S::LDS;
  bf16* p_row = sP + row * S::LDP;
  const bf16* sQ_w = sQ + warp * 16 * S::LDQ;
  const bf16* sG_w = sG + warp * 16 * S::LDQ;
  const bf16* sP_w = sP + warp * 16 * S::LDP;
  float* part = dpos_part + ((long long)grp * H + h) * Lq * Lk;

  const int b_begin = grp * rows_per_group;
  const int b_end = min(B, b_begin + rows_per_group);
  for (int b = b_begin; b < b_end; ++b) {
    const bool first = b == b_begin;
    __syncthreads();  // every warp is done with the previous row's tiles
    load_tile<DK>(sQ, q + b * q_sb + h * q_sh + q0 * q_sl, q_sl, q_valid);
    load_tile<DK>(sG, g + b * g_sb + h * g_sh + q0 * g_sl, g_sl, q_valid);
    const float* mask_row = key_mask + (long long)b * Lk;
    const long long st = ((long long)b * H + h) * Lq + (row_ok ? qi : 0);
    const float m_i = m_in[st];
    const float l_i = l_in[st];
    const bf16* kb = k + b * kv_sb + h * kv_sh;
    const bf16* vb = v + b * kv_sb + h * kv_sh;

    // Pass 1: o = bf16(p) . v with p already normalised, in fragments
    // carried across the key tiles (no rescaling needed).
    Acc acc[DK / 16];
#pragma unroll
    for (int n = 0; n < DK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int k0 = 0; k0 < Lk; k0 += BKV) {
      const int kv_valid = min(BKV, Lk - k0);
      __syncthreads();  // every warp is done with the previous sK / sV
      load_tile<DK>(sK, kb + k0 * kv_sl, kv_sl, kv_valid);
      load_tile<DK>(sV, vb + k0 * kv_sl, kv_sl, kv_valid);
      __syncthreads();
      product_nt<DK>(sQ_w, sK, s_w);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) {
        const int c = half + 2 * j;
        float p = 0.0f;
        if (row_ok && c < kv_valid) {
          // s = q.k + pos + mask, in that order (flash_v3.py:225)
          const float s = s_row[c] + pos_row[k0 + c] + mask_row[k0 + c];
          p = expf(s - m_i) / l_i;
        }
        p_row[c] = __float2bfloat16(p);
      }
      __syncwarp();
      product_nn<DK>(sP_w, sV, acc);
    }
    // delta = sum g * o from the fp32 o; o itself is stored in bf16.
#pragma unroll
    for (int n = 0; n < DK / 16; ++n)
      wmma::store_matrix_sync(s_w + n * 16, acc[n], S::LDS,
                              wmma::mem_row_major);
    __syncwarp();
    float d = 0.0f;
#pragma unroll
    for (int j = 0; j < DK / 2; ++j) {
      const int c = half + 2 * j;
      d += __bfloat162float(sG[row * S::LDQ + c]) * s_row[c];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0 && row_ok) delta_out[st] = d;
    for (int idx = lane; idx < 16 * (DK / 2); idx += 32) {
      const int rr = idx / (DK / 2), c = (idx % (DK / 2)) * 2;
      const int qrow = q0 + warp * 16 + rr;
      if (qrow >= Lq) continue;
      const float* s = s_w + rr * S::LDS + c;
      *reinterpret_cast<__nv_bfloat162*>(out + b * o_sb + h * o_sh +
                                         qrow * o_sl + c) =
          __floats2bfloat162_rn(s[0], s[1]);
    }
    __syncwarp();

    // Pass 2: dp = g . v^T, ds = p (dp - delta), dq += bf16(ds) . k, and
    // ds into this group's dpos partial.
#pragma unroll
    for (int n = 0; n < DK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int k0 = 0; k0 < Lk; k0 += BKV) {
      const int kv_valid = min(BKV, Lk - k0);
      __syncthreads();
      load_tile<DK>(sK, kb + k0 * kv_sl, kv_sl, kv_valid);
      load_tile<DK>(sV, vb + k0 * kv_sl, kv_sl, kv_valid);
      __syncthreads();
      product_nt<DK>(sQ_w, sK, s_w);
      __syncwarp();
      float pv[BKV / 2];
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) {
        const int c = half + 2 * j;
        float p = 0.0f;
        if (row_ok && c < kv_valid) {
          const float s = s_row[c] + pos_row[k0 + c] + mask_row[k0 + c];
          p = expf(s - m_i) / l_i;
        }
        pv[j] = p;
      }
      __syncwarp();  // scores read; the scratch now takes dp
      product_nt<DK>(sG_w, sV, s_w);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) {
        const int c = half + 2 * j;
        const float ds = pv[j] * (s_row[c] - d);
        s_row[c] = ds;
        p_row[c] = __float2bfloat16(ds);
      }
      __syncwarp();
      // dpos partial += ds: the warp's 16 rows, two columns a lane, so
      // each row is one 256-byte stretch. The band is this block's alone.
      for (int rr = 0; rr < 16; ++rr) {
        const int qrow = q0 + warp * 16 + rr;
        if (qrow >= Lq) break;
        float* dst = part + (long long)qrow * Lk + k0;
        const float* src = s_w + rr * S::LDS;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * lane + e;
          if (c < kv_valid) dst[c] = first ? src[c] : dst[c] + src[c];
        }
      }
      product_nn<DK>(sP_w, sK, acc);
    }
    store_rows<DK>(acc, s_w, dq + b * dq_sb + h * dq_sh, dq_sl,
                   q0 + warp * 16, Lq);
  }
}

// ---------------------------------------------------------------------------
// B: dk and dv
// ---------------------------------------------------------------------------

template <int DK>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long q_sb, long long q_sh,
    long long q_sl, long long kv_sb, long long kv_sh, long long kv_sl,
    const bf16* __restrict__ g, long long g_sb, long long g_sh,
    long long g_sl, const float* __restrict__ pos,
    const float* __restrict__ key_mask, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ delta_in,
    bf16* __restrict__ dk, bf16* __restrict__ dv, long long dkv_sb,
    long long dkv_sh, long long dkv_sl, int H, int Lq, int Lk) {
  using S = Smem<DK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + S::TILE;
  bf16* sQ = sV + S::TILE;
  bf16* sG = sQ + S::TILE;
  bf16* sPT = sG + S::TILE;     // bf16(p)^T: keys x queries
  bf16* sDT = sPT + S::P_ELEMS;  // bf16(ds)^T
  float* sS = reinterpret_cast<float*>(sDT + S::P_ELEMS);
  float* sPos = sS + S::S_ELEMS;  // pos tile, queries x keys
  float* sM = sPos + BQ * LDPOS;
  float* sL = sM + BQ;
  float* sD = sL + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;
  const int kv_valid = min(BKV, Lk - k0);
  const int r = lane >> 1, half = lane & 1;
  const int krow = warp * 16 + r;  // this lane pair's key within the tile
  const bool key_ok = krow < kv_valid;
  const float mask_j = key_ok ? key_mask[(long long)b * Lk + k0 + krow] : 0.f;
  float* s_row = sS + krow * S::LDS;
  float* s_w = sS + warp * 16 * S::LDS;
  bf16* pt_row = sPT + krow * S::LDP;
  bf16* dt_row = sDT + krow * S::LDP;
  const long long st0 = ((long long)b * H + h) * Lq;

  load_tile<DK>(sK, k + b * kv_sb + h * kv_sh + k0 * kv_sl, kv_sl, kv_valid);
  load_tile<DK>(sV, v + b * kv_sb + h * kv_sh + k0 * kv_sl, kv_sl, kv_valid);

  Acc dv_acc[DK / 16], dk_acc[DK / 16];
#pragma unroll
  for (int n = 0; n < DK / 16; ++n) {
    wmma::fill_fragment(dv_acc[n], 0.0f);
    wmma::fill_fragment(dk_acc[n], 0.0f);
  }
  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int q_valid = min(BQ, Lq - q0);
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<DK>(sQ, q + b * q_sb + h * q_sh + q0 * q_sl, q_sl, q_valid);
    load_tile<DK>(sG, g + b * g_sb + h * g_sh + q0 * g_sl, g_sl, q_valid);
    for (int idx = threadIdx.x; idx < BQ * BKV; idx += THREADS) {
      const int i = idx / BKV, j = idx % BKV;
      float val = 0.0f;
      if (i < q_valid && j < kv_valid)
        val = pos[((long long)h * Lq + q0 + i) * Lk + k0 + j];
      sPos[i * LDPOS + j] = val;
    }
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x;
      const bool ok = i < q_valid;
      sM[i] = ok ? m_in[st0 + q0 + i] : 0.0f;
      sL[i] = ok ? l_in[st0 + q0 + i] : 1.0f;
      sD[i] = ok ? delta_in[st0 + q0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T (this warp's 16 keys x 64 queries) = K_w . Q^T
    product_nt<DK>(sK + warp * 16 * S::LDQ, sQ, s_w);
    __syncwarp();
    float pv[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int c = half + 2 * j;  // query within the tile
      float p = 0.0f;
      if (key_ok && c < q_valid) {
        const float s = s_row[c] + sPos[c * LDPOS + krow] + mask_j;
        p = expf(s - sM[c]) / sL[c];
      }
      pv[j] = p;
      pt_row[c] = __float2bfloat16(p);
    }
    __syncwarp();
    // dP^T (16 keys x 64 queries) = V_w . G^T
    product_nt<DK>(sV + warp * 16 * S::LDQ, sG, s_w);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int c = half + 2 * j;
      dt_row[c] = __float2bfloat16(pv[j] * (s_row[c] - sD[c]));
    }
    __syncwarp();
    product_nn<DK>(sPT + warp * 16 * S::LDP, sG, dv_acc);
    product_nn<DK>(sDT + warp * 16 * S::LDP, sQ, dk_acc);
  }
  const long long base = b * dkv_sb + h * dkv_sh + (long long)k0 * dkv_sl;
  store_rows<DK>(dv_acc, s_w, dv + base, dkv_sl, warp * 16, kv_valid);
  store_rows<DK>(dk_acc, s_w, dk + base, dkv_sl, warp * 16, kv_valid);
}

// ---------------------------------------------------------------------------
// C: dpos = sum of the group partials, in group order
// ---------------------------------------------------------------------------

__global__ void dpos_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ dpos, long long n,
                                   int groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int gi = 1; gi < groups; ++gi) acc += part[gi * n + i];
    dpos[i] = acc;
  }
}

template <int DK>
int launch(const void* q, const void* k, const void* v, long long q_sb,
           long long q_sh, long long q_sl, long long kv_sb, long long kv_sh,
           long long kv_sl, const void* g, long long g_sb, long long g_sh,
           long long g_sl, const void* pos, const void* key_mask,
           const void* m, const void* l, void* dq, long long dq_sb,
           long long dq_sh, long long dq_sl, void* dk, void* dv,
           long long dkv_sb, long long dkv_sh, long long dkv_sl, void* out,
           long long o_sb, long long o_sh, long long o_sl, void* delta,
           void* dpos_part, void* dpos, int B, int H, int Lq, int Lk,
           int rows_per_group, cudaStream_t stream) {
  const int groups = (B + rows_per_group - 1) / rows_per_group;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto ka = bwd_dq_kernel<DK>;
  auto kb = bwd_dkdv_kernel<DK>;
  constexpr int bytes_a = Smem<DK>::BYTES_A;  // above 48 KB: opt in
  constexpr int bytes_b = Smem<DK>::BYTES_B;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes_b);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(g);
  const float* pos_ = static_cast<const float*>(pos);
  const float* mask_ = static_cast<const float*>(key_mask);
  const float* m_ = static_cast<const float*>(m);
  const float* l_ = static_cast<const float*>(l);
  float* delta_ = static_cast<float*>(delta);

  dim3 grid_a((Lq + BQ - 1) / BQ, H, groups);
  ka<<<grid_a, THREADS, bytes_a, stream>>>(
      q_, k_, v_, q_sb, q_sh, q_sl, kv_sb, kv_sh, kv_sl, g_, g_sb, g_sh, g_sl,
      pos_, mask_, m_, l_, static_cast<bf16*>(dq), dq_sb, dq_sh, dq_sl,
      static_cast<bf16*>(out), o_sb, o_sh, o_sl, delta_,
      static_cast<float*>(dpos_part), B, H, Lq, Lk, rows_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  dim3 grid_b((Lk + BKV - 1) / BKV, H, B);
  kb<<<grid_b, THREADS, bytes_b, stream>>>(
      q_, k_, v_, q_sb, q_sh, q_sl, kv_sb, kv_sh, kv_sl, g_, g_sb, g_sh, g_sl,
      pos_, mask_, m_, l_, delta_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dkv_sb, dkv_sh, dkv_sl, H, Lq, Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = (long long)H * Lq * Lk;
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dpos_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dpos_part), static_cast<float*>(dpos), n,
      groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements; the head
// dimension is contiguous everywhere. q (B, H, Lq, dk); k, v (B, H, Lk, dk)
// sharing strides; g (B, H, Lq, dk); pos (H, Lq, Lk) and key_mask (B, Lk)
// fp32 contiguous; m, l (B, H, Lq) fp32. Outputs: dq, dk/dv (sharing
// strides) and out in bf16; delta (B, H, Lq) fp32; dpos (H, Lq, Lk) fp32.
// dpos_part is fp32 scratch of ceil(B / rows_per_group) * H * Lq * Lk.
// Launches three kernels on `stream` and returns cudaGetLastError() after
// them (0 = success); allocates nothing.
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535 ||
      rows_per_group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PNT_ARGS                                                            \
  q, k, v, q_sb, q_sh, q_sl, kv_sb, kv_sh, kv_sl, g, g_sb, g_sh, g_sl, pos, \
      key_mask, m, l, dq, dq_sb, dq_sh, dq_sl, dk, dv, dkv_sb, dkv_sh,      \
      dkv_sl, out, o_sb, o_sh, o_sl, delta, dpos_part, dpos, B, H, Lq, Lk,  \
      rows_per_group, s
  if (dk_dim == 64) return launch<64>(PNT_ARGS);
  if (dk_dim == 128) return launch<128>(PNT_ARGS);
#undef PNT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
