// T5 attention core, backward, with fp32 operands (K2a), for Hopper.
//
// Replaces flash_attention_backward (pacednegatives_tpu/ops/flash.py:316,
// pallas_calls at :353 and :384): every product takes fp32 operands
// (flash.py:215-232, 277-298), so the products are plain fp32 FMA loops
// (SIMT); q/k/v are bf16 in memory and widened exactly. Per (batch b,
// head h), with s = q . k^T + pos[h] + key_mask[b] and the forward's
// softmax statistics (m, l), delta (dcap) and the fp32 cotangent g given:
//   p  = exp(s - m) / l,  dv = p^T . g,  ds = p * (g . v^T - delta)
//   dq = ds . k,  dk = ds^T . q,  dpos[h] = sum_b ds   (deterministic)
// It is reached through pnt_t5_attention_core_bwd (t5_attention_bwd.cu)
// with fp32_operands = 1.
//
// What bounds it: shared-memory loads: each fp32 FMA reads one operand from
// shared memory (a broadcast within a lane pair), far below the tensor
// cores. It is taken only where the TPU's resident-memory gate sends long
// sequences (L >= 768 at t5-base), and is right before fast; its redesign
// (3xTF32 tensor-core products) is later work.
//
// The work is split three ways, none of which uses atomics:
//   A. dq pass, one block per (64-query tile, head, group of batch rows):
//      for each row b of its group, one sweep computes ds and dq; the
//      block owns the (64 x Lk) band of its group's dpos partial and adds
//      ds into it in row order (the band stays hot in L2).
//   B. dk/dv pass, one block per (64-key tile, head, b): sweeps the query
//      tiles with each warp owning 16 keys, and computes S^T and dP^T
//      directly so dk and dv accumulate in the warp's registers.
//   C. dpos[h, i, j] = sum over groups of the partials, in group order
//      (dpos_reduce in t5_attention_bwd.cu).
// Rows past Lq and keys past Lk are zero-filled and get p = 0. Inside a
// warp, lanes 2r and 2r+1 own row r of the warp's 16 and take its
// interleaved columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "t5_attention_bwd.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;   // query rows per tile (16 per warp)
constexpr int BKV = 64;  // keys per tile (16 per warp in kernel B)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LDPOS = BKV + 1;      // fp32 pos tile rows in kernel B
constexpr int HALF_COLS = BKV / 2;  // columns of a 64-wide row per lane

// F32: the products take fp32 operands (K2a; the only instantiation here:
// the bf16 products run in t5_attention_bwd.cu).
template <int DK, bool F32>
struct Cfg {
  typedef typename std::conditional<F32, float, bf16>::type T;
  // Tile rows: fp32 rows padded by 1, so the 16 rows a warp reads at one
  // column fall in 16 different banks (bf16 rows padded by 8).
  static constexpr int LDQ = F32 ? DK + 1 : DK + 8;
  static constexpr int LDP = F32 ? BKV + 1 : BKV + 8;  // 64-wide P rows
  static constexpr int LDS = (DK > BKV ? DK : BKV) + 4;  // fp32 scratch
  static constexpr int TILE = 64 * LDQ;  // elements
  static constexpr int P_ELEMS = 64 * LDP;
  static constexpr int S_ELEMS = 64 * LDS;
  static constexpr int TB = static_cast<int>(sizeof(T));
  // A: Q, G, K, V tiles, P (dS), fp32 scratch
  static constexpr int BYTES_A = (4 * TILE + P_ELEMS) * TB + S_ELEMS * 4;
  // B: K, V, Q, G tiles, P^T, dS^T, fp32 scratch, pos tile, m / l / delta
  static constexpr int BYTES_B = (4 * TILE + 2 * P_ELEMS) * TB +
                                 (S_ELEMS + BQ * LDPOS + 3 * BQ) * 4;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ void store_pair(bf16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}

// `rows_valid` rows of a 64 x DK bf16 tile (row stride `ld` elements) into
// shared memory as T, 16 bytes a thread; rows past rows_valid become zero.
template <int DK, bool F32>
__device__ __forceinline__ void load_tile(typename Cfg<DK, F32>::T* dst,
                                          const bf16* src, long long ld,
                                          int rows_valid) {
  constexpr int CPR = DK / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + r * ld + col);
    if constexpr (F32) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
      float* d = dst + r * Cfg<DK, F32>::LDQ + col;
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = __bfloat162float(e[i]);
    } else {
      *reinterpret_cast<uint4*>(dst + r * Cfg<DK, F32>::LDQ + col) = val;
    }
  }
}

// The same for an fp32 source (g), kept fp32.
template <int DK, bool F32>
__device__ __forceinline__ void load_tile(typename Cfg<DK, F32>::T* dst,
                                          const float* src, long long ld,
                                          int rows_valid) {
  constexpr int CPR = DK / 4;
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid)
      val = *reinterpret_cast<const float4*>(src + r * ld + col);
    typename Cfg<DK, F32>::T* d = dst + r * Cfg<DK, F32>::LDQ + col;
    if constexpr (F32) {
      d[0] = val.x;
      d[1] = val.y;
      d[2] = val.z;
      d[3] = val.w;
    } else {
      store_pair(d, val.x, val.y);
      store_pair(d + 2, val.z, val.w);
    }
  }
}

// out[j] = (A_w . B^T)[r, half + 2j] for the lane's row r = lane / 2: A_w
// the warp's 16 rows of a 64 x DK tile, B a 64 x DK tile, both row-major in
// shared memory: an FMA loop (scratch_w unused).
template <int DK, bool F32>
__device__ __forceinline__ void product_nt(
    const typename Cfg<DK, F32>::T* a_w, const typename Cfg<DK, F32>::T* b,
    float* scratch_w, float (&out)[HALF_COLS]) {
  using C = Cfg<DK, F32>;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;
  static_assert(F32, "the bf16 products run in t5_attention_bwd.cu");
#pragma unroll
  for (int j = 0; j < HALF_COLS; ++j) out[j] = 0.0f;
  const float* a_row = a_w + r * C::LDQ;
  const float* b_col = b + half * C::LDQ;
#pragma unroll 4
  for (int kk = 0; kk < DK; ++kk) {
    const float a = a_row[kk];
#pragma unroll
    for (int j = 0; j < HALF_COLS; ++j)
      out[j] = fmaf(a, b_col[2 * j * C::LDQ + kk], out[j]);
  }
}

// A warp's 16 x DK fp32 accumulator: acc += P_w . B, P_w the warp's 16 rows
// of a 64-wide T tile (row stride LDP), B a 64 x DK row-major T tile.
template <int DK, bool F32>
struct Accum;

template <int DK>
struct Accum<DK, true> {  // per lane: row lane / 2, columns half + 2j
  using C = Cfg<DK, true>;
  float v[DK / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < DK / 2; ++j) v[j] = 0.0f;
  }
  __device__ __forceinline__ void add(const float* p_w, const float* b) {
    const int lane = threadIdx.x % 32;
    const float* p_row = p_w + (lane >> 1) * C::LDP;
    const float* b_col = b + (lane & 1);
#pragma unroll 4
    for (int kk = 0; kk < 64; ++kk) {
      const float p = p_row[kk];
#pragma unroll
      for (int j = 0; j < DK / 2; ++j)
        v[j] = fmaf(p, b_col[kk * C::LDQ + 2 * j], v[j]);
    }
  }
  __device__ __forceinline__ void store(float*, float* dst, long long ld,
                                        int row0, int rows) const {
    const int lane = threadIdx.x % 32;
    const int row = row0 + (lane >> 1);
    if (row >= rows) return;
    float* d = dst + row * ld + (lane & 1);
#pragma unroll
    for (int j = 0; j < DK / 2; ++j) d[2 * j] = v[j];
  }
};

// ---------------------------------------------------------------------------
// A: dq and the dpos partials
// ---------------------------------------------------------------------------

// Shared-memory layout of kernel A: Q, G, K, V tiles, P (dS), fp32 scratch.
template <int DK, bool F32>
struct TilesA {
  using C = Cfg<DK, F32>;
  using T = typename C::T;
  T *q, *g, *k, *v, *p;
  float* s;
  __device__ __forceinline__ explicit TilesA(unsigned char* raw) {
    q = reinterpret_cast<T*>(raw);
    g = q + C::TILE;
    k = g + C::TILE;
    v = k + C::TILE;
    p = v + C::TILE;
    s = reinterpret_cast<float*>(p + C::P_ELEMS);
  }
};

// One batch row of a kernel-A block, with its q and g tiles loaded: sweep
// the key tiles for ds = p (g . v^T - d_i) and dq += ds . k, add ds into
// the block's band of the group's dpos partial (`first`: the group's first
// row, which writes instead of adding), and store dq rows q0.. through
// `dq_b` (row stride dq_sl).
template <int DK, bool F32, typename OT>
__device__ __forceinline__ void dq_sweep(
    const TilesA<DK, F32>& t, const bf16* kb, const bf16* vb, long long kv_sl,
    const float* pos_row, const float* mask_row, float m_i, float l_i,
    float d_i, float* part, bool first, OT* dq_b, long long dq_sl, int q0,
    int Lq, int Lk) {
  using C = Cfg<DK, F32>;
  using T = typename C::T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const bool row_ok = q0 + row < Lq;
  float* s_row = t.s + row * C::LDS;
  float* s_w = t.s + warp * 16 * C::LDS;
  T* p_row = t.p + row * C::LDP;
  const T* sQ_w = t.q + warp * 16 * C::LDQ;
  const T* sG_w = t.g + warp * 16 * C::LDQ;
  const T* sP_w = t.p + warp * 16 * C::LDP;

  Accum<DK, F32> acc;
  acc.zero();
  for (int k0 = 0; k0 < Lk; k0 += BKV) {
    const int kv_valid = min(BKV, Lk - k0);
    __syncthreads();  // every warp is done with the previous sK / sV / sS
    load_tile<DK, F32>(t.k, kb + k0 * kv_sl, kv_sl, kv_valid);
    load_tile<DK, F32>(t.v, vb + k0 * kv_sl, kv_sl, kv_valid);
    __syncthreads();
    float pv[HALF_COLS], dp[HALF_COLS];
    product_nt<DK, F32>(sQ_w, t.k, s_w, pv);
#pragma unroll
    for (int j = 0; j < HALF_COLS; ++j) {
      const int c = half + 2 * j;
      float p = 0.0f;
      if (row_ok && c < kv_valid) {
        // s = q.k + pos + mask, in that order (flash.py:219, :551;
        // flash_v3.py:225)
        const float s = pv[j] + pos_row[k0 + c] + mask_row[k0 + c];
        p = expf(s - m_i) / l_i;
      }
      pv[j] = p;
    }
    product_nt<DK, F32>(sG_w, t.v, s_w, dp);
#pragma unroll
    for (int j = 0; j < HALF_COLS; ++j) {
      const int c = half + 2 * j;
      const float ds = pv[j] * (dp[j] - d_i);
      s_row[c] = ds;
      p_row[c] = from_float<T>(ds);
    }
    __syncwarp();
    // dpos partial += ds: the warp's 16 rows, two columns a lane, so each
    // row is one 256-byte stretch. The band is this block's alone.
    for (int rr = 0; rr < 16; ++rr) {
      const int qrow = q0 + warp * 16 + rr;
      if (qrow >= Lq) break;
      float* dst = part + (long long)qrow * Lk + k0;
      const float* src = s_w + rr * C::LDS;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + e;
        if (c < kv_valid) dst[c] = first ? src[c] : dst[c] + src[c];
      }
    }
    acc.add(sP_w, t.k);
  }
  acc.store(s_w, dq_b, dq_sl, q0 + warp * 16, Lq);
}

// fp32 g, delta given (dcap), fp32 dq contiguous (B, H, Lq, DK).
template <int DK, bool F32>
__global__ void __launch_bounds__(THREADS) core_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long q_sb, long long q_sh,
    long long q_sl, long long kv_sb, long long kv_sh, long long kv_sl,
    const float* __restrict__ g, long long g_sb, long long g_sh,
    long long g_sl, const float* __restrict__ pos,
    const float* __restrict__ key_mask, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ dcap,
    float* __restrict__ dq, float* __restrict__ dpos_part, int B, int H,
    int Lq, int Lk, int rows_per_group) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TilesA<DK, F32> t(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, grp = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Lq - q0);
  const int qi = q0 + warp * 16 + (lane >> 1);
  const bool row_ok = qi < Lq;
  // rows past Lq read row 0's bias: finite, and p = 0 for them anyway
  const float* pos_row = pos + ((long long)h * Lq + (row_ok ? qi : 0)) * Lk;
  float* part = dpos_part + ((long long)grp * H + h) * Lq * Lk;

  const int b_begin = grp * rows_per_group;
  const int b_end = min(B, b_begin + rows_per_group);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // every warp is done with the previous row's tiles
    load_tile<DK, F32>(t.q, q + b * q_sb + h * q_sh + q0 * q_sl, q_sl,
                       q_valid);
    load_tile<DK, F32>(t.g, g + b * g_sb + h * g_sh + q0 * g_sl, g_sl,
                       q_valid);
    const long long st = ((long long)b * H + h) * Lq + (row_ok ? qi : 0);
    dq_sweep<DK, F32>(t, k + b * kv_sb + h * kv_sh, v + b * kv_sb + h * kv_sh,
                      kv_sl, pos_row, key_mask + (long long)b * Lk, m_in[st],
                      l_in[st], dcap[st], part, b == b_begin,
                      dq + ((long long)b * H + h) * Lq * DK, (long long)DK,
                      q0, Lq, Lk);
  }
}

// ---------------------------------------------------------------------------
// B: dk and dv
// ---------------------------------------------------------------------------

// g of type GT (fp32); delta per query row given;
// dk and dv of type OT through (batch, head, row) strides.
template <int DK, bool F32, typename GT, typename OT>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long q_sb, long long q_sh,
    long long q_sl, long long kv_sb, long long kv_sh, long long kv_sl,
    const GT* __restrict__ g, long long g_sb, long long g_sh, long long g_sl,
    const float* __restrict__ pos, const float* __restrict__ key_mask,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta, OT* __restrict__ dk,
    OT* __restrict__ dv, long long dkv_sb, long long dkv_sh,
    long long dkv_sl, int H, int Lq, int Lk) {
  using C = Cfg<DK, F32>;
  using T = typename C::T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + C::TILE;
  T* sQ = sV + C::TILE;
  T* sG = sQ + C::TILE;
  T* sPT = sG + C::TILE;      // p^T: keys x queries
  T* sDT = sPT + C::P_ELEMS;  // ds^T
  float* sS = reinterpret_cast<float*>(sDT + C::P_ELEMS);
  float* sPos = sS + C::S_ELEMS;  // pos tile, queries x keys
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
  float* s_w = sS + warp * 16 * C::LDS;
  T* pt_row = sPT + krow * C::LDP;
  T* dt_row = sDT + krow * C::LDP;
  const long long st0 = ((long long)b * H + h) * Lq;

  load_tile<DK, F32>(sK, k + b * kv_sb + h * kv_sh + k0 * kv_sl, kv_sl,
                     kv_valid);
  load_tile<DK, F32>(sV, v + b * kv_sb + h * kv_sh + k0 * kv_sl, kv_sl,
                     kv_valid);

  Accum<DK, F32> dv_acc, dk_acc;
  dv_acc.zero();
  dk_acc.zero();
  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int q_valid = min(BQ, Lq - q0);
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<DK, F32>(sQ, q + b * q_sb + h * q_sh + q0 * q_sl, q_sl,
                       q_valid);
    load_tile<DK, F32>(sG, g + b * g_sb + h * g_sh + q0 * g_sl, g_sl,
                       q_valid);
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
      sD[i] = ok ? delta[st0 + q0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T (this warp's 16 keys x 64 queries) = K_w . Q^T
    float pv[HALF_COLS], dpt[HALF_COLS];
    product_nt<DK, F32>(sK + warp * 16 * C::LDQ, sQ, s_w, pv);
#pragma unroll
    for (int j = 0; j < HALF_COLS; ++j) {
      const int c = half + 2 * j;  // query within the tile
      float p = 0.0f;
      if (key_ok && c < q_valid) {
        const float s = pv[j] + sPos[c * LDPOS + krow] + mask_j;
        p = expf(s - sM[c]) / sL[c];
      }
      pv[j] = p;
      pt_row[c] = from_float<T>(p);
    }
    // dP^T (16 keys x 64 queries) = V_w . G^T
    product_nt<DK, F32>(sV + warp * 16 * C::LDQ, sG, s_w, dpt);
#pragma unroll
    for (int j = 0; j < HALF_COLS; ++j) {
      const int c = half + 2 * j;
      dt_row[c] = from_float<T>(pv[j] * (dpt[j] - sD[c]));
    }
    __syncwarp();
    dv_acc.add(sPT + warp * 16 * C::LDP, sG);
    dk_acc.add(sDT + warp * 16 * C::LDP, sQ);
  }
  const long long base = b * dkv_sb + h * dkv_sh + (long long)k0 * dkv_sl;
  dv_acc.store(s_w, dv + base, dkv_sl, warp * 16, kv_valid);
  dk_acc.store(s_w, dk + base, dkv_sl, warp * 16, kv_valid);
}

// Kernels A and B use more than 48 KB of dynamic shared memory: opt in.
template <typename KernelA, typename KernelB>
cudaError_t allow_smem(KernelA ka, int bytes_a, KernelB kb, int bytes_b) {
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_a);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_b);
}

template <int DK>
int launch(const T5BwdArgs& a, const float* g, const float* dcap, float* dq,
           float* dk, float* dv, float* part, cudaStream_t stream) {
  using C = Cfg<DK, true>;
  auto ka = core_bwd_dq_kernel<DK, true>;
  auto kb = bwd_dkdv_kernel<DK, true, float, float>;
  cudaError_t err = allow_smem(ka, C::BYTES_A, kb, C::BYTES_B);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const float* pos = static_cast<const float*>(a.pos);
  const float* mask = static_cast<const float*>(a.key_mask);
  const float* m = static_cast<const float*>(a.m);
  const float* l = static_cast<const float*>(a.l);
  const int groups = (a.B + a.rows_per_group - 1) / a.rows_per_group;

  dim3 grid_a((a.Lq + BQ - 1) / BQ, a.H, groups);
  ka<<<grid_a, THREADS, C::BYTES_A, stream>>>(
      q, k, v, a.q_sb, a.q_sh, a.q_sl, a.kv_sb, a.kv_sh, a.kv_sl, g, a.g_sb,
      a.g_sh, a.g_sl, pos, mask, m, l, dcap, dq, part, a.B, a.H, a.Lq, a.Lk,
      a.rows_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // dk, dv contiguous (B, H, Lk, DK)
  dim3 grid_b((a.Lk + BKV - 1) / BKV, a.H, a.B);
  kb<<<grid_b, THREADS, C::BYTES_B, stream>>>(
      q, k, v, a.q_sb, a.q_sh, a.q_sl, a.kv_sb, a.kv_sh, a.kv_sl, g, a.g_sb,
      a.g_sh, a.g_sl, pos, mask, m, l, dcap, dk, dv,
      (long long)a.H * a.Lk * DK, (long long)a.Lk * DK, (long long)DK, a.H,
      a.Lq, a.Lk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernels A and B of K2a on `stream` (the dpos partials into `part`, one
// (H, Lq, Lk) slab per group of rows_per_group batch rows; the caller sums
// them). Returns 0 or a cudaError_t.
int t5_bwd_fp32_launch(const T5BwdArgs& a, const float* g, const float* dcap,
                       float* dq, float* dk, float* dv, float* part,
                       cudaStream_t stream) {
  if (a.dk == 64) return launch<64>(a, g, dcap, dq, dk, dv, part, stream);
  if (a.dk == 128) return launch<128>(a, g, dcap, dq, dk, dv, part, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
