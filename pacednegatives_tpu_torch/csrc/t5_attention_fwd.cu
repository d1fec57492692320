// T5 attention core, forward, for Hopper (sm_90a).
//
// Per (batch b, head h):  out = softmax(q . k^T + pos[h] + key_mask[b]) . v
// with no 1/sqrt(dk) scaling (T5 folds it into the init), plus the softmax
// statistics m (row max) and l (row sum of exp(s - m)).
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
// the two products are ~28 GFLOP per call, small next to the projections,
// and the exp / max / sum work on B*H*L*L scores is scalar. The kernel is
// bound by that scalar softmax work and by shared-memory traffic, not by
// device memory: q/k/v are read once per query tile and scores never leave
// the SM. Design: one block of 4 warps per (64-row query tile, h, b); it
// sweeps 64-key tiles with an online softmax (running m and l in fp32),
// computes S and P.V with WMMA bf16 16x16x16 fragments (fp32 accumulate),
// rounds the UNNORMALISED p to bf16 before P.V and divides by l at the end,
// as the TPU kernels do (flash.py:78-89, flash_v3.py:120-127). Each lane
// pair owns one query row: lanes 2r and 2r+1 take the interleaved columns of
// row r, so the row's max and sum need one shuffle. The output accumulator
// lives in registers in that same layout; the P.V product of each key tile
// comes back through the warp's rows of a shared scratch.
//
// Ragged lengths: rows past Lq and key columns past Lk are masked inside the
// kernel (the TPU wrapper pads L to 16 instead). q/k/v/out are read through
// (batch, head, row) strides with a contiguous head dimension, so the same
// kernel reads K1's (B, H, L, dk) layout and K3's fused (B, L, 3*H*dk) qkv
// buffer without a transpose copy, and writes K3's (B, L, H*dk) layout.
// Not yet done (later work): mma.sync/wgmma register tiles, cp.async or TMA
// prefetch of the next key tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int BKV = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e9f;  // the repo's additive mask value (t5.py:33)

template <int DK>
struct Smem {
  static constexpr int LDQ = DK + 8;   // bf16 q/k/v rows
  static constexpr int LDP = BKV + 8;  // bf16 probabilities
  static constexpr int LDS = (DK > BKV ? DK : BKV) + 4;  // fp32 scratch
  static constexpr int Q_ELEMS = BQ * LDQ;
  static constexpr int KV_ELEMS = BKV * LDQ;
  static constexpr int P_ELEMS = BQ * LDP;
  static constexpr int BYTES =
      (Q_ELEMS + 2 * KV_ELEMS + P_ELEMS) * 2 + BQ * LDS * 4;
};

// Copy `rows_valid` rows of a 64 x DK bf16 tile (row stride `ld` elements)
// into shared memory, 16 bytes a thread; rows past rows_valid become zero.
template <int DK>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
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

template <int DK, bool OUT_F32>
__global__ void __launch_bounds__(THREADS) t5_attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, long long q_sb, long long q_sh,
    long long q_sl, long long kv_sb, long long kv_sh, long long kv_sl,
    const float* __restrict__ pos, const float* __restrict__ key_mask,
    void* __restrict__ out, long long o_sb, long long o_sh, long long o_sl,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int Lq,
    int Lk) {
  using S = Smem<DK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + S::Q_ELEMS;
  __nv_bfloat16* sV = sK + S::KV_ELEMS;
  __nv_bfloat16* sP = sV + S::KV_ELEMS;
  float* sS = reinterpret_cast<float*>(sP + S::P_ELEMS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + q0 * q_sl;
  const __nv_bfloat16* kb = k + b * kv_sb + h * kv_sh;
  const __nv_bfloat16* vb = v + b * kv_sb + h * kv_sh;
  load_tile<DK>(sQ, qb, q_sl, min(BQ, Lq - q0));

  // This lane's query row and its half of the key columns (interleaved).
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qi = q0 + row;
  const bool row_ok = qi < Lq;
  // rows past Lq read row 0's bias: finite, and their results are dropped
  const float* pos_row = pos + ((long long)h * Lq + (row_ok ? qi : 0)) * Lk;
  const float* mask_row = key_mask + (long long)b * Lk;
  float* s_row = sS + row * S::LDS;
  __nv_bfloat16* p_row = sP + row * S::LDP;

  float m_i = NEG_INF;  // the TPU kernels start the running max here too
  float l_i = 0.0f;
  float o[DK / 2];
#pragma unroll
  for (int j = 0; j < DK / 2; ++j) o[j] = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += BKV) {
    const int kv_valid = min(BKV, Lk - k0);
    __syncthreads();  // every warp is done with the previous sK / sV
    load_tile<DK>(sK, kb + k0 * kv_sl, kv_sl, kv_valid);
    load_tile<DK>(sV, vb + k0 * kv_sl, kv_sl, kv_valid);
    __syncthreads();

    // S (16 x 64 per warp) = Q_w . K^T, fp32 accumulate.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKV / 16];
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * S::LDQ + kk, S::LDQ);
#pragma unroll
        for (int n = 0; n < BKV / 16; ++n) {
          // K stored row-major (key, d) is K^T in column-major order.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              bk;
          wmma::load_matrix_sync(bk, sK + n * 16 * S::LDQ + kk, S::LDQ);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * S::LDS + n * 16, acc[n],
                                S::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile: s = q.k + pos + mask, in that order
    // (flash.py:73); columns past Lk are excluded (-inf -> p = 0).
    float sv[BKV / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = half + 2 * j;
      float s = -INFINITY;
      if (c < kv_valid) s = s_row[c] + pos_row[k0 + c] + mask_row[k0 + c];
      sv[j] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_i, tmax);
    const float corr = expf(m_i - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
      p_row[half + 2 * j] = __float2bfloat16(p);  // unnormalised, as the TPU
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();

    // P.V (16 x DK per warp), fp32 accumulate, back through the scratch.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DK / 16];
#pragma unroll
      for (int n = 0; n < DK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, sP + warp * 16 * S::LDP + kk, S::LDP);
#pragma unroll
        for (int n = 0; n < DK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bv;
          wmma::load_matrix_sync(bv, sV + kk * S::LDQ + n * 16, S::LDQ);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < DK / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * S::LDS + n * 16, acc[n],
                                S::LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DK / 2; ++j)
      o[j] = o[j] * corr + s_row[half + 2 * j];
    __syncwarp();
  }

  const float l_fin = fmaxf(l_i, 1e-30f);  // the TPU kernels' clamp
  if (half == 0 && row_ok) {
    const long long idx = ((long long)b * H + h) * Lq + qi;
    m_out[idx] = m_i;
    l_out[idx] = l_fin;
  }
  // Normalise, stage the warp's 16 rows, and store them row by row.
#pragma unroll
  for (int j = 0; j < DK / 2; ++j) s_row[half + 2 * j] = o[j] / l_fin;
  __syncwarp();
  for (int idx = lane; idx < 16 * (DK / 2); idx += 32) {
    const int rr = idx / (DK / 2), c = (idx % (DK / 2)) * 2;
    const int qrow = q0 + warp * 16 + rr;
    if (qrow >= Lq) continue;
    const float x0 = sS[(warp * 16 + rr) * S::LDS + c];
    const float x1 = sS[(warp * 16 + rr) * S::LDS + c + 1];
    const long long off = b * o_sb + h * o_sh + qrow * o_sl + c;
    if (OUT_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
          make_float2(x0, x1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         off) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int DK, bool OUT_F32>
int launch(const void* q, const void* k, const void* v, long long q_sb,
           long long q_sh, long long q_sl, long long kv_sb, long long kv_sh,
           long long kv_sl, const void* pos, const void* key_mask, void* out,
           long long o_sb, long long o_sh, long long o_sl, void* m, void* l,
           int B, int H, int Lq, int Lk, cudaStream_t stream) {
  auto kernel = t5_attention_fwd_kernel<DK, OUT_F32>;
  constexpr int bytes = Smem<DK>::BYTES;  // above 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_sb, q_sh, q_sl, kv_sb, kv_sh,
      kv_sl, static_cast<const float*>(pos),
      static_cast<const float*>(key_mask), out, o_sb, o_sh, o_sl,
      static_cast<float*>(m), static_cast<float*>(l), H, Lq, Lk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements; the head
// dimension is contiguous. pos is (H, Lq, Lk) fp32 and key_mask (B, Lk) fp32,
// both contiguous; m and l are (B, H, Lq) fp32. Returns cudaGetLastError()
// after the launch (0 = success). Launches on `stream`; allocates nothing.
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
      o_sh, o_sl, m, l, B, H, Lq, Lk, s
  if (dk == 64) return out_f32 ? launch<64, true>(PNT_ARGS)
                               : launch<64, false>(PNT_ARGS);
  if (dk == 128) return out_f32 ? launch<128, true>(PNT_ARGS)
                                : launch<128, false>(PNT_ARGS);
#undef PNT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
