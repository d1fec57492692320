// bf16 GEMM for Hopper (sm_90a): C[M, N] = A[M, K] . B[K, N], row-major,
// bf16 operands, fp32 accumulation, bf16 result.
//
// Replaces: the two projections inside the TPU kernel _v3_fwd_kernel /
// v3_forward (pacednegatives_tpu/ops/flash_v3.py:94-147): qkv = x . Wqkv and
// y = attn . Wo. The TPU kernel keeps both weights and one batch row's qkv in
// one core's VMEM; no Hopper SM can hold that (192 x 2304 bf16 is ~0.9 MB
// against 227 KB of shared memory), so the port runs the block as
// GEMM -> attention core -> GEMM with the intermediates in device memory.
//
// What bounds it: at the serving shapes (M = 256 * 188 rows, K = 768,
// N = 2304 or 768) the product does ~100-300 flops per byte moved, so it is
// bound by tensor-core issue, not by memory. Design: 128 x 128 output tiles
// per block of 8 warps (each warp a 64 x 32 sub-tile of 4 x 2 WMMA 16x16x16
// bf16 fragments with fp32 accumulators), K stepped by 32 through a
// two-stage cp.async ring in shared memory so the next tile's loads overlap
// the current tile's products. Ragged M and K are zero-filled by cp.async's
// source-size operand; N and K must be multiples of 8 (one 16-byte chunk).
// The epilogue stages each fragment through shared memory to round to bf16
// and store 16 bytes a thread with the ragged edge masked.
// Not yet done (later work): wgmma/TMA, a persistent schedule, deeper rings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int WN = BN / WARPS_N;  // 32 columns per warp
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
// Padded leading dimensions: rows stay 16-byte aligned for cp.async and
// 32-byte aligned at every 16-row fragment, and shift banks row to row.
constexpr int LDA = BK + 8;  // 40
constexpr int LDB = BN + 8;  // 136
constexpr int A_STAGE = BM * LDA;  // elements
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_BYTES = 2 * (A_STAGE + B_STAGE) * 2;  // 37,888

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two blocks per SM (at most 128 registers a thread; ptxas spills 24 bytes)
// and one barrier per k-step: 0.94-0.99 ms at 48128 x 768 x 2304 against
// 1.17-1.20 ms for one 140-register block with two barriers per step
// (H100 80GB HBM3, 700 W); a third or fourth cp.async stage gained nothing.
__global__ void __launch_bounds__(THREADS, 2)
    gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ B,
                     __nv_bfloat16* __restrict__ C, int M, int N, int K,
                     long long lda, long long ldb, long long ldc) {
  __shared__ __align__(128) unsigned char smem_raw[SMEM_BYTES];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + 2 * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* a_dst = sA + stage * A_STAGE;
    __nv_bfloat16* b_dst = sB + stage * B_STAGE;
    // A tile: BM x BK = 512 chunks of 8; B tile: BK x BN = 512 chunks.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + col;
      const bool ok = gr < M && gc < K;
      const __nv_bfloat16* src = ok ? A + (long long)gr * lda + gc : A;
      cp_async16(a_dst + r * LDA + col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + col;
      const bool ok = gr < K && gc < N;
      const __nv_bfloat16* src = ok ? B + (long long)gr * ldb + gc : B;
      cp_async16(b_dst + r * LDB + col, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<0>();  // tile kt has landed
    // one barrier per step: tile kt is visible to every warp, and every
    // warp is done with tile kt - 1, whose stage the next load refills
    __syncthreads();
    if (kt + 1 < ktiles) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* a_s = sA + (kt & 1) * A_STAGE;
    const __nv_bfloat16* b_s = sB + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_s + (warp_m * WM + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b_s + kk * LDB + warp_n * WN + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done reading the ring

  // Epilogue: each warp owns a 16 x 16 fp32 staging square in the (now idle)
  // pipeline buffer; lane -> (row lane / 2, 8 columns at (lane % 2) * 8).
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2, cg = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + warp_m * WM + i * 16 + r;
      const int gc = n0 + warp_n * WN + j * 16 + cg;
      if (gr < M && gc < N) {
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed[e] = __floats2bfloat162_rn(stage[r * 16 + cg + 2 * e],
                                            stage[r * 16 + cg + 2 * e + 1]);
        *reinterpret_cast<uint4*>(C + (long long)gr * ldc + gc) =
            *reinterpret_cast<const uint4*>(packed);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = success). Launches on `stream`; allocates nothing.
extern "C" int pnt_gemm_bf16(const void* A, const void* B, void* C, int M,
                             int N, int K, long long lda, long long ldb,
                             long long ldc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0 || K <= 0 || (N % 8) || (K % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(B), static_cast<__nv_bfloat16*>(C), M,
      N, K, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}
