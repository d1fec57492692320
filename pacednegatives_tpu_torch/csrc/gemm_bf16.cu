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
// N = 2304 or 768) the product does ~300-500 operations per byte moved, so
// it is bound by the tensor cores (989 TFLOP/s bf16), which only wgmma
// drives at full rate, fed without stalls; a 128 x 256 x 64 step also pulls
// 48 KB from L2 into each SM, so the L2 feed and the epilogue are the next
// limits.
//
// Design (hopper_pipeline.cuh): one persistent CTA per SM walks the
// 128 x 256 output tiles (N fastest, so neighbouring CTAs share A's rows in
// L2; the weights fit L2 whole). Warpgroup 0 is the producer: its first
// thread issues TMA loads of A's 128 x 64 box (K-major) and B's four
// 64 x 64 boxes (row-major B is N-major for wgmma, which bf16 allows as
// the transposed B operand, so the weights are read as they lie) into a
// three-stage ring of 48 KB stages, 128-byte swizzle. Warpgroups 1 and 2
// each own 64 rows of the tile and issue four m64n256k16 wgmmas per stage
// into 128 fp32 registers a thread (setmaxnreg gives them 232 registers,
// the producer 40), keeping one stage's products in flight while the next
// is issued. The producer runs ahead across tiles, so one tile's epilogue
// overlaps the next tile's loads. The epilogue rounds to bf16 into a 32 KB
// staging buffer per warpgroup (stmatrix into the 128-byte swizzle, so the
// writes are conflict-free and few) and leaves the tile to TMA stores,
// which drain while the next tile's products run (stored straight from
// registers, as 4-byte scattered stores with the tensor cores idle, the
// epilogue cost about a third of the kernel's time at the serving shape).
// TMA zero-fills the ragged M, N and K edges on load and clips them on
// store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_pipeline.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int A_BYTES = BM * BK * 2;                // 16 KB
constexpr int B_BOX_BYTES = 64 * BK * 2;            // 8 KB: 64 columns
constexpr int B_BYTES = BN * BK * 2;                // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;      // 48 KB
constexpr int C_BYTES = 64 * BN * 2;                // a consumer's 64 rows
constexpr int THREADS = 384;                        // producer + 2 consumers
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + 2 * C_BYTES + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c, int M, int N,
                     int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = smem + STAGES * STAGE_BYTES;  // 2 x C_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + 2 * C_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive + bytes
      hopper::mbar_init(&empty[s], 2);  // one arrive per consumer
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          hopper::mbar_expect_tx(&full[stage], STAGE_BYTES);
          hopper::tma_load_2d(st, &map_a, &full[stage], kb * BK, m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_2d(st + A_BYTES + c * B_BOX_BYTES, &map_b,
                                &full[stage], n0 + 64 * c, kb * BK);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int cw = wg - 1;  // rows 64 * cw .. of the tile
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * STAGE_BYTES;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: K-major rows of 128 bytes, +32 bytes per k16 step. B: N-major,
          // 64-column boxes 8 KB apart (lbo), 8 k-rows 1 KB apart (sbo),
          // +16 rows (2 KB) per k16 step.
          const uint64_t da =
              hopper::make_desc(st + cw * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = hopper::make_desc(
              st + A_BYTES + kk * 16 * 128, B_BOX_BYTES, 1024);
          hopper::wgmma_m64n256k16_bf16_tb(acc, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done
        hopper::fence_regs(acc);
        if (prev >= 0 && leader) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (prev >= 0 && leader) hopper::mbar_arrive(&empty[prev]);

      // epilogue: fp32 -> bf16 into this warpgroup's 64 x 256 staging
      // buffer, as four 64 x 64 boxes in the 128-byte swizzle, four 8 x 8
      // matrices per stmatrix (conflict-free: a matrix's 8 rows land on 8
      // distinct 16-byte bank groups), then TMA stores, which clip the
      // ragged M and N edges and drain while the next tile's products run
      unsigned char* cb = cbuf + cw * C_BYTES;
      if (leader) hopper::bulk_wait_read();  // the last tile's stores
      hopper::named_sync(1 + cw, 128);
#pragma unroll
      for (int q = 0; q < BN / 16; ++q) {
        // matrices (rows 8h.., columns 8j..) for h = 0, 1 and j = 2q, 2q + 1;
        // this lane addresses row lane % 8 of matrix lane / 8
        const int rr = lane % 8, hj = lane / 8;
        const int r = warp * 16 + 8 * (hj & 1) + rr, j = 2 * q + (hj >> 1);
        uint32_t v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int jm = 2 * q + (m >> 1), hm = m & 1;
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              acc[4 * jm + 2 * hm], acc[4 * jm + 2 * hm + 1]);
          v[m] = *reinterpret_cast<const uint32_t*>(&p);
        }
        hopper::stmatrix_x4(
            hopper::smem_u32(cb + (j / 8) * 8192 + r * 128 +
                             (((j % 8) ^ rr) << 4)),
            v);
      }
      hopper::fence_async_smem();
      hopper::named_sync(1 + cw, 128);
      if (leader) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          hopper::tma_store_2d(&map_c, cb + b * 8192, n0 + 64 * b,
                               m0 + cw * 64);
        hopper::bulk_commit();
      }
    }
    if (leader) hopper::bulk_wait();
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns 0 or a cudaError_t (the tensor
// maps' encoding, the launch's cudaGetLastError()). Launches on `stream`;
// allocates nothing. A and B: row-major with row strides lda, ldb
// (elements, multiples of 8), 16-byte-aligned bases; K and N multiples of 8.
extern "C" int pnt_gemm_bf16(const void* A, const void* B, void* C, int M,
                             int N, int K, long long lda, long long ldb,
                             long long ldc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0 || K <= 0 || (N % 8) || (K % 8) || (lda % 8) ||
      (ldb % 8) || (ldc % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b, map_c;
  int rc = hopper::make_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A,
                               K, M, lda * 2, BK, BM);
  if (rc) return rc;
  rc = hopper::make_map_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, B, N, K,
                           ldb * 2, 64, BK);
  if (!rc)
    rc = hopper::make_map_2d(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, C, N,
                             M, ldc * 2, 64, 64);
  if (rc) return rc;
  err = cudaFuncSetAttribute(gemm_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      tiles < hopper::sm_count(device) ? tiles : hopper::sm_count(device));
  gemm_bf16_kernel<<<grid, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, map_c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
