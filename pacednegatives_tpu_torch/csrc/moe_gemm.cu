// M1: the grouped bf16 GEMM of a mixture-of-experts layer for Hopper
// (sm_90a), over the experts a rank holds, bf16 operands, fp32
// accumulation, bf16 results.
//
// Replaces no TPU kernel: the JAX package has no expert layer. Added for
// the experts of DeepSeek-V3-style MoE layers (models/deepseek_v3.py,
// ops/moe.py), whose tokens arrive sorted by expert in one buffer, each
// expert's segment starting at a multiple of 128 rows (zero rows fill a
// segment up to the next multiple). The per-expert offsets stay on the
// device, so the host never learns how many rows an expert got: the grid
// is sized for the worst case and each CTA reads the offsets to find its
// tiles, skipping those past the last segment.
//
// Two modes, one pipeline:
//   mode 0, rows grouped (forward, and dX over transposed weights):
//     Y[r, :] = X[r, :] . W[e]  for the rows r of expert e's segment;
//     X (rows, K), W (E, K, N), Y (rows, N). A 128-row tile lies inside
//     one segment, so it reads one expert's weights.
//   mode 1, reduction grouped (dW):
//     dW[e] = X[seg_e]^T . dY[seg_e]; X (rows, M), dY (rows, N),
//     dW (E, M, N). Each output tile sums over its expert's segment; an
//     expert with no rows gets zeros.
//
// What bounds it: at the Moonlight cell's shapes (about 1,870 rows an
// expert, 8 experts, K = 2,048, N = 2,816 for gate|up; 1,408 -> 2,048
// down) the products do ~700-900 operations per byte of the weights and
// activations, so the tensor cores bound it (989 TFLOP/s bf16); the
// ragged segment tails (each padded to 128 rows) and the tile quantisation
// over 132 SMs (about 15 x 11 = 165 tiles for gate|up) are the losses.
//
// Design: gemm_bf16.cu's pipeline (hopper_pipeline.cuh): one persistent
// CTA per SM walks the output tiles of 128 x 256 (N fastest); the
// producer warpgroup's first thread keeps TMA loads of the A tile (mode
// 0: one 128 x 64 K-major box; mode 1: two 64 x 64 boxes of X, M
// contiguous, read as the transposed A operand) and B's four 64 x 64
// N-major boxes in a three-stage ring; two consumer warpgroups each run
// m64n256k16 wgmmas into 128 fp32 registers a thread; the epilogue rounds
// to bf16 through a swizzled staging buffer and TMA stores. TMA zero-fills
// loads past the ends and clips the stores.

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

// C[64 x 256] += A[64 x 16] . B[16 x 256], bf16, both from shared memory,
// B MN-major; A K-major (TA 0) or MN-major (TA 1, M contiguous).
template <int TA>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA));
}

// One output tile: its expert, its first row (of Y, or of dW[e]), its
// first column, where its reduction starts and how many BK steps it takes.
struct Tile {
  int e, m0, n0, k0, nk;
};

// The number of tiles: mode 0 from the end of the last segment, mode 1
// fixed by E, M and N.
template <int MODE>
__device__ __forceinline__ int tile_count(const int* offs, int E, int K,
                                          int N) {
  const int tiles_n = (N + BN - 1) / BN;
  if (MODE == 0) return (offs[E] / BM) * tiles_n;
  return E * (K / BM) * tiles_n;
}

template <int MODE>
__device__ __forceinline__ Tile tile_at(int tile, const int* offs, int E,
                                        int K, int N) {
  const int tiles_n = (N + BN - 1) / BN;
  Tile t;
  t.n0 = (tile % tiles_n) * BN;
  if (MODE == 0) {
    t.m0 = (tile / tiles_n) * BM;
    int e = 0;
    while (e < E - 1 && offs[e + 1] <= t.m0) ++e;
    t.e = e;
    t.k0 = 0;
    t.nk = K / BK;
  } else {
    const int per_e = (K / BM) * tiles_n;
    t.e = tile / per_e;
    t.m0 = ((tile % per_e) / tiles_n) * BM;
    t.k0 = offs[t.e];
    t.nk = (offs[t.e + 1] - offs[t.e]) / BK;
  }
  return t;
}

// MODE 0: A = X (rows, K), B = W as (E * K, N), C = Y (rows, N).
// MODE 1: A = X (rows, K = M), B = dY (rows, N), C = dW as (E * M, N).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    moe_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c,
                    const int* __restrict__ offs, int E, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = smem + STAGES * STAGE_BYTES;  // 2 x C_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + 2 * C_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles = tile_count<MODE>(offs, E, K, N);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
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
        const Tile t = tile_at<MODE>(tile, offs, E, K, N);
        for (int kb = 0; kb < t.nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          hopper::mbar_expect_tx(&full[stage], STAGE_BYTES);
          const int k = t.k0 + kb * BK;
          if (MODE == 0) {
            hopper::tma_load_2d(st, &map_a, &full[stage], k, t.m0);
          } else {
            hopper::tma_load_2d(st, &map_a, &full[stage], t.m0, k);
            hopper::tma_load_2d(st + A_BYTES / 2, &map_a, &full[stage],
                                t.m0 + 64, k);
          }
          const int brow = MODE == 0 ? t.e * K + k : k;
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_2d(st + A_BYTES + c * B_BOX_BYTES, &map_b,
                                &full[stage], t.n0 + 64 * c, brow);
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
      const Tile t = tile_at<MODE>(tile, offs, E, K, N);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < t.nk; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * STAGE_BYTES;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // B: N-major, 64-column boxes 8 KB apart (lbo), 8 k-rows 1 KB
          // apart (sbo), +16 rows (2 KB) a k16 step. A in mode 0: K-major
          // rows of 128 bytes, +32 bytes a k16 step; in mode 1: M-major,
          // this warpgroup's 64 rows are one 8 KB box of k-rows, +2 KB a
          // k16 step.
          const uint64_t db = hopper::make_desc(
              st + A_BYTES + kk * 16 * 128, B_BOX_BYTES, 1024);
          if (MODE == 0) {
            const uint64_t da =
                hopper::make_desc(st + cw * 64 * 128 + kk * 32, 16, 1024);
            wgmma_m64n256k16<0>(acc, da, db);
          } else {
            const uint64_t da = hopper::make_desc(
                st + cw * (A_BYTES / 2) + kk * 16 * 128, A_BYTES / 2, 1024);
            wgmma_m64n256k16<1>(acc, da, db);
          }
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

      // epilogue: as gemm_bf16.cu's (stmatrix into the 128-byte swizzle,
      // then TMA stores that clip the ragged N edge)
      unsigned char* cb = cbuf + cw * C_BYTES;
      if (leader) hopper::bulk_wait_read();  // the last tile's stores
      hopper::named_sync(1 + cw, 128);
#pragma unroll
      for (int q = 0; q < BN / 16; ++q) {
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
        const int crow = (MODE == 0 ? 0 : t.e * K) + t.m0 + cw * 64;
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          if (t.n0 + 64 * b < N)
            hopper::tma_store_2d(&map_c, cb + b * 8192, t.n0 + 64 * b, crow);
        hopper::bulk_commit();
      }
    }
    if (leader) hopper::bulk_wait();
  }
}

template <int MODE>
int launch(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& c,
           const int* offs, int E, int K, int N, long long tiles, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles <= 0) return 0;
  const int sms = hopper::sm_count(device);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  moe_gemm_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, c, offs,
                                                               E, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. Returns 0 or a cudaError_t. Launches on
// `stream`; allocates nothing; reads `offs` (E + 1 int32, on the device)
// only inside the kernel. All operands contiguous row-major bf16 with
// 16-byte-aligned bases, `rows` a multiple of 128, every offset a multiple
// of 128 and offs[E] <= rows.
//   mode 0: A = X (rows, K), B = W (E, K, N), C = Y (rows, N); K a
//     multiple of 64, N of 8.
//   mode 1: A = X (rows, K), B = dY (rows, N), C = dW (E, K, N); K a
//     multiple of 128, N of 8.
extern "C" int pnt_moe_gemm(const void* A, const void* B, void* C,
                            const void* offs, int E, int rows, int K, int N,
                            int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || rows <= 0 || K <= 0 || N <= 0 || (rows % BM) || (N % 8) ||
      (mode == 0 && K % BK) || (mode == 1 && K % BM) ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* o = static_cast<const int*>(offs);
  const int tiles_n = (N + BN - 1) / BN;
  CUtensorMap map_a, map_b, map_c;
  int rc;
  if (mode == 0) {
    rc = hopper::make_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, K,
                             rows, static_cast<uint64_t>(K) * 2, BK, BM);
    if (!rc)
      rc = hopper::make_map_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, B, N,
                               static_cast<uint64_t>(E) * K,
                               static_cast<uint64_t>(N) * 2, 64, BK);
    if (!rc)
      rc = hopper::make_map_2d(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, C, N,
                               rows, static_cast<uint64_t>(N) * 2, 64, 64);
    if (rc) return rc;
    return launch<0>(map_a, map_b, map_c, o, E, K, N,
                     static_cast<long long>(rows / BM) * tiles_n, device,
                     static_cast<cudaStream_t>(stream));
  }
  rc = hopper::make_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, K,
                           rows, static_cast<uint64_t>(K) * 2, 64, BK);
  if (!rc)
    rc = hopper::make_map_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, B, N,
                             rows, static_cast<uint64_t>(N) * 2, 64, BK);
  if (!rc)
    rc = hopper::make_map_2d(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, C, N,
                             static_cast<uint64_t>(E) * K,
                             static_cast<uint64_t>(N) * 2, 64, 64);
  if (rc) return rc;
  return launch<1>(map_a, map_b, map_c, o, E, K, N,
                   static_cast<long long>(E) * (K / BM) * tiles_n, device,
                   static_cast<cudaStream_t>(stream));
}
