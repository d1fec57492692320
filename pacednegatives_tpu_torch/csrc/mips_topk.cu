// MIPS top-k for Hopper (sm_90a): the blockwise top-k of K5 and K6.
//
// Replaces: the TPU kernels _mips_block_kernel / mips_topk_pallas (K5,
// pacednegatives_tpu/ops/mips.py:73-138) and _quant_block_kernel /
// mips_topk_pallas_quantized (K6, :151-210): for every doc block of
// block_n rows and every query, the top-k' inner products (ties to the
// lower doc index); the merge of the candidates sits outside the kernel, as
// lax.top_k sits outside pallas_call (mips.py:64-70). The TPU kernel takes
// the per-block top-k' by k' rounds of max + first-argmax only because
// Mosaic has no sort (mips.py:9-12); here it is a real selection. Two
// designs share this file.
//
// fp32 and bf16 docs (K5; at the build_pools scale: B 64, 1M fp32 rows of
// 768, k 1000, block 1024, k' = k): pnt_mips_topk_sets.
//   What bounds it: 3.08 GB of fp32 docs read once, 0.92 ms at 3.35 TB/s,
//   if the fp32 products run on the tensor cores (98.7 GFLOP of fp32 FMA
//   would be 1.5 ms at 67 TFLOP/s) and the selection costs a few passes
//   over the scores (257 MB), not a sort of the survivors.
//   1. Scores (mips_scores_kernel): S[B, N] = Q . Docs^T, each doc row read
//      once. One persistent CTA per SM walks tiles of 256 docs x 64 queries
//      (hopper_pipeline.cuh): the producer warpgroup TMA-loads each tile's
//      doc box (256 rows x 128 bytes of D) and the queries' box into a
//      four-stage ring (128-byte swizzle); each of two consumer warpgroups
//      owns 128 of the docs as two m64 wgmma tiles against n64 queries,
//      fp32 accumulation. fp32 docs: 3xTF32. The consumer reads its tf32 A
//      fragments from the swizzled doc box, splits each value into a tf32
//      high part and the fp32 residual (x - hi) in registers, and issues
//      m64n64k8 wgmmas lo.q_hi + hi.q_lo + hi.q_hi (B = the queries' high
//      and low parts, split by the wrapper, K-major from shared memory). The
//      dropped lo.lo term and the residuals' tf32 rounding leave ~2^-21
//      relative per product, far inside the fp32 summation tolerance the
//      checks hold it to. bf16 docs: m64n64k16 bf16 wgmmas, both operands
//      from shared memory, against the queries rounded to bf16.
//   2. Selection (topk_segments_kernel): one CTA per (query, segment) finds
//      the set of the segment's top-kk keys with a radix select (12 + 12 + 8
//      bits of the order-preserving value, a shared-memory histogram per
//      round, a round only while the boundary bin holds more than 2048
//      keys), then writes the keys above the boundary and the boundary
//      bin's best (sorted in shared memory by value, then lower index) as
//      packed int64 merge keys. No list is kept sorted. Segments are the
//      blocks when k' < k; when k' >= k the blockwise function is the exact
//      top-k, so the segments are a few long runs of rows (about two CTAs an
//      SM) and kk = k.
//   The merge is an exact top-k on the packed keys (the wrapper).
//
// int8 docs (K6 at the online-mining scale: B 16, 8.8M int8 rows of 768,
// k 129, block 4096, k' 32): pnt_mips_topk, one CTA of 8 warps per (doc
// block, tile of 16 queries).
//   What bounds it: 6.8 GB of int8, ~2.0 ms at 3.35 TB/s.
//   The int8 values are converted to bf16 in shared memory (exact: |v| <=
//   127) and multiplied by bf16 WMMA against the queries rounded to bf16,
//   with fp32 sums and the row's fp32 scale applied to the sum (not int8 x
//   int8 IMMA, which would quantise the queries: another function). The
//   CTA walks its block in chunks of 128 docs: each chunk's 16 x 128 scores
//   go to shared memory through D in slabs of 64, the next slab's loads
//   kept in registers while the current one multiplies. Each warp then
//   updates the running top-k' of its two query rows: a key packs
//   (order-preserving value bits, ~index) into 64 bits; a threshold test
//   against the row's k'-th key rejects most scores in one compare once the
//   list is full; the survivors are compacted with a ballot, bitonic-sorted
//   by the warp and merged into the sorted list in place. At k' 32 of 4096
//   the threshold rejects almost everything, so this serial merge costs
//   little there.
//
// Both: no atomics that decide a result (the selection's shared-memory
// counters only place keys of a set), so the merged top-k repeats bitwise.
// Ties: -0 is folded into +0 before values are compared inside a block or
// segment, as the TPU kernel's == comparisons do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_pipeline.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int QT = 16;   // query rows per CTA: one WMMA m-tile
constexpr int CN = 128;  // docs per chunk: 16 columns per warp
constexpr int KS = 64;   // depth of one slab
constexpr int ROWS_PER_WARP = QT / NWARPS;
constexpr int S_LD = CN + 4;  // fp32 score tile row, a multiple of 4
constexpr int KMAX = 1024;    // longest running list (shared memory)
constexpr int C_PER_LANE = CN / 32;

enum { DOC_F32 = 0, DOC_BF16 = 1, DOC_I8 = 2 };

using Op = __nv_bfloat16;      // operand type in shared memory
constexpr int LD = KS + 8;     // 144-byte operand rows: 16-byte aligned

constexpr size_t smem_bytes(int kpb) {
  return size_t(QT) * kpb * 8            // running lists
         + size_t(NWARPS) * CN * 8       // per-warp candidate buffer
         + size_t(QT) * S_LD * 4         // score tile
         + size_t(QT) * LD * sizeof(Op)  // query slab
         + size_t(CN) * LD * sizeof(Op);  // doc slab
}

// Order-preserving map of fp32 bits (larger value -> larger key). -0 is
// folded into +0 first, so equal values tie on the index as the TPU
// kernel's comparisons do.
__device__ __forceinline__ uint32_t ord_key(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// ord_key with the complemented index below it (lower index -> larger key).
__device__ __forceinline__ unsigned long long make_key(float v, unsigned idx) {
  return (static_cast<unsigned long long>(ord_key(v)) << 32) | (~idx);
}

// Number of entries of the descending list a[0, n) greater than key.
__device__ __forceinline__ int count_greater(const unsigned long long* a,
                                             int n, unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] > key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    mips_topk_kernel(const Op* __restrict__ Q, const int8_t* __restrict__ docs,
                     const float* __restrict__ scales,
                     long long* __restrict__ cand, int B, int D,
                     int block_n, int kpb, int n_qtiles) {
  constexpr int DVEC = 16;                // doc elements per 16-byte load
  constexpr int DPR = KS / DVEC;          // loads per doc row of a slab
  constexpr int DLOADS = CN * DPR / THREADS;
  constexpr int QVEC = 16 / sizeof(Op);
  constexpr int QPR = KS / QVEC;
  constexpr int QLOADS = QT * QPR;  // <= THREADS

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* R = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* Cb = R + size_t(QT) * kpb;
  float* S = reinterpret_cast<float*>(Cb + NWARPS * CN);
  Op* Qs = reinterpret_cast<Op*>(S + QT * S_LD);
  Op* Ds = Qs + QT * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = blockIdx.x % n_qtiles;
  const int blk = blockIdx.x / n_qtiles;
  const int q0 = qt * QT;
  const int rows = min(QT, B - q0);
  const long long doc0 = static_cast<long long>(blk) * block_n;
  const int nchunks = (block_n + CN - 1) / CN;
  const int nslabs = (D + KS - 1) / KS;
  const int nsteps = nchunks * nslabs;

  uint4 draw[DLOADS];
  uint4 qraw;
  auto load_step = [&](int step) {
    const int chunk = step / nslabs, k0 = (step % nslabs) * KS;
#pragma unroll
    for (int i = 0; i < DLOADS; ++i) {
      const int id = tid + i * THREADS;
      const int n = id / DPR, k = k0 + (id % DPR) * DVEC;
      const int col = chunk * CN + n;
      draw[i] = make_uint4(0, 0, 0, 0);
      if (col < block_n && k < D)
        draw[i] = __ldg(reinterpret_cast<const uint4*>(
            docs + (doc0 + col) * D + k));
    }
    qraw = make_uint4(0, 0, 0, 0);
    if (tid < QLOADS) {
      const int r = tid / QPR, k = k0 + (tid % QPR) * QVEC;
      if (r < rows && k < D)
        qraw = __ldg(reinterpret_cast<const uint4*>(
            Q + static_cast<long long>(q0 + r) * D + k));
    }
  };
  auto store_step = [&]() {
#pragma unroll
    for (int i = 0; i < DLOADS; ++i) {
      const int id = tid + i * THREADS;
      const int n = id / DPR, kk = (id % DPR) * DVEC;
      const int8_t* b = reinterpret_cast<const int8_t*>(&draw[i]);
      __align__(16) __nv_bfloat162 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = __floats2bfloat162_rn(static_cast<float>(b[2 * e]),
                                     static_cast<float>(b[2 * e + 1]));
      uint4* dst = reinterpret_cast<uint4*>(Ds + n * LD + kk);
      dst[0] = reinterpret_cast<const uint4*>(h)[0];
      dst[1] = reinterpret_cast<const uint4*>(h)[1];
    }
    if (tid < QLOADS)
      *reinterpret_cast<uint4*>(Qs + (tid / QPR) * LD + (tid % QPR) * QVEC) =
          qraw;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> wacc;

  // per-warp running-list sizes of its rows (same value in every lane)
  int cnt[ROWS_PER_WARP];
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) cnt[j] = 0;
  unsigned long long* Cw = Cb + warp * CN;

  load_step(0);
  for (int step = 0; step < nsteps; ++step) {
    const int chunk = step / nslabs, slab = step % nslabs;
    if (slab == 0) wmma::fill_fragment(wacc, 0.0f);
    store_step();
    __syncthreads();
    if (step + 1 < nsteps) load_step(step + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + kk, LD);
      wmma::load_matrix_sync(b, Ds + warp * 16 * LD + kk, LD);
      wmma::mma_sync(wacc, a, b, wacc);
    }
    __syncthreads();  // the slab buffers are free for the next store
    if (slab != nslabs - 1) continue;

    // the chunk's 16 x 128 scores
    wmma::store_matrix_sync(S + warp * 16, wacc, S_LD, wmma::mem_row_major);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      if (r >= rows) continue;
      unsigned long long* Rr = R + size_t(r) * kpb;
      const bool full = cnt[j] == kpb;
      const unsigned long long thresh = full ? Rr[kpb - 1] : 0ull;
      // 1. threshold test and ballot compaction of the survivors
      int c = 0;
#pragma unroll
      for (int t = 0; t < C_PER_LANE; ++t) {
        const int n = t * 32 + lane;
        const int col = chunk * CN + n;
        bool pass = false;
        unsigned long long key = 0;
        if (col < block_n) {
          float v = S[r * S_LD + n];
          v *= __ldg(scales + doc0 + col);
          key = make_key(v, static_cast<unsigned>(doc0 + col));
          pass = !full || key > thresh;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, pass);
        if (pass) Cw[c + __popc(ballot & ((1u << lane) - 1u))] = key;
        c += __popc(ballot);
      }
      if (c == 0) continue;
      // 2. bitonic sort of the survivors, descending (0-keys pad to 2^m)
      int P = 1;
      while (P < c) P <<= 1;
      for (int i = c + lane; i < P; i += 32) Cw[i] = 0ull;
      __syncwarp();
      for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = lane; t < P / 2; t += 32) {
            const int i = 2 * stride * (t / stride) + (t % stride);
            const int o = i + stride;
            const unsigned long long a = Cw[i], b = Cw[o];
            const bool desc = (i & size) == 0;
            if ((a < b) == desc) { Cw[i] = b; Cw[o] = a; }
          }
          __syncwarp();
        }
      }
      // 3. merge into the running list in place: the survivors' new
      // positions first (the list still unmoved), then the list's entries
      // top-down (each moves up by the survivors ahead of it), then the
      // survivors
      const int n_old = cnt[j];
      int cpos[C_PER_LANE];
      unsigned long long ckey[C_PER_LANE];
#pragma unroll
      for (int t = 0; t < C_PER_LANE; ++t) {
        const int i = t * 32 + lane;
        cpos[t] = kpb;
        if (i < c) {
          ckey[t] = Cw[i];
          cpos[t] = i + count_greater(Rr, n_old, ckey[t]);
        }
      }
      __syncwarp();
      for (int hi = n_old; hi > 0; hi -= 32) {
        const int i = hi - 32 + lane;
        unsigned long long key = 0;
        int pos = kpb;
        if (i >= 0) {
          key = Rr[i];
          pos = i + count_greater(Cw, c, key);
        }
        __syncwarp();
        if (i >= 0 && pos < kpb && pos != i) Rr[pos] = key;
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < C_PER_LANE; ++t)
        if (cpos[t] < kpb) Rr[cpos[t]] = ckey[t];
      __syncwarp();
      cnt[j] = min(n_old + c, kpb);
    }
  }

  // the block's candidates as merge keys (a list key with its top bit
  // flipped: signed order is value descending, then the lower index), in
  // the (B, num_blocks, k') slots of this CTA only
  __syncthreads();
  const int num_blocks = gridDim.x / n_qtiles;
  for (int r = 0; r < rows; ++r) {
    const unsigned long long* Rr = R + size_t(r) * kpb;
    const long long out =
        (static_cast<long long>(q0 + r) * num_blocks + blk) * kpb;
    for (int i = tid; i < kpb; i += THREADS)
      cand[out + i] = static_cast<long long>(Rr[i] ^ 0x8000000000000000ull);
  }
}

int launch(const void* q, const void* docs, const float* scales,
           long long* cand, int B, int N, int D, int block_n, int kpb,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kpb);
  cudaError_t err = cudaFuncSetAttribute(
      mips_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (B + QT - 1) / QT;
  const long long grid = static_cast<long long>(N / block_n) * n_qtiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mips_topk_kernel<<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
      static_cast<const Op*>(q), static_cast<const int8_t*>(docs), scales,
      cand, B, D, block_n, kpb, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 docs: 3xTF32 scores, then a set selection per (query, segment)
// ---------------------------------------------------------------------------

constexpr int SC_DOCS = 256, SC_Q = 64, SC_STAGES = 4;
constexpr int SC_THREADS = 384;                  // producer + 2 consumers
constexpr int SC_D_BYTES = SC_DOCS * 128;        // 32 KB: 128-byte doc rows
constexpr int SC_Q_BYTES = SC_Q * 128;           // 8 KB: one query part
constexpr int SC_STAGE = SC_D_BYTES + 2 * SC_Q_BYTES;  // 48 KB (bf16: 40 used)
constexpr int SC_SMEM = SC_STAGES * SC_STAGE + 2 * SC_STAGES * 8 + 1024;

// Element (r, c) of a 128-byte-swizzled tile of 32-float rows.
__device__ __forceinline__ float swizzled(const unsigned char* tile, int r,
                                          int c) {
  return *reinterpret_cast<const float*>(
      tile + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
}

template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// S[B, N] = Q . Docs^T, one 128-byte slice of D (32 fp32 or 64 bf16) a
// stage. kF32: 3xTF32 with the doc operand split in registers and the
// queries' high and low parts from shared memory; else bf16 products with
// both operands from shared memory.
template <bool kF32>
__global__ void __launch_bounds__(SC_THREADS, 1)
    mips_scores_kernel(const __grid_constant__ CUtensorMap map_docs,
                       const __grid_constant__ CUtensorMap map_qhi,
                       const __grid_constant__ CUtensorMap map_qlo,
                       float* __restrict__ S, int B, int N, int D) {
  constexpr int BK = kF32 ? 32 : 64;  // elements of D a stage
  constexpr int STAGE_TX = SC_D_BYTES + (kF32 ? 2 : 1) * SC_Q_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SC_STAGES * SC_STAGE);
  uint64_t* empty = full + SC_STAGES;

  const int tiles_q = (B + SC_Q - 1) / SC_Q;
  const int tiles = ((N + SC_DOCS - 1) / SC_DOCS) * tiles_q;
  const int nk = (D + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SC_STAGES; ++s) {
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
        // query tiles of one doc tile are neighbours: their doc reads meet
        // in L2
        const int d0 = (tile / tiles_q) * SC_DOCS;
        const int q0 = (tile % tiles_q) * SC_Q;
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * SC_STAGE;
          hopper::mbar_expect_tx(&full[stage], STAGE_TX);
          hopper::tma_load_2d(st, &map_docs, &full[stage], kb * BK, d0);
          hopper::tma_load_2d(st + SC_D_BYTES, &map_qhi, &full[stage], kb * BK,
                              q0);
          if (kF32)
            hopper::tma_load_2d(st + SC_D_BYTES + SC_Q_BYTES, &map_qlo,
                                &full[stage], kb * BK, q0);
          if (++stage == SC_STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int cw = wg - 1;  // docs 128 * cw .. of the tile
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[2][32];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int d0 = (tile / tiles_q) * SC_DOCS;
      const int q0 = (tile % tiles_q) * SC_Q;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[s][i] = 0.0f;
      for (int kb = 0; kb < nk; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * SC_STAGE;
        if constexpr (kF32) {
          // A fragments (m16n8k8 tf32 layout per warp) straight from the
          // swizzled doc box, split into tf32 high part and residual
          uint32_t hi[2][4][4], lo[2][4][4];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int r = cw * 128 + s * 64 + warp * 16 + g;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int c = kk * 8 + t;
              const float x[4] = {swizzled(st, r, c), swizzled(st, r + 8, c),
                                  swizzled(st, r, c + 4),
                                  swizzled(st, r + 8, c + 4)};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                hi[s][kk][e] = hopper::to_tf32(x[e]);
                lo[s][kk][e] =
                    __float_as_uint(x[e] - __uint_as_float(hi[s][kk][e]));
              }
            }
          }
          hopper::fence_regs(acc[0]);
          hopper::fence_regs(acc[1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qh =
                hopper::make_desc(st + SC_D_BYTES + kk * 32, 16, 1024);
            const uint64_t ql = hopper::make_desc(
                st + SC_D_BYTES + SC_Q_BYTES + kk * 32, 16, 1024);
#pragma unroll
            for (int s = 0; s < 2; ++s) {  // small terms first
              hopper::wgmma_m64n64k8_tf32_ra(acc[s], lo[s][kk], qh);
              hopper::wgmma_m64n64k8_tf32_ra(acc[s], hi[s][kk], ql);
              hopper::wgmma_m64n64k8_tf32_ra(acc[s], hi[s][kk], qh);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              keep_regs(hi[s][kk]);
              keep_regs(lo[s][kk]);
            }
        } else {
          hopper::fence_regs(acc[0]);
          hopper::fence_regs(acc[1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qd =
                hopper::make_desc(st + SC_D_BYTES + kk * 32, 16, 1024);
#pragma unroll
            for (int s = 0; s < 2; ++s)
              hopper::wgmma_m64n64k16_bf16(
                  acc[s],
                  hopper::make_desc(st + (cw * 128 + s * 64) * 128 + kk * 32,
                                    16, 1024),
                  qd);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
        }
        hopper::fence_regs(acc[0]);
        hopper::fence_regs(acc[1]);
        if (leader) hopper::mbar_arrive(&empty[stage]);
        if (++stage == SC_STAGES) { stage = 0; phase ^= 1; }
      }
      // scores: acc row = doc, column = query; S is (B, N)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = d0 + cw * 128 + s * 64 + warp * 16 + g + 8 * h;
          if (d >= N) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = q0 + 8 * j + 2 * t + e;
              if (q < B)
                S[static_cast<long long>(q) * N + d] =
                    acc[s][4 * j + 2 * h + e];
            }
        }
    }
  }
}

constexpr int SEL_THREADS = 256;
constexpr int SEL_BINS = 4096;  // 12 bits a round
constexpr int SEL_CAP = 2048;   // boundary keys sorted in shared memory

// The merge's key: signed order = (value descending, index ascending).
// High word: the value's bits with the magnitude flipped for negatives
// (signed order of those ints is the float order, -0 below +0 as
// lax.top_k orders them); low word: the complemented index.
__device__ __forceinline__ long long merge_key(float v, uint32_t idx) {
  const int32_t b = __float_as_int(v);
  const uint32_t hi = static_cast<uint32_t>(b < 0 ? (b ^ 0x7fffffff) : b);
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) |
                                (0xffffffffu - idx));
}

// f(i, x[i]) over i in [0, L) by this CTA: float4 loads, four in flight a
// thread, where x is 16-byte aligned.
template <typename F>
__device__ __forceinline__ void for_each_score(const float* __restrict__ x,
                                               int L, bool vec, F&& f) {
  int tail = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int L4 = L >> 2;
    int i = threadIdx.x;
    for (; i + 3 * SEL_THREADS < L4; i += 4 * SEL_THREADS) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(x4 + i + u * SEL_THREADS);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * (i + u * SEL_THREADS);
        f(j, v[u].x); f(j + 1, v[u].y); f(j + 2, v[u].z); f(j + 3, v[u].w);
      }
    }
    for (; i < L4; i += SEL_THREADS) {
      const float4 v = __ldg(x4 + i);
      f(4 * i, v.x); f(4 * i + 1, v.y); f(4 * i + 2, v.z); f(4 * i + 3, v.w);
    }
    tail = 4 * L4;
  }
  for (int j = tail + threadIdx.x; j < L; j += SEL_THREADS) f(j, __ldg(x + j));
}

// Where the top `take` of this CTA's `total` scores end, as order-
// preserving 32-bit keys (larger first; for_each(g) calls g(i, key) for
// this thread's share). A radix select, 12 + 12 + 8 bits from the top, each
// round a shared-memory histogram of the keys that match the bits fixed so
// far; it stops once the boundary bin holds at most SEL_CAP keys. Keys
// whose fixed bits (& mask) exceed prefix are in; of the cnt keys equal to
// it, the best `need` are in.
struct Boundary {
  uint32_t prefix, mask, need, cnt;
};

template <typename ForEach>
__device__ Boundary radix_boundary(ForEach&& for_each, uint32_t total,
                                   uint32_t take) {
  __shared__ uint32_t hist[SEL_BINS];
  __shared__ uint32_t part[SEL_THREADS];
  __shared__ uint32_t sh_bin, sh_above, sh_cnt;
  const int tid = threadIdx.x;
  Boundary bd = {0u, 0u, take, total};
  for (int hi = 32; hi > 0;) {
    const int width = hi < 12 ? hi : 12, shift = hi - width;
    const int nb = 1 << width;
    for (int i = tid; i < nb; i += SEL_THREADS) hist[i] = 0;
    __syncthreads();
    for_each([&](int, uint32_t u) {
      if ((u & bd.mask) == bd.prefix)
        atomicAdd(&hist[(u >> shift) & (nb - 1)], 1u);
    });
    __syncthreads();
    // thread tid sums the bins [top - per * (tid + 1), top - per * tid)
    const int per = nb > SEL_THREADS ? nb / SEL_THREADS : 1;
    const int top_bin = nb - 1 - tid * per;
    uint32_t local = 0;
    for (int j = 0; j < per && top_bin - j >= 0; ++j)
      local += hist[top_bin - j];
    part[tid] = local;
    __syncthreads();
    for (int off = 1; off < SEL_THREADS; off <<= 1) {
      const uint32_t v = tid >= off ? part[tid - off] : 0;
      __syncthreads();
      part[tid] += v;
      __syncthreads();
    }
    const uint32_t above = part[tid] - local;  // keys in the bins above
    if (above < bd.need && above + local >= bd.need) {
      uint32_t run = above;
      for (int j = 0; j < per; ++j) {
        const uint32_t h = hist[top_bin - j];
        if (run + h >= bd.need) {
          sh_bin = top_bin - j;
          sh_above = run;
          sh_cnt = h;
          break;
        }
        run += h;
      }
    }
    __syncthreads();
    bd.prefix |= sh_bin << shift;
    bd.mask |= static_cast<uint32_t>(nb - 1) << shift;
    bd.need -= sh_above;
    bd.cnt = sh_cnt;
    hi = shift;
    __syncthreads();
    if (bd.cnt <= SEL_CAP) break;
  }
  return bd;
}

// buf[0, n) sorted descending in place (bitonic; padded with zeros to a
// power of two <= SEL_CAP), by the whole CTA.
__device__ void sort_desc(unsigned long long* buf, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + threadIdx.x; i < P; i += SEL_THREADS) buf[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += SEL_THREADS) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const unsigned long long a = buf[i], b = buf[j];
        if ((a < b) == ((i & size) == 0)) { buf[i] = b; buf[j] = a; }
      }
      __syncthreads();
    }
  }
}

// One CTA per (segment, query row): the set of the segment's top-kk scores
// (value descending, lower index first) as merge keys in out[row][seg]
// [0, kk), in no particular order; slots past the segment's length hold
// INT64_MIN.
__global__ void __launch_bounds__(SEL_THREADS)
    topk_segments_kernel(const float* __restrict__ S, int N, int seg_len,
                         int nseg, int kk, long long* __restrict__ out) {
  __shared__ unsigned long long buf[SEL_CAP];
  __shared__ int n_greater, n_buf, wcount[SEL_THREADS / 32];
  const int tid = threadIdx.x, seg = blockIdx.x, row = blockIdx.y;
  const long long s0 = static_cast<long long>(seg) * seg_len;
  const int L = static_cast<int>(min(static_cast<long long>(seg_len), N - s0));
  const int take = min(kk, L);
  const float* srow = S + static_cast<long long>(row) * N;
  const float* x = srow + s0;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  long long* o = out + (static_cast<long long>(row) * nseg + seg) * kk;

  const Boundary bd = radix_boundary(
      [&](auto&& g) {
        for_each_score(x, L, vec, [&](int i, float v) { g(i, ord_key(v)); });
      },
      L, take);

  if (tid == 0) { n_greater = 0; n_buf = 0; }
  __syncthreads();
  const uint32_t prefix = bd.prefix, mask = bd.mask;
  const bool use_buf = bd.cnt <= SEL_CAP;
  for_each_score(x, L, vec, [&](int i, float v) {
    const uint32_t u = ord_key(v);
    const uint32_t idx = static_cast<uint32_t>(s0 + i);
    if ((u & mask) > prefix) {
      o[atomicAdd(&n_greater, 1)] = merge_key(v, idx);
    } else if (use_buf && (u & mask) == prefix) {
      buf[atomicAdd(&n_buf, 1)] =
          (static_cast<unsigned long long>(u) << 32) | (0xffffffffu - idx);
    }
  });
  __syncthreads();
  const int G = n_greater;  // == take - need
  if (use_buf) {
    // the boundary bin's keys, best first
    sort_desc(buf, n_buf);
    for (int i = tid; i < static_cast<int>(bd.need); i += SEL_THREADS) {
      const uint32_t idx = 0xffffffffu - static_cast<uint32_t>(buf[i]);
      o[G + i] = merge_key(srow[idx], idx);
    }
  } else {
    // more than SEL_CAP keys share the boundary value exactly: the lowest
    // indices first, by a block-wide ordered count
    const int warp = tid / 32, lane = tid % 32;
    uint32_t base = 0;
    for (int c0 = 0; c0 < L && base < bd.need; c0 += SEL_THREADS) {
      const int i = c0 + tid;
      const float v = i < L ? x[i] : 0.0f;
      const bool tie = i < L && ord_key(v) == prefix;
      const unsigned ballot = __ballot_sync(0xffffffffu, tie);
      if (lane == 0) wcount[warp] = __popc(ballot);
      __syncthreads();
      uint32_t before = base, total = base;
      for (int w = 0; w < SEL_THREADS / 32; ++w) {
        if (w < warp) before += wcount[w];
        total += wcount[w];
      }
      const uint32_t r = before + __popc(ballot & ((1u << lane) - 1u));
      if (tie && r < bd.need)
        o[G + r] = merge_key(v, static_cast<uint32_t>(s0 + i));
      __syncthreads();
      base = total;
    }
  }
  for (int i = take + tid; i < kk; i += SEL_THREADS)
    o[i] = static_cast<long long>(0x8000000000000000ull);
}

}  // namespace

// C entry point for int8 docs (doc_type 2), bound with ctypes. q: (B, D)
// bf16; docs (N, D) int8 with scales (N,) fp32 (fp32 and bf16 docs go
// through pnt_mips_topk_sets); cand: (B, N / block_n, kpb) int64 merge
// keys, each block's top k' of each query.
// Returns cudaGetLastError() after the launch (0 = success). Launches on
// `stream`; allocates nothing.
extern "C" int pnt_mips_topk(const void* q, const void* docs,
                             const void* scales, void* cand, int B, int N,
                             int D, int block_n, int kpb, int doc_type,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0 || D <= 0 || (D % 16) || block_n <= 0 ||
      (N % block_n) || kpb <= 0 || kpb > KMAX || kpb > block_n ||
      doc_type != DOC_I8 || scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, docs, static_cast<const float*>(scales),
                static_cast<long long*>(cand), B, N, D, block_n, kpb,
                static_cast<cudaStream_t>(stream));
}

// C entry point for fp32 and bf16 docs, bound with ctypes: scores (B, N)
// fp32 scratch = Q . docs^T, then the top-kk keys of every (query, segment
// of seg_len rows) into cand (B, nseg, kk) int64. doc_type 0: docs (N, D)
// fp32, q_hi / q_lo (B, D) fp32, the queries' tf32 high parts and
// residuals (3xTF32); doc_type 1: docs bf16, q_hi the queries in bf16,
// q_lo unused. Two launches on `stream`; allocates nothing. Returns 0 or a
// cudaError_t.
extern "C" int pnt_mips_topk_sets(const void* q_hi, const void* q_lo,
                                  const void* docs, void* scores, void* cand,
                                  int B, int N, int D, int seg_len, int nseg,
                                  int kk, int doc_type, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool f32 = doc_type == DOC_F32;
  if ((!f32 && doc_type != DOC_BF16) || B <= 0 || B > 65535 || N <= 0 ||
      D <= 0 || (D % 16) || seg_len <= 0 || nseg <= 0 ||
      static_cast<long long>(seg_len) * (nseg - 1) >= N ||
      static_cast<long long>(seg_len) * nseg < N || kk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type = f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int esize = f32 ? 4 : 2, bk = 128 / esize;
  CUtensorMap map_docs, map_qhi, map_qlo;
  int rc = hopper::make_map_2d(&map_docs, type, docs, D, N,
                               static_cast<uint64_t>(D) * esize, bk, SC_DOCS);
  if (!rc)
    rc = hopper::make_map_2d(&map_qhi, type, q_hi, D, B,
                             static_cast<uint64_t>(D) * esize, bk, SC_Q);
  if (!rc)  // bf16: an unused copy of the first
    rc = hopper::make_map_2d(&map_qlo, type, f32 ? q_lo : q_hi, D, B,
                             static_cast<uint64_t>(D) * esize, bk, SC_Q);
  if (rc) return rc;
  auto kernel = f32 ? mips_scores_kernel<true> : mips_scores_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = static_cast<long long>((N + SC_DOCS - 1) / SC_DOCS) *
                          ((B + SC_Q - 1) / SC_Q);
  const int grid = static_cast<int>(
      tiles < hopper::sm_count(device) ? tiles : hopper::sm_count(device));
  float* S = static_cast<float*>(scores);
  kernel<<<grid, SC_THREADS, SC_SMEM, s>>>(map_docs, map_qhi, map_qlo, S, B,
                                           N, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_segments_kernel<<<dim3(nseg, B), SEL_THREADS, 0, s>>>(
      S, N, seg_len, nseg, kk, static_cast<long long*>(cand));
  return static_cast<int>(cudaGetLastError());
}

