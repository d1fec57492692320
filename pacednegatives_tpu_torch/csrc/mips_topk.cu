// MIPS top-k for Hopper (sm_90a): the blockwise top-k of K5 and K6.
//
// Replaces: the TPU kernels _mips_block_kernel / mips_topk_pallas (K5,
// pacednegatives_tpu/ops/mips.py:73-138) and _quant_block_kernel /
// mips_topk_pallas_quantized (K6, :151-210): for every doc block of
// block_n rows and every query, the top-k' inner products (ties to the
// lower doc index); the merge of the candidates sits outside the kernel, as
// lax.top_k sits outside pallas_call (mips.py:64-70). The TPU kernel takes
// the per-block top-k' by k' rounds of max + first-argmax only because
// Mosaic has no sort (mips.py:9-12); here it is a real selection. fp32,
// bf16 and int8 docs share one design, pnt_mips_topk_sets: a score pass,
// then a selection pass.
//
// What bounds it: the docs read once (K5 at the build_pools scale: B 64,
// 1M fp32 rows of 768, 3.08 GB, 0.92 ms at 3.35 TB/s; K6 at the online-
// mining scale: B 16, 8.8M int8 rows, 6.8 GB, 2.0 ms), if the products run
// on the tensor cores (98.7 GFLOP of fp32 FMA would be 1.5 ms at 67
// TFLOP/s), the int8 values are widened faster than they arrive, and the
// selection costs a few passes over the fp32 scores (B * N * 4 bytes: 257
// MB at K5's scale, 563 MB at K6's), not a sort of the survivors.
//   1. Scores (mips_scores_kernel): S[B, N] = Q . Docs^T, each doc row read
//      once. One persistent CTA per SM walks tiles of 256 docs x 64 queries
//      (hopper_pipeline.cuh): the producer warpgroup TMA-loads each tile's
//      doc box (256 rows x 128 bytes of D) and the queries' boxes into a
//      four-stage ring (128-byte swizzle); each of two consumer warpgroups
//      owns 128 of the docs as two m64 wgmma tiles against n64 queries,
//      fp32 accumulation.
//      fp32 docs: 3xTF32. The consumer reads its tf32 A fragments from the
//      swizzled doc box, splits each value into a tf32 high part and the
//      fp32 residual (x - hi) in registers, and issues m64n64k8 wgmmas
//      lo.q_hi + hi.q_lo + hi.q_hi (B = the queries' high and low parts,
//      split by the wrapper, K-major from shared memory). The dropped lo.lo
//      term and the residuals' tf32 rounding leave ~2^-21 relative per
//      product, far inside the fp32 summation tolerance the checks hold it
//      to.
//      bf16 docs: m64n64k16 bf16 wgmmas, both operands from shared memory,
//      against the queries rounded to bf16.
//      int8 docs: a stage holds 128 int8 values of each doc row (its 128
//      bytes) and two 64-column boxes of the bf16 queries. Each consumer
//      thread reads its A fragments' bytes from the swizzled box as two
//      16-byte loads a row and widens them in registers, four at a time,
//      exactly (i8x4_to_bf16x2: an xor, four byte permutes into fp32
//      2^23 + b + 128, four subtractions, two permutes that keep the upper
//      halves), then runs bf16 wgmmas with A from registers against the
//      queries rounded to bf16 (m64n16k16 when B <= 16, as in the online
//      step, else m64n64k16); each doc's fp32 scale multiplies its fp32
//      sums before the score is stored. Not int8 x int8 IMMA, which would
//      quantise the queries: another function. The reduction order along D
//      is permuted so that a thread's 16 fragment values of a 16-column
//      step are 4 consecutive bytes: the queries' columns are permuted the
//      same way (prep_queries_kernel), a sum over D in another order.
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
// No atomics that decide a result (the selection's shared-memory counters
// only place keys of a set), so the merged top-k repeats bitwise. Ties: -0
// is folded into +0 before values are compared inside a block or segment,
// as the TPU kernel's == comparisons do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_pipeline.cuh"

namespace {

enum { DOC_F32 = 0, DOC_BF16 = 1, DOC_I8 = 2 };

// Order-preserving map of fp32 bits (larger value -> larger key). -0 is
// folded into +0 first, so equal values tie on the index as the TPU
// kernel's comparisons do.
__device__ __forceinline__ uint32_t ord_key(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Four int8 values (one 32-bit word, bytes 0..3) as two bf16 pairs, exact:
// each byte b, offset to b + 128, becomes the low bits of the fp32 2^23 +
// b + 128; subtracting 2^23 + 128 leaves b, whose upper 16 bits are its
// bf16 (|b| <= 128 needs 8 significant bits). lo = bytes (0, 1), hi =
// bytes (2, 3), the lower byte in the low half.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.0f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// ---------------------------------------------------------------------------
// Scores, then a set selection per (query, segment)
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

// S[B, N] = Q . Docs^T, one 128-byte slice of each doc row (32 fp32, 64
// bf16 or 128 int8 values of D) a stage. DOC_F32: 3xTF32 with the doc
// operand split in registers and the queries' high and low parts from
// shared memory; DOC_BF16: bf16 products with both operands from shared
// memory; DOC_I8: the docs widened to bf16 in registers, the queries'
// two 64-column boxes (bf16, columns in the int8 order) from shared
// memory, each doc's sums times its scale. NQ: queries a tile (the wgmma's
// N): 64, or 16 for int8 docs and B <= 16 (the online step's 16 queries),
// which cuts the products to a quarter.
template <int kDoc, int NQ>
__global__ void __launch_bounds__(SC_THREADS, 1)
    mips_scores_kernel(const __grid_constant__ CUtensorMap map_docs,
                       const __grid_constant__ CUtensorMap map_qhi,
                       const __grid_constant__ CUtensorMap map_qlo,
                       const float* __restrict__ scales,
                       float* __restrict__ S, int B, int N, int D) {
  constexpr bool kF32 = kDoc == DOC_F32, kI8 = kDoc == DOC_I8;
  constexpr int BK = kF32 ? 32 : kI8 ? 128 : 64;  // elements of D a stage
  static_assert(NQ == 64 || (kI8 && NQ == 16), "n16 tiles: int8 only");
  constexpr int STAGE_TX = SC_D_BYTES + (kF32 || kI8 ? 2 : 1) * NQ * 128;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned for the 128-byte swizzle (an offset from the shared
  // array, so that the fragment reads stay shared loads)
  unsigned char* smem =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SC_STAGES * SC_STAGE);
  uint64_t* empty = full + SC_STAGES;

  const int tiles_q = (B + NQ - 1) / NQ;
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
        const int q0 = (tile % tiles_q) * NQ;
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
          if (kI8)  // the queries' second 64 columns of this stage
            hopper::tma_load_2d(st + SC_D_BYTES + SC_Q_BYTES, &map_qhi,
                                &full[stage], kb * BK + 64, q0);
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
    float acc[2][NQ / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int d0 = (tile / tiles_q) * SC_DOCS;
      const int q0 = (tile % tiles_q) * NQ;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) acc[s][i] = 0.0f;
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
              hopper::keep_regs(hi[s][kk]);
              hopper::keep_regs(lo[s][kk]);
            }
        } else if constexpr (kI8) {
          // A fragments (m16n8k16 bf16 layout per warp) from the swizzled
          // int8 box: row r's bytes 32t .. 32t + 31 (16-byte chunks 2t and
          // 2t + 1) hold this thread's four values of each of the stage's
          // eight 16-column steps, in the wrapper's column order (word kk
          // of the 32 bytes = step kk: bytes 0, 1 -> columns 2t, 2t + 1;
          // bytes 2, 3 -> columns 2t + 8, 2t + 9)
          uint32_t a[2][8][4];
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = cw * 128 + s * 64 + warp * 16 + g + 8 * h;
              const unsigned char* row = st + r * 128;
              const uint4 v0 = *reinterpret_cast<const uint4*>(
                  row + (((2 * t) ^ (r & 7)) << 4));
              const uint4 v1 = *reinterpret_cast<const uint4*>(
                  row + (((2 * t + 1) ^ (r & 7)) << 4));
              const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w,
                                     v1.x, v1.y, v1.z, v1.w};
#pragma unroll
              for (int kk = 0; kk < 8; ++kk)
                i8x4_to_bf16x2(w[kk], a[s][kk][h], a[s][kk][2 + h]);
            }
          hopper::fence_regs(acc[0]);
          hopper::fence_regs(acc[1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const uint64_t qd = hopper::make_desc(
                st + SC_D_BYTES + (kk / 4) * SC_Q_BYTES + (kk % 4) * 32, 16,
                1024);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              if constexpr (NQ == 16)
                hopper::wgmma_m64n16k16_bf16_ra<0>(acc[s], a[s][kk], qd);
              else
                hopper::wgmma_m64n64k16_bf16_ra<0>(acc[s], a[s][kk], qd);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) hopper::keep_regs(a[s][kk]);
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
          const float scale = kI8 ? __ldg(scales + d) : 1.0f;
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = q0 + 8 * j + 2 * t + e;
              const float v = acc[s][4 * j + 2 * h + e];
              if (q < B)
                S[static_cast<long long>(q) * N + d] = kI8 ? v * scale : v;
            }
        }
    }
  }
}

// The queries as the score kernel reads them, from fp32 (B, D): DOC_F32:
// q_hi = the tf32 high parts (rounded to the nearest, ties away), q_lo =
// the residuals, both fp32 (B, D); DOC_BF16: q_hi = bf16 (B, D), rounded
// to the nearest even; DOC_I8: q_hi = bf16 (B, qcols), qcols = D rounded
// up to 128, zero-padded, each 128 columns in the int8 fragments' order:
// position 16 kk + 2 t + e + 8 f holds column 32 t + 4 kk + 2 f + e (kk
// the 16-column step, t a lane's place in its quad, e and f the halves of
// its A fragment), so a lane's values of all eight steps are 32
// consecutive bytes of a doc row.
template <int kDoc>
__global__ void prep_queries_kernel(const float* __restrict__ q, int B,
                                    int D, int qcols, void* __restrict__ q_hi,
                                    float* __restrict__ q_lo) {
  const long long n = static_cast<long long>(B) * qcols;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i / qcols;
    const int p = static_cast<int>(i % qcols);
    if constexpr (kDoc == DOC_F32) {
      const float x = q[b * D + p];
      const float hi = __uint_as_float(hopper::to_tf32(x));
      static_cast<float*>(q_hi)[i] = hi;
      q_lo[i] = x - hi;
    } else {
      int col = p;
      if constexpr (kDoc == DOC_I8) {
        const int r = p % 128, kk = r / 16, f = (r / 8) % 2, t = (r % 8) / 2,
                  e = r % 2;
        col = p - r + 32 * t + 4 * kk + 2 * f + e;
      }
      static_cast<__nv_bfloat16*>(q_hi)[i] =
          __float2bfloat16_rn(col < D ? q[b * D + col] : 0.0f);
    }
  }
}

// The merge's keys back to (fp32 value, int64 index): the inverse of
// merge_key.
__global__ void unpack_keys_kernel(const long long* __restrict__ keys,
                                   long long n, float* __restrict__ values,
                                   long long* __restrict__ indices) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long key = keys[i];
    const int32_t hi = static_cast<int32_t>(key >> 32);
    values[i] = __int_as_float(hi < 0 ? (hi ^ 0x7fffffff) : hi);
    indices[i] = 0xffffffffLL - (key & 0xffffffffLL);
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

// C entry point, bound with ctypes: the queries prepared into q_hi /
// q_lo (scratch), scores (B, N) fp32 scratch = Q . docs^T, then the top-kk
// keys of every (query, segment of seg_len rows) into cand (B, nseg, kk)
// int64. q: (B, D) fp32. doc_type 0: docs (N, D) fp32, q_hi and q_lo
// (B, D) fp32, the queries' tf32 high parts and residuals (3xTF32);
// doc_type 1: docs bf16, q_hi (B, D) bf16; doc_type 2: docs int8 with
// scales (N,) fp32, q_hi (B, 128 * ceil(D / 128)) bf16 (prep_queries_kernel
// says what they hold). q_lo unused but for fp32, scales but for int8.
// Three launches on `stream`; allocates nothing. Returns 0 or a
// cudaError_t.
extern "C" int pnt_mips_topk_sets(const void* q, void* q_hi, void* q_lo,
                                  const void* docs, const void* scales,
                                  void* scores, void* cand, int B, int N,
                                  int D, int seg_len, int nseg, int kk,
                                  int doc_type, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool f32 = doc_type == DOC_F32, i8 = doc_type == DOC_I8;
  if ((!f32 && !i8 && doc_type != DOC_BF16) || (i8 && scales == nullptr) ||
      (f32 && q_lo == nullptr) || B <= 0 || B > 65535 || N <= 0 || D <= 0 ||
      (D % 16) || seg_len <= 0 || nseg <= 0 ||
      static_cast<long long>(seg_len) * (nseg - 1) >= N ||
      static_cast<long long>(seg_len) * nseg < N || kk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType qtype = f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType dtype = i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : qtype;
  const int dsize = f32 ? 4 : i8 ? 1 : 2, qsize = f32 ? 4 : 2;
  const int qcols = i8 ? (D + 127) / 128 * 128 : D;
  const int nq = i8 && B <= 16 ? 16 : 64;  // queries a score tile
  CUtensorMap map_docs, map_qhi, map_qlo;
  int rc = hopper::make_map_2d(&map_docs, dtype, docs, D, N,
                               static_cast<uint64_t>(D) * dsize, 128 / dsize,
                               SC_DOCS);
  if (!rc)
    rc = hopper::make_map_2d(&map_qhi, qtype, q_hi, qcols, B,
                             static_cast<uint64_t>(qcols) * qsize,
                             128 / qsize, nq);
  if (!rc)  // bf16 and int8: an unused copy of the first
    rc = hopper::make_map_2d(&map_qlo, qtype, f32 ? q_lo : q_hi, qcols, B,
                             static_cast<uint64_t>(qcols) * qsize,
                             128 / qsize, nq);
  if (rc) return rc;
  auto kernel = f32       ? mips_scores_kernel<DOC_F32, 64>
                : nq == 16 ? mips_scores_kernel<DOC_I8, 16>
                : i8       ? mips_scores_kernel<DOC_I8, 64>
                           : mips_scores_kernel<DOC_BF16, 64>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* lo = static_cast<float*>(q_lo);
  const int prep_blocks = static_cast<int>(
      (static_cast<long long>(B) * qcols + 255) / 256 < 1024
          ? (static_cast<long long>(B) * qcols + 255) / 256
          : 1024);
  if (f32)
    prep_queries_kernel<DOC_F32><<<prep_blocks, 256, 0, s>>>(qf, B, D, qcols,
                                                             q_hi, lo);
  else if (i8)
    prep_queries_kernel<DOC_I8><<<prep_blocks, 256, 0, s>>>(qf, B, D, qcols,
                                                            q_hi, lo);
  else
    prep_queries_kernel<DOC_BF16><<<prep_blocks, 256, 0, s>>>(qf, B, D, qcols,
                                                              q_hi, lo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((N + SC_DOCS - 1) / SC_DOCS) *
                          ((B + nq - 1) / nq);
  const int grid = static_cast<int>(
      tiles < hopper::sm_count(device) ? tiles : hopper::sm_count(device));
  float* S = static_cast<float*>(scores);
  kernel<<<grid, SC_THREADS, SC_SMEM, s>>>(map_docs, map_qhi, map_qlo,
                                           static_cast<const float*>(scales),
                                           S, B, N, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_segments_kernel<<<dim3(nseg, B), SEL_THREADS, 0, s>>>(
      S, N, seg_len, nseg, kk, static_cast<long long*>(cand));
  return static_cast<int>(cudaGetLastError());
}

// C entry point, bound with ctypes: n packed merge keys (int64) -> values
// (fp32) and indices (int64). One launch on `stream`. Returns 0 or a
// cudaError_t.
extern "C" int pnt_mips_unpack_keys(const void* keys, void* values,
                                    void* indices, long long n, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n + 255) / 256 < 1024 ? (n + 255) / 256
                                                             : 1024);
  unpack_keys_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<float*>(values),
      static_cast<long long*>(indices));
  return static_cast<int>(cudaGetLastError());
}
