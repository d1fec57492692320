// Blockwise MIPS top-k for Hopper (sm_90a): for every doc block of block_n
// rows and every query, the top-k' inner products (ties to the lower doc
// index), written to the block's own candidate slots. The merge of the
// num_blocks * k' candidates is a stable sort outside the kernel.
//
// Replaces: the TPU kernels _mips_block_kernel / mips_topk_pallas (K5,
// pacednegatives_tpu/ops/mips.py:73-138) and _quant_block_kernel /
// mips_topk_pallas_quantized (K6, :151-210). Same blocks and the same k',
// so the same near-exact function when k' < k. The TPU kernel takes the
// per-block top-k' by k' rounds of max + first-argmax only because Mosaic
// has no sort (mips.py:9-12); here it is a real selection.
//
// Products by doc type: fp32 docs in full fp32 (SIMT FMA; single-pass TF32
// would change which docs win); bf16 docs as bf16 WMMA products with fp32
// accumulation against the queries rounded to bf16; int8 docs converted to
// bf16 in shared memory (exact: |v| <= 127), the same bf16 products, and
// the row's fp32 scale applied to the fp32 sum (not int8 x int8 IMMA,
// which would quantise the queries: another function).
//
// What bounds it: K6 at the online-mining scale (B 16 queries, 8.8M int8
// rows of 768) reads 6.8 GB for ~0.2 TFLOP of bf16 products: memory, ~2.0
// ms at 3.35 TB/s. K5 at the build_pools scale (B 64, 1M fp32 rows of 768,
// k' = 1000) is 98.7 GFLOP of fp32 FMA: compute, ~1.5 ms at 67 TFLOP/s.
//
// Design. One CTA of 8 warps per (doc block, tile of 16 queries), one
// launch for the whole grid; the query tiles of one block are neighbours
// in the grid, so their doc reads meet in L2. The CTA walks its block in
// chunks of 128 docs (a 16 x 4096 fp32 score tile would be 256 KB, above
// the 227 KB of shared memory): each chunk's 16 x 128 scores go to shared
// memory through D in slabs of 64, the next slab's loads kept in registers
// while the current one multiplies. Then each warp updates the running
// top-k' of its two query rows: a key packs (order-preserving value bits,
// ~index) into 64 bits, so "better" is one unsigned compare with the tie
// broken to the lower index; a threshold test against the row's k'-th key
// rejects most scores in one compare once the list is full; the survivors
// are compacted with a ballot, bitonic-sorted by the warp and merged into
// the sorted list in place (merge positions by binary search; list entries
// only move up, so moving them top-down in warp steps overwrites nothing
// unread). No atomics: each CTA writes only its own candidate slots, so
// results are bitwise repeatable.
// Not yet done (later work): TMA / cp.async rings, wgmma, 3xTF32 for fp32
// docs, splitting a block over CTAs when B is small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

template <int T> struct Traits;
template <> struct Traits<DOC_F32> {
  using Doc = float;
  using Op = float;  // operand type in shared memory
  static constexpr int LD = KS + 4;  // 68 words: float4 rows on distinct banks
};
template <> struct Traits<DOC_BF16> {
  using Doc = __nv_bfloat16;
  using Op = __nv_bfloat16;
  static constexpr int LD = KS + 8;  // 144-byte rows: 16-byte aligned
};
template <> struct Traits<DOC_I8> {
  using Doc = int8_t;
  using Op = __nv_bfloat16;
  static constexpr int LD = KS + 8;
};

template <int T>
constexpr size_t smem_bytes(int kpb) {
  using Op = typename Traits<T>::Op;
  return size_t(QT) * kpb * 8            // running lists
         + size_t(NWARPS) * CN * 8       // per-warp candidate buffer
         + size_t(QT) * S_LD * 4         // score tile
         + size_t(QT) * Traits<T>::LD * sizeof(Op)   // query slab
         + size_t(CN) * Traits<T>::LD * sizeof(Op);  // doc slab
}

// Order-preserving map of fp32 bits (larger value -> larger key), with the
// complemented index below it (lower index -> larger key). -0 is folded
// into +0 first, so equal values tie on the index as the TPU kernel's
// comparisons do.
__device__ __forceinline__ unsigned long long make_key(float v, unsigned idx) {
  if (v == 0.0f) v = 0.0f;
  unsigned bits = __float_as_uint(v);
  unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) | (~idx);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned ord = static_cast<unsigned>(key >> 32);
  unsigned bits = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  return __uint_as_float(bits);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(~static_cast<unsigned>(key & 0xffffffffull));
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

template <int T>
__global__ void __launch_bounds__(THREADS)
    mips_topk_kernel(const typename Traits<T>::Op* __restrict__ Q,
                     const typename Traits<T>::Doc* __restrict__ docs,
                     const float* __restrict__ scales,
                     float* __restrict__ cand_v, int* __restrict__ cand_i,
                     int B, int D, int block_n, int kpb, int n_qtiles) {
  using Doc = typename Traits<T>::Doc;
  using Op = typename Traits<T>::Op;
  constexpr int LD = Traits<T>::LD;
  constexpr int DVEC = 16 / sizeof(Doc);  // doc elements per 16-byte load
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
      if constexpr (T == DOC_I8) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&draw[i]);
        __align__(16) __nv_bfloat162 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __floats2bfloat162_rn(static_cast<float>(b[2 * e]),
                                       static_cast<float>(b[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(Ds + n * LD + kk);
        dst[0] = reinterpret_cast<const uint4*>(h)[0];
        dst[1] = reinterpret_cast<const uint4*>(h)[1];
      } else {
        *reinterpret_cast<uint4*>(Ds + n * LD + kk) = draw[i];
      }
    }
    if (tid < QLOADS)
      *reinterpret_cast<uint4*>(Qs + (tid / QPR) * LD + (tid % QPR) * QVEC) =
          qraw;
  };

  // fp32: thread -> doc column n of the chunk, query rows rg*8 .. rg*8+7
  const int fn = tid % CN, rg = tid / CN;
  float facc[QT * CN / THREADS];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> wacc;

  // per-warp running-list sizes of its rows (same value in every lane)
  int cnt[ROWS_PER_WARP];
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) cnt[j] = 0;
  unsigned long long* Cw = Cb + warp * CN;

  load_step(0);
  for (int step = 0; step < nsteps; ++step) {
    const int chunk = step / nslabs, slab = step % nslabs;
    if (slab == 0) {
      if constexpr (T == DOC_F32) {
#pragma unroll
        for (int r = 0; r < QT * CN / THREADS; ++r) facc[r] = 0.0f;
      } else {
        wmma::fill_fragment(wacc, 0.0f);
      }
    }
    store_step();
    __syncthreads();
    if (step + 1 < nsteps) load_step(step + 1);  // in flight during the products
    if constexpr (T == DOC_F32) {
#pragma unroll 4
      for (int kk = 0; kk < KS; kk += 4) {
        const float4 d = *reinterpret_cast<const float4*>(Ds + fn * LD + kk);
#pragma unroll
        for (int r = 0; r < QT * CN / THREADS; ++r) {
          const float4 q =
              *reinterpret_cast<const float4*>(Qs + (rg * 8 + r) * LD + kk);
          facc[r] = fmaf(q.x, d.x, facc[r]);
          facc[r] = fmaf(q.y, d.y, facc[r]);
          facc[r] = fmaf(q.z, d.z, facc[r]);
          facc[r] = fmaf(q.w, d.w, facc[r]);
        }
      }
    } else {
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
    }
    __syncthreads();  // the slab buffers are free for the next store
    if (slab != nslabs - 1) continue;

    // the chunk's 16 x 128 scores
    if constexpr (T == DOC_F32) {
#pragma unroll
      for (int r = 0; r < QT * CN / THREADS; ++r)
        S[(rg * 8 + r) * S_LD + fn] = facc[r];
    } else {
      wmma::store_matrix_sync(S + warp * 16, wacc, S_LD, wmma::mem_row_major);
    }
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
          if constexpr (T == DOC_I8) v *= __ldg(scales + doc0 + col);
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

  // the block's candidates: (num_blocks, B, k') slots of this CTA only
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const unsigned long long* Rr = R + size_t(r) * kpb;
    const long long out = (static_cast<long long>(blk) * B + q0 + r) * kpb;
    for (int i = tid; i < kpb; i += THREADS) {
      cand_v[out + i] = key_value(Rr[i]);
      cand_i[out + i] = key_index(Rr[i]);
    }
  }
}

template <int T>
int launch(const void* q, const void* docs, const float* scales, float* cv,
           int* ci, int B, int N, int D, int block_n, int kpb,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(kpb);
  cudaError_t err = cudaFuncSetAttribute(
      mips_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (B + QT - 1) / QT;
  const long long grid = static_cast<long long>(N / block_n) * n_qtiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mips_topk_kernel<T><<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(
      static_cast<const typename Traits<T>::Op*>(q),
      static_cast<const typename Traits<T>::Doc*>(docs), scales, cv, ci, B, D,
      block_n, kpb, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. q: (B, D) fp32 for fp32 docs, else bf16;
// docs (N, D) of doc_type 0 fp32 / 1 bf16 / 2 int8 (scales (N,) fp32 for
// int8, else unused); cand_v / cand_i: (N / block_n, B, kpb) fp32 / int32.
// Returns cudaGetLastError() after the launch (0 = success). Launches on
// `stream`; allocates nothing.
extern "C" int pnt_mips_topk(const void* q, const void* docs,
                             const void* scales, void* cand_v, void* cand_i,
                             int B, int N, int D, int block_n, int kpb,
                             int doc_type, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || N <= 0 || D <= 0 || (D % 16) || block_n <= 0 ||
      (N % block_n) || kpb <= 0 || kpb > KMAX || kpb > block_n ||
      (doc_type == DOC_I8 && scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  const float* sc = static_cast<const float*>(scales);
  switch (doc_type) {
    case DOC_F32:
      return launch<DOC_F32>(q, docs, sc, cv, ci, B, N, D, block_n, kpb, s);
    case DOC_BF16:
      return launch<DOC_BF16>(q, docs, sc, cv, ci, B, N, D, block_n, kpb, s);
    case DOC_I8:
      return launch<DOC_I8>(q, docs, sc, cv, ci, B, N, D, block_n, kpb, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
