// The embedding lookup's backward for Hopper (sm_90a): a segmented sum.
//
// Replaces: no TPU kernel. The JAX package looks rows up with an XLA
// gather (emb[input_ids], pacednegatives_tpu/models/t5.py:1368) and XLA
// emits its transpose. In the port the same gradient, through autograd on
// table[ids], was aten's index_put_(accumulate=True): a sort of the ids,
// then one warp per run of equal ids that adds the run's rows one after
// another, reading and writing the table row in its own dtype (bf16) at
// every add. A step at L 188 holds a run of ~50k pad ids and runs of 512
// template ids, so that kernel was a few long chains of dependent
// read-add-write operations (57 ms a 512-row t5-base step on an H100).
//
// The function: dtable[v] = sum of g[j] over the positions j with ids[j] ==
// v, summed in fp32 and rounded to the table's dtype once; 0 where no id
// is v. The ids are first sorted with their positions (cub's radix sort
// over the bits that hold the vocab: two passes of 8 bits at 32,128 rows;
// stable, so positions ascend within a run), which fixes the order of every
// sum: the result is the same bits from call to call. No float atomics.
//
// What bounds it: bytes. g is read once (N x D), the table written once
// (V x D): at a t5-base step's encoder lookup (N 96,256, D 768, V 32,128,
// bf16) 147.9 + 49.3 MB, 0.059 ms at 3.35 TB/s. The only arithmetic is one
// fp32 add per element read.
//
// Why tiles: the work of a run is its length, and one run may hold half of
// all ids. So the sorted list is cut into fixed tiles (of 256 entries at
// a training step's 96,256 ids; fewer for few ids, so that pass 1 still
// fills the card), whatever the runs, and every grid is sized from N, V
// and the tile, which the host knows: nothing is read back (no unique
// count, no sync).
//   1. embed_grad_tiles_kernel, one CTA a tile: each thread owns VEC
//      columns (16-byte loads: 8 bf16) and walks the tile's entries in
//      order, adding each entry's row into fp32 registers (the loads of
//      kUnroll entries issued before their adds). At the end of each piece
//      (the part of a run inside the tile): a run wholly inside the tile
//      is complete, and its row is written in the table's dtype; the
//      tile's first piece, if its run began in an earlier tile, goes to
//      the tile's fp32 "head" partial; its last piece, if its run goes on
//      into the next tile (and it is not that head), to its "tail"
//      partial. The CTA also records each run's first and end entry by id
//      (run_lo, run_hi). A run of 50k ids is thus summed by hundreds of
//      CTAs at once.
//   2. embed_grad_rows_kernel, kRows rows a CTA, one thread resolving
//      each: a row whose run_lo does not point at the first entry of a run
//      of its own id (so no scratch needs clearing) has no ids and is
//      written as zeros, by all threads at once; a run inside one tile was
//      written by pass 1; a run over tiles t0..t1 is tail[t0] + head[t0+1]
//      + ... + head[t1], which the CTA's warps sum in contiguous slices,
//      in tile order, with two pieces' loads in flight, then add in warp
//      order through shared memory, and the row is written once in the
//      table's dtype. Every row of the table is written by exactly one of
//      the passes: no memset.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTile = 256;  // sorted entries a CTA of pass 1 sums, at most
constexpr int kPass1Ctas = 3 * 132;  // about three on each of an H100's SMs
constexpr int kUnroll = 8;     // entries whose loads are in flight a thread
constexpr int kRows = 32;      // rows a CTA of pass 2
constexpr int kWarps = 8;      // pass 2's warps
constexpr int kChunk = 512;    // columns pass 2 reduces at a time
constexpr size_t kAlign = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// VEC elements in one load: 16 bytes when VEC * sizeof(T) == 16.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* acc) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = acc[k];
  }
}

// The sort's input: each id as an unsigned key (an id outside [0, vocab)
// becomes vocab, which sorts after every row and is skipped), and its
// position.
template <typename I>
__global__ void embed_grad_keys_kernel(const I* __restrict__ ids, int n,
                                       int vocab, uint32_t* __restrict__ keys,
                                       int* __restrict__ pos) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const long long id = static_cast<long long>(ids[j]);
    keys[j] = (id >= 0 && id < vocab) ? static_cast<uint32_t>(id)
                                      : static_cast<uint32_t>(vocab);
    pos[j] = j;
  }
}

// Pass 1: one CTA a tile of the sorted entries.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) embed_grad_tiles_kernel(
    const T* __restrict__ g, const uint32_t* __restrict__ ids,
    const int* __restrict__ order, int n, int d, int vocab, int tile,
    T* __restrict__ out, int* __restrict__ run_lo, int* __restrict__ run_hi,
    float* __restrict__ partial) {
  __shared__ int s_id[kMaxTile];
  __shared__ long long s_row[kMaxTile];  // the entry's row offset in g
  const int a = blockIdx.x * tile;
  const int len = min(tile, n - a);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int j = a + i;
    const int id = static_cast<int>(ids[j]);
    s_id[i] = id;
    s_row[i] = order[j] * static_cast<long long>(d);
    if (id < vocab) {
      if (j == 0 || ids[j - 1] != ids[j]) run_lo[id] = j;
      if (j == n - 1 || ids[j + 1] != ids[j]) run_hi[id] = j + 1;
    }
  }
  // the tile's first run began in an earlier tile / its last goes on
  const bool cont_prev = a > 0 && ids[a - 1] == ids[a];
  const bool cont_next = a + len < n && ids[a + len] == ids[a + len - 1];
  __syncthreads();
  float* head = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  float* tail = head + d;
  const int nvec = d / VEC;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    const int col = c * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int start = 0;  // the current piece's first entry in the tile
    for (int i0 = 0; i0 < len; i0 += kUnroll) {
      Vec<T, VEC> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u < len)
          x[u] = *reinterpret_cast<const Vec<T, VEC>*>(g + s_row[i0 + u] +
                                                        col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u;
        if (i >= len) break;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += to_f32(x[u].v[k]);
        if (i == len - 1 || s_id[i + 1] != s_id[i]) {
          const bool is_head = start == 0 && cont_prev;
          if (is_head) {
            store_f32<VEC>(head + col, acc);
          } else if (i == len - 1 && cont_next) {
            store_f32<VEC>(tail + col, acc);
          } else if (s_id[i] < vocab) {
            Vec<T, VEC> y;
#pragma unroll
            for (int k = 0; k < VEC; ++k) y.v[k] = from_f32<T>(acc[k]);
            *reinterpret_cast<Vec<T, VEC>*>(
                out + static_cast<size_t>(s_id[i]) * d + col) = y;
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
          start = i + 1;
        }
      }
    }
  }
}

// Pass 2's sum of one spanning row's pieces over columns [c0, c0 + width):
// each warp its contiguous slice of the pieces in tile order, PV floats a
// load, two pieces' loads in flight; then the warps' sums in warp order.
template <typename T, int PV>
__device__ __forceinline__ void reduce_pieces(const float* __restrict__ partial,
                                              int d, int t0, int np, int c0,
                                              int width, T* __restrict__ row,
                                              float (*red)[kChunk]) {
  constexpr int J = kChunk / (32 * PV);
  using P = Vec<float, PV>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p_end = (warp + 1) * np / kWarps;
  float acc[J][PV];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < PV; ++k) acc[j][k] = 0.f;
  // piece 0 is tile t0's tail, piece p > 0 tile t0 + p's head
  auto piece = [&](int p) {
    return partial + (static_cast<size_t>(t0 + p) * 2 + (p == 0)) * d + c0;
  };
  int p = warp * np / kWarps;
  for (; p + 1 < p_end; p += 2) {
    const float* s0 = piece(p);
    const float* s1 = piece(p + 1);
    P x0[J], x1[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = (lane + 32 * j) * PV;
      if (col < width) {
        x0[j] = *reinterpret_cast<const P*>(s0 + col);
        x1[j] = *reinterpret_cast<const P*>(s1 + col);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < PV; ++k) acc[j][k] = (acc[j][k] + x0[j].v[k]) +
                                               x1[j].v[k];
  }
  if (p < p_end) {
    const float* s0 = piece(p);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = (lane + 32 * j) * PV;
      if (col < width) {
        const P x = *reinterpret_cast<const P*>(s0 + col);
#pragma unroll
        for (int k = 0; k < PV; ++k) acc[j][k] += x.v[k];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = (lane + 32 * j) * PV;
    if (col < width)
#pragma unroll
      for (int k = 0; k < PV; ++k) red[warp][col + k] = acc[j][k];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float s = red[0][col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][col];
    row[c0 + col] = from_f32<T>(s);
  }
  __syncthreads();
}

// Pass 2: every row not written by pass 1, kRows rows a CTA.
template <typename T, int VEC, int PV>
__global__ void __launch_bounds__(kWarps * 32) embed_grad_rows_kernel(
    const uint32_t* __restrict__ ids, int n, int d, int vocab, int tile,
    const int* __restrict__ run_lo, const int* __restrict__ run_hi,
    const float* __restrict__ partial, T* __restrict__ out) {
  __shared__ int s_np[kRows];     // -1: pass 1 wrote it; 0: zeros; else pieces
  __shared__ int s_first[kRows];  // the first piece's tile
  __shared__ float red[kWarps][kChunk];
  const int v0 = blockIdx.x * kRows;
  if (threadIdx.x < kRows) {
    const int v = v0 + threadIdx.x;
    int np = -1, first = 0;
    if (v < vocab) {
      // run_lo is not cleared: trust it only if it points at the first
      // entry of a run of v
      const int lo = run_lo[v];
      const bool present =
          lo >= 0 && lo < n && ids[lo] == static_cast<uint32_t>(v) &&
          (lo == 0 || ids[lo - 1] != static_cast<uint32_t>(v));
      if (!present) {
        np = 0;
      } else {
        const int t0 = lo / tile, t1 = (run_hi[v] - 1) / tile;
        if (t1 > t0) {
          np = t1 - t0 + 1;
          first = t0;
        }
      }
    }
    s_np[threadIdx.x] = np;
    s_first[threadIdx.x] = first;
  }
  __syncthreads();
  const int nvec = d / VEC;
  Vec<T, VEC> z;
#pragma unroll
  for (int k = 0; k < VEC; ++k) z.v[k] = from_f32<T>(0.f);
  for (int f = threadIdx.x; f < kRows * nvec; f += blockDim.x) {
    const int r = f / nvec;
    if (s_np[r] == 0)
      reinterpret_cast<Vec<T, VEC>*>(out + static_cast<size_t>(v0 + r) * d)
          [f - r * nvec] = z;
  }
  for (int r = 0; r < kRows; ++r) {
    const int np = s_np[r];
    if (np <= 0) continue;
    T* row = out + static_cast<size_t>(v0 + r) * d;
    for (int c0 = 0; c0 < d; c0 += kChunk)
      reduce_pieces<T, PV>(partial, d, s_first[r], np, c0,
                           min(kChunk, d - c0), row, red);
  }
}

size_t align_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

// The tile: enough CTAs in pass 1 to fill the card (a decoder's few ids
// in tiles of 32), at most kMaxTile, so that a long run splits into few
// pieces.
int tile_for(int n) {
  const int t = ((n + kPass1Ctas - 1) / kPass1Ctas + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxTile ? kMaxTile : t);
}

int key_bits(int vocab) {  // bits that hold 0..vocab (vocab: a bad id)
  int b = 1;
  while ((1ll << b) <= vocab) ++b;
  return b;
}

// The scratch: keys and positions in, sorted, run bounds, partials, the
// sort's own storage; each part 256-byte aligned.
struct Scratch {
  int tile;
  uint32_t *keys_in, *keys;
  int *pos_in, *pos, *run_lo, *run_hi;
  float* partial;
  void* sort;
  size_t sort_bytes, total;
};

Scratch carve(char* base, int n, int d, int vocab) {
  Scratch s{};
  s.tile = tile_for(n);
  const int tiles = n > 0 ? (n + s.tile - 1) / s.tile : 1;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align_up(bytes);
    return p;
  };
  s.keys_in = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * n));
  s.keys = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * n));
  s.pos_in = reinterpret_cast<int*>(take(sizeof(int) * n));
  s.pos = reinterpret_cast<int*>(take(sizeof(int) * n));
  s.run_lo = reinterpret_cast<int*>(take(sizeof(int) * vocab));
  s.run_hi = reinterpret_cast<int*>(take(sizeof(int) * vocab));
  s.partial = reinterpret_cast<float*>(take(sizeof(float) * tiles * 2 * d));
  s.sort_bytes = 0;
  if (n > 0)
    cub::DeviceRadixSort::SortPairs(nullptr, s.sort_bytes, s.keys_in, s.keys,
                                    s.pos_in, s.pos, n, 0, key_bits(vocab));
  s.sort = take(s.sort_bytes);
  s.total = off;
  return s;
}

// VEC: g's elements a 16-byte load (1: the scalar path, any D); PV: the
// partials' floats a load in pass 2.
template <typename T, int VEC, int PV>
cudaError_t launch_passes(const void* g, const Scratch& s, void* out, int n,
                          int d, int vocab, cudaStream_t stream) {
  if (n > 0) {
    const int nvec = d / VEC;
    int threads = (nvec + 31) / 32 * 32;
    threads = threads < 256 ? threads : 256;
    embed_grad_tiles_kernel<T, VEC><<<(n + s.tile - 1) / s.tile, threads, 0,
                                      stream>>>(
        static_cast<const T*>(g), s.keys, s.pos, n, d, vocab, s.tile,
        static_cast<T*>(out), s.run_lo, s.run_hi, s.partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  embed_grad_rows_kernel<T, VEC, PV><<<(vocab + kRows - 1) / kRows,
                                       kWarps * 32, 0, stream>>>(
      s.keys, n, d, vocab, s.tile, s.run_lo, s.run_hi, s.partial,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* g, const Scratch& s, void* out, int n,
                         int d, int vocab, bool vec, cudaStream_t stream) {
  if (vec)
    return launch_passes<T, static_cast<int>(16 / sizeof(T)), 4>(
        g, s, out, n, d, vocab, stream);
  return launch_passes<T, 1, 1>(g, s, out, n, d, vocab, stream);
}

}  // namespace

// Bytes of scratch pnt_embed_grad needs for n ids, rows of d, vocab rows.
extern "C" int pnt_embed_grad_scratch(int n, int d, int vocab,
                                      long long* bytes) {
  if (n < 0 || d <= 0 || vocab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *bytes = static_cast<long long>(carve(nullptr, n, d, vocab).total);
  return 0;
}

// g (n, d) contiguous, bf16 (dtype 0) or fp32 (1); ids (n,) int32
// (ids_bytes 4) or int64 (8), in g's row order; out (vocab, d), g's dtype;
// scratch: pnt_embed_grad_scratch's bytes, 256-byte aligned, not cleared.
// vec: g's pointer is 16-byte aligned and d a multiple of 16 bytes'
// elements.
extern "C" int pnt_embed_grad(const void* g, const void* ids, int ids_bytes,
                              void* out, void* scratch, int n, int d,
                              int vocab, int dtype, int vec, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || d <= 0 || vocab <= 0 || (ids_bytes != 4 && ids_bytes != 8) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s = carve(static_cast<char*>(scratch), n, d, vocab);
  if (n > 0) {
    const int blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
    if (ids_bytes == 4)
      embed_grad_keys_kernel<<<blocks, 256, 0, st>>>(
          static_cast<const int*>(ids), n, vocab, s.keys_in, s.pos_in);
    else
      embed_grad_keys_kernel<<<blocks, 256, 0, st>>>(
          static_cast<const long long*>(ids), n, vocab, s.keys_in, s.pos_in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // stable: positions ascend within a run, so every sum has one order
    err = cub::DeviceRadixSort::SortPairs(s.sort, s.sort_bytes, s.keys_in,
                                          s.keys, s.pos_in, s.pos, n, 0,
                                          key_bits(vocab), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = dtype == 0 ? launch_typed<__nv_bfloat16>(g, s, out, n, d, vocab,
                                                 vec != 0, st)
                   : launch_typed<float>(g, s, out, n, d, vocab, vec != 0,
                                         st);
  return static_cast<int>(err);
}
