// Row-stream matmul for Hopper (sm_90a): out (m, n) = x (m, k) @ w (k, n),
// accumulated in fp32 and cast to x's dtype.
//
// Replaces the Pallas TPU kernel `rowstream_matmul`
// (src/repro/kernels/rowstream_matmul/kernel.py). On the decode path m is
// the slot count (1..8), so the product does 2*m flops per weight element
// and is bound by the bytes of the weight: the design streams w once, in
// runs of whole 4 KB DRAM rows, keeps enough of them in flight, and adds
// no other traffic to device memory. The wrapper (kernel.py) plans the grid.
//
// 1. One launch, nothing allocated per call but the output. w is cut into
//    column tiles: 4096 bytes of every row where a row is wider (so a row
//    segment is one 4 KB row; the last tile may be narrower), else the full
//    width. A tile's K rows are split over blocks; the blocks of one
//    thread-block cluster (<= 8) take consecutive splits of one tile. Grid
//    (cluster, clusters of every tile, tiles of MT rows of x). After one
//    cluster barrier each block adds, in rank order, the partial sums its
//    peers pushed into its shared memory through distributed shared memory
//    for the columns it owns. Where a tile has several clusters, each
//    writes its sum to an fp32 workspace (the plan keeps it at most 1/16 of
//    the weight's bytes) and the last cluster to arrive, told by an arrival
//    counter per owned column slice that it resets itself, adds the
//    clusters' sums in cluster order. No atomics in the sums: the result
//    does not depend on the order blocks run in; two calls give the same
//    bits.
// 2. Whole-row runs, copied asynchronously. A block streams its K rows of
//    the tile in 16 KB stages: four 4 KB row segments of a full tile, or a
//    contiguous run of full-width rows where a row is narrower (its splits
//    are whole 4 KB rows where the row width divides 4096). Stages come by
//    16-byte cp.async (L1 bypassed) into a ring of 2 in shared memory: both
//    are in flight until the first lands, then one while the other is
//    computed. On an H100 80GB HBM3 at 700 W, 32 KB in flight a block
//    streamed faster than 48 or 64 KB (PERF.md): with more in flight the
//    blocks' shares of HBM grew more unequal, and the slowest block sets
//    the time.
// 3. Balanced by bytes. The plan gives every block about the same weight
//    bytes (a narrower last tile takes proportionally more rows) and fits
//    the grid in one wave, so no block waits for another's slot.
// 4. Threads. Each thread owns one 16-byte column chunk (8 bf16 or 4 fp32
//    columns) of the tile for MT <= 8 rows of x, with fp32 accumulators in
//    registers. Where a row of the tile has fewer chunks than the block has
//    threads, the threads cover several rows of a stage (row phases) and
//    the block adds its phases in shared memory, in order, before the
//    cluster sum. The block's slice of x is staged in shared memory once,
//    in x's dtype, K-major, so a thread reads a row's MT values in one
//    load. CUDA cores suffice: at m = 4 a bf16 byte of w takes 4 flops, and
//    leaving the arithmetic out saves 1-8 % of a product's time on an H100
//    (PERF.md).
// 5. m > 8 takes several tiles of MT = 8 rows of x (grid z), each of which
//    streams w again: a block's fp32 sums for more rows of a 2048-column
//    tile would not fit its registers. The decode path runs m = slots <= 8.
// 6. Where a row of w is not a whole number of 16-byte chunks, or w is off
//    16-byte alignment, `rowstream_scalar` runs instead: one thread per
//    column over all of K.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;                           // bytes per cp.async
constexpr int STAGE_BYTES = 16384;                  // four 4 KB rows
constexpr int STAGE_CHUNKS = STAGE_BYTES / CHUNK;
constexpr int STAGES = 2;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int COPIES = STAGE_CHUNKS / THREADS;      // per thread per stage
constexpr int MAX_CLUSTER = 8;
constexpr int LOADS = 8;    // workspace loads in flight per thread

// One product's plan (kernel.py `Plan`); recv_bytes is set here.
struct Params {
  const void* x;
  const void* w;
  void* out;
  float* ws;       // (z, groups, MT, n) fp32 where groups > 1
  int* counters;   // (z, tiles + 1, cluster) arrivals, zero between calls
  int m, k, n;
  int cluster;     // blocks per cluster
  int tiles;       // full column tiles
  int cols;        // columns of a full tile
  int groups;      // clusters per full tile
  int cols_r;      // columns of the last, narrower tile (0: none)
  int groups_r;    // clusters of the last tile
  int granule;     // rows per split unit
  int recv_bytes;  // the cluster sum's receive region
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A cluster barrier split in two: every block arrives as it starts and
// waits just before its first write into a peer's shared memory, so no
// block writes into one that has not started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// bf16 pairs of a 32-bit word as fp32 (element 0 in the low half).
__device__ __forceinline__ void unpack2(unsigned v, float& a, float& b) {
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}

// A 16-byte chunk of w from shared memory as fp32.
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  unpack2(u.x, f[0], f[1]);
  unpack2(u.y, f[2], f[3]);
  unpack2(u.z, f[4], f[5]);
  unpack2(u.w, f[6], f[7]);
}
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}

// The MT values of one K row of the staged x (MT * sizeof(T) bytes,
// aligned to that size).
template <int MT>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&f)[MT]) {
  if constexpr (MT == 1) {
    f[0] = __bfloat162float(p[0]);
  } else if constexpr (MT == 2) {
    unpack2(*reinterpret_cast<const unsigned*>(p), f[0], f[1]);
  } else if constexpr (MT == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, f[0], f[1]);
    unpack2(u.y, f[2], f[3]);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack2(u.x, f[0], f[1]);
    unpack2(u.y, f[2], f[3]);
    unpack2(u.z, f[4], f[5]);
    unpack2(u.w, f[6], f[7]);
  }
}
template <int MT>
__device__ __forceinline__ void load_x(const float* p, float (&f)[MT]) {
  if constexpr (MT == 1) {
    f[0] = p[0];
  } else if constexpr (MT == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    f[0] = u.x; f[1] = u.y;
  } else {
#pragma unroll
    for (int j = 0; j < MT / 4; ++j) {
      const float4 u = reinterpret_cast<const float4*>(p)[j];
      f[4 * j] = u.x; f[4 * j + 1] = u.y;
      f[4 * j + 2] = u.z; f[4 * j + 3] = u.w;
    }
  }
}

// VEC fp32 values (16 or 32 bytes, aligned) stored or added.
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j)
    reinterpret_cast<float4*>(p)[j] =
        make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
}
template <int VEC>
__device__ __forceinline__ void add_f32(const float* p, float (&f)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j) {
    const float4 u = reinterpret_cast<const float4*>(p)[j];
    f[4 * j] += u.x; f[4 * j + 1] += u.y;
    f[4 * j + 2] += u.z; f[4 * j + 3] += u.w;
  }
}

// One 16-byte chunk of the output, cast from fp32.
__device__ __forceinline__ void store_out(__nv_bfloat16* p,
                                          const float (&f)[8]) {
  unsigned v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    v[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_out(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
// Four columns of the output (8 or 16 bytes, aligned).
__device__ __forceinline__ void store_out4(__nv_bfloat16* p,
                                           const float (&f)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const unsigned*>(&a),
      *reinterpret_cast<const unsigned*>(&b));
}
__device__ __forceinline__ void store_out4(float* p, const float (&f)[4]) {
  store_out(p, f);
}

// Bytes of the first region of shared memory: the ring, or the row
// phases' sums where those are larger.
template <typename T, int MT>
__host__ __device__ constexpr int region0_bytes() {
  constexpr int sums = THREADS * MT * (16 / static_cast<int>(sizeof(T)))
      * static_cast<int>(sizeof(float));
  return RING_BYTES > sums ? RING_BYTES : sums;
}

// The arrival count of a workspace slice, raised with release and acquire
// semantics at gpu scope: the block's workspace writes (ordered before
// this by a block barrier) are visible to the block that sees the last
// arrival, as are the other blocks' writes to it.
__device__ __forceinline__ int arrive(int* count) {
  int prev;
  asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;\n"
               : "=r"(prev) : "l"(count) : "memory");
  return prev;
}

// WS: some tile of the launch has several clusters (groups > 1), so the
// workspace path is compiled in.
template <typename T, int MT, bool WS>
__global__ void __launch_bounds__(THREADS, 2)
rowstream_tiles(const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_arrival;
  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;

  // Tile, cluster and split of this block.
  const int full = p.tiles * p.groups;
  const bool last_tile = static_cast<int>(blockIdx.y) >= full;
  const int tile = last_tile ? p.tiles : blockIdx.y / p.groups;
  const int g = last_tile ? blockIdx.y - full : blockIdx.y - tile * p.groups;
  const int G = last_tile ? p.groups_r : p.groups;
  const int cols = last_tile ? p.cols_r : p.cols;
  const int col0 = tile * p.cols;
  const int m0 = blockIdx.z * MT;
  const long long units = (p.k + p.granule - 1) / p.granule;
  const long long S = static_cast<long long>(G) * C;
  const long long s = static_cast<long long>(g) * C + rank;
  const int kb = static_cast<int>(min(static_cast<long long>(p.k),
                                      s * units / S * p.granule));
  const int ke = static_cast<int>(min(static_cast<long long>(p.k),
                                      (s + 1) * units / S * p.granule));
  const int nrows = ke - kb;

  // A stage holds sr rows of cpr chunks; thread (phase, c) computes chunk
  // c of rows phase, phase + phases, ...
  const int cpr = cols / VEC;
  const int phases = max(1, THREADS / cpr);
  const int sr = max(1, STAGE_CHUNKS / cpr);
  const int nstages = (nrows + sr - 1) / sr;
  const bool active = tid < phases * cpr;
  const int phase = tid / cpr;
  const int c = tid - phase * cpr;

  const size_t row_bytes = static_cast<size_t>(p.n) * sizeof(T);
  const unsigned char* wsrc = static_cast<const unsigned char*>(p.w)
      + static_cast<size_t>(kb) * row_bytes
      + static_cast<size_t>(col0) * sizeof(T);
  unsigned char* ring = smem;
  float* recv = reinterpret_cast<float*>(smem + region0_bytes<T, MT>());
  T* xs = reinterpret_cast<T*>(smem + region0_bytes<T, MT>() + p.recv_bytes);

  // Chunk tid + u * THREADS of a stage is row e / cpr, chunk e % cpr.
  size_t src_off[COPIES];
#pragma unroll
  for (int u = 0; u < COPIES; ++u) {
    const int e = tid + u * THREADS;
    const int r = e / cpr;
    src_off[u] = r * row_bytes + static_cast<size_t>(e - r * cpr) * CHUNK;
  }
  auto fetch = [&](int st) {
    if (st < nstages) {
      const int valid = min(sr, nrows - st * sr) * cpr;
      unsigned char* dst = ring + (st % STAGES) * STAGE_BYTES;
      const unsigned char* src =
          wsrc + static_cast<size_t>(st) * sr * row_bytes;
#pragma unroll
      for (int u = 0; u < COPIES; ++u) {
        const int e = tid + u * THREADS;
        if (e < valid) cp_async16(dst + e * CHUNK, src + src_off[u]);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < STAGES; ++st) fetch(st);

  // x's rows m0..m0+MT-1 (zero past m) over this block's K rows, K-major.
  const T* xg = static_cast<const T*>(p.x);
  for (int e = tid; e < MT * nrows; e += THREADS) {
    const int i = e / nrows;
    const int kk = e - i * nrows;
    xs[kk * MT + i] = m0 + i < p.m
        ? xg[static_cast<size_t>(m0 + i) * p.k + kb + kk]
        : from_float<T>(0.f);
  }

  float acc[MT][VEC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;

  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();   // stage st landed (and x's slice is staged)
    if (active) {
      const int rows = min(sr, nrows - st * sr);
      const unsigned char* stage =
          ring + (st % STAGES) * STAGE_BYTES + c * CHUNK;
      const T* xr = xs + st * sr * MT;
#pragma unroll 4
      for (int j = phase; j < rows; j += phases) {
        float wv[VEC];
        load_chunk(stage + j * cpr * CHUNK, wv);
        float xv[MT];
        load_x<MT>(xr + j * MT, xv);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[i][v] = fmaf(xv[i], wv[v], acc[i][v]);
      }
    }
    __syncthreads();   // stage st's slot is free
    fetch(st + STAGES);
  }
  cp_async_wait<0>();

  // Rank r owns chunks [r * cs, (r + 1) * cs) of the tile. Every block
  // pushes its sum over row phases (in phase order) of each owned chunk
  // into the owner's receive region, recv (rank, MT, cs, VEC).
  const int cs = (cpr + C - 1) / C;
  cluster_wait();
  if (phases == 1) {
    if (active) {
      const int r = c / cs;
      float* dst = cluster.map_shared_rank(recv, r)
          + (rank * MT * cs + c - r * cs) * VEC;
#pragma unroll
      for (int i = 0; i < MT; ++i) store_f32<VEC>(dst + i * cs * VEC, acc[i]);
    }
  } else {
    float* part = reinterpret_cast<float*>(ring);   // (phase, MT, cpr, VEC)
    if (active) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        store_f32<VEC>(part + ((phase * MT + i) * cpr + c) * VEC, acc[i]);
    }
    __syncthreads();
    for (int e = tid; e < MT * cpr; e += THREADS) {
      const int i = e / cpr;
      const int cc = e - i * cpr;
      float sum[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
      for (int ph = 0; ph < phases; ++ph)
        add_f32<VEC>(part + ((ph * MT + i) * cpr + cc) * VEC, sum);
      const int r = cc / cs;
      store_f32<VEC>(cluster.map_shared_rank(recv, r)
                         + ((rank * MT + i) * cs + cc - r * cs) * VEC,
                     sum);
    }
  }
  cluster.sync();   // every push has landed

  // The owned chunks, summed in rank order: the output where the tile has
  // one cluster, else this cluster's entry of the workspace.
  T* out = static_cast<T*>(p.out);
  const size_t zg = static_cast<size_t>(blockIdx.z) * p.groups;
  for (int e = tid; e < MT * cs; e += THREADS) {
    const int i = e / cs;
    const int cl = e - i * cs;
    const int cc = rank * cs + cl;
    if (cc >= cpr) continue;
    float sum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
    for (int q = 0; q < C; ++q)
      add_f32<VEC>(recv + ((q * MT + i) * cs + cl) * VEC, sum);
    const int col = col0 + cc * VEC;
    if (!WS || G == 1) {
      if (m0 + i < p.m)
        store_out(out + static_cast<size_t>(m0 + i) * p.n + col, sum);
    } else {
      store_f32<VEC>(p.ws + ((zg + g) * MT + i) * p.n + col, sum);
    }
  }
  if constexpr (!WS) return;
  if (G == 1) return;

  // The last cluster to arrive adds the clusters' sums in cluster order.
  __syncthreads();
  if (tid == 0) {
    int* count = p.counters
        + (static_cast<size_t>(blockIdx.z) * (p.tiles + 1) + tile) * C + rank;
    last_arrival = arrive(count) == G - 1;
    if (last_arrival) *count = 0;
  }
  __syncthreads();
  if (!last_arrival) return;
  // Items of 4 columns, every thread busy, LOADS loads in flight each.
  constexpr int Q = VEC / 4;
  const size_t gstride = static_cast<size_t>(MT) * p.n;
  for (int e = tid; e < MT * cs * Q; e += THREADS) {
    const int i = e / (cs * Q);
    const int rem = e - i * cs * Q;
    const int cc = rank * cs + rem / Q;
    if (cc >= cpr || m0 + i >= p.m) continue;
    const int col = col0 + cc * VEC + (rem % Q) * 4;
    const float4* src = reinterpret_cast<const float4*>(
        p.ws + (zg * MT + i) * p.n + col);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g0 = 0; g0 < G; g0 += LOADS) {
      float4 part[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j)
        if (g0 + j < G) part[j] = __ldcg(src + (g0 + j) * gstride / 4);
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        if (g0 + j < G) {
          sum[0] += part[j].x; sum[1] += part[j].y;
          sum[2] += part[j].z; sum[3] += part[j].w;
        }
      }
    }
    store_out4(out + static_cast<size_t>(m0 + i) * p.n + col, sum);
  }
}

// Unaligned w: one thread per column, all of K, MT rows of x per block.
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
rowstream_scalar(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int m, int k, int n) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  const int m0 = blockIdx.y * MT;
  if (col >= n) return;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const float wv = to_float(w[static_cast<size_t>(kk) * n + col]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = min(m0 + i, m - 1);
      acc[i] = fmaf(to_float(x[static_cast<size_t>(row) * k + kk]), wv,
                    acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (m0 + i < m)
      out[static_cast<size_t>(m0 + i) * n + col] = from_float<T>(acc[i]);
}

// Dynamic shared memory of a block: the ring (also the row phases' sums
// once the ring is drained, (phases, MT, cpr, VEC) fp32), the receive
// region (cluster, MT, cs, VEC) fp32, and x's slice for the most rows a
// block takes (kernel.py `smem_bytes`, `Plan.rows_max`).
template <typename T, int MT>
size_t smem_bytes(Params& p) {
  constexpr int VEC = 16 / sizeof(T);
  const int cs = (p.cols / VEC + p.cluster - 1) / p.cluster;
  p.recv_bytes = p.cluster * cs * VEC * MT * static_cast<int>(sizeof(float));
  const long long units = (p.k + p.granule - 1) / p.granule;
  const long long s_min = static_cast<long long>(p.cluster)
      * (p.cols_r > 0 ? min(p.groups, p.groups_r) : p.groups);
  const long long rows = min(static_cast<long long>(p.k),
                             (units + s_min - 1) / s_min * p.granule);
  const size_t xs = (rows * MT * sizeof(T) + 15) / 16 * 16;
  return region0_bytes<T, MT>() + p.recv_bytes + xs;
}

template <typename T, int MT, bool WS>
cudaError_t allow_smem(size_t smem) {
  static size_t smem_set = 48 * 1024;   // the attribute's value so far
  if (smem <= smem_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      rowstream_tiles<T, MT, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rowstream_tiles<T, MT, WS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess) smem_set = smem;
  return err;
}

cudaLaunchConfig_t tiles_config(dim3 grid, size_t smem, int cluster,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int MT, bool WS>
int launch_tiles(Params p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, MT>(p);
  cudaError_t err = allow_smem<T, MT, WS>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int clusters = p.tiles * p.groups + (p.cols_r > 0 ? p.groups_r : 0);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = tiles_config(
      dim3(p.cluster, clusters, (p.m + MT - 1) / MT), smem, p.cluster,
      stream, attr);
  err = cudaLaunchKernelEx(&cfg, rowstream_tiles<T, MT, WS>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT>
int launch_tiles(const Params& p, cudaStream_t stream) {
  return p.groups > 1 ? launch_tiles<T, MT, true>(p, stream)
                      : launch_tiles<T, MT, false>(p, stream);
}

template <typename T, int MT>
int launch_scalar(const Params& p, cudaStream_t stream) {
  dim3 grid((p.n + THREADS - 1) / THREADS, (p.m + MT - 1) / MT);
  rowstream_scalar<T, MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.w),
      static_cast<T*>(p.out), p.m, p.k, p.n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int vec, int mt, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1) {
    switch (mt) {
      case 1: return launch_scalar<T, 1>(p, s);
      case 2: return launch_scalar<T, 2>(p, s);
      case 4: return launch_scalar<T, 4>(p, s);
      case 8: return launch_scalar<T, 8>(p, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (vec != kVec || p.cols % kVec || p.cols_r % kVec
      || p.cols > 4096 / static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mt) {
    case 1: return launch_tiles<T, 1>(p, s);
    case 2: return launch_tiles<T, 2>(p, s);
    case 4: return launch_tiles<T, 4>(p, s);
    case 8: return launch_tiles<T, 8>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int MT>
int max_clusters(int cluster, int smem, int* count) {
  cudaError_t err = allow_smem<T, MT, true>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = tiles_config(dim3(cluster, 1, 1), smem, cluster,
                                        nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, rowstream_tiles<T, MT, true>, &cfg));
}

template <typename T>
int max_clusters_mt(int mt, int cluster, int smem, int* count) {
  switch (mt) {
    case 1: return max_clusters<T, 1>(cluster, smem, count);
    case 2: return max_clusters<T, 2>(cluster, smem, count);
    case 4: return max_clusters<T, 4>(cluster, smem, count);
    case 8: return max_clusters<T, 8>(cluster, smem, count);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). vec: 1 (the
// scalar kernel; the tiling arguments are ignored) or 16 / sizeof(dtype).
// mt: rows of x per block, 1, 2, 4 or 8. The tiling arguments are a plan
// of kernel.py. ws and counters: the device's workspace and arrival
// counters, used (and the counters left zero) where groups > 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rowstream_matmul(const void* x, const void* w, void* out,
                                void* ws, void* counters, int m, int k,
                                int n, int dtype, int vec, int mt,
                                int cluster, int tiles, int cols, int groups,
                                int cols_r, int groups_r, int granule,
                                void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || groups < 1 || granule < 1
      || (cols_r > 0 && (groups_r < 1 || groups_r > groups))
      || (groups > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {x, w, out, static_cast<float*>(ws), static_cast<int*>(counters),
              m, k, n, cluster, tiles, cols, groups, cols_r, groups_r,
              granule, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, vec, mt, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, vec, mt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of `cluster` blocks with `smem` bytes of dynamic shared memory
// each that the current device holds at once, into *count.
extern "C" int rowstream_max_clusters(int dtype, int mt, int cluster,
                                      int smem, int* count) {
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return max_clusters_mt<float>(mt, cluster, smem, count);
  if (dtype == 1)
    return max_clusters_mt<__nv_bfloat16>(mt, cluster, smem, count);
  return static_cast<int>(cudaErrorInvalidValue);
}
