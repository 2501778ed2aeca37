// GQA flash decode for Hopper (sm_90a): one new query token per sequence
// against its KV cache.
//
// Replaces the Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_decode/kernel.py), which is the softmax of
// `_cached_attention_local` (src/repro/models/layers.py): logits
// q.k * (1/sqrt(d)) in fp32, slots after `pos` masked to -1e30, online
// softmax, output cast to q's dtype.
//
// q (b, h, d), caches (b, h_kv, S, d) contiguous; the g = h / h_kv query
// heads that share a KV head ride along, so each K/V token is read once per
// (batch, KV head) pair and used by g heads. The work is 4 flops per cached
// value against 2 bytes read, so at long context the kernel is bound by the
// bytes of the cache; at serving's short context (a few hundred slots) it
// is bound by launch latency and the length of its dependent steps.
//
// 1. One launch, no workspace. The valid prefix of a pair is cut into
//    nsplit <= 8 chunks, each starting on a whole 4 KB row of one head's K
//    where the head dim allows (the wrapper plans this per shape). The
//    chunks of one pair are the blocks of one thread-block cluster: grid
//    (nsplit, h_kv * head groups, b), cluster (nsplit, 1, 1). Each block
//    leaves its running max, sum and accumulator in its shared memory;
//    after a cluster barrier the blocks read their peers' through
//    distributed shared memory and combine them in chunk order, each block
//    writing its share of the output. Deterministic, no atomics, no second
//    kernel, nothing allocated but the output. Only the tokens
//    0..min(pos, S-1) are read. On request the merge also writes each
//    head's softmax statistics (its max and sum), which a cache split by
//    sequence over several ranks needs to merge the ranks' partial
//    results (`flash_decode_partial`).
// 2. Row-sized asynchronous copies. K and V of a pair are contiguous over
//    S, so a tile of T tokens is one contiguous range of whole 4 KB rows:
//    64 tokens on the tensor-core path (16 KB of K and 16 KB of V at d 128
//    bf16, four rows each), 512 / P tokens on the CUDA-core path (P
//    below). Tiles come into shared memory in the cache's own dtype by
//    16-byte `cp.async` (L1 bypassed; bytes past the valid prefix are
//    zero-filled, not read) into a ring of 3 (tensor-core) or 4 stages, so
//    the next tiles are in flight while one is computed; one barrier per
//    tile. Where d is not a multiple of 8 or q or a cache is not 16-byte
//    aligned, the CUDA-core ring is filled by plain element loads.
// 3. Warp-parallel arithmetic, on tensor cores where the dtypes allow.
//    * bf16 q against a bf16 cache, d a multiple of 64 (the serving path):
//      `flash_decode_mma`. Each of 4 warps takes 16 tokens (one 4 KB row
//      of K and of V at d 128) of every 64-token tile. S = Q K^T comes
//      from mma.sync m16n8k16 with q's A fragments held in registers (the
//      block's <= 8 heads as rows) and K by ldmatrix; each lane owns 4
//      scores, so the online softmax computes every exp once; O += P V
//      takes P straight from the score fragments and V by ldmatrix.trans.
//      p enters P V rounded to bf16, where the TPU kernel keeps it in fp32
//      (a deliberate step down: mma.sync takes bf16 operands); the sum l
//      adds the same rounded p, so numerator and denominator agree. The
//      ring is XOR-swizzled by 16-byte chunk so that ldmatrix's 8 rows
//      fall in 8 bank groups. A first version on CUDA
//      cores alone ran at 15 % of the byte bound at S 32768 on an H100
//      80GB HBM3 at 700 W (PERF.md): shuffles, redundant exps and
//      latency, not bytes, held it.
//    * every other pair and head dim: `flash_decode_simt`, on CUDA cores.
//      A row of d values is split over P lanes (the power of two >= d / 8),
//      each lane holding 8 consecutive values and its 8-column slice of q
//      for the block's 8 heads (zero past g) in registers; dots are finished by xor
//      shuffles within the P lanes of a token; P.V keeps the lanes on the
//      same 8 output columns.
//    Both keep one online softmax per warp over its share of every tile
//    (no block barrier for the softmax), merge the warps through shared
//    memory at the end of the chunk, accumulate in fp32 and use accurate
//    expf (no fast math). Groups of more than 8 query heads per KV head
//    take several blocks (head groups).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 4;     // ring of K/V tiles
constexpr int PASSES = 2;     // token passes of each warp per tile
constexpr int W = 8;          // consecutive values of a row per lane
constexpr int MAX_HG = 8;     // query heads held in registers per block
constexpr int MAX_SPLITS = 8; // blocks of a cluster (the portable size)
// Tensor-core path: 4 warps, each taking 16 tokens of every 64-token tile.
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_STAGES = 3;
constexpr int MMA_TT = 16 * MMA_WARPS;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// Lanes per row: the power of two that covers d in slices of W.
__host__ __device__ __forceinline__ int lanes_per_row(int d) {
  int p = 1;
  while (p * W < d) p <<= 1;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
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
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_started() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The W values of a row slice from shared memory as fp32: one 16-byte
// load for bf16, two for fp32 (VEC: d % 8 == 0, so the slice is aligned
// and inside the row); else element by element, zero past the row's end.
template <bool VEC>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p, int left,
                                           float (&f)[W]) {
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) f[e] = e < left ? to_float(p[e]) : 0.f;
  }
}
template <bool VEC>
__device__ __forceinline__ void load_slice(const float* p, int left,
                                           float (&f)[W]) {
  if (VEC) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) f[e] = e < left ? p[e] : 0.f;
  }
}

// Copy tokens [t0, t0 + nt) of one head's K and V into a stage of the
// ring; the rest of the tile's TT tokens is zero. VEC: 16-byte cp.async
// chunks, each thread's in flight until cp_async_wait; SWZ stores chunk c
// of token t at c ^ (t % 8) (rows of a multiple of 8 chunks). Else plain
// element copies.
template <typename KT, bool VEC, bool SWZ>
__device__ __forceinline__ void load_tile(KT* ks, KT* vs, const KT* kp,
                                          const KT* vp, int t0, int nt,
                                          int TT, int d, int nthreads) {
  const size_t off = static_cast<size_t>(t0) * d;
  if (VEC) {
    const int cpr = d * static_cast<int>(sizeof(KT)) / 16;   // per row
    const int chunks = TT * cpr;
    const int valid = nt * cpr;
    const char* kg = reinterpret_cast<const char*>(kp + off);
    const char* vg = reinterpret_cast<const char*>(vp + off);
    char* kd = reinterpret_cast<char*>(ks);
    char* vd = reinterpret_cast<char*>(vs);
    for (int i = threadIdx.x; i < chunks; i += nthreads) {
      const bool in = i < valid;
      int j = i;
      if (SWZ) {
        const int t = i / cpr;
        j = t * cpr + ((i - t * cpr) ^ (t & 7));
      }
      cp_async16(kd + 16 * j, in ? kg + 16 * i : kg, in ? 16 : 0);
      cp_async16(vd + 16 * j, in ? vg + 16 * i : vg, in ? 16 : 0);
    }
  } else {
    const int n = TT * d;
    const int valid = nt * d;
    for (int i = threadIdx.x; i < n; i += nthreads) {
      const bool in = i < valid;
      ks[i] = in ? kp[off + i] : from_float<KT>(0.f);
      vs[i] = in ? vp[off + i] : from_float<KT>(0.f);
    }
  }
}

// Byte offset of the receive region in dynamic shared memory: after the
// ring, or after the warps' states where those are larger (they take the
// ring's place once the last tile is done).
__host__ __device__ __forceinline__ size_t recv_offset(size_t ring,
                                                       size_t warps) {
  return ((ring > warps ? ring : warps) + 15) / 16 * 16;
}

// Bytes of the warps' states: wm, wl (nw, hg) each and wacc (nw, hg, d),
// fp32.
__host__ __device__ __forceinline__ size_t warp_state_bytes(int nw, int hg,
                                                            int d) {
  return static_cast<size_t>(nw) * hg * (d + 2) * sizeof(float);
}

// Bytes of a block's receive region: the running max and sum of every
// chunk's block for its heads, rm and rl (MAX_SPLITS, hg), and racc, the
// accumulator entries this block owns from every chunk (nsplit * E <=
// hg * d + MAX_SPLITS).
__host__ __device__ __forceinline__ size_t recv_bytes(int hg, int d) {
  return (static_cast<size_t>(hg) * (d + 2 * MAX_SPLITS) + MAX_SPLITS)
      * sizeof(float);
}

// The warps' states (running max, sum and accumulator of each head), left
// in shared memory at wm (NW, HG), wl (NW, HG) and wacc (NW, HG, d) before
// a block barrier, are merged in warp order into this block's state. The
// block owns E = ceil(HG * d / nsplit) of the output entries (head-major)
// and pushes every other block its share, with its max and sum, into that
// block's receive region through distributed shared memory. After one
// cluster barrier each block merges the entries it owns in chunk order
// from its own shared memory and writes them to op (nh, d); no block
// reads another's memory after the barrier, so none waits at the exit.
// Where mo and lo are set, the thread that writes a head's column 0 also
// writes the head's merged max (natural-log units, times the scale) and
// sum to mo[h] and lo[h].
template <typename QT, int HG, int NW>
__device__ __forceinline__ void merge_and_store(
    const float* wm, const float* wl, const float* wacc, float* recv, int d,
    int nh, QT* __restrict__ op, float* __restrict__ mo,
    float* __restrict__ lo) {
  constexpr int NT = NW * 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int E = (HG * d + nsplit - 1) / nsplit;
  float* rm = recv;
  float* rl = rm + MAX_SPLITS * HG;
  float* racc = rl + MAX_SPLITS * HG;
  __syncthreads();   // the warps' states are written
  cluster_wait_started();
  // Thread t merges head t / TPH over the columns t % TPH + k * TPH: its
  // head's warp weights once, then each column's sum over the warps,
  // pushed to the block that owns the entry.
  constexpr int TPH = NT / HG;
  if (threadIdx.x < HG * TPH) {
    const int h = threadIdx.x / TPH;
    const int c0 = threadIdx.x % TPH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * HG + h]);
    float f[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) f[w] = expf(wm[w * HG + h] - mx);
    if (c0 == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum = fmaf(wl[w * HG + h], f[w], sum);
      for (int r = 0; r < nsplit; ++r) {
        cluster.map_shared_rank(rm, r)[split * HG + h] = mx;
        cluster.map_shared_rank(rl, r)[split * HG + h] = sum;
      }
    }
    for (int c = c0; c < d; c += TPH) {
      const int i = h * d + c;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        a = fmaf(wacc[(w * HG) * d + i], f[w], a);
      const int r = i / E;
      cluster.map_shared_rank(racc, r)[split * E + (i - r * E)] = a;
    }
  }
  cluster.sync();   // every block's pushes have landed
  for (int j = threadIdx.x; j < E; j += NT) {
    const int i = split * E + j;
    if (i >= nh * d) break;
    const int h = i / d;
    float mx = NEG_INF;
    for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, rm[r * HG + h]);
    float sum = 0.f;
    float a = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float e = expf(rm[r * HG + h] - mx);
      sum = fmaf(rl[r * HG + h], e, sum);
      a = fmaf(racc[r * E + j], e, a);
    }
    op[i] = from_float<QT>(a / fmaxf(sum, 1e-30f));
    if (mo != nullptr && i == h * d) {
      mo[h] = mx;
      lo[h] = sum;
    }
  }
}

// This block's heads' statistics within m_out / l_out (b, h), or null.
__device__ __forceinline__ float* head_stats(float* stats, size_t head) {
  return stats == nullptr ? nullptr : stats + head;
}

template <typename QT, typename KT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_decode_simt(const QT* __restrict__ q, const KT* __restrict__ kc,
                  const KT* __restrict__ vc, QT* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int hkv, int n_hg, int S, int d, int g, int n_valid,
                  int chunk, float scale) {
  constexpr int HG = MAX_HG;
  extern __shared__ __align__(128) unsigned char smem[];
  cluster_arrive_started();
  const int split = static_cast<int>(cg::this_cluster().block_rank());
  const int kvh = blockIdx.y / n_hg;
  const int h0 = (blockIdx.y - kvh * n_hg) * HG;
  const int nh = min(HG, g - h0);
  const size_t pair = static_cast<size_t>(blockIdx.z) * hkv + kvh;

  const int P = lanes_per_row(d);
  const int TPW = 32 / P;                     // tokens of a warp per pass
  const int TT = PASSES * WARPS * TPW;        // tokens per tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / P;
  const int col = (lane % P) * W;
  const int left = d - col;                   // values of the row from col
  const bool active = left > 0;

  const size_t tile_elems = static_cast<size_t>(TT) * d;
  KT* ring = reinterpret_cast<KT*>(smem);
  float* recv = reinterpret_cast<float*>(
      smem + recv_offset(STAGES * 2 * tile_elems * sizeof(KT),
                         warp_state_bytes(WARPS, HG, d)));

  const QT* qp = q + (pair * g + h0) * d;
  float qr[HG][W];
#pragma unroll
  for (int h = 0; h < HG; ++h)
#pragma unroll
    for (int e = 0; e < W; ++e)
      qr[h][e] = (h < nh && e < left) ? to_float(qp[h * d + col + e]) : 0.f;

  float m[HG], l[HG], acc[HG][W];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[h][e] = 0.f;
  }

  const KT* kp = kc + pair * S * d;
  const KT* vp = vc + pair * S * d;
  const int t_begin = split * chunk;
  const int t_end = min(n_valid, t_begin + chunk);
  const int ntiles = (t_end - t_begin + TT - 1) / TT;
  auto load = [&](int i) {
    if (i < ntiles) {
      const int st = i % STAGES;
      const int t0 = t_begin + i * TT;
      load_tile<KT, VEC, false>(ring + 2 * st * tile_elems,
                                ring + (2 * st + 1) * tile_elems, kp, vp, t0,
                                min(TT, t_end - t0), TT, d, THREADS);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(it + STAGES - 1);
    const int st = it % STAGES;
    const KT* ks = ring + 2 * st * tile_elems;
    const KT* vs = ks + tile_elems;
    const int nt = min(TT, t_end - (t_begin + it * TT));

    float s[PASSES][HG];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int tok = (p * WARPS + warp) * TPW + grp;
      float kf[W];
      if (active) {
        load_slice<VEC>(ks + static_cast<size_t>(tok) * d + col, left, kf);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) dot = fmaf(qr[h][e], kf[e], dot);
        s[p][h] = dot;
      }
      for (int off = P / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int h = 0; h < HG; ++h)
          s[p][h] += __shfl_xor_sync(FULL, s[p][h], off);
      }
      const bool valid = tok < nt;
#pragma unroll
      for (int h = 0; h < HG; ++h) s[p][h] = valid ? s[p][h] * scale : NEG_INF;
    }

    // The warp's running max over its tokens of this tile; the accumulator
    // is rescaled only when it grows (the test is warp-uniform).
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float mt = s[0][h];
#pragma unroll
      for (int p = 1; p < PASSES; ++p) mt = fmaxf(mt, s[p][h]);
      for (int off = P; off < 32; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
      if (mt > m[h]) {
        const float a = expf(m[h] - mt);
        l[h] *= a;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[h][e] *= a;
        m[h] = mt;
      }
    }

#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int tok = (p * WARPS + warp) * TPW + grp;
      const bool valid = tok < nt;
      float vf[W];
      if (active) {
        load_slice<VEC>(vs + static_cast<size_t>(tok) * d + col, left, vf);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) vf[e] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        const float pr = valid ? expf(s[p][h] - m[h]) : 0.f;
        l[h] += pr;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' states go there

  // Sum the token groups of each warp (lanes P apart hold the same
  // columns).
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    for (int off = P; off < 32; off <<= 1) {
      l[h] += __shfl_xor_sync(FULL, l[h], off);
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[h][e] += __shfl_xor_sync(FULL, acc[h][e], off);
    }
  }
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + WARPS * HG;
  float* wacc = wl + WARPS * HG;
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h)
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (e < left) wacc[(warp * HG + h) * d + col + e] = acc[h][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      wm[warp * HG + h] = m[h];
      wl[warp * HG + h] = l[h];
    }
  }
  merge_and_store<QT, HG, WARPS>(wm, wl, wacc, recv, d, nh,
                                 out + (pair * g + h0) * d,
                                 head_stats(m_out, pair * g + h0),
                                 head_stats(l_out, pair * g + h0));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p,
                                        bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32
// accumulate. a1 and a3 (rows 8-15) are zero here: at most 8 query heads.
__device__ __forceinline__ void mma_rows8(float (&c)[4], unsigned a0,
                                          unsigned a2, unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// The pair rounded to bf16, as the bits of an mma operand; lo and hi are
// set to the rounded values.
__device__ __forceinline__ unsigned pack_bf16(float& lo, float& hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(v);
  lo = r.x;
  hi = r.y;
  return *reinterpret_cast<const unsigned*>(&v);
}

// Tensor-core path for bf16 q against a bf16 cache, d a multiple of 64:
// the same clusters, ring and merges, with the products on mma.sync.
// Each warp takes 16 tokens of every 64-token tile (one 4 KB row of K and
// one of V at d 128): S = Q K^T as a 16 x 16 tile (rows: the block's <= 8
// heads, padded to 16; columns: tokens) from ldmatrix of the K rows, its
// own online softmax on the fragments (each lane owns 4 scores, so every
// exp is computed once), then O += P V with P taken straight from the
// score fragments and V by ldmatrix.trans. q and K are bf16 already, so
// q.k is exact up to the fp32 sums; p goes into the product as bf16, and
// the sum l (fp32) adds the same rounded p. The ring is XOR-swizzled by 16-byte chunk (chunk c of token t at
// c ^ (t % 8)) so that ldmatrix's eight rows hit eight bank groups.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_decode_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ vc,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int hkv, int n_hg, int S, int g, int n_valid, int chunk,
                 float scale) {
  constexpr int HG = MAX_HG;
  constexpr int KSTEPS = D / 16;
  constexpr int NTILES = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  cluster_arrive_started();
  const int split = static_cast<int>(cg::this_cluster().block_rank());
  const int kvh = blockIdx.y / n_hg;
  const int h0 = (blockIdx.y - kvh * n_hg) * HG;
  const int nh = min(HG, g - h0);
  const size_t pair = static_cast<size_t>(blockIdx.z) * hkv + kvh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane / 4;     // head of the fragments' rows 0-7
  const int quad = lane % 4;

  constexpr size_t tile_elems = static_cast<size_t>(MMA_TT) * D;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  // The warps' states fit in one stage of the ring (checked at compile
  // time), so the receive region follows the ring.
  static_assert(2 * MMA_TT * D * 2 >= 4 * MMA_WARPS * HG * (D + 2),
                "warp states exceed a stage");
  float* recv = reinterpret_cast<float*>(
      smem + recv_offset(MMA_STAGES * 2 * tile_elems * 2, 0));

  // q as the A fragments of rows 0-7: a0 (k 0-7 of the step), a2 (k 8-15).
  unsigned qa[KSTEPS][2];
  const __nv_bfloat16* qp = q + (pair * g + h0 + row) * D + quad * 2;
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k) {
    qa[k][0] = row < nh ? *reinterpret_cast<const unsigned*>(qp + k * 16) : 0u;
    qa[k][1] =
        row < nh ? *reinterpret_cast<const unsigned*>(qp + k * 16 + 8) : 0u;
  }
  float o[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  float m_run = NEG_INF;   // of head `row`, over this warp's tokens
  float l_run = 0.f;       // this lane's share of the sum

  const __nv_bfloat16* kp = kc + pair * S * D;
  const __nv_bfloat16* vp = vc + pair * S * D;
  const int t_begin = split * chunk;
  const int t_end = min(n_valid, t_begin + chunk);
  const int ntiles = (t_end - t_begin + MMA_TT - 1) / MMA_TT;
  auto load = [&](int i) {
    if (i < ntiles) {
      const int st = i % MMA_STAGES;
      const int t0 = t_begin + i * MMA_TT;
      load_tile<__nv_bfloat16, true, true>(
          ring + 2 * st * tile_elems, ring + (2 * st + 1) * tile_elems, kp,
          vp, t0, min(MMA_TT, t_end - t0), MMA_TT, D, MMA_THREADS);
    }
    cp_async_commit();
  };
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  const int mi = lane / 8;
  const int mr = lane % 8;
  const int k_tok = warp * 16 + (mi / 2) * 8 + mr;   // K: tokens x chunks
  const int k_chunk = mi % 2;
  const int v_tok = warp * 16 + (mi % 2) * 8 + mr;   // V: chunks x tokens
  const int v_chunk = mi / 2;

#pragma unroll
  for (int i = 0; i < MMA_STAGES - 1; ++i) load(i);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();
    load(it + MMA_STAGES - 1);
    const int st = it % MMA_STAGES;
    const __nv_bfloat16* ks = ring + 2 * st * tile_elems;
    const __nv_bfloat16* vs = ks + tile_elems;
    const int nt = min(MMA_TT, t_end - (t_begin + it * MMA_TT));
    if (warp * 16 >= nt) continue;   // warp-uniform: no token of this warp

    // Two accumulators per 8 tokens (even and odd k steps) halve the chain
    // of dependent mma.
    float sk[2][2][4] = {};
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {
      unsigned b[4];
      ldsm_x4(b, ks + k_tok * D + (((2 * k + k_chunk) ^ (k_tok & 7)) * 8),
              false);
      mma_rows8(sk[k % 2][0], qa[k][0], qa[k][1], b[0], b[1]);
      mma_rows8(sk[k % 2][1], qa[k][0], qa[k][1], b[2], b[3]);
    }
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = sk[0][n][j] + sk[1][n][j];
    // V's fragments come in while the softmax runs.
    unsigned vb[NTILES / 2][4];
#pragma unroll
    for (int n = 0; n < NTILES; n += 2)
      ldsm_x4(vb[n / 2],
              vs + v_tok * D + (((n + v_chunk) ^ (v_tok & 7)) * 8), true);
    // Lane (row, quad) holds the scores of head `row` for tokens
    // n * 8 + quad * 2 + j of the warp's 16 (fragments s[n][j], j < 2).
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = warp * 16 + n * 8 + quad * 2 + j < nt;
        s[n][j] = valid ? s[n][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[n][j]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float p[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = warp * 16 + n * 8 + quad * 2 + j < nt;
        p[n][j] = valid ? expf(s[n][j] - m_new) : 0.f;
      }
    const unsigned pa0 = pack_bf16(p[0][0], p[0][1]);
    const unsigned pa2 = pack_bf16(p[1][0], p[1][1]);
    l_run = l_run * alpha + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
#pragma unroll
    for (int n = 0; n < NTILES; n += 2) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
      o[n + 1][0] *= alpha;
      o[n + 1][1] *= alpha;
      mma_rows8(o[n], pa0, pa2, vb[n / 2][0], vb[n / 2][1]);
      mma_rows8(o[n + 1], pa0, pa2, vb[n / 2][2], vb[n / 2][3]);
    }
  }
  // The warps' states go to the stage after the last tile's: every warp
  // finished its tile before the last barrier, and no copy targets it.
  l_run += __shfl_xor_sync(FULL, l_run, 1);
  l_run += __shfl_xor_sync(FULL, l_run, 2);
  float* wm = reinterpret_cast<float*>(ring + 2 * (ntiles % MMA_STAGES) *
                                       tile_elems);
  float* wl = wm + MMA_WARPS * HG;
  float* wacc = wl + MMA_WARPS * HG;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    float* dst = wacc + (warp * HG + row) * D + n * 8 + quad * 2;
    dst[0] = o[n][0];
    dst[1] = o[n][1];
  }
  if (quad == 0) {
    wm[warp * HG + row] = m_run;
    wl[warp * HG + row] = l_run;
  }
  merge_and_store<__nv_bfloat16, HG, MMA_WARPS>(
      wm, wl, wacc, recv, D, nh, out + (pair * g + h0) * D,
      head_stats(m_out, pair * g + h0), head_stats(l_out, pair * g + h0));
}

// Launch `fn` on grid (nsplit, h_kv * head groups, b) in clusters of
// nsplit blocks, with `smem` bytes of dynamic shared memory.
template <typename... Args>
int launch_clusters(void (*fn)(Args...), size_t& smem_set, int nsplit,
                    int groups, int b, int threads, size_t smem,
                    cudaStream_t stream, Args... args) {
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, groups, b);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, bool VEC>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* m_out, float* l_out, int b, int hkv, int g, int S,
                int d, int n_valid, int chunk, int nsplit, float scale,
                cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;   // the attribute's value so far
  const int TT = PASSES * WARPS * (32 / lanes_per_row(d));
  const size_t smem =
      recv_offset(STAGES * 2 * static_cast<size_t>(TT) * d * sizeof(KT),
                  warp_state_bytes(WARPS, MAX_HG, d))
      + recv_bytes(MAX_HG, d);
  const int n_hg = (g + MAX_HG - 1) / MAX_HG;
  return launch_clusters(
      flash_decode_simt<QT, KT, VEC>, smem_set, nsplit, hkv * n_hg, b,
      THREADS, smem, stream, static_cast<const QT*>(q),
      static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<QT*>(out), m_out, l_out, hkv, n_hg, S, d, g, n_valid,
      chunk, scale);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* m_out, float* l_out, int b, int hkv, int g, int S,
               int n_valid, int chunk, int nsplit, float scale,
               cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  const size_t smem =
      recv_offset(MMA_STAGES * 2 * static_cast<size_t>(MMA_TT) * D * 2, 0)
      + recv_bytes(MAX_HG, D);
  const int n_hg = (g + MAX_HG - 1) / MAX_HG;
  using bf16 = __nv_bfloat16;
  return launch_clusters(
      flash_decode_mma<D>, smem_set, nsplit, hkv * n_hg, b, MMA_THREADS,
      smem, stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), m_out, l_out,
      hkv, n_hg, S, g, n_valid, chunk, scale);
}

// bf16 against bf16 with d a multiple of 64 takes the tensor-core path,
// the rest the CUDA-core path. Both hold MAX_HG heads per block (zero past
// g), in ceil(g / MAX_HG) head groups.
template <typename QT, typename KT>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* m_out, float* l_out, int b, int hkv, int g, int S, int d,
             int n_valid, int chunk, int nsplit, int vec, float scale,
             cudaStream_t s) {
#define FD_MMA(D)                                                        \
  return launch_mma<D>(q, k, v, out, m_out, l_out, b, hkv, g, S, n_valid, \
                       chunk, nsplit, scale, s)
#define FD_SIMT(VEC)                                                       \
  return launch_simt<QT, KT, VEC>(q, k, v, out, m_out, l_out, b, hkv, g, \
                                  S, d, n_valid, chunk, nsplit, scale, s)
  if (std::is_same<QT, __nv_bfloat16>::value && vec && d % 64 == 0) {
    switch (d) {
      case 64: FD_MMA(64);
      case 128: FD_MMA(128);
      case 192: FD_MMA(192);
      case 256: FD_MMA(256);
      default: break;
    }
  }
  if (vec) FD_SIMT(true);
  FD_SIMT(false);
#undef FD_SIMT
#undef FD_MMA
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. Supported (q, kv): (f32, f32),
// (f32, bf16), (bf16, bf16). The first n_valid tokens are read (min(pos +
// 1, S) of a whole cache; a shard's own count of its slots), in
// nsplit <= 8 chunks of `chunk` tokens (one cluster of nsplit blocks per
// pair and head group). vec = 1 when d % 8 == 0 and q and both caches are
// 16-byte aligned. Writes `out` (b, h, d) in q's dtype and allocates
// nothing. Where m_out and l_out (b, h) fp32 are not null, also writes each
// head's softmax statistics over the n_valid tokens: the row max of the
// scaled logits and the sum of exp(logit - max), as the plain
// `flash_decode_partial_ref` gives them; null pointers leave the kernels'
// work as it is without them. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* out, float* m_out, float* l_out, int b,
                            int hkv, int g, int S, int d, int n_valid,
                            int chunk, int nsplit, int vec, float scale,
                            int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAX_SPLITS || d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch<float, float>(q, k, v, out, m_out, l_out, b, hkv, g, S,
                                  d, n_valid, chunk, nsplit, vec, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, __nv_bfloat16>(q, k, v, out, m_out, l_out, b,
                                          hkv, g, S, d, n_valid, chunk,
                                          nsplit, vec, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, out, m_out, l_out, b, hkv, g, S, d, n_valid, chunk, nsplit,
        vec, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
