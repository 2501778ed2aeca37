// Chunked RWKV6 time-mix scan for Hopper (sm_90a):
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,  o_t = r_t (diag(u) k_t^T v_t + S_{t-1})
//
// for r, k, v, w of shape (b, H, s, 64) (the wrapper transposes them from
// the model's (b, s, H, hd) and pads a smaller head dim to 64 with
// r = k = v = 0, w = 1), u (H, 64) fp32; o (b, H, s, 64) in the input
// dtype and the final state (b, H, 64, 64) in fp32, from a zero state.
//
// Replaces the Pallas TPU kernel `rwkv_scan`
// (src/repro/kernels/rwkv_scan/kernel.py). It computes the same chunked
// form: within a tile of at most 16 tokens every cross-token term is a
// 16 x 16 matrix A, and only the (64 x 64) state crosses tile boundaries.
// A tile never straddles a chunk of the caller's `chunk` tokens: a chunk of
// 16 or fewer is one tile (padded to 16 rows with r = k = v = 0, w = 1,
// which add nothing to S and leave every decay product unchanged), a
// longer chunk is cut into tiles of 16 and a ragged rest.
//
// What bounds it: at rwkv6-3b's shape (hd 64, fp32, chunk 16) each tile of
// one operand of one head is one contiguous 4 KB DRAM row (the RoMe
// contract, as on the TPU), and the kernel moves each input once and
// writes o once: about 212 MB per launch at b 4 x s 1024 x H 40, 63 us at
// 3.35 TB/s. The arithmetic, two 64 x 64 x 16 state products and the
// 16 x 16 matrix per tile and head, would take 40 us at the fp32 CUDA-core
// peak; on tensor cores it is far less. What the design has to keep short
// is the walk over 64 tiles per head, which is a chain through the state.
// Measured on an H100 (PERF.md), the copies alone run at the byte bound;
// the rest of the time is the shared-memory traffic and instructions of
// the two blocks that 28 of the 132 SMs hold.
//
// Design:
// * One block per (b, h): grid b * H, 160 blocks at rwkv6-3b, two per SM
//   (launch bound, about 111 KB of shared memory each). The block owns the
//   whole state, so the decays and the matrix A are computed once per
//   tile and head.
// * Warp roles. Four prep warps turn tile m + 1's raw rows into the
//   operands of the state products while the four state warps run tile
//   m's products. Three barriers per tile: a __syncthreads hands the
//   double-buffered operands over, a named barrier among the state warps
//   stages o, and one among the prep warps separates their two phases.
// * Tiles are copied ahead, whole rows, by TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx::bytes): one per operand per
//   tile, len x 64 elements, contiguous in the (b, H, s, 64) layout. A ring
//   of 3 stages holds tiles m + 1 (prepped), m + 2 and m + 3 (in flight);
//   the prep warps wait on the stage's mbarrier, never on a block barrier.
//   (2 stages were 2 % slower on an H100, PERF.md.)
//   A ragged tile copies its valid rows only; the prep warps read the rest
//   as r = k = v = 0, w = 1 (a select, never a product with stale bytes).
// * Decays as running products of w, with no log or exp: within a tile
//   exp(lcp_i - lc_j) = prod_{t=j+1}^{i-1} w_t, exp(lcp_i) = prod_{t<i} w_t,
//   exp(lc_last - lc_j) = prod_{t>j} w_t and exp(lc_last) = prod_t w_t.
//   Every product lies in [0, 1]: it underflows to 0 where the reference's
//   exp does and never overflows. The reference clamps w at 1e-38 before
//   its log; a product differs from that by less than 1e-38 of the term.
//   No fast-math intrinsics (the build passes no -use_fast_math), so
//   subnormal products are kept, as in the reference's expf.
// * The state products on tensor cores: mma.sync m16n8k8 in TF32 with the
//   3xTF32 split (hi*hi + hi*lo + lo*hi, summed in fp32), which keeps fp32
//   accuracy over 1000 tokens of decays near 0.993. State warp q keeps
//   rows 16q..16q+15 of S^T (value columns) in mma accumulators for the
//   whole walk: S^T <- S^T diag(W) + v^T k_dec, and
//   o^T = S^T r_dec^T + v^T A^T reads S^T straight from the accumulators
//   as an A operand (the k order inside an 8-wide step is permuted the
//   same way in both operands, which leaves the sum unchanged).
// * Operands in shared memory are fp32 rows padded so that each fragment
//   load is free of bank conflicts (strides below); the state warps split
//   them as they load them (A is stored split). On an H100 that was faster
//   than storing r_dec and k_dec split in (hi, lo) pairs (PERF.md): half
//   the shared-memory bytes for more ALU work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

constexpr int HD = 64;          // head dim of the kernel (the wrapper pads)
constexpr int TILE = 16;        // tokens per tile
constexpr int MAX_CHUNK = 64;
constexpr int STAGES = 3;
constexpr int STATE_WARPS = 4;
constexpr int PREP_WARPS = 4;
constexpr int STATE_THREADS = 32 * STATE_WARPS;
constexpr int PREP_THREADS = 32 * PREP_WARPS;
constexpr int THREADS = STATE_THREADS + PREP_THREADS;
constexpr int PRODUCER = STATE_THREADS;   // the first prep thread
// Prep buffer, in floats: r_dec, k_dec and v in fp32 (the state warps
// split them), A in (hi, lo) pairs, and W. Row strides of 8 mod 32 make
// every fragment load free of bank conflicts (r_dec and A by float2, k_dec
// and v by float).
constexpr int RD_STRIDE = HD + 8;
constexpr int KD_STRIDE = HD + 8;
constexpr int V_STRIDE = HD + 8;
constexpr int A_STRIDE = 2 * TILE + 8;
constexpr int RD_OFF = 0;
constexpr int KD_OFF = RD_OFF + TILE * RD_STRIDE;
constexpr int V_OFF = KD_OFF + TILE * KD_STRIDE;
constexpr int A_OFF = V_OFF + TILE * V_STRIDE;
constexpr int W_OFF = A_OFF + TILE * A_STRIDE;
constexpr int PREP_FLOATS = W_OFF + HD;
// o staged as fp32 rows (stride 4 mod 32 is conflict-free for the
// accumulator layout's stores and for row-wise float4 reads).
constexpr int O_STRIDE = HD + 4;
constexpr int O_FLOATS = TILE * O_STRIDE;
// The prep warps' scratch for A (one tile at a time), rows of HD + 4
// floats so that 8 rows read by float4 fall in distinct banks: r~ (16
// rows), r (16), k~_b (4 + 8 + 12, for the blocks of BLK tokens after the
// first), k~ within a block (6 per block) and k * u (16). Every entry of A
// is the dot product of two of these rows (see prep_tile).
constexpr int BLK = 4;                       // tokens per block of A
constexpr int X_STRIDE = HD + 4;
constexpr int RT_ROW = 0, RR_ROW = 16, KT_ROW = 32, KW_ROW = 56, KU_ROW = 80;
constexpr int SCRATCH_FLOATS = 96 * X_STRIDE;
constexpr int A_CROSS = 96, A_ITEMS = A_CROSS + TILE + 24;

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return 4 * TILE * HD * static_cast<int>(sizeof(T));
}

// Dynamic shared memory of one block (kernel.py `Plan.smem` mirrors it).
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<T>()
         + (2 * PREP_FLOATS + O_FLOATS + SCRATCH_FLOATS + HD) * 4
         + STAGES * 8;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 q;
  q.x = *reinterpret_cast<unsigned*>(&a);
  q.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ void state_barrier() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(STATE_THREADS) : "memory");
}
__device__ __forceinline__ void prep_barrier() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(PREP_THREADS) : "memory");
}

// Tile t of a head: tokens [start, start + len). Chunks of C tokens are cut
// into tiles of TILE tokens and a ragged rest; `tpc` = ceil(C / TILE).
struct Tile {
  int start, len;
};
__device__ __forceinline__ Tile tile_at(int t, int s, int C, int tpc) {
  const int chunk = t / tpc, m = t - chunk * tpc;
  const int start = chunk * C + m * TILE;
  return {start, min(min(TILE, C - m * TILE), s - start)};
}

template <typename T>
struct Ring {
  T* stage;        // STAGES x (r, k, v, w) x TILE x HD
  uint64_t* full;  // one mbarrier per stage
  __device__ T* operand(int st, int q) const {
    return stage + (st * 4 + q) * TILE * HD;
  }
};

// The producer: tile t's valid rows of r, k, v and w into stage t % STAGES.
template <typename T>
__device__ __forceinline__ void issue_tile(const Ring<T>& ring, int t,
                                           Tile tl, const T* const (&src)[4],
                                           size_t base) {
  const int st = t % STAGES;
  const unsigned bytes = tl.len * HD * sizeof(T);
  mbar_expect_tx(&ring.full[st], 4 * bytes);
  const size_t off = base + static_cast<size_t>(tl.start) * HD;
  for (int q = 0; q < 4; ++q)
    bulk_copy(ring.operand(st, q), src[q] + off, bytes, &ring.full[st]);
}

// Prep warps: tile t's raw rows (stage t % STAGES) into the state warps'
// operands in `pb`: r_dec, k_dec, v, A and the tile's decay W; `x` is the
// scratch for A.
//
// A[i][j] = sum_d r[i,d] k[j,d] prod_{t=j+1}^{i-1} w[t,d] below the
// diagonal, sum_d r[j,d] u[d] k[j,d] on it; above it A stays 0. The tile's
// 16 tokens are 4 blocks of BLK. For j in an earlier block than i (96
// pairs) the decay splits at i's block start 4 b:
//   A[i][j] = r~[i] . k~_b[j],  r~[i] = r[i] prod_{4b<=t<i} w[t],
//                               k~_b[j] = k[j] prod_{j<t<4b} w[t];
// within a block (24 pairs) at i itself: A[i][j] = r[i] . (k[j]
// prod_{j<t<i} w[t]), with at most two factors of w. A first phase walks
// each channel and writes these rows; a second computes the 136 dot
// products, one per thread (8 threads take two), fully unrolled, so that
// no warp waits on a long chain of dependent loads.
template <typename T>
__device__ void prep_tile(const Ring<T>& ring, int t, int len,
                          const float* u_s, float* pb, float* x, int pt) {
  const int st = t % STAGES;
  mbar_wait(&ring.full[st], (t / STAGES) & 1);
  const T* R = ring.operand(st, 0);
  const T* K = ring.operand(st, 1);
  const T* V = ring.operand(st, 2);
  const T* W = ring.operand(st, 3);

  // Per channel, rows past len read as r = k = v = 0, w = 1. Threads
  // 0..63 walk forward: r_dec[i] = r[i] prod_{t<i} w[t] (their product
  // over the tile is W), r~, r and v. Threads 64..127 walk back: k_dec[j]
  // = k[j] prod_{t>j} w[t], k~_b, k * u, and the k rows within blocks.
  {
    const int d = pt & (HD - 1);
    if (pt < HD) {
      float p = 1.f, q = 1.f;
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const bool ok = i < len;
        const float rv = ok ? to_float(R[i * HD + d]) : 0.f;
        const float wv = ok ? to_float(W[i * HD + d]) : 1.f;
        if (i % BLK == 0) q = 1.f;
        pb[RD_OFF + i * RD_STRIDE + d] = rv * p;
        x[(RT_ROW + i) * X_STRIDE + d] = rv * q;
        x[(RR_ROW + i) * X_STRIDE + d] = rv;
        pb[V_OFF + i * V_STRIDE + d] = ok ? to_float(V[i * HD + d]) : 0.f;
        p *= wv;
        q *= wv;
      }
      pb[W_OFF + d] = p;
    } else {
      float kv[TILE], wv[TILE];
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        const bool ok = j < len;
        kv[j] = ok ? to_float(K[j * HD + d]) : 0.f;
        wv[j] = ok ? to_float(W[j * HD + d]) : 1.f;
      }
      const float ud = u_s[d];
      float p = 1.f, q1 = 1.f, q2 = 1.f, q3 = 1.f;
#pragma unroll
      for (int j = TILE - 1; j >= 0; --j) {
        pb[KD_OFF + j * KD_STRIDE + d] = kv[j] * p;
        p *= wv[j];
        x[(KU_ROW + j) * X_STRIDE + d] = kv[j] * ud;
        if (j < 3 * BLK) {
          x[(KT_ROW + 12 + j) * X_STRIDE + d] = kv[j] * q3;
          q3 *= wv[j];
        }
        if (j < 2 * BLK) {
          x[(KT_ROW + 4 + j) * X_STRIDE + d] = kv[j] * q2;
          q2 *= wv[j];
        }
        if (j < BLK) {
          x[(KT_ROW + j) * X_STRIDE + d] = kv[j] * q1;
          q1 *= wv[j];
        }
      }
      // Within block c, pairs (i, j) in the order (1, 0), (2, 0), (2, 1),
      // (3, 0), (3, 1), (3, 2) from the block's start.
#pragma unroll
      for (int c = 0; c < TILE / BLK; ++c) {
        const int j0 = BLK * c;
        float* kw = x + (KW_ROW + 6 * c) * X_STRIDE + d;
        kw[0] = kv[j0];
        kw[X_STRIDE] = kv[j0] * wv[j0 + 1];
        kw[2 * X_STRIDE] = kv[j0 + 1];
        kw[3 * X_STRIDE] = kv[j0] * wv[j0 + 1] * wv[j0 + 2];
        kw[4 * X_STRIDE] = kv[j0 + 1] * wv[j0 + 2];
        kw[5 * X_STRIDE] = kv[j0 + 2];
      }
    }
  }
  prep_barrier();

  // Items 0..95: pairs across blocks (block b = 1, 2, 3 of i has 16, 32,
  // 48); 96..111: the diagonal; 112..135: pairs within a block.
  float* A = pb + A_OFF;
  for (int item = pt; item < A_ITEMS; item += PREP_THREADS) {
    int i, j, xr, yr;
    if (item < A_CROSS) {
      int b;
      if (item < 16) {
        b = 1; i = 4 + (item >> 2); j = item & 3;
      } else if (item < 48) {
        b = 2; i = 8 + ((item - 16) >> 3); j = (item - 16) & 7;
      } else {
        b = 3; i = 12 + (item - 48) / 12; j = (item - 48) % 12;
      }
      xr = RT_ROW + i;
      yr = KT_ROW + 2 * b * (b - 1) + j;
    } else if (item < A_CROSS + TILE) {
      i = j = item - A_CROSS;
      xr = RR_ROW + i;
      yr = KU_ROW + i;
    } else {
      const int q = item - A_CROSS - TILE, c = q / 6, e = q % 6;
      i = BLK * c + (e < 1 ? 1 : e < 3 ? 2 : 3);
      j = BLK * c + (e < 1 ? 0 : e < 3 ? e - 1 : e - 3);
      xr = RR_ROW + i;
      yr = KW_ROW + q;
    }
    const float* a = x + xr * X_STRIDE;
    const float* k = x + yr * X_STRIDE;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += 8) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + d0);
      const float4 k0 = *reinterpret_cast<const float4*>(k + d0);
      const float4 a1 = *reinterpret_cast<const float4*>(a + d0 + 4);
      const float4 k1 = *reinterpret_cast<const float4*>(k + d0 + 4);
      s0 = fmaf(a0.x, k0.x, s0); s1 = fmaf(a1.x, k1.x, s1);
      s0 = fmaf(a0.y, k0.y, s0); s1 = fmaf(a1.y, k1.y, s1);
      s0 = fmaf(a0.z, k0.z, s0); s1 = fmaf(a1.z, k1.z, s1);
      s0 = fmaf(a0.w, k0.w, s0); s1 = fmaf(a1.w, k1.w, s1);
    }
    store_split(A + i * A_STRIDE + 2 * j, s0 + s1);
  }
}

// State warps: tile m's output from the state before it, then the state
// after it. S[n] holds S^T[c0 + g (+ 8)][8 n + 2 t (+ 1)].
template <typename T>
__device__ __forceinline__ void state_tile(float (&S)[8][4], const float* pb,
                                           float* os, T* og, int len,
                                           int lane, int c0, int st_tid) {
  const int g = lane >> 2, t = lane & 3;
  // v^T fragments (rows c, columns i), split: the A operand of both
  // v products.
  unsigned vh[2][4], vl[2][4];
  {
    const float* V = pb + V_OFF;
    for (int kk = 0; kk < 2; ++kk) {
      const float* v0 = V + (8 * kk + t) * V_STRIDE + c0 + g;
      const float* v1 = v0 + 4 * V_STRIDE;
      split(v0[0], vh[kk][0], vl[kk][0]);
      split(v0[8], vh[kk][1], vl[kk][1]);
      split(v1[0], vh[kk][2], vl[kk][2]);
      split(v1[8], vh[kk][3], vl[kk][3]);
    }
  }

  // o^T = S^T r_dec^T + v^T A^T, in accumulators per (n-tile of i,
  // parity of the k step), big and small parts apart.
  float ob[2][2][4] = {}, osm[2][2][4] = {};
  {
    const float* RD = pb + RD_OFF;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // S^T columns 8 kk + 2 t, 8 kk + 2 t + 1 as k slots t, t + 4.
      unsigned sh[4], sl[4];
      split(S[kk][0], sh[0], sl[0]);
      split(S[kk][2], sh[1], sl[1]);
      split(S[kk][1], sh[2], sl[2]);
      split(S[kk][3], sh[3], sl[3]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const float2 q = *reinterpret_cast<const float2*>(
            RD + (8 * nn + g) * RD_STRIDE + 8 * kk + 2 * t);
        unsigned h0, l0, h1, l1;
        split(q.x, h0, l0);
        split(q.y, h1, l1);
        mma3(ob[nn][kk & 1], osm[nn][kk & 1], sh, sl,
             make_float2(__uint_as_float(h0), __uint_as_float(l0)),
             make_float2(__uint_as_float(h1), __uint_as_float(l1)));
      }
    }
    const float* A = pb + A_OFF;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const float* a = A + (8 * nn + g) * A_STRIDE + 2 * (8 * kk + t);
        mma3(ob[nn][kk], osm[nn][kk], vh[kk], vl[kk],
             *reinterpret_cast<const float2*>(a),
             *reinterpret_cast<const float2*>(a + 8));
      }
    }
  }

  // S^T = S^T diag(W) + v^T k_dec.
  {
    const float* KD = pb + KD_OFF;
    const float* W = pb + W_OFF;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 wv = *reinterpret_cast<const float2*>(W + 8 * n + 2 * t);
      float sm[4] = {};
      S[n][0] *= wv.x;
      S[n][1] *= wv.y;
      S[n][2] *= wv.x;
      S[n][3] *= wv.y;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* k0 = KD + (8 * kk + t) * KD_STRIDE + 8 * n + g;
        unsigned h0, l0, h1, l1;
        split(k0[0], h0, l0);
        split(k0[4 * KD_STRIDE], h1, l1);
        mma3(S[n], sm, vh[kk], vl[kk],
             make_float2(__uint_as_float(h0), __uint_as_float(l0)),
             make_float2(__uint_as_float(h1), __uint_as_float(l1)));
      }
      for (int c = 0; c < 4; ++c) S[n][c] += sm[c];
    }
  }

  // o through shared memory, stored as whole rows.
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
    float o4[4];
    for (int c = 0; c < 4; ++c)
      o4[c] = (ob[nn][0][c] + osm[nn][0][c]) + (ob[nn][1][c] + osm[nn][1][c]);
    float* p = os + (8 * nn + 2 * t) * O_STRIDE + c0 + g;
    p[0] = o4[0];
    p[O_STRIDE] = o4[1];
    p[8] = o4[2];
    p[O_STRIDE + 8] = o4[3];
  }
  state_barrier();
  for (int q = st_tid; q < len * (HD / 4); q += STATE_THREADS) {
    const int i = q >> 4, c = (q & 15) * 4;
    store4(og + i * HD + c, *reinterpret_cast<const float4*>(os + i * O_STRIDE + c));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
rwkv_scan_head(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, T* __restrict__ o,
               float* __restrict__ s_final, int H, int s, int C,
               int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring<T> ring{reinterpret_cast<T*>(smem), nullptr};
  float* prep = reinterpret_cast<float*>(smem + STAGES * stage_bytes<T>());
  float* os = prep + 2 * PREP_FLOATS;
  float* scratch = os + O_FLOATS;
  float* u_s = scratch + SCRATCH_FLOATS;
  ring.full = reinterpret_cast<uint64_t*>(u_s + HD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool state = warp < STATE_WARPS;
  const int bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * s * HD;
  const int tpc = (C + TILE - 1) / TILE;
  const T* const src[4] = {r, k, v, w};

  for (int i = tid; i < 2 * PREP_FLOATS; i += THREADS) prep[i] = 0.f;
  for (int i = tid; i < HD; i += THREADS) u_s[i] = u[(bh % H) * HD + i];
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&ring.full[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == PRODUCER) {
    for (int t = 0; t < min(STAGES, ntiles); ++t)
      issue_tile(ring, t, tile_at(t, s, C, tpc), src, base);
  }
  if (!state) prep_tile(ring, 0, tile_at(0, s, C, tpc).len, u_s, prep,
                        scratch, tid - STATE_THREADS);
  __syncthreads();

  float S[8][4] = {};
  const int c0 = 16 * warp;
  for (int m = 0; m < ntiles; ++m) {
    if (state) {
      const Tile tl = tile_at(m, s, C, tpc);
      state_tile(S, prep + (m & 1) * PREP_FLOATS, os,
                 o + base + static_cast<size_t>(tl.start) * HD, tl.len, lane,
                 c0, tid);
    } else {
      if (tid == PRODUCER && m + STAGES < ntiles)
        issue_tile(ring, m + STAGES, tile_at(m + STAGES, s, C, tpc), src,
                   base);
      if (m + 1 < ntiles)
        prep_tile(ring, m + 1, tile_at(m + 1, s, C, tpc).len, u_s,
                  prep + ((m + 1) & 1) * PREP_FLOATS, scratch,
                  tid - STATE_THREADS);
    }
    __syncthreads();
  }

  if (state) {
    const int g = lane >> 2, t = lane & 3;
    float* out = s_final + static_cast<size_t>(bh) * HD * HD;
    for (int n = 0; n < 8; ++n) {
      float* p = out + (8 * n + 2 * t) * HD + c0 + g;
      p[0] = S[n][0];
      p[HD] = S[n][1];
      p[8] = S[n][2];
      p[HD + 8] = S[n][3];
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, void* s_final, int b, int H, int s, int C,
           int smem, cudaStream_t stream) {
  if (smem != smem_bytes<T>()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_scan_head<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tpc = (C + TILE - 1) / TILE;
  const int ntiles = (s / C) * tpc + (s % C + TILE - 1) / TILE;
  rwkv_scan_head<T><<<b * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(o),
      static_cast<float*>(s_final), H, s, C, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and o share it); u is
// float32. Layouts: r/k/v/w/o (b, H, s, 64), u (H, 64), s_final
// (b, H, 64, 64), all contiguous and 16-byte aligned. 1 <= chunk <= 64,
// 1 <= b * H <= 65535; `smem` is the block's shared-memory bytes as
// kernel.py plans them (checked against the kernel's own count). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int rwkv_scan(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* o,
                         void* s_final, int b, int H, int s, int chunk,
                         int dtype, int smem, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || s < 1 || b < 1 || H < 1 ||
      b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, o, s_final, b, H, s, chunk, smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, o, s_final, b, H, s, chunk,
                                 smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
