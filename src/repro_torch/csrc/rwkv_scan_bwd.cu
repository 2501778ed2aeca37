// Backward of the RWKV6 time-mix scan for Hopper (sm_90a):
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,  o_t = r_t (diag(u) k_t^T v_t + S_{t-1})
//
// from a zero state, given do (the gradient of o) and, optionally, dS (the
// gradient of the final state S_{s-1}). With G_t = dL/dS_t, G_{s-1} = dS
// (or zero) and, walking back, G_{t-1} = diag(w_t) G_t + r_t^T do_t:
//
//   dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
//   dk_t = G_t v_t + u * r_t (v_t . do_t)
//   dv_t = G_t^T k_t + (sum_i r_t u k_t) do_t
//   dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//   du = sum over b and t of r_t * k_t (v_t . do_t)
//
// Layouts as the forward kernel's (csrc/rwkv_scan.cu): r, k, v, w, do and
// the gradients dr, dk, dv, dw (b, H, s, 64) in the input dtype (the
// wrapper transposes from (b, s, H, hd) and pads a smaller head dim with
// r = k = v = do = 0, w = 1), u (H, 64) fp32, dS (b, H, 64, 64) fp32.
//
// The gradient of the Pallas TPU kernel `rwkv_scan`
// (src/repro/kernels/rwkv_scan/kernel.py). The JAX package has no backward
// kernel: XLA differentiates its jnp scan (src/repro/models/rwkv6.py). This
// kernel computes the same gradient.
//
// What bounds it: at rwkv6-3b's training shape (b 4 x s 128 x H 40, fp32)
// each input is read once and each gradient written once, 47 MB (14 us at
// 3.35 TB/s). The arithmetic, counted as the plain backward does it (one
// forward state update and five hd x hd products a token and head, 12 hd^2
// multiply-adds), is 1.01e9 operations: 15.0 us at the fp32 CUDA-core peak
// of 67 TFLOP/s, the bound. The checkpoints below add 16 MB written and
// read, which stay in the 50 MB L2. What no design shortens is the walk:
// per head, two chains of s / 16 dependent tile steps through S and G.
// Measured on an H100 (PERF.md): 231,720 bytes of shared memory (fp32)
// leave one block per SM, so the 160 blocks run in two waves, and the
// state and prep warps each take about as long per tile.
//
// Design: the forward kernel's tile algebra, run forward once for the
// states and back once for the gradients, in one block per (b, h).
// * Tiles of TILE = 16 tokens from 0, the last one ragged and padded with
//   r = k = v = do = 0, w = 1 (which change no state, gradient or decay).
//   Per tile, with before_t = prod_{t'<t} w, after_t = prod_{t'>t} w,
//   W = prod w, the forward's 16 x 16 matrix A and dA = do v^T (on and
//   below the diagonal), S_in the state before the tile and G_out the
//   gradient of the state after it:
//     D = diag(G_out S_in^T),  P = v G_out^T,  Q = do S_in^T
//     dv = (k * after) G_out + A^T do
//     dr = before * Q + [dA k-terms],   dk = after * P + [dA r-terms]
//     dw = before after D + after c + before e + g4,
//     G_in = diag(W) G_out + (r * before)^T do,
//   with c and e running sums over P and Q through the tile and g4 the
//   dA terms of dw (kernels/rwkv_scan/ref.py `rwkv_scan_bwd_chunked_ref`
//   writes out every term; the tests hold it against jax.vjp). dw is
//   dw_t = sum_j G_t S_{t-1} with G_t and S_{t-1} expanded from G_out
//   and S_in: every decay is a product of w over a segment,
//   built by running products, and none is ever divided (w may be 1e-35).
// * 512 threads: eight state warps and eight prep warps (one block per SM:
//   the 160 blocks of the training shape run in two waves, so each block
//   takes as many warps as its registers allow). The walk forward (tiles
//   0 .. M-2) keeps S^T in the state warps' mma accumulators and stores
//   the state before each tile but the first, (64, 64) fp32, to the
//   scratch (b, H, M - 1, 64, 64); the last one goes straight to shared
//   memory. The walk back (tiles M-1 .. 0) keeps G^T in
//   the same accumulators from dS. While the state warps run tile m, the
//   prep warps build tile m - 1's operands: the decays, r * before,
//   k * after, A (136 dot products, as the forward), dA (on tensor cores)
//   and the terms that need no state (dr's and dk's dA sums and g4, each a
//   walk over the tile's tokens per channel).
// * State warp (q, h) owns rows 16q..16q+15 of S^T and G^T (value
//   columns) for key channels 32h..32h+31. dv^T = G^T (k * after)^T +
//   do^T A and the G update are the forward's o^T and S^T products (the
//   accumulators read as A operands; dv's two halves of the key sum meet
//   in shared memory); P and Q sum over the value columns, so G_out is
//   written to shared memory and warp (q, h) takes key rows 16q.. and
//   tokens 8h.. of P^T = G_out v^T and Q^T = S_in do^T. All products are
//   mma.sync m16n8k8 in 3xTF32, as in the forward.
// * S_in and the copy of G_out are (64, 64) fp32 in an XOR-swizzled row
//   layout (`swz`): the state warps' accumulator positions and the A
//   operand fragments (two columns a lane, read as float2) both fall in 32
//   distinct banks.
// * Tiles copied ahead: TMA bulk copies on mbarriers (cp.async.bulk ...
//   complete_tx), a ring of 3 stages of whole rows (a tile of one operand
//   of one head is one contiguous row of 16 x 64 elements), k, v and w on
//   the walk forward, r, k, v, w and do on the walk back, taken in reverse.
//   The state warps read the raw w, k and r of their own tile, so on the
//   walk back the ring holds tile m (state warps), m - 1 (prep warps) and
//   m - 2 (in flight), one operand copied by each of five lanes of a
//   prep warp. S_in of tile m - 1 is copied, in its own pair of buffers,
//   while tile m is computed.
// * du without atomics: each block sums its (b, h) share in a fixed order
//   into du_part (b, H, 64); the wrapper sums du_part over b, also in a
//   fixed order. Two calls give identical bits. No fast-math intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

constexpr int HD = 64;          // head dim of the kernel (the wrapper pads)
constexpr int TILE = 16;        // tokens per tile
constexpr int STAGES = 3;
constexpr int STATE_WARPS = 8;
constexpr int PREP_WARPS = 8;
constexpr int STATE_THREADS = 32 * STATE_WARPS;
constexpr int PREP_THREADS = 32 * PREP_WARPS;
constexpr int THREADS = STATE_THREADS + PREP_THREADS;
constexpr int PRODUCER = STATE_THREADS;   // the first prep thread
// Operands of a ring stage, in order.
constexpr int OP_R = 0, OP_K = 1, OP_V = 2, OP_W = 3, OP_DO = 4, OPS = 5;
// Prep buffer, in floats: k * after, r * before, v and do in fp32 rows of
// ROW floats (8 mod 32: every fragment load below is free of bank
// conflicts), A^T in (hi, lo) pairs, W, and dr's, dk's and dw's terms that
// need no state (dw's in two parts), in rows of HD.
constexpr int ROW = HD + 8;
constexpr int A_STRIDE = 2 * TILE + 8;
constexpr int KD_OFF = 0;
constexpr int RD_OFF = KD_OFF + TILE * ROW;
constexpr int V_OFF = RD_OFF + TILE * ROW;
constexpr int DO_OFF = V_OFF + TILE * ROW;
constexpr int AT_OFF = DO_OFF + TILE * ROW;
constexpr int W_OFF = AT_OFF + TILE * A_STRIDE;
constexpr int DRP_OFF = W_OFF + HD;
constexpr int DKP_OFF = DRP_OFF + TILE * HD;
constexpr int DWP_OFF = DKP_OFF + TILE * HD;
constexpr int DWQ_OFF = DWP_OFF + TILE * HD;
constexpr int PREP_FLOATS = DWQ_OFF + TILE * HD;
constexpr int STATE_FLOATS = HD * HD;
// P^T, Q^T and dv's two halves staged as [token][channel] rows (4 mod 32:
// the accumulator layout's stores are conflict-free), and the four warp
// rows' parts of D.
constexpr int PQ = HD + 4;
// The prep warps' scratch for A, as the forward's: rows of HD + 4 floats,
// r~ (16 rows), r (16), k~_b (4 + 8 + 12), k within blocks (6 per block)
// and k * u (16); then dA (16 x 16).
constexpr int BLK = 4;
constexpr int X_STRIDE = HD + 4;
constexpr int RT_ROW = 0, RR_ROW = 16, KT_ROW = 32, KW_ROW = 56, KU_ROW = 80;
constexpr int SCRATCH_FLOATS = 96 * X_STRIDE;
constexpr int A_CROSS = 96, A_ITEMS = A_CROSS + TILE + 24;

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return OPS * TILE * HD * static_cast<int>(sizeof(T));
}

// Dynamic shared memory of one block: the ring, two S_in buffers, the copy
// of G_out, two prep buffers, P^T, Q^T and dv's halves, D's parts, the A
// scratch, dA, u, and the mbarriers (3 for the ring, 2 for S_in).
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<T>()
         + (3 * STATE_FLOATS + 2 * PREP_FLOATS + 4 * TILE * PQ + 4 * HD
            + SCRATCH_FLOATS + TILE * TILE + HD) * 4
         + (STAGES + 2) * 8;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element (i, j) of a (64, 64) fp32 matrix in the swizzled layout: row i,
// its columns XOR-ed in groups of 8 by two bits of i. A lane's accumulator
// positions (i = 8n + 2t + a, j = c0 + g + 8b) and A-operand pairs
// (i = c0 + g (+8), j = 8kk + 2t, +1) both fall in 32 distinct banks.
__device__ __forceinline__ int swz(int i, int j) {
  const int f = ((i ^ (i >> 1)) & 1) | ((((i >> 1) ^ (i >> 2)) & 1) << 1);
  return i * HD + (j ^ (f << 3));
}

// --- TF32 operands --------------------------------------------------------

__device__ __forceinline__ float2 split2(float x) {
  unsigned hi, lo;
  split(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}
// The B operand (k = 8kk + 2t, +1; n = g) of a row-major fp32 matrix
// whose row g starts at `row`, split: the k order inside an 8-wide step
// is permuted (slot t <-> column 2t, slot t + 4 <-> 2t + 1) the same way
// in the A operand.
__device__ __forceinline__ void pair_b(const float* row, int kk, int t,
                                       float2& b0, float2& b1) {
  const float2 q = *reinterpret_cast<const float2*>(row + 8 * kk + 2 * t);
  b0 = split2(q.x);
  b1 = split2(q.y);
}

// --- fences and barriers -------------------------------------------------

// Order this thread's generic writes before later bulk copies (the async
// proxy) that read (global) or overwrite (shared) the same bytes.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void state_barrier() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(STATE_THREADS) : "memory");
}
__device__ __forceinline__ void prep_barrier() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(PREP_THREADS) : "memory");
}
// State roles 1 and 3 (two warps each) hand dw's first part over.
__device__ __forceinline__ void dw_barrier(bool wait) {
  if (wait)
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
  else
    asm volatile("bar.arrive 3, 128;\n" ::: "memory");
}

// The walk's items: 0 .. M-2 the tiles forward, then tiles M-1 .. 0 back.
struct Walk {
  int M;
  __device__ int items() const { return 2 * M - 1; }
  __device__ bool forward(int x) const { return x < M - 1; }
  __device__ int tile(int x) const { return x < M - 1 ? x : 2 * M - 2 - x; }
};

template <typename T>
struct Ring {
  T* stage;        // STAGES x (r, k, v, w, do) x TILE x HD
  uint64_t* full;  // one mbarrier per stage
  __device__ const T* operand(int x, int q) const {
    return stage + ((x % STAGES) * OPS + q) * TILE * HD;
  }
  __device__ void wait(int x) const {
    mbar_wait(&full[x % STAGES], (x / STAGES) & 1);
  }
};

// The producer warp: item x's valid rows (k, v, w forward; all five back)
// into stage x % STAGES, one operand per lane.
template <typename T>
__device__ __forceinline__ void issue_item(const Ring<T>& ring, Walk wk,
                                           int x, const T* const (&src)[OPS],
                                           size_t base, int s, int lane) {
  const int st = x % STAGES, t0 = wk.tile(x) * TILE;
  const unsigned bytes = min(TILE, s - t0) * HD * sizeof(T);
  const bool fwd = wk.forward(x);
  if (lane == 0) mbar_expect_tx(&ring.full[st], (fwd ? 3 : OPS) * bytes);
  __syncwarp();
  const int q = lane + (fwd ? OP_K : OP_R);
  if (q <= (fwd ? OP_W : OP_DO))
    bulk_copy(const_cast<T*>(ring.operand(x, q)),
              src[q] + base + static_cast<size_t>(t0) * HD, bytes,
              &ring.full[st]);
}

// Column d of tile operand X (rows past len read as `pad`).
template <typename T>
__device__ __forceinline__ void column(const T* X, int d, int len, float pad,
                                       float (&out)[TILE]) {
#pragma unroll
  for (int i = 0; i < TILE; ++i)
    out[i] = i < len ? to_float(X[i * HD + d]) : pad;
}

// --- prep warps ------------------------------------------------------------
// Prep thread pt takes channel d = pt % 64 in role pt / 64.

// A tile of the walk forward: v in fp32 rows (role 0), k * after and W
// (role 1).
template <typename T>
__device__ void prep_forward(const Ring<T>& ring, int x, int len, float* pb,
                             int pt) {
  ring.wait(x);
  const int d = pt & (HD - 1), role = pt / HD;
  if (role == 0) {
    float vv[TILE];
    column(ring.operand(x, OP_V), d, len, 0.f, vv);
#pragma unroll
    for (int i = 0; i < TILE; ++i) pb[V_OFF + i * ROW + d] = vv[i];
  } else if (role == 1) {
    float kv[TILE], wv[TILE];
    column(ring.operand(x, OP_K), d, len, 0.f, kv);
    column(ring.operand(x, OP_W), d, len, 1.f, wv);
    float p = 1.f;
#pragma unroll
    for (int j = TILE - 1; j >= 0; --j) {
      pb[KD_OFF + j * ROW + d] = kv[j] * p;
      p *= wv[j];
    }
    pb[W_OFF + d] = p;
  }
}

// A tile of the walk back, in three phases between prep barriers:
// 1. per channel: r * before, W and the r rows of A's dot products (role
//    0, walking forward); v and do rows (1); k * after, k * u and k~_b
//    (2, walking back); k within blocks (3).
// 2. A's 136 dot products, stored as A^T split; dA = do v^T on tensor
//    cores by prep warps 6 and 7 (8 token columns each).
// 3. per channel, the terms that need no state, with
//      h_t'(t) = sum_{tau<t} dA[t',tau] k_tau prod_{tau<t''<t} w:
//      dr_part[t'] = h_t'(t') + dA[t',t'] u k_t',
//      g4_t = sum_{t'>t} r_t' prod_{t<t''<t'} w h_t'(t)
//    (roles 0 and 1 for t' < 12 and t' >= 12, g4 in two parts), and
//      dk_part[tau] = sum_{t>tau} dA[t,tau] r_t prod_{tau<t''<t} w
//                     + dA[tau,tau] u r_tau
//    with du's share (roles 2 and 3 for tau < 5 and tau >= 5).
template <typename T>
__device__ void prep_back(const Ring<T>& ring, int x, int len,
                          const float* u_s, float* pb, float* xs, float* dA,
                          float& du_acc, int pt, int lane) {
  ring.wait(x);
  const int d = pt & (HD - 1), role = pt / HD;
  const float ud = u_s[d];
  float rv[TILE], kv[TILE], wv[TILE];
  column(ring.operand(x, OP_R), d, len, 0.f, rv);
  column(ring.operand(x, OP_K), d, len, 0.f, kv);
  column(ring.operand(x, OP_W), d, len, 1.f, wv);
  if (role == 0) {
    float p = 1.f, q = 1.f;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (i % BLK == 0) q = 1.f;
      pb[RD_OFF + i * ROW + d] = rv[i] * p;
      xs[(RT_ROW + i) * X_STRIDE + d] = rv[i] * q;
      xs[(RR_ROW + i) * X_STRIDE + d] = rv[i];
      p *= wv[i];
      q *= wv[i];
    }
    pb[W_OFF + d] = p;
  } else if (role == 1) {
    float vv[TILE], dv[TILE];
    column(ring.operand(x, OP_V), d, len, 0.f, vv);
    column(ring.operand(x, OP_DO), d, len, 0.f, dv);
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      pb[V_OFF + i * ROW + d] = vv[i];
      pb[DO_OFF + i * ROW + d] = dv[i];
    }
  } else if (role == 2) {
    float p = 1.f, q1 = 1.f, q2 = 1.f, q3 = 1.f;
#pragma unroll
    for (int j = TILE - 1; j >= 0; --j) {
      pb[KD_OFF + j * ROW + d] = kv[j] * p;
      p *= wv[j];
      xs[(KU_ROW + j) * X_STRIDE + d] = kv[j] * ud;
      if (j < 3 * BLK) {
        xs[(KT_ROW + 12 + j) * X_STRIDE + d] = kv[j] * q3;
        q3 *= wv[j];
      }
      if (j < 2 * BLK) {
        xs[(KT_ROW + 4 + j) * X_STRIDE + d] = kv[j] * q2;
        q2 *= wv[j];
      }
      if (j < BLK) {
        xs[(KT_ROW + j) * X_STRIDE + d] = kv[j] * q1;
        q1 *= wv[j];
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < TILE / BLK; ++c) {
      const int j0 = BLK * c;
      float* kw = xs + (KW_ROW + 6 * c) * X_STRIDE + d;
      kw[0] = kv[j0];
      kw[X_STRIDE] = kv[j0] * wv[j0 + 1];
      kw[2 * X_STRIDE] = kv[j0 + 1];
      kw[3 * X_STRIDE] = kv[j0] * wv[j0 + 1] * wv[j0 + 2];
      kw[4 * X_STRIDE] = kv[j0 + 1] * wv[j0 + 2];
      kw[5 * X_STRIDE] = kv[j0 + 2];
    }
  }
  prep_barrier();

  // A: items 0..95 pairs across blocks, 96..111 the diagonal, 112..135
  // pairs within a block (the forward's prep_tile); A[i][j] goes to
  // A^T[j][i].
  if (pt < A_ITEMS) {
    const int item = pt;
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
    const float* a = xs + xr * X_STRIDE;
    const float* k = xs + yr * X_STRIDE;
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
    store_split(pb + AT_OFF + j * A_STRIDE + 2 * i, s0 + s1);
  }
  // dA[t][tau] = do_t . v_tau for tau in 8 nn .. 8 nn + 7.
  if (pt >= PREP_THREADS - 64) {
    const int nn = (pt - (PREP_THREADS - 64)) >> 5, g = lane >> 2,
              t = lane & 3;
    const float* DO = pb + DO_OFF;
    float big[2][4] = {}, sm[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float2 a0 = *reinterpret_cast<const float2*>(
          DO + g * ROW + 8 * kk + 2 * t);
      const float2 a1 = *reinterpret_cast<const float2*>(
          DO + (g + 8) * ROW + 8 * kk + 2 * t);
      unsigned ah[4], al[4];
      split(a0.x, ah[0], al[0]);
      split(a1.x, ah[1], al[1]);
      split(a0.y, ah[2], al[2]);
      split(a1.y, ah[3], al[3]);
      float2 b0, b1;
      pair_b(pb + V_OFF + (8 * nn + g) * ROW, kk, t, b0, b1);
      mma3(big[kk & 1], sm[kk & 1], ah, al, b0, b1);
    }
    float* p = dA + g * TILE + 8 * nn + 2 * t;
    p[0] = (big[0][0] + sm[0][0]) + (big[1][0] + sm[1][0]);
    p[1] = (big[0][1] + sm[0][1]) + (big[1][1] + sm[1][1]);
    p[8 * TILE] = (big[0][2] + sm[0][2]) + (big[1][2] + sm[1][2]);
    p[8 * TILE + 1] = (big[0][3] + sm[0][3]) + (big[1][3] + sm[1][3]);
  }
  prep_barrier();

  if (role < 2) {
    const int tp0 = role == 0 ? 0 : 12, tp1 = role == 0 ? 12 : TILE;
    float g4[TILE] = {};
#pragma unroll
    for (int tp = 0; tp < TILE; ++tp) {
      if (tp < tp0 || tp >= tp1) continue;
      float h = 0.f, hs[TILE];
#pragma unroll
      for (int t = 0; t < tp; ++t) {
        hs[t] = h;
        h = fmaf(wv[t], h, dA[tp * TILE + t] * kv[t]);
      }
      pb[DRP_OFF + tp * HD + d] = fmaf(dA[tp * TILE + tp] * ud, kv[tp], h);
      float rho = rv[tp];
#pragma unroll
      for (int t = tp - 1; t >= 1; --t) {
        g4[t] = fmaf(rho, hs[t], g4[t]);
        rho *= wv[t];
      }
    }
    float* out = pb + (role == 0 ? DWP_OFF : DWQ_OFF) + d;
#pragma unroll
    for (int t = 0; t < TILE; ++t) out[t * HD] = g4[t];
  } else {
    const int t0 = role == 2 ? 0 : 5, t1 = role == 2 ? 5 : TILE;
#pragma unroll
    for (int tau = 0; tau < TILE; ++tau) {
      if (tau < t0 || tau >= t1) continue;
      const float diag = dA[tau * TILE + tau];
      float acc = diag * ud * rv[tau], rho = 1.f;
#pragma unroll
      for (int t = tau + 1; t < TILE; ++t) {
        acc = fmaf(dA[t * TILE + tau] * rv[t], rho, acc);
        rho *= wv[t];
      }
      pb[DKP_OFF + tau * HD + d] = acc;
      du_acc = fmaf(diag * rv[tau], kv[tau], du_acc);
    }
  }
}

// --- state warps -----------------------------------------------------------
// State warp (q, h) = (warp % 4, warp / 4) holds, for n = 4h .. 4h + 3,
// X^T[c0 + g (+ 8)][8 n + 2 t (+ 1)] (X = S or G, c0 = 16 q), that is
// X[i = 8n + 2t + (c & 1)][j = c0 + g + 8 (c >> 1)] in X[n - 4h][c].

// The A operands of Y^T rows c0.., k = tokens (Y = v or do): fp32 rows of
// the prep buffer, split.
__device__ __forceinline__ void token_a(const float* Y, int c0, int g, int t,
                                        unsigned (&h)[2][4],
                                        unsigned (&l)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* y0 = Y + (8 * kk + t) * ROW + c0 + g;
    const float* y1 = y0 + 4 * ROW;
    split(y0[0], h[kk][0], l[kk][0]);
    split(y0[8], h[kk][1], l[kk][1]);
    split(y1[0], h[kk][2], l[kk][2]);
    split(y1[8], h[kk][3], l[kk][3]);
  }
}

// X^T <- X^T diag(W) + Y^T Z on this warp's key columns 8 n0 .. 8 n0 + 31,
// Z a (TILE, 64) row block of the prep buffer.
__device__ __forceinline__ void state_update(float (&X)[4][4], const float* Z,
                                             const float* W,
                                             const unsigned (&yh)[2][4],
                                             const unsigned (&yl)[2][4],
                                             int n0, int g, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = 8 * (n0 + n);
    const float2 wv = *reinterpret_cast<const float2*>(W + col + 2 * t);
    float sm[4] = {};
    X[n][0] *= wv.x;
    X[n][1] *= wv.y;
    X[n][2] *= wv.x;
    X[n][3] *= wv.y;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* z0 = Z + (8 * kk + t) * ROW + col + g;
      mma3(X[n], sm, yh[kk], yl[kk], split2(z0[0]), split2(z0[4 * ROW]));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) X[n][c] += sm[c];
  }
}

// out[token][i] for i in c0 .. c0 + 15 and tokens 8 nn .. 8 nn + 7 =
// sum_j X[i][j] Y[token][j]: X a swizzled (64, 64) matrix in shared
// memory, Y (TILE, 64) prep rows.
__device__ __forceinline__ void rows_times(const float* X, const float* Y,
                                           float* out, int c0, int nn, int g,
                                           int t) {
  float big[2][4] = {}, sm[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(
        X + swz(c0 + g, 8 * kk + 2 * t));
    const float2 x1 = *reinterpret_cast<const float2*>(
        X + swz(c0 + g + 8, 8 * kk + 2 * t));
    unsigned ah[4], al[4];
    split(x0.x, ah[0], al[0]);
    split(x1.x, ah[1], al[1]);
    split(x0.y, ah[2], al[2]);
    split(x1.y, ah[3], al[3]);
    float2 b0, b1;
    pair_b(Y + (8 * nn + g) * ROW, kk, t, b0, b1);
    mma3(big[kk & 1], sm[kk & 1], ah, al, b0, b1);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out[(8 * nn + 2 * t + (c & 1)) * PQ + c0 + g + 8 * (c >> 1)] =
        (big[0][c] + sm[0][c]) + (big[1][c] + sm[1][c]);
}

// A tile of the walk forward: S^T <- S^T diag(W) + v^T (k * after), then
// the state before the next tile to `ck` (global) or, for the last one,
// `sb` (shared), swizzled.
__device__ void state_forward(float (&S)[4][4], const float* pb, float* ck,
                              float* sb, int lane, int c0, int n0) {
  const int g = lane >> 2, t = lane & 3;
  unsigned vh[2][4], vl[2][4];
  token_a(pb + V_OFF, c0, g, t, vh, vl);
  state_update(S, pb + KD_OFF, pb + W_OFF, vh, vl, n0, g, t);
  float* out = sb ? sb : ck;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[swz(8 * (n0 + n) + 2 * t + (c & 1), c0 + g + 8 * (c >> 1))] =
          S[n][c];
  if (sb)
    fence_async_shared();
  else
    fence_async_global();
}

// A tile of the walk back (see the header). `sb` is S_in (null for tile
// 0, whose state is zero); R, K, W the raw tile in the ring; the
// gradients' pointers are at the tile's first token.
template <typename T>
__device__ void state_back(float (&G)[4][4], const float* pb, const float* sb,
                           float* gs, float* ps, float* qs, float* dvs,
                           float* dp, const T* R, const T* K, const T* W,
                           T* dr, T* dk, T* dv, T* dw, int len, int lane,
                           int warp, int st_tid) {
  const int g = lane >> 2, t = lane & 3;
  const int q = warp & 3, h = warp >> 2, c0 = 16 * q, n0 = 4 * h;

  // G_out to shared memory; D's part over this warp's value columns.
  float part[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = 8 * (n0 + n) + 2 * t + a;
      gs[swz(i, c0 + g)] = G[n][a];
      gs[swz(i, c0 + g + 8)] = G[n][a + 2];
      part[n][a] = sb ? fmaf(G[n][a], sb[swz(i, c0 + g)],
                             G[n][a + 2] * sb[swz(i, c0 + g + 8)])
                      : 0.f;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        part[n][a] += __shfl_xor_sync(0xffffffffu, part[n][a], o);
    }
  }
  if (g == 0) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int a = 0; a < 2; ++a)
        dp[q * HD + 8 * (n0 + n) + 2 * t + a] = part[n][a];
  }

  // This warp's half of the key sum of dv^T = G^T (k * after)^T (plus
  // do^T A in half 0), to dvs[h].
  unsigned dh[2][4], dl[2][4];
  token_a(pb + DO_OFF, c0, g, t, dh, dl);
  {
    float ob[2][2][4] = {}, osm[2][2][4] = {};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      unsigned sh[4], sl[4];
      split(G[n][0], sh[0], sl[0]);
      split(G[n][2], sh[1], sl[1]);
      split(G[n][1], sh[2], sl[2]);
      split(G[n][3], sh[3], sl[3]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        float2 b0, b1;
        pair_b(pb + KD_OFF + (8 * nn + g) * ROW, n0 + n, t, b0, b1);
        mma3(ob[nn][n & 1], osm[nn][n & 1], sh, sl, b0, b1);
      }
    }
    if (h == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const float* a = pb + AT_OFF + (8 * nn + g) * A_STRIDE +
                           2 * (8 * kk + t);
          mma3(ob[nn][kk], osm[nn][kk], dh[kk], dl[kk],
               *reinterpret_cast<const float2*>(a),
               *reinterpret_cast<const float2*>(a + 8));
        }
      }
    }
    float* out = dvs + h * TILE * PQ;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(8 * nn + 2 * t + (c & 1)) * PQ + c0 + g + 8 * (c >> 1)] =
            (ob[nn][0][c] + osm[nn][0][c]) + (ob[nn][1][c] + osm[nn][1][c]);
  }

  // Q^T = S_in do^T, rows c0.., tokens 8h.. (zero for tile 0).
  if (sb) {
    rows_times(sb, pb + DO_OFF, qs, c0, h, g, t);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qs[(8 * h + 2 * t + (c & 1)) * PQ + c0 + g + 8 * (c >> 1)] = 0.f;
  }

  // G_in = diag(W) G_out + (r * before)^T do.
  state_update(G, pb + RD_OFF, pb + W_OFF, dh, dl, n0, g, t);
  state_barrier();

  // P^T = G_out v^T, rows c0.., tokens 8h.. .
  rows_times(gs, pb + V_OFF, ps, c0, h, g, t);
  state_barrier();

  // Per channel: dk (role 0), dr (2), dv's halves summed (3); dw's terms
  // but before e (role 1, into the copy of G_out, now free), then dw
  // (role 3).
  const int i = st_tid & (HD - 1), role = st_tid / HD;
  if (role == 3) {
#pragma unroll
    for (int s = 0; s < TILE; ++s)
      if (s < len)
        store(dv + s * HD + i, dvs[s * PQ + i] + dvs[(TILE + s) * PQ + i]);
  }
  float wv[TILE], bef[TILE], aft[TILE];
  column(W, i, len, 1.f, wv);
  {
    float p = 1.f, q = 1.f;
#pragma unroll
    for (int s = 0; s < TILE; ++s) {
      bef[s] = p;
      p *= wv[s];
      aft[TILE - 1 - s] = q;
      q *= wv[TILE - 1 - s];
    }
  }
  if (role == 0) {
#pragma unroll
    for (int s = 0; s < TILE; ++s)
      if (s < len)
        store(dk + s * HD + i,
              fmaf(aft[s], ps[s * PQ + i], pb[DKP_OFF + s * HD + i]));
  } else if (role == 1) {
    float kv[TILE];
    column(K, i, len, 0.f, kv);
    const float D = ((dp[i] + dp[HD + i]) + dp[2 * HD + i]) + dp[3 * HD + i];
    float c = 0.f;
#pragma unroll
    for (int s = 0; s < TILE; ++s) {
      const float P = ps[s * PQ + i];
      gs[s * HD + i] = fmaf(bef[s] * aft[s], D, aft[s] * c) +
                       (pb[DWP_OFF + s * HD + i] + pb[DWQ_OFF + s * HD + i]);
      c = fmaf(wv[s], c, kv[s] * P);
    }
    dw_barrier(false);
  } else if (role == 3) {
    float rv[TILE], g3[TILE];
    column(R, i, len, 0.f, rv);
    float e = 0.f;
#pragma unroll
    for (int s = TILE - 1; s >= 0; --s) {
      g3[s] = bef[s] * e;
      e = fmaf(wv[s], e, rv[s] * qs[s * PQ + i]);
    }
    dw_barrier(true);
#pragma unroll
    for (int s = 0; s < TILE; ++s)
      if (s < len) store(dw + s * HD + i, gs[s * HD + i] + g3[s]);
  } else {
#pragma unroll
    for (int s = 0; s < TILE; ++s)
      if (s < len)
        store(dr + s * HD + i,
              fmaf(bef[s], qs[s * PQ + i], pb[DRP_OFF + s * HD + i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
rwkv_scan_bwd_head(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u, const T* __restrict__ dout,
                   const float* __restrict__ dS, T* __restrict__ dr,
                   T* __restrict__ dk, T* __restrict__ dv,
                   T* __restrict__ dw, float* __restrict__ du_part,
                   float* __restrict__ ckpt, int H, int s) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring<T> ring{reinterpret_cast<T*>(smem), nullptr};
  float* sbuf = reinterpret_cast<float*>(smem + STAGES * stage_bytes<T>());
  float* gs = sbuf + 2 * STATE_FLOATS;
  float* prep = gs + STATE_FLOATS;
  float* ps = prep + 2 * PREP_FLOATS;
  float* qs = ps + TILE * PQ;
  float* dvs = qs + TILE * PQ;
  float* dp = dvs + 2 * TILE * PQ;
  float* xs = dp + 4 * HD;
  float* dA = xs + SCRATCH_FLOATS;
  float* u_s = dA + TILE * TILE;
  ring.full = reinterpret_cast<uint64_t*>(u_s + HD);
  uint64_t* sbar = ring.full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool state = warp < STATE_WARPS;
  const int pt = tid - STATE_THREADS;
  const int bh = blockIdx.x;
  const Walk wk{(s + TILE - 1) / TILE};
  const int N = wk.items(), M = wk.M;
  const size_t base = static_cast<size_t>(bh) * s * HD;
  const T* const src[OPS] = {r, k, v, w, dout};
  float* const ck = ckpt + static_cast<size_t>(bh) * (M - 1) * STATE_FLOATS;

  for (int i = tid; i < 2 * PREP_FLOATS; i += THREADS) prep[i] = 0.f;
  for (int i = tid; i < HD; i += THREADS) u_s[i] = u[(bh % H) * HD + i];
  if (tid == 0) {
    for (int st = 0; st < STAGES + 2; ++st) mbar_init(&ring.full[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  int next = 0;   // the producer warp's next item to copy
  if (warp == PRODUCER / 32)
    for (; next < min(STAGES, N); ++next)
      issue_item(ring, wk, next, src, base, s, lane);
  float du_acc = 0.f;
  if (!state) {
    const int len = min(TILE, s - wk.tile(0) * TILE);
    if (wk.forward(0))
      prep_forward(ring, 0, len, prep, pt);
    else
      prep_back(ring, 0, len, u_s, prep, xs, dA, du_acc, pt, lane);
  }
  __syncthreads();

  float X[4][4] = {};   // S^T on the walk forward, G^T on the walk back
  const int g = lane >> 2, t = lane & 3;
  const int c0 = 16 * (warp & 3), n0 = 4 * (warp >> 2);
  for (int it = 0; it < N; ++it) {
    const int m = wk.tile(it), t0 = m * TILE, len = min(TILE, s - t0);
    const float* pb = prep + (it & 1) * PREP_FLOATS;
    if (state) {
      if (wk.forward(it)) {
        state_forward(X, pb, ck + static_cast<size_t>(m) * STATE_FLOATS,
                      m == M - 2 ? sbuf + ((M - 1) & 1) * STATE_FLOATS
                                 : nullptr,
                      lane, c0, n0);
      } else {
        if (it == M - 1) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              X[n][c] = dS ? dS[static_cast<size_t>(bh) * STATE_FLOATS +
                                (8 * (n0 + n) + 2 * t + (c & 1)) * HD + c0 +
                                g + 8 * (c >> 1)]
                           : 0.f;
        }
        const float* sb = nullptr;
        if (m >= 1) {
          sb = sbuf + (m & 1) * STATE_FLOATS;
          if (m <= M - 2) mbar_wait(&sbar[m & 1], (((M - 2) - m) >> 1) & 1);
        }
        ring.wait(it);
        const size_t off = base + static_cast<size_t>(t0) * HD;
        state_back(X, pb, sb, gs, ps, qs, dvs, dp, ring.operand(it, OP_R),
                   ring.operand(it, OP_K), ring.operand(it, OP_W), dr + off,
                   dk + off, dv + off, dw + off, len, lane, warp, tid);
      }
    } else {
      if (tid == PRODUCER) {
        // S_in of the state warps' next tile (1 .. M-2; M-1's is written
        // by them, 0's is zero).
        if (it + 1 < N && !wk.forward(it + 1)) {
          const int m1 = wk.tile(it + 1);
          if (m1 >= 1 && m1 <= M - 2) {
            uint64_t* bar = &sbar[m1 & 1];
            mbar_expect_tx(bar, STATE_FLOATS * 4);
            bulk_copy(sbuf + (m1 & 1) * STATE_FLOATS,
                      ck + static_cast<size_t>(m1 - 1) * STATE_FLOATS,
                      STATE_FLOATS * 4, bar);
          }
        }
      }
      if (warp == PRODUCER / 32) {
        // Ring stage x % STAGES frees when item x - STAGES is done: by the
        // prep warps (forward items) or by the state warps too (back).
        const int limit = wk.forward(it) ? it + STAGES : it + STAGES - 1;
        for (; next <= limit && next < N; ++next)
          issue_item(ring, wk, next, src, base, s, lane);
      }
      if (it + 1 < N) {
        const int len1 = min(TILE, s - wk.tile(it + 1) * TILE);
        float* pb1 = prep + ((it + 1) & 1) * PREP_FLOATS;
        if (wk.forward(it + 1))
          prep_forward(ring, it + 1, len1, pb1, pt);
        else
          prep_back(ring, it + 1, len1, u_s, pb1, xs, dA, du_acc, pt, lane);
      }
    }
    __syncthreads();
  }
  // du: roles 2 and 3 hold the shares of tokens < 5 and >= 5.
  if (!state && pt >= 3 * HD) dA[pt - 3 * HD] = du_acc;
  __syncthreads();
  if (!state && pt >= 2 * HD && pt < 3 * HD)
    du_part[static_cast<size_t>(bh) * HD + (pt - 2 * HD)] =
        du_acc + dA[pt - 2 * HD];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, const void* dS, void* dr,
           void* dk, void* dv, void* dw, void* du_part, void* ckpt, int b,
           int H, int s, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_scan_bwd_head<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_scan_bwd_head<T><<<b * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dout),
      static_cast<const float*>(dS), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(ckpt), H, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, dout and dr, dk, dv, dw
// share it); u, dS, du_part and ckpt are float32. Layouts: r/k/v/w/dout and
// the gradients (b, H, s, 64), u (H, 64), dS (b, H, 64, 64) or null for a
// zero gradient of the final state, du_part (b, H, 64), ckpt
// b * H * (ceil(s / 16) - 1) * 64 * 64 floats of scratch; all contiguous
// and 16-byte aligned. 1 <= b * H <= 65535. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int rwkv_scan_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* dout,
                             const void* dS, void* dr, void* dk, void* dv,
                             void* dw, void* du_part, void* ckpt, int b,
                             int H, int s, int dtype, void* stream) {
  if (s < 1 || b < 1 || H < 1 || b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, dout, dS, dr, dk, dv, dw, du_part,
                         ckpt, b, H, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, dout, dS, dr, dk, dv, dw,
                                 du_part, ckpt, b, H, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
