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
// 3.35 TB/s); the checkpoints below add 84 MB written and read. The
// arithmetic, 12 hd^2 fp32 operations per token and head (one forward
// recompute, four products with the 64 x 64 state or its gradient and the
// G update), takes 1.26 GFLOP, 19 us at the fp32 CUDA-core peak. What the
// walk cannot shorten is its chain: s dependent steps through G per head.
//
// Design (simple, CUDA cores only; tensor cores and TMA wait for a
// redesign):
// * One block per (b, h) of 256 threads, owning the 64 x 64 fp32 G in
//   registers: warp w holds rows 8w..8w+7, lane l rows 8w + 2(l / 8) + {0,1}
//   and columns l % 8 + 8m, m = 0..7, 16 elements a thread. Row sums (dr,
//   dk, dw) are then shuffles among the 8 lanes of a row pair, column sums
//   (dv) shuffles among 4 lanes and one fixed-order sum over the 8 warps in
//   shared memory.
// * S_{t-1} is never rebuilt by dividing by w_t: w may be 1e-35. A first
//   walk forward stores S at the start of every chunk of RC tokens in a
//   fp32 scratch (b, H, ceil(s / RC), 64, 64), in each thread's own order
//   (coalesced, and read back by the thread that wrote it). The walk back
//   takes the chunks in reverse, recomputes the chunk's RC states into
//   registers from its checkpoint, then steps G back through them.
// * A chunk's r, k, v, w and do (RC x 64 each) are staged in shared memory
//   as fp32, padded past s with r = k = v = do = 0, w = 1, which leave G
//   unchanged. Per token, warp q < RC forms v . do and sum r u k once.
// * du without atomics: each block sums its (b, h) share over t in a fixed
//   order into du_part (b, H, 64); the wrapper sums du_part over b, also in
//   a fixed order. Two calls give identical bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;            // head dim of the kernel (the wrapper pads)
constexpr int RC = 4;             // tokens per checkpointed chunk
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ELEMS = HD * HD / THREADS;    // state elements per thread: 16
// Staged operands of a chunk, in order.
constexpr int OP_R = 0, OP_K = 1, OP_V = 2, OP_W = 3, OP_DO = 4, OPS = 5;
// Row gradients staged for the chunk's store, in order.
constexpr int G_DR = 0, G_DK = 1, G_DW = 2;

static_assert(RC * HD == THREADS, "one staged element per thread and operand");
static_assert(RC <= WARPS, "one warp per token for the per-token dots");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Smem {
  float op[OPS][RC][HD];          // the chunk's r, k, v, w, do
  float u[HD];
  float dots[RC][2];              // per token: v . do, sum_i r u k
  float rows[3][RC][HD];          // dr, dk, dw of the chunk's tokens
  float cols[RC][WARPS][HD];      // dv partials of each warp
};

// Stage tokens [t0, t0 + RC) of the operands `which` (a mask over OP_*):
// thread tid loads token t0 + tid / HD, channel tid % HD of each.
template <typename T>
__device__ __forceinline__ void stage(Smem& sm, const T* const (&src)[OPS],
                                      unsigned which, size_t base, int t0,
                                      int s, int tid) {
  const int q = tid / HD, j = tid % HD, t = t0 + q;
  const size_t off = base + static_cast<size_t>(t) * HD + j;
  for (int n = 0; n < OPS; ++n) {
    if (!(which & (1u << n))) continue;
    const float pad = n == OP_W ? 1.0f : 0.0f;
    sm.op[n][q][j] = t < s ? to_float(src[n][off]) : pad;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
rwkv_scan_bwd_head(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u, const T* __restrict__ dout,
                   const float* __restrict__ dS, T* __restrict__ dr,
                   T* __restrict__ dk, T* __restrict__ dv,
                   T* __restrict__ dw, float* __restrict__ du_part,
                   float* __restrict__ ckpt, int H, int s) {
  __shared__ Smem sm;
  const int bh = blockIdx.x, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 3, gj = lane & 7;
  const int row0 = 8 * warp + 2 * gi;        // rows row0, row0 + 1
  const int nc = (s + RC - 1) / RC;
  const size_t base = static_cast<size_t>(bh) * s * HD;
  const T* const src[OPS] = {r, k, v, w, dout};
  float* const my_ckpt = ckpt + static_cast<size_t>(bh) * nc * HD * HD + tid;

  if (tid < HD) sm.u[tid] = u[h * HD + tid];

  // Walk forward: S at the start of each chunk into the scratch.
  float S[2][8] = {};
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * RC;
    stage(sm, src, (1u << OP_K) | (1u << OP_V) | (1u << OP_W), base, t0, s,
          tid);
    __syncthreads();
    float* out = my_ckpt + static_cast<size_t>(c) * HD * HD;
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) out[e * THREADS] = S[e / 8][e % 8];
    if (c + 1 < nc) {
#pragma unroll
      for (int q = 0; q < RC; ++q) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float wa = sm.op[OP_W][q][row0 + a];
          const float ka = sm.op[OP_K][q][row0 + a];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            S[a][m] = fmaf(wa, S[a][m], ka * sm.op[OP_V][q][gj + 8 * m]);
        }
      }
    }
    __syncthreads();
  }

  // Walk back.
  float G[2][8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < 8; ++m)
      G[a][m] = dS ? dS[(static_cast<size_t>(bh) * HD + row0 + a) * HD + gj +
                        8 * m]
                   : 0.0f;
  float du_acc[2] = {0.0f, 0.0f};
  const float ua[2] = {sm.u[row0], sm.u[row0 + 1]};

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * RC;
    stage(sm, src, (1u << OPS) - 1, base, t0, s, tid);
    // St[q] = S_{t0 + q - 1}, the state token t0 + q reads.
    float St[RC][2][8];
    const float* in = my_ckpt + static_cast<size_t>(c) * HD * HD;
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) St[0][e / 8][e % 8] = in[e * THREADS];
    __syncthreads();
    if (warp < RC) {
      const int q = warp;
      const float vdo = warp_sum(sm.op[OP_V][q][lane] * sm.op[OP_DO][q][lane] +
                                 sm.op[OP_V][q][lane + 32] *
                                     sm.op[OP_DO][q][lane + 32]);
      const float ruk = warp_sum(
          sm.op[OP_R][q][lane] * sm.u[lane] * sm.op[OP_K][q][lane] +
          sm.op[OP_R][q][lane + 32] * sm.u[lane + 32] *
              sm.op[OP_K][q][lane + 32]);
      if (lane == 0) {
        sm.dots[q][0] = vdo;
        sm.dots[q][1] = ruk;
      }
    }
#pragma unroll
    for (int q = 1; q < RC; ++q) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float wa = sm.op[OP_W][q - 1][row0 + a];
        const float ka = sm.op[OP_K][q - 1][row0 + a];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          St[q][a][m] = fmaf(wa, St[q - 1][a][m],
                             ka * sm.op[OP_V][q - 1][gj + 8 * m]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int q = RC - 1; q >= 0; --q) {
      const float vdo = sm.dots[q][0];
      // Row sums over this thread's 8 columns, then over the row's 8 lanes.
      float pr[2] = {0.0f, 0.0f}, pk[2] = {0.0f, 0.0f}, pw[2] = {0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float dom = sm.op[OP_DO][q][gj + 8 * m];
        const float vm = sm.op[OP_V][q][gj + 8 * m];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          pr[a] = fmaf(St[q][a][m], dom, pr[a]);
          pk[a] = fmaf(G[a][m], vm, pk[a]);
          pw[a] = fmaf(G[a][m], St[q][a][m], pw[a]);
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          pr[a] += __shfl_xor_sync(0xffffffffu, pr[a], o);
          pk[a] += __shfl_xor_sync(0xffffffffu, pk[a], o);
          pw[a] += __shfl_xor_sync(0xffffffffu, pw[a], o);
        }
      }
      float ra[2], ka[2], wa[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        ra[a] = sm.op[OP_R][q][row0 + a];
        ka[a] = sm.op[OP_K][q][row0 + a];
        wa[a] = sm.op[OP_W][q][row0 + a];
        du_acc[a] = fmaf(ra[a] * ka[a], vdo, du_acc[a]);
      }
      if (gj == 0) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          sm.rows[G_DR][q][row0 + a] = fmaf(ua[a] * ka[a], vdo, pr[a]);
          sm.rows[G_DK][q][row0 + a] = fmaf(ua[a] * ra[a], vdo, pk[a]);
          sm.rows[G_DW][q][row0 + a] = pw[a];
        }
      }
      // Column sums over this thread's 2 rows, then over the 4 lanes of the
      // column; the warps' partials are summed in the store below.
      float pv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        pv[m] = fmaf(G[0][m], ka[0], G[1][m] * ka[1]);
        pv[m] += __shfl_xor_sync(0xffffffffu, pv[m], 8);
        pv[m] += __shfl_xor_sync(0xffffffffu, pv[m], 16);
      }
      if (gi == 0) {
#pragma unroll
        for (int m = 0; m < 8; ++m) sm.cols[q][warp][gj + 8 * m] = pv[m];
      }
      // G_{t-1} = diag(w_t) G_t + r_t^T do_t.
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float dom = sm.op[OP_DO][q][gj + 8 * m];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          G[a][m] = fmaf(wa[a], G[a][m], ra[a] * dom);
      }
    }
    __syncthreads();

    // Store the chunk's gradients: thread tid takes token t0 + tid / HD,
    // channel tid % HD.
    {
      const int q = tid / HD, j = tid % HD, t = t0 + q;
      if (t < s) {
        const size_t off = base + static_cast<size_t>(t) * HD + j;
        float col = 0.0f;
#pragma unroll
        for (int n = 0; n < WARPS; ++n) col += sm.cols[q][n][j];
        store(dr + off, sm.rows[G_DR][q][j]);
        store(dk + off, sm.rows[G_DK][q][j]);
        store(dw + off, sm.rows[G_DW][q][j]);
        store(dv + off, fmaf(sm.dots[q][1], sm.op[OP_DO][q][j], col));
      }
    }
    __syncthreads();
  }

  if (gj == 0) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
      du_part[static_cast<size_t>(bh) * HD + row0 + a] = du_acc[a];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, const void* dS, void* dr,
           void* dk, void* dv, void* dw, void* du_part, void* ckpt, int b,
           int H, int s, cudaStream_t stream) {
  rwkv_scan_bwd_head<T><<<b * H, THREADS, 0, stream>>>(
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
// b * H * ceil(s / 4) * 64 * 64 floats of scratch; all contiguous.
// 1 <= b * H <= 65535. Returns the cudaError_t of the launch (0 on
// success).
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
