// Chunked RWKV6 time-mix scan for Hopper (sm_90a):
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,  o_t = r_t (diag(u) k_t^T v_t + S_{t-1})
//
// for r, k, v, w of shape (b, H, s, hd) (the wrapper transposes them from
// the model's (b, s, H, hd)), u (H, hd) fp32; o (b, H, s, hd) in the
// input dtype and the final state (b, H, hd, hd) in fp32, from a zero
// state.
//
// Replaces the Pallas TPU kernel `rwkv_scan`
// (src/repro/kernels/rwkv_scan/kernel.py). It computes the same chunked
// form: within a chunk of C tokens every cross-token term is a C x C
// matrix built from per-channel log-space cumulative decays, masked before
// the exp, so every exponent is <= 0 and nothing overflows whatever the
// data-dependent w; only the (hd x hd) state crosses chunk boundaries.
//
// What bounds it: at the model's shapes (hd 64, C 16) a chunk of one
// operand is one 4 KB DRAM row (the RoMe contract, as on the TPU), and the
// kernel moves each input once: about 212 MB per rwkv6-3b layer at
// b 4 x s 1024 in fp32, 63 us at 3.35 TB/s. The exps of the C x C matrix
// (C * (C - 1) / 2 * hd per chunk) and the three small products are plain
// fp32 FMA work, recomputed by each column block; this first version
// makes no attempt to hide load latency and is expected to be bound by
// that work and by its barriers, not by bytes.
//
// Design:
// * Grid (value-column tiles, b * H). Column v of S and of o depends only
//   on column v of the v inputs, so splitting the value dim across blocks
//   is exact: hd 64 gives 4 tiles of VT = 16 columns and 640 blocks at
//   rwkv6-3b's b 4 x H 40, instead of 160. The tiles of one head are
//   neighbours in launch order, so their shared reads of r, k and w meet
//   in L2. Each block recomputes its chunk's C x C matrix.
// * A block walks its chunks in sequence and keeps its (hd x VT) slice of
//   the state in shared memory; one chunk's r, k, w and v tile are loaded
//   into shared memory as fp32 (rows padded to hd + 1 floats against bank
//   conflicts).
// * Any s >= 1: the rows of a ragged last chunk are padded with
//   r = k = v = 0 and w = 1 (log w = 0), so they add nothing to S and
//   leave the cumulative decay at its last valid value; their outputs are
//   not stored.
// * logf/expf, never the fast-math intrinsics: the clamp 1e-38 lies below
//   FLT_MIN, and flushing it to zero would make its log -inf and the
//   exponent differences NaN. The build passes no -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 64;      // head dim the shared-memory plan allows
constexpr int MAX_CHUNK = 64;   // tokens per chunk
constexpr int VT = 16;          // value columns per block
constexpr int THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;

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

// Floats of shared memory for chunk length C and head dim hd.
__host__ __device__ inline int smem_floats(int C, int hd) {
  return 4 * C * (hd + 1)   // r, k, lc, lcp
         + C * VT           // v tile
         + C * (C + 1)      // A
         + hd * VT          // state slice
         + hd;              // u
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ o,
                 float* __restrict__ s_final, int H, int s, int hd, int C) {
  extern __shared__ float sm[];
  const int hp = hd + 1;
  float* r_s = sm;                 // r, then r * exp(lcp)
  float* k_s = r_s + C * hp;       // k, then k * exp(lc_last - lc)
  float* lc_s = k_s + C * hp;      // log w, then its inclusive cumsum
  float* lcp_s = lc_s + C * hp;    // exclusive cumsum
  float* v_s = lcp_s + C * hp;     // (C, VT)
  float* a_s = v_s + C * VT;       // (C, C + 1)
  float* st_s = a_s + C * (C + 1); // (hd, VT) slice of S
  float* u_s = st_s + hd * VT;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * VT;
  const int ncols = min(VT, hd - col0);
  const int bh = blockIdx.y;
  const int h = bh % H;
  const size_t base = static_cast<size_t>(bh) * s * hd;

  for (int i = tid; i < hd * VT; i += THREADS) st_s[i] = 0.f;
  for (int i = tid; i < hd; i += THREADS) u_s[i] = u[h * hd + i];

  for (int c0 = 0; c0 < s; c0 += C) {
    const int cv = min(C, s - c0);   // valid tokens of this chunk
    __syncthreads();                 // the previous chunk is done with smem

    for (int i = tid; i < C * hd; i += THREADS) {
      const int t = i / hd, d = i - t * hd;
      const int q = t * hp + d;
      if (t < cv) {
        const size_t g = base + static_cast<size_t>(c0 + t) * hd + d;
        r_s[q] = to_float(r[g]);
        k_s[q] = to_float(k[g]);
        lc_s[q] = logf(fmaxf(to_float(w[g]), 1e-38f));
      } else {
        r_s[q] = 0.f;
        k_s[q] = 0.f;
        lc_s[q] = 0.f;
      }
    }
    for (int i = tid; i < C * VT; i += THREADS) {
      const int t = i / VT, c = i - t * VT;
      v_s[i] = (t < cv && c < ncols)
                   ? to_float(v[base + static_cast<size_t>(c0 + t) * hd +
                                col0 + c])
                   : 0.f;
    }
    __syncthreads();

    // Cumulative log decay of each channel over the chunk.
    for (int d = tid; d < hd; d += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const int q = t * hp + d;
        lcp_s[q] = acc;
        acc += lc_s[q];
        lc_s[q] = acc;
      }
    }
    __syncthreads();

    // A[i][j] = sum_d r[i,d] k[j,d] exp(lcp[i,d] - lc[j,d]) for j < i,
    // sum_d r[i,d] u[d] k[i,d] on the diagonal, 0 above it. The exp is
    // taken only where j < i, so its argument is <= 0.
    for (int p = tid; p < C * C; p += THREADS) {
      const int i = p / C, j = p - i * C;
      const float* ri = r_s + i * hp;
      float acc = 0.f;
      if (j < i) {
        const float* kj = k_s + j * hp;
        const float* lpi = lcp_s + i * hp;
        const float* lj = lc_s + j * hp;
        for (int d = 0; d < hd; ++d)
          acc = fmaf(ri[d] * kj[d], expf(lpi[d] - lj[d]), acc);
      } else if (j == i) {
        const float* ki = k_s + i * hp;
        for (int d = 0; d < hd; ++d) acc = fmaf(ri[d] * u_s[d], ki[d], acc);
      }
      a_s[i * (C + 1) + j] = acc;
    }
    __syncthreads();

    // Decay r and k in place for the state terms; both exps are <= 1.
    for (int i = tid; i < C * hd; i += THREADS) {
      const int t = i / hd, d = i - t * hd;
      const int q = t * hp + d;
      r_s[q] *= expf(lcp_s[q]);
      k_s[q] *= expf(lc_s[(C - 1) * hp + d] - lc_s[q]);
    }
    __syncthreads();

    // o = A v + (r * exp(lcp)) S.
    for (int p = tid; p < C * VT; p += THREADS) {
      const int i = p / VT, c = p - i * VT;
      if (i >= cv || c >= ncols) continue;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j)
        acc = fmaf(a_s[i * (C + 1) + j], v_s[j * VT + c], acc);
      const float* ri = r_s + i * hp;
      for (int d = 0; d < hd; ++d) acc = fmaf(ri[d], st_s[d * VT + c], acc);
      o[base + static_cast<size_t>(c0 + i) * hd + col0 + c] =
          from_float<T>(acc);
    }
    __syncthreads();

    // S = exp(lc_last) * S + (k * exp(lc_last - lc))^T v.
    for (int p = tid; p < hd * VT; p += THREADS) {
      const int d = p / VT, c = p - d * VT;
      float acc = expf(lc_s[(C - 1) * hp + d]) * st_s[p];
      for (int j = 0; j < C; ++j)
        acc = fmaf(k_s[j * hp + d], v_s[j * VT + c], acc);
      st_s[p] = acc;
    }
  }
  __syncthreads();

  float* out = s_final + static_cast<size_t>(bh) * hd * hd;
  for (int p = tid; p < hd * VT; p += THREADS) {
    const int d = p / VT, c = p - d * VT;
    if (c < ncols) out[d * hd + col0 + c] = st_s[p];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, void* s_final, int b, int H, int s,
           int hd, int C, cudaStream_t stream) {
  const int bytes = smem_floats(C, hd) * static_cast<int>(sizeof(float));
  if (bytes > SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((hd + VT - 1) / VT, b * H);
  rwkv_scan_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(o),
      static_cast<float*>(s_final), H, s, hd, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and o share it); u is
// float32. Layouts: r/k/v/w/o (b, H, s, hd), u (H, hd), s_final
// (b, H, hd, hd), all contiguous. 1 <= hd <= 64, 1 <= chunk <= 64,
// b * H <= 65535. Returns the cudaError_t of the launch (0 on success).
extern "C" int rwkv_scan(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* o,
                         void* s_final, int b, int H, int s, int hd,
                         int chunk, int dtype, void* stream) {
  if (hd < 1 || hd > MAX_HD || chunk < 1 || chunk > MAX_CHUNK || s < 1 ||
      b * H < 1 || b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, o, s_final, b, H, s, hd, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, o, s_final, b, H, s, hd,
                                 chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
