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
// (batch, KV head) and used by g heads. The work is 4 flops per cached
// value against 2 bytes read, so the kernel is bound by the bytes of the
// cache (and, at serving's small S, by launch latency).
//
// * Parallelism. The TPU walks the S blocks of one (batch, KV head) in
//   order on one core. Decode at batch 4 with 4 KV heads has only 16 such
//   pairs for 132 SMs, so the valid tokens are cut into `nsplit` chunks
//   (grid.x), each block keeps its own running max, sum and accumulator,
//   and a second kernel combines the chunks in chunk order: deterministic,
//   no atomics. Chunks start on whole 4 KB DRAM rows where the head dim
//   allows (the wrapper picks the chunk length).
// * Skipping. Only the tokens 0..min(pos, S-1) are read: chunks past pos
//   are never launched, and the ragged end of the last chunk is masked
//   with -1e30 inside its tile, so S need not be a multiple of anything.
// * Inside a block, the chunk is visited in tiles of 32 tokens. A tile of
//   K is staged in shared memory as fp32 (rows padded to d + 1 floats, so
//   the 32 threads of a warp, one per token, hit 32 different banks), one
//   warp per head updates the running max and sum, then the V tile takes
//   the same buffer and each thread updates its (head, column) entries of
//   the accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 32;  // tokens per tile; one warp lane per token
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

template <typename QT, typename KT>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const QT* __restrict__ q, const KT* __restrict__ kc,
                   const KT* __restrict__ vc, float* __restrict__ ws_m,
                   float* __restrict__ ws_l, float* __restrict__ ws_acc,
                   int hkv, int S, int d, int g, int n_valid, int chunk,
                   float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int gd = g * d;
  const int ld = d + 1;
  float* qs = smem;              // (g, d) queries of this KV head
  float* acc = qs + gd;          // (g, d) running accumulator
  float* kv = acc + gd;          // (TILE, d + 1) staged K, then V, tile
  float* sc = kv + TILE * ld;    // (g, TILE) logits, then probabilities
  float* mrun = sc + g * TILE;   // (g,) running max
  float* lrun = mrun + g;        // (g,) running sum
  float* alpha = lrun + g;       // (g,) rescale of this tile

  const size_t pair = static_cast<size_t>(bi) * hkv + kvh;
  const QT* qp = q + pair * gd;
  for (int i = tid; i < gd; i += THREADS) {
    qs[i] = to_float(qp[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    mrun[i] = NEG_INF;
    lrun[i] = 0.f;
  }
  const KT* kp = kc + pair * S * d;
  const KT* vp = vc + pair * S * d;
  const int t_begin = split * chunk;
  const int t_end = min(n_valid, t_begin + chunk);
  const int warp = tid / 32;
  const int lane = tid % 32;
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    const int nt = min(TILE, t_end - t0);
    const KT* kt = kp + static_cast<size_t>(t0) * d;
    for (int i = tid; i < nt * d; i += THREADS) {
      const int r = i / d;
      kv[r * ld + (i - r * d)] = to_float(kt[i]);
    }
    __syncthreads();

    for (int i = tid; i < g * TILE; i += THREADS) {
      const int gi = i / TILE;
      const int tt = i - gi * TILE;
      float s = NEG_INF;
      if (tt < nt) {
        const float* qr = qs + gi * d;
        const float* kr = kv + tt * ld;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot * scale;
      }
      sc[i] = s;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += THREADS / 32) {
      const float s = sc[gi * TILE + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_old = mrun[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      sc[gi * TILE + lane] = p;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(FULL, ps, off);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[gi] = a;
        lrun[gi] = lrun[gi] * a + ps;
        mrun[gi] = m_new;
      }
    }
    const KT* vt = vp + static_cast<size_t>(t0) * d;
    for (int i = tid; i < nt * d; i += THREADS) {
      const int r = i / d;
      kv[r * ld + (i - r * d)] = to_float(vt[i]);
    }
    __syncthreads();

    for (int i = tid; i < gd; i += THREADS) {
      const int gi = i / d;
      const int c = i - gi * d;
      const float* pr = sc + gi * TILE;
      float a = acc[i] * alpha[gi];
      for (int tt = 0; tt < nt; ++tt) a = fmaf(pr[tt], kv[tt * ld + c], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  const size_t part = pair * nsplit + split;
  for (int i = tid; i < gd; i += THREADS) ws_acc[part * gd + i] = acc[i];
  for (int i = tid; i < g; i += THREADS) {
    ws_m[part * g + i] = mrun[i];
    ws_l[part * g + i] = lrun[i];
  }
}

// Combine the chunks of one (batch, KV head) in chunk order.
template <typename QT>
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(const float* __restrict__ ws_m,
                     const float* __restrict__ ws_l,
                     const float* __restrict__ ws_acc, QT* __restrict__ out,
                     int hkv, int d, int g, int nsplit) {
  const size_t pair = static_cast<size_t>(blockIdx.y) * hkv + blockIdx.x;
  const int gd = g * d;
  const size_t base = pair * nsplit;
  for (int i = threadIdx.x; i < gd; i += THREADS) {
    const int gi = i / d;
    float m = NEG_INF;
    for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ws_m[(base + s) * g + gi]);
    float l = 0.f;
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float e = expf(ws_m[(base + s) * g + gi] - m);
      l = fmaf(ws_l[(base + s) * g + gi], e, l);
      a = fmaf(ws_acc[(base + s) * gd + i], e, a);
    }
    out[pair * gd + i] = from_float<QT>(a / fmaxf(l, 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, void* out,
           float* ws_m, float* ws_l, float* ws_acc, int b, int hkv, int g,
           int S, int d, int n_valid, int chunk, int nsplit, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * g * d + TILE * (d + 1) + g * TILE + 3 * g);
  auto split_fn = flash_decode_split<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  split_fn<<<dim3(nsplit, hkv, b), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ws_m, ws_l, ws_acc, hkv, S, d, g, n_valid,
      chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine<QT><<<dim3(hkv, b), THREADS, 0, stream>>>(
      ws_m, ws_l, ws_acc, static_cast<QT*>(out), hkv, d, g, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. Supported (q, kv): (f32, f32),
// (f32, bf16), (bf16, bf16). n_valid = min(pos + 1, S) tokens are read, in
// nsplit chunks of `chunk` tokens. ws_m, ws_l: (b, h_kv, nsplit, g) floats;
// ws_acc: (b, h_kv, nsplit, g, d) floats. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* out, void* ws_m, void* ws_l, void* ws_acc,
                            int b, int hkv, int g, int S, int d, int n_valid,
                            int chunk, int nsplit, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(ws_m);
  float* l = static_cast<float*>(ws_l);
  float* a = static_cast<float*>(ws_acc);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, out, m, l, a, b, hkv, g, S, d,
                                n_valid, chunk, nsplit, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, out, m, l, a, b, hkv, g, S,
                                        d, n_valid, chunk, nsplit, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, m, l, a, b, hkv,
                                                g, S, d, n_valid, chunk,
                                                nsplit, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
