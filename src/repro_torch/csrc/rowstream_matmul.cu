// Row-stream matmul for Hopper (sm_90a): out (m, n) = x (m, k) @ w (k, n),
// accumulated in fp32 and cast to x's dtype.
//
// Replaces the Pallas TPU kernel `rowstream_matmul`
// (src/repro/kernels/rowstream_matmul/kernel.py). On the decode path m is
// the slot count (1..8), so the product does 2*m flops per weight element
// and is bound by the bytes of the weight: every design choice below is
// about streaming w once, in whole 4 KB DRAM rows, with enough loads in
// flight to keep HBM busy.
//
// * Tiling. The Pallas kernel streams K-blocks of the full N width, sized
//   for 2 MB of VMEM; a Hopper block has at most 227 KB of shared memory,
//   so N is tiled too. Each thread owns VEC adjacent columns (16 bytes of
//   w: 8 bf16 or 4 fp32) and a block of up to 256 threads owns a column
//   tile of up to 4096 bytes. A tile is either the full N width (n * size
//   <= 4096 bytes: the whole tile, all of its rows, is one contiguous run)
//   or exactly 4096 bytes wide, so every row of the tile is one DRAM row.
//   The row contract cannot be kept by the ragged last column tile when
//   n * size is not a multiple of 4096 (qwen2-7b's 3584-wide weights end in
//   a 3072-byte tile), nor by the scalar path (VEC = 1), which the wrapper
//   takes when a row of w is not a whole number of 16-byte vectors.
// * Parallelism. A GEMV over a few column tiles gives too few blocks for
//   132 SMs, so K is split into `splits` chunks (grid.y). Each block writes
//   its fp32 partial sums to a workspace and a second kernel adds the
//   partials in split order: no atomics, so the result does not depend on
//   the order in which blocks run. With one split the block writes the
//   cast result directly.
// * Rows of x. grid.z walks m in tiles of MT rows (MT = 1, 2, 4 or 8), so
//   the accumulators stay in registers for any m; x is tiny and is read
//   through the read-only cache, each value shared by the whole block.
// * Loads in flight. The K loop loads UNROLL rows of w before it uses any
//   of them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 4;

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

// Load VEC consecutive elements of w as floats. The vector paths need a
// 16-byte aligned address, which the wrapper guarantees when it picks them.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(__ldg(p));
  } else if constexpr (sizeof(T) == 2) {
    static_assert(VEC == 8, "bf16 vector path loads 8 values");
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 4, "fp32 vector path loads 4 values");
    float4 f = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
}

template <typename T, int MT, int VEC>
__global__ void __launch_bounds__(256)
rowstream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, float* __restrict__ ws, int m, int k,
                 int n, int kchunk, int splits) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int kb = split * kchunk;
  const int ke = min(k, kb + kchunk);
  if (col >= n) return;

  float acc[MT][VEC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;

  // Rows of x past m read row m0 again and are never stored.
  const T* xr[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    xr[i] = x + static_cast<size_t>(m0 + i < m ? m0 + i : m0) * k;

  const T* wp = w + static_cast<size_t>(kb) * n + col;
  int kk = kb;
  for (; kk + UNROLL <= ke; kk += UNROLL) {
    float wv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_row<T, VEC>(wp + static_cast<size_t>(u) * n, wv[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xv = to_float(__ldg(xr[i] + kk + u));
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[i][v] = fmaf(xv, wv[u][v], acc[i][v]);
      }
    }
    wp += static_cast<size_t>(UNROLL) * n;
  }
  for (; kk < ke; ++kk) {
    float wv[VEC];
    load_row<T, VEC>(wp, wv);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float xv = to_float(__ldg(xr[i] + kk));
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[i][v] = fmaf(xv, wv[v], acc[i][v]);
    }
    wp += n;
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (m0 + i >= m) break;
    const size_t row = static_cast<size_t>(m0 + i) * n + col;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (splits == 1)
        out[row + v] = from_float<T>(acc[i][v]);
      else
        ws[static_cast<size_t>(split) * m * n + row + v] = acc[i][v];
    }
  }
}

// out[i] = cast(sum over splits, in split order, of ws[split][i]).
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              T* __restrict__ out, int mn, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[static_cast<size_t>(p) * mn + i];
  out[i] = from_float<T>(s);
}

template <typename T, int MT, int VEC>
void launch_tile(const T* x, const T* w, T* out, float* ws, int m, int k,
                 int n, int threads, int kchunk, int splits,
                 cudaStream_t stream) {
  const int cols_per_block = threads * VEC;
  dim3 grid((n + cols_per_block - 1) / cols_per_block, splits,
            (m + MT - 1) / MT);
  rowstream_kernel<T, MT, VEC>
      <<<grid, threads, 0, stream>>>(x, w, out, ws, m, k, n, kchunk, splits);
}

template <typename T, int VEC>
void launch_vec(const T* x, const T* w, T* out, float* ws, int m, int k,
                int n, int threads, int mt, int kchunk, int splits,
                cudaStream_t stream) {
  switch (mt) {
    case 1: launch_tile<T, 1, VEC>(x, w, out, ws, m, k, n, threads, kchunk, splits, stream); break;
    case 2: launch_tile<T, 2, VEC>(x, w, out, ws, m, k, n, threads, kchunk, splits, stream); break;
    case 4: launch_tile<T, 4, VEC>(x, w, out, ws, m, k, n, threads, kchunk, splits, stream); break;
    default: launch_tile<T, 8, VEC>(x, w, out, ws, m, k, n, threads, kchunk, splits, stream); break;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* ws, int m, int k,
           int n, int vec, int threads, int mt, int kchunk, int splits,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  float* wsp = static_cast<float*>(ws);
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1)
    launch_vec<T, 1>(xp, wp, op, wsp, m, k, n, threads, mt, kchunk, splits, stream);
  else if (vec == kVec)
    launch_vec<T, kVec>(xp, wp, op, wsp, m, k, n, threads, mt, kchunk, splits, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int mn = m * n;
  splitk_reduce<T><<<(mn + 255) / 256, 256, 0, stream>>>(wsp, op, mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). vec: 1 or
// 16 / sizeof(dtype). ws: splits * m * n floats, unused when splits == 1.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int rowstream_matmul(const void* x, const void* w, void* out,
                                void* ws, int m, int k, int n, int dtype,
                                int vec, int threads, int mt, int kchunk,
                                int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, out, ws, m, k, n, vec, threads, mt, kchunk,
                         splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, ws, m, k, n, vec, threads, mt,
                                 kchunk, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
