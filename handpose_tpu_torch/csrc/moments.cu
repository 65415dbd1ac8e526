// Per-channel shifted moments for Hopper (sm_90a): train-mode BatchNorm.
//
// Replaces handpose_tpu/ops/pallas_kernels.py:_moments_pallas_raw (body
// _moments_kernel).  Over the rows of an (N, C) row-major view of x
// (float32 or bfloat16, the channels_last activation) and a float32 shift:
//
//   out[0, c] = sum_r (x[r, c] - shift[c])
//   out[1, c] = sum_r (x[r, c] - shift[c])^2
//
// each element converted to float32 first, every sum in float32.
//
// Bound: bytes read.  x is read once (at the b256 stem, 4,194,304 x 64
// bf16 = 0.54 GB, 0.16 ms at 3.35 TB/s); the work is two adds and a
// multiply-add per element.  The design keeps x the only large stream:
//   * stage 1: each block reduces a fixed range of rows.  Its threads
//     tile a row with 16-byte vectors (8 bf16 or 4 f32 channels each),
//     neighbouring threads on neighbouring addresses, so a warp reads
//     whole 512-byte segments; the rest of the block's threads take the
//     next rows, and each thread keeps four loads in flight.  The block
//     folds its threads' float32 partials in shared memory, in a fixed
//     order, into one (2, C) partial in a workspace.
//   * stage 2: one small launch folds the per-block partials in a fixed
//     order.
// The TPU kernel accumulated into one output block across sequential
// grid steps; Hopper's blocks run concurrently, hence the two stages.
// No float atomics: the grid depends only on the shape, so every sum is
// taken in the same order on every run and the result repeats bit for
// bit.  The wrapper sizes the grid at two blocks per SM (132 SMs), fewer
// only when the rows run out.
//
// Plain C entry point, bound from Python with ctypes; returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // stage 1; ops/moments_cuda.py THREADS
constexpr int kFinalCols = 32;
constexpr int kFinalRows = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& p,
                                           const float* sh, float* s,
                                           float* ss) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = to_f32(p.v[i]) - sh[i];
    s[i] += d;
    ss[i] += d * d;
  }
}

// Stage 1: block b reduces rows [b * rows_per_cta, (b + 1) * rows_per_cta)
// into part[b, 0:C] (sums) and part[b, C:2C] (sums of squares).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
moments_partial_kernel(const T* __restrict__ x,
                       const float* __restrict__ shift,
                       float* __restrict__ part, long long n_rows, int C,
                       long long rows_per_cta) {
  // rps * 2C = 2 * VEC * rps * lanes <= 2 * VEC * kThreads (32 KB at VEC 8)
  __shared__ float red[2 * VEC * kThreads];
  const int lanes = C / VEC;            // threads across one row
  const int rps = kThreads / lanes;     // rows in flight per step
  const int lc = threadIdx.x % lanes;   // channel vector of this thread
  const int lr = threadIdx.x / lanes;   // row lane of this thread
  const bool active = lr < rps;

  float s[VEC], ss[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] = 0.0f;
    ss[i] = 0.0f;
    sh[i] = active ? shift[lc * VEC + i] : 0.0f;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  long long r1 = r0 + rows_per_cta;
  if (r1 > n_rows) r1 = n_rows;
  if (active) {
    using P = Pack<T, VEC>;
    const T* base = x + (long long)lc * VEC;
    long long r = r0 + lr;
    for (; r + 3LL * rps < r1; r += 4LL * rps) {
      const P a = *reinterpret_cast<const P*>(base + r * C);
      const P b = *reinterpret_cast<const P*>(base + (r + rps) * C);
      const P c = *reinterpret_cast<const P*>(base + (r + 2LL * rps) * C);
      const P d = *reinterpret_cast<const P*>(base + (r + 3LL * rps) * C);
      accumulate<T, VEC>(a, sh, s, ss);
      accumulate<T, VEC>(b, sh, s, ss);
      accumulate<T, VEC>(c, sh, s, ss);
      accumulate<T, VEC>(d, sh, s, ss);
    }
    for (; r < r1; r += rps) {
      accumulate<T, VEC>(*reinterpret_cast<const P*>(base + r * C), sh, s,
                         ss);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[lr * 2 * C + lc * VEC + i] = s[i];
      red[lr * 2 * C + C + lc * VEC + i] = ss[i];
    }
  }
  __syncthreads();
  // fold the row lanes in order 0, 1, ..., rps-1
  for (int j = threadIdx.x; j < 2 * C; j += kThreads) {
    float acc = red[j];
    for (int l = 1; l < rps; ++l) acc += red[l * 2 * C + j];
    part[(long long)blockIdx.x * 2 * C + j] = acc;
  }
}

// Stage 2: out[j] = sum over blocks g of part[g, j], for j < 2C.  Warp w
// of a block sums g = w, w + 8, ... in order; then the eight warp sums
// are added in order.
__global__ void __launch_bounds__(kFinalCols * kFinalRows)
moments_final_kernel(const float* __restrict__ part, int grid, int two_c,
                     float* __restrict__ out) {
  __shared__ float red[kFinalRows][kFinalCols];
  const int tx = threadIdx.x % kFinalCols;
  const int ty = threadIdx.x / kFinalCols;
  const int j = blockIdx.x * kFinalCols + tx;
  float acc = 0.0f;
  if (j < two_c) {
    for (int g = ty; g < grid; g += kFinalRows)
      acc += part[(long long)g * two_c + j];
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < two_c) {
    float total = red[0][tx];
#pragma unroll
    for (int w = 1; w < kFinalRows; ++w) total += red[w][tx];
    out[j] = total;
  }
}

template <typename T, int VEC>
void launch(const void* x, const float* shift, float* part, float* out,
            long long n_rows, int C, int grid, cudaStream_t s) {
  const long long rows_per_cta = (n_rows + grid - 1) / grid;
  moments_partial_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), shift, part, n_rows, C, rows_per_cta);
  const int two_c = 2 * C;
  moments_final_kernel<<<(two_c + kFinalCols - 1) / kFinalCols,
                         kFinalCols * kFinalRows, 0, s>>>(part, grid, two_c,
                                                          out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per vector load, a
// divisor of C with x 16/8/4/2-byte aligned accordingly (the wrapper
// checks); C / vec <= 512.  part: grid * 2C floats of workspace; out:
// 2C floats (sums, then sums of squares).
extern "C" int hpt_moments(const void* x, int dtype, const void* shift,
                           void* part, void* out, long long n_rows, int C,
                           int grid, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sh = static_cast<const float*>(shift);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (n_rows <= 0 || C <= 0 || grid <= 0 || C % vec != 0 ||
      C / vec > kThreads)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 4: launch<float, 4>(x, sh, p, o, n_rows, C, grid, s); break;
      case 2: launch<float, 2>(x, sh, p, o, n_rows, C, grid, s); break;
      case 1: launch<float, 1>(x, sh, p, o, n_rows, C, grid, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8: launch<__nv_bfloat16, 8>(x, sh, p, o, n_rows, C, grid, s); break;
      case 4: launch<__nv_bfloat16, 4>(x, sh, p, o, n_rows, C, grid, s); break;
      case 2: launch<__nv_bfloat16, 2>(x, sh, p, o, n_rows, C, grid, s); break;
      case 1: launch<__nv_bfloat16, 1>(x, sh, p, o, n_rows, C, grid, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
