// Backward of the ResNet-stem max pool (3x3 window, stride 2, padding 1)
// for Hopper (sm_90a).
//
// Replaces handpose_tpu/ops/pallas_kernels.py:max_pool_3x3s2p1_bwd_pallas
// (bodies _pool_bwd_kernel and _pool_bwd_chunk).  Given x (N, H, W, C) and
// the cotangent dy (N, Ho, Wo, C), Ho = (H + 1) / 2, Wo = (W + 1) / 2, both
// channels_last (NHWC in memory), float32 or bfloat16, it writes
//
//   dx[n, h, w, c] = sum of dy[n, oh, ow, c] over the windows (oh, ow)
//                    whose first maximum, in row-major window order, is
//                    x[n, h, w, c]
//
// with padding that never wins (a padded tap is skipped, not compared).
// The <= 4 terms are summed in float32 in the TPU kernel's order and
// rounded once to x's dtype.
//
// Bound: bytes.  x and dy are read once and dx written once (at the b256
// stem, 0.54 + 0.13 + 0.54 GB, 0.36 ms at 3.35 TB/s); the work is a few
// compares per tap.  Gather form, no atomics and no zero-fill pass: each
// thread owns a 2x2 block of input pixels (rows 2k, 2k+1, cols 2l, 2l+1)
// and one 16-byte vector of channels.  Exactly the four windows (k..k+1,
// l..l+1) cover that block; the thread re-derives each one's argmax from
// x (9 vector loads, served mostly by L1/L2 since neighbouring threads
// read the same rows) and adds the window's dy to whichever of its four
// pixels holds the argmax.  A window's argmax lies in exactly one block,
// so every dy term lands exactly once, and each dx element is written by
// exactly one thread.  Neighbouring threads own neighbouring channel
// vectors, then neighbouring blocks of a row, so loads and stores are
// coalesced.  Unlike the TPU kernel's lane packing this covers odd H and
// W and any C; padded taps are skipped, so no -inf or 0 * inf arises.
//
// Plain C entry point, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, int N, int H, int W, int C, int Ho,
                int Wo) {
  using P = Pack<T, VEC>;
  const int cvs = C / VEC;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long total = (long long)N * Ho * Wo * cvs;
  if (t >= total) return;
  const int cv = (int)(t % cvs);
  long long q = t / cvs;
  const int l = (int)(q % Wo);  // block column: input cols 2l, 2l+1
  q /= Wo;
  const int k = (int)(q % Ho);  // block row: input rows 2k, 2k+1
  const int n = (int)(q / Ho);

  const T* xn = x + (long long)n * H * W * C + (long long)cv * VEC;
  const T* dyn = dy + (long long)n * Ho * Wo * C + (long long)cv * VEC;

  float acc[4][VEC];  // pixel (2k + a, 2l + b) at acc[2a + b]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[p][i] = 0.0f;

  // windows in the TPU kernel's order of accumulation: (k+1, l+1),
  // (k+1, l), (k, l+1), (k, l) -- the pixel sees its terms in ascending
  // tap index, as the Pallas kernel adds its nine placements
#pragma unroll
  for (int wi = 1; wi >= 0; --wi) {
#pragma unroll
    for (int wj = 1; wj >= 0; --wj) {
      const int oh = k + wi, ow = l + wj;
      if (oh >= Ho || ow >= Wo) continue;
      float m[VEC];
      int arg[VEC];
      bool first = true;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int ih = 2 * oh - 1 + di;
        if (ih < 0 || ih >= H) continue;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int iw = 2 * ow - 1 + dj;
          if (iw < 0 || iw >= W) continue;
          const P v = *reinterpret_cast<const P*>(
              xn + ((long long)ih * W + iw) * C);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float f = to_f32(v.v[i]);
            // strict >: the first maximum in row-major order keeps it
            if (first || f > m[i]) {
              m[i] = f;
              arg[i] = di * 3 + dj;
            }
          }
          first = false;
        }
      }
      const P g = *reinterpret_cast<const P*>(
          dyn + ((long long)oh * Wo + ow) * C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // argmax position relative to this thread's 2x2 block
        const int a = 2 * oh - 1 + arg[i] / 3 - 2 * k;
        const int b = 2 * ow - 1 + arg[i] % 3 - 2 * l;
        const int p = (a == 0 || a == 1) && (b == 0 || b == 1) ? 2 * a + b
                                                                : -1;
        const float gv = to_f32(g.v[i]);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          if (p == pp) acc[pp][i] += gv;
      }
    }
  }

  T* dxn = dx + (long long)n * H * W * C + (long long)cv * VEC;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int h = 2 * k + a;
    if (h >= H) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int w = 2 * l + b;
      if (w >= W) continue;
      P out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) from_f32(acc[2 * a + b][i], &out.v[i]);
      *reinterpret_cast<P*>(dxn + ((long long)h * W + w) * C) = out;
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* dy, void* dx, int N, int H, int W,
            int C, cudaStream_t s) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long total = (long long)N * Ho * Wo * (C / VEC);
  const long long grid = (total + kThreads - 1) / kThreads;
  pool_bwd_kernel<T, VEC><<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      N, H, W, C, Ho, Wo);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: channels per vector load, a
// divisor of C with all three tensors aligned to it (the wrapper checks).
extern "C" int hpt_pool_bwd(const void* x, const void* dy, void* dx,
                            int dtype, int N, int H, int W, int C, int vec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 4: launch<float, 4>(x, dy, dx, N, H, W, C, s); break;
      case 2: launch<float, 2>(x, dy, dx, N, H, W, C, s); break;
      case 1: launch<float, 1>(x, dy, dx, N, H, W, C, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 8: launch<__nv_bfloat16, 8>(x, dy, dx, N, H, W, C, s); break;
      case 4: launch<__nv_bfloat16, 4>(x, dy, dx, N, H, W, C, s); break;
      case 2: launch<__nv_bfloat16, 2>(x, dy, dx, N, H, W, C, s); break;
      case 1: launch<__nv_bfloat16, 1>(x, dy, dx, N, H, W, C, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
