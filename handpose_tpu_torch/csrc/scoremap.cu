// Gaussian scoremap render for Hopper (sm_90a).
//
// Replaces handpose_tpu/ops/pallas_kernels.py:render_gaussian_maps_pallas
// (body _scoremap_kernel).  For n_maps = B*K keypoints with (row, col)
// coords and a visibility flag it writes n_maps float32 maps of H x W:
//
//   out[m, y, x] = expf(-((y - cy)^2 + (x - cx)^2) * inv_s2) * cond[m]
//
// with cy, cx the coords truncated toward zero (astype(int32) in JAX) and
// cond = vis && 0 < cy < H-1 && 0 < cx < W-1.
//
// Bound: bytes written.  The kernel reads 9 bytes per map and writes
// 4*H*W, so the output stream is the whole cost (at B=256, K=21, 256x256
// it is 1.41 GB, 0.42 ms at 3.35 TB/s).  The design keeps the output the
// only traffic: each block derives its map's three scalars from the
// inputs itself (no intermediate tensors, no separable factors in memory),
// and its threads store consecutive 16-byte float4 vectors, neighbouring
// threads on neighbouring addresses, so every warp writes whole 512-byte
// segments.  Maps whose gate is off are written as zeros without calling
// expf.  The arithmetic (one expf per element) stays well below the
// memory time.
//
// Plain C entry point, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void map_scalars(const float* coords,
                                            const uint8_t* vis, int m, int H,
                                            int W, float* cy, float* cx,
                                            bool* on) {
  // __float2int_rz: truncation toward zero, saturating like XLA's convert
  float y = (float)__float2int_rz(coords[2 * m]);
  float x = (float)__float2int_rz(coords[2 * m + 1]);
  *cy = y;
  *cx = x;
  *on = vis[m] != 0 && y > 0.0f && y < (float)(H - 1) && x > 0.0f &&
        x < (float)(W - 1);
}

// W % 4 == 0: every thread stores float4 vectors.
__global__ void __launch_bounds__(kThreads)
scoremap_vec4_kernel(const float* __restrict__ coords,
                     const uint8_t* __restrict__ vis, float* __restrict__ out,
                     int n_maps, int H, int W, float inv_s2) {
  const int W4 = W >> 2;
  const int quads = H * W4;
  for (int m = blockIdx.x; m < n_maps; m += gridDim.x) {
    float cy, cx;
    bool on;
    map_scalars(coords, vis, m, H, W, &cy, &cx, &on);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)m * H * W);
    if (!on) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = threadIdx.x; q < quads; q += kThreads) dst[q] = z;
      continue;
    }
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const int row = q / W4;
      const int col = (q - row * W4) << 2;
      const float dy = (float)row - cy;
      const float dy2 = dy * dy;
      const float dx0 = (float)col - cx;
      const float dx1 = dx0 + 1.0f;
      const float dx2 = dx0 + 2.0f;
      const float dx3 = dx0 + 3.0f;
      float4 v;
      v.x = expf(-(dy2 + dx0 * dx0) * inv_s2);
      v.y = expf(-(dy2 + dx1 * dx1) * inv_s2);
      v.z = expf(-(dy2 + dx2 * dx2) * inv_s2);
      v.w = expf(-(dy2 + dx3 * dx3) * inv_s2);
      dst[q] = v;
    }
  }
}

// Any W: one float per thread per step.
__global__ void __launch_bounds__(kThreads)
scoremap_scalar_kernel(const float* __restrict__ coords,
                       const uint8_t* __restrict__ vis,
                       float* __restrict__ out, int n_maps, int H, int W,
                       float inv_s2) {
  const int n = H * W;
  for (int m = blockIdx.x; m < n_maps; m += gridDim.x) {
    float cy, cx;
    bool on;
    map_scalars(coords, vis, m, H, W, &cy, &cx, &on);
    float* dst = out + (size_t)m * n;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int row = i / W;
      const int col = i - row * W;
      const float dy = (float)row - cy;
      const float dx = (float)col - cx;
      dst[i] = on ? expf(-(dy * dy + dx * dx) * inv_s2) : 0.0f;
    }
  }
}

}  // namespace

extern "C" int hpt_scoremap_f32(const void* coords, const void* vis,
                                void* out, int n_maps, int H, int W,
                                float inv_s2, void* stream) {
  if (n_maps <= 0) return (int)cudaSuccess;
  // one block per map, capped: blocks loop over further maps
  const int grid = n_maps < 65535 ? n_maps : 65535;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0) {
    scoremap_vec4_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(coords), static_cast<const uint8_t*>(vis),
        static_cast<float*>(out), n_maps, H, W, inv_s2);
  } else {
    scoremap_scalar_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(coords), static_cast<const uint8_t*>(vis),
        static_cast<float*>(out), n_maps, H, W, inv_s2);
  }
  return (int)cudaGetLastError();
}
