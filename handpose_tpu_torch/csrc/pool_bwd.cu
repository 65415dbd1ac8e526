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
// with padding that never wins (a padded tap is skipped by its
// coordinates, never compared, so the zeros of a post-ReLU input keep
// their ties).  The <= 4 terms of a pixel are summed in float32 in the TPU
// kernel's order, ascending tap index -- windows (k+1, l+1), (k+1, l),
// (k, l+1), (k, l) of pixel block (k, l) -- and rounded once to x's dtype.
//
// Bound: bytes.  x and dy are read once and dx written once (at the b256
// stem, 0.54 + 0.13 + 0.54 GB, 0.36 ms at 3.35 TB/s); the work is a few
// compares per tap.
//
// Design: a persistent block walks tiles of TH x TW windows of one image
// and one chunk of at most 8 channel vectors (128 bytes of a pixel), in
// raster order within the image, so the tiles in flight at once are
// neighbours whose overlapping halos come from L2, not HBM.  For each
// tile it
//   1. stages, with cp.async, the x halo (rows 2k0-1 .. 2k0+2TH+1 and the
//      same span of columns; pixels outside the image are not copied) and
//      dy of the (TH+1) x (TW+1) windows that cover the tile's pixels in
//      shared memory;
//   2. derives every window's first-max tap once, from shared memory, as
//      a two-byte code per (window, channel): the bfloat16 bits of tap + 1,
//      so that in bf16 one packed compare and two bit blends handle two
//      channels.  Only the halo row and column of windows is derived
//      twice: (TH+1)(TW+1)/(TH TW) of the work, against 4x in the gather
//      kernel this replaces, which re-derived each window for each of the
//      four 2x2 blocks it covers, with 36 tap loads a thread;
//   3. gathers: one thread per (dx pixel, channel vector), the pixels of
//      one row and column parity in a warp, reads the codes and dy of the
//      <= 4 windows that cover its pixel, adds the matching terms and
//      writes its vector once, coalesced.
// No atomics, no zero-fill pass: each dx element is written exactly once.
// The tile is fixed at 8 x 8 windows (16 x 16 dx pixels, a 19 x 19-pixel x
// halo) with one stage buffer: at the b256 stem in bf16 that is 66,944 B
// of shared memory, three resident blocks per SM, and the other blocks of
// the SM overlap one block's copy with their compute.  A ring of two
// buffers at this tile fits one block per SM and ran slower on the H100,
// as did 4 x 8 windows (PERF.md).
// Any N, H, W (odd, 1) and C: the vector width is what the wrapper finds C
// and the pointers allow.  A 2-byte vector (bf16 with odd C) cannot be
// copied by cp.async; that variant ("tiled_sync") stages through
// registers, the same code otherwise.  The chunking, the block and the
// grid come from the wrapper's tile_plan (ops/pool_bwd_cuda.py); this file
// checks that the plan's tile is its own and that the shared memory it is
// given holds the layout below.
//
// Plain C entry points, bound from Python with ctypes:
// hpt_pool_bwd_occupancy opts a launch configuration into its shared
// memory once, when the wrapper first plans it, and reports its
// occupancy; hpt_pool_bwd only launches, and returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // <= 64 registers a thread
constexpr int kTH = 8, kTW = 8;  // windows a tile: rows, columns

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

// a window's first-max tap t (0..8) is stored as the bfloat16 bits of
// t + 1, two bytes a channel, so that packed bf16 compares can test it
template <int VEC>
struct alignas(2 * VEC) Codes {
  uint16_t v[VEC];
};

// VEC bf16 channels as VEC / 2 packed pairs
template <int NW>
struct alignas(4 * NW) Words {
  uint32_t w[NW];
};

__device__ __forceinline__ uint32_t tap_code(int tap) {
  return __float_as_uint((float)(tap + 1)) >> 16;
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, 4);
  return r;
}

// 0xFFFF in each half where the bf16 compare holds (false for NaN)
__device__ __forceinline__ uint32_t gt_mask(uint32_t a, uint32_t b) {
  return __hgt2_mask(as_bf2(a), as_bf2(b));
}
__device__ __forceinline__ uint32_t eq_mask(uint32_t a, uint32_t b) {
  return __heq2_mask(as_bf2(a), as_bf2(b));
}
__device__ __forceinline__ uint32_t blend(uint32_t mask, uint32_t a,
                                         uint32_t b) {
  return (a & mask) | (b & ~mask);
}

// one vector from device memory into shared memory: cp.async for 4, 8 or
// 16 bytes (L2 only for 16), a plain load and store for 2
template <int BYTES>
__device__ __forceinline__ void stage_copy(void* smem, const void* gmem) {
  if constexpr (BYTES >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (BYTES == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(gmem));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                   "l"(gmem), "n"(BYTES));
  } else {
    *static_cast<uint16_t*>(smem) = *static_cast<const uint16_t*>(gmem);
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// shared memory of one launch: the stage buffer, the x halo
// ((2TH+3) x (2TW+3) pixels) then dy of the (TH+1) x (TW+1) windows, and
// the window codes, 2 bytes a channel; a pixel or window holds cvb
// vectors of VEC channels
__host__ __device__ constexpr long long stage_bytes(int cvb, int vec_bytes) {
  return align16((long long)((2 * kTH + 3) * (2 * kTW + 3) +
                             (kTH + 1) * (kTW + 1)) * cvb * vec_bytes);
}

__host__ __device__ constexpr long long smem_bytes(int cvb, int vec,
                                                   int esize) {
  return stage_bytes(cvb, vec * esize) +
         align16((long long)(kTH + 1) * (kTW + 1) * cvb * vec * 2);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pool_bwd_tiled(const T* __restrict__ x, const T* __restrict__ dy,
               T* __restrict__ dx, int H, int W, int C, int Ho, int Wo,
               int n_chunks, int tiles_h, int tiles_w, long long n_tiles) {
  using P = Pack<T, VEC>;
  constexpr int TH = kTH, TW = kTW;
  constexpr int XR = 2 * TH + 3, XC = 2 * TW + 3;  // x halo
  constexpr int WR = TH + 1, WC = TW + 1;          // windows
  constexpr int PR = 2 * TH, PC = 2 * TW;          // dx pixels owned
  constexpr int VB = VEC * (int)sizeof(T);
  constexpr bool kAsync = VB >= 4;
  constexpr bool kPacked = sizeof(T) == 2 && VEC % 2 == 0;
  constexpr int NW = VEC / 2 > 0 ? VEC / 2 : 1;
  using PW = Words<NW>;

  extern __shared__ __align__(16) unsigned char smem[];
  const int cvb = blockDim.x;        // channel vectors of a chunk
  const int tx = threadIdx.x, ty = threadIdx.y, by = blockDim.y;
  const int cvs = C / VEC;
  P* const xs = reinterpret_cast<P*>(smem);  // x halo
  P* const ds = xs + XR * XC * cvb;          // dy of the windows
  Codes<VEC>* const codes =
      reinterpret_cast<Codes<VEC>*>(smem + stage_bytes(cvb, VB));

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // tile t: columns fastest, then rows, then channel chunk, then image
    long long r = t;
    const int l0 = (int)(r % tiles_w) * TW;
    r /= tiles_w;
    const int k0 = (int)(r % tiles_h) * TH;
    r /= tiles_h;
    const int cv = (int)(r % n_chunks) * cvb + tx;
    const int n = (int)(r / n_chunks);
    const bool active = cv < cvs;

    // 0. stage the tile: the x halo (pixels outside the image are not
    // copied) and dy of its windows
    if (active) {
      const T* xn = x + (long long)n * H * W * C + (long long)cv * VEC;
      for (int p = ty; p < XR * XC; p += by) {
        const int ih = 2 * k0 - 1 + p / XC, iw = 2 * l0 - 1 + p % XC;
        if (ih < 0 || ih >= H || iw < 0 || iw >= W) continue;
        stage_copy<VB>(xs + p * cvb + tx,
                       xn + ((long long)ih * W + iw) * C);
      }
      const T* dn = dy + (long long)n * Ho * Wo * C + (long long)cv * VEC;
      for (int q = ty; q < WR * WC; q += by) {
        const int oh = k0 + q / WC, ow = l0 + q % WC;
        if (oh >= Ho || ow >= Wo) continue;
        stage_copy<VB>(ds + q * cvb + tx,
                       dn + ((long long)oh * Wo + ow) * C);
      }
    }
    if constexpr (kAsync) {
      commit();
      wait_group<0>();
    }
    __syncthreads();

    // 1. each window's first-max tap, once, from shared memory
    for (int q = ty; q < WR * WC && active; q += by) {
      const int wr = q / WC, wc = q % WC;
      if (k0 + wr >= Ho || l0 + wc >= Wo) continue;
      const int at = (2 * wr * XC + 2 * wc) * cvb + tx;  // tap (0, 0)
      if constexpr (kPacked) {
        // bf16 pairs: one packed compare and two bit blends a pair
        const PW* xw = reinterpret_cast<const PW*>(xs) + at;
        uint32_t m[NW] = {}, arg[NW] = {};
        bool first = true;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int ih = 2 * (k0 + wr) - 1 + di;
          if (ih < 0 || ih >= H) continue;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const int iw = 2 * (l0 + wc) - 1 + dj;
            if (iw < 0 || iw >= W) continue;
            const PW v = xw[(di * XC + dj) * cvb];
            const uint32_t code = tap_code(di * 3 + dj) * 0x00010001u;
#pragma unroll
            for (int j = 0; j < NW; ++j) {
              // strict >: the first maximum in row-major order keeps it
              const uint32_t k = first ? 0xFFFFFFFFu : gt_mask(v.w[j], m[j]);
              m[j] = blend(k, v.w[j], m[j]);
              arg[j] = blend(k, code, arg[j]);
            }
            first = false;
          }
        }
        PW out;
#pragma unroll
        for (int j = 0; j < NW; ++j) out.w[j] = arg[j];
        reinterpret_cast<PW*>(codes)[q * cvb + tx] = out;
      } else {
        float m[VEC];
        Codes<VEC> arg;
        bool first = true;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int ih = 2 * (k0 + wr) - 1 + di;
          if (ih < 0 || ih >= H) continue;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const int iw = 2 * (l0 + wc) - 1 + dj;
            if (iw < 0 || iw >= W) continue;
            const P v = xs[at + (di * XC + dj) * cvb];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float f = to_f32(v.v[j]);
              if (first || f > m[j]) {
                m[j] = f;
                arg.v[j] = (uint16_t)tap_code(di * 3 + dj);
              }
            }
            first = false;
          }
        }
        codes[q * cvb + tx] = arg;
      }
    }
    __syncthreads();

    // 2. one thread per (dx pixel, channel vector), the pixels of one
    // row and column parity together so a warp's threads take the same
    // windows: the terms of the <= 4 covering windows in ascending tap
    // index, i.e. window rows and then columns descending, summed in
    // float32 and rounded once
    T* dxn = dx + (long long)n * H * W * C + (long long)cv * VEC;
    for (int p = ty; p < PR * PC && active; p += by) {
      const int parity = p / (TH * TW), e = p % (TH * TW);
      const int pr = 2 * (e / TW) + (parity >> 1);
      const int pc = 2 * (e % TW) + (parity & 1);
      const int h = 2 * k0 + pr, w = 2 * l0 + pc;
      if (h >= H || w >= W) continue;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int wr = (pr + 1) / 2 - a, di = pr + 1 - 2 * wr;
        if (di > 2 || k0 + wr >= Ho) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int wc = (pc + 1) / 2 - b, dj = pc + 1 - 2 * wc;
          if (dj > 2 || l0 + wc >= Wo) continue;
          const int at = (wr * WC + wc) * cvb + tx;
          if constexpr (kPacked) {
            // a pair's non-matching half adds +0, as the plain version's
            // where(idx == k, dy, 0) does
            const PW code = reinterpret_cast<const PW*>(codes)[at];
            const PW g = reinterpret_cast<const PW*>(ds)[at];
            const uint32_t tap = tap_code(di * 3 + dj) * 0x00010001u;
#pragma unroll
            for (int j = 0; j < NW; ++j) {
              const uint32_t term = g.w[j] & eq_mask(code.w[j], tap);
              acc[2 * j] += __uint_as_float(term << 16);
              acc[2 * j + 1] += __uint_as_float(term & 0xFFFF0000u);
            }
          } else {
            const Codes<VEC> code = codes[at];
            const P g = ds[at];
            const uint16_t tap = (uint16_t)tap_code(di * 3 + dj);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              if (code.v[j] == tap) acc[j] += to_f32(g.v[j]);
          }
        }
      }
      P out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) from_f32(acc[j], &out.v[j]);
      *reinterpret_cast<P*>(dxn + ((long long)h * W + w) * C) = out;
    }
    __syncthreads();  // this tile's stage buffer and codes are free
  }
}

// the instantiation for (dtype, vec), or null
const void* kernel_for(int dtype, int vec) {
  if (dtype == 0) {
    switch (vec) {
      case 4: return reinterpret_cast<const void*>(&pool_bwd_tiled<float, 4>);
      case 2: return reinterpret_cast<const void*>(&pool_bwd_tiled<float, 2>);
      case 1: return reinterpret_cast<const void*>(&pool_bwd_tiled<float, 1>);
    }
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    switch (vec) {
      case 8: return reinterpret_cast<const void*>(&pool_bwd_tiled<B, 8>);
      case 4: return reinterpret_cast<const void*>(&pool_bwd_tiled<B, 4>);
      case 2: return reinterpret_cast<const void*>(&pool_bwd_tiled<B, 2>);
      case 1: return reinterpret_cast<const void*>(&pool_bwd_tiled<B, 1>);
    }
  }
  return nullptr;
}

// the kernel for a plan, or null if the plan is not one this file builds:
// another tile, a block of more than kThreads threads, or less shared
// memory than the layout needs
const void* checked(int dtype, int vec, int th, int tw, int cvb, int block_y,
                    int smem) {
  const void* fn = kernel_for(dtype, vec);
  const int esize = dtype == 0 ? 4 : 2;
  if (fn == nullptr || th != kTH || tw != kTW || cvb < 1 || block_y < 1 ||
      cvb * block_y > kThreads || smem < smem_bytes(cvb, vec, esize))
    return nullptr;
  return fn;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: channels per vector, a divisor
// of C with all three tensors aligned to it (the wrapper checks).  The
// tile plan (ops/pool_bwd_cuda.py:tile_plan): th x tw windows a tile (this
// file's), cvb channel vectors a chunk (blockDim.x), n_chunks chunks,
// block_y rows of threads, grid persistent blocks, smem bytes of dynamic
// shared memory, opted into by hpt_pool_bwd_occupancy first.
extern "C" int hpt_pool_bwd(const void* x, const void* dy, void* dx,
                            int dtype, int N, int H, int W, int C, int vec,
                            int th, int tw, int cvb, int n_chunks,
                            int block_y, int grid, int smem, void* stream) {
  const void* fn = checked(dtype, vec, th, tw, cvb, block_y, smem);
  if (fn == nullptr || N <= 0 || H <= 0 || W <= 0 || C <= 0 ||
      C % vec != 0 || n_chunks < 1 || (long long)cvb * n_chunks < C / vec ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  int tiles_h = (Ho + th - 1) / th, tiles_w = (Wo + tw - 1) / tw;
  long long n_tiles = (long long)N * n_chunks * tiles_h * tiles_w;
  void* args[] = {&x,  &dy,       &dx,      &H,       &W,      &C,
                  &Ho, &Wo,       &n_chunks, &tiles_h, &tiles_w, &n_tiles};
  cudaError_t err = cudaLaunchKernel(fn, dim3(grid), dim3(cvb, block_y),
                                     args, (size_t)smem,
                                     static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Prepares one launch configuration on the current card: opts the kernel
// into smem bytes of dynamic shared memory when opt_in is set (above the
// 48 KB default), then reports its resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and registers per thread
// (cudaFuncGetAttributes).  Returns a CUDA error code.
extern "C" int hpt_pool_bwd_occupancy(int dtype, int vec, int th, int tw,
                                      int cvb, int block_y, int smem,
                                      int opt_in, int* blocks_per_sm,
                                      int* registers) {
  const void* fn = checked(dtype, vec, th, tw, cvb, block_y, smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (opt_in)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, cvb * block_y, (size_t)smem);
}
