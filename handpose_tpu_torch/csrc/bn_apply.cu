// Eval-mode BatchNorm with its ReLU and residual add, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the normalisation, the
// residual add and the ReLU into the convolution's neighbour.  PyTorch's
// eager ops run them as separate float32 passes over the activation (a
// cast up, a subtract, a multiply, an add, a cast down, then the residual
// add and the ReLU), so the port adds this kernel.  Over the rows of an
// (N, C) row-major view of x (float32 or bfloat16, the channels_last
// activation) it computes, element for element, what those passes did:
//
//   mul[c] = rsqrt(var[c] + 1e-5) * weight[c]
//   y      = T(((f32(x) - mean[c]) * mul[c]) + bias[c])
//   'shifted' (ShiftedBatchNorm): x - mean, mul and bias each rounded to T
//            before the multiply, the product and the sum rounded to T
//   y      = T(f32(residual) + f32(y))            with a residual
//   y      = y <= 0 ? 0 : y, NaN kept             with relu
//
// with T the dtype of x, every float32 step rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no contraction into an FMA) and every rounding to
// bfloat16 to nearest even, as PyTorch's kernels round.
//
// Bound: bytes.  About half an operation per byte moved: x is read once,
// the residual (if any) once, y written once; at the b256 stem, (4,194,304
// x 64) bf16, that is 1.07 GB with the ReLU, 0.32 ms at 3.35 TB/s.  The
// design keeps those the only streams:
//   * each thread owns one 16-byte channel group (8 bf16 or 4 float32
//     channels) for the whole launch, so its scales and shifts are formed
//     once, in registers, from the four (C,) vectors;
//   * a block tiles rows with its threads, neighbouring threads on
//     neighbouring 16-byte vectors, so a warp reads and writes whole
//     segments; rows wider than a block (C / VEC > kThreads) take
//     gridDim.y blocks across;
//   * the grid holds as many blocks as the card keeps resident at once
//     (its SMs times the kernel's occupancy), which stride over the rows,
//     so no block waits for a second wave; each thread issues four rows'
//     loads before it computes and stores them.
//
// Plain C entry point, bound from Python with ctypes; returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr float kEpsilon = 1e-5f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
struct alignas(16) Pack {
  static constexpr int kVec = 16 / sizeof(T);
  T v[kVec];
};

template <typename T, bool SHIFTED, bool RESIDUAL, bool RELU>
__device__ __forceinline__ Pack<T> apply(const Pack<T>& x, const Pack<T>& r,
                                         const float* mean, const float* mul,
                                         const float* bias) {
  using E = Elem<T>;
  Pack<T> y;
#pragma unroll
  for (int i = 0; i < Pack<T>::kVec; ++i) {
    float v = __fsub_rn(E::load(x.v[i]), mean[i]);
    if (SHIFTED) {
      v = E::round(__fadd_rn(E::round(__fmul_rn(E::round(v), mul[i])),
                             bias[i]));
    } else {
      v = E::round(__fadd_rn(__fmul_rn(v, mul[i]), bias[i]));
    }
    if (RESIDUAL) v = E::round(__fadd_rn(E::load(r.v[i]), v));
    if (RELU && !(v != v)) v = fmaxf(v, 0.0f);
    y.v[i] = E::store(v);
  }
  return y;
}

template <typename T, bool SHIFTED, bool RESIDUAL, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                T* __restrict__ y, const float* __restrict__ mean_,
                const float* __restrict__ var, const float* __restrict__ weight,
                const float* __restrict__ bias_, long long n_rows, int C) {
  using P = Pack<T>;
  constexpr int VEC = P::kVec;
  const int lanes = C / VEC;                            // vectors in a row
  const int lanes_cta = lanes < kThreads ? lanes : kThreads;
  const int rps = kThreads / lanes_cta;                 // rows a block step
  const int lc = blockIdx.y * lanes_cta + threadIdx.x % lanes_cta;
  const int lr = threadIdx.x / lanes_cta;
  if (lr >= rps || lc >= lanes) return;

  float mean[VEC], mul[VEC], bias[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = lc * VEC + i;
    mean[i] = mean_[c];
    mul[i] = __fmul_rn(rsqrtf(__fadd_rn(var[c], kEpsilon)), weight[c]);
    bias[i] = bias_[c];
    if (SHIFTED) {
      mul[i] = Elem<T>::round(mul[i]);
      bias[i] = Elem<T>::round(bias[i]);
    }
  }

  const long long step = (long long)gridDim.x * rps;
  const long long col = (long long)lc * VEC;
  long long r = (long long)blockIdx.x * rps + lr;
  P xs[kUnroll], rs[kUnroll];
  for (; r + (kUnroll - 1) * step < n_rows; r += kUnroll * step) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (r + u * step) * C + col;
      xs[u] = *reinterpret_cast<const P*>(x + off);
      if (RESIDUAL) rs[u] = *reinterpret_cast<const P*>(res + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (r + u * step) * C + col;
      *reinterpret_cast<P*>(y + off) =
          apply<T, SHIFTED, RESIDUAL, RELU>(xs[u], rs[u], mean, mul, bias);
    }
  }
  for (; r < n_rows; r += step) {
    const long long off = r * C + col;
    xs[0] = *reinterpret_cast<const P*>(x + off);
    if (RESIDUAL) rs[0] = *reinterpret_cast<const P*>(res + off);
    *reinterpret_cast<P*>(y + off) =
        apply<T, SHIFTED, RESIDUAL, RELU>(xs[0], rs[0], mean, mul, bias);
  }
}

// The grid: gridDim.y blocks across a row, and as many blocks along the
// rows as the card holds at once (all resident, so no block waits for a
// second wave), fewer when the rows run out.
template <typename T, bool SHIFTED, bool RESIDUAL, bool RELU>
cudaError_t launch(const void* x, const void* res, void* y,
                   const float* const* p, long long n_rows, int C,
                   cudaStream_t s) {
  auto kernel = bn_apply_kernel<T, SHIFTED, RESIDUAL, RELU>;
  static int resident = 0;  // blocks of this kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int lanes = C / Pack<T>::kVec;
  const int lanes_cta = lanes < kThreads ? lanes : kThreads;
  const int grid_y = (lanes + lanes_cta - 1) / lanes_cta;
  const long long row_steps = (n_rows + kThreads / lanes_cta - 1) /
                              (kThreads / lanes_cta);
  long long grid_x = resident / grid_y;
  if (grid_x > row_steps) grid_x = row_steps;
  if (grid_x < 1) grid_x = 1;
  kernel<<<dim3((unsigned)grid_x, grid_y), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<T*>(y), p[0], p[1], p[2], p[3], n_rows, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* res, void* y,
                     const float* const* p, long long n_rows, int C, int relu,
                     int shifted, cudaStream_t s) {
  const int key = (shifted ? 4 : 0) | (res ? 2 : 0) | (relu ? 1 : 0);
  switch (key) {
    case 0: return launch<T, false, false, false>(x, res, y, p, n_rows, C, s);
    case 1: return launch<T, false, false, true>(x, res, y, p, n_rows, C, s);
    case 2: return launch<T, false, true, false>(x, res, y, p, n_rows, C, s);
    case 3: return launch<T, false, true, true>(x, res, y, p, n_rows, C, s);
    case 4: return launch<T, true, false, false>(x, res, y, p, n_rows, C, s);
    case 5: return launch<T, true, false, true>(x, res, y, p, n_rows, C, s);
    case 6: return launch<T, true, true, false>(x, res, y, p, n_rows, C, s);
    default: return launch<T, true, true, true>(x, res, y, p, n_rows, C, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, residual (null for none) and y:
// (n_rows, C) row-major, 16-byte aligned, C a multiple of 16 bytes' worth
// of elements (the wrapper checks); mean, var, weight, bias: float32 (C,).
extern "C" int hpt_bn_apply(const void* x, const void* residual, void* y,
                            int dtype, const void* mean, const void* var,
                            const void* weight, const void* bias,
                            long long n_rows, int C, int relu, int shifted,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p[4] = {static_cast<const float*>(mean),
                       static_cast<const float*>(var),
                       static_cast<const float*>(weight),
                       static_cast<const float*>(bias)};
  if (n_rows <= 0 || C <= 0 || C % (dtype == 1 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, residual, y, p, n_rows, C, relu, shifted,
                                s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, residual, y, p, n_rows, C, relu,
                                        shifted, s);
  return (int)cudaErrorInvalidValue;
}
