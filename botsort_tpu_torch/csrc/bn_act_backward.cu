// K6b: the backward of K6 (inference batch norm + activation), for training.
//
// A kernel of the port alone: no TPU kernel stands behind it. The JAX
// package trains its encoders (botsort_tpu/train/reid_trainer.py) with
// jax.grad through the Flax BatchNorm and activation of
// botsort_tpu/models/common.py:62, which XLA differentiates and fuses; the
// port's forward is kernel K6 (bn_act.cu), and this is its backward. For
// x [N, C, inner] contiguous (inner = H*W of an NCHW tensor, or 1 for
// [N, C]), grad_out of x's shape and type, and mean, mul, bias [C] float32:
//
//   y       = round to x's type(((float(x) - mean) * mul) + bias)  (K6's y,
//             recomputed here, not saved by the forward)
//   g_y     = round to x's type(grad_out * act'(y))
//   grad_x  = round to x's type(g_y * mul)
//   sum_gy  [c] = sum of g_y over channel c
//   sum_gyx [c] = sum of g_y * (float(x) - mean) over channel c
//
// act' follows torch's backward of each activation: none passes grad_out;
// ReLU passes it where y > 0 (threshold_backward); ReLU6 = clamp(y, 0, 6)
// where 0 <= y <= 6 (clamp_backward); SiLU is silu_backward's
// dy * s * (1 + y * (1 - s)), s = 1 / (1 + exp(-y)), in float32, with the
// one fused multiply-add that ATen's CUDA build contracts. The caller
// (models/bn_act.py) turns the sums into the [C] gradients: grad_mean =
// -mul * sum_gy, grad_mul = sum_gyx, grad_bias = sum_gy. The plain PyTorch
// version is models/bn_act.py::bn_act_backward_plain.
//
// Deterministic sums: pass 1 runs one block per (channel, slice of planes);
// each thread adds its elements in a fixed order into float64, the block
// reduces its threads in a fixed tree and writes one partial per slice;
// pass 2 adds a channel's partials in slice order. So two calls on the same
// inputs give the same bits (no atomics), and with float64 accumulation the
// sums agree with the plain version's float64 sums to far below float32's
// precision. Products and sums are __fmul_rn / __fadd_rn / __fsub_rn, which
// nvcc never contracts (the library is built with --fmad=false), so
// grad_x equals the plain version bit for bit for none, ReLU and ReLU6; for
// SiLU it does where the plain version runs ATen's CUDA silu_backward and
// both exponentials round alike.
//
// What bounds it on the card: bytes. It reads grad_out and x and writes
// grad_x (3 x 2 bytes an element in bfloat16) against about ten float32
// operations an element and two float64 additions. A block's threads walk
// its planes with 16-byte vectors where every plane is a whole number of
// vectors and the pointers are aligned, neighbouring threads on
// neighbouring addresses; [N, C] tensors (inner = 1) fall back to one
// element a thread, strided by C, which is uncoalesced but small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum Act { kNone = 0, kSilu = 1, kRelu = 2, kRelu6 = 3 };

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  T r;
  narrow(v, &r);
  return widen(r);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// One element: writes grad_x and adds to the two sums.
template <typename T, int ACT>
__device__ __forceinline__ T backward_one(T g, T xv, float mean, float mul,
                                          float bias, double& s_gy,
                                          double& s_gyx) {
  const float d = __fsub_rn(widen(xv), mean);
  float gy = widen(g);
  if (ACT != kNone) {
    // K6's y: the norm's output rounded to the tensor's type.
    const float y = round_to<T>(__fadd_rn(__fmul_rn(d, mul), bias));
    if (ACT == kRelu) {
      gy = y > 0.0f ? gy : 0.0f;
    } else if (ACT == kRelu6) {
      gy = (y >= 0.0f && y <= 6.0f) ? gy : 0.0f;
    } else {
      // ATen's CUDA silu_backward, as nvcc compiles it there: the sum
      // 1 + y * (1 - s) contracted into one fused multiply-add.
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
      gy = __fmul_rn(__fmul_rn(gy, s),
                     __fmaf_rn(y, __fsub_rn(1.0f, s), 1.0f));
    }
    gy = round_to<T>(gy);
  }
  s_gy += static_cast<double>(gy);
  s_gyx += static_cast<double>(__fmul_rn(gy, d));
  T r;
  narrow(__fmul_rn(gy, mul), &r);
  return r;
}

// A fixed-order sum of one value per thread of the block; thread 0 gets it.
__device__ __forceinline__ double block_sum(double v, double* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (blockDim.x >> 5); ++w) total += scratch[w];
  }
  __syncthreads();
  return total;
}

// Pass 1. Block (c, j): channel c = blockIdx.x, planes [j * per, (j + 1) *
// per) of the N, slice j = blockIdx.y; VEC elements a thread step (1 or a
// 16-byte vector; VEC > 1 only where inner is a multiple of VEC).
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_act_backward_kernel(const T* __restrict__ grad_out,
                           const T* __restrict__ x,
                           const float* __restrict__ mean,
                           const float* __restrict__ mul,
                           const float* __restrict__ bias,
                           T* __restrict__ grad_x,
                           double* __restrict__ partial_gy,
                           double* __restrict__ partial_gyx, unsigned planes,
                           unsigned channels, unsigned inner,
                           unsigned planes_per_slice) {
  __shared__ double scratch[kThreads / 32];
  const unsigned c = blockIdx.x, j = blockIdx.y;
  const unsigned n0 = j * planes_per_slice;
  const unsigned n1 = min(planes, n0 + planes_per_slice);
  const float m = __ldg(mean + c), s = __ldg(mul + c), b = __ldg(bias + c);
  const unsigned per_plane = inner / VEC;
  const unsigned count = (n1 > n0 ? n1 - n0 : 0) * per_plane;
  double s_gy = 0.0, s_gyx = 0.0;
  for (unsigned e = threadIdx.x; e < count; e += blockDim.x) {
    const unsigned n = n0 + e / per_plane;
    const size_t at = (static_cast<size_t>(n) * channels + c) * inner +
                      static_cast<size_t>(e % per_plane) * VEC;
    const Pack<T, VEC> g = *reinterpret_cast<const Pack<T, VEC>*>(grad_out +
                                                                  at);
    const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(x + at);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      o.v[k] = backward_one<T, ACT>(g.v[k], xv.v[k], m, s, b, s_gy, s_gyx);
    }
    *reinterpret_cast<Pack<T, VEC>*>(grad_x + at) = o;
  }
  const double t_gy = block_sum(s_gy, scratch);
  const double t_gyx = block_sum(s_gyx, scratch);
  if (threadIdx.x == 0) {
    partial_gy[static_cast<size_t>(c) * gridDim.y + j] = t_gy;
    partial_gyx[static_cast<size_t>(c) * gridDim.y + j] = t_gyx;
  }
}

// Pass 2: one thread a channel adds its partials in slice order.
__global__ void __launch_bounds__(kThreads)
    bn_act_backward_sums(const double* __restrict__ partial_gy,
                         const double* __restrict__ partial_gyx,
                         float* __restrict__ sum_gy,
                         float* __restrict__ sum_gyx, unsigned channels,
                         unsigned slices) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  double a = 0.0, b = 0.0;
  for (unsigned j = 0; j < slices; ++j) {
    a += partial_gy[static_cast<size_t>(c) * slices + j];
    b += partial_gyx[static_cast<size_t>(c) * slices + j];
  }
  sum_gy[c] = static_cast<float>(a);
  sum_gyx[c] = static_cast<float>(b);
}

template <typename T, int VEC>
int run(const void* grad_out, const void* x, const float* mean,
        const float* mul, const float* bias, void* grad_x, double* partial_gy,
        double* partial_gyx, float* sum_gy, float* sum_gyx, unsigned planes,
        unsigned channels, unsigned inner, unsigned slices,
        unsigned planes_per_slice, int act, cudaStream_t stream) {
  const dim3 grid(channels, slices);
#define BN_BWD_LAUNCH(A)                                                     \
  bn_act_backward_kernel<T, VEC, A><<<grid, kThreads, 0, stream>>>(          \
      static_cast<const T*>(grad_out), static_cast<const T*>(x), mean, mul,  \
      bias, static_cast<T*>(grad_x), partial_gy, partial_gyx, planes,        \
      channels, inner, planes_per_slice)
  switch (act) {
    case kNone: BN_BWD_LAUNCH(kNone); break;
    case kSilu: BN_BWD_LAUNCH(kSilu); break;
    case kRelu: BN_BWD_LAUNCH(kRelu); break;
    case kRelu6: BN_BWD_LAUNCH(kRelu6); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BN_BWD_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_act_backward_sums<<<(channels + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(partial_gy, partial_gyx, sum_gy, sum_gyx,
                                   channels, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params: planes (N), channels (C), inner, dtype (0 float32, 1 bfloat16),
// act (0 none, 1 SiLU, 2 ReLU, 3 ReLU6), vec (elements a 16-byte access
// holds, or 1), slices (blocks per channel), planes_per_slice: the launch
// models/bn_act.py::bn_act_backward_plan decided. partial_gy / partial_gyx
// are [C, slices] float64 scratch. Returns the CUDA error of the launches
// (cudaErrorInvalidValue for a combination not built here).
extern "C" int bn_act_backward_launch(const void* grad_out, const void* x,
                                      const float* mean, const float* mul,
                                      const float* bias, void* grad_x,
                                      double* partial_gy, double* partial_gyx,
                                      float* sum_gy, float* sum_gyx,
                                      const int* params, void* stream) {
  const unsigned planes = static_cast<unsigned>(params[0]);
  const unsigned channels = static_cast<unsigned>(params[1]);
  const unsigned inner = static_cast<unsigned>(params[2]);
  const int dtype = params[3], act = params[4], vec = params[5];
  const unsigned slices = static_cast<unsigned>(params[6]);
  const unsigned per = static_cast<unsigned>(params[7]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes == 0 || channels == 0 || inner == 0 || slices == 0 ||
      slices > 65535 || per == 0 || static_cast<size_t>(slices) * per <
      planes || inner % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define BN_BWD_ARGS grad_out, x, mean, mul, bias, grad_x, partial_gy,      \
                    partial_gyx, sum_gy, sum_gyx, planes, channels, inner, \
                    slices, per, act, s
  if (dtype == 0) {
    if (vec == 4) return run<float, 4>(BN_BWD_ARGS);
    if (vec == 1) return run<float, 1>(BN_BWD_ARGS);
  } else if (dtype == 1) {
    if (vec == 8) return run<__nv_bfloat16, 8>(BN_BWD_ARGS);
    if (vec == 1) return run<__nv_bfloat16, 1>(BN_BWD_ARGS);
  }
#undef BN_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
