// K6: inference batch norm and activation as one pass over the activation.
//
// A kernel of the port alone: no TPU kernel stands behind it. In the JAX
// package (botsort_tpu/models/common.py and the two encoders) a Flax
// BatchNorm and the activation after it are plain array code that XLA fuses
// into the convolution's output; in eager PyTorch the same arithmetic was
// about nine elementwise kernels a layer, each a read and a write of the
// whole activation. What it computes, for x [N, C, inner] contiguous (inner
// = H*W of an NCHW tensor, or 1 for [N, C]):
//
//   y   = ((float(x) - mean[c]) * mul[c]) + bias[c]      in float32
//   y   = round to x's type                              (where the module
//   out = round to x's type(act(float(y)))                chain rounds)
//
// with mul = rsqrt(var + eps) * scale precomputed by the caller and act one
// of none, SiLU, ReLU, ReLU6. The plain PyTorch version is
// models/bn_act.py::bn_act_plain: the same float32 operations in the same
// order. Subtract, multiply and add are __fsub_rn / __fmul_rn / __fadd_rn,
// which nvcc never contracts into an FMA, so none / ReLU / ReLU6 agree with
// the plain version bit for bit; SiLU is v / (1 + expf(-v)) with IEEE
// division, and differs from another expf by at most one unit in the last
// place of the output.
//
// What bounds it on the card: bytes. One read and one write of the
// activation (2 x 2 bytes an element in bfloat16) against six float32
// operations and, for SiLU, one expf. So every thread moves 16 bytes at a
// time (8 bfloat16 or 4 float32) with neighbouring threads on neighbouring
// addresses, the three per-channel parameters come through the read-only
// cache, and a vector whose elements all lie in one channel (always, when
// inner is a multiple of the vector) loads them once. One division per
// vector finds the channel; the elements after it only count up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum Act { kNone = 0, kSilu = 1, kRelu = 2, kRelu6 = 3 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// max(v, 0) that keeps a NaN, as torch.relu and torch.clamp do.
__device__ __forceinline__ float relu_keep_nan(float v) {
  return v > 0.0f ? v : (v != v ? v : 0.0f);
}

template <typename T, int ACT>
__device__ __forceinline__ T bn_act_one(T x, float mean, float mul,
                                        float bias) {
  float y = __fadd_rn(__fmul_rn(__fsub_rn(widen(x), mean), mul), bias);
  T r;
  narrow(y, &r);  // the norm's output, in the tensor's type
  if (ACT == kNone) return r;
  float v = widen(r);
  if (ACT == kSilu) {
    v = __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
  } else if (ACT == kRelu) {
    v = relu_keep_nan(v);
  } else {
    v = relu_keep_nan(v);
    v = v > 6.0f ? 6.0f : v;
  }
  narrow(v, &r);
  return r;
}

// A grid-stride loop over the vectors of VEC elements; the thread that
// takes a vector finds its first element's channel with one division.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(256)
    bn_act_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ mul,
                  const float* __restrict__ bias, T* __restrict__ out,
                  unsigned total, unsigned channels, unsigned inner) {
  const unsigned n_vec = total / VEC;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const unsigned first = i * VEC;
    const unsigned plane = first / inner;
    unsigned pos = first - plane * inner;
    unsigned c = plane % channels;
    const Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(x + first);
    Pack<T, VEC> o;
    if (pos + VEC <= inner) {  // one channel for the whole vector
      const float m = __ldg(mean + c), s = __ldg(mul + c);
      const float b = __ldg(bias + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = bn_act_one<T, ACT>(in.v[j], m, s, b);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        o.v[j] = bn_act_one<T, ACT>(in.v[j], __ldg(mean + c), __ldg(mul + c),
                                    __ldg(bias + c));
        if (++pos == inner) {
          pos = 0;
          if (++c == channels) c = 0;
        }
      }
    }
    *reinterpret_cast<Pack<T, VEC>*>(out + first) = o;
  }
  // The elements after the last whole vector (fewer than VEC).
  const unsigned tail = n_vec * VEC + blockIdx.x * blockDim.x + threadIdx.x;
  if (tail < total) {
    const unsigned c = (tail / inner) % channels;
    out[tail] = bn_act_one<T, ACT>(x[tail], __ldg(mean + c), __ldg(mul + c),
                                   __ldg(bias + c));
  }
}

template <typename T, int VEC>
int run(const void* x, const float* mean, const float* mul, const float* bias,
        void* out, unsigned total, unsigned channels, unsigned inner, int act,
        int grid, int threads, cudaStream_t stream) {
#define BN_ACT_LAUNCH(A)                                                   \
  bn_act_kernel<T, VEC, A><<<grid, threads, 0, stream>>>(                  \
      static_cast<const T*>(x), mean, mul, bias, static_cast<T*>(out),     \
      total, channels, inner)
  switch (act) {
    case kNone: BN_ACT_LAUNCH(kNone); break;
    case kSilu: BN_ACT_LAUNCH(kSilu); break;
    case kRelu: BN_ACT_LAUNCH(kRelu); break;
    case kRelu6: BN_ACT_LAUNCH(kRelu6); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BN_ACT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params: total elements, channels, inner, dtype (0 float32, 1 bfloat16),
// act (0 none, 1 SiLU, 2 ReLU, 3 ReLU6), vec (elements a 16-byte access
// holds, or 1 where x or out is not 16-byte aligned), grid, threads: the
// launch models/bn_act.py::bn_act_plan decided. Returns the CUDA error of
// the launch (cudaErrorInvalidValue for a combination not built here).
extern "C" int bn_act_launch(const void* x, const float* mean,
                             const float* mul, const float* bias, void* out,
                             const int* params, void* stream) {
  const unsigned total = static_cast<unsigned>(params[0]);
  const unsigned channels = static_cast<unsigned>(params[1]);
  const unsigned inner = static_cast<unsigned>(params[2]);
  const int dtype = params[3], act = params[4], vec = params[5];
  const int grid = params[6], threads = params[7];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total == 0 || channels == 0 || inner == 0 || grid < 1 || threads < 1 ||
      threads > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define BN_ARGS x, mean, mul, bias, out, total, channels, inner, act, grid, \
                threads, s
  if (dtype == 0) {
    if (vec == 4) return run<float, 4>(BN_ARGS);
    if (vec == 1) return run<float, 1>(BN_ARGS);
  } else if (dtype == 1) {
    if (vec == 8) return run<__nv_bfloat16, 8>(BN_ARGS);
    if (vec == 1) return run<__nv_bfloat16, 1>(BN_ARGS);
  }
#undef BN_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
