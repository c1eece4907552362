// K6: inference batch norm and activation as one pass over the activation.
//
// A kernel of the port alone: no TPU kernel stands behind it. In the JAX
// package (botsort_tpu/models/common.py and the two encoders) a Flax
// BatchNorm and the activation after it are plain array code that XLA fuses
// into the convolution's output; in eager PyTorch the same arithmetic was
// about nine elementwise kernels a layer, each a read and a write of the
// whole activation. What it computes, per channel c of x:
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
// addresses. Two layouts, two kernels, one arithmetic (bn_act_one):
//
// - bn_act_kernel, x [N, C, inner] contiguous (inner = H*W of an NCHW
//   tensor): the per-channel parameters come through the read-only cache,
//   and a vector whose elements all lie in one channel (always, when inner
//   is a multiple of the vector) loads them once. One division per vector
//   finds the channel; the elements after it only count up.
// - bn_act_kernel_cl, x [rows, C] with the channels innermost (a
//   channels-last [N, C, H, W], which the networks run on the card, and
//   [N, C] or [N, C, 1, 1]): a thread owns one column of VEC consecutive
//   channels for the whole launch, loads that column's mean, mul and bias
//   once into registers (float4 loads), and walks the rows two at a time,
//   so every access is a whole 16-byte vector of one row's channels, with
//   no division and no parameter load per vector. C not a multiple of the
//   vector, or unaligned pointers, take VEC = 1: the same kernel, a
//   channel a thread.

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

// mean / mul / bias of channels c0 .. c0 + VEC - 1, float4 loads where the
// column is whole vectors of them (c0 a multiple of 4, the base 16-byte
// aligned: the wrapper checks).
template <int VEC>
__device__ __forceinline__ void load_column(const float* __restrict__ p,
                                            unsigned c0, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + c0 + j));
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __ldg(p + c0 + j);
  }
}

template <typename T, int VEC, int ACT>
__device__ __forceinline__ Pack<T, VEC> bn_act_pack(const Pack<T, VEC>& in,
                                                    const float (&m)[VEC],
                                                    const float (&s)[VEC],
                                                    const float (&b)[VEC]) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o.v[j] = bn_act_one<T, ACT>(in.v[j], m[j], s[j], b[j]);
  return o;
}

// Channels innermost: x [rows, channels], row-major. A block is
// ``per_block`` rows of ``tile`` columns (a column: VEC channels); blockIdx.y
// picks the tile of columns, blockIdx.x the first rows, and the grid strides
// over the rest. A thread keeps its column, and so its parameters, to the
// end.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(256)
    bn_act_kernel_cl(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ mul,
                     const float* __restrict__ bias, T* __restrict__ out,
                     unsigned rows, unsigned channels, unsigned tile) {
  const unsigned col = blockIdx.y * tile + threadIdx.x % tile;
  if (col * VEC >= channels) return;
  const unsigned per_block = blockDim.x / tile;
  const unsigned stride = gridDim.x * per_block;
  const unsigned c0 = col * VEC;
  float m[VEC], s[VEC], b[VEC];
  load_column<VEC>(mean, c0, m);
  load_column<VEC>(mul, c0, s);
  load_column<VEC>(bias, c0, b);
  using P = Pack<T, VEC>;
  unsigned r = blockIdx.x * per_block + threadIdx.x / tile;
  // Two rows in flight a thread: both loads issue before either store.
  for (; r + stride < rows; r += 2 * stride) {
    const unsigned i0 = r * channels + c0, i1 = (r + stride) * channels + c0;
    const P a = *reinterpret_cast<const P*>(x + i0);
    const P a2 = *reinterpret_cast<const P*>(x + i1);
    *reinterpret_cast<P*>(out + i0) = bn_act_pack<T, VEC, ACT>(a, m, s, b);
    *reinterpret_cast<P*>(out + i1) = bn_act_pack<T, VEC, ACT>(a2, m, s, b);
  }
  if (r < rows) {
    const unsigned i0 = r * channels + c0;
    const P a = *reinterpret_cast<const P*>(x + i0);
    *reinterpret_cast<P*>(out + i0) = bn_act_pack<T, VEC, ACT>(a, m, s, b);
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

template <typename T, int VEC>
int run_cl(const void* x, const float* mean, const float* mul,
           const float* bias, void* out, unsigned rows, unsigned channels,
           int act, unsigned tile, dim3 grid, unsigned threads,
           cudaStream_t stream) {
#define BN_ACT_CL_LAUNCH(A)                                                \
  bn_act_kernel_cl<T, VEC, A><<<grid, threads, 0, stream>>>(               \
      static_cast<const T*>(x), mean, mul, bias, static_cast<T*>(out),     \
      rows, channels, tile)
  switch (act) {
    case kNone: BN_ACT_CL_LAUNCH(kNone); break;
    case kSilu: BN_ACT_CL_LAUNCH(kSilu); break;
    case kRelu: BN_ACT_CL_LAUNCH(kRelu); break;
    case kRelu6: BN_ACT_CL_LAUNCH(kRelu6); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BN_ACT_CL_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The contiguous path. params: total elements, channels, inner, dtype (0
// float32, 1 bfloat16), act (0 none, 1 SiLU, 2 ReLU, 3 ReLU6), vec
// (elements a 16-byte access holds, or 1 where x or out is not 16-byte
// aligned), grid, threads: the launch models/bn_act.py::bn_act_plan decided. Returns the CUDA error of
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

// The channels-innermost path. params: rows, channels, dtype, act, vec
// (elements a 16-byte access holds, or 1), tile (columns of vec channels a
// block spans), rows a block takes at once, grid x (blocks along the rows),
// grid y (tiles of columns): the launch models/bn_act.py::bn_act_cl_plan
// decided. Returns the CUDA error of the launch (cudaErrorInvalidValue for
// a plan that does not cover x or a combination not built here).
extern "C" int bn_act_cl_launch(const void* x, const float* mean,
                                const float* mul, const float* bias,
                                void* out, const int* params, void* stream) {
  const unsigned rows = static_cast<unsigned>(params[0]);
  const unsigned channels = static_cast<unsigned>(params[1]);
  const int dtype = params[2], act = params[3], vec = params[4];
  const unsigned tile = static_cast<unsigned>(params[5]);
  const unsigned per_block = static_cast<unsigned>(params[6]);
  const dim3 grid(static_cast<unsigned>(params[7]),
                  static_cast<unsigned>(params[8]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || channels == 0 || vec < 1 || channels % vec != 0 ||
      tile == 0 || per_block == 0 || tile * per_block > 256 ||
      grid.x == 0 || grid.y == 0 || grid.y > 65535 ||
      static_cast<unsigned long long>(tile) * grid.y * vec < channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define BN_CL_ARGS x, mean, mul, bias, out, rows, channels, act, tile, grid, \
                   tile * per_block, s
  if (dtype == 0) {
    if (vec == 4) return run_cl<float, 4>(BN_CL_ARGS);
    if (vec == 1) return run_cl<float, 1>(BN_CL_ARGS);
  } else if (dtype == 1) {
    if (vec == 8) return run_cl<__nv_bfloat16, 8>(BN_CL_ARGS);
    if (vec == 1) return run_cl<__nv_bfloat16, 1>(BN_CL_ARGS);
  }
#undef BN_CL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
