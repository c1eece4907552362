// K7: bilinear crop-and-resize of many boxes from uint8 frames, in the
// three numerics of the JAX package's crops.
//
// A kernel of the port alone: no TPU kernel stands behind it. In the JAX
// package the crop is plain array code, two one-hot-matrix contractions
// per call that XLA lowers to the matrix unit
// (botsort_tpu/ops/crop.py::crop_and_resize, :60, in float32 or bfloat16,
// and ::crop_and_resize_int8, :124, whose x phase is an int8 product).
// Every frame of every path runs it three times: the detector input
// (1080p -> 480x640), the body crops (256x128) and the face crops
// (128x128). Here each output pixel reads its four source taps directly.
// Each thread first finds the taps y0 / y1 and weight wy of its output row
// r and x0 / x1 and wx of its column c from its box, as
// ops/crop.py::_sample_grid does (cv2's half-pixel grid, clamped to the
// box and the frame; ``y1 + gy * (h / out_h)`` as XLA compiles it in the
// JAX steps, one rounding of gy * (h * f32(1 / out_h)) + y1, which the
// plain version and this kernel both compute in float64), then, per
// channel:
//
//   float32   top = p00 + wx (p01 - p00), bot = p10 + wx (p11 - p10),
//             out = top + wy (bot - top)
//   bfloat16  t_i = bf16(a0 bf16(p_i0) + a1 bf16(p_i1)) for rows i = 0, 1,
//             a0 = bf16(1 - wx), a1 = bf16(wx);
//             out = b0 t0 + b1 t1, b0 = bf16(1 - wy), b1 = bf16(wy)
//   int8      q = rint(127 wx), acc_i = (127 - q)(p_i0 - 128) + q(p_i1 - 128),
//             t_i = bf16((acc_i + 16256) / 127); out as in bfloat16
//
// Where the two taps of an axis are one pixel (x0 == x1 at the frame's
// last column, y0 == y1 at its last row) the JAX one-hot weights sum
// before the cast: a0 = bf16((1 - wx) + wx) and a1 = 0 (127 and 0 in
// int8), and so for b0 and b1. A degenerate box (good false) gives 0.
// The plain PyTorch version is ops/crop.py::crop_resize_plain: the same
// float32 and integer operations in the same order, which are written here
// as __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn (never contracted into
// an FMA, and the library is built with --fmad=false besides), with
// __float2bfloat16_rn for each bfloat16 rounding and __float2int_rn (half
// to even, as torch.round and jnp.round) for q. So the three modes agree
// with the plain version bit for bit.
//
// What bounds it on the card: bytes. Each output pixel writes 12 bytes of
// float32 and does about 60 operations; the frame is read once from memory
// and its taps again from L2. One thread computes one output pixel's three
// channels; a block of 256 threads stages its 256 x 3 floats in shared
// memory and writes them as one contiguous run, neighbouring threads on
// neighbouring words. Blocks: output tiles x boxes x frames. The grid is
// computed in the kernel, so a call is one launch (computed apart, its
// two dozen small PyTorch kernels took about ten times K7's device time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum Mode { kFloat32 = 0, kBfloat16 = 1, kInt8 = 2 };
constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float pixel(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float pixel(float v) { return v; }

// The bfloat16 weights of one axis's two taps (see the header).
__device__ __forceinline__ void pair_weights(float w, bool edge, float* w0,
                                             float* w1) {
  const float one_minus = __fsub_rn(1.0f, w);
  *w0 = bf16_round(edge ? __fadd_rn(one_minus, w) : one_minus);
  *w1 = edge ? 0.0f : bf16_round(w);
}

template <typename T, int MODE>
__device__ __forceinline__ void crop_pixel(const T* q00, const T* q01,
                                           const T* q10, const T* q11,
                                           float wy, float wx, bool edge_y,
                                           bool edge_x, float v[3]) {
  if constexpr (MODE == kFloat32) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float p00 = pixel(q00[ch]), p01 = pixel(q01[ch]);
      const float p10 = pixel(q10[ch]), p11 = pixel(q11[ch]);
      const float top = __fadd_rn(p00, __fmul_rn(wx, __fsub_rn(p01, p00)));
      const float bot = __fadd_rn(p10, __fmul_rn(wx, __fsub_rn(p11, p10)));
      v[ch] = __fadd_rn(top, __fmul_rn(wy, __fsub_rn(bot, top)));
    }
  } else {
    float b0, b1;
    pair_weights(wy, edge_y, &b0, &b1);
    if constexpr (MODE == kInt8) {
      const int q = __float2int_rn(__fmul_rn(wx, 127.0f));
      const int w0 = edge_x ? 127 : 127 - q;
      const int w1 = edge_x ? 0 : q;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int acc0 = w0 * (static_cast<int>(q00[ch]) - 128) +
                         w1 * (static_cast<int>(q01[ch]) - 128);
        const int acc1 = w0 * (static_cast<int>(q10[ch]) - 128) +
                         w1 * (static_cast<int>(q11[ch]) - 128);
        const float t0 = bf16_round(
            __fdiv_rn(__fadd_rn(static_cast<float>(acc0), 16256.0f), 127.0f));
        const float t1 = bf16_round(
            __fdiv_rn(__fadd_rn(static_cast<float>(acc1), 16256.0f), 127.0f));
        v[ch] = __fadd_rn(__fmul_rn(b0, t0), __fmul_rn(b1, t1));
      }
    } else {
      float a0, a1;
      pair_weights(wx, edge_x, &a0, &a1);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float t0 = bf16_round(
            __fadd_rn(__fmul_rn(a0, bf16_round(pixel(q00[ch]))),
                      __fmul_rn(a1, bf16_round(pixel(q01[ch])))));
        const float t1 = bf16_round(
            __fadd_rn(__fmul_rn(a0, bf16_round(pixel(q10[ch]))),
                      __fmul_rn(a1, bf16_round(pixel(q11[ch])))));
        v[ch] = __fadd_rn(__fmul_rn(b0, t0), __fmul_rn(b1, t1));
      }
    }
  }
}

// One axis of the sample grid (ops/crop.py::_sample_grid): the taps i0 /
// i1 and weight w of output index k for a box starting at lo of size len,
// out cells over a frame axis of n pixels, in its float32 and float64
// operations and their order.
__device__ __forceinline__ void grid_axis(float lo, float len, int k, int out,
                                          int n, int* i0, int* i1, float* w) {
  const float g = __fadd_rn(static_cast<float>(k), 0.5f);
  const float step = __fmul_rn(len, __fdiv_rn(1.0f, static_cast<float>(out)));
  float s = __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(g), static_cast<double>(step)),
                static_cast<double>(lo)));
  s = __fsub_rn(s, 0.5f);
  s = fminf(fmaxf(s, lo), __fsub_rn(__fadd_rn(lo, len), 1.0f));
  s = fminf(fmaxf(s, 0.0f), static_cast<float>(n - 1));
  const float f = floorf(s);
  *w = __fsub_rn(s, f);
  *i0 = static_cast<int>(f);
  *i1 = min(*i0 + 1, n - 1);
}

// Block (tile, n, b): output pixels tile * 256 ... of box n of frame b.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    crop_resize_kernel(const T* __restrict__ frames,
                       const float* __restrict__ boxes,
                       float* __restrict__ out, int n_boxes, int height,
                       int width, int out_h, int out_w) {
  __shared__ float staged[kThreads * 3];
  const int b = blockIdx.z;
  const long long box = static_cast<long long>(b) * n_boxes + blockIdx.y;
  const int pixels = out_h * out_w;
  const int first = blockIdx.x * kThreads;
  const int p = first + threadIdx.x;
  const float bx1 = __ldg(boxes + box * 4), by1 = __ldg(boxes + box * 4 + 1);
  const float bw = __fsub_rn(__ldg(boxes + box * 4 + 2), bx1);
  const float bh = __fsub_rn(__ldg(boxes + box * 4 + 3), by1);
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (p < pixels && bw >= 1.0f && bh >= 1.0f) {
    const int r = p / out_w;
    const int c = p - r * out_w;
    int y0, y1, x0, x1;
    float wy, wx;
    grid_axis(by1, bh, r, out_h, height, &y0, &y1, &wy);
    grid_axis(bx1, bw, c, out_w, width, &x0, &x1, &wx);
    const T* frame = frames + static_cast<size_t>(b) * height * width * 3;
    const T* row0 = frame + static_cast<size_t>(y0) * width * 3;
    const T* row1 = frame + static_cast<size_t>(y1) * width * 3;
    crop_pixel<T, MODE>(row0 + x0 * 3, row0 + x1 * 3, row1 + x0 * 3,
                        row1 + x1 * 3, wy, wx, y0 == y1, x0 == x1, v);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) staged[threadIdx.x * 3 + ch] = v[ch];
  __syncthreads();
  const int count = 3 * min(kThreads, pixels - first);
  float* dst = out + (box * pixels + first) * 3;
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = staged[i];
}

template <typename T, int MODE>
int run(const void* frames, const float* boxes, float* out,
        const int* params, cudaStream_t stream) {
  const int batch = params[0], n_boxes = params[1], height = params[2],
            width = params[3], out_h = params[4], out_w = params[5];
  const dim3 grid((out_h * out_w + kThreads - 1) / kThreads, n_boxes, batch);
  crop_resize_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(frames), boxes, out, n_boxes, height, width,
      out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params: batch, boxes, frame height, frame width, output height, output
// width, mode (0 float32, 1 bfloat16, 2 int8), frame type (0 uint8,
// 1 float32), threads (256; checked). frames [B, H, W, 3]; boxes [B, N, 4]
// float32 (x1, y1, x2, y2); out [B, N, out_h, out_w, 3] float32; all
// contiguous. Returns the CUDA error of the launch (cudaErrorInvalidValue
// for a combination not built here).
extern "C" int crop_resize_launch(const void* frames, const float* boxes,
                                  float* out, const int* params,
                                  cudaStream_t stream) {
  const int mode = params[6], frame_type = params[7];
  if (params[8] != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (frame_type == 0) {
    switch (mode) {
      case kFloat32:
        return run<uint8_t, kFloat32>(frames, boxes, out, params,
                                      stream);
      case kBfloat16:
        return run<uint8_t, kBfloat16>(frames, boxes, out, params, stream);
      case kInt8:
        return run<uint8_t, kInt8>(frames, boxes, out, params, stream);
      default:
        break;
    }
  } else if (frame_type == 1) {
    switch (mode) {
      case kFloat32:
        return run<float, kFloat32>(frames, boxes, out, params, stream);
      case kBfloat16:
        return run<float, kBfloat16>(frames, boxes, out, params, stream);
      default:
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
