// K5: depthwise 3x3 convolution, stride 1, SAME padding, on NCHW planes.
//
// Replaces the TPU kernel botsort_tpu/models/facereid_pallas.py::_dw_kernel
// (entered through dw_conv3x3_same and DWConvPallas, which
// FaceReID(dw_mode="pallas") runs for every stride-1 depthwise 3x3). What it
// computes: out[n,c,y,x] = sum over (dy, dx) in row-major order of
// x[n,c,y+dy-1,x+dx-1] * taps[dy*3+dx, c], the input widened to float32, the
// sum carried in float32 from 0, one store in the input's type; taps outside
// the plane read 0. The plain PyTorch version is
// models/facereid_dw.py::dw_conv3x3_plain: the same nine multiplies and adds
// in the same order, so the two agree bit for bit. Multiplies and adds are
// written as __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA.
//
// What bounds it on the card: bytes. Each input element is read once from
// device memory and each output written once; nine multiply-adds per output
// are far below the card's float32 rate (at the face encoder's 13 layers and
// 50 faces: 2 x 29.7 M bf16 elements = 119 MB, 35.5 us at 3.35 TB/s, against
// 0.53 GFLOP, 8 us at 67 TFLOP/s). The TPU kernel's grid over images and its
// VMEM row loop are TPU layout; here one block takes a tile of whole planes
// (planes of at most 1024 pixels) or of rows of one plane, stages the tile
// and its one-pixel halo in shared memory as float32 (the SAME padding is a
// mask on that load: no padded copy exists in device memory), and every
// thread computes outputs from shared memory with the plane's nine taps.
//
// Layout: x [N,C,H,W] (float32 or bfloat16), taps [9,C] float32 ->
// out [N,C,H,W] of x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileOutputs = 1024;  // outputs a block computes, about

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// One block: planes [p0, p0 + pp) and rows [y0, y0 + th) of each.
template <typename T>
__global__ void dw3x3_kernel(const T* __restrict__ x,
                             const float* __restrict__ taps,
                             T* __restrict__ out, int n_planes, int c, int h,
                             int w, int pp, int th, int tiles_per_plane) {
  extern __shared__ float tile[];  // [pp][th + 2][w + 2]
  const int tw = w + 2;
  const int tr = th + 2;
  const int p0 = (blockIdx.x / tiles_per_plane) * pp;
  const int y0 = (blockIdx.x % tiles_per_plane) * th;

  const int n_in = pp * tr * tw;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int p = i / (tr * tw);
    const int rem = i - p * tr * tw;
    const int yy = y0 + rem / tw - 1;
    const int xx = rem % tw - 1;
    float v = 0.0f;
    if (p0 + p < n_planes && yy >= 0 && yy < h && xx >= 0 && xx < w) {
      v = widen(x[(static_cast<size_t>(p0 + p) * h + yy) * w + xx]);
    }
    tile[i] = v;
  }
  __syncthreads();

  const int n_out = pp * th * w;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int p = i / (th * w);
    const int rem = i - p * th * w;
    const int ty = rem / w;
    const int tx = rem % w;
    const int plane = p0 + p;
    const int y = y0 + ty;
    if (plane >= n_planes || y >= h) continue;
    const int ch = plane % c;
    const float* src = tile + (p * tr + ty) * tw + tx;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        acc = __fadd_rn(acc, __fmul_rn(src[dy * tw + dx],
                                       taps[(dy * 3 + dx) * c + ch]));
      }
    }
    narrow(acc, out + (static_cast<size_t>(plane) * h + y) * w + tx);
  }
}

// Tile shape: whole planes when a plane has at most kTileOutputs pixels,
// else rows of one plane.
void tile_shape(int h, int w, int* pp, int* th) {
  if (h * w <= kTileOutputs) {
    *pp = kTileOutputs / (h * w);
    *th = h;
  } else {
    *pp = 1;
    *th = kTileOutputs / w > 0 ? kTileOutputs / w : 1;
    if (*th > h) *th = h;
  }
}

}  // namespace

extern "C" int dw_conv3x3_smem_bytes(int h, int w) {
  int pp = 0, th = 0;
  tile_shape(h, w, &pp, &th);
  return static_cast<int>(sizeof(float)) * pp * (th + 2) * (w + 2);
}

// dtype: 0 float32, 1 bfloat16. Returns the CUDA error of the launch.
extern "C" int dw_conv3x3_launch(const void* x, const float* taps, void* out,
                                 int n, int c, int h, int w, int dtype,
                                 void* stream) {
  int pp = 0, th = 0;
  tile_shape(h, w, &pp, &th);
  const int n_planes = n * c;
  const int tiles_per_plane = (h + th - 1) / th;
  const int blocks = ((n_planes + pp - 1) / pp) * tiles_per_plane;
  const int smem = dw_conv3x3_smem_bytes(h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dw3x3_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), taps, static_cast<float*>(out),
        n_planes, c, h, w, pp, th, tiles_per_plane);
  } else if (dtype == 1) {
    dw3x3_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), taps,
        static_cast<__nv_bfloat16*>(out), n_planes, c, h, w, pp, th,
        tiles_per_plane);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
