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
// 0.53 GFLOP, 8 us at 67 TFLOP/s). So the design is built for bytes in
// flight:
// - A block's tile is one contiguous span of memory: whole planes where a
//   plane has at most 256 pixels (the face encoder's 16x16, 8x8 and 4x4),
//   else a band of rows of one plane with a one-row halo. It is copied to
//   shared memory with 16-byte loads, in the input's type; SAME padding is
//   a mask on the shared-memory read, so no padded copy exists anywhere.
// - Each thread computes runs of RW outputs along x (8 bf16 or 4 float32,
//   one 16-byte store; 1 on the scalar path, for widths that are not a
//   multiple of RW) from three rows read from shared memory, widened to
//   float32 in registers where the plain version widens. Its channel's nine
//   taps sit in registers, reloaded only when its plane changes.
// - Coordinates are computed once per thread; walking to the next run adds
//   a stride carried across run columns, rows and planes, with no division
//   per element.
// The tiling (span or band, RW, threads, grid, shared bytes) is
// decided in Python by models/facereid_dw.py::dw_plan and passed in, so it
// has one definition that the CPU tests check.
//
// Layout: x [N,C,H,W] (float32 or bfloat16), taps [9,C] float32 ->
// out [N,C,H,W] of x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// n consecutive elements, loaded and stored as one vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Copies count elements from device memory to shared memory, with 16-byte
// loads where both ends are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int count) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  int i = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int nv = count / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (; i < nv; i += blockDim.x) d4[i] = __ldg(s4 + i);
    i = nv * kVec + threadIdx.x;
  }
  for (; i < count; i += blockDim.x) dst[i] = src[i];
}

// One block: the tile of planes [p0, p0 + planes) and rows [y0, y0 + rows)
// (band: planes = 1; span: y0 = 0, rows = h). Runs are RW outputs along x.
template <typename T, int RW>
__global__ void __launch_bounds__(256)
    dw3x3_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                 T* __restrict__ out, int n_planes, int c, int h, int w,
                 int band, int pp, int th) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  int p0, y0, rows, planes, tile_y0, tile_rows, lo, hi;
  if (band) {
    p0 = blockIdx.x;
    y0 = blockIdx.y * th;
    rows = min(th, h - y0);
    planes = 1;
    tile_y0 = y0 - 1;  // tile row 0 is the halo row above the band
    tile_rows = th + 2;
    lo = max(y0 - 1, 0);
    hi = min(y0 + rows + 1, h);
  } else {
    p0 = blockIdx.x * pp;
    y0 = 0;
    rows = h;
    planes = min(pp, n_planes - p0);
    tile_y0 = 0;
    tile_rows = h;
    lo = 0;
    hi = h * planes;  // whole planes: one span of rows
  }
  copy_span(tile + (lo - tile_y0) * w,
            x + (static_cast<size_t>(p0) * h + lo) * w, (hi - lo) * w);
  __syncthreads();

  // This thread's first run (plane lp of the tile, row rr of the block's
  // rows, run column rc) and the block stride in the same units,
  // decomposed once.
  const int rpr = w / RW;
  int rc = threadIdx.x % rpr;
  int rr = threadIdx.x / rpr;
  int lp = rr / rows;
  rr -= lp * rows;
  const int sc = blockDim.x % rpr;
  int sr = blockDim.x / rpr;
  const int sp = sr / rows;
  sr -= sp * rows;

  int loaded = -1;
  float k[9];
  for (; lp < planes; ) {
    const int plane = p0 + lp;
    if (plane != loaded) {  // the channel's taps, once per plane
      const int ch = plane % c;
#pragma unroll
      for (int t = 0; t < 9; ++t) k[t] = __ldg(taps + t * c + ch);
      loaded = plane;
    }
    const int y = y0 + rr;
    const int x0 = rc * RW;
    float acc[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) acc[j] = 0.0f;
    // Rows y-1, y, y+1 in (dy, dx) order; a row outside the plane reads 0.
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int wy = y - 1 + dy;
      float win[RW + 2];
      if (wy >= 0 && wy < h) {
        const T* row = tile + (lp * tile_rows + wy - tile_y0) * w;
        const Pack<T, RW> mid =
            *reinterpret_cast<const Pack<T, RW>*>(row + x0);
        win[0] = x0 > 0 ? widen(row[x0 - 1]) : 0.0f;
#pragma unroll
        for (int j = 0; j < RW; ++j) win[j + 1] = widen(mid.v[j]);
        win[RW + 1] = x0 + RW < w ? widen(row[x0 + RW]) : 0.0f;
      } else {
#pragma unroll
        for (int j = 0; j < RW + 2; ++j) win[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < RW; ++j) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(win[j + dx], k[dy * 3 + dx]));
        }
      }
    }
    Pack<T, RW> o;
#pragma unroll
    for (int j = 0; j < RW; ++j) narrow(acc[j], &o.v[j]);
    *reinterpret_cast<Pack<T, RW>*>(
        out + (static_cast<size_t>(plane) * h + y) * w + x0) = o;

    // Next run: add the stride, carrying run columns into rows and rows
    // into planes.
    rc += sc;
    int carry = rc >= rpr;
    rc -= carry * rpr;
    rr += sr + carry;
    carry = rr >= rows;
    rr -= carry * rows;
    lp += sp + carry;
  }
}

template <typename T, int RW>
int run(const void* x, const float* taps, void* out, int n_planes, int c,
        int h, int w, int band, int pp, int th, int threads, int grid_x,
        int grid_y, int smem, cudaStream_t stream) {
  auto kernel = dw3x3_kernel<T, RW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(grid_x, grid_y), threads, smem, stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(out), n_planes, c, h,
      w, band, pp, th);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params: n, c, h, w, dtype (0 float32, 1 bfloat16), then the plan of
// models/facereid_dw.py::dw_plan: band, planes, rows, rw, threads, grid x,
// grid y, shared bytes. One array, so the host passes five
// arguments a call. Returns the CUDA error of the launch
// (cudaErrorInvalidValue for a run shape not built here).
extern "C" int dw_conv3x3_launch(const void* x, const float* taps, void* out,
                                 const int* params, void* stream) {
  const int n = params[0], c = params[1], h = params[2], w = params[3];
  const int dtype = params[4], band = params[5], pp = params[6];
  const int th = params[7], rw = params[8], threads = params[9];
  const int grid_x = params[10], grid_y = params[11], smem = params[12];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = n * c;
#define DW_ARGS x, taps, out, np, c, h, w, band, pp, th, threads, grid_x, \
                grid_y, smem, s
  if (dtype == 0) {
    if (rw == 4) return run<float, 4>(DW_ARGS);
    if (rw == 1) return run<float, 1>(DW_ARGS);
  } else if (dtype == 1) {
    if (rw == 8) return run<__nv_bfloat16, 8>(DW_ARGS);
    if (rw == 1) return run<__nv_bfloat16, 1>(DW_ARGS);
  }
#undef DW_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
