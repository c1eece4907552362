// K4: the ResNeSt-50 deep stem and stage 1 (three split-attention
// bottlenecks) of the body encoder, batch-norm folded into per-channel
// float32 scale and bias.
//
// Replaces the TPU kernel botsort_tpu/models/fastreid_pallas.py::_make_kernel
// (launched by _stem_stage1_call, entered through stem_stage1, which
// FastReIDSBS(fused_stem=True) runs). What it computes, per image:
//   stem   three 3x3 convs (3->sw stride 2, sw->sw, sw->2sw), each followed
//          by acc*scale + bias, ReLU and a bfloat16 store; a 3x3/2 max pool
//          (its padding never wins);
//   stage 1, per block: 1x1 in (+ReLU); the radix-2 grouped 3x3 (+ReLU);
//          split attention in float32 (pixel mean of each radix half, summed
//          over radix; Dense_0 with its batch norm folded in, ReLU; Dense_1;
//          a two-way softmax as att0 = e0/(e0+e1), att1 = 1 - att0; the
//          weighted radix sum, one bfloat16 store); 1x1 out; the shortcut
//          (a folded 1x1 kept in float32 in block 0, else the bfloat16
//          input); relu(out + shortcut), one bfloat16 store.
// Every product is bfloat16 x bfloat16 summed in float32. The plain
// PyTorch version is models/fastreid_fused.py::stem_stage1_plain; the two
// sum in different orders, so they agree to float32 rounding before each
// bfloat16 store.
//
// What bounds it on the card: operations. 1.34 GFLOP of convolution per
// 256x128 image (stem 467 M, block 0 302 M, blocks 1 and 2 285 M each)
// against 1.25 MB of input and output: 1,070 FLOP a byte, above the H100's
// 295 for bfloat16. At 50 crops, 67.0 GFLOP is 67.7 us at 989 TFLOP/s,
// 62 MB is 18.6 us at 3.35 TB/s.
//
// Design. The TPU kernel keeps one image's stem and stage 1 in 32 MB of
// VMEM and packs pixel pairs into lanes; both are TPU layout. One image's
// stem activations (1 MB) do not fit a Hopper block's 227 KB of shared
// memory, so here one C entry point launches a fixed sequence of 17
// kernels on the caller's stream, with activations in NHWC bfloat16
// scratch that the caller allocates:
//   conv_kernel      implicit-GEMM direct convolution: a 64-pixel x
//                    64-channel output tile per block, K (taps x input
//                    channels of one group) in steps of 32 gathered into
//                    shared memory, bfloat16 16x16x16 WMMA fragments with
//                    float32 accumulation; the epilogue applies scale and
//                    bias, the residual, ReLU and the store (NHWC, NCHW or
//                    float32). Used for all 13 convolutions.
//   maxpool_kernel   the 3x3/2 max pool, one thread per output.
//   attention_kernel one block per image: the pixel-mean reduction, the
//                    two dense layers and the softmax, the weighted sum.
// Weights come packed as [groups][K padded to 32][out channels of a group
// padded to 64] bfloat16, K ordered (ky, kx, input channel), zeros in the
// padding (models/fastreid_fused.py::pack_conv).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // output pixels per conv block
constexpr int BN = 64;   // output channels per conv block
constexpr int BK = 32;   // K per shared-memory stage
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kConvThreads = 128;  // four warps, 32x32 outputs each
constexpr int kAttThreads = 512;
constexpr int kPoolThreads = 256;
constexpr int kPtrsPerConv = 3;    // packed weight, scale, bias
constexpr int kPtrsPerBlock = 16;  // in, grouped, wd1, bd1, wd2, bd2, out, sc

struct ConvArgs {
  const bf16* x;       // NHWC [n, h, w, cin]
  const bf16* wt;      // [groups][kpad][npad]
  const float* scale;  // [cout]
  const float* bias;   // [cout]
  const void* res;     // NHWC [n, ho, wo, cout], or null
  void* out;
  long long os_n, os_y, os_x, os_c;  // output element strides
  int n, h, w, cin, cout, ksize, stride, pad, ho, wo;
  int cin_g, cout_g, k, kpad, npad;
  int relu, res_f32, out_f32;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__global__ void __launch_bounds__(kConvThreads) conv_kernel(ConvArgs a) {
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const int hw_out = a.ho * a.wo;
  const int m_total = a.n * hw_out;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const bf16* wg = a.wt + static_cast<size_t>(g) * a.kpad * a.npad;
  const bool vec = (a.cin_g % 8) == 0 && (a.cin % 8) == 0;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < a.kpad; k0 += BK) {
    // A: BM output pixels x BK taps-and-channels, gathered from the input.
    const int per = vec ? 8 : 1;
    for (int i = tid; i < BM * BK / per; i += kConvThreads) {
      const int r = i / (BK / per);
      const int kc = (i % (BK / per)) * per;
      const int m = m0 + r;
      const int kk = k0 + kc;
      const bf16* src = nullptr;
      if (m < m_total && kk < a.k) {
        const int tap = kk / a.cin_g;
        const int ci = kk - tap * a.cin_g;
        const int ky = tap / a.ksize;
        const int kx = tap - ky * a.ksize;
        const int img = m / hw_out;
        const int rem = m - img * hw_out;
        const int oy = rem / a.wo;
        const int ox = rem - oy * a.wo;
        const int iy = oy * a.stride - a.pad + ky;
        const int ix = ox * a.stride - a.pad + kx;
        if (iy >= 0 && iy < a.h && ix >= 0 && ix < a.w) {
          src = a.x + ((static_cast<size_t>(img) * a.h + iy) * a.w + ix) *
                          a.cin + g * a.cin_g + ci;
        }
      }
      if (vec) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (src != nullptr) v = *reinterpret_cast<const uint4*>(src);
        *reinterpret_cast<uint4*>(&As[r * LDA + kc]) = v;
      } else {
        As[r * LDA + kc] = src != nullptr ? *src : zero;
      }
    }
    // B: BK x BN packed weights (always in bounds: the packing pads).
    for (int i = tid; i < BK * BN / 8; i += kConvThreads) {
      const int r = i / (BN / 8);
      const int c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * LDB + c]) =
          *reinterpret_cast<const uint4*>(
              wg + static_cast<size_t>(k0 + r) * a.npad + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue; neighbouring threads take neighbouring output addresses.
  const bool cfast = a.os_c == 1;
  for (int i = tid; i < BM * BN; i += kConvThreads) {
    const int r = cfast ? i / BN : i % BM;
    const int c = cfast ? i % BN : i / BM;
    const int m = m0 + r;
    const int co_g = n0 + c;
    if (m >= m_total || co_g >= a.cout_g) continue;
    const int co = g * a.cout_g + co_g;
    float v = __fadd_rn(__fmul_rn(Cs[r * LDC + c], a.scale[co]), a.bias[co]);
    if (a.res != nullptr) {
      const size_t ri = static_cast<size_t>(m) * a.cout + co;
      v = __fadd_rn(v, a.res_f32
                           ? static_cast<const float*>(a.res)[ri]
                           : __bfloat162float(
                                 static_cast<const bf16*>(a.res)[ri]));
    }
    if (a.relu) v = fmaxf(v, 0.0f);
    const int img = m / hw_out;
    const int rem = m - img * hw_out;
    const int oy = rem / a.wo;
    const int ox = rem - oy * a.wo;
    const long long o = img * a.os_n + oy * a.os_y + ox * a.os_x +
                        co * a.os_c;
    if (a.out_f32) {
      static_cast<float*>(a.out)[o] = v;
    } else {
      static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(v);
    }
  }
}

// 3x3 stride-2 max pool with one pixel of padding, NHWC; padded taps are
// skipped (every window holds a real pixel).
__global__ void maxpool_kernel(const bf16* __restrict__ x,
                               bf16* __restrict__ out, int n, int h, int w,
                               int c, int ho, int wo) {
  const size_t total = static_cast<size_t>(n) * ho * wo * c;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % c);
    size_t rest = i / c;
    const int ox = static_cast<int>(rest % wo);
    rest /= wo;
    const int oy = static_cast<int>(rest % ho);
    const int img = static_cast<int>(rest / ho);
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = oy * 2 - 1 + ky;
      if (iy < 0 || iy >= h) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = ox * 2 - 1 + kx;
        if (ix < 0 || ix >= w) continue;
        m = fmaxf(m, __bfloat162float(
                         x[((static_cast<size_t>(img) * h + iy) * w + ix) *
                               c + ch]));
      }
    }
    out[i] = __float2bfloat16_rn(m);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Split attention of one image per block. y: NHWC [n, pixels, 2*width]
// (radix-major channels) -> so: NHWC [n, pixels, width].
__global__ void __launch_bounds__(kAttThreads) attention_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ wd1,
    const float* __restrict__ bd1, const bf16* __restrict__ wd2,
    const float* __restrict__ bd2, bf16* __restrict__ so, int pixels,
    int width, int inter) {
  extern __shared__ float sm[];
  const int c2 = 2 * width;
  const int lanes = blockDim.x / c2;
  float* part = sm;                    // [lanes][c2]
  float* gap = part + lanes * c2;      // [width]
  float* z = gap + width;              // [inter]
  float* att0 = z + inter;             // [width]
  float* att1 = att0 + width;          // [width]
  const bf16* yi = y + static_cast<size_t>(blockIdx.x) * pixels * c2;
  const int t = threadIdx.x;

  if (t < lanes * c2) {
    const int c = t % c2;
    float s = 0.0f;
    for (int p = t / c2; p < pixels; p += lanes) {
      s += __bfloat162float(yi[static_cast<size_t>(p) * c2 + c]);
    }
    part[t] = s;
  }
  __syncthreads();
  if (t < width) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int l = 0; l < lanes; ++l) {
      s0 += part[l * c2 + t];
      s1 += part[l * c2 + width + t];
    }
    gap[t] = s0 / pixels + s1 / pixels;
  }
  __syncthreads();
  if (t < inter) {
    float s = 0.0f;
    for (int i = 0; i < width; ++i) {
      s += round_bf16(gap[i]) * __bfloat162float(wd1[t * width + i]);
    }
    z[t] = fmaxf(s + bd1[t], 0.0f);
  }
  __syncthreads();
  if (t < width) {
    float a0 = 0.0f, a1 = 0.0f;
    for (int j = 0; j < inter; ++j) {
      const float zj = round_bf16(z[j]);
      a0 += zj * __bfloat162float(wd2[t * inter + j]);
      a1 += zj * __bfloat162float(wd2[(width + t) * inter + j]);
    }
    a0 += bd2[t];
    a1 += bd2[width + t];
    const float mx = fmaxf(a0, a1);
    const float e0 = expf(a0 - mx);
    const float e1 = expf(a1 - mx);
    att0[t] = e0 / (e0 + e1);
    att1[t] = 1.0f - att0[t];
  }
  __syncthreads();
  bf16* so_i = so + static_cast<size_t>(blockIdx.x) * pixels * width;
  for (int i = t; i < pixels * width; i += blockDim.x) {
    const int p = i / width;
    const int c = i - p * width;
    const bf16* row = yi + static_cast<size_t>(p) * c2;
    const float v = __bfloat162float(row[c]) * att0[c] +
                    __bfloat162float(row[width + c]) * att1[c];
    so_i[i] = __float2bfloat16_rn(v);
  }
}

struct Dims {
  int n, h1, w1, h2, w2, sw, width, inter;
};

Dims dims_of(int n, int h, int w, int sw, int width) {
  Dims d;
  d.n = n;
  d.h1 = h / 2;
  d.w1 = w / 2;
  d.h2 = h / 4;
  d.w2 = w / 4;
  d.sw = sw;
  d.width = width;
  d.inter = 2 * width / 4 > 32 ? 2 * width / 4 : 32;
  return d;
}

// Scratch layout, each buffer 256-byte aligned: two stem buffers, the
// pooled stem, t, y, so (bfloat16), the block-0 shortcut (float32) and
// two stage-1 outputs (bfloat16).
void scratch_sizes(const Dims& d, size_t bytes[8]) {
  const size_t s1 = static_cast<size_t>(d.n) * d.h1 * d.w1;
  const size_t s2 = static_cast<size_t>(d.n) * d.h2 * d.w2;
  bytes[0] = bytes[1] = s1 * 2 * d.sw * 2;
  bytes[2] = s2 * 2 * d.sw * 2;
  bytes[3] = s2 * d.width * 2;
  bytes[4] = s2 * 2 * d.width * 2;
  bytes[5] = s2 * d.width * 2;
  bytes[6] = s2 * 4 * d.width * 4;
  bytes[7] = s2 * 4 * d.width * 2;  // x1; x2 is the same size
}

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

int run_conv(const bf16* x, int n, int h, int w, int cin,
             const void* const* p, int cout, int groups, int ksize,
             int stride, const void* res, int res_f32, void* out,
             int out_f32, bool nchw, int relu, cudaStream_t s) {
  ConvArgs a;
  a.x = x;
  a.wt = static_cast<const bf16*>(p[0]);
  a.scale = static_cast<const float*>(p[1]);
  a.bias = static_cast<const float*>(p[2]);
  a.res = res;
  a.out = out;
  a.n = n;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cout = cout;
  a.ksize = ksize;
  a.stride = stride;
  a.pad = (ksize - 1) / 2;
  a.ho = (h + 2 * a.pad - ksize) / stride + 1;
  a.wo = (w + 2 * a.pad - ksize) / stride + 1;
  a.cin_g = cin / groups;
  a.cout_g = cout / groups;
  a.k = ksize * ksize * a.cin_g;
  a.kpad = round_up(a.k, BK);
  a.npad = round_up(a.cout_g, BN);
  a.relu = relu;
  a.res_f32 = res_f32;
  a.out_f32 = out_f32;
  const long long hw = static_cast<long long>(a.ho) * a.wo;
  if (nchw) {
    a.os_n = cout * hw;
    a.os_c = hw;
    a.os_y = a.wo;
    a.os_x = 1;
  } else {
    a.os_n = cout * hw;
    a.os_y = static_cast<long long>(a.wo) * cout;
    a.os_x = cout;
    a.os_c = 1;
  }
  const long long m = static_cast<long long>(n) * hw;
  dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), a.npad / BN, groups);
  conv_kernel<<<grid, kConvThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long stem_stage1_scratch_bytes(int n, int h, int w, int sw,
                                               int width) {
  size_t bytes[8];
  scratch_sizes(dims_of(n, h, w, sw, width), bytes);
  size_t total = align256(bytes[7]);  // x2
  for (int i = 0; i < 8; ++i) total += align256(bytes[i]);
  return static_cast<long long>(total);
}

// x: NHWC [n, h, w, 3] bfloat16; ptrs: 9 stem pointers (3 convs x packed
// weight, scale, bias) then 16 per block (in, grouped, wd1, bd1, wd2, bd2,
// out, shortcut; the shortcut's three are null in blocks 1 and 2);
// out: NCHW [n, 4*width, h/4, w/4] bfloat16. Returns the first CUDA error.
extern "C" int stem_stage1_launch(const void* x, const void* const* ptrs,
                                  void* out, void* scratch, int n, int h,
                                  int w, int sw, int width, void* stream) {
  if (2 * width > kAttThreads || width % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d = dims_of(n, h, w, sw, width);
  size_t bytes[8];
  scratch_sizes(d, bytes);
  char* base = static_cast<char*>(scratch);
  void* buf[9];
  for (int i = 0; i < 8; ++i) {
    buf[i] = base;
    base += align256(bytes[i]);
  }
  buf[8] = base;  // x2
  bf16* stem_a = static_cast<bf16*>(buf[0]);
  bf16* stem_b = static_cast<bf16*>(buf[1]);
  bf16* pooled = static_cast<bf16*>(buf[2]);
  bf16* t = static_cast<bf16*>(buf[3]);
  bf16* y = static_cast<bf16*>(buf[4]);
  bf16* so = static_cast<bf16*>(buf[5]);
  float* sc = static_cast<float*>(buf[6]);
  bf16* stage[2] = {static_cast<bf16*>(buf[7]), static_cast<bf16*>(buf[8])};

  int err;
#define STEM_CHECK(call) \
  if ((err = (call)) != 0) return err
  STEM_CHECK(run_conv(static_cast<const bf16*>(x), n, h, w, 3, ptrs, d.sw,
                      1, 3, 2, nullptr, 0, stem_a, 0, false, 1, s));
  STEM_CHECK(run_conv(stem_a, n, d.h1, d.w1, d.sw, ptrs + kPtrsPerConv, d.sw,
                      1, 3, 1, nullptr, 0, stem_b, 0, false, 1, s));
  STEM_CHECK(run_conv(stem_b, n, d.h1, d.w1, d.sw, ptrs + 2 * kPtrsPerConv,
                      2 * d.sw, 1, 3, 1, nullptr, 0, stem_a, 0, false, 1, s));
  {
    const size_t total = static_cast<size_t>(n) * d.h2 * d.w2 * 2 * d.sw;
    const int blocks = static_cast<int>(
        (total + kPoolThreads - 1) / kPoolThreads);
    maxpool_kernel<<<blocks, kPoolThreads, 0, s>>>(
        stem_a, pooled, n, d.h1, d.w1, 2 * d.sw, d.h2, d.w2);
    STEM_CHECK(static_cast<int>(cudaGetLastError()));
  }
  const int pixels = d.h2 * d.w2;
  const int lanes = kAttThreads / (2 * width);
  const int att_smem = static_cast<int>(sizeof(float)) *
                       (lanes * 2 * width + 3 * width + d.inter);
  const bf16* cur = pooled;
  int cin = 2 * d.sw;
  for (int b = 0; b < 3; ++b) {
    const void* const* p = ptrs + 3 * kPtrsPerConv + b * kPtrsPerBlock;
    STEM_CHECK(run_conv(cur, n, d.h2, d.w2, cin, p, width, 1, 1, 1, nullptr,
                        0, t, 0, false, 1, s));
    STEM_CHECK(run_conv(t, n, d.h2, d.w2, width, p + 3, 2 * width, 2, 3, 1,
                        nullptr, 0, y, 0, false, 1, s));
    attention_kernel<<<n, kAttThreads, att_smem, s>>>(
        y, static_cast<const bf16*>(p[6]), static_cast<const float*>(p[7]),
        static_cast<const bf16*>(p[8]), static_cast<const float*>(p[9]), so,
        pixels, width, d.inter);
    STEM_CHECK(static_cast<int>(cudaGetLastError()));
    const void* res = cur;
    int res_f32 = 0;
    if (b == 0) {
      STEM_CHECK(run_conv(cur, n, d.h2, d.w2, cin, p + 13, 4 * width, 1, 1,
                          1, nullptr, 0, sc, 1, false, 0, s));
      res = sc;
      res_f32 = 1;
    }
    void* dst = b == 2 ? out : static_cast<void*>(stage[b]);
    STEM_CHECK(run_conv(so, n, d.h2, d.w2, width, p + 10, 4 * width, 1, 1, 1,
                        res, res_f32, dst, 0, b == 2, 1, s));
    cur = static_cast<const bf16*>(dst);
    cin = 4 * width;
  }
#undef STEM_CHECK
  return 0;
}
