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
//          weighted radix sum, rounded once to bfloat16); 1x1 out; the
//          shortcut (a folded 1x1 in float32 in block 0, else the bfloat16
//          input); relu(out + shortcut), one bfloat16 store.
// Every product is bfloat16 x bfloat16 summed in float32. The plain
// PyTorch version is models/fastreid_fused.py::stem_stage1_plain; the two
// sum in different orders, so they agree to float32 rounding before each
// bfloat16 store.
//
// What bounds it on the card. Counting only the call's input and output,
// operations: 1.34 GFLOP of convolution per 256x128 image against 1.25 MB
// is 1,070 FLOP a byte, above the H100's 295 for bfloat16. But one image's
// stem activations (1 MB) do not fit a block's 227 KB of shared memory, so
// the layers run one after the other through NHWC bfloat16 scratch in
// device memory, and the design is bound by those bytes: 7.9 MB written
// and 9.4 MB read per 256x128 image, 3.8 times the time of the
// operations at the card's peak rates. Inside a 3x3 layer the next limit
// is shared-memory bandwidth: every byte wgmma multiplies crosses it.
//
// Design: 16 kernels a call on the caller's stream. Each layer moves its
// activations once, 16 bytes a thread with eight neighbouring threads on
// one pixel's 128 bytes, and is fused with the neighbours whose data it
// already holds.
//   stem0_kernel     3->sw stride 2 (K = 27, bound by its bytes): a band of
//                    input rows copied to shared memory with 16-byte loads,
//                    the weights in shared memory as float32, plain FMAs on
//                    4 pixels x 8 channels a thread (a bfloat16 product is
//                    exact in float32, so an FMA rounds as a multiply and
//                    an add do).
//   halo_conv_kernel the 3x3 convolutions (stem 1 and 2, the grouped conv):
//                    implicit GEMM on wgmma.mma_async m64nNk16, N the
//                    group's own output width (32 or 64), a tile of 128
//                    consecutive pixels of one image for two warpgroups.
//                    Persistent blocks keep the group's weights in shared
//                    memory; per tile the contiguous span of pixels that
//                    holds every tap (the halo) arrives once by cp.async
//                    with zero-fill, double-buffered under the tile before;
//                    wgmma's A operand comes from registers, loaded by
//                    ldmatrix straight from the halo, so no im2col copy
//                    crosses shared memory. The K loop is bound by
//                    instruction issue: every k16 slice's tap and halo
//                    offset come from a table made once a block, a thread's
//                    pixels and their nine taps' validity bits once a tile,
//                    and warps off the image's border skip the masking.
//                    The grouped conv's epilogue also sums its
//                    bfloat16-rounded outputs per channel into per-tile
//                    partials (shuffles and a fixed order, no atomics) for
//                    the attention.
//   ring_conv_kernel the first 1x1 of a block (A is the [pixels, channels]
//                    matrix itself): K in steps of 64 through a ring of
//                    three shared-memory stages in the 128-byte-swizzled
//                    layout wgmma reads, filled by cp.async; the loads of
//                    steps i+1 and i+2 are in flight while step i
//                    multiplies.
//   attention_kernel one block per image: the partials in a fixed order,
//                    the two dense layers and the softmax -> [N, 2 width]
//                    float32 weights.
//   out_conv_kernel  the block's last 1x1 (width -> 4 width): builds its A
//                    tile as bf16(y0*att0 + y1*att1) on the way into shared
//                    memory, so the attention's output is never stored; in
//                    block 0 it also multiplies the pooled stem by the
//                    shortcut's weights into a second accumulator and adds
//                    (acc_o*s_o + b_o) + (acc_s*s_s + b_s) in float32, so no
//                    float32 shortcut buffer exists; in blocks 1 and 2 the
//                    residual comes through shared memory, 64 channels
//                    ahead. The 256 output channels of the tile are taken
//                    64 at a time (m64n64k16), in block 0 32 at a time
//                    (m64n32k16): its two accumulators then take the
//                    registers of one, and two blocks share an SM in every
//                    block of the stage. The last block stores NCHW through
//                    a transposing tile.
//   Both epilogues go from the accumulator registers through a swizzled
//   bfloat16 tile in shared memory (stmatrix, four 8 x 8 matrices a store)
//   to 16-byte stores.
//   maxpool_kernel   8 channels a thread, 16-byte loads and stores.
//   conv_kernel      the general path for other widths (a group with fewer
//                    than 32 input channels, output widths other than 32
//                    and 64): bfloat16 WMMA on a 64x64 tile, with the same
//                    two fusions (attention-weighted A, second product).
// Which path a convolution takes, its grid and its shared memory are
// decided by models/fastreid_fused.py::conv_plan from the shapes alone and
// passed in; the weights come packed for that path (pack_conv).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc*scale + bias as two rounded operations (never contracted).
__device__ __forceinline__ float scale_bias(float acc, float s, float b) {
  return __fadd_rn(__fmul_rn(acc, s), b);
}

// ---------------------------------------------------------------------
// Shared-memory, cp.async and wgmma primitives.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false copies nothing and fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Makes shared memory written by this thread (st.shared, cp.async that has
// landed) visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 8 bfloat16 matrices from shared memory, one register each: lane
// l gives the address of row l % 8 of matrix l / 8 (16 bytes a row) and
// receives elements 2(l%4), 2(l%4) + 1 of row l / 4 of every matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The inverse: four 8 x 8 bfloat16 matrices from registers to shared
// memory, lane l giving the address of row l % 8 of matrix l / 8. With
// `.trans` element (l / 4, 2(l%4) + e) of a matrix goes to position l / 4
// of its row 2(l%4) + e: the matrix is stored transposed.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// relu(lo), relu(hi) rounded to a bfloat16 pair.
__device__ __forceinline__ uint32_t relu_pack(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(fmaxf(lo, 0.0f), fmaxf(hi, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Scale and bias of a pair of neighbouring channels as one 16-byte shared
// load: {s[2p], s[2p + 1], b[2p], b[2p + 1]}.
__device__ __forceinline__ float4 scale_bias_pair(const float* scale,
                                                  const float* bias, int p) {
  return make_float4(scale[2 * p], scale[2 * p + 1], bias[2 * p],
                     bias[2 * p + 1]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending committed groups are still multiplying.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int kRegs>
__device__ __forceinline__ void fence_acc(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A tile of rows of 64 bfloat16 (128 bytes), 1024-byte aligned: the
// 16-byte chunk c of row r lives at chunk c ^ (r & 7) (the 128-byte
// swizzle). Both wgmma operands use it: A rows are pixels, B rows output
// channels, K contiguous in a row.
__device__ __forceinline__ int swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The matrix descriptor of such a tile: start address, leading offset 1
// (unused for swizzled K-major), stride 1024 bytes between 8-row groups,
// all in 16-byte units, 128-byte swizzle. 16 further K is 32 bytes: + 2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, 32 float32 a thread.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, 16 float32 a thread.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss_step(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_n64(d, da, db, accumulate);
  } else {
    wgmma_n32(d, da, db, accumulate);
  }
}

// D (+)= A B^T with A[64 x 16] from registers (D 64 x 32 or 64 x 64):
// a[0..3] of lane l in warp q hold rows 16q + l/4 and + 8 (a[0], a[2]: the
// first; a[1], a[3]: the second) at K 2(l%4), 2(l%4) + 1 (a[0], a[1]) and 8
// further (a[2], a[3]).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_step(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db, accumulate);
  } else {
    wgmma_rs_n32(d, a, db, accumulate);
  }
}

constexpr int kFastThreads = 256;  // two warpgroups, 64 pixels each
constexpr int kTileM = 128;        // pixels of a fast-path tile
constexpr int kStepK = 64;         // K of a shared-memory stage
constexpr int kStages = 3;
constexpr int kATileBytes = kTileM * 128;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ---------------------------------------------------------------------
// The stem's first conv: 3 -> sw, 3x3, stride 2, pad 1. A block takes
// kStem0Rows output rows of one image; a thread computes 8 channels of 4
// neighbouring pixels. Shared memory: weights [27][sw] float32, scale and
// bias, then 2 kStem0Rows + 1 input rows of 3w bfloat16 behind 8 zeros (the
// left pad).

constexpr int kStem0Rows = 16;
constexpr int kStem0Threads = 256;

__global__ void __launch_bounds__(kStem0Threads) stem0_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wt, int w_ld,
    const float* __restrict__ scale, const float* __restrict__ bias,
    bf16* __restrict__ out, int h, int w, int sw) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);
  float* ss = ws + 27 * sw;
  float* bs = ss + sw;
  bf16* rows = reinterpret_cast<bf16*>(bs + sw);
  const int ld = 3 * w + 8;
  const int ho = h / 2, wo = w / 2;
  const int img = blockIdx.y;
  const int oy0 = blockIdx.x * kStem0Rows;
  const int tid = threadIdx.x;

  for (int i = tid; i < 27 * sw; i += kStem0Threads) {
    const int k = i / sw;
    ws[i] = __bfloat162float(wt[k * w_ld + (i - k * sw)]);
  }
  for (int i = tid; i < sw; i += kStem0Threads) {
    ss[i] = scale[i];
    bs[i] = bias[i];
  }
  const int n_rows = 2 * kStem0Rows + 1;
  const int chunks = 3 * w / 8;  // 16-byte chunks of an input row
  for (int i = tid; i < n_rows * (chunks + 1); i += kStem0Threads) {
    const int r = i / (chunks + 1);
    const int c = i - r * (chunks + 1);  // chunk 0 is the left pad
    const int iy = 2 * oy0 - 1 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c > 0 && iy >= 0 && iy < h) {
      v = *reinterpret_cast<const uint4*>(
          x + (static_cast<size_t>(img) * h + iy) * w * 3 + (c - 1) * 8);
    }
    *reinterpret_cast<uint4*>(rows + r * ld + c * 8) = v;
  }
  __syncthreads();

  // A thread: 8 channels of 4 neighbouring pixels, so a loaded input
  // value serves up to two pixels and a loaded weight four.
  const int groups = sw / 8;
  const int quads = wo / 4;
  for (int i = tid; i < kStem0Rows * quads * groups; i += kStem0Threads) {
    const int quad = i / groups;
    const int c0 = (i - quad * groups) * 8;
    const int oyl = quad / quads;
    const int ox0 = (quad - oyl * quads) * 4;
    const int oy = oy0 + oyl;
    if (oy >= ho) continue;
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      // Element 8 of a row is (ix = 0, channel 0); ix starts at 2 ox0 - 1
      // and pixel j's taps at 2 j further columns.
      const bf16* px = rows + (2 * oyl + ky) * ld + 8 + (2 * ox0 - 1) * 3;
      float xv[27];
#pragma unroll
      for (int t = 0; t < 27; ++t) xv[t] = __bfloat162float(px[t]);
#pragma unroll
      for (int t = 0; t < 9; ++t) {  // (kx, input channel)
        const float4* wp =
            reinterpret_cast<const float4*>(ws + (ky * 9 + t) * sw + c0);
        const float4 w0 = wp[0], w1 = wp[1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = xv[6 * j + t];
          acc[j][0] = __fmaf_rn(v, w0.x, acc[j][0]);
          acc[j][1] = __fmaf_rn(v, w0.y, acc[j][1]);
          acc[j][2] = __fmaf_rn(v, w0.z, acc[j][2]);
          acc[j][3] = __fmaf_rn(v, w0.w, acc[j][3]);
          acc[j][4] = __fmaf_rn(v, w1.x, acc[j][4]);
          acc[j][5] = __fmaf_rn(v, w1.y, acc[j][5]);
          acc[j][6] = __fmaf_rn(v, w1.z, acc[j][6]);
          acc[j][7] = __fmaf_rn(v, w1.w, acc[j][7]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf162 o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 2 * e;
        o[e] = __floats2bfloat162_rn(
            fmaxf(scale_bias(acc[j][2 * e], ss[c], bs[c]), 0.0f),
            fmaxf(scale_bias(acc[j][2 * e + 1], ss[c + 1], bs[c + 1]), 0.0f));
      }
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(img) * ho + oy) * wo + ox0 + j) * sw +
          c0) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// ---------------------------------------------------------------------
// The wgmma convolutions: stride 1, a group of cin_g = 2^lg_cin_g >= 32
// input channels and N output channels, 128 pixels of one image a tile.
// Weights packed [group][K step][N][64] (pack_conv), zeros past K.

struct FastArgs {
  const bf16* x;       // NHWC [n, h, w, cin]
  const bf16* wt;
  const float* scale;  // [cout]
  const float* bias;
  bf16* out;           // NHWC [n, h, w, cout]
  float* partial;      // [n, tiles, cout] channel sums of a tile, or null
  int h, w, cin, cout, cin_g, lg_cin_g, tiles, total, ksteps, pitch;
};

// Where the epilogue tile keeps chunk `chunk` (8 channels) of row `row`:
// rows of 2N bytes, chunks permuted so that the eight rows a warp writes
// at once fall into different banks.
template <int N>
__device__ __forceinline__ int stage_off(int row, int chunk) {
  if constexpr (N == 64) {
    return swz128(row, chunk);
  } else {
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
  }
}

// The accumulator of m64nNk16: register 4j + 2h + e of lane l in warp q of
// the warpgroup is row 16q + l/4 + 8h, column 8j + 2(l%4) + e: as bfloat16
// pairs, the 8 x 8 matrices (h, j) in the fragment layout of ldmatrix and
// stmatrix. An epilogue moves four of them at once, (h, j) = (0, 2jp),
// (1, 2jp), (0, 2jp + 1), (1, 2jp + 1): lane l addresses row
// 16q + 8(l/8 % 2) + l % 8 (frag_row) at column chunk 2jp + l / 16.
__device__ __forceinline__ int frag_row(int warp, int lane) {
  return warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
}

// The epilogue of a 128 x N tile: acc*scale + bias, ReLU and the bfloat16
// rounding from the accumulator registers into the tile `stg` (stmatrix),
// then 16-byte stores of its first `rows_valid` rows to `out` (rows `ld`
// elements apart), neighbouring threads on neighbouring chunks of a row.
// `s_sb`: scale_bias_pair of the tile's N channels. SUMS: the per-channel
// sums of the rounded values over those rows go to `partial` (shuffles
// over a warp's 16 rows, then the eight warps in order: the same bits on
// every run). Ends with the tile free again.
template <int N, bool SUMS>
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[N / 2], uint8_t* stg, const float4* s_sb,
    float* s_part, bf16* out, int ld, int rows_valid, float* partial) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2);
  const int st_row = frag_row(warp, lane);
#pragma unroll
  for (int jp = 0; jp < N / 16; ++jp) {
    uint32_t v[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * jp + jj;
      const float4 sb = s_sb[4 * j + (lane & 3)];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        v[2 * jj + hh] =
            relu_pack(scale_bias(acc[4 * j + 2 * hh], sb.x, sb.z),
                      scale_bias(acc[4 * j + 2 * hh + 1], sb.y, sb.w));
        if (SUMS && r0 + 8 * hh < rows_valid) {
          const bf162 r = *reinterpret_cast<const bf162*>(&v[2 * jj + hh]);
          sum0 += __low2float(r);
          sum1 += __high2float(r);
        }
      }
      if (SUMS) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, m);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, m);
        }
        if (lane < 4) {
          const int col = 8 * j + lane * 2;
          s_part[warp * N + col] = sum0;
          s_part[warp * N + col + 1] = sum1;
        }
      }
    }
    stmatrix_x4(smem_u32(stg + stage_off<N>(st_row, 2 * jp + (lane >> 4))),
                v);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N / 16; ++i) {
    const int idx = i * kFastThreads + tid;
    const int row = idx / (N / 8);
    const int chunk = idx % (N / 8);
    if (row < rows_valid) {
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * ld +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(stg + stage_off<N>(row, chunk));
    }
  }
  if (SUMS && tid < N) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += s_part[q * N + tid];
    partial[tid] = s;
  }
  __syncthreads();
}

// The 1x1 convolutions of the ring path: A is the [pixels, channels]
// matrix itself. K runs in steps of 64 through a ring of kStages stages
// filled by cp.async; the loads of steps i+1 and i+2 are in flight while
// step i multiplies. 64 output channels a group. Grid: (images x tiles,
// groups).
__global__ void __launch_bounds__(kFastThreads) ring_conv_kernel(FastArgs a) {
  constexpr int N = 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float4 s_sb[N / 2];
  constexpr int kStageBytes = kATileBytes + N * 128;
  uint8_t* smem = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int img = blockIdx.x / a.tiles;
  const int tile = blockIdx.x - img * a.tiles;
  const int g = blockIdx.y;
  const int hw = a.h * a.w;
  if (tid < N / 2) {
    s_sb[tid] = scale_bias_pair(a.scale + g * N, a.bias + g * N, tid);
  }

  // Chunk tid % 8 of rows tid / 8 + 32 i of every A stage is this thread's:
  // eight neighbours load one pixel's 128 bytes.
  const int p0 = tile * kTileM;
  const int rows_valid = hw - p0;
  const int row = tid >> 3;
  const int chunk = tid & 7;
  const bf16* xp = a.x + (static_cast<size_t>(img) * hw + p0) * a.cin +
                   g * a.cin_g + chunk * 8;
  const bf16* wsrc = a.wt + static_cast<size_t>(g) * a.ksteps * N * kStepK;

  auto load_stage = [&](int ks, int slot) {
    uint8_t* sa = smem + slot * kStageBytes;
    uint8_t* sb = sa + kATileBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 32 * i;
      const bool ok = r < rows_valid;
      cp_async16(smem_u32(sa + swz128(r, chunk)),
                 xp + static_cast<size_t>(ok ? r : 0) * a.cin + ks * kStepK,
                 ok);
    }
    const bf16* wk = wsrc + static_cast<size_t>(ks) * N * kStepK;
#pragma unroll
    for (int i = tid; i < N * 8; i += kFastThreads) {
      cp_async16(smem_u32(sb + swz128(i >> 3, i & 7)), wk + i * 8, true);
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < a.ksteps) load_stage(s, s);
    cp_async_commit();
  }
  int slot = 0;               // of step ks
  int fill = kStages - 1;     // of step ks + kStages - 1
  for (int ks = 0; ks < a.ksteps; ++ks) {
    cp_async_wait<kStages - 2>();  // step ks has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread; step ks - 1 is multiplied
    if (ks + kStages - 1 < a.ksteps) load_stage(ks + kStages - 1, fill);
    cp_async_commit();
    const uint32_t sa = smem_u32(smem + slot * kStageBytes);
    const uint64_t da = smem_desc(sa + wg * 64 * 128);
    const uint64_t db = smem_desc(sa + kATileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStepK / 16; ++kk) {
      wgmma_n64(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    slot = slot + 1 == kStages ? 0 : slot + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the stages

  tile_epilogue<N, false>(
      acc, smem, s_sb, nullptr,
      a.out + (static_cast<size_t>(img) * hw + p0) * a.cout + g * N, a.cout,
      rows_valid, nullptr);
}

// The 3x3 SAME convolutions. A tile's 128 pixels are consecutive in the
// image, so every tap of every pixel lies in one contiguous span of
// 130 + 2w pixels: the halo. A persistent block (grid: blocks x groups)
// keeps its group's whole weights in shared memory and, per tile, gets the
// halo once with cp.async (zeros outside the image) while the tile before
// it multiplies (two halo buffers). wgmma's A operand comes from
// registers: a thread loads its fragment of a K step's 64 (two taps of 32
// channels, one of 64) straight from the halo, so no A tile is copied
// through shared memory, and the next step's fragment is loaded while this
// one multiplies. The K loop is bound by instruction issue, so what it
// needs is worked out before it: per block a table of every k16 slice's
// tap and halo offset, per tile a thread's two pixels' nine taps' validity
// bits and whether its warp touches the image's border at all (most do
// not, and skip the masking). Halo pixels are `pitch` bytes apart (16 more
// than their channels), which spreads eight neighbours over all banks.
// Shared memory: weights [K step][N][64] swizzled, the epilogue's tile, two
// halos.
constexpr int kMaxSlices = 128;  // k16 slices of K the tap table holds

template <int N, bool SUMS>
__global__ void __launch_bounds__(kFastThreads, 2)
    halo_conv_kernel(FastArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float4 s_sb[N / 2];
  __shared__ float s_part[SUMS ? 8 * N : 1];
  __shared__ uint32_t s_tap[kMaxSlices];
  uint8_t* sb = align1024(smem_raw);          // [K step][N][64]
  uint8_t* stg = sb + a.ksteps * N * 128;     // 128 x N output tile
  uint8_t* halos = stg + kTileM * N * 2;
  const int halo_px = kTileM + 2 * a.w + 2;
  const int halo_bytes = halo_px * a.pitch;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = blockIdx.y;
  const int hw = a.h * a.w;
  if (tid < N / 2) {
    s_sb[tid] = scale_bias_pair(a.scale + g * N, a.bias + g * N, tid);
  }
  {
    const bf16* wsrc = a.wt + static_cast<size_t>(g) * a.ksteps * N * kStepK;
    for (int i = tid; i < a.ksteps * N * 8; i += kFastThreads) {
      cp_async16(smem_u32(sb + swz128(i >> 3, i & 7)), wsrc + i * 8, true);
    }
  }
  // Slice i of K (16 channels of one tap): the tap in the top byte, below
  // it the byte offset of its pixel and channels from the halo's place of
  // the output pixel's tap 0. K past the ninth tap is zero padding: it
  // reads tap 8's place (inside the halo) and is masked like a tap outside
  // the image (its validity bit is never set).
  if (tid < 4 * a.ksteps) {
    const int k = tid * 16;
    const int tap = k >> a.lg_cin_g;
    const int at = tap < 9 ? tap : 8;
    const int ky = (at * 11) >> 5;  // at / 3
    s_tap[tid] = (tap << 24) | ((ky * a.w + at - 3 * ky) * a.pitch +
                                (k & (a.cin_g - 1)) * 2);
  }
  const int lg_cpp = a.lg_cin_g - 3;  // 16-byte chunks of a halo pixel

  // The halo of tile t: pixels p0 - w - 1 ... p0 + 128 + w of its image.
  auto load_halo = [&](int t, int buf) {
    const int img = t / a.tiles;
    const int p0 = (t - img * a.tiles) * kTileM;
    const bf16* ximg = a.x + static_cast<size_t>(img) * hw * a.cin +
                       g * a.cin_g;
    uint8_t* halo = halos + buf * halo_bytes;
    for (int i = tid; i < (halo_px << lg_cpp); i += kFastThreads) {
      const int hq = i >> lg_cpp;
      const int c = i & ((1 << lg_cpp) - 1);
      const int q = p0 - a.w - 1 + hq;
      const bool ok = q >= 0 && q < hw;
      cp_async16(smem_u32(halo + hq * a.pitch + c * 16),
                 ximg + static_cast<size_t>(ok ? q : 0) * a.cin + c * 8, ok);
    }
    cp_async_commit();
  };
  if (static_cast<int>(blockIdx.x) < a.total) load_halo(blockIdx.x, 0);

  // This thread's A fragments hold rows r0 and r0 + 8 of the tile; for
  // ldmatrix it points at row lane % 16 of its warp's 16, K half lane / 16.
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int lm_off = ((tid >> 5) * 16 + (lane & 15)) * a.pitch +
                     (lane >> 4) * 16;
  int buf = 0;
  for (int t = blockIdx.x; t < a.total; t += gridDim.x, buf ^= 1) {
    const int img = t / a.tiles;
    const int tile = t - img * a.tiles;
    const int p0 = tile * kTileM;
    // Bit 3 ky + kx: that tap of the pixel reads inside the image.
    unsigned taps_ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = p0 + r0 + 8 * hh;
      const int oy = p / a.w;
      const int ox = p - oy * a.w;
      const unsigned rows =
          (oy > 0 ? 0x007u : 0u) | 0x038u | (oy + 1 < a.h ? 0x1C0u : 0u);
      const unsigned cols =
          (ox > 0 ? 0x049u : 0u) | 0x092u | (ox + 1 < a.w ? 0x124u : 0u);
      taps_ok[hh] = p < hw ? rows & cols : 0u;
    }
    const bool edge =
        __any_sync(0xffffffffu, (taps_ok[0] & taps_ok[1]) != 0x1FFu);
    cp_async_wait<0>();
    __syncthreads();  // this tile's halo has landed; the other one is free
    if (t + static_cast<int>(gridDim.x) < a.total) {
      load_halo(t + gridDim.x, buf ^ 1);
    }
    const uint32_t hrow = smem_u32(halos + buf * halo_bytes) + lm_off;

    // The A fragments of K step ks: four k16 slices, each in one tap.
    auto load_frags = [&](int ks, uint32_t (&f)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t slice = s_tap[ks * 4 + kk];
        const unsigned tap = slice >> 24;
        ldmatrix_x4(f[kk], hrow + (slice & 0xFFFFFFu));
        if (edge || tap > 8) {
          if (!((taps_ok[0] >> tap) & 1u)) f[kk][0] = f[kk][2] = 0u;
          if (!((taps_ok[1] >> tap) & 1u)) f[kk][1] = f[kk][3] = 0u;
        }
      }
    };

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    auto mma_step = [&](int ks, const uint32_t (&f)[4][4]) {
      const uint64_t db = smem_desc(smem_u32(sb) + ks * N * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_step<N>(acc, f[kk], db + 2 * kk, (ks | kk) != 0);
      }
      wgmma_commit();
    };
    // Two sets of fragments in turn: one multiplies (its registers are
    // read until the wait) while the next step's is loaded.
    uint32_t fa[4][4], fb[4][4];
    load_frags(0, fa);
    for (int ks = 0; ks < a.ksteps; ks += 2) {
      mma_step(ks, fa);
      if (ks + 1 < a.ksteps) load_frags(ks + 1, fb);
      wgmma_wait<0>();
      if (ks + 1 < a.ksteps) {
        mma_step(ks + 1, fb);
        if (ks + 2 < a.ksteps) load_frags(ks + 2, fa);
        wgmma_wait<0>();
      }
    }
    fence_acc(acc);

    float* partial = nullptr;
    if (SUMS) {
      partial = a.partial + static_cast<size_t>(t) * a.cout + g * N;
    }
    tile_epilogue<N, SUMS>(
        acc, stg, s_sb, s_part,
        a.out + (static_cast<size_t>(img) * hw + p0) * a.cout + g * N, a.cout,
        hw - p0, partial);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// A block's last 1x1 (64 -> 256) with its neighbours fused in. y: NHWC
// [n, hw, 128] (radix-major), att: [n, 128] float32. The A tile is
// bf16(y0*att0 + y1*att1). HAS_SC (block 0): a second product of the
// block's input xs [n, hw, 64] with the shortcut's weights, summed as
// (acc_o*s_o + b_o) + (acc_s*s_s + b_s); otherwise the residual `res`
// [n, hw, 256] bfloat16 is added. Output NHWC, or NCHW when `nchw` (never
// with HAS_SC: block 0 is not the last). The tile's 256 output channels are
// taken NC at a time: 64, or 32 with HAS_SC, whose two accumulators then
// take the registers of one and whose output tile is half as large, so two
// blocks share an SM either way. Grid: images x tiles of 128 pixels.
// Weights packed [256][64].

constexpr int kOutW = 64;      // stage-1 width this kernel is built for
constexpr int kOutC = 4 * kOutW;
constexpr int kOutBBytes = kOutC * 128;

struct OutArgs {
  const bf16* y;
  const float* att;
  const bf16* wo;
  const float* so;
  const float* bo;
  const bf16* xs;
  const bf16* ws;
  const float* ss;
  const float* bs;
  const bf16* res;
  bf16* out;
  int hw, tiles, nchw;
};

// The transposing tile of the NCHW store: [64 channels][128 pixels], the
// 16-byte chunk (8 pixels) q of channel c at chunk q ^ (c & 7).
__device__ __forceinline__ int nchw_off(int ch, int px) {
  return ch * 256 + (((px >> 3) ^ (ch & 7)) << 4) + (px & 7) * 2;
}

template <bool HAS_SC>
__global__ void __launch_bounds__(kFastThreads, 2)
    out_conv_kernel(OutArgs a) {
  constexpr int NC = HAS_SC ? 32 : 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float4 s_o[kOutC / 2];               // scale_bias_pair
  __shared__ float4 s_s[HAS_SC ? kOutC / 2 : 1];  // the shortcut's
  uint8_t* smem = align1024(smem_raw);
  uint8_t* a_so = smem;                      // 128 x 64
  uint8_t* b_o = a_so + kATileBytes;         // 256 x 64
  uint8_t* stg = b_o + kOutBBytes;           // 128 x NC output chunk
  uint8_t* a_sc = stg + kTileM * NC * 2;     // HAS_SC: 128 x 64
  uint8_t* b_s = a_sc + kATileBytes;         // HAS_SC: 256 x 64
  uint8_t* rbuf = a_sc;                      // else: 128 x 64 of the residual

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;
  const int img = blockIdx.x / a.tiles;
  const int tile = blockIdx.x - img * a.tiles;
  const int hw = a.hw;
  if (tid < kOutC / 2) {
    s_o[tid] = scale_bias_pair(a.so, a.bo, tid);
    if (HAS_SC) s_s[tid] = scale_bias_pair(a.ss, a.bs, tid);
  }

  // Chunk tid % 8 (8 channels) of rows tid / 8 + 32 i is this thread's in
  // every 128 x 64 tile it loads or stores: eight neighbours move one
  // pixel's 128 bytes.
  const int p0 = tile * kTileM;
  const int rows_valid = hw - p0;
  const int row = tid >> 3;
  const int chunk = tid & 7;
  const size_t pix0 = static_cast<size_t>(img) * hw + p0;

#pragma unroll 2
  for (int i = tid; i < kOutC * 8; i += kFastThreads) {
    cp_async16(smem_u32(b_o + swz128(i >> 3, i & 7)), a.wo + i * 8, true);
  }
  if (HAS_SC) {
#pragma unroll 2
    for (int i = tid; i < kOutC * 8; i += kFastThreads) {
      cp_async16(smem_u32(b_s + swz128(i >> 3, i & 7)), a.ws + i * 8, true);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 32 * i;
      const bool ok = r < rows_valid;
      cp_async16(smem_u32(a_sc + swz128(r, chunk)),
                 a.xs + (pix0 + (ok ? r : 0)) * kOutW + chunk * 8, ok);
    }
  }
  // 64 channels of the residual, one chunk loop ahead of their use.
  auto load_res = [&](int nc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 32 * i;
      const bool ok = r < rows_valid;
      cp_async16(smem_u32(rbuf + swz128(r, chunk)),
                 a.res + (pix0 + (ok ? r : 0)) * kOutC + nc * NC + chunk * 8,
                 ok);
    }
  };
  if (!HAS_SC) load_res(0);
  cp_async_commit();

  // The attention-weighted radix sum: this thread's 8 channels of 4 rows.
  {
    const float* att = a.att + static_cast<size_t>(img) * 2 * kOutW;
    float a0[8], a1[8];
    *reinterpret_cast<float4*>(a0) =
        *reinterpret_cast<const float4*>(att + chunk * 8);
    *reinterpret_cast<float4*>(a0 + 4) =
        *reinterpret_cast<const float4*>(att + chunk * 8 + 4);
    *reinterpret_cast<float4*>(a1) =
        *reinterpret_cast<const float4*>(att + kOutW + chunk * 8);
    *reinterpret_cast<float4*>(a1 + 4) =
        *reinterpret_cast<const float4*>(att + kOutW + chunk * 8 + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 32 * i;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        const bf16* yp = a.y + (pix0 + r) * 2 * kOutW + chunk * 8;
        const uint4 y0 = *reinterpret_cast<const uint4*>(yp);
        const uint4 y1 = *reinterpret_cast<const uint4*>(yp + kOutW);
        const bf162* y0p = reinterpret_cast<const bf162*>(&y0);
        const bf162* y1p = reinterpret_cast<const bf162*>(&y1);
        bf162 o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = __fadd_rn(
              __fmul_rn(__low2float(y0p[e]), a0[2 * e]),
              __fmul_rn(__low2float(y1p[e]), a1[2 * e]));
          const float hi = __fadd_rn(
              __fmul_rn(__high2float(y0p[e]), a0[2 * e + 1]),
              __fmul_rn(__high2float(y1p[e]), a1[2 * e + 1]));
          o[e] = __floats2bfloat162_rn(lo, hi);
        }
        packed = *reinterpret_cast<const uint4*>(o);
      }
      *reinterpret_cast<uint4*>(a_so + swz128(r, chunk)) = packed;
    }
  }
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  const uint64_t da_o = smem_desc(smem_u32(a_so) + wg * 64 * 128);
  const uint64_t da_s = smem_desc(smem_u32(a_sc) + wg * 64 * 128);
  const int st_row = frag_row(warp, lane);
  const bool nchw = !HAS_SC && a.nchw;

#pragma unroll 1
  for (int nc = 0; nc < kOutC / NC; ++nc) {
    float acc_o[NC / 2];
    float acc_s[HAS_SC ? NC / 2 : 1];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc_o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (HAS_SC ? NC / 2 : 1); ++i) acc_s[i] = 0.0f;
    const uint64_t db_o = smem_desc(smem_u32(b_o) + nc * NC * 128);
    const uint64_t db_s = smem_desc(smem_u32(b_s) + nc * NC * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kOutW / 16; ++kk) {
      wgmma_ss_step<NC>(acc_o, da_o + 2 * kk, db_o + 2 * kk, kk != 0);
    }
    if constexpr (HAS_SC) {
#pragma unroll
      for (int kk = 0; kk < kOutW / 16; ++kk) {
        wgmma_ss_step<NC>(acc_s, da_s + 2 * kk, db_s + 2 * kk, kk != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_o);
    if constexpr (HAS_SC) {
      fence_acc(acc_s);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // the residual's 64 channels are in rbuf
    }

    // Four 8 x 8 matrices of the chunk a step (frag_row); the residual's
    // come from rbuf in the same fragment layout.
#pragma unroll
    for (int jp = 0; jp < NC / 16; ++jp) {
      const int chunk2 = 2 * jp + (lane >> 4);
      uint32_t res[4];
      if constexpr (!HAS_SC) {
        ldmatrix_x4(res, smem_u32(rbuf + swz128(st_row, chunk2)));
      }
      uint32_t v[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * jp + jj;
        const int pair = nc * (NC / 2) + 4 * j + (lane & 3);
        const float4 sb = s_o[pair];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v0 = scale_bias(acc_o[4 * j + 2 * hh], sb.x, sb.z);
          float v1 = scale_bias(acc_o[4 * j + 2 * hh + 1], sb.y, sb.w);
          if constexpr (HAS_SC) {
            const float4 sc = s_s[pair];
            v0 = __fadd_rn(v0, scale_bias(acc_s[4 * j + 2 * hh], sc.x, sc.z));
            v1 = __fadd_rn(
                v1, scale_bias(acc_s[4 * j + 2 * hh + 1], sc.y, sc.w));
          } else {
            const bf162 r =
                *reinterpret_cast<const bf162*>(&res[2 * jj + hh]);
            v0 = __fadd_rn(v0, __low2float(r));
            v1 = __fadd_rn(v1, __high2float(r));
          }
          v[2 * jj + hh] = relu_pack(v0, v1);
        }
      }
      if (nchw) {
        // Transposed: a matrix's row is a channel, its 16 bytes 8 pixels.
        stmatrix_x4_trans(
            smem_u32(stg + nchw_off(8 * chunk2 + (lane & 7),
                                    warp * 16 + ((lane >> 3) & 1) * 8)),
            v);
      } else {
        stmatrix_x4(smem_u32(stg + stage_off<NC>(st_row, chunk2)), v);
      }
    }
    __syncthreads();
    if (!HAS_SC && nc + 1 < kOutC / NC) {
      load_res(nc + 1);
      cp_async_commit();
    }
    if (!nchw) {
      // Chunk idx % (NC / 8) of row idx / (NC / 8): a row's chunks on
      // neighbouring threads.
#pragma unroll
      for (int i = 0; i < NC / 16; ++i) {
        const int idx = i * kFastThreads + tid;
        const int r = idx / (NC / 8);
        const int c = idx % (NC / 8);
        if (r < rows_valid) {
          *reinterpret_cast<uint4*>(a.out + (pix0 + r) * kOutC + nc * NC +
                                    c * 8) =
              *reinterpret_cast<const uint4*>(stg + stage_off<NC>(r, c));
        }
      }
    } else {
      // Thread: 8 pixels (one chunk) of channels tid / 16 + 16 i.
      const int px = (tid & 15) * 8;
      const int pp = tile * kTileM + px;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = (tid >> 4) + 16 * i;
        bf16* dst = a.out +
                    (static_cast<size_t>(img) * kOutC + nc * NC + cl) * hw +
                    pp;
        const uint8_t* src = stg + nchw_off(cl, px);
        if ((hw & 7) == 0) {
          if (pp < hw) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          }
        } else {
          for (int e = 0; e < 8; ++e) {
            if (pp + e < hw) dst[e] = reinterpret_cast<const bf16*>(src)[e];
          }
        }
      }
    }
    __syncthreads();  // the tile is free for the next 64 channels
  }
}

// ---------------------------------------------------------------------
// 3x3 stride-2 max pool with one pixel of padding, NHWC, VEC channels a
// thread (8: 16-byte loads and stores); padded taps are skipped (every
// window holds a real pixel).

constexpr int kPoolThreads = 256;

template <int VEC>
__global__ void __launch_bounds__(kPoolThreads) maxpool_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ out, int n, int h, int w,
    int c, int ho, int wo) {
  const int cv = c / VEC;
  const size_t total = static_cast<size_t>(n) * ho * wo * cv;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % cv) * VEC;
    size_t rest = i / cv;
    const int ox = static_cast<int>(rest % wo);
    rest /= wo;
    const int oy = static_cast<int>(rest % ho);
    const int img = static_cast<int>(rest / ho);
    float m[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = oy * 2 - 1 + ky;
      if (iy < 0 || iy >= h) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = ox * 2 - 1 + kx;
        if (ix < 0 || ix >= w) continue;
        const bf16* src =
            x + ((static_cast<size_t>(img) * h + iy) * w + ix) * c + ch;
        if constexpr (VEC == 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          const bf162* vp = reinterpret_cast<const bf162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            m[2 * e] = fmaxf(m[2 * e], __low2float(vp[e]));
            m[2 * e + 1] = fmaxf(m[2 * e + 1], __high2float(vp[e]));
          }
        } else {
          m[0] = fmaxf(m[0], __bfloat162float(*src));
        }
      }
    }
    bf16* dst = out + i * VEC;
    if constexpr (VEC == 8) {
      bf162 o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = __floats2bfloat162_rn(m[2 * e], m[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
      *dst = __float2bfloat16_rn(m[0]);
    }
  }
}

// ---------------------------------------------------------------------
// The split attention's weights, one image per block: channel sums of y
// (from the grouped conv's per-tile partials in tile order, or, when
// `partial` is null, from y [n, pixels, 2 width] itself), the two dense
// layers and the two-way softmax -> att [n, 2 width] float32.

constexpr int kAttThreads = 512;

__global__ void __launch_bounds__(kAttThreads) attention_kernel(
    const bf16* __restrict__ y, const float* __restrict__ partial, int tiles,
    const bf16* __restrict__ wd1, const float* __restrict__ bd1,
    const bf16* __restrict__ wd2, const float* __restrict__ bd2,
    float* __restrict__ att, int pixels, int width, int inter) {
  extern __shared__ float sm[];
  const int c2 = 2 * width;
  const int lanes = blockDim.x / c2;
  float* part = sm;                    // [lanes][c2]
  float* gap = part + lanes * c2;      // [width]
  float* z = gap + width;              // [inter]
  const int t = threadIdx.x;
  const int img = blockIdx.x;

  if (partial != nullptr) {
    if (t < c2) {
      const float* pp = partial + static_cast<size_t>(img) * tiles * c2 + t;
      float s = 0.0f;
      for (int k = 0; k < tiles; ++k) s += pp[static_cast<size_t>(k) * c2];
      part[t] = s;
    }
    __syncthreads();
  } else {
    const bf16* yi = y + static_cast<size_t>(img) * pixels * c2;
    if (t < lanes * c2) {
      const int c = t % c2;
      float s = 0.0f;
      for (int p = t / c2; p < pixels; p += lanes) {
        s += __bfloat162float(yi[static_cast<size_t>(p) * c2 + c]);
      }
      part[t] = s;
    }
    __syncthreads();
    float s = 0.0f;
    if (t < c2) {
      for (int l = 0; l < lanes; ++l) s += part[l * c2 + t];
    }
    __syncthreads();
    if (t < c2) part[t] = s;
    __syncthreads();
  }
  if (t < width) gap[t] = part[t] / pixels + part[width + t] / pixels;
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
    const float w0 = e0 / (e0 + e1);
    att[static_cast<size_t>(img) * c2 + t] = w0;
    att[static_cast<size_t>(img) * c2 + width + t] = 1.0f - w0;
  }
}

// ---------------------------------------------------------------------
// The general path: implicit-GEMM direct convolution on bfloat16 WMMA
// fragments for any widths. A 64-pixel x 64-channel output tile per block,
// K in steps of 32 gathered into shared memory. Weights packed
// [groups][K padded to 32][output channels of a group padded to 64]. With
// `att` the (1x1) input is y [.., 2 cin_g] and A is built as
// bf16(y0*att0 + y1*att1); with a second source (`x2`, 1x1, stride 1) its
// product goes to a second accumulator and the epilogue adds
// (acc*s + b) + (acc2*s2 + b2).

constexpr int BM = 64;   // output pixels per conv block
constexpr int BN = 64;   // output channels per conv block
constexpr int BK = 32;   // K per shared-memory stage
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kConvThreads = 128;  // four warps, 32x32 outputs each

struct ConvArgs {
  const bf16* x;       // NHWC [n, h, w, x_ld]
  const bf16* wt;      // [groups][kpad][npad]
  const float* scale;  // [cout]
  const float* bias;   // [cout]
  const float* att;    // [n, 2 cin_g], or null
  const bf16* x2;      // NHWC [n, ho, wo, cin2], or null
  const bf16* wt2;     // [kpad2][npad]
  const float* scale2;
  const float* bias2;
  const bf16* res;     // NHWC [n, ho, wo, cout], or null
  bf16* out;
  long long os_n, os_y, os_x, os_c;  // output element strides
  int n, h, w, x_ld, cout, ksize, stride, pad, ho, wo;
  int cin_g, cout_g, k, kpad, npad, cin2, kpad2;
  int relu;
};

__global__ void __launch_bounds__(kConvThreads) conv_kernel(ConvArgs a) {
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[2][BM * LDC];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const int hw_out = a.ho * a.wo;
  const int m_total = a.n * hw_out;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  const int passes = a.x2 != nullptr ? 2 : 1;

  for (int pass = 0; pass < passes; ++pass) {
    // The second source is a 1x1 over the output's own pixels.
    const bf16* x = pass ? a.x2 : a.x;
    const int x_ld = pass ? a.cin2 : a.x_ld;
    const int cin_g = pass ? a.cin2 : a.cin_g;
    const int k_total = pass ? a.cin2 : a.k;
    const int kpad = pass ? a.kpad2 : a.kpad;
    const int ksize = pass ? 1 : a.ksize;
    const int stride = pass ? 1 : a.stride;
    const int pad = pass ? 0 : a.pad;
    const int h = pass ? a.ho : a.h;
    const int w = pass ? a.wo : a.w;
    const float* att = pass ? nullptr : a.att;
    const bf16* wg =
        pass ? a.wt2 : a.wt + static_cast<size_t>(g) * a.kpad * a.npad;
    const bool vec = (cin_g % 8) == 0 && (x_ld % 8) == 0;
    const int per = vec ? 8 : 1;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < kpad; k0 += BK) {
      // A: BM output pixels x BK taps-and-channels, gathered from the input.
      for (int i = tid; i < BM * BK / per; i += kConvThreads) {
        const int r = i / (BK / per);
        const int kc = (i % (BK / per)) * per;
        const int m = m0 + r;
        const int kk = k0 + kc;
        const bf16* src = nullptr;
        const float* at = nullptr;
        if (m < m_total && kk < k_total) {
          const int tap = kk / cin_g;
          const int ci = kk - tap * cin_g;
          const int ky = tap / ksize;
          const int kx = tap - ky * ksize;
          const int img = m / hw_out;
          const int rem = m - img * hw_out;
          const int oy = rem / a.wo;
          const int ox = rem - oy * a.wo;
          const int iy = oy * stride - pad + ky;
          const int ix = ox * stride - pad + kx;
          if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
            src = x + ((static_cast<size_t>(img) * h + iy) * w + ix) * x_ld +
                  g * cin_g + ci;
            if (att != nullptr) {
              at = att + static_cast<size_t>(img) * 2 * cin_g + ci;
            }
          }
        }
        if (vec && at == nullptr) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (src != nullptr) v = *reinterpret_cast<const uint4*>(src);
          *reinterpret_cast<uint4*>(&As[r * LDA + kc]) = v;
          continue;
        }
        for (int e = 0; e < per; ++e) {
          bf16 v = zero;
          if (src != nullptr) {
            v = src[e];
            if (at != nullptr) {
              v = __float2bfloat16_rn(__fadd_rn(
                  __fmul_rn(__bfloat162float(v), at[e]),
                  __fmul_rn(__bfloat162float(src[cin_g + e]),
                            at[cin_g + e])));
            }
          }
          As[r * LDA + kc + e] = v;
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
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
        wmma::store_matrix_sync(Cs[pass] + (wm + 16 * i) * LDC + wn + 16 * j,
                                acc[i][j], LDC, wmma::mem_row_major);
  }
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
    float v = scale_bias(Cs[0][r * LDC + c], a.scale[co], a.bias[co]);
    if (passes == 2) {
      v = __fadd_rn(v, scale_bias(Cs[1][r * LDC + c], a.scale2[co],
                                  a.bias2[co]));
    } else if (a.res != nullptr) {
      v = __fadd_rn(v, __bfloat162float(
                           a.res[static_cast<size_t>(m) * a.cout + co]));
    }
    if (a.relu) v = fmaxf(v, 0.0f);
    const int img = m / hw_out;
    const int rem = m - img * hw_out;
    const int oy = rem / a.wo;
    const int ox = rem - oy * a.wo;
    a.out[img * a.os_n + oy * a.os_y + ox * a.os_x + co * a.os_c] =
        __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------
// Host side. The plan (models/fastreid_fused.py::conv_plan) arrives as an
// array of 64-bit integers: kScratchBufs byte offsets into the scratch
// buffer, then kPlanInts values for each of the 12 launches of a
// convolution.

constexpr int kPtrsPerConv = 3;    // packed weight, scale, bias
constexpr int kPtrsPerBlock = 16;  // in, grouped, wd1, bd1, wd2, bd2, out, sc
constexpr int kScratchBufs = 9;  // stem a, stem b, pooled, t, y, partial,
                                 // att, x1, x2
constexpr int kPlanInts = 5;     // path, grid x, grid y, shared bytes, K steps
enum Path { kGeneral = 0, kRing = 1, kStem0 = 2, kOut = 3, kHalo = 4 };

struct Conv {
  const bf16* x;
  int h, w, cin;
  const void* const* p;  // packed weight, scale, bias
  int cout, groups, ksize, stride;
};

int log2_exact(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return (1 << lg) == v ? lg : -1;
}

template <typename Kernel>
int launch_fast(Kernel kernel, const long long* plan, cudaStream_t s,
                const void* args) {
  const int smem = static_cast<int>(plan[3]);
  // More than 48 KB of dynamic shared memory has to be asked for.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {const_cast<void*>(args)};
  err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned>(plan[1]), static_cast<unsigned>(plan[2])),
      dim3(kFastThreads), params, smem, s);
  return static_cast<int>(err);
}

int run_general(const Conv& c, int n, const float* att, const Conv* second,
                const bf16* res, bf16* out, bool nchw, int relu,
                cudaStream_t s) {
  ConvArgs a;
  a.x = c.x;
  a.wt = static_cast<const bf16*>(c.p[0]);
  a.scale = static_cast<const float*>(c.p[1]);
  a.bias = static_cast<const float*>(c.p[2]);
  a.att = att;
  a.res = res;
  a.out = out;
  a.n = n;
  a.h = c.h;
  a.w = c.w;
  a.cout = c.cout;
  a.ksize = c.ksize;
  a.stride = c.stride;
  a.pad = (c.ksize - 1) / 2;
  a.ho = (c.h + 2 * a.pad - c.ksize) / c.stride + 1;
  a.wo = (c.w + 2 * a.pad - c.ksize) / c.stride + 1;
  // With att the input holds both radix halves of each of cin channels.
  a.x_ld = att != nullptr ? 2 * c.cin : c.cin;
  a.cin_g = c.cin / c.groups;
  a.cout_g = c.cout / c.groups;
  a.k = c.ksize * c.ksize * a.cin_g;
  a.kpad = round_up(a.k, BK);
  a.npad = round_up(a.cout_g, BN);
  a.x2 = nullptr;
  a.wt2 = nullptr;
  a.scale2 = a.bias2 = nullptr;
  a.cin2 = a.kpad2 = 0;
  if (second != nullptr) {
    a.x2 = second->x;
    a.wt2 = static_cast<const bf16*>(second->p[0]);
    a.scale2 = static_cast<const float*>(second->p[1]);
    a.bias2 = static_cast<const float*>(second->p[2]);
    a.cin2 = second->cin;
    a.kpad2 = round_up(second->cin, BK);
  }
  a.relu = relu;
  const long long hw = static_cast<long long>(a.ho) * a.wo;
  if (nchw) {
    a.os_n = c.cout * hw;
    a.os_c = hw;
    a.os_y = a.wo;
    a.os_x = 1;
  } else {
    a.os_n = c.cout * hw;
    a.os_y = static_cast<long long>(a.wo) * c.cout;
    a.os_x = c.cout;
    a.os_c = 1;
  }
  const long long m = static_cast<long long>(n) * hw;
  dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), a.npad / BN, c.groups);
  conv_kernel<<<grid, kConvThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A convolution followed by scale, bias and ReLU, NHWC in and out, on the
// path its plan names; `partial`: the grouped conv's per-tile channel sums.
int run_conv(const Conv& c, int n, const long long* plan, bf16* out,
             float* partial, cudaStream_t s) {
  const int path = static_cast<int>(plan[0]);
  if (path == kGeneral) {
    return run_general(c, n, nullptr, nullptr, nullptr, out, false, 1, s);
  }
  if (path == kStem0) {
    const cudaError_t err = cudaFuncSetAttribute(
        stem0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan[3]));
    if (err != cudaSuccess) return static_cast<int>(err);
    stem0_kernel<<<dim3(static_cast<unsigned>(plan[1]),
                        static_cast<unsigned>(plan[2])),
                   kStem0Threads, static_cast<int>(plan[3]), s>>>(
        c.x, static_cast<const bf16*>(c.p[0]), round_up(c.cout, BN),
        static_cast<const float*>(c.p[1]), static_cast<const float*>(c.p[2]),
        out, c.h, c.w, c.cout);
    return static_cast<int>(cudaGetLastError());
  }
  FastArgs a;
  a.x = c.x;
  a.wt = static_cast<const bf16*>(c.p[0]);
  a.scale = static_cast<const float*>(c.p[1]);
  a.bias = static_cast<const float*>(c.p[2]);
  a.out = out;
  a.partial = partial;
  a.h = c.h;
  a.w = c.w;
  a.cin = c.cin;
  a.cout = c.cout;
  a.cin_g = c.cin / c.groups;
  a.lg_cin_g = log2_exact(a.cin_g);
  a.tiles = (c.h * c.w + kTileM - 1) / kTileM;
  a.total = n * a.tiles;
  a.ksteps = static_cast<int>(plan[4]);
  a.pitch = a.cin_g * 2 + 16;
  const int cout_g = c.cout / c.groups;
  if (a.lg_cin_g < 5 || c.stride != 1 || 4 * a.ksteps > kMaxSlices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == kRing && c.ksize == 1 && partial == nullptr && cout_g == 64) {
    return launch_fast(ring_conv_kernel, plan, s, &a);
  }
  if (path == kHalo && c.ksize == 3) {
    if (partial != nullptr && cout_g == 64) {
      return launch_fast(halo_conv_kernel<64, true>, plan, s, &a);
    }
    if (partial == nullptr && cout_g == 64) {
      return launch_fast(halo_conv_kernel<64, false>, plan, s, &a);
    }
    if (partial == nullptr && cout_g == 32) {
      return launch_fast(halo_conv_kernel<32, false>, plan, s, &a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: NHWC [n, h, w, 3] bfloat16; ptrs: 9 stem pointers (3 convs x packed
// weight, scale, bias) then 16 per block (in, grouped, wd1, bd1, wd2, bd2,
// out, shortcut; the shortcut's three are null in blocks 1 and 2); plan:
// see above; out: NCHW [n, 4*width, h/4, w/4] bfloat16. Returns the first
// CUDA error.
extern "C" int stem_stage1_launch(const void* x, const void* const* ptrs,
                                  void* out, void* scratch,
                                  const long long* plan, int n, int h, int w,
                                  int sw, int width, void* stream) {
  if (2 * width > kAttThreads || width % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h1 = h / 2, w1 = w / 2, h2 = h / 4, w2 = w / 4;
  const int inter = 2 * width / 4 > 32 ? 2 * width / 4 : 32;
  char* base = static_cast<char*>(scratch);
  bf16* stem_a = reinterpret_cast<bf16*>(base + plan[0]);
  bf16* stem_b = reinterpret_cast<bf16*>(base + plan[1]);
  bf16* pooled = reinterpret_cast<bf16*>(base + plan[2]);
  bf16* t = reinterpret_cast<bf16*>(base + plan[3]);
  bf16* y = reinterpret_cast<bf16*>(base + plan[4]);
  float* partial = reinterpret_cast<float*>(base + plan[5]);
  float* att = reinterpret_cast<float*>(base + plan[6]);
  bf16* stage[2] = {reinterpret_cast<bf16*>(base + plan[7]),
                    reinterpret_cast<bf16*>(base + plan[8])};
  const long long* cp = plan + kScratchBufs;

  int err;
#define STEM_CHECK(call) \
  if ((err = (call)) != 0) return err
  const Conv stem0 = {static_cast<const bf16*>(x), h, w, 3, ptrs, sw, 1, 3, 2};
  const Conv stem1 = {stem_a, h1, w1, sw, ptrs + kPtrsPerConv, sw, 1, 3, 1};
  const Conv stem2 = {stem_b, h1, w1, sw, ptrs + 2 * kPtrsPerConv, 2 * sw,
                      1, 3, 1};
  STEM_CHECK(run_conv(stem0, n, cp, stem_a, nullptr, s));
  STEM_CHECK(run_conv(stem1, n, cp + kPlanInts, stem_b, nullptr, s));
  STEM_CHECK(run_conv(stem2, n, cp + 2 * kPlanInts, stem_a, nullptr, s));
  {
    const int c = 2 * sw;
    const int vec = c % 8 == 0 ? 8 : 1;
    const size_t total = static_cast<size_t>(n) * h2 * w2 * (c / vec);
    const int blocks = static_cast<int>(
        (total + kPoolThreads - 1) / kPoolThreads);
    if (vec == 8) {
      maxpool_kernel<8><<<blocks, kPoolThreads, 0, s>>>(stem_a, pooled, n, h1,
                                                        w1, c, h2, w2);
    } else {
      maxpool_kernel<1><<<blocks, kPoolThreads, 0, s>>>(stem_a, pooled, n, h1,
                                                        w1, c, h2, w2);
    }
    STEM_CHECK(static_cast<int>(cudaGetLastError()));
  }
  const int pixels = h2 * w2;
  const int lanes = kAttThreads / (2 * width);
  const int att_smem = static_cast<int>(sizeof(float)) *
                       (lanes * 2 * width + width + inter);
  const bf16* cur = pooled;
  int cin = 2 * sw;
  for (int b = 0; b < 3; ++b) {
    const void* const* p = ptrs + 3 * kPtrsPerConv + b * kPtrsPerBlock;
    const long long* bp = cp + (3 + 3 * b) * kPlanInts;
    const Conv c_in = {cur, h2, w2, cin, p, width, 1, 1, 1};
    const Conv c_split = {t, h2, w2, width, p + 3, 2 * width, 2, 3, 1};
    const Conv c_out = {y, h2, w2, width, p + 10, 4 * width, 1, 1, 1};
    const Conv c_sc = {cur, h2, w2, cin, p + 13, 4 * width, 1, 1, 1};
    const bool split_fast = bp[kPlanInts] == kHalo;
    STEM_CHECK(run_conv(c_in, n, bp, t, nullptr, s));
    STEM_CHECK(run_conv(c_split, n, bp + kPlanInts, y,
                        split_fast ? partial : nullptr, s));
    attention_kernel<<<n, kAttThreads, att_smem, s>>>(
        y, split_fast ? partial : nullptr, (pixels + kTileM - 1) / kTileM,
        static_cast<const bf16*>(p[6]), static_cast<const float*>(p[7]),
        static_cast<const bf16*>(p[8]), static_cast<const float*>(p[9]), att,
        pixels, width, inter);
    STEM_CHECK(static_cast<int>(cudaGetLastError()));
    bf16* dst = b == 2 ? static_cast<bf16*>(out) : stage[b];
    const long long* op = bp + 2 * kPlanInts;
    if (op[0] == kOut) {
      if (width != kOutW || (b == 0 && cin != kOutW)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      OutArgs a;
      a.y = y;
      a.att = att;
      a.wo = static_cast<const bf16*>(p[10]);
      a.so = static_cast<const float*>(p[11]);
      a.bo = static_cast<const float*>(p[12]);
      a.xs = cur;
      a.ws = static_cast<const bf16*>(p[13]);
      a.ss = static_cast<const float*>(p[14]);
      a.bs = static_cast<const float*>(p[15]);
      a.res = cur;
      a.out = dst;
      a.hw = pixels;
      a.tiles = (pixels + kTileM - 1) / kTileM;
      a.nchw = b == 2;
      STEM_CHECK(b == 0 ? launch_fast(out_conv_kernel<true>, op, s, &a)
                        : launch_fast(out_conv_kernel<false>, op, s, &a));
    } else {
      STEM_CHECK(run_general(c_out, n, att, b == 0 ? &c_sc : nullptr,
                             b == 0 ? nullptr : cur, dst, b == 2, 1, s));
    }
    cur = dst;
    cin = 4 * width;
  }
#undef STEM_CHECK
  return 0;
}
