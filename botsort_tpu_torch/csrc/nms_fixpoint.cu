// K8: greedy non-maximum suppression run to its fixpoint, one block per
// (frame, class) problem.
//
// A kernel of the port alone: no Pallas kernel stands behind it. In the
// JAX package the suppression is a ``lax.while_loop`` inside the jitted
// frame step (botsort_tpu/ops/nms.py:88-103, ``nms_single_class``): from
// keep = valid it iterates
//
//   keep[j] = valid[j] and no i < j with keep[i] and iou(i, j) > thr
//
// over the top-P candidates of one class (score order, rank = index) until
// nothing changes, capped at P iterations. The fixpoint is unique and
// iteration t settles every box whose longest chain of dominators is at
// most t long, so the loop ends after (longest chain + 1) iterations. The
// plain PyTorch version is ops/nms.py::nms_fixpoint_plain; the sort, the
// gathers before and the compaction after stay in PyTorch.
//
// Exactness: the IoU is ops/boxes.py::iou_matrix's float32 arithmetic in
// its order: inter = min(max) corners, wh = max - min, overlap = both
// wh > 0, inter_area = wh0 * wh1, area = (x2 - x1) * (y2 - y1),
// denom = (area_i + area_j) - inter_area, iou = inter_area /
// max(denom, 1e-12) where denom > 0 and overlap, else 0; then
// iou > thr with thr rounded to float32, as torch and JAX compare a float32
// tensor with a Python float. Products, sums and the quotient are
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (the library is built
// with --fmad=false besides), so a box exactly at the threshold goes the
// way the plain version sends it.
//
// Design: the block first builds, for every box j, the bits of the
// higher-ranked boxes i < j that dominate it (valid, IoU above thr), as
// ceil(P/32) 32-bit words: word w of box j at dom[w * P + j], so that the
// 32 lanes of a warp, which own 32 consecutive boxes, touch 32 consecutive
// banks (32 KB of shared memory at P = 512). The keep vector is ceil(P/32)
// words, double-buffered. One iteration: each thread ANDs its box's words
// with keep, and __ballot_sync packs the warp's 32 results into the next
// keep word; __syncthreads_or ends the loop when no word changed. So the
// loop costs one block barrier an iteration, not one per box as a serial
// greedy scan would, and no [P, P] IoU or dominance tensor ever reaches
// device memory.
//
// What bounds it on the card: neither bytes nor operations at these
// sizes. A problem reads P x 17 B and writes P B; its IoUs are about
// P^2 / 2 (131,072 at P = 512, some 12 float32 operations each, one a
// division), and one problem's IoUs run on one SM (4 blocks at one
// stream, 32 at eight): the build's instruction latency on that SM, then
// a barrier an iteration, set the time, far above the card's bound.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// A block of 1024 threads: the IoU build is most of a launch, and it runs
// on one SM; 32 warps hide the division's latency where 8 could not (256
// and 512 threads were slower on the card at the steps' shapes).
constexpr int kThreads = 1024;

struct Box {
  float x1, y1, x2, y2;
};

// ops/boxes.py::iou_matrix for one pair (a = the higher-ranked box), then
// the comparison with the threshold.
__device__ __forceinline__ bool dominates(const Box a, float area_a,
                                          const Box b, float area_b,
                                          float thr) {
  const float w = __fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1));
  const float h = __fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1));
  float iou = 0.0f;
  if (w > 0.0f && h > 0.0f) {  // overlap
    const float inter = __fmul_rn(w, h);
    const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    if (denom > 0.0f) iou = __fdiv_rn(inter, fmaxf(denom, 1e-12f));
  }
  return iou > thr;
}

// Shared memory: dom [words][p], keep [2][words], valid bits [words] and
// area [p] as 32-bit words, then the boxes [p] on a 16-byte boundary.
__host__ __device__ __forceinline__ size_t boxes_offset(int p) {
  const size_t words = (p + 31) / 32;
  const size_t head = 4 * (words * p + 3 * words + p);
  return (head + 15) & ~static_cast<size_t>(15);
}

__global__ void __launch_bounds__(kThreads)
nms_fixpoint_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep_out, int p, float thr) {
  extern __shared__ uint32_t smem[];
  const int words = (p + 31) >> 5;
  const int p_pad = words << 5;
  uint32_t* dom = smem;                           // [words][p]
  uint32_t* keep = dom + words * p;               // [2][words]
  uint32_t* valid_bits = keep + 2 * words;        // [words]
  float* area = reinterpret_cast<float*>(valid_bits + words);  // [p]
  Box* box = reinterpret_cast<Box*>(reinterpret_cast<char*>(smem) +
                                    boxes_offset(p));             // [p]

  const int prob = blockIdx.x;
  const float4* pb = boxes + static_cast<int64_t>(prob) * p;
  const uint8_t* pv = valid + static_cast<int64_t>(prob) * p;
  const int tid = threadIdx.x;

  for (int j = tid; j < p_pad; j += kThreads) {
    const bool v = j < p && pv[j] != 0;
    if (j < p) {
      const float4 q = pb[j];
      box[j] = Box{q.x, q.y, q.z, q.w};
      area[j] = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if ((j & 31) == 0) {
      valid_bits[j >> 5] = bits;
      keep[j >> 5] = bits;  // keep0 = valid
    }
  }
  __syncthreads();

  // dom[w][j]: bit b set where box 32w + b (< j, valid) dominates valid j.
  for (int idx = tid; idx < words * p; idx += kThreads) {
    const int w = idx / p;
    const int j = idx - w * p;
    uint32_t bits = 0;
    const int i0 = w << 5;
    if (i0 < j && ((valid_bits[j >> 5] >> (j & 31)) & 1u)) {
      const Box b = box[j];
      const float ab = area[j];
      const uint32_t vw = valid_bits[w];
      const int i1 = min(i0 + 32, j);
      for (int i = i0; i < i1; ++i) {
        if (((vw >> (i - i0)) & 1u) &&
            dominates(box[i], area[i], b, ab, thr))
          bits |= 1u << (i - i0);
      }
    }
    dom[idx] = bits;
  }
  __syncthreads();

  // keep_{t+1}[j] = valid[j] and no kept dominator, from keep_t, until no
  // word changes (at most p iterations, as the JAX loop's cap).
  int cur = 0;
  for (int it = 0; it < p; ++it) {
    const uint32_t* k_old = keep + cur * words;
    uint32_t* k_new = keep + (cur ^ 1) * words;
    int changed = 0;
    for (int j = tid; j < p_pad; j += kThreads) {
      bool kj = false;
      if (j < p && ((valid_bits[j >> 5] >> (j & 31)) & 1u)) {
        uint32_t hit = 0;
        const int last = (j - 1) >> 5;  // words that can hold a dominator
        for (int w = 0; w <= last; ++w) hit |= dom[w * p + j] & k_old[w];
        kj = hit == 0;
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, kj);
      if ((j & 31) == 0) {
        k_new[j >> 5] = bits;
        changed |= bits != k_old[j >> 5];
      }
    }
    cur ^= 1;
    if (!__syncthreads_or(changed)) break;
  }

  const uint32_t* k_fin = keep + cur * words;
  uint8_t* out = keep_out + static_cast<int64_t>(prob) * p;
  for (int j = tid; j < p; j += kThreads)
    out[j] = static_cast<uint8_t>((k_fin[j >> 5] >> (j & 31)) & 1u);
}

size_t smem_bytes(int p) {
  return boxes_offset(p) + 16 * static_cast<size_t>(p);
}

}  // namespace

extern "C" size_t nms_fixpoint_smem_bytes(int p) { return smem_bytes(p); }

// boxes [problems, p, 4] float32, valid [problems, p] uint8 (0/1), keep
// [problems, p] uint8 out; all contiguous on one device.
extern "C" int nms_fixpoint_launch(const void* boxes, const void* valid,
                                   void* keep, int problems, int p,
                                   float thr, cudaStream_t stream) {
  if (problems < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_fixpoint_kernel<<<problems, kThreads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), p, thr);
  return static_cast<int>(cudaGetLastError());
}
