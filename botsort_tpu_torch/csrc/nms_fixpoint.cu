// K8: greedy non-maximum suppression run to its fixpoint, one thread-block
// cluster per (frame, class) problem.
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
// The decision without a division: with t = f32(thr) normal and in
// [2^-60, 2^60], the host passes hi = fl(t (1 + 2^-20)) and
// lo = fl(t (1 - 2^-20)); d = max(denom, 1e-12). If inter > fl(d hi),
// then inter / d > t (1 + 2^-21), above t's rounding midpoint
// t + ulp(t) / 2 <= t (1 + 2^-24), so fl(inter / d) > t; if
// inter < fl(d lo), then inter / d < t and fl(inter / d) <= t. Only the
// pairs between (IoUs within about 2^-20 of t) take __fdiv_rn, so every
// decision is the division's. Another t gets hi = +inf and lo = -inf:
// every pair divides.
//
// Design: the problem's dominance bits are built by a cluster of c blocks
// (c from the host: ops/nms.py::cluster_size, 16 at 4 problems and 3 at
// 32 on the H100) and gathered in the leader block's (rank 0) shared
// memory. Word w of box j holds the bits of the boxes 32w..32w+31 that
// rank above j, are valid and dominate it, at dom[w * P + j], so that the
// 32 lanes of a warp, which own 32 consecutive boxes, touch 32 consecutive
// banks (32 KB at P = 512). Only the words with 32w < j hold work (the
// triangle); in tasks of 32 consecutive boxes j (a warp, lane = j mod 32)
// they are numbered row by row (w, then j), and each block takes an equal
// share of the numbers. A lane walks the 32 boxes i of word w, which every
// lane reads at one address (a broadcast), in straight-line code (the
// decision without a division; the few pairs it leaves divide afterwards),
// builds its word in a register and stores it into the leader's dom
// through distributed shared memory: a warp's 32 words at 32 consecutive
// addresses. Every block loads the problem's boxes, areas and valid bits
// itself (P x 17 B, from L2). One cluster barrier orders the remote stores
// before the leader reads them; the other blocks then exit (nobody reads
// their shared memory). The leader alone iterates: each thread ANDs its
// box's words with keep, __ballot_sync packs the warp's 32 results into
// the next keep word (double-buffered), and __syncthreads_or ends the loop
// when no word changed. So an iteration costs one block barrier, and no
// [P, P] IoU or dominance tensor ever reaches device memory.
//
// Above kSmemCandidates (1,024) candidates the words outgrow the leader's
// shared memory (P x ceil(P / 32) x 4 B: 4.96 MB at P = 6,300), and the
// same tasks store them, at the same index, into a device scratch buffer
// that the wrapper allocates (words x P x 4 B a problem, on the current
// stream: a graph capture takes it from the graph's pool). A block's shared
// memory then holds only the keep and valid words, and each warp stages the
// 32 boxes of its task's word w (a box and its area a lane) so that the
// lanes still read them as broadcasts; a lane loads its own box from global
// memory. The cluster barrier orders the global stores before the leader's
// loads, which go to L2 (__ldcg), several in flight. Only this path's
// speed differs: every decision, and so every keep bit, is the one the
// shared-memory path and the plain version take.
//
// What bounds it on the card: neither bytes nor operations at these
// sizes. A problem reads P x 17 B and writes P B; its IoUs are about
// P^2 / 2 (131,072 at P = 512, some 12 float32 operations each). The
// build's instruction throughput, spread over c SMs (over every SM at 8
// streams), and the leader's fixpoint, a block barrier an iteration, set
// the time; above 1,024 candidates the fixpoint's L2 loads of the words
// besides.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace cg = cooperative_groups;

namespace {

// ops/nms.py::SMEM_CANDIDATES: the most candidates whose dominance words
// the leader's shared memory holds (128 KB at 1,024); above, they live in
// the wrapper's scratch buffer.
constexpr int kSmemCandidates = 1024;
// The warps of the largest block, each with its own staging slots (above
// kSmemCandidates).
constexpr int kMaxWarps = 32;

struct __align__(16) Box {
  float x1, y1, x2, y2;
};

// t = f32(thr); the division-free decision's bounds (see the note above).
struct Threshold {
  float t, lo, hi;
};

// ops/boxes.py::iou_matrix for one pair (a = the higher-ranked box) up to
// the division: the intersection, max(denom, 1e-12) and whether the IoU
// is a quotient (overlap on both axes, denom > 0) or 0.
struct Pair {
  float inter, d;
  bool quotient;
};

__device__ __forceinline__ Pair pair_of(const Box a, float area_a,
                                        const Box b, float area_b) {
  const float w = __fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1));
  const float h = __fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1));
  const float inter = __fmul_rn(w, h);
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return Pair{inter, fmaxf(denom, 1e-12f),
              w > 0.0f && h > 0.0f && denom > 0.0f};
}

// iou > t without a division where the margin decides (see the note), in
// straight-line code: *hit, or *unsure where only the division can tell.
// zero_hit = 0 > t, the decision for an IoU of 0 (false unless t < 0,
// which the division path takes).
__device__ __forceinline__ void decide(const Pair q, const Threshold thr,
                                       bool zero_hit, bool* hit,
                                       bool* unsure) {
  const bool above = q.inter > __fmul_rn(q.d, thr.hi);
  const bool below = q.inter < __fmul_rn(q.d, thr.lo);
  *hit = q.quotient && above;
  *unsure = q.quotient ? !above && !below : zero_hit;
}

// iou > t by the division.
__device__ __forceinline__ bool dominates(const Pair q, const Threshold thr) {
  return (q.quotient ? __fdiv_rn(q.inter, q.d) : 0.0f) > thr.t;
}

// ops/boxes.py::iou_matrix's area of a box.
__device__ __forceinline__ float area_of(const float4 q) {
  return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
}

// Shared memory (every block of a launch gets the same). Up to
// kSmemCandidates: dom [words][p] (the leader's is the one written), keep
// [2][words], valid bits [words] and area [p_pad] as 32-bit words, then
// the boxes [p_pad] on a 16-byte boundary (p_pad = 32 words; the padding
// is zero). Above: keep [2][words] and valid bits [words], then on a
// 16-byte boundary each warp's 32 staged boxes, then their 32 areas.
__host__ __device__ __forceinline__ size_t boxes_offset(int p) {
  const size_t words = (p + 31) / 32;
  const size_t head = 4 * (words * p + 3 * words + 32 * words);
  return (head + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ __forceinline__ size_t stage_offset(int p) {
  const size_t words = (p + 31) / 32;
  return (4 * 3 * words + 15) & ~static_cast<size_t>(15);
}

size_t smem_bytes(int p) {
  if (p > kSmemCandidates) return stage_offset(p) + kMaxWarps * 32 * (16 + 4);
  return boxes_offset(p) + 16 * 32 * static_cast<size_t>((p + 31) / 32);
}

// The dominance words of `problems` problems above kSmemCandidates
// ([problems][words][p] 32-bit words); 0 up to it.
size_t scratch_bytes(int problems, int p) {
  if (p <= kSmemCandidates) return 0;
  return 4 * static_cast<size_t>(problems) * ((p + 31) / 32) * p;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int kThreads, bool kLarge>
__global__ void __launch_bounds__(kThreads)
nms_fixpoint_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep_out,
                    uint32_t* __restrict__ scratch, int p, Threshold thr) {
  // Word indices: w * p + j outgrows an int only in the scratch buffer.
  using Index = std::conditional_t<kLarge, int64_t, int>;
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  // The leader's shared memory may take remote stores only once every
  // block of the cluster runs: arrive now, wait before the first store.
  cluster_arrive_relaxed();

  const int words = (p + 31) >> 5;
  const int p_pad = words << 5;
  const int prob = blockIdx.x / c;
  const float4* pb = boxes + static_cast<int64_t>(prob) * p;
  const uint8_t* pv = valid + static_cast<int64_t>(prob) * p;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  uint32_t* dom;       // [words][p]: the leader's shared memory, or scratch
  uint32_t* keep;      // [2][words]
  Box* box = nullptr;  // [p_pad], up to kSmemCandidates
  float* area = nullptr;
  Box* stage_box = nullptr;  // this warp's [32], above kSmemCandidates
  float* stage_area = nullptr;
  if constexpr (kLarge) {
    dom = scratch + static_cast<int64_t>(prob) * words * p;
    keep = smem;
    Box* stage = reinterpret_cast<Box*>(reinterpret_cast<char*>(smem) +
                                        stage_offset(p));
    stage_box = stage + (tid >> 5) * 32;
    stage_area = reinterpret_cast<float*>(stage + kMaxWarps * 32) +
                 (tid >> 5) * 32;
  } else {
    dom = smem;
    keep = dom + words * p;
  }
  uint32_t* valid_bits = keep + 2 * words;  // [words]
  if constexpr (!kLarge) {
    area = reinterpret_cast<float*>(valid_bits + words);  // [p_pad]
    box = reinterpret_cast<Box*>(reinterpret_cast<char*>(smem) +
                                 boxes_offset(p));         // [p_pad]
  }

  for (int j = tid; j < p_pad; j += kThreads) {
    const bool v = j < p && pv[j] != 0;
    if constexpr (!kLarge) {
      const float4 q = j < p ? pb[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      box[j] = Box{q.x, q.y, q.z, q.w};
      area[j] = area_of(q);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if ((j & 31) == 0) {
      valid_bits[j >> 5] = bits;
      keep[j >> 5] = bits;  // keep0 = valid (read in the leader only)
    }
  }
  __syncthreads();
  cluster_wait();

  // The words with 32w < j in tasks of 32 consecutive boxes j = 32m + lane
  // (one warp, m >= w), numbered row by row: row w holds the chunks
  // m = w .. words - 1. This block's share is [t0, t1) of the `tasks`
  // numbers; warp k takes t0 + k, t0 + k + warps, ...
  const int tasks = words * (words + 1) / 2;
  const int t0 = tasks * rank / c;
  const int t1 = tasks * (rank + 1) / c;
  constexpr int kWarps = kThreads / 32;
  uint32_t* out_dom;
  if constexpr (kLarge)
    out_dom = dom;
  else
    out_dom = cluster.map_shared_rank(dom, 0);
  const bool zero_hit = 0.0f > thr.t;
  int w = 0, row0 = 0;  // the warp's row and the number of its first task
  for (int t = t0 + (tid >> 5); t < t1; t += kWarps) {
    while (t >= row0 + words - w) {
      row0 += words - w;
      ++w;
    }
    const int j = 32 * (w + t - row0) + lane;
    const int i0 = 32 * w;
    const Box* bi;  // the word's 32 boxes (zero past p), read as broadcasts
    const float* ai;
    if constexpr (kLarge) {
      __syncwarp();  // the warp's previous task has read its stage
      const float4 q = i0 + lane < p ? pb[i0 + lane]
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      stage_box[lane] = Box{q.x, q.y, q.z, q.w};
      stage_area[lane] = area_of(q);
      __syncwarp();
      bi = stage_box;
      ai = stage_area;
    } else {
      bi = box + i0;  // padded to p_pad: no index leaves it
      ai = area + i0;
    }
    if (j >= p) continue;
    uint32_t bits = 0;
    if ((valid_bits[j >> 5] >> (j & 31)) & 1u) {
      Box b;
      float ab;
      if constexpr (kLarge) {
        const float4 q = pb[j];
        b = Box{q.x, q.y, q.z, q.w};
        ab = area_of(q);
      } else {
        b = box[j];
        ab = area[j];
      }
      // Valid boxes i = i0 + k < j: the bits the word can hold.
      const uint32_t cand =
          valid_bits[w] & (j - i0 >= 32 ? 0xffffffffu
                                        : (1u << (j - i0)) - 1u);
      uint32_t unsure = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        bool hit, uns;
        decide(pair_of(bi[k], ai[k], b, ab), thr, zero_hit, &hit, &uns);
        if (hit) bits |= 1u << k;
        if (uns) unsure |= 1u << k;
      }
      bits &= cand;
      for (unsure &= cand; unsure != 0; unsure &= unsure - 1) {
        const int k = __ffs(unsure) - 1;
        if (dominates(pair_of(bi[k], ai[k], b, ab), thr)) bits |= 1u << k;
      }
    }
    // 32 lanes, 32 consecutive words.
    out_dom[static_cast<Index>(w) * p + j] = bits;
  }
  // Release the stores (remote shared or global), acquire them in the
  // leader.
  cluster.sync();
  if (rank != 0) return;

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
        if constexpr (kLarge) {
          // From L2 (the SM's L1 does not see the other blocks' stores),
          // eight loads in flight: no branch between them.
#pragma unroll 8
          for (int v = 0; v <= last; ++v)
            hit |= __ldcg(dom + static_cast<Index>(v) * p + j) & k_old[v];
        } else {
          for (int v = 0; v <= last; ++v) hit |= dom[v * p + j] & k_old[v];
        }
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

using KernelFn = void (*)(const float4*, const uint8_t*, uint8_t*, uint32_t*,
                          int, Threshold);

// The kernel for a block size and candidate count, or null: 1024 threads
// (ops/nms.py::THREADS) in the wrapper; 256 and 512 only in chip_smoke.py's
// timing.
KernelFn pick(int threads, int p) {
  const bool large = p > kSmemCandidates;
  switch (threads) {
    case 256:
      return large ? nms_fixpoint_kernel<256, true>
                   : nms_fixpoint_kernel<256, false>;
    case 512:
      return large ? nms_fixpoint_kernel<512, true>
                   : nms_fixpoint_kernel<512, false>;
    case 1024:
      return large ? nms_fixpoint_kernel<1024, true>
                   : nms_fixpoint_kernel<1024, false>;
    default: return nullptr;
  }
}

// Sets a kernel's attributes once per device: dynamic shared memory up to
// the largest shared-memory problem's (kSmemCandidates), or to the card's
// most for the scratch kernels (whose shared memory grows by 12 B a word
// of 32 candidates), and the non-portable cluster sizes.
cudaError_t prepare(KernelFn kernel, bool large) {
  static std::mutex mu;
  static std::set<std::pair<KernelFn, int>> ready;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (ready.count({kernel, device})) return cudaSuccess;
  int smem = static_cast<int>(smem_bytes(kSmemCandidates));
  if (large) {
    err = cudaDeviceGetAttribute(
        &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  ready.insert({kernel, device});
  return cudaSuccess;
}

// The launch configuration of `problems` clusters of `cluster` blocks of
// `threads` threads, the kernel prepared for it. `attr` is the
// configuration's one attribute.
cudaError_t configure(KernelFn kernel, int problems, int p, int threads,
                      int cluster, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const cudaError_t err = prepare(kernel, p > kSmemCandidates);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(problems * cluster);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem_bytes(p);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

Threshold threshold(float thr) {
  Threshold out{thr, -INFINITY, INFINITY};
  if (thr >= 0x1p-60f && thr <= 0x1p60f) {
    out.lo = thr * (1.0f - 0x1p-20f);
    out.hi = thr * (1.0f + 0x1p-20f);
  }
  return out;
}

bool valid_shape(int problems, int p, int cluster) {
  return problems >= 1 && p >= 1 && cluster >= 1 && cluster <= 16;
}

}  // namespace

extern "C" size_t nms_fixpoint_smem_bytes(int p) { return smem_bytes(p); }

// The scratch buffer nms_fixpoint_launch needs for `problems` problems of p
// candidates (0: none).
extern "C" size_t nms_fixpoint_scratch_bytes(int problems, int p) {
  return scratch_bytes(problems, p);
}

// How many clusters of `cluster` blocks of `threads` threads can run at
// once at candidate count p (cudaOccupancyMaxActiveClusters), into *out;
// 0 means that the cluster size cannot be scheduled.
extern "C" int nms_fixpoint_max_active_clusters(int p, int cluster,
                                                int threads, int* out) {
  const KernelFn kernel = pick(threads, p);
  if (kernel == nullptr || !valid_shape(1, p, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure(kernel, 1, p, threads, cluster, nullptr,
                              &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// boxes [problems, p, 4] float32, valid [problems, p] uint8 (0/1), keep
// [problems, p] uint8 out, scratch nms_fixpoint_scratch_bytes(problems, p)
// bytes (null where that is 0); all contiguous on one device. One cluster
// of `cluster` blocks of `threads` threads a problem, on `stream`.
extern "C" int nms_fixpoint_launch(const void* boxes, const void* valid,
                                   void* keep, void* scratch, int problems,
                                   int p, float thr, int cluster,
                                   int threads, cudaStream_t stream) {
  const KernelFn kernel = pick(threads, p);
  if (kernel == nullptr || !valid_shape(problems, p, cluster) ||
      (scratch == nullptr && scratch_bytes(problems, p) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure(kernel, problems, p, threads, cluster, stream,
                              &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float4*>(boxes),
                           static_cast<const uint8_t*>(valid),
                           static_cast<uint8_t*>(keep),
                           static_cast<uint32_t*>(scratch), p,
                           threshold(thr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
