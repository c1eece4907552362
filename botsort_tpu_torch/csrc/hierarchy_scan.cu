// K10: the box hierarchy's greedy claims, every problem of a step in one
// launch, one warp a problem (a block a problem above 1,024 targets).
//
// A kernel of the port alone: no Pallas kernel stands behind it. In the
// JAX package the claims are a ``lax.scan`` inside the jitted frame step
// (botsort_tpu/ops/hierarchy.py::greedy_assign_batch, :122-130), which
// XLA compiles into one device loop with the problems (faces -> heads,
// heads -> bodies, hands -> bodies, for each frame) advancing in lockstep.
// For base bi = 0 .. B-1 and round r = 0 .. R-1 each problem p claims
//
//   row[t]  = used[t] ? 0 : iou[p, bi, t]
//   best    = max_t row[t]
//   cand[t] = row[t] == best and best > 0
//   idx     = argmin_t (cand[t] ? dist[p, bi, t] : +inf), the lowest t
//             among equal values (torch.argmin's and jnp.argmin's rule)
//   found   = best > 0 and round_active[p, r]
//   picks[bi, p, r] = found ? idx : -1; found sets used[idx]
//
// starting from used = used0 (the invalid targets). The plain PyTorch
// version is ops/hierarchy.py::greedy_scan_plain; the IoU and the
// distances stay PyTorch ops (ops/hierarchy.py::scan_inputs), as the JAX
// package computes them outside its scan.
//
// Exactness: the kernel does no float arithmetic, only comparisons, so
// its picks equal the plain version's bit for bit given the same iou and
// dist. It compares 32-bit order-preserving keys, made once a row
// (iou_key, dist_key): an unsigned comparison of two keys gives the
// order torch gives their floats, -0 equal to +0. NaN follows torch: a
// NaN in the row makes best NaN (amax propagates it; its key is above
// every number's), so nothing is claimed; a NaN distance of a candidate
// is the argmin (torch's argmin takes NaN as the least value, the first
// one at several; its key is below every number's). A used target's key
// is 0's. tests/test_torch_hierarchy.py mirrors both maps in torch
// integer ops and holds the claims by keys to greedy_scan_plain on rows of
// NaN, +-0, +-inf, subnormals and ties.
//
// Design: a claim is three warp reductions, Hopper's redux.sync
// (__reduce_max_sync / __reduce_min_sync on 32-bit integers): the max of
// the lanes' largest IoU keys gives best; among the targets whose key is
// best, the min of the lanes' least distance keys gives d; the min of
// the lowest index of each lane whose least key is d (UINT32_MAX from the
// others) gives idx. A round that claims nothing (best not above 0, or
// the round not the problem's, both uniform) skips the last two.
//
// Up to 1,024 targets, a warp a problem: lane l holds the targets l,
// l + 32, ... (kSlots of them, the least of {1, 2, 4, 8, 16, 32} with
// T <= 32 kSlots), their keys in registers and their used bits in one
// register word. A base's row of iou and dist is loaded (coalesced: lane
// l reads t = l + 32 s) while the previous base's rounds run, so the
// loads' latency hides behind the claims; it becomes keys when its base
// starts. Warps of a block are independent problems; nothing is shared
// and nothing is synchronised beyond the warp.
//
// Above 1,024 targets, a block of 1,024 threads a problem: thread i holds
// the targets i, i + 1024, ... (any number), their keys and used bits in
// a device scratch buffer that the wrapper allocates (the thread alone
// reads and writes its own, so nothing orders them), and each reduction
// is the warp's redux.sync, the 32 warps' results through shared memory
// and a barrier, and a second redux.sync over them. A row becomes keys
// when its base starts; its loads are not hidden behind the claims.
//
// The rounds' activity is read 32 rounds at a time (a lane a round, one
// __ballot_sync), so R has no limit either.
//
// What bounds it on the card: neither bytes nor operations. A problem
// reads B x T x 8 B (20 KB at B = T = 50) and writes B x R x 4 B; the
// claims are a chain of B x R dependent steps, so the chain's latency is
// its time: at 50 x 2 claims about a hundred times a claim's three
// redux.sync and local work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
// ops/hierarchy.py::WARP_TARGETS: the most targets of the warp-a-problem
// form (32 lanes x 32 slots), and the block size above it.
constexpr int kWarpTargets = 1024;
constexpr int kBlockThreads = 1024;
constexpr uint32_t kNone = 0xffffffffu;

// IoU keys: torch.amax's order, -0 as +0, NaN above every number.
__device__ __forceinline__ uint32_t iou_key(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN
  if (u == 0x80000000u) u = 0u;                             // -0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Distance keys: torch.argmin's order, -0 as +0, NaN below every number.
__device__ __forceinline__ uint32_t dist_key(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0u;  // NaN
  if (u == 0x80000000u) u = 0u;                    // -0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr uint32_t kZeroKey = 0x80000000u;  // iou_key(0)
constexpr uint32_t kNanKey = 0xffffffffu;   // iou_key(NaN)
constexpr uint32_t kInfKey = 0xff800000u;   // dist_key(+inf)

// best > 0 and not NaN, as torch's best_iou > 0.0.
__device__ __forceinline__ bool positive(uint32_t best) {
  return best > kZeroKey && best != kNanKey;
}

// The activity of rounds r0 .. r0 + 31 of a problem (bit k: round r0 + k
// claims), one lane a round, in every lane of the warp.
__device__ __forceinline__ uint32_t round_bits(const bool* active, int r0,
                                               int n_rounds, int lane) {
  const int r = r0 + lane;
  return __ballot_sync(kFull, r < n_rounds && active[r]);
}

template <int kSlots>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    hierarchy_scan_warp(const float* __restrict__ iou,
                        const float* __restrict__ dist,
                        const bool* __restrict__ used0,
                        const bool* __restrict__ round_active,
                        int32_t* __restrict__ picks, int n_problems,
                        int n_bases, int n_targets, int n_rounds) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_problems) return;  // the whole warp leaves together

  uint32_t used = 0;  // bit s: target lane + 32 s is used (or absent)
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + 32 * s;
    if (t >= n_targets || used0[static_cast<int64_t>(p) * n_targets + t])
      used |= 1u << s;
  }
  const bool* active_p = round_active + static_cast<int64_t>(p) * n_rounds;
  uint32_t active = round_bits(active_p, 0, n_rounds, lane);

  const int64_t plane = static_cast<int64_t>(n_bases) * n_targets;
  const float* iou_p = iou + p * plane;
  const float* dist_p = dist + p * plane;
  uint32_t key_iou[kSlots], key_d[kSlots];
  float next_iou[kSlots], next_d[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + 32 * s;
    next_iou[s] = t < n_targets ? iou_p[t] : 0.0f;
    next_d[s] = t < n_targets ? dist_p[t] : 0.0f;
  }
  for (int bi = 0; bi < n_bases; ++bi) {
    // The row as keys; a used (or absent) target weighs 0.
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      key_iou[s] = (used >> s) & 1u ? kZeroKey : iou_key(next_iou[s]);
      key_d[s] = dist_key(next_d[s]);
    }
    if (bi + 1 < n_bases) {  // the next base's row, loaded in the shadow
      const int64_t off = static_cast<int64_t>(bi + 1) * n_targets;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int t = lane + 32 * s;
        next_iou[s] = t < n_targets ? iou_p[off + t] : 0.0f;
        next_d[s] = t < n_targets ? dist_p[off + t] : 0.0f;
      }
    }
    for (int r = 0; r < n_rounds; ++r) {
      if (n_rounds > 32 && (r & 31) == 0)
        active = round_bits(active_p, r, n_rounds, lane);
      uint32_t top = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) top = max(top, key_iou[s]);
      const uint32_t best = __reduce_max_sync(kFull, top);
      int32_t pick = -1;
      if (positive(best) && ((active >> (r & 31)) & 1u)) {
        // The lane's least distance key among the candidates (+inf's key
        // for every other target; absent targets take no part), at its
        // lowest index.
        uint32_t least = kNone, at = kNone;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int t = lane + 32 * s;
          const uint32_t k = key_iou[s] == best ? key_d[s] : kInfKey;
          if (t < n_targets && k < least) {
            least = k;
            at = static_cast<uint32_t>(t);
          }
        }
        const uint32_t d = __reduce_min_sync(kFull, least);
        const uint32_t idx = __reduce_min_sync(kFull, least == d ? at : kNone);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (static_cast<uint32_t>(lane + 32 * s) == idx) {
            used |= 1u << s;
            key_iou[s] = kZeroKey;
          }
        }
        pick = static_cast<int32_t>(idx);
      }
      if (lane == 0)
        picks[(static_cast<int64_t>(bi) * n_problems + p) * n_rounds + r] =
            pick;
    }
  }
}

// The block's max or min of v (every thread's), through 32 words of
// shared memory `red`: the warp's redux.sync, one barrier, then a
// redux.sync over the 32 warps' results. Every thread reads a
// reduction's words before it reaches the next reduction's barrier, and
// each is written again only after that barrier: the best's words
// alternate between two sets a claim (a claim may have no other
// reduction), the distance's and the index's have one set each.
template <bool kMax>
__device__ __forceinline__ uint32_t block_reduce(uint32_t v, uint32_t* red,
                                                 int lane, int warp) {
  v = kMax ? __reduce_max_sync(kFull, v) : __reduce_min_sync(kFull, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const uint32_t w = red[lane];
  return kMax ? __reduce_max_sync(kFull, w) : __reduce_min_sync(kFull, w);
}

// keys [P][T] (iou key, distance key) and used [P][words][kBlockThreads]
// (bit k of word w: the thread's target tid + kBlockThreads (32 w + k)).
__global__ void __launch_bounds__(kBlockThreads)
    hierarchy_scan_block(const float* __restrict__ iou,
                         const float* __restrict__ dist,
                         const bool* __restrict__ used0,
                         const bool* __restrict__ round_active,
                         int32_t* __restrict__ picks,
                         uint2* __restrict__ keys,
                         uint32_t* __restrict__ used, int n_problems,
                         int n_bases, int n_targets, int n_rounds) {
  __shared__ uint32_t red[4][32];  // best (two sets), distance, index
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x;
  const int slots = (n_targets + kBlockThreads - 1) / kBlockThreads;
  const int words = (slots + 31) / 32;
  uint2* keys_p = keys + static_cast<int64_t>(p) * n_targets;
  uint32_t* used_p =
      used + (static_cast<int64_t>(p) * words) * kBlockThreads + tid;

  for (int w = 0; w < words; ++w) {
    uint32_t bits = 0;
    for (int k = 0; k < 32; ++k) {
      const int64_t t = tid + static_cast<int64_t>(kBlockThreads) *
                                  (32 * w + k);
      if (t >= n_targets || used0[p * static_cast<int64_t>(n_targets) + t])
        bits |= 1u << k;
    }
    used_p[w * kBlockThreads] = bits;
  }
  const bool* active_p = round_active + static_cast<int64_t>(p) * n_rounds;
  uint32_t active = 0;
  int claims = 0;

  const int64_t plane = static_cast<int64_t>(n_bases) * n_targets;
  for (int bi = 0; bi < n_bases; ++bi) {
    const int64_t row = p * plane + static_cast<int64_t>(bi) * n_targets;
    const float* iou_b = iou + row;
    const float* dist_b = dist + row;
    for (int s = 0; s < slots; ++s) {
      const int t = tid + kBlockThreads * s;
      if (t >= n_targets) break;
      const bool u = (used_p[(s >> 5) * kBlockThreads] >> (s & 31)) & 1u;
      keys_p[t] = make_uint2(u ? kZeroKey : iou_key(iou_b[t]),
                             dist_key(dist_b[t]));
    }
    for (int r = 0; r < n_rounds; ++r) {
      if ((r & 31) == 0) active = round_bits(active_p, r, n_rounds, lane);
      uint32_t top = 0;
      for (int s = 0; s < slots; ++s) {
        const int t = tid + kBlockThreads * s;
        if (t >= n_targets) break;
        top = max(top, keys_p[t].x);
      }
      const uint32_t best =
          block_reduce<true>(top, red[claims++ & 1], lane, warp);
      int32_t pick = -1;
      if (positive(best) && ((active >> (r & 31)) & 1u)) {
        uint32_t least = kNone, at = kNone;
        for (int s = 0; s < slots; ++s) {
          const int t = tid + kBlockThreads * s;
          if (t >= n_targets) break;
          const uint2 k = keys_p[t];
          const uint32_t d = k.x == best ? k.y : kInfKey;
          if (d < least) {
            least = d;
            at = static_cast<uint32_t>(t);
          }
        }
        const uint32_t d = block_reduce<false>(least, red[2], lane, warp);
        const uint32_t idx =
            block_reduce<false>(least == d ? at : kNone, red[3], lane, warp);
        if (idx % kBlockThreads == static_cast<uint32_t>(tid)) {
          const int s = static_cast<int>(idx / kBlockThreads);
          used_p[(s >> 5) * kBlockThreads] |= 1u << (s & 31);
          keys_p[idx].x = kZeroKey;
        }
        pick = static_cast<int32_t>(idx);
      }
      if (tid == 0)
        picks[(static_cast<int64_t>(bi) * n_problems + p) * n_rounds + r] =
            pick;
    }
  }
}

// The block form's scratch: keys, then used words.
size_t scratch_bytes(int n_problems, int n_targets) {
  if (n_targets <= kWarpTargets) return 0;
  const size_t slots = (n_targets + kBlockThreads - 1) / kBlockThreads;
  const size_t words = (slots + 31) / 32;
  return static_cast<size_t>(n_problems) *
         (8 * static_cast<size_t>(n_targets) + 4 * words * kBlockThreads);
}

template <int kSlots>
int run(const float* iou, const float* dist, const bool* used0,
        const bool* round_active, int32_t* picks, int n_problems,
        int n_bases, int n_targets, int n_rounds, cudaStream_t stream) {
  const int blocks = (n_problems + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hierarchy_scan_warp<kSlots><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      iou, dist, used0, round_active, picks, n_problems, n_bases, n_targets,
      n_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch buffer hierarchy_scan_launch needs (0: none, up to 1,024
// targets).
extern "C" size_t hierarchy_scan_scratch_bytes(int n_problems,
                                               int n_targets) {
  return scratch_bytes(n_problems, n_targets);
}

// iou, dist [P, B, T] float32; used0 [P, T] bool; round_active [P, R]
// bool; picks [B, P, R] int32; scratch hierarchy_scan_scratch_bytes(P, T)
// bytes, 8-byte aligned (null where that is 0); all contiguous on the
// stream's device. Returns a CUDA error code (0: launched).
extern "C" int hierarchy_scan_launch(const float* iou, const float* dist,
                                     const bool* used0,
                                     const bool* round_active,
                                     int32_t* picks, void* scratch,
                                     int n_problems, int n_bases,
                                     int n_targets, int n_rounds,
                                     cudaStream_t stream) {
  if (n_problems <= 0 || n_bases <= 0 || n_rounds <= 0) return 0;
  if (n_targets <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_targets > kWarpTargets) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    uint2* keys = static_cast<uint2*>(scratch);
    uint32_t* used = reinterpret_cast<uint32_t*>(
        keys + static_cast<int64_t>(n_problems) * n_targets);
    hierarchy_scan_block<<<n_problems, kBlockThreads, 0, stream>>>(
        iou, dist, used0, round_active, picks, keys, used, n_problems,
        n_bases, n_targets, n_rounds);
    return static_cast<int>(cudaGetLastError());
  }
  const int slots = (n_targets + 31) / 32;
  if (slots <= 1)
    return run<1>(iou, dist, used0, round_active, picks, n_problems,
                  n_bases, n_targets, n_rounds, stream);
  if (slots <= 2)
    return run<2>(iou, dist, used0, round_active, picks, n_problems,
                  n_bases, n_targets, n_rounds, stream);
  if (slots <= 4)
    return run<4>(iou, dist, used0, round_active, picks, n_problems,
                  n_bases, n_targets, n_rounds, stream);
  if (slots <= 8)
    return run<8>(iou, dist, used0, round_active, picks, n_problems,
                  n_bases, n_targets, n_rounds, stream);
  if (slots <= 16)
    return run<16>(iou, dist, used0, round_active, picks, n_problems,
                   n_bases, n_targets, n_rounds, stream);
  return run<32>(iou, dist, used0, round_active, picks, n_problems, n_bases,
                 n_targets, n_rounds, stream);
}
