// K10: the box hierarchy's greedy claims, every problem of a step in one
// launch, one warp a problem.
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
// dist. NaN follows torch: a NaN in the row makes best NaN (amax
// propagates it), so nothing is claimed; a NaN distance of a candidate is
// the argmin (torch's argmin takes NaN as the least value, the first one
// at several).
//
// Design: a warp a problem, lane l holding the targets l, l + 32, ...
// (kSlots of them, T <= 32 kSlots; the host picks the least kSlots in
// {1, 2, 4, 8, 16, 32}), their used bits in one register word. A claim is
// a local max over the lane's slots and a 5-step __shfl_xor_sync
// butterfly for the max, then a local (value, index) argmin and a second
// 5-step butterfly, which leaves the winner in every lane; the lane that
// owns it sets its used bit, lane 0 writes the pick. A base's row of iou
// and dist is loaded (coalesced: lane l reads t = l + 32 s) while the
// previous base's rounds run, so the loads' latency hides behind the
// reductions. Warps of a block are independent problems; nothing is
// shared and nothing is synchronised beyond the warp.
//
// What bounds it on the card: neither bytes nor operations. A problem
// reads B x T x 8 B (20 KB at B = T = 50) and writes B x R x 4 B; the
// claims are a chain of B x R dependent steps, each two warp reductions
// (about 10 shuffles in sequence), so the chain's latency is its time,
// at 50 x 2 claims about a hundred times a shuffle round trip.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
// ops/hierarchy.py::MAX_TARGETS and MAX_ROUNDS.
constexpr int kMaxTargets = 1024;
constexpr int kMaxRounds = 32;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.amax's order: NaN above every number.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (is_nan(a) || a > b) ? a : b;
}

// (value a, index ia) before (value b, index ib) in torch.argmin's order:
// NaN first, then the smaller value, then the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = is_nan(a), nb = is_nan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

template <int kSlots>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    hierarchy_scan_kernel(const float* __restrict__ iou,
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
  uint32_t active = 0;  // bit r: round r claims for this problem
  for (int r = 0; r < n_rounds; ++r)
    if (round_active[p * n_rounds + r]) active |= 1u << r;

  const int64_t plane = static_cast<int64_t>(n_bases) * n_targets;
  const float* iou_p = iou + p * plane;
  const float* dist_p = dist + p * plane;
  float row_iou[kSlots], row_d[kSlots], next_iou[kSlots], next_d[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + 32 * s;
    next_iou[s] = t < n_targets ? iou_p[t] : 0.0f;
    next_d[s] = t < n_targets ? dist_p[t] : 0.0f;
  }
  for (int bi = 0; bi < n_bases; ++bi) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      row_iou[s] = next_iou[s];
      row_d[s] = next_d[s];
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
      // The row's highest IoU among the unused targets. An absent target
      // counts as used: 0, which no best above 0 can equal.
      float best = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        best = max_nan(best, (used >> s) & 1u ? 0.0f : row_iou[s]);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        best = max_nan(best, __shfl_xor_sync(kFull, best, m));
      const bool positive = best > 0.0f;  // false for NaN, as torch's
      // The smallest distance among the candidates, the lowest index at
      // equal values; every other target of the row weighs +inf. Absent
      // targets (t >= T) lose every tie to a real index.
      float v = __int_as_float(0x7f800000);
      int idx = kMaxTargets;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int t = lane + 32 * s;
        if (t >= n_targets) continue;
        const float row = (used >> s) & 1u ? 0.0f : row_iou[s];
        const float d = (positive && row == best)
                            ? row_d[s]
                            : __int_as_float(0x7f800000);
        if (before(d, t, v, idx)) {
          v = d;
          idx = t;
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, m);
        const int oi = __shfl_xor_sync(kFull, idx, m);
        if (before(ov, oi, v, idx)) {
          v = ov;
          idx = oi;
        }
      }
      const bool found = positive && ((active >> r) & 1u);
      if (found && (idx & 31) == lane) used |= 1u << (idx >> 5);
      if (lane == 0)
        picks[(static_cast<int64_t>(bi) * n_problems + p) * n_rounds + r] =
            found ? idx : -1;
    }
  }
}

template <int kSlots>
int run(const float* iou, const float* dist, const bool* used0,
        const bool* round_active, int32_t* picks, int n_problems,
        int n_bases, int n_targets, int n_rounds, cudaStream_t stream) {
  const int blocks = (n_problems + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hierarchy_scan_kernel<kSlots><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      iou, dist, used0, round_active, picks, n_problems, n_bases, n_targets,
      n_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// iou, dist [P, B, T] float32; used0 [P, T] bool; round_active [P, R]
// bool; picks [B, P, R] int32; all contiguous on the stream's device.
// Returns a CUDA error code (0: launched).
extern "C" int hierarchy_scan_launch(const float* iou, const float* dist,
                                     const bool* used0,
                                     const bool* round_active,
                                     int32_t* picks, int n_problems,
                                     int n_bases, int n_targets,
                                     int n_rounds, cudaStream_t stream) {
  if (n_problems <= 0 || n_bases <= 0 || n_rounds <= 0) return 0;
  if (n_targets <= 0 || n_targets > kMaxTargets || n_rounds > kMaxRounds)
    return static_cast<int>(cudaErrorInvalidValue);
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
