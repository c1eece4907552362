// Device helpers shared by the assignment kernels (cascade_lap.cu: K1/K2,
// jv_lap.cu: K3): one Jonker-Volgenant shortest-augmenting-path
// augmentation, run by one warp or by one block, and the launch plan that
// picks between the two.
//
// Every float32 operation here is the one the plain PyTorch version
// (ops/assignment.py::jv_solve_plain) performs, in the same order, so the
// matchings agree exactly: the kernels are built with --fmad=false and the
// argmin breaks ties to the lowest index, as torch.argmin does.
//
// What bounds the solve is the latency of its sequential pop chain: each
// pop relaxes one extended row, takes the argmin over the columns and
// updates the duals before the next pop can start. The design keeps that
// chain short:
// - Up to kWarpMaxCols columns, one warp solves a problem. Lane l owns
//   columns l, l + 32, ... (K = ceil(S / 32) of them): their minv, v, way
//   and used flags live in registers; the argmin is two warp reductions
//   (redux.sync) on an order-preserving key and one shuffle, after which
//   every lane holds (delta, j1). No barrier in the pop loop: the lanes
//   exchange data only through those warp-synchronous instructions.
// - Above that, the same loop runs block-wide with K = kMaxCols columns a
//   thread; only that instantiation has a barrier (one per pop, the
//   cross-warp argmin hand-off).
// - The row duals u, the owners p and the unwind's way stay in shared
//   memory; the path's rows are a register bit mask of the owning thread.
// - The next pop's row dual is read as soon as its row is known (see
//   augment), so the chain is: argmin, p[j1], u and the row's entries,
//   relax, argmin.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace lap {

constexpr float kInf = 1e30f;  // the reference solver's "unreached" value
constexpr int kMaxCols = 8;    // columns a thread owns, at most
constexpr int kWarpMaxCols = 32 * kMaxCols;    // one warp solves up to this
constexpr int kMaxS = 1024 * kMaxCols;         // one block solves up to this
// Dynamic shared memory a plan may ask for: a Hopper block's 227 KB less
// room for the kernels' static ArgminScratch.
constexpr int kDynSmemLimit = 227 * 1024 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// Key whose unsigned order is the float order, with -0 and +0 equal (the
// + 0.0f turns -0 into +0); the solver's values are never NaN.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

// Index of the warp's minimum value, the lowest index among equal values
// (as jnp.argmin / torch.argmin): two redux.sync reductions; every lane
// gets it.
__device__ __forceinline__ int warp_argmin(float val, int idx) {
  const unsigned key = order_key(val);
  const unsigned kmin = __reduce_min_sync(kFull, key);
  return static_cast<int>(__reduce_min_sync(
      kFull, key == kmin ? static_cast<unsigned>(idx) : 0xffffffffu));
}

// Cross-warp hand-off of the block-wide argmin, double-buffered so that one
// barrier a pop suffices.
struct ArgminScratch {
  float wval[2][32];
  int widx[2][32];
};

// The threads that solve one problem: a warp, or the whole block.
template <bool kBlock>
struct Team {
  int t;   // this thread's rank in the team
  int nt;  // team size
  __device__ __forceinline__ Team()
      : t(kBlock ? static_cast<int>(threadIdx.x)
                 : static_cast<int>(threadIdx.x & 31)),
        nt(kBlock ? static_cast<int>(blockDim.x) : 32) {}
  __device__ __forceinline__ void sync() const {
    if (kBlock) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  }
  // Column (or row) of slot k of this thread.
  __device__ __forceinline__ int col(int k) const { return t + nt * k; }
  // Bit of j's slot if this thread owns column j, else 0.
  __device__ __forceinline__ unsigned bit_of(int j) const {
    const int k = (j - t) / nt;  // a shift in warp mode
    return j >= t && t + nt * k == j ? 1u << k : 0u;
  }
};

// The team's argmin of each thread's (best, bidx): returns the column and
// sets delta to its value, exactly the value its owner holds. Slot
// columns are t + nt * k, so the owner's lane is j & 31 in either mode.
template <bool kBlock>
__device__ __forceinline__ int team_argmin(float best, int bidx,
                                           float& delta, int parity,
                                           ArgminScratch* sc) {
  int j1 = warp_argmin(best, bidx);
  delta = __shfl_sync(kFull, best, j1 & 31);
  if (kBlock) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
      sc->wval[parity][warp] = delta;
      sc->widx[parity][warp] = j1;
    }
    __syncthreads();
    const int nw = blockDim.x >> 5;
    const float val = lane < nw ? sc->wval[parity][lane] : INFINITY;
    const int idx = lane < nw ? sc->widx[parity][lane] : INT_MAX;
    j1 = warp_argmin(val, idx);
    const int owner = __ffs(__ballot_sync(kFull, idx == j1)) - 1;
    delta = __shfl_sync(kFull, val, owner);
  }
  return j1;
}

// One problem's shared-memory vectors, each S words.
struct RowState {
  float* u;  // row duals
  int* p;    // owner row of each column, -1 free
  int* way;  // the augmenting path's predecessors, for the unwind
};

// Carves u, p and way out of `words`; returns the first word after them.
__device__ __forceinline__ int* carve_rows(int* words, int s, RowState& st) {
  st.u = reinterpret_cast<float*>(words);
  st.p = words + s;
  st.way = st.p + s;
  return st.way + s;
}

constexpr int kRowWords = 3;  // S-word vectors in RowState
// Words after a staged matrix, so that a slot past the last row's end
// (up to 32 * K - 1 >= S) still reads inside the problem's shared memory.
constexpr int kPad = 32;

// Copies `count` floats from device memory to shared memory with 16-byte
// loads where both ends are aligned (read-only path).
template <bool kBlock>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count, const Team<kBlock>& tm) {
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = tm.t; i < n4; i += tm.nt) d4[i] = __ldg(s4 + i);
    for (int i = 4 * n4 + tm.t; i < count; i += tm.nt) {
      dst[i] = __ldg(src + i);
    }
  } else {
    for (int i = tm.t; i < count; i += tm.nt) dst[i] = __ldg(src + i);
  }
}

// Augments live row r of the s x s extended problem: Dijkstra over the
// columns from r with dual updates until a free column is reached, then
// the team's thread 0 unwinds the alternating path. ext.row(i) gives row
// i of the extended matrix, row(k, j) its entry at this thread's slot k,
// column j (any j < nt * K must be safe to read). v holds this thread's
// column duals (slot k = column tm.col(k)). Slots past s are kept used:
// they never relax, and at the used columns' value they lose every tie to
// a real column's lower index. Every thread of the team calls it with the
// same arguments.
//
// The pop chain: p[j1] gives the next row, and its dual u[next] is read at
// once: that row owns an unused column, so it is not on the path and this
// pop's dual update leaves its u alone. Each path row's u is updated by
// its owning thread only, so the warp needs no barrier between pops.
template <int K, bool kBlock, class Ext>
__device__ __forceinline__ void augment(int r, int s, const Ext& ext,
                                        float (&v)[K], const RowState& st,
                                        int max_iters, ArgminScratch* sc) {
  const Team<kBlock> tm;
  float minv[K];
  int way[K];
  unsigned outside = 0;  // bit k: slot k lies past column s - 1
#pragma unroll
  for (int k = 0; k < K; ++k) {
    minv[k] = kInf;
    way[k] = s;
    if (tm.col(k) >= s) outside |= 1u << k;
  }
  unsigned used = outside, onpath = 0;  // bit k: slot k's column / row
  float* const u_mine = st.u + tm.t;    // this thread's rows' duals
  int cur = r;
  float ucur = st.u[r];
  int jfrom = s;
  bool done = false;
  for (int it = 0; !done && it < max_iters; ++it) {
    onpath |= tm.bit_of(cur);
    const auto row = ext.row(cur);
    float mv[K];  // masked minv, reduced below to this thread's minimum
    int mi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tm.col(k);
      const bool uj = (used >> k) & 1u;
      // Ext::kGuarded: skip used columns' relax (one load, predicated);
      // else compute it for every slot and keep it for unused ones only,
      // so an entry built from selects stays branch-free (measured).
      if (!Ext::kGuarded || !uj) {
        const float red = (row(k, j) - ucur) - v[k];
        const bool better = !uj && red < minv[k];
        minv[k] = better ? red : minv[k];
        way[k] = better ? jfrom : way[k];
      }
      mv[k] = uj ? kInf : minv[k];
      mi[k] = j;
    }
    // Tree of pairwise minima; the lower slots (lower columns) win ties.
#pragma unroll
    for (int w = 1; w < K; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < K; k += 2 * w) {
        if (mv[k + w] < mv[k]) {
          mv[k] = mv[k + w];
          mi[k] = mi[k + w];
        }
      }
    }
    const float best = mv[0];
    const int bidx = mi[0];
    float delta;
    const int j1 = team_argmin<kBlock>(best, bidx, delta, it & 1, sc);
    const int nxt = st.p[j1];
    done = nxt < 0;
    if (!done) {
      cur = nxt;
      ucur = st.u[nxt];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((onpath >> k) & 1u) u_mine[tm.nt * k] = u_mine[tm.nt * k] + delta;
      if ((used >> k) & 1u) {
        v[k] = v[k] - delta;
      } else {
        minv[k] = minv[k] - delta;
      }
    }
    used |= tm.bit_of(j1);
    jfrom = j1;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!((outside >> k) & 1u)) st.way[tm.col(k)] = way[k];
  }
  tm.sync();
  if (tm.t == 0) {  // unwind the alternating path to the sentinel
    int j0 = jfrom;
    for (int it = 0; j0 < s && it < max_iters; ++it) {
      const int jj = st.way[j0];
      st.p[j0] = jj >= s ? r : st.p[jj];
      j0 = jj;
    }
  }
  tm.sync();
}

// How a batch of problems of width s is launched: one block per problem,
// of one warp up to kWarpMaxCols columns.
struct Plan {
  bool block;   // the block-wide loop (s > kWarpMaxCols), else one warp
  int k;        // columns a thread owns
  int threads;  // threads per block
};

// Returns false if s is out of range.
inline bool make_plan(int s, Plan* pl) {
  if (s < 1 || s > kMaxS) return false;
  pl->block = s > kWarpMaxCols;
  pl->k = pl->block ? kMaxCols : (s + 31) / 32;
  pl->threads = pl->block ? (s + kMaxCols - 1) / kMaxCols : 32;
  pl->threads = (pl->threads + 31) / 32 * 32;
  return true;
}

// Words rounded up to whole 16-byte groups, so every problem's region and
// every staged matrix starts 16-byte aligned.
__host__ __device__ constexpr int round4(int words) {
  return (words + 3) & ~3;
}

// Launches kernel<<<plan>>> with `smem` bytes of dynamic shared memory,
// raising the kernel's limit first where it needs more than 48 KB.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, const Plan& pl, int batch, int smem,
                  cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, pl.threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lap
