// Device helpers shared by the assignment kernels (cascade_lap.cu: K1/K2,
// jv_lap.cu: K3): the block-wide argmin and one Jonker-Volgenant
// shortest-augmenting-path augmentation over shared-memory state.
//
// Every float32 operation here is the one the plain PyTorch version
// (ops/assignment.py::jv_solve_plain) performs, in the same order, so the
// matchings agree exactly: the kernels are built with --fmad=false and the
// argmin breaks ties to the lowest index, as torch.argmin does.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace lap {

constexpr float kInf = 1e30f;  // the reference solver's "unreached" value

__device__ __forceinline__ void take_min(float& val, int& idx, float oval,
                                         int oidx) {
  // Lowest index wins ties, as jnp.argmin / torch.argmin do.
  if (oval < val || (oval == val && oidx < idx)) {
    val = oval;
    idx = oidx;
  }
}

// Shared-memory scratch of one block's argmin.
struct ArgminScratch {
  float wval[32];
  int widx[32];
  float val;
  int idx;
};

// Block-wide argmin of (val, idx); the result lands in sc.val / sc.idx and
// is visible to every thread on return.
__device__ inline void block_argmin(float val, int idx, ArgminScratch& sc) {
  for (int off = 16; off > 0; off >>= 1) {
    take_min(val, idx, __shfl_down_sync(0xffffffffu, val, off),
             __shfl_down_sync(0xffffffffu, idx, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sc.wval[warp] = val;
    sc.widx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    val = lane < nw ? sc.wval[lane] : INFINITY;
    idx = lane < nw ? sc.widx[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      take_min(val, idx, __shfl_down_sync(0xffffffffu, val, off),
               __shfl_down_sync(0xffffffffu, idx, off));
    }
    if (lane == 0) {
      sc.val = val;
      sc.idx = idx;
    }
  }
  __syncthreads();
}

// The solver's S-word vectors in shared memory.
struct JvState {
  float* minv;
  float* u;       // row duals
  float* v;       // column duals
  int* way;
  int* used;
  int* onpath;    // rows whose dual rises this augmentation
  int* p;         // owner row of each column, -1 free
};

// Carves the seven vectors out of `smem` (7 * s words); returns the first
// word after them.
__device__ inline int* carve_state(int* smem, int s, JvState& st) {
  st.minv = reinterpret_cast<float*>(smem);
  st.u = st.minv + s;
  st.v = st.u + s;
  st.way = reinterpret_cast<int*>(st.v + s);
  st.used = st.way + s;
  st.onpath = st.used + s;
  st.p = st.onpath + s;
  return st.p + s;
}

// Augments live row r of the s x s extended problem: Dijkstra over the
// columns from r with dual updates until a free column is reached, then
// thread 0 unwinds the alternating path. ext(row, j) gives the extended
// entry. Every thread of the block calls it with the same arguments.
template <class Ext>
__device__ void augment(int r, int s, const Ext& ext, const JvState& st,
                        int max_iters, ArgminScratch& sc) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j = tid; j < s; j += nt) {
    st.minv[j] = kInf;
    st.way[j] = s;
    st.used[j] = 0;
    st.onpath[j] = 0;
  }
  __syncthreads();
  int cur = r;
  int jfrom = s;
  bool done = false;
  for (int it = 0; !done && it < max_iters; ++it) {
    const float ucur = st.u[cur];
    float best = INFINITY;
    int bidx = INT_MAX;
    for (int j = tid; j < s; j += nt) {
      if (j == cur) st.onpath[j] = 1;
      if (!st.used[j]) {
        const float red = (ext(cur, j) - ucur) - st.v[j];
        if (red < st.minv[j]) {
          st.minv[j] = red;
          st.way[j] = jfrom;
        }
      }
      const float m = st.used[j] ? kInf : st.minv[j];
      if (m < best) {  // ascending j: first minimum in this thread
        best = m;
        bidx = j;
      }
    }
    block_argmin(best, bidx, sc);
    const float delta = sc.val;
    const int j1 = sc.idx;
    for (int j = tid; j < s; j += nt) {
      if (st.onpath[j]) st.u[j] = st.u[j] + delta;
      if (st.used[j]) {
        st.v[j] = st.v[j] - delta;
      } else {
        st.minv[j] = st.minv[j] - delta;
      }
    }
    if (j1 % nt == tid) st.used[j1] = 1;
    const int nxt = st.p[j1];
    done = nxt < 0;
    if (!done) cur = nxt;
    jfrom = j1;
    __syncthreads();
  }
  if (tid == 0) {  // unwind the alternating path to the sentinel
    int j0 = jfrom;
    for (int it = 0; j0 < s && it < max_iters; ++it) {
      const int jj = st.way[j0];
      st.p[j0] = jj >= s ? r : st.p[jj];
      j0 = jj;
    }
  }
  __syncthreads();
}

// Threads for a block over s columns: whole warps, one per column lane, up
// to what the kernel's register use allows in one block (past that each
// thread strides). Returns a CUDA error code (0 on success) and sets
// *threads; raises the dynamic shared-memory limit when smem needs it.
template <class Kernel>
inline int launch_shape(Kernel kernel, int s, int smem, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap = attr.maxThreadsPerBlock / 32 * 32;
  int t = ((s + 31) / 32) * 32;
  *threads = t > cap ? cap : t;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace lap
