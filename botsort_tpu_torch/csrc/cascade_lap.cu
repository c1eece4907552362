// K1: the association cascade's three chained thresholded LAPs in one launch.
//
// Replaces the TPU kernel botsort_tpu/ops/assignment_pallas.py::_cascade_kernel
// (entered through cascade_solve_pallas). Semantics are those of
// botsort_tpu/ops/assignment.py::solve_cascade_masked: three lap.lapjv
// extend_cost/cost_limit solves, each an exact Jonker-Volgenant
// shortest-augmenting-path solve of the (N+D) x (N+D) extended problem
//
//     [ C            L/2 ]        rows 0..N-1 real, N..N+D-1 dummy
//     [ L/2          0   ]        cols 0..D-1 real, D..D+N-1 dummy
//
// with invalid rows/cols pre-matched to designated dummies (row i owns
// dummy col D+i, dummy row N+j owns col j) and the live rows augmented in
// ascending index order. Pass 2's row mask (tracked & pass-1 unmatched) and
// pass 3's column mask (high & pass-1 unmatched) are derived here from pass
// 1's result. The plain PyTorch version (ops/assignment.py::
// cascade_solve_plain) runs the same float32 operations in the same order,
// so the two agree exactly: build with --fmad=false.
//
// What bounds it on the card: neither bytes nor FLOPs. Every Dijkstra pop is
// a block-wide relax over one extended row (one coalesced cost-row read,
// L2-resident), one block argmin (warp shuffles, then across warps in
// shared memory) and three __syncthreads — the solve is the latency of that
// sequential pop chain. One block per problem means a single-stream frame
// (B = 1) occupies one SM and leaves 131 idle; the multi-stream port of K2
// runs one block per stream and fills them. The TPU kernel's column
// reduction, leftover pairing and post-reduction resolve, which cut the pop
// count, are not ported yet.
//
// Layout: costs [B,3,N,D] f32; masks [B, 3N+3D] i32 = pool[N], tracked[N],
// unconf[N], high1[D], high3[D], low[D] (already feasibility pre-parked);
// big [B] f32 -> cfr [B,3,N], rfc [B,3,D] i32 (-1 = unmatched).

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr float kInf = 1e30f;  // the reference solver's "unreached" value

__device__ __forceinline__ void take_min(float& val, int& idx, float oval,
                                         int oidx) {
  // Lowest index wins ties, as jnp.argmin / torch.argmin do.
  if (oval < val || (oval == val && oidx < idx)) {
    val = oval;
    idx = oidx;
  }
}

// Block-wide argmin of (val, idx); the result lands in *out_val/*out_idx and
// is visible to every thread on return.
__device__ void block_argmin(float val, int idx, float* wval, int* widx,
                             float* out_val, int* out_idx) {
  for (int off = 16; off > 0; off >>= 1) {
    take_min(val, idx, __shfl_down_sync(0xffffffffu, val, off),
             __shfl_down_sync(0xffffffffu, idx, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    wval[warp] = val;
    widx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    val = lane < nw ? wval[lane] : INFINITY;
    idx = lane < nw ? widx[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      take_min(val, idx, __shfl_down_sync(0xffffffffu, val, off),
               __shfl_down_sync(0xffffffffu, idx, off));
    }
    if (lane == 0) {
      *out_val = val;
      *out_idx = idx;
    }
  }
  __syncthreads();
}

// Entry (r, j) of the extended matrix, built on the fly from the row class.
__device__ __forceinline__ float ext_val(int r, int j, int n, int d,
                                         const float* cost, const int* rv,
                                         const int* cv, float half,
                                         float big) {
  if (r < n) {
    if (rv[r]) return j < d ? (cv[j] ? cost[r * d + j] : big) : half;
    return j < d ? big : 0.0f;  // parked real row
  }
  return j < d ? (cv[j] ? half : 0.0f) : 0.0f;  // dummy row
}

__global__ void cascade_lap_kernel(const float* __restrict__ costs,
                                   const int* __restrict__ masks,
                                   const float* __restrict__ bigs,
                                   int* __restrict__ cfr_out,
                                   int* __restrict__ rfc_out, int n, int d,
                                   float h0, float h1, float h2,
                                   int max_iters) {
  extern __shared__ int smem[];
  const int s = n + d;
  float* minv = reinterpret_cast<float*>(smem);
  float* u = minv + s;      // row duals
  float* v = u + s;         // column duals
  int* way = reinterpret_cast<int*>(v + s);
  int* used = way + s;
  int* onpath = used + s;   // rows whose dual rises this augmentation
  int* p = onpath + s;      // owner row of each column, -1 free
  int* rv = p + s;          // [n] live real rows of this pass
  int* cv = rv + n;         // [d] live real cols of this pass
  int* m1 = cv + d;         // pass-1 result: cfr [n], rfc [d]
  __shared__ float wval[32];
  __shared__ int widx[32];
  __shared__ float s_delta;
  __shared__ int s_j1;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const float* cost_b = costs + static_cast<size_t>(b) * 3 * n * d;
  const int* mask_b = masks + static_cast<size_t>(b) * 3 * s;
  const float big = bigs[b];

  for (int pass = 0; pass < 3; ++pass) {
    const float half = pass == 0 ? h0 : (pass == 1 ? h1 : h2);
    const float* cost = cost_b + static_cast<size_t>(pass) * n * d;
    for (int i = tid; i < n; i += nt) {
      rv[i] = pass == 0   ? mask_b[i]
              : pass == 1 ? (mask_b[n + i] && m1[i] < 0)
                          : mask_b[2 * n + i];
    }
    for (int j = tid; j < d; j += nt) {
      cv[j] = pass == 0   ? mask_b[3 * n + j]
              : pass == 1 ? mask_b[3 * n + 2 * d + j]
                          : (mask_b[3 * n + d + j] && m1[n + j] < 0);
    }
    __syncthreads();
    // Designated parking at zero duals.
    for (int j = tid; j < s; j += nt) {
      p[j] = j < d ? (cv[j] ? -1 : n + j) : (rv[j - d] ? -1 : j - d);
      u[j] = 0.0f;
      v[j] = 0.0f;
    }
    __syncthreads();

    for (int r = 0; r < s; ++r) {
      if (!(r < n ? rv[r] : cv[r - n])) continue;  // uniform: shared flags
      for (int j = tid; j < s; j += nt) {
        minv[j] = kInf;
        way[j] = s;
        used[j] = 0;
        onpath[j] = 0;
      }
      __syncthreads();
      int cur = r;
      int jfrom = s;
      bool done = false;
      for (int it = 0; !done && it < max_iters; ++it) {
        const float ucur = u[cur];
        float best = INFINITY;
        int bidx = INT_MAX;
        for (int j = tid; j < s; j += nt) {
          if (j == cur) onpath[j] = 1;
          if (!used[j]) {
            const float e = ext_val(cur, j, n, d, cost, rv, cv, half, big);
            const float red = (e - ucur) - v[j];
            if (red < minv[j]) {
              minv[j] = red;
              way[j] = jfrom;
            }
          }
          const float m = used[j] ? kInf : minv[j];
          if (m < best) {  // ascending j: first minimum in this thread
            best = m;
            bidx = j;
          }
        }
        block_argmin(best, bidx, wval, widx, &s_delta, &s_j1);
        const float delta = s_delta;
        const int j1 = s_j1;
        for (int j = tid; j < s; j += nt) {
          if (onpath[j]) u[j] = u[j] + delta;
          if (used[j]) {
            v[j] = v[j] - delta;
          } else {
            minv[j] = minv[j] - delta;
          }
        }
        if (j1 % nt == tid) used[j1] = 1;
        const int nxt = p[j1];
        done = nxt < 0;
        if (!done) cur = nxt;
        jfrom = j1;
        __syncthreads();
      }
      if (tid == 0) {  // unwind the alternating path to the sentinel
        int j0 = jfrom;
        for (int it = 0; j0 < s && it < max_iters; ++it) {
          const int jj = way[j0];
          p[j0] = jj >= s ? r : p[jj];
          j0 = jj;
        }
      }
      __syncthreads();
    }

    // Extraction: rfc[j] = owning live real row; cfr is its inverse.
    int* cfr_b = cfr_out + (static_cast<size_t>(b) * 3 + pass) * n;
    int* rfc_b = rfc_out + (static_cast<size_t>(b) * 3 + pass) * d;
    for (int i = tid; i < n; i += nt) onpath[i] = -1;
    __syncthreads();
    for (int j = tid; j < d; j += nt) {
      const int o = p[j];
      const int row = (cv[j] && o >= 0 && o < n && rv[o]) ? o : -1;
      rfc_b[j] = row;
      if (row >= 0) onpath[row] = j;
      if (pass == 0) m1[n + j] = row;
    }
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
      cfr_b[i] = onpath[i];
      if (pass == 0) m1[i] = onpath[i];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int cascade_lap_smem_bytes(int n, int d) {
  return static_cast<int>(sizeof(int)) * (9 * (n + d));
}

extern "C" int cascade_lap_launch(const float* costs, const int* masks,
                                  const float* big, int* cfr, int* rfc,
                                  int batch, int n, int d, float half0,
                                  float half1, float half2, int max_iters,
                                  void* stream) {
  const int s = n + d;
  // One thread per column lane, in whole warps, up to what the kernel's
  // register use allows in one block; past that each thread strides.
  cudaFuncAttributes attr;
  cudaError_t aerr = cudaFuncGetAttributes(&attr, cascade_lap_kernel);
  if (aerr != cudaSuccess) return static_cast<int>(aerr);
  const int cap = attr.maxThreadsPerBlock / 32 * 32;
  int threads = ((s + 31) / 32) * 32;
  if (threads > cap) threads = cap;
  const int smem = cascade_lap_smem_bytes(n, d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cascade_lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cascade_lap_kernel<<<batch, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      costs, masks, big, cfr, rfc, n, d, half0, half1, half2, max_iters);
  return static_cast<int>(cudaGetLastError());
}
