// K1 and K2: the association cascade's three chained thresholded LAPs in one
// launch, for one stream (K1) or B streams (K2, one block per stream).
//
// Replaces the TPU kernels botsort_tpu/ops/assignment_pallas.py::
// _cascade_kernel (K1, entered through cascade_solve_pallas) and
// _cascade_kernel_ls (K2, the lockstep kernel that jax.vmap over the
// multi-stream cascade reaches). The lockstep layout exists because one
// TensorCore runs grid steps in order; here the B blocks run at once on B of
// the 132 SMs, so a batch takes as long as its slowest stream without it.
// Each stream keeps its own `big` (the grid kernel's semantics; the lockstep
// kernel's shared maximum gives the same matchings). Semantics are those of
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
// (B = 1) occupies one SM and leaves 131 idle; a B-stream step (K2) keeps B
// of them busy in the same time. The TPU kernel's column
// reduction, leftover pairing and post-reduction resolve, which cut the pop
// count, are not ported yet.
//
// Layout: costs [B,3,N,D] f32; masks [B, 3N+3D] i32 = pool[N], tracked[N],
// unconf[N], high1[D], high3[D], low[D] (already feasibility pre-parked);
// big [B] f32 -> cfr [B,3,N], rfc [B,3,D] i32 (-1 = unmatched). The solver
// loop itself is lap_common.cuh's, shared with K3 (jv_lap.cu).

#include "lap_common.cuh"

namespace {

// Entry (r, j) of one pass's extended matrix, built on the fly from the
// row class.
struct CascadeExt {
  const float* cost;
  const int* rv;
  const int* cv;
  int n, d;
  float half, big;
  __device__ __forceinline__ float operator()(int r, int j) const {
    if (r < n) {
      if (rv[r]) return j < d ? (cv[j] ? cost[r * d + j] : big) : half;
      return j < d ? big : 0.0f;  // parked real row
    }
    return j < d ? (cv[j] ? half : 0.0f) : 0.0f;  // dummy row
  }
};

__global__ void cascade_lap_kernel(const float* __restrict__ costs,
                                   const int* __restrict__ masks,
                                   const float* __restrict__ bigs,
                                   int* __restrict__ cfr_out,
                                   int* __restrict__ rfc_out, int n, int d,
                                   float h0, float h1, float h2,
                                   int max_iters) {
  extern __shared__ int smem[];
  __shared__ lap::ArgminScratch sc;
  const int s = n + d;
  lap::JvState st;
  int* rv = lap::carve_state(smem, s, st);  // [n] live real rows of a pass
  int* cv = rv + n;         // [d] live real cols of this pass
  int* m1 = cv + d;         // pass-1 result: cfr [n], rfc [d]

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
      st.p[j] = j < d ? (cv[j] ? -1 : n + j) : (rv[j - d] ? -1 : j - d);
      st.u[j] = 0.0f;
      st.v[j] = 0.0f;
    }
    __syncthreads();

    const CascadeExt ext{cost, rv, cv, n, d, half, big};
    for (int r = 0; r < s; ++r) {
      if (!(r < n ? rv[r] : cv[r - n])) continue;  // uniform: shared flags
      lap::augment(r, s, ext, st, max_iters, sc);
    }

    // Extraction: rfc[j] = owning live real row; cfr is its inverse.
    int* cfr_b = cfr_out + (static_cast<size_t>(b) * 3 + pass) * n;
    int* rfc_b = rfc_out + (static_cast<size_t>(b) * 3 + pass) * d;
    for (int i = tid; i < n; i += nt) st.onpath[i] = -1;
    __syncthreads();
    for (int j = tid; j < d; j += nt) {
      const int o = st.p[j];
      const int row = (cv[j] && o >= 0 && o < n && rv[o]) ? o : -1;
      rfc_b[j] = row;
      if (row >= 0) st.onpath[row] = j;
      if (pass == 0) m1[n + j] = row;
    }
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
      cfr_b[i] = st.onpath[i];
      if (pass == 0) m1[i] = st.onpath[i];
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
  const int smem = cascade_lap_smem_bytes(n, d);
  int threads = 0;
  const int err = lap::launch_shape(cascade_lap_kernel, n + d, smem, &threads);
  if (err != 0) return err;
  // One block per problem: K1 at batch 1, K2 (B streams at once) above.
  cascade_lap_kernel<<<batch, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      costs, masks, big, cfr, rfc, n, d, half0, half1, half2, max_iters);
  return static_cast<int>(cudaGetLastError());
}
