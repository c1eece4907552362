// K3: one exact Jonker-Volgenant solve of a materialised square extended
// assignment problem, one block per problem.
//
// Replaces the TPU kernel botsort_tpu/ops/assignment_pallas.py::_jv_kernel
// (entered through jv_solve_pallas, which botsort_tpu/ops/assignment.py::
// solve_masked calls on the TPU). Semantics: the columns start owned as p0
// says (parked rows pre-matched to their designated columns at zero duals,
// -1 = free); the first n_live entries of live_order are augmented in that
// order, each by a shortest augmenting path with dual potentials
// (lap_common.cuh::augment, the same loop K1 and K2 run); the result is the
// owner row of every column. The plain PyTorch version is
// ops/assignment.py::jv_solve_plain: it performs the same float32 operations
// in the same order, so the two agree exactly (build with --fmad=false).
//
// What bounds it on the card: the sequential pop chain, as in K1 — each pop
// is one coalesced read of an ext row (L2-resident: 52 KB per problem at
// S = 114), a block-wide relax and argmin, and three __syncthreads. The TPU
// kernel pads S to 128 lanes, a Mosaic tiling rule; here S is the problem's
// own width and the block is S threads rounded up to whole warps.
//
// Layout: ext [B,S,S] f32; p0 [B,S] i32; live_order [B,S] i32 (ascending
// live rows, then the sentinel S); n_live [B] i32 -> owner [B,S] i32.
// Shared memory: seven S-word vectors (minv, u, v, way, used, onpath, p).

#include "lap_common.cuh"

namespace {

struct DenseExt {
  const float* ext;
  int s;
  __device__ __forceinline__ float operator()(int r, int j) const {
    return ext[static_cast<size_t>(r) * s + j];
  }
};

__global__ void jv_lap_kernel(const float* __restrict__ ext,
                              const int* __restrict__ p0,
                              const int* __restrict__ live_order,
                              const int* __restrict__ n_live,
                              int* __restrict__ owner, int s, int max_iters) {
  extern __shared__ int smem[];
  __shared__ lap::ArgminScratch sc;
  lap::JvState st;
  lap::carve_state(smem, s, st);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const size_t row0 = static_cast<size_t>(b) * s;
  for (int j = tid; j < s; j += nt) {
    st.p[j] = p0[row0 + j];
    st.u[j] = 0.0f;
    st.v[j] = 0.0f;
  }
  __syncthreads();

  const DenseExt e{ext + row0 * s, s};
  const int live = n_live[b];
  for (int k = 0; k < live; ++k) {
    lap::augment(live_order[row0 + k], s, e, st, max_iters, sc);
  }
  for (int j = tid; j < s; j += nt) owner[row0 + j] = st.p[j];
}

}  // namespace

extern "C" int jv_lap_smem_bytes(int s) {
  return static_cast<int>(sizeof(int)) * (7 * s);
}

extern "C" int jv_lap_launch(const float* ext, const int* p0,
                             const int* live_order, const int* n_live,
                             int* owner, int batch, int s, int max_iters,
                             void* stream) {
  const int smem = jv_lap_smem_bytes(s);
  int threads = 0;
  const int err = lap::launch_shape(jv_lap_kernel, s, smem, &threads);
  if (err != 0) return err;
  jv_lap_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ext, p0, live_order, n_live, owner, s, max_iters);
  return static_cast<int>(cudaGetLastError());
}
