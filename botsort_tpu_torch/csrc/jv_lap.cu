// K3: one exact Jonker-Volgenant solve of a materialised square extended
// assignment problem per problem of a batch.
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
// What bounds it on the card: the latency of the sequential pop chain, as in
// K1 (about 3,500 pops per S = 114 problem on chip_smoke's inputs). The
// design shortens each pop: up to S = 256 one warp owns a problem, with its
// column state in registers and a warp-reduction argmin (lap_common.cuh),
// and the
// whole S x S matrix is staged in shared memory once with 16-byte loads
// (52 KB at S = 114), so a pop's relax reads shared memory instead of L2.
// A matrix too large to stage is read through the read-only path; above
// S = 256 one block takes a problem. The TPU kernel pads S to 128 lanes, a
// Mosaic tiling rule; here S is the problem's own width.
//
// Layout: ext [B,S,S] f32; p0 [B,S] i32; live_order [B,S] i32 (ascending
// live rows, then the sentinel S); n_live [B] i32 -> owner [B,S] i32.
// Shared memory per problem: the staged matrix (if staged), then u, p, way.

#include "lap_common.cuh"

namespace {

template <bool kStaged>
struct DenseExt {
  static constexpr bool kGuarded = true;  // an entry is one load
  const float* ext;  // shared memory if staged, else device memory
  int s;
  struct Row {
    const float* e;
    int last;  // s - 1: in device memory, slots past the row read its end
    __device__ __forceinline__ float operator()(int, int j) const {
      // Staged, a slot past the row reads the next row or the padding.
      return kStaged ? e[j] : __ldg(e + min(j, last));
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return Row{ext + static_cast<size_t>(r) * s, s - 1};
  }
};

int problem_words(int s, bool staged) {
  return lap::round4((staged ? lap::round4(s * s) + lap::kPad : 0) +
                     lap::kRowWords * s);
}

template <int K, bool kBlock, bool kStaged>
__global__ void __launch_bounds__(kBlock ? 1024 : 32)
    jv_lap_kernel(const float* __restrict__ ext, const int* __restrict__ p0,
                  const int* __restrict__ live_order,
                  const int* __restrict__ n_live, int* __restrict__ owner,
                  int s, int max_iters) {
  extern __shared__ __align__(16) int smem[];
  __shared__ lap::ArgminScratch sc;
  const lap::Team<kBlock> tm;
  const int b = blockIdx.x;
  int* mine = smem;
  const size_t row0 = static_cast<size_t>(b) * s;
  const float* src = ext + row0 * s;
  const float* e = src;
  if (kStaged) {
    float* staged = reinterpret_cast<float*>(mine);
    lap::stage(staged, src, s * s, tm);
    e = staged;
    mine += lap::round4(s * s) + lap::kPad;
  }
  lap::RowState st;
  lap::carve_rows(mine, s, st);
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0f;
  for (int j = tm.t; j < s; j += tm.nt) {
    st.p[j] = p0[row0 + j];
    st.u[j] = 0.0f;
  }
  tm.sync();

  const DenseExt<kStaged> de{e, s};
  const int live = n_live[b];
  for (int k = 0; k < live; ++k) {
    lap::augment<K, kBlock>(live_order[row0 + k], s, de, v, st, max_iters,
                            &sc);
  }
  for (int j = tm.t; j < s; j += tm.nt) owner[row0 + j] = st.p[j];
}

// Whether a warp-mode problem's matrix fits in shared memory with the rest
// of its state, and the shared bytes of a launch.
bool staged_for(const lap::Plan& pl, int s) {
  return !pl.block && 4LL * problem_words(s, true) <= lap::kDynSmemLimit;
}

int smem_for(const lap::Plan& pl, int s) {
  return 4 * problem_words(s, staged_for(pl, s));
}

template <int K, bool kBlock, bool kStaged>
int run(const lap::Plan& pl, int batch, int smem, cudaStream_t stream,
        const float* ext, const int* p0, const int* live_order,
        const int* n_live, int* owner, int s, int max_iters) {
  return lap::launch(jv_lap_kernel<K, kBlock, kStaged>, pl, batch, smem,
                     stream, ext, p0, live_order, n_live, owner, s,
                     max_iters);
}

}  // namespace

// Shared bytes a launch asks for; -1 if S is out of range.
extern "C" int jv_lap_smem_bytes(int s) {
  lap::Plan pl;
  return lap::make_plan(s, &pl) ? smem_for(pl, s) : -1;
}

extern "C" int jv_lap_launch(const float* ext, const int* p0,
                             const int* live_order, const int* n_live,
                             int* owner, int batch, int s, int max_iters,
                             void* stream) {
  lap::Plan pl;
  if (batch < 1 || !lap::make_plan(s, &pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_for(pl, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define JV_ARGS pl, batch, smem, st, ext, p0, live_order, n_live, owner, s, \
                max_iters
  if (pl.block) return run<lap::kMaxCols, true, false>(JV_ARGS);
  if (!staged_for(pl, s)) return run<lap::kMaxCols, false, false>(JV_ARGS);
  switch (pl.k) {
    case 1: return run<1, false, true>(JV_ARGS);
    case 2: return run<2, false, true>(JV_ARGS);
    case 3: return run<3, false, true>(JV_ARGS);
    case 4: return run<4, false, true>(JV_ARGS);
    case 5: return run<5, false, true>(JV_ARGS);
    case 6: return run<6, false, true>(JV_ARGS);
    case 7: return run<7, false, true>(JV_ARGS);
    default: return run<8, false, true>(JV_ARGS);
  }
#undef JV_ARGS
}
