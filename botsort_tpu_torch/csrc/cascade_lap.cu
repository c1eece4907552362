// K1 and K2: the association cascade's three chained thresholded LAPs in one
// launch, for one stream (K1) or B streams (K2, one warp per stream).
//
// Replaces the TPU kernels botsort_tpu/ops/assignment_pallas.py::
// _cascade_kernel (K1, entered through cascade_solve_pallas) and
// _cascade_kernel_ls (K2, the lockstep kernel that jax.vmap over the
// multi-stream cascade reaches). The lockstep layout exists because one
// TensorCore runs grid steps in order; here the B streams' warps run at
// once, so a batch takes as long as its slowest stream without it.
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
// What bounds it on the card: neither bytes nor FLOPs but the latency of
// the sequential pop chain (about 3,300 pops per three-pass solve at N=64,
// D=50 on chip_smoke's inputs). The design shortens each pop: up to
// N+D = 256 one warp owns a stream, with its column state in registers, a
// warp-reduction argmin and no barrier (lap_common.cuh), and each pass's
// N x D costs are staged in shared memory once with 16-byte loads (12.8 KB
// at 64 x 50), so the on-the-fly extended row reads shared memory. A K2
// batch is B blocks of one warp each; a batch takes as long as its slowest
// stream. (Two, four or eight streams a block measured no faster: PERF.md.)
// Above N+D = 256 one block takes a stream, reading costs that do not fit
// through the read-only path. The TPU kernel's column reduction, leftover
// pairing and post-reduction resolve, which cut the pop count, are not
// ported: they change the duals and, at exact ties, the matching.
//
// Layout: costs [B,3,N,D] f32; masks [B, 3N+3D] i32 = pool[N], tracked[N],
// unconf[N], high1[D], high3[D], low[D] (already feasibility pre-parked);
// big [B] f32 -> cfr [B,3,N], rfc [B,3,D] i32 (-1 = unmatched). The solver
// loop itself is lap_common.cuh's, shared with K3 (jv_lap.cu). Shared
// memory per stream: the staged pass costs (if staged), the pass's row and
// column masks, pass 1's result, then u, p, way.

#include "lap_common.cuh"

namespace {

// One pass's extended matrix, built on the fly from the row and column
// classes. real / live: this thread's slots whose column is a real column
// (j < d) / a live real column.
template <bool kStaged>
struct CascadeExt {
  static constexpr bool kGuarded = false;  // an entry is a load and selects
  const float* cost;  // shared memory if staged, else device memory
  const int* rv;
  int n, d;
  float half, big;
  unsigned real, live;
  struct Row {
    const float* c;  // the costs of the row (of row n - 1 for a dummy)
    int last;        // d - 1
    bool read;       // a live real row: its live real columns are costs
    float at_live, at_dead, at_dummy;  // entries that are not costs
    unsigned real, live;
    __device__ __forceinline__ float operator()(int k, int j) const {
      // The cost is loaded whatever the row and column (staged, past the
      // row it reads the next row or the padding; in device memory, a
      // clamped address), so the load need not wait for the row's class.
      const float cost_j = kStaged ? c[j] : __ldg(c + min(j, last));
      const bool is_live = (live >> k) & 1u;
      const float x = read && is_live ? cost_j : at_live;
      return (real >> k) & 1u ? (is_live ? x : at_dead) : at_dummy;
    }
  };
  // Live real row: [cost or big where the column is parked | half];
  // parked real row: [big | 0]; dummy row: [half, 0 where parked | 0].
  __device__ __forceinline__ Row row(int r) const {
    const bool real_row = r < n;
    const bool read = real_row && rv[r];
    return Row{cost + min(r, n - 1) * d, d - 1, read,
               real_row ? big : half, real_row ? big : 0.0f,
               read ? half : 0.0f, real, live};
  }
};

int problem_words(int n, int d, bool staged) {
  return lap::round4((staged ? lap::round4(n * d) + lap::kPad : 0) +
                     2 * (n + d) + lap::kRowWords * (n + d));
}

template <int K, bool kBlock, bool kStaged>
__global__ void __launch_bounds__(kBlock ? 1024 : 32)
    cascade_lap_kernel(const float* __restrict__ costs,
                       const int* __restrict__ masks,
                       const float* __restrict__ bigs,
                       int* __restrict__ cfr_out, int* __restrict__ rfc_out,
                       int n, int d, float h0, float h1, float h2,
                       int max_iters) {
  extern __shared__ __align__(16) int smem[];
  __shared__ lap::ArgminScratch sc;
  const lap::Team<kBlock> tm;
  const int b = blockIdx.x;
  const int s = n + d;
  int* mine = smem;
  float* staged = reinterpret_cast<float*>(mine);
  if (kStaged) mine += lap::round4(n * d) + lap::kPad;
  int* rv = mine;   // [n] live real rows of a pass
  int* cv = rv + n; // [d] live real cols of this pass
  int* m1 = cv + d; // pass-1 result: cfr [n], rfc [d]
  lap::RowState st;
  lap::carve_rows(m1 + s, s, st);

  const float* cost_b = costs + static_cast<size_t>(b) * 3 * n * d;
  const int* mask_b = masks + static_cast<size_t>(b) * 3 * s;
  const float big = bigs[b];
  float v[K];

  for (int pass = 0; pass < 3; ++pass) {
    const float half = pass == 0 ? h0 : (pass == 1 ? h1 : h2);
    const float* cost = cost_b + static_cast<size_t>(pass) * n * d;
    for (int i = tm.t; i < n; i += tm.nt) {
      rv[i] = pass == 0   ? mask_b[i]
              : pass == 1 ? (mask_b[n + i] && m1[i] < 0)
                          : mask_b[2 * n + i];
    }
    for (int j = tm.t; j < d; j += tm.nt) {
      cv[j] = pass == 0   ? mask_b[3 * n + j]
              : pass == 1 ? mask_b[3 * n + 2 * d + j]
                          : (mask_b[3 * n + d + j] && m1[n + j] < 0);
    }
    if (kStaged) lap::stage(staged, cost, n * d, tm);
    tm.sync();
    // Designated parking at zero duals.
    for (int j = tm.t; j < s; j += tm.nt) {
      st.p[j] = j < d ? (cv[j] ? -1 : n + j) : (rv[j - d] ? -1 : j - d);
      st.u[j] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = 0.0f;
    tm.sync();

    unsigned real = 0, live = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tm.col(k);
      if (j < d) {
        real |= 1u << k;
        if (cv[j]) live |= 1u << k;
      }
    }
    const CascadeExt<kStaged> ext{kStaged ? staged : cost, rv, n, d,
                                  half, big, real, live};
    for (int r = 0; r < s; ++r) {
      if (!(r < n ? rv[r] : cv[r - n])) continue;  // uniform: shared flags
      lap::augment<K, kBlock>(r, s, ext, v, st, max_iters, &sc);
    }

    // Extraction: rfc[j] = owning live real row; cfr is its inverse (built
    // in way, free after the last unwind).
    int* cfr_b = cfr_out + (static_cast<size_t>(b) * 3 + pass) * n;
    int* rfc_b = rfc_out + (static_cast<size_t>(b) * 3 + pass) * d;
    for (int i = tm.t; i < n; i += tm.nt) st.way[i] = -1;
    tm.sync();
    for (int j = tm.t; j < d; j += tm.nt) {
      const int o = st.p[j];
      const int row = (cv[j] && o >= 0 && o < n && rv[o]) ? o : -1;
      rfc_b[j] = row;
      if (row >= 0) st.way[row] = j;
      if (pass == 0) m1[n + j] = row;
    }
    tm.sync();
    for (int i = tm.t; i < n; i += tm.nt) {
      cfr_b[i] = st.way[i];
      if (pass == 0) m1[i] = st.way[i];
    }
    tm.sync();
  }
}

// Whether a stream's pass costs fit in shared memory with the rest of its
// state, and the shared bytes of a launch.
bool staged_for(int n, int d) {
  return 4LL * problem_words(n, d, true) <= lap::kDynSmemLimit;
}

int smem_for(int n, int d) {
  return 4 * problem_words(n, d, staged_for(n, d));
}

bool plan_for(int n, int d, lap::Plan* pl) {
  return n >= 1 && d >= 1 && lap::make_plan(n + d, pl);
}

template <int K, bool kBlock, bool kStaged>
int run(const lap::Plan& pl, int batch, int smem, cudaStream_t stream,
        const float* costs, const int* masks, const float* big, int* cfr,
        int* rfc, int n, int d, float h0, float h1, float h2,
        int max_iters) {
  return lap::launch(cascade_lap_kernel<K, kBlock, kStaged>, pl, batch,
                     smem, stream, costs, masks, big, cfr, rfc, n, d, h0, h1,
                     h2, max_iters);
}

}  // namespace

// Shared bytes a launch asks for; -1 if N+D is out of range.
extern "C" int cascade_lap_smem_bytes(int n, int d) {
  lap::Plan pl;
  return plan_for(n, d, &pl) ? smem_for(n, d) : -1;
}

extern "C" int cascade_lap_launch(const float* costs, const int* masks,
                                  const float* big, int* cfr, int* rfc,
                                  int batch, int n, int d, float half0,
                                  float half1, float half2, int max_iters,
                                  void* stream) {
  lap::Plan pl;
  if (batch < 1 || !plan_for(n, d, &pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_for(n, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASCADE_ARGS pl, batch, smem, st, costs, masks, big, cfr, rfc, n, d, \
                     half0, half1, half2, max_iters
  if (pl.block) {
    return staged_for(n, d)
               ? run<lap::kMaxCols, true, true>(CASCADE_ARGS)
               : run<lap::kMaxCols, true, false>(CASCADE_ARGS);
  }
  // Warp mode always stages: N x D <= 128 x 128 floats.
  switch (pl.k) {
    case 1: return run<1, false, true>(CASCADE_ARGS);
    case 2: return run<2, false, true>(CASCADE_ARGS);
    case 3: return run<3, false, true>(CASCADE_ARGS);
    case 4: return run<4, false, true>(CASCADE_ARGS);
    case 5: return run<5, false, true>(CASCADE_ARGS);
    case 6: return run<6, false, true>(CASCADE_ARGS);
    case 7: return run<7, false, true>(CASCADE_ARGS);
    default: return run<8, false, true>(CASCADE_ARGS);
  }
#undef CASCADE_ARGS
}
