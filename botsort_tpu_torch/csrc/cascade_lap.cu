// K1 and K2: the association cascade's three chained thresholded LAPs in one
// launch, for one stream (K1) or B streams (K2, one warp per stream).
//
// Replaces the TPU kernels botsort_tpu/ops/assignment_pallas.py::
// _cascade_kernel (K1, entered through cascade_solve_pallas) and
// _cascade_kernel_ls (K2, the lockstep kernel that jax.vmap over the
// multi-stream cascade reaches), and computes what they compute, step for
// step: the same matchings, ties included. The lockstep layout exists
// because one TensorCore runs grid steps in order; here the B streams' warps
// run at once, so a batch takes as long as its slowest stream without it.
// Each stream keeps its own `big` (the grid kernel's semantics); `big` only
// fills the parked entries of the Dijkstra rows, so the lockstep kernel's
// shared maximum gives the same matchings.
//
// Each pass solves lap.lapjv's extend_cost/cost_limit problem, the
// (N+D) x (N+D) extended matrix
//
//     [ C            L/2 ]        rows 0..N-1 real, N+j dummy of column j
//     [ L/2          0   ]        cols 0..D-1 real, D+i escape of row i
//
// in the TPU kernel's order: designated parking at zero duals (parked row i
// owns escape D+i, dummy row N+j owns parked column j); the LAPJV column
// reduction (a live column goes to its lowest minimum live row if that
// minimum is below L/2, else to its dummy row; a row keeps its lowest
// column; v = min(column minimum, L/2)); the won columns' dummy rows paired
// by rank with the escape columns; _post_reduction_resolve's three steps
// (rows whose least reduced cost is >= L/2 take a free escape by rank at
// u = L/2; two rounds in which a row whose least reduced cost lies on a free
// column claims it, the lowest row winning, at u = that cost; the dummy
// rows left paired by rank with the free escapes); then a Dijkstra
// augmentation (lap_common.cuh, shared with K3) of each row still
// unassigned, real rows then dummy rows, from those duals. Pass 2's row mask
// (tracked & pass-1 unmatched) and pass 3's column mask (high & pass-1
// unmatched) are derived here from pass 1's result. The plain PyTorch
// version (ops/assignment.py::cascade_solve_plain) runs the same float32
// operations in the same order, so the two agree exactly: build with
// --fmad=false. The TPU kernel pads lanes to a multiple of 128 with pad
// rows and columns paired diagonally at 1e9; no pad lane ever wins a
// minimum, an argmin or a rank, so the port works at S = N + D.
//
// What bounds it on the card: neither bytes nor FLOPs but the latency of
// the sequential pop chain (one Dijkstra pop per step; how many depends on
// the data: the reduction and the resolve leave none on coherent costs).
// The design shortens each pop: up to N+D = 256 one warp owns a stream,
// with its column state in registers, a warp-reduction argmin and no
// barrier (lap_common.cuh), and each pass's N x D costs are staged in
// shared memory once with 16-byte loads (12.8 KB at 64 x 50), so the
// on-the-fly extended row reads shared memory. The steps before the pops
// are simple loops of the team over columns or rows of the staged costs:
// a thread a column for the column minima (ascending rows, so the lowest
// row wins a tie) and the claims, a thread a row for the row minima and
// the free-column minima (ascending columns); the rank pairings and the
// list of rows to augment are ballot-and-popcount prefixes taken by the
// team's first warp. No atomics. A K2 batch is B blocks of one warp each; a
// batch takes as long as its slowest stream. Above N+D = 256 one block
// takes a stream, reading costs that do not fit through the read-only path.
//
// Layout: costs [B,3,N,D] f32; masks [B, 3N+3D] i32 = pool[N], tracked[N],
// unconf[N], high1[D], high3[D], low[D] (already feasibility pre-parked);
// big [B] f32 -> cfr [B,3,N], rfc [B,3,D] i32 (-1 = unmatched). Shared
// memory per stream: the staged pass costs (if staged), the pass's row and
// column masks, pass 1's result, u, p and way (way doubles as the resolve's
// scratch), q (each row's column), the column duals before the pops (then
// the list of rows to augment) and the row minima.

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
                     (4 + lap::kRowWords) * (n + d) + n);
}

// The team's first warp lists the indices i < len with pred(i) in
// ascending order: emit(k, i) for the k-th of them, by the lane that found
// it, once the warp has evaluated pred on the chunk of 32. Returns the count
// to every thread of the team through *count (a slot of its own per call
// site, so no thread can still be reading it when it is next written).
template <bool kBlock, class Pred, class Emit>
__device__ __forceinline__ int compact(int len, Pred pred, Emit emit,
                                       int* count,
                                       const lap::Team<kBlock>& tm) {
  if (tm.t < 32) {
    const unsigned below = (1u << tm.t) - 1u;
    int base = 0;
    for (int c = 0; c < len; c += 32) {
      const int i = c + tm.t;
      const bool f = i < len && pred(i);
      const unsigned m = __ballot_sync(lap::kFull, f);
      if (f) emit(base + __popc(m & below), i);
      base += __popc(m);
    }
    if (tm.t == 0) *count = base;
  }
  tm.sync();
  return *count;
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
  __shared__ int counts[7];  // compact's slots
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
  int* q = lap::carve_rows(m1 + s, s, st);  // [s] column of each row
  float* vs = reinterpret_cast<float*>(q + s);  // [s] column duals
  int* order = q + s;                           // [s] rows to augment
  float* rowmin = vs + s;  // [n] least reduced cost over live columns
  int* list = st.way;      // the resolve's scratch, [s]

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
    const float* c = kStaged ? staged : cost;
    auto cost_at = [&](int i, int j) {
      return kStaged ? c[i * d + j] : __ldg(c + i * d + j);
    };

    // Column reduction: each live column's lowest minimum live row claims
    // it if that minimum is below half (list[j], -1 if none); v = min(colmin,
    // half) on live columns. The dummy row of a column not claimed owns it.
    // Parking of the other rows and columns at zero duals.
    for (int j = tm.t; j < d; j += tm.nt) {
      float cmin = lap::kInf;
      int arg = 0;
      if (cv[j]) {
        for (int i = 0; i < n; ++i) {
          if (!rv[i]) continue;
          const float x = cost_at(i, j);
          if (x < cmin) {
            cmin = x;
            arg = i;
          }
        }
      }
      const bool claim = cv[j] && cmin < half;
      vs[j] = cv[j] ? fminf(cmin, half) : 0.0f;
      list[j] = claim ? arg : -1;
      q[n + j] = claim ? -1 : j;
    }
    for (int i = tm.t; i < n; i += tm.nt) {
      q[i] = rv[i] ? -1 : d + i;
      st.p[d + i] = rv[i] ? -1 : i;
      vs[d + i] = 0.0f;
    }
    for (int r = tm.t; r < s; r += tm.nt) st.u[r] = 0.0f;
    tm.sync();
    // A row keeps its lowest claimed column.
    for (int i = tm.t; i < n; i += tm.nt) {
      if (!rv[i]) continue;
      for (int j = 0; j < d; ++j) {
        if (list[j] == i) {
          q[i] = j;
          break;
        }
      }
    }
    tm.sync();
    for (int j = tm.t; j < d; j += tm.nt) {
      const int r = list[j];
      st.p[j] = r < 0 ? n + j : (q[r] == j ? r : -1);
    }
    tm.sync();
    // The won columns' dummy rows take the live rows' escapes, by rank.
    const int n_won = compact(
        d, [&](int j) { return st.p[j] >= 0 && st.p[j] < n; },
        [&](int k, int j) { list[k] = j; }, &counts[0], tm);
    compact(
        n, [&](int i) { return rv[i] != 0; },
        [&](int k, int i) {
          if (k < n_won) {
            q[n + list[k]] = d + i;
            st.p[d + i] = n + list[k];
          }
        },
        &counts[1], tm);

    // (a) The escape fast path: an unassigned live row whose least reduced
    // cost over the live columns is >= half takes a free escape, by rank,
    // at u = half.
    for (int i = tm.t; i < n; i += tm.nt) {
      float m = lap::kInf;
      if (rv[i]) {
        for (int j = 0; j < d; ++j) {
          if (cv[j]) m = fminf(m, __fsub_rn(cost_at(i, j), vs[j]));
        }
      }
      rowmin[i] = m;
    }
    tm.sync();
    const int n_qual = compact(
        n, [&](int i) { return rv[i] && q[i] < 0 && rowmin[i] >= half; },
        [&](int k, int i) { list[k] = i; }, &counts[2], tm);
    compact(
        n, [&](int i) { return rv[i] && st.p[d + i] < 0; },
        [&](int k, int i) {
          if (k < n_qual) {
            const int r = list[k];
            q[r] = d + i;
            st.p[d + i] = r;
            st.u[r] = half;
          }
        },
        &counts[3], tm);

    // (b) Two rounds of free-column claims: an unassigned live row whose
    // least reduced cost (at most half) lies on a free live column claims
    // the lowest such column; the lowest claiming row wins it, at
    // u = rowmin.
    for (int round = 0; round < 2; ++round) {
      for (int i = tm.t; i < n; i += tm.nt) {
        int claim = -1;
        if (rv[i] && q[i] < 0) {
          float fmin = lap::kInf;
          int arg = -1;
          for (int j = 0; j < d; ++j) {
            if (!cv[j] || st.p[j] >= 0) continue;
            const float red = __fsub_rn(cost_at(i, j), vs[j]);
            if (red < fmin) {
              fmin = red;
              arg = j;
            }
          }
          if (fmin <= rowmin[i] && fmin <= half) claim = arg;
        }
        list[i] = claim;
      }
      tm.sync();
      for (int j = tm.t; j < d; j += tm.nt) {
        for (int i = 0; i < n; ++i) {
          if (list[i] == j) {
            st.p[j] = i;
            q[i] = j;
            st.u[i] = rowmin[i];
            break;
          }
        }
      }
      tm.sync();
    }

    // (c) The dummy rows still unassigned take the free escapes, by rank.
    const int n_dummy = compact(
        d, [&](int j) { return cv[j] && q[n + j] < 0; },
        [&](int k, int j) { list[k] = j; }, &counts[4], tm);
    compact(
        n, [&](int i) { return rv[i] && st.p[d + i] < 0; },
        [&](int k, int i) {
          if (k < n_dummy) {
            q[n + list[k]] = d + i;
            st.p[d + i] = n + list[k];
          }
        },
        &counts[5], tm);

    // The column duals into registers, then the rows still unassigned,
    // real then dummy, in ascending order (over the duals' words).
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tm.col(k);
      v[k] = j < s ? vs[j] : 0.0f;
    }
    tm.sync();
    const int n_active = compact(
        s, [&](int r) { return (r < n ? rv[r] : cv[r - n]) && q[r] < 0; },
        [&](int k, int r) { order[k] = r; }, &counts[6], tm);

    unsigned real = 0, live = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tm.col(k);
      if (j < d) {
        real |= 1u << k;
        if (cv[j]) live |= 1u << k;
      }
    }
    const CascadeExt<kStaged> ext{c, rv, n, d, half, big, real, live};
    for (int k = 0; k < n_active; ++k) {
      lap::augment<K, kBlock>(order[k], s, ext, v, st, max_iters, &sc);
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
