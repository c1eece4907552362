// K9: the device-side predicate of the frame step's bucket switch, and the
// CUDA graph that holds the switch's branches as conditional nodes.
//
// A kernel of the port alone: no Pallas kernel stands behind it. With
// PipelineConfig.host_bucket_dispatch=False the JAX frame step picks each
// encoder's batch on the device, ``lax.switch`` on the live body count
// (botsort_tpu/pipeline/frame_step.py:165, :723; ``lax.cond`` where the
// padded width is one chunk): nothing, the first ``max_reid_batch`` slots
// or the full padded width. The port captures the step in segments
// (pipeline/graphed.py): the work before a switch, one graph per branch,
// the work after it. This file assembles them into one parent graph:
//
//   segment -> K9 -> IF(branch 1) -> IF(branch 2) -> segment -> ...
//
// where each segment and each branch is a child-graph node (the branch's
// inside the IF node's body graph), and K9 is a one-thread kernel node of
// the parent that reads the live count the previous segment left on the
// device and sets each IF node's conditional handle with
// cudaGraphSetConditional: value in (lo, hi] runs that branch. Untaken
// branches do not run at all (the TPU's untaken lax.switch branch cost
// nearly its full time). IF nodes need CUDA 12.3; every node runs after
// the one before it, in capture order, because the segments share one
// memory pool (a later segment may reuse an earlier one's scratch).
//
// What bounds K9: nothing but its launch: it reads 4 bytes and writes one
// handle per branch. Its plain version is pipeline/switch.py::
// branch_flags_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBranches = 4;

struct Branches {
  cudaGraphConditionalHandle handle[kMaxBranches];
  int lo[kMaxBranches];
  int hi[kMaxBranches];
  int n;
};

__global__ void set_conditionals_kernel(const int* __restrict__ value,
                                        Branches b) {
  const int v = *value;
  for (int k = 0; k < b.n; ++k)
    cudaGraphSetConditional(b.handle[k],
                            (v > b.lo[k] && v <= b.hi[k]) ? 1u : 0u);
}

// Adds a child-graph node running `child` (cloned) after *last, or as the
// graph's first node where *last is null; *last becomes the new node.
int add_child(cudaGraph_t graph, cudaGraphNode_t* last, cudaGraph_t child) {
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddChildGraphNode(
      &node, graph, *last ? last : nullptr, *last ? 1 : 0, child);
  if (err != cudaSuccess) return static_cast<int>(err);
  *last = node;
  return 0;
}

}  // namespace

extern "C" int graph_cond_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(driver);
  return static_cast<int>(err);
}

extern "C" int graph_cond_create(void** graph) {
  return static_cast<int>(
      cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0));
}

// add_child on the parent graph.
extern "C" int graph_cond_add_segment(void* graph, void** last,
                                      void* child) {
  return add_child(static_cast<cudaGraph_t>(graph),
                   reinterpret_cast<cudaGraphNode_t*>(last),
                   static_cast<cudaGraph_t>(child));
}

// Appends K9 and one IF node per branch after `*last`: branch k (body
// graph bodies[k], cloned) runs where lo[k] < *value <= hi[k], value an
// int32 in device memory that an earlier node writes.
extern "C" int graph_cond_add_switch(void* graph, void** last,
                                     const void* value, int n,
                                     const int* lo, const int* hi,
                                     void* const* bodies) {
  if (n < 1 || n > kMaxBranches)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphNode_t* prev = reinterpret_cast<cudaGraphNode_t*>(last);
  Branches b = {};
  b.n = n;
  for (int k = 0; k < n; ++k) {
    const cudaError_t err = cudaGraphConditionalHandleCreate(
        &b.handle[k], g, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return static_cast<int>(err);
    b.lo[k] = lo[k];
    b.hi[k] = hi[k];
  }
  const int* value_ptr = static_cast<const int*>(value);
  void* args[] = {&value_ptr, &b};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_conditionals_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, g, *prev ? prev : nullptr,
                                           *prev ? 1 : 0, &kp);
  if (err != cudaSuccess) return static_cast<int>(err);
  *prev = node;
  for (int k = 0; k < n; ++k) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = b.handle[k];
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&node, g, prev, 1, &cp);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphNode_t inner = nullptr;
    const int rc = add_child(cp.conditional.phGraph_out[0], &inner,
                             static_cast<cudaGraph_t>(bodies[k]));
    if (rc != 0) return rc;
    *prev = node;
  }
  return 0;
}

extern "C" int graph_cond_instantiate(void* graph, void** exec) {
  cudaGraphExec_t e = nullptr;
  const cudaError_t err =
      cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph), 0);
  *exec = e;
  return static_cast<int>(err);
}

extern "C" int graph_cond_launch(void* exec, cudaStream_t stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream));
}

extern "C" int graph_cond_destroy(void* exec, void* graph) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}
