// spt_graph: one CUDA graph a frame, with the frame's conditionals on the
// device.
//
// Not a counterpart of a TPU kernel: the counterpart of what XLA does for
// the JAX package's jitted k-frame step (spt_tpu/engine/renderer.py:
// 36-66, 136-150), whose lax.cond (the sorted mesh frame's condense
// decision, spt_tpu/integrators/wavefront.py:615) and lax.while_loop (the
// compact path's bounces and chunks, :224-258; path regeneration,
// :868-905) never leave the device.  The port captures the frame in
// segments with PyTorch (each a torch.cuda.CUDAGraph kept as a
// cudaGraph_t) and these entries put the segments together: as child
// graph nodes in sequence, or inside the body of a conditional node (IF
// for a branch, WHILE for a loop), each conditional preceded by
// set_cond_kernel, which reads a 0-dim predicate the frame computed on the
// device and sets the node's handle (a WHILE body ends with another).  A
// replay is then one cudaGraphLaunch and no host read.
//
// set_cond_kernel also counts, on the device, the times it set its handle
// true: how often each branch was taken and each loop body ran, which the
// wrappers' launch counts need (integrators/wavefront.py reads them only
// when asked, after the frames).
//
// spt_stamp is not part of a graph: it enqueues stamp_kernel, which writes
// the device's %globaltimer (ns) into one int64 slot, on a stream between
// two pieces of work, outside any capture (utils/timing.py reads the slots
// back after the work and puts them on the host clock).
//
// Every entry returns its CUDA error (0 on success); graphs, nodes,
// handles and streams are the same CUgraph / CUstream objects under both
// runtimes, so they pass between this library's runtime and PyTorch's.

#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const uint8_t* pred, int negate,
                                unsigned long long* taken) {
  const bool value = (*pred != 0) != (negate != 0);
  cudaGraphSetConditional(handle, value ? 1u : 0u);
  if (value && taken != nullptr) *taken += 1ull;
}

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  *slot = ns;
}

// A conditional body holds kernel, memcpy, memset, empty, child-graph and
// conditional nodes only.
bool body_node_ok(cudaGraphNodeType type) {
  switch (type) {
    case cudaGraphNodeTypeKernel:
    case cudaGraphNodeTypeMemcpy:
    case cudaGraphNodeTypeMemset:
    case cudaGraphNodeTypeGraph:
    case cudaGraphNodeTypeEmpty:
    case cudaGraphNodeTypeConditional:
      return true;
    default:
      return false;
  }
}

int deps_of(void* dep, cudaGraphNode_t* out) {
  *out = static_cast<cudaGraphNode_t>(dep);
  return dep != nullptr ? 1 : 0;
}

}  // namespace

extern "C" {

int spt_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

int spt_graph_destroy(void* graph) {
  return cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

// The nodes of `graph` (its top level), and in *bad_type the type of the
// first one a conditional body may not hold (-1 when there is none).
int spt_graph_nodes(void* graph, int* count, int* bad_type) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return err;
  *count = static_cast<int>(n);
  *bad_type = -1;
  if (n == 0) return cudaSuccess;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    if (!body_node_ok(type)) {
      *bad_type = static_cast<int>(type);
      break;
    }
  }
  return cudaSuccess;
}

// A copy of `child` as a node of `graph` after `dep` (null: no dependency).
int spt_graph_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d;
  const int nd = deps_of(dep, &d);
  return cudaGraphAddChildGraphNode(reinterpret_cast<cudaGraphNode_t*>(node),
                                    static_cast<cudaGraph_t>(graph), &d, nd,
                                    static_cast<cudaGraph_t>(child));
}

int spt_graph_add_empty(void* graph, void* dep, void** node) {
  cudaGraphNode_t d;
  const int nd = deps_of(dep, &d);
  return cudaGraphAddEmptyNode(reinterpret_cast<cudaGraphNode_t*>(node),
                               static_cast<cudaGraph_t>(graph), &d, nd);
}

// A conditional handle of `graph`, reset to 0 at every launch.
int spt_graph_cond_handle(void* graph, unsigned long long* handle) {
  return cudaGraphConditionalHandleCreate(
      reinterpret_cast<cudaGraphConditionalHandle*>(handle),
      static_cast<cudaGraph_t>(graph), 0, cudaGraphCondAssignDefault);
}

// set_cond_kernel(handle, pred, negate, taken) as a node of `graph` after
// `dep`; `taken` (one unsigned 64-bit word, or null) counts the times it
// sets the handle true.
int spt_graph_add_set_cond(void* graph, void* dep, unsigned long long handle,
                           const void* pred, int negate, void* taken,
                           void** node) {
  cudaGraphNode_t d;
  const int nd = deps_of(dep, &d);
  cudaGraphConditionalHandle h = handle;
  const uint8_t* p = static_cast<const uint8_t*>(pred);
  unsigned long long* t = static_cast<unsigned long long*>(taken);
  void* args[] = {&h, &p, &negate, &t};
  cudaKernelNodeParams params = {};
  params.func = reinterpret_cast<void*>(set_cond_kernel);
  params.gridDim = dim3(1);
  params.blockDim = dim3(1);
  params.sharedMemBytes = 0;
  params.kernelParams = args;
  return cudaGraphAddKernelNode(reinterpret_cast<cudaGraphNode_t*>(node),
                                static_cast<cudaGraph_t>(graph), &d, nd,
                                &params);
}

// A conditional node on `handle` after `dep`: kind 0 an IF (its body runs
// once when the handle is nonzero), 1 a WHILE (its body runs while the
// handle is nonzero, tested before each run).  *body is the body graph the
// node owns, empty, for the caller to fill.
int spt_graph_add_conditional(void* graph, void* dep, unsigned long long handle,
                              int kind, void** node, void** body) {
  cudaGraphNode_t d;
  const int nd = deps_of(dep, &d);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 0 ? cudaGraphCondTypeIf
                                      : cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  const cudaError_t err = cudaGraphAddNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph), &d, nd, &params);
  if (err != cudaSuccess) return err;
  *body = params.conditional.phGraph_out[0];
  return cudaSuccess;
}

int spt_graph_instantiate(void* graph, void** exec) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

int spt_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int spt_graph_exec_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// One thread writes the globaltimer into *slot once the work enqueued on
// `stream` before it has run.
int spt_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slot));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
