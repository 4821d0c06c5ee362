// Conditional nodes of a CUDA graph under stream capture: the device-side
// counterpart of the JAX package's `lax.cond` and `lax.while_loop` inside one
// jitted step (dpgo_tpu/driver.py::_multi_step_impl), for the graph route of
// dpgo_tpu_torch/driver.py.
//
// Not a numerical kernel: one thread reads a flag the step computed on the
// card and hands it to the graph's conditional handle. What this file adds
// is host-side graph surgery while a stream is being captured (CUDA 12.4+):
//
//   dpgo_cond_begin  creates a conditional handle in the graph the parent
//                    stream is capturing into, launches `set_cond` on the
//                    parent stream (so the handle takes the flag's value when
//                    the graph reaches that point), appends an IF or WHILE
//                    conditional node after it, makes the node the parent
//                    stream's only capture dependency, and starts capturing
//                    the child stream into the node's body graph;
//   dpgo_cond_set    launches `set_cond` on a stream (a WHILE body ends with
//                    it: the loop runs again while the flag is set);
//   dpgo_cond_end    ends the child stream's capture into the body;
//   dpgo_capture_node_types
//                    lists the types of the nodes of the graph a stream is
//                    capturing into, child graphs expanded (a diagnostic:
//                    what a library call records under capture).
//
// The caller (dpgo_tpu_torch/ops/graph_nodes.py) makes the child stream
// PyTorch's current stream between begin and end, so every operation of the
// branch or loop body is recorded into the body graph, and routes the
// allocations of that stream into the capture's memory pool.
//
// Bound: one 1-thread launch per predicate (a few microseconds of graph
// latency); the node itself costs the device no memory traffic.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_cond(cudaGraphConditionalHandle handle,
                         const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

// kind: 0 = IF (the body runs once when the flag is set), 1 = WHILE (the
// body runs while the flag is set; the body must end with dpgo_cond_set).
extern "C" int dpgo_cond_begin(void* parent, void* child, const void* flag,
                               int kind, unsigned long long* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStream_t cs = static_cast<cudaStream_t>(child);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps,
                                             nullptr, &ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps,
                                             &ndeps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_cond<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The dependencies now end at the set_cond launch.
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, nullptr,
                                 &ndeps);
#else
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &ndeps);
#endif
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile
                                      : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];

#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(ps, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(cs, body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return cudaSuccess;
}

extern "C" int dpgo_cond_set(unsigned long long handle, const void* flag,
                             void* stream) {
  set_cond<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(flag));
  return cudaGetLastError();
}

extern "C" int dpgo_cond_end(void* child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

namespace {

// Depth-first over `graph`: depth * 256 + cudaGraphNodeType per node.
cudaError_t walk(cudaGraph_t graph, int depth, int* out, int cap, int* n) {
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &count);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(count);
  if (count) err = cudaGraphGetNodes(graph, nodes.data(), &count);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return err;
    if (*n < cap) out[*n] = depth * 256 + static_cast<int>(type);
    ++*n;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (err != cudaSuccess) return err;
      err = walk(child, depth + 1, out, cap, n);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// The node types of the graph `stream` is capturing into (at most `cap`
// written to `out`; `*n_out` the number of nodes in all).
extern "C" int dpgo_capture_node_types(void* stream, int* out, int cap,
                                       int* n_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  unsigned long long id = 0;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph, &deps,
      nullptr, &ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph, &deps, &ndeps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  *n_out = 0;
  return walk(graph, 0, out, cap, n_out);
}
