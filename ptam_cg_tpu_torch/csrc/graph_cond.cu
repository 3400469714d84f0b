// CUDA graph IF and WHILE nodes for a capture under way
// (models/graphs.py::if_block, ::loop).
//
// The counterparts of JAX's lax.cond and lax.while_loop inside a jitted
// program: a node of the graph being captured whose body graph runs when a
// bool on the card is true at that point of the replay (IF), or again and
// again while it is (WHILE). graph_cond_begin, called while `outer`
// captures, adds a one-thread kernel that loads the predicate into a
// conditional handle, then the conditional node after it, makes the node the
// capture's new frontier and starts capturing `body` into the node's body
// graph; graph_cond_end ends that capture. What the caller launches on
// `body` in between is the body; a WHILE body ends with graph_cond_set,
// which loads the predicate into the handle again. This is what CUDA's
// runtime offers since 12.4 (cudaGraphConditionalHandleCreate,
// cudaStreamBeginCaptureToGraph); the PyTorch build on the card has no
// Python binding of it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (kernels/_build.py). Every entry returns a cudaError_t, 0 on success.

#include <cuda_runtime.h>

__global__ void graph_cond_set_kernel(cudaGraphConditionalHandle handle,
                                      const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

static cudaError_t capture_frontier(cudaStream_t s, cudaGraph_t* graph,
                                    const cudaGraphNode_t** deps,
                                    size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps,
                                             nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps,
                                             n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

extern "C" int graph_cond_stream_create(void** out) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(out),
                                   cudaStreamNonBlocking);
}

extern "C" int graph_cond_set(unsigned long long handle, const void* pred,
                              void* stream) {
  graph_cond_set_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(pred));
  return cudaGetLastError();
}

// `loop`: 0 for an IF node, 1 for a WHILE node; `handle_out` gets the
// node's conditional handle.
extern "C" int graph_cond_begin(void* outer_stream, const void* pred,
                                void* body_stream, int capture_mode, int loop,
                                unsigned long long* handle_out) {
  cudaStream_t outer = static_cast<cudaStream_t>(outer_stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_frontier(outer, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  err = static_cast<cudaError_t>(graph_cond_set(handle, pred, outer));
  if (err != cudaSuccess) return err;
  err = capture_frontier(outer, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      outer, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(outer, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(capture_mode));
}

extern "C" int graph_cond_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}
