// One branch of a data-dependent choice in a captured CUDA graph, taken on
// the device (the counterpart of lax.cond in a step that runs as a graph):
// an IF node (a CUDA >= 12.4 conditional node) whose body is a copy of a
// graph captured on its own, entered where an int32 flag on the device is
// nonzero (or zero). A one-thread kernel captured just before the node sets
// its condition from the flag, so no host ever reads it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const int32_t* flag,
                              int invert) {
  const unsigned int take = (*flag != 0) != (invert != 0);
  cudaGraphSetConditional(handle, take);
}

}  // namespace

// Appends to the graph being captured on `stream`: set_if_kernel on `flag`,
// then an IF node whose body is a copy of `branch` (a cudaGraph_t), taken
// where *flag != 0 (== 0 with `invert`); the capture continues after the
// node. Returns 0, cudaErrorIllegalState when `stream` is not capturing, or
// the failing call's cudaError_t.
extern "C" int ttamm_graph_if(const int32_t* flag, int invert, void* branch,
                              cudaStream_t stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t num_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, flag, invert);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the node follows the kernel: the capture's dependencies after it
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(branch));
  if (err != cudaSuccess) return err;
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
}
