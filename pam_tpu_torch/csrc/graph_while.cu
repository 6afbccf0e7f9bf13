// A step captured into one CUDA graph, with loops decided on the device:
// the port's counterpart of jax.jit over a step whose loops are
// jax.lax.while_loop (pam_tpu's compiled CRM step runs Kessler's rain
// sub-cycles, P3's sedimentation rounds and AWFL's acoustic sub-cycles
// so). ops/graph.py drives it.
//
// CUDA 12.4 added conditional graph nodes; a WHILE node runs its body
// graph for as long as its condition value is nonzero, tested before the
// first trip and after every trip, with no host involved. PyTorch binds
// no WHILE node, so this file captures the graph itself:
//
//   pam_capture_begin  start capturing a stream into a new graph;
//   pam_while_begin    on that stream: create the condition handle,
//                      capture a one-thread kernel that sets it from the
//                      predicate (a bool on the device), add the WHILE
//                      node after it, pause the graph's capture and
//                      capture the same stream into the node's body;
//   pam_while_end      capture the kernel that sets the condition from
//                      the predicate recomputed at the end of the trip,
//                      end the body's capture and resume the graph's,
//                      after the node;
//   pam_while_abort    end the body's capture after a failure in the
//                      body and resume the graph's;
//   pam_capture_end    end the capture and instantiate the graph;
//   pam_graph_launch, pam_graph_destroy.
//
// Body and graph are captured on one stream so that PyTorch's caching
// allocator, whose free blocks belong to the stream that allocated them,
// reuses the memory of either in the other, as the eager step does: the
// body's nodes run after every node captured before the WHILE node and
// before every node captured after it. With a second stream for the body
// its memory and the graph's would add up.
//
// Not a kernel of the TPU's: XLA provides the while loop. The work is one
// thread reading one byte a trip; what it saves is the host round trip
// that reading the trip count would cost.

#include <cuda_runtime.h>

namespace {

constexpr cudaStreamCaptureMode kMode = cudaStreamCaptureModeThreadLocal;

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t resume(cudaStream_t s, void* parent, void* node) {
  cudaGraphNode_t n = static_cast<cudaGraphNode_t>(node);
  return cudaStreamBeginCaptureToGraph(s, static_cast<cudaGraph_t>(parent),
                                       &n, nullptr, 1, kMode);
}

}  // namespace

extern "C" int pam_capture_begin(void* stream, void** graph_out) {
  cudaGraph_t graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(stream),
                                      graph, nullptr, nullptr, 0, kMode);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return err;
  }
  *graph_out = graph;
  return 0;
}

// returns 0, a CUDA error code, or -1 when `stream` is not capturing;
// parent_out and node_out are what pam_while_end resumes after
extern "C" int pam_while_begin(void* stream, const void* pred,
                               unsigned long long* handle_out,
                               void** parent_out, void** node_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end in the kernel just captured
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t paused;
  err = cudaStreamEndCapture(s, &paused);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(s, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0, kMode);
  if (err != cudaSuccess) {
    resume(s, graph, node);
    return err;
  }
  *handle_out = handle;
  *parent_out = graph;
  *node_out = node;
  return 0;
}

extern "C" int pam_while_end(void* stream, unsigned long long handle,
                             const void* pred, void* parent, void* node) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t ended = cudaStreamEndCapture(s, &body);
  cudaError_t resumed = resume(s, parent, node);
  if (launched != cudaSuccess) return launched;
  return ended != cudaSuccess ? ended : resumed;
}

extern "C" int pam_while_abort(void* stream, void* parent, void* node) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t body;
  cudaStreamEndCapture(s, &body);
  return resume(s, parent, node);
}

// ends the capture; with `instantiate`, instantiates the graph into
// *exec_out; destroys the graph either way (the instance keeps what it
// needs)
extern "C" int pam_capture_end(void* stream, void* graph, int instantiate,
                               void** exec_out) {
  cudaGraph_t captured;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &captured);
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess && instantiate)
    err = cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  *exec_out = exec;
  return err;
}

extern "C" int pam_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

extern "C" int pam_graph_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
