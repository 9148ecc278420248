// Conditional (IF) nodes of a CUDA graph made under stream capture, for
// otamg_torch/graphs.py::when: a body that runs at a replay only where a
// device predicate holds.
//
// Replaces what the TPU program does with lax.cond (the defect repair of
// otamg/amg/hierarchy.py:941) and with the exits of its lax.while_loops
// (amg_solve, the Armijo search, the mixed refinement): work that XLA
// skips on the device when its predicate is false.  A CUDA graph without
// such nodes replays every kernel it holds, so the port used to compute
// both branches and select.
//
// The node is made in three calls while a stream captures:
// * cond_begin creates the node's condition handle on the graph the stream
//   captures and launches set_if there: at every replay one thread reads
//   the 0-d bool predicate and sets the condition.
// * cond_node adds the IF node after the stream's captured work (the
//   set_if launch) and makes it the stream's only dependency, so the work
//   captured next runs after the node.  It returns the node's body graph.
// * cond_capture starts capturing a second stream into that body graph;
//   cond_end ends it.  The body's kernels are captured there as they
//   would be in the graph itself.  A body may hold further IF nodes: its
//   stream then captures the body graph, and the same calls nest.
//
// The predicate is read by set_if at the replay, in stream order after
// whatever wrote it.  The handle's default value is 0 and set_if writes
// it at every replay.
//
// C interface, loaded with ctypes; pointers and handles pass as uint64.
// Every call returns a cudaError_t (0 on success) or kNotCapturing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNotCapturing = 10001;

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph `stream` captures and the nodes its next work depends on.
int capture_info(cudaStream_t stream, cudaGraph_t* graph,
                 const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, ndeps);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? 0 : kNotCapturing;
}

}  // namespace

extern "C" {

int cond_begin(uint64_t stream, uint64_t pred, uint64_t* handle) {
  auto s = reinterpret_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  int err = capture_info(s, &graph, &deps, &ndeps);
  if (err) return err;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err) return err;
  set_if<<<1, 1, 0, s>>>(h, reinterpret_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err) return err;
  *handle = static_cast<uint64_t>(h);
  return 0;
}

int cond_node(uint64_t stream, uint64_t handle, uint64_t* body) {
  auto s = reinterpret_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  int err = capture_info(s, &graph, &deps, &ndeps);
  if (err) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err) return err;
  *body = reinterpret_cast<uint64_t>(params.conditional.phGraph_out[0]);
  return 0;
}

// A stream of its own for the bodies (never the stream that captures
// the node: torch's pool of streams hands its streams out in turn).
int cond_stream(uint64_t* out) {
  cudaStream_t s;
  int err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err) return err;
  *out = reinterpret_cast<uint64_t>(s);
  return 0;
}

int cond_capture(uint64_t side, uint64_t body, int mode) {
  return cudaStreamBeginCaptureToGraph(
      reinterpret_cast<cudaStream_t>(side),
      reinterpret_cast<cudaGraph_t>(body), nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode));
}

int cond_end(uint64_t side) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(reinterpret_cast<cudaStream_t>(side), &graph);
}

const char* cond_error_string(int err) {
  if (err == kNotCapturing) return "the stream is not capturing";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
