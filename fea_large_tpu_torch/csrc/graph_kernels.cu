// IF and WHILE nodes for CUDA graphs captured by PyTorch (ops/cuda_graphs.py).
//
// The device-resident Newton loop (solvers/device_loop.py) and the PCG
// chunks (solvers/linear.py::DevicePCGChunk) replay graphs whose control is
// decided on the card: a body runs only while a flag in device memory is
// set. CUDA has conditional nodes for that (IF since CUDA 12.3, WHILE since
// 12.4); the PyTorch this runs under captures graphs but has no call that
// captures into one. So PyTorch captures each body as a graph of its own
// (its memory in that graph's private pool), and this library composes the
// programs from them: a chain whose items are a child-graph node holding a
// body, or
//
//     IF:    set kernel (reads the flag, sets the IF's condition) -> IF node
//            {child graph node holding the body}
//     WHILE: set kernel -> WHILE node {child graph node holding the body ->
//            set kernel}
//
// The WHILE item is `lax.while_loop`: the flag is tested before the first
// run (a flag already clear runs the body no time) and again after each
// run, all on the card. cudaGraphAddChildGraphNode clones the body, so a
// body may appear several times in one chain (the K predicated CG
// iterations). No Pallas kernel of the reference corresponds: on the TPU
// the loops are XLA programs. The set kernel is one thread that reads one
// byte.
//
// C interface, loaded with ctypes; every function returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t add_node(cudaGraphNode_t* out, cudaGraph_t graph, const cudaGraphNode_t* deps,
                     size_t n_deps, cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(out, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(out, graph, deps, n_deps, params);
#endif
}

#define FEA_TRY(call)                         \
  do {                                        \
    cudaError_t status_ = (call);             \
    if (status_ != cudaSuccess) return status_; \
  } while (0)

// The item kinds of fea_graph_compose.
enum Kind { kAlways = 0, kIf = 1, kWhile = 2 };

// A set kernel node in `graph` after `deps` (n_deps of them): it copies
// *flag into the condition `handle`.
cudaError_t add_set(cudaGraphNode_t* out, cudaGraph_t graph, const cudaGraphNode_t* deps,
                    size_t n_deps, cudaGraphConditionalHandle handle, const bool* flag) {
  void* args[2] = {&handle, &flag};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(out, graph, deps, n_deps, &kp);
}

// Append `body` to the chain ending at *tail: always (kAlways), under
// IF(*flag) (kIf) or WHILE(*flag) (kWhile).
cudaError_t append(cudaGraph_t graph, cudaGraphNode_t* tail, cudaGraph_t body, const bool* flag,
                   int kind) {
  const size_t n_deps = *tail ? 1 : 0;
  cudaGraphNode_t node;
  if (kind == kAlways) {
    FEA_TRY(cudaGraphAddChildGraphNode(&node, graph, tail, n_deps, body));
    *tail = node;
    return cudaSuccess;
  }
  if ((kind != kIf && kind != kWhile) || flag == nullptr) return cudaErrorInvalidValue;
  cudaGraphConditionalHandle handle;
  FEA_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  cudaGraphNode_t set;
  FEA_TRY(add_set(&set, graph, tail, n_deps, handle, flag));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = kind == kIf ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  FEA_TRY(add_node(&node, graph, &set, 1, &cp));
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  cudaGraphNode_t child;
  FEA_TRY(cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, body));
  if (kind == kWhile) {
    // the loop condition for the next run, after this one
    cudaGraphNode_t again;
    FEA_TRY(add_set(&again, inner, &child, 1, handle, flag));
  }
  *tail = node;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Load the set kernel's module now: a first launch inside a capture or a
// graph cannot load it.
int fea_graph_init() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, set_condition_kernel);
}

// Compose n items into a new graph and instantiate it. Item i is the body
// graph bodies[i], run once (kinds[i] 0), under IF(*flags[i]) (1) or
// WHILE(*flags[i]) (2); flags[i] is a bool in device memory, read when a
// set kernel runs.
int fea_graph_compose(int n, void* const* bodies, void* const* flags, const int* kinds,
                      void** graph_out, void** exec_out) {
  cudaGraph_t graph;
  FEA_TRY(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t tail = nullptr;
  for (int i = 0; i < n; ++i) {
    cudaError_t status = append(graph, &tail, static_cast<cudaGraph_t>(bodies[i]),
                                static_cast<const bool*>(flags[i]), kinds[i]);
    if (status != cudaSuccess) {
      cudaGraphDestroy(graph);
      return status;
    }
  }
  cudaGraphExec_t exec;
  cudaError_t status = cudaGraphInstantiate(&exec, graph, 0);
  if (status != cudaSuccess) {
    cudaGraphDestroy(graph);
    return status;
  }
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
}

int fea_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

// Top-level nodes of a graph (a body captured by PyTorch has no nested one).
int fea_graph_node_count(void* graph, size_t* count) {
  return cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, count);
}

int fea_graph_destroy(void* graph, void* exec) {
  cudaError_t a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return a != cudaSuccess ? a : b;
}

}  // extern "C"
