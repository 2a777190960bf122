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
//            {chain}
//     WHILE: set kernel -> WHILE node {chain -> set kernel}
//
// where {chain} is again a chain of items, appended into the conditional
// node's own body graph, so that conditionals nest (a whole Newton
// increment: WHILE {..., IF {...}, WHILE {...}, ...}). A child graph may
// not hold a conditional node (cudaGraphAddChildGraphNode refuses it), so a
// composed program is never wrapped as a child graph. The WHILE item is
// `lax.while_loop`: the flag is tested before the first run (a flag already
// clear runs the body no time) and again after each run, all on the card.
// cudaGraphAddChildGraphNode clones the body, so a body may appear several
// times in one program (the two runs of a PCG solve and its restart). No
// Pallas kernel of the reference corresponds: on the TPU the loops are XLA
// programs. The set kernel is one thread that reads one byte.
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

// Append a set kernel and a conditional node of `kind` on *flag to the
// chain of `graph` ending at *tail; *inner is the node's body graph.
cudaError_t append_conditional(cudaGraph_t graph, cudaGraphNode_t* tail, const bool* flag,
                               int kind, cudaGraph_t* inner, cudaGraphConditionalHandle* handle) {
  // the handle belongs to the graph that holds the conditional node
  FEA_TRY(cudaGraphConditionalHandleCreate(handle, graph, 0, 0));
  cudaGraphNode_t set;
  FEA_TRY(add_set(&set, graph, tail, *tail ? 1 : 0, *handle, flag));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = *handle;
  cp.conditional.type = kind == kIf ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  FEA_TRY(add_node(tail, graph, &set, 1, &cp));
  *inner = cp.conditional.phGraph_out[0];
  return cudaSuccess;
}

// Append items [lo, hi), the chain whose parent is item `parent` (-1: the
// top level), to the chain of `graph` ending at *tail. Items are in
// pre-order: item i's chain is the run of items after it whose parents are
// i or later.
cudaError_t append_chain(cudaGraph_t graph, cudaGraphNode_t* tail, int parent, int lo, int hi,
                         void* const* bodies, void* const* flags, const int* kinds,
                         const int* parents) {
  for (int i = lo; i < hi;) {
    if (parents[i] != parent) return cudaErrorInvalidValue;
    int end = i + 1;
    while (end < hi && parents[end] >= i) {
      if (parents[end] >= end) return cudaErrorInvalidValue;
      ++end;
    }
    if (kinds[i] == kAlways) {
      if (bodies[i] == nullptr || end != i + 1) return cudaErrorInvalidValue;
      cudaGraphNode_t node;
      FEA_TRY(cudaGraphAddChildGraphNode(&node, graph, tail, *tail ? 1 : 0,
                                         static_cast<cudaGraph_t>(bodies[i])));
      *tail = node;
    } else {
      const bool* flag = static_cast<const bool*>(flags[i]);
      if ((kinds[i] != kIf && kinds[i] != kWhile) || flag == nullptr || bodies[i] != nullptr ||
          end == i + 1) {
        return cudaErrorInvalidValue;
      }
      cudaGraph_t inner;
      cudaGraphConditionalHandle handle;
      FEA_TRY(append_conditional(graph, tail, flag, kinds[i], &inner, &handle));
      cudaGraphNode_t inner_tail = nullptr;
      FEA_TRY(append_chain(inner, &inner_tail, i, i + 1, end, bodies, flags, kinds, parents));
      if (kinds[i] == kWhile) {
        // the loop condition for the next run, after this one
        cudaGraphNode_t again;
        FEA_TRY(add_set(&again, inner, &inner_tail, 1, handle, flag));
      }
    }
    i = end;
  }
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

// Compose n items into a new graph and instantiate it. The items are in
// pre-order; parents[i] is the conditional item whose chain item i belongs
// to (-1: the top level). Item i is the body graph bodies[i], run once
// (kinds[i] 0), or a conditional on the bool *flags[i] in device memory,
// read when a set kernel runs, with bodies[i] null: IF (1) or WHILE (2)
// over its chain, which is not empty.
int fea_graph_compose(int n, void* const* bodies, void* const* flags, const int* kinds,
                      const int* parents, void** graph_out, void** exec_out) {
  cudaGraph_t graph;
  FEA_TRY(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t tail = nullptr;
  cudaError_t status = append_chain(graph, &tail, -1, 0, n, bodies, flags, kinds, parents);
  if (status != cudaSuccess) {
    cudaGraphDestroy(graph);
    return status;
  }
  cudaGraphExec_t exec;
  status = cudaGraphInstantiate(&exec, graph, 0);
  if (status != cudaSuccess) {
    cudaGraphDestroy(graph);
    return status;
  }
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
}

// Append the graph `child` as a child-graph node to a new graph and
// destroy that graph: whether CUDA takes `child` as a child graph (it
// refuses one that holds a conditional node).
int fea_graph_try_child(void* child) {
  cudaGraph_t graph;
  FEA_TRY(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t node;
  cudaError_t status = cudaGraphAddChildGraphNode(&node, graph, nullptr, 0,
                                                  static_cast<cudaGraph_t>(child));
  cudaGraphDestroy(graph);
  return status;
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
